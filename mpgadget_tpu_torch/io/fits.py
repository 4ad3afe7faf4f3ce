"""Minimal FITS image writer (lenstools-compatible potential planes).

The reference writes lensing planes through CFITSIO
(libgadget/lenstools.c:322-390); this is a clean-room writer for the
small subset needed — a single 2-D float32/float64 image HDU with
scalar header keys — following the public FITS 4.0 standard (2880-byte
header/data blocks, 80-char cards, big-endian data)."""

import numpy as np


def _card(key, value, comment=""):
    if isinstance(value, str):
        v = "'" + value.ljust(8) + "'"
        body = f"{key:<8}= {v:<20}"
    elif isinstance(value, bool):
        body = f"{key:<8}= {'T' if value else 'F':>20}"
    elif isinstance(value, (int, np.integer)):
        body = f"{key:<8}= {value:>20d}"
    else:
        body = f"{key:<8}= {value:>20.13E}"
    if comment:
        body += f" / {comment}"
    return body[:80].ljust(80)


def write_fits_image(path, data, header=None, double=False):
    """Write a 2-D array as a simple FITS image with header keys.

    header: list of (key, value, comment) tuples appended after the
    mandatory cards."""
    data = np.asarray(data)
    assert data.ndim == 2
    dtype = ">f8" if double else ">f4"
    bitpix = -64 if double else -32
    cards = [
        _card("SIMPLE", True, "conforms to FITS standard"),
        _card("BITPIX", bitpix, "array data type"),
        _card("NAXIS", 2, "number of array dimensions"),
        _card("NAXIS1", data.shape[1]),
        _card("NAXIS2", data.shape[0]),
    ]
    for key, value, comment in (header or []):
        cards.append(_card(key, value, comment))
    cards.append("END".ljust(80))
    head = "".join(cards).encode("ascii")
    head += b" " * ((-len(head)) % 2880)
    payload = data.astype(dtype).tobytes()
    payload += b"\0" * ((-len(payload)) % 2880)
    with open(path, "wb") as fh:
        fh.write(head)
        fh.write(payload)


def read_fits_image(path):
    """Read back a simple FITS image (for tests); returns
    (data, header dict)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    header = {}
    pos = 0
    while True:
        block = raw[pos:pos + 2880].decode("ascii", errors="replace")
        pos += 2880
        done = False
        for i in range(0, 2880, 80):
            card = block[i:i + 80]
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if "=" in card:
                val = card[9:].split("/")[0].strip()
                if val.startswith("'"):
                    header[key] = val.strip("'").strip()
                elif val in ("T", "F"):
                    header[key] = val == "T"
                else:
                    try:
                        header[key] = int(val)
                    except ValueError:
                        header[key] = float(val)
        if done:
            break
    ny, nx = header["NAXIS2"], header["NAXIS1"]
    dtype = ">f8" if header["BITPIX"] == -64 else ">f4"
    n = ny * nx * (8 if header["BITPIX"] == -64 else 4)
    data = np.frombuffer(raw[pos:pos + n], dtype=dtype).reshape(ny, nx)
    return data, header
