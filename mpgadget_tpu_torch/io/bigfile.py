"""Pure-Python implementation of the *bigfile* on-disk format.

Byte-compatible with the reference's vendored C library
(/root/reference/depends/bigfile/src/bigfile.c), so snapshots written here
are readable by MP-Gadget and by the public ``bigfile`` Python package,
and vice versa.

Format (bigfile.c:330-420, 590-620, 1560-1630):

* A *file* is a directory; a *block* is a subdirectory (nested names use
  subdirectories, e.g. ``0/Position``).
* ``<block>/header`` (text)::

      DTYPE: <f8
      NMEMB: 3
      NFILE: 2
      000000: <nbytes> : <sysv raw sum> : <sysv folded sum>
      000001: ...

* ``<block>/attr-v2`` (text): one line per attribute:
  ``<name> <dtype> <nmemb> <hexbytes> #HUMANE [ <textual> ]``
* Data files named ``%06X`` hold raw little-endian binary rows,
  striped by row across NFILE files.
"""

import os
import numpy as np

from . import _native


def _dtype_to_bigfile(dt: np.dtype, nmemb: int) -> str:
    dt = np.dtype(dt)
    byteorder = "<" if dt.byteorder in ("<", "=", "|") else ">"
    return f"{byteorder}{dt.kind}{dt.itemsize}"


def _sysv_checksums(raw_sum: int):
    s = raw_sum & 0xFFFFFFFF
    r = (s & 0xFFFF) + ((s & 0xFFFFFFFF) >> 16)
    folded = (r & 0xFFFF) + (r >> 16)
    return s, folded


def _bytesum(arr: np.ndarray) -> int:
    return int(np.frombuffer(arr.tobytes(), dtype=np.uint8)
               .astype(np.uint64).sum() & 0xFFFFFFFF)


class BigAttrs:
    """attr-v2 attribute set; dict-like, numpy-valued."""

    def __init__(self, block):
        self._block = block
        self._attrs = {}   # name -> (dtype_str, np.ndarray)
        self._load()

    def _path(self):
        return os.path.join(self._block.path, "attr-v2")

    def _load(self):
        path = self._path()
        if not os.path.exists(path):
            return
        with open(path) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) < 4:
                    continue
                name, dtype, nmemb, hexdata = parts[:4]
                nmemb = int(nmemb)
                data = bytes.fromhex(hexdata)
                arr = np.frombuffer(data, dtype=np.dtype(dtype),
                                    count=nmemb).copy()
                self._attrs[name] = (dtype, arr)

    def _save(self):
        with open(self._path(), "w") as fh:
            for name, (dtype, arr) in self._attrs.items():
                raw = arr.tobytes()
                hexdata = raw.hex().upper()
                if len(raw) > 128:
                    textual = "... (Too Long) "
                elif np.dtype(dtype).kind in ("S", "a"):
                    textual = raw.split(b"\0")[0].decode("latin1")
                else:
                    textual = " ".join(repr(v) for v in arr.tolist())
                fh.write(f"{name} {dtype} {len(arr)} {hexdata} "
                         f"#HUMANE [ {textual} ]\n")

    def __getitem__(self, name):
        dtype, arr = self._attrs[name]
        if np.dtype(dtype).kind in ("S", "a"):
            return arr.tobytes().split(b"\0")[0].decode("latin1")
        return arr

    def __setitem__(self, name, value):
        if isinstance(value, str):
            raw = (value + "\0").encode("latin1")
            arr = np.frombuffer(raw, dtype="S1").copy()
            self._attrs[name] = ("<S1", arr)
        else:
            arr = np.atleast_1d(np.asarray(value))
            if arr.dtype.kind == "i":
                arr = arr.astype("<i8")
            elif arr.dtype.kind == "u":
                arr = arr.astype("<u8")
            elif arr.dtype.kind == "f":
                arr = arr.astype("<f8")
            dt = _dtype_to_bigfile(arr.dtype, len(arr))
            self._attrs[name] = (dt, arr)
        self._save()

    def __contains__(self, name):
        return name in self._attrs

    def keys(self):
        return self._attrs.keys()


class BigBlock:
    def __init__(self, path, mode="r", dtype=None, nmemb=1, Nfile=1,
                 size=None):
        self.path = path
        if mode == "r":
            self._read_header()
        else:
            os.makedirs(path, exist_ok=True)
            if dtype is None:
                # header-only block ('.'): attrs but no data
                self.dtype = None
                self.nmemb = 0
                self.Nfile = 0
                self.fsize = []
                self.size = 0
                attrpath = os.path.join(path, "attr-v2")
                if not os.path.exists(attrpath):
                    open(attrpath, "w").close()
            else:
                dt = np.dtype(dtype)
                self.dtype = dt.newbyteorder("<")
                self.nmemb = nmemb
                self.Nfile = Nfile if size else 0
                per = (size + self.Nfile - 1) // self.Nfile if size else 0
                self.fsize = [min(per, size - i * per)
                              for i in range(self.Nfile)]
                self.size = size or 0
                self.fchecksum = [0] * self.Nfile
                self._write_header()
                for i in range(self.Nfile):
                    open(self._datafile(i), "wb").close()
        self.attrs = BigAttrs(self)

    def _datafile(self, i):
        return os.path.join(self.path, "%06X" % i)

    def _read_header(self):
        hpath = os.path.join(self.path, "header")
        if not os.path.exists(hpath):
            self.dtype = None
            self.nmemb = 0
            self.Nfile = 0
            self.fsize = []
            self.size = 0
            return
        with open(hpath) as fh:
            tokens = fh.read().split()
        hdr = {}
        fsizes = {}
        checksums = {}
        i = 0
        while i < len(tokens):
            t = tokens[i]
            if t in ("DTYPE:", "NMEMB:", "NFILE:"):
                hdr[t[:-1]] = tokens[i + 1]
                i += 2
            elif t.endswith(":"):
                fid = int(t[:-1], 16)
                fsizes[fid] = int(tokens[i + 1])
                checksums[fid] = int(tokens[i + 3])
                i += 6  # "XXXXXX: size : cksum : folded"
            else:
                i += 1
        self.dtype = np.dtype(hdr["DTYPE"])
        self.nmemb = int(hdr["NMEMB"])
        self.Nfile = int(hdr["NFILE"])
        self.fsize = [fsizes.get(i, 0) for i in range(self.Nfile)]
        self.fchecksum = [checksums.get(i, 0) for i in range(self.Nfile)]
        self.size = sum(self.fsize)

    def _write_header(self):
        if self.dtype is None:
            return
        with open(os.path.join(self.path, "header"), "w") as fh:
            fh.write(f"DTYPE: {_dtype_to_bigfile(self.dtype, self.nmemb)}\n")
            fh.write(f"NMEMB: {self.nmemb}\n")
            fh.write(f"NFILE: {self.Nfile}\n")
            for i in range(self.Nfile):
                raw, folded = _sysv_checksums(self.fchecksum[i])
                fh.write("%06X: %d : %u : %u\n"
                         % (i, self.fsize[i], raw, folded))

    @property
    def foffset(self):
        off = [0]
        for s in self.fsize:
            off.append(off[-1] + s)
        return off

    # -- data ---------------------------------------------------------

    def _stripe_plan(self, start, count):
        """(file ids, file byte offsets, row offsets, row counts) of
        the stripes touching [start, start+count)."""
        off = self.foffset
        ids, foff, roff, rcnt = [], [], [], []
        row = 0
        for i in range(self.Nfile):
            lo = max(start, off[i])
            hi = min(start + count, off[i + 1])
            if hi <= lo:
                continue
            ids.append(i)
            foff.append(lo - off[i])
            roff.append(row)
            rcnt.append(hi - lo)
            row += hi - lo
        return ids, foff, roff, rcnt

    def read(self, start=0, count=None) -> np.ndarray:
        if count is None:
            count = self.size - start
        itemsize = self.dtype.itemsize * self.nmemb
        ids, foff, roff, rcnt = self._stripe_plan(start, count)
        out = np.empty(count * self.nmemb, dtype=self.dtype)
        outb = out.view(np.uint8).reshape(count, itemsize)
        # native path: one OpenMP pread per stripe file
        raw = _native.read_striped(
            [self._datafile(i) for i in ids],
            np.asarray(foff, np.int64) * itemsize,
            count * itemsize, np.asarray(roff, np.int64) * itemsize,
            np.asarray(rcnt, np.int64) * itemsize) \
            if ids else b""
        if raw is not None:
            outb[:] = np.frombuffer(raw, np.uint8).reshape(
                count, itemsize)
        else:
            for i, fo, ro, rc in zip(ids, foff, roff, rcnt):
                with open(self._datafile(i), "rb") as fh:
                    fh.seek(fo * itemsize)
                    buf = fh.read(rc * itemsize)
                outb[ro:ro + rc] = np.frombuffer(
                    buf, dtype=np.uint8).reshape(rc, itemsize)
        if self.nmemb > 1:
            return out.reshape(count, self.nmemb)
        return out

    def write(self, start: int, data: np.ndarray):
        data = np.ascontiguousarray(data, dtype=self.dtype)
        count = data.shape[0]
        flat = data.reshape(count, -1)
        assert flat.shape[1] == self.nmemb, \
            f"nmemb mismatch: {flat.shape[1]} != {self.nmemb}"
        itemsize = self.dtype.itemsize * self.nmemb
        ids, foff, roff, rcnt = self._stripe_plan(start, count)
        sums = _native.write_striped(
            [self._datafile(i) for i in ids],
            np.asarray(foff, np.int64) * itemsize,
            np.ascontiguousarray(flat).tobytes(),
            np.asarray(roff, np.int64) * itemsize,
            np.asarray(rcnt, np.int64) * itemsize) if ids else []
        if sums is not None:
            for i, s in zip(ids, np.asarray(sums, np.uint64)):
                self.fchecksum[i] = (self.fchecksum[i] + int(s)) \
                    & 0xFFFFFFFF
        else:
            for i, fo, ro, rc in zip(ids, foff, roff, rcnt):
                chunk = flat[ro:ro + rc]
                with open(self._datafile(i), "r+b") as fh:
                    fh.seek(fo * itemsize)
                    fh.write(chunk.tobytes())
                self.fchecksum[i] = (self.fchecksum[i]
                                     + _bytesum(chunk)) & 0xFFFFFFFF
        self._write_header()

    def write_stripe(self, i: int, data: np.ndarray) -> int:
        """Write data file ``i`` in full and return its sysv byte sum
        WITHOUT touching the shared header — the multi-writer path
        (petaio.c:33-68 NumWriters analog): every writer owns whole
        stripe files, and one rank calls ``finalize_checksums`` after
        collecting the sums."""
        data = np.ascontiguousarray(data, dtype=self.dtype)
        flat = data.reshape(data.shape[0], self.nmemb)
        assert flat.shape[0] == self.fsize[i], \
            f"stripe {i} size mismatch: {flat.shape[0]} != {self.fsize[i]}"
        with open(self._datafile(i), "wb") as fh:
            fh.write(flat.tobytes())
        return _bytesum(flat)

    def finalize_checksums(self, sums):
        """Record per-file byte sums gathered from the stripe writers
        and rewrite the header once (single-writer header policy)."""
        self.fchecksum = [int(s) & 0xFFFFFFFF for s in sums]
        self._write_header()

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            start, stop, step = idx.indices(self.size)
            assert step == 1
            return self.read(start, stop - start)
        raise TypeError(idx)


class BigFile:
    """A bigfile directory: a tree of named blocks."""

    def __init__(self, path, create=False):
        self.path = path
        if create:
            os.makedirs(path, exist_ok=True)
        elif not os.path.isdir(path):
            raise FileNotFoundError(path)

    def blocks(self):
        found = []
        for root, dirs, files in os.walk(self.path):
            if "header" in files or "attr-v2" in files:
                rel = os.path.relpath(root, self.path)
                found.append("." if rel == "." else rel.replace(os.sep, "/"))
                dirs[:] = [d for d in dirs
                           if os.path.isdir(os.path.join(root, d))]
        return sorted(found)

    def __contains__(self, name):
        p = os.path.join(self.path, name)
        return (os.path.exists(os.path.join(p, "header"))
                or os.path.exists(os.path.join(p, "attr-v2")))

    def open(self, name) -> BigBlock:
        return BigBlock(os.path.join(self.path, name), mode="r")

    def create(self, name, dtype=None, size=None, nmemb=1,
               Nfile=1) -> BigBlock:
        if size == 0:
            Nfile = 0
        return BigBlock(os.path.join(self.path, name), mode="w",
                        dtype=dtype, nmemb=nmemb, Nfile=Nfile, size=size)

    def create_from_array(self, name, data: np.ndarray, Nfile=1) -> BigBlock:
        data = np.asarray(data)
        nmemb = 1 if data.ndim == 1 else data.shape[1]
        bb = self.create(name, dtype=data.dtype.newbyteorder("<"),
                         size=data.shape[0], nmemb=nmemb, Nfile=Nfile)
        if data.shape[0]:
            bb.write(0, data)
        return bb
