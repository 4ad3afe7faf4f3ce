"""Convert a classic Gadget-1 binary snapshot (single- or multi-file)
to an MP-Gadget bigfile snapshot (the port's twin of
tools/convert_from_gadget_1.py).

Behavior parity with the reference's nbodykit-based
tools/convert_from_gadget_1.py (velocity convention u*sqrt(a) ->
peculiar, UsePeculiarVelocity=1, MassTable carried over, ID
wrap-around repair, optional subsampling) — implemented here as a
standalone pure-numpy F77-record reader, since nbodykit is not a
dependency of this framework.

Gadget-1 files have no metadata: fields beyond pos/vel/id/mass/u are
not converted.  For multi-file snapshots pass the basename excluding
".0".

    python -m mpgadget_tpu_torch.tools.convert_from_gadget_1 SOURCE DEST
"""

import argparse
import glob
import os
import struct

import numpy as np

from ..io.bigfile import BigFile
from ..io.snapshot import SnapshotHeader, write_header

HEADER_FMT = "<6i6ddd2i6Ii i d d d d 2i 6I i"  # through flag_entr_ics


def _read_record(fh, expect=None):
    """One F77 unformatted record: i32 length, payload, i32 length."""
    raw = fh.read(4)
    if len(raw) < 4:
        return None
    n1 = struct.unpack("<i", raw)[0]
    payload = fh.read(n1)
    n2 = struct.unpack("<i", fh.read(4))[0]
    if n1 != n2:
        raise IOError(f"corrupt F77 record: lengths {n1} != {n2}")
    if expect is not None and n1 != expect:
        raise IOError(f"record length {n1}, expected {expect}")
    return payload


def read_gadget1_header(payload):
    h = {}
    off = 0

    def take(fmt):
        nonlocal off
        vals = struct.unpack_from("<" + fmt, payload, off)
        off += struct.calcsize("<" + fmt)
        return vals

    h["npart"] = np.array(take("6i"), np.int64)
    h["massarr"] = np.array(take("6d"), np.float64)
    h["time"], h["redshift"] = take("2d")
    h["flag_sfr"], h["flag_feedback"] = take("2i")
    h["nall"] = np.array(take("6I"), np.int64)
    h["flag_cooling"], h["num_files"] = take("2i")
    h["boxsize"], h["omega0"], h["omegaL"], h["hubble"] = take("4d")
    h["flag_stellarage"], h["flag_metals"] = take("2i")
    h["nallhw"] = np.array(take("6I"), np.int64)
    return h


def read_gadget1_file(path):
    """Read one Gadget-1 file -> (header, dict of arrays)."""
    with open(path, "rb") as fh:
        h = read_gadget1_header(_read_record(fh, expect=256))
        n = int(h["npart"].sum())
        data = {}
        pos = _read_record(fh)
        data["pos"] = np.frombuffer(pos, "<f4").reshape(n, 3)
        vel = _read_record(fh)
        data["vel"] = np.frombuffer(vel, "<f4").reshape(n, 3)
        ids = _read_record(fh)
        idt = "<u8" if len(ids) == 8 * n else "<u4"
        data["id"] = np.frombuffer(ids, idt)
        # mass block only for types with massarr == 0
        nwithmass = int(h["npart"][h["massarr"] == 0].sum())
        if nwithmass > 0:
            m = _read_record(fh)
            if m is not None:
                data["mass"] = np.frombuffer(m, "<f4")
        ngas = int(h["npart"][0])
        if ngas > 0:
            u = _read_record(fh)
            if u is not None:
                data["u"] = np.frombuffer(u, "<f4")[:ngas]
    return h, data


def gather_files(root):
    if os.path.exists(root):
        return [root]
    files = []
    for pat in (".?", ".??", ".???", ".????"):
        files += sorted(glob.glob(root + pat))
    if not files:
        raise FileNotFoundError(root)
    return files


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("source", help="Gadget-1 filename base "
                    "(excluding '.0' for multi-file)")
    ap.add_argument("dest", help="output bigfile snapshot directory")
    ap.add_argument("--time-ic", type=float, default=None)
    ap.add_argument("--unit-system", choices=["Mpc", "Kpc"],
                    default="Kpc")
    ap.add_argument("--subsample", type=int, default=None,
                    help="keep every n-th particle")
    ns = ap.parse_args(argv)

    files = gather_files(ns.source)
    print(f"reading {len(files)} file(s)")
    h0 = None
    per_type = {pt: {"pos": [], "vel": [], "id": [], "mass": [],
                     "u": []} for pt in range(6)}
    for path in files:
        h, data = read_gadget1_file(path)
        if h0 is None:
            h0 = h
        start = 0
        mstart = 0
        ustart = 0
        for pt in range(6):
            cnt = int(h["npart"][pt])
            if cnt == 0:
                continue
            sl = slice(start, start + cnt)
            per_type[pt]["pos"].append(data["pos"][sl])
            per_type[pt]["vel"].append(data["vel"][sl])
            per_type[pt]["id"].append(data["id"][sl])
            if h["massarr"][pt] == 0 and "mass" in data:
                per_type[pt]["mass"].append(
                    data["mass"][mstart:mstart + cnt])
                mstart += cnt
            if pt == 0 and "u" in data:
                per_type[pt]["u"].append(data["u"][ustart:ustart + cnt])
                ustart += cnt
            start += cnt

    a = float(h0["time"])
    tot = h0["nall"] + (h0["nallhw"] << 32)
    ulen = 3.085678e24 if ns.unit_system == "Mpc" else 3.085678e21

    bf = BigFile(ns.dest, create=True)
    header = SnapshotHeader(
        TotNumPart=tot.astype(np.uint64),
        MassTable=h0["massarr"],
        Time=a, BoxSize=float(h0["boxsize"]),
        Omega0=float(h0["omega0"]), OmegaLambda=float(h0["omegaL"]),
        HubbleParam=float(h0["hubble"]),
        TimeIC=a if ns.time_ic is None else ns.time_ic,
        UnitLength_in_cm=ulen, UsePeculiarVelocity=1)
    write_header(bf, header, code_version="convert_from_gadget_1")

    for pt in range(6):
        if not per_type[pt]["pos"]:
            continue
        pos = np.concatenate(per_type[pt]["pos"])
        vel = np.concatenate(per_type[pt]["vel"])
        pid = np.concatenate(per_type[pt]["id"]).astype(np.uint64)
        # IDs from 32-bit files may wrap: re-offset repeats of the
        # first ID (reference converter's wrap repair)
        if pid.size and (pid == pid[0]).sum() > 1:
            wraps = np.flatnonzero(pid == pid[0])[1:]
            for ind in wraps:
                pid[ind:] += np.uint64(2 ** 32)
        mass = (np.concatenate(per_type[pt]["mass"])
                if per_type[pt]["mass"] else None)
        sl = slice(None, None, ns.subsample)
        # Gadget-1 stores u = v_pec / sqrt(a); the bigfile Velocity
        # block stores peculiar velocity when UsePeculiarVelocity=1
        v_pec = vel[sl].astype(np.float64) * np.sqrt(a)
        prefix = f"{pt}/"
        bf.create_from_array(prefix + "Position",
                             pos[sl].astype("<f8"))
        bf.create_from_array(prefix + "Velocity",
                             v_pec.astype("<f4"))
        bf.create_from_array(prefix + "ID", pid[sl])
        if mass is not None:
            bf.create_from_array(prefix + "Mass",
                                 mass[sl].astype("<f4"))
        if pt == 0 and per_type[0]["u"]:
            u = np.concatenate(per_type[0]["u"])[sl]
            bf.create_from_array("0/InternalEnergy", u.astype("<f4"))
        print(f"type {pt}: wrote {pos[sl].shape[0]} particles")


if __name__ == "__main__":
    main()
