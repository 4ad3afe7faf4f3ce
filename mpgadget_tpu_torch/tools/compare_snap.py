"""Compare two snapshots: per-particle displacement (matched by ID)
and the relative difference of the measured power spectra (the port's
twin of tools/compare_snap.py; the spectra are measured on the card
unless --device cpu is given).

Equivalent of tools/compare_snap.py in the reference (which checks
bit-identity of regression snapshots); this version reports quantified
differences so cross-code comparisons (e.g. vs MP-Gadget output on the
same ICs) are one command.

Usage: python -m mpgadget_tpu_torch.tools.compare_snap <snapA> <snapB>
           [ptype] [--device cpu]
"""

import sys

import numpy as np

from . import torch_device
from ..io.bigfile import BigFile


def compare(snap_a, snap_b, ptype=1, device="cuda"):
    a, b = BigFile(snap_a), BigFile(snap_b)
    box = float(np.asarray(a.open("Header").attrs["BoxSize"])[0])
    ida = a.open(f"{ptype}/ID").read()
    idb = b.open(f"{ptype}/ID").read()
    pa = a.open(f"{ptype}/Position").read()
    pb = b.open(f"{ptype}/Position").read()
    oa, ob = np.argsort(ida), np.argsort(idb)
    if not np.array_equal(ida[oa], idb[ob]):
        print("ID sets differ: "
              f"{len(np.setdiff1d(ida, idb))} only in A, "
              f"{len(np.setdiff1d(idb, ida))} only in B")
        common = np.intersect1d(ida, idb)
        oa = oa[np.isin(ida[oa], common)]
        ob = ob[np.isin(idb[ob], common)]
    d = pa[oa] - pb[ob]
    d -= np.round(d / box) * box            # minimum image
    dr = np.linalg.norm(d, axis=1)
    print(f"N matched = {len(dr)}")
    print(f"displacement: max = {dr.max():.6g}  rms = "
          f"{np.sqrt((dr ** 2).mean()):.6g}  (box = {box:g})")

    import torch
    from ..pm.gravity import measure_power, PMConfig
    from ..particles import pos_to_fixed
    dev = torch_device(device)
    ng = max(round(len(dr) ** (1 / 3)), 2)
    cfg = PMConfig(nmesh=2 * ng, boxsize=box)
    w = torch.ones(len(dr), dtype=torch.float32, device=dev)

    def fixed(pos):
        return torch.as_tensor(pos_to_fixed(pos, box).astype(np.int64),
                               device=dev)

    ka = measure_power(fixed(pa[oa]), w, cfg)
    kb = measure_power(fixed(pb[ob]), w, cfg)
    sel = (ka.nmodes > 0) & (ka.power > 0) & (kb.power > 0)
    ratio = kb.power[sel] / ka.power[sel]
    print("P(k) ratio B/A: "
          f"min = {ratio.min():.4f}  max = {ratio.max():.4f}  "
          f"mean = {ratio.mean():.4f}")
    return dr, ratio


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) < 2:
        sys.exit(__doc__)
    return compare(argv[0], argv[1], int(argv[2]) if len(argv) > 2 else 1,
                   device=device)


if __name__ == "__main__":
    main()
