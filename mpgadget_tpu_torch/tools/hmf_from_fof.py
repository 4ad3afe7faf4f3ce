"""Halo mass function from a PIG (FOF) output (the port's twin of
tools/hmf_from_fof.py).

Equivalent of tools/hmffromfof.py in the reference: dn/dlnM from the
FOFGroups/Mass table, printed as columns
    M_center[Msun/h]  dn/dlnM[(Mpc/h)^-3]  Nhalos
Usage: python -m mpgadget_tpu_torch.tools.hmf_from_fof <PIG_dir> [nbins]
"""

import sys

import numpy as np

from ..io.bigfile import BigFile


def hmf(pig, nbins=24):
    bf = BigFile(pig)
    hdr = bf.open("Header")
    box = float(np.asarray(hdr.attrs["BoxSize"])[0])
    mass = bf.open("FOFGroups/Mass").read().astype(np.float64)
    # internal mass -> Msun/h (UnitMass default 1e10 Msun/h)
    mass = mass * 1e10
    # internal length -> Mpc/h assuming kpc/h units
    vol = (box / 1000.0) ** 3
    if len(mass) == 0:
        print("# no groups")
        return None
    lo, hi = np.log(mass.min() * 0.999), np.log(mass.max() * 1.001)
    edges = np.linspace(lo, hi, nbins + 1)
    counts, _ = np.histogram(np.log(mass), bins=edges)
    dlnm = edges[1] - edges[0]
    centers = np.exp(0.5 * (edges[1:] + edges[:-1]))
    print("# M[Msun/h]  dn/dlnM[(Mpc/h)^-3]  N")
    rows = []
    for c, n in zip(centers, counts):
        if n > 0:
            print(f"{c:.6g} {n / vol / dlnm:.6g} {n}")
            rows.append((c, n / vol / dlnm, n))
    return np.array(rows)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        sys.exit(__doc__)
    return hmf(argv[0], int(argv[1]) if len(argv) > 1 else 24)


if __name__ == "__main__":
    main()
