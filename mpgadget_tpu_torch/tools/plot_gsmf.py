"""Galaxy stellar mass function from a PIG (FOF) catalog (the port's
twin of tools/plot_gsmf.py).

Reads FOFGroups/MassByType from a PIG output, takes the type-4
(stellar) column, and prints/plots dn/dlog10(M*) [Mpc^-3 dex^-1] --
the standard observable the reference's tools/plotGSMF.py computes for
BlueTides-style runs (and compares against observed GSMFs).

Usage:
    python -m mpgadget_tpu_torch.tools.plot_gsmf PIG_005 [--nbins 20]
        [--h 0.7] [--boxsize-mpch B] [-o plot.png]

Without -o prints columns: log10(M*/Msun)  phi [Mpc^-3 dex^-1]  count.
"""

import argparse

import numpy as np

from ..io.bigfile import BigFile


def gsmf(pig, nbins=20, unit_mass_msun=1e10, hubble=None,
         boxsize_mpch=None):
    bf = BigFile(pig)
    mbt = bf.open("FOFGroups/MassByType").read()
    hdr = bf.open("Header").attrs
    if boxsize_mpch is None:
        # internal length is kpc/h by convention -> Mpc/h
        boxsize_mpch = float(np.asarray(hdr["BoxSize"])[0]) / 1e3
    if hubble is None:
        hubble = (float(np.asarray(hdr["HubbleParam"])[0])
                  if "HubbleParam" in hdr.keys() else 0.7)
    mstar = mbt[:, 4].astype(np.float64) * unit_mass_msun / hubble
    mstar = mstar[mstar > 0]
    if len(mstar) == 0:
        return np.zeros(0), np.zeros(0), np.zeros(0, np.int64)
    lm = np.log10(mstar)
    edges = np.linspace(lm.min() - 1e-6, lm.max() + 1e-6, nbins + 1)
    cnt, _ = np.histogram(lm, bins=edges)
    dlog = np.diff(edges)
    vol = (boxsize_mpch / hubble) ** 3          # Mpc^3
    phi = cnt / dlog / vol
    mid = 0.5 * (edges[1:] + edges[:-1])
    ok = cnt > 0
    return mid[ok], phi[ok], cnt[ok]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("pig")
    ap.add_argument("--nbins", type=int, default=20)
    ap.add_argument("--h", type=float, default=None)
    ap.add_argument("--boxsize-mpch", type=float, default=None)
    ap.add_argument("--unit-mass-msun", type=float, default=1e10)
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)

    mid, phi, cnt = gsmf(args.pig, args.nbins, args.unit_mass_msun,
                         args.h, args.boxsize_mpch)
    if args.output:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.figure(figsize=(5, 4))
        plt.plot(mid, np.log10(np.maximum(phi, 1e-30)), "o-")
        plt.xlabel(r"$\log_{10} M_*/M_\odot$")
        plt.ylabel(r"$\log_{10}\phi$ [Mpc$^{-3}$ dex$^{-1}$]")
        plt.tight_layout()
        plt.savefig(args.output, dpi=150)
        print(f"wrote {args.output}")
    else:
        print("# log10(M*) phi[Mpc^-3 dex^-1] count")
        for m, p, c in zip(mid, phi, cnt):
            print(f"{m:8.3f} {p:.6e} {int(c)}")


if __name__ == "__main__":
    main()
