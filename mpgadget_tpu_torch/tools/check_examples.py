"""The examples' checks on the port: one set of check functions for each
of examples/dm-small, lya, star-small and travis, copied from their
check_results.py with the same checks and tolerances, reading the
outputs through the port's bigfile.

    python -m mpgadget_tpu_torch.tools.check_examples <example> \
        [output_dir] [input_spectrum]

runs the checks that the example's check_results.py runs, in its order
(``CHECKS``); output_dir defaults to "output" and input_spectrum to the
file its check_results.py names.  lya's one check, ``check_lya``, is the
sequence of its parts (``check_lya_redshift`` ... ``check_lya_baryons``),
which can also be called one by one.
"""

import glob
import os
import sys

import numpy as np

from ..io.bigfile import BigFile
from ..io import snapshot as snap_io


def modecount_rebin(kk, pk, modes, minmodes=2, ndesired=20):
    """Rebin P(k) so each bin holds enough modes (reference helper)."""
    logkk = np.log10(kk)
    mdlogk = (np.max(logkk) - np.min(logkk)) / ndesired
    istart = iend = 1
    count = 0
    k_list, pk_list = [kk[0]], [pk[0]]
    targetlogk = mdlogk + logkk[istart]
    while iend < np.size(logkk) - 1:
        count += modes[iend]
        iend += 1
        if count >= minmodes and logkk[iend - 1] >= targetlogk:
            pk_list.append(np.sum(modes[istart:iend]
                                  * pk[istart:iend]) / count)
            k_list.append(np.sum(modes[istart:iend]
                                 * kk[istart:iend]) / count)
            istart = iend
            targetlogk = mdlogk + logkk[istart]
            count = 0
    return np.array(k_list), np.array(pk_list)


def _read_power(fn, ndesired=20):
    """(k, P, D1) of a powerspectrum file, rebinned to ndesired bins
    (dm-small's checker: 20, travis's: 16)."""
    data = np.loadtxt(fn)
    kk, pk, modes = data[:, 0], data[:, 1], data[:, 2]
    good = kk > 0
    kk, pk = modecount_rebin(kk[good], pk[good], modes[good],
                             ndesired=ndesired)
    d1 = 1.0
    with open(fn) as fh:
        for line in fh:
            if line.startswith("# D1"):
                d1 = float(line.split("=")[1].strip())
            if not line.startswith("#"):
                break
    return kk, pk, d1


def _power_files(outdir):
    return sorted(glob.glob(os.path.join(outdir, "powerspectrum-*.txt")))


def _last(outdir, prefix):
    return sorted(glob.glob(os.path.join(outdir, prefix + "*")))


# -- dm-small (examples/dm-small/check_results.py) ---------------------

def check_power(outdir, spectrum, rtol_shape=0.1, rtol_growth=0.18):
    """Large-scale shape of the first output == the linear input
    spectrum; growth between first and last outputs == D1 ratio
    squared (check_power analog with reference tolerances)."""
    files = _power_files(outdir)
    assert files, "no power spectra written"
    kk, pk, d1_0 = _read_power(files[0])
    lin = np.loadtxt(spectrum)
    pk_lin = np.interp(kk, lin[:, 0], lin[:, 1])
    nb = min(6, len(kk))
    ratio = pk[:nb] / pk_lin[:nb]
    np.testing.assert_allclose(ratio, np.mean(ratio),
                               rtol=rtol_shape, atol=0)
    if len(files) > 1:
        kk1, pk1, d1_1 = _read_power(files[-1])
        pk1i = np.interp(kk[:nb], kk1, pk1)
        growth = pk1i / pk[:nb]
        np.testing.assert_allclose(growth, (d1_1 / d1_0) ** 2,
                                   rtol=rtol_growth, atol=0)
    print(f"P(k) OK over {len(files)} outputs")


def check_golden_pk(outdir, golden_file, rtol=5e-2):
    """Per-bin golden P(k) regression for the reduced CI config
    (deterministic seed 181170, Ngrid 24, Nmesh 48, a=0.15): the
    un-gated analog of the reference CI's per-halo golden masses
    (check_results.py:15-26) for a box too small to form halos."""
    files = _power_files(outdir)
    assert files, "no power spectra written"
    got = np.loadtxt(files[-1])
    want = np.loadtxt(golden_file)
    assert got.shape[0] == want.shape[0], \
        f"bin count changed: {got.shape} vs {want.shape}"
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-3)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=rtol,
                               err_msg="golden P(k) regression")
    print(f"golden P(k) OK ({got.shape[0]} bins, rtol {rtol})")


def check_hmf(outdir):
    pigs = _last(outdir, "PIG_")
    assert pigs, "no FOF catalogs written"
    bf = BigFile(pigs[-1])
    hh = float(np.asarray(bf.open("Header").attrs["HubbleParam"])
               .reshape(-1)[0])
    masses = bf.open("FOFGroups/Mass").read() * 1e10 / hh
    assert masses.size > 0, "no halos found"
    assert np.max(masses) > 9e12, f"max halo mass {np.max(masses):g}"
    print(f"FOF OK: {masses.size} halos, max {np.max(masses):.3g} Msun")


# -- lya (examples/lya/check_results.py: check_lya, in parts) ----------

XH = 0.76
BOLTZMANN = 1.38066e-16
PROTONMASS = 1.6726e-24


def _lya_snapshot(outdir):
    snaps = _last(outdir, "PART_")
    assert snaps, "no snapshots written"
    bf = BigFile(snaps[-1])
    return bf, snap_io.read_header(bf)


def _lya_gas(bf):
    """(temperature, delta, ne) of the gas: temperature from u (internal
    (km/s)^2) with the ionized mean molecular weight."""
    u = bf.open("0/InternalEnergy").read().astype(np.float64)
    rho = bf.open("0/Density").read().astype(np.float64)
    ne = bf.open("0/ElectronAbundance").read().astype(np.float64)
    uu = 1e10        # (1e5 cm/s)^2 -> erg/g
    mu = 4.0 / (1.0 + 3 * XH + 4 * XH * ne)
    temp = (2.0 / 3.0) * u * uu * mu * PROTONMASS / BOLTZMANN
    return temp, rho / np.median(rho), ne


def check_lya_redshift(outdir):
    """The last snapshot is at z < 3.1."""
    _, hdr = _lya_snapshot(outdir)
    z = 1.0 / hdr.Time - 1.0
    assert z < 3.1, f"last snapshot too early (z={z:.2f})"


def check_lya_species(outdir):
    """Gas, and stars from QuickLymanAlpha, in the last snapshot."""
    _, hdr = _lya_snapshot(outdir)
    assert int(hdr.TotNumPart[0]) > 0, "no gas in the forest snapshot"
    assert int(hdr.TotNumPart[4]) > 0, \
        "QuickLymanAlpha should have converted dense gas to stars"


def check_lya_igm(outdir):
    """The diffuse gas follows T = T0 delta^(gamma-1), T0 in [5e3, 5e4]
    K, gamma in [1.0, 1.9]."""
    bf, hdr = _lya_snapshot(outdir)
    temp, delta, _ = _lya_gas(bf)
    # diffuse forest gas: fit log T = log T0 + (gamma-1) log delta
    sel = (delta > 0.1) & (delta < 5.0) & (temp > 100.0)
    assert sel.sum() > 100, "too little diffuse gas for the fit"
    A = np.vstack([np.ones(sel.sum()), np.log10(delta[sel])]).T
    coef, *_ = np.linalg.lstsq(A, np.log10(temp[sel]), rcond=None)
    T0 = 10 ** coef[0]
    gamma = 1.0 + coef[1]
    print(f"IGM relation: T0 = {T0:.3g} K, gamma = {gamma:.3f} "
          f"(z = {1.0 / hdr.Time - 1.0:.2f})")
    assert 5e3 < T0 < 5e4, f"T0 = {T0:g} outside the forest range"
    assert 1.0 < gamma < 1.9, f"gamma = {gamma:g} unphysical"


def check_lya_ionized(outdir):
    """The median electron abundance is above 0.8 per hydrogen."""
    bf, _ = _lya_snapshot(outdir)
    med_ne = float(np.median(bf.open("0/ElectronAbundance").read()
                             .astype(np.float64)))
    assert med_ne > 0.8, f"IGM not ionized (median ne = {med_ne:g})"
    return med_ne


def check_lya_dense_gas(outdir):
    """quick-LyA conversion is total above threshold: no cold dense gas
    survives well past the critical overdensity."""
    bf, _ = _lya_snapshot(outdir)
    _, delta, _ = _lya_gas(bf)
    frac_dense = float((delta > 2000.0).mean())
    assert frac_dense < 0.01, \
        f"{frac_dense:.2%} of gas above the QuickLyA threshold"


def check_lya_baryons(outdir):
    """Baryon conservation: gas + stars against TotNumPartInit gas."""
    bf, hdr = _lya_snapshot(outdir)
    nstar = int(hdr.TotNumPart[4])
    mgas = bf.open("0/Mass").read().astype(np.float64).sum()
    mstar = bf.open("4/Mass").read().astype(np.float64).sum() \
        if nstar else 0.0
    n0 = int(hdr.TotNumPartInit[0])
    m0 = mgas + mstar
    # all gas particles started equal-mass; infer from the mode
    m_one = np.median(bf.open("0/Mass").read())
    expect = n0 * m_one
    assert abs(m0 - expect) < 0.05 * expect, \
        f"baryon mass drifted: {m0:g} vs {expect:g}"


LYA_PARTS = (check_lya_redshift, check_lya_species, check_lya_igm,
             check_lya_ionized, check_lya_dense_gas, check_lya_baryons)


def check_lya(outdir):
    """examples/lya/check_results.py's check_lya: its parts in its
    order."""
    got = {part: part(outdir) for part in LYA_PARTS}
    med_ne = got[check_lya_ionized]
    _, hdr = _lya_snapshot(outdir)
    print(f"lya OK: {int(hdr.TotNumPart[0])} gas / "
          f"{int(hdr.TotNumPart[4])} stars, median ne {med_ne:.2f}")


# -- star-small (examples/star-small/check_results.py) -----------------

def check_sfr_history(outdir, min_total_sfr=1e-8):
    """sfr.txt columns: a, total_sm, totsfrrate, rate_in_msunperyear,
    total_sum_mass_stars (sfr_eff.c write_sfr analog)."""
    fn = os.path.join(outdir, "sfr.txt")
    assert os.path.exists(fn), "no sfr.txt written"
    data = np.loadtxt(fn, ndmin=2)
    assert data.shape[0] > 0, "empty sfr.txt"
    a = data[:, 0]
    rate = data[:, 2]
    assert np.all(np.isfinite(rate)) and np.all(rate >= 0)
    # star formation must have switched on during the run
    assert rate.max() > min_total_sfr, \
        f"no star formation recorded (max rate {rate.max():g})"
    print(f"SFR history OK: {data.shape[0]} entries, "
          f"peak rate {rate.max():.3g} (internal units) at "
          f"a={a[np.argmax(rate)]:.3f}")


def check_stars_in_snapshot(outdir):
    snaps = _last(outdir, "PART_")
    assert snaps, "no snapshots written"
    bf = BigFile(snaps[-1])
    hdr = bf.open("Header").attrs
    npart = np.asarray(hdr["TotNumPart"]).reshape(-1)
    if npart[4] == 0:
        print("note: no star particles by the final snapshot "
              "(quick/reduced runs may stop before conversion)")
        return
    sm = bf.open("4/Mass").read()
    assert np.all(sm > 0)
    met = bf.open("4/Metallicity").read()
    assert np.all(np.isfinite(met)) and np.all(met >= 0)
    print(f"stars OK: {npart[4]} star particles")


# -- travis (examples/travis/check_results.py) -------------------------

def check_linear_growth(outdir, spectrum, rtol=0.25, nbins=5):
    """P(k, a) / P(k, a0) == (D1(a)/D1(a0))^2 on large scales, and the
    first output's shape matches the linear input spectrum."""
    files = _power_files(outdir)
    assert len(files) >= 2, f"need >=2 power outputs, got {len(files)}"
    kk0, pk0, d1_0 = _read_power(files[0], ndesired=16)
    nb = min(nbins, len(kk0))
    lin = np.loadtxt(spectrum)
    pk_lin = np.interp(kk0[:nb], lin[:, 0], lin[:, 1])
    ratio = pk0[:nb] / pk_lin
    # shape agreement: constant ratio over the large-scale bins
    np.testing.assert_allclose(ratio, np.mean(ratio), rtol=rtol,
                               atol=0)
    for fn in files[1:]:
        kk1, pk1, d1_1 = _read_power(fn, ndesired=16)
        pk1i = np.interp(kk0[:nb], kk1, pk1)
        growth = pk1i / pk0[:nb]
        if (d1_1 / d1_0) ** 2 < 1.0 + 2 * rtol:
            continue    # growth smaller than the tolerance: no signal
        np.testing.assert_allclose(
            growth, (d1_1 / d1_0) ** 2, rtol=rtol, atol=0,
            err_msg=f"growth mismatch at {fn}")
    print(f"linear growth OK over {len(files)} outputs")


def check_gas_state(outdir):
    """Snapshot gas blocks are physical (entropy/density positive)."""
    snaps = _last(outdir, "PART_")
    assert snaps, "no snapshots written"
    bf = BigFile(snaps[-1])
    rho = bf.open("0/Density").read()
    u = bf.open("0/InternalEnergy").read()
    assert np.all(rho > 0) and np.all(np.isfinite(rho))
    assert np.all(u > 0) and np.all(np.isfinite(u))
    print(f"gas state OK ({len(rho)} particles)")


# example -> (the checks its check_results.py runs, in order; the input
# spectrum it defaults to, for the checks that take one)
CHECKS = {
    "dm-small": ((check_power, check_hmf), "class_pk_9.dat"),
    "lya": ((check_lya,), None),
    "star-small": ((check_sfr_history, check_stars_in_snapshot), None),
    "travis": ((check_linear_growth, check_gas_state), "class_pk.dat"),
}
TAKES_SPECTRUM = (check_power, check_linear_growth)


def run_checks(example, outdir="output", spectrum=None):
    """Run the example's checks in order."""
    checks, default = CHECKS[example]
    for fn in checks:
        if fn in TAKES_SPECTRUM:
            fn(outdir, spectrum or default)
        else:
            fn(outdir)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in CHECKS:
        sys.exit(__doc__)
    run_checks(argv[0], argv[1] if len(argv) > 1 else "output",
               argv[2] if len(argv) > 2 else None)
    print(f"all {argv[0]} checks passed")


if __name__ == "__main__":
    main()
