"""The port's cooling tables and reionization against the JAX package:
physics/cooling.py's MetalCoolingTable, UVFluctuationTable and local_uvbg,
the network and do_cooling with metallicity and per-row UV rates,
physics/uvbg.py (the excursion set) and physics/qso_lightup.py.

The same numpy inputs, made from a seed, go through both packages on the
CPU.  The stand-in tables are written by the functions below from closed
forms (the reference's cooling_metal_UVB, z_reion grids and HeII histories
are not in the repository), and read through both packages by path.

Tolerances, each measured on these inputs with a margin:

* the metal table's lookup: float64 coordinates bit for bit but for
  float32 denormals (XLA on the CPU flushes them: 1e-37 absolute); float32
  coordinates within 2e-6 relative plus 1e-6 of the table's largest value
  (the two libraries' float32 log10 differ by an ulp, which moves a corner
  weight by ~5e-7; 1e-7 of the largest value measured);
* z_reion, local_uvbg, j21_to_rates and the HeII history: bit for bit;
* the net rate and do_cooling with metallicity in [0, 0.02] and per-row
  UV rates: tests/test_torch_cooling.py's tolerances (op by op JAX for the
  rate: ne/nh within 1e-6, the rate within 4e-6 plus 1e-7 of its largest
  value; the compiled JAX do_cooling: u_new 2e-5, ne/nh 2e-3 + 2e-6;
  float64 1e-9);
* the filters at the kR a grid reaches (0, or at least 2 pi / UVBGdim):
  2e-6 relative plus 1e-4 absolute (the real-space top hat's float32
  sin / x^3 - cos / x^2 cancels: 2e-5 of rounding at kR = 0.2);
* the excursion set's grids on tests/test_uvbg.py's top-hat set-up
  (UVBGdim 16 and 32) and on a smooth one (UVBGdim 16): the FFTs, sin and
  cos of the two libraries round otherwise, so a cell may be decided
  otherwise where its f_coll lies within 1e-4 of the barrier (the port's
  ``margin``): such flips are counted and allowed (none showed).
  Elsewhere the ionized cells are the same and J21 within 1e-5 of its
  largest value (2.2e-7 measured).  The partial xHI of the last step,
  1 - f_coll * ReionEfficiency, within 1e-5 plus the cell's rounding
  scale: d xHI / d s times float32's epsilon times the largest filtered
  stellar mass s, from a float64 ladder (``_ladder64``).  The top-hat's
  point source reaches most cells only by its filter's ringing, where
  that scale is 3e-3 and more: the two packages differ there by up to 0.063
  and each differs from the float64 ladder by up to 0.057 (the port) and
  0.047 (the JAX package), at most 0.08 of the scale.  On the smooth
  set-up the scale is 1.4e-7 and the partial xHI within 2.5e-7 in all
  three comparisons; the global xHI figures within 1e-3;
* a QSO bubble's mask: identical but where a row's distance lies within
  1e-6 of the radius (the float32 distance may round otherwise), entropy
  within 1e-6 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgadget_tpu.io.bigfile import BigFile as JBigFile
from mpgadget_tpu.physics import cooling as jcool
from mpgadget_tpu.physics import qso_lightup as jq
from mpgadget_tpu.physics import uvbg as ju
from mpgadget_tpu.cosmology import Cosmology as JCosmology
from mpgadget_tpu_torch.cosmology import Cosmology
from mpgadget_tpu_torch.physics import cooling as tcool
from mpgadget_tpu_torch.physics import qso_lightup as tq
from mpgadget_tpu_torch.physics import uvbg as tu
from mpgadget_tpu_torch.utils import constants as C
from mpgadget_tpu_torch.utils import get_unitsystem

torch.set_num_threads(1)

UNITS = get_unitsystem(C.CM_PER_KPC, 1.989e43, 1e5)
UVB = dict(gJH0=1e-12, gJHe0=8e-13, gJHep=3e-14, epsH0=5e-24,
           epsHe0=6e-24, epsHep=2e-25, self_shield_dens=5e-3)


# ---- stand-in inputs, each from a closed form -------------------------------

def write_metal_table(path):
    """A Cloudy-layout metal cooling table (tests/test_cooling.py's):
    1e-23 (1 + z) exp(-(log nH + 2)^2) exp(-(log T - 5)^2) erg cm^3/s on
    z 0..10 (6 bins), log nH -6..3 (10), log T 2..9 (15)."""
    z = np.linspace(0.0, 10.0, 6)
    lognh = np.linspace(-6.0, 3.0, 10)
    logt = np.linspace(2.0, 9.0, 15)
    zz, nn, tt = np.meshgrid(z, lognh, logt, indexing="ij")
    tab = 1e-23 * (1 + zz) * np.exp(-(nn + 2) ** 2) * np.exp(-(tt - 5) ** 2)
    bf = JBigFile(str(path), create=True)
    bf.create_from_array("MetallicityInSolar_bins", np.array([0.0]))
    bf.create_from_array("Redshift_bins", z)
    bf.create_from_array("HydrogenNumberDensity_bins", lognh)
    bf.create_from_array("Temperature_bins", logt)
    bf.create_from_array("NetCoolingRate", tab.ravel())
    return str(path)


def write_zreion_table(path, box_mpc, nside=8, early=20.0, late=2.0):
    """A z_reion grid (Zreion_Table, attrs Nmesh, BoxSize in Mpc/h,
    Redshift): z_re = early on x < box/2, late on x >= box/2."""
    tab = np.full((nside,) * 3, early)
    tab[nside // 2:] = late
    bf = JBigFile(str(path), create=True)
    blk = bf.create_from_array("Zreion_Table", tab.ravel())
    blk.attrs["Nmesh"] = np.asarray([nside], "<u8")
    blk.attrs["BoxSize"] = np.asarray([box_mpc], "<f8")
    blk.attrs["Redshift"] = np.asarray([(early + late) / 2], "<f8")
    return str(path)


def write_heii_history(path, rows=((4.0, 0.0, 0.0), (3.5, 0.3, 1e-33),
                                   (3.0, 0.7, 2e-33), (2.8, 0.999, 1e-33))):
    """A HeII reionization history: alpha_q 1.7, Emax 150 eV, then rows of
    (z, XHeIII, LMFP heating erg/s/cm^3)."""
    with open(path, "w") as fh:
        fh.write("# stand-in history\n1.7\n150.0\n")
        for z, x, lm in rows:
            fh.write(f"{z} {x} {lm}\n")
    return str(path)


def write_treecool(path, lz_max=1.2):
    """A TreeCool table from a closed form, nonzero up to log10(1+z) =
    lz_max: Gamma_X = 10^(-12 - X - lz / 2), Qdot_X = 10^(-24 - X - lz / 2)
    for X = 0, 1, 2 (HI, HeI, HeII)."""
    lz = np.linspace(0.0, lz_max, 25)
    cols = [lz] + [10 ** (-12 - c - lz / 2) for c in range(3)] \
        + [10 ** (-24 - c - lz / 2) for c in range(3)]
    with open(path, "w") as fh:
        fh.write("# log10(1+z) GH1 GHe1 GHe2 eH1 eHe1 eHe2\n")
        for row in np.stack(cols, axis=1):
            fh.write(" ".join(f"{x:.6e}" for x in row) + "\n")
    return str(path)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- the tables --------------------------------------------------------------

@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reion_tables")
    mpath = write_metal_table(tmp / "metalcool")
    return {"metal": (jcool.MetalCoolingTable.from_file(mpath),
                      tcool.MetalCoolingTable.from_file(mpath)),
            "tmp": tmp}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_metal_table_matches_jax(tables, dtype):
    """MetalCoolingTable.from_file and the lookup at 400 (nH, T) points
    inside and outside the grid, at z inside and beyond it (clamped)."""
    jm, tm = tables["metal"]
    rng = np.random.RandomState(3)
    nh = (10 ** rng.uniform(-8, 4, 400)).astype(dtype)
    temp = (10 ** rng.uniform(1, 10, 400)).astype(dtype)
    scale = float(tm.table.abs().max())
    for z in (0.0, 3.3, 9.99, 12.0):
        with jax.disable_jit():
            want = np.asarray(jm(z, jnp.asarray(nh), jnp.asarray(temp)))
        got = tm(z, torch.as_tensor(nh), torch.as_tensor(temp)).numpy()
        assert got.dtype == np.float32
        if dtype == np.float64:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-37)
        else:
            np.testing.assert_allclose(got, want, rtol=2e-6,
                                       atol=1e-6 * scale)
    assert np.isfinite(float(tm(0.0, torch.tensor([1e-30]),
                                torch.tensor([1e2]))[0]))


def test_metal_table_refuses_other_layouts(tables):
    """A table tabulated at a nonzero metallicity bin is refused."""
    path = str(tables["tmp"] / "metal_bad")
    write_metal_table(path)
    bf = JBigFile(path)
    bf.create_from_array("MetallicityInSolar_bins", np.array([0.5]))
    with pytest.raises(ValueError, match="wrongly tabulated"):
        tcool.MetalCoolingTable.from_file(path)


def test_uv_fluctuations_match_jax(tmp_path):
    """UVFluctuationTable.from_file (a table for another box raises),
    zreion at 600 random fixed-point positions and local_uvbg, bit for
    bit."""
    box = 5000.0
    path = write_zreion_table(tmp_path / "uvf", 5.0)
    juvf = jcool.UVFluctuationTable.from_file(path, box, C.CM_PER_KPC)
    tuvf = tcool.UVFluctuationTable.from_file(path, box, C.CM_PER_KPC)
    with pytest.raises(ValueError, match="for box"):
        tcool.UVFluctuationTable.from_file(path, 2 * box, C.CM_PER_KPC)
    rng = np.random.RandomState(5)
    ipos = rng.randint(0, 2 ** 32, (600, 3), dtype=np.int64)
    ipos[:4] = [[0, 0, 0], [2 ** 32 - 1] * 3, [2 ** 31] * 3, [2 ** 31 - 1,
                                                             5, 7]]
    zj = np.asarray(juvf.zreion(jnp.asarray(ipos.astype(np.uint32))))
    zt = tuvf.zreion(torch.as_tensor(ipos)).numpy()
    np.testing.assert_array_equal(zt, zj)
    assert (zt == 20.0).any() and (zt == 2.0).any()
    for z in (1.0, 5.0, 19.0, 25.0):
        jl = jcool.local_uvbg(jcool.UVBG(**UVB), jnp.asarray(zj), z)
        tl = tcool.local_uvbg(tcool.UVBG(**UVB), torch.as_tensor(zt), z)
        for k in tcool.UV_RATES:
            a, b = np.asarray(getattr(jl, k)), getattr(tl, k).numpy()
            assert b.dtype == a.dtype == np.float32
            np.testing.assert_array_equal(b, a, err_msg=k)
        assert tl.self_shield_dens == jl.self_shield_dens


# ---- the network with metallicity and per-row UV rates -----------------------

def _rows_in(n, seed, dtype):
    """Density (protons/cm^3), u (erg/g), ne/nh, metallicity in [0, 0.02]
    and per-row UV rates (a quarter of the rows gated off) over the grid
    of tests/test_torch_cooling.py."""
    rng = np.random.default_rng(seed)
    nh = 10 ** rng.uniform(-7, 3, n)
    temp = 10 ** rng.uniform(2, 8, n)
    ne = rng.uniform(0, 1.2, n)
    ne[::7] = 0.0
    u = temp * C.BOLTZMANN / (C.GAMMA_MINUS1 * 0.6 * C.PROTONMASS)
    z = rng.uniform(0, 0.02, n).astype(np.float32)
    z[::5] = 0.0
    zre = np.where(np.arange(n) % 4 == 0, 1.0, 20.0).astype(np.float32)
    return [x.astype(dtype) for x in (nh / C.HYDROGEN_MASSFRAC, u, ne)], \
        z, zre


def _pair(tables, metals=True):
    jp, tp = jcool.CoolingParams(), tcool.CoolingParams()
    jm, tm = tables["metal"] if metals else (None, None)
    return (jcool.CoolingRates(jp, jcool.TreeCool(None, jp), metal_table=jm),
            tcool.CoolingRates(tp, tcool.TreeCool(None, tp), metal_table=tm))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rate_with_metals_and_local_uv_matches_jax(tables, dtype):
    """get_heatingcooling_rate with the metal table, per-row metallicity
    and per-row UV rates (local_uvbg at z = 3), against JAX op by op, at
    z = 3 and 9 (the table's redshift axis)."""
    jc, tc = _pair(tables)
    (dens, u, ne), zmet, zre = _rows_in(48, 31, dtype)
    juv = jcool.local_uvbg(jcool.UVBG(**UVB), jnp.asarray(zre), 3.0)
    tuv = tcool.local_uvbg(tcool.UVBG(**UVB), torch.as_tensor(zre), 3.0)
    for z in (3.0, 9.0):
        with jax.disable_jit():
            lj, nj = jc.get_heatingcooling_rate(
                jnp.asarray(dens), jnp.asarray(u), z, jnp.asarray(zmet),
                juv, jnp.asarray(ne))
        lt, nt = tc.get_heatingcooling_rate(
            torch.as_tensor(dens), torch.as_tensor(u), z, tuv,
            torch.as_tensor(ne), metallicity=torch.as_tensor(zmet))
        assert lt.dtype == torch.as_tensor(dens).dtype
        lj, nj = _np(lj).astype(np.float64), _np(nj).astype(np.float64)
        lt, nt = _np(lt).astype(np.float64), _np(nt).astype(np.float64)
        if dtype == np.float32:
            np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-6)
            np.testing.assert_allclose(lt, lj, rtol=4e-6,
                                       atol=1e-7 * np.abs(lj).max())
        else:
            np.testing.assert_allclose(nt, nj, rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(lt, lj, rtol=1e-9,
                                       atol=1e-12 * np.abs(lj).max())
    # the metal term is there: metallicity lowers the net rate
    l0, _ = tc.get_heatingcooling_rate(
        torch.as_tensor(dens), torch.as_tensor(u), 3.0, tuv,
        torch.as_tensor(ne), metallicity=torch.zeros(48))
    assert (torch.as_tensor(lt) < l0.double()).sum() > 10


def test_no_metals_and_uniform_rates_are_the_scalar_path(tables):
    """The plain version's per-row inputs reduce to the scalar path bit for
    bit: zero metallicity with the table, and per-row rates equal to the
    scalars on every row (or zero where gated off, against UVBG())."""
    jc, tc = _pair(tables)
    _, plain = _pair(tables, metals=False)
    (dens, u, ne), _, _ = _rows_in(40, 37, np.float32)
    args = [torch.as_tensor(x) for x in (dens, u, ne)]
    want = plain.get_heatingcooling_rate(args[0], args[1], 3.0,
                                         tcool.UVBG(**UVB), args[2])
    on = tcool.local_uvbg(tcool.UVBG(**UVB), torch.full((40,), 20.0), 3.0)
    got = tc.get_heatingcooling_rate(args[0], args[1], 3.0, on, args[2],
                                     metallicity=torch.zeros(40))
    off = tcool.local_uvbg(tcool.UVBG(**UVB), torch.zeros(40), 3.0)
    dark = plain.get_heatingcooling_rate(args[0], args[1], 3.0,
                                         tcool.UVBG(), args[2])
    got_off = tc.get_heatingcooling_rate(args[0], args[1], 3.0, off,
                                         args[2])
    for a, b in zip(got + got_off, want + dark):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _cooling_inputs(n, seed, dtype):
    units = get_unitsystem(C.CM_PER_KPC, 1.989e43, 1e5)
    cu = dict(density_in_phys_cgs=units.UnitDensity_in_cgs * 0.49,
              uu_in_cgs=units.UnitInternalEnergy_in_cgs,
              tt_in_s=units.UnitTime_in_s / 0.7)
    rng = np.random.default_rng(seed)
    nh = 10 ** rng.uniform(-6, 2, n)
    rho = nh * C.PROTONMASS / C.HYDROGEN_MASSFRAC / cu["density_in_phys_cgs"]
    temp = 10 ** rng.uniform(2, 7, n)
    u = temp * C.BOLTZMANN / (C.GAMMA_MINUS1 * 0.6 * C.PROTONMASS) \
        / cu["uu_in_cgs"]
    dt = 10 ** rng.uniform(-6, -2, n)
    ne = rng.uniform(0, 1.2, n)
    min_egy = 100 * C.BOLTZMANN / C.PROTONMASS / C.GAMMA_MINUS1 \
        / cu["uu_in_cgs"] / (4 / (1 + 3 * C.HYDROGEN_MASSFRAC))
    z = rng.uniform(0, 0.02, n).astype(np.float32)
    zre = np.where(np.arange(n) % 3 == 0, 1.0, 20.0).astype(np.float32)
    return [x.astype(dtype) for x in (u, rho, dt, ne)], z, zre, min_egy, cu


@pytest.fixture(scope="module")
def cooling_runs(tables):
    """do_cooling with the metal table, metallicity and local_uvbg's
    per-row rates on 64 particles at z = 2: compiled JAX and the port,
    float32 and float64; the port's float32 run also on a listed third."""
    jc, tc = _pair(tables)
    out = {}
    for dt in (np.float32, np.float64):
        ins, zmet, zre, min_egy, cu = _cooling_inputs(64, 11, dt)
        juv = jcool.local_uvbg(jcool.UVBG(**UVB), jnp.asarray(zre), 2.0)
        tuv = tcool.local_uvbg(tcool.UVBG(**UVB), torch.as_tensor(zre), 2.0)
        j = jcool.do_cooling(jc, 2.0, *[jnp.asarray(x) for x in ins[:3]],
                             juv, jnp.asarray(ins[3]), jnp.asarray(zmet),
                             min_egy, jcool.CoolingUnits(**cu))
        targs = [torch.as_tensor(x) for x in ins]
        units = tcool.CoolingUnits(**cu)
        t = tcool.do_cooling(tc, 2.0, *targs[:3], tuv, targs[3], min_egy,
                             units, metallicity=torch.as_tensor(zmet))
        out[dt] = (j, t)
        if dt == np.float32:
            # 32 of 64 rows: PyTorch's CPU loops run a batch's tail (past
            # a multiple of the vector width) through scalar code, whose
            # pow and exp may round otherwise
            rows = torch.arange(1, 64, 2)
            out["rows"] = (rows, targs, t, tcool.do_cooling(
                tc, 2.0, *targs[:3], tuv, targs[3], min_egy, units,
                rows=rows, metallicity=torch.as_tensor(zmet)))
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_do_cooling_with_metals_and_local_uv_matches_jax(cooling_runs,
                                                         dtype):
    """The implicit cooling step with the metal table and per-row UV rates
    against the JAX package's compiled do_cooling."""
    (uj, nj), (ut, nt) = cooling_runs[dtype]
    uj, nj = _np(uj).astype(np.float64), _np(nj).astype(np.float64)
    ut, nt = _np(ut).astype(np.float64), _np(nt).astype(np.float64)
    if dtype == np.float32:
        np.testing.assert_allclose(ut, uj, rtol=2e-5)
        np.testing.assert_allclose(nt, nj, rtol=2e-3, atol=2e-6)
    else:
        np.testing.assert_allclose(ut, uj, rtol=1e-9)
        np.testing.assert_allclose(nt, nj, rtol=1e-9, atol=1e-12)
    assert np.all(ut > 0)


def test_do_cooling_rows_with_per_row_inputs(cooling_runs):
    """A row list with per-row UV rates and metallicity computes exactly
    those rows as the full call does, the others untouched."""
    rows, (u, _, _, ne), (uf, nf), (ur, nr) = cooling_runs["rows"]
    rest = torch.ones(64, dtype=torch.bool)
    rest[rows] = False
    assert torch.equal(ur[rows], uf[rows]) and torch.equal(nr[rows],
                                                           nf[rows])
    assert torch.equal(ur[rest], u[rest]) and torch.equal(nr[rest],
                                                          ne[rest])


# ---- the excursion set -------------------------------------------------------

def test_filters_and_rtom_match_jax():
    """The three filters over a k grid at two radii, and rtom for both
    filter types."""
    for ft in (0, 1, 2):
        for R in (np.float32(100.0), np.float32(3.7)):
            k = np.concatenate([[0.0, 1e-7 / R], np.logspace(
                np.log10(2 * np.pi / 64), 1.5, 300) / R]).astype(np.float32)
            want = np.asarray(ju._filter_fac(jnp.asarray(k), R, ft))
            got = tu._filter_fac(torch.as_tensor(k), float(R), ft).numpy()
            np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-4)
            assert got[0] == got[1] == 1.0
    radii = np.array([2000.0, 1000.0, 406.8])
    for ft in (0, 1):
        np.testing.assert_array_equal(tu.rtom(radii, 0.3, 27.7, ft),
                                      ju.rtom(radii, 0.3, 27.7, ft))


def _lattice(n_side, dim):
    """A lattice of gas in a 10 Mpc/h box and tests/test_uvbg.py's ladder
    parameters."""
    box = 10000.0
    grid = np.indices((n_side,) * 3).reshape(3, -1).T
    pos = (grid + 0.5) / n_side * box
    params = dict(uvbg_dim=dim, r_bubble_max=box / 4, r_bubble_min=box / 32,
                  delta_r_factor=1.25, nion_phot_per_bary=4000.0,
                  use_particle_sfr=False)
    return box, pos, params


def _tophat(n_side, dim):
    """tests/test_uvbg.py's set-up: a lattice of gas in a 10 Mpc/h box
    and one star at the center holding 2% of the mass."""
    box, pos, params = _lattice(n_side, dim)
    n = n_side ** 3
    ipos = np.concatenate([(pos / box * 2 ** 32).astype(np.int64),
                           np.array([[2 ** 31] * 3], np.int64)])
    mass = np.full(n + 1, 1e-2, np.float32)
    mass[n] = 1e-2 * n * 0.02
    return box, ipos, mass, n, params


def _smooth(n_side, dim):
    """The lattice of gas with a star on each gas particle, of SMOOTH_FCOLL
    (x, y) times its mass: f_coll follows a smooth field around half the
    barrier, so that the last step leaves cells partially ionized by a
    field far above the float32 transforms' rounding, and some cells
    ionized where it peaks."""
    box, pos, params = _lattice(n_side, dim)
    n = n_side ** 3
    ip = (pos / box * 2 ** 32).astype(np.int64)
    ipos = np.concatenate([ip, ip])
    x, y = (2 * np.pi * pos[:, k] / box for k in (0, 1))
    frac = SMOOTH_FCOLL * (1 + 1.5 * np.sin(x) * np.cos(y))
    mass = np.concatenate([np.full(n, 1e-2), 1e-2 * frac]).astype(np.float32)
    return box, ipos, mass, n, params


# the stars' mean mass fraction in _smooth: half the barrier
# (1 - 0.75 Y_He) / ReionEfficiency at OmegaBaryon / Omega0 = 1/6
SMOOTH_FCOLL = 0.5 * 0.05 / 0.3 / 4000.0 * (1 - 0.75 * 0.24)
# (set-up, UVBGdim, use_particle_sfr) -> test id
EXCURSION_CASES = {("tophat", 16, False): "16-False",
                   ("tophat", 32, False): "32-False",
                   ("tophat", 32, True): "32-True",
                   ("smooth", 16, False): "smooth-16"}


def _ladder64(ipos, weights, params, CP, box):
    """The xHI grid of the filter ladder in float64 from the port's float32
    deposits (numpy's transforms), with each cell's rounding scale of the
    last step: d xHI / d s there times float32's epsilon times the largest
    filtered stellar mass s, the size of the float32 transforms' rounding
    of s (s -> f_coll -> 1 - f_coll * ReionEfficiency)."""
    from mpgadget_tpu_torch.ops.cic import cic_deposit
    n = params.uvbg_dim
    shape = (n,) * 3
    mass_k, star_k = (np.fft.rfftn(cic_deposit(
        torch.as_tensor(ipos), torch.as_tensor(w), n).double().numpy())
        for w in weights)
    radii = tu.radius_ladder(params, box)
    rtoms = tu.rtom(radii, CP.Omega0, CP.RhoCrit, params.rtom_filter_type)
    eff = (CP.Omega0 / CP.OmegaBaryon * params.nion_phot_per_bary
           / (1 - 0.75 * (1 - C.HYDROGEN_MASSFRAC)))
    deltax_conv = n ** 3 / (CP.RhoCrit * CP.Omega0 * box ** 3)
    pixel_volume = (box / n) ** 3
    kx = np.fft.fftfreq(n, 1.0 / n)
    kz = np.arange(n // 2 + 1)
    k_mag = 2 * np.pi / box * np.sqrt(kx[:, None, None] ** 2
                                      + kx[None, :, None] ** 2
                                      + kz[None, None, :] ** 2)
    xhi = np.ones(shape)
    for i, (R, rtom_r) in enumerate(zip(radii, rtoms)):
        kR = np.maximum(k_mag * R, 1e-8)
        filt = np.where(k_mag * R > 1e-4,
                        3 * (np.sin(kR) / kR ** 3 - np.cos(kR) / kR ** 2), 1)
        m, st = (np.maximum(np.fft.irfftn(g * filt, s=shape, axes=(0, 1, 2)),
                            0) for g in (mass_k, star_k))
        per_s = (4 / 3 * np.pi * R ** 3 / pixel_volume
                 / np.maximum(rtom_r * m * deltax_conv, 1e-30))
        fcoll = st * per_s
        ion = fcoll > 1 / eff
        xhi = np.where(ion, 0, xhi)
    xhi = np.where(~ion & (xhi > 1e-5), np.clip(1 - fcoll * eff, 0, 1), xhi)
    return xhi, eff * per_s * np.finfo(np.float32).eps * st.max()


@pytest.fixture(scope="module")
def excursion_runs():
    """calculate_uvbg in both packages on the top-hat set-up at UVBGdim
    16 and 32, with a per-particle SFR deposit (use_particle_sfr) too, and
    on the smooth set-up at 16; the float64 ladder's xHI and rounding
    scale (_ladder64) beside each."""
    out = {}
    cpj = JCosmology(Omega0=0.3, OmegaLambda=0.7, OmegaBaryon=0.05,
                     HubbleParam=0.7, TimeBegin=0.1).init_units(UNITS)
    cpt = Cosmology(Omega0=0.3, OmegaLambda=0.7, OmegaBaryon=0.05,
                    HubbleParam=0.7, TimeBegin=0.1).init_units(UNITS)
    for setup, dim, particle_sfr in EXCURSION_CASES:
        box, ipos, mass, n, kw = (_tophat if setup == "tophat"
                                  else _smooth)(16, dim)
        kw["use_particle_sfr"] = particle_sfr
        rows = mass.size
        valid = np.ones(rows, bool)
        is_gas = np.arange(rows) < n
        is_star = ~is_gas
        rng = np.random.default_rng(dim)
        sfr = np.where(is_gas & (rng.uniform(size=rows) < 0.05),
                       rng.uniform(0, 1e-3, rows), 0.0).astype(np.float32)
        fesc = np.ones(rows, np.float32)
        j = ju.calculate_uvbg(
            jnp.asarray(ipos.astype(np.uint32)), jnp.asarray(mass),
            jnp.asarray(valid), jnp.asarray(is_gas), jnp.asarray(is_star),
            jnp.asarray(sfr), jnp.asarray(fesc), ju.UVBGParams(**kw), cpj,
            UNITS, box, atime=0.125)
        t = tu.calculate_uvbg(
            torch.as_tensor(ipos), torch.as_tensor(mass),
            torch.as_tensor(valid), torch.as_tensor(is_gas),
            torch.as_tensor(is_star), torch.as_tensor(sfr),
            torch.as_tensor(fesc), tu.UVBGParams(**kw), cpt, UNITS, box,
            atime=0.125)
        x64 = _ladder64(ipos, (mass, np.where(is_star, mass, 0)),
                        tu.UVBGParams(**kw), cpt, box)
        out[setup, dim, particle_sfr] = (j, t, ipos, x64)
    return out


@pytest.mark.parametrize("case", [pytest.param(k, id=v)
                                  for k, v in EXCURSION_CASES.items()])
def test_excursion_grids_match_jax(excursion_runs, case):
    """The xHI and J21 grids and the global xHI figures; a cell decided
    otherwise only where its f_coll came within 1e-4 of the barrier.  The
    partial xHI, 1 - f_coll * ReionEfficiency, within 1e-5 of its terms
    (1e-5 absolute) plus the cell's float32 rounding scale (_ladder64), in
    both packages against the float64 ladder and against each other."""
    j, t, _, (x64, rounding) = excursion_runs[case]
    xj, jj = np.asarray(j["xhi"]), np.asarray(j["j21"])
    xt, jt = t["xhi"].numpy(), t["j21"].numpy()
    margin = t["margin"].numpy()
    flip = ((xt == 0) != (xj == 0)) | (np.abs(jt - jj)
                                       > 1e-5 * np.abs(jj).max())
    assert (margin[flip] < 1e-4).all(), (flip.sum(), margin[flip].max())
    assert flip.sum() <= max(2, xj.size // 1000), flip.sum()
    near = flip | (margin < 1e-4)
    for got, want in ((xt, xj), (xt, x64), (xj, x64)):
        err = np.abs(got - want)[~near]
        bound = 1e-5 + rounding[~near]
        assert (err <= bound).all(), (err / bound).max()
    assert 0 < (xt == 0).sum() < xt.size and (jt > 0).any()
    partial = (xj > 0) & (xj < 1)
    if case[0] == "smooth":     # held at 1e-5: no rounding to speak of
        assert partial.sum() > xj.size // 4
        assert (rounding[partial] < 1e-6).all(), rounding[partial].max()
    for k in ("volume_weighted_global_xHI", "mass_weighted_global_xHI"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-3)


def test_readout_and_rates_match_jax(excursion_runs):
    """readout_j21_max on the J21 grid at every particle and at positions
    on cell boundaries, j21_to_rates bit for bit (float64), and
    escape_fractions."""
    j, t, ipos, _ = excursion_runs["tophat", 32, False]
    grid = t["j21"]
    extra = np.array([[0, 0, 0], [2 ** 32 - 1] * 3, [2 ** 27] * 3],
                     np.int64)
    ip = np.concatenate([ipos, extra])
    want = np.asarray(ju.readout_j21_max(jnp.asarray(grid.numpy()),
                                         jnp.asarray(ip.astype(np.uint32))))
    got = tu.readout_j21_max(grid, torch.as_tensor(ip)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got > 0).any()
    for alpha in (3.0, 5.0):
        gj, ej = ju.j21_to_rates(jnp.asarray(got), alpha)
        gt, et = tu.j21_to_rates(torch.as_tensor(got), alpha)
        for a, b in zip(gj + ej, gt + et):
            assert b.dtype == torch.float64
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    hm = np.array([0.0, 1e-4, 0.01, 1.0, 30.0, 1e5], np.float32)
    for norm, scaling in ((0.2, 0.5), (1.0, 0.0), (0.5, -0.3)):
        np.testing.assert_allclose(
            tu.escape_fractions(torch.as_tensor(hm), norm, scaling,
                                1.989e43, 0.7).numpy(),
            np.asarray(ju.escape_fractions(jnp.asarray(hm), norm, scaling,
                                           1.989e43, 0.7)), rtol=1e-6)


# ---- QSO lightup -------------------------------------------------------------

def test_heii_history_matches_jax(tmp_path):
    """load_heii_reion_hist, Q_inst, the desired HeIII fraction and the
    LMFP heating rate, bit for bit; a malformed table raises."""
    path = write_heii_history(tmp_path / "heii.txt")
    hj, ht = jq.load_heii_reion_hist(path), tq.load_heii_reion_hist(path)
    for k in ("atime", "xheiii", "lmfp"):
        np.testing.assert_array_equal(getattr(ht, k), getattr(hj, k))
    assert (ht.alpha_q, ht.emax, ht.qso_inst_heating, ht.zstart) \
        == (hj.alpha_q, hj.emax, hj.qso_inst_heating, hj.zstart)
    pj, pt = jq.QSOParams(heiii_start=hj.zstart), \
        tq.QSOParams(heiii_start=ht.zstart)
    for a in (0.15, 0.2, 0.22, 0.25, 0.27, 0.3):
        assert tq.desired_heiii_frac(ht, a) == jq.desired_heiii_frac(hj, a)
        assert tq.lmfp_heating(ht, pt, a) == jq.lmfp_heating(hj, pj, a)
    with open(tmp_path / "bad.txt", "w") as fh:
        fh.write("1.7\n4.0 0.0 0.0\n")
    with pytest.raises(ValueError, match="Malformed"):
        tq.load_heii_reion_hist(tmp_path / "bad.txt")


def _qso_gas(n=2000, seed=0):
    rng = np.random.RandomState(seed)
    ipos = rng.randint(0, 2 ** 32, (n, 3), dtype=np.int64)
    is_gas = rng.uniform(size=n) < 0.8
    density = rng.uniform(0.5, 4.0, n).astype(np.float32)
    entropy = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return ipos, is_gas, density, entropy


def _near_radius(ipos, center, radius):
    """Rows whose float64 distance from center lies within 1e-6 of the
    radius (box units)."""
    d = ipos / 2 ** 32 - np.asarray(center, np.float64)
    d -= np.round(d)
    return np.abs(np.sqrt((d ** 2).sum(1)) - radius) < 1e-6


def test_ionize_bubble_matches_jax():
    """One bubble: the same rows ionized and heated, the count, and no
    second heating of ionized rows."""
    ipos, is_gas, density, entropy = _qso_gas()
    center = np.array([0.9, 0.5, 0.05], np.float32)     # wraps in x, z
    ionized = np.zeros(len(ipos), bool)
    ionized[::9] = True
    args = (0.23, 3.5, np.float32(8.0))
    jo = jq._ionize_bubble(jnp.asarray(ipos.astype(np.uint32)),
                           jnp.asarray(is_gas), jnp.asarray(ionized),
                           jnp.asarray(density), jnp.asarray(entropy),
                           jnp.asarray(center), *[jnp.float32(a)
                                                  for a in args])
    to = tq._ionize_bubble(torch.as_tensor(ipos), torch.as_tensor(is_gas),
                           torch.as_tensor(ionized),
                           torch.as_tensor(density),
                           torch.as_tensor(entropy),
                           torch.as_tensor(center), *[float(a)
                                                      for a in args])
    ok = ~_near_radius(ipos, center, 0.23)
    np.testing.assert_array_equal(to[0].numpy()[ok], np.asarray(jo[0])[ok])
    np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), rtol=1e-6)
    assert abs(to[2] - int(jo[2])) <= (~ok).sum() and to[2] > 50


@pytest.mark.parametrize("var,flash", [(0.0, False), (4e5, False),
                                       (0.0, True)])
def test_place_bubbles_matches_jax(tmp_path, var, flash):
    """place_bubbles on the same catalogue: the same bubbles in the same
    order (helium.txt), the same ionized rows, entropies within 1e-6; with
    a variance the radii are drawn, past the finish fraction the rest is
    flash-ionized."""
    ipos, is_gas, density, entropy = _qso_gas(3000, 4)
    rng = np.random.RandomState(9)
    cat = {"masses": rng.uniform(10, 2000, 40),
           "cm": rng.uniform(0, 5000.0, (40, 3))}
    hist_rows = ((4.0, 0.0, 0.0), (3.5, 0.3, 1e-33), (3.0, 0.7, 2e-33),
                 (2.8, 0.999, 1e-33))
    path = write_heii_history(tmp_path / "heii.txt", hist_rows)
    atime = 1 / 3.6 if not flash else 1 / 2.85
    outs = {}
    for name, mod in (("jax", jq), ("torch", tq)):
        hist = mod.load_heii_reion_hist(path)
        par = mod.QSOParams(min_mass=100.0, max_mass=1000.0,
                            mean_bubble=900.0, var_bubble=var,
                            heiii_start=hist.zstart).with_units(1e10)
        odir = tmp_path / name
        odir.mkdir()
        if name == "jax":
            put = jnp.asarray
            ip = jnp.asarray(ipos.astype(np.uint32))
        else:
            put = torch.as_tensor
            ip = torch.as_tensor(ipos)
        ion, ent, nb = mod.place_bubbles(
            ip, put(is_gas), put(np.zeros(len(ipos), bool)), put(density),
            put(entropy), cat, hist, par, atime, 5000.0, 42, str(odir))
        with open(odir / "helium.txt") as fh:
            lines = fh.read().splitlines()
        outs[name] = (np.asarray(_np(ion)), np.asarray(_np(ent)), nb, lines)
    (ij, ej, nj, lj), (it, et, nt, lt) = outs["jax"], outs["torch"]
    assert nt == nj and len(lt) == len(lj) >= 1
    for a, b in zip(lj, lt):
        assert a.split()[:4] == b.split()[:4]
        assert abs(int(a.split()[-1]) - int(b.split()[-1])) <= 2
    diff = it != ij
    assert diff.sum() <= 2, diff.sum()
    np.testing.assert_allclose(et[~diff], ej[~diff], rtol=1e-6)
    assert it.sum() > (0.2 if not flash else 0.79) * is_gas.sum()


def test_lmfp_heat_entropy_matches_jax():
    """The long-mean-free-path heating of the not-yet-ionized rows."""
    _, is_gas, density, entropy = _qso_gas(500, 2)
    notion = is_gas & (np.arange(500) % 3 > 0)
    args = (2e-30, 3e15, 0.22, UNITS, 0.7)
    want = np.asarray(jq.lmfp_heat_entropy(
        jnp.asarray(entropy), jnp.asarray(density), jnp.asarray(notion),
        *args))
    got = tq.lmfp_heat_entropy(torch.as_tensor(entropy),
                               torch.as_tensor(density),
                               torch.as_tensor(notion), *args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got[notion] > entropy[notion]).all()
    np.testing.assert_array_equal(got[~notion], entropy[~notion])
