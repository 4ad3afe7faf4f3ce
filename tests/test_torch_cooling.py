"""The port's cooling network (physics/cooling.py) against the JAX package.

The same numpy inputs, made from a seed, go through the JAX functions on
the CPU and the port's plain versions; tests/test_torch_cuda.py holds the
kernel K6 to those plain versions on a card.

The grid: n_H 1e-7 ... 1e3 cm^-3 and T 1e2 ... 1e8 K (log-uniform), ne/nh
uniform in [0, 1.2] with some zeros, z in {0, 3, 99}, without and with a
UV background (self-shielding on).  Tolerances, each measured on these
inputs with a margin:

* the rate functions (eager JAX, one XLA operation at a time): 2e-6
  relative in float32 (1.3e-6 measured), 1e-14 in float64, and 1e-37
  absolute, because XLA on the CPU flushes float32 denormals to zero and
  PyTorch and the card keep them (the Voronov ionization rates of cold
  gas are denormal); Enzo2Nyx's collisH0 in float32 1e-4 (3.1e-5
  measured): exp of a degree-5 polynomial in log T near -60 multiplies
  one rounding of log T by ~60;
* the equilibrium ne and the net rate against JAX run op by op
  (``jax.disable_jit``): ne/nh within 1e-6, the rate within 4e-6 of its
  value plus 1e-7 of the largest |rate| in float32 (2.4e-7 and 8.5e-7
  measured; with Enzo2Nyx cooling the rate within 1e-3, 1.8e-4
  measured, for its collisH0); 1e-9 relative in float64.  The JAX package's compiled loop
  fuses the same operations, and XLA rounds the fusion otherwise: where
  the 30 Steffensen iterations have not converged (dense self-shielded
  gas started far from equilibrium) the two trajectories part, by up to
  0.014 in ne/nh on this grid, and the op-by-op run is the comparison
  that holds the arithmetic;
* do_cooling against the compiled JAX function (what the run calls):
  its 50 bisection steps carry ne, so the fixed point converges; u_new
  within 2e-5 relative (3.7e-6 measured), ne/nh within 2e-6 + 2e-3
  relative (3.6e-7 and 5.7e-4); float64 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgadget_tpu.physics import cooling as jcool
from mpgadget_tpu.utils import constants as C
from mpgadget_tpu_torch.physics import cooling as tcool

torch.set_num_threads(1)

UVB = dict(gJH0=1e-12, gJHe0=8e-13, gJHep=3e-14, epsH0=5e-24,
           epsHe0=6e-24, epsHep=2e-25, self_shield_dens=5e-3)
RATES = ("alphaHp", "alphaHepd", "alphaHepp", "GammaeH0", "GammaeHe0",
         "GammaeHep", "collisH0", "collisHe0", "collisHeP", "recombHp",
         "recombHeP", "recombHePP")
OPTIONS = [(r, c) for r in (tcool.CEN92, tcool.VERNER96, tcool.BADNELL06)
           for c in (tcool.KWH92, tcool.ENZO2NYX, tcool.SHERWOOD)]


def _pair(recomb=tcool.VERNER96, cooling=tcool.SHERWOOD, **kw):
    """The same rates object in both packages."""
    jp = jcool.CoolingParams(recomb=recomb, cooling=cooling, **kw)
    tp = tcool.CoolingParams(recomb=recomb, cooling=cooling, **kw)
    return (jcool.CoolingRates(jp, jcool.TreeCool(None, jp)),
            tcool.CoolingRates(tp, tcool.TreeCool(None, tp)))


def _uv(on):
    return (jcool.UVBG(**UVB), tcool.UVBG(**UVB)) if on else \
        (jcool.UVBG(), tcool.UVBG())


def _grid(n, seed):
    """(density protons/cm^3, u erg/g, ne/nh) over the module's grid."""
    rng = np.random.default_rng(seed)
    nh = 10 ** rng.uniform(-7, 3, n)
    temp = 10 ** rng.uniform(2, 8, n)
    ne = rng.uniform(0, 1.2, n)
    ne[::7] = 0.0
    u = temp * C.BOLTZMANN / (C.GAMMA_MINUS1 * 0.6 * C.PROTONMASS)
    return nh / C.HYDROGEN_MASSFRAC, u, ne


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("recomb,cooling", OPTIONS)
def test_rates_match_jax(recomb, cooling):
    """Every rate coefficient (make_rates) of each recombination and
    cooling option, float32 and float64, over T 1e2 ... 1e8 K."""
    jc, tc = _pair(recomb, cooling)
    temp = np.logspace(2, 8, 241)
    for dt in (np.float32, np.float64):
        tj, tt = jnp.asarray(temp, dt), torch.as_tensor(temp.astype(dt))
        rtol = 2e-6 if dt == np.float32 else 1e-14
        for name in RATES:
            want, got = _np(jc.rates[name](tj)), _np(tc.rates[name](tt))
            assert got.dtype == want.dtype, name
            enzo = name == "collisH0" and cooling == tcool.ENZO2NYX
            np.testing.assert_allclose(
                got, want, rtol=1e-4 if enzo and dt == np.float32 else rtol,
                atol=1e-37, err_msg=name)
        for zz in (1, 2):
            np.testing.assert_allclose(
                _np(tc.rates["freefree"](tt, zz)),
                _np(jc.rates["freefree"](tj, zz)), rtol=rtol, atol=1e-37)


@pytest.mark.parametrize("recomb,cooling", OPTIONS)
def test_rate_options_through_the_network(recomb, cooling):
    """get_heatingcooling_rate with each rate option, float32, with a UV
    background, against JAX op by op (36 grid points at z = 3)."""
    jc, tc = _pair(recomb, cooling)
    juv, tuv = _uv(True)
    dens, u, ne = _grid(36, 5)
    with jax.disable_jit():
        lj, nj = jc.get_heatingcooling_rate(
            jnp.asarray(dens, jnp.float32), jnp.asarray(u, jnp.float32),
            3.0, 0.0, juv, jnp.asarray(ne, jnp.float32))
    lt, nt = tc.get_heatingcooling_rate(
        torch.as_tensor(dens, dtype=torch.float32),
        torch.as_tensor(u, dtype=torch.float32), 3.0, tuv,
        torch.as_tensor(ne, dtype=torch.float32))
    lj, nj = _np(lj).astype(np.float64), _np(nj).astype(np.float64)
    lt, nt = _np(lt).astype(np.float64), _np(nt).astype(np.float64)
    np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-6)
    # Enzo2Nyx's collisH0 (module docstring): 1.8e-4 measured
    rtol = 1e-3 if cooling == tcool.ENZO2NYX else 4e-6
    np.testing.assert_allclose(lt, lj, rtol=rtol,
                               atol=1e-7 * np.abs(lj).max())


@pytest.fixture(scope="module")
def network_runs():
    """The equilibrium ne (which does not depend on z) and the net rate at
    z = 0 and 99 on 400 grid points, without and with the UV background,
    float32 and float64: JAX op by op and the port."""
    jc, tc = _pair()
    dens, u, ne = _grid(400, 7)
    out = {}
    for uv in (False, True):
        juv, tuv = _uv(uv)
        for dt in (np.float32, np.float64):
            tdt = torch.float32 if dt == np.float32 else torch.float64
            jargs = [jnp.asarray(x, dt) for x in (dens, u, ne)]
            targs = [torch.as_tensor(x, dtype=tdt) for x in (dens, u, ne)]
            with jax.disable_jit():
                j = [jc.get_equilib_ne(jargs[0], jargs[1], juv, jargs[2])]
                for z in (0.0, 99.0):
                    j += jc.get_heatingcooling_rate(
                        jargs[0], jargs[1], z, 0.0, juv, jargs[2])
            t = [tc.get_equilib_ne(targs[0], targs[1], tuv, targs[2])]
            for z in (0.0, 99.0):
                t += tc.get_heatingcooling_rate(targs[0], targs[1], z, tuv,
                                                targs[2])
            out[uv, dt] = [(_np(a).astype(np.float64),
                            _np(b).astype(np.float64)) for a, b in zip(j, t)]
    return out, dens


@pytest.mark.parametrize("uv", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_equilib_ne_and_rate_match_jax(network_runs, uv, dtype):
    """get_equilib_ne and get_heatingcooling_rate over the grid (module
    docstring), against JAX op by op."""
    runs, dens = network_runs
    nh = dens * C.HYDROGEN_MASSFRAC
    (ej, et), *rest = runs[uv, dtype]
    for (lj, lt), (nj, nt) in zip(rest[::2], rest[1::2]):
        if dtype == np.float32:
            np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-6)
            np.testing.assert_allclose(et / nh, ej / nh, rtol=0, atol=1e-6)
            np.testing.assert_allclose(lt, lj, rtol=4e-6,
                                       atol=1e-7 * np.abs(lj).max())
        else:
            for a, b in ((lt, lj), (nt, nj), (et, ej)):
                np.testing.assert_allclose(a, b, rtol=1e-9,
                                           atol=1e-12 * np.abs(b).max())
        assert np.all(np.isfinite(lt)) and np.all(nt >= 0)


def _cooling_inputs(n, seed):
    """do_cooling's inputs in internal units (kpc, 1e10 Msun, km/s)."""
    from mpgadget_tpu.utils import get_unitsystem
    units = get_unitsystem(C.CM_PER_KPC, 1.989e43, 1e5)
    h = 0.7
    cu = dict(density_in_phys_cgs=units.UnitDensity_in_cgs * h * h,
              uu_in_cgs=units.UnitInternalEnergy_in_cgs,
              tt_in_s=units.UnitTime_in_s / h)
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
    return (u, rho, dt, ne), min_egy, cu


@pytest.fixture(scope="module")
def cooling_runs():
    """do_cooling on 96 particles, compiled JAX and the port, for each of
    (UV background off/on) x (float32, float64), with the port's
    bisection steps counted; the port's float32 run also on a listed
    subset of the rows."""
    jc, tc = _pair()
    ins, min_egy, cu = _cooling_inputs(96, 11)
    out = {}
    step = tcool.bisection_step

    def counted(*a):
        out["steps", uv, dt] += 1
        return step(*a)

    for uv in (False, True):
        juv, tuv = _uv(uv)
        for dt in (np.float32, np.float64):
            tdt = torch.float32 if dt == np.float32 else torch.float64
            j = jcool.do_cooling(jc, 2.0, *[jnp.asarray(x, dt)
                                            for x in ins[:3]], juv,
                                 jnp.asarray(ins[3], dt), None, min_egy,
                                 jcool.CoolingUnits(**cu))
            targs = [torch.as_tensor(x, dtype=tdt) for x in ins]
            out["steps", uv, dt] = 0
            tcool.bisection_step = counted
            try:
                t = tcool.do_cooling(tc, 2.0, *targs[:3], tuv, targs[3],
                                     min_egy, tcool.CoolingUnits(**cu))
            finally:
                tcool.bisection_step = step
            out[uv, dt] = (j, t)
            if dt == np.float32 and uv:
                rows = torch.arange(1, 96, 3)
                out["rows"] = (rows, targs, tcool.do_cooling(
                    tc, 2.0, *targs[:3], tuv, targs[3], min_egy,
                    tcool.CoolingUnits(**cu), rows=rows))
    return out


@pytest.mark.parametrize("uv", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_do_cooling_matches_jax(cooling_runs, uv, dtype):
    """The implicit cooling step (u_new, ne/nh) against the JAX package's
    compiled do_cooling."""
    (uj, nj), (ut, nt) = cooling_runs[uv, dtype]
    uj, nj = _np(uj).astype(np.float64), _np(nj).astype(np.float64)
    assert ut.dtype == (torch.float32 if dtype == np.float32
                        else torch.float64)
    ut, nt = _np(ut).astype(np.float64), _np(nt).astype(np.float64)
    if dtype == np.float32:
        np.testing.assert_allclose(ut, uj, rtol=2e-5)
        np.testing.assert_allclose(nt, nj, rtol=2e-3, atol=2e-6)
    else:
        np.testing.assert_allclose(ut, uj, rtol=1e-9)
        np.testing.assert_allclose(nt, nj, rtol=1e-9, atol=1e-12)
    assert np.all(ut > 0)


def test_do_cooling_rows(cooling_runs):
    """An index list computes exactly those rows, as the full call does,
    and leaves the other rows' u and ne as they came in."""
    rows, (u, _, _, ne), (ur, nr) = cooling_runs["rows"]
    _, (uf, nf) = cooling_runs[True, np.float32]
    rest = torch.ones(96, dtype=torch.bool)
    rest[rows] = False
    assert torch.equal(ur[rows], uf[rows]) and torch.equal(nr[rows],
                                                           nf[rows])
    assert torch.equal(ur[rest], u[rest]) and torch.equal(nr[rest],
                                                          ne[rest])


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def test_iterate_closes_cycles_exactly():
    """tcool.iterate, the plain loops' exit, against every step taken: rows
    that enter a cycle of 1-5 iterates after 0-2 others, from several
    starts, with cycles of up to 1, 2, 4 and 16 iterates closed, 0-13 steps.
    Where the batch's iterates cycle with a period it closes, it returns
    the iterate the full count ends on; otherwise it takes every step."""
    for tail in range(3):
        for length in range(1, 6):
            succ = torch.tensor(list(range(1, tail + length)) + [tail])
            x0 = torch.tensor([0.0, min(1, tail + length - 1), tail])

            def step(x):
                return succ[x.long()].float()

            for period in (1, 2, 4, 16):
                for iters in range(14):
                    want = x0
                    for _ in range(iters):
                        want = step(want)
                    got = tcool.iterate(step, x0, iters, period)
                    assert torch.equal(_bits(got), _bits(want)), \
                        (tail, length, period, iters)


@pytest.mark.parametrize("uv", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_equilib_ne_exits_are_exact(uv, dtype, monkeypatch):
    """get_equilib_ne, which stops where the Steffensen iterates repeat,
    against equilib_ne_step run NE_ITERS times, bit for bit, on 16-row
    slices of the grid (self-shielded rows with the UV background, and a
    NaN row in the first slice); most slices stop early."""
    _, tc = _pair()
    _, tuv = _uv(uv)
    dens, u, ne = (torch.as_tensor(x[:128], dtype=torch.float32
                                   if dtype == np.float32 else torch.float64)
                   for x in _grid(400, 7))
    u[5] = float("nan")
    steps = []
    real = tcool.CoolingRates.equilib_ne_step

    def counted(*a):
        steps[-1] += 1
        return real(*a)

    for k in range(0, 128, 16):
        d, e, n = dens[k:k + 16], u[k:k + 16], ne[k:k + 16]
        nh = d * (1 - tc.helium)
        x = torch.where(n <= 0, 1.0, n)
        for _ in range(tcool.NE_ITERS):
            x = real(tc, nh, e, x, tc.helium, tuv)
        steps.append(0)
        monkeypatch.setattr(tcool.CoolingRates, "equilib_ne_step", counted)
        got = tc.get_equilib_ne(d, e, tuv, n)
        monkeypatch.setattr(tcool.CoolingRates, "equilib_ne_step", real)
        assert torch.equal(_bits(got), _bits(x * nh)), k
    assert steps[0] == tcool.NE_ITERS       # the NaN row never repeats
    assert sum(s < tcool.NE_ITERS for s in steps) >= 3


@pytest.mark.parametrize("uv", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_do_cooling_exits_are_exact(cooling_runs, uv, dtype):
    """do_cooling_reference, whose bisection stops where (u_lo, u_hi, ne)
    repeats, against bisection_step run BISECT_ITERS times on the same 96
    rows, bit for bit (in float32 the bisection stops early; in float64
    (u_lo, u_hi) keep halving past the cap)."""
    _, tc = _pair()
    _, tuv = _uv(uv)
    ins, min_egy, cu = _cooling_inputs(96, 11)
    ins = [torch.as_tensor(x, dtype=torch.float32 if dtype == np.float32
                           else torch.float64) for x in ins]
    units = tcool.CoolingUnits(**cu)
    br = tcool.cooling_bracket(*ins[:3], min_egy, units)
    st = (br.u_lo, br.u_hi, ins[3])
    for _ in range(tcool.BISECT_ITERS):
        st = tcool.bisection_step(tc, 2.0, tuv, br, *st)
    want = (torch.clamp(0.5 * (st[0] + st[1]), min=br.min_u)
            / units.uu_in_cgs, st[2])
    _, got = cooling_runs[uv, dtype]
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    steps = cooling_runs["steps", uv, dtype]
    assert (steps < tcool.BISECT_ITERS) == (dtype == np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_nan_or_a_signed_zero_is_no_repeat(dtype):
    """tcool.unchanged, the exit's test: equal bits, and no NaN (a NaN
    never equals itself) and no -0 against +0; so tcool.iterate takes
    every step of a batch holding a NaN row, as the plain cooling loops
    do (a NaN row on the real step: test_equilib_ne_exits_are_exact)."""
    x = torch.tensor([0.5, 0.0, 3.0], dtype=dtype)
    assert tcool.unchanged(x, x.clone())
    assert tcool.unchanged((x, x), (x.clone(), x.clone()))
    assert not tcool.unchanged(x, torch.tensor([0.5, -0.0, 3.0],
                                               dtype=dtype))
    y = torch.tensor([0.5, float("nan"), 3.0], dtype=dtype)
    assert not tcool.unchanged(y, y.clone())
    steps = []

    def step(v):
        steps.append(1)
        return v.clone()

    assert torch.equal(_bits(tcool.iterate(step, x, 30, 16)), _bits(x))
    assert len(steps) == 1
    got = tcool.iterate(step, y, 30, 16)
    assert len(steps) == 31 and torch.equal(_bits(got), _bits(y))


def _write_treecool(path):
    """A TreeCool table in the reference's layout: log10(1+z) and six
    rates, a comment line, one column zero at high z."""
    lz = np.linspace(0.0, 1.0, 21)
    tab = np.stack([lz] + [10 ** (-12 - c - 2 * lz) for c in range(3)]
                   + [10 ** (-24 - c - lz) for c in range(3)], axis=1)
    tab[-3:, 3] = 0.0
    with open(path, "w") as fh:
        fh.write("# log10(1+z) GH1 GHe1 GHe2 eH1 eHe1 eHe2\n")
        for row in tab:
            fh.write(" ".join(f"{x:.6e}" for x in row) + "\n")


def test_treecool_matches_jax(tmp_path):
    """TreeCool from a table the test writes, and TreeCool(None): the same
    UVBG at every redshift (interpolation, self-shielding density, the UVB
    off beyond the table), and the same net rate with it."""
    path = str(tmp_path / "TREECOOL")
    _write_treecool(path)
    jp, tp = jcool.CoolingParams(), tcool.CoolingParams()
    for p in (path, None):
        jt, tt = jcool.TreeCool(p, jp), tcool.TreeCool(p, tp)
        for z in (0.0, 0.7, 2.5, 8.99, 9.5, 30.0):
            assert jt.get_global_uvbg(z).__dict__ \
                == tt.get_global_uvbg(z).__dict__, (p, z)
    jt, tt = jcool.TreeCool(path, jp), tcool.TreeCool(path, tp)
    assert tt.get_global_uvbg(2.5).gJH0 > 0
    assert tt.get_global_uvbg(9.5).gJH0 == 0 and \
        tcool.TreeCool(None, tp).get_global_uvbg(2.5).gJH0 == 0
    jc, tc = jcool.CoolingRates(jp, jt), tcool.CoolingRates(tp, tt)
    dens, u, ne = _grid(24, 13)
    with jax.disable_jit():
        lj, nj = jc.get_heatingcooling_rate(
            jnp.asarray(dens, jnp.float32), jnp.asarray(u, jnp.float32),
            2.5, 0.0, jt.get_global_uvbg(2.5), jnp.asarray(ne, jnp.float32))
    lt, nt = tc.get_heatingcooling_rate(
        torch.as_tensor(dens, dtype=torch.float32),
        torch.as_tensor(u, dtype=torch.float32), 2.5,
        tt.get_global_uvbg(2.5), torch.as_tensor(ne, dtype=torch.float32))
    lj = _np(lj).astype(np.float64)
    np.testing.assert_allclose(_np(nt), _np(nj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(lt), lj, rtol=4e-6,
                               atol=1e-7 * np.abs(lj).max())


def test_helium_heating_matches_jax():
    """HeliumHeatOn: the overdensity-dependent heating factor."""
    kw = dict(HeliumHeatOn=True, HeliumHeatThresh=10.0, HeliumHeatAmp=1.5,
              HeliumHeatExp=-0.5, rho_crit_baryon=0.0455 * 1.8788e-29)
    jc, tc = _pair(**kw)
    juv, tuv = _uv(True)
    dens, u, ne = _grid(36, 17)
    with jax.disable_jit():
        lj, _ = jc.get_heatingcooling_rate(
            jnp.asarray(dens, jnp.float32), jnp.asarray(u, jnp.float32),
            3.0, 0.0, juv, jnp.asarray(ne, jnp.float32))
    lt, _ = tc.get_heatingcooling_rate(
        torch.as_tensor(dens, dtype=torch.float32),
        torch.as_tensor(u, dtype=torch.float32), 3.0, tuv,
        torch.as_tensor(ne, dtype=torch.float32))
    lj = _np(lj).astype(np.float64)
    np.testing.assert_allclose(_np(lt), lj, rtol=4e-6,
                               atol=1e-7 * np.abs(lj).max())
    _, tc_off = _pair()
    l_off, _ = tc_off.get_heatingcooling_rate(
        torch.as_tensor(dens, dtype=torch.float32),
        torch.as_tensor(u, dtype=torch.float32), 3.0, tuv,
        torch.as_tensor(ne, dtype=torch.float32))
    assert not torch.equal(l_off, lt)


def test_wrappers_use_the_plain_versions_on_the_cpu():
    """On CPU tensors the K6 wrappers return the plain versions' values
    and launch nothing."""
    jc, tc = _pair()
    _, tuv = _uv(True)
    dens, u, ne = _grid(8, 19)
    args = [torch.as_tensor(x, dtype=torch.float32) for x in (dens, u, ne)]
    before = tcool.LAUNCHES
    lam, nn = tcool.heatingcooling_rate(tc, args[0], args[1], 3.0, tuv,
                                        args[2])
    ref = tc.get_heatingcooling_rate(args[0], args[1], 3.0, tuv,
                                     args[2])
    assert torch.equal(lam, ref[0]) and torch.equal(nn, ref[1])
    assert tcool.LAUNCHES == before


def test_rows_outside_the_arrays_raise():
    """An index list reaching past the arrays is refused before any
    computation (K6 would write out of bounds)."""
    _, tc = _pair()
    _, tuv = _uv(False)
    dens, u, ne = (torch.as_tensor(x, dtype=torch.float32)
                   for x in _grid(8, 23))
    for rows in (torch.tensor([0, 8]), torch.tensor([-1])):
        with pytest.raises(ValueError, match="rows outside"):
            tcool.heatingcooling_rate(tc, dens, u, 3.0, tuv, ne, rows=rows)
        with pytest.raises(ValueError, match="rows outside"):
            tcool.do_cooling(tc, 3.0, u, dens, dens, tuv, ne, 0.0,
                             tcool.CoolingUnits(1.0, 1.0, 1.0), rows=rows)
