"""The port's winds, metal return and black holes, module by module, against
the JAX package.

The same inputs, made with numpy from a seed, go through each JAX function
and its counterpart in mpgadget_tpu_torch (on the CPU: the neighbour walk
runs its plain version, ops/pairs.find_neighbors_reference, and the pair
sums ops/pairs.pair_reduce).  The BH functions run on
tests/test_blackhole.py's set-up (make_bh_setup: a BH at the centre of a
uniform gas cube), with a second BH and stars added where a function
needs them.

Tolerances: the IMF, lifetimes, the SN1a number, stellar_return and the
age table 1e-6 relative; the pair-sum outputs (metal_return_step, the
velocity dispersion, the BH sums, the winds' kicks) 1e-5 relative by
norm, since both packages sum float32 pair terms, in different orders;
the host-side and per-particle functions 1e-6; every mask (kicked,
swallowed, seeded, found), bhrow, the merger pairs and the minimum-
potential positions identical.
"""

from dataclasses import fields

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpgadget_tpu.particles import ParticleData as JParticleData
from mpgadget_tpu.particles import pos_to_fixed
from mpgadget_tpu.physics import blackhole as jbh
from mpgadget_tpu.physics import metal_return as jmr
from mpgadget_tpu.physics import sfr as jsfr
from mpgadget_tpu.physics import winds as jwinds
from mpgadget_tpu.physics import yield_tables as jyt
from mpgadget_tpu.physics.stars import StarData as JStarData
from mpgadget_tpu.sph.state import SphData as JSphData
from mpgadget_tpu_torch.particles import ParticleData
from mpgadget_tpu_torch.physics import blackhole as tbh
from mpgadget_tpu_torch.physics import metal_return as tmr
from mpgadget_tpu_torch.physics import sfr as tsfr
from mpgadget_tpu_torch.physics import winds as twinds
from mpgadget_tpu_torch.physics import yield_tables as tyt
from mpgadget_tpu_torch.physics.stars import StarData
from mpgadget_tpu_torch.sph.state import SphData
from mpgadget_tpu_torch.utils import threefry

from test_blackhole import make_bh_setup

torch.set_num_threads(1)

REL = 1e-6          # host-side and per-particle functions
PAIR_TOL = 1e-5     # pair sums, by norm


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _close(got, want, rtol=REL, msg=""):
    got = _np(got).astype(np.float64)
    want = _np(want).astype(np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max(), err_msg=msg)


def _norm_close(got, want, tol=PAIR_TOL, msg=""):
    got = _np(got).astype(np.float64)
    want = _np(want).astype(np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300)
    assert err <= tol, (msg, err)


# -- yields, IMF, lifetimes ---------------------------------------------

def test_yield_tables_match_jax():
    """The SNII and AGB grids and their bilinear interpolation, inside the
    grids, on their nodes and clamped beyond their edges (as
    tests/test_metal_return.py:148)."""
    for name in ("SNII_MASSES", "SNII_Z", "AGB_MASSES", "AGB_Z"):
        np.testing.assert_array_equal(getattr(tyt, name),
                                      getattr(jyt, name))
    m = np.array([0.5, 1.0, 2.2, 7.9, 8.0, 13.0, 17.3, 40.0, 60.0],
                 np.float32)
    z = np.array([0.0, 1e-4, 0.003, 0.02, 0.03, 0.004, 0.01, 0.02, 0.05],
                 np.float32)
    for fn in ("snii_produced", "agb_produced"):
        want = getattr(jyt, fn)(jnp.asarray(m), jnp.asarray(z))
        got = getattr(tyt, fn)(_t(m), _t(z))
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], msg=f"{fn} {k}")
    o = _np(tyt.snii_produced(_t(m[-3:]), _t(np.full(3, 0.02, np.float32)))
            ["O"])
    assert np.isclose(o[1], 5.3, rtol=1e-5) and o[2] == o[1]


def test_imf_lifetimes_yields_match_jax():
    """imf_xi (float64, as the JAX package's), lifetime_myr, mass_dying,
    remnant_mass and produced_fractions, to 1e-6."""
    m = np.geomspace(0.1, 40.0, 257).astype(np.float32)
    z = np.float32(0.012)
    xi = tmr.imf_xi(_t(m))
    assert xi.dtype == torch.float64
    _close(xi, jmr.imf_xi(jnp.asarray(m)), msg="imf_xi")
    _close(tmr.lifetime_myr(_t(m), z), jmr.lifetime_myr(jnp.asarray(m), z),
           msg="lifetime")
    t = np.geomspace(1.0, 1.3e4, 97).astype(np.float32)
    _close(tmr.mass_dying(_t(t), z), jmr.mass_dying(jnp.asarray(t), z),
           msg="mass_dying")
    _close(tmr.remnant_mass(_t(m)), jmr.remnant_mass(jnp.asarray(m)))
    prod, ej = tmr.produced_fractions(_t(m), 0.004)
    jprod, jej = jmr.produced_fractions(jnp.asarray(m), 0.004)
    _close(ej, jej, msg="ejecta")
    for i, (a, b) in enumerate(zip(prod, jprod)):
        _close(a, b, msg=f"produced {i}")


def test_sn1a_and_stellar_return_match_jax():
    """sn1a_number and stellar_return over ages from the first SNII to a
    Hubble time, at three metallicities: 1e-6 relative."""
    rng = np.random.RandomState(3)
    age0 = rng.uniform(0.0, 2000.0, 64).astype(np.float32)
    age1 = (age0 + rng.uniform(0.0, 5000.0, 64)).astype(np.float32)
    age0[:4] = [0.0, 1e-3, 30.0, 13.7e3]
    z = rng.choice([1e-4, 0.004, 0.02], 64).astype(np.float32)
    mi = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    _close(tmr.sn1a_number(_t(age0), _t(age1), _t(z), 1.3e-3),
           jmr.sn1a_number(jnp.asarray(age0), jnp.asarray(age1),
                           jnp.asarray(z), 1.3e-3), msg="sn1a")
    mret, gen = tmr.stellar_return(_t(age0), _t(age1), _t(z), _t(mi),
                                   1.3e-3)
    jret, jgen = jmr.stellar_return(age0, age1, z, mi, 1.3e-3)
    assert mret.dtype == gen.dtype == torch.float64
    _close(mret, jret, msg="mass returned")
    for i in range(tmr.NMETALS):
        _close(gen[:, i], np.asarray(jgen)[:, i], msg=f"metal {i}")


def test_age_table_matches_jax():
    """AgeTable: t(a) in Myr at scalars and per-star tensors."""
    from mpgadget_tpu.cosmology import Cosmology as JCosmology
    from mpgadget_tpu.utils import get_unitsystem as jget_units
    from mpgadget_tpu_torch.cosmology import Cosmology
    from mpgadget_tpu_torch.utils import get_unitsystem
    kw = dict(Omega0=0.288, OmegaBaryon=0.0472, OmegaLambda=0.712,
              HubbleParam=0.7)
    units = (3.085678e21, 1.989e43, 1e5)
    jcp = JCosmology(**kw).init_units(jget_units(*units))
    tcp = Cosmology(**kw).init_units(get_unitsystem(*units))
    jt = jmr.AgeTable(jcp.hubble_function, jget_units(*units), 0.7)
    tt = tmr.AgeTable(tcp.hubble_function, get_unitsystem(*units), 0.7,
                      device="cpu")
    a = np.array([5e-4, 0.05, 0.1, 0.1234, 0.2, 0.5, 1.0], np.float32)
    _close(tt(_t(a)), jt(jnp.asarray(a)), msg="tensor")
    for x in (0.1, 0.15, 0.2):
        _close(tt(x), jt(x), msg=f"scalar {x}")


# -- metal return step --------------------------------------------------

def _metal_box(seed=5):
    """tests/test_metal_return.py:73's box (stars among gas), gas masses and
    densities that vary, stars of mixed ages and metallicities."""
    rng = np.random.RandomState(seed)
    box = 1000.0
    ngas, nstar = 256, 16
    n = ngas + nstar + 16            # 16 free rows
    pos = rng.uniform(0, box, (n, 3))
    pos[ngas:ngas + nstar] = pos[:nstar] + rng.uniform(-20, 20, (nstar, 3))
    pos = np.mod(pos, box)
    ptype = np.concatenate([np.zeros(ngas, np.int32),
                            np.full(nstar, 4, np.int32),
                            np.ones(16, np.int32)])
    mass = rng.uniform(0.8e-3, 1.2e-3, n).astype(np.float32)
    valid = np.arange(n) < ngas + nstar
    is_gas = (ptype == 0) & valid
    is_star = (ptype == 4) & valid
    ft = np.where(is_star, rng.uniform(0.1, 0.3, n), 0.0).astype(np.float32)
    met = np.where(is_star, rng.choice([0.0, 0.004, 0.02], n),
                   0.0).astype(np.float32)
    smetals = np.zeros((n, 9), np.float32)
    smetals[:, 0], smetals[:, 1] = 0.74, 0.24
    smetals[:, 2:] = 0.02 / 7
    tmr_ = np.where(is_star, rng.uniform(0, 1e-4, n), 0.0).astype(np.float32)
    gmetals = np.zeros((n, 9), np.float32)
    gmetals[:, 0], gmetals[:, 1] = 0.76, 0.24
    return dict(box=box, pos=pos, mass=mass, ptype=ptype, valid=valid,
                is_gas=is_gas, is_star=is_star, ft=ft, met=met,
                smetals=smetals, tmr=tmr_, gmetals=gmetals,
                rho=np.where(is_gas, rng.uniform(0.5, 2.0, n),
                             0.0).astype(np.float32),
                hsml=rng.uniform(40.0, 80.0, n).astype(np.float32),
                n=n)


class _FlatAgeJax:
    def __call__(self, a):
        return jnp.asarray(a, jnp.float32) * 1.0e4


class _FlatAgeTorch:
    def __call__(self, a):
        return torch.as_tensor(a, dtype=torch.float32) * 1.0e4


@pytest.fixture(scope="module")
def metal_runs():
    b = _metal_box()
    ipos = pos_to_fixed(b["pos"], b["box"])
    jstars = JStarData.zeros(b["n"]).replace(
        formation_time=jnp.asarray(b["ft"]),
        metallicity=jnp.asarray(b["met"]), metals=jnp.asarray(b["smetals"]),
        total_mass_returned=jnp.asarray(b["tmr"]))
    tstars = StarData.zeros(b["n"], "cpu").replace(
        formation_time=_t(b["ft"]), metallicity=_t(b["met"]),
        metals=_t(b["smetals"]), total_mass_returned=_t(b["tmr"]))
    out = {"box": b}
    for name, ll in (("auto", None), ("static", 512)):
        par_j = jmr.MetalReturnParams()
        par_t = tmr.MetalReturnParams()
        want = jmr.metal_return_step(
            jnp.asarray(ipos), jnp.asarray(b["mass"]),
            jnp.asarray(b["hsml"]), jnp.asarray(b["rho"]),
            jnp.asarray(b["is_gas"]), jnp.asarray(b["is_star"]),
            jnp.asarray(b["hsml"]), jstars, jnp.asarray(b["gmetals"]),
            0.5, 0.6, _FlatAgeJax(), b["box"], par_j, ll_static=ll)
        got = tmr.metal_return_step(
            _t(ipos.astype(np.int64)), _t(b["mass"]), _t(b["hsml"]),
            _t(b["rho"]), _t(b["is_gas"]), _t(b["is_star"]), _t(b["hsml"]),
            tstars, _t(b["gmetals"]), 0.5, 0.6, _FlatAgeTorch(), b["box"],
            par_t, ll_static=ll)
        out[name] = (want, got)
    return out


@pytest.mark.parametrize("branch", ["auto", "static"])
def test_metal_return_step_matches_jax(metal_runs, branch):
    """metal_return_step on a seeded box (stars among gas), through the
    find_neighbors_auto branch and the fixed-capacity (ll_static) branch:
    every per-row output to 1e-5 by norm, the star hsml bisection to the
    same, and total mass conserved as in tests/test_metal_return.py:73."""
    want, got = metal_runs[branch]
    b = metal_runs["box"]
    for k in ("gas_mass", "gas_metals", "star_mass", "total_mass_returned",
              "last_enrichment_myr", "star_hsml"):
        _norm_close(got[k], want[k], msg=k)
    assert bool(got["ngb_overflow"]) == bool(want["ngb_overflow"]) is False
    ret = float(got["mass_returned_total"])
    assert ret > 0
    assert np.isclose(float(got["mass_received_total"]), ret, rtol=1e-4)
    _close(ret, float(want["mass_returned_total"]), rtol=1e-5)
    m_new = np.where(b["is_gas"], _np(got["gas_mass"]),
                     _np(got["star_mass"]))[b["valid"]]
    assert np.isclose(m_new.astype(np.float64).sum(),
                      b["mass"][b["valid"]].astype(np.float64).sum(),
                      rtol=1e-5)


# -- winds --------------------------------------------------------------

def _wind_params(module, model):
    par = module.WindParams(model=model)
    return module.init_winds(par, 0.1, 1.5e6, 3e-5, 3.08568e16)


@pytest.mark.parametrize("model", ["sh03", "ofjt10"])
def test_wind_kick_functions_match_jax(model):
    """get_wind_kick, winds_subgrid and winds_decouple_update with the sh03
    (subgrid | decouple | fixed efficiency) and ofjt10 (halo | decouple)
    flags: the kicked mask identical, the rest to 1e-6."""
    flags = {"sh03": 1 | 2 | 8, "ofjt10": 4 | 2}[model]
    jpar = _wind_params(jwinds, flags)
    tpar = _wind_params(twinds, flags)
    assert (jpar.wind_speed, jpar.max_free_travel_time,
            jpar.free_travel_dens_thresh) == (
        tpar.wind_speed, tpar.max_free_travel_time,
        tpar.free_travel_dens_thresh)
    rng = np.random.RandomState(11)
    n = 512
    vdisp = rng.uniform(0.0, 300.0, n).astype(np.float32)
    atime = 0.15
    for a, b in zip(twinds.get_wind_kick(tpar, _t(vdisp), atime),
                    jwinds.get_wind_kick(jpar, jnp.asarray(vdisp), atime)):
        _close(a, b, msg="get_wind_kick")
    pid = rng.randint(1, 2 ** 40, n).astype(np.int64)
    kw = dict(sm=rng.uniform(0, 2e-4, n).astype(np.float32),
              mass=rng.uniform(1e-4, 3e-4, n).astype(np.float32),
              vdisp=vdisp, vel=rng.randn(n, 3).astype(np.float32),
              entropy=rng.uniform(1, 10, n).astype(np.float32),
              density=rng.uniform(1e-6, 1e-3, n).astype(np.float32),
              delay_time=np.where(rng.rand(n) < 0.2,
                                  rng.uniform(0, 1e-3, n),
                                  0.0).astype(np.float32),
              eligible=rng.rand(n) < 0.7)
    want = jwinds.winds_subgrid(
        jpar, jax.random.PRNGKey(77), pid=jnp.asarray(pid), atime=atime,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = twinds.winds_subgrid(
        tpar, threefry.prng_key(77), pid=_t(pid), atime=atime,
        **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_array_equal(_np(got[3]), _np(want[3]))
    assert _np(got[3]).any()
    for a, b, name in zip(got[:3], want[:3], ("vel", "entropy", "delay")):
        _close(a, b, msg=name)
    dt = rng.uniform(0, 5e-4, n).astype(np.float32)
    for dtime in (2e-4, dt):
        _close(twinds.winds_decouple_update(
            tpar, _t(kw["delay_time"]), _t(kw["density"]),
            _t(dtime) if isinstance(dtime, np.ndarray) else dtime, atime),
            jwinds.winds_decouple_update(
                jpar, jnp.asarray(kw["delay_time"]),
                jnp.asarray(kw["density"]), jnp.asarray(dtime), atime))


def test_pair_uniform_bit_for_bit():
    """The uint32 hash of two IDs, bit for bit, on IDs whose sums cross
    2^24 and 2^32 (the int64 spelling wraps every product to 32 bits)."""
    rng = np.random.RandomState(2)
    a = np.concatenate([rng.randint(0, 2 ** 24, 300),
                        rng.randint(2 ** 24 - 50, 2 ** 24 + 50, 100),
                        rng.randint(2 ** 31, 2 ** 32, 300),
                        [0, 2 ** 32 - 1, 2 ** 24 - 1]]).astype(np.int64)
    b = np.concatenate([rng.randint(0, 2 ** 24, 300),
                        rng.randint(0, 100, 100),
                        rng.randint(2 ** 31, 2 ** 32, 300),
                        [0, 1, 1]]).astype(np.int64)
    assert ((a + b) >= 2 ** 32).any() and ((a + b) >= 2 ** 24).any()
    want = np.asarray(jwinds._pair_uniform(jnp.asarray(a, jnp.uint32),
                                           jnp.asarray(b, jnp.uint32)))
    got = _np(twinds.pair_uniform(_t(a), _t(b)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _wind_box(seed=9):
    """Gas in a 1 Mpc box around a few dense knots, DM beside it, and new
    stars in the knots with a hsml that reaches a few dozen gas
    particles."""
    rng = np.random.RandomState(seed)
    box = 1000.0
    ngas, ndm, nstar = 384, 256, 12
    knots = rng.uniform(0, box, (6, 3))
    gas = np.concatenate([
        knots[rng.randint(0, 6, 256)] + rng.normal(0, 25, (256, 3)),
        rng.uniform(0, box, (ngas - 256, 3))])
    dm = np.concatenate([
        knots[rng.randint(0, 6, 192)] + rng.normal(0, 30, (192, 3)),
        rng.uniform(0, box, (ndm - 192, 3))])
    star = knots[rng.randint(0, 6, nstar)] + rng.normal(0, 10, (nstar, 3))
    pos = np.mod(np.concatenate([gas, dm, star]), box)
    n = len(pos)
    ptype = np.concatenate([np.zeros(ngas, np.int32), np.ones(ndm, np.int32),
                            np.full(nstar, 4, np.int32)])
    vel = (rng.randn(n, 3) * 60.0).astype(np.float32)
    mass = np.where(ptype == 1, 5e-3, 1e-3).astype(np.float32)
    pid = (np.arange(n) + 1 + (ptype == 4) * 2 ** 40).astype(np.int64)
    pid[:8] += 2 ** 24 - 4          # ids that cross 2^24
    hsml = np.where(ptype == 4, 60.0, rng.uniform(20, 40, n)).astype(
        np.float32)
    return dict(box=box, pos=pos, ipos=pos_to_fixed(pos, box), n=n,
                ptype=ptype, vel=vel, mass=mass, pid=pid, hsml=hsml,
                is_gas=ptype == 0, is_dm=ptype == 1, new_star=ptype == 4,
                density=rng.uniform(1e-5, 1e-4, n).astype(np.float32),
                entropy=rng.uniform(1, 10, n).astype(np.float32),
                delay=np.where(rng.rand(n) < 0.1, 1e-3, 0.0).astype(
                    np.float32))


@pytest.mark.parametrize("radius", ["fixed", "per_particle"])
def test_dm_velocity_dispersion_matches_jax(radius):
    """dm_velocity_dispersion around the gas with the fixed search radius
    (2 mean separations), and around the stars with each target's own
    radius (radius_per_particle, the BH kinetic feedback's call): 1e-5 by
    norm."""
    w = _wind_box()
    if radius == "fixed":
        targets, kw = w["is_gas"], dict(mean_sep=w["box"] / 8.0)
    else:
        targets = w["new_star"]
        rpp = np.where(targets, w["hsml"], 0.0).astype(np.float32)
        kw = dict(mean_sep=0.0)
    want = jwinds.dm_velocity_dispersion(
        jnp.asarray(w["ipos"]), jnp.asarray(w["vel"]),
        jnp.asarray(w["mass"]), jnp.asarray(w["is_dm"]),
        jnp.asarray(targets), w["box"],
        radius_per_particle=(None if radius == "fixed"
                             else jnp.asarray(rpp)), **kw)
    got = twinds.dm_velocity_dispersion(
        _t(w["ipos"].astype(np.int64)), _t(w["vel"]), _t(w["mass"]),
        _t(w["is_dm"]), _t(targets), w["box"],
        radius_per_particle=None if radius == "fixed" else _t(rpp), **kw)
    assert (_np(got)[targets] > 0).any()
    _norm_close(np.where(targets, _np(got), 0.0),
                np.where(targets, np.asarray(want), 0.0))


def test_winds_via_neighbors_matches_jax():
    """ofjt10's kicks of the new stars' gas neighbours (three pair passes
    on one tree): the kicked mask identical, velocities, entropy and delay
    times to 1e-5."""
    w = _wind_box()
    jpar = _wind_params(jwinds, 4 | 2)
    tpar = _wind_params(twinds, 4 | 2)
    svd = np.where(w["new_star"], 60.0, 0.0).astype(np.float32)
    svd[-1] = 0.0                    # a star without dispersion: no kicks
    common = dict(boxsize=w["box"], atime=0.12)
    want = jwinds.winds_via_neighbors(
        jpar, jax.random.fold_in(jax.random.PRNGKey(7), 77),
        ipos=jnp.asarray(w["ipos"]), mass=jnp.asarray(w["mass"]),
        hsml=jnp.asarray(w["hsml"]), pid=jnp.asarray(w["pid"]),
        vel=jnp.asarray(w["vel"]), entropy=jnp.asarray(w["entropy"]),
        density=jnp.asarray(w["density"]),
        delay_time=jnp.asarray(w["delay"]), is_gas=jnp.asarray(w["is_gas"]),
        new_star=jnp.asarray(w["new_star"]), star_vdisp=jnp.asarray(svd),
        **common)
    got = twinds.winds_via_neighbors(
        tpar, threefry.fold_in(threefry.prng_key(7), 77),
        ipos=_t(w["ipos"].astype(np.int64)), mass=_t(w["mass"]),
        hsml=_t(w["hsml"]), pid=_t(w["pid"]), vel=_t(w["vel"]),
        entropy=_t(w["entropy"]), density=_t(w["density"]),
        delay_time=_t(w["delay"]), is_gas=_t(w["is_gas"]),
        new_star=_t(w["new_star"]), star_vdisp=_t(svd), **common)
    kicked = _np(got[3])
    np.testing.assert_array_equal(kicked, np.asarray(want[3]))
    assert 5 < kicked.sum() < w["is_gas"].sum()
    assert not (kicked & (w["delay"] > 0)).any()
    for a, b, name in zip(got[:3], want[:3], ("vel", "entropy", "delay")):
        _norm_close(a, b, msg=name)
    _close(_np(got[2])[kicked], np.asarray(want[2])[kicked], rtol=1e-5)


# -- black holes --------------------------------------------------------

@pytest.fixture(scope="module")
def bh_setup():
    """make_bh_setup's BH in a gas cube, with a second BH 3 kpc/h from the
    first, stars and DM among the gas, velocities, entropies and BH
    state; both packages' inputs."""
    jp, jhsml, box, n = make_bh_setup()
    rng = np.random.RandomState(21)
    ipos = np.asarray(jp.ipos).astype(np.int64)
    pos = ipos.astype(np.float64) * box / 2 ** 32
    ptype = np.asarray(jp.ptype).copy()
    ptype[1] = 5
    pos[1] = pos[0] + [3.0, 0.0, 0.0]
    ptype[2:120:4] = 4
    ptype[3:120:4] = 1
    ipos = pos_to_fixed(pos, box).astype(np.int64)
    is_bh, is_gas = ptype == 5, ptype == 0
    hsml = np.asarray(jhsml).copy()
    hsml[1] = 18.0
    d = dict(box=box, n=n, ipos=ipos, pos=pos, ptype=ptype, is_bh=is_bh,
             is_gas=is_gas, is_star=ptype == 4, is_dm=ptype == 1,
             mass=np.asarray(jp.mass).copy(), hsml=hsml,
             pid=np.asarray(jp.pid).astype(np.int64),
             vel=(rng.randn(n, 3) * 5).astype(np.float32),
             entropy=rng.uniform(40, 60, n).astype(np.float32),
             density=rng.uniform(0.005, 0.02, n).astype(np.float32),
             bh_mass=np.where(is_bh, [100.0, 40.0] + [0.0] * (n - 2),
                              0.0).astype(np.float32),
             mtrack=np.where(is_bh, [0.5, 3.0] + [0.0] * (n - 2),
                             0.0).astype(np.float32))
    return d


def _bh_sums(bs):
    j = jbh.bh_neighbor_sums(
        jnp.asarray(bs["ipos"].astype(np.uint32)), jnp.asarray(bs["mass"]),
        jnp.asarray(bs["hsml"]), jnp.asarray(bs["vel"]),
        jnp.asarray(bs["entropy"]), jnp.asarray(bs["is_bh"]),
        jnp.asarray(bs["is_gas"]), bs["box"])
    t = tbh.bh_neighbor_sums(
        _t(bs["ipos"]), _t(bs["mass"]), _t(bs["hsml"]), _t(bs["vel"]),
        _t(bs["entropy"]), _t(bs["is_bh"]), _t(bs["is_gas"]), bs["box"])
    return j, t


def test_bh_neighbor_sums_match_jax(bh_setup):
    """The accretion sums of both BHs (rho, feedback weight, smoothed
    entropy, gas velocity, enclosed gas mass): 1e-5 by norm."""
    j, t = _bh_sums(bh_setup)
    assert set(j) == set(t)
    assert (_np(t["rho"])[:2] > 0).all()
    for k in j:
        _norm_close(t[k], j[k], msg=k)


def test_bh_dynfric_sums_match_jax(bh_setup):
    """bh_dynfric_sums over stars and DM (BH_DynFrictionMethod 2):
    density, mean velocity and rms velocity at both BHs, 1e-5 by norm."""
    bs = bh_setup
    src = bs["is_star"] | bs["is_dm"]
    j = jbh.bh_dynfric_sums(
        jnp.asarray(bs["ipos"].astype(np.uint32)), jnp.asarray(bs["mass"]),
        jnp.asarray(bs["hsml"]), jnp.asarray(bs["vel"]),
        jnp.asarray(bs["is_bh"]), jnp.asarray(src), bs["box"])
    t = tbh.bh_dynfric_sums(
        _t(bs["ipos"]), _t(bs["mass"]), _t(bs["hsml"]), _t(bs["vel"]),
        _t(bs["is_bh"]), _t(src), bs["box"])
    for k in ("rho", "vel", "rmsvel"):
        _norm_close(np.asarray(t[k])[:2], np.asarray(j[k])[:2], msg=k)
    assert (_np(t["rho"])[:2] > 0).all()


def test_dynfric_bondi_kinetic_match_jax(bh_setup):
    """dynfric_accel, bondi_accretion and kinetic_update on the BH sums of
    the set-up, with the JAX package's float64 promotions: 1e-6."""
    bs = bh_setup
    j, t = _bh_sums(bs)
    G, atime, dtime = 43007.1, 0.2, 3e-3
    rng = np.random.RandomState(4)
    n = bs["n"]
    rho = np.where(bs["is_bh"], rng.uniform(0.5, 2, n), 0.0).astype(
        np.float32)
    vsur = rng.randn(n, 3).astype(np.float32)
    rms = rng.uniform(1, 10, n).astype(np.float32)
    wacc = jbh.dynfric_accel(jnp.asarray(rho), jnp.asarray(vsur),
                             jnp.asarray(rms), jnp.asarray(bs["mass"]),
                             jnp.asarray(bs["vel"]), atime, G, bmax=20.0,
                             boost=1.5)
    gacc = tbh.dynfric_accel(_t(rho), _t(vsur), _t(rms), _t(bs["mass"]),
                             _t(bs["vel"]), atime, G, bmax=20.0, boost=1.5)
    _close(gacc, wacc, msg="dynfric_accel")
    par_j, par_t = jbh.BHParams(), tbh.BHParams()
    gasvel_j = jnp.stack([j["vx"], j["vy"], j["vz"]], axis=-1)
    gasvel_t = torch.stack([t["vx"], t["vy"], t["vz"]], dim=-1)
    # the sums of one package into both: the rate alone compared
    want = jbh.bondi_accretion(
        par_j, jnp.asarray(bs["bh_mass"]), j["rho"], j["ent"], gasvel_j,
        jnp.asarray(bs["vel"]), atime, G, 3.08568e16, 0.7, dtime)
    got = tbh.bondi_accretion(
        par_t, _t(bs["bh_mass"]), _t(np.asarray(j["rho"])),
        _t(np.asarray(j["ent"])), _t(np.asarray(gasvel_j)), _t(bs["vel"]),
        atime, G, 3.08568e16, 0.7, dtime)
    for a, b in zip(got, want):
        _close(a, b, msg="bondi")
    assert (_np(got[0])[:2] > 0).all()
    kpar_j = jbh.BHParams(kinetic_on=True)
    kpar_t = tbh.BHParams(kinetic_on=True)
    args = (bs["bh_mass"], np.asarray(want[0]),
            np.asarray(j["rho"]), np.where(bs["is_bh"], 80.0, 0.0),
            np.asarray(j["mgas"]),
            np.where(bs["is_bh"], [1e9, 0.0] + [0.0] * (n - 2), 0.0))
    kw = (dtime, 3.08568e16, 0.7, 1e-8, 1e5)
    wk = jbh.kinetic_update(kpar_j, *[jnp.asarray(a, jnp.float32)
                                      for a in args], *kw)
    gk = tbh.kinetic_update(kpar_t, *[_t(a, torch.float32) for a in args],
                            *kw)
    _close(gk[0], wk[0], msg="ke energy")
    np.testing.assert_array_equal(_np(gk[1]), np.asarray(wk[1]))


@pytest.mark.parametrize("kinetic", [False, True])
def test_swallow_and_feedback_matches_jax(bh_setup, kinetic):
    """The gas-side swallow and feedback pass (a symmetric walk through
    the BHs' node hmax), with thermal feedback and with the kinetic
    channel releasing: the swallowed mask and bhrow identical, entropy
    and kick to 1e-5 by norm.  SeedBHDynMass on, so that the first BH
    swallows with its Mtrack."""
    bs = bh_setup
    j, _ = _bh_sums(bs)
    n = bs["n"]
    mdot = np.where(bs["is_bh"], [1.0, 0.3] + [0.0] * (n - 2),
                    0.0).astype(np.float32)
    kin = {}
    if kinetic:
        kin = dict(ke_energy=np.where(bs["is_bh"], [50.0, 0.0]
                                      + [0.0] * (n - 2), 0.0).astype(
                                          np.float32),
                   keflag=np.where(bs["is_bh"], [2, 1] + [0] * (n - 2),
                                   0).astype(np.int32))
    common = dict(boxsize=bs["box"], atime=0.5, dtime=0.1,
                  unit_velocity=1e5, uu_in_cgs=1e10)
    arrays = dict(mass=bs["mass"], hsml=bs["hsml"], entropy=bs["entropy"],
                  density=bs["density"], is_bh=bs["is_bh"],
                  is_gas=bs["is_gas"], pid=bs["pid"],
                  bh_mass=bs["bh_mass"], mdot=mdot,
                  bh_density=np.asarray(j["rho"]),
                  fbweight=np.asarray(j["fbweight"]), mtrack=bs["mtrack"],
                  **kin)
    want = jbh.swallow_and_feedback(
        jbh.BHParams(seed_bh_dyn_mass=2.5), jax.random.PRNGKey(12),
        ipos=jnp.asarray(bs["ipos"].astype(np.uint32)),
        **{k: jnp.asarray(v) for k, v in arrays.items()}, **common)
    got = tbh.swallow_and_feedback(
        tbh.BHParams(seed_bh_dyn_mass=2.5), threefry.prng_key(12),
        ipos=_t(bs["ipos"]), **{k: _t(v) for k, v in arrays.items()},
        **common)
    sw = _np(got[0])
    np.testing.assert_array_equal(sw, np.asarray(want[0]))
    assert 0 < sw.sum() < bs["is_gas"].sum()
    np.testing.assert_array_equal(np.maximum(_np(got[2]), -1),
                                  np.maximum(np.asarray(want[2]), -1))
    assert set(_np(got[2])[sw]) <= {0, 1}
    _norm_close(got[1], want[1], msg="entropy")
    _norm_close(got[3], want[3], msg="kick")
    assert (np.abs(_np(got[3])).sum() > 0) == kinetic


def test_bh_mergers_match_jax():
    """bh_mergers on tests/test_blackhole.py's pairs plus a chain of three
    close BHs, with and without MergeGravBound: the same pairs."""
    pos = np.array([[100.0, 100, 100], [100.5, 100, 100],
                    [500.0, 500, 500], [500.5, 500, 500],
                    [900.0, 900, 900], [300.0, 300, 300],
                    [300.6, 300, 300], [301.2, 300, 300], [999.8, 5, 5],
                    [0.3, 5, 5]])
    n = len(pos)
    vel = np.zeros((n, 3))
    vel[3, 0] = 1e4
    acc = np.zeros((n, 3))
    acc[[0, 2, 5, 8], 0] = 1.0
    acc[[1, 3, 7, 9], 0] = -1.0
    pid = np.array([11, 22, 33, 44, 55, 70, 60, 80, 91, 90], np.int64)
    is_bh = np.ones(n, bool)
    is_bh[4] = False
    for bound in (True, False):
        kw = dict(pos=pos, vel=vel, accel=acc, df_accel=np.zeros((n, 3)),
                  pid=pid, is_bh=is_bh, boxsize=1000.0, atime=1.0,
                  softening=1.0)
        want = jbh.bh_mergers(jbh.BHParams(merge_grav_bound=bound), **kw)
        got = tbh.bh_mergers(tbh.BHParams(merge_grav_bound=bound), **{
            k: _t(v) for k, v in kw.items()
            if isinstance(v, np.ndarray)}, boxsize=1000.0, atime=1.0,
            softening=1.0)
        for k in ("swallowed", "swallower"):
            np.testing.assert_array_equal(got[k], want[k])
        assert len(got["swallowed"]) >= 2


def test_seed_black_holes_matches_jax(bh_setup):
    """seed_black_holes on a catalogue of three groups (one holding a BH,
    one below the stellar-mass threshold), with SeedBHDynMass: the same
    rows seeded, and the same BH and particle state."""
    from mpgadget_tpu_torch.sph.state import SphData as TSph
    bs = bh_setup
    n = bs["n"]
    gi = np.full(n, -1, np.int64)
    gi[:200] = 0
    gi[200:400] = 1
    gi[400:500] = 2
    ptype = bs["ptype"].copy()
    ptype[ptype == 5] = 0
    ptype[0] = 5          # group 0 keeps one BH
    cat = {"ngroups": 3, "masses": np.array([500.0, 400.0, 200.0]),
           "mass_by_type": np.array([[1, 0, 0, 0, 2.0, 0],
                                     [1, 0, 0, 0, 1.0, 0],
                                     [1, 0, 0, 0, 1e-6, 0]]),
           "group_index": gi}
    dens = np.random.RandomState(8).rand(n).astype(np.float32)
    jp = JParticleData.from_numpy(bs["pos"], bs["vel"], bs["mass"], ptype,
                                  bs["pid"], bs["box"])
    tp = ParticleData.from_numpy(bs["pos"], bs["vel"], bs["mass"], ptype,
                                 bs["pid"], bs["box"], device="cpu")
    par = dict(min_fof_mass_for_seed=100.0, min_mstar_for_seed=0.5,
               seed_mass=3e-3, seed_bh_dyn_mass=0.7)
    jp2, jbh2, jn = jbh.seed_black_holes(
        jbh.BHParams(**par), cat, jp, jbh.BhData.zeros(n),
        JSphData.zeros(n).replace(density=jnp.asarray(dens)), 0.31)
    tp2, tbh2, tn = tbh.seed_black_holes(
        tbh.BHParams(**par), cat, tp, tbh.BhData.zeros(n, "cpu"),
        TSph.zeros(n, "cpu").replace(density=_t(dens)), 0.31)
    assert tn == jn == 1
    np.testing.assert_array_equal(_np(tp2.ptype), np.asarray(jp2.ptype))
    np.testing.assert_array_equal(_np(tp2.mass), np.asarray(jp2.mass))
    for f in fields(tbh.BhData):
        np.testing.assert_array_equal(_np(getattr(tbh2, f.name)),
                                      np.asarray(getattr(jbh2, f.name)),
                                      err_msg=f.name)


def test_bh_minpot_matches_jax():
    """bh_minpot on tests/test_blackhole.py:285's set-up with a second BH:
    the minimum-potential positions identical, the found mask identical,
    velocities to 1e-6."""
    box = 1000.0
    rng = np.random.RandomState(4)
    n = 96
    pos = (box / 2 + rng.uniform(-50, 50, (n, 3))) % box
    ipos = (pos / box * 2 ** 32).astype(np.uint64).astype(np.uint32)
    is_bh = np.zeros(n, bool)
    is_bh[[0, 5]] = True
    src = np.ones(n, bool)
    src[90:] = False
    pot = rng.rand(n).astype(np.float32)
    pot[17] = -5.0
    pot[93] = -9.0               # not a source
    hsml = np.where(is_bh, [200.0, 0, 0, 0, 0, 30.0] + [0.0] * (n - 6),
                    0.0).astype(np.float32)
    vel = rng.randn(n, 3).astype(np.float32)
    want = jbh.bh_minpot(jnp.asarray(ipos), jnp.asarray(hsml),
                         jnp.asarray(pot), jnp.asarray(vel),
                         jnp.asarray(src), jnp.asarray(is_bh), box)
    got = tbh.bh_minpot(_t(ipos.astype(np.int64)), _t(hsml), _t(pot),
                        _t(vel), _t(src), _t(is_bh), box)
    found = _np(got[2])
    np.testing.assert_array_equal(found, np.asarray(want[2]))
    assert found[[0, 5]].all()
    np.testing.assert_array_equal(_np(got[0])[found],
                                  np.asarray(want[0])[found])
    _close(_np(got[1])[found], np.asarray(want[1])[found])


@pytest.mark.parametrize("dyn", [-1.0, 2.0])
def test_apply_mtrack_accretion_matches_jax(dyn):
    """Swallowed mass routed into Mtrack or the dynamical mass, without
    and with SeedBHDynMass: 1e-6."""
    rng = np.random.RandomState(6)
    n = 64
    is_bh = rng.rand(n) < 0.5
    args = [rng.uniform(1.0, 3.0, n), rng.uniform(0.0, 2.5, n),
            np.where(rng.rand(n) < 0.7, rng.uniform(0, 0.5, n), 0.0),
            rng.randn(n, 3), rng.randn(n, 3)]
    args = [a.astype(np.float32) for a in args]
    want = jbh.apply_mtrack_accretion(*[jnp.asarray(a) for a in args],
                                      jnp.asarray(is_bh), dyn)
    got = tbh.apply_mtrack_accretion(*[_t(a) for a in args], _t(is_bh),
                                     dyn)
    for a, b in zip(got, want):
        _close(a, b)


def test_bh_data_and_spawn_vdisp_match_jax():
    """BhData.from_jax_numpy carries the JAX state across (fields, shapes,
    types, values), and spawn_stars copies the halo wind model's
    dispersion into the new stars as the JAX package's does."""
    rng = np.random.RandomState(1)
    n = 48
    jb = jbh.BhData.zeros(n).replace(
        bh_mass=jnp.asarray(rng.rand(n), jnp.float32),
        count_progs=jnp.asarray(rng.randint(0, 3, n), jnp.int32),
        min_pot_pos=jnp.asarray(rng.rand(n, 3), jnp.float32))
    tb = tbh.BhData.from_jax_numpy(
        {f.name: np.asarray(getattr(jb, f.name)) for f in fields(jbh.BhData)},
        device="cpu")
    zero = tbh.BhData.zeros(n, "cpu")
    for f in fields(tbh.BhData):
        a, z = getattr(tb, f.name), getattr(zero, f.name)
        assert a.dtype == z.dtype and a.shape == z.shape, f.name
        np.testing.assert_array_equal(_np(a),
                                      np.asarray(getattr(jb, f.name)))
    # spawn_stars with vdisp
    pos = rng.uniform(0, 100.0, (n, 3))
    ptype = np.zeros(n, np.int32)
    mass = np.full(n, 1.0, np.float32)
    jp = JParticleData.from_numpy(pos, np.zeros((n, 3)), mass, ptype,
                                  np.arange(n) + 1, 100.0)
    tp = ParticleData.from_numpy(pos, np.zeros((n, 3)), mass, ptype,
                                 np.arange(n) + 1, 100.0, device="cpu")
    valid = np.arange(n) < 40
    jp = jp.replace(valid=jnp.asarray(valid))
    tp = tp.replace(valid=_t(valid))
    make = valid & (rng.rand(n) < 0.3)
    convert = make & (rng.rand(n) < 0.5)
    smass = np.where(make, 0.25, 0.0).astype(np.float32)
    vd = rng.uniform(10, 100, n).astype(np.float32)
    want = jsfr.spawn_stars(jp, JSphData.zeros(n), jnp.asarray(make),
                            jnp.asarray(convert), jnp.asarray(smass), 0.1,
                            stars=JStarData.zeros(n), vdisp=jnp.asarray(vd))
    got = tsfr.spawn_stars(tp, SphData.zeros(n, "cpu"), _t(make),
                           _t(convert), _t(smass), 0.1,
                           stars=StarData.zeros(n, "cpu"), vdisp=_t(vd))
    np.testing.assert_array_equal(_np(got[2].vdisp),
                                  np.asarray(want[2].vdisp))
    np.testing.assert_array_equal(_np(got[5]), np.asarray(want[5]))
    assert (_np(got[2].vdisp) > 0).sum() == _np(got[5]).sum() > 0
