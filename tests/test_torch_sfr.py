"""The port's star formation (physics/sfr.py, physics/stars.py,
utils/threefry.py) against the JAX package.

The same numpy inputs, made from a seed, go through both packages on the
CPU (the port's cooling as its plain version).  The random draws, the
masks and the rows of new stars must be identical; the floats agree to
the tolerances stated in each test (the cooling time inside the eEOS model
carries tests/test_torch_cooling.py's float32 tolerances).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgadget_tpu.cosmology import Cosmology as JCosmology
from mpgadget_tpu.particles import ParticleData as JParticles
from mpgadget_tpu.physics import cooling as jcool
from mpgadget_tpu.physics import sfr as jsfr
from mpgadget_tpu.physics.stars import StarData as JStars
from mpgadget_tpu.sph.state import SphData as JSph
from mpgadget_tpu.utils import constants as C
from mpgadget_tpu.utils import get_unitsystem
from mpgadget_tpu_torch.cosmology import Cosmology
from mpgadget_tpu_torch.particles import ParticleData
from mpgadget_tpu_torch.physics import cooling as tcool
from mpgadget_tpu_torch.physics import sfr as tsfr
from mpgadget_tpu_torch.physics.stars import StarData, primordial_metals
from mpgadget_tpu_torch.sph.state import SphData
from mpgadget_tpu_torch.utils import threefry

torch.set_num_threads(1)

UNITS = get_unitsystem(C.CM_PER_KPC, 1.989e43, 1e5)
COSMO = dict(Omega0=0.3, OmegaBaryon=0.045, OmegaLambda=0.7, HubbleParam=0.7)
CUNITS = dict(density_in_phys_cgs=UNITS.UnitDensity_in_cgs * 0.49,
              uu_in_cgs=UNITS.UnitInternalEnergy_in_cgs,
              tt_in_s=UNITS.UnitTime_in_s / 0.7)
SEEDS = (0, 1, 42, 181170 + 4096, 2 ** 31 - 1)
PIDS = np.array([0, 1, 7, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32,
                 2 ** 32 + 5, 2 ** 40, 2 ** 40 + 12345, 2 ** 41 + 3,
                 3 * 2 ** 40 + 2 ** 33 + 17, 2 ** 62 + 99], np.int64)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_words_match_jax(seed):
    """PRNGKey, split in three, fold_in and one uint32 of bits: the same
    words as jax.random (threefry2x32, partitionable)."""
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable
    k = jax.random.PRNGKey(seed)
    key = threefry.prng_key(seed)
    np.testing.assert_array_equal(key, np.asarray(k))
    ks, tks = jax.random.split(k, 3), threefry.split(key, 3)
    np.testing.assert_array_equal(tks, np.asarray(ks))
    for i in range(3):
        for data in (0, 77, 2 ** 32 - 1):
            f = jax.random.fold_in(ks[i], data)
            np.testing.assert_array_equal(threefry.fold_in(tks[i], data),
                                          np.asarray(f))
        f = jax.random.fold_in(ks[i], 0)
        assert threefry.bits32(threefry.fold_in(tks[i], 0)) \
            == int(jax.random.bits(f, (1,), jnp.uint32)[0])


@pytest.mark.parametrize("seed", SEEDS)
def test_id_uniform_matches_jax(seed):
    """The per-ID deviates bit for bit, for IDs beyond 2^32 (truncated to
    their low 32 bits) and spawned IDs pid + 2^40, and for pid + 1."""
    rng = np.random.default_rng(seed)
    pid = np.concatenate([PIDS, rng.integers(0, 2 ** 62, 64)])
    for k, tk in zip(jax.random.split(jax.random.PRNGKey(seed), 3),
                     threefry.split(threefry.prng_key(seed), 3)):
        for p in (pid, pid + 1, pid + 2 ** 40):
            want = np.asarray(jsfr._id_uniform(k, jnp.asarray(p)))
            got = tsfr.id_uniform(tk, torch.as_tensor(p)).numpy()
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def setup():
    """init_sfr in both packages (the port's float64 cooling time on the
    CPU) with the cooling rates it used."""
    jp, tp = jcool.CoolingParams(), tcool.CoolingParams()
    jcr = jcool.CoolingRates(jp, jcool.TreeCool(None, jp))
    tcr = tcool.CoolingRates(tp, tcool.TreeCool(None, tp))
    jpar = jsfr.init_sfr(jsfr.SFRParams(), JCosmology(**COSMO).init_units(
        UNITS), UNITS, jcr, jcool.CoolingUnits(**CUNITS), 1e-3)
    tpar = tsfr.init_sfr(tsfr.SFRParams(), Cosmology(**COSMO).init_units(
        UNITS), UNITS, tcr, tcool.CoolingUnits(**CUNITS), 1e-3,
        device="cpu")
    return jpar, tpar, jcr, tcr


def test_init_sfr_matches_jax(setup):
    """The derived thresholds: identical, but PhysDensThresh, from one
    float64 cooling time, within 1e-9."""
    jpar, tpar, _, _ = setup
    for f in dataclasses.fields(jpar):
        a, b = getattr(jpar, f.name), getattr(tpar, f.name)
        if f.name == "PhysDensThresh":
            assert b == pytest.approx(a, rel=1e-9)
        else:
            assert a == b, f.name
    nh = tpar.PhysDensThresh * UNITS.UnitDensity_in_cgs / C.PROTONMASS \
        * C.HYDROGEN_MASSFRAC
    assert 0.01 < nh < 10


def _gas(n, par, seed, a3inv):
    """Gas around the star formation thresholds at a^-3 = a3inv, in
    float32."""
    rng = np.random.default_rng(seed)
    lo = max(par.PhysDensThresh / a3inv, par.OverDensThresh)
    dens = (lo * 10 ** rng.uniform(-1, 2, n)).astype(np.float32)
    return dict(
        density=dens,
        entropy=(10 ** rng.uniform(-1, 4, n)).astype(np.float32),
        ne=rng.uniform(0, 1.2, n).astype(np.float32),
        metallicity=rng.uniform(0, 0.02, n).astype(np.float32),
        delay_time=np.where(rng.uniform(size=n) < 0.1, 1.0, 0.0)
        .astype(np.float32),
        mass=np.full(n, 1e-3, np.float32),
        pid=rng.integers(0, 2 ** 41, n),
        valid_gas=rng.uniform(size=n) < 0.9)


def test_get_sfr_eeqos_matches_jax(setup):
    """The multiphase model on the gas on the eEOS, dtime scalar: every
    output within 2e-5 relative (its cooling time of the hot phase)."""
    jpar, tpar, jcr, tcr = setup
    a3inv = 1.0 / 0.25 ** 3
    g = _gas(64, tpar, 3, a3inv)
    on = np.asarray(jsfr.sfreff_on_eeqos(jpar, jnp.asarray(g["density"]),
                                         jnp.asarray(g["delay_time"]), a3inv))
    ton = tsfr.sfreff_on_eeqos(tpar, torch.as_tensor(g["density"]),
                               torch.as_tensor(g["delay_time"]), a3inv)
    np.testing.assert_array_equal(ton.numpy(), on)
    assert 8 < on.sum() < 60
    dtime = np.float32(0.01)
    j = jsfr.get_sfr_eeqos(jpar, jcr, jcool.CoolingUnits(**CUNITS),
                           jnp.asarray(g["density"]), jnp.asarray(g["ne"]),
                           jnp.asarray(g["metallicity"]), dtime,
                           jcool.UVBG(), 3.0, a3inv, jnp.asarray(on))
    t = tsfr.get_sfr_eeqos(tpar, tcr, tcool.CoolingUnits(**CUNITS),
                           torch.as_tensor(g["density"]),
                           torch.as_tensor(g["ne"]), torch.tensor(dtime),
                           tcool.UVBG(), 3.0, a3inv,
                           ton)
    for k in ("tsfr", "egyhot", "cloudfrac", "trelax", "egyeff"):
        np.testing.assert_allclose(_np(t[k])[on], _np(j[k])[on], rtol=2e-5,
                                   err_msg=k)
    assert np.all((_np(t["cloudfrac"])[on] > 0)
                  & (_np(t["cloudfrac"])[on] <= 1))


@pytest.fixture(scope="module")
def sf_runs(setup):
    """cooling_and_starformation in both packages on the same gas, without
    and with quick Lyman-alpha, each with a scalar and a per-particle
    dloga; key from RandomSeed 42 + ti 4096."""
    jpar, tpar, jcr, tcr = setup
    out = {}
    g = _gas(96, tpar, 5, 1.0 / 0.4 ** 3)
    # a small mean baryon mass makes the stars' masses small enough that
    # several form in one step
    for qla in (0.0, 0.5):
        jp = dataclasses.replace(jpar, QuickLymanAlphaProbability=qla,
                                 avg_baryon_mass=1e-3 / 16)
        tp = dataclasses.replace(tpar, QuickLymanAlphaProbability=qla,
                                 avg_baryon_mass=1e-3 / 16)
        rng = np.random.default_rng(7)
        for dloga in (0.02, rng.uniform(0.005, 0.04, 96).astype(np.float32)):
            seed = 42 + 4096
            jkw = {k: jnp.asarray(v) for k, v in g.items()}
            tkw = {k: torch.as_tensor(v) for k, v in g.items()}
            juv, tuv = jcool.UVBG(), tcool.UVBG()
            jcu, tcu = jcool.CoolingUnits(**CUNITS), \
                tcool.CoolingUnits(**CUNITS)
            common = dict(redshift=1.5, atime=0.4, hubble=0.2)

            def jcool_fn(u, rho, dt, ne, Z):
                return jcool.do_cooling(jcr, 1.5, u, rho, dt, juv, ne, Z,
                                        1e-4, jcu)

            def tcool_fn(u, rho, dt, ne, rows):
                return tcool.do_cooling(tcr, 1.5, u, rho, dt, tuv, ne, 1e-4,
                                        tcu, rows=rows)

            j = jsfr.cooling_and_starformation(
                jp, jcr, jcu, jax.random.PRNGKey(seed), **jkw,
                dloga=dloga if np.isscalar(dloga) else jnp.asarray(dloga),
                uvbg=juv, do_cooling_fn=jcool_fn, min_egy_spec=1e-4,
                **common)
            t = tsfr.cooling_and_starformation(
                tp, tcr, tcu, threefry.prng_key(seed), **tkw,
                dloga=dloga if np.isscalar(dloga)
                else torch.as_tensor(dloga),
                uvbg=tuv, do_cooling_fn=tcool_fn, **common)
            out[qla, np.isscalar(dloga)] = (
                {k: np.asarray(v) for k, v in j.items()},
                {k: v.numpy() for k, v in t.items()}, g)
    return out


@pytest.mark.parametrize("qla", [0.0, 0.5])
@pytest.mark.parametrize("scalar_dloga", [True, False])
def test_cooling_and_starformation_matches_jax(sf_runs, qla, scalar_dloga):
    """The source step of the gas: identical on_eeqos, make_star and
    convert masks; entropy, ne, sfr, metallicity, star_mass and sm within
    2e-5 relative (ne also 2e-6 absolute, the cooling's).  With quick
    Lyman-alpha every star is a whole conversion of cold dense gas."""
    j, t, g = sf_runs[qla, scalar_dloga]
    for k in ("on_eeqos", "make_star", "convert"):
        assert t[k].dtype == bool
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for k in ("entropy", "sfr", "metallicity", "star_mass", "sm"):
        np.testing.assert_allclose(t[k], j[k], rtol=2e-5, atol=0, err_msg=k)
    np.testing.assert_allclose(t["ne"], j["ne"], rtol=2e-5, atol=2e-6)
    assert t["on_eeqos"].sum() > 4 and t["make_star"].sum() > 0
    if qla:
        assert np.array_equal(t["convert"], t["make_star"])
        assert np.all(t["star_mass"][t["convert"]] == g["mass"][t["convert"]])
    else:
        # partial stars (spawns) and no star off the eEOS
        assert (t["make_star"] & ~t["convert"]).any()
        assert not (t["make_star"] & ~t["on_eeqos"]).any()


def _particles(n, cap, seed):
    """Gas, DM and free rows (not only at the end) in both packages."""
    rng = np.random.default_rng(seed)
    box = 1000.0
    jp = JParticles.from_numpy(
        rng.uniform(0, box, (n, 3)), rng.normal(size=(n, 3)),
        np.full(n, 1e-3), (rng.uniform(size=n) < 0.3).astype(np.int32),
        np.arange(n) + 2 ** 32 - 5, box, capacity=cap)
    dead = rng.uniform(size=cap) < 0.1
    jp = jp.replace(valid=jp.valid & ~jnp.asarray(dead),
                    hsml=jnp.asarray(rng.uniform(1, 5, cap), jnp.float32),
                    timebin=jnp.asarray(rng.integers(1, 8, cap), jnp.int32),
                    grav_accel=jnp.asarray(rng.normal(size=(cap, 3)),
                                           jnp.float32))
    tp = ParticleData.from_jax_numpy(
        {f.name: np.asarray(getattr(jp, f.name))
         for f in dataclasses.fields(ParticleData)}, device="cpu")
    return jp, tp


def test_spawn_stars_matches_jax():
    """spawn_stars: the same destination rows (the free rows in index
    order), ptype, pid (+2^40), valid, masses and copied fields, and
    StarData filled alike (converted rows in place, spawned rows at their
    destination), bit for bit."""
    n, cap = 200, 256
    jp, tp = _particles(n, cap, 9)
    rng = np.random.default_rng(10)
    gas = np.asarray(jp.valid) & (np.asarray(jp.ptype) == 0)
    make = gas & (rng.uniform(size=cap) < 0.3)
    convert = make & (rng.uniform(size=cap) < 0.4)
    star_mass = np.where(make, np.where(convert, 1e-3, 2.5e-4),
                         0.0).astype(np.float32)
    jsph = JSph.zeros(cap).replace(
        density=jnp.asarray(rng.uniform(1, 2, cap), jnp.float32),
        metallicity=jnp.asarray(rng.uniform(0, 0.02, cap), jnp.float32))
    tsph = SphData.from_jax_numpy(
        {f.name: np.asarray(getattr(jsph, f.name))
         for f in dataclasses.fields(SphData)}, device="cpu")
    jstars = JStars.zeros(cap)
    jstars = jstars.replace(formation_time=jnp.full(cap, 0.1, jnp.float32))
    tstars = StarData.from_jax_numpy(
        {f.name: np.asarray(getattr(jstars, f.name))
         for f in dataclasses.fields(StarData)}, device="cpu")
    jout = jsfr.spawn_stars(jp, jsph, jnp.asarray(make),
                            jnp.asarray(convert), jnp.asarray(star_mass),
                            0.25, stars=jstars)
    tout = tsfr.spawn_stars(tp, tsph, torch.as_tensor(make),
                            torch.as_tensor(convert),
                            torch.as_tensor(star_mass), 0.25, stars=tstars)
    assert int(jout[3]) == tout[3] == (make & ~convert).sum() > 0
    assert bool(jout[4]) == tout[4] is False
    np.testing.assert_array_equal(tout[5].numpy(), np.asarray(jout[5]))
    for f in dataclasses.fields(ParticleData):
        a = np.asarray(getattr(jout[0], f.name))
        b = getattr(tout[0], f.name).numpy()
        np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=f.name)
    for f in dataclasses.fields(StarData):
        np.testing.assert_array_equal(getattr(tout[2], f.name).numpy(),
                                      np.asarray(getattr(jout[2], f.name)),
                                      err_msg=f.name)
    # the spawned rows are the first free rows, in index order
    free = ~np.asarray(jp.valid)
    new = tout[0].valid.numpy() & ~np.asarray(jp.valid)
    assert np.array_equal(np.flatnonzero(new),
                          np.flatnonzero(free)[:int(new.sum())])
    assert np.all(tout[0].pid.numpy()[new] >= 2 ** 40)


def test_spawn_stars_reports_overflow():
    """More spawns than free rows: the overflow flag, as in JAX."""
    jp, tp = _particles(120, 128, 12)
    gas = tp.valid & (tp.ptype == 0)
    out = tsfr.spawn_stars(tp, None, gas, torch.zeros_like(gas),
                           torch.where(gas, 1e-4, 0.0), 0.3)
    free = int((~tp.valid).sum())
    assert out[3] == int(gas.sum()) > free and out[4] is True
    jout = jsfr.spawn_stars(jp, None, jnp.asarray(gas.numpy()),
                            jnp.zeros(128, bool),
                            jnp.asarray(torch.where(gas, 1e-4, 0.0).numpy()),
                            0.3)
    assert bool(jout[4])


def test_star_data_and_primordial_metals():
    """StarData.zeros and primordial_metals as the JAX package's."""
    from mpgadget_tpu.physics.stars import primordial_metals as jmetals
    np.testing.assert_array_equal(primordial_metals(5, "cpu").numpy(),
                                  np.asarray(jmetals(5)))
    z, jz = StarData.zeros(4, "cpu"), JStars.zeros(4)
    for f in dataclasses.fields(StarData):
        assert getattr(z, f.name).shape == np.asarray(
            getattr(jz, f.name)).shape
