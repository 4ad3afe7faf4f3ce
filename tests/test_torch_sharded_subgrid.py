"""The port's sharded subgrid modules against the JAX package's, at 2 and 4
ranks: parallel/winds.py (the vs08 and ofjt10 neighbour winds),
parallel/blackhole.py (accretion, feedback, swallowing, mergers, the
dynamical friction, the kinetic channel, Mtrack and the reposition),
parallel/metals.py (the metal return with its strip re-run) and
parallel/fof.py's seeding (the catalogue's extras and seed_convert).

The port's side runs as gloo ranks on the CPU, spawned once per rank count
(tests/_torch_sharded_worker.py: subgrid_module_cases), on numpy inputs
from a seed (the cases of tests/test_parallel.py's sharded winds, BH,
merger and metal-return tests, and the gas FOF case with densities and
BHs).  The JAX side is the JAX package's shard_map functions
(build_sharded_winds, build_sharded_bh, build_sharded_metal_return,
sharded_fof and build_seed_convert) on the same rows at the same shard
count; since those take minutes to compile on the CPU, the cases compare
against the committed record ``torch_sharded/jax_subgrid_modules.npz``,
which the slow test ``test_jax_subgrid_module_record`` computes anew and
checks (MPG_WRITE_SHARDED_FIXTURE=1 writes it):

    MPG_WRITE_SHARDED_FIXTURE=1 python -m pytest -m slow \\
        tests/test_torch_sharded_subgrid.py

Each case is also held to the port's single-device functions on the same
box (physics/winds.py, physics/blackhole.py, physics/metal_return.py, the
single-device FOF and seed_black_holes).

Tolerances: float32 sums within 1e-5 relative by norm (PERF.md section 2;
the per-star and per-BH sums run in another order than the JAX package's
dense sums and are then summed over ranks); the stochastic sets (kicked
gas, swallowed gas, merged BHs, seeded rows) identical, since their draws
are per ID and no sum of these cases lies within 1e-5 of its threshold.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_sharded_worker as W

torch.set_num_threads(1)

RECORD = Path(__file__).resolve().parent / "torch_sharded" / \
    "jax_subgrid_modules.npz"
RANKS = (2, 4)
TOL = 1e-5          # relative, by norm (float32 sums)
# the seeding catalogue's columns: the same on every rank
REPLICATED = ("seed_has_bh", "seed_seed_density", "seed_masses",
              "seed_lengths")


@pytest.fixture(scope="module", params=RANKS, ids=lambda s: f"{s}ranks")
def ranks(request, tmp_path_factory):
    """(S, this side's columns concatenated over ranks, the JAX record of
    S)."""
    S = request.param
    out = tmp_path_factory.mktemp(f"subgrid{S}")
    W.spawn(W.subgrid_module_cases, S, str(out))
    got = [dict(np.load(out / f"sg_r{r}.npz")) for r in range(S)]
    cat = {}
    for k in got[0]:
        if got[0][k].ndim == 0 or k in REPLICATED:
            cat[k] = got[0][k]
        elif k == "seed_pid_part":      # each rank maps the rows it holds
            cat[k] = np.max([g[k] for g in got], axis=0)
        else:
            cat[k] = np.concatenate([g[k] for g in got])
    rec = np.load(RECORD)
    want = {k[len(f"S{S}_"):]: rec[k] for k in rec.files
            if k.startswith(f"S{S}_")}
    return S, cat, want


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den > 0 else \
        float(np.abs(a).max(initial=0.0))


def _by_pid(pid, *cols):
    o = np.argsort(pid, kind="stable")
    return (pid[o],) + tuple(c[o] for c in cols)


# ---- winds -------------------------------------------------------------------

@pytest.mark.parametrize("model", ["ofjt10", "vs08"])
def test_winds_match_jax(ranks, model):
    """The kicked gas is the JAX package's, row by row (the pair-ID hash),
    and the velocities, entropies and decoupling times are within 1e-5
    by norm; the same number of new stars."""
    S, got, want = ranks
    p = f"wind_{model}_"
    np.testing.assert_array_equal(got[p + "pid"], want[p + "pid"])
    assert int(got[p + "n_new"]) == int(want[p + "n_new"]) == 6
    assert int(got[p + "n_kicked"]) == int(want[p + "n_kicked"]) > 0
    for k in ("vel", "entropy", "delay_time"):
        assert _rel(got[p + k], want[p + k]) <= TOL, (k, _rel(
            got[p + k], want[p + k]))
    d = W.wind_module_inputs()
    moved = lambda v: np.any(v != d["vel"], axis=1)
    np.testing.assert_array_equal(moved(got[p + "vel"]),
                                  moved(want[p + "vel"]))


def test_winds_match_single_device(ranks):
    """ofjt10: the sharded passes kick the same gas as the single-device
    winds_via_neighbors with each star's dispersion from
    dm_velocity_dispersion, then the decoupling update, within 1e-5."""
    from mpgadget_tpu_torch.physics import winds as windmod
    from mpgadget_tpu_torch.utils import threefry
    S, got, _ = ranks
    d = W.wind_module_inputs()
    c = W._cols(d, d.keys())
    w = W.SG_WIND
    par = W.wind_params(windmod, "ofjt10")
    star = c["ptype"] == 4
    vd = windmod.dm_velocity_dispersion(
        c["ipos"], c["vel"], c["mass"], c["ptype"] == 1, star, W.SG_BOX,
        W.SG_BOX / np.cbrt(len(d["pid"])))
    vel, ent, delay, kicked = windmod.winds_via_neighbors(
        par, threefry.prng_key(w["key"]), ipos=c["ipos"], mass=c["mass"],
        hsml=c["hsml"], pid=c["pid"], vel=c["vel"], entropy=c["entropy"],
        density=c["density"], delay_time=c["delay_time"],
        is_gas=c["gas_mask"], new_star=star,
        star_vdisp=torch.where(star, vd, 0.0), boxsize=W.SG_BOX,
        atime=w["atime"])
    delay = windmod.winds_decouple_update(par, delay, c["density"],
                                          w["dtime"], w["atime"])
    p = "wind_ofjt10_"
    assert int(kicked.sum()) == int(got[p + "n_kicked"]) > 0
    for k, v in (("vel", vel), ("entropy", ent), ("delay_time", delay)):
        assert _rel(got[p + k], v.numpy()) <= TOL, k


# ---- black holes ---------------------------------------------------------------

BH_FLOAT = ("vel", "mass", "entropy", "bh_mass", "bh_mdot", "bh_density",
            "bh_mtrack", "bh_ke", "bh_vdisp")


@pytest.mark.parametrize("variant", list(W.BH_VARIANTS))
def test_bh_matches_jax(ranks, variant):
    """The rows that stay (the swallowed gas and the merged BHs gone, the
    same IDs as the JAX package's valid rows), their floats within 1e-5
    by norm, the progenitor counts equal, the repositioned BHs at the
    JAX package's positions; the same swallow and merger counts."""
    S, got, want = ranks
    p = f"bh_{variant}_"
    gpid, *g = _by_pid(got[p + "pid"], *(got[p + k] for k in BH_FLOAT
                                         + ("bh_progs", "ipos", "ptype")))
    keep = want[p + "valid"]
    wpid, *w = _by_pid(want[p + "pid"][keep], *(
        want[p + k][keep] for k in BH_FLOAT + ("bh_progs", "ipos",
                                               "ptype")))
    np.testing.assert_array_equal(gpid, wpid)
    for k, a, b in zip(BH_FLOAT, g, w):
        assert _rel(a, b) <= TOL, (k, _rel(a, b))
    np.testing.assert_array_equal(g[-3], w[-3])          # progenitors
    np.testing.assert_array_equal(g[-1], w[-1])          # types
    np.testing.assert_array_equal(g[-2].astype(np.int64),
                                  w[-2].astype(np.int64))
    for k in ("n_bh", "n_swallowed", "n_merged"):
        assert got[p + "stat_" + k] == want[p + "stat_" + k], k
    if variant == "merge":
        assert int(got[p + "stat_n_merged"]) == 2
    else:
        assert int(got[p + "stat_n_swallowed"]) > 0
    if variant == "full":
        d = W.bh_module_inputs("full")
        bh = np.isin(d["pid"], gpid[g[-1] == 5])
        moved = d["ipos"][bh].astype(np.int64)
        assert not np.array_equal(np.sort(g[-2][g[-1] == 5], axis=0),
                                  np.sort(moved, axis=0))


def test_bh_matches_single_device(ranks):
    """The "bh" case against the single-device pipeline
    (bh_neighbor_sums, bondi_accretion, swallow_and_feedback): the same
    swallowed gas, the BHs' density and accretion rate and the gas's
    entropy within 1e-5."""
    from mpgadget_tpu_torch.physics import blackhole as bhmod
    from mpgadget_tpu_torch.utils import threefry
    S, got, _ = ranks
    d = W.bh_module_inputs("bh")
    c = W._cols(d, d.keys())
    b = W.SG_BH
    par = W.bh_params(bhmod, "bh")
    bh, gas = c["ptype"] == 5, c["gas_mask"]
    s = bhmod.bh_neighbor_sums(c["ipos"], c["mass"], c["hsml"], c["vel"],
                               c["entropy"], bh, gas, W.SG_BOX,
                               kernel_type=b["kernel"])
    gv = torch.stack([s["vx"], s["vy"], s["vz"]], dim=-1)
    mdot, dm = bhmod.bondi_accretion(
        par, c["bh_mass"], s["rho"], s["ent"], gv, c["vel"], b["atime"],
        b["gconst"], b["unit_time"], b["hubble"], b["dtime"])
    sw, ent, _, _ = bhmod.swallow_and_feedback(
        par, threefry.prng_key(b["key"]), ipos=c["ipos"], mass=c["mass"],
        hsml=c["hsml"], entropy=c["entropy"], density=c["density"],
        is_bh=bh, is_gas=gas, pid=c["pid"],
        bh_mass=torch.where(bh, c["bh_mass"] + dm, c["bh_mass"]),
        mdot=torch.where(bh, mdot, 0.0), bh_density=s["rho"],
        fbweight=s["fbweight"], boxsize=W.SG_BOX, atime=b["atime"],
        dtime=b["dtime"], unit_velocity=b["unit_vel"], uu_in_cgs=b["uu"],
        kernel_type=b["kernel"])
    p = "bh_bh_"
    kept = np.isin(d["pid"], got[p + "pid"])
    np.testing.assert_array_equal(~kept, sw.numpy())
    o = np.argsort(got[p + "pid"])
    gb = got[p + "ptype"][o] == 5
    for k, v in (("bh_density", s["rho"]), ("bh_mdot", mdot)):
        assert _rel(got[p + k][o][gb], v.numpy()[d["ptype"] == 5]) <= TOL
    g_gas = got[p + "ptype"][o] == 0
    assert _rel(got[p + "entropy"][o][g_gas], ent.numpy()[kept & (
        d["ptype"] == 0)]) <= TOL


def test_bh_mergers_match_single_device(ranks):
    """The merger case against the single-device bh_mergers (float64 on
    the host): the same prey and swallower."""
    from mpgadget_tpu_torch.physics import blackhole as bhmod
    S, got, _ = ranks
    d = W.merger_module_inputs()
    m = bhmod.bh_mergers(
        W.bh_params(bhmod, "merge"),
        pos=d["ipos"].astype(np.float64) / 2.0 ** 32 * W.SG_BOX,
        vel=d["vel"], accel=d["grav_acc"], df_accel=np.zeros((64, 3)),
        pid=d["pid"], is_bh=d["ptype"] == 5, boxsize=W.SG_BOX, atime=0.5,
        softening=2.0)
    gone = set(d["pid"]) - set(got["bh_merge_pid"].tolist())
    assert gone == set(d["pid"][m["swallowed"]].tolist()) == {1, 2}
    assert set(d["pid"][m["swallower"]].tolist()) == {3}
    o = list(got["bh_merge_pid"]).index(3)
    assert int(got["bh_merge_bh_progs"][o]) == (0 + 1) + (1 + 1) + 2
    np.testing.assert_allclose(got["bh_merge_bh_mass"][o], 3e-3, rtol=1e-6)


# ---- metal return ------------------------------------------------------------

METAL = ("mass", "metals", "metallicity", "star_hsml", "total_mass_returned",
         "last_enrichment_myr")


def test_metal_return_matches_jax(ranks):
    """The strip re-runs as the JAX package's (the same wider margin), and
    every row's mass, metals, metallicity and star bookkeeping within
    1e-5 by norm; the mass returned equals the mass received."""
    S, got, want = ranks
    assert got["metal_stat_reruns"] >= 1
    assert float(got["metal_stat_margin"]) == pytest.approx(
        float(want["metal_margin"]))
    gp, *g = _by_pid(got["metal_pid"], *(got["metal_" + k] for k in METAL))
    wp, *w = _by_pid(want["metal_pid"], *(want["metal_" + k]
                                           for k in METAL))
    np.testing.assert_array_equal(gp, wp)
    for k, a, b in zip(METAL, g, w):
        assert _rel(a, b) <= TOL, (k, _rel(a, b))
    np.testing.assert_allclose(got["metal_stat_returned"],
                               got["metal_stat_received"], rtol=1e-5)
    np.testing.assert_allclose(got["metal_stat_returned"],
                               want["metal_returned"], rtol=1e-5)


def test_metal_return_matches_single_device(ranks):
    """The same rows through the single-device metal_return_step in one
    piece: gas mass, metals, star mass, star hsml and bookkeeping within
    1e-5 by norm."""
    from mpgadget_tpu_torch.physics import metal_return as mrmod
    from mpgadget_tpu_torch.physics.stars import StarData
    S, got, _ = ranks
    d = W.metal_module_inputs()
    c = W._cols(d, d.keys())
    un, cp = W.metal_units_cosmology("mpgadget_tpu_torch")
    age = mrmod.AgeTable(cp.hubble_function, un, 0.7, device="cpu")
    star = c["ptype"] == 4
    stars = StarData.zeros(0, "cpu").replace(
        formation_time=c["formation_time"],
        metallicity=c["birth_metallicity"], metals=c["metals"],
        total_mass_returned=c["total_mass_returned"],
        last_enrichment_myr=c["last_enrichment_myr"])
    out = mrmod.metal_return_step(
        c["ipos"], c["mass"], c["hsml"], c["density"], c["gas_mask"], star,
        c["star_hsml"], stars, c["metals"], W.SG_METAL["a0"],
        W.SG_METAL["a1"], age, W.SG_BOX, mrmod.MetalReturnParams())
    o = np.argsort(got["metal_pid"])
    gas = d["gas_mask"]
    mass = np.where(gas, out["gas_mass"].numpy(),
                    out["star_mass"].numpy().astype(np.float32))
    for k, v in (("mass", mass), ("star_hsml", out["star_hsml"].numpy()),
                 ("total_mass_returned", out["total_mass_returned"].numpy()),
                 ("last_enrichment_myr", out["last_enrichment_myr"].numpy())):
        assert _rel(got["metal_" + k][o], v) <= TOL, k
    assert _rel(got["metal_metals"][o][gas],
                out["gas_metals"].numpy()[gas]) <= TOL


# ---- seeding -----------------------------------------------------------------

def _seed_picks(d):
    """The seeding rows' IDs of the eligible groups (no BH, some gas)."""
    pick = ~d["seed_has_bh"] & (d["seed_pid_part"] >= 0)
    return set(d["seed_pid_part"][pick].tolist())


def test_seeding_matches_jax(ranks):
    """The catalogue's seeding extras pick the same rows as the JAX
    package's (its gids shard * n_local + row, the port's offset + row:
    compared through the rows' IDs), and seed_convert makes the same rows
    BHs with the seed mass, Mtrack and formation time."""
    S, got, want = ranks
    assert got["seed_has_bh"].sum() == want["seed_has_bh"].sum() > 0
    np.testing.assert_allclose(np.sort(got["seed_seed_density"]),
                               np.sort(want["seed_seed_density"]), rtol=0)
    picks = _seed_picks(got)
    assert picks == _seed_picks(want) and len(picks) > 0
    assert int(got["seed_n"]) == len(picks) == int(want["seed_n"])
    keys = ("ptype", "gas_mask", "bh_mass", "bh_mtrack", "mass",
            "formation_time")
    gp, *g = _by_pid(got["seed_pid"], *(got["seed_new_" + k] for k in keys))
    wv = want["seed_valid"]
    wp, *w = _by_pid(want["seed_pid"][wv], *(want["seed_new_" + k][wv]
                                             for k in keys))
    np.testing.assert_array_equal(gp, wp)
    for k, a, b in zip(keys, g, w):
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert set(gp[g[0] == 5].tolist()) >= picks


def test_seeding_matches_single_device(ranks):
    """The single-device FOF catalogue of the same rows and
    seed_black_holes (every group without a BH seeds) seed the same rows
    as the sharded catalogue's extras."""
    from mpgadget_tpu_torch.particles import ParticleData
    from mpgadget_tpu_torch.physics import blackhole as bhmod
    from mpgadget_tpu_torch.physics.fof import FOFParams, fof_catalog
    from mpgadget_tpu_torch.sph.state import SphData
    S, got, _ = ranks
    d = W.seed_module_inputs()
    c = W._cols(d, d.keys())
    ones = torch.ones(W.N, dtype=torch.bool)
    cat = fof_catalog(c["ipos"], c["vel"], c["mass"], c["ptype"], ones,
                      W.SG_BOX, W.SG_BOX / np.cbrt(int((d["ptype"] == 1)
                                                       .sum())),
                      FOFParams(linking_length=W.FOF_LL,
                                min_group_length=W.FOF_MIN))
    pd = ParticleData.zeros(W.N, device="cpu").replace(
        ipos=c["ipos"], mass=c["mass"], ptype=c["ptype"], pid=c["pid"],
        valid=ones)
    par = bhmod.BHParams(min_fof_mass_for_seed=-1.0,
                         min_mstar_for_seed=-1.0)
    pd2, _, n = bhmod.seed_black_holes(
        par, cat, pd, bhmod.BhData.zeros(W.N, "cpu"),
        SphData.zeros(W.N, "cpu").replace(density=c["density"]), 0.1)
    seeded = (pd2.ptype == 5) & (pd.ptype != 5)
    assert _seed_picks(got) == set(d["pid"][seeded.numpy()].tolist())
    assert n == int(got["seed_n"])


# ---- elementwise: both packages in this process --------------------------------

def test_sh03_wind_fn_matches_jax():
    """The sharded step's sh03 winds (Simulation._sharded_wind_fn: the JAX
    package's wind_fn) on star-forming rows: winds_subgrid with no
    dispersion keyed fold_in(key, 77), then the decoupling update over
    per-row intervals, as the JAX package's."""
    import jax
    import jax.numpy as jnp
    from mpgadget_tpu.physics import winds as jwinds
    from mpgadget_tpu_torch.physics import winds as twinds
    from mpgadget_tpu_torch.run import Simulation
    from mpgadget_tpu_torch.utils import threefry
    rng = np.random.RandomState(8)
    n = 512
    st = {"mass": (1 + rng.rand(n)).astype(np.float32),
          "pid": np.arange(n, dtype=np.int64) * 7 + 3,
          "vel": rng.randn(n, 3).astype(np.float32),
          "entropy": (1 + rng.rand(n)).astype(np.float32),
          "density": (10.0 ** rng.uniform(-8, -5, n)).astype(np.float32),
          "delay_time": np.where(rng.rand(n) < 0.3, rng.rand(n),
                                 0.0).astype(np.float32)}
    out = {"sm": (0.5 * rng.rand(n)).astype(np.float32),
           "on_eeqos": rng.rand(n) < 0.6}
    dl = (0.01 * rng.rand(n)).astype(np.float32)
    scal = {"atime": 0.2, "hubble": 12.0, "key": threefry.prng_key(4)}
    model = jwinds.WIND_SUBGRID | jwinds.WIND_DECOUPLE_SPH \
        | jwinds.WIND_FIXED_EFFICIENCY
    jp = jwinds.init_winds(jwinds.WindParams(model=model), 0.1, 1e3, 1e-7,
                           3.08568e16)
    tp = twinds.init_winds(twinds.WindParams(model=model), 0.1, 1e3, 1e-7,
                           3.08568e16)
    sim = Simulation.__new__(Simulation)
    sim._winds = tp
    got = sim._sharded_wind_fn()(
        {k: torch.as_tensor(v) for k, v in st.items()},
        {k: torch.as_tensor(v) for k, v in out.items()}, torch.as_tensor(dl),
        scal)
    wkey = jax.random.fold_in(jax.random.PRNGKey(4), 77)
    j = {k: jnp.asarray(v) for k, v in st.items()}
    v, e, dly, _ = jwinds.winds_subgrid(
        jp, wkey, sm=jnp.asarray(out["sm"]), mass=j["mass"], pid=j["pid"],
        vdisp=jnp.zeros_like(j["mass"]), vel=j["vel"], entropy=j["entropy"],
        density=j["density"], delay_time=j["delay_time"],
        eligible=jnp.asarray(out["on_eeqos"]), atime=jnp.float32(0.2))
    dly = jwinds.winds_decouple_update(
        jp, dly, j["density"], jnp.asarray(dl) / jnp.float32(12.0),
        jnp.float32(0.2))
    kicked = np.any(np.asarray(v) != st["vel"], axis=1)
    assert kicked.sum() > 0
    for a, b in zip(got, (v, e, dly)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                   atol=1e-7)


def test_sharded_refuses_what_the_jax_package_refuses(tmp_path):
    """WindOn without star formation, subgrid winds without fixed
    efficiency (sh03's), and metal return without star formation are
    refused before the first step, as the JAX package's run_sharded
    refuses them."""
    from mpgadget_tpu_torch.parallel.mesh import make_sim_mesh
    from mpgadget_tpu_torch.run import check_sharded_supported
    sim = W.build_gas_run(str(tmp_path), "cool", WindOn=1)
    with pytest.raises(ValueError, match="WindOn needs StarformationOn"):
        sim.run_sharded(make_sim_mesh("cpu"))
    assert sim.ti_current == 0
    cfg = sim.cfg
    cfg.starformation_on = True
    cfg.wind_model = 1 | 2 | 4          # subgrid + decouple + halo
    with pytest.raises(ValueError, match="fixed efficiency"):
        check_sharded_supported(cfg, True)
    cfg.wind_model = 1 | 2 | 8          # sh03
    check_sharded_supported(cfg, True)
    cfg.wind_model = 4 | 2              # ofjt10
    cfg.metal_return_on = cfg.black_hole_on = True
    check_sharded_supported(cfg, True)


# ---- the JAX record ----------------------------------------------------------

def _jax_rows(d, keys):
    import jax.numpy as jnp
    return {k: jnp.asarray(d[k].astype(np.int64) if k == "pid" else d[k])
            for k in keys}


def jax_subgrid_module_record(S):
    """The JAX package's side of the sharded subgrid cases at S shards."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from mpgadget_tpu.parallel.blackhole import build_sharded_bh
    from mpgadget_tpu.parallel.decomp import exchange_to_slabs
    from mpgadget_tpu.parallel.fof import build_seed_convert, sharded_fof
    from mpgadget_tpu.parallel.mesh import shard_particles
    from mpgadget_tpu.parallel.metals import build_sharded_metal_return
    from mpgadget_tpu.parallel.winds import build_sharded_winds
    from mpgadget_tpu.physics import blackhole as jbh
    from mpgadget_tpu.physics import metal_return as jmr
    from mpgadget_tpu.physics import winds as jwinds
    from mpgadget_tpu.physics.fof import FOFParams

    mesh = Mesh(np.array(jax.devices("cpu")[:S]), ("x",))
    rec = {}

    def place(d, keys):
        st = _jax_rows(d, keys)
        st["valid"] = jnp.ones(len(d["pid"]), bool)
        return shard_particles(st, mesh, axis="x")

    # winds
    d = W.wind_module_inputs()
    w = W.SG_WIND
    for model in ("ofjt10", "vs08"):
        n = len(d["pid"])
        fn = build_sharded_winds(mesh, n_local=n // S, nstar_cap=8,
                                 par=W.wind_params(jwinds, model),
                                 boxsize=W.SG_BOX,
                                 mean_sep=W.SG_BOX / np.cbrt(n))
        upd, stats = fn(place(d, d.keys()), {
            "atime": jnp.float32(w["atime"]), "dtime": jnp.float32(
                w["dtime"]), "aform_min": jnp.float32(
                w["atime"] * (1 - 1e-6)),
            "rng_wind": jax.random.PRNGKey(w["key"])})
        assert not int(stats["ovf"])
        p = f"wind_{model}_"
        rec[p + "pid"] = d["pid"]
        for k, v in upd.items():
            rec[p + k] = np.asarray(v)
        rec[p + "n_kicked"] = np.int64(stats["n_kicked"])
        rec[p + "n_new"] = np.int64(stats["n_new"])

    # black holes
    b = W.SG_BH
    for variant in W.BH_VARIANTS:
        d = W.merger_module_inputs() if variant == "merge" else \
            W.bh_module_inputs(variant)
        n = len(d["pid"])
        fn = build_sharded_bh(
            mesh, n_local=n // S, nbh_cap=8,
            par=W.bh_params(jbh, variant), boxsize=W.SG_BOX,
            gconst=b["gconst"], unit_time_in_s=b["unit_time"],
            hubble_param=b["hubble"], unit_velocity=b["unit_vel"],
            uu_in_cgs=b["uu"], rho_crit_baryon=b["rho_crit_b"],
            kernel_type=b["kernel"], reposition=variant == "full")
        upd, stats = fn(place(d, d.keys()), {
            "atime": jnp.float32(b["atime"]),
            "dtime": jnp.float32(b["dtime"]),
            "rng_bh": jax.random.PRNGKey(b["key"]),
            "bh_soft": jnp.float32(2.0 if variant == "merge" else
                                   b["soft"])})
        assert not int(stats["ovf"])
        p = f"bh_{variant}_"
        full = dict(d)
        full.update({k: np.asarray(v) for k, v in upd.items()})
        for k in ("pid", "valid", "ptype", "ipos", "bh_progs") + BH_FLOAT:
            rec[p + k] = np.asarray(full[k])
        for k in ("n_bh", "n_swallowed", "n_merged", "mdot_sum",
                  "bh_mass_total"):
            rec[p + "stat_" + k] = np.float64(stats[k])

    # metal return: rows placed by their geometric slab
    d = W.metal_module_inputs()
    n = len(d["pid"])
    un, cp = W.metal_units_cosmology("mpgadget_tpu")
    age = jmr.AgeTable(cp.hubble_function, un, 0.7)
    n_local = n
    owner = (d["ipos"][:, 0].astype(np.int64) * S) >> 32
    cols = ("ipos", "mass", "hsml", "density", "gas_mask", "star_hsml",
            "metals", "birth_metallicity", "formation_time",
            "total_mass_returned", "last_enrichment_myr", "pid",
            "metallicity", "ptype")
    lay = {k: np.zeros((S * n_local,) + d[k].shape[1:], d[k].dtype)
           for k in cols}
    for s in range(S):
        r = np.nonzero(owner == s)[0]
        for k in cols:
            lay[k][s * n_local:s * n_local + len(r)] = d[k][r]
    placed = np.zeros(S * n_local, bool)
    for s in range(S):
        placed[s * n_local:s * n_local + int((owner == s).sum())] = True
    lay["gas_mask"] = lay["gas_mask"] & placed
    lay["star_mask"] = (lay["ptype"] == 4) & placed
    keys = ("ipos", "mass", "hsml", "density", "gas_mask", "star_mask",
            "star_hsml", "metals", "birth_metallicity", "formation_time",
            "total_mass_returned", "last_enrichment_myr")
    st = shard_particles({k: jnp.asarray(lay[k]) for k in keys}, mesh,
                         axis="x")
    geo = (np.arange(S, dtype=np.uint64) * (2 ** 32 // S)).astype(np.uint32)
    margin = 1.6
    while True:
        fn = build_sharded_metal_return(
            mesh, n_local=n_local, ghost_cap=n_local, hops=max(S // 2, 1),
            age_table=age, params=jmr.MetalReturnParams(), boxsize=W.SG_BOX,
            margin=margin)
        upd, fl = fn(st, jnp.asarray(geo), jnp.float32(W.SG_METAL["a0"]),
                     jnp.float32(W.SG_METAL["a1"]))
        assert not int(fl["ghost"]), fl
        if not int(fl["strip"]):
            break
        margin *= 1.5
    rec["metal_margin"] = np.float64(margin)
    rec["metal_returned"] = np.float64(fl["returned"])
    rec["metal_pid"] = lay["pid"][placed]
    for k in ("mass", "metals", "star_hsml", "total_mass_returned",
              "last_enrichment_myr"):
        rec["metal_" + k] = np.asarray(upd[k])[placed]
    gas = lay["gas_mask"][placed]
    rec["metal_metallicity"] = np.where(
        gas, rec["metal_metals"][:, 2:].sum(axis=1),
        lay["metallicity"][placed]).astype(np.float32)

    # the FOF's seeding extras and build_seed_convert
    d = W.seed_module_inputs()
    log2s = int(np.log2(S))
    nl0 = W.n_local_of(S)
    npad = nl0 * S
    keys = ("ipos", "pid", "mass", "vel", "ptype", "density", "gas_mask",
            "bh_mass", "bh_mtrack", "formation_time")

    def pad(a):
        return np.concatenate([a, np.zeros((npad - len(a),) + a.shape[1:],
                                           a.dtype)])

    sh = shard_particles(dict({k: pad(d[k].astype(np.int64) if k == "pid"
                                      else d[k]) for k in keys},
                              valid=pad(np.ones(W.N, bool))), mesh, axis="x")

    def exch(v, *c):
        out, v2, ovf = exchange_to_slabs(c, c[0], v, "x", log2s, nl0)
        return (*out, v2, jax.lax.psum(ovf.astype(jnp.int32), "x"))

    nk = len(keys)
    ex = jax.jit(shard_map(
        exch, mesh=mesh, in_specs=(P("x"),) * (nk + 1),
        out_specs=(P("x"),) * (nk + 1) + (P(),)))(
        sh["valid"], *(sh[k] for k in keys))
    assert not int(ex[-1])
    e = dict(zip(keys, ex[:nk]))
    ev = ex[nk]
    nl = int(e["ipos"].shape[0]) // S
    e["gas_mask"] = e["gas_mask"] & ev
    params = FOFParams(linking_length=W.FOF_LL, min_group_length=W.FOF_MIN)
    cat, _, extras, _ = sharded_fof(
        mesh, {"ipos": e["ipos"], "vel": e["vel"], "mass": e["mass"],
               "ptype": e["ptype"], "valid": ev, "density": e["density"],
               "gas_mask": e["gas_mask"]}, geo, boxsize=W.SG_BOX,
        mean_sep=W.SG_BOX / np.cbrt(int((d["ptype"] == 1).sum())),
        n_local=nl, params=params)
    pid_lay = np.asarray(e["pid"])
    gid = extras["seed_gid"]
    ok = gid < 2 ** 31 - 1
    rec["seed_pid_part"] = np.where(ok, pid_lay[np.where(ok, gid, 0)], -1)
    rec["seed_has_bh"] = extras["has_bh"]
    rec["seed_seed_density"] = extras["seed_density"]
    rec["seed_masses"] = cat["masses"]
    rec["seed_lengths"] = cat["lengths"]
    pick = ~extras["has_bh"] & ok
    seeds = np.sort(gid[pick].astype(np.int32))
    pad_s = np.full(max(64, len(seeds)), 2 ** 31 - 1, np.int32)
    pad_s[:len(seeds)] = seeds
    fn = build_seed_convert(mesh, n_local=nl)
    sub = {k: e[k] for k in ("ptype", "gas_mask", "bh_mass", "bh_mtrack",
                             "mass", "formation_time")}
    sub["valid"] = ev
    upd, nseeded = fn(sub, jnp.asarray(pad_s), {
        "seed_mass": jnp.float32(W.SG_SEED["seed_mass"]),
        "seed_dyn_mass": jnp.float32(W.SG_SEED["seed_dyn_mass"]),
        "atime": jnp.float32(W.SG_SEED["atime"])})
    rec["seed_n"] = np.int64(nseeded)
    rec["seed_pid"] = pid_lay
    rec["seed_valid"] = np.asarray(ev)
    for k, v in upd.items():
        rec["seed_new_" + k] = np.asarray(v)
    return rec


@pytest.mark.slow
def test_jax_subgrid_module_record():
    """Computes the JAX side anew and holds the committed record to it
    (or, with MPG_WRITE_SHARDED_FIXTURE=1, writes it)."""
    new = {}
    for S in RANKS:
        for k, v in jax_subgrid_module_record(S).items():
            new[f"S{S}_{k}"] = np.asarray(v)
    if os.environ.get("MPG_WRITE_SHARDED_FIXTURE") == "1":
        RECORD.parent.mkdir(exist_ok=True)
        np.savez_compressed(RECORD, **new)
    rec = np.load(RECORD)
    assert sorted(rec.files) == sorted(new)
    for k, v in new.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(rec[k], v, rtol=1e-6, atol=1e-12,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(rec[k], v, err_msg=k)
