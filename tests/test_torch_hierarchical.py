"""Hierarchical timebins of the PyTorch port against the JAX package:
per-particle bins, the tree force on an active target set, and one PM
interval of sub-cycled stepping, on a 4096-particle box with a dense
clump (the set-up of tests/test_timebins.py, at Nmesh 32 instead of 16:
rcut then spans a quarter of the box instead of half, which cuts the
plain pair sums' cost on the CPU by three)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpgadget_tpu.cosmology import Cosmology as JCosmology
from mpgadget_tpu.gravity import treepm as jtp
from mpgadget_tpu.particles import ParticleData as JParticleData
from mpgadget_tpu.run import Simulation as JSimulation, SimConfig as JConfig
from mpgadget_tpu.timeline import Timeline as JTimeline
from mpgadget_tpu.timestep import assign_particle_bins as jax_bins
from mpgadget_tpu.utils import get_unitsystem as jax_units
from mpgadget_tpu_torch.cosmology import Cosmology
from mpgadget_tpu_torch.gravity import treepm as ttp
from mpgadget_tpu_torch.particles import ParticleData
from mpgadget_tpu_torch.run import Simulation, SimConfig
from mpgadget_tpu_torch.timeline import Timeline
from mpgadget_tpu_torch.timestep import assign_particle_bins
from mpgadget_tpu_torch.utils import get_unitsystem
from mpgadget_tpu_torch.utils.constants import CM_PER_KPC

# one intra-op thread: the suite runs in several worker processes that
# share the machine's cores
torch.set_num_threads(1)

BOX = 10000.0
N = 4096
N_CLUMP = 256
NMESH = 32


def _positions():
    rng = np.random.RandomState(21)
    pos = rng.uniform(0, BOX, (N, 3))
    pos[:N_CLUMP] = BOX / 2 + rng.randn(N_CLUMP, 3) * BOX * 0.004
    return np.mod(pos, BOX)


def _sims(tmp_path):
    """The same clustered box in both packages.  The JAX one computes
    the first forces; the port starts from them, and from the state they
    leave (TreeUseBH=2: the first call used BH opening), so that both
    assign the same first bins."""
    pos = _positions()
    args = (pos, np.zeros((N, 3)), np.full(N, 10.0), np.ones(N, np.int32),
            np.arange(N) + 1, BOX)
    sims = []
    for mk_pd, cosmo, tl, cfg_cls, sim_cls, units, kw in (
            (JParticleData.from_numpy, JCosmology, JTimeline, JConfig,
             JSimulation, jax_units, {}),
            (ParticleData.from_numpy, Cosmology, Timeline, SimConfig,
             Simulation, get_unitsystem, {"device": "cpu"})):
        u = units(CM_PER_KPC, 1.989e43, 1e5)
        cp = cosmo(Omega0=0.3, OmegaLambda=0.7, HubbleParam=0.7,
                   TimeBegin=0.1).init_units(u)
        cfg = cfg_cls(boxsize=BOX, nmesh=NMESH, output_dir=str(tmp_path),
                      timeline=tl([0.2], TimeIC=0.1, TimeMax=0.2), units=u,
                      hydro_on=False, tree_grav_on=True,
                      split_gravity_timesteps=True,
                      random_particle_offset=0.0)
        sims.append(sim_cls(cp, mk_pd(*args, **kw), cfg, time_ic=0.1))
    jsim, tsim = sims
    jsim.compute_forces(measure_power=False)
    tsim.pdata = tsim.pdata.replace(
        grav_accel=torch.as_tensor(np.array(jsim.pdata.grav_accel)),
        grav_pm=torch.as_tensor(np.array(jsim.pdata.grav_pm)))
    tsim._tree_grav = tsim._make_tree_gravity()
    tsim._tree_grav._use_bh_now = jsim._tree_grav._use_bh_now
    return jsim, tsim


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """Both simulations before and after one hierarchical PM interval."""
    jsim, tsim = _sims(tmp_path_factory.mktemp("torch_hier"))
    before = {k: np.array(getattr(jsim.pdata, k))
              for k in ("ipos", "grav_accel", "grav_pm")}
    # one PM interval 32 times shorter than the box's PM step: the bins
    # then span three levels (six substeps) instead of nine
    dti = jsim.find_pm_timestep() >> 5
    port_dti = tsim.find_pm_timestep() >> 5
    jsub = jsim.step_hierarchical(dti)
    tsub = tsim.step_hierarchical(dti)
    return dict(jsim=jsim, tsim=tsim, before=before, dti=dti,
                port_dti=port_dti, jsub=jsub, tsub=tsub)


def test_bins_identical_from_identical_inputs(stepped):
    """assign_particle_bins of both packages on the same numpy forces:
    the box's own (spread over several bins), the same scaled over four
    decades, and invalid rows."""
    jsim, tsim = stepped["jsim"], stepped["tsim"]
    ga, gp = stepped["before"]["grav_accel"], stepped["before"]["grav_pm"]
    rng = np.random.RandomState(3)
    scale = (10.0 ** rng.uniform(-2, 2, N)).astype(np.float32)[:, None]
    valid = rng.uniform(size=N) > 0.05
    for accel, pm, ok in ((ga, gp, np.ones(N, bool)),
                          (ga * scale, gp * scale, valid)):
        jpd = jsim.pdata.replace(grav_accel=jnp.asarray(accel),
                                 grav_pm=jnp.asarray(pm),
                                 valid=jnp.asarray(ok))
        tpd = tsim.pdata.replace(grav_accel=torch.as_tensor(accel),
                                 grav_pm=torch.as_tensor(pm),
                                 valid=torch.as_tensor(ok))
        for ti, dti_max in ((0, stepped["dti"]), (3 << 40, 1 << 41)):
            want = np.asarray(jax_bins(
                jpd, None, jsim.gas_mask, jsim.CP, 0.1, 50.0, jsim.timeline,
                ti, jsim.cfg.timestep, dti_max))
            got = assign_particle_bins(
                tpd, None, None, tsim.CP, 0.1, 50.0, tsim.timeline, ti,
                tsim.cfg.timestep, dti_max)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
            assert len(np.unique(want[ok])) >= 3


def test_tree_force_active_targets_match_jax(stepped):
    """tree_force(target_active=...) against the JAX package's, with and
    without its active_block_cap, on the stepped box with the clump
    active (the 8 blocks around the centre), each package at its
    simulation's parameters: accelerations within 1e-5 by norm on active
    rows; the port walks exactly the active blocks."""
    jsim, tsim = stepped["jsim"], stepped["tsim"]
    ipos = np.array(jsim.pdata.ipos)
    mass = np.array(jsim.pdata.mass)
    acc = np.array(jsim.pdata.grav_accel) + np.array(jsim.pdata.grav_pm)
    amag = np.sqrt(np.sum(acc * acc, axis=1)).astype(np.float32)
    act = np.zeros(N, bool)
    act[:N_CLUMP] = True
    valid = np.ones(N, bool)
    # the simulations' own parameters (no potential), so that the JAX
    # package reuses the step's compiled tree force
    kw = jsim._tree_grav.force_kwargs(N)
    tkw = tsim._tree_grav.force_kwargs(N)
    timer = ttp.StageTimer()
    tres = ttp.tree_force(torch.as_tensor(ipos.astype(np.int64)),
                          torch.as_tensor(mass), torch.as_tensor(valid),
                          torch.as_tensor(amag),
                          target_active=torch.as_tensor(act), timer=timer,
                          **tkw)
    nb = N // kw["group_size"]
    assert 0 < tres.n_active_blocks <= nb // 2
    assert timer.series["active_blocks"] == [tres.n_active_blocks]
    assert not bool(tres.overflow)
    jargs = (jnp.asarray(ipos), jnp.asarray(mass), jnp.asarray(valid),
             jnp.asarray(amag))
    for cap in (None, nb // 2):
        jres = jtp.tree_force(*jargs, target_active=jnp.asarray(act),
                              active_block_cap=cap, **kw)
        assert int(jres.n_active_blocks) == tres.n_active_blocks
        assert not bool(jres.overflow) and not bool(jres.compact_overflow)
        jacc = np.asarray(jres.accel)[act]
        assert np.linalg.norm(tres.accel.numpy()[act] - jacc) <= \
            1e-5 * np.linalg.norm(jacc)
    # rows outside the walked blocks get nothing
    assert (tres.accel.numpy() == 0).all(axis=1).sum() == \
        (nb - tres.n_active_blocks) * kw["group_size"]


def test_step_hierarchical_matches_jax(stepped):
    jsim, tsim = stepped["jsim"], stepped["tsim"]
    assert stepped["port_dti"] == stepped["dti"]
    assert stepped["tsub"] == stepped["jsub"] >= 4
    assert tsim.ti_current == jsim.ti_current
    log = tsim.step_log[-1]
    assert log["n_sub"] == stepped["tsub"] == len(log["actives"])
    assert sum(log["actives"]) == tsim.force_evals == jsim._force_evals
    assert sum(log["bins"]) == N
    jb = np.asarray(jsim.pdata.timebin)
    tb = tsim.pdata.timebin.numpy()
    moved = tb != jb
    # float32 association may move a particle across a bin edge; none
    # does here, and the rest is held to the slice test's tolerances
    print(f"particles whose bin differs: {int(moved.sum())}")
    assert not moved.any()
    a = np.asarray(jsim.pdata.ipos).astype(np.int64)
    b = tsim.pdata.ipos.numpy()
    d = (b - a + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert np.abs(d).max() <= 16
    assert np.abs((a - stepped["before"]["ipos"].astype(np.int64))).max() \
        > 1000                                # particles did move
    va, vb = np.asarray(jsim.pdata.vel), tsim.pdata.vel.numpy()
    assert np.linalg.norm(vb - va) <= 1e-4 * np.linalg.norm(va)
