"""The port's run with cooling and star formation, against the JAX package.

One gas IC (the port's genic: Ngrid 8, 512 gas and 512 DM particles,
BoxSize 5000 kpc/h, z = 9, the Eisenstein-Hu spectrum) is read by both
packages' build_simulation from the same paramfile string: lya's gas
physics (HydroOn, DensityIndependentSphOn 0, the cubic kernel, CoolingOn,
StarformationOn, no UV background: TreeCoolFile empty, InitGasTemp 270,
MinGasTemp 100), Nmesh 16.  So that stars form at z ~ 9 in so small a
box, CritOverDensity is 1 and CritPhysDensity 1e-4 cm^-3 (about the mean
baryon density there), and a mean baryon mass of 1/64 of a particle
(Generations 64) makes partial stars likely.  Three configurations, each
run once by each package (module fixture): ``spawn`` (stochastic star
formation: new star particles in free rows), ``qla``
(QuickLymanAlphaProbability 1: cold dense gas converts whole) and
``cool`` (StarformationOn 0: cooling alone, run.py's apply_cooling).  Each runs
two global KDK steps (state recorded, and a snapshot written), then one
hierarchical PM step (SplitGravityTimestepsOn switched on: the source
terms per closing bin).  The port runs its plain versions on the CPU;
tests/test_torch_cuda.py holds K6 to them on a card.

Tolerances: positions within 16 (global) and 32 (hierarchical) ticks,
every float field within 2e-5 relative by norm (the cooling's float32
tolerance, tests/test_torch_cooling.py, carried through the steps);
ptype, pid, valid, the bins and the star masks identical; sfr.txt's
floats within 1e-4 (six printed digits) and its counts equal.  Spawned
stars' positions within 1024 ticks (2.4e-7 of the box): a new star sits
on its parent gas particle, and the tree walk's open/discard decisions
around such a near-coincident pair flip under the few-tick differences
the two runs carry, which moves its short-range force by the tree's own
error (1.1e-4 against 1.8e-6 for every other particle, 237 ticks after
the hierarchical step).  The tree itself is not the cause: on the JAX
run's own state the port's tree force equals the JAX package's
(test_tree_force_on_the_jax_state).
"""

from dataclasses import fields

import numpy as np
import pytest
import torch

from mpgadget_tpu.main import build_simulation as jax_build
from mpgadget_tpu.params import create_gadget_parameter_set as jax_params
from mpgadget_tpu_torch.genic.main import run_genic
from mpgadget_tpu_torch.io import snapshot as snap_io
from mpgadget_tpu_torch.io.bigfile import BigFile
from mpgadget_tpu_torch.main import build_simulation
from mpgadget_tpu_torch.params import (create_gadget_parameter_set,
                                       create_genic_parameter_set)
from mpgadget_tpu_torch.physics.stars import StarData
from mpgadget_tpu_torch.run import SimConfig, check_supported

torch.set_num_threads(1)

NG = 8
TOL = 2e-5          # relative, by norm
GENIC = """
OutputDir = {out}
FileBase = IC
Omega0 = 0.288
OmegaBaryon = 0.0472
OmegaLambda = 0.712
HubbleParam = 0.7
ProduceGas = 1
BoxSize = 5000
Redshift = 9
Ngrid = {ng}
Nmesh = 16
Seed = 181170
UnitaryAmplitude = 1
WhichSpectrum = 1
Sigma8 = 0.8
InputPowerRedshift = 0
FileWithInputSpectrum = none
DifferentTransferFunctions = 0
"""
PARAMS = """
InitCondFile = {ic}
OutputDir = {out}
OutputList = 0.2
TimeMax = 0.2
TimeLimitCPU = 10000
Omega0 = 0.288
OmegaLambda = 0.712
OmegaBaryon = 0.0472
HubbleParam = 0.7
HydroOn = 1
DensityIndependentSphOn = 0
DensityKernelType = cubic
CoolingOn = 1
StarformationOn = 1
TreeCoolFile =
InitGasTemp = 270.
MinGasTemp = 100
CritOverDensity = 1
CritPhysDensity = 1e-4
Generations = 64
WindOn = 0
BlackHoleOn = 0
MetalReturnOn = 0
MassiveNuLinRespOn = 0
SnapshotWithFOF = 0
SplitGravityTimestepsOn = 0
Nmesh = 16
"""
CONFIGS = {"spawn": {}, "qla": {"QuickLymanAlphaProbability": 1.0},
           "cool": {"StarformationOn": 0}}
STAR_CONFIGS = ("spawn", "qla")    # the configurations that form stars
PDATA = ("vel", "mass", "hsml")
SPH = ("entropy", "density", "ne", "sfr", "metallicity", "hydro_accel",
       "dt_entropy")
STARS = ("formation_time", "birth_density", "metallicity")


def _np(x):
    return x.cpu().numpy().copy() if isinstance(x, torch.Tensor) \
        else np.array(x)


def _state(sim):
    """numpy copies of what the comparisons read, from either package."""
    st = {k: _np(getattr(sim.pdata, k))
          for k in PDATA + ("ipos", "ptype", "pid", "valid", "timebin")}
    st["ipos"] = st["ipos"].astype(np.int64)
    st.update({k: _np(getattr(sim.sph, k)) for k in SPH})
    st.update({"star_" + k: _np(getattr(sim.stars, k)) for k in STARS}
              if sim.stars is not None else {})
    st["ti"] = sim.ti_current
    return st


def _params(create, ic, out, **override):
    ps = create()
    ps.parse_string(PARAMS.format(ic=ic, out=out))
    for k, v in override.items():
        ps.set(k, v)
    ps.validate()
    return ps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_star_run")
    gps = create_genic_parameter_set()
    gps.parse_string(GENIC.format(out=tmp / "ics", ng=NG))
    gps.validate()
    ic = run_genic(gps, device="cpu")
    out = {"ic": ic, "tmp": tmp}
    for config, over in CONFIGS.items():
        for name, build, create, kw in (
                ("jax", jax_build, jax_params, {}),
                ("torch", build_simulation, create_gadget_parameter_set,
                 {"device": "cpu"})):
            odir = tmp / f"{config}_{name}"
            sim, _ = build(_params(create, ic, odir, **over), **kw)
            states = {}
            assert sim.run(max_steps=2, verbose=False) == 2
            states["global"] = _state(sim)
            if name == "torch":
                states["snapshot"] = sim.write_snapshot()
            sim.cfg.split_gravity_timesteps = True
            assert sim.run(max_steps=1, verbose=False) == 1
            states["hier"] = _state(sim)
            if config in STAR_CONFIGS:
                with open(odir / "sfr.txt") as fh:
                    states["sfr_txt"] = [ln.split() for ln in fh]
            states["sim"] = sim
            out[config, name] = states
    return out


def _compare(a, b, ticks):
    assert a["ti"] == b["ti"]
    for k in ("ptype", "pid", "valid", "timebin"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    d = np.abs((b["ipos"] - a["ipos"] + 2 ** 31) % 2 ** 32 - 2 ** 31).max(1)
    spawned = a["valid"] & (a["pid"] >= 2 ** 40)
    assert d[a["valid"] & ~spawned].max() <= ticks
    assert not spawned.any() or d[spawned].max() <= 1024
    rel = {}
    for k in PDATA + SPH + tuple("star_" + s for s in STARS):
        if k not in a and k not in b:
            continue
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        rel[k] = np.linalg.norm(y - x) / max(np.linalg.norm(x), 1e-300)
    bad = {k: v for k, v in rel.items() if not v < TOL}
    assert not bad, bad


@pytest.mark.parametrize("config", list(CONFIGS))
def test_two_global_steps_match_jax(runs, config):
    """Two global KDK steps with cooling (and star formation, where on): the
    same stars in the same rows, the gas and star state to 2e-5 by norm."""
    a, b = runs[config, "jax"]["global"], runs[config, "torch"]["global"]
    _compare(a, b, ticks=16)
    stars = b["valid"] & (b["ptype"] == 4)
    assert stars.any() == (config in STAR_CONFIGS)
    spawned = b["valid"].sum() - NG ** 3 * 2
    if config == "cool":
        assert spawned == 0 and (b["valid"] & (b["ptype"] == 0)).sum() \
            == NG ** 3
    elif config == "spawn":
        assert spawned > 0 and np.all(b["pid"][stars] >= 2 ** 40)
    else:
        assert spawned == 0 and np.all(b["pid"][stars] < 2 ** 40)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_hierarchical_step_matches_jax(runs, config):
    """One hierarchical PM step, the source terms applied per closing bin
    over each particle's own interval: the same bins and stars, positions
    within 32 ticks, the rest to 2e-5 by norm."""
    a, b = runs[config, "jax"]["hier"], runs[config, "torch"]["hier"]
    _compare(a, b, ticks=32)
    log = runs[config, "torch"]["sim"].step_log[-1]
    assert log["n_sub"] > 1


@pytest.mark.parametrize("config", STAR_CONFIGS)
def test_sfr_txt_matches_jax(runs, config):
    """sfr.txt: one line per source step (2 global steps, then one per
    substep), column by column: a as printed, the five floats within 1e-4,
    the star-forming and new-star counts equal."""
    a = runs[config, "jax"]["sfr_txt"]
    b = runs[config, "torch"]["sfr_txt"]
    assert len(a) == len(b) > 2
    for la, lb in zip(a, b):
        assert len(la) == len(lb) == 8
        assert la[0] == lb[0]
        np.testing.assert_allclose([float(x) for x in lb[1:6]],
                                   [float(x) for x in la[1:6]], rtol=1e-4)
        assert la[6:] == lb[6:]
    assert sum(int(ln[7]) for ln in b) > 0


@pytest.mark.parametrize("config", STAR_CONFIGS)
def test_star_snapshot_reads_back(runs, config):
    """The snapshot after the global steps holds the type-4 blocks, and the
    port's from_snapshot (PartAllocFactor padding) restores StarData on the
    star rows and the gas ne and Metallicity."""
    st = runs[config, "torch"]["global"]
    path = runs[config, "torch"]["snapshot"]
    bf = BigFile(path)
    hdr = snap_io.read_header(bf)
    star = st["valid"] & (st["ptype"] == 4)
    gas = st["valid"] & (st["ptype"] == 0)
    assert int(hdr.TotNumPart[4]) == star.sum() > 0
    for block in ("StarFormationTime", "BirthDensity", "Metallicity",
                  "Metals", "TotalMassReturned", "LastEnrichmentMyr"):
        assert len(bf.open(f"4/{block}").read()) == star.sum(), block
    sim, _ = build_simulation(
        _params(create_gadget_parameter_set, runs["ic"],
                runs["tmp"] / f"restart_{config}", **CONFIGS[config]),
        snapshot=path, device="cpu")
    assert sim.pdata.capacity >= 1.5 * (gas.sum() + star.sum() + NG ** 3)
    sim._restore_gas()
    rstar = (sim.pdata.valid & (sim.pdata.ptype == 4)).numpy()
    rgas = sim.gas_mask.numpy()
    assert isinstance(sim.stars, StarData)
    # the snapshot holds the particles type by type, in row order
    np.testing.assert_array_equal(sim.stars.formation_time.numpy()[rstar],
                                  st["star_formation_time"][star])
    np.testing.assert_array_equal(sim.stars.birth_density.numpy()[rstar],
                                  st["star_birth_density"][star])
    np.testing.assert_array_equal(sim.pdata.pid.numpy()[rstar],
                                  st["pid"][star])
    for k in ("ne", "metallicity"):
        np.testing.assert_array_equal(getattr(sim.sph, k).numpy()[rgas],
                                      st[k][gas])


def test_tree_force_on_the_jax_state(runs):
    """Both packages' short-range tree force on the JAX run's final state
    (spawned stars beside their parents included): within 1e-6 of the
    largest |accel|."""
    from mpgadget_tpu_torch.particles import ParticleData
    jsim = runs["spawn", "jax"]["sim"]
    tsim = runs["spawn", "torch"]["sim"]
    pdata = ParticleData.from_jax_numpy(
        {f.name: np.asarray(getattr(jsim.pdata, f.name))
         for f in fields(ParticleData)}, device="cpu")
    tsim._tree_grav._use_bh_now = bool(jsim._tree_grav._use_bh_now)
    want = np.asarray(jsim._tree_grav.compute(jsim.pdata))
    got = tsim._tree_grav.compute(pdata).numpy()
    valid = np.asarray(jsim.pdata.valid)
    assert (np.asarray(jsim.pdata.pid)[valid] >= 2 ** 40).any()
    np.testing.assert_allclose(got[valid], want[valid], rtol=0,
                               atol=1e-6 * np.abs(want[valid]).max())


def test_star_data_carries_from_jax(runs):
    """StarData.from_jax_numpy carries the JAX run's star state into the
    port's: the same fields, shapes and values on the star rows to 2e-5."""
    jst = runs["spawn", "jax"]["sim"].stars
    tst = runs["spawn", "torch"]["sim"].stars
    carried = StarData.from_jax_numpy(
        {f.name: np.asarray(getattr(jst, f.name)) for f in fields(StarData)},
        device="cpu")
    rows = runs["spawn", "torch"]["hier"]["ptype"] == 4
    for f in fields(StarData):
        a, b = getattr(carried, f.name), getattr(tst, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_allclose(b.numpy()[rows], a.numpy()[rows],
                                   rtol=2e-5, err_msg=f.name)


@pytest.mark.parametrize("name,field,value", [
    ("WindOn", "wind_on", True), ("BlackHoleOn", "black_hole_on", True),
    ("MetalReturnOn", "metal_return_on", True),
    ("MetalCoolFile", "metal_cool_file", "cooling.bf"),
    ("UVFluctuationFile", "uv_fluctuation_file", "uvf.bf")])
def test_check_supported_names_refused_switches(name, field, value):
    """With gas, cooling and star formation, the switches this slice does
    not carry raise NotImplementedError naming the parameter and the
    slice."""
    cfg = SimConfig(boxsize=1.0, nmesh=8, output_dir="", timeline=None,
                    units=None, cooling_on=True, starformation_on=True)
    check_supported(cfg, has_gas=True)
    cfg = SimConfig(**{**cfg.__dict__, field: value})
    with pytest.raises(NotImplementedError,
                       match=f"{name} .*cooling and star formation"):
        check_supported(cfg, has_gas=True)
