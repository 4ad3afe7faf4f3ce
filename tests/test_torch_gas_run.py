"""The port's non-radiative SPH run as a whole, against the JAX package.

One gas IC (the port's genic: Ngrid 8, gas and DM, BoxSize 5000 kpc/h,
z = 9, the Eisenstein-Hu spectrum) is read by both packages'
build_simulation from the same paramfile string: HydroOn 1 with
DensityIndependentSphOn 1 (star-small's formulation), cooling, star
formation, winds, black holes and metal return off, Nmesh 16.  The cubic
kernel (lya's; DesNumNgb 33.5): at 8^3 gas the quintic's 113 neighbours
need a smoothing length near the 0.45-box cap, where some particles never
converge.  Each package runs once (module fixture): Simulation.run for
two global KDK steps, the state recorded after setup_gas and the first
compute_hydro, then one hierarchical PM step
(SplitGravityTimestepsOn switched on).  The port runs its plain versions
on the CPU; tests/test_torch_cuda.py holds K4 and K5 to them on a card.

The IC is committed as ``torch_gas/IC`` and the JAX package's run from it
as ``torch_gas/jax_run.npz`` (with its final SPH state), which the port's
run from the same IC is held to.  (The IC is read, not made again: genic's
FFTs round differently on different CPUs, which moved positions by up to
53 ticks before any step.)  ``test_jax_run_matches_its_record`` (slow)
runs the JAX package from the IC and holds it to the record, and with
MPG_WRITE_GAS_FIXTURE=1 writes the IC and the record anew:

    MPG_WRITE_GAS_FIXTURE=1 python -m pytest -m slow \
        tests/test_torch_gas_run.py
"""

import os
import shutil
from dataclasses import fields
from pathlib import Path

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
from mpgadget_tpu_torch.sph.state import SphData

# one intra-op thread: the suite runs in several worker processes that
# share the machine's cores
torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "torch_gas"
IC = FIXTURE / "IC"
RECORD = FIXTURE / "jax_run.npz"
NG = 8
TOL = 1e-5          # relative, by norm
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
DensityIndependentSphOn = 1
DensityKernelType = cubic
CoolingOn = 0
StarformationOn = 0
WindOn = 0
BlackHoleOn = 0
MetalReturnOn = 0
MassiveNuLinRespOn = 0
SnapshotWithFOF = 0
SplitGravityTimestepsOn = 0
Nmesh = 16
"""
SPH_FIELDS = ("entropy", "density", "egy_wt_density", "dhsml_density_factor",
              "dhsml_egy_factor", "div_vel", "curl_vel", "hydro_accel",
              "dt_entropy", "max_signal_vel")


def _state(sim):
    """numpy copies of what the comparisons read, from either package."""
    def np_(x):
        return x.cpu().numpy().copy() if isinstance(x, torch.Tensor) \
            else np.array(x)
    st = {k: np_(getattr(sim.sph, k)) for k in SPH_FIELDS}
    for k in ("ipos", "vel", "hsml", "timebin"):
        st[k] = np_(getattr(sim.pdata, k))
    st["ipos"] = st["ipos"].astype(np.int64)
    st["ti"] = sim.ti_current
    return st


def _record_first_hydro(sim, states):
    """Record the state right after the first compute_hydro (the one at
    the start of run(), after setup_gas)."""
    real = sim.compute_hydro

    def spy(*a, **k):
        real(*a, **k)
        states.setdefault("first", _state(sim))
    sim.compute_hydro = spy


def _params(create, ic, out, **override):
    ps = create()
    ps.parse_string(PARAMS.format(ic=ic, out=out))
    for k, v in override.items():
        ps.set(k, v)
    ps.validate()
    return ps


def make_ic():
    """The committed IC, written anew: the port's genic at Ngrid 8
    (GENIC)."""
    gps = create_genic_parameter_set()
    gps.parse_string(GENIC.format(out=FIXTURE, ng=NG))
    gps.validate()
    if IC.exists():
        shutil.rmtree(IC)
    return run_genic(gps, device="cpu")


def run_package(name, ic, tmp):
    """The run by the JAX package or the port (CPU): the states after the
    first compute_hydro, the two global steps and the hierarchical step;
    the port's also its snapshot and simulation, the JAX package's its
    final SPH state (every SphData field)."""
    build, create, kw = {
        "jax": (jax_build, jax_params, {}),
        "torch": (build_simulation, create_gadget_parameter_set,
                  {"device": "cpu"})}[name]
    sim, _ = build(_params(create, ic, tmp / name), **kw)
    states = {}
    _record_first_hydro(sim, states)
    assert sim.run(max_steps=2, verbose=False) == 2
    states["global"] = _state(sim)
    if name == "torch":
        states["snapshot"] = sim.write_snapshot()
        states["at_snapshot"] = _state(sim)
    sim.cfg.split_gravity_timesteps = True
    assert sim.run(max_steps=1, verbose=False) == 1
    states["hier"] = _state(sim)
    if name == "torch":
        states["sim"] = sim
    else:
        states["sph"] = {f.name: np.asarray(getattr(sim.sph, f.name))
                         for f in fields(SphData)}
    return states


def write_record(run):
    RECORD.parent.mkdir(exist_ok=True)
    np.savez_compressed(RECORD, **{f"{part}/{k}": np.asarray(v)
                                   for part, st in run.items()
                                   for k, v in st.items()})


def read_record():
    out = {}
    with np.load(RECORD) as z:
        for key in z.files:
            part, name = key.split("/", 1)
            v = z[key]
            out.setdefault(part, {})[name] = v.item() if name == "ti" else v
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_gas_run")
    ic = str(IC)
    return {"ic": ic, "tmp": tmp, "jax": read_record(),
            "torch": run_package("torch", ic, tmp)}


@pytest.mark.slow
def test_jax_run_matches_its_record(tmp_path):
    """The JAX package's run from the committed IC against its committed
    record: every array within 1e-6 by norm.  With MPG_WRITE_GAS_FIXTURE=1
    it writes the IC and the record anew."""
    write = bool(os.environ.get("MPG_WRITE_GAS_FIXTURE"))
    if write:
        FIXTURE.mkdir(exist_ok=True)
        make_ic()
    run = run_package("jax", str(IC), tmp_path)
    if write:
        write_record(run)
    rec = read_record()
    assert set(rec) == set(run)
    for part in run:
        a, b = rec[part], run[part]
        assert set(a) == set(b), part
        for k in a:
            x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
            assert x.shape == y.shape, (part, k)
            err = np.linalg.norm(y - x) / max(np.linalg.norm(x), 1e-300)
            assert err <= 1e-6, (part, k, err)


def _compare(a, b, ticks):
    assert a["ti"] == b["ti"]
    d = (b["ipos"] - a["ipos"] + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert np.abs(d).max() <= ticks
    rel = {}
    for k in ("vel", "hsml") + SPH_FIELDS:
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        rel[k] = np.linalg.norm(y - x) / max(np.linalg.norm(x), 1e-300)
    bad = {k: v for k, v in rel.items() if not v < TOL}
    assert not bad, bad


def test_setup_gas_and_first_hydro_match_jax(runs):
    """After setup_gas (hsml bisection, the entropy <-> EgyWtDensity
    iteration) and the first compute_hydro, before any step: the same
    SPH state to 1e-5 by norm, positions untouched."""
    _compare(runs["jax"]["first"], runs["torch"]["first"], ticks=0)
    gas = runs["torch"]["sim"].gas_mask.numpy()
    st = runs["torch"]["first"]
    assert np.all(st["entropy"][gas] > 0) and np.all(st["hsml"][gas] > 0)
    assert np.abs(st["hydro_accel"][gas]).max() > 0


def test_sph_state_carries_from_jax(runs):
    """SphData.from_jax_numpy carries the JAX package's SPH state into the
    port's: the same fields, shapes and types, and equal values where
    the non-radiative path keeps the initial ones (ne, metals, zreion,
    ...)."""
    tsph = runs["torch"]["sim"].sph
    carried = SphData.from_jax_numpy(runs["jax"]["sph"], device="cpu")
    for f in fields(SphData):
        a, b = getattr(carried, f.name), getattr(tsph, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
    for name in ("ne", "metallicity", "metals", "sfr", "delay_time",
                 "he_iii_ionized", "local_j21", "zreion"):
        assert torch.equal(getattr(carried, name), getattr(tsph, name)), name


def test_two_global_steps_match_jax(runs):
    """Two global KDK steps with hydro: positions within 16 fixed-point
    ticks, velocities and the SPH state to 1e-5 by norm."""
    _compare(runs["jax"]["global"], runs["torch"]["global"], ticks=16)


def test_hierarchical_step_matches_jax(runs):
    """One hierarchical PM step (compute_hydro on the closing targets of
    each substep, bins from the gravity and Courant criteria): the same
    bins, positions within 32 ticks, the rest to 1e-5 by norm."""
    a, b = runs["jax"]["hier"], runs["torch"]["hier"]
    np.testing.assert_array_equal(a["timebin"], b["timebin"])
    _compare(a, b, ticks=32)
    log = runs["torch"]["sim"].step_log[-1]
    assert log["n_sub"] > 1 and sum(1 for c in log["bins"] if c) > 1


def test_gas_snapshot_reads_back(runs):
    """A gas snapshot written by the port holds the SPH blocks, and the
    port's from_snapshot restores the same SPH state from it."""
    st = runs["torch"]["at_snapshot"]
    path = runs["torch"]["snapshot"]
    bf = BigFile(path)
    hdr = snap_io.read_header(bf)
    ngas = int(hdr.TotNumPart[0])
    assert ngas == NG ** 3
    for block in ("Density", "SmoothingLength", "InternalEnergy",
                  "EgyWtDensity", "ElectronAbundance", "Metals"):
        assert len(bf.open(f"0/{block}").read()) == ngas, block
    sim, _ = build_simulation(
        _params(create_gadget_parameter_set, runs["ic"],
                runs["tmp"] / "restart"), snapshot=path, device="cpu")
    sim._restore_gas()
    gas = sim.gas_mask.numpy()
    # the snapshot holds the particles type by type: gas first
    order = np.argsort(runs["torch"]["sim"].pdata.ptype.numpy(),
                       kind="stable")
    src = {k: v[order] for k, v in st.items() if isinstance(v, np.ndarray)}
    assert gas.sum() == ngas
    np.testing.assert_array_equal(sim.pdata.hsml.numpy()[gas],
                                  src["hsml"][:ngas])
    for k in ("density", "egy_wt_density"):
        np.testing.assert_array_equal(getattr(sim.sph, k).numpy()[gas],
                                      src[k][:ngas])
    # entropy comes back through InternalEnergy (float32 round trip)
    np.testing.assert_allclose(sim.sph.entropy.numpy()[gas],
                               src["entropy"][:ngas], rtol=1e-5)
    np.testing.assert_array_equal(sim.sph.metals.numpy()[gas][:, 0],
                                  np.float32(0.76))
    assert sim._gas_initialized and os.path.isdir(path)
