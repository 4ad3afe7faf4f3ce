"""The PyTorch port's DM TreePM slice as a whole, against the JAX package.

A 16^3 IC from the JAX genic is read by both packages' build_simulation
from the same paramfile string (global KDK steps, no FOF); both run two
steps.  Also: switches the port does not carry raise, the port imports
no JAX, the copied host modules are byte-identical to their originals,
and chip_smoke.py refuses to run without a card or without the package.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpgadget_tpu.genic.main import run_genic
from mpgadget_tpu.main import build_simulation as jax_build
from mpgadget_tpu.params import (create_genic_parameter_set,
                                 create_gadget_parameter_set as jax_params)
from mpgadget_tpu_torch.main import build_simulation
from mpgadget_tpu_torch.params import create_gadget_parameter_set
from mpgadget_tpu_torch.run import Simulation, SimConfig, check_supported

REPO = Path(__file__).resolve().parents[1]

# one intra-op thread: the suite runs in several worker processes that
# share the machine's cores
torch.set_num_threads(1)

COPIED = ("utils/constants.py", "utils/unitsystem.py", "utils/paramset.py",
          "utils/walltime.py", "utils/hci.py", "utils/__init__.py",
          "params.py", "cosmology.py", "timefac.py", "timeline.py",
          "io/bigfile.py", "io/_native.py", "io/snapshot.py",
          "io/registry.py", "io/__init__.py", "genic/power.py",
          "genic/thermal.py", "physics/neutrinos_lra.py", "io/fits.py")

PARAMS = """
InitCondFile = {ic}
OutputDir = {out}
OutputList = 0.12
TimeMax = 0.12
TimeLimitCPU = 10000
Omega0 = 0.288
OmegaLambda = 0.712
OmegaBaryon = 0.0
HubbleParam = 0.7
HydroOn = 0
CoolingOn = 0
StarformationOn = 0
WindOn = 0
SnapshotWithFOF = 0
BlackHoleOn = 0
MetalReturnOn = 0
MassiveNuLinRespOn = 0
DensityIndependentSphOn = 0
SplitGravityTimestepsOn = 0
TreeGravOn = 1
Nmesh = 32
"""


@pytest.fixture(scope="module")
def ic_path(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_slice")
    k = np.logspace(-4, 3, 300)
    with open(tmp / "pk.txt", "w") as fh:
        for ki, pi in zip(k, 2e3 * k / (1 + (k / 0.01) ** 2) ** 1.5):
            fh.write(f"{ki} {pi}\n")
    gps = create_genic_parameter_set()
    gps.parse_string(f"""
FileWithInputSpectrum = {tmp}/pk.txt
OutputDir = {tmp}/ics
FileBase = IC
Omega0 = 0.288
OmegaBaryon = 0.0
OmegaLambda = 0.712
HubbleParam = 0.7
ProduceGas = 0
BoxSize = 64000
Redshift = 9
Ngrid = 16
Nmesh = 16
Seed = 181170
UnitaryAmplitude = 1
DifferentTransferFunctions = 0
InputPowerRedshift = 9
""")
    gps.validate()
    return run_genic(gps)


def _params(create, ic, out, **override):
    ps = create()
    ps.parse_string(PARAMS.format(ic=ic, out=out))
    for k, v in override.items():
        ps.set(k, v)
    ps.validate()
    return ps


def test_slice_matches_jax(ic_path, tmp_path):
    jsim, _ = jax_build(_params(jax_params, ic_path, tmp_path / "jax"))
    tsim, _ = build_simulation(
        _params(create_gadget_parameter_set, ic_path, tmp_path / "torch"),
        device="cpu")
    assert jsim.run(max_steps=2, verbose=False) == 2
    assert tsim.run(max_steps=2, verbose=False) == 2
    assert tsim.ti_current == jsim.ti_current
    # forces agree to ~1e-6, so two steps move positions by a few
    # fixed-point ticks at most (minimum image, 2^-32 box per tick)
    a = np.asarray(jsim.pdata.ipos).astype(np.int64)
    b = tsim.pdata.ipos.numpy()
    d = (b - a + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert np.abs(d).max() <= 16
    va, vb = np.asarray(jsim.pdata.vel), tsim.pdata.vel.numpy()
    assert np.linalg.norm(vb - va) <= 1e-4 * np.linalg.norm(va)
    pa, pb = jsim.last_power, tsim.last_power
    np.testing.assert_array_equal(pb.nmodes, pa.nmodes)
    np.testing.assert_allclose(pb.power, pa.power, rtol=1e-4)
    # both reached the sync point at a = 0.12 and wrote the same files
    for name in ("PART_000", "powerspectrum-0.1200.txt", "Snapshots.txt"):
        assert (tmp_path / "torch" / name).exists()
        assert (tmp_path / "jax" / name).exists()


def test_snapshot_written_by_port_reads_back(ic_path, tmp_path):
    from mpgadget_tpu_torch.io import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    tsim, _ = build_simulation(
        _params(create_gadget_parameter_set, ic_path, tmp_path), device="cpu")
    tsim.compute_forces()
    calls = tsim.tree_force_calls
    path = tsim.write_snapshot()
    assert tsim.tree_force_calls == calls + 1   # short-range potential
    bf = BigFile(path)
    hdr = snap_io.read_header(bf)
    sp = snap_io.read_species(bf, 1, hdr)
    assert len(sp["pid"]) == 16 ** 3 and int(hdr.TotNumPart[1]) == 16 ** 3
    np.testing.assert_allclose(sp["pos"], tsim._output_pos(), atol=1e-6)
    pot = bf.open("1/Potential").read()
    assert np.isfinite(pot).all() and np.abs(pot).max() > 0
    # a restart from the snapshot restores the particles
    sim2, _ = build_simulation(
        _params(create_gadget_parameter_set, ic_path, tmp_path / "re"),
        snapshot=path, device="cpu")
    np.testing.assert_array_equal(sim2.pdata.pid.numpy()[:16 ** 3],
                                  tsim.pdata.pid.numpy()[:16 ** 3])


def test_snapshot_potential_retries_an_overflowed_walk(ic_path, tmp_path,
                                                       monkeypatch):
    """write_snapshot takes the tree potential through the forces' grow
    and retry loop: a first walk that reports overflow (here with a
    zeroed, truncated potential) is retried at grown capacities, and the
    Potential written is that of a walk that did not overflow."""
    from mpgadget_tpu_torch.gravity.treepm import TreeGravity
    from mpgadget_tpu_torch.io import BigFile
    tsim, _ = build_simulation(
        _params(create_gadget_parameter_set, ic_path, tmp_path), device="cpu")
    tsim.compute_forces()
    clean = BigFile(tsim.write_snapshot()).open("1/Potential").read()
    real = TreeGravity.compute
    calls = []

    def overflow_once(self, pdata, return_potential=False, **kw):
        res = real(self, pdata, return_potential=return_potential, **kw)
        calls.append(return_potential)
        if len(calls) == 1:
            self.last_overflow = torch.tensor(True)
            self.last_overflow_parts = {"leaf_list": torch.tensor(True)}
            res = (res[0], torch.zeros_like(res[1]))
        return res

    monkeypatch.setattr(TreeGravity, "compute", overflow_once)
    ll = tsim._tree_grav.walk_cfg.leaf_list_max
    path = tsim.write_snapshot()
    assert calls == [True, True]
    assert tsim.tree_retries[-1] == ("leaf_list",)
    assert tsim._tree_grav.walk_cfg.leaf_list_max == 2 * ll
    pot = BigFile(path).open("1/Potential").read()
    np.testing.assert_allclose(pot, clean, rtol=1e-6,
                               atol=1e-6 * np.abs(clean).max())


def test_bad_timestep_error_survives_a_failed_emergency_snapshot(
        ic_path, tmp_path, monkeypatch):
    """A zero PM timestep writes the emergency snapshot and raises "Bad
    timestep"; a failing write must not hide that error (run.c:776-780,
    mpgadget_tpu/run.py:3085-3095).  No force is computed."""
    from mpgadget_tpu_torch.run import Simulation
    tsim, _ = build_simulation(
        _params(create_gadget_parameter_set, ic_path, tmp_path),
        device="cpu")

    def refuse(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(Simulation, "compute_forces", lambda *a, **k: None)
    monkeypatch.setattr(Simulation, "find_pm_timestep", lambda self: 0)
    monkeypatch.setattr(Simulation, "write_snapshot", refuse)
    with pytest.raises(RuntimeError, match="Bad timestep"):
        tsim.run(verbose=False)


# switches the port carries since the dark-matter options were ported, and
# BlackHoleOn since black holes were
CARRIED = ("MassiveNuLinRespOn", "LightconeOn", "PlaneOutputList",
           "OutputEnergyDebug", "HybridNeutrinosOn", "BlackHoleOn")
# gas switches the port carries since winds and metal return were ported,
# and the reionization switches and cooling tables since they were
GAS_CARRIED = ("WindOn", "MetalReturnOn", "ExcursionSetReionOn",
               "QSOLightupOn", "MetalCoolFile", "UVFluctuationFile")


@pytest.mark.parametrize("name,value", [
    ("MassiveNuLinRespOn", 1), ("BlackHoleOn", 1),
    ("LightconeOn", 1), ("PlaneOutputList", "0.11"),
    ("OutputEnergyDebug", 1), ("HybridNeutrinosOn", 1),
    ("WindOn", 1), ("MetalReturnOn", 1), ("ExcursionSetReionOn", 1),
    ("QSOLightupOn", 1), ("MetalCoolFile", "cooling_metal_UVB"),
    ("UVFluctuationFile", "uvfluc.txt")])
def test_unsupported_switch_raises(ic_path, tmp_path, name, value):
    """Every switch of the single-device JAX package is carried: the five
    dark-matter switches and BlackHoleOn build a Simulation on the CPU;
    the gas switches and the cooling tables (WindOn, MetalReturnOn, the
    excursion set, QSO lightup with its ReionHistFile, the metal cooling
    and UV fluctuation tables) pass check_supported with cooling gas (the
    slice's IC holds no gas).  QSOLightupOn without its ReionHistFile is
    refused, naming it."""
    ps = _params(create_gadget_parameter_set, ic_path, tmp_path,
                 **{name: value})
    if name in CARRIED:
        sim, _ = build_simulation(ps, device="cpu")
        assert isinstance(sim, Simulation)
        return
    cfg = SimConfig(boxsize=1.0, nmesh=8, output_dir="", timeline=None,
                    units=None, hydro_on=True, cooling_on=True)
    field = {"WindOn": "wind_on", "MetalReturnOn": "metal_return_on",
             "ExcursionSetReionOn": "excursion_set_on",
             "QSOLightupOn": "qso_lightup_on",
             "MetalCoolFile": "metal_cool_file",
             "UVFluctuationFile": "uv_fluctuation_file"}[name]
    cfg = SimConfig(**{**cfg.__dict__, field: value})
    assert name in GAS_CARRIED
    if name == "QSOLightupOn":
        with pytest.raises(ValueError, match="QSOLightupOn needs "
                           "ReionHistFile"):
            check_supported(cfg, has_gas=True)
        cfg = SimConfig(**{**cfg.__dict__, "reion_hist_file": "heii.txt"})
    check_supported(cfg, has_gas=True)


@pytest.mark.parametrize("name,field", [
    ("ExcursionSetReionOn", "excursion_set_on"),
    ("QSOLightupOn", "qso_lightup_on"),
    ("WindOn", "wind_on"), ("MetalReturnOn", "metal_return_on")])
def test_gas_switches_raise_only_with_gas(name, field):
    """The gas switches, all carried, pass with and without gas (QSOLightupOn
    with gas given its ReionHistFile: without it, it is refused with gas
    only)."""
    cfg = SimConfig(boxsize=1.0, nmesh=8, output_dir="", timeline=None,
                    units=None, hydro_on=False, split_gravity_timesteps=False)
    cfg = SimConfig(**{**cfg.__dict__, field: True})
    check_supported(cfg, has_gas=False)
    assert name in GAS_CARRIED
    if name == "QSOLightupOn":
        with pytest.raises(ValueError, match="ReionHistFile"):
            check_supported(cfg, has_gas=True)
        cfg = SimConfig(**{**cfg.__dict__, "reion_hist_file": "heii.txt"})
    check_supported(cfg, has_gas=True)


def test_restart_flag_99_raises(monkeypatch):
    """The CLI runs RestartFlag 99 (tests/test_torch_dmopts.py holds the
    self-test to the JAX package's), on a card only: without one it stops
    naming the CUDA device instead of falling back to the CPU."""
    from mpgadget_tpu_torch import main as tmain
    monkeypatch.setattr(sys, "argv", ["main", "param.txt", "99"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        tmain.main()


def test_port_imports_no_jax():
    """Every module of the port imports, and none of them brings in JAX or
    the JAX package, nor names either in its source."""
    import re
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "mpgadget_tpu_torch").rglob("*.py")
        if p.name != "__init__.py")
    assert "mpgadget_tpu_torch.parallel.sph" in mods
    code = ("import sys, importlib; "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'mpgadget_tpu.'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    use = re.compile(r"^\s*(import|from)\s+(jax\b|mpgadget_tpu\b(?!_torch))",
                     re.M)
    named = sorted(str(p.relative_to(REPO))
                   for p in (REPO / "mpgadget_tpu_torch").rglob("*.py")
                   if use.search(p.read_text()))
    assert not named, named


@pytest.mark.parametrize("rel", COPIED)
def test_copied_host_module_is_identical(rel):
    assert filecmp.cmp(REPO / "mpgadget_tpu" / rel,
                       REPO / "mpgadget_tpu_torch" / rel, shallow=False)


def _smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def _prints_result(stdout):
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except ValueError:
            continue
    return False


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_package(tmp_path, alone):
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        out = _smoke(tmp_path)
    else:
        out = _smoke(REPO)
    assert out.returncode != 0
    assert not _prints_result(out.stdout)
