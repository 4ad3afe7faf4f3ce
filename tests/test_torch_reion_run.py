"""The port's run with the cooling tables and reionization, against the JAX
package.

The committed IC ``torch_subgrid/IC`` (tests/test_torch_subgrid_run.py:
512 gas and 512 DM particles in 5000 kpc/h at z = 9, four gas rows
written as black holes) runs with that file's physics (cooling, star
formation, ofjt10 winds, metal return, black holes) and all four switches
of this slice on, each reading a stand-in that the test writes into its
temporary directory from a closed form (tests/test_torch_reion.py):

* MetalCoolFile: the Cloudy-layout metal table;
* TreeCoolFile: a TreeCool table nonzero to z = 14.8, so that the UV
  background that the z_reion grid gates is not zero;
* UVFluctuationFile: a z_reion grid at Nmesh 8 for the 5 Mpc/h box, 20 on
  half the box and ZRE_LATE on the other half, still dark at the run's
  end;
* ExcursionSetReionOn from z = 12 to ZSTOP, which the run crosses, so that
  the cooling reads each row's J21 rates first (zero before the first
  update, after the first PM step) and the gated TreeCool background
  after, with UVBGdim 16, ReionUseParticleSFR 0, 100 ionizing photons per
  baryon and escape fractions of 1, so that part of the box reionizes
  (a fifth of the gas), and FOF groups of 4 particles;
* QSOLightupOn with a HeII history from z = 12 to 6 (tests/test_parallel.py's)
  and QSOMinMass 0: a bubble of 1000 kpc/h around a halo at each PM step.

Each package runs two global KDK steps, then one hierarchical PM step.  The
JAX package's run is committed as ``torch_reion/jax_run.npz`` (it takes
minutes on one core, too long for the suite); the port runs in the suite
and is held to it.  ``test_jax_run_matches_its_record`` (slow) runs the
JAX package and holds it to the record; with MPG_WRITE_REION_FIXTURE=1 it
writes the record anew:

    MPG_WRITE_REION_FIXTURE=1 python -m pytest -m slow \\
        tests/test_torch_reion_run.py

Tolerances: tests/test_torch_subgrid_run.py's (positions 16 and 32 ticks,
float fields 2e-5 by norm, the masks identical), with the J21 and
zreion columns and the HeIII flags among them.  During the excursion
epoch the JAX package feeds the float32 network its float64 J21 rates
(numpy constants promote them), the port rounds them to float32 first:
a difference of an ulp in the rates, within these tolerances.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from mpgadget_tpu.main import build_simulation as jax_build
from mpgadget_tpu.params import create_gadget_parameter_set as jax_params
from mpgadget_tpu_torch.io import snapshot as snap_io
from mpgadget_tpu_torch.io.bigfile import BigFile
from mpgadget_tpu_torch.main import build_simulation
from mpgadget_tpu_torch.params import create_gadget_parameter_set
from mpgadget_tpu_torch.run import Simulation

from test_torch_reion import (write_heii_history, write_metal_table,
                              write_treecool, write_zreion_table)
from test_torch_subgrid_run import IC, PARAMS as SUBGRID, _compare, _lines

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "torch_reion"
RECORD = FIXTURE / "jax_run.npz"
ZRE_LATE = 7.0       # the late half of the z_reion grid
ZSTOP = 7.8          # the end of the excursion epoch
SWITCHES = """
MetalCoolFile = {tmp}/metalcool
TreeCoolFile = {tmp}/TREECOOL
UVFluctuationFile = {tmp}/zreion
ExcursionSetReionOn = 1
ExcursionSetZStart = 12
ExcursionSetZStop = {zstop}
UVBGdim = 16
ReionUseParticleSFR = 0
ReionNionPhotPerBary = 100
ReionRBubbleMax = 3000
EscapeFractionNorm = 1
EscapeFractionScaling = 0
QSOLightupOn = 1
ReionHistFile = {tmp}/heii.txt
QSOMinMass = 0
QSOMaxMass = 1e8
QSOMeanBubble = 1000
FOFHaloMinLength = 4
"""
HEII = ((12.0, 0.0, 0.0), (10.0, 0.02, 1e-33), (8.0, 0.6, 2e-33),
        (6.0, 0.999, 1e-33))
PDATA = ("vel", "mass", "hsml")
SPH = ("entropy", "density", "ne", "sfr", "metallicity", "hydro_accel",
       "dt_entropy", "delay_time", "local_j21", "zreion")


def write_inputs(tmp):
    """The stand-ins, into tmp."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    write_metal_table(tmp / "metalcool")
    write_treecool(tmp / "TREECOOL")
    write_zreion_table(tmp / "zreion", 5.0, late=ZRE_LATE)
    write_heii_history(tmp / "heii.txt", HEII)
    return tmp


def _params(create, tmp, out):
    ps = create()
    ps.parse_string(SUBGRID.format(ic=IC, out=out)
                    + SWITCHES.format(tmp=tmp, zstop=ZSTOP))
    ps.validate()
    return ps


def _np(x):
    return x.cpu().numpy().copy() if isinstance(x, torch.Tensor) \
        else np.array(x)


def _state(sim):
    st = {k: _np(getattr(sim.pdata, k))
          for k in PDATA + ("ipos", "ptype", "pid", "valid", "timebin")}
    st["ipos"] = st["ipos"].astype(np.int64)
    st.update({k: _np(getattr(sim.sph, k)) for k in SPH})
    st["he_iii_ionized"] = _np(sim.sph.he_iii_ionized).astype(np.int64)
    st["bh_count_progs"] = _np(sim.bh.count_progs)
    st["ti"] = sim.ti_current
    return st


def run_package(name, tmp, odir):
    """Two global steps, then one hierarchical PM step, by the JAX package
    or the port (CPU): the states after each, helium.txt and the
    simulation."""
    build, create, kw = {
        "jax": (jax_build, jax_params, {}),
        "torch": (build_simulation, create_gadget_parameter_set,
                  {"device": "cpu"})}[name]
    sim, _ = build(_params(create, tmp, odir), **kw)
    out = {}
    assert sim.run(max_steps=2, verbose=False) == 2
    out["global"] = _state(sim)
    if name == "torch":
        out["snapshot"] = sim.write_snapshot()
    sim.cfg.split_gravity_timesteps = True
    assert sim.run(max_steps=1, verbose=False) == 1
    out["hier"] = _state(sim)
    out["helium"] = _lines(Path(odir) / "helium.txt")
    out["sim"] = sim
    return out


def write_record(run):
    arrays = {f"{stage}/{k}": np.asarray(v)
              for stage in ("global", "hier") for k, v in run[stage].items()}
    arrays["helium"] = np.array([" ".join(ln) for ln in run["helium"]])
    np.savez_compressed(RECORD, **arrays)


def read_record():
    with np.load(RECORD) as z:
        rec = {"global": {}, "hier": {}}
        for k in z.files:
            if "/" in k:
                stage, name = k.split("/", 1)
                v = z[k]
                rec[stage][name] = v.item() if name == "ti" else v
            else:
                rec[k] = [ln.split() for ln in z[k].tolist()]
    return rec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_reion_run")
    inputs = write_inputs(tmp / "inputs")
    return {"tmp": tmp, "jax": read_record(),
            "torch": run_package("torch", inputs, tmp / "torch")}


@pytest.mark.slow
def test_jax_run_matches_its_record(tmp_path):
    """The JAX package's run against its committed record: every field
    within 1e-6 by norm, the same masks and helium.txt.  With
    MPG_WRITE_REION_FIXTURE=1 it writes the record anew."""
    run = run_package("jax", write_inputs(tmp_path / "inputs"),
                      tmp_path / "jax")
    if os.environ.get("MPG_WRITE_REION_FIXTURE"):
        FIXTURE.mkdir(exist_ok=True)
        write_record(run)
    rec = read_record()
    for stage in ("global", "hier"):
        a, b = rec[stage], run[stage]
        assert set(a) == set(b) and a["ti"] == b["ti"]
        for k in a:
            if k == "ti":
                continue
            x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
            assert x.shape == y.shape, k
            err = np.linalg.norm(y - x) / max(np.linalg.norm(x), 1e-300)
            assert err <= 1e-6, (stage, k, err)
    assert rec["helium"] == run["helium"]


@pytest.mark.parametrize("stage,ticks", [("global", 16), ("hier", 32)])
def test_reion_run_matches_jax(runs, stage, ticks):
    """Two global KDK steps, then one hierarchical PM step, with the metal
    table, the z_reion grid, the excursion set and QSO lightup: the same
    HeIII-ionized rows, the same rows with J21 > 0 and zreion set, and
    every float field to 2e-5 by norm."""
    a, b = runs["jax"][stage], runs["torch"][stage]
    for k in ("he_iii_ionized",):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_array_equal(b["local_j21"] > 0, a["local_j21"] > 0)
    np.testing.assert_array_equal(b["zreion"] >= 0, a["zreion"] >= 0)
    _compare({k: v for k, v in a.items() if k != "he_iii_ionized"},
             {k: v for k, v in b.items() if k != "he_iii_ionized"}, ticks)


def test_helium_txt_matches_jax(runs):
    """helium.txt: the same bubbles (a, centre, HeIII fraction, rows
    ionized) in the same order."""
    a, b = runs["jax"]["helium"], runs["torch"]["helium"]
    assert len(a) == len(b) >= 1
    for la, lb in zip(a, b):
        assert la[:4] == lb[:4] and la[5:] == lb[5:]
        np.testing.assert_allclose(float(lb[4]), float(la[4]), rtol=1e-5)


def test_reionization_happened(runs):
    """The run exercises what it claims: the excursion set gives part of
    the gas J21 > 0 and a zreion, and its epoch ends inside the run; HeIII
    bubbles ionize gas; after the epoch the z_reion grid gates the UV
    background, the late half of the box still dark; gas carries metals
    for the metal table; the mass is kept."""
    tsim = runs["torch"]["sim"]
    g, h = runs["torch"]["global"], runs["torch"]["hier"]
    gas = h["valid"] & (h["ptype"] == 0)
    assert 0 < (h["local_j21"][gas] > 0).sum() < gas.sum()
    assert (h["zreion"][gas] > 0).any()
    assert tsim.uvbg_updates and tsim.uvbg_updates[0][0] >= ZSTOP
    z_end = 1 / np.exp(tsim.timeline.loga_from_ti(h["ti"])) - 1
    assert ZRE_LATE < z_end < ZSTOP < 9.0
    zre = _np(tsim._uvf.zreion(tsim.pdata.ipos))[gas]
    assert np.isclose(zre, ZRE_LATE, rtol=0, atol=1e-4).any()
    assert np.isclose(zre, 20.0, rtol=0, atol=1e-4).any()
    assert (h["he_iii_ionized"][gas] > 0).any()
    assert sum(n for _, n in tsim.qso_bubbles) > 0
    assert (h["metallicity"][gas] > 0).any()
    assert (g["he_iii_ionized"] <= h["he_iii_ionized"]).all()
    ic = BigFile(str(IC))
    hdr = snap_io.read_header(ic)
    m0 = sum(snap_io.read_species(ic, t, hdr)["mass"].sum() for t in (0, 1, 5))
    assert abs(h["mass"][h["valid"]].astype(np.float64).sum() / m0 - 1) \
        < 1e-5


def test_reion_blocks_read_back(runs):
    """The port's snapshot after the global steps holds J21, ZReionized and
    HeIIIIonized, and from_snapshot restores them on the gas rows."""
    st = runs["torch"]["global"]
    path = runs["torch"]["snapshot"]
    bf = BigFile(path)
    gas = st["valid"] & (st["ptype"] == 0)
    sim = Simulation.from_snapshot(path, {
        "starformation_on": True, "black_hole_on": True,
        "part_alloc_factor": 2.0, "nmesh": 16,
        "output_dir": str(runs["tmp"] / "readback"),
        "timeline": runs["torch"]["sim"].timeline}, device="cpu")
    sim._restore_gas()
    rows = _np(sim.gas_mask)
    for name, field in (("J21", "local_j21"), ("ZReionized", "zreion"),
                        ("HeIIIIonized", "he_iii_ionized")):
        want = bf.open(f"0/{name}").read()
        np.testing.assert_array_equal(
            want, st[field][gas].astype(want.dtype), err_msg=name)
        np.testing.assert_array_equal(
            _np(getattr(sim.sph, field))[rows].astype(want.dtype), want,
            err_msg=name)
    assert (bf.open("0/J21").read() > 0).any()
