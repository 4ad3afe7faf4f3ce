"""The port's run with winds, metal return and black holes, against the JAX
package.

One IC, committed as ``torch_subgrid/IC``: tests/test_torch_star_run.py's
recipe (the port's genic: Ngrid 8, 512 gas and 512 DM particles, BoxSize
5000 kpc/h, z = 9, the Eisenstein-Hu spectrum), with four gas rows
written as type-5 particles.  Two of those black holes sit 8 kpc/h apart
(within the 41.7 kpc/h of twice the softening) with the same velocity,
so that they merge.  The gas physics is lya's as in that file (cubic
kernel, CoolingOn, StarformationOn, no UV background, CritOverDensity 1,
CritPhysDensity 1e-4, Generations 64), with WindOn (WindModel ofjt10),
MetalReturnOn and BlackHoleOn; a seed mass of 1 (above a gas particle's
0.32) lets the black holes swallow gas from the first step, and
BlackHoleFeedbackFactor 1e-3 keeps the heated gas's timesteps long
enough for the hierarchical step.  Each package's _ensure_bh gives the
IC's black holes the seed mass.  Each run: two global KDK steps (where
ofjt10's dispersion is computed, so that the second step's new stars
kick their gas neighbours), then one hierarchical PM step.

The JAX package's run is committed as ``torch_subgrid/jax_run.npz``: on
one core it takes ~425 s (it compiles op by op), too long for the suite.
In the suite the port runs from the IC and is held to that record;
``test_jax_run_matches_its_record`` (slow) runs the JAX package from the
same IC and holds it to the record, and with MPG_WRITE_SUBGRID_FIXTURE=1
writes the IC and the record anew:

    MPG_WRITE_SUBGRID_FIXTURE=1 python -m pytest -m slow \\
        tests/test_torch_subgrid_run.py

Tolerances, as test_torch_star_run.py states them: positions within 16
(global) and 32 (hierarchical) ticks, spawned stars 1024; every float
field within 2e-5 relative by norm, the BH fields included; ptype, pid,
valid, the bins and the star, BH, wind-kicked (DelayTime > 0) and
swallowed masks identical; sfr.txt's and blackholes.txt's floats within
1e-4 and their counts equal; the BH-Details-R0 records within 1e-4.
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
from mpgadget_tpu.run import Simulation as JSimulation
from mpgadget_tpu_torch.genic.main import run_genic
from mpgadget_tpu_torch.io import snapshot as snap_io
from mpgadget_tpu_torch.io.bigfile import BigFile
from mpgadget_tpu_torch.io.registry import blocks_for_type
from mpgadget_tpu_torch.main import build_simulation
from mpgadget_tpu_torch.params import (create_gadget_parameter_set,
                                       create_genic_parameter_set)
from mpgadget_tpu_torch.physics.blackhole import BhData
from mpgadget_tpu_torch.run import Simulation

from test_torch_star_run import GENIC, NG

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "torch_subgrid"
IC = FIXTURE / "IC"
RECORD = FIXTURE / "jax_run.npz"
TOL = 2e-5
BH_ROWS = (17, 200, 333, 480)      # gas rows of the IC that become BHs
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
WindOn = 1
WindModel = ofjt10
MetalReturnOn = 1
BlackHoleOn = 1
SeedBlackHoleMass = 1.0
BlackHoleFeedbackFactor = 1e-3
WriteBlackHoleDetails = 1
PartAllocFactor = 2.0
MassiveNuLinRespOn = 0
SnapshotWithFOF = 0
SplitGravityTimestepsOn = 0
Nmesh = 16
"""
PDATA = ("vel", "mass", "hsml")
SPH = ("entropy", "density", "ne", "sfr", "metallicity", "metals",
       "hydro_accel", "dt_entropy", "delay_time")
STARS = ("formation_time", "birth_density", "metallicity", "metals",
         "total_mass_returned", "last_enrichment_myr", "vdisp")
BH = ("bh_mass", "mdot", "bh_density", "mtrack", "formation_time",
      "df_accel")


def _np(x):
    return x.cpu().numpy().copy() if isinstance(x, torch.Tensor) \
        else np.array(x)


def _state(sim):
    st = {k: _np(getattr(sim.pdata, k))
          for k in PDATA + ("ipos", "ptype", "pid", "valid", "timebin")}
    st["ipos"] = st["ipos"].astype(np.int64)
    st.update({k: _np(getattr(sim.sph, k)) for k in SPH})
    if sim.stars is not None:
        st.update({"star_" + k: _np(getattr(sim.stars, k)) for k in STARS})
    st.update({"bh_" + k: _np(getattr(sim.bh, k)) for k in BH})
    st["bh_count_progs"] = _np(sim.bh.count_progs)
    st["ti"] = sim.ti_current
    return st


def _bh_ic(ic, path):
    """The IC with the gas rows BH_ROWS written as type 5; the second BH is
    moved to 8 kpc/h of the first, with its velocity."""
    bf = BigFile(ic)
    hdr = snap_io.read_header(bf)
    gas = snap_io.read_species(bf, 0, hdr)
    dm = snap_io.read_species(bf, 1, hdr)
    rows = np.array(BH_ROWS)
    keep = np.setdiff1d(np.arange(len(gas["pid"])), rows)
    bh = {k: v[rows].copy() for k, v in gas.items()}
    bh["pos"][1] = np.mod(bh["pos"][0] + [8.0, 0.0, 0.0], hdr.BoxSize)
    bh["vel"][1] = bh["vel"][0]
    out = BigFile(path, create=True)
    fac = dict(atime=hdr.Time, use_peculiar=bool(hdr.UsePeculiarVelocity))
    for t, sp in ((0, {k: v[keep] for k, v in gas.items()}), (1, dm),
                  (5, bh)):
        snap_io.write_species(out, t, pos=sp["pos"], vel=sp["vel"],
                              pid=sp["pid"], mass=sp["mass"], **fac)
    tot = np.zeros(6, np.uint64)
    tot[:2] = [len(keep), len(dm["pid"])]
    tot[5] = len(rows)
    hdr.TotNumPart = tot
    snap_io.write_header(out, hdr)
    return path


def _params(create, ic, out, **override):
    ps = create()
    ps.parse_string(PARAMS.format(ic=ic, out=out))
    for k, v in override.items():
        ps.set(k, v)
    ps.validate()
    return ps


def _lines(path, binary=False):
    if binary:
        return np.fromfile(path, np.float64).reshape(-1, 12)
    with open(path) as fh:
        return [ln.split() for ln in fh]


def run_package(name, odir, snapshot=False):
    """Two global steps, then one hierarchical PM step, from the committed
    IC, by the JAX package or the port (CPU): the states after each, the
    text outputs, the BH records and the simulation."""
    build, create, kw = {
        "jax": (jax_build, jax_params, {}),
        "torch": (build_simulation, create_gadget_parameter_set,
                  {"device": "cpu"})}[name]
    sim, _ = build(_params(create, str(IC), odir), **kw)
    out = {}
    assert sim.run(max_steps=2, verbose=False) == 2
    out["global"] = _state(sim)
    if snapshot:
        out["snapshot"] = sim.write_snapshot()
    sim.cfg.split_gravity_timesteps = True
    assert sim.run(max_steps=1, verbose=False) == 1
    out["hier"] = _state(sim)
    out["sfr_txt"] = _lines(Path(odir) / "sfr.txt")
    out["bh_txt"] = _lines(Path(odir) / "blackholes.txt")
    out["details"] = _lines(
        Path(odir) / "BlackholeDetails" / "BH-Details-R0", binary=True)
    out["sim"] = sim
    return out


def write_record(run):
    """The JAX run's record: every state array by stage, the text lines,
    the BH records."""
    arrays = {f"{stage}/{k}": np.asarray(v)
              for stage in ("global", "hier") for k, v in run[stage].items()}
    for k in ("sfr_txt", "bh_txt"):
        arrays[k] = np.array([" ".join(ln) for ln in run[k]])
    arrays["details"] = run["details"]
    np.savez_compressed(RECORD, **arrays)


def read_record():
    with np.load(RECORD) as z:
        rec = {"global": {}, "hier": {}}
        for k in z.files:
            if "/" in k:
                stage, name = k.split("/", 1)
                v = z[k]
                rec[stage][name] = v.item() if name == "ti" else v
            elif k == "details":
                rec[k] = z[k]
            else:
                rec[k] = [ln.split() for ln in z[k].tolist()]
    return rec


def make_ic(tmp):
    """The committed IC: the port's genic at Ngrid 8, then the BH rows."""
    gps = create_genic_parameter_set()
    gps.parse_string(GENIC.format(out=tmp / "ics", ng=NG))
    gps.validate()
    if IC.exists():
        shutil.rmtree(IC)
    return _bh_ic(run_genic(gps, device="cpu"), str(IC))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_subgrid_run")
    return {"ic": str(IC), "tmp": tmp, "jax": read_record(),
            "torch": run_package("torch", tmp / "torch", snapshot=True)}


@pytest.mark.slow
def test_jax_run_matches_its_record(tmp_path):
    """The JAX package's run from the committed IC against its committed
    record: the same masks and bins, positions and every float field
    within 1e-6 by norm, the same text lines (~425 s on one core).  With
    MPG_WRITE_SUBGRID_FIXTURE=1 it writes the IC and the record anew."""
    write = bool(os.environ.get("MPG_WRITE_SUBGRID_FIXTURE"))
    if write:
        FIXTURE.mkdir(exist_ok=True)
        make_ic(tmp_path)
    run = run_package("jax", tmp_path / "jax")
    if write:
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
    assert rec["sfr_txt"] == run["sfr_txt"]
    assert rec["bh_txt"] == run["bh_txt"]
    np.testing.assert_allclose(run["details"], rec["details"], rtol=1e-6)


def _compare(a, b, ticks):
    assert a["ti"] == b["ti"]
    for k in ("ptype", "pid", "valid", "timebin", "bh_count_progs"):
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_array_equal(b["delay_time"] > 0, a["delay_time"] > 0,
                                  err_msg="wind-kicked rows")
    d = np.abs((b["ipos"] - a["ipos"] + 2 ** 31) % 2 ** 32 - 2 ** 31).max(1)
    spawned = a["valid"] & (a["pid"] >= 2 ** 40)
    assert d[a["valid"] & ~spawned].max() <= ticks
    assert not spawned.any() or d[spawned].max() <= 1024
    bad = {}
    for k in a:
        if k in ("ti", "ipos", "ptype", "pid", "valid", "timebin",
                 "bh_count_progs"):
            continue
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        x = np.where(np.isfinite(x), x, 0.0)
        y = np.where(np.isfinite(y), y, 0.0)
        rel = np.linalg.norm(y - x) / max(np.linalg.norm(x), 1e-300)
        if not rel < TOL:
            bad[k] = rel
    assert not bad, bad


@pytest.mark.parametrize("stage,ticks", [("global", 16), ("hier", 32)])
def test_subgrid_run_matches_jax(runs, stage, ticks):
    """Two global KDK steps, then one hierarchical PM step (black holes and
    metal return once per PM step): the same stars, BHs, swallowed and
    wind-kicked rows in the same places, and every float field, the BH
    fields included, to 2e-5 by norm."""
    _compare(runs["jax"][stage], runs["torch"][stage], ticks)


def test_subgrid_physics_happened(runs):
    """The run exercises what it claims: stars form and return mass, winds
    kick gas on the second global step, the black holes accrete, swallow
    gas and two of them merge, and the total mass (gas, stars and BHs,
    swallowed gas in the BHs) is kept to 1e-5."""
    tsim = runs["torch"]["sim"]
    h = runs["torch"]["hier"]
    assert tsim.wind_kicks > 0 and (h["delay_time"] > 0).any()
    stars = h["valid"] & (h["ptype"] == 4)
    assert stars.any() and (h["star_total_mass_returned"][stars] > 0).any()
    bh = h["valid"] & (h["ptype"] == 5)
    assert tsim.bh_mergers == 1 and bh.sum() == len(BH_ROWS) - 1
    assert tsim.bh_swallowed > 0 and (h["bh_mdot"][bh] > 0).all()
    assert h["bh_count_progs"][bh].sum() == 1
    ic = BigFile(runs["ic"])
    hdr = snap_io.read_header(ic)
    m0 = sum(snap_io.read_species(ic, t, hdr)["mass"].sum() for t in (0, 1, 5))
    m1 = h["mass"][h["valid"]].astype(np.float64).sum()
    assert abs(m1 / m0 - 1) < 1e-5


@pytest.mark.parametrize("which", ["sfr", "bh"])
def test_txt_outputs_match_jax(runs, which):
    """sfr.txt (8 columns) and blackholes.txt (a, BHs, total BH mass, total
    mdot, swallowed): the same lines, floats within 1e-4, counts equal."""
    key, nfl, counts = {"sfr": ("sfr_txt", (1, 6), (6, 8)),
                        "bh": ("bh_txt", (2, 4), (1, 2))}[which]
    a, b = runs["jax"][key], runs["torch"][key]
    assert len(a) == len(b) > 2
    for la, lb in zip(a, b):
        assert len(la) == len(lb)
        np.testing.assert_allclose(float(lb[0]), float(la[0]), rtol=1e-6)
        np.testing.assert_allclose([float(x) for x in lb[nfl[0]:nfl[1]]],
                                   [float(x) for x in la[nfl[0]:nfl[1]]],
                                   rtol=1e-4)
        assert la[counts[0]:counts[1]] == lb[counts[0]:counts[1]]
        if which == "bh":
            assert la[4:] == lb[4:]


def test_bh_details_match_jax(runs):
    """BlackholeDetails/BH-Details-R0: the same records (ID, a, BH mass,
    mdot, density, position, mass, Mtrack, progenitors, kinetic energy),
    within 1e-4."""
    a, b = runs["jax"]["details"], runs["torch"]["details"]
    assert a.shape == b.shape and len(a) > 4
    np.testing.assert_array_equal(b[:, 0], a[:, 0])
    scale = np.maximum(np.abs(a).max(0), 1e-300)
    assert (np.abs(b - a) <= 1e-4 * scale).all(), np.abs(b - a).max(0) / scale


def test_bh_snapshot_reads_back_in_both(runs):
    """The port's snapshot after the global steps holds the type-4 and
    type-5 blocks, and both packages' from_snapshot read it: every BH
    block equal to the port's state on the BH rows, in both."""
    st = runs["torch"]["global"]
    path = runs["torch"]["snapshot"]
    bf = BigFile(path)
    hdr = snap_io.read_header(bf)
    bh = st["valid"] & (st["ptype"] == 5)
    assert int(hdr.TotNumPart[5]) == bh.sum() > 0
    assert int(hdr.TotNumPart[4]) > 0
    kw = {"starformation_on": True, "black_hole_on": True,
          "part_alloc_factor": 2.0, "nmesh": 16,
          "output_dir": str(runs["tmp"] / "readback"),
          "timeline": runs["torch"]["sim"].timeline}
    tsim = Simulation.from_snapshot(path, kw, device="cpu")
    jsim = JSimulation.from_snapshot(path, dict(
        kw, timeline=runs["torch"]["sim"].timeline))
    for sim in (tsim, jsim):
        rows = np.asarray(_np(sim.pdata.valid)) \
            & (np.asarray(_np(sim.pdata.ptype)) == 5)
        np.testing.assert_array_equal(_np(sim.pdata.pid)[rows],
                                      st["pid"][bh])
        for spec in blocks_for_type(5):
            got = _np(getattr(sim.bh, spec.field))[rows]
            want = bf.open(f"5/{spec.name}").read()
            np.testing.assert_array_equal(
                got.astype(spec.dtype).reshape(want.shape), want,
                err_msg=spec.name)
    for spec in blocks_for_type(5):
        if "bh_" + spec.field in st:
            np.testing.assert_array_equal(
                bf.open(f"5/{spec.name}").read().reshape(
                    st["bh_" + spec.field][bh].shape),
                st["bh_" + spec.field][bh].astype(spec.dtype),
                err_msg=spec.name)
    assert tsim.pdata.capacity >= 2.0 * st["valid"].sum()


def test_fof_seeding_matches_jax(runs):
    """seed_black_holes_from_fof on one catalogue of the final state (the
    port's FOF at FOFHaloMinLength 8), every halo counted as stellar and
    the thresholds at 0: the same rows become BHs with the same state in
    both packages (the JAX package's seeding on its recorded state)."""
    from mpgadget_tpu.particles import ParticleData as JParticleData
    from mpgadget_tpu.physics import blackhole as jbh
    from mpgadget_tpu.sph.state import SphData as JSphData
    import jax.numpy as jnp
    tsim = runs["torch"]["sim"]
    a = runs["jax"]["hier"]
    tsim.cfg.fof_min_group_length = 8
    cat = tsim.run_fof(save=False)
    assert cat["ngroups"] > 0
    cat = dict(cat, mass_by_type=np.asarray(cat["mass_by_type"]).copy())
    cat["mass_by_type"][:, 4] = 1.0     # every halo counts as stellar
    tsim.cfg.min_fof_mass_for_seed = 0.0
    tsim.cfg.min_mstar_for_seed = 0.0
    n = len(a["ptype"])
    jpd = JParticleData.from_numpy(
        np.zeros((n, 3)), a["vel"], a["mass"], a["ptype"], a["pid"],
        1.0).replace(valid=jnp.asarray(a["valid"]),
                     ptype=jnp.asarray(a["ptype"]))
    jbhd = jbh.BhData.zeros(n).replace(**{
        k: jnp.asarray(a["bh_" + k]) for k in BH} | {
        "count_progs": jnp.asarray(a["bh_count_progs"])})
    jpd, jbhd, jn = jbh.seed_black_holes(
        jbh.BHParams(min_fof_mass_for_seed=0.0, min_mstar_for_seed=0.0,
                     seed_mass=tsim.cfg.bh_seed_mass), cat, jpd, jbhd,
        JSphData.zeros(n).replace(density=jnp.asarray(a["density"])),
        float(np.exp(tsim.timeline.loga_from_ti(a["ti"]))))
    tn = tsim.seed_black_holes_from_fof(cat)
    assert tn == jn > 0
    np.testing.assert_array_equal(_np(tsim.pdata.ptype),
                                  np.asarray(jpd.ptype))
    for f in fields(BhData):
        x = np.asarray(getattr(jbhd, f.name)).astype(np.float64)
        y = _np(getattr(tsim.bh, f.name)).astype(np.float64)
        assert np.linalg.norm(y - x) <= TOL * max(np.linalg.norm(x),
                                                  1e-300), f.name
