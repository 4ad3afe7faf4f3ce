"""The port's sharded driver with gas (Simulation.run_sharded: SPH, cooling
and star formation), end to end on gloo ranks on the CPU.

- Run cases (tests/_torch_sharded_worker.py: GAS_PARAMS, gas_run_cases,
  every mode in one spawn per rank count): the committed 8^3 gas IC
  ``torch_star/IC`` with lya's gas physics and tests/test_torch_star_run.py's
  star-forming thresholds, DensityIndependentSphOn 1 (the only formulation
  the JAX package's sharded density computes), FOF with gas and stars as
  secondaries (FOFHaloMinLength 4):

  - ``hier``: hierarchical to a = 0.11 with a snapshot and a PIG there;
  - ``global``: two global KDK steps;
  - ``cool``: one hierarchical PM step with cooling alone.

  At 2 and 4 ranks each is held to the committed record of the JAX
  package's run_sharded of the same run, ``torch_sharded/jax_gas_run.npz``:
  the final state by ID (the same IDs, so the same stars: the draws are
  per ID; positions within 16 fixed-point ticks, every float column within
  2e-5 by norm, the cooling's tolerance, tests/test_torch_star_run.py),
  sfr.txt, and every block of the snapshot; the PIG is held to the JAX
  package's distributed FOF of the same run's final rows
  (jax_pig_witness, in the same record).  The slow test
  ``test_jax_gas_run_record`` computes it anew and checks it
  (MPG_WRITE_SHARDED_FIXTURE=1 writes it):

      MPG_WRITE_SHARDED_FIXTURE=1 python -m pytest -m slow \\
          tests/test_torch_sharded_gas_run.py

- The striped gas snapshot of two ranks reads back through io/snapshot and
  resumes with RestartFlag 2, on one device and through the sharded
  driver.
- One rank (MPG_SHARDED=1's run) against the single-device run of lya's
  own formulation (DensityIndependentSphOn 0), from the same IC.
- The refusals that stay.
"""

import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_sharded_worker as W

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RECORD = REPO / "tests" / "torch_sharded" / "jax_gas_run.npz"
RANKS = (2, 4)
MODES = tuple(W.GAS_MODES)
TICKS = 16
TOL = 2e-5          # relative, by norm


def read_record(S):
    rec = np.load(RECORD)
    pre = f"S{S}/"
    return {k[len(pre):]: rec[k] for k in rec.files if k.startswith(pre)}


@pytest.fixture(scope="module", params=RANKS, ids=lambda s: f"{s}ranks")
def runs(request, tmp_path_factory):
    S = request.param
    out = tmp_path_factory.mktemp(f"gas{S}")
    t0 = time.perf_counter()
    W.spawn(W.gas_run_cases, S, str(out), list(MODES))
    print(f"{S} ranks: {time.perf_counter() - t0:.1f} s")
    return S, out, read_record(S)


def _ticks(a, b):
    d = (a.astype(np.int64) - b.astype(np.int64) + 2 ** 31) % 2 ** 32 \
        - 2 ** 31
    return int(np.abs(d).max()) if d.size else 0


def _rel(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den > 0 else \
        float(np.abs(a).max(initial=0.0))


def compare_columns(got, want, prefix):
    """Every column under prefix: IDs, types and group ids equal,
    positions within TICKS, floats within TOL by norm."""
    keys = sorted(k for k in want if k.startswith(prefix))
    assert keys and keys == sorted(k for k in got if k.startswith(prefix))
    bad = {}
    for k in keys:
        a, b = got[k], want[k]
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if k.endswith(("ipos", "Position")) and a.dtype.kind in "iu":
            if _ticks(a, b) > TICKS:
                bad[k] = _ticks(a, b)
        elif a.dtype.kind in "iub" or k.endswith(("/ID", "/pid")):
            if not np.array_equal(a, b):
                bad[k] = "differs"
        elif k.endswith("/Position"):
            # the output's float64 positions: within TICKS of the box
            d = np.abs(a - b)
            d = np.minimum(d, W.GAS_BOX - d).max(initial=0.0)
            if d > TICKS * W.GAS_BOX / 2.0 ** 32:
                bad[k] = d
        elif _rel(a, b) > TOL:
            bad[k] = _rel(a, b)
    assert not bad, bad


@pytest.mark.parametrize("mode", MODES)
def test_gas_run_matches_jax_record(runs, mode):
    """The final state by ID: the same IDs and types (the same stars),
    positions within 16 ticks, the rest within 2e-5 by norm; and the
    same sfr.txt lines."""
    S, out, rec = runs
    got = dict(np.load(out / f"gas_{mode}.npz"))
    want = {k[len(mode) + 1:]: v for k, v in rec.items()
            if k.startswith(mode + "/")}
    assert float(got["state/atime"]) == pytest.approx(
        float(want["state/atime"]), rel=1e-12)
    compare_columns(got, want, "state/")
    if mode != "cool":
        assert int((got["state/ptype"] == 4).sum()) > 0
    # sfr.txt: a line for each step that formed stellar mass
    # (sfr_eff.c:356), the JAX package's global loop writes one for every
    # step: its lines with total_sm > 0
    jax_lines = [ln.split() for ln in want["sfr_txt"].tolist()
                 if float(ln.split()[1]) > 0]
    lines = [ln.split() for ln in got["sfr_txt"].tolist()]
    assert len(lines) == len(jax_lines)
    if mode != "cool":
        assert lines
    for a, b in zip(lines, jax_lines):
        np.testing.assert_allclose(np.float64(a[:6]), np.float64(b[:6]),
                                   rtol=1e-4)
        assert a[6:] == b[6:]


def canonical_groups(d, kind="PIG0"):
    """The PIG's groups in the order of their smallest member ID: groups
    whose float32 masses tie to the last bit may swap places in the
    catalogue (its order is by mass), with the sums' order of the ranks."""
    types = [t for t in range(6) if f"{kind}/{t}/ID" in d]
    ids = np.concatenate([d[f"{kind}/{t}/ID"] for t in types])
    gid = np.concatenate([d[f"{kind}/{t}/GroupID"] for t in types])
    ng = len(d[f"{kind}/FOFGroups/GroupID"])
    first = np.full(ng, np.iinfo(np.uint64).max, np.uint64)
    np.minimum.at(first, gid.astype(np.int64) - 1, ids.astype(np.uint64))
    order = np.argsort(first, kind="stable")
    new = np.empty(ng, np.int64)
    new[order] = np.arange(1, ng + 1)
    out = dict(d)
    for k, v in d.items():
        if k.startswith(f"{kind}/FOFGroups/") and not k.endswith("GroupID"):
            out[k] = v[order]
        elif k.startswith(kind + "/") and k.endswith("/GroupID") \
                and "FOFGroups" not in k:
            out[k] = new[v.astype(np.int64) - 1].astype(v.dtype)
    return out


def jax_pig(rec):
    """The JAX side of the hierarchical run's PIG: the groups and members
    of jax_pig_witness (the JAX package's distributed FOF of its final
    rows), each member's other blocks from the JAX package's snapshot of
    those rows (PART0; the PIG writes the snapshot's blocks and GroupID)."""
    w = {k[len("hier/PIGwitness/"):]: v for k, v in rec.items()
         if k.startswith("hier/PIGwitness/")}
    want = {f"PIG0/{k}": v for k, v in w.items()
            if k.startswith("FOFGroups/")}
    for t in (0, 1, 4):
        part = {k[len(f"hier/PART0/{t}/"):]: v for k, v in rec.items()
                if k.startswith(f"hier/PART0/{t}/")}
        wt = {k[len(f"{t}/"):]: v for k, v in w.items()
              if k.startswith(f"{t}/")}
        # a star by ID and formation time: spawned stars' IDs repeat
        cols = ("ID", "StarFormationTime") if t == 4 else ("ID",)
        row = {k: i for i, k in enumerate(zip(*(part[c].tolist()
                                                for c in cols)))}
        sel = np.array([row[k] for k in zip(*(wt[c].tolist()
                                              for c in cols))], np.int64)
        for block, v in part.items():
            want[f"PIG0/{t}/{block}"] = v[sel]
        want[f"PIG0/{t}/GroupID"] = wt["GroupID"]
    return want


def by_member(d, kind="PIG0"):
    """A PIG's member blocks in the order of (ID, StarFormationTime)."""
    out = dict(d)
    for t in range(6):
        if f"{kind}/{t}/ID" not in d:
            continue
        keys = (d[f"{kind}/{t}/ID"],)
        if f"{kind}/{t}/StarFormationTime" in d:
            keys = (d[f"{kind}/{t}/StarFormationTime"],) + keys
        o = np.lexsort(keys)
        for k, v in d.items():
            if k.startswith(f"{kind}/{t}/"):
                out[k] = v[o]
    return out


@pytest.mark.parametrize("kind", ["PART0", "PIG0"])
def test_gas_snapshot_and_pig_blocks_match_jax(runs, kind):
    """Every block of the hierarchical run's striped snapshot and PIG, by
    ID (gas, dark matter, stars and the FOFGroups table, its groups by
    their smallest member): the same rows and groups, the floats within
    2e-5 by norm, the positions within 16 ticks; one stripe per rank.
    The snapshot is held to the JAX package's; the PIG to the JAX
    package's distributed FOF of its run's final rows, each shard holding
    its own slab's rows (jax_pig_witness): its run_sharded ghosts the rows
    of its FOF by the next step's slab boundaries instead, and at 4 shards
    splits a group there (80 groups in its PIG, 79 in the witness;
    ROADMAP.md section 3)."""
    from mpgadget_tpu_torch.io import BigFile
    S, out, rec = runs
    got = dict(np.load(out / "gas_hier.npz"))
    if kind == "PART0":
        want = {k[len("hier/"):]: v for k, v in rec.items()
                if k.startswith("hier/")}
    else:
        want = jax_pig(rec)
        got, want = (by_member(canonical_groups(d)) for d in (got, want))
    compare_columns(got, want, kind + "/")
    assert f"{kind}/4/StarFormationTime" in got
    assert f"{kind}/0/InternalEnergy" in got
    if kind == "PIG0":
        # gas and stars joined groups as secondaries
        lbt = got["PIG0/FOFGroups/LengthByType"]
        assert lbt[:, 0].sum() > 0 and lbt[:, 1].sum() > 0
    path = sorted((out / "hier").glob("PART_*" if kind == "PART0"
                                      else "PIG_*"))[0]
    assert BigFile(str(path)).open("0/ID").Nfile == S


def test_gas_run_substeps(runs):
    """The hierarchical run took substeps, and the sharded log has one
    entry per PM step."""
    S, out, rec = runs
    got = np.load(out / "gas_hier.npz")
    assert got["substeps"].sum() >= len(got["substeps"]) >= 1


# ---- read-back and resume ------------------------------------------------

@pytest.mark.parametrize("sharded", ["0", "1"])
def test_striped_gas_snapshot_resumes(runs, sharded, tmp_path, monkeypatch):
    """The striped snapshot of the hierarchical run, as written by the
    ranks, reads back through io/snapshot to the run's final state, and
    RestartFlag 2 resumes from it for one PM step, on one device
    (MPG_SHARDED=0) and through the sharded driver on one rank."""
    import shutil
    from mpgadget_tpu_torch.main import build_simulation, run_cli
    S, out, _ = runs
    got = dict(np.load(out / "gas_hier.npz"))
    work = tmp_path / "resume"
    shutil.copytree(out / "hier", work)
    pf = tmp_path / "paramfile.gadget"
    # the resumed run's output at its end: an output time at the
    # snapshot's own a, which the header holds as 0.11000000000000001,
    # would fall before the timeline's start (timeline.py drops it, and
    # the start with it)
    pf.write_text(W.gas_paramtext(work, "hier").replace(
        f"TimeMax = {W.GAS_TIME_MAX}", "TimeMax = 0.112").replace(
        f"OutputList = {W.GAS_TIME_MAX}", "OutputList = 0.112"))
    snap = work / "PART_000"
    sim, _ = build_simulation(str(pf), snapshot=str(snap), device="cpu")
    sim._restore_gas()
    pd = sim.pdata
    v = pd.valid.numpy()
    # by ID, then formation time: a gas row that spawned twice gave both
    # stars its ID + 2^40 (physics/sfr.spawn_stars, as the JAX package)
    o = np.lexsort((sim.stars.formation_time.numpy()[v], pd.pid.numpy()[v]))
    og = np.lexsort((got["state/formation_time"], got["state/pid"]))
    got = {k: v_[og] if k != "state/atime" and np.ndim(v_) else v_
           for k, v_ in got.items() if k.startswith("state/")}
    np.testing.assert_array_equal(pd.pid.numpy()[v][o], got["state/pid"])
    np.testing.assert_array_equal(pd.ptype.numpy()[v][o],
                                  got["state/ptype"])
    gas = got["state/ptype"] == 0
    for k, col in (("hsml", pd.hsml), ("density", sim.sph.density),
                   ("sfr", sim.sph.sfr)):
        np.testing.assert_array_equal(col.numpy()[v][o][gas],
                                      got[f"state/{k}"][gas])
    np.testing.assert_allclose(sim.sph.entropy.numpy()[v][o][gas],
                               got["state/entropy"][gas], rtol=1e-5)
    star = pd.ptype.numpy()[v][o] == 4
    np.testing.assert_array_equal(
        sim.stars.formation_time.numpy()[v][o][star],
        got["state/formation_time"][star])
    monkeypatch.setenv("MPG_SHARDED", sharded)
    res = run_cli(str(pf), 2, 0, device="cpu")
    assert res.atime == pytest.approx(0.112)
    pd = res.pdata
    assert int(pd.valid.sum()) >= len(got["state/pid"])
    assert torch.isfinite(pd.vel[pd.valid]).all()


# ---- one rank against the single device ----------------------------------

def test_one_rank_matches_single_device(tmp_path):
    """run_sharded on one rank against the single-device run of the same
    IC and switches, with lya's DensityIndependentSphOn 0 and cooling
    alone (two global steps): the same physics, in another order of
    summation, so positions within 16 ticks and the gas within 2e-5 by
    norm.  (With star formation the two loops key the draws of a step
    differently: the JAX package's sharded run on the step's first tick,
    its single-device run on its last; the port keeps both.)"""
    from mpgadget_tpu_torch.parallel.mesh import make_sim_mesh
    res = {}
    for name in ("sharded", "single"):
        sim = W.build_gas_run(str(tmp_path / name), "global",
                              DensityIndependentSphOn=0, StarformationOn=0,
                              RandomParticleOffset=0, SnapshotWithFOF=0)
        if name == "sharded":
            sim.run_sharded(make_sim_mesh("cpu"), verbose=False,
                            max_steps=2)
        else:
            sim.run(max_steps=2, verbose=False)
        res[name] = W.gas_final_state(sim)
    a, b = res["sharded"], res["single"]
    np.testing.assert_array_equal(a["pid"], b["pid"])
    assert a["atime"] == pytest.approx(b["atime"], rel=1e-12)
    assert _ticks(a["ipos"], b["ipos"]) <= TICKS
    for k in ("vel", "hsml", "entropy", "density", "ne"):
        assert _rel(a[k], b[k]) <= TOL, (k, _rel(a[k], b[k]))


# ---- refusals -------------------------------------------------------------

def test_metal_return_needs_star_formation_when_sharded(tmp_path):
    from mpgadget_tpu_torch.parallel.mesh import make_sim_mesh
    sim = W.build_gas_run(str(tmp_path), "cool", MetalReturnOn=1)
    with pytest.raises(ValueError, match="MetalReturnOn needs "
                                         "StarformationOn"):
        sim.run_sharded(make_sim_mesh("cpu"))
    assert sim.ti_current == 0


# ---- the JAX record ---------------------------------------------------------

def jax_pig_witness(sim, mesh):
    """The JAX package's distributed FOF (parallel/fof.sharded_fof) of a
    finished run's final rows, each shard holding the rows of its own slab
    of the count-balanced boundaries of those rows (run_sharded's rule):
    the FOFGroups table as its write_pig_sharded writes it, and each
    member's ID and GroupID (stars also their StarFormationTime, since
    their IDs repeat).  run_sharded's own PIG ghosts the rows by the next
    step's boundaries instead (ROADMAP.md section 3)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mpgadget_tpu.parallel.decomp import balanced_boundaries
    from mpgadget_tpu.parallel.fof import sharded_fof
    from mpgadget_tpu.physics.fof import FOFParams
    S = int(mesh.devices.size)
    pd = sim.pdata
    v = np.asarray(pd.valid)
    rows = {"ipos": pd.ipos, "vel": pd.vel, "mass": pd.mass,
            "ptype": pd.ptype, "pid": pd.pid, "sfr": sim.sph.sfr,
            "ft": sim.stars.formation_time}
    rows = {k: np.asarray(c)[v] for k, c in rows.items()}
    x = rows["ipos"][:, 0]
    bounds = balanced_boundaries(np.bincount(
        (x >> np.uint32(20)).astype(np.int64), minlength=1 << 12), S)
    shard = np.searchsorted(bounds, x, side="right") - 1
    o = np.argsort(shard, kind="stable")
    counts = np.bincount(shard, minlength=S)
    n_local = int(counts.max())
    slot = np.concatenate([r * n_local + np.arange(c)
                           for r, c in enumerate(counts)])
    lay = {}
    for k, c in rows.items():
        a = np.zeros((S * n_local,) + c.shape[1:], c.dtype)
        a[slot] = c[o]
        lay[k] = a
    lay["valid"] = np.zeros(S * n_local, bool)
    lay["valid"][slot] = True
    sh = NamedSharding(mesh, P("x"))
    st = {k: jax.device_put(lay[k], sh)
          for k in ("ipos", "vel", "mass", "ptype", "valid", "sfr")}
    cfg = sim.cfg
    npart = int(((lay["ptype"] == 1) & lay["valid"]).sum())
    cat, sorted_labels, _, labels = sharded_fof(
        mesh, st, bounds, boxsize=cfg.boxsize,
        mean_sep=cfg.boxsize / max(1.0, np.cbrt(npart)), n_local=n_local,
        params=FOFParams(linking_length=cfg.fof_linking_length,
                         min_group_length=cfg.fof_min_group_length,
                         primary_link_types=cfg.fof_primary_link_types,
                         secondary_link_types=cfg.fof_secondary_link_types))
    rank = {int(lab): i for i, lab in enumerate(sorted_labels)}
    gi = np.array([rank.get(int(lab), -1) for lab in np.asarray(labels)])
    off = sim._ipos_offset.astype(np.float64) / 2.0 ** 32 * cfg.boxsize
    ng = cat["ngroups"]
    out = {"FOFGroups/GroupID": np.arange(1, ng + 1, dtype="<u4"),
           "FOFGroups/Mass": cat["masses"].astype("<f4"),
           "FOFGroups/MassCenterPosition":
               np.mod(cat["cm"] - off, cfg.boxsize).astype("<f8"),
           "FOFGroups/MassCenterVelocity":
               (cat["vel"] / sim.atime).astype("<f4"),
           "FOFGroups/LengthByType": cat["len_by_type"].astype("<u4"),
           "FOFGroups/MassByType": cat["mass_by_type"].astype("<f4"),
           "FOFGroups/StarFormationRate": cat["sfr"].astype("<f4")}
    for t in (0, 1, 4):
        m = lay["valid"] & (gi >= 0) & (lay["ptype"] == t)
        k = np.argsort(lay["pid"][m], kind="stable")
        out[f"{t}/ID"] = lay["pid"][m][k]
        out[f"{t}/GroupID"] = (gi[m][k] + 1).astype("<u4")
        if t == 4:
            out["4/StarFormationTime"] = lay["ft"][m][k].astype("<f4")
    return out


def jax_gas_run(S, mode, outdir):
    """The JAX package's run_sharded of a gas run case at S shards (and,
    of the hierarchical run, jax_pig_witness of its final rows)."""
    import jax
    from jax.sharding import Mesh
    from mpgadget_tpu.main import build_simulation as jax_build
    from mpgadget_tpu.params import create_gadget_parameter_set as jps
    ps = jps()
    ps.parse_string(W.gas_paramtext(os.path.join(outdir, mode), mode))
    ps.validate()
    sim, _ = jax_build(ps)
    mesh = Mesh(np.array(jax.devices("cpu")[:S]), ("x",))
    sim.run_sharded(mesh, hierarchical=mode != "global", verbose=False,
                    max_steps=W.GAS_MODES[mode][1])
    out = W.gas_outputs(sim, os.path.join(outdir, mode))
    if mode == "hier":
        out.update({f"PIGwitness/{k}": v
                    for k, v in jax_pig_witness(sim, mesh).items()})
    return out


@pytest.mark.slow
def test_jax_gas_run_record(tmp_path):
    new = {}
    for S in RANKS:
        for mode in MODES:
            for k, v in jax_gas_run(S, mode, tmp_path / f"S{S}").items():
                new[f"S{S}/{mode}/{k}"] = np.asarray(v)
    if os.environ.get("MPG_WRITE_SHARDED_FIXTURE") == "1":
        RECORD.parent.mkdir(exist_ok=True)
        np.savez_compressed(RECORD, **new)
    rec = np.load(RECORD)
    assert sorted(rec.files) == sorted(new)
    for k, v in new.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(rec[k], v, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(rec[k], v, err_msg=k)
