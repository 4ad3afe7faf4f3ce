"""The port's sharded driver with its subgrid physics (Simulation.run_sharded:
ofjt10 winds from the new stars' neighbours, black holes with swallowing,
mergers and FOF seeding, metal return), end to end through the CLI's body
(main.run_cli) on two gloo ranks on the CPU.

The run (tests/_torch_sharded_worker.py: STAR_PARAMS, star_run_cases): the
committed IC ``torch_subgrid/IC`` (8^3 gas, 8^3 dark matter and four BHs,
two of which merge in the first step) with lya's gas physics, the
star-forming thresholds lowered, WindOn (ofjt10), MetalReturnOn and
BlackHoleOn, to a = 0.12 (on global steps but in the hier modes), with
phase 24's seeding thresholds and a PIG at a = 0.115 and 0.12, so that
stars form, winds kick, the BHs swallow and merge, and the FOF seeds new
BHs that then step.

- ``nodecouple`` (MaxWindFreeTravelTime 0: no wind gas ever decouples;
  OutputPotential 0): held to the committed record of the JAX package's
  run_sharded of the same run on two shards,
  ``torch_sharded/jax_star_run.npz``.  This is the window that avoids the
  decoupling defect: the JAX package's sharded hydro gives decoupled gas
  its hydro force (its write-back has no DelayTime mask,
  mpgadget_tpu/parallel/driver.py:629-634), where the port's follows the
  single-device rule (ROADMAP.md section 3); and the JAX package
  repositions BHs whenever it carries the potential, so the potential is
  off.  The final state by ID (the same IDs, types, stars and BHs: the
  draws are per ID), the last snapshot's and PIG's blocks and sfr.txt,
  with the tolerances of TICKS and TOL below.  The slow test
  ``test_jax_star_run_record`` computes it anew and checks it
  (MPG_WRITE_SHARDED_FIXTURE=1 writes it).
- ``decouple`` (the paramfile's winds, decoupling on): held to the port's
  single-device global loop (Simulation.run) from the same paramfile, the
  reference the JAX package's sharded run departs from.  The two follow
  different step paths (the single-device loop runs the BHs before star
  formation, takes ofjt10's dispersion at the gas before the hydro force
  and from the second step only, and sizes its PM step otherwise), so they
  are held to each other by bulk measures with stated slack: the total
  mass against the IC's in both; the same BHs of the IC merging; BHs
  seeded by both at a = 0.115; stars, wind kicks and swallowed gas
  within the slack of tests' STAR_SLACK; every decoupled gas row of the
  sharded run without hydro force.
- ``hier`` (nodecouple on the hierarchical path, metal return off): the
  subgrid passes at PM cadence, the BH pass on the tree plus the PM
  acceleration, the winds keyed by the PM step's first tick; held to the
  JAX package's hierarchical run_sharded in the same record, with the same
  tolerances.  Metal return is off because the JAX package's hierarchical
  metal return ghosts the rows by the next step's boundaries (ROADMAP.md
  section 3).
- ``hiermetals`` (hier with metal return): held to the same run on one
  rank, where no row is ghosted.
"""

import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_sharded_worker as W
from test_torch_sharded_gas_run import _rel, _ticks

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RECORD = REPO / "tests" / "torch_sharded" / "jax_star_run.npz"
RECORDED = ("nodecouple", "hier")   # the modes the JAX record holds
S = 2
# Against the JAX record, measured on the nodecouple run at two ranks
# (CHANGES.md; the hier run: 207 ticks, floats at most 1.1e-5, the SFR):
# - positions within 1024 ticks (2.4e-7 of the box): the gas moves ~1e8
#   ticks a step, so velocities equal to 1e-6 (float32 sums in another
#   order, 9e-7 by norm here) leave up to 545 ticks after 11 steps;
# - every float column within 2e-5 by norm (the cooling's tolerance,
#   tests/test_torch_star_run.py), but the SFR within 2e-4: the star-forming
#   gas's cooling time comes from the network's fixed point, which the JAX
#   package runs compiled and the port op by op (tests/test_torch_cooling.py
#   compares against jax.disable_jit() runs for this reason); measured
#   5.9e-5 by norm on equal densities (5e-7) and equal ne.
TICKS = 1024
TOL = {"sfr": 2e-4, "StarFormationRate": 2e-4}
TOL_ALL = 2e-5
# the sharded decouple run against the single-device loop, relative to the
# single-device figure, about twice to three times what was measured on
# this run (two ranks: stars 131 against 164, wind kicks 606 against 453,
# swallowed gas 33 against 62)
STAR_SLACK = {"stars": 0.6, "wind_kicks": 1.0, "swallowed": 1.0}


def compare_columns(got, want, prefix):
    """Every column under prefix: IDs, types and group ids equal,
    positions within TICKS, floats within their TOL by norm."""
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
            d = np.abs(a - b)
            d = np.minimum(d, W.GAS_BOX - d).max(initial=0.0)
            if d > TICKS * W.GAS_BOX / 2.0 ** 32:
                bad[k] = d
        elif _rel(a, b) > TOL.get(k.split("/")[-1], TOL_ALL):
            bad[k] = _rel(a, b)
    print(prefix, {k: (_ticks(got[k], want[k]) if k.endswith("ipos") else
                       _rel(got[k], want[k])) for k in keys
                   if got[k].dtype.kind == "f" or k.endswith("ipos")})
    assert not bad, bad


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("star")
    t0 = time.perf_counter()
    # four runs in one spawn: ~200 s under the suite's load (CHANGES.md)
    W.spawn(W.star_run_cases, S, str(out), list(W.STAR_MODES),
            deadline=900)
    print(f"{S} ranks: {time.perf_counter() - t0:.1f} s")
    return out


def read_record(mode):
    rec = np.load(RECORD)
    return {k[len(mode) + 1:]: rec[k] for k in rec.files
            if k.startswith(mode + "/")}


def check_state_against_record(runs, mode):
    """A recorded run's final state by ID: the same IDs and types (the
    same stars, swallowed gas, merged and seeded BHs), positions within
    TICKS, the other columns within their TOL by norm; sfr.txt's lines.
    Returns the port's run."""
    got = dict(np.load(runs / f"star_{mode}.npz"))
    want = read_record(mode)
    assert float(got["state/atime"]) == pytest.approx(
        float(want["state/atime"]), rel=1e-12)
    compare_columns(got, want, "state/")
    jax_lines = [ln.split() for ln in want["sfr_txt"].tolist()
                 if float(ln.split()[1]) > 0]
    lines = [ln.split() for ln in got["sfr_txt"].tolist()]
    assert len(lines) == len(jax_lines) > 0
    for a, b in zip(lines, jax_lines):
        np.testing.assert_allclose(np.float64(a[:6]), np.float64(b[:6]),
                                   rtol=1e-4)
        assert a[6:] == b[6:]
    return got


def check_blocks_against_record(runs, mode, kind, blocks):
    """Every block of a recorded run's last snapshot and PIG by ID, the
    named star and BH blocks (and Metals) among them, as the JAX package's
    striped writer wrote them (groups by their smallest member)."""
    from test_torch_sharded_gas_run import canonical_groups
    got = dict(np.load(runs / f"star_{mode}.npz"))
    want = read_record(mode)
    if kind == "PIG":
        got, want = canonical_groups(got, "PIG"), canonical_groups(want,
                                                                   "PIG")
    compare_columns(got, want, kind + "/")
    for block in blocks:
        assert f"{kind}/{block}" in got, block


def test_star_run_matches_jax_record(runs):
    """The nodecouple run against the JAX package's (global steps): stars,
    wind kicks, swallowed gas, the IC's merger and the FOF's seeds."""
    got = check_state_against_record(runs, "nodecouple")
    pt = got["state/ptype"]
    assert (pt == 4).sum() > 0 and (pt == 5).sum() > 4
    assert int(got["wind_kicks"]) > 0 and int(got["swallowed"]) > 0
    assert int(got["mergers"]) == 1 and got["seeded"][0] > 0


@pytest.mark.parametrize("kind", ["PART", "PIG"])
def test_star_snapshot_and_pig_blocks_match_jax(runs, kind):
    check_blocks_against_record(runs, "nodecouple", kind, (
        "0/Metals", "4/Metals", "4/TotalMassReturned", "5/BlackholeMass",
        "5/BlackholeMtrack"))


def test_star_hier_run_matches_jax_record(runs):
    """The hier run against the JAX package's hierarchical run_sharded:
    the subgrid passes at PM cadence, the BH pass on the tree plus the PM
    acceleration, the IC's BHs swallowing and merging, stars, wind kicks
    keyed by the PM step's first tick and the FOF's seeds."""
    got = check_state_against_record(runs, "hier")
    pt = got["state/ptype"]
    assert (pt == 4).sum() > 0 and (pt == 5).sum() > 4
    assert int(got["wind_kicks"]) > 0 and int(got["swallowed"]) > 0
    assert int(got["mergers"]) == 1 and got["seeded"][0] > 0
    assert (got["substeps"] > 1).any()


@pytest.mark.parametrize("kind", ["PART", "PIG"])
def test_star_hier_snapshot_and_pig_blocks_match_jax(runs, kind):
    check_blocks_against_record(runs, "hier", kind, (
        "4/StarFormationTime", "5/BlackholeMass", "5/BlackholeMtrack"))


def test_star_hier_metal_return_matches_one_rank(runs, tmp_path,
                                                 monkeypatch):
    """The hiermetals run (hier with metal return at PM cadence) on two
    ranks against the same run on one rank, where run_sharded ghosts
    nothing: the final state by ID, positions within TICKS, the other
    columns within their TOL by norm (measured 22 ticks and at most 8.7e-7,
    the SFR).  The JAX package's hierarchical run_sharded is no reference
    here: its metal return ghosts the rows by the next step's boundaries
    (ROADMAP.md section 3), and its gas metallicity departs from the one
    rank's by 2.0% by norm in this run."""
    from mpgadget_tpu_torch.main import run_cli
    got = dict(np.load(runs / "star_hiermetals.npz"))
    out = tmp_path / "one"
    out.mkdir()
    pf = tmp_path / "one.gadget"
    pf.write_text(W.star_paramtext(str(out), "hiermetals"))
    monkeypatch.setenv("MPG_SHARDED", "1")
    sim = run_cli(str(pf), device="cpu")
    want = {f"state/{k}": v for k, v in W.star_final_state(sim).items()}
    compare_columns(got, want, "state/")
    gas = got["state/ptype"] == 0
    assert (got["state/metallicity"][gas] > 0).sum() > 0
    assert (got["substeps"] > 1).any() and int(got["mergers"]) == 1


def test_star_run_holds_to_single_device(runs, tmp_path):
    """The decouple run against the single-device global loop from the same
    paramfile: the mass kept, the same merger, BHs seeded at a = 0.115 by
    both, stars, wind kicks and swallowed gas within STAR_SLACK, and no
    hydro force on any decoupled gas row of the sharded run."""
    from mpgadget_tpu_torch.main import run_cli
    got = dict(np.load(runs / "star_decouple.npz"))
    out = tmp_path / "single"
    out.mkdir()
    pf = tmp_path / "single.gadget"
    pf.write_text(W.star_paramtext(str(out), "decouple"))
    os.environ["MPG_SHARDED"] = "0"
    try:
        sim = run_cli(str(pf), device="cpu")
    finally:
        del os.environ["MPG_SHARDED"]
    pd = sim.pdata
    pt = pd.ptype[pd.valid].numpy()
    m_ic = W.star_ic_mass()
    ref = dict(stars=int((pt == 4).sum()), wind_kicks=sim.wind_kicks,
               swallowed=sim.bh_swallowed)
    mine = dict(stars=int((got["state/ptype"] == 4).sum()),
                wind_kicks=int(got["wind_kicks"]),
                swallowed=int(got["swallowed"]))
    print(f"sharded {mine} single-device {ref}; seeded "
          f"{got['seeded'].tolist()} and {sim.bh_seeded}")
    for k, slack in STAR_SLACK.items():
        assert ref[k] > 0 and mine[k] > 0, k
        assert abs(mine[k] - ref[k]) <= slack * ref[k], (k, mine[k], ref[k])
    assert int(got["mergers"]) == sim.bh_mergers == 1
    assert got["seeded"][0] > 0 and sim.bh_seeded[0] > 0
    m1 = float(got["state/mass"].astype(np.float64).sum())
    m2 = float(pd.mass[pd.valid].double().sum())
    for m in (m1, m2):
        assert abs(m / m_ic - 1) < W.STAR_MASS_TOL, (m, m_ic)
    checks = got["decoupled_checks"]
    assert checks[:, 0].max() > 0 and not checks[:, 1].any(), checks


# ---- the JAX record ----------------------------------------------------------

def jax_star_run(outdir, mode):
    """The JAX package's run_sharded of a recorded mode on S shards."""
    import jax
    from jax.sharding import Mesh
    from mpgadget_tpu.main import build_simulation as jax_build
    from mpgadget_tpu.params import create_gadget_parameter_set as jps
    ps = jps()
    ps.parse_string(W.star_paramtext(str(outdir), mode))
    ps.validate()
    sim, _ = jax_build(ps)
    mesh = Mesh(np.array(jax.devices("cpu")[:S]), ("x",))
    sim.run_sharded(mesh, hierarchical=mode == "hier", verbose=False)
    return W.star_outputs(sim, outdir)


@pytest.mark.slow
def test_jax_star_run_record(tmp_path):
    new = {f"{mode}/{k}": np.asarray(v) for mode in RECORDED
           for k, v in jax_star_run(tmp_path / mode, mode).items()}
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
