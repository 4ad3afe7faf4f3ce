"""The port's sharded driver with the options of the single-device loop
(Simulation.run_sharded): the light cone, QSO lightup with the excursion
set and the lensing planes, hybrid and massive neutrinos, on two gloo
ranks on the CPU.

The runs (tests/_torch_sharded_worker.py: option_run_cases), one spawn:

- ``lc``: the JAX package's tests/test_parallel.py light cone case (10^3
  DM in a 1 Gpc/h box from a = 0.45 to 0.48, global steps), held to the
  committed record of the JAX package's run_sharded on two shards: the
  same crossing rows, matched by position.
- ``aux``: its test_run_sharded_aux_physics case (one massive halo on a
  slab boundary, QSO lightup, the excursion set, planes at a = 0.1, one
  step), held to the JAX package's run_sharded: the same HeIII IDs and
  helium.txt, the reionized IDs but for nearly empty cells, J21 by ID;
  the planes byte for byte equal to the port's host path on the run's
  final rows and within PLANE_RTOL of the JAX package's; the snapshot's
  HeIIIIonized, J21 and ZReionized blocks are the final state's.
- ``hyb_global`` and ``hyb_hier``: 8^3 DM and 8^3 type-2 tracers with
  HybridNeutrinosOn and NuPartTime 0.105 from a = 0.1 to 0.11, global and
  hierarchical, held to the JAX package's run_sharded: the final state by
  ID; the hierarchical run's type-2 rows feel no PM force before
  NuPartTime on every rank, and feel it after.
- ``nu``: the parity IC (24^3, Nmesh 48) with MassiveNuLinRespOn and
  RandomParticleOffset 0, hierarchical, to a = 0.115.  The JAX package's
  run_sharded drops massive neutrinos and the per-step P(k) (ROADMAP.md
  section 3), so this run is held to its single-device loop: each PM
  step's powerspectrum file and the delta_tot history, and the sharded
  snapshot's Neutrino block.

The JAX side is ``torch_sharded/jax_options_run.npz``, which the slow test
``test_jax_options_run_record`` computes anew and checks (with
MPG_WRITE_SHARDED_FIXTURE=1 it writes it anew).
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
RECORD = REPO / "tests" / "torch_sharded" / "jax_options_run.npz"
S = 2
# Each tolerance is about three times what was measured on these runs at
# two ranks (CHANGES.md):
# - light cone rows against the JAX package's, matched by position: the
#   same float32 crossing test; the rows lie up to a few boxes out, where
#   a float32 ulp is 2.5e-7 of the box (measured 5.0e-7 of the box);
LC_POS_TOL = 2e-6 * W.LC_BOX
# - the aux run's reionized IDs (534): J21 of nearly empty cells, whose
#   ionization float32 noise decides, may differ (measured 26 IDs; the
#   JAX package's own test allows 1/50 of the set between its sharded and
#   single-device runs); J21 by ID by norm (measured 1.1e-6);
AUX_ZRE_SLACK = 80
J21_RTOL = 5e-6
# - the planes against the JAX package's, max |diff| / max |ref| (measured
#   1.5e-7);
PLANE_RTOL = 5e-7
# - the hybrid runs' final positions in ticks of 2^-32 of the box
#   (measured 3) and velocities by norm (measured 4.8e-10; float32 sums
#   in another order, 20x);
HYB_TICKS = 16
HYB_VEL_RTOL = 1e-8
# - the neutrino run's P(k) at each PM step (measured 6.1e-10 and 1.2e-6)
#   and its delta_tot history (measured 1.6e-7), by norm, against the JAX
#   package's single-device loop.
NU_PK_RTOL = 5e-6
NU_DELTA_RTOL = 5e-7


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("options")
    t0 = time.perf_counter()
    # five runs in one spawn: ~125 s under the suite's load (CHANGES.md)
    W.spawn(W.option_run_cases, S, str(out), list(W.OPTION_RUNS),
            deadline=600)
    print(f"{S} ranks: {time.perf_counter() - t0:.1f} s")
    return out


def read_record(case):
    rec = np.load(RECORD)
    return {k[len(case) + 1:]: rec[k] for k in rec.files
            if k.startswith(case + "/")}


def rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-300))


def test_lightcone_rows_match_jax_run_sharded(runs):
    got = np.load(runs / "run_lc.npz")["rows"]
    want = read_record("lc")["rows"]
    assert len(want) > 50 and len(got) == len(want)
    o, p = np.lexsort(got[:, :3].T), np.lexsort(want[:, :3].T)
    assert np.abs(got[o, :3] - want[p, :3]).max() < LC_POS_TOL
    np.testing.assert_array_equal(got[o, 3], want[p, 3])
    # one stripe per rank, each rank's own crossers
    stripes = sorted((runs / "lc" / "lightcone" / "000").glob("*.raw"))
    assert [f.name for f in stripes] == [f"lightcone-{r:05d}.raw"
                                         for r in range(S)]
    assert all(f.stat().st_size > 0 for f in stripes)


def test_aux_run_matches_jax_run_sharded(runs):
    got = dict(np.load(runs / "run_aux.npz"))
    want = read_record("aux")
    np.testing.assert_array_equal(got["pid"], want["pid"])
    gas = got["gas"]
    ion = set(got["pid"][got["ionized"]])
    assert ion == set(want["pid"][want["ionized"]]) and len(ion) >= 48
    assert got["helium"].tolist() == want["helium"].tolist()
    re_p = set(got["pid"][gas & (got["zreion"] > 0)])
    re_j = set(want["pid"][gas & (want["zreion"] > 0)])
    assert len(re_p) > 100 and len(re_p ^ re_j) <= AUX_ZRE_SLACK
    assert (got["zreion"][gas & (got["j21"] > 0)] > 0).all()
    assert (got["zreion"][gas] < 0).any()
    assert rel(got["j21"], want["j21"]) < J21_RTOL


def test_aux_planes_match_host_path_and_jax(runs):
    """The sharded planes equal byte for byte the port's host path on the
    run's final rows (the host mirror, from which rank 0 wrote them
    again), and the JAX package's within PLANE_RTOL."""
    from mpgadget_tpu_torch.io.fits import read_fits_image
    files = sorted((runs / "aux").glob("snap0_*.fits"))
    assert len(files) == 3
    want = read_record("aux")
    for f in files:
        host = runs / "aux" / "host" / f.name
        assert host.read_bytes() == f.read_bytes(), f.name
        data = read_fits_image(str(f))[0]
        ref = want[f"plane_{f.stem}"]
        assert np.abs(data - ref).max() / np.abs(ref).max() < PLANE_RTOL


def test_aux_snapshot_blocks_read_back(runs):
    from mpgadget_tpu_torch.io import BigFile
    got = dict(np.load(runs / "run_aux.npz"))
    bf = BigFile(str(runs / "aux" / "PART_000"))
    pid = bf.open("0/ID").read()
    o = np.argsort(pid)
    g = np.searchsorted(got["pid"], pid[o])
    np.testing.assert_array_equal(bf.open("0/HeIIIIonized").read()[o] > 0,
                                  got["ionized"][g])
    np.testing.assert_array_equal(bf.open("0/J21").read()[o], got["j21"][g])
    np.testing.assert_array_equal(bf.open("0/ZReionized").read()[o],
                                  got["zreion"][g])
    assert bf.open("0/J21").Nfile == S


@pytest.mark.parametrize("mode", ["global", "hier"])
def test_hybrid_run_matches_jax_run_sharded(runs, mode):
    got = dict(np.load(runs / f"run_hyb_{mode}.npz"))
    want = read_record(f"hyb_{mode}")
    np.testing.assert_array_equal(got["pid"], want["pid"])
    np.testing.assert_array_equal(got["ptype"], want["ptype"])
    assert float(got["atime"]) == pytest.approx(float(want["atime"]),
                                                rel=1e-12)
    d = np.abs(got["ipos"] - want["ipos"])
    assert np.minimum(d, 2 ** 32 - d).max() <= HYB_TICKS
    assert rel(got["vel"], want["vel"]) < HYB_VEL_RTOL


def test_hybrid_tracers_feel_no_pm_before_nu_part_time(runs):
    """Every rank's PM refreshes of the hierarchical run: the type-2 rows'
    PM acceleration is zero while they are passive tracers (a <=
    NuPartTime) and not after."""
    for r in range(S):
        seen = np.load(runs / f"tracer_pm_hyb_hier_r{r}.npy")
        before = seen[:, 0] <= W.HYB_PART_TIME
        np.testing.assert_array_equal(seen[:, 1] > 0, before)
        assert before.any() and (~before).any()
        assert (seen[before, 2] == 0).all() and (seen[~before, 2] > 0).all()


def test_neutrino_run_matches_single_device_jax(runs):
    """Each PM step's total-matter P(k) and the delta_tot history against
    the JAX package's single-device loop from the same paramfile."""
    got = dict(np.load(runs / "run_nu.npz"))
    want = read_record("nu")
    steps = sorted(k[:-2] for k in want if k.endswith("_a"))
    assert len(steps) >= 2 and sorted(
        k[:-2] for k in got if k.endswith("_a")) == steps
    for s in steps:
        assert float(got[f"{s}_a"]) == float(want[f"{s}_a"])
        # the files print 6 significant digits
        np.testing.assert_allclose(got[f"{s}_k"], want[f"{s}_k"],
                                   rtol=1e-5)
        print(s, "P(k)", rel(got[f"{s}_p"], want[f"{s}_p"]))
        assert rel(got[f"{s}_p"], want[f"{s}_p"]) < NU_PK_RTOL, s
    np.testing.assert_allclose(got["scalefact"], want["scalefact"],
                               rtol=1e-12)
    assert got["delta_tot"].shape == want["delta_tot"].shape
    print("delta_tot", rel(got["delta_tot"], want["delta_tot"]))
    assert rel(got["delta_tot"], want["delta_tot"]) < NU_DELTA_RTOL


def test_neutrino_snapshot_carries_delta_tot(runs):
    """The sharded snapshot's Neutrino block is the run's history, and a
    run resumed from it (RestartFlag 2's build_simulation) takes it up:
    its first forces extend that history."""
    from mpgadget_tpu_torch.io import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.main import build_simulation
    from mpgadget_tpu_torch.params import create_gadget_parameter_set
    got = dict(np.load(runs / "run_nu.npz"))
    snap = runs / "nu" / "PART_000"
    st = snap_io.read_neutrino_state(BigFile(str(snap)))
    np.testing.assert_allclose(st["scalefact"], got["scalefact"],
                               rtol=1e-12)
    np.testing.assert_allclose(st["delta_tot"], got["delta_tot"],
                               rtol=1e-12)
    ps = create_gadget_parameter_set()
    ps.parse_string(W.nu_paramtext(str(runs / "nu_resumed")))
    sim, _ = build_simulation(ps, snapshot=str(snap), device="cpu")
    sim.compute_forces()
    table = sim._nu_table_state.state_dict()
    n = len(got["scalefact"])
    np.testing.assert_array_equal(table["scalefact"][:n],
                                  got["scalefact"])
    np.testing.assert_array_equal(table["delta_tot"][:n - 1],
                                  got["delta_tot"][:n - 1])


# ---- the JAX record ------------------------------------------------------

def jax_option_run(case, outdir):
    """The JAX package's run of one option case: run_sharded on S shards,
    or for ``nu`` its single-device loop."""
    import jax
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices("cpu")[:S]), ("x",))
    pkg = "mpgadget_tpu"
    if case == "lc":
        sim = W.lightcone_sim(pkg, outdir)
        sim.run_sharded(mesh, verbose=False)
        return {"rows": W.lightcone_rows(outdir)}
    if case == "aux":
        outdir.mkdir(parents=True)
        W.write_heii_hist(outdir / "heii.txt")
        sim = W.aux_sim(pkg, outdir, outdir / "heii.txt")
        sim.run_sharded(mesh, max_steps=1, verbose=False)
        return W.aux_outputs(sim, outdir)
    if case.startswith("hyb"):
        hier = case == "hyb_hier"
        sim = W.hybrid_sim(pkg, outdir, hier)
        sim.run_sharded(mesh, hierarchical=hier, verbose=False)
        return W.hybrid_state(sim)
    from mpgadget_tpu.main import build_simulation as jax_build
    from mpgadget_tpu.params import create_gadget_parameter_set as jps
    ps = jps()
    ps.parse_string(W.nu_paramtext(str(outdir)))
    sim, _ = jax_build(ps)
    sim.run(verbose=False)
    return W.nu_outputs(sim, outdir)


@pytest.mark.slow
def test_jax_options_run_record(tmp_path):
    new = {f"{case}/{k}": np.asarray(v) for case in W.OPTION_RUNS
           for k, v in jax_option_run(case, tmp_path / case).items()}
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
