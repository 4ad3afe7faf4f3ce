"""The port's sharded driver (Simulation.run_sharded) end to end, on gloo
ranks on the CPU.

- Run cases: dm-small's paramfile.gadget on the committed 24^3 parity IC
  (``torch_parity/IC``, Nmesh 48) for one PM step to a = 0.105, with a
  snapshot and a PIG there, global and hierarchical, at 2 and 4 ranks
  (tests/_torch_sharded_worker.py: run_cases, both modes in one spawn per
  rank count).  Each is held to the committed record of the JAX package's
  run_sharded of the same run, ``torch_sharded/jax_run.npz`` (per-ID
  positions and velocities, every snapshot's P(k) measured from its rows,
  its IDs, the PIG counts), which the slow test ``test_jax_run_record``
  computes anew and checks (MPG_WRITE_SHARDED_FIXTURE=1 writes it):

      MPG_WRITE_SHARDED_FIXTURE=1 python -m pytest -m slow \\
          tests/test_torch_sharded_run.py

  The sharded run writes no per-step power spectrum (neither does the
  JAX package's), so P(k) is measured from the snapshots.
- The CLI under ``torch.distributed.run --nproc_per_node 2`` on the CPU,
  with a stop file: the striped checkpoint reads back to the IC's rows.
- A rank that calls endrun ends the job; every switch the sharded driver
  does not carry is refused before the first step; NCCL with more ranks
  than cards is refused (card only).
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_sharded_worker as W

REPO = Path(__file__).resolve().parents[1]
IC = REPO / "tests" / "torch_parity" / "IC"
RECORD = REPO / "tests" / "torch_sharded" / "jax_run.npz"
RANKS = (2, 4)
MODES = ("global", "hier")
PK_RTOL = 5e-5          # tests/test_torch_parity.py, chip_smoke.py


def snapshot_rows(path):
    """(ids, float64 positions, float32 velocities, masses) of a
    snapshot, sorted by ID."""
    from mpgadget_tpu_torch.io import BigFile
    bf = BigFile(str(path))
    ids = bf.open("1/ID").read()
    o = np.argsort(ids, kind="stable")
    return (ids[o], bf.open("1/Position").read()[o],
            bf.open("1/Velocity").read()[o], bf.open("1/Mass").read()[o])


def snapshot_power(path, nmesh=48):
    """P(k) of a snapshot's rows (the port's measure_power): (k, P, N)."""
    from mpgadget_tpu_torch.io import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.particles import pos_to_fixed
    from mpgadget_tpu_torch.pm.gravity import PMConfig, measure_power
    hdr = snap_io.read_header(BigFile(str(path)))
    _, pos, _, mass = snapshot_rows(path)
    ipos = torch.as_tensor(pos_to_fixed(pos, hdr.BoxSize).astype(np.int64))
    ps = measure_power(ipos, torch.as_tensor(mass), PMConfig(
        nmesh=nmesh, boxsize=hdr.BoxSize,
        unitlength_in_cm=hdr.UnitLength_in_cm))
    return np.stack([ps.k, ps.power, ps.nmodes], axis=1)


def pig_counts(path):
    from mpgadget_tpu_torch.io import BigFile
    hdr = BigFile(str(path)).open("Header").attrs
    return np.concatenate([np.asarray(hdr["NumFOFGroupsTotal"], np.int64),
                           np.asarray(hdr["NumPartInGroupTotal"],
                                      np.int64)])


def run_outputs(outdir):
    """What the record keeps of one run's directory."""
    out = {}
    snaps = sorted(Path(outdir).glob("PART_*"))
    out["n_snapshots"] = np.int64(len(snaps))
    for i, p in enumerate(snaps):
        ids = snapshot_rows(p)[0]
        out[f"snap{i}_ids_ok"] = np.bool_(
            np.array_equal(ids, np.arange(1, len(ids) + 1))
            or np.array_equal(np.sort(ids), np.unique(ids)))
        out[f"snap{i}_nids"] = np.int64(len(ids))
        out[f"snap{i}_pk"] = snapshot_power(p)
    pigs = sorted(Path(outdir).glob("PIG_*"))
    out["n_pigs"] = np.int64(len(pigs))
    for i, p in enumerate(pigs):
        out[f"pig{i}_counts"] = pig_counts(p)
    return out


@pytest.fixture(scope="module")
def first_forces(tmp_path_factory):
    """The first forces of the run case, computed once for every rank."""
    path = tmp_path_factory.mktemp("first") / "forces.pt"
    W.first_forces(str(path))
    return str(path)


@pytest.fixture(scope="module", params=RANKS, ids=lambda s: f"{s}ranks")
def runs(request, tmp_path_factory, first_forces):
    S = request.param
    out = tmp_path_factory.mktemp(f"run{S}")
    t0 = time.perf_counter()
    W.spawn(W.run_cases, S, str(out), first_forces)
    print(f"{S} ranks: {time.perf_counter() - t0:.1f} s")
    rec = np.load(RECORD)
    return S, out, rec


@pytest.mark.parametrize("mode", MODES)
def test_run_sharded_matches_jax_record(runs, mode):
    S, out, rec = runs
    key = f"S{S}_{mode}_"
    got = np.load(out / f"run_{mode}.npz")
    v = got["valid"]
    o = np.argsort(got["pid"][v])
    pid, ipos, vel = got["pid"][v][o], got["ipos"][v][o], got["vel"][v][o]
    np.testing.assert_array_equal(pid, rec[key + "pid"])
    assert float(got["atime"]) == pytest.approx(float(rec[key + "atime"]))
    np.testing.assert_array_equal(got["substeps"], rec[key + "substeps"])
    # forces agree to ~1e-6: positions by a few fixed-point ticks, as in
    # the single-device parity tests
    d = (ipos - rec[key + "ipos"].astype(np.int64) + 2 ** 31) % 2 ** 32 \
        - 2 ** 31
    assert np.abs(d).max() <= 16, np.abs(d).max()
    va = rec[key + "vel"]
    assert np.linalg.norm(vel - va) <= 1e-4 * np.linalg.norm(va)
    # the snapshots: every ID once, P(k), the PIGs
    mine = run_outputs(out / mode)
    assert int(mine["n_snapshots"]) == int(rec[key + "n_snapshots"]) >= 1
    assert int(mine["n_pigs"]) == int(rec[key + "n_pigs"]) >= 1
    for i in range(int(mine["n_snapshots"])):
        assert bool(mine[f"snap{i}_ids_ok"])
        assert int(mine[f"snap{i}_nids"]) == len(pid)
        g, w = mine[f"snap{i}_pk"], rec[key + f"snap{i}_pk"]
        np.testing.assert_array_equal(g[:, 2], w[:, 2])
        np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=PK_RTOL)
    for i in range(int(mine["n_pigs"])):
        np.testing.assert_array_equal(mine[f"pig{i}_counts"],
                                      rec[key + f"pig{i}_counts"])


def test_run_sharded_within_single_device_bounds(runs):
    """The hierarchical run's forces at its final positions against the
    single-device forces there, within the JAX package's own bounds
    (tests/test_parallel.py:263-264)."""
    S, out, _ = runs
    got = np.load(out / "run_hier.npz")
    v = got["valid"]
    a, ref = got["sharded_acc"][v], got["single_acc"][v]
    rel = np.linalg.norm(a - ref, axis=1) / (np.linalg.norm(ref, axis=1)
                                              + 1e-8)
    print(f"{S} ranks: p95 {np.percentile(rel, 95):.3e}, max "
          f"{rel.max():.3e}")
    assert np.percentile(rel, 95) < 2e-2
    assert rel.max() < 0.2


def test_cli_two_ranks_stop_file_and_striped_snapshot(tmp_path):
    """run_cli under torch.distributed.run on two gloo ranks: with a stop
    file in OutputDir the run writes a checkpoint at once and stops; the
    checkpoint, a stripe per rank, reads back to the IC's rows."""
    from mpgadget_tpu_torch.genic.main import run_genic
    from mpgadget_tpu_torch.io import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.params import create_genic_parameter_set
    gtext = (REPO / "examples/dm-small/paramfile.genic").read_text()
    gtext = gtext.replace("Ngrid = 64", "Ngrid = 8").replace(
        "OutputDir = IC", f"OutputDir = {tmp_path / 'ic'}")
    gps = create_genic_parameter_set()
    gps.parse_string(gtext + "\nWhichSpectrum = 1\nSigma8 = 0.8\n"
                     "InputPowerRedshift = 0\n")
    gps.validate()
    ic = run_genic(gps, device="cpu")
    out = tmp_path / "out"
    out.mkdir()
    (out / "stop").write_text("")
    pf = tmp_path / "paramfile.gadget"
    pf.write_text(W.run_paramtext(ic, out).replace("Nmesh = 48",
                                                   "Nmesh = 16"))
    (tmp_path / "rank.py").write_text(
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from mpgadget_tpu_torch.main import run_cli\n"
        f"run_cli({str(pf)!r}, device='cpu')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", str(tmp_path / "rank.py")],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "backend gloo, 2 rank(s)" in res.stdout
    assert "[hci] stop requested" in res.stdout
    assert not (out / "stop").exists()
    snap = out / "PART_000"

    def rows(path):
        bf = BigFile(str(path))
        sp = snap_io.read_species(bf, 1, snap_io.read_header(bf))
        o = np.argsort(sp["pid"])
        return {k: v[o] for k, v in sp.items()}

    got, ref = rows(snap), rows(ic)
    np.testing.assert_array_equal(got["pid"], ref["pid"])
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0,
                               atol=1e-9 * 64000)
    np.testing.assert_allclose(got["mass"], ref["mass"], rtol=1e-7)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=1e-6,
                               atol=1e-6)
    # one stripe per rank, holding that rank's rows
    blk = BigFile(str(snap)).open("1/ID")
    assert blk.Nfile == 2 and sum(blk.fsize) == len(ref["pid"])
    assert not list(out.glob("PART_001"))


def test_endrun_on_one_rank_ends_both(tmp_path):
    t0 = time.perf_counter()
    with pytest.raises(Exception) as err:
        W.spawn(W.endrun_case, 2, str(tmp_path))
    assert "exit code 3" in str(err.value) or "exited" in str(err.value)
    assert time.perf_counter() - t0 < 60
    assert not (tmp_path / "rank0_passed").exists()


GAS_SWITCHES = ("HydroOn", "CoolingOn", "StarformationOn", "WindOn",
                "BlackHoleOn", "MetalReturnOn", "QSOLightupOn",
                "ExcursionSetReionOn")
DM_SWITCHES = {"MassiveNuLinRespOn": "massive_nu_lin_resp_on",
               "HybridNeutrinosOn": "hybrid_neutrinos_on",
               "LightconeOn": "lightcone_on",
               "PlaneOutputList": "plane_output_list"}


# Every switch is carried by the sharded driver since its options (QSO
# lightup, the excursion set, the dark-matter options): each is admitted
# alone, and beside it the combination that the JAX package's run_sharded
# refuses, metal return without star formation, is still refused before
# the first step.
@pytest.mark.parametrize("switch", GAS_SWITCHES + tuple(DM_SWITCHES))
def test_run_sharded_refuses_what_it_does_not_carry(switch, tmp_path):
    from mpgadget_tpu_torch.main import build_simulation
    from mpgadget_tpu_torch.params import create_gadget_parameter_set
    from mpgadget_tpu_torch.parallel.mesh import make_sim_mesh
    from mpgadget_tpu_torch.run import check_sharded_supported
    ic = REPO / "tests" / "torch_subgrid" / "IC"
    ps = create_gadget_parameter_set()
    ps.parse_string(W.run_paramtext(ic, tmp_path))
    for s in GAS_SWITCHES:
        ps.set(s, 1 if s == switch else 0)
    # the single-device check wants QSOLightupOn's table named
    ps.set("ReionHistFile", str(tmp_path / "HeIIhist.txt"))
    sim, _ = build_simulation(ps, device="cpu")
    if switch in DM_SWITCHES:
        setattr(sim.cfg, DM_SWITCHES[switch],
                "0.2" if switch == "PlaneOutputList" else True)
    check_sharded_supported(sim.cfg, sim.has_gas)
    sim.cfg.hydro_on, sim.cfg.metal_return_on = True, True
    sim.cfg.starformation_on = False
    calls = sim.tree_force_calls
    # (with WindOn on, winds without star formation are refused first)
    with pytest.raises(ValueError, match="needs StarformationOn in the "
                                         "sharded driver"):
        sim.run_sharded(make_sim_mesh("cpu"))
    assert sim.tree_force_calls == calls and sim.ti_current == 0


@pytest.mark.cuda
def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    from mpgadget_tpu_torch.main import init_distributed
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs on cards only")
    n = torch.cuda.device_count()
    monkeypatch.setenv("WORLD_SIZE", str(n + 1))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29555")
    monkeypatch.delenv("MPG_DIST_BACKEND", raising=False)
    with pytest.raises(RuntimeError, match="NCCL"):
        init_distributed("cuda")


# ---- the JAX record --------------------------------------------------------

def jax_run(S, mode, outdir):
    """The JAX package's run_sharded of the run case at S shards."""
    import jax
    from jax.sharding import Mesh
    from mpgadget_tpu.main import build_simulation as jax_build
    from mpgadget_tpu.params import create_gadget_parameter_set as jps
    ps = jps()
    ps.parse_string(W.run_paramtext(IC, outdir,
                                    hierarchical=(mode == "hier")))
    sim, _ = jax_build(ps)
    mesh = Mesh(np.array(jax.devices("cpu")[:S]), ("x",))
    sim.run_sharded(mesh, hierarchical=(mode == "hier"), verbose=False)
    pd = sim.pdata
    v = np.asarray(pd.valid)
    pid = np.asarray(pd.pid)[v]
    o = np.argsort(pid)
    rec = {"pid": pid[o], "ipos": np.asarray(pd.ipos)[v][o],
           "vel": np.asarray(pd.vel)[v][o],
           "atime": np.float64(sim.atime)}
    # substeps of the run's one PM step
    rec["substeps"] = np.asarray([int(sim._hier_substeps)
                                  if mode == "hier" else 1])
    rec.update(run_outputs(outdir))
    return rec


@pytest.mark.slow
def test_jax_run_record(tmp_path):
    new = {}
    for S in RANKS:
        for mode in MODES:
            for k, v in jax_run(S, mode, tmp_path / f"{S}{mode}").items():
                new[f"S{S}_{mode}_{k}"] = np.asarray(v)
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
