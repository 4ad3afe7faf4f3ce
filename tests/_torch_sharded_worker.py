"""Rank processes of the port's sharded tests: each rank joins a gloo
process group on the CPU (main.init_distributed, from the environment that
torch.distributed.run would give it), runs its cases and writes its results
to an npz file for the test to compare.  Imports no JAX, so that a rank
starts in a few seconds.

``spawn(target, size, *args)`` starts ``size`` ranks of ``target(rank,
size, *args)`` with torch.multiprocessing and waits for them; a rank that
fails fails the call and ends the others.
"""

import copy
import os
import socket
import sys
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# ---- the module cases' inputs (numpy, from a seed) ----------------------
N = 2048
BOX = 1000.0
G = 43007.1
NMESH_PM = 32        # pm_force_multi
NMESH_TREE = 64      # the TreePM step: rcut 6 x asmth 1.5 / 64 < 1/4
ASMTH = 1.5
RCUT = 6.0
GHOST_WIDTH = 0.05   # box units
WIDE_WIDTH = 0.3     # spans more than one slab at 4 ranks: two hops
FOF_LL = 0.2         # of the mean separation
FOF_MIN = 8


def module_inputs(seed=14):
    """Clustered particles: 60% uniform, 40% in six Gaussian blobs."""
    rng = np.random.RandomState(seed)
    nu = int(0.6 * N)
    x = [rng.rand(nu, 3)]
    centres = rng.rand(6, 3)
    per = (N - nu) // 6
    for c in centres:
        x.append(np.mod(c + 0.01 * rng.randn(per, 3), 1.0))
    x.append(rng.rand(N - nu - 6 * per, 3))
    x = np.concatenate(x)
    ipos = np.minimum(x * 2.0 ** 32, 2.0 ** 32 - 1).astype(np.uint32)
    return dict(ipos=ipos, pid=np.arange(N, dtype=np.int64),
                mass=(1.0 + 0.1 * rng.rand(N)).astype(np.float32),
                vel=(10.0 * rng.randn(N, 3)).astype(np.float32),
                keys=((np.arange(N, dtype=np.int64) * 2654435761)
                      % (1 << 40)).astype(np.int64))


def n_local_of(size):
    """Rows per shard of the JAX side's padded layout."""
    return int(np.ceil(2.0 * N / size / 64)) * 64


def pm_hops(bounds):
    """Ring hops from each balanced interval to the geometric slabs its
    rows may sit in (the JAX package's pm_hops_for)."""
    S = len(bounds)
    b = np.asarray(bounds, np.float64) / 2 ** 32
    iv = np.append(b, 1.0)
    K = 0
    for s in range(S):
        lo = int(iv[s] * S)
        hi = min(int(np.nextafter(iv[s + 1], 0) * S), S - 1)
        for g in (lo, hi):
            d = abs(g - s)
            K = max(K, min(d, S - d))
    return int(min(K, S // 2))


def tree_gravity(module):
    """TreeGravity of the TreePM case from a treepm module (the JAX
    package's or the port's)."""
    return module.TreeGravity(boxsize=BOX, nmesh=NMESH_TREE, asmth=ASMTH,
                              rcut=RCUT, G=G, softening=BOX / 50.0)


# ---- spawning ------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _entry(rank, size, port, target, args):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    from mpgadget_tpu_torch.main import init_distributed
    from mpgadget_tpu_torch.parallel import collectives as coll
    init_distributed("cpu")
    try:
        target(rank, size, *args)
    finally:
        coll.destroy_process_group()


def spawn(target, size, *args):
    mp.start_processes(_entry, args=(size, _free_port(), target, args),
                       nprocs=size, start_method="spawn")


def _mesh():
    from mpgadget_tpu_torch.parallel.mesh import make_sim_mesh
    return make_sim_mesh("cpu")


# ---- module cases ----------------------------------------------------------

def module_cases(rank, size, outdir):
    """Every module case of tests/test_torch_parallel.py on this rank;
    writes outdir/mod_r<rank>.npz."""
    from mpgadget_tpu_torch.gravity import treepm as port_treepm
    from mpgadget_tpu_torch.gravity.treepm import tree_force
    from mpgadget_tpu_torch.parallel import decomp, pfft
    from mpgadget_tpu_torch.parallel.driver import (pm_force_multi,
                                                    ghost_hops)
    from mpgadget_tpu_torch.parallel.fof import sharded_fof
    from mpgadget_tpu_torch.parallel.mesh import (shard_particles,
                                                  sharded_pm_step)
    from mpgadget_tpu_torch.parallel.sort import sharded_sort
    from mpgadget_tpu_torch.parallel.treepm import sharded_treepm_step
    from mpgadget_tpu_torch.physics.fof import FOFParams
    from mpgadget_tpu_torch.pm.gravity import _pm_force_kernel
    mesh = _mesh()
    out = {}
    S = size

    # pencil FFT round trip (16^3)
    rng = np.random.RandomState(0)
    vol = rng.randn(16, 16, 16).astype(np.float32)
    nx = 16 // S
    slab = torch.tensor(vol[rank * nx:(rank + 1) * nx])
    pencil = pfft.pencil_r2c(slab, mesh)
    out["pencil"] = torch.view_as_real(pencil).numpy()
    out["pencil_back"] = pfft.pencil_c2r(pencil, mesh).numpy()

    d = module_inputs()
    valid = np.ones(N, bool)
    n_local = n_local_of(S)
    cols = {k: torch.as_tensor(d[k]).to(torch.int64) if k == "ipos"
            else torch.as_tensor(d[k]) for k in ("ipos", "pid", "mass",
                                                  "vel", "keys")}
    st0 = shard_particles(cols, np.ones(N, bool), mesh, n_local)
    hist = decomp.count_histogram(st0["ipos"], mesh).numpy()
    bounds = decomp.balanced_boundaries(hist, S)
    out["hist"] = hist
    out["bounds"] = bounds

    # exchange to the balanced owners
    st, _ = decomp.exchange_to_slabs(dict(st0), st0["ipos"], mesh, bounds)
    out["exchange_pid"] = st["pid"].numpy()

    # ghost strips: one hop, and wide strips over several hops
    for name, width in (("ghost", GHOST_WIDTH), ("wide", WIDE_WIDTH)):
        hops = ghost_hops(bounds, width)
        (g_pid,) = decomp.ghost_strips_multi(
            (st["pid"],), st["ipos"], mesh, bounds,
            float(np.float32(width)), hops)
        out[f"{name}_pid"] = g_pid.numpy()
        out[f"{name}_hops"] = np.int64(hops)

    # distributed sort of the balanced rows
    k_s, arr = sharded_sort(st["keys"], {"pid": st["pid"]}, mesh)
    out["sort_keys"] = k_s.numpy()
    out["sort_pid"] = arr["pid"].numpy()

    # the multi-hop PM force of the balanced rows
    acc, _ = pm_force_multi(st["ipos"], st["mass"], NMESH_PM, BOX, G, ASMTH,
                            mesh)
    out["pm_acc"] = acc.numpy()
    out["pm_pid"] = st["pid"].numpy()

    # the TreePM step (geometric slabs, one-hop ghosts), dkick 1, no drift
    tg = tree_gravity(port_treepm)
    step = sharded_treepm_step(mesh, nmesh=NMESH_TREE, boxsize=BOX,
                               gconst=G, asmth=ASMTH, rcut=RCUT, tg=tg)
    z3 = torch.zeros_like(st0["vel"])
    ip2, vel2, _, _, pid2 = step(st0["ipos"], z3, st0["mass"],
                                 torch.zeros_like(st0["mass"]), st0["pid"],
                                 1.0, 0.0)
    out["tree_acc"] = vel2.numpy()
    out["tree_pid"] = pid2.numpy()
    if rank == 0:
        # the single-device forces at the same positions
        ip = torch.as_tensor(d["ipos"]).to(torch.int64)
        m = torch.as_tensor(d["mass"])
        kw = tree_gravity(port_treepm).force_kwargs(N)
        kw["with_potential"] = False
        res = tree_force(ip, m, torch.ones(N, dtype=torch.bool),
                         torch.zeros(N), **kw)
        acc_pm, _, _ = _pm_force_kernel(ip, m, NMESH_TREE, BOX, G, ASMTH,
                                        compute_potential=False)
        out["single_acc"] = (res.accel + acc_pm).numpy()

    # the PM-only step over geometric slabs (mesh.sharded_pm_step), dkick
    # 1, no drift, against the single-device PM force
    pm_step = sharded_pm_step(mesh, NMESH_PM, BOX, G, ASMTH)
    _, vel3, _, pid3 = pm_step(st0["ipos"], z3, st0["mass"], st0["pid"],
                               1.0, 0.0)
    out["pmstep_acc"] = vel3.numpy()
    out["pmstep_pid"] = pid3.numpy()
    if rank == 0:
        acc_pm1, _, _ = _pm_force_kernel(
            torch.as_tensor(d["ipos"]).to(torch.int64),
            torch.as_tensor(d["mass"]), NMESH_PM, BOX, G, ASMTH,
            compute_potential=False)
        out["pmstep_single"] = acc_pm1.numpy()

    # distributed FOF of the balanced rows
    params = FOFParams(linking_length=FOF_LL, min_group_length=FOF_MIN)
    fst = {"ipos": st["ipos"], "vel": st["vel"], "mass": st["mass"],
           "ptype": torch.ones(st["pid"].shape[0], dtype=torch.int32)}
    cat, sorted_labels, labels = sharded_fof(
        mesh, fst, bounds, boxsize=BOX, mean_sep=BOX / np.cbrt(N),
        params=params)
    out["fof_label"] = labels.numpy()
    out["fof_pid"] = st["pid"].numpy()
    out["fof_lengths"] = np.asarray(cat["lengths"])
    out["fof_masses"] = np.asarray(cat["masses"])
    out["fof_cm"] = np.asarray(cat["cm"])
    out["fof_sorted_labels"] = np.asarray(sorted_labels)
    np.savez(os.path.join(outdir, f"mod_r{rank}.npz"), **out)


# ---- run cases -------------------------------------------------------------

RUN_OUTPUTS = "0.105"
RUN_TMAX = "0.105"


def run_paramtext(ic, out, hierarchical=True, extra=""):
    """dm-small's paramfile.gadget on the 24^3 parity IC at Nmesh 48 to
    a = 0.105 (one PM step), with a snapshot and a PIG there."""
    text = (REPO / "examples/dm-small/paramfile.gadget").read_text()
    text = text.replace("InitCondFile = IC/IC", f"InitCondFile = {ic}")
    text = text.replace("OutputDir = output", f"OutputDir = {out}")
    text = text.replace("Nmesh = 128", "Nmesh = 48")
    text = text.replace("OutputList = 0.15,0.2,0.25",
                        f"OutputList = {RUN_OUTPUTS}")
    text = text.replace("TimeMax = 0.25", f"TimeMax = {RUN_TMAX}")
    if not hierarchical:
        text = text.replace("SplitGravityTimestepsOn = 1",
                            "SplitGravityTimestepsOn = 0")
    return text + extra


PARITY_IC = REPO / "tests" / "torch_parity" / "IC"


def build_run(outdir, mode):
    """The run case's Simulation on the CPU."""
    from mpgadget_tpu_torch.main import build_simulation
    from mpgadget_tpu_torch.params import create_gadget_parameter_set
    ps = create_gadget_parameter_set()
    ps.parse_string(run_paramtext(PARITY_IC, os.path.join(outdir, mode),
                                  hierarchical=(mode == "hier")))
    return build_simulation(ps, device="cpu")[0]


def first_forces(path):
    """What run_sharded's first force computation (the single-device
    compute_forces every rank makes from the same IC) leaves: computed
    once and saved to path, for every rank of every spawn to load."""
    sim = build_run(os.path.dirname(path), "hier")
    sim.compute_forces(measure_power=False)
    pd = sim.pdata
    torch.save({"grav_accel": pd.grav_accel, "grav_pm": pd.grav_pm,
                "potential": pd.potential, "tree": sim._tree_grav}, path)


def run_cases(rank, size, outdir, forces):
    """run_sharded, global and hierarchical, from the parity IC on this
    rank, each from the first forces saved at ``forces``.  Rank 0 writes
    the final state of each (run_<mode>.npz) and, of the hierarchical
    run, the single-device forces at its final positions."""
    mesh = _mesh()
    first = torch.load(forces, weights_only=False)
    for mode in ("hier", "global"):
        sim = build_run(outdir, mode)
        sim.pdata = sim.pdata.replace(
            **{k: first[k] for k in ("grav_accel", "grav_pm", "potential")})
        sim._tree_grav = copy.deepcopy(first["tree"])
        sim.run_sharded(mesh, hierarchical=(mode == "hier"),
                        verbose=False)
        if rank == 0:
            pd = sim.pdata
            res = dict(ipos=pd.ipos.numpy(), vel=pd.vel.numpy(),
                       pid=pd.pid.numpy(), valid=pd.valid.numpy(),
                       atime=np.float64(sim.atime),
                       substeps=np.asarray([e["substeps"]
                                            for e in sim.sharded_log]),
                       ngroups=np.asarray([f["ngroups"]
                                           for f in sim.sharded_fofs]))
            if mode == "hier":
                # the single-device forces at the final positions; the
                # last substep closed every bin at a = 0.105
                res["sharded_acc"] = (pd.grav_accel + pd.grav_pm).numpy()
                sim._compute_tree_forces()
                sim.compute_forces(measure_power=False, tree=False)
                res["single_acc"] = (sim.pdata.grav_accel
                                     + sim.pdata.grav_pm).numpy()
            np.savez(os.path.join(outdir, f"run_{mode}.npz"), **res)


# ---- failure cases ---------------------------------------------------------

def endrun_case(rank, size, outdir):
    """Rank 1 ends the job while rank 0 waits in a collective."""
    from mpgadget_tpu_torch.parallel import collectives as coll
    from mpgadget_tpu_torch.utils.log import endrun
    mesh = _mesh()
    coll.barrier(mesh)
    if rank == 1:
        endrun(3, "deliberate failure on rank 1")
    coll.barrier(mesh)          # never completes: rank 1 is gone
    Path(outdir, "rank0_passed").write_text("unexpected")
