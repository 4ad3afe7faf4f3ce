"""Rank processes of the port's sharded tests: each rank joins a gloo
process group on the CPU (main.init_distributed, from the environment that
torch.distributed.run would give it), runs its cases and writes its results
to an npz file for the test to compare.  Imports no JAX, so that a rank
starts in a few seconds.

``spawn(target, size, *args)`` starts ``size`` ranks of ``target(rank,
size, *args)`` with torch.multiprocessing and waits for them; a rank that
fails fails the call and ends the others.  The ranks have a deadline
(SPAWN_DEADLINE seconds, or ``deadline=``): past it they are killed and
the call raises, so that a rank stuck in a collective fails its test and
no more.  A rendezvous that fails (the free port taken between its choice
and rank 0's bind) is retried on another port.
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


SPAWN_DEADLINE = 300.0    # seconds for one spawn's ranks
RENDEZVOUS_EXIT = 75      # a rank's exit code when it could not join
RENDEZVOUS_TRIES = 3
PG_TIMEOUT = 240.0        # the gloo group's timeout for a collective


def _entry(rank, size, port, target, args):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port),
                      MPG_DIST_TIMEOUT=str(PG_TIMEOUT))
    from mpgadget_tpu_torch.main import init_distributed
    from mpgadget_tpu_torch.parallel import collectives as coll
    try:
        init_distributed("cpu")
    except Exception as e:      # the rendezvous: retried by spawn
        print(f"rank {rank}: rendezvous on port {port} failed: {e}",
              file=sys.stderr)
        sys.exit(RENDEZVOUS_EXIT)
    try:
        target(rank, size, *args)
    finally:
        coll.destroy_process_group()


def _kill(ctx):
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
        p.join()


def spawn(target, size, *args, deadline=SPAWN_DEADLINE):
    """Run target(rank, size, *args) on ``size`` gloo ranks; raises if a
    rank fails or the ranks pass ``deadline`` seconds (then killed)."""
    import time
    from torch.multiprocessing import ProcessExitedException
    t_end = time.monotonic() + deadline
    for attempt in range(RENDEZVOUS_TRIES):
        ctx = mp.start_processes(_entry, args=(size, _free_port(), target,
                                               args),
                                 nprocs=size, start_method="spawn",
                                 join=False)
        try:
            while not ctx.join(timeout=max(0.1, min(
                    5.0, t_end - time.monotonic()))):
                if time.monotonic() > t_end:
                    _kill(ctx)
                    raise TimeoutError(
                        f"{target.__name__} on {size} ranks passed its "
                        f"deadline of {deadline:.0f} s; ranks killed")
            return
        except ProcessExitedException as e:
            _kill(ctx)
            if e.exit_code != RENDEZVOUS_EXIT \
                    or attempt == RENDEZVOUS_TRIES - 1:
                raise


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
    acc, _, _ = pm_force_multi(st["ipos"], st["mass"], NMESH_PM, BOX, G,
                               ASMTH, mesh)
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


# ---- the sharded gas -------------------------------------------------------

GAS_IC = REPO / "tests" / "torch_star" / "IC"
# tests/test_torch_star_run.py's run (lya's gas physics, its star-forming
# thresholds lowered so that stars form at z ~ 9 in a 5 Mpc/h box of 8^3
# gas), with DensityIndependentSphOn 1: the JAX package's sharded density
# always sums the entropy-weighted density, so that only this formulation
# compares with its run_sharded; a snapshot and a PIG (FOF with gas and
# stars attached as secondaries) at GAS_TIME_MAX.
GAS_PARAMS = """
InitCondFile = {ic}
OutputDir = {out}
OutputList = {tmax}
TimeMax = {tmax}
TimeLimitCPU = 10000
Omega0 = 0.288
OmegaLambda = 0.712
OmegaBaryon = 0.0472
HubbleParam = 0.7
HydroOn = 1
DensityIndependentSphOn = 1
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
SnapshotWithFOF = 1
FOFHaloMinLength = 4
SplitGravityTimestepsOn = 1
Nmesh = 16
"""
GAS_TIME_MAX = 0.11
GAS_BOX = 5000.0      # the IC's BoxSize (kpc/h)
# mode: (paramfile overrides, PM steps (None: to GAS_TIME_MAX))
GAS_MODES = {"hier": ({}, None),
             "global": ({"SplitGravityTimestepsOn": 0}, 2),
             "cool": ({"StarformationOn": 0}, 1)}
GAS_STATE = ("ipos", "vel", "mass", "ptype", "hsml", "entropy", "density",
             "egy_wt_density", "ne", "sfr", "formation_time",
             "birth_density")


def gas_paramtext(out, mode, **extra):
    text = GAS_PARAMS.format(ic=GAS_IC, out=out, tmax=GAS_TIME_MAX)
    for k, v in dict(GAS_MODES[mode][0], **extra).items():
        text += f"\n{k} = {v}"
    return text


def build_gas_run(outdir, mode, **extra):
    """A gas run case's Simulation on the CPU."""
    from mpgadget_tpu_torch.main import build_simulation
    from mpgadget_tpu_torch.params import create_gadget_parameter_set
    ps = create_gadget_parameter_set()
    ps.parse_string(gas_paramtext(os.path.join(outdir, mode), mode,
                                  **extra))
    ps.validate()
    return build_simulation(ps, device="cpu")[0]


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def gas_final_state(sim):
    """The host mirror of a finished run (either package), by ID."""
    pd = sim.pdata
    v = _host(pd.valid)
    cols = {"pid": pd.pid, "ipos": pd.ipos, "vel": pd.vel, "mass": pd.mass,
            "ptype": pd.ptype, "hsml": pd.hsml}
    for k in ("entropy", "density", "egy_wt_density", "ne", "sfr"):
        cols[k] = getattr(sim.sph, k)
    if sim.stars is not None:
        cols["formation_time"] = sim.stars.formation_time
        cols["birth_density"] = sim.stars.birth_density
    out = {k: _host(c)[v] for k, c in cols.items()}
    out["ipos"] = out["ipos"].astype(np.int64)
    o = np.argsort(out["pid"], kind="stable")
    out = {k: c[o] for k, c in out.items()}
    out["atime"] = np.float64(sim.atime)
    return out


def bigfile_blocks(path, types=(0, 1, 4)):
    """Every block of a snapshot or PIG's species, sorted by ID, and the
    FOFGroups table: {"<t>/<block>": array}."""
    from mpgadget_tpu_torch.io import BigFile
    bf = BigFile(str(path))
    blocks = bf.blocks()
    out = {}
    for t in types:
        if f"{t}/ID" not in bf:
            continue
        o = np.argsort(bf.open(f"{t}/ID").read(), kind="stable")
        for name in blocks:
            if name.startswith(f"{t}/"):
                out[name] = bf.open(name).read()[o]
    for name in blocks:
        if name.startswith("FOFGroups/"):
            out[name] = bf.open(name).read()
    return out


def gas_outputs(sim, outdir):
    """What the gas record keeps of one run: the final state by ID, the
    sfr.txt lines, and the blocks of its snapshots and PIGs."""
    out = {f"state/{k}": v for k, v in gas_final_state(sim).items()}
    sfr = Path(outdir) / "sfr.txt"
    out["sfr_txt"] = np.array(sfr.read_text().split("\n")[:-1]
                              if sfr.exists() else [], dtype=str)
    for kind in ("PART", "PIG"):
        for i, p in enumerate(sorted(Path(outdir).glob(f"{kind}_*"))):
            for k, v in bigfile_blocks(p).items():
                out[f"{kind}{i}/{k}"] = v
    return out


def gas_run_cases(rank, size, outdir, modes):
    """run_sharded of each gas mode on this rank (rank 0 writes
    gas_<mode>.npz: gas_outputs and the sharded log)."""
    mesh = _mesh()
    for mode in modes:
        sim = build_gas_run(outdir, mode)
        sim.run_sharded(mesh, hierarchical=mode != "global",
                        verbose=False, max_steps=GAS_MODES[mode][1])
        if rank == 0:
            res = gas_outputs(sim, os.path.join(outdir, mode))
            res["substeps"] = np.asarray([e["substeps"]
                                          for e in sim.sharded_log])
            np.savez(os.path.join(outdir, f"gas_{mode}.npz"), **res)


# ---- the sharded gas modules ------------------------------------------------

GAS_HSML0 = 0.35     # of the gas's mean separation: too narrow a first
                     # strip, so that the density solve runs again wider
GAS_ATIME, GAS_HUBBLE, GAS_DLOGA = 0.1, 0.0316, 0.01   # the hydro call's


def gas_module_inputs(seed=15):
    """module_inputs with types: a quarter dark matter (the FOF's
    primaries), an eighth stars, the rest gas, with a first hsml
    GAS_HSML0 of the gas's mean separation and entropy variables near
    one."""
    d = module_inputs(seed)
    pid = d["pid"]
    ptype = np.zeros(N, np.int32)
    ptype[pid % 4 == 1] = 1
    ptype[pid % 8 == 3] = 4
    ngas = int((ptype == 0).sum())
    rng = np.random.RandomState(seed + 1)
    d["ptype"] = ptype
    d["hsml"] = np.where(ptype == 0, np.float32(
        GAS_HSML0 * BOX / np.cbrt(ngas)), 0).astype(np.float32)
    d["entvar"] = (1.0 + 0.2 * rng.rand(N)).astype(np.float32)
    return d


def sph_params():
    """The density and hydro parameters of the module cases (cubic kernel,
    either package's dataclasses)."""
    from mpgadget_tpu_torch.sph.density import DensityParams
    from mpgadget_tpu_torch.sph.hydra import HydroParams
    from mpgadget_tpu_torch.sph.kernels import CUBIC
    return DensityParams(kernel_type=CUBIC), HydroParams(kernel_type=CUBIC)


def gas_module_cases(rank, size, outdir):
    """The sharded gas modules of tests/test_torch_sharded_gas.py on this
    rank, on the rows of its geometric slab; writes outdir/gas_r<rank>.npz:
    the density (and the margin its strip needed), the hydro force on the
    converged density, and the FOF labels with secondaries and its
    catalogue."""
    from mpgadget_tpu_torch.parallel import decomp
    from mpgadget_tpu_torch.parallel.fof import sharded_fof
    from mpgadget_tpu_torch.parallel.mesh import shard_particles
    from mpgadget_tpu_torch.parallel.sph import (DENSITY_MARGIN,
                                                 DENSITY_OUT, HYDRO_OUT,
                                                 STRIP_WIDEN, sharded_hydro,
                                                 sharded_sph_density)
    from mpgadget_tpu_torch.physics.fof import FOFParams
    mesh = _mesh()
    S = size
    d = gas_module_inputs()
    cols = {k: torch.as_tensor(d[k]).to(torch.int64) if k == "ipos"
            else torch.as_tensor(d[k])
            for k in ("ipos", "pid", "mass", "vel", "ptype", "hsml",
                      "entvar")}
    st0 = shard_particles(cols, np.ones(N, bool), mesh, n_local_of(S))
    st, _ = decomp.exchange_to_slabs(dict(st0), st0["ipos"], mesh)
    geo = (np.arange(S, dtype=np.int64) * (2 ** 32 // S)).astype(np.int64)
    gas = st["ptype"] == 0
    dpar, hpar = sph_params()
    out = {"pid": st["pid"].numpy()}
    margin = DENSITY_MARGIN
    while True:     # the strip re-run, as the JAX package's caller's
        dens, ok = sharded_sph_density(st["ipos"], st["vel"], st["mass"],
                                       gas, st["hsml"], st["entvar"], mesh,
                                       geo, dpar, BOX, margin=margin)
        if ok:
            break
        margin *= STRIP_WIDEN
    out["margin"] = np.float64(margin)
    for k in DENSITY_OUT:
        out[f"dens_{k}"] = dens[k].numpy()
    hcols = dict(ipos=st["ipos"], vel=st["vel"], mass=st["mass"],
                 hsml=dens["hsml"], entvar=st["entvar"],
                 density=dens["density"], egywt=dens["egy_wt_density"],
                 divv=dens["div_vel"], curlv=dens["curl_vel"],
                 dhsml_egy=dens["dhsml_egy_factor"])
    h = sharded_hydro(hcols, gas, mesh, geo, hpar, BOX, GAS_ATIME,
                      GAS_HUBBLE, GAS_DLOGA)
    for k in HYDRO_OUT:
        out[f"hydro_{k}"] = h[k].numpy()
    params = FOFParams(linking_length=FOF_LL, min_group_length=FOF_MIN)
    ndm = int((d["ptype"] == 1).sum())
    cat, sorted_labels, labels = sharded_fof(
        mesh, {k: st[k] for k in ("ipos", "vel", "mass", "ptype")}, geo,
        boxsize=BOX, mean_sep=BOX / np.cbrt(ndm), params=params)
    out["fof_label"] = labels.numpy()
    for k in ("lengths", "masses", "len_by_type", "mass_by_type"):
        out[f"fof_{k}"] = np.asarray(cat[k])
    out["fof_sorted_labels"] = np.asarray(sorted_labels)
    np.savez(os.path.join(outdir, f"gas_r{rank}.npz"), **out)


# ---- the sharded subgrid modules ---------------------------------------------

SG_BOX = 1000.0
SG_UNITS = (3.085678e21, 1.989e43, 1e5)       # kpc, 1e10 Msun, km/s
SG_WIND = dict(atime=0.6, dtime=2e-3, key=19)
SG_BH = dict(atime=0.5, dtime=2e-3, key=33, soft=1.0, gconst=43007.1,
             unit_time=3.08568e16, hubble=0.7, unit_vel=1e5, uu=1e10,
             rho_crit_b=1e-9, kernel=1)
SG_METAL = dict(a0=0.5, a1=0.6, star_h=1.0, gas_h=0.8)   # of the mean sep.
SG_SEED = dict(seed_mass=1e-3, seed_dyn_mass=-1.0, atime=0.1)


def wind_module_inputs(seed=11):
    """tests/test_parallel.py's sharded-winds case: 1024 rows, six new
    stars with gas around each, 400 dark-matter rows, the stars scattered
    to high rows (one at row 255)."""
    rng = np.random.RandomState(seed)
    n, nstar, box = 1024, 6, SG_BOX
    pos = rng.uniform(0, box, (n, 3))
    new_star = np.zeros(n, bool)
    new_star[:nstar] = True
    for b in range(nstar):
        pos[nstar + b * 40:nstar + (b + 1) * 40] = (
            pos[b] + rng.uniform(-50, 50, (40, 3))) % box
    is_dm = np.zeros(n, bool)
    is_dm[nstar + nstar * 40:nstar + nstar * 40 + 400] = True
    perm = rng.permutation(n)
    j0 = int(np.where(new_star[perm])[0][0])
    perm[[j0, 255]] = perm[[255, j0]]
    pos, new_star, is_dm = pos[perm], new_star[perm], is_dm[perm]
    is_gas = ~new_star & ~is_dm
    a = SG_WIND["atime"]
    return dict(
        ipos=(pos / box * 2.0 ** 32).astype(np.uint32),
        vel=(rng.randn(n, 3) * 50).astype(np.float32),
        mass=np.full(n, 1e-3, np.float32), pid=np.arange(1, n + 1),
        ptype=np.where(new_star, 4, np.where(is_dm, 1, 0)).astype(np.int32),
        hsml=np.where(new_star, 80.0, 40.0).astype(np.float32),
        entropy=np.full(n, 1e3, np.float32),
        density=np.full(n, 1e-6, np.float32),
        delay_time=np.zeros(n, np.float32), gas_mask=is_gas,
        formation_time=np.where(new_star, a, 0.0).astype(np.float32))


def wind_params(module, model):
    """The case's WindParams (either package's winds module): ofjt10 or
    vs08, init_winds as tests/test_parallel.py's."""
    par = module.WindParams(model=(
        module.WIND_USE_HALO | module.WIND_DECOUPLE_SPH if model == "ofjt10"
        else module.WIND_FIXED_EFFICIENCY))
    return module.init_winds(par, 0.1, 1e3, 1e-7, 3.08568e16)


def bh_module_inputs(variant, seed=21):
    """tests/test_parallel.py's sharded-BH case (1024 rows, four BHs with
    60 gas rows around each, scattered to high rows, one at row 255);
    "full" makes a quarter of the other rows dark matter and an eighth
    stars, gives the BHs an Mtrack and every row a potential."""
    rng = np.random.RandomState(seed)
    n, nbh, box = 1024, 4, SG_BOX
    pos = rng.uniform(0, box, (n, 3))
    is_bh = np.zeros(n, bool)
    is_bh[:nbh] = True
    for b in range(nbh):
        pos[nbh + b * 60:nbh + (b + 1) * 60] = (
            pos[b] + rng.uniform(-40, 40, (60, 3))) % box
    perm = rng.permutation(n)
    j0 = int(np.where(is_bh[perm])[0][0])
    perm[[j0, 255]] = perm[[255, j0]]
    pos, is_bh = pos[perm], is_bh[perm]
    pid = np.arange(1, n + 1)
    ptype = np.where(is_bh, 5, 0).astype(np.int32)
    if variant == "full":
        ptype[~is_bh & (pid % 4 == 1)] = 1
        ptype[~is_bh & (pid % 8 == 3)] = 4
    d = dict(
        ipos=(pos / box * 2.0 ** 32).astype(np.uint32),
        vel=(rng.randn(n, 3) * 20.0).astype(np.float32),
        mass=np.where(is_bh, 4e-4, 2e-4).astype(np.float32), pid=pid,
        ptype=ptype, hsml=np.where(is_bh, 60.0, 30.0).astype(np.float32),
        entropy=(np.abs(rng.randn(n)) * 1e3 + 1e3).astype(np.float32),
        density=np.full(n, 1e-7, np.float32), gas_mask=ptype == 0,
        grav_acc=(rng.randn(n, 3) * 1e2).astype(np.float32),
        bh_mass=np.where(is_bh, 2e-3, 0.0).astype(np.float32),
        bh_mdot=np.zeros(n, np.float32), bh_density=np.zeros(n, np.float32),
        bh_mtrack=np.zeros(n, np.float32), bh_progs=np.zeros(n, np.int32),
        bh_ke=np.zeros(n, np.float32), bh_vdisp=np.zeros(n, np.float32))
    if variant == "full":
        d["bh_mtrack"] = np.where(is_bh, 3e-4, 0.0).astype(np.float32)
        d["bh_ke"] = np.where(is_bh, 1e-9, 0.0).astype(np.float32)
        d["potential"] = (-1e5 * (1 + rng.rand(n))).astype(np.float32)
    return d


def merger_module_inputs():
    """Three BHs (IDs 1-3) within twice the softening of one another,
    at rest and unaccelerated, so bound: the biggest ID swallows both;
    a fourth BH far from them stays."""
    rng = np.random.RandomState(3)
    n, box = 64, SG_BOX
    pos = rng.uniform(0, box, (n, 3))
    pos[1] = pos[0] + [1.0, 0.0, 0.0]
    pos[2] = pos[0] + [2.0, 0.0, 0.0]
    pos[3] = np.mod(pos[0] + 400.0, box)
    is_bh = np.arange(n) < 4
    return dict(
        ipos=(np.mod(pos, box) / box * 2.0 ** 32).astype(np.uint32),
        vel=np.zeros((n, 3), np.float32), mass=np.full(n, 1e-4, np.float32),
        pid=np.arange(1, n + 1), ptype=np.where(is_bh, 5, 0).astype(np.int32),
        hsml=np.full(n, 20.0, np.float32),
        entropy=np.full(n, 1e3, np.float32),
        density=np.full(n, 1e-7, np.float32), gas_mask=~is_bh,
        grav_acc=np.zeros((n, 3), np.float32),
        bh_mass=np.where(is_bh, 1e-3, 0.0).astype(np.float32),
        bh_mdot=np.zeros(n, np.float32), bh_density=np.zeros(n, np.float32),
        bh_mtrack=np.zeros(n, np.float32), bh_progs=np.where(
            is_bh, np.arange(n) % 3, 0).astype(np.int32),
        bh_ke=np.zeros(n, np.float32), bh_vdisp=np.zeros(n, np.float32))


BH_VARIANTS = {"bh": dict(), "full": dict(
    dynfric_method=2, kinetic_on=True, seed_bh_dyn_mass=1e-3,
    merge_grav_bound=True, eddington_factor=2.1), "merge": dict()}


def bh_params(module, variant):
    par = dict(accretion_factor=100.0, feedback_factor=0.05,
               eddington_factor=0.0, seed_bh_dyn_mass=-1.0,
               merge_grav_bound=False)
    par.update(BH_VARIANTS[variant])
    return module.BHParams(**par)


def metal_module_inputs(seed=7):
    """tests/test_parallel.py's sharded metal-return case (512 rows, 64
    stars formed at a = 0.11), with the stars' first hsml and the gas's
    (SG_METAL, of the mean separation) small enough that the first strip
    is too narrow for the converged star hsml."""
    rng = np.random.RandomState(seed)
    n, n_star, box = 512, 64, SG_BOX
    pos = rng.uniform(0, box, (n, 3))
    is_star = np.arange(n) < n_star
    sep = box / np.cbrt(n)
    metals = np.zeros((n, 9), np.float32)
    metals[:, 0], metals[:, 1], metals[:, 4] = 0.75, 0.24, 0.01
    return dict(
        ipos=(pos / box * 2.0 ** 32).astype(np.uint32), pid=np.arange(n),
        mass=np.where(is_star, 2.0, 1.0).astype(np.float32),
        hsml=np.where(~is_star, SG_METAL["gas_h"] * sep, 0.0).astype(
            np.float32),
        star_hsml=np.where(is_star, SG_METAL["star_h"] * sep, 0.0).astype(
            np.float32),
        density=np.where(~is_star, 1e-8, 0.0).astype(np.float32),
        gas_mask=~is_star, ptype=np.where(is_star, 4, 0).astype(np.int32),
        metals=metals,
        metallicity=np.where(~is_star, 0.01, 0.0).astype(np.float32),
        birth_metallicity=np.where(is_star, 0.02, 0.0).astype(np.float32),
        formation_time=np.where(is_star, 0.11, 0.0).astype(np.float32),
        total_mass_returned=np.zeros(n, np.float32),
        last_enrichment_myr=np.zeros(n, np.float32))


def metal_units_cosmology(pkg):
    """(units, Cosmology) of the metal-return case from either package."""
    U = __import__(f"{pkg}.utils", fromlist=["get_unitsystem", "constants"])
    cosmo = __import__(f"{pkg}.cosmology", fromlist=["Cosmology"])
    un = U.get_unitsystem(U.constants.CM_PER_KPC, 1.989e43, 1e5)
    cp = cosmo.Cosmology(Omega0=0.3, OmegaLambda=0.7, HubbleParam=0.7,
                         TimeBegin=0.1).init_units(un)
    return un, cp


def seed_module_inputs(seed=15):
    """gas_module_inputs with the gas's densities, and every 61st gas row
    a BH, for the FOF's seeding extras."""
    d = gas_module_inputs(seed)
    rng = np.random.RandomState(seed + 2)
    bh = (d["ptype"] == 0) & (d["pid"] % 61 == 7)
    d["ptype"] = np.where(bh, 5, d["ptype"]).astype(np.int32)
    d["density"] = np.where(d["ptype"] == 0, 10.0 ** rng.uniform(
        -9, -7, N), 0.0).astype(np.float32)
    n = N
    d.update(gas_mask=d["ptype"] == 0,
             bh_mass=np.where(bh, 2e-3, 0.0).astype(np.float32),
             bh_mtrack=np.zeros(n, np.float32),
             formation_time=np.zeros(n, np.float32))
    return d


def _cols(d, keys):
    return {k: torch.as_tensor(d[k].astype(np.int64) if k in ("ipos", "pid")
                               else d[k]) for k in keys}


def subgrid_module_cases(rank, size, outdir):
    """The sharded subgrid modules of tests/test_torch_sharded_subgrid.py on
    this rank; writes outdir/sg_r<rank>.npz: the winds (ofjt10 and vs08),
    the BH passes (without and with reposition, dynamical friction, the
    kinetic channel and Mtrack; the mergers), the metal return with its
    strip re-run, and the FOF's seeding with seed_convert."""
    from mpgadget_tpu_torch.parallel import decomp
    from mpgadget_tpu_torch.parallel.blackhole import sharded_bh
    from mpgadget_tpu_torch.parallel.fof import (SEED_NONE, row_offsets,
                                                 seed_convert, sharded_fof)
    from mpgadget_tpu_torch.parallel.mesh import shard_particles
    from mpgadget_tpu_torch.parallel.metals import sharded_metal_return
    from mpgadget_tpu_torch.parallel.winds import sharded_winds
    from mpgadget_tpu_torch.physics import blackhole as bhmod
    from mpgadget_tpu_torch.physics import metal_return as mrmod
    from mpgadget_tpu_torch.physics import winds as windmod
    from mpgadget_tpu_torch.physics.fof import FOFParams
    from mpgadget_tpu_torch.utils import threefry
    mesh = _mesh()
    S = size
    out = {}

    def rows(d, keys):
        # rank r holds rows [r n / S, (r + 1) n / S): the JAX side's layout
        n = len(d["pid"])
        return shard_particles(_cols(d, keys), np.ones(n, bool), mesh,
                               n // S)

    # ---- winds ----
    d = wind_module_inputs()
    for model in ("ofjt10", "vs08"):
        st = rows(d, d.keys())
        w = SG_WIND
        upd, stats = sharded_winds(
            st, {"atime": w["atime"], "dtime": w["dtime"],
                 "aform_min": w["atime"] * (1 - 1e-6),
                 "key": threefry.prng_key(w["key"])}, mesh,
            wind_params(windmod, model), boxsize=SG_BOX,
            mean_sep=SG_BOX / np.cbrt(len(d["pid"])))
        out[f"wind_{model}_pid"] = st["pid"].numpy()
        for k, v in upd.items():
            out[f"wind_{model}_{k}"] = v.numpy()
        out[f"wind_{model}_n_kicked"] = np.int64(stats["n_kicked"])
        out[f"wind_{model}_n_new"] = np.int64(stats["n_new"])

    # ---- black holes ----
    for variant in BH_VARIANTS:
        d = merger_module_inputs() if variant == "merge" else \
            bh_module_inputs(variant)
        st = rows(d, d.keys())
        b = SG_BH
        new, stats = sharded_bh(
            st, {"atime": b["atime"], "dtime": b["dtime"],
                 "key": threefry.prng_key(b["key"]),
                 "bh_soft": 2.0 if variant == "merge" else b["soft"]}, mesh,
            bh_params(bhmod, variant), boxsize=SG_BOX, gconst=b["gconst"],
            unit_time_in_s=b["unit_time"], hubble_param=b["hubble"],
            unit_velocity=b["unit_vel"], uu_in_cgs=b["uu"],
            rho_crit_baryon=b["rho_crit_b"], kernel_type=b["kernel"],
            reposition=variant == "full")
        for k, v in new.items():
            out[f"bh_{variant}_{k}"] = v.numpy()
        for k, v in stats.items():
            out[f"bh_{variant}_stat_{k}"] = np.float64(v)

    # ---- metal return (geometric slabs: the ghost strips') ----
    d = metal_module_inputs()
    un, cp = metal_units_cosmology("mpgadget_tpu_torch")
    age = mrmod.AgeTable(cp.hubble_function, un, 0.7, device="cpu")
    cols = _cols(d, d.keys())
    st0 = shard_particles(cols, np.ones(len(d["pid"]), bool), mesh,
                          len(d["pid"]) // S)
    st, _ = decomp.exchange_to_slabs(dict(st0), st0["ipos"], mesh)
    geo = decomp.geometric_boundaries(S)
    upd, stats = sharded_metal_return(
        st, mesh, geo, SG_METAL["a0"], SG_METAL["a1"], age,
        mrmod.MetalReturnParams(), SG_BOX)
    out["metal_pid"] = st["pid"].numpy()
    for k, v in upd.items():
        out[f"metal_{k}"] = v.numpy()
    for k, v in stats.items():
        out[f"metal_stat_{k}"] = np.float64(v)

    # ---- the FOF's seeding extras and seed_convert ----
    d = seed_module_inputs()
    keys = ("ipos", "pid", "mass", "vel", "ptype", "density", "gas_mask",
            "bh_mass", "bh_mtrack", "formation_time")
    st0 = shard_particles(_cols(d, keys), np.ones(N, bool), mesh,
                          n_local_of(S))
    st, _ = decomp.exchange_to_slabs(dict(st0), st0["ipos"], mesh)
    params = FOFParams(linking_length=FOF_LL, min_group_length=FOF_MIN)
    ndm = int((d["ptype"] == 1).sum())
    cat, _, labels = sharded_fof(
        mesh, {k: st[k] for k in ("ipos", "vel", "mass", "ptype",
                                  "density")}, geo, boxsize=SG_BOX,
        mean_sep=SG_BOX / np.cbrt(ndm), params=params, with_bh=True)
    offset, _ = row_offsets(st["pid"].shape[0], mesh)
    # the seeding rows' IDs: every rank maps the gids it holds
    gid = cat["seed_gid"]
    mine = (gid >= offset) & (gid < offset + st["pid"].shape[0])
    sp = np.full(len(gid), -1, np.int64)
    sp[mine] = st["pid"].numpy()[gid[mine] - offset]
    out["seed_pid_part"] = sp
    for k in ("has_bh", "seed_density", "masses", "lengths"):
        out[f"seed_{k}"] = np.asarray(cat[k])
    pick = ~cat["has_bh"] & (gid != SEED_NONE)
    new, nseeded = seed_convert(st, gid[pick], mesh, **SG_SEED)
    out["seed_pid"] = new["pid"].numpy()
    for k in ("ptype", "gas_mask", "bh_mass", "bh_mtrack", "mass",
              "formation_time"):
        out[f"seed_new_{k}"] = new[k].numpy()
    out["seed_n"] = np.int64(nseeded)
    np.savez(os.path.join(outdir, f"sg_r{rank}.npz"), **out)


# ---- the sharded star run ------------------------------------------------------

STAR_IC = REPO / "tests" / "torch_subgrid" / "IC"
# tests/test_torch_subgrid_run.py's run (its committed IC: 8^3 gas, 8^3
# dark matter, four BHs of which two merge; lya's gas physics with the
# star-forming thresholds lowered, ofjt10 winds, metal return and BHs with
# a seed mass of 1) on global steps to STAR_TIME_MAX, with phase 24's
# seeding thresholds (MinFoFMassForNewSeed 0, MinMStarForNewSeed -1) and
# FOF with groups of 8 or more at each output, so that the FOF seeds BHs
# at a = 0.115 and these step to a = 0.12.
STAR_PARAMS = """
InitCondFile = {ic}
OutputDir = {out}
OutputList = 0.115,{tmax}
TimeMax = {tmax}
TimeLimitCPU = 10000
Omega0 = 0.288
OmegaLambda = 0.712
OmegaBaryon = 0.0472
HubbleParam = 0.7
HydroOn = 1
DensityIndependentSphOn = 1
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
MinFoFMassForNewSeed = 0
MinMStarForNewSeed = -1
PartAllocFactor = 2.0
MassiveNuLinRespOn = 0
SnapshotWithFOF = 1
FOFHaloMinLength = 8
SplitGravityTimestepsOn = 0
Nmesh = 16
"""
STAR_TIME_MAX = 0.12
# mode: paramfile overrides.  "nodecouple" is the window the JAX package's
# run_sharded can be held to: its sharded hydro gives decoupled wind gas
# the hydro force (ROADMAP.md section 3), so no wind gas decouples
# (MaxWindFreeTravelTime 0); and it repositions BHs whenever it carries
# the potential (OutputPotential), so the potential is off.  "decouple"
# runs as the paramfile says, held to the single-device loop.
# "hiermetals" is the nodecouple window on the hierarchical path (the
# passes at PM cadence, the BH pass on the tree plus the PM acceleration,
# the winds keyed by the PM step's first tick), held to the same run on one
# rank; "hier" is it without metal return, held to the JAX package's
# hierarchical run_sharded, whose metal return ghosts the rows by the next
# step's boundaries (ROADMAP.md section 3).
HIER = {"MaxWindFreeTravelTime": 0, "OutputPotential": 0,
        "SplitGravityTimestepsOn": 1}
STAR_MODES = {"nodecouple": {"MaxWindFreeTravelTime": 0,
                             "OutputPotential": 0},
              "decouple": {},
              "hier": dict(HIER, MetalReturnOn=0),
              "hiermetals": HIER}


STAR_MASS_TOL = 1e-6     # the total mass against the IC's, relative


def star_ic_mass():
    """The IC's total mass (float64)."""
    from mpgadget_tpu_torch.io import BigFile
    bf = BigFile(str(STAR_IC))
    return sum(float(bf.open(f"{t}/Mass").read().astype(np.float64).sum())
               for t in (0, 1, 5))


def star_paramtext(out, mode, tmax=STAR_TIME_MAX):
    text = STAR_PARAMS.format(ic=STAR_IC, out=out, tmax=tmax)
    for k, v in STAR_MODES[mode].items():
        text += f"\n{k} = {v}"
    return text


def star_final_state(sim):
    """gas_final_state with the subgrid columns: the gas's delay time,
    metallicity and metals, the stars' metals and returned mass, the BHs'
    columns (either package's host mirror)."""
    pd = sim.pdata
    v = _host(pd.valid)
    pt = _host(pd.ptype)[:, None]
    # each species column only on its own rows (the packages' host mirrors
    # fill the others differently)
    cols = {"delay_time": sim.sph.delay_time,
            "metallicity": sim.sph.metallicity,
            "gas_metals": np.where(pt == 0, _host(sim.sph.metals), 0.0),
            "star_metals": np.where(pt == 4, _host(sim.stars.metals), 0.0),
            "total_mass_returned": sim.stars.total_mass_returned,
            "bh_mass": sim.bh.bh_mass, "bh_mdot": sim.bh.mdot,
            "bh_density": sim.bh.bh_density, "bh_mtrack": sim.bh.mtrack,
            "bh_progs": sim.bh.count_progs}
    out = gas_final_state(sim)
    o = np.argsort(_host(pd.pid)[v], kind="stable")
    out.update({k: _host(c)[v][o] for k, c in cols.items()})
    return out


def star_outputs(sim, outdir):
    """What the star record keeps of one run: the final state by ID, the
    sfr.txt lines, and the blocks of the last snapshot and PIG."""
    out = {f"state/{k}": v for k, v in star_final_state(sim).items()}
    sfr = Path(outdir) / "sfr.txt"
    out["sfr_txt"] = np.array(sfr.read_text().split("\n")[:-1]
                              if sfr.exists() else [], dtype=str)
    for kind in ("PART", "PIG"):
        p = sorted(Path(outdir).glob(f"{kind}_*"))[-1]
        for k, v in bigfile_blocks(p, types=(0, 1, 4, 5)).items():
            out[f"{kind}/{k}"] = v
    return out


def star_run_cases(rank, size, outdir, modes):
    """Each star mode through the port's CLI body (main.run_cli, which runs
    the sharded driver on more than one rank) on this rank; rank 0 writes
    star_<mode>.npz: star_outputs, the counters, and after each step
    this rank's decoupled gas rows with their largest hydro force."""
    from mpgadget_tpu_torch.main import run_cli
    from mpgadget_tpu_torch.parallel import driver
    real_step = driver.sharded_step
    checks = []     # per step: decoupled gas rows, their largest |a_hydro|

    def step(st, *a, **k):
        new, stats = real_step(st, *a, **k)
        if new is not None and "delay_time" in new:
            dec = new["gas_mask"] & (new["delay_time"] > 0)
            acc = new["hydro_acc"][dec]
            checks.append((int(dec.sum()), float(acc.abs().max())
                           if acc.numel() else 0.0))
        return new, stats

    driver.sharded_step = step
    for mode in modes:
        checks.clear()
        out = os.path.join(outdir, mode)
        pf = os.path.join(outdir, f"{mode}.gadget")
        if rank == 0:
            os.makedirs(out, exist_ok=True)
            Path(pf).write_text(star_paramtext(out, mode))
        from mpgadget_tpu_torch.parallel import collectives as coll
        coll.barrier(_mesh())
        sim = run_cli(pf, device="cpu")
        if rank == 0:
            res = star_outputs(sim, out)
            res.update(wind_kicks=np.int64(sim.wind_kicks),
                       swallowed=np.int64(sim.bh_swallowed),
                       mergers=np.int64(sim.bh_mergers),
                       seeded=np.asarray(sim.bh_seeded, np.int64),
                       nsteps=np.int64(len(sim.sharded_log)),
                       substeps=np.asarray([e["substeps"]
                                            for e in sim.sharded_log]))
            res["decoupled_checks"] = np.asarray(checks, np.float64)
            np.savez(os.path.join(outdir, f"star_{mode}.npz"), **res)


# ---- the sharded options (QSO lightup, excursion set, planes, light cone,
# hybrid and massive neutrinos) --------------------------------------------

def _pkg(pkg, name):
    import importlib
    return importlib.import_module(f"{pkg}.{name}")


def _dev_kw(pkg):
    return {"device": "cpu"} if pkg.endswith("_torch") else {}


def option_units(pkg):
    U = _pkg(pkg, "utils")
    return U.get_unitsystem(U.constants.CM_PER_KPC, 1.989e43, 1e5)


def _simulation(pkg, pos, vel, mass, ptype, box, cp, cfg_kw, time_ic):
    """Either package's Simulation of the given rows (IDs from 1)."""
    run = _pkg(pkg, "run")
    pd = _pkg(pkg, "particles").ParticleData.from_numpy(
        pos, vel, mass, ptype, np.arange(len(pos)) + 1, box, **_dev_kw(pkg))
    return run.Simulation(cp, pd, run.SimConfig(boxsize=box, **cfg_kw),
                          time_ic=time_ic)


# tests/test_parallel.py's run_sharded light cone case: 10^3 DM in a 1
# Gpc/h box at z ~ 1.2, the horizon sweeping through the replicas
LC_BOX = 1.0e6


def lightcone_sim(pkg, outdir, hierarchical=False):
    rng = np.random.RandomState(5)
    ng = 10
    n = ng ** 3
    grid = (np.stack(np.meshgrid(*[np.arange(ng)] * 3),
                     axis=-1).reshape(-1, 3) + 0.5) / ng * LC_BOX
    pos = np.mod(grid + rng.uniform(-0.02, 0.02, (n, 3)) * LC_BOX, LC_BOX)
    vel = rng.randn(n, 3).astype(np.float64) * 100.0
    units = option_units(pkg)
    cp = _pkg(pkg, "cosmology").Cosmology(
        Omega0=0.3, OmegaLambda=0.7, HubbleParam=0.7, OmegaBaryon=0.05,
        TimeBegin=0.45).init_units(units)
    TL, TS = _pkg(pkg, "timeline"), _pkg(pkg, "timestep")
    kw = dict(nmesh=16, output_dir=str(outdir),
              timeline=TL.Timeline([0.48], TimeIC=0.45, TimeMax=0.48),
              units=units, hydro_on=False, tree_grav_on=True,
              random_particle_offset=0.0, lightcone_on=True,
              split_gravity_timesteps=hierarchical,
              timestep=TS.TimestepParams(MaxSizeTimestep=0.02))
    return _simulation(pkg, pos, vel, np.full(n, 10.0), np.ones(n, np.int32),
                       LC_BOX, cp, kw, 0.45)


def lightcone_rows(outdir):
    """Every stripe's rows (x, y, z, SampleFraction), stripe by stripe."""
    rows = [np.fromfile(f, np.float64).reshape(-1, 4) for f in sorted(
        Path(outdir).glob("lightcone/*/*.raw"))]
    return np.concatenate(rows) if rows else np.zeros((0, 4))


# tests/test_parallel.py's test_run_sharded_aux_physics case: one massive
# DM halo straddling a slab boundary, gas inside its future QSO bubble and
# background gas pushed out of it, stars in the halo; QSO lightup, the
# excursion set and lensing planes on one step from a = 0.1
AUX_BOX = 8000.0
AUX_R_BUB = 600.0
AUX_HALO = np.array([AUX_BOX / 2, AUX_BOX / 3, AUX_BOX / 3])


def write_heii_hist(path):
    """The case's HeII table, spanning the run's z ~ 9 epoch."""
    with open(path, "w") as fh:
        fh.write("1.7\n150.0\n")
        for z, x, lm in [(12.0, 0.0, 0.0), (10.0, 0.02, 1e-33),
                         (8.0, 0.6, 2e-33), (6.0, 0.999, 1e-33)]:
            fh.write(f"{z} {x} {lm}\n")


def aux_rows():
    rng = np.random.RandomState(11)
    box = AUX_BOX
    ng = 8
    n_bg = ng ** 3
    grid = (np.stack(np.meshgrid(*[np.arange(ng)] * 3),
                     axis=-1).reshape(-1, 3) + 0.5) / ng * box
    n_halo, n_in = 64, 48
    pos = np.concatenate([
        grid + rng.uniform(-40, 40, (n_bg, 3)),
        AUX_HALO + rng.randn(n_halo, 3) * 60.0,
        AUX_HALO + rng.randn(n_in, 3) * 0.3 * AUX_R_BUB / 3,
        grid + box / ng / 2 + rng.uniform(-40, 40, (n_bg, 3)),
        AUX_HALO + rng.randn(16, 3) * 50.0]) % box
    lo = n_bg + n_halo + n_in
    d_bg = pos[lo:lo + n_bg] - AUX_HALO
    d_bg -= np.round(d_bg / box) * box
    rr = np.sqrt((d_bg ** 2).sum(1))
    close = rr < 2.0 * AUX_R_BUB
    shift = np.where(close[:, None], 2.5 * AUX_R_BUB
                     * d_bg / np.maximum(rr, 1.0)[:, None], 0.0)
    pos[lo:lo + n_bg] = (pos[lo:lo + n_bg] + shift) % box
    ptype = np.concatenate([
        np.ones(n_bg + n_halo, np.int32), np.zeros(n_in, np.int32),
        np.zeros(n_bg, np.int32), np.full(16, 4, np.int32)])
    mass = np.where(ptype == 1, 50.0, np.where(ptype == 4, 10.0, 1.0))
    return pos, ptype, mass


def aux_sim(pkg, outdir, hist_path):
    pos, ptype, mass = aux_rows()
    n = len(pos)
    units = option_units(pkg)
    cp = _pkg(pkg, "cosmology").Cosmology(
        Omega0=0.3, OmegaLambda=0.7, HubbleParam=0.7, OmegaBaryon=0.05,
        TimeBegin=0.1).init_units(units)
    kw = dict(nmesh=16, output_dir=str(outdir),
              timeline=_pkg(pkg, "timeline").Timeline(
                  [0.102], TimeIC=0.1, TimeMax=0.102),
              units=units, hydro_on=True, tree_grav_on=True,
              cooling_on=True, random_particle_offset=0.0,
              qso_lightup_on=True, reion_hist_file=str(hist_path),
              qso_min_mass=1000.0, qso_max_mass=1e8,
              qso_mean_bubble=AUX_R_BUB, qso_var_bubble=0.0,
              excursion_set_on=True, excursion_set_zstart=12.0,
              excursion_set_zstop=5.0, uvbg_dim=32,
              reion_use_particle_sfr=False,
              reion_nion_phot_per_bary=10.0, reion_r_bubble_max=3000.0,
              plane_output_list="0.1", plane_resolution=64,
              fof_min_group_length=32)
    return _simulation(pkg, pos, np.zeros((n, 3)), mass, ptype, AUX_BOX, cp,
                       kw, 0.1)


# a small hybrid-neutrino run: 8^3 DM on a jittered lattice and 8^3 fast
# type-2 tracers, 64 Mpc/h, from a = 0.1 to 0.11 with NuPartTime 0.105, so
# that the tracers first neither source gravity nor feel the PM force and
# then do both
HYB_BOX = 64000.0
HYB_PART_TIME = 0.105


def hybrid_sim(pkg, outdir, hierarchical):
    rng = np.random.RandomState(23)
    ng = 8
    n = ng ** 3
    grid = (np.stack(np.meshgrid(*[np.arange(ng)] * 3),
                     axis=-1).reshape(-1, 3) + 0.5) / ng * HYB_BOX
    pos = np.concatenate([grid + rng.normal(0, 600.0, (n, 3)),
                          rng.uniform(0, HYB_BOX, (n, 3))]) % HYB_BOX
    vel = np.concatenate([rng.normal(0, 30.0, (n, 3)),
                          rng.normal(0, 600.0, (n, 3))])
    ptype = np.concatenate([np.ones(n, np.int32), np.full(n, 2, np.int32)])
    mass = np.where(ptype == 1, 30.0, 1.0)
    units = option_units(pkg)
    cp = _pkg(pkg, "cosmology").Cosmology(
        Omega0=0.3, OmegaLambda=0.7, HubbleParam=0.7, OmegaBaryon=0.05,
        MNu=(0.2, 0.2, 0.2), HybridNeutrinosOn=True,
        HybridNuPartTime=HYB_PART_TIME, TimeBegin=0.1).init_units(units)
    kw = dict(nmesh=16, output_dir=str(outdir),
              timeline=_pkg(pkg, "timeline").Timeline(
                  [0.11], TimeIC=0.1, TimeMax=0.11),
              units=units, hydro_on=False, tree_grav_on=True,
              random_particle_offset=0.0, hybrid_neutrinos_on=True,
              hybrid_nu_part_time=HYB_PART_TIME,
              split_gravity_timesteps=hierarchical,
              timestep=_pkg(pkg, "timestep").TimestepParams(
                  MaxSizeTimestep=0.01))
    return _simulation(pkg, pos, vel, mass, ptype, HYB_BOX, cp, kw, 0.1)


def nu_table():
    """A neutrino linear-response table (logk, fac), float32: 1 + 5% of a
    smooth bump over the box's modes."""
    logk = np.linspace(np.log(2 * np.pi / BOX * 0.5),
                       np.log(2 * np.pi / BOX * NMESH_PM), 24)
    fac = 1.0 + 0.05 * np.sin(np.linspace(0.0, 3.0, 24))
    return logk.astype(np.float32), fac.astype(np.float32)


LC_TIMES = (0.452, 0.46)   # the module case's shell: set_time at each


def lightcone_module_inputs():
    """lightcone_sim's rows with ids, in box units of LC_BOX."""
    rng = np.random.RandomState(5)
    ng = 10
    n = ng ** 3
    grid = (np.stack(np.meshgrid(*[np.arange(ng)] * 3),
                     axis=-1).reshape(-1, 3) + 0.5) / ng
    x = np.mod(grid + rng.uniform(-0.02, 0.02, (n, 3)), 1.0)
    return dict(ipos=(x * 2.0 ** 32).astype(np.uint32),
                vel=(rng.randn(n, 3) * 100.0).astype(np.float32),
                pid=np.arange(1, n + 1),
                ptype=np.where(np.arange(n) % 7 == 3, 2, 1).astype(np.int32))


def lightcone_shell(pkg, outdir):
    """(Lightcone after LC_TIMES, its replicas, ddrift) of either
    package (the distance tables are the same numpy code)."""
    units = option_units(pkg)
    cp = _pkg(pkg, "cosmology").Cosmology(
        Omega0=0.3, OmegaLambda=0.7, HubbleParam=0.7, OmegaBaryon=0.05,
        TimeBegin=0.45).init_units(units)
    lc = _pkg(pkg, "physics.lightcone").Lightcone(
        cp, 0.45, units.UnitVelocity_in_cm_per_s, str(outdir), LC_BOX)
    for a in LC_TIMES:
        lc.set_time(a)
    return lc, lc.replicas(), 0.05


PLANE_ATIME = 0.4
PLANE_BOX = 200000.0


def plane_sim(pkg, ipos, outdir, mesh_rows=None):
    """A stand-in of the Simulation that write_planes reads: box, units,
    cosmology, a, output directory, and for the host path the rows."""
    from types import SimpleNamespace
    units = option_units(pkg)
    cp = _pkg(pkg, "cosmology").Cosmology(
        Omega0=0.3, OmegaLambda=0.7, HubbleParam=0.7, OmegaBaryon=0.05,
        TimeBegin=0.1).init_units(units)
    n = len(ipos)
    if pkg.endswith("_torch"):
        ip = torch.as_tensor(np.asarray(ipos).astype(np.int64))
        pdata = SimpleNamespace(valid=torch.ones(n, dtype=torch.bool),
                                num_valid=n, ipos=ip)
    else:
        import jax.numpy as jnp
        pdata = SimpleNamespace(valid=jnp.ones(n, bool), num_valid=n,
                                ipos=jnp.asarray(ipos))
    sim = SimpleNamespace(
        cfg=SimpleNamespace(boxsize=PLANE_BOX, units=units,
                            output_dir=str(outdir)),
        CP=cp, atime=PLANE_ATIME, pdata=pdata,
        _ipos_offset=np.zeros(3, np.uint32))
    sim._unshifted_ipos = lambda: pdata.ipos
    return sim


def plane_params(pkg):
    return _pkg(pkg, "physics.plane").PlaneParams(
        output_times=[PLANE_ATIME], resolution=64,
        thickness=PLANE_BOX / 4, normals=[0, 1, 2])


QSO_CAT = {"masses": np.array([5000.0, 50.0, 3000.0, 2.0e4, 1500.0]),
           "cm": np.array([AUX_HALO, [100.0, 7900.0, 4000.0],
                           [6000.0, 1000.0, 7000.0],
                           [2000.0, 5000.0, 600.0],
                           [7800.0, 7800.0, 7800.0]])}
QSO_ATIME = 0.1
QSO_PARAMS = dict(min_mass=1000.0, max_mass=1e8, mean_bubble=AUX_R_BUB,
                  var_bubble=200.0 ** 2, finish_frac=0.995)


def qso_inputs():
    """aux_rows with a density and entropy per row (float32), in ID
    order."""
    pos, ptype, mass = aux_rows()
    rng = np.random.RandomState(12)
    n = len(pos)
    return dict(ipos=(pos / AUX_BOX * 2.0 ** 32).astype(np.uint32),
                gas=ptype == 0, ionized=np.zeros(n, bool),
                density=(1e-8 * (1 + rng.rand(n))).astype(np.float32),
                entropy=(1e3 * (1 + rng.rand(n))).astype(np.float32),
                mass=mass.astype(np.float32), ptype=ptype,
                pid=np.arange(1, n + 1))


def uvbg_case(pkg):
    """(UVBGParams, Cosmology, units, per-row fesc and sfr) of the module
    case: aux_sim's excursion set, the halo rows' escape fraction from
    a halo mass of 5000."""
    U = _pkg(pkg, "physics.uvbg")
    units = option_units(pkg)
    cp = _pkg(pkg, "cosmology").Cosmology(
        Omega0=0.3, OmegaLambda=0.7, HubbleParam=0.7, OmegaBaryon=0.05,
        TimeBegin=0.1).init_units(units)
    par = U.UVBGParams(uvbg_dim=32, r_bubble_max=3000.0, r_bubble_min=406.8,
                       delta_r_factor=1.1, nion_phot_per_bary=10.0,
                       alpha_uv=3.0, escape_frac_norm=0.2,
                       escape_frac_scaling=0.5, zstart=12.0, zstop=5.0,
                       use_particle_sfr=True)
    d = qso_inputs()
    x = d["ipos"].astype(np.float64) / 2.0 ** 32 * AUX_BOX - AUX_HALO
    x -= np.round(x / AUX_BOX) * AUX_BOX
    near = np.sqrt((x ** 2).sum(1)) < 300.0
    halo_mass = np.where(near, 5000.0, 0.0).astype(np.float32)
    sfr = np.where(d["gas"] & near, 1e-2, 0.0).astype(np.float32)
    return par, cp, units, halo_mass, sfr


def option_module_cases(rank, size, outdir):
    """The sharded options' modules of tests/test_torch_sharded_options.py
    on this rank; writes outdir/opt_r<rank>.npz: the PM with the neutrino
    table and the power bins, the sharded measure_power, the light cone's
    crossers per replica, the planes (rank 0 also writes the host path's),
    the QSO bubbles and the excursion set's grids and readout."""
    from mpgadget_tpu_torch.parallel import decomp
    from mpgadget_tpu_torch.parallel.driver import (measure_power_multi,
                                                    pm_force_multi)
    from mpgadget_tpu_torch.parallel.mesh import shard_particles
    from mpgadget_tpu_torch.physics import qso_lightup as qmod
    from mpgadget_tpu_torch.physics import uvbg as umod
    from mpgadget_tpu_torch.physics.lightcone import rank_crossers
    from mpgadget_tpu_torch.physics.plane import write_planes
    mesh = _mesh()
    S = size
    out = {}

    def rows(d, keys):
        n = len(d["pid"])
        return shard_particles(_cols(d, keys), np.ones(n, bool), mesh,
                               n // S)

    # ---- PM with the neutrino table and the power bins (balanced rows) ----
    d = module_inputs()
    st0 = shard_particles(_cols(d, ("ipos", "pid", "mass")),
                          np.ones(N, bool), mesh, n_local_of(S))
    hist = decomp.count_histogram(st0["ipos"], mesh).numpy()
    bounds = decomp.balanced_boundaries(hist, S)
    st, _ = decomp.exchange_to_slabs(dict(st0), st0["ipos"], mesh, bounds)
    logk, fac = (torch.as_tensor(a) for a in nu_table())
    acc, _, pk = pm_force_multi(st["ipos"], st["mass"], NMESH_PM, BOX, G,
                                ASMTH, mesh, nu_logk=logk, nu_fac=fac,
                                nbins=NMESH_PM)
    out["pm_pid"] = st["pid"].numpy()
    out["pm_acc"] = acc.numpy()
    for k, v in zip(("p", "n", "k", "norm"), pk):
        out[f"pm_pk_{k}"] = np.asarray(v)
    for k, v in zip(("p", "n", "k", "norm"), measure_power_multi(
            st["ipos"], st["mass"], NMESH_PM, mesh, NMESH_PM)):
        out[f"mp_{k}"] = np.asarray(v)

    # ---- the light cone's crossers of this rank's rows, per replica ----
    d = lightcone_module_inputs()
    st = rows(d, d.keys())
    lc, reps, ddrift = lightcone_shell("mpgadget_tpu_torch",
                                       os.path.join(outdir, f"lc{rank}"))
    out["lc_nrep"] = np.int64(len(reps))
    for i, rep in enumerate(reps):
        out[f"lc_rows_{i}"] = rank_crossers(
            st["ipos"], st["vel"], st["ptype"], st["pid"], (0, 0, 0),
            LC_BOX, rep, ddrift, lc.hd_prev2, lc.hd2, lc.hd_prev, lc.hd,
            lc.sample_fraction)

    # ---- planes: this rank's rows (module_inputs), counts summed ----
    d = module_inputs()
    st = rows(d, ("ipos", "pid"))
    pdir = os.path.join(outdir, "planes")
    if rank == 0:
        os.makedirs(pdir + "/host", exist_ok=True)
        os.makedirs(pdir + "/sharded", exist_ok=True)
        # the host path, every row on this rank alone
        write_planes(plane_sim("mpgadget_tpu_torch", d["ipos"],
                               pdir + "/host"), 0,
                     plane_params("mpgadget_tpu_torch"))
    from mpgadget_tpu_torch.parallel import collectives as coll
    coll.barrier(mesh)
    write_planes(plane_sim("mpgadget_tpu_torch", d["ipos"],
                           pdir + "/sharded"), 0,
                 plane_params("mpgadget_tpu_torch"), ipos=st["ipos"],
                 weights=torch.ones(st["ipos"].shape[0]), n_tot=N,
                 write=rank == 0, mesh=mesh)

    # ---- QSO bubbles over ranks ----
    d = qso_inputs()
    st = rows(d, d.keys())
    hist_path = os.path.join(outdir, f"heii{rank}.txt")
    write_heii_hist(hist_path)
    hist = qmod.load_heii_reion_hist(hist_path)
    par = qmod.QSOParams(heiii_start=hist.zstart, **QSO_PARAMS).with_units(
        option_units("mpgadget_tpu_torch").UnitInternalEnergy_in_cgs)
    qdir = os.path.join(outdir, "qso")
    os.makedirs(qdir, exist_ok=True)
    ion, ent, nbub = qmod.place_bubbles(
        st["ipos"], st["gas"], st["ionized"], st["density"], st["entropy"],
        QSO_CAT, hist, par, QSO_ATIME, AUX_BOX, 42, qdir, write=rank == 0,
        mesh=mesh)
    out["qso_pid"] = st["pid"].numpy()
    out["qso_ionized"] = ion.numpy()
    out["qso_entropy"] = ent.numpy()
    out["qso_nbub"] = np.int64(nbub)

    # ---- the excursion set over ranks ----
    par, cp, units, halo_mass, sfr = uvbg_case("mpgadget_tpu_torch")
    d.update(halo_mass=halo_mass, sfr=sfr)
    st = rows(d, d.keys())
    fesc = umod.escape_fractions(st["halo_mass"], par.escape_frac_norm,
                                 par.escape_frac_scaling,
                                 units.UnitMass_in_g, cp.HubbleParam)
    res = umod.calculate_uvbg(
        st["ipos"], st["mass"], torch.ones_like(st["gas"]), st["gas"],
        st["ptype"] == 4, st["sfr"], fesc, par, cp, units, AUX_BOX, 0.1,
        mesh=mesh)
    j21_p = umod.readout_j21_max(res["j21"], st["ipos"])
    out["uvbg_j21"] = res["j21"].numpy()
    out["uvbg_xhi"] = res["xhi"].numpy()
    out["uvbg_vol"] = np.float64(res["volume_weighted_global_xHI"])
    out["uvbg_mass"] = np.float64(res["mass_weighted_global_xHI"])
    out["uvbg_pid"] = st["pid"].numpy()
    out["uvbg_j21_rows"] = j21_p.numpy()
    np.savez(os.path.join(outdir, f"opt_r{rank}.npz"), **out)


# a small massive-neutrino run: the parity IC (24^3, Nmesh 48) with one
# massive species, hierarchical, no random box shift (RandomParticleOffset
# 0, so that the single-device loop's PM force sees the rows where the
# sharded run's does), to NU_TIME_MAX with a snapshot there
NU_TIME_MAX = 0.115
NU_EXTRA = """
MassiveNuLinRespOn = 1
MNue = 0.2
RandomParticleOffset = 0
"""


def nu_paramtext(out):
    return run_paramtext(PARITY_IC, out, extra=NU_EXTRA).replace(
        f"OutputList = {RUN_OUTPUTS}", f"OutputList = {NU_TIME_MAX}").replace(
        f"TimeMax = {RUN_TMAX}", f"TimeMax = {NU_TIME_MAX}")


def powerspectra(outdir):
    """Every powerspectrum file of a run, in a order: {a: (k, P)}."""
    out = {}
    for f in sorted(Path(outdir).glob("powerspectrum-*.txt")):
        rows = np.loadtxt(f, ndmin=2)
        out[float(f.stem.split("-", 1)[1])] = (rows[:, 0], rows[:, 1])
    return out


def nu_outputs(sim, outdir):
    """What the neutrino record keeps of a run (either package): each
    step's P(k) and the delta_tot history."""
    out = {}
    for i, (a, (k, p)) in enumerate(sorted(powerspectra(outdir).items())):
        out[f"pk{i}_a"] = np.float64(a)
        out[f"pk{i}_k"], out[f"pk{i}_p"] = k, p
    st = sim._nu_table_state.state_dict()
    out["scalefact"] = np.asarray(st["scalefact"])
    out["delta_tot"] = np.asarray(st["delta_tot"])
    return out


def hybrid_state(sim):
    """The final rows of a hybrid run by ID (either package)."""
    pd = sim.pdata
    v = _host(pd.valid)
    cols = {k: _host(getattr(pd, k))[v] for k in ("pid", "ipos", "vel",
                                                 "ptype")}
    o = np.argsort(cols["pid"])
    out = {k: c[o] for k, c in cols.items()}
    out["ipos"] = out["ipos"].astype(np.int64)
    out["atime"] = np.float64(sim.atime)
    return out


def aux_outputs(sim, outdir):
    """What the aux record keeps of a run (either package): the ionized
    and reionized IDs, J21 by ID, helium.txt, the planes."""
    from mpgadget_tpu_torch.io.fits import read_fits_image
    pd = sim.pdata
    v = _host(pd.valid)
    pid = _host(pd.pid)[v]
    o = np.argsort(pid)
    gas = (_host(pd.ptype)[v] == 0)[o]
    out = {"pid": pid[o], "gas": gas,
           "ionized": (_host(sim.sph.he_iii_ionized)[v] > 0)[o],
           "j21": _host(sim.sph.local_j21)[v][o],
           "zreion": _host(sim.sph.zreion)[v][o],
           "helium": np.array((Path(outdir) / "helium.txt").read_text()
                              .splitlines(), dtype=str)}
    for f in sorted(Path(outdir).glob("snap0_*.fits")):
        out[f"plane_{f.stem}"] = np.asarray(read_fits_image(str(f))[0],
                                            np.float64)
    return out


OPTION_RUNS = ("lc", "aux", "hyb_global", "hyb_hier", "nu")


def option_run_cases(rank, size, outdir, cases):
    """run_sharded of each option run on this rank; rank 0 writes
    run_<case>.npz.  The hybrid runs record, at every PM refresh of each
    rank (the hierarchical run's), a, whether the tracers were passive
    then and the largest PM acceleration of its type-2 rows
    (tracer_pm_<case>_r<rank>.npy)."""
    from mpgadget_tpu_torch.main import build_simulation
    from mpgadget_tpu_torch.params import create_gadget_parameter_set
    from mpgadget_tpu_torch.parallel import collectives as coll
    from mpgadget_tpu_torch.parallel import driver
    mesh = _mesh()
    seen = []
    real_refresh = driver.pm_refresh

    def refresh(st, mesh, scal, **kw):
        upd, stats = real_refresh(st, mesh, scal, **kw)
        t2 = st["ptype"] == 2
        seen.append((float(scal["atime"]), bool(scal.get("nu_tracer")),
                     float(upd["pm_acc"][t2].abs().max()) if t2.any()
                     else 0.0))
        return upd, stats

    driver.pm_refresh = refresh
    for case in cases:
        out = os.path.join(outdir, case)
        seen.clear()
        if case == "lc":
            sim = lightcone_sim("mpgadget_tpu_torch", out)
        elif case == "aux":
            if rank == 0:
                os.makedirs(out, exist_ok=True)
                write_heii_hist(os.path.join(outdir, "heii.txt"))
            coll.barrier(mesh)
            sim = aux_sim("mpgadget_tpu_torch", out,
                          os.path.join(outdir, "heii.txt"))
        elif case.startswith("hyb"):
            sim = hybrid_sim("mpgadget_tpu_torch", out, case == "hyb_hier")
        else:
            ps = create_gadget_parameter_set()
            ps.parse_string(nu_paramtext(out))
            sim = build_simulation(ps, device="cpu")[0]
        hier = bool(sim.cfg.split_gravity_timesteps)
        sim.run_sharded(mesh, hierarchical=hier, verbose=False,
                        max_steps=1 if case == "aux" else None)
        if case.startswith("hyb"):
            np.save(os.path.join(outdir, f"tracer_pm_{case}_r{rank}.npy"),
                    np.asarray(seen, np.float64))
        if rank != 0:
            continue
        if case == "lc":
            res = {"rows": lightcone_rows(out)}
        elif case == "aux":
            res = aux_outputs(sim, out)
            # the planes' host path on the final rows (the host mirror),
            # the state they were written from
            from mpgadget_tpu_torch.physics.plane import write_planes
            sim.cfg.output_dir = os.path.join(out, "host")
            os.makedirs(sim.cfg.output_dir)
            write_planes(sim, 0, sim._plane_params)
            sim.cfg.output_dir = out
        elif case.startswith("hyb"):
            res = hybrid_state(sim)
        else:
            res = nu_outputs(sim, out)
        res["nsteps"] = np.int64(len(sim.sharded_log))
        np.savez(os.path.join(outdir, f"run_{case}.npz"), **res)
    driver.pm_refresh = real_refresh
