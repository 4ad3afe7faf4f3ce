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
    gas_<mode>.npz: gas_outputs, and the sharded log)."""
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
