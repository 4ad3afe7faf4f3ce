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
