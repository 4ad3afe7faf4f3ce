#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mpgadget_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card; it
takes no arguments and imports nothing of JAX.  Phases, each of which
fails the run (non-zero exit, no result line) if it fails:

1. the card: CUDA must be available; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles the five kernels, the pair kernel K1
   (csrc/pairkernel.cu), the walk kernel K2 (csrc/treewalk.cu), the
   neighbour walk K3 (csrc/neighbors.cu) and the SPH pair sums K4
   (csrc/sph_density.cu) and K5 (csrc/sph_hydro.cu), and the five
   measurement aids (the serial walks K2 and K3 began as, the first
   designs of K4 and K5, and an L2 pointer chase), one nvcc each, in
   parallel;
3. K1: the pair kernel against its plain PyTorch version on the card at
   the main path's shapes (nb=1024 blocks, G=256 targets, S=4096
   sources), with and without potential, on inputs from a seed, once
   over every slot and once with per-block source counts (one block
   filled to S, one empty, random counts between); tolerance 1e-4 of
   max |result|;
4. L2: one L2 round trip, timed by a pointer chase (csrc/l2chase.cu,
   built with the kernels and loaded only here: the latency of each
   load in the walk's chain of dependent loads);
5. K2: the walk kernel against its plain version on the card, on the
   dm-small lattice IC's first tree (BH opening, 512 leaves per block),
   at a retry-grown leaf list (relative opening, 4096 leaves, with
   potential), on 64^3 particles in eight clusters (BH, 512 leaves,
   with potential), where monopoles do most of the work (the lattice
   applies none), and on the lattice moved by the box shift of the
   slice's second step (relative opening), where blocks that straddle a
   jump of the Z curve open thousands of leaves, at 512 leaves (they
   overflow) and at the 8192 the retries reach: the same leaf lists,
   leaf counts, overflow flags and visit counts, acc and pot within 1e-5
   by norm.  In every case a second launch must give the same bits, and
   the serial walk the port began with (csrc/treewalk_serial.cu, loaded
   only here) is timed beside the kernel and must give the same bits
   too;
6. accuracy: the tree force on the card (walk + pair kernels) against
   direct pairwise summation, 4096 particles, as the repo's tree tests do;
7. slice: the examples/dm-small configuration at full width (64^3 DM
   particles, Nmesh 128, BoxSize 64000 kpc/h, z=9) with
   SplitGravityTimestepsOn=0 and SnapshotWithFOF=0, on a seeded lattice
   IC: build_simulation -> Simulation.run(max_steps=3) ->
   write_snapshot, with both kernels' launch counts read around it; then
   phase 3 again at the slice's final S if overflow retries grew it;
8. compaction: the tree force on 64^3 clustered particles with a seeded
   20% of the targets active (half the targets of a seeded 40% of the
   blocks), walked over exactly the active blocks, against the same force
   with every block walked: the same bits on active rows; and both
   kernels against their plain versions at those compacted shapes, to
   the tolerances of phases 3 and 5;
9. genic: examples/dm-small/paramfile.genic through the port's CLI,
   python -m mpgadget_tpu_torch.genic.main (Ngrid 64, Nmesh 128, Seed
   181170, z=9, UnitaryAmplitude) with the
   Eisenstein-Hu spectrum in place of the absent class_pk_9.dat
   (WhichSpectrum 1, Sigma8 0.8, InputPowerRedshift 0): header, IDs and
   masses, and the IC's P(k) at Nmesh 128 keeps the linear spectrum's
   shape over its 6 lowest-k bins to rtol 0.1 (examples/dm-small/
   check_results.py:62-75);
10. hierarchical dm-small: build_simulation on examples/dm-small/
   paramfile.gadget as it ships (SplitGravityTimestepsOn 1,
   SnapshotWithFOF 1), from that IC -> Simulation.run() to a = 0.25
   (HIER_STEPS), which writes a snapshot and a FOF catalogue (PIG) at
   each output, -> write_snapshot, the launch counts reset just before
   and read just after; per PM step its seconds, substeps, bin histogram
   and active targets per evaluation; finite state, no particle lost, the
   snapshot read back, the growth of P(k) between the first and last
   outputs equal to D1^2 to rtol 0.18 (check_results.py:76-81); each PIG
   read back and consistent (group rows, lengths >= FOFHaloMinLength,
   grouped particles per type with sorted GroupIDs), its halos per
   log10 mass bin, halos in the last one, and check_hmf's 9e12 Msun
   printed as met or not (not enforced: EH spectrum, the port's own
   realisation);
11. FOF of the final state: Simulation.run_fof from a cold leaf-list
   cache, K3's launch count reset just before and read just after, with
   the seconds of each stage and min-label round; the labels held to
   scipy's connected components (cKDTree with boxsize, positions in f64
   from the fixed point): every component at ll(1-1e-5) inside one port
   group, every port group inside one component at ll(1+1e-5);
12. K3: the neighbour walk against its plain version on the card, on the
   final state's FOF inputs (asymmetric, at the LL the FOF reached) and
   on 64^3 clustered particles (symmetric, a seeded hmax, LL 16, which
   some groups overflow): the same leaf lists, counts, flags and visits,
   two launches and the serial walk K3 began as (csrc/neighbors_serial.cu,
   loaded only here) bit-identical, device times of both by CUDA graph
   replays, each with its critical path; then the clustered set with a
   stack of one entry, so that K3's serial mode walks every group, held
   to the plain version too;
13. RestartFlag 3: python -m mpgadget_tpu_torch.main paramfile.gadget 3
   <the last snapshot>, whose PIG must read back and pass the checks of
   phase 10;
14. star-small without its subgrid physics: examples/star-small/
   paramfile.genic through the genic CLI with the Eisenstein-Hu cut of
   phase 9 (Ngrid 32: 32^3 gas + 32^3 DM, BoxSize 5000 kpc/h, z=9), then
   its paramfile.gadget as it ships (hierarchical, SnapshotWithFOF,
   DensityIndependentSphOn, Nmesh 64) but for CoolingOn, StarformationOn,
   BlackHoleOn, WindOn and MetalReturnOn, all 0 (GAS_SWITCHES_OFF) ->
   Simulation.run() to a = 0.2 -> write_snapshot, the five kernels'
   launch counts reset just before and read just after: every density
   solve's targets within DesNumNgb +- MaxNumNgbDeviation (or the count
   that hit max_iter, and a failure), every hydro call's momentum
   (|sum m a| / sum m |a| < 1e-4), the IC's volume-weighted SPH density
   against Omega_b rho_crit (IC_RHO_TOL), the entropy floor, the growth
   of P(k) against D1^2 at k <= GAS_PK_KMAX (rtol 0.18), each
   snapshot's Density,
   SmoothingLength, InternalEnergy and EgyWtDensity and each PIG read
   back, and RestartFlag 3 through the CLI on the last gas snapshot;
15. K4 and K5 against their plain versions on the card, on the inputs
   of the run's own calls (K4: the first pass of the last density solve
   that targets every gas particle; K5: the last hydro call), and on a
   bigger IC, examples/dm-small/paramfile.genic with ProduceGas 1 (2 x
   64^3): every output within 1e-5 by norm (maxsig bit for bit, -inf at
   the same rows), two launches bit-identical, device times of both,
   the pairs each evaluates and counts, and the bound; beside them the
   first designs of K4 and K5 (csrc/sph_density_simple.cu,
   csrc/sph_hydro_simple.cu, loaded only here), held to the same
   tolerances and timed on the same inputs, and both designs' critical
   paths.

Bounds ("bound_ms") are the larger of bytes over the card's memory rate
(3.35 TB/s) and FP32 operations over its FP32 peak (67 TFLOP/s, an FMA
counted as 2), for the work these inputs need: padding is not work, a
pair beyond rcut needs only its distance, and the walk reads each node
of the tree once (revisits hit L2).  Beside the walk's bound stands its
critical path, the longest chain of loads of which each needs the one
before, times one L2 round trip: the kernel's (the longest block's sum
of each round's longest sibling chain; for K3 the longest group's
rounds) and a serial walk's (the longest block's or group's visits);
for K4 and K5 the longest group's chain of dependent loads in each
design (sph_critical_paths).
K3's bound is the node rows read once, the groups read and the leaf
lists written, against NEIGHBOR_OPS per visit; beside it stands the
walk's own bound, which counts only the listed leaves written and not
the fill of the lists' unused slots.  K4's and K5's are the particle
tables read once and each target's row written once, against
DENSITY_PAIR_OPS / HYDRO_PAIR_OPS for each pair that counts and the
distance's operations for each other pair the lists hold.

The last two lines of standard output are the kernel table and the
result, each one JSON object.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
NGRID = 64            # dm-small: 64^3 particles
NMESH = 128           # dm-small: Nmesh 128
BOXSIZE = 64000.0     # kpc/h
A_START = 0.1         # z = 9
HIER_STEPS = None     # PM steps of the hierarchical dm-small run (None:
#                       the whole run to its TimeMax, a = 0.25)
KERNEL_TOL = 1e-4     # max |kernel - plain| / max |plain|
WALK_TOL = 1e-5       # |kernel - plain| / |plain| by norm (acc, pot)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate
FP32_OPS_PER_S = 67e12      # H100 SXM FP32 peak outside the tensor cores
# FP32 operations per source-target pair (an FMA counted as 2), counted
# from csrc/shortrange.cuh and the K1 loop: wrap 9, r2 5, rsqrt and r 3,
# u and -u^2 2, exp 2, erfcx fit 26, windows 3, softening 5, cut 2, sums 6
PAIR_OPS = {False: 64, True: 72}     # with_potential -> ops
DISTANCE_OPS = 15        # a pair beyond rcut: wrap 9, r2 5, the cut 1
MONOPOLE_OPS = {False: 64, True: 70}  # the walk keeps r = 0 in the pot
WALK_DECISION_OPS = 44   # per visit: wrap and |d| 12, dmin 10, r2min 5,
#                          criteria 11, inside 7 (csrc/treewalk.cu)
WALK_ROW_BYTES = 36      # per node: two float4 rows and one int
# K3 per visit (csrc/neighbors.cu): wrap and |d| 12, half length 1, dmin 9,
# r2min 5, reach^2 and the test 2, and the max with hmax when symmetric
NEIGHBOR_OPS = {False: 29, True: 30}
NEIGHBOR_ROW_BYTES = {False: 20, True: 24}   # float4 row, int meta, hmax
NEIGHBOR_GROUP_BYTES = 36    # per group read: node, center, half, radius
HMF_MSUN = 9e12   # check_hmf: the largest halo (check_results.py:104-115)

PARAMS = """
InitCondFile = {ic}
OutputDir = {out}
OutputList = 0.15,0.2,0.25
TimeMax = 0.25
TimeLimitCPU = 3600
Omega0 = 0.288
OmegaLambda = 0.712
OmegaBaryon = 0.0472
HubbleParam = 0.7
MassiveNuLinRespOn = 0
HydroOn = 0
CoolingOn = 0
StarformationOn = 0
DensityIndependentSphOn = 0
SnapshotWithFOF = 0
SplitGravityTimestepsOn = 0
PartAllocFactor = 2.0
BlackHoleOn = 0
MetalReturnOn = 0
WindOn = 0
Nmesh = {nmesh}
"""


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound(ops, nbytes):
    """(bound_ms, bound_by) for the given FP32 operations and bytes."""
    t_ops = ops / FP32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pair_bound(nb, G, sources, with_potential, within=None):
    """K1's bound for `sources` real sources in all (padding excluded), of
    which `within` (source, target) pairs are closer than rcut and need
    the pair terms; the others need only their distance.  within=None:
    every pair at the full cost."""
    pairs = G * sources
    within = pairs if within is None else within
    ops = (within * PAIR_OPS[with_potential]
           + (pairs - within) * DISTANCE_OPS)
    # targets, sources (x, y, z, m), acc0 + pot0 read; acc + pot written
    nbytes = 4 * (3 * nb * G + 4 * sources + 4 * nb * G + 4 * nb * G + nb)
    return bound(ops, nbytes)


def walk_bound(nb, G, LL, nodes, visits, monopoles, with_potential):
    """K2's bound for `visits` node visits over a tree of `nodes` nodes,
    of which `monopoles` applied a monopole to the G targets of their
    block."""
    ops = (visits * WALK_DECISION_OPS
           + monopoles * G * MONOPOLE_OPS[with_potential])
    # each node row read once (at most the visits); targets, block boxes,
    # aold, active read; acc, pot, leaf lists, leaf counts, flags, visit
    # and monopole counts written
    nbytes = (min(nodes, visits) * WALK_ROW_BYTES + nb * G * 12 + nb * 29
              + nb * G * 16 + nb * LL * 8 + nb * 17)
    return bound(ops, nbytes)


def neighbor_bound(ng, LL, nodes, visits, symmetric, listed=None):
    """K3's bound for `visits` node visits of ng groups over a tree of
    `nodes` nodes: each node row read once (at most the visits), the
    groups read, and the leaf lists (ng x LL int32), counts, flags and
    visit counts written.  listed: count only that many list entries
    written, the leaves the walk records, without the fill of the unused
    slots (the walk's own bound)."""
    ops = visits * NEIGHBOR_OPS[symmetric]
    written = ng * LL if listed is None else listed
    nbytes = (min(nodes, visits) * NEIGHBOR_ROW_BYTES[symmetric]
              + ng * NEIGHBOR_GROUP_BYTES + written * 4 + ng * 9)
    return bound(ops, nbytes)


def rel_norm(a, ref):
    """|a - ref| / |ref| by norm (0 where both are zero)."""
    import torch
    return float(torch.linalg.norm(a - ref)
                 / max(float(torch.linalg.norm(ref)), 1e-30))


def write_lattice_ic(path, ngrid, seed=4242):
    """A 64^3-style DM IC: a lattice displaced by up to 0.3 cell (seeded),
    zero velocity, at a = 0.1, in the dm-small cosmology and box."""
    import numpy as np
    from mpgadget_tpu_torch.cosmology import Cosmology
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.utils import get_unitsystem
    from mpgadget_tpu_torch.utils.constants import CM_PER_KPC

    units = get_unitsystem(CM_PER_KPC, 1.989e43, 1e5)
    cp = Cosmology(Omega0=0.288, OmegaBaryon=0.0472, OmegaLambda=0.712,
                   HubbleParam=0.7, TimeBegin=A_START).init_units(units)
    cell = BOXSIZE / ngrid
    g = (np.arange(ngrid) + 0.5) * cell
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.RandomState(seed)
    pos = np.mod(pos + rng.uniform(-0.3, 0.3, pos.shape) * cell, BOXSIZE)
    n = len(pos)
    mass = cp.Omega0 * cp.RhoCrit * BOXSIZE ** 3 / n
    bf = BigFile(path, create=True)
    snap_io.write_species(bf, 1, pos=pos, vel=np.zeros((n, 3)),
                          pid=np.arange(1, n + 1), atime=A_START)
    masstable = np.zeros(6)
    masstable[1] = mass
    ntot = np.zeros(6, np.uint64)
    ntot[1] = n
    hubble = cp.hubble_function(A_START)
    snap_io.write_header(bf, snap_io.SnapshotHeader(
        TotNumPart=ntot, MassTable=masstable, Time=A_START, TimeIC=A_START,
        BoxSize=BOXSIZE, Omega0=cp.Omega0, OmegaLambda=cp.OmegaLambda,
        HubbleParam=cp.HubbleParam, OmegaBaryon=cp.OmegaBaryon,
        CMBTemperature=cp.CMBTemperature, RSDFactor=1.0 / (A_START * hubble)))
    return path


def build_sim(workdir, device, ngrid=NGRID, nmesh=NMESH):
    """build_simulation on the lattice IC with the dm-small parameters;
    returns (sim, output directory)."""
    from mpgadget_tpu_torch.main import build_simulation
    from mpgadget_tpu_torch.params import create_gadget_parameter_set

    ic = write_lattice_ic(os.path.join(workdir, "IC"), ngrid)
    out = os.path.join(workdir, "output")
    ps = create_gadget_parameter_set()
    ps.parse_string(PARAMS.format(ic=ic, out=out, nmesh=nmesh))
    ps.validate()
    sim, _ = build_simulation(ps, device=device)
    return sim, out


def time_ms(fn, reps):
    """Mean milliseconds per call on the card (CUDA events; one call
    first to warm up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps):
    """Mean milliseconds of the device work of one call of fn: the call
    is captured once in a CUDA graph and the graph replayed, so that the
    host's time to enqueue it (allocations, launches) does not count.  fn
    must not synchronise."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                        # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps)


def pairs_within(tx, ty, tz, sx, sy, sz, count, rcut, batch=64, chunk=512):
    """Number of (target, real source) pairs closer than rcut."""
    import torch

    def wrap(d):
        return d - torch.round(d)

    nb, S = sx.shape
    slot = torch.arange(S, device=sx.device)
    n = 0
    for b0 in range(0, nb, batch):
        bs = slice(b0, b0 + batch)
        for c0 in range(0, S, chunk):
            cs = slice(c0, c0 + chunk)
            dx = wrap(sx[bs, None, cs] - tx[bs, :, None])
            dy = wrap(sy[bs, None, cs] - ty[bs, :, None])
            dz = wrap(sz[bs, None, cs] - tz[bs, :, None])
            near = torch.sqrt(dx * dx + dy * dy + dz * dz) < rcut
            real = slot[None, cs] < count[bs, None]
            n += int((near & real[:, None, :]).sum())
    return n


def kernel_phase(nb, G, S, rs_inv, h_inv, rcut, counts=False, seed=7,
                 device="cuda"):
    """Pair kernel vs its plain version on the card at (nb, G, S); with
    counts, block 0 holds S sources, block 1 none and the others a
    random multiple of 8, with zero mass past each count."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.gravity import pairkernel as pk

    rng = np.random.RandomState(seed)
    c = rng.rand(nb, 1, 3)
    tgt = np.mod(c + rng.uniform(-0.01, 0.01, (nb, G, 3)), 1.0)
    src = np.mod(c + rng.uniform(-1.2 * rcut, 1.2 * rcut, (nb, S, 3)), 1.0)
    sm = rng.uniform(0.5, 1.5, (nb, S))
    dev = torch.device(device)
    if counts:
        cnt = rng.randint(0, S // 8 + 1, nb) * 8
        cnt[0], cnt[1] = S, 0
        sm[np.arange(S)[None, :] >= cnt[:, None]] = 0.0
    else:
        sm[:, -S // 10:] = 0.0      # zero-mass padding slots, as packed
        cnt = np.full(nb, S)
    count = torch.as_tensor(cnt, dtype=torch.int32, device=dev)
    sources = int(cnt.sum())

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    tx, ty, tz = (put(tgt[:, :, k]) for k in range(3))
    sx, sy, sz = (put(src[:, :, k]) for k in range(3))
    smt = put(sm)
    within = pairs_within(tx, ty, tz, sx, sy, sz,
                          count, rcut)
    acc0 = torch.zeros((nb, 3, G), dtype=torch.float32, device=dev)
    pot0 = torch.zeros((nb, G), dtype=torch.float32, device=dev)
    plain_reps = 3 if S <= 8192 else 1
    out = {}
    for wp in (False, True):
        args = (tx, ty, tz, sx, sy, sz, smt, acc0, pot0, rs_inv, h_inv, rcut,
                count)
        kw = dict(with_potential=wp)
        acc, pot = pk.block_pair_accumulate(*args, **kw)
        torch.cuda.synchronize()
        ref_acc, ref_pot = pk.block_pair_accumulate_reference(*args, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(acc).all() & torch.isfinite(pot).all()),
              "pair kernel output not finite")
        abs_err = float((acc - ref_acc).abs().max())
        rel = abs_err / max(float(ref_acc.abs().max()), 1e-30)
        if wp:
            pabs = float((pot - ref_pot).abs().max())
            rel = max(rel, pabs / max(float(ref_pot.abs().max()), 1e-30))
            abs_err = max(abs_err, pabs)
        ms = time_ms(lambda: pk.block_pair_accumulate(*args, **kw), 20)
        plain_ms = time_ms(lambda: pk.block_pair_accumulate_reference(
            *args, **kw), plain_reps)
        bound_ms, bound_by = pair_bound(nb, G, sources, wp, within)
        print(f"kernel block_pair_accumulate nb={nb} G={G} S={S} "
              f"counts={'per-block' if counts else 'all S'} "
              f"sum(count)={sources} pairs within rcut {within} of "
              f"{G * sources} with_potential={wp}: "
              f"max_abs_err={abs_err:.6e} err/max|plain|={rel:.6e} "
              f"(tol {KERNEL_TOL:g}) kernel_ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} "
              f"({bound_by})", flush=True)
        check(rel <= KERNEL_TOL, f"pair kernel disagrees with plain version "
              f"(with_potential={wp}, S={S}): {rel:.3e} > {KERNEL_TOL:g}")
        out[wp] = dict(max_abs_err=abs_err, rel=rel, ms=ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, sources=sources)
    return out


def l2_phase(entries=1 << 21, steps=200000, seed=11):
    """Nanoseconds per dependent load hitting L2: a random cycle through
    an 8 MB table (past L1, inside the 50 MB L2), walked once whole to
    bring it into L2."""
    import ctypes
    import numpy as np
    import torch
    from mpgadget_tpu_torch import kernels

    fn = kernels.load("l2chase").l2_chase
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    order = np.random.RandomState(seed).permutation(entries)
    nxt = np.empty(entries, np.int32)
    nxt[order] = np.roll(order, -1)
    nxt_t = torch.as_tensor(nxt, device="cuda")
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def chase(n):
        check(fn(nxt_t.data_ptr(), n, out.data_ptr(), stream) == 0,
              "l2_chase launch failed")

    chase(entries)                  # bring the table into L2
    ns = time_ms(lambda: chase(steps), 3) * 1e6 / steps
    print(f"L2 round trip (pointer chase, 8 MB table): {ns:.3f} ns",
          flush=True)
    return ns


def clustered_ipos(n, seed=31):
    """n integer positions in eight Gaussian clusters (0.03 box wide)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    c = rng.uniform(0.2, 0.8, (8, 3))
    pos = np.mod(c[rng.randint(8, size=n)] + 0.03 * rng.randn(n, 3), 1.0)
    return np.minimum((pos * 2.0 ** 32).astype(np.int64), 2 ** 32 - 1)


SHIFT = (0.04367676, 0.01198168, 0.02141668)   # box units: what
#   run.py:_update_random_offset draws at dm-small's second step


def serial_walk_fn():
    """The serial walk's entry point (csrc/treewalk_serial.cu), a
    yardstick that only this script loads."""
    import ctypes
    from mpgadget_tpu_torch import kernels
    fn = kernels.load("treewalk_serial").tree_walk_serial_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 3 + [ctypes.c_int]
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    return fn


def serial_walk(fn, packed, tree, tpos, center, half, aold, active, cfg,
                rcut, bh_angle2, use_bh, rs_inv, h_inv, with_potential):
    """One launch of the serial walk on the walk kernel's inputs; returns
    (acc, pot, leaf_idx, n_leaves, overflow, visits, monopoles)."""
    import numpy as np
    import torch
    nodes, meta = packed
    nb, G, _ = tpos.shape
    dev = tpos.device
    LL = cfg.leaf_list_max
    out = (torch.empty((nb, 3, G), dtype=torch.float32, device=dev),
           torch.empty((nb, G), dtype=torch.float32, device=dev),
           torch.empty((nb, LL), dtype=torch.int64, device=dev),
           torch.empty(nb, dtype=torch.int64, device=dev),
           torch.empty(nb, dtype=torch.bool, device=dev),
           torch.empty(nb, dtype=torch.int32, device=dev),
           torch.empty(nb, dtype=torch.int32, device=dev))
    rc = fn(nodes.data_ptr(), meta.data_ptr(), tree.n_nodes.data_ptr(),
            tpos.data_ptr(), center.data_ptr(), half.data_ptr(),
            aold.data_ptr(), active.data_ptr(), *(t.data_ptr() for t in out),
            nb, G, tree.capacity, LL, float(rcut),
            float(np.float32(rcut * rcut)), float(np.float32(bh_angle2)),
            int(bool(use_bh)), float(rs_inv), float(h_inv),
            int(with_potential), torch.cuda.current_stream(dev).cuda_stream)
    check(rc == 0, f"serial walk launch failed: CUDA error {rc}")
    return out


def walk_phase(workdir, l2_ns, device="cuda", ngrid=NGRID, nmesh=NMESH):
    """The walk kernel against its plain version on the dm-small lattice
    IC's first tree, on the same particles in clusters and on the lattice
    after a box shift, with the serial walk beside it; returns one dict
    per case."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.gravity import treewalk as tw
    from mpgadget_tpu_torch.gravity.treepm import StageTimer, walk_inputs

    sim, _ = build_sim(workdir, device, ngrid, nmesh)
    sim.compute_forces()            # PM and the first tree force
    pd = sim.pdata
    tg = sim._tree_grav
    acc_old = pd.grav_accel + pd.grav_pm
    amag = torch.sqrt(torch.sum(acc_old * acc_old, dim=-1))
    ipos_clusters = torch.as_tensor(clustered_ipos(int(pd.capacity)),
                                    device=pd.ipos.device)
    shift = torch.as_tensor((np.array(SHIFT) * 2.0 ** 32).astype(np.int64),
                            device=pd.ipos.device)
    ipos_shifted = (pd.ipos + shift[None, :]) & 0xFFFFFFFF
    serial_fn = serial_walk_fn() if device == "cuda" else None
    out = []
    for name, ipos, use_bh, LL, wp in (
            ("lattice", pd.ipos, True, 512, False),
            ("lattice", pd.ipos, False, 4096, True),
            ("clusters", ipos_clusters, True, 512, True),
            ("shifted", ipos_shifted, False, 512, False),
            ("shifted", ipos_shifted, False, 8192, False)):
        kw = tg.force_kwargs(int(pd.capacity), use_bh=use_bh)
        w = walk_inputs(ipos, pd.mass, pd.valid, amag,
                        leaf_max=kw["leaf_max"], max_level=kw["max_level"],
                        node_cap=kw["node_cap"], group_size=kw["group_size"])
        aold = kw["err_tol_force_acc"] * w.amin / kw["g_over_box2"]
        cfg = tw.WalkConfig(leaf_list_max=LL)
        args = (w.tree, w.tpos, w.center, w.half, aold, w.active, cfg,
                kw["rcut_box"], kw["theta2"], use_bh, kw["rs_inv_box"],
                kw["h_inv_box"])
        case = f"{name} LL={LL}"
        t_kernel, t_plain = StageTimer(), StageTimer()
        res = tw.traverse_fused(*args, with_potential=wp, timer=t_kernel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = tw.traverse_fused_reference(*args, with_potential=wp,
                                          timer=t_plain)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        acc, pot, leaf, nl, ovf = res
        racc, rpot, rleaf, rnl, rovf = ref
        check(torch.equal(leaf, rleaf) and torch.equal(nl, rnl)
              and torch.equal(ovf, rovf),
              f"walk kernel leaf lists differ ({case})")
        check(t_kernel.series == t_plain.series
              and t_kernel.counts == t_plain.counts,
              f"walk kernel visit counts differ ({case}): "
              f"{t_kernel.series} vs {t_plain.series}")
        check(bool(torch.isfinite(acc).all() & torch.isfinite(pot).all()),
              "walk kernel output not finite")
        err = rel_norm(acc, racc)
        abs_err = float((acc - racc).abs().max())
        if wp:
            err = max(err, rel_norm(pot, rpot))
            abs_err = max(abs_err, float((pot - rpot).abs().max()))
        check(err <= WALK_TOL, f"walk kernel acc/pot differ by {err:.3e} "
              f"> {WALK_TOL:g} by norm ({case})")
        if name == "shifted":
            check(bool(ovf.any()) == (LL == 512),
                  f"overflowing blocks not as expected ({case})")

        # a second launch, and the serial walk: the same bits
        packed = tw.pack_nodes(w.tree)
        again, stats = tw.walk_kernel(*args, with_potential=wp,
                                      packed=packed)
        check(all(torch.equal(a, b) for a, b in zip(res, again)),
              f"two launches of the walk kernel differ ({case})")
        rounds = int(stats["rounds"].max())
        loads = int(stats["loads"].max())
        check(int(stats["serial"].sum()) == 0,
              f"the walk kernel's stack ran out of room ({case})")
        ser = serial_walk(serial_fn, packed, *args, wp)
        check(all(torch.equal(a, b) for a, b in zip(res, ser[:5]))
              and torch.equal(ser[5], stats["visits"])
              and torch.equal(ser[6], stats["monopoles"]),
              f"walk kernel and serial walk differ in some bit ({case})")

        # the kernel is shorter than the host takes to enqueue it, so the
        # device times come from graph replays; eager_ms is what a caller
        # sees who makes call after call
        ms = graph_ms(lambda: tw.traverse_fused(*args, with_potential=wp),
                      20)
        eager_ms = time_ms(lambda: tw.traverse_fused(
            *args, with_potential=wp), 20)
        serial_ms = graph_ms(lambda: serial_walk(serial_fn, packed, *args,
                                                 wp), 10)
        alone_ms = graph_ms(lambda: tw.walk_kernel(
            *args, with_potential=wp, packed=packed), 20)
        pack_ms = graph_ms(lambda: tw.pack_nodes(w.tree), 20)
        nb, G = w.tpos.shape[:2]
        nodes = t_kernel.series["walk_nodes"][0]
        visits = t_kernel.series["walk_visits_sum"][0]
        vmax = t_kernel.counts["walk_iterations"]
        mono = t_kernel.series["walk_monopoles"][0]
        if name == "clusters":
            check(mono > 0, "clustered walk applied no monopole")
        bound_ms, bound_by = walk_bound(nb, G, LL, nodes, visits, mono, wp)
        path_ms = loads * l2_ns * 1e-6
        serial_path_ms = vmax * l2_ns * 1e-6
        print(f"kernel traverse_fused {name} nb={nb} G={G} LL={LL} "
              f"{'BH' if use_bh else 'relative'} with_potential={wp}: "
              f"identical leaf lists ({int(nl.sum())} leaves, "
              f"{int(ovf.sum())} blocks overflowed); acc/pot err by norm "
              f"{err:.6e} (tol {WALK_TOL:g}), max abs {abs_err:.6e}; "
              f"two launches and the serial walk bit-identical; "
              f"tree nodes {nodes}, deepest level "
              f"{int(w.tree.level.max())}, visits {visits} (longest block "
              f"{vmax}), monopoles {mono} (pair terms "
              f"{mono * G}); kernel_ms={ms:.6f} (device time of the "
              f"wrapper, with pack_nodes {pack_ms:.6f}; the kernel alone "
              f"{alone_ms:.6f}; called again and again by the host "
              f"{eager_ms:.6f}) serial_walk_ms={serial_ms:.6f} "
              f"plain_ms={plain_ms:.6f} "
              f"bound_ms={bound_ms:.6f} ({bound_by}); critical path "
              f"{path_ms:.6f} ms (longest block {loads} dependent loads "
              f"in {rounds} rounds, x one L2 round trip; mean block "
              f"{float(stats['loads'].float().mean()):.1f} loads in "
              f"{float(stats['rounds'].float().mean()):.1f} rounds), a "
              f"serial walk's {serial_path_ms:.6f} ms (longest block "
              f"{vmax} visits)", flush=True)
        out.append(dict(case=case, max_abs_err=abs_err, rel=err, ms=ms,
                        alone_ms=alone_ms, eager_ms=eager_ms,
                        serial_ms=serial_ms,
                        pack_ms=pack_ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by, visits=visits,
                        visits_max=vmax, monopoles=mono, rounds_max=rounds,
                        loads_max=loads,
                        path_ms=path_ms, serial_path_ms=serial_path_ms))
    return out


def accuracy_phase(device):
    """Tree force (walk + pair kernel) vs direct summation, 4096
    particles; the error bounds of tests/test_tree_gravity.py."""
    import numpy as np
    from mpgadget_tpu_torch.gravity.treepm import TreeGravity
    from mpgadget_tpu_torch.gravity.treewalk import WalkConfig
    from mpgadget_tpu_torch.gravity.shortrange import (
        direct_shortrange_pairwise)
    from mpgadget_tpu_torch.particles import ParticleData

    n, box, nmesh = 4096, 1000.0, 32
    rng = np.random.RandomState(21)
    pos = rng.uniform(0, box, (n, 3))
    pdata = ParticleData.from_numpy(pos, np.zeros((n, 3)),
                                    rng.uniform(0.5, 1.5, n),
                                    np.ones(n, np.int32), np.arange(n) + 1,
                                    box, device=device)
    tg = TreeGravity(boxsize=box, nmesh=nmesh, asmth=1.5, rcut=4.5, G=1.0,
                     softening=box / 200.0, tree_use_bh=1,
                     walk_cfg=WalkConfig(leaf_list_max=1024, src_cap=8192))
    acc_tree = tg.compute(pdata)
    check(not bool(tg.last_overflow), "accuracy phase: walk overflow")
    acc_pair, _ = direct_shortrange_pairwise(
        pdata.ipos, pdata.mass, pdata.valid, box,
        float(nmesh / (2 * 1.5) / box), float(4.5 * 1.5 * box / nmesh),
        float(200.0 / box))
    acc_tree = acc_tree.cpu().double().numpy()
    acc_pair = acc_pair.cpu().double().numpy()
    ref = np.sqrt(np.mean(np.sum(acc_pair ** 2, axis=1)))
    rel = np.linalg.norm(acc_tree - acc_pair, axis=1) / ref
    print(f"accuracy tree vs direct (N={n}): mean rel err "
          f"{rel.mean():.6e} (limit 5e-3), p99 "
          f"{np.percentile(rel, 99):.6e} (limit 5e-2)", flush=True)
    check(rel.mean() < 5e-3 and np.percentile(rel, 99) < 5e-2,
          "tree force disagrees with direct summation")


def slice_phase(workdir, device, ngrid=NGRID, nmesh=NMESH, max_steps=3):
    """dm-small through the port's entry points; returns a dict of what
    was measured.  Both kernels' LAUNCHES are reset just before the run
    and read just after the snapshot."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.gravity import pairkernel as pk
    from mpgadget_tpu_torch.gravity import treewalk as tw
    from mpgadget_tpu_torch.gravity.treepm import StageTimer
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io

    sim, out = build_sim(workdir, device, ngrid, nmesh)
    sim.tree_timer = StageTimer()
    step_seconds = []
    run_step = sim.step

    def timed_step(dti):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_step(dti)
        if device == "cuda":
            torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t0)

    sim.step = timed_step
    pk.LAUNCHES = 0
    tw.LAUNCHES = 0
    nsteps = sim.run(max_steps=max_steps, verbose=True)
    snap = sim.write_snapshot()
    launches = {"pair": pk.LAUNCHES, "walk": tw.LAUNCHES}

    check(nsteps == max_steps, f"ran {nsteps} steps, expected {max_steps}")
    check(sim.tree_force_calls >= nsteps + 2,
          f"only {sim.tree_force_calls} tree-force evaluations")
    if device == "cuda":
        for name, n in launches.items():
            check(n >= sim.tree_force_calls,
                  f"{name} kernel launched {n} times for "
                  f"{sim.tree_force_calls} tree-force evaluations")
    pd = sim.pdata
    valid = pd.valid
    check(int(valid.sum()) == ngrid ** 3, "particles lost")
    check(bool(torch.isfinite(pd.vel[valid]).all()), "velocity not finite")
    check(bool(torch.isfinite(pd.grav_accel[valid]).all()
               & torch.isfinite(pd.grav_pm[valid]).all()),
          "acceleration not finite")
    check(float(pd.grav_accel[valid].abs().max()) > 0, "tree force is zero")
    check(bool(((pd.ipos >= 0) & (pd.ipos < 2 ** 32)).all()),
          "position outside the box")
    pks = [f for f in os.listdir(out) if f.startswith("powerspectrum-")]
    check(len(pks) >= nsteps, f"power spectra written: {pks}")
    bf = BigFile(snap)
    hdr = snap_io.read_header(bf)
    sp = snap_io.read_species(bf, 1, hdr)
    check(int(hdr.TotNumPart[1]) == ngrid ** 3 and len(sp["pid"]) ==
          ngrid ** 3, "snapshot particle count")
    spot = bf.open("1/Potential").read()
    check(np.isfinite(sp["pos"]).all() and np.isfinite(sp["vel"]).all()
          and np.isfinite(spot).all(), "snapshot values not finite")
    check(((sp["pos"] >= 0) & (sp["pos"] < BOXSIZE)).all(),
          "snapshot position outside the box")
    power = sim.last_power
    check(np.isfinite(power.power).all() and (power.power > 0).all(),
          "power spectrum not finite and positive")
    return dict(nsteps=nsteps, launches=launches,
                tree_force_calls=sim.tree_force_calls,
                step_seconds=step_seconds, atime=sim.atime,
                stages=dict(sim.tree_timer.seconds),
                walltime=dict(sim.walltime.totals),
                npart=ngrid ** 3, snapshot=os.path.basename(snap),
                powerspectra=len(pks),
                retries=sim.tree_retries,
                counts=dict(sim.tree_timer.counts),
                series=dict(sim.tree_timer.series),
                src_cap=sim._tree_grav.walk_cfg.src_cap,
                group=sim._tree_grav.tree_cfg.group_max,
                capacity=int(sim.pdata.capacity))

def compaction_phase(l2_ns, device="cuda", ngrid=NGRID, nmesh=NMESH,
                     seed=41):
    """The active-target tree force (compacted to the active blocks)
    against the same force with every block walked, on 64^3 clustered
    particles; then both kernels against their plain versions at the
    compacted shapes, their inputs taken from the compacted call."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.gravity import pairkernel as pk
    from mpgadget_tpu_torch.gravity import treepm
    from mpgadget_tpu_torch.gravity import treewalk as tw

    n = ngrid ** 3
    dev = torch.device(device)
    rng = np.random.RandomState(seed)
    ipos = torch.as_tensor(clustered_ipos(n), device=dev)
    mass = torch.ones(n, dtype=torch.float32, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    amag = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32),
                           device=dev) * 1e3
    tg = treepm.TreeGravity(boxsize=BOXSIZE, nmesh=nmesh,
                            softening=2.8 / 30.0 * BOXSIZE / ngrid,
                            tree_use_bh=0, with_potential=True)
    # the active set: half the targets of a seeded 40% of the blocks
    kw = tg.force_kwargs(n)
    G = kw["group_size"]
    nb = n // G
    w = treepm.walk_inputs(ipos, mass, valid, amag, leaf_max=kw["leaf_max"],
                           max_level=kw["max_level"],
                           node_cap=kw["node_cap"], group_size=G)
    blocks = rng.choice(nb, int(0.4 * nb), replace=False)
    rows = (blocks[:, None] * G + np.arange(G)).reshape(-1)
    rows = rows[rng.uniform(size=rows.size) < 0.5]
    act = torch.zeros(n, dtype=torch.bool, device=dev)
    act[w.perm[torch.as_tensor(rows, device=dev)]] = True

    captured = {}
    real_walk, real_pair = treepm.traverse_fused, pk.block_pair_accumulate

    def spy_walk(*a, **k):
        captured["walk"] = (a, k)
        return real_walk(*a, **k)

    def spy_pair(*a, **k):
        captured["pair"] = (a, k)
        return real_pair(*a, **k)

    for attempt in range(6):
        kw = tg.force_kwargs(n)
        treepm.traverse_fused, pk.block_pair_accumulate = spy_walk, spy_pair
        try:
            res_c = treepm.tree_force(ipos, mass, valid, amag,
                                      target_active=act, **kw)
        finally:
            treepm.traverse_fused = real_walk
            pk.block_pair_accumulate = real_pair
        if not bool(res_c.overflow):
            break
        tg.grow()
    check(not bool(res_c.overflow), "compaction phase: walk overflow")
    res_f = treepm.tree_force(ipos, mass, valid, amag, **kw)
    torch.cuda.synchronize()
    nact = int(act.sum())
    same = (torch.equal(res_c.accel[act], res_f.accel[act])
            and torch.equal(res_c.potential[act], res_f.potential[act]))
    diff = max(rel_norm(res_c.accel[act], res_f.accel[act]),
               rel_norm(res_c.potential[act], res_f.potential[act]))
    print(f"compaction: {nact} active targets of {n} in "
          f"{res_c.n_active_blocks} of {nb} blocks (LL "
          f"{kw['walk_cfg'].leaf_list_max}, S {kw['walk_cfg'].src_cap}); "
          f"acc and pot on active rows "
          f"{'bit-identical' if same else 'NOT bit-identical'} to every "
          f"block walked (difference by norm {diff:.6e})", flush=True)
    check(same, f"compacted tree force differs from the full one on "
          f"active rows ({diff:.3e} by norm)")

    # K2 at the compacted shapes
    args, wkw = captured["walk"]
    wkw = {k: v for k, v in wkw.items() if k != "timer"}
    t_kernel, t_plain = treepm.StageTimer(), treepm.StageTimer()
    kres = tw.traverse_fused(*args, timer=t_kernel, **wkw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = tw.traverse_fused_reference(*args, timer=t_plain, **wkw)
    torch.cuda.synchronize()
    walk_plain_ms = (time.perf_counter() - t0) * 1e3
    check(all(torch.equal(a, b) for a, b in zip(kres[2:], ref[2:])),
          "walk kernel leaf lists differ (compacted)")
    check(t_kernel.series == t_plain.series
          and t_kernel.counts == t_plain.counts,
          "walk kernel visit counts differ (compacted)")
    wp = wkw["with_potential"]
    walk_err = max(rel_norm(kres[0], ref[0]), rel_norm(kres[1], ref[1]))
    walk_abs = max(float((kres[0] - ref[0]).abs().max()),
                   float((kres[1] - ref[1]).abs().max()))
    check(walk_err <= WALK_TOL, f"walk kernel acc/pot differ by "
          f"{walk_err:.3e} > {WALK_TOL:g} by norm (compacted)")
    nbc, G = args[1].shape[:2]
    LL = args[6].leaf_list_max
    nodes = t_kernel.series["walk_nodes"][0]
    visits = t_kernel.series["walk_visits_sum"][0]
    mono = t_kernel.series["walk_monopoles"][0]
    walk_ms = graph_ms(lambda: tw.traverse_fused(*args, **wkw), 20)
    wb_ms, wb_by = walk_bound(nbc, G, LL, nodes, visits, mono, wp)
    print(f"kernel traverse_fused compacted nb={nbc} G={G} LL={LL} "
          f"with_potential={wp}: identical leaf lists and visit counts "
          f"({visits} visits, {mono} monopoles); acc/pot err by norm "
          f"{walk_err:.6e} (tol {WALK_TOL:g}), max abs {walk_abs:.6e}; "
          f"kernel_ms={walk_ms:.6f} (graph replays) "
          f"plain_ms={walk_plain_ms:.6f} bound_ms={wb_ms:.6f} ({wb_by})",
          flush=True)

    # K1 at the compacted shapes
    a, pkw = captured["pair"]
    acc, pot = pk.block_pair_accumulate(*a, **pkw)
    torch.cuda.synchronize()
    racc, rpot = pk.block_pair_accumulate_reference(*a, **pkw)
    torch.cuda.synchronize()
    rel = max(float((acc - racc).abs().max())
              / max(float(racc.abs().max()), 1e-30),
              float((pot - rpot).abs().max())
              / max(float(rpot.abs().max()), 1e-30))
    pair_abs = max(float((acc - racc).abs().max()),
                   float((pot - rpot).abs().max()))
    check(rel <= KERNEL_TOL, f"pair kernel disagrees with plain version "
          f"(compacted): {rel:.3e} > {KERNEL_TOL:g}")
    count = pkw["count"]
    tx, ty, tz, sx, sy, sz = a[:6]
    rcut = a[11]
    within = pairs_within(tx, ty, tz, sx, sy, sz, count, rcut)
    sources = int(count.sum())
    pair_ms = time_ms(lambda: pk.block_pair_accumulate(*a, **pkw), 20)
    pair_plain_ms = time_ms(
        lambda: pk.block_pair_accumulate_reference(*a, **pkw), 1)
    pb_ms, pb_by = pair_bound(nbc, G, sources, pkw["with_potential"],
                              within)
    print(f"kernel block_pair_accumulate compacted nb={nbc} G={G} "
          f"S={sx.shape[1]} sum(count)={sources} pairs within rcut {within}"
          f" with_potential={pkw['with_potential']}: "
          f"err/max|plain|={rel:.6e} (tol {KERNEL_TOL:g}) max_abs_err="
          f"{pair_abs:.6e} kernel_ms={pair_ms:.6f} "
          f"plain_ms={pair_plain_ms:.6f} bound_ms={pb_ms:.6f} ({pb_by})",
          flush=True)
    return dict(nb=nbc, active=nact, bit_identical=same,
                walk=dict(max_abs_err=walk_abs, rel=walk_err, ms=walk_ms,
                          plain_ms=walk_plain_ms, bound_ms=wb_ms,
                          bound_by=wb_by),
                pair=dict(max_abs_err=pair_abs, rel=rel, ms=pair_ms,
                          plain_ms=pair_plain_ms, bound_ms=pb_ms,
                          bound_by=pb_by))


# stand-ins for the absent class_pk_9.dat (examples/dm-small/
# paramfile.genic): the Eisenstein-Hu spectrum normalised by Sigma8 today
GENIC_OVERRIDE = {"WhichSpectrum": 1, "Sigma8": 0.8,
                  "InputPowerRedshift": 0}


def modecount_rebin(kk, pk, modes, minmodes=2, ndesired=20):
    """Rebin P(k) so each bin holds enough modes (the helper of
    examples/dm-small/check_results.py)."""
    import numpy as np
    logkk = np.log10(kk)
    mdlogk = (np.max(logkk) - np.min(logkk)) / ndesired
    istart = iend = 1
    count = 0
    k_list, pk_list = [kk[0]], [pk[0]]
    targetlogk = mdlogk + logkk[istart]
    while iend < np.size(logkk) - 1:
        count += modes[iend]
        iend += 1
        if count >= minmodes and logkk[iend - 1] >= targetlogk:
            pk_list.append(np.sum(modes[istart:iend]
                                  * pk[istart:iend]) / count)
            k_list.append(np.sum(modes[istart:iend]
                                 * kk[istart:iend]) / count)
            istart = iend
            targetlogk = mdlogk + logkk[istart]
            count = 0
    return np.array(k_list), np.array(pk_list)


def read_power(fn):
    """(k, P, D1) of a powerspectrum-*.txt, rebinned as check_results.py
    does."""
    import numpy as np
    data = np.loadtxt(fn)
    good = data[:, 0] > 0
    kk, pk = modecount_rebin(data[good, 0], data[good, 1], data[good, 2])
    d1 = 1.0
    with open(fn) as fh:
        for line in fh:
            if line.startswith("# D1"):
                d1 = float(line.split("=")[1].strip())
            if not line.startswith("#"):
                break
    return kk, pk, d1


def genic_phase(workdir, device="cuda", ngrid=None):
    """examples/dm-small/paramfile.genic, with GENIC_OVERRIDE written into
    a copy in workdir, through the port's CLI (python -m
    mpgadget_tpu_torch.genic.main, run in workdir: the paramfile's
    OutputDir is relative); returns a dict with the IC's path.  On the
    CPU, where the CLI refuses to run, the function it calls runs."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.cosmology import Cosmology
    from mpgadget_tpu_torch.genic.main import run_genic
    from mpgadget_tpu_torch.genic.power import PowerParams, PowerSpec
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.params import create_genic_parameter_set
    from mpgadget_tpu_torch.particles import pos_to_fixed
    from mpgadget_tpu_torch.pm.gravity import PMConfig, measure_power
    from mpgadget_tpu_torch.utils import get_unitsystem
    from mpgadget_tpu_torch.utils.constants import CM_PER_MPC

    over = dict(GENIC_OVERRIDE)
    if ngrid is not None:       # a smaller rehearsal on the CPU
        over["Ngrid"] = ngrid
    with open(os.path.join(HERE, "examples", "dm-small",
                           "paramfile.genic")) as fh:
        lines = [ln for ln in fh.read().splitlines()
                 if ln.split("=")[0].strip() not in over]
    paramfile = os.path.join(workdir, "paramfile.genic")
    with open(paramfile, "w") as fh:
        fh.write("\n".join(lines + [f"{k} = {v}" for k, v in over.items()])
                 + "\n")
    ps = create_genic_parameter_set()
    ps.parse_file(paramfile)
    ng = ps["Ngrid"]
    path = os.path.join(workdir, ps["OutputDir"], ps["FileBase"])
    t0 = time.perf_counter()
    if device == "cuda":
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
        out = subprocess.run(
            [sys.executable, "-m", "mpgadget_tpu_torch.genic.main",
             paramfile], cwd=workdir, env=env, capture_output=True,
            text=True, timeout=600)
        check(out.returncode == 0, "genic CLI failed: "
              + (out.stdout + out.stderr)[-2000:])
    else:
        cwd = os.getcwd()
        os.chdir(workdir)
        try:
            run_genic(ps, device=device)
        finally:
            os.chdir(cwd)
    seconds = time.perf_counter() - t0
    bf = BigFile(path)
    hdr = snap_io.read_header(bf)
    sp = snap_io.read_species(bf, 1, hdr)
    n = ng ** 3
    units = get_unitsystem(hdr.UnitLength_in_cm, hdr.UnitMass_in_g,
                           hdr.UnitVelocity_in_cm_per_s)
    atime = 1.0 / (1.0 + ps["Redshift"])
    cp = Cosmology(
        Omega0=ps["Omega0"], OmegaBaryon=ps["OmegaBaryon"],
        OmegaLambda=ps["OmegaLambda"], HubbleParam=ps["HubbleParam"],
        CMBTemperature=ps["CMBTemperature"],
        RadiationOn=bool(ps["RadiationOn"]),
        MNu=(ps["MNue"], ps["MNum"], ps["MNut"]),
        TimeBegin=atime).init_units(units)
    box = ps["BoxSize"]
    # the particles carry all matter but the neutrinos' share
    mass = (cp.Omega0 - cp.ONu(1.0)) * cp.RhoCrit * box ** 3 / n
    check(list(np.asarray(hdr.TotNumPart, np.int64)) == [0, n, 0, 0, 0, 0],
          f"IC header TotNumPart {hdr.TotNumPart}")
    check(abs(hdr.Time - atime) < 1e-12 and hdr.BoxSize == box
          and hdr.Omega0 == ps["Omega0"] and hdr.HubbleParam == 0.7,
          "IC header Time/BoxSize/cosmology")
    check(abs(hdr.MassTable[1] / mass - 1) < 1e-12
          and np.allclose(sp["mass"], mass, rtol=1e-6, atol=0),
          f"IC masses {hdr.MassTable[1]} vs {mass}")
    check(np.array_equal(np.sort(sp["pid"]), np.arange(1, n + 1)),
          "IC IDs are not 1..N")
    check(np.isfinite(sp["pos"]).all() and np.isfinite(sp["vel"]).all()
          and ((sp["pos"] >= 0) & (sp["pos"] < box)).all(),
          "IC positions/velocities")
    vrms = float(np.sqrt(np.mean(np.sum(sp["vel"] ** 2, axis=1))))
    check(vrms > 0, "IC has no velocities")

    ipos = torch.as_tensor(pos_to_fixed(sp["pos"], box).astype(np.int64),
                           device=device)
    weights = torch.as_tensor(sp["mass"], dtype=torch.float32,
                              device=device)
    pm_nmesh = 2 * ng
    power = measure_power(ipos, weights, PMConfig(
        nmesh=pm_nmesh, boxsize=box, unitlength_in_cm=hdr.UnitLength_in_cm))
    kk, pk = modecount_rebin(power.k, power.power, power.nmodes)
    lin = PowerSpec(PowerParams(WhichSpectrum=1,
                                PrimordialIndex=ps["PrimordialIndex"]),
                    cp, atime, units.UnitLength_in_cm)
    scale = units.UnitLength_in_cm / CM_PER_MPC   # h/Mpc -> internal
    nbins = min(6, len(kk))
    pk_lin = lin.delta_spec(kk[:nbins] * scale) ** 2
    ratio = pk[:nbins] / pk_lin
    shape_err = float(np.max(np.abs(ratio / np.mean(ratio) - 1)))
    print(f"genic dm-small (Ngrid {ng}, Nmesh {ps['Nmesh'] or 2 * ng}, "
          f"Seed {ps['Seed']}, z={ps['Redshift']:g}, EH spectrum): "
          f"{seconds:.6f} s on {device} ("
          f"{'the CLI process' if device == 'cuda' else 'run_genic'}); "
          f"{n} particles, mass "
          f"{hdr.MassTable[1]:.9g}, rms velocity {vrms:.6g}; IC P(k) at "
          f"Nmesh {pm_nmesh}, {nbins} lowest-k bins k={kk[:nbins].tolist()} "
          f"P/P_lin={ratio.tolist()}: largest deviation from their mean "
          f"{shape_err:.6f} (rtol 0.1)", flush=True)
    check(shape_err <= 0.1, f"IC P(k) shape differs from the linear "
          f"spectrum by {shape_err:.3f} > 0.1")
    return dict(path=path, seconds=seconds, shape_err=shape_err,
                npart=n)


def pig_check(path, min_length):
    """Read a PIG back through the port's bigfile and hold it to its own
    schema: NumFOFGroupsTotal rows of FOFGroups, every LengthByType row
    at least min_length, NumPartInGroupTotal rows of grouped particles
    per type whose GroupIDs are sorted.  Returns (groups,
    halo count per log10 mass bin in Msun as {bin start: count}, the
    largest mass in Msun or 0)."""
    import numpy as np
    from mpgadget_tpu_torch.io.bigfile import BigFile
    bf = BigFile(path)
    attrs = bf.open("Header").attrs
    ng = int(np.asarray(attrs["NumFOFGroupsTotal"]).reshape(-1)[0])
    npart = np.asarray(attrs["NumPartInGroupTotal"]).astype(np.int64)
    mass = bf.open("FOFGroups/Mass").read()
    lbt = np.asarray(bf.open("FOFGroups/LengthByType").read(),
                     np.int64).reshape(-1, 6)
    name = os.path.basename(path)
    check(len(mass) == ng and lbt.shape[0] == ng
          and len(bf.open("FOFGroups/GroupID").read()) == ng,
          f"{name}: NumFOFGroupsTotal {ng} against {len(mass)} rows")
    check(bool((lbt.sum(axis=1) >= min_length).all()),
          f"{name}: a group shorter than {min_length}")
    check(int(npart.sum()) == int(lbt.sum()),
          f"{name}: NumPartInGroupTotal {npart} against LengthByType")
    for t in np.nonzero(npart)[0]:
        gid = bf.open(f"{t}/GroupID").read().astype(np.int64)
        check(len(gid) == npart[t]
              and len(bf.open(f"{t}/Position").read()) == npart[t],
              f"{name}: type {t} rows against NumPartInGroupTotal")
        check(bool((np.diff(gid) >= 0).all()) and gid[0] >= 1
              and gid[-1] <= ng, f"{name}: GroupIDs not sorted in 1..{ng}")
    hh = float(np.asarray(attrs["HubbleParam"]).reshape(-1)[0])
    msun = mass.astype(np.float64) * 1e10 / hh
    lg = np.floor(np.log10(msun)).astype(int)
    bins = {int(b): int((lg == b).sum()) for b in np.unique(lg)}
    return ng, bins, float(msun.max()) if ng else 0.0


def hier_phase(workdir, device="cuda", max_steps=HIER_STEPS, nmesh=None):
    """examples/dm-small/paramfile.gadget as it ships (hierarchical
    timebins, SnapshotWithFOF 1: a PIG beside every output) from the
    genic IC in workdir; every kernel's LAUNCHES is reset just before the
    run and read just after the snapshot.  Returns its measurements and
    the simulation (the FOF phase takes its final state)."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.gravity import pairkernel as pk
    from mpgadget_tpu_torch.gravity import treewalk as tw
    from mpgadget_tpu_torch.gravity.treepm import StageTimer
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.main import build_simulation
    from mpgadget_tpu_torch.ops import pairs

    override = {}
    if nmesh is not None:       # a smaller rehearsal on the CPU
        override["Nmesh"] = nmesh
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        sim, _ = build_simulation(
            os.path.join(HERE, "examples", "dm-small", "paramfile.gadget"),
            override=override, device=device)
        check(sim.cfg.split_gravity_timesteps and sim.cfg.snapshot_with_fof,
              "paramfile.gadget no longer sets SplitGravityTimestepsOn and "
              "SnapshotWithFOF")
        out = os.path.abspath(sim.cfg.output_dir)
        npart = sim.pdata.num_valid
        sim.tree_timer = StageTimer()
        step_seconds = []
        run_step = sim.step_hierarchical

        def timed_step(dti):
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_sub = run_step(dti)
            if device == "cuda":
                torch.cuda.synchronize()
            step_seconds.append(time.perf_counter() - t0)
            return n_sub

        sim.step_hierarchical = timed_step
        pk.LAUNCHES = 0
        tw.LAUNCHES = 0
        pairs.LAUNCHES = 0
        t0 = time.perf_counter()
        nsteps = sim.run(max_steps=max_steps, verbose=True)
        snap = os.path.abspath(sim.write_snapshot())
        run_seconds = time.perf_counter() - t0
        launches = {"pair": pk.LAUNCHES, "walk": tw.LAUNCHES,
                    "neighbors": pairs.LAUNCHES}
    finally:
        os.chdir(cwd)

    check(nsteps == max_steps or sim.ti_current == sim.timeline.ti_end,
          f"ran {nsteps} PM steps to a={sim.atime}")
    check(len(sim.step_log) == nsteps, "a PM step was not hierarchical")
    for i, (log, sec) in enumerate(zip(sim.step_log, step_seconds)):
        hist = {b: c for b, c in enumerate(log["bins"]) if c}
        print(f"hierarchical PM step {i + 1}: {sec:.6f} s, "
              f"{log['n_sub']} substeps, bins {hist}, active targets per "
              f"evaluation {log['actives']}", flush=True)
    check(any(sum(1 for c in log["bins"] if c) > 1 for log in sim.step_log)
          and max(log["n_sub"] for log in sim.step_log) > 1,
          "no sub-cycling: every particle in one bin")
    calls = sim.tree_force_calls
    pigs = sorted(f for f in os.listdir(out) if f.startswith("PIG_"))
    # one PIG beside every snapshot of the run (not the smoke's own last)
    check(len(pigs) == sim.snapshot_count - 1 >= 1,
          f"PIG catalogues written: {pigs}")
    if device == "cuda":
        for name in ("pair", "walk"):
            check(launches[name] >= calls, f"{name} kernel launched "
                  f"{launches[name]} times for {calls} tree-force "
                  "evaluations")
        check(launches["neighbors"] >= len(pigs), f"neighbour kernel "
              f"launched {launches['neighbors']} times for {len(pigs)} FOF")
    pd = sim.pdata
    valid = pd.valid
    check(int(valid.sum()) == npart, "particles lost")
    check(bool(torch.isfinite(pd.vel[valid]).all()
               & torch.isfinite(pd.grav_accel[valid]).all()
               & torch.isfinite(pd.grav_pm[valid]).all()),
          "state not finite")
    check(float(pd.grav_accel[valid].abs().max()) > 0, "tree force is zero")
    bf = BigFile(snap)
    hdr = snap_io.read_header(bf)
    sp = snap_io.read_species(bf, 1, hdr)
    check(int(hdr.TotNumPart[1]) == npart and len(sp["pid"]) == npart
          and np.isfinite(sp["pos"]).all() and np.isfinite(sp["vel"]).all(),
          "hierarchical snapshot does not read back")
    files = sorted(f for f in os.listdir(out)
                   if f.startswith("powerspectrum-"))
    check(len(files) >= 2, f"power spectra written: {files}")
    kk, pk0, d0 = read_power(os.path.join(out, files[0]))
    kk1, pk1, d1 = read_power(os.path.join(out, files[-1]))
    nbins = min(6, len(kk))
    growth = np.interp(kk[:nbins], kk1, pk1) / pk0[:nbins]
    want = (d1 / d0) ** 2
    growth_err = float(np.max(np.abs(growth / want - 1)))
    print(f"P(k) growth {files[0]} -> {files[-1]} over {nbins} lowest-k "
          f"bins: {growth.tolist()} against D1^2 ratio {want:.6f}, largest "
          f"deviation {growth_err:.6f} (rtol 0.18)", flush=True)
    check(growth_err <= 0.18, f"P(k) growth off D1^2 by {growth_err:.3f}")
    pig_groups = {}
    for name in pigs:
        ng, bins, last = pig_check(os.path.join(out, name),
                                      sim.cfg.fof_min_group_length)
        pig_groups[name] = ng
        print(f"{name}: read back and consistent; {ng} groups; halos per "
              f"log10(M/Msun) bin {bins}; largest {last:.6e} Msun",
              flush=True)
    check(ng > 0, f"{pigs[-1]} holds no halo (check_hmf asks for one)")
    print(f"check_hmf (examples/dm-small/check_results.py:104-115): "
          f"largest halo of {pigs[-1]} {last:.6e} Msun against "
          f"{HMF_MSUN:g}: {'met' if last > HMF_MSUN else 'NOT met'} (not "
          f"enforced: the spectrum is the Eisenstein-Hu stand-in and the "
          f"realisation the port's own)", flush=True)
    return dict(nsteps=nsteps, atime=sim.atime, launches=launches,
                tree_force_calls=calls, force_evals=sim.force_evals,
                step_seconds=step_seconds, run_seconds=run_seconds,
                step_log=sim.step_log, stages=dict(sim.tree_timer.seconds),
                series=dict(sim.tree_timer.series),
                walltime=dict(sim.walltime.totals), retries=sim.tree_retries,
                leaf_list_max=sim._tree_grav.walk_cfg.leaf_list_max,
                group=sim._tree_grav.tree_cfg.group_max,
                growth_err=growth_err, npart=npart,
                snapshot=os.path.basename(snap), powerspectra=len(files),
                pig_groups=pig_groups, largest_msun=last, sim=sim,
                snapnum=int(os.path.basename(snap).split("_")[-1]))


def hier_bounds(res):
    """K1's and K2's bounds summed over the hierarchical run's
    evaluations, each at its own (compacted) nb, with the potential where
    it was computed (the snapshots')."""
    ser = res["series"]
    nbs = ser["active_blocks"]
    npot = ser["with_potential"]
    G, LL = res["group"], res["leaf_list_max"]
    k1 = sum(pair_bound(nb, G, s, wp)[0]
             for nb, s, wp in zip(nbs, ser["pair_sources_sum"], npot))
    k2 = sum(walk_bound(nb, G, LL, c, v, m, wp)[0]
             for nb, c, v, m, wp in zip(nbs, ser["walk_nodes"],
                                        ser["walk_visits_sum"],
                                        ser["walk_monopoles"], npot))
    return k1, k2


def refines(a, b):
    """Every class of labeling a lies inside one class of labeling b."""
    import numpy as np
    a = np.unique(a, return_inverse=True)[1].astype(np.int64)
    b = np.unique(b, return_inverse=True)[1].astype(np.int64)
    return len(np.unique(a * (b.max() + 1) + b)) == a.max() + 1


def fof_phase(sim, label, device="cuda"):
    """FOF of the final dm-small state through Simulation.run_fof (PIG
    `label`), from a cold leaf-list cache, with per-stage seconds; the
    labels held to scipy's connected components of the same positions
    (f64 from the fixed point) bracketing the linking length.  K3's
    LAUNCHES are reset just before and read just after.  Returns the
    measurements and K3's inputs."""
    import numpy as np
    import torch
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree
    from mpgadget_tpu_torch.gravity.treepm import StageTimer
    from mpgadget_tpu_torch.ops import pairs
    from mpgadget_tpu_torch.physics import fof

    captured = {}
    real = fof.fof_label

    def spy(*a, **k):
        res = real(*a, **k)
        captured.update(args=a, labels=res[0])
        return res

    timer = StageTimer()
    pairs._LL_CACHE.clear()
    fof.fof_label = spy
    try:
        pairs.LAUNCHES = 0
        t0 = time.perf_counter()
        timer.start(torch.device(device))
        cat = sim.run_fof(save=True, label=label, timer=timer)
        seconds = time.perf_counter() - t0
        launches = pairs.LAUNCHES
    finally:
        fof.fof_label = real
    if device == "cuda":
        check(launches >= 1, "FOF did not launch the neighbour kernel")
    path = os.path.join(sim.cfg.output_dir,
                        f"{sim.cfg.fof_file_base}_{label:03d}")
    ng, bins, _ = pig_check(path, sim.cfg.fof_min_group_length)
    check(ng == cat["ngroups"], "PIG group count against the catalogue")

    ipos, primary, box, ll = captured["args"][:4]
    primary = primary.cpu().numpy()
    lab = captured["labels"].cpu().numpy()[primary]
    pos = ipos.cpu().numpy()[primary].astype(np.float64) * 2.0 ** -32
    t0 = time.perf_counter()
    kd = cKDTree(pos, boxsize=1.0)
    m = len(pos)
    comps = {}
    for side, f in (("inner", 1 - 1e-5), ("outer", 1 + 1e-5)):
        prs = kd.query_pairs(ll / box * f, output_type="ndarray")
        comps[side] = connected_components(csr_matrix(
            (np.ones(len(prs)), (prs[:, 0], prs[:, 1])), shape=(m, m)),
            directed=False)[1]
    scipy_s = time.perf_counter() - t0
    inside = refines(comps["inner"], lab)
    within = refines(lab, comps["outer"])
    st, ser = timer.seconds, timer.series
    print(f"FOF of the final dm-small state ({m} primaries, linking length "
          f"{ll:.6f} kpc/h = {ll / box:.9f} box) on {device}: "
          f"{seconds:.6f} s through Simulation.run_fof; stages "
          + ", ".join(f"{k} {v:.6f}" for k, v in st.items())
          + f" s; leaf lists from 64 (cache cleared) to LL "
          f"{ser['leaf_list_max'][-1]}; {ser['rounds'][-1]} min-label rounds"
          f" of " + " ".join(f"{v:.6f}" for v in ser["round_seconds"])
          + f" s; K3 launches {launches}", flush=True)
    print(f"FOF labels against scipy (cKDTree + connected_components, "
          f"{scipy_s:.3f} s on the host): {len(np.unique(comps['inner']))} "
          f"components at ll(1-1e-5), {len(np.unique(lab))} port groups, "
          f"{len(np.unique(comps['outer']))} at ll(1+1e-5); every inner "
          f"component inside one port group: {inside}; every port group "
          f"inside one outer component: {within}; {ng} halos of >= "
          f"{sim.cfg.fof_min_group_length}, per log10(M/Msun) bin {bins}",
          flush=True)
    check(inside and within, "FOF labels outside the scipy bracket")
    return dict(seconds=seconds, stages=dict(st), series=dict(ser),
                launches=launches, groups=ng, ll=ll, box=box,
                ipos=ipos, primary=captured["args"][1],
                leaf_list_max=ser["leaf_list_max"][-1])


def kernel_split(fn, calls):
    """Mean device milliseconds per call of each CUDA kernel that fn
    launches, by torch.profiler ({} where the profiler records no device
    time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            out[ev.key.split("(")[0].split("<")[0].replace("void ", "")] = \
                us * 1e-3 / calls
    return out


def serial_neighbors_fn():
    """The serial neighbour walk's entry point (csrc/neighbors_serial.cu),
    a yardstick that only this script loads."""
    import ctypes
    from mpgadget_tpu_torch import kernels
    fn = kernels.load("neighbors_serial").find_neighbors_serial_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    return fn


def serial_neighbors(fn, packed, tree, group_nodes, center, half, radius,
                     hmax, LL, symmetric):
    """One call of the serial neighbour walk as the port first launched
    it: the lists filled with C, then one thread per group; returns
    (leaf_idx, n_leaves, overflow, visits)."""
    import torch
    nodes, meta = packed
    ng = group_nodes.shape[0]
    dev = center.device
    out = (torch.full((ng, LL), tree.capacity, dtype=torch.int32,
                      device=dev),
           torch.empty(ng, dtype=torch.int32, device=dev),
           torch.empty(ng, dtype=torch.bool, device=dev),
           torch.empty(ng, dtype=torch.int32, device=dev))
    rc = fn(nodes.data_ptr(), (hmax if symmetric else nodes).data_ptr(),
            meta.data_ptr(), tree.n_nodes.data_ptr(), group_nodes.data_ptr(),
            center.data_ptr(), half.data_ptr(), radius.data_ptr(),
            *(t.data_ptr() for t in out), ng, tree.capacity, LL,
            int(bool(symmetric)), torch.cuda.current_stream(dev).cuda_stream)
    check(rc == 0, f"serial neighbour walk launch failed: CUDA error {rc}")
    return out


NEIGHBOR_FIELDS = ("leaf_idx", "n_leaves", "overflow", "visits")


def neighbor_case(name, tree, groups, radius, hmax, LL, symmetric, l2_ns,
                  serial_fn):
    """K3 against its plain version on one set: the same lists, counts,
    flags and visits, two launches and the serial yardstick the same
    bits; device times by graph replays, the kernel's beside the serial
    walk's, and each one's critical path."""
    import torch
    from mpgadget_tpu_torch.ops import pairs
    nodes, gc, gh = groups[:3]
    args = (tree, nodes, gc, gh, radius, hmax, LL)
    res = pairs.find_neighbors(*args, symmetric=symmetric)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = pairs.find_neighbors_reference(*args, symmetric=symmetric)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for f in NEIGHBOR_FIELDS:
        check(torch.equal(getattr(res, f), getattr(ref, f)),
              f"neighbour kernel {f} differs from the plain version ({name})")
    abs_err = max(int((getattr(res, f).long() - getattr(ref, f).long())
                      .abs().max()) for f in NEIGHBOR_FIELDS)
    packed = pairs.pack_neighbor_nodes(tree)
    again, stats = pairs.neighbor_kernel(*args, symmetric=symmetric,
                                         packed=packed)
    check(all(torch.equal(getattr(res, f), getattr(again, f))
              for f in NEIGHBOR_FIELDS), f"two launches of K3 differ ({name})")
    check(int(stats["serial"].sum()) == 0,
          f"K3's stack ran out of room ({name})")
    ser = serial_neighbors(serial_fn, packed, *args, symmetric)
    check(all(torch.equal(a, getattr(res, f))
              for a, f in zip(ser, NEIGHBOR_FIELDS)),
          f"K3 and the serial neighbour walk differ in some bit ({name})")
    ms = graph_ms(lambda: pairs.find_neighbors(*args, symmetric=symmetric),
                  20)
    alone_ms = graph_ms(lambda: pairs.neighbor_kernel(
        *args, symmetric=symmetric, packed=packed), 20)
    serial_ms = graph_ms(lambda: serial_neighbors(
        serial_fn, packed, *args, symmetric), 20)
    split = kernel_split(lambda: pairs.neighbor_kernel(
        *args, symmetric=symmetric, packed=packed), 10)
    ng = int(nodes.shape[0])
    real = int((nodes < tree.n_nodes).sum())
    visits = int(res.visits.sum())
    vmax = int(res.visits.max())
    n_nodes = int(tree.n_nodes)
    listed = int(res.n_leaves.sum())
    rounds = int(stats["rounds"].max())
    loads = int(stats["loads"].max())
    bound_ms, bound_by = neighbor_bound(ng, LL, n_nodes, visits, symmetric)
    walk_ms, walk_by = neighbor_bound(ng, LL, n_nodes, visits, symmetric,
                                      listed)
    path_ms = loads * l2_ns * 1e-6
    serial_path_ms = vmax * l2_ns * 1e-6
    print(f"kernel find_neighbors {name} groups {real} of {ng} slots "
          f"LL={LL} symmetric={symmetric}: identical leaf lists, counts, "
          f"flags and visits, max_abs_err={abs_err} ({listed} leaves, "
          f"{int(res.overflow.sum())} groups overflowed); two launches "
          f"and the serial walk bit-identical; tree nodes {n_nodes}, "
          f"visits {visits} (longest group {vmax}); kernel_ms={ms:.6f} "
          f"(graph replays, with pack_neighbor_nodes; the kernel alone "
          f"{alone_ms:.6f}) serial_walk_ms={serial_ms:.6f} "
          f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f} ({bound_by}, "
          f"the whole {ng} x {LL} lists written); the walk's own bound "
          f"{walk_ms:.6f} ms ({walk_by}, the {listed} listed leaves "
          f"written); critical path {path_ms:.6f} ms (longest group "
          f"{loads} dependent loads in {rounds} rounds x one L2 round "
          f"trip; mean group {float(stats['loads'].float().mean()):.1f} "
          f"loads in {float(stats['rounds'].float().mean()):.1f} rounds), "
          f"the serial walk's {serial_path_ms:.6f} ms (longest group "
          f"{vmax} visits); per kernel of K3 (torch.profiler, mean of 10 "
          f"calls): " + (", ".join(f"{k} {v:.6f} ms" for k, v in
                                     split.items()) or "not measured"),
          flush=True)
    return dict(case=name, ms=ms, alone_ms=alone_ms, serial_ms=serial_ms,
                split_ms=split,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                walk_bound_ms=walk_ms, visits=visits, visits_max=vmax,
                groups=real, LL=LL, rounds_max=rounds, loads_max=loads,
                path_ms=path_ms, serial_path_ms=serial_path_ms,
                overflowed=int(res.overflow.sum()), max_abs_err=abs_err)


def neighbor_serial_mode_case(name, tree, groups, radius, hmax, LL,
                              symmetric, stack_cap=1):
    """K3 with a stack too small for its rounds, so that its serial mode
    walks the groups: held to the plain version bit for bit."""
    import torch
    from mpgadget_tpu_torch.ops import pairs
    args = (tree, *groups[:3], radius, hmax, LL)
    res, stats = pairs.neighbor_kernel(*args, symmetric=symmetric,
                                       stack_cap=stack_cap)
    ref = pairs.find_neighbors_reference(*args, symmetric=symmetric)
    for f in NEIGHBOR_FIELDS:
        check(torch.equal(getattr(res, f), getattr(ref, f)),
              f"K3's serial mode: {f} differs from the plain version")
    serial = int(stats["serial"].sum())
    check(serial > 0, "K3's serial mode was not taken")
    ms = graph_ms(lambda: pairs.neighbor_kernel(
        *args, symmetric=symmetric, stack_cap=stack_cap), 5)
    abs_err = max(int((getattr(res, f).long() - getattr(ref, f).long())
                      .abs().max()) for f in NEIGHBOR_FIELDS)
    print(f"kernel find_neighbors {name}, stack_cap={stack_cap} (serial "
          f"mode): identical leaf lists, counts, flags and visits; "
          f"{serial} of {int(res.visits.sum())} visits serial; "
          f"kernel_ms={ms:.6f} (the kernel alone, graph replays)",
          flush=True)
    return dict(case=f"{name} serial mode", ms=ms, serial=serial,
                max_abs_err=abs_err)


def neighbor_phase(fres, l2_ns, seed=43, device="cuda"):
    """K3 against its plain version on the card: the final dm-small
    state's FOF inputs (asymmetric, radius the linking length, at the LL
    the FOF phase reached), and the 64^3 clustered particles, symmetric,
    with a seeded hmax on a fifth of the nodes, at an LL that some groups
    overflow; each beside the serial walk K3 began as; then the clustered
    set again with a stack too small for the rounds (the serial mode)."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.physics import fof

    serial_fn = serial_neighbors_fn() if device == "cuda" else None
    cfg = fof.FOFParams()
    out = []
    _, _, _, tree, groups = fof._sorted_tree(fres["ipos"], fres["primary"],
                                             cfg)
    ll_box = float(np.float32(fres["ll"] / fres["box"]))
    radius = torch.full((groups[0].shape[0],), ll_box, device=device)
    out.append(neighbor_case("dm-small final state", tree, groups, radius,
                             None, fres["leaf_list_max"], False, l2_ns,
                             serial_fn))
    n = int(fres["ipos"].shape[0])
    ipos = torch.as_tensor(clustered_ipos(n), device=device)
    _, _, _, tree, groups = fof._sorted_tree(
        ipos, torch.ones(n, dtype=torch.bool, device=device), cfg)
    rng = np.random.RandomState(seed)
    C = tree.capacity
    hmax = torch.as_tensor((rng.uniform(0, 3 * ll_box, C)
                            * (rng.rand(C) < 0.2)).astype(np.float32),
                           device=device)
    radius = torch.full((groups[0].shape[0],), ll_box, device=device)
    res = neighbor_case("clusters", tree, groups, radius, hmax, 16, True,
                        l2_ns, serial_fn)
    check(res["overflowed"] > 0, "no clustered group overflowed LL = 16")
    out.append(res)
    out.append(neighbor_serial_mode_case("clusters", tree, groups, radius,
                                         hmax, 16, True))
    return out


def restart_phase(workdir, snapnum, in_process, device="cuda",
                  paramfile=None):
    """RestartFlag 3 through the port's CLI, python -m
    mpgadget_tpu_torch.main paramfile.gadget 3 <snapnum>, in workdir (the
    paramfile's paths are relative): its PIG must read back and pass the
    PIG checks.  On the CPU, where the CLI refuses to run, the calls it
    makes run in-process.  paramfile: dm-small's by default."""
    paramfile = paramfile or os.path.join(HERE, "examples", "dm-small",
                                          "paramfile.gadget")
    t0 = time.perf_counter()
    if device == "cuda":
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
        out = subprocess.run(
            [sys.executable, "-m", "mpgadget_tpu_torch.main", paramfile,
             "3", str(snapnum)], cwd=workdir, env=env, capture_output=True,
            text=True, timeout=600)
        check(out.returncode == 0, "RestartFlag 3 CLI failed: "
              + (out.stdout + out.stderr)[-2000:])
    else:
        from mpgadget_tpu_torch.main import build_simulation
        cwd = os.getcwd()
        os.chdir(workdir)
        try:
            sim, ps = build_simulation(paramfile, snapshot=os.path.join(
                "output", f"PART_{snapnum:03d}"), device=device)
            sim.run_fof(save=True, label=snapnum)
        finally:
            os.chdir(cwd)
    seconds = time.perf_counter() - t0
    from mpgadget_tpu_torch.params import create_gadget_parameter_set
    ps = create_gadget_parameter_set()
    ps.parse_file(paramfile)
    ng, bins, largest = pig_check(
        os.path.join(workdir, ps["OutputDir"], f"PIG_{snapnum:03d}"),
        ps["FOFHaloMinLength"])
    how = ("the CLI process, its start included" if device == "cuda"
           else "the in-process calls")
    print(f"RestartFlag 3 on PART_{snapnum:03d}: {seconds:.6f} s for {how}"
          f"; PIG_{snapnum:03d} read back and consistent: {ng} groups "
          f"(the in-process FOF of the same state: {in_process}); halos per "
          f"log10(M/Msun) bin {bins}; largest {largest:.6e} Msun",
          flush=True)
    return dict(seconds=seconds, groups=ng)


# -- the gas phase: examples/star-small without its subgrid physics ------

GAS_SWITCHES_OFF = {"CoolingOn": 0, "StarformationOn": 0, "BlackHoleOn": 0,
                    "WindOn": 0, "MetalReturnOn": 0}
GAS_STEPS = None      # PM steps of the star-small run (None: to TimeMax)
MOMENTUM_TOL = 1e-4   # |sum m a_hydro| / sum m |a_hydro|
# the IC's SPH density, volume-weighted (sum m / sum m/rho), against the
# mean baryon density Omega_b rho_crit.  star-small's IC (z = 9, a 5
# Mpc/h box, 156 kpc/h between particles) is already nonlinear at the
# kernel's scale: its particle mean lies ~40% above, by the density's
# variance, and SPH volumes m/rho do not tile the box exactly there; a
# wrong unit (a^3, h, the box) would miss by far more than 10%.  The
# bigger IC (dm-small's box with gas, 1 Mpc/h between particles) is near
# linear and is held to 3%.
IC_RHO_TOL = {"star-small": 0.10, "dm-small": 0.03}
# P(k) growth against D1^2 on the linear scales only: dm-small's six
# lowest-k bins end at 0.6 h/Mpc, star-small's (a 5 Mpc/h box) reach 7.5
# h/Mpc, where the growth from z = 9 to 4 is nonlinear (4.4-6.0 against
# D1^2's 3.55 in this PR's first full run on the card); its bins up to 3
# h/Mpc are held to the same rtol 0.18
GAS_PK_KMAX = 3.0
SPH_TOL = 1e-5        # K4, K5 against their plain versions, by norm
MAXSIG_TOL = 1e-6     # K5's maxsig: a max of the same pair terms (and
                      # bit for bit besides)
# FP32 operations per (target, source) pair, counted from the kernels (a
# division or square root counted as one): a pair that counts (u < 1 for
# K4; r < H_i or r < H_j for K5) and one that does not (its distance
# and the decision)
DENSITY_PAIR_OPS = 116
DENSITY_DISTANCE_OPS = 17
HYDRO_PAIR_OPS = 165
HYDRO_DISTANCE_OPS = 19
# bytes per particle read (src, tgt, valid) and per target written
DENSITY_PARTICLE_BYTES = (32 + 16 + 1, 36)
HYDRO_PARTICLE_BYTES = (64 + 32 + 1, 20)


def paramfile_copy(src, dst, over):
    """Copy a paramfile with the parameters in `over` replaced."""
    with open(src) as fh:
        lines = [ln for ln in fh.read().splitlines()
                 if ln.split("=")[0].strip() not in over]
    with open(dst, "w") as fh:
        fh.write("\n".join(lines + [f"{k} = {v}" for k, v in over.items()])
                 + "\n")
    return dst


def run_cli(module, args, workdir, what):
    """python -m <module> <args> in workdir with the checkout on the path;
    fails the smoke if it fails.  Returns its seconds."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=workdir,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    check(out.returncode == 0, f"{what} failed: "
          + (out.stdout + out.stderr)[-2000:])
    return time.perf_counter() - t0


def gas_genic(workdir, example, over, device="cuda"):
    """examples/<example>/paramfile.genic with `over` written into a copy
    in workdir, through the port's genic CLI (on the CPU the function it
    calls); checks the gas + DM IC's header, IDs and masses.  Returns
    (IC path, particles per species, seconds)."""
    import numpy as np
    from mpgadget_tpu_torch.cosmology import Cosmology
    from mpgadget_tpu_torch.genic.main import run_genic
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.params import create_genic_parameter_set
    from mpgadget_tpu_torch.utils import get_unitsystem

    paramfile = paramfile_copy(
        os.path.join(HERE, "examples", example, "paramfile.genic"),
        os.path.join(workdir, "paramfile.genic"), over)
    ps = create_genic_parameter_set()
    ps.parse_file(paramfile)
    t0 = time.perf_counter()
    if device == "cuda":
        run_cli("mpgadget_tpu_torch.genic.main", [paramfile], workdir,
                f"{example} genic CLI")
    else:
        cwd = os.getcwd()
        os.chdir(workdir)
        try:
            run_genic(ps, device=device)
        finally:
            os.chdir(cwd)
    seconds = time.perf_counter() - t0
    path = os.path.join(workdir, ps["OutputDir"], ps["FileBase"])
    bf = BigFile(path)
    hdr = snap_io.read_header(bf)
    n = ps["Ngrid"] ** 3
    check(list(np.asarray(hdr.TotNumPart, np.int64)) == [n, n, 0, 0, 0, 0],
          f"{example} IC TotNumPart {hdr.TotNumPart}")
    units = get_unitsystem(hdr.UnitLength_in_cm, hdr.UnitMass_in_g,
                           hdr.UnitVelocity_in_cm_per_s)
    cp = Cosmology(Omega0=ps["Omega0"], OmegaBaryon=ps["OmegaBaryon"],
                   OmegaLambda=ps["OmegaLambda"],
                   HubbleParam=ps["HubbleParam"],
                   TimeBegin=hdr.Time).init_units(units)
    vol = ps["BoxSize"] ** 3
    pids = []
    for t, omega in ((0, cp.OmegaBaryon), (1, cp.Omega0 - cp.OmegaBaryon)):
        sp = snap_io.read_species(bf, t, hdr)
        want = omega * cp.RhoCrit * vol / n
        check(len(sp["pid"]) == n and np.allclose(sp["mass"], want,
                                                  rtol=1e-5, atol=0),
              f"{example} IC type {t} masses {sp['mass'][:1]} vs {want}")
        check(np.isfinite(sp["pos"]).all() and np.isfinite(sp["vel"]).all(),
              f"{example} IC type {t} positions/velocities")
        pids.append(sp["pid"])
    check(len(np.unique(np.concatenate(pids))) == 2 * n,
          f"{example} IC IDs are not unique")
    print(f"genic {example} (Ngrid {ps['Ngrid']}, ProduceGas 1, BoxSize "
          f"{ps['BoxSize']:g} kpc/h, z={ps['Redshift']:g}; cuts {over}): "
          f"{seconds:.6f} s on {device}; {n} gas + {n} DM particles",
          flush=True)
    return path, n, seconds


class SphSpy:
    """Wraps sph.density.sph_density and the two pair-sum entry points
    (density_sums, hydro_sums) and sph.hydra.hydro_force: checks every
    density solve's neighbour numbers and every hydro call's momentum,
    counts bisection passes and keeps pair-sum inputs: K5's last call
    (the run's final gas state) and K4's first pass of the last solve
    that targets every gas particle (its later passes list only the
    unconverged groups)."""

    def __init__(self, device):
        from mpgadget_tpu_torch.sph import density, hydra
        self.mods = (density, hydra)
        self.device = device
        self.solves = []       # (passes, unconverged, targets, worst dev)
        self.momentum = []     # |sum m a| / sum m |a| per hydro call
        self.last = {}
        self.real = {}
        self._targets = None     # targets of the solve in progress

    def __enter__(self):
        import torch
        density, hydra = self.mods
        self.real = dict(sph_density=density.sph_density,
                         density_sums=density.density_sums,
                         hydro_force=hydra.hydro_force,
                         hydro_sums=hydra.hydro_sums)

        def sph_density(ipos, mass, valid_gas, hsml, vel, velpred, entvar,
                        par, boxsize, update_hsml=True, **kw):
            tm = kw.get("target_mask")
            tgt = valid_gas if tm is None else valid_gas & tm
            self._targets = (int(tgt.sum()), int(valid_gas.sum()))
            res = self.real["sph_density"](
                ipos, mass, valid_gas, hsml, vel, velpred, entvar, par,
                boxsize, update_hsml=update_hsml, **kw)
            if update_hsml:
                dev = (res["numngb"] - par.desnumngb).abs()
                worst = float(torch.where(tgt, dev, 0.0).max())
                self.solves.append((res["iterations"], res["unconverged"],
                                    int(tgt.sum()), worst,
                                    par.max_ngb_deviation))
            return res

        def hydro_force(ipos, mass, valid_gas, *a, **kw):
            res = self.real["hydro_force"](ipos, mass, valid_gas, *a, **kw)
            m = torch.where(valid_gas, mass, 0.0)[:, None].double()
            ma = m * res["hydro_accel"].double()
            self.momentum.append(float(
                ma.sum(dim=0).norm() / ma.norm(dim=1).sum().clamp(
                    min=1e-300)))
            return res

        def keep(name):
            def fn(*a, **kw):
                if name == "hydro_sums":
                    self.last[name] = (a, kw)
                elif self._targets is not None:
                    if self._targets[0] == self._targets[1]:
                        self.last[name] = (a, kw)
                    self._targets = None        # later passes: not kept
                return self.real[name](*a, **kw)
            return fn

        density.sph_density = sph_density
        hydra.hydro_force = hydro_force
        density.density_sums = keep("density_sums")
        hydra.hydro_sums = keep("hydro_sums")
        return self

    def __exit__(self, *exc):
        density, hydra = self.mods
        density.sph_density = self.real["sph_density"]
        density.density_sums = self.real["density_sums"]
        hydra.hydro_force = self.real["hydro_force"]
        hydra.hydro_sums = self.real["hydro_sums"]
        return False

    def check(self, what):
        bad = [s for s in self.solves if s[1] or s[3] > s[4]]
        passes = [s[0] for s in self.solves]
        print(f"{what}: {len(self.solves)} density solves, bisection passes "
              f"per solve {passes} (targets {[s[2] for s in self.solves]}), "
              f"largest |numngb - DesNumNgb| {max(s[3] for s in self.solves):.6f}"
              f" (MaxNumNgbDeviation {self.solves[0][4]:g}); "
              f"{len(self.momentum)} hydro calls, largest |sum m a_hydro| / "
              f"sum m |a_hydro| {max(self.momentum):.6e} (tol "
              f"{MOMENTUM_TOL:g})", flush=True)
        check(not bad, f"{what}: density solves with targets outside "
              f"DesNumNgb +- dev (passes, unconverged at max_iter, targets, "
              f"worst deviation, dev): {bad}")
        check(max(self.momentum) < MOMENTUM_TOL, f"{what}: hydro force "
              f"does not conserve momentum: {max(self.momentum):.3e}")


def gas_run_phase(workdir, device="cuda", max_steps=GAS_STEPS, ngrid=None,
                  nmesh=None):
    """examples/star-small from its own two paramfiles, without its
    subgrid physics: genic (GENIC_OVERRIDE) through the CLI, then
    paramfile.gadget with GAS_SWITCHES_OFF written into a copy ->
    build_simulation -> Simulation.run() (hierarchical, a snapshot and a
    PIG at each output) -> write_snapshot, K1-K5's launch counts reset
    just before and read just after.  Checks: every density solve's
    targets within DesNumNgb +- MaxNumNgbDeviation; every hydro call's
    momentum; the IC's mean SPH density against Omega_b rho_crit; the
    entropy floor; the growth of P(k) against D1^2; each snapshot's gas
    blocks and each PIG read back.  Returns the measurements and the
    simulation."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.gravity import pairkernel as pk
    from mpgadget_tpu_torch.gravity import treewalk as tw
    from mpgadget_tpu_torch.gravity.treepm import StageTimer
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.main import build_simulation
    from mpgadget_tpu_torch.ops import pairs
    from mpgadget_tpu_torch.sph import density, hydra
    from mpgadget_tpu_torch.utils.constants import GAMMA_MINUS1

    over = dict(GENIC_OVERRIDE)
    if ngrid is not None:           # a smaller rehearsal on the CPU
        over["Ngrid"] = ngrid
    _, ngas, genic_s = gas_genic(workdir, "star-small", over, device)
    gover = dict(GAS_SWITCHES_OFF)
    if nmesh is not None:
        gover["Nmesh"] = nmesh
    paramfile = paramfile_copy(
        os.path.join(HERE, "examples", "star-small", "paramfile.gadget"),
        os.path.join(workdir, "paramfile.gadget"), gover)
    cwd = os.getcwd()
    os.chdir(workdir)
    first = {}
    try:
        sim, _ = build_simulation(paramfile, device=device)
        c = sim.cfg
        check(c.hydro_on and c.density_independent_sph
              and c.split_gravity_timesteps and c.snapshot_with_fof,
              "star-small's paramfile.gadget no longer sets HydroOn, "
              "DensityIndependentSphOn, SplitGravityTimestepsOn and "
              "SnapshotWithFOF")
        out = os.path.abspath(c.output_dir)
        real_hydro = sim.compute_hydro

        def first_hydro(*a, **k):
            real_hydro(*a, **k)
            if not first:
                gas = sim.gas_mask
                rho = sim.sph.density[gas].double()
                m = sim.pdata.mass[gas].double()
                first["rho"] = float(rho.mean())
                # the mass over the particles' SPH volumes m / rho: the
                # volume-weighted mean (the particle mean is weighted by
                # mass, so above it by the variance of the density)
                first["rho_vol"] = float(m.sum() / (m / rho).sum())
        sim.compute_hydro = first_hydro
        sim.tree_timer = StageTimer()
        step_seconds = []
        run_step = sim.step_hierarchical

        def timed_step(dti):
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            n_sub = run_step(dti)
            if device == "cuda":
                torch.cuda.synchronize()
            step_seconds.append(time.perf_counter() - t0)
            return n_sub

        sim.step_hierarchical = timed_step
        for mod in (pk, tw, pairs, density, hydra):
            mod.LAUNCHES = 0
        t0 = time.perf_counter()
        with SphSpy(device) as spy:
            nsteps = sim.run(max_steps=max_steps, verbose=True)
            snap = os.path.abspath(sim.write_snapshot())
            if device == "cuda":
                torch.cuda.synchronize()
        run_seconds = time.perf_counter() - t0
        launches = {"pair": pk.LAUNCHES, "walk": tw.LAUNCHES,
                    "neighbors": pairs.LAUNCHES, "density": density.LAUNCHES,
                    "hydro": hydra.LAUNCHES}
    finally:
        os.chdir(cwd)

    check(nsteps == max_steps or sim.ti_current == sim.timeline.ti_end,
          f"star-small ran {nsteps} PM steps to a={sim.atime}")
    spy.check("star-small")
    n_solves = len(spy.solves)
    if device == "cuda":
        check(launches["density"] >= n_solves and launches["hydro"]
              >= len(spy.momentum) and min(launches.values()) > 0,
              f"a kernel of the gas path was not launched: {launches}")
    for i, (log, sec) in enumerate(zip(sim.step_log, step_seconds)):
        hist = {b: cnt for b, cnt in enumerate(log["bins"]) if cnt}
        print(f"star-small PM step {i + 1}: {sec:.6f} s, {log['n_sub']} "
              f"substeps, bins {hist}, closing targets {log['actives']}",
              flush=True)
    pd = sim.pdata
    gas = sim.gas_mask
    check(int(pd.valid.sum()) == 2 * ngas and int(gas.sum()) == ngas,
          "particles lost")
    sph = sim.sph
    check(bool(torch.isfinite(pd.vel[pd.valid]).all()
               & torch.isfinite(sph.entropy[gas]).all()
               & torch.isfinite(sph.hydro_accel[gas]).all()
               & (sph.entropy[gas] > 0).all()),
          "gas state not finite or entropy not positive")
    # IC: mean comoving SPH density against the mean baryon density
    want = sim.CP.OmegaBaryon * sim.CP.RhoCrit
    rho_err = first["rho_vol"] / want - 1
    # the entropy floor (MinGasTemp), as the kicks apply it
    a3 = sim.atime ** 3
    minent = GAMMA_MINUS1 * sim._min_egy_spec / torch.clamp(
        sph.density / a3, min=1e-30) ** GAMMA_MINUS1
    floor_ratio = float((sph.entropy[gas] / minent[gas]).min())
    print(f"star-small IC: SPH density, volume-weighted mean (sum m / sum "
          f"m/rho) {first['rho_vol']:.9g} against Omega_b rho_crit "
          f"{want:.9g}: {rho_err:+.6f} (particle mean {first['rho']:.9g}); "
          f"final state: least entropy / floor {floor_ratio:.6f}",
          flush=True)
    check(abs(rho_err) < IC_RHO_TOL["star-small"], f"IC mean SPH density off "
          f"Omega_b rho_crit by {rho_err:+.4f}")
    check(floor_ratio >= 1.0, f"entropy below the MinGasTemp floor "
          f"({floor_ratio:.6f})")
    # every snapshot's gas blocks read back
    snaps = sorted(f for f in os.listdir(out) if f.startswith("PART_"))
    for name in snaps:
        bf = BigFile(os.path.join(out, name))
        hdr = snap_io.read_header(bf)
        check(int(hdr.TotNumPart[0]) == ngas, f"{name}: gas count")
        for block in ("Density", "SmoothingLength", "InternalEnergy",
                      "EgyWtDensity"):
            v = bf.open(f"0/{block}").read()
            check(len(v) == ngas and np.isfinite(v).all() and (v > 0).all(),
                  f"{name}: 0/{block} does not read back")
    pigs = sorted(f for f in os.listdir(out) if f.startswith("PIG_"))
    check(len(pigs) == sim.snapshot_count - 1 >= 1,
          f"star-small PIGs written: {pigs}")
    pig_groups = {}
    for name in pigs:
        ng, bins, last = pig_check(os.path.join(out, name),
                                   sim.cfg.fof_min_group_length)
        pig_groups[name] = ng
        print(f"{name}: read back and consistent; {ng} groups; halos per "
              f"log10(M/Msun) bin {bins}; largest {last:.6e} Msun",
              flush=True)
    files = sorted(f for f in os.listdir(out)
                   if f.startswith("powerspectrum-"))
    check(len(files) >= 2, f"power spectra written: {files}")
    kk, pk0, d0 = read_power(os.path.join(out, files[0]))
    kk1, pk1, d1 = read_power(os.path.join(out, files[-1]))
    nbins = min(6, len(kk))
    growth = np.interp(kk[:nbins], kk1, pk1) / pk0[:nbins]
    want_g = (d1 / d0) ** 2
    lin = kk[:nbins] <= GAS_PK_KMAX
    check(lin.sum() >= 2, f"star-small: fewer than two P(k) bins below "
          f"k = {GAS_PK_KMAX}")
    growth_err = float(np.max(np.abs(growth[lin] / want_g - 1)))
    print(f"star-small matter P(k) growth {files[0]} -> {files[-1]} over "
          f"{nbins} lowest-k bins k={kk[:nbins].tolist()}: {growth.tolist()}"
          f" against D1^2 ratio {want_g:.6f}; largest deviation at k <= "
          f"{GAS_PK_KMAX} h/Mpc ({int(lin.sum())} bins) {growth_err:.6f} "
          f"(rtol 0.18)", flush=True)
    check(growth_err <= 0.18, f"star-small P(k) growth off D1^2 by "
          f"{growth_err:.3f}")
    wt = dict(sim.walltime.totals)
    return dict(nsteps=nsteps, atime=sim.atime, launches=launches,
                step_seconds=step_seconds, run_seconds=run_seconds,
                genic_seconds=genic_s, walltime=wt, spy=spy,
                n_solves=n_solves, passes=[s[0] for s in spy.solves],
                rho_err=rho_err, floor_ratio=floor_ratio,
                momentum=max(spy.momentum), growth_err=growth_err,
                snapshots=snaps, pig_groups=pig_groups, sim=sim,
                stages=dict(sim.tree_timer.seconds), ngas=ngas,
                paramfile=paramfile,
                snapnum=int(os.path.basename(snap).split("_")[-1]))


def sph_stream_shape():
    """K4's and K5's CTA shape as csrc/sph_stream.cuh fixes it: (warps on
    a group, list entries a segment, sources a tile)."""
    import re
    from mpgadget_tpu_torch import kernels
    text = (kernels.CSRC / "sph_stream.cuh").read_text()
    warps = int(re.search(r"constexpr int WARPS = (\d+);", text).group(1))
    tile = int(re.search(r"constexpr int TILE = (\d+);", text).group(1))
    return warps, warps * 32, tile


def sph_critical_paths(tree, nbr, which):
    """The longest group's chain of dependent global loads in K4 (which
    "density") or K5 ("hydro"): (the redesign's, the first design's).
    Both begin with group_nodes -> the node's pstart/pcount -> the target
    rows (3 loads).  The first design then takes list[l] -> the leaf's
    pstart/pcount -> its rows, leaf after leaf, and one load more for
    every further 32 particles of a leaf.  The redesign takes list ->
    pstart/pcount once a segment, then the tiles of its busiest warp, one
    in flight ahead of the one computed: a load a tile (K5: two, the
    staged rows, then the first counted pair's body rows)."""
    import torch
    warps, seg, tile = sph_stream_shape()
    ng, LL = nbr.leaf_idx.shape
    nl = nbr.n_leaves.long()
    listed = torch.arange(LL, device=nl.device)[None, :] < nl[:, None]
    leaf = torch.clamp(nbr.leaf_idx.long(), 0, tree.capacity - 1)
    pc = torch.where(listed, tree.pcount[leaf], 0)
    simple = 3 + 2 * nl + ((pc + 31) // 32).sum(dim=1)
    nseg = (LL + seg - 1) // seg
    tot = torch.nn.functional.pad(pc, (0, nseg * seg - LL)).view(
        ng, nseg, seg).sum(dim=2)
    present = torch.arange(nseg, device=nl.device)[None, :] * seg \
        < nl[:, None]
    per_tile = 1 if which == "density" else 2
    busiest = ((tot + tile - 1) // tile + warps - 1) // warps
    new = 3 + torch.where(present, 2 + per_tile * busiest, 0).sum(dim=1)
    return int(new.max()), int(simple.max())


def simple_sums(which, args):
    """One launch of the first design of K4 (which "density",
    csrc/sph_density_simple.cu) or K5 ("hydro", csrc/sph_hydro_simple.cu)
    on a wrapper's arguments: the wrapper's checks and output, its entry
    point swapped for the yardstick's for this call; its launch count is
    left as it was."""
    import ctypes
    from mpgadget_tpu_torch import kernels
    from mpgadget_tpu_torch.sph import density, hydra

    mod = density if which == "density" else hydra
    kern = mod.density_kernel if which == "density" else mod.hydro_kernel
    name = f"sph_{which}_simple"
    fn = getattr(kernels.load(name), f"{name}_f32")
    fn.restype = ctypes.c_int
    fn.argtypes = mod._kernel().argtypes
    real, launches = mod._fn, mod.LAUNCHES
    mod._fn = fn
    try:
        return kern(*args)
    finally:
        mod._fn, mod.LAUNCHES = real, launches


def sph_errors(name, which, got, ref):
    """K4's or K5's outputs against the plain version's: the relative
    error by norm of each column and the largest absolute error; fails
    unless K5's maxsig is -inf at the same rows and equal bit for bit."""
    import torch
    from mpgadget_tpu_torch.sph import density, hydra

    names = (density if which == "density" else hydra).OUTPUTS
    rels = {}
    abs_err = 0.0
    for i, k in enumerate(names):
        x, y = got[:, i], ref[:, i]
        if k == "maxsig":
            fx, fy = torch.isfinite(x), torch.isfinite(y)
            check(bool(torch.equal(fx, fy)), f"{name}: maxsig -inf rows "
                  "differ from the plain version's")
            check(bool(torch.equal(x, y)), f"{name}: maxsig differs from "
                  "the plain version's in some bit")
            x, y = x[fx], y[fy]
        rels[k] = rel_norm(x.double(), y.double())
        abs_err = max(abs_err, float((x - y).abs().max()) if x.numel()
                      else 0.0)
    tol = {k: (MAXSIG_TOL if k == "maxsig" else SPH_TOL) for k in names}
    return rels, abs_err, {k: v for k, v in rels.items() if not v <= tol[k]}


def sph_kernel_case(name, which, args, G, l2_ns, reps=20):
    """K4 (which "density") or K5 ("hydro") on the inputs of one of its
    calls (tree, nbr, src, tgt, valid, ...) against its plain version on
    the card: outputs by norm within SPH_TOL (K5's maxsig within
    MAXSIG_TOL and bit for bit, -inf at the same rows), two launches
    bit-identical; the first design (simple_sums) held to the same; device
    times of the three (the two designs by CUDA graph replays, in turns:
    first, new, new, first), the pair counts, the bound and both designs'
    critical paths."""
    import torch
    from mpgadget_tpu_torch.ops import pairs
    from mpgadget_tpu_torch.sph import density, hydra

    mod = density if which == "density" else hydra
    kern = mod.density_kernel if which == "density" else mod.hydro_kernel
    plain = (mod.density_sums_reference if which == "density"
             else mod.hydro_sums_reference)
    tree, nbr, src, tgt, valid = args[:5]
    rest = args[5:]
    a = kern(*args)
    b = kern(*args)
    first = simple_sums(which, args)
    torch.cuda.synchronize()
    ref = plain(*args)
    torch.cuda.synchronize()
    same_bits = bool(torch.equal(a, b))
    check(same_bits, f"{name}: two launches of {which} kernel differ")
    rels, abs_err, bad = sph_errors(name, which, a, ref)
    first_rels, _, first_bad = sph_errors(f"{name} (first design)", which,
                                          first, ref)
    # the pair counts this run's data needs
    n = src.shape[0]
    gn = torch.clamp(nbr.group_nodes, max=tree.capacity - 1)
    tpc = torch.clamp(tree.pcount[gn], max=G)
    LL = nbr.leaf_idx.shape[1]
    listed = torch.arange(LL, device=gn.device)[None, :] \
        < nbr.n_leaves[:, None].long()
    leaf = torch.clamp(nbr.leaf_idx.long(), max=tree.capacity - 1)
    lsrc = torch.where(listed, tree.pcount[leaf], 0).sum(dim=1)
    total = int((tpc * lsrc).sum())
    n_listed = int(nbr.n_leaves.long().sum())
    le = max(1, int(tree.pcount[tree.is_leaf].max()))
    if which == "density":
        # pairs inside H: the plain engine counts them
        def fn(dx, r, tm, sm, tf, sf):
            return {"c": ((r * tf["hinv"] < 1.0) & sf["ok"]).float()}
        hinv = 1.0 / torch.clamp(tgt[:, 0], min=1e-30)
        within = int(pairs.pair_reduce(
            fn, nbr, tree, src[:, :3].contiguous(), {"hinv": hinv},
            {"ok": valid.bool()}, {"c": "sum"}, G, le)["c"].sum())
        ops = within * DENSITY_PAIR_OPS \
            + (total - within) * DENSITY_DISTANCE_OPS
        pb = DENSITY_PARTICLE_BYTES
    else:
        L = rest[1][0]
        def fn(dx, r, tm, sm, tf, sf):
            ri = r * L
            return {"c": (((ri < tf["h"]) | (ri < sf["h"])) & (ri > 0)
                          & sf["ok"]).float()}
        within = int(pairs.pair_reduce(
            fn, nbr, tree, src[:, :3].contiguous(), {"h": src[:, 7]},
            {"h": src[:, 7], "ok": valid.bool()}, {"c": "sum"}, G,
            le)["c"].sum())
        ops = within * HYDRO_PAIR_OPS + (total - within) * HYDRO_DISTANCE_OPS
        pb = HYDRO_PARTICLE_BYTES
    nbytes = (n * (pb[0] + pb[1]) + n_listed * 4 + nbr.n_leaves.shape[0] * 12
              + tree.capacity * 16)
    bound_ms, bound_by = bound(ops, nbytes)
    path, simple_path = sph_critical_paths(tree, nbr, which)
    # graph replays, so that the host's time to enqueue the wrapper's
    # call does not count
    turns = [graph_ms(lambda: simple_sums(which, args), reps),
             graph_ms(lambda: kern(*args), reps),
             graph_ms(lambda: kern(*args), reps),
             graph_ms(lambda: simple_sums(which, args), reps)]
    ms = 0.5 * (turns[1] + turns[2])
    simple_ms = 0.5 * (turns[0] + turns[3])
    plain_ms = time_ms(lambda: plain(*args), 2)
    path_ms = path * l2_ns * 1e-6
    simple_path_ms = simple_path * l2_ns * 1e-6
    print(f"kernel {which} ({name}): {nbr.n_leaves.shape[0]} groups, "
          f"{n_listed} listed leaves, {total} pairs evaluated, {within} "
          f"count; rel err by norm " + ", ".join(
              f"{k} {v:.3e}" for k, v in rels.items())
          + f" (tol {SPH_TOL:g}, maxsig {MAXSIG_TOL:g} and bit for bit); "
          f"max_abs_err {abs_err:.6e}; two launches bit-identical "
          f"{same_bits}; the first design's rel err " + ", ".join(
              f"{k} {v:.3e}" for k, v in first_rels.items())
          + f"; kernel_ms={ms:.6f} simple_ms={simple_ms:.6f} (turns "
          + " ".join(f"{t:.6f}" for t in turns) + f") plain_ms="
          f"{plain_ms:.6f} bound_ms={bound_ms:.6f} ({bound_by}); critical "
          f"path {path_ms:.6f} ms (longest group {path} dependent loads x "
          f"{l2_ns:.3f} ns), the first design's {simple_path_ms:.6f} ms "
          f"({simple_path} loads)", flush=True)
    check(not bad, f"{name}: {which} kernel disagrees with its plain "
          f"version: {bad}")
    check(not first_bad, f"{name}: the first design of the {which} kernel "
          f"disagrees with its plain version: {first_bad}")
    return dict(ms=ms, simple_ms=simple_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=abs_err,
                rel=rels, pairs=total, within=within,
                groups=nbr.n_leaves.shape[0], listed=n_listed,
                path_ms=path_ms, simple_path_ms=simple_path_ms,
                path_loads=path, simple_path_loads=simple_path)


def big_gas_case(workdir, l2_ns):
    """A bigger IC for K4 and K5: dm-small's paramfile.genic with
    ProduceGas 1 (2 x 64^3), one density solve from the initial hsml
    guess (setup_gas's) and one hydro call with unit entropy; the last
    pair-sum inputs of each, held to the plain versions."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.particles import pos_to_fixed
    from mpgadget_tpu_torch.sph import density, hydra

    over = dict(GENIC_OVERRIDE, ProduceGas=1)
    path, n, _ = gas_genic(workdir, "dm-small", over)
    bf = BigFile(path)
    hdr = snap_io.read_header(bf)
    sp = snap_io.read_species(bf, 0, hdr)
    box = hdr.BoxSize
    dev = torch.device("cuda")
    ipos = torch.as_tensor(pos_to_fixed(sp["pos"], box).astype(np.int64),
                           device=dev)
    mass = torch.as_tensor(sp["mass"], dtype=torch.float32, device=dev)
    vel = torch.as_tensor(sp["vel"], dtype=torch.float32, device=dev)
    gas = torch.ones(n, dtype=torch.bool, device=dev)
    hsml = torch.full((n,), float(np.float32(2.0 * box / np.cbrt(n))),
                      device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    with SphSpy("cuda") as spy:
        t0 = time.perf_counter()
        d = density.sph_density(ipos, mass, gas, hsml, vel, vel, ones,
                                density.DensityParams(), box)
        torch.cuda.synchronize()
        dens_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hydra.hydro_force(ipos, mass, gas, d["hsml"], vel, ones,
                          d["density"], d["egy_wt_density"], d["div_vel"],
                          d["curl_vel"], d["dhsml_egy_factor"],
                          hydra.HydroParams(), box, hdr.Time, 10.0, 0.01)
        torch.cuda.synchronize()
        hydro_s = time.perf_counter() - t0
    spy.check("dm-small with gas (2 x 64^3)")
    rho = d["density"].double()
    m = mass.double()
    rho_err = float(m.sum() / (m / rho).sum()) / float(m.sum() / box ** 3) - 1
    print(f"dm-small with gas: density solve {dens_s:.6f} s "
          f"({spy.solves[0][0]} bisection passes), hydro call "
          f"{hydro_s:.6f} s; IC SPH density, volume-weighted, against the "
          f"mean gas density (Omega_b rho_crit): {rho_err:+.6f} (particle "
          f"mean {float(rho.mean() / (m.sum() / box ** 3)) - 1:+.6f})",
          flush=True)
    check(abs(rho_err) < IC_RHO_TOL["dm-small"], f"dm-small gas IC mean SPH "
          f"density off by {rho_err:+.4f}")
    a, kw = spy.last["density_sums"]
    k4 = sph_kernel_case("dm-small 2 x 64^3 gas", "density", a, a[6], l2_ns)
    a, kw = spy.last["hydro_sums"]
    k5 = sph_kernel_case("dm-small 2 x 64^3 gas", "hydro", a,
                         a[5].group_max, l2_ns)
    return dict(k4=k4, k5=k5, density_s=dens_s, hydro_s=hydro_s,
                passes=spy.solves[0][0], n=n)


def sph_entry(name, which, gas, case, big):
    """The kernels line's entry of K4 or K5: times at the star-small run's
    final state, the bigger IC beside them."""
    src = {"density": ("sph_density.cu", "mpgadget_tpu/sph/density.py:52"),
           "hydro": ("sph_hydro.cu", "mpgadget_tpu/sph/hydra.py:45")}[which]
    keys = ("ms", "simple_ms", "plain_ms", "bound_ms", "bound_by", "pairs",
            "within", "groups", "listed", "path_ms", "simple_path_ms")
    return {
        "name": name, "route": "cuda",
        "source": f"mpgadget_tpu_torch/csrc/{src[0]}",
        "replaces": "mpgadget_tpu/ops/pairs.py:355", "pair_function": src[1],
        "launches": gas["launches"][which],
        "launches_by_path": {"star_small": gas["launches"][which]},
        "density_solves": gas["n_solves"],
        "bisection_passes": sum(gas["passes"]),
        "max_abs_err": max(case["max_abs_err"], big["max_abs_err"]),
        "max_rel_err": max(list(case["rel"].values())
                           + list(big["rel"].values())),
        "pairs": case["pairs"], "pairs_counted": case["within"],
        "dm_small_2x64": {k: big[k] for k in keys},
        "simple_source": f"mpgadget_tpu_torch/csrc/{src[0][:-3]}_simple.cu",
        "simple_ms": case["simple_ms"],
        "critical_path_ms": case["path_ms"],
        "simple_critical_path_ms": case["simple_path_ms"],
        "ms": case["ms"], "plain_ms": case["plain_ms"],
        "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
        "library_ms": None}


def main():
    if not os.path.isdir(os.path.join(HERE, "mpgadget_tpu_torch")):
        print("chip_smoke.py: mpgadget_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    try:
        return run()
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1


def run():
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print(card, flush=True)

    from mpgadget_tpu_torch import kernels
    from mpgadget_tpu_torch.gravity.tree import TreeConfig
    from mpgadget_tpu_torch.gravity.treewalk import WalkConfig
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"build (nvcc per source, in parallel): "
          f"{time.perf_counter() - t0:.3f} s; per source "
          f"{kernels.BUILD_SECONDS}", flush=True)
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # the main path's shapes and scalars for dm-small
    G = TreeConfig().group_max
    S = WalkConfig().src_cap
    nb = NGRID ** 3 // G
    rs_inv = float(np.float32(NMESH / 3.0))
    rcut = float(np.float32(6.0 * 1.5 / NMESH))
    soft = 2.8 * (1.0 / 30.0) * BOXSIZE / NGRID
    h_inv = float(np.float32(BOXSIZE / soft))
    kres = [kernel_phase(nb, G, S, rs_inv, h_inv, rcut),
            kernel_phase(nb, G, S, rs_inv, h_inv, rcut, counts=True)]

    l2_ns = l2_phase()
    with tempfile.TemporaryDirectory() as work:
        wres = walk_phase(work, l2_ns)

    accuracy_phase("cuda")

    with tempfile.TemporaryDirectory() as work:
        res = slice_phase(work, "cuda")
    if (res["src_cap"], res["group"], res["capacity"] // res["group"]) \
            != (S, G, nb):
        # an overflow retry changed the kernel's shapes: compare there too
        nb2, S2 = res["capacity"] // res["group"], res["src_cap"]
        kres += [kernel_phase(nb2, res["group"], S2, rs_inv, h_inv, rcut),
                 kernel_phase(nb2, res["group"], S2, rs_inv, h_inv, rcut,
                              counts=True)]
    steps = res["step_seconds"]
    print(f"slice dm-small 64^3 Nmesh {NMESH} on {card}: {res['nsteps']} "
          f"global KDK steps to a={res['atime']:.6f}; "
          f"tree-force evaluations {res['tree_force_calls']}, "
          f"kernel launches {res['launches']}", flush=True)
    print("step seconds: " + " ".join(f"{s:.6f}" for s in steps))
    print(f"particle-steps/s: {res['npart'] * len(steps) / sum(steps):.1f} "
          f"(all steps), {res['npart'] / min(steps):.1f} (fastest step) "
          f"on {card}")
    st = res["stages"]
    print("tree stage seconds, summed over all evaluations: " + ", ".join(
        f"{k} {v:.6f}" for k, v in st.items()) + f" on {card}")
    print(f"walk stage {st.get('walk', 0.0):.6f} s, K1 (pair) stage "
          f"{st.get('pair', 0.0):.6f} s on {card}")
    ser = res["series"]
    print("per evaluation: K1 sum(count) " + str(ser["pair_sources_sum"])
          + ", max(count) " + str(ser["pair_sources_max"])
          + "; walk tree nodes " + str(ser["walk_nodes"]) + ", visits "
          + str(ser["walk_visits_sum"]) + ", monopoles "
          + str(ser["walk_monopoles"]))
    npot = ser["with_potential"]      # the snapshot's evaluation
    k1_bound = sum(pair_bound(nb, G, s, wp)[0]
                   for s, wp in zip(ser["pair_sources_sum"], npot))
    k2_bound = sum(walk_bound(nb, G, WalkConfig().leaf_list_max, c, v, m,
                              wp)[0]
                   for c, v, m, wp in zip(ser["walk_nodes"],
                                          ser["walk_visits_sum"],
                                          ser["walk_monopoles"], npot))
    k2_serial = res["counts"]["walk_iterations"] * l2_ns * 1e-6
    print(f"slice bounds, all evaluations: K1 {k1_bound:.6f} ms for the "
          f"real sources at the full pair cost; walk {k2_bound:.6f} ms (a "
          f"serial walk's critical path would be {k2_serial:.6f} ms: "
          f"longest blocks' visits x one L2 round trip)")
    print(f"tree counts: {res['counts']}; overflow retries (capacities "
          f"that overflowed): {res['retries']}; final src_cap "
          f"{res['src_cap']}")
    wt = res["walltime"]
    print(f"PM seconds (all evaluations): {wt.get('PMgrav', 0.0):.6f}; "
          f"tree seconds: {wt.get('Tree', 0.0):.6f} on {card}")
    print(f"snapshot {res['snapshot']} read back; "
          f"{res['powerspectra']} power spectra written", flush=True)

    cres = compaction_phase(l2_ns)
    with tempfile.TemporaryDirectory() as work:
        gres = genic_phase(work)
        hres = hier_phase(work)
        fres = fof_phase(hres["sim"], hres["snapnum"])
        nres = neighbor_phase(fres, l2_ns)
        rres = restart_phase(work, hres["snapnum"], fres["groups"])
    hsteps = hres["step_seconds"]
    print(f"hierarchical dm-small 64^3 Nmesh {NMESH} from the genic IC on "
          f"{card}: {hres['nsteps']} PM steps to a={hres['atime']:.6f} in "
          f"{sum(hsteps):.6f} s of steps ({hres['run_seconds']:.6f} s with "
          f"the first forces and the last snapshot); tree-force evaluations "
          f"{hres['tree_force_calls']}, kernel launches {hres['launches']}",
          flush=True)
    print(f"force_evals {hres['force_evals']}: "
          f"{hres['force_evals'] / sum(hsteps):.1f} per second; PM steps "
          f"per second {hres['nsteps'] / sum(hsteps):.6f}; particle-steps/s "
          f"{hres['npart'] * hres['nsteps'] / sum(hsteps):.1f} on {card}")
    hst = hres["stages"]
    print("hierarchical tree stage seconds, summed over all evaluations: "
          + ", ".join(f"{k} {v:.6f}" for k, v in hst.items())
          + f"; PM seconds {hres['walltime'].get('PMgrav', 0.0):.6f}, tree "
          f"seconds {hres['walltime'].get('Tree', 0.0):.6f} on {card}")
    hser = hres["series"]
    print("per evaluation: active blocks " + str(hser["active_blocks"])
          + "; K1 sum(count) " + str(hser["pair_sources_sum"])
          + "; walk visits " + str(hser["walk_visits_sum"])
          + ", monopoles " + str(hser["walk_monopoles"]))
    hk1, hk2 = hier_bounds(hres)
    print(f"hierarchical bounds, all evaluations at their compacted nb: "
          f"K1 {hk1:.6f} ms (real sources at the full pair cost), K2 "
          f"{hk2:.6f} ms; overflow retries {hres['retries']}", flush=True)
    print(f"FOF in the hierarchical run: {len(hres['pig_groups'])} PIGs "
          f"{hres['pig_groups']}, {hres['walltime'].get('FOF', 0.0):.6f} s "
          f"(walltime 'FOF'); the final state's FOF {fres['seconds']:.6f} s "
          f"in-process, RestartFlag 3 {rres['seconds']:.6f} s as a process; "
          f"K3 launches {hres['launches']['neighbors']} (run), "
          f"{fres['launches']} (final state) on {card}", flush=True)

    with tempfile.TemporaryDirectory() as work:
        gas = gas_run_phase(work)
        spy = gas["spy"]
        a = spy.last["density_sums"][0]
        gk4 = sph_kernel_case("star-small final state", "density", a, a[6],
                              l2_ns)
        a = spy.last["hydro_sums"][0]
        gk5 = sph_kernel_case("star-small final state", "hydro", a,
                              a[5].group_max, l2_ns)
        grres = restart_phase(work, gas["snapnum"], "not run",
                              paramfile=gas["paramfile"])
    with tempfile.TemporaryDirectory() as work:
        big = big_gas_case(work, l2_ns)
    gst = gas["step_seconds"]
    gwt = gas["walltime"]
    print(f"star-small (2 x {gas['ngas']} particles, cuts "
          f"{GENIC_OVERRIDE} in genic and {GAS_SWITCHES_OFF} in the run) on "
          f"{card}: {gas['nsteps']} PM steps to a={gas['atime']:.6f} in "
          f"{sum(gst):.6f} s of steps ({gas['run_seconds']:.6f} s with the "
          f"gas set-up, the first forces and the last snapshot); walltime "
          + ", ".join(f"{k} {v:.6f}" for k, v in sorted(gwt.items()))
          + f" s; {gas['n_solves']} density solves, bisection passes "
          f"{sum(gas['passes'])} in all; kernel launches {gas['launches']}; "
          f"RestartFlag 3 {grres['seconds']:.6f} s", flush=True)
    print("star-small tree stage seconds: " + ", ".join(
        f"{k} {v:.6f}" for k, v in gas["stages"].items()), flush=True)

    check("jax" not in sys.modules, "jax was imported")
    k1 = kres[1][False]             # per-block counts, S = 4096
    k2 = wres[0]                    # the lattice's first tree, LL = 512
    launches = {k: res["launches"][k] + hres["launches"][k]
                + gas["launches"][k] for k in ("pair", "walk")}
    k3 = nres[0]                    # the final dm-small state's FOF inputs
    print(json.dumps({"kernels": [{
        "name": "block_pair_accumulate", "route": "cuda",
        "source": "mpgadget_tpu_torch/csrc/pairkernel.cu",
        "replaces": "mpgadget_tpu/gravity/pairkernel.py:129",
        "launches": launches["pair"],
        "launches_by_path": {"global": res["launches"]["pair"],
                             "hierarchical": hres["launches"]["pair"],
                             "star_small": gas["launches"]["pair"]},
        "max_abs_err": max([r[wp]["max_abs_err"] for r in kres
                            for wp in (False, True)]
                           + [cres["pair"]["max_abs_err"]]),
        "max_rel_err": max([r[wp]["rel"] for r in kres
                            for wp in (False, True)]
                           + [cres["pair"]["rel"]]),
        "compacted": {k: cres["pair"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")} | {"nb": cres["nb"]},
        "hierarchical_bound_ms": hk1,
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None}, {
        "name": "traverse_fused", "route": "cuda",
        "source": "mpgadget_tpu_torch/csrc/treewalk.cu",
        "replaces": "mpgadget_tpu/gravity/treewalk.py:114",
        "launches": launches["walk"],
        "launches_by_path": {"global": res["launches"]["walk"],
                             "hierarchical": hres["launches"]["walk"],
                             "star_small": gas["launches"]["walk"]},
        # over all walk cases, the clustered one's monopoles included
        "max_abs_err": max([r["max_abs_err"] for r in wres]
                           + [cres["walk"]["max_abs_err"]]),
        "max_rel_err": max([r["rel"] for r in wres]
                           + [cres["walk"]["rel"]]),
        "compacted": {k: cres["walk"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")} | {"nb": cres["nb"]},
        "hierarchical_bound_ms": hk2,
        "monopoles_compared": sum(r["monopoles"] for r in wres),
        "critical_path_ms": k2["path_ms"],
        "serial_critical_path_ms": k2["serial_path_ms"],
        "serial_walk_ms": k2["serial_ms"],
        "kernel_alone_ms": k2["alone_ms"], "eager_ms": k2["eager_ms"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None}, {
        "name": "find_neighbors", "route": "cuda",
        "source": "mpgadget_tpu_torch/csrc/neighbors.cu",
        "replaces": "mpgadget_tpu/ops/pairs.py:108",
        "launches": (hres["launches"]["neighbors"] + fres["launches"]
                     + gas["launches"]["neighbors"]),
        "launches_by_path": {"hierarchical": hres["launches"]["neighbors"],
                             "fof_final_state": fres["launches"],
                             "star_small": gas["launches"]["neighbors"]},
        # leaf lists, counts, flags and visits: identical on both sets
        # and in the serial mode
        "max_abs_err": max(r["max_abs_err"] for r in nres),
        "groups": k3["groups"], "leaf_list_max": k3["LL"],
        "visits": k3["visits"], "kernel_alone_ms": k3["alone_ms"],
        "critical_path_ms": k3["path_ms"],
        "serial_critical_path_ms": k3["serial_path_ms"],
        "serial_walk_ms": k3["serial_ms"],
        "walk_bound_ms": k3["walk_bound_ms"],
        "clusters": {k: nres[1][k] for k in (
            "ms", "alone_ms", "serial_ms", "plain_ms", "bound_ms",
            "bound_by", "walk_bound_ms", "path_ms", "serial_path_ms", "LL",
            "overflowed")},
        "serial_mode_ms": nres[2]["ms"],
        "kernel_split_ms": k3["split_ms"],
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": None}] + [sph_entry(name, which, gas, gk, big[key])
                                for name, which, gk, key in (
            ("sph_density_pairs", "density", gk4, "k4"),
            ("sph_hydro_pairs", "hydro", gk5, "k5"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
