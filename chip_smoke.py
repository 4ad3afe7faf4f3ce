#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mpgadget_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card; it
takes no arguments and imports nothing of JAX.  Phases, each of which
fails the run (non-zero exit, no result line) if it fails:

1. the card: CUDA must be available; prints the card's name and power
   limit as nvidia-smi reports them;
2. build: compiles both kernels, the pair kernel K1 (csrc/pairkernel.cu)
   and the walk kernel K2 (csrc/treewalk.cu), and the two measurement
   aids, one nvcc each, in parallel;
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
   paramfile.gadget as it ships (SplitGravityTimestepsOn 1), from that
   IC, with only SnapshotWithFOF set to 0 -> Simulation.run() to a = 0.25
   (HIER_STEPS) -> write_snapshot, the launch counts reset just
   before and read just after; per PM step its seconds, substeps, bin
   histogram and active targets per evaluation; finite state, no particle
   lost, the snapshot read back, and the growth of P(k) between the first
   and last outputs equal to D1^2 to rtol 0.18 (check_results.py:76-81).

Bounds ("bound_ms") are the larger of bytes over the card's memory rate
(3.35 TB/s) and FP32 operations over its FP32 peak (67 TFLOP/s, an FMA
counted as 2), for the work these inputs need: padding is not work, a
pair beyond rcut needs only its distance, and the walk reads each node
of the tree once (revisits hit L2).  Beside the walk's bound stands its
critical path, the longest chain of loads of which each needs the one
before, times one L2 round trip: the kernel's (the longest block's sum
of each round's longest sibling chain) and a serial walk's (the longest
block's visits).

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


def hier_phase(workdir, device="cuda", max_steps=HIER_STEPS, nmesh=None):
    """examples/dm-small/paramfile.gadget as it ships (hierarchical
    timebins) from the genic IC in workdir, SnapshotWithFOF off; both
    kernels' LAUNCHES are reset just before the run and read just after
    the snapshot."""
    import numpy as np
    import torch
    from mpgadget_tpu_torch.gravity import pairkernel as pk
    from mpgadget_tpu_torch.gravity import treewalk as tw
    from mpgadget_tpu_torch.gravity.treepm import StageTimer
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.main import build_simulation

    override = {"SnapshotWithFOF": 0}
    if nmesh is not None:       # a smaller rehearsal on the CPU
        override["Nmesh"] = nmesh
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        sim, _ = build_simulation(
            os.path.join(HERE, "examples", "dm-small", "paramfile.gadget"),
            override=override, device=device)
        check(sim.cfg.split_gravity_timesteps,
              "paramfile.gadget no longer sets SplitGravityTimestepsOn")
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
        t0 = time.perf_counter()
        nsteps = sim.run(max_steps=max_steps, verbose=True)
        snap = os.path.abspath(sim.write_snapshot())
        run_seconds = time.perf_counter() - t0
        launches = {"pair": pk.LAUNCHES, "walk": tw.LAUNCHES}
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
    if device == "cuda":
        for name, n in launches.items():
            check(n >= calls, f"{name} kernel launched {n} times for "
                  f"{calls} tree-force evaluations")
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
    return dict(nsteps=nsteps, atime=sim.atime, launches=launches,
                tree_force_calls=calls, force_evals=sim.force_evals,
                step_seconds=step_seconds, run_seconds=run_seconds,
                step_log=sim.step_log, stages=dict(sim.tree_timer.seconds),
                series=dict(sim.tree_timer.series),
                walltime=dict(sim.walltime.totals), retries=sim.tree_retries,
                leaf_list_max=sim._tree_grav.walk_cfg.leaf_list_max,
                group=sim._tree_grav.tree_cfg.group_max,
                growth_err=growth_err, npart=npart,
                snapshot=os.path.basename(snap), powerspectra=len(files))


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

    check("jax" not in sys.modules, "jax was imported")
    k1 = kres[1][False]             # per-block counts, S = 4096
    k2 = wres[0]                    # the lattice's first tree, LL = 512
    launches = {k: res["launches"][k] + hres["launches"][k]
                for k in ("pair", "walk")}
    print(json.dumps({"kernels": [{
        "name": "block_pair_accumulate", "route": "cuda",
        "source": "mpgadget_tpu_torch/csrc/pairkernel.cu",
        "replaces": "mpgadget_tpu/gravity/pairkernel.py:129",
        "launches": launches["pair"],
        "launches_by_path": {"global": res["launches"]["pair"],
                             "hierarchical": hres["launches"]["pair"]},
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
                             "hierarchical": hres["launches"]["walk"]},
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
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
