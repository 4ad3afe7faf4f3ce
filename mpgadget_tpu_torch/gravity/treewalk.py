"""Block tree walk and direct leaf sums (PyTorch port of
mpgadget_tpu/gravity/treewalk.py).

The targets are blocks of G consecutive Morton-sorted particles.  Each
block runs a stackless preorder walk over the skip-pointer tree
(descend = i+1, reject/accept = skip[i]); accepted nodes' monopoles are
applied to the block's G targets inside the walk, and opened leaves are
recorded.  On CUDA tensors :func:`traverse_fused` launches the
hand-written walk kernel ``csrc/treewalk.cu`` (one launch per call; it
takes the same nodes in parallel, see :func:`walk_kernel`); on CPU
tensors it runs :func:`traverse_fused_reference`, a plain batched loop.
The opened leaves' particle ranges are then packed into a dense per-block
source buffer and evaluated as block-dense pair interactions by
``pairkernel.block_pair_accumulate`` (the CUDA kernel on CUDA tensors).

Opening criteria mirror shall_we_open_node (gravshort-tree.c:221-245):
relative acceleration (mass*len^2 > r^4*aold), Barnes-Hut angle
fallback/cap, and the "inside" guard, made conservative at block level
by using the nearest distance from the block's particle bounding box and
the block-minimum aold.

Translation notes: JAX ``mode="drop"`` scatters become masked writes
(or a spare column that takes the dropped writes); ``lax.cummax`` is
``torch.cummax(...).values``; the plain walk keeps the node skip pointer
and leaf flag as separate integer tensors, the kernel's node table packs
them into one int32 (:func:`pack_nodes`).
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from . import pairkernel
from .shortrange import (shortrange_force_window, shortrange_pot_window,
                         softened_force_factor, softened_pot_factor)


@dataclass(frozen=True)
class WalkConfig:
    leaf_list_max: int = 512    # opened leaves recorded per block
    src_cap: int = 4096         # direct-source slots per block (a
    #                             multiple of sub)
    sub: int = 8                # sub-row width: leaves are padded to
    #                             ceil(count/sub)*sub aligned slots
    nleaf_frac: float = 0.15    # leaf-table capacity = frac * N + 256
    sr_frac: float = 0.16       # sub-row capacity  = frac * N + 256
    chunk: int = 512            # source slots per plain-version chunk


# plain walk: iterations between host checks for "every block finished"
# (each check synchronises with the device; extra iterations are masked
# no-ops)
DONE_CHECK = 16
MAX_G = 1024
STACK_CAP = 3072                # the walk kernel's stack entries per block
LEAF_BIT = -2 ** 31             # leaf flag of the packed int32 node meta

LAUNCHES = 0                    # walk kernel launches (not plain calls)
_fn = None


def _wrap(d):
    """Minimum image for box-unit coordinates."""
    return d - torch.round(d)


def _cummax(x, dim=-1):
    return torch.cummax(x, dim=dim).values


def make_block_groups(pos_box, valid_s, amag_s, group_size):
    """Fixed-size target blocks over the Morton-sorted particle array.

    Returns (tpos f32[nb,G,3], center f32[nb,3], half f32[nb,3],
    amin f32[nb], active bool[nb]).
    """
    n = pos_box.shape[0]
    G = group_size
    if n % G:
        raise ValueError("particle capacity must be a multiple of group size")
    nb = n // G
    p = pos_box.reshape(nb, G, 3)
    mask = valid_s.reshape(nb, G)
    anchor = p[:, :1, :]
    rel = _wrap(p - anchor)
    rel = torch.where(mask[:, :, None], rel, 0.0)
    lo = rel.min(dim=1).values
    hi = rel.max(dim=1).values
    center = anchor[:, 0, :] + 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    am = torch.where(mask, amag_s.reshape(nb, G), float("inf"))
    amin = am.min(dim=1).values
    amin = torch.where(torch.isfinite(amin), amin, 0.0)
    active = mask.any(dim=1)
    return p, center, half, amin, active


def make_target_groups(tree, pos_box, amag_sorted, group_cap, group_max):
    """Compact target-group node list + per-group bbox and min |aold|
    (the node-group variant the neighbour engine, ops/pairs.py, uses).

    Group nodes are the highest tree nodes with count <= group_max
    (tree.is_group): true octree cells, so their bounding boxes are
    tight.  Returns (group_nodes int64[group_cap]: node index, 2^30 for
    padding; center f32[group_cap,3]; half f32[group_cap,3]; amin
    f32[group_cap]; n_groups; overflow).
    """
    dev = pos_box.device
    C = tree.capacity
    iota = torch.arange(C, device=dev)
    is_group = tree.is_group & (iota < tree.n_nodes)
    # stable compaction of group indices (DFS order preserved)
    order = torch.argsort((~is_group).to(torch.int8), stable=True)
    n_groups = is_group.sum()
    slot = torch.arange(group_cap, device=dev)
    nodes = torch.where(slot < n_groups, order[:group_cap], C - 1)
    overflow = n_groups > group_cap

    n = pos_box.shape[0]
    off = torch.arange(group_max, device=dev)
    ps = tree.pstart[nodes]
    pc = tree.pcount[nodes]
    idx = torch.clamp(ps[:, None] + off[None, :], 0, n - 1)
    mask = off[None, :] < pc[:, None]
    p = pos_box[idx]
    # min-image-safe bbox: anchor on the first particle
    anchor = p[:, :1, :]
    rel = torch.where(mask[:, :, None], _wrap(p - anchor), 0.0)
    lo = rel.min(dim=1).values
    hi = rel.max(dim=1).values
    center = anchor[:, 0, :] + 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    am = torch.where(mask, amag_sorted[idx], float("inf"))
    amin = am.min(dim=1).values
    amin = torch.where(torch.isfinite(amin), amin, 0.0)
    # padding groups: a sentinel node so that their walk starts done
    nodes = torch.where(slot >= n_groups, 2 ** 30, nodes)
    return nodes, center, half, amin, n_groups, overflow


def pack_meta(tree):
    """int32[C]: each node's skip pointer with the leaf flag in bit 31, as
    the walk kernels (treewalk.cu, neighbors.cu) read it."""
    return tree.skip.to(torch.int32) | torch.where(
        tree.is_leaf, LEAF_BIT, 0).to(torch.int32)


def pack_nodes(tree):
    """The walk kernel's node table, packed once per tree.

    Returns (nodes f32[C, 8], meta int32[C]): each node is two 16-byte
    rows, (center, length) and (com, mass), and :func:`pack_meta`.
    """
    nodes = torch.cat([tree.center, tree.length[:, None], tree.com,
                       tree.mass[:, None]], dim=1).contiguous()
    return nodes, pack_meta(tree)


def _count(timer, tree, visits, monopoles):
    """Walk statistics for a StageTimer: the longest block's node visits
    ("walk_iterations"), and per evaluation the tree's nodes, the
    visits' sum and the monopoles applied (one read from the device)."""
    if timer is None:
        return
    longest = visits.max() if visits.numel() else visits.sum()
    longest, nodes, total, mono = torch.stack(
        [longest.long(), tree.n_nodes.long(), visits.sum(),
         monopoles.sum()]).tolist()
    timer.count("walk_iterations", longest)
    timer.record("walk_nodes", nodes)
    timer.record("walk_visits_sum", total)
    timer.record("walk_monopoles", mono)


def traverse_fused_reference(tree, tpos, center, half, aold, active,
                             cfg: WalkConfig, rcut, bh_angle2, use_bh,
                             rs_inv, h_inv, with_potential=False,
                             timer=None):
    """Plain version of :func:`traverse_fused`: a batched loop in which
    every iteration advances all unfinished blocks by one node, with
    masks, until every block is done (the JAX package runs a vmapped
    while_loop).  Same contract as :func:`traverse_fused`."""
    dev = tpos.device
    nb, G, _ = tpos.shape
    LL = cfg.leaf_list_max
    C = tree.capacity
    n_nodes = tree.n_nodes
    rcut2 = rcut * rcut
    node_f = torch.cat([tree.center, tree.length[:, None],
                        tree.mass[:, None], tree.com], dim=1)   # (C, 8)
    tx, ty, tz = tpos[:, :, 0], tpos[:, :, 1], tpos[:, :, 2]
    rows = torch.arange(nb, device=dev)

    i = torch.where(active, 0, n_nodes)
    nl = torch.zeros(nb, dtype=torch.int64, device=dev)
    # column LL takes the writes the JAX walk drops (list full / no leaf)
    leaves = torch.full((nb, LL + 1), C, dtype=torch.int64, device=dev)
    ovf = torch.zeros(nb, dtype=torch.bool, device=dev)
    visits = torch.zeros(nb, dtype=torch.int64, device=dev)
    monopoles = torch.zeros(nb, dtype=torch.int64, device=dev)
    ax = torch.zeros((nb, G), dtype=torch.float32, device=dev)
    ay = torch.zeros_like(ax)
    az = torch.zeros_like(ax)
    pot = torch.zeros_like(ax)
    it = 0
    while it % DONE_CHECK or bool((i < n_nodes).any()):
        it += 1
        live = i < n_nodes
        visits += live.to(torch.int64)
        ic = torch.clamp(i, max=C - 1)
        row = node_f[ic]
        c, ln, m, com = row[:, 0:3], row[:, 3], row[:, 4], row[:, 5:8]
        leaf = tree.is_leaf[ic]
        skip = tree.skip[ic]
        dc = torch.abs(_wrap(c - center))
        dmin = torch.clamp(dc - half - 0.5 * ln[:, None], min=0.0)
        r2min = (dmin[:, 0] * dmin[:, 0] + dmin[:, 1] * dmin[:, 1]
                 + dmin[:, 2] * dmin[:, 2])
        discard = r2min > rcut2
        rel_open = m * ln * ln > r2min * r2min * aold
        bh_open = ln * ln > bh_angle2 * r2min
        # relative mode still opens at the max BH angle cap
        # (gravshort-tree.c:227-233)
        if use_bh:
            crit_open = bh_open
        else:
            crit_open = torch.where(aold <= 0, bh_open, rel_open | bh_open)
        inside = (dc < half + 0.6 * ln[:, None]).all(dim=1)
        must_open = crit_open | inside | (r2min <= 0)
        keep = live & ~discard
        use_node = keep & ~must_open
        rec_leaf = keep & must_open & leaf
        descend = keep & must_open & ~leaf
        monopoles += use_node.to(torch.int64)
        # an iteration in which no block applies a monopole would add only
        # zeros: skip its terms (one host read; most iterations of a walk
        # open or discard)
        if bool(use_node.any()):
            dx = _wrap(com[:, 0:1] - tx)
            dy = _wrap(com[:, 1:2] - ty)
            dz = _wrap(com[:, 2:3] - tz)
            r = torch.sqrt(dx * dx + dy * dy + dz * dz)
            on = use_node[:, None] & (r < rcut)
            w = torch.where(on, m[:, None] * softened_force_factor(r, h_inv)
                            * shortrange_force_window(r, rs_inv), 0.0)
            ax += w * dx
            ay += w * dy
            az += w * dz
            if with_potential:
                pot += torch.where(
                    on, m[:, None] * softened_pot_factor(r, h_inv)
                    * shortrange_pot_window(r, rs_inv), 0.0)
        room = nl < LL
        leaves[rows, torch.where(rec_leaf & room, nl, LL)] = i
        ovf |= rec_leaf & ~room
        nl += (rec_leaf & room).to(torch.int64)
        i = torch.where(live, torch.where(descend, i + 1, skip), i)
    _count(timer, tree, visits, monopoles)
    acc = torch.stack([ax, ay, az], dim=1)
    return acc, pot, leaves[:, :LL], nl, ovf


def _kernel():
    global _fn
    if _fn is None:
        fn = kernels.load("treewalk").tree_walk_f32
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 3 + [ctypes.c_int]
                       + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        _fn = fn
    return _fn


def walk_kernel(tree, tpos, center, half, aold, active, cfg, rcut, bh_angle2,
                use_bh, rs_inv, h_inv, with_potential=False,
                stack_cap=STACK_CAP, packed=None):
    """One launch of the walk kernel on CUDA tensors (no synchronisation).

    Returns :func:`traverse_fused`'s five results and a dict of int32[nb]
    device tensors: "visits" and "monopoles" (nodes visited, monopoles
    applied), "rounds" (rounds of the block's stack), "loads" (the
    dependent loads on the block's critical path: each round's longest
    sibling chain) and "serial" (nodes visited in the serial mode that
    takes over when the stack has no room; see csrc/treewalk.cu).
    stack_cap below STACK_CAP only serves to test that mode; packed: the
    tree's :func:`pack_nodes`, if the caller has it already.
    """
    global LAUNCHES
    nb, G, _ = tpos.shape
    LL = cfg.leaf_list_max
    C = tree.capacity
    dev = tpos.device
    if G > MAX_G:
        raise ValueError(f"group size {G} > {MAX_G} targets per block")
    if not 1 <= stack_cap <= STACK_CAP:
        raise ValueError(f"stack_cap {stack_cap} outside [1, {STACK_CAP}]")
    if not 1 <= C < 2 ** 30:
        raise ValueError(f"tree capacity {C} outside [1, 2^30)")
    nodes, meta = pack_nodes(tree) if packed is None else packed
    f32, i32 = torch.float32, torch.int32
    for name, t, shape, dtype in (
            ("tpos", tpos, (nb, G, 3), f32), ("center", center, (nb, 3), f32),
            ("half", half, (nb, 3), f32), ("aold", aold, (nb,), f32),
            ("active", active, (nb,), torch.bool),
            ("tree nodes", nodes, (C, 8), f32), ("tree meta", meta, (C,), i32),
            ("tree.n_nodes", tree.n_nodes, (), torch.int64)):
        kernels.check_tensor(name, t, shape, dtype)
        if t.device != dev:
            raise ValueError("walk inputs must be on one device")
    fn = _kernel()
    acc = torch.empty((nb, 3, G), dtype=f32, device=dev)
    pot = torch.empty((nb, G), dtype=f32, device=dev)
    leaves = torch.empty((nb, LL), dtype=torch.int64, device=dev)
    nl = torch.empty(nb, dtype=torch.int64, device=dev)
    ovf = torch.empty(nb, dtype=torch.bool, device=dev)
    stats = {name: torch.empty(nb, dtype=i32, device=dev)
             for name in ("visits", "monopoles", "rounds", "loads",
                         "serial")}
    # a Python float meets an f32 tensor in PyTorch rounded to f32: pass
    # the plain version's scalars the same way (rcut * rcut in double)
    with torch.cuda.device(dev):
        rc = fn(nodes.data_ptr(), meta.data_ptr(), tree.n_nodes.data_ptr(),
                tpos.data_ptr(), center.data_ptr(), half.data_ptr(),
                aold.data_ptr(), active.data_ptr(), acc.data_ptr(),
                pot.data_ptr(), leaves.data_ptr(), nl.data_ptr(),
                ovf.data_ptr(), stats["visits"].data_ptr(),
                stats["monopoles"].data_ptr(), stats["rounds"].data_ptr(),
                stats["loads"].data_ptr(), stats["serial"].data_ptr(), nb,
                G, C, LL, int(stack_cap),
                float(rcut), float(np.float32(rcut * rcut)),
                float(np.float32(bh_angle2)), int(bool(use_bh)),
                float(rs_inv), float(h_inv), int(with_potential),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"walk kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return (acc, pot, leaves, nl, ovf), stats


def traverse_fused(tree, tpos, center, half, aold, active, cfg: WalkConfig,
                   rcut, bh_angle2, use_bh, rs_inv, h_inv,
                   with_potential=False, timer=None):
    """Skip-pointer walk per block with fused monopole evaluation.

    aold: ErrTolForceAcc * min |old accel| over the block in box-unit
    force units; <= 0 means BH opening.  CPU tensors run the plain
    version; any other tensor launches the walk kernel (one launch) or
    raises.

    Returns (acc f32[nb,3,G] component-major, pot f32[nb,G], leaf_idx
    int64[nb,LL] (unused slots hold tree.capacity), n_leaves int64[nb],
    overflow bool[nb]) in box-unit force units.  timer: optional
    treepm.StageTimer; counts the longest block's node visits
    ("walk_iterations") and records per-evaluation visit statistics.
    """
    if tpos.device.type == "cpu":
        return traverse_fused_reference(
            tree, tpos, center, half, aold, active, cfg, rcut, bh_angle2,
            use_bh, rs_inv, h_inv, with_potential=with_potential,
            timer=timer)
    res, stats = walk_kernel(tree, tpos, center, half, aold, active, cfg,
                             rcut, bh_angle2, use_bh, rs_inv, h_inv,
                             with_potential=with_potential)
    _count(timer, tree, stats["visits"], stats["monopoles"])
    return res


def make_leaf_sources(tree, pos_box, mass_sorted, valid_sorted, nleaf_cap,
                      sr_cap, sub=8):
    """Sub-row-padded leaf source buffers, built once per tree.

    Each leaf's particle range is padded up to a multiple of ``sub``
    aligned slots and packed as one f32 row [x*sub, y*sub, z*sub, m*sub]
    per sub-row; padding slots carry zero mass.

    Returns (packed f32[sr_cap, 4*sub], node_first_sub int64[C],
    node_nsub int64[C], overflow).
    """
    dev = pos_box.device
    n = pos_box.shape[0]
    C = tree.capacity
    iota_c = torch.arange(C, device=dev)
    is_leaf = tree.is_leaf & (iota_c < tree.n_nodes) & (tree.pcount > 0)
    rank = torch.cumsum(is_leaf.to(torch.int64), 0) - 1
    nleaf = is_leaf.sum()
    # compact leaf list (masked write = the JAX drop-mode scatter)
    leaf_nodes = torch.zeros(nleaf_cap, dtype=torch.int64, device=dev)
    sel = is_leaf & (rank < nleaf_cap)
    leaf_nodes[rank[sel]] = iota_c[sel]
    lrow = torch.arange(nleaf_cap, device=dev)
    lok = lrow < nleaf
    pc = torch.where(lok, tree.pcount[leaf_nodes], 0)
    n_sub = (pc + (sub - 1)) // sub
    first_sub = torch.cumsum(n_sub, 0) - n_sub
    total_sub = first_sub[-1] + n_sub[-1]
    overflow = (nleaf > nleaf_cap) | (total_sub > sr_cap)

    # sub-row -> leaf by masked scatter-max + forward fill
    dest = torch.where(n_sub > 0, torch.clamp(first_sub, max=sr_cap), sr_cap)
    mark = torch.zeros(sr_cap, dtype=torch.int64, device=dev)
    ok = dest < sr_cap
    mark.scatter_reduce_(0, dest[ok], lrow[ok], reduce="amax")
    lof = _cummax(mark)                                   # (SR,)
    srow = torch.arange(sr_cap, device=dev)
    off = srow - first_sub[lof]
    sstart = tree.pstart[leaf_nodes[lof]] + sub * off
    cnt = torch.clamp(pc[lof] - sub * off, 0, sub)
    cnt = torch.where(srow < total_sub, cnt, 0)

    slot = torch.arange(sub, device=dev)[None, :]
    idx = torch.clamp(sstart[:, None] + slot, 0, n - 1)
    okm = (slot < cnt[:, None]) & valid_sorted[idx]
    sm = torch.where(okm, mass_sorted[idx], 0.0)
    packed = torch.cat([pos_box[idx, 0], pos_box[idx, 1], pos_box[idx, 2],
                        sm], dim=1)                        # (SR, 4*sub)

    # node-indexed sub-row tables for the walk's recorded leaf ids
    node_first_sub = torch.zeros(C, dtype=torch.int64, device=dev)
    node_nsub = torch.zeros(C, dtype=torch.int64, device=dev)
    node_first_sub[leaf_nodes[lok]] = first_sub[lok]
    node_nsub[leaf_nodes[lok]] = n_sub[lok]
    return packed, node_first_sub, node_nsub, overflow


def evaluate_leaves(tree, leaf_src, tpos, leaf_idx, n_leaves, acc0, pot0,
                    cfg: WalkConfig, rs_inv, h_inv, rcut,
                    with_potential=True, timer=None):
    """Direct (leaf) interactions added to the fused-walk accumulators.

    The opened leaves' sub-rows (see :func:`make_leaf_sources`) are
    compacted into a dense per-block source buffer of cfg.src_cap slots
    and summed by ``pairkernel.block_pair_accumulate``: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors.  Each block's
    count of filled slots goes with it, so the padding is not computed.

    Returns (acc f32[N,3], pot f32[N], overflow bool[nb]) in sorted
    particle order.  timer: optional treepm.StageTimer ("pack", "pair"
    seconds; per evaluation the sum and maximum of the source counts).
    """
    packed, node_first_sub, node_nsub, _ = leaf_src
    dev = tpos.device
    nb, G, _ = tpos.shape
    n = nb * G
    LL = cfg.leaf_list_max
    sub = cfg.sub
    S = cfg.src_cap
    if S % sub:
        raise ValueError("src_cap must be a multiple of sub")
    SS = S // sub                   # sub-row slots per block
    SR = packed.shape[0]

    safe_leaf = torch.clamp(leaf_idx, max=tree.capacity - 1)
    in_list = (torch.arange(LL, device=dev)[None, :] < n_leaves[:, None]) \
        & (leaf_idx < tree.n_nodes)
    lsub = torch.where(in_list, node_nsub[safe_leaf], 0)   # (nb, LL)
    lfirst = node_first_sub[safe_leaf]
    prefix = torch.cumsum(lsub, 1) - lsub                  # exclusive
    total = prefix[:, -1] + lsub[:, -1]
    overflow = total > SS

    # slot -> (leaf-list position, offset) by masked scatter-max + fill
    dest = torch.where(lsub > 0, torch.clamp(prefix, max=SS), SS)
    lpos = torch.arange(LL, device=dev)[None, :].expand(nb, LL)
    flat = torch.arange(nb, device=dev)[:, None] * SS + dest
    ok = dest < SS
    mark = torch.zeros(nb * SS, dtype=torch.int64, device=dev)
    mark.scatter_reduce_(0, flat[ok], lpos[ok], reduce="amax")
    lid = _cummax(mark.reshape(nb, SS), dim=1)             # (nb, SS)
    s_iota = torch.arange(SS, device=dev)[None, :]
    srow = (torch.gather(lfirst, 1, lid)
            + (s_iota - torch.gather(prefix, 1, lid)))
    src_ok = s_iota < torch.clamp(total, max=SS)[:, None]
    srow = torch.clamp(srow, 0, SR - 1)

    # ONE row gather of packed sub-rows, then unpack to component-separate
    # (nb, S) arrays
    rows4 = packed[srow].reshape(nb, SS, 4, sub).permute(2, 0, 1, 3)
    sx = rows4[0].reshape(nb, S)
    sy = rows4[1].reshape(nb, S)
    sz = rows4[2].reshape(nb, S)
    smass = torch.where(src_ok[:, :, None], rows4[3], 0.0).reshape(nb, S)
    tx = tpos[:, :, 0].contiguous()
    ty = tpos[:, :, 1].contiguous()
    tz = tpos[:, :, 2].contiguous()
    sx, sy, sz, smass = (a.contiguous() for a in (sx, sy, sz, smass))
    acc0 = acc0.contiguous()
    pot0 = pot0.contiguous()
    # real sources per block: the filled sub-rows; the rest is padding
    count = (torch.clamp(total, max=SS) * sub).to(torch.int32)
    if timer is not None:
        timer.lap("pack")
        timer.record("pair_sources_sum", int(count.sum()))
        timer.record("pair_sources_max", int(count.max()))

    acc_b, pot = pairkernel.block_pair_accumulate(
        tx, ty, tz, sx, sy, sz, smass, acc0, pot0, float(rs_inv),
        float(h_inv), float(rcut), chunk=cfg.chunk,
        with_potential=with_potential, count=count)
    if timer is not None:
        timer.lap("pair")
    acc = acc_b.transpose(1, 2).reshape(n, 3)
    return acc, pot.reshape(n), overflow
