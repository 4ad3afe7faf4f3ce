"""Generic neighbour-pair reduction engine over the Morton octree
(PyTorch port of mpgadget_tpu/ops/pairs.py).

Every neighbour-loop module supplies a *pair function* evaluated on dense
(target-group x source) blocks; the engine finds the neighbour leaves of
each target group (:func:`find_neighbors`: on CUDA tensors the
hand-written walk kernel ``csrc/neighbors.cu``, K3; on CPU tensors its
plain version :func:`find_neighbors_reference`), then gathers, masks and
reduces (:func:`pair_reduce`, plain PyTorch).

Usage:
    nbr = find_neighbors(tree, group_nodes, center, half, radius, ...)
    out = pair_reduce(pair_fn, nbr, tree, pos_box, target_feats,
                      source_feats, reducers, group_max, leaf_eval_max)

pair_fn(dx, r, tmask, smask, tfeat, sfeat) -> dict of tensors shaped
(B, G, S) to be reduced over S with the per-key reducer: 'sum' and 'max'
(float32, as in the JAX package) or 'min' (int64: integer labels, which
the JAX package carries as float32, exact only below 2^24 rows).  dx is
source - target (box units, min-image).

SPH uses :func:`compact_leaves` and :func:`node_hmax` (the symmetric
search's per-node hmax) besides the walk; its pair sums are kernels of
their own (sph/density.py K4, sph/hydra.py K5) whose plain versions run
:func:`pair_reduce`.  Not carried, by design: ``pack_sources``,
``pair_reduce_packed`` and ``flatten_source_feats``, which pack each
leaf's sources into contiguous sub-rows so that a TPU gathers whole
rows; the SPH kernels read a listed leaf's particles straight from the
Morton-sorted arrays through ``pstart``/``pcount``.
"""

import ctypes
from dataclasses import dataclass
from typing import Dict

import torch

from .. import kernels
from ..gravity.treewalk import DONE_CHECK, pack_meta

INT_FILL = torch.iinfo(torch.int64).max   # the 'min' reducer's identity
# pair_reduce evaluates this many (target, source) pair slots per batch:
# its dx tensor then takes 96 MiB
PAIR_SLOTS_PER_BATCH = 1 << 23

LAUNCHES = 0                    # K3 launches (not plain calls)
STACK_CAP = 64                  # K3's stack entries per target group
_fn = None


def _wrap(d):
    return d - torch.round(d)


def compact_leaves(tree, leaf_cap):
    """DFS-ordered compacted leaf list (int32[leaf_cap], count, overflow);
    unused slots hold tree.capacity - 1."""
    C = tree.capacity
    iota = torch.arange(C, device=tree.skip.device)
    is_leaf = tree.is_leaf & (iota < tree.n_nodes)
    order = torch.argsort((~is_leaf).to(torch.int8), stable=True)
    n_leaves = is_leaf.sum()
    slot = torch.arange(leaf_cap, device=iota.device)
    leaves = torch.where(slot < n_leaves, order[:leaf_cap], C - 1)
    return leaves.to(torch.int32), n_leaves, n_leaves > leaf_cap


def node_hmax(tree, leaf_ids, n_leaves, hsml_sorted):
    """Max Hsml over every node's particles (force_update_hmax analog):
    float32[C], 0 where a node holds no particle with Hsml.

    Each particle's value goes to its leaf and to every ancestor of the
    leaf by a scatter max, one tree level at a time (in DFS preorder a
    node's ancestor at level l is the last node of level l at or before
    it).  A max is exact, so this gives the JAX package's values, which
    it takes from a doubling table over the DFS-ordered leaves (a TPU
    workaround).  The JAX package reads a leaf's first ``leaf_max`` (16)
    particles only; a leaf holds more only at the deepest level, so the
    two agree wherever no leaf holds more than 16.
    """
    dev = hsml_sorted.device
    n = hsml_sorted.shape[0]
    C = tree.capacity
    nl = int(n_leaves)
    leaves = leaf_ids[:nl].to(torch.int64)
    ps = tree.pstart[leaves]
    pj = torch.arange(n, device=dev)
    k = torch.clamp(torch.searchsorted(ps, pj, right=True) - 1, min=0)
    leaf = leaves[k] if nl else torch.zeros_like(pj)
    inside = (pj < ps[k] + tree.pcount[leaves][k]) if nl \
        else torch.zeros_like(pj, dtype=torch.bool)
    iota = torch.arange(C, device=dev)
    real = iota < tree.n_nodes
    hm = torch.zeros(C + 1, dtype=torch.float32, device=dev)  # row C: dump
    leaf_level = tree.level[leaf]
    for lev in range(int(leaf_level[inside].max()) + 1 if nl else 0):
        last = torch.cummax(torch.where(real & (tree.level == lev), iota,
                                        -1), dim=0).values
        anc = last[leaf]
        ok = inside & (leaf_level >= lev) & (anc >= 0)
        hm.scatter_reduce_(0, torch.where(ok, anc, C), hsml_sorted,
                           reduce="amax")
    return hm[:C]


@dataclass
class NeighborLists:
    leaf_idx: torch.Tensor     # int32[ngroups, LL] source-leaf node ids
    #                            (unused slots hold tree.capacity)
    n_leaves: torch.Tensor     # int32[ngroups]
    overflow: torch.Tensor     # bool[ngroups]
    group_nodes: torch.Tensor  # int64[ngroups]
    visits: torch.Tensor       # int32[ngroups] nodes each walk visited


def find_neighbors_reference(tree, group_nodes, group_center, group_half,
                             group_radius, hmax, leaf_list_max,
                             symmetric=True):
    """Plain version of :func:`find_neighbors`: a batched loop in which
    every iteration advances all unfinished groups by one node, with
    masks, until every group is done (the JAX package runs a vmapped
    while_loop).  Same contract as :func:`find_neighbors`."""
    dev = group_center.device
    ng = group_nodes.shape[0]
    LL = leaf_list_max
    C = tree.capacity
    n_nodes = tree.n_nodes
    rows = torch.arange(ng, device=dev)
    hm = hmax if symmetric else None

    i = torch.where(group_nodes < n_nodes, 0, n_nodes)
    nl = torch.zeros(ng, dtype=torch.int64, device=dev)
    # column LL takes the writes the JAX walk drops (list full / no leaf)
    leaves = torch.full((ng, LL + 1), C, dtype=torch.int64, device=dev)
    ovf = torch.zeros(ng, dtype=torch.bool, device=dev)
    visits = torch.zeros(ng, dtype=torch.int64, device=dev)
    it = 0
    while it % DONE_CHECK or bool((i < n_nodes).any()):
        it += 1
        live = i < n_nodes
        visits += live.to(torch.int64)
        ic = torch.clamp(i, max=C - 1)
        dc = torch.abs(_wrap(tree.center[ic] - group_center))
        dmin = torch.clamp(dc - group_half - 0.5 * tree.length[ic][:, None],
                           min=0.0)
        r2min = (dmin[:, 0] * dmin[:, 0] + dmin[:, 1] * dmin[:, 1]
                 + dmin[:, 2] * dmin[:, 2])
        reach = (torch.maximum(group_radius, hm[ic]) if symmetric
                 else group_radius)
        near = r2min < reach * reach
        leaf = tree.is_leaf[ic]
        rec = live & near & leaf
        room = nl < LL
        leaves[rows, torch.where(rec & room, nl, LL)] = i
        nl += (rec & room).to(torch.int64)
        ovf |= rec & (nl >= LL)
        i = torch.where(live, torch.where(near & ~leaf, i + 1,
                                          tree.skip[ic]), i)
    return NeighborLists(
        leaf_idx=leaves[:, :LL].to(torch.int32),
        n_leaves=nl.to(torch.int32), overflow=ovf, group_nodes=group_nodes,
        visits=visits.to(torch.int32))


def pack_neighbor_nodes(tree):
    """K3's node table: (nodes f32[C,4] = center, length; meta int32[C],
    treewalk.pack_meta)."""
    nodes = torch.cat([tree.center, tree.length[:, None]], dim=1).contiguous()
    return nodes, pack_meta(tree)


def _kernel():
    global _fn
    if _fn is None:
        fn = kernels.load("neighbors").find_neighbors_f32
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        _fn = fn
    return _fn


def neighbor_kernel(tree, group_nodes, group_center, group_half,
                    group_radius, hmax, leaf_list_max, symmetric=True,
                    stack_cap=STACK_CAP, packed=None):
    """One launch of K3 (``csrc/neighbors.cu``: its table of rows and
    child lists, then the walk) on CUDA tensors, no synchronisation.

    Returns :class:`NeighborLists` and a dict of int32[ngroups] device
    tensors: "rounds" (rounds of the group's stack), "loads" (the
    dependent loads on the group's critical path: one for each round
    that visits, one for each node visited serially) and "serial" (nodes
    visited in the serial mode that takes over when the stack has no
    room).  stack_cap below STACK_CAP only serves to test that mode;
    packed: the tree's :func:`pack_neighbor_nodes`, if the caller has it
    already.
    """
    global LAUNCHES
    ng = group_nodes.shape[0]
    LL = leaf_list_max
    C = tree.capacity
    dev = group_center.device
    if not 1 <= stack_cap <= STACK_CAP:
        raise ValueError(f"stack_cap {stack_cap} outside [1, {STACK_CAP}]")
    if not 1 <= C < 2 ** 30:
        raise ValueError(f"tree capacity {C} outside [1, 2^30)")
    if not 1 <= LL < 2 ** 31 // max(ng, 1):
        # the lists alone would take 8 GiB: a retry gone astray
        raise ValueError(f"leaf_list_max {LL} outside [1, 2^31 / groups)")
    nodes, meta = pack_neighbor_nodes(tree) if packed is None else packed
    f32 = torch.float32
    checks = [("group_nodes", group_nodes, (ng,), torch.int64),
              ("group_center", group_center, (ng, 3), f32),
              ("group_half", group_half, (ng, 3), f32),
              ("group_radius", group_radius, (ng,), f32),
              ("tree nodes", nodes, (C, 4), f32),
              ("tree meta", meta, (C,), torch.int32),
              ("tree.n_nodes", tree.n_nodes, (), torch.int64)]
    if symmetric:
        checks.append(("hmax", hmax, (C,), f32))
    for name, t, shape, dtype in checks:
        kernels.check_tensor(name, t, shape, dtype)
        if t.device != dev:
            raise ValueError("neighbour walk inputs must be on one device")
    fn = _kernel()
    i32 = torch.int32
    leaves = torch.empty((ng, LL), dtype=i32, device=dev)   # all written
    nl = torch.empty(ng, dtype=i32, device=dev)
    ovf = torch.empty(ng, dtype=torch.bool, device=dev)
    visits = torch.empty(ng, dtype=i32, device=dev)
    stats = {name: torch.empty(ng, dtype=i32, device=dev)
             for name in ("rounds", "loads", "serial")}
    table = torch.empty((C, 16), dtype=i32, device=dev)     # K3's scratch
    with torch.cuda.device(dev):
        rc = fn(nodes.data_ptr(), (hmax if symmetric else nodes).data_ptr(),
                meta.data_ptr(), table.data_ptr(), tree.n_nodes.data_ptr(),
                group_nodes.data_ptr(), group_center.data_ptr(),
                group_half.data_ptr(), group_radius.data_ptr(),
                leaves.data_ptr(), nl.data_ptr(), ovf.data_ptr(),
                visits.data_ptr(), stats["rounds"].data_ptr(),
                stats["loads"].data_ptr(), stats["serial"].data_ptr(), ng,
                C, LL, int(stack_cap), int(bool(symmetric)),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"neighbour kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return NeighborLists(leaf_idx=leaves, n_leaves=nl, overflow=ovf,
                         group_nodes=group_nodes, visits=visits), stats


def find_neighbors(tree, group_nodes, group_center, group_half, group_radius,
                   hmax, leaf_list_max, symmetric=True):
    """Collect source leaves intersecting each group's search volume.

    Search volume: distance from the group bbox < group_radius
    (asymmetric) or < max(group_radius, node hmax) (symmetric, the
    NGB_TREEFIND_SYMMETRIC analog, treewalk.h:13-16).  CPU tensors run
    the plain version; any other tensor launches K3 (one launch) or
    raises.
    """
    if group_center.device.type == "cpu":
        return find_neighbors_reference(
            tree, group_nodes, group_center, group_half, group_radius, hmax,
            leaf_list_max, symmetric=symmetric)
    return neighbor_kernel(tree, group_nodes, group_center, group_half,
                           group_radius, hmax, leaf_list_max,
                           symmetric=symmetric)[0]


# converged leaf-list capacities per (shape) key: remember what worked and
# start there on later calls
_LL_CACHE = {}


def find_neighbors_auto(tree, group_nodes, group_center, group_half,
                        group_radius, hmax, ll0, symmetric,
                        cache_key=None, grow=4, max_attempts=5):
    """find_neighbors with overflow retry and capacity memoization.

    Returns (NeighborLists, ll_used); raises on persistent overflow."""
    if cache_key is not None:
        ll0 = max(ll0, _LL_CACHE.get(cache_key, ll0))
    ll = ll0
    for _ in range(max_attempts):
        nbr = find_neighbors(tree, group_nodes, group_center, group_half,
                             group_radius, hmax, ll, symmetric=symmetric)
        if not bool(nbr.overflow.any()):
            if cache_key is not None:
                _LL_CACHE[cache_key] = ll
            return nbr, ll
        ll *= grow
    raise RuntimeError(f"neighbor list overflow at capacity {ll // grow}")


_REDUCE = {"sum": "sum", "max": "amax", "min": "amin"}


def _fill(red):
    return {"sum": 0.0, "max": -float("inf"), "min": INT_FILL}[red]


def pair_reduce(pair_fn, nbr: NeighborLists, tree, pos_box,
                target_feats: Dict, source_feats: Dict,
                reducers: Dict[str, str], group_max: int,
                leaf_eval_max: int):
    """Evaluate pair_fn over all (target particle, source particle) pairs
    implied by the neighbour lists and reduce over sources.

    target_feats: dict of [N] or [N,k] tensors (sorted particle order)
    gathered per target; source_feats likewise gathered per source.
    Where the JAX package scans every group's whole leaf list in chunks,
    padding included, the port evaluates only the listed (group, leaf)
    entries, in batches of B entries of G targets x S = leaf_eval_max
    sources each (B * G * S = PAIR_SLOTS_PER_BATCH), reduced over S,
    then combined into their groups by a scatter min / max / sum ('sum'
    in no fixed order on the card).  Returns dict of [N] or [N,k]
    tensors in sorted particle order.
    """
    dev = pos_box.device
    n = pos_box.shape[0]
    ngroups, LL = nbr.leaf_idx.shape
    G = group_max
    LE = leaf_eval_max
    C = tree.capacity

    gn = nbr.group_nodes
    safe_nodes = torch.clamp(gn, max=C - 1)
    tps = tree.pstart[safe_nodes]
    tpc = torch.where(gn < tree.n_nodes, tree.pcount[safe_nodes], 0)
    offg = torch.arange(G, device=dev)
    offe = torch.arange(LE, device=dev)

    # the listed entries, in (group, list position) order
    listed = torch.arange(LL, device=dev)[None, :] \
        < nbr.n_leaves[:, None].to(torch.int64)
    egroup, epos = torch.nonzero(listed, as_tuple=True)
    eleaf = torch.clamp(nbr.leaf_idx[egroup, epos].to(torch.int64),
                        max=C - 1)

    def gather(feats, idx, axis):
        """Gather and pre-broadcast: targets get a trailing source axis
        (B,G,1[,k]), sources a target axis (B,1,S[,k])."""
        return {k: v[idx].unsqueeze(2 if axis == "target" else 1)
                for k, v in feats.items()}

    flat = {}
    for k, red in reducers.items():
        dt = torch.int64 if red == "min" else torch.float32
        flat[k] = torch.full((ngroups, G), _fill(red), dtype=dt, device=dev)
    batch = max(1, PAIR_SLOTS_PER_BATCH // (G * LE))
    for e0 in range(0, egroup.shape[0], batch):
        eg = egroup[e0:e0 + batch]
        el = eleaf[e0:e0 + batch]
        tidx = torch.clamp(tps[eg][:, None] + offg[None, :], 0, n - 1)
        tmask = offg[None, :] < tpc[eg][:, None]                # (B, G)
        src = tree.pstart[el][:, None] + offe[None, :]
        smask = offe[None, :] < tree.pcount[el][:, None]        # (B, S)
        src = torch.clamp(src, 0, n - 1)
        tpos = pos_box[tidx]                                    # (B, G, 3)
        spos = pos_box[src]                                     # (B, S, 3)
        dx = _wrap(spos[:, None, :, :] - tpos[:, :, None, :])
        r = torch.sqrt(dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1]
                       + dx[..., 2] * dx[..., 2])
        pmask = tmask[:, :, None] & smask[:, None, :]
        contrib = pair_fn(dx, r, tmask[:, :, None], smask[:, None, :],
                          gather(target_feats, tidx, "target"),
                          gather(source_feats, src, "source"))
        for k, red in reducers.items():
            cv = contrib[k]
            if red != "min":
                cv = cv.to(torch.float32)
            cv = torch.where(pmask, cv, _fill(red))
            if red == "sum":
                part = cv.sum(dim=2)
            elif red == "max":
                part = cv.max(dim=2).values
            else:
                part = cv.min(dim=2).values
            flat[k].scatter_reduce_(0, eg[:, None].expand_as(part), part,
                                    reduce=_REDUCE[red])

    # back to particles
    pj = torch.arange(n, device=dev)
    search_ps = torch.where(gn < tree.n_nodes, tps, n + 1)
    gid = torch.clamp(torch.searchsorted(search_ps, pj, right=True) - 1,
                      0, ngroups - 1)
    slot = pj - tps[gid]
    covered = (slot >= 0) & (slot < torch.clamp(tpc[gid], max=G))
    slot = torch.clamp(slot, 0, G - 1)
    return {k: torch.where(covered, flat[k][gid, slot], _fill(red))
            for k, red in reducers.items()}
