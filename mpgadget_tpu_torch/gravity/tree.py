"""Morton-prefix octree (PyTorch port of mpgadget_tpu/gravity/tree.py).

Particles are kept Morton-sorted, so every octree node is a contiguous
particle range.  Nodes are stored in depth-first preorder, so traversal
is stackless: "descend" is i+1 and "skip subtree" is the skip pointer
(skip[i] = first node after the subtree of i).  Two builds fill the same
:class:`Tree`: the closed-form one of gravity/tree32.py (48-bit keys, the
gravity tree) and :func:`build_tree` here, the per-level build over
63-bit keys that the neighbour walk (ops/pairs.py, physics/fof.py) uses.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.morton import KEY_PAD, MORTON_BITS


@dataclass(frozen=True)
class TreeConfig:
    leaf_max: int = 32       # make a leaf when count <= this
    group_max: int = 256     # target-block size for the treewalk
    max_level: int = 15      # deepest split level
    node_factor: float = 0.35  # node capacity = factor * N + 64
    #                            (overflow retry doubles toward 2.0)


@dataclass
class Tree:
    """Fixed-capacity node arrays in DFS preorder."""
    key_start: torch.Tensor  # int64[C] first Morton key of the node: the
    #                          48-bit key of tree32.py, or the 63-bit key
    #                          of build_tree (padding rows KEY_PAD)
    level: torch.Tensor      # int64[C]
    pstart: torch.Tensor     # int64[C] first particle (sorted order)
    pcount: torch.Tensor     # int64[C]
    mass: torch.Tensor       # f32[C]
    com: torch.Tensor        # f32[C,3] box units [0,1)
    center: torch.Tensor     # f32[C,3] geometric cell center, box units
    length: torch.Tensor     # f32[C] cell side, box units
    is_leaf: torch.Tensor    # bool[C]
    is_group: torch.Tensor   # bool[C]: treewalk target group node
    skip: torch.Tensor       # int64[C] DFS skip pointer
    n_nodes: torch.Tensor    # int64 scalar
    overflow: torch.Tensor   # bool scalar: capacity exceeded

    @property
    def capacity(self):
        return self.key_start.shape[0]

    @classmethod
    def from_jax_numpy(cls, arrays: dict, device="cuda"):
        """Carry a JAX ``Tree`` (fields as numpy arrays) over into the
        port's tensors.  Integer fields become int64; a uint32
        ``key_start`` (tree32) is kept as its value, and the uint64
        padding key ~0 of the per-level build becomes KEY_PAD."""
        ints = ("key_start", "level", "pstart", "pcount", "skip", "n_nodes")
        fields = {}
        for name in cls.__dataclass_fields__:
            a = np.asarray(arrays[name])
            if name == "key_start" and a.dtype == np.uint64:
                a = np.where(a == np.iinfo(np.uint64).max, KEY_PAD,
                             a.astype(np.int64))
            a = np.array(a, dtype=np.int64 if name in ints else None)
            fields[name] = torch.as_tensor(a).to(device)
        return cls(**fields)


def _scan_add(x, base=16):
    """Inclusive prefix sum along dim 0: sequential within blocks of
    ``base``, block totals scanned recursively and added.  Rounding error
    grows with log(n) rather than n, and with base 16 the association is
    the one XLA's CPU backend gives ``jnp.cumsum``, so node moments round
    as the JAX package's do."""
    n = x.shape[0]
    nb = -(-n // base)
    pad = nb * base - n
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    xb = x.reshape((nb, base) + tuple(x.shape[1:]))
    cols = [xb[:, 0]]
    for j in range(1, base):
        cols.append(cols[-1] + xb[:, j])
    inner = torch.stack(cols, dim=1)
    if nb > 1:
        tot = _scan_add(inner[:, -1], base)
        excl = torch.cat([tot.new_zeros((1,) + tuple(tot.shape[1:])),
                          tot[:-1]])
        inner = inner + excl[:, None]
    return inner.reshape((nb * base,) + tuple(x.shape[1:]))[:n]


def _range_sum_maker(x, chunk=4096):
    """Two-level prefix sums for range-sum queries with N-independent
    error: f32 cumsum within chunks + exact f64 chunk offsets.

    A plain f32 cumsum-diff loses ~N*eps absolute accuracy (fatal for
    small nodes at large N); here the error is bounded by ~chunk*eps of
    the local magnitude.  Returns range_sum(starts, ends) -> f32 sums of
    x[starts:ends] (x may be [N] or [N,k])."""
    n = x.shape[0]
    nc = (n + chunk - 1) // chunk
    pad = nc * chunk - n
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    xc = x.reshape((nc, chunk) + tuple(x.shape[1:]))
    inner_incl = _scan_add(xc.movedim(1, 0)).movedim(0, 1)
    chunk_tot = torch.sum(xc.to(torch.float64), dim=1)
    off = torch.cat([chunk_tot.new_zeros((1,) + tuple(chunk_tot.shape[1:])),
                     torch.cumsum(chunk_tot, dim=0)])
    inner_excl = (inner_incl - xc).reshape((nc * chunk,) + tuple(x.shape[1:]))

    def prefix(i):
        """Exclusive prefix S(i) as (chunk_offset f64, inner f32)."""
        c = i // chunk
        r = i % chunk
        inner = inner_excl[torch.clamp(i, 0, nc * chunk - 1)]
        zero = (r == 0)
        if x.ndim > 1:
            zero = zero[(...,) + (None,) * (x.ndim - 1)]
        return off[c], torch.where(zero, 0.0, inner)

    def range_sum(starts, ends):
        off_s, in_s = prefix(starts)
        off_e, in_e = prefix(ends)
        return (off_e - off_s).to(torch.float32) + (in_e - in_s)

    return range_sum


def _run_bounds(flags):
    """For boolean run-start flags over a sorted array, return for every
    element the (start, end) indices of its run (scans, no scatter)."""
    n = flags.shape[0]
    iota = torch.arange(n, device=flags.device)
    starts = torch.cummax(torch.where(flags, iota, 0), 0).values
    # run end = next run's start: a reverse cummin of next-start markers
    nxt = torch.where(flags, iota, n)
    nxt = torch.cat([nxt[1:], nxt.new_full((1,), n)])
    ends = torch.flip(torch.cummin(torch.flip(nxt, [0]), 0).values, [0])
    return starts, ends


def _broadcast_from_start(value_at_start, flags):
    """Propagate a value set at run-start positions to the whole run
    (forward fill along the sorted axis)."""
    iota = torch.arange(flags.shape[0], device=flags.device)
    return value_at_start[torch.cummax(torch.where(flags, iota, 0), 0).values]


def build_tree(keys, ipos, mass, valid, leaf_max, max_level, capacity,
               group_max=64):
    """Build the octree from SORTED 63-bit Morton keys, one level at a
    time.

    keys: int64[N] in :func:`~mpgadget_tpu_torch.ops.morton.sort_order`
    (valid particles by key, then the invalid ones, which hold KEY_PAD);
    ipos: int64[N,3] fixed-point positions in the same order; mass zeroed
    for invalid particles.  All geometry is in box units [0,1).  Level L
    holds a node wherever the 3L-bit key prefix changes under an internal
    parent; nodes are ordered by (key_start, level), which is DFS
    preorder, padding rows (key KEY_PAD) last.
    """
    dev = keys.device
    n = keys.shape[0]
    pos_box = ipos.to(torch.float32) * 2.0 ** -32
    mass = torch.where(valid, mass, 0.0)
    mass_sum = _range_sum_maker(mass)
    mpos_sum = _range_sum_maker(mass[:, None] * pos_box)
    nvalid = valid.sum()

    C = capacity
    # row C takes the writes the JAX package drops (rank past capacity)
    key_start_g = torch.full((C + 1,), KEY_PAD, dtype=torch.int64,
                             device=dev)
    fdata = torch.zeros((C + 1, 8), dtype=torch.float32, device=dev)
    idata = torch.zeros((C + 1, 4), dtype=torch.int64, device=dev)
    offset = torch.zeros((), dtype=torch.int64, device=dev)
    parent_internal = torch.ones(n, dtype=torch.bool, device=dev)
    parent_small = torch.zeros(n, dtype=torch.bool, device=dev)
    iota = torch.arange(n, device=dev)

    for lev in range(0, max_level + 1):
        shift = 3 * (MORTON_BITS - lev)
        prefix = keys >> shift
        if lev == 0:
            flags = iota == 0
        else:
            flags = torch.cat([flags.new_ones(1), prefix[1:] != prefix[:-1]])
        starts, ends = _run_bounds(flags)
        count = ends - starts
        # candidate nodes: run starts, within the valid-particle range,
        # whose parent was internal
        cand = flags & (iota < nvalid) & parent_internal
        node_is_leaf = (count <= leaf_max) | (lev == max_level)
        # target group: first node on the root path with count<=group_max
        node_is_group = (((count <= group_max) | (lev == max_level))
                         & ~parent_small[starts])
        rank = torch.cumsum(cand.to(torch.int64), 0) - 1
        dest = torch.where(cand, torch.clamp(offset + rank, max=C), C)
        nm = mass_sum(starts, ends)
        com = mpos_sum(starts, ends) / torch.clamp(nm, min=1e-30)[:, None]
        # geometric cell center: exact from the run-start particle's
        # integer position (it lies inside the cell by construction)
        side = float(np.float32(1.0 / (1 << lev)))
        if lev > 0:
            cell = (ipos[starts] >> (32 - lev)).to(torch.float32)
        else:
            cell = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        center = (cell + 0.5) * side
        com = torch.where(nm[:, None] > 0, com, center)

        frow = torch.cat([nm[:, None], com, center,
                          torch.full((n, 1), side, dtype=torch.float32,
                                     device=dev)], dim=1)
        irow = torch.stack(
            [torch.full((n,), lev, dtype=torch.int64, device=dev), starts,
             count, node_is_leaf.to(torch.int64)
             + 2 * (node_is_group & cand).to(torch.int64)], dim=1)
        key_start_g[dest] = prefix << shift
        fdata[dest] = frow
        idata[dest] = irow
        offset = offset + cand.sum()
        # children exist only under internal nodes
        parent_internal = _broadcast_from_start(cand & ~node_is_leaf, flags)
        parent_small = _broadcast_from_start(
            flags & (parent_small[starts] | (count <= group_max)), flags)

    n_nodes = offset
    overflow = n_nodes > C
    key_start_g, fdata, idata = key_start_g[:C], fdata[:C], idata[:C]

    # DFS preorder: sort by (key_start, level), padding rows last (three
    # stable sorts: no lexicographic sort in torch, and no int64 above a
    # node of the last cell for the padding key)
    pad = torch.arange(C, device=dev) >= n_nodes
    o = torch.argsort(idata[:, 0], stable=True)
    o = o[torch.argsort(key_start_g[o], stable=True)]
    o = o[torch.argsort(pad[o].to(torch.int8), stable=True)]
    ks = key_start_g[o]
    fdata = fdata[o]
    idata = idata[o]
    level = idata[:, 0]

    # skip pointer: first node with key_start >= my key_end, searched as
    # key_start > my last key, so that no key_end overflows int64 (the
    # last cell of a level ends at 2^63); the root's is n_nodes
    ks_search = torch.where(ks >= 0, ks, torch.iinfo(torch.int64).max)
    span = torch.ones_like(level) << (3 * (MORTON_BITS
                                           - torch.clamp(level, min=1)))
    last = torch.clamp(ks, min=0) + (span - 1)
    skip = torch.searchsorted(ks_search, last, right=True)
    skip = torch.where((level == 0) | (ks < 0), n_nodes,
                       torch.minimum(skip, n_nodes))

    return Tree(key_start=ks, level=level, pstart=idata[:, 1],
                pcount=idata[:, 2], mass=fdata[:, 0], com=fdata[:, 1:4],
                center=fdata[:, 4:7], length=fdata[:, 7],
                is_leaf=(idata[:, 3] & 1) > 0, is_group=(idata[:, 3] & 2) > 0,
                skip=skip, n_nodes=n_nodes, overflow=overflow)
