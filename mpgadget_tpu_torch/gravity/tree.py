"""Morton-prefix octree node layout (PyTorch port of the parts of
mpgadget_tpu/gravity/tree.py that the gravity tree uses).

Particles are kept Morton-sorted, so every octree node is a contiguous
particle range.  Nodes are stored in depth-first preorder, so traversal
is stackless: "descend" is i+1 and "skip subtree" is the skip pointer
(skip[i] = first node after the subtree of i).  See gravity/tree32.py
for the closed-form build.
"""

from dataclasses import dataclass

import numpy as np
import torch


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
    key_start: torch.Tensor  # int64[C] 48-bit Morton prefix of the node
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
        port's tensors.  Integer fields become int64; the JAX uint32
        ``key_start`` is kept as its value."""
        ints = ("key_start", "level", "pstart", "pcount", "skip", "n_nodes")
        fields = {}
        for name in cls.__dataclass_fields__:
            a = np.array(arrays[name], dtype=np.int64 if name in ints
                         else None)
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
