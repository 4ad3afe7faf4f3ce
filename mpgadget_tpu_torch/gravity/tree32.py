"""Morton-prefix octree build, all levels at once (PyTorch port of
mpgadget_tpu/gravity/tree32.py).

Keys are one int64 per particle: the 48-bit Morton key of the top 16
bits per axis (16 octree levels), ``(hi << 18) | lo`` in the JAX
package's terms.  The JAX package splits it into a uint32 (hi, lo) pair
only to avoid emulated 64-bit integers on the TPU.

The structure falls out of closed-form scans (see the JAX module for
the derivation):

- ``lca[i]`` = number of leading octree levels shared by sorted keys
  ``i-1`` and ``i``; position i starts a run at every level > lca[i];
- run bounds per (level, position) are two batched scans over a
  (levels, N) matrix;
- node enumeration is one cumsum of per-position node counts plus one
  N-row scatter of run markers; the per-node fields are gathered in
  DFS order after one sort on (key prefix, level).

Translation notes: JAX ``mode="drop"`` scatters are masked index
writes; ``lax.cummax`` is ``torch.cummax(...).values`` and ``cummin``
is done with a flip of a negated cummax.
"""

import torch

from .tree import Tree, _range_sum_maker

MAX_LEVEL32 = 16
KEY_BITS = 48
KEY_INVALID = (1 << 62)     # sorts after every real 48-bit key


def _spread16(x):
    """Spread the low 16 bits: b15..b0 -> b15 0 0 b14 ... 0 0 b0 (the
    21-bit masks of mpgadget_tpu/ops/morton.py)."""
    x = x & 0xFFFF
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def morton_key48(ipos):
    """48-bit Morton key (int64) from int64 fixed-point positions [N,3]."""
    c = [ipos[:, a] >> 16 for a in range(3)]
    return ((_spread16(c[0]) << 2) | (_spread16(c[1]) << 1)
            | _spread16(c[2]))


def sort_by_morton32_payload(ipos, valid, payload):
    """Morton sort carrying payload columns; invalid rows sink to the end.

    A stable ``torch.sort`` of one int64 key, then payload gathers.
    Returns (key_s, perm, ipos_s, valid_s, payload_s).
    """
    key = torch.where(valid, morton_key48(ipos), KEY_INVALID)
    key_s, perm = torch.sort(key, stable=True)
    return (key_s, perm, ipos[perm], valid[perm],
            tuple(p[perm] for p in payload))


def _drop_set(size, idx, vals, fill=0):
    """out = full(size, fill); out[idx] = vals, dropping idx >= size
    (the JAX ``.at[idx].set(vals, mode="drop")``)."""
    out = torch.full((size,), fill, dtype=vals.dtype, device=vals.device)
    keep = idx < size
    out[idx[keep]] = vals[keep]
    return out


def _cummax(x, dim=-1):
    return torch.cummax(x, dim=dim).values


def _lca_levels(key, max_level):
    """lca[i] = #levels shared by keys i-1 and i (lca[0] = 0)."""
    x = key ^ torch.roll(key, 1)
    agree = torch.zeros_like(key)
    for L in range(1, max_level + 1):
        agree += ((x >> (KEY_BITS - 3 * L)) == 0).to(key.dtype)
    agree[0] = 0
    return agree


def _run_bounds_batched(flags):
    """(L, N) run-start flags -> per-position (start, end) along axis 1."""
    L, n = flags.shape
    iota = torch.arange(n, device=flags.device)[None, :]
    starts = _cummax(torch.where(flags, iota, 0), dim=1)
    nxt = torch.where(flags, iota, n)
    nxt = torch.cat([nxt[:, 1:], torch.full((L, 1), n, dtype=nxt.dtype,
                                            device=nxt.device)], dim=1)
    # reverse cummin == flip(-cummax(-flip(x)))
    ends = -torch.flip(_cummax(-torch.flip(nxt, [1]), dim=1), [1])
    return starts, ends


def build_tree32(key, ipos_s, mass_s, valid_s, leaf_max, max_level,
                 capacity, group_max=64):
    """Build the octree from SORTED int64 Morton keys.

    Invalid rows must be key-maxed and sorted to the tail, mass zeroed for
    invalid.  All geometry is in box units [0,1).
    """
    if max_level > MAX_LEVEL32:
        raise ValueError(f"max_level {max_level} > {MAX_LEVEL32}")
    dev = key.device
    n = key.shape[0]
    C = capacity
    NL = max_level  # levels 1..NL as rows 0..NL-1
    mass = torch.where(valid_s, mass_s, 0.0)
    pos_box = ipos_s.to(torch.float32) * 2.0 ** -32
    m4_sum = _range_sum_maker(
        torch.cat([mass[:, None], mass[:, None] * pos_box], dim=1))
    nvalid = valid_s.sum()
    iota_n = torch.arange(n, device=dev)

    lca = _lca_levels(key, max_level)                       # (N,)
    levels = torch.arange(1, NL + 1, device=dev)[:, None]
    flags = lca[None, :] < levels                           # (NL, N)
    starts, ends = _run_bounds_batched(flags)
    ends = torch.minimum(ends, nvalid)                      # clamp to valid
    counts = ends - starts                                  # (NL, N)

    # contiguous alive-level range per position: [lca+1, P]
    internal = counts > leaf_max
    P = torch.where(nvalid > leaf_max,
                    1 + internal[:NL - 1].sum(dim=0), 0)     # (N,)
    base = lca + 1
    n_i = torch.clamp(torch.clamp(P, max=NL) - base + 1, min=0)
    n_i = torch.where(iota_n < nvalid, n_i, 0)

    offs = torch.cumsum(n_i, 0) - n_i                       # exclusive
    total = offs[-1] + n_i[-1] + 1                          # +1 root
    overflow = total > C

    # one N-row scatter of run markers; forward fill recovers the rest
    dest = torch.where(n_i > 0, 1 + offs, C)
    pos_of = _cummax(_drop_set(C, dest, iota_n))
    drow = _cummax(_drop_set(C, dest, dest))
    row = torch.arange(C, device=dev)
    level = torch.where(row == 0, 0, base[pos_of] + (row - drow))
    pstart = torch.where(row == 0, 0, pos_of)
    in_use = row < total
    level = torch.where(in_use, level, 0)

    # node key prefix at its level, then DFS order by (prefix, level)
    shk = torch.clamp(KEY_BITS - 3 * level, 0, KEY_BITS)
    kpre = (key[pstart] >> shk) << shk
    kpre = torch.where(level > 0, kpre, 0)
    sort_key = torch.where(in_use, (kpre << 5) | level, KEY_INVALID)
    sort_key, crow = torch.sort(sort_key, stable=True)
    pstart = pstart[crow]
    row_ok = row < total
    level = torch.where(row_ok, sort_key & 31, 0)
    pstart = torch.where(row_ok, pstart, n)
    key_start = torch.where(row_ok, sort_key >> 5, KEY_INVALID)

    # per-node fields, gathered in DFS order
    flat = torch.clamp(level - 1, 0, NL - 1) * n + torch.clamp(pstart, 0,
                                                                 n - 1)
    end_n = torch.where(level > 0, ends.reshape(-1)[flat], nvalid)
    end_n = torch.where(row_ok, end_n, n)
    pcount = torch.clamp(end_n - pstart, min=0)
    flatp = torch.clamp(level - 2, 0, NL - 1) * n + torch.clamp(pstart, 0,
                                                                  n - 1)
    # root's "parent" count = nvalid+1 > group_max guarantees marking
    parent_cnt = torch.where(level > 1, counts.reshape(-1)[flatp],
                             nvalid + 1)

    s4 = m4_sum(pstart, end_n)
    nm = s4[:, 0]
    com = s4[:, 1:4] / torch.clamp(nm, min=1e-30)[:, None]
    side = torch.exp2(-level.to(torch.float32))
    shift = torch.clamp(32 - level, 0, 31)
    cell = (ipos_s[torch.clamp(pstart, 0, n - 1)]
            >> shift[:, None]).to(torch.float32)
    cell = torch.where((level > 0)[:, None], cell, 0.0)
    center = (cell + 0.5) * side[:, None]
    com = torch.where(nm[:, None] > 0, com, center)

    is_leaf = ((pcount <= leaf_max) | (level == max_level)) & row_ok
    is_group = (((pcount <= group_max) | (level == max_level))
                & (parent_cnt > group_max)) & row_ok

    # skip pointer in O(1): in DFS preorder the node after subtree
    # (s, L) is the SHALLOWEST node starting at particle e = s+count,
    # whose construction row is 1 + offs[e].  Map construction rows to
    # sorted rows through the carried crow.
    new_of_old = torch.empty(C, dtype=row.dtype, device=dev)
    new_of_old[crow] = row
    e = pstart + pcount
    e_safe = torch.clamp(e, 0, n - 1)
    erow_old = torch.clamp(1 + offs[e_safe], 0, C - 1)
    skip = torch.where((e < nvalid) & row_ok, new_of_old[erow_old], total)
    skip = torch.minimum(skip, total)

    return Tree(key_start=key_start, level=level, pstart=pstart,
                pcount=pcount, mass=torch.where(row_ok, nm, 0.0), com=com,
                center=center, length=side, is_leaf=is_leaf,
                is_group=is_group, skip=skip, n_nodes=total,
                overflow=overflow)
