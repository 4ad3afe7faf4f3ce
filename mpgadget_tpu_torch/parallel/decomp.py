"""Slab domain decomposition, particle exchange and ghost strips.

PyTorch port of mpgadget_tpu/parallel/decomp.py, the analog of the
reference's domain/exchange machinery (libgadget/domain.c, exchange.c:
105-191): the box is split into S x-slabs, one per rank, and each rank
owns the particles whose x coordinate falls in its slab.

Rows are variable-length per rank.  An exchange sorts the rows stably by
destination (source order within a destination, the order in which the
JAX package packs them), swaps the per-destination counts, and moves all
columns at once as one byte buffer through one split-size all_to_all.  So
there is no bucket capacity, no overflow flag and no retry: the local row
order after an exchange is the JAX package's order of its valid rows.

Ghost strips replace the treewalk export/import protocol
(treewalk.c:325-902): a rank needs only the rows within the short-range
cut (or the linking length) of its slab faces, and receives them as
source-only rows appended after its own.

Positions are int64 holding [0, 2^32); interval arithmetic wraps with
``& 0xFFFFFFFF`` as the JAX package's uint32 does.
"""

import numpy as np
import torch

from . import collectives as coll

MASK32 = 0xFFFFFFFF


def slab_of(ipos, log2_shards):
    """Owning rank of each row under the geometric split: the top bits
    of x."""
    return ipos[:, 0] >> (32 - log2_shards) if log2_shards else \
        torch.zeros_like(ipos[:, 0])


def owner_of(ipos, boundaries):
    """Owning rank under arbitrary slab boundaries (S ascending left
    edges, boundaries[0] == 0), the count-balanced domain_decompose analog
    (domain.c:106)."""
    b = torch.as_tensor(np.asarray(boundaries, np.int64), device=ipos.device)
    return torch.searchsorted(b, ipos[:, 0].contiguous(), right=True) - 1


def count_histogram(ipos, mesh, bits=12):
    """Global histogram of the top ``bits`` of x, summed over ranks; the
    host turns it into count-balanced boundaries."""
    idx = ipos[:, 0] >> (32 - bits)
    h = torch.bincount(idx, minlength=1 << bits)
    return coll.psum(h, mesh)


def balanced_boundaries(hist, n_shards):
    """Count-balanced left edges from a global x histogram (host numpy;
    the same bits as the JAX package).  Splits at histogram-bin
    granularity so that each slab holds ~total/S rows (the cost-balanced
    topleaf assignment analog, domain.c:145-257)."""
    hist = np.asarray(hist, np.int64)
    bits = int(np.log2(hist.shape[0]))
    csum = np.cumsum(hist)
    total = int(csum[-1])
    targets = np.arange(n_shards, dtype=np.float64) * total / n_shards
    idx = np.searchsorted(csum, targets, side="left")
    b = (idx.astype(np.uint64) << (32 - bits)).astype(np.uint32)
    b[0] = 0
    # strictly increasing: an empty slab collapses onto the next bin edge
    for s in range(1, n_shards):
        if b[s] <= b[s - 1]:
            b[s] = b[s - 1] + 1
    return b


def geometric_boundaries(n_shards):
    """uint32[S] left edges of the fixed geometric x-slab split."""
    return (np.arange(n_shards, dtype=np.uint64)
            * (2 ** 32 // n_shards)).astype(np.uint32)


def pack_rows(arrays):
    """Columns (tensors with one leading row dimension, on one device) as
    one uint8 buffer [n, bytes per row], and what unpack_rows needs."""
    n = arrays[0].shape[0]
    cols, spec = [], []
    for a in arrays:
        a = a.contiguous()
        if a.dtype == torch.bool:
            b, size = a.to(torch.uint8), 1
        else:
            b, size = a.view(torch.uint8), a.element_size()
        nb = int(np.prod(a.shape[1:], dtype=np.int64)) * size
        cols.append(b.reshape(n, nb))
        spec.append((a.dtype, tuple(a.shape[1:]), nb))
    return torch.cat(cols, dim=1) if cols else None, spec


def unpack_rows(buf, spec):
    out, c = [], 0
    for dtype, shape, nb in spec:
        # a fresh buffer: a view of the bytes need not be aligned for dtype
        raw = torch.empty((buf.shape[0], nb), dtype=torch.uint8,
                          device=buf.device)
        raw.copy_(buf[:, c:c + nb])
        c += nb
        if dtype == torch.bool:
            out.append(raw.reshape((-1,) + shape).to(torch.bool))
        else:
            out.append(raw.view(dtype).reshape((-1,) + shape))
    return out


def all_gather_rows(arrays, mesh):
    """Every rank's rows of the columns (tuple or dict, one leading row
    dimension, lengths differing between ranks) on every rank, in rank
    order: one all_gather_v of the packed rows.  Returns (columns,
    rows per rank)."""
    keys, cols = _as_list(arrays)
    buf, spec = pack_rows(cols)
    g, counts = coll.all_gather_v(buf, mesh)
    return _as_input(keys, unpack_rows(g, spec)), counts


def _as_list(arrays):
    if isinstance(arrays, dict):
        return list(arrays.keys()), list(arrays.values())
    return None, list(arrays)


def _as_input(keys, cols):
    return dict(zip(keys, cols)) if keys is not None else tuple(cols)


def exchange_by_dest(arrays, dest, mesh):
    """Route every row to the rank named by ``dest`` (int64[n], 0..S-1):
    the alltoallv struct exchange (exchange.c:105-191) shared by the
    domain exchange, the distributed sort and the FOF catalogue.  arrays:
    tuple or dict of columns.  Rows arrive grouped by source rank, in
    each source's order.  Returns (arrays_out, recv_counts)."""
    keys, cols = _as_list(arrays)
    S = mesh.size
    order = torch.sort(dest, stable=True).indices
    counts = torch.bincount(dest, minlength=S)
    buf, spec = pack_rows([c[order] for c in cols])
    rbuf, recv = coll.all_to_all(buf, mesh, counts)
    return _as_input(keys, unpack_rows(rbuf, spec)), recv


def exchange_to_slabs(arrays, ipos, mesh, boundaries=None):
    """Move rows to their owning x-slab rank (domain_exchange analog).
    arrays must include ipos itself if it is to travel.  boundaries:
    optional S left edges (count-balanced ownership); default the
    geometric split."""
    if boundaries is None:
        boundaries = geometric_boundaries(mesh.size)
    return exchange_by_dest(arrays, owner_of(ipos, boundaries), mesh)


def interval_dist_u32(x, lo, hi):
    """Circular distance (mod 2^32) from x to the interval [lo, hi): 0
    inside, else the shorter way round to either edge."""
    length = (hi - lo) & MASK32
    off = (x - lo) & MASK32
    inside = off < length
    d_before = (-off) & MASK32          # lo - x, wrapped
    d_after = (off - length) & MASK32   # x - hi, wrapped
    return torch.where(inside, torch.zeros_like(x),
                       torch.minimum(d_before, d_after))


def strip_width(width_box):
    """Strip width in fixed-point ticks, at most half the box (the JAX
    package's conversion: float64 times 2^32, truncated)."""
    return int(min(float(width_box) * 2.0 ** 32, 2.0 ** 31))


def _exchange_parts(cols, masks, shifts, mesh):
    """Send, for each part p, the rows in masks[p] to rank (me +
    shifts[p]) mod S, and receive part p from rank (me - shifts[p]) mod S.
    Returns the received columns, parts concatenated in part order (each
    in its sender's row order), and the rows per part.  A part that would
    go to this rank itself is empty (one rank has no neighbour)."""
    S, me = mesh.size, mesh.rank
    P = len(shifts)
    dev = cols[0].device
    sel, dest_part = [], []
    for p, (m, sh) in enumerate(zip(masks, shifts)):
        d = (me + sh) % S
        idx = torch.nonzero(m).squeeze(1) if d != me else \
            torch.zeros(0, dtype=torch.int64, device=dev)
        sel.append(idx)
        dest_part.append((d, p))
    # the send buffer: by destination rank, then by part
    order = sorted(range(P), key=lambda p: dest_part[p])
    cnt = torch.zeros((S, P), dtype=torch.int64)
    for p in range(P):
        cnt[dest_part[p][0], p] = sel[p].shape[0]
    rows = torch.cat([sel[p] for p in order]) if P else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    buf, spec = pack_rows([c[rows] for c in cols])
    rcnt, _ = coll.all_to_all(cnt.reshape(-1).to(dev), mesh)
    rcnt = rcnt.reshape(S, P).cpu()
    rbuf, recv = coll.all_to_all(buf, mesh, cnt.sum(dim=1))
    # received: by source rank, then by part index
    start = np.concatenate([[0], np.cumsum(rcnt.reshape(-1).numpy())])
    pieces, sizes = [], []
    for p in range(P):
        src = (me - shifts[p]) % S
        a = int(start[src * P + p])
        b = int(start[src * P + p + 1])
        pieces.append(torch.arange(a, b, device=dev))
        sizes.append(b - a)
    take = torch.cat(pieces) if pieces else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    return unpack_rows(rbuf[take], spec), sizes


def ring_parts(hops, n_shards):
    """The shifts of a K-hop ghost exchange in the JAX package's order:
    for k = 1..hops, +k then -k (one of them when 2k = S)."""
    shifts = []
    for k in range(1, hops + 1):
        shifts += [+k, -k] if (2 * k) % n_shards != 0 else [+k]
    return shifts


def ghost_hops(bounds, width):
    """Ring hops K such that, from every slab, the K neighbours on each
    side span at least ``width`` (box units): the ghost_strips_multi
    contract (the JAX package's run_sharded hops_for)."""
    S = len(bounds)
    b = np.asarray(bounds, np.float64) / 2 ** 32
    widths = np.diff(np.append(b, 1.0))
    K = 1
    for s in range(S):
        left = right = 0.0
        k = 0
        while (left < width or right < width) and k < S // 2:
            k += 1
            left += widths[(s - k) % S]
            right += widths[(s + k) % S]
        K = max(K, k)
    return int(min(max(K, 1), max(S // 2, 1)))


def ghost_strips_multi(arrays, ipos, mesh, boundaries, width_box, hops):
    """K-hop ghost exchange over arbitrary slab boundaries (the
    reference's treewalk exports reach any rank, treewalk.c:325): rank j
    sends, for each k in 1..hops and each direction, the rows within
    width_box of rank (j +- k)'s interval [boundaries[t],
    boundaries[t+1 mod S]) and outside it.  hops must make the 2 hops
    neighbours' intervals cover width_box from every face (the caller
    sizes it from the slab widths).  Returns the ghost columns (tuple or
    dict as arrays), parts in the JAX package's order."""
    keys, cols = _as_list(arrays)
    S, me = mesh.size, mesh.rank
    b = np.asarray(boundaries, np.int64)
    w = strip_width(width_box)
    x = ipos[:, 0]
    shifts = ring_parts(hops, S)
    masks = []
    for sh in shifts:
        tgt = (me + sh) % S
        d = interval_dist_u32(x, int(b[tgt]), int(b[(tgt + 1) % S]))
        masks.append((d < w) & (d > 0))
    got, _ = _exchange_parts(cols, masks, shifts, mesh)
    return _as_input(keys, got)


def ghost_strips(arrays, ipos, mesh, log2_shards, rcut_box):
    """Source-only ghost rows from both geometric slab neighbours: my
    right strip (x >= right edge - rcut) goes to my right neighbour, my
    left strip (x < left edge + rcut) to my left.  Requires slab width >
    rcut_box (one hop).  Returns the ghosts, from my left neighbour first,
    then from my right."""
    keys, cols = _as_list(arrays)
    me = mesh.rank
    step = 2 ** 32 // (1 << log2_shards)
    rc = strip_width(rcut_box)
    x = ipos[:, 0]
    right_edge = ((me + 1) * step) & MASK32        # wraps for the last
    left_edge = me * step
    in_right = x >= ((right_edge - rc) & MASK32)
    in_left = x < left_edge + rc
    got, _ = _exchange_parts(cols, [in_right, in_left], [+1, -1], mesh)
    return _as_input(keys, got)
