"""The flat stream of source tiles of the SPH pair kernels K4 and K5
(mpgadget_tpu_torch/csrc/sph_stream.cuh), mirrored in numpy on the CPU:
every (target, source) pair of a group's list reaches exactly one lane,
in list order within the lane; the queue of counted pairs hands each
lane back its own pairs in bit order; the band test on r^2 decides as
the plain version's float32 arithmetic does; and chip_smoke.py's count
of the kernels' chains of dependent loads against a direct count.  The
kernels' results are held to the plain versions on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import chip_smoke
from mpgadget_tpu_torch.ops.pairs import NeighborLists


def _segment(counts, starts):
    """build_segment: inclusive prefix and per-entry offsets of one
    segment (entries past the list hold count 0)."""
    incl = np.cumsum(counts)
    return incl, starts - (incl - counts)


def _source_at(incl, off, p):
    """source_at: binary lifting over the inclusive prefix."""
    i = 0
    b = len(incl) >> 1
    while b > 0:
        if incl[i + b - 1] <= p:
            i += b
        b >>= 1
    return off[i] + p


def _stream_lanes(lst, pstart, pcount, T):
    """The (target, source) pairs each (warp, lane) of the CTA sums, in
    its order, as for_each_tile and the slots of sph_stream.cuh deal
    them."""
    warps, seg, tile = chip_smoke.sph_stream_shape()
    lg = int(np.ceil(np.log2(T))) if T > 1 else 0
    lanes = {(w, ln): [] for w in range(warps) for ln in range(32)}
    for l0 in range(0, len(lst), seg):
        ent = lst[l0:l0 + seg]
        counts = np.zeros(seg, np.int64)
        starts = np.zeros(seg, np.int64)
        counts[:len(ent)] = pcount[ent]
        starts[:len(ent)] = pstart[ent]
        incl, off = _segment(counts, starts)
        total = int(incl[-1])
        ntiles = -(-total // tile)
        for w in range(warps):
            for t0 in range(w, ntiles, warps):
                src = [_source_at(incl, off, t0 * tile + k)
                       if t0 * tile + k < total else None
                       for k in range(tile)]
                for ln in range(32):
                    t, s = ln & ((1 << lg) - 1), ln >> lg
                    if t >= T:
                        continue
                    for i in range(1 << lg):
                        j = src[s + (i << (5 - lg))]
                        if j is not None:
                            lanes[(w, ln)].append((t, j))
    return lanes


@pytest.mark.parametrize("T", [1, 2, 3, 5, 8, 16, 17, 32])
def test_stream_deals_every_pair_once(T):
    """Lists of 0 to 3 segments, with empty leaves and leaves of up to 40
    particles: each (target, source) pair reaches one lane exactly, and a
    lane sees its sources in list order."""
    rng = np.random.RandomState(T)
    _, seg, _ = chip_smoke.sph_stream_shape()
    nleaf = 400
    pcount = rng.randint(0, 41, nleaf)
    pcount[rng.rand(nleaf) < 0.1] = 0
    pstart = np.concatenate([[0], np.cumsum(pcount)[:-1]])
    for length in (0, 1, 7, seg, seg + 1, 3 * seg - 5):
        lst = rng.permutation(nleaf)[:length]
        lanes = _stream_lanes(lst, pstart, pcount, T)
        got = sorted(p for v in lanes.values() for p in v)
        flat = [j for leaf in lst
                for j in range(pstart[leaf], pstart[leaf] + pcount[leaf])]
        assert got == sorted((t, j) for t in range(T) for j in flat)
        order = {j: q for q, j in enumerate(flat)}     # leaves distinct
        for v in lanes.values():
            pos = [order[j] for _, j in v]
            assert pos == sorted(pos)


def _counted_rounds(masks, T):
    """for_each_counted: the queue of (target, slot) in lane and bit order,
    dealt out 32 a round; returns, per lane, the pair terms it adds back,
    in order, and per lane the entries it computed."""
    lg = int(np.ceil(np.log2(T))) if T > 1 else 0
    cnt = [bin(m).count("1") for m in masks]
    off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    total = int(sum(cnt))
    queue = []
    for ln, m in enumerate(masks):
        t, s = ln & ((1 << lg) - 1), ln >> lg
        queue += [(t, s + (i << (5 - lg))) for i in range(32) if m >> i & 1]
    assert len(queue) == total
    added = [[] for _ in range(32)]
    computed = [[] for _ in range(32)]
    for r0 in range(0, total, 32):
        res = {}
        for ln in range(32):
            if r0 + ln < total:
                res[ln] = queue[r0 + ln]              # body(t, k)
                computed[ln].append(r0 + ln)
        for ln in range(32):
            for f in range(max(off[ln], r0), min(off[ln] + cnt[ln], r0 + 32)):
                added[ln].append(res[f - r0])
    return added, computed


@pytest.mark.parametrize("T", [1, 3, 8, 17, 32])
def test_counted_pairs_come_back_to_their_lane_in_order(T):
    """Each lane gets back exactly its own counted pairs, in bit order,
    and each queued pair is computed once; the rounds are as many as the
    pairs over 32."""
    rng = np.random.RandomState(10 + T)
    lg = int(np.ceil(np.log2(T))) if T > 1 else 0
    for share in (0.0, 0.12, 0.5, 1.0):
        masks = [0] * 32
        for ln in range(32):
            if (ln & ((1 << lg) - 1)) < T:          # a live slot
                bits = rng.rand(1 << lg) < share
                masks[ln] = int(sum(1 << i for i in np.flatnonzero(bits)))
        added, computed = _counted_rounds(masks, T)
        for ln, m in enumerate(masks):
            t, s = ln & ((1 << lg) - 1), ln >> lg
            assert added[ln] == [(t, s + (i << (5 - lg)))
                                 for i in range(32) if m >> i & 1]
        done = sorted(e for c in computed for e in c)
        assert done == list(range(sum(bin(m).count("1") for m in masks)))
        assert max(len(c) for c in computed) == -(-len(done) // 32)


def _band(s, lo2, hi2):
    return np.where(s < lo2, 1, np.where(s > hi2, 0, -1))


def test_band_decisions_are_the_plain_versions():
    """K4's u < 1 and K5's (r L < H_i or r L < H_j) and r > 0, decided on
    r^2 against 0.9999 and 1.0001 of the radius squared (float32 as the
    kernels compute it) wherever the band test answers, equal the plain
    version's float32 arithmetic; pairs at 1 +- 1e-7 of the radius, exact
    zeros and a radius of zero included."""
    f = np.float32
    lo, hi = f(0.9999), f(1.0001)
    rng = np.random.RandomState(5)
    n = 200000
    h = (10.0 ** rng.uniform(-4, -0.5, n)).astype(f)
    h[:100] = f(1e-30)
    rel = np.concatenate([1 + rng.uniform(-3e-4, 3e-4, n // 2),
                          1 + rng.uniform(-1e-6, 1e-6, n // 4),
                          rng.uniform(0, 3, n - n // 2 - n // 4)])
    dx = (h * rel / np.sqrt(f(3))).astype(f)
    dx[200:300] = 0
    s2 = dx * dx + dx * dx + dx * dx                 # float32, as dist2_rn
    with np.errstate(over="ignore", divide="ignore"):
        # K4: hinv = 1 / max(H, 1e-30), u = sqrt(r^2) hinv
        hinv = f(1) / np.maximum(h, f(1e-30))
        H = f(1) / hinv
        band = _band(s2, H * H * lo, H * H * hi)
    exact = np.sqrt(s2) * hinv < f(1)
    far = (np.abs(rel - 1) > 1e-4) & (h > 1e-20) & (dx > 0)
    assert bool((band[far] >= 0).all())          # no square root there
    assert np.array_equal(band[band >= 0] == 1, exact[band >= 0])
    # K5: ri = sqrt(r^2) L against H_i and H_j, in internal units
    L = f(1000.0)
    hi_, hj_ = (h * L).astype(f), (h * L * rng.uniform(0.5, 1.5, n)).astype(f)
    hj_[300:400] = 0
    w = np.maximum(np.maximum(hi_, hj_), f(0)) * (f(1) / L)
    band = _band(s2, w * w * lo, w * w * hi)
    band = np.where((band == 1) & (s2 > 0), 1, np.where(band == 1, 0, band))
    ri = np.sqrt(s2) * L
    exact = ((ri < hi_) | (ri < hj_)) & (ri > 0)
    assert np.array_equal(band[band >= 0] == 1, exact[band >= 0])


def test_critical_paths_count_the_chains():
    """sph_critical_paths against a direct count of each design's chain
    of dependent loads, group by group."""
    warps, seg, tile = chip_smoke.sph_stream_shape()
    rng = np.random.RandomState(3)
    C, ng, LL = 500, 40, 3 * seg
    pcount = rng.randint(0, 70, C)

    class Tree:
        capacity = C
    tree = Tree()
    tree.pcount = torch.as_tensor(pcount)
    n_leaves = rng.randint(0, LL + 1, ng)
    n_leaves[0] = LL
    leaf_idx = np.full((ng, LL), C, np.int32)
    for g in range(ng):
        leaf_idx[g, :n_leaves[g]] = rng.randint(0, C, n_leaves[g])
    nbr = NeighborLists(
        leaf_idx=torch.as_tensor(leaf_idx),
        n_leaves=torch.as_tensor(n_leaves.astype(np.int32)),
        overflow=torch.zeros(ng, dtype=torch.bool),
        group_nodes=torch.zeros(ng, dtype=torch.int64),
        visits=torch.zeros(ng, dtype=torch.int32))
    for which, per_tile in (("density", 1), ("hydro", 2)):
        new, simple = [], []
        for g in range(ng):
            pc = pcount[leaf_idx[g, :n_leaves[g]]]
            simple.append(3 + sum(2 + -(-c // 32) for c in pc))
            links = 3
            for l0 in range(0, n_leaves[g], seg):
                tiles = -(-int(pc[l0:l0 + seg].sum()) // tile)
                links += 2 + per_tile * -(-tiles // warps)
            new.append(links)
        assert chip_smoke.sph_critical_paths(tree, nbr, which) \
            == (max(new), max(simple))
