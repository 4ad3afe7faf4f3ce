"""What surrounds the port's two CUDA kernels, on the CPU: the walk's node
table and its plain version, the pair kernel's work list and source
counts, the fitted window, and the card as the entry points' default.

The kernels themselves run only on a card (tests/test_torch_cuda.py).
Here the walk kernel's per-block procedure is mirrored in float32 numpy,
one rounded operation at a time as the kernel is compiled (no
multiply-add contraction), and held against the plain batched walk: the
leaf lists must be the same bit for bit.  Two mirrors: the serial walk
(one node after the other, the order that defines the results) and the
kernel's rounds over a sorted stack of ranges and markers, which must
give the serial walk's leaves and monopoles in its order.
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.special import erfcx

from mpgadget_tpu_torch.gravity import pairkernel as pk
from mpgadget_tpu_torch.gravity import treepm, treewalk as tw
from mpgadget_tpu_torch.gravity.tree import Tree
from mpgadget_tpu_torch.particles import ParticleData
from mpgadget_tpu_torch.run import Simulation

CSRC = Path(__file__).resolve().parents[1] / "mpgadget_tpu_torch" / "csrc"
RS_INV = 42.666668
H_INV = 300.0
RCUT = 0.0703125

# the erfcx fit of csrc/shortrange.cuh (descending, in t = u/1.75 - 1)
ERFCX_COEF = (1.322439755e-03, -3.050815780e-03, 2.034642501e-03,
              -2.875122475e-03, 9.868625551e-03, -1.870233938e-02,
              2.987133339e-02, -4.916772246e-02, 7.879809290e-02,
              -1.193499863e-01, 1.707793027e-01, -2.292069048e-01,
              2.849721909e-01)
ERFCX_REL_ERR = 1e-6      # stated in shortrange.cuh

# one intra-op thread: the suite runs in several worker processes that
# share the machine's cores
torch.set_num_threads(1)


def walk_inputs(kind, device="cpu", n=4096, seed=9, node_cap=None):
    """The walk's inputs on ``device`` (tests/test_torch_cuda.py shares
    them).  "blob": uniform with a quarter in one small blob, a slow old
    acceleration (the relative criterion opens every node); "clusters":
    eight clusters and an old acceleration of the size their own gravity
    gives, so that both criteria accept many nodes as monopoles."""
    rng = np.random.RandomState(seed)
    if kind == "blob":
        pos = rng.uniform(0, 1, (n, 3))
        pos[: n // 4] = np.mod(0.5 + rng.randn(n // 4, 3) * 0.01, 1.0)
        amag = rng.uniform(0, 2e-3, n) / 1e-3
    else:
        c = rng.uniform(0.2, 0.8, (8, 3))
        pos = np.mod(c[rng.randint(8, size=n)] + 0.03 * rng.randn(n, 3), 1.0)
        amag = rng.uniform(0.5, 2.0, n) * 1e4
    w = treepm.walk_inputs(
        torch.as_tensor((pos * 2.0 ** 32).astype(np.int64), device=device),
        torch.as_tensor(rng.uniform(5, 15, n).astype(np.float32),
                        device=device),
        torch.ones(n, dtype=torch.bool, device=device),
        torch.as_tensor(amag.astype(np.float32), device=device), leaf_max=32,
        max_level=15, node_cap=node_cap or int(0.35 * n) + 64,
        group_size=256)
    aold = float(np.float32(0.002)) * w.amin
    return w.tree, w.tpos, w.center, w.half, aold, w.active


DISCARD, MONOPOLE, LEAF, DESCEND = range(4)


def _decide(nodes, meta, C, i, center, half, aold, rcut2, bh2, bh_only):
    """(fate, skip pointer) of node i for one block as the kernel decides
    it: every operation a rounded float32 operation, in the kernel's
    order.  An index at or past C reads row C - 1."""
    f = np.float32
    ic = min(i, C - 1)
    cx, cy, cz, ln, _, _, _, m = nodes[ic]
    mt = int(meta[ic])
    dc = [abs(f(d - np.rint(d))) for d in (f(cx - center[0]),
                                           f(cy - center[1]),
                                           f(cz - center[2]))]
    hl = f(f(0.5) * ln)
    dm = [max(f(f(d - h) - hl), f(0)) for d, h in zip(dc, half)]
    r2min = f(f(f(dm[0] * dm[0]) + f(dm[1] * dm[1])) + f(dm[2] * dm[2]))
    skip = mt & 0x7FFFFFFF
    if r2min > rcut2:
        return DISCARD, skip
    opened = f(ln * ln) > f(bh2 * r2min)
    if not bh_only:
        opened = opened or f(f(m * ln) * ln) > f(f(r2min * r2min) * aold)
    l6 = f(f(0.6) * ln)
    opened = opened or r2min <= 0 or all(d < f(h + l6)
                                         for d, h in zip(dc, half))
    if not opened:
        return MONOPOLE, skip
    return (LEAF if mt < 0 else DESCEND), skip


def _scalar_walk(nodes, meta, n_nodes, C, center, half, aold, active, LL,
                 rcut, bh_angle2, use_bh, monos=None):
    """One block's serial walk, one node after the other.  Returns
    (leaves, overflow, visits, monopoles); the accepted nodes are
    appended to ``monos`` in the order they are applied."""
    rcut2 = np.float32(rcut * rcut)
    bh2 = np.float32(bh_angle2)
    bh_only = use_bh or aold <= 0
    leaves, ovf, visits, mono = [], False, 0, 0
    i = 0 if active else n_nodes
    while i < n_nodes:
        visits += 1
        fate, skip = _decide(nodes, meta, C, i, center, half, aold, rcut2,
                             bh2, bh_only)
        if fate == DISCARD:
            i = skip
        elif fate == MONOPOLE:
            mono += 1
            if monos is not None:
                monos.append(i)
            i = skip
        elif fate == LEAF:
            if len(leaves) < LL:
                leaves.append(i)
            else:
                ovf = True
            i = skip
        else:
            i += 1
    return leaves, ovf, visits, mono


def _stack_walk(nodes, meta, n_nodes, C, center, half, aold, active, LL,
                rcut, bh_angle2, use_bh, window=256, stack_cap=3072, sibs=8):
    """One block's walk as csrc/treewalk.cu runs it.  The stack (its top
    is the list's end) holds, ascending from the top, ranges (a, b) of
    preorder indices still to walk and markers (node, -fate).  A round
    takes the top w entries; in a range up to ``sibs`` siblings are
    visited, each found through the one before, and it becomes each
    sibling's marker or its children's range, and the range of the
    siblings left; markers that no range precedes leave in order.  A
    round whose new entries would not fit is taken again with as few
    entries as are sure to fit; when that is none, the top entry is taken
    alone, a range walked serially.  A skip pointer outside (a, b] counts
    as b.  Returns (leaves, overflow, visits, monopole nodes in the order
    applied, rounds, dependent loads, serial visits)."""
    rcut2 = np.float32(rcut * rcut)
    bh2 = np.float32(bh_angle2)
    bh_only = use_bh or aold <= 0
    leaves, monos = [], []
    n_opened = visits = rounds = loads = serial = 0
    safe = False

    def emit(node, fate):
        nonlocal n_opened
        if fate == LEAF:
            if n_opened < LL:
                leaves.append(node)
            n_opened += 1
        else:
            monos.append(node)

    def visit(a, b):
        fate, skip = _decide(nodes, meta, C, a, center, half, aold, rcut2,
                             bh2, bh_only)
        return fate, (b if skip <= a or skip > b else skip)

    stack = [(0, n_nodes)] if active and n_nodes > 0 else []
    while stack:
        rounds += 1
        w = min(window, len(stack))
        if safe:
            w = min(w, (stack_cap - len(stack)) // (2 * sibs))
        if w <= 0:
            safe = False
            a, b = stack.pop()
            if b < 0:
                emit(a, -b)
                continue
            while a < b:
                fate, skip = visit(a, b)
                visits += 1
                serial += 1
                loads += 1
                if fate == DESCEND:
                    a += 1
                else:
                    if fate != DISCARD:
                        emit(a, fate)
                    a = skip
            continue
        new, seen, deepest = [], 0, 0
        for a, b in stack[:-w - 1:-1]:                  # ascending
            if b < 0:
                new.append((a, b))
                continue
            k = 0
            while a < b and k < sibs:
                fate, skip = visit(a, b)
                k += 1
                if fate in (MONOPOLE, LEAF):
                    new.append((a, -fate))
                if fate == DESCEND and a + 1 < skip:
                    new.append((a + 1, skip))
                a = skip
            if a < b:
                new.append((a, b))
            seen += k
            deepest = max(deepest, k)
        loads += deepest
        assert new == sorted(new, key=lambda e: e[0])
        final = next((k for k, e in enumerate(new) if e[1] >= 0), len(new))
        safe = len(stack) - w + len(new) - final > stack_cap
        if safe:                # nothing is written: take fewer
            continue
        del stack[-w:]
        visits += seen
        for a, b in new[:final]:
            emit(a, -b)
        stack.extend(reversed(new[final:]))
    return leaves, n_opened > LL, visits, monos, rounds, loads, serial


@pytest.mark.parametrize("kind,use_bh,LL,rcut", [
    ("blob", True, 512, RCUT), ("blob", False, 512, RCUT),
    ("blob", True, 24, RCUT), ("clusters", True, 512, 0.25),
    ("clusters", False, 512, 0.25)])
def test_kernel_walk_order_matches_plain_walk(kind, use_bh, LL, rcut):
    """The kernel's per-block loop (mirrored in float32 numpy on the
    packed node table) records the plain walk's leaves bit for bit, with
    its visit and monopole counts; LL=24 overflows."""
    tree, tpos, center, half, aold, active = walk_inputs(kind)
    bh_angle2 = float(np.float32((0.5 if kind == "clusters" else 0.175) ** 2
                                 if use_bh else 0.9 ** 2))
    timer = treepm.StageTimer()
    before = tw.LAUNCHES
    acc, pot, leaf_idx, nl, ovf = tw.traverse_fused(
        tree, tpos, center, half, aold, active,
        tw.WalkConfig(leaf_list_max=LL), rcut, bh_angle2, use_bh,
        3.0 / rcut, H_INV, with_potential=True, timer=timer)
    assert tw.LAUNCHES == before          # CPU tensors: the plain version
    if LL == 24:
        assert bool(ovf.any())
    nodes, meta = (a.numpy() for a in tw.pack_nodes(tree))
    n_nodes, C = int(tree.n_nodes), tree.capacity
    c, h, ao, act = (a.numpy() for a in (center, half, aold, active))
    visits, mono = [], []
    for b in range(tpos.shape[0]):
        leaves, bovf, v, m = _scalar_walk(nodes, meta, n_nodes, C, c[b],
                                          h[b], ao[b], act[b], LL, rcut,
                                          bh_angle2, use_bh)
        assert int(nl[b]) == len(leaves)
        np.testing.assert_array_equal(leaf_idx[b, :len(leaves)].numpy(),
                                      leaves)
        assert (leaf_idx[b, len(leaves):] == C).all()
        assert bool(ovf[b]) == bovf
        visits.append(v)
        mono.append(m)
    assert timer.counts["walk_iterations"] == max(visits)
    assert timer.series["walk_visits_sum"] == [sum(visits)]
    assert timer.series["walk_monopoles"] == [sum(mono)]
    assert (sum(mono) > 100) == (kind == "clusters")
    assert torch.isfinite(acc).all() and torch.isfinite(pot).all()


@pytest.mark.parametrize("kind,use_bh,LL,rcut,stack_cap,node_cap", [
    ("blob", True, 512, RCUT, 3072, None),
    ("blob", False, 512, RCUT, 3072, None),
    ("blob", True, 24, RCUT, 3072, None),
    ("clusters", True, 512, 0.25, 3072, None),
    ("clusters", False, 512, 0.25, 3072, None),
    # a stack too small for its rounds: they are taken again with fewer
    # entries, and serial walks take over
    ("blob", True, 24, RCUT, 40, None),
    ("clusters", True, 512, 0.25, 100, None),
    ("clusters", False, 512, 0.25, 1, None),
    # a tree that overflowed its capacity (770 nodes, 299 rows): rcut of
    # the box and BH keep its last row, a level-2 cell, opened, so that
    # the walk runs on through the indices past the rows to its end
    ("blob", True, 512, 1.0, 3072, 299),
    ("blob", True, 512, 1.0, 16, 299)])
def test_kernel_stack_walk_matches_plain_walk(kind, use_bh, LL, rcut,
                                              stack_cap, node_cap):
    """The kernel's rounds over its sorted stack (mirrored in float32
    numpy) give the plain walk's leaf lists, flags and counts, and the
    serial walk's monopoles in its order; block 3 is inactive."""
    tree, tpos, center, half, aold, active = walk_inputs(kind,
                                                         node_cap=node_cap)
    active = active.clone()
    active[3] = False
    assert bool(tree.overflow) == (node_cap is not None)
    bh_angle2 = float(np.float32((0.5 if kind == "clusters" else 0.175) ** 2
                                 if use_bh else 0.9 ** 2))
    timer = treepm.StageTimer()
    acc, pot, leaf_idx, nl, ovf = tw.traverse_fused(
        tree, tpos, center, half, aold, active,
        tw.WalkConfig(leaf_list_max=LL), rcut, bh_angle2, use_bh,
        3.0 / rcut, H_INV, with_potential=True, timer=timer)
    if LL == 24:
        assert bool(ovf.any())
    nodes, meta = (a.numpy() for a in tw.pack_nodes(tree))
    n_nodes, C = int(tree.n_nodes), tree.capacity
    c, h, ao, act = (a.numpy() for a in (center, half, aold, active))
    visits, mono, serial, rounds = [], [], [], []
    for b in range(tpos.shape[0]):
        args = (nodes, meta, n_nodes, C, c[b], h[b], ao[b], act[b], LL, rcut,
                bh_angle2, use_bh)
        leaves, bovf, v, monos, r, ld, ser = _stack_walk(
            *args, stack_cap=stack_cap)
        assert ld <= 8 * r + ser
        serial_monos = []
        assert _scalar_walk(*args, monos=serial_monos) == (
            leaves, bovf, v, len(monos))
        assert monos == serial_monos
        assert int(nl[b]) == len(leaves)
        np.testing.assert_array_equal(leaf_idx[b, :len(leaves)].numpy(),
                                      leaves)
        assert (leaf_idx[b, len(leaves):] == C).all()
        assert bool(ovf[b]) == bovf
        visits.append(v)
        mono.append(len(monos))
        serial.append(ser)
        rounds.append(r)
    assert visits[3] == 0 and rounds[3] == 0 and int(nl[3]) == 0
    assert timer.counts["walk_iterations"] == max(visits)
    assert timer.series["walk_visits_sum"] == [sum(visits)]
    assert timer.series["walk_monopoles"] == [sum(mono)]
    # the full stack never leaves the rounds, and they are far fewer than
    # the visits; a small one falls back to serial walks
    assert (sum(serial) > 0) == (stack_cap < 3072)
    if stack_cap == 3072 and node_cap is None:
        assert max(rounds) <= 12 and max(visits) > 20 * max(rounds)
    if node_cap is not None:
        assert n_nodes > C and max(visits) > C


@pytest.mark.parametrize("kind", ["blob", "clusters"])
def test_plain_walk_skipping_monopole_free_iterations_is_bit_identical(kind):
    """The plain walk skips the monopole terms of an iteration in which no
    block applies a monopole.  A copy of the module that applies them in
    every iteration (and records which iterations the original skips)
    gives the same accelerations, potentials and leaf lists bit for
    bit."""
    src = inspect.getsource(tw)
    skip = "if bool(use_node.any()):"
    assert src.count(skip) == 1
    always = type(tw)("mpgadget_tpu_torch.gravity._treewalk_always")
    always.__package__ = tw.__package__
    always._seen = []
    exec(compile(src.replace(
        skip, "if _seen.append(bool(use_node.any())) or True:"),
        tw.__file__, "exec"), always.__dict__)
    tree, tpos, center, half, aold, active = walk_inputs(kind)
    args = (tree, tpos, center, half, aold, active,
            tw.WalkConfig(leaf_list_max=512), RCUT, float(np.float32(0.25)),
            True, 3.0 / RCUT, H_INV)
    got = tw.traverse_fused_reference(*args, with_potential=True)
    want = always.traverse_fused_reference(*args, with_potential=True)
    assert False in always._seen and True in always._seen
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_pack_nodes_round_trips_every_field():
    tree = walk_inputs("clusters")[0]
    nodes, meta = tw.pack_nodes(tree)
    assert nodes.dtype == torch.float32 and meta.dtype == torch.int32
    assert nodes.shape == (tree.capacity, 8) and nodes.is_contiguous()
    back = dict(center=nodes[:, 0:3], length=nodes[:, 3], com=nodes[:, 4:7],
                mass=nodes[:, 7], skip=(meta & 0x7FFFFFFF).to(torch.int64),
                is_leaf=meta < 0)
    assert bool(tree.is_leaf.any()) and bool((tree.skip > 0).any())
    for name, value in back.items():
        np.testing.assert_array_equal(value.numpy(),
                                      getattr(tree, name).numpy(), name)


@pytest.mark.parametrize("T", [2048, 512])
def test_pair_work_list_covers_each_count_once_in_order(T):
    S = 4096
    rng = np.random.RandomState(3)
    counts = np.concatenate([[S, 0, T, T + 8, S + 100],
                             rng.randint(0, S // 8, 20) * 8])
    item_block, item_start, first, n_items, M = pk.pair_work_items(
        torch.as_tensor(counts, dtype=torch.int32), S, T)
    nb = len(counts)
    assert M == nb * (S // T) and item_block.shape == (M,)
    assert item_block.dtype == torch.int32 and n_items.dtype == torch.int32
    ib, st = item_block.numpy(), item_start.numpy()
    first, n_items = first.numpy(), n_items.numpy()
    total = int(n_items.sum())
    assert (ib[total:] == nb).all()                   # sentinels
    assert (np.diff(ib[:total]) >= 0).all()           # block order
    for b, cnt in enumerate(np.minimum(counts, S)):
        rows = np.flatnonzero(ib == b)
        assert len(rows) == n_items[b] and (len(rows) == 0
                                            or rows[0] == first[b])
        covered = np.zeros(S, int)
        for s0 in st[rows]:
            covered[s0:min(s0 + T, cnt)] += 1
        assert (covered[:cnt] == 1).all() and (covered[cnt:] == 0).all()


@pytest.mark.parametrize("nb,S,T", [(1024, 4096, 512), (1024, 65536, 2048),
                                    (4, 100, 512), (8192, 8192, 512)])
def test_pair_work_items_stay_within_the_partials(nb, S, T):
    # the item size depends on S alone (the same for any number of
    # blocks); at nb = 1024 it is what a bound of 32768 items per launch
    # gave
    assert pk.item_sources(S) == T
    M = pk.pair_work_items(torch.full((nb,), S, dtype=torch.int32), S, T)[4]
    assert M == nb * (-(-S // T)) <= nb * pk.MAX_BLOCK_ITEMS


def _pair_inputs(nb, G, S, counts, seed=5):
    rng = np.random.RandomState(seed)
    c = rng.rand(nb, 1, 3)
    tgt = np.mod(c + rng.uniform(-0.01, 0.01, (nb, G, 3)), 1.0)
    src = np.mod(c + rng.uniform(-0.1, 0.1, (nb, S, 3)), 1.0)
    sm = rng.uniform(0.5, 1.5, (nb, S))
    sm[np.arange(S)[None, :] >= np.asarray(counts)[:, None]] = 0.0
    t = [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)
         for a in ([tgt[:, :, k] for k in range(3)]
                   + [src[:, :, k] for k in range(3)]
                   + [sm, rng.randn(nb, 3, G), rng.randn(nb, G)])]
    return t, torch.as_tensor(counts, dtype=torch.int32)


@pytest.mark.parametrize("counts", [(1024, 0, 296, 8), (296, 0, 8, 64)])
def test_plain_pair_with_counts_is_bit_identical(counts):
    """Counts leave out zero-mass padding only, chunks past every count
    included: the sums are the same bit for bit."""
    args, cnt = _pair_inputs(4, 64, 1024, counts)
    every = torch.full((4,), 1024, dtype=torch.int32)
    before = pk.LAUNCHES
    for wp in (False, True):
        a0, p0 = pk.block_pair_accumulate(*args, RS_INV, H_INV, RCUT, every,
                                          chunk=128, with_potential=wp)
        a1, p1 = pk.block_pair_accumulate(*args, RS_INV, H_INV, RCUT, cnt,
                                          chunk=128, with_potential=wp)
        np.testing.assert_array_equal(a1.numpy(), a0.numpy())
        np.testing.assert_array_equal(p1.numpy(), p0.numpy())
    assert pk.LAUNCHES == before


def test_plain_pair_count_leaves_out_the_slots_past_it():
    args, cnt = _pair_inputs(4, 64, 1024, (1024, 0, 296, 8))
    args[6] = args[6] + 1.0                   # no zero-mass padding now
    acc, pot = pk.block_pair_accumulate(*args, RS_INV, H_INV, RCUT, cnt,
                                        with_potential=True)
    masked = list(args)
    masked[6] = torch.where(torch.arange(1024)[None, :]
                            < cnt[:, None].long(), args[6], 0.0)
    every = torch.full((4,), 1024, dtype=torch.int32)
    ref_acc, ref_pot = pk.block_pair_accumulate(*masked, RS_INV, H_INV, RCUT,
                                                every, with_potential=True)
    np.testing.assert_array_equal(acc.numpy(), ref_acc.numpy())
    np.testing.assert_array_equal(pot.numpy(), ref_pot.numpy())
    np.testing.assert_array_equal(acc[1].numpy(), args[7][1].numpy())


def test_erfcx_fit_within_its_stated_error():
    """The coefficients in csrc/shortrange.cuh are this test's, and the
    fit, evaluated in float32 Horner form, is within 1e-6 of erfcx(u) over
    [0, 3.5] (so Q = fit + 2u/sqrt(pi) is within 1e-6 of erfcx(u) +
    2u/sqrt(pi))."""
    src = (CSRC / "shortrange.cuh").read_text()
    body = src[src.index("ERFCX_COEF (descending)") - 40:
               src.index("end ERFCX_COEF")]
    found = [float(x) for x in re.findall(r"(-?\d\.\d+e[-+]\d+)f", body)]
    assert found == list(ERFCX_COEF)
    assert f"#define ERFCX_NCOEF {len(ERFCX_COEF)}" in src
    u = np.linspace(0.0, 3.5, 100001).astype(np.float32)
    t = (u * np.float32(0.571428571) - np.float32(1.0)).astype(np.float32)
    p = np.full_like(t, np.float32(ERFCX_COEF[0]))
    for c in ERFCX_COEF[1:]:
        p = (p * t + np.float32(c)).astype(np.float32)
    ref = erfcx(u.astype(np.float64))
    assert np.max(np.abs(p - ref) / ref) < ERFCX_REL_ERR
    q_ref = ref + 2.0 * u / np.sqrt(np.pi)
    q = p + np.float32(2.0 / np.sqrt(np.pi)) * u
    assert np.max(np.abs(q - q_ref) / q_ref) < ERFCX_REL_ERR


@pytest.mark.parametrize("fn", [ParticleData.zeros, ParticleData.from_numpy,
                                ParticleData.from_jax_numpy,
                                Tree.from_jax_numpy, Simulation.from_snapshot])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
