"""The neighbour walk kernel K3 (csrc/neighbors.cu) mirrored on the CPU.

The kernel runs only on a card (tests/test_torch_cuda.py).  Here its
procedure, one warp per target group working rounds over a sorted stack
of ranges and leaf markers, is mirrored in numpy and held against the
plain batched walk find_neighbors_reference: the same leaf lists, counts,
overflow flags and visits, group by group.  The near/far decisions are
made in float32, one rounded operation at a time as the kernel is
compiled (no multiply-add contraction).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mpgadget_tpu_torch.gravity import treewalk
from mpgadget_tpu_torch.gravity.tree import build_tree
from mpgadget_tpu_torch.ops import morton, pairs

# one intra-op thread: the suite runs in several worker processes that
# share the machine's cores
torch.set_num_threads(1)

FAR, LEAF, DESCEND = range(3)


def _kernel_defines():
    """The kernel's team width (lanes per group), siblings per lane and
    round, and stack entries per group, read from its source."""
    src = (Path(__file__).resolve().parents[1] / "mpgadget_tpu_torch" / "csrc"
           / "neighbors.cu").read_text()
    return {k: int(re.search(rf"#define {k} (\d+)", src).group(1))
            for k in ("TEAM", "SIBS", "QCAP")}


KERNEL = _kernel_defines()


def neighbor_inputs(kind, device="cpu", n=8192, seed=17, node_cap=None):
    """A per-level tree over n particles (uniform, or eight clusters) and
    its FOF target groups, as physics.fof builds them, and a seeded hmax
    on a fifth of the nodes (tests/test_torch_cuda.py shares them)."""
    rng = np.random.RandomState(seed)
    if kind == "uniform":
        pos = rng.uniform(0, 1, (n, 3))
    else:
        c = rng.uniform(0.2, 0.8, (8, 3))
        pos = np.mod(c[rng.randint(8, size=n)] + 0.02 * rng.randn(n, 3), 1)
    ipos = torch.as_tensor(np.minimum((pos * 2.0 ** 32).astype(np.int64),
                                      2 ** 32 - 1), device=device)
    valid = torch.as_tensor(rng.rand(n) > 0.05, device=device)
    keys = morton.morton_key(ipos)
    perm = morton.sort_order(keys, valid)
    vs = valid[perm]
    tree = build_tree(torch.where(vs, keys[perm], morton.KEY_PAD),
                      ipos[perm], torch.ones(n, device=device), vs, 16, 18,
                      node_cap or 2 * n + 64, group_max=32)
    pos_box = ipos[perm].float() * 2.0 ** -32
    groups = treewalk.make_target_groups(
        tree, pos_box, torch.full((n,), float("inf"), device=device),
        min(n // 4 + 64, tree.capacity), 32)
    hmax = torch.as_tensor(
        (rng.uniform(0, 0.02, tree.capacity)
         * (rng.rand(tree.capacity) < 0.2)).astype(np.float32),
        device=device)
    return tree, groups, hmax


def _near_rows(nodes, hmax, center, half, radius, symmetric):
    """Whether each row of the packed node table is near one group, every
    operation a rounded float32 operation in the kernel's order."""
    f = np.float32
    d = nodes[:, :3] - center
    dc = np.abs(d - np.rint(d))
    hl = f(0.5) * nodes[:, 3]
    dm = np.maximum((dc - half) - hl[:, None], f(0))
    r2min = (dm[:, 0] * dm[:, 0] + dm[:, 1] * dm[:, 1]) + dm[:, 2] * dm[:, 2]
    reach = np.maximum(radius, hmax) if symmetric else radius
    return r2min < reach * reach


INDEX = 0x7FFFFFFF          # a node index; bit 31 of a list entry flags a leaf


def _child_list(meta, c, C, sibs=KERNEL["SIBS"]):
    """Node c's child list as csrc/neighbors.cu's build_table writes it
    (for c < C): the nodes that 0, 1, ..., sibs - 1 skip pointers lead to
    from c + 1 while they ascend and lie before c's own skip pointer
    `end` (an index at or past C reads row C - 1), each with bit 31 set
    where it is a leaf, and `end` in the slots left."""
    end = int(meta[c]) & INDEX
    out, prev, cur = [], c, c + 1
    for _ in range(sibs):
        if prev < cur < end:
            mt = int(meta[min(cur, C - 1)])
            out.append(cur | (0x80000000 if mt < 0 else 0))
            prev, cur = cur, mt & INDEX
        else:
            out.append(end)
            prev = end
    return out


def _team_walk(near, meta, n_nodes, C, active, LL, stack_cap=pairs.STACK_CAP,
               window=KERNEL["TEAM"] // KERNEL["SIBS"], sibs=KERNEL["SIBS"]):
    """One group's walk as csrc/neighbors.cu runs it, on the group's near
    flags of every row.  The stack (its top is the list's end) holds,
    ascending from the top, ranges (a, b, list) of preorder indices still
    to walk, with the child list of the node whose children they are (or
    None), and leaf markers (node, -1, None).  A round takes the top w
    entries and visits a range's siblings at once: the entries of its
    list that lie inside it (a list ascends, so these are the siblings
    the skip pointers lead to: the test holds the mirror to the plain
    walk); without a list, the first sibling alone.  A range becomes
    each near leaf's marker or each near internal node's children's
    range, and, after its last sibling visited, the rest of the range
    where that sibling's skip pointer leads on inside it; markers that
    no range precedes leave in order.  A round that visits costs one dependent load.  A
    round whose new entries would not fit is taken again with as few
    entries as are sure to fit; when that is none, the top entry is taken
    alone, a range walked serially.  An index at or past C reads row
    C - 1.  Returns (listed leaves, leaves found, visits, rounds,
    dependent loads, serial visits)."""
    leaves = []
    found = visits = rounds = loads = serial = 0
    safe = False

    def emit(node):
        nonlocal found
        if found < LL:
            leaves.append(node)
        found += 1

    def visit(a, b):
        """(fate, next node, skip pointer) of node a in a range ending at
        b."""
        ic = min(a, C - 1)
        s = int(meta[ic]) & INDEX
        fate = FAR if not near[ic] else (LEAF if meta[ic] < 0 else DESCEND)
        return fate, (b if s <= a or s > b else s), s

    stack = [(0, n_nodes, None)] if active and n_nodes > 0 else []
    while stack:
        rounds += 1
        w = min(window, len(stack))
        if safe:
            w = min(w, (stack_cap - len(stack)) // sibs)
        if w <= 0:
            safe = False
            a, b, _ = stack.pop()
            if b < 0:
                emit(a)
                continue
            while a < b:
                fate, nxt, _ = visit(a, b)
                visits += 1
                serial += 1
                loads += 1
                if fate == DESCEND:
                    a += 1
                else:
                    if fate == LEAF:
                        emit(a)
                    a = nxt
            continue
        new, seen = [], 0
        for a, b, kids in stack[:-w - 1:-1]:            # ascending
            if b < 0:
                new.append((a, b, None))
                continue
            listed = kids is not None and kids[0] & INDEX == a
            for node in ([k & INDEX for k in kids] if listed else [a]):
                if node >= b:
                    break
                fate, nxt, s = visit(node, b)
                link = node < s < b
                seen += 1
                if fate == LEAF:
                    new.append((node, -1, None))
                if fate == DESCEND and node + 1 < nxt:
                    new.append((node + 1, nxt,
                                _child_list(meta, min(node, C - 1), C)))
            if link:
                new.append((s, b, None))
        loads += seen > 0
        assert new == sorted(new, key=lambda e: e[0])
        final = next((k for k, e in enumerate(new) if e[1] >= 0), len(new))
        safe = len(stack) - w + len(new) - final > stack_cap
        if safe:                # nothing is written: take fewer
            continue
        del stack[-w:]
        visits += seen
        for a, _, _ in new[:final]:
            emit(a)
        stack.extend(reversed(new[final:]))
    return leaves, found, visits, rounds, loads, serial


def mirror_walks(tree, groups, radius, hmax, LL, symmetric,
                 stack_cap=pairs.STACK_CAP):
    """_team_walk for every target group: a list of its results."""
    nodes = torch.cat([tree.center, tree.length[:, None]], 1).cpu().numpy()
    meta = treewalk.pack_meta(tree).cpu().numpy()
    hm = hmax.cpu().numpy() if symmetric else None
    gn, gc, gh = (a.cpu().numpy() for a in groups[:3])
    rad = radius.cpu().numpy()
    n_nodes, C = int(tree.n_nodes), tree.capacity
    rows = min(n_nodes, C)
    out = []
    for g in range(len(gn)):
        near = _near_rows(nodes[:rows], None if hm is None else hm[:rows],
                          gc[g], gh[g], rad[g], symmetric)
        out.append(_team_walk(near, meta, n_nodes, C, gn[g] < n_nodes, LL,
                              stack_cap=stack_cap))
    return out


def _check_against_plain(tree, groups, radius, hmax, LL, symmetric,
                         stack_cap=pairs.STACK_CAP):
    """The mirror's lists, counts, flags and visits against the plain
    walk's, group by group; returns the mirror's results and the plain
    walk's NeighborLists."""
    nodes, gc, gh = groups[:3]
    ref = pairs.find_neighbors_reference(tree, nodes, gc, gh, radius, hmax,
                                         LL, symmetric=symmetric)
    got = mirror_walks(tree, groups, radius, hmax, LL, symmetric, stack_cap)
    C = tree.capacity
    for g, (leaves, found, visits, *_rest) in enumerate(got):
        want = ref.leaf_idx[g].numpy()
        assert int(ref.n_leaves[g]) == len(leaves) == min(found, LL)
        np.testing.assert_array_equal(want[:len(leaves)], leaves)
        assert (want[len(leaves):] == C).all()
        assert bool(ref.overflow[g]) == (found >= LL)
        assert int(ref.visits[g]) == visits
    return got, ref


@pytest.mark.parametrize("kind,symmetric,LL,stack_cap", [
    # FOF's search (asymmetric, the linking length); LL 8 overflows
    ("uniform", False, 64, pairs.STACK_CAP),
    ("clusters", False, 8, pairs.STACK_CAP),
    # SPH's symmetric search with a seeded hmax
    ("clusters", True, 256, pairs.STACK_CAP),
    ("clusters", False, 1, pairs.STACK_CAP),
    # a stack too small for the rounds: they are taken again with fewer
    # entries, and serial walks take over
    ("clusters", True, 256, 10),
    ("uniform", False, 64, 1)])
def test_team_walk_matches_plain_walk(kind, symmetric, LL, stack_cap):
    """The kernel's rounds (mirrored in numpy) give the plain walk's leaf
    lists, counts, overflow flags and visits; the full stack never
    leaves the rounds, whose critical path is far shorter than the
    visits, and a small one falls back to serial walks."""
    tree, groups, hmax = neighbor_inputs(kind, n=2048)
    radius = torch.full((groups[0].shape[0],), 0.2 / 12.7)
    got, ref = _check_against_plain(tree, groups, radius, hmax, LL,
                                    symmetric, stack_cap)
    if LL < 64:
        assert bool(ref.overflow.any())
    serial = [r[5] for r in got]
    assert (sum(serial) > 0) == (stack_cap < pairs.STACK_CAP)
    if stack_cap == pairs.STACK_CAP:
        loads = [r[4] for r in got]
        assert max(loads) * 2 < int(ref.visits.max())


def test_group_with_exactly_ll_leaves_is_flagged():
    """Count first, flag at LL (the JAX package's rule): a group whose
    search finds exactly LL leaves has a full list and its flag set; one
    more slot clears the flag."""
    tree, groups, hmax = neighbor_inputs("clusters", n=2048)
    radius = torch.full((groups[0].shape[0],), 0.2 / 12.7)
    nodes, gc, gh = groups[:3]
    full = pairs.find_neighbors_reference(tree, nodes, gc, gh, radius, hmax,
                                          512, symmetric=False)
    g = int(torch.argmax(full.n_leaves))
    LL = int(full.n_leaves[g])
    assert not bool(full.overflow[g]) and LL > 1
    _, ref = _check_against_plain(tree, groups, radius, hmax, LL, False)
    assert bool(ref.overflow[g]) and int(ref.n_leaves[g]) == LL
    _, ref = _check_against_plain(tree, groups, radius, hmax, LL + 1, False)
    assert not bool(ref.overflow[g])


@pytest.mark.parametrize("stack_cap", [pairs.STACK_CAP, 16])
def test_team_walk_past_the_tree_capacity(stack_cap):
    """A tree that overflowed its capacity: indices at or past its rows
    read the last row, as the plain walk does."""
    tree, groups, hmax = neighbor_inputs("uniform", n=1024, node_cap=150)
    assert bool(tree.overflow) and int(tree.n_nodes) > tree.capacity
    # every node near: the last row, an internal node, is descended, so
    # that the walk runs on through the indices past the rows to its end
    radius = torch.full((groups[0].shape[0],), 1.0)
    _, ref = _check_against_plain(tree, groups, radius, hmax, 64, False,
                                  stack_cap)
    assert int(ref.visits.max()) > tree.capacity


def test_wrapper_stack_matches_the_kernel():
    """The wrapper's largest stack_cap is the kernel's stack; a team is
    whole segments of SIBS lanes within a warp (its masks are 32-bit
    ballots), and a child list fills two int4 of the table row."""
    assert pairs.STACK_CAP == KERNEL["QCAP"]
    assert KERNEL["SIBS"] == 8
    assert KERNEL["TEAM"] % KERNEL["SIBS"] == 0 and KERNEL["TEAM"] < 32


def test_child_lists_hold_the_children_in_order():
    """In a well-formed tree the child list of an internal node starts
    with its children in order (its subtree's nodes one level down), and
    what follows lies past its subtree."""
    tree = neighbor_inputs("clusters", n=2048)[0]
    meta = treewalk.pack_meta(tree).numpy()
    skip, leaf, level = (a.numpy() for a in (tree.skip, tree.is_leaf,
                                             tree.level))
    n_nodes, C = int(tree.n_nodes), tree.capacity
    internal = np.flatnonzero(~leaf[:n_nodes])
    assert len(internal) > 20
    for i in internal:
        got = _child_list(meta, i, C)
        sub = np.arange(i + 1, skip[i])
        want = sub[level[sub] == level[i] + 1]
        n = len(want)
        assert 0 < n <= KERNEL["SIBS"]
        assert [k & INDEX for k in got[:n]] == list(want)
        assert [k >= 0x80000000 for k in got[:n]] == list(leaf[want])
        assert all(k & INDEX >= skip[i] for k in got[n:])
