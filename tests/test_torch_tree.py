"""Morton sort, tree build, block walk and tree force of the PyTorch port
against the JAX package, on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpgadget_tpu.gravity import tree32 as j32, treepm as jtp, \
    treewalk as jtw
from mpgadget_tpu.gravity.shortrange import \
    direct_shortrange_pairwise as jax_direct
from mpgadget_tpu_torch.gravity import tree32 as t32, treepm as ttp, \
    treewalk as ttw
from mpgadget_tpu_torch.gravity.shortrange import direct_shortrange_pairwise
from mpgadget_tpu_torch.gravity.tree import Tree
from mpgadget_tpu_torch.particles import ParticleData

BOX = 10000.0
INT_FIELDS = ("level", "pstart", "pcount", "skip", "is_leaf", "is_group")
F32_FIELDS = ("mass", "com", "center", "length")

# one intra-op thread: the suite runs in several worker processes that
# share the machine's cores
torch.set_num_threads(1)


def _positions(n, seed, clustered):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, BOX, (n, 3))
    if clustered:
        pos[: n // 4] = BOX / 2 + rng.randn(n // 4, 3) * BOX * 0.01
    ipos = (np.mod(pos, BOX) / BOX * 2.0 ** 32).astype(np.uint32)
    mass = rng.uniform(5.0, 15.0, n).astype(np.float32)
    amag = rng.uniform(0.0, 2e-3, n).astype(np.float32)
    return ipos, mass, amag


def _t(a):
    """numpy/JAX array -> CPU tensor (uint32 positions -> int64)."""
    a = np.array(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.uint32 else a)


def _both_trees(n=4096, seed=3, clustered=True, leaf_max=32, max_level=15):
    ipos, mass, _ = _positions(n, seed, clustered)
    valid = np.ones(n, bool)
    cap = int(0.35 * n) + 64
    hi, lo, perm, ipos_s, valid_s, pay = j32.sort_by_morton32_payload(
        jnp.asarray(ipos), jnp.asarray(valid), [jnp.asarray(mass)])
    jt = j32.build_tree32(hi, lo, ipos_s, pay[0], valid_s, leaf_max,
                          max_level, cap, group_max=256)
    key, tperm, tipos_s, tvalid_s, tpay = t32.sort_by_morton32_payload(
        _t(ipos), _t(valid), (_t(mass),))
    tt = t32.build_tree32(key, tipos_s, tpay[0], tvalid_s, leaf_max,
                          max_level, cap, group_max=256)
    return (perm, jt, ipos_s, pay[0]), (tperm, tt, tipos_s, tpay[0])


@pytest.mark.parametrize("clustered", [False, True])
def test_morton_sort_permutation_identical(clustered):
    ipos, mass, amag = _positions(4096, 5, clustered)
    valid = np.ones(4096, bool)
    valid[-100:] = False          # invalid rows sink to the tail
    _, _, perm, ipos_s, valid_s, pay = j32.sort_by_morton32_payload(
        jnp.asarray(ipos), jnp.asarray(valid),
        [jnp.asarray(mass), jnp.asarray(amag)])
    _, tperm, tipos_s, tvalid_s, tpay = t32.sort_by_morton32_payload(
        _t(ipos), _t(valid), (_t(mass), _t(amag)))
    nv = 4096 - 100   # ties among invalid rows may sort either way
    np.testing.assert_array_equal(tperm.numpy()[:nv], np.asarray(perm)[:nv])
    np.testing.assert_array_equal(tipos_s.numpy(),
                                  np.asarray(ipos_s).astype(np.int64))
    np.testing.assert_array_equal(tvalid_s.numpy(), np.asarray(valid_s))
    np.testing.assert_array_equal(tpay[1].numpy()[:nv],
                                  np.asarray(pay[1])[:nv])


@pytest.mark.parametrize("clustered,leaf_max,max_level",
                         [(False, 32, 15), (True, 32, 15), (True, 8, 16),
                          (True, 16, 6)])
def test_tree_build_matches_jax(clustered, leaf_max, max_level):
    (_, jt, _, _), (_, tt, _, _) = _both_trees(
        clustered=clustered, leaf_max=leaf_max, max_level=max_level)
    assert int(tt.n_nodes) == int(jt.n_nodes)
    assert bool(tt.overflow) == bool(jt.overflow)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(
            getattr(tt, f).numpy().astype(np.int64),
            np.asarray(getattr(jt, f)).astype(np.int64), err_msg=f)
    # same f32 terms and, by construction, the same prefix-sum
    # association: 1e-6 relative
    for f in F32_FIELDS:
        np.testing.assert_allclose(getattr(tt, f).numpy(),
                                   np.asarray(getattr(jt, f)), rtol=1e-6,
                                   atol=0, err_msg=f)


def _walk_inputs(seed):
    (perm, jt, ipos_s, mass_s), _ = _both_trees(seed=seed)
    n = ipos_s.shape[0]
    _, _, amag = _positions(n, seed, True)
    amag_s = jnp.asarray(amag)[perm]
    pos_box = ipos_s.astype(jnp.float32) * jnp.float32(2.0 ** -32)
    jgroups = jtw.make_block_groups(pos_box, jnp.ones(n, bool), amag_s, 256)
    tgroups = ttw.make_block_groups(_t(pos_box), torch.ones(n, dtype=bool),
                                    _t(amag_s), 256)
    for a, b in zip(jgroups, tgroups):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    fields = {k: np.asarray(getattr(jt, k))
              for k in Tree.__dataclass_fields__}
    tt = Tree.from_jax_numpy(fields, device="cpu")
    return jt, tt, jgroups, tgroups, pos_box, mass_s


@pytest.mark.parametrize("use_bh,with_potential",
                         [(True, False), (False, True)])
def test_walk_matches_jax_on_same_tree(use_bh, with_potential):
    jt, tt, jg, tg, _, _ = _walk_inputs(9)
    kw = dict(rcut=0.0703125, bh_angle2=float(np.float32(
        0.175 ** 2 if use_bh else 0.9 ** 2)), use_bh=use_bh,
        rs_inv=42.666668, h_inv=300.0, with_potential=with_potential)
    jtp_, jc, jh, jamin, jact = jg
    aold = float(np.float32(0.002)) * jamin / 1e-3
    jres = jtw.traverse_fused(jt, jtp_, jc, jh, aold, jact,
                              jtw.WalkConfig(), **kw)
    ttp_, tc, th, tamin, tact = tg
    taold = float(np.float32(0.002)) * tamin / 1e-3
    tres = ttw.traverse_fused(tt, ttp_, tc, th, taold, tact,
                              ttw.WalkConfig(), **kw)
    jacc, jpot, jleaf, jnl, jovf = (np.asarray(a) for a in jres)
    tacc, tpot, tleaf, tnl, tovf = (a.numpy() for a in tres)
    np.testing.assert_array_equal(tnl, jnl)
    np.testing.assert_array_equal(tleaf, jleaf)
    np.testing.assert_array_equal(tovf, jovf)
    # same decisions, same f32 terms; erfc differs in the last bits
    assert np.linalg.norm(tacc - jacc) <= 1e-5 * np.linalg.norm(jacc)
    assert np.linalg.norm(tpot - jpot) <= 1e-5 * max(np.linalg.norm(jpot),
                                                     1e-30)


def test_leaf_sources_and_evaluate_match_jax():
    jt, tt, jg, tg, pos_box, mass_s = _walk_inputs(13)
    n = pos_box.shape[0]
    valid = jnp.ones(n, bool)
    cap, sr = int(0.15 * n) + 256, int(0.16 * n) + 256
    jsrc = jtw.make_leaf_sources(jt, pos_box, mass_s, valid, cap, sr, 8)
    tsrc = ttw.make_leaf_sources(tt, _t(pos_box), _t(mass_s),
                                 torch.ones(n, dtype=bool), cap, sr, 8)
    for a, b in zip(jsrc, tsrc):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    kw = dict(rcut=0.0703125, bh_angle2=float(np.float32(0.175 ** 2)),
              use_bh=True, rs_inv=42.666668, h_inv=300.0,
              with_potential=True)
    jw = jtw.traverse_fused(jt, jg[0], jg[1], jg[2], jg[3], jg[4],
                            jtw.WalkConfig(), **kw)
    tw = ttw.traverse_fused(tt, tg[0], tg[1], tg[2], tg[3], tg[4],
                            ttw.WalkConfig(), **kw)
    ev = dict(rs_inv=42.666668, h_inv=300.0, rcut=0.0703125,
              with_potential=True)
    jacc, jpot, jovf = jtw.evaluate_leaves(
        jt, jsrc, jg[0], jw[2], jw[3], jw[0], jw[1],
        jtw.WalkConfig(src_cap=8192), **ev)
    tacc, tpot, tovf = ttw.evaluate_leaves(
        tt, tsrc, tg[0], tw[2], tw[3], tw[0], tw[1],
        ttw.WalkConfig(src_cap=8192), **ev)
    np.testing.assert_array_equal(tovf.numpy(), np.asarray(jovf))
    jacc, jpot = np.asarray(jacc), np.asarray(jpot)
    assert np.linalg.norm(tacc.numpy() - jacc) <= 1e-5 * np.linalg.norm(jacc)
    assert np.linalg.norm(tpot.numpy() - jpot) <= 1e-5 * np.linalg.norm(jpot)


@pytest.mark.parametrize("use_bh,clustered", [(0, True), (1, False)])
def test_tree_force_matches_jax(use_bh, clustered):
    n = 4096
    ipos, mass, amag = _positions(n, 21, clustered)
    valid = np.ones(n, bool)
    jg = jtp.TreeGravity(boxsize=BOX, nmesh=32, softening=BOX / 300,
                         tree_use_bh=use_bh, with_potential=True,
                         walk_cfg=jtw.WalkConfig(src_cap=8192))
    kw = jg.force_kwargs(n)
    jres = jtp.tree_force(jnp.asarray(ipos), jnp.asarray(mass),
                          jnp.asarray(valid), jnp.asarray(amag), **kw)
    tkw = dict(kw, walk_cfg=ttw.WalkConfig(src_cap=8192))
    tres = ttp.tree_force(_t(ipos), _t(mass), _t(valid), _t(amag), **tkw)
    assert bool(tres.overflow) == bool(jres.overflow)
    jacc, jpot = np.asarray(jres.accel), np.asarray(jres.potential)
    assert np.linalg.norm(tres.accel.numpy() - jacc) <= \
        1e-5 * np.linalg.norm(jacc)
    assert np.linalg.norm(tres.potential.numpy() - jpot) <= \
        1e-5 * np.linalg.norm(jpot)


@pytest.mark.parametrize("clustered", [False, True])
def test_tree_gravity_vs_direct_pairwise(clustered):
    """Force accuracy: tree vs direct pairwise (check_accns analog), the
    bounds of tests/test_tree_gravity.py; the port's direct sum is itself
    held against the JAX one."""
    n, box, nmesh = 4096, 1000.0, 32
    rng = np.random.RandomState(21)
    if clustered:
        nb = n // 2
        centers = rng.uniform(0.2, 0.8, (5, 3))
        blob = centers[rng.randint(5, size=nb)] + 0.02 * rng.randn(nb, 3)
        pos = np.concatenate([rng.uniform(0, 1, (n - nb, 3)),
                              np.mod(blob, 1.0)]) * box
    else:
        pos = rng.uniform(0, box, (n, 3))
    mass = rng.uniform(0.5, 1.5, n)
    pdata = ParticleData.from_numpy(pos, np.zeros((n, 3)), mass,
                                    np.ones(n, np.int32), np.arange(n) + 1,
                                    box, device="cpu")
    tg = ttp.TreeGravity(boxsize=box, nmesh=nmesh, asmth=1.5, rcut=4.5,
                         G=1.0, softening=box / 200.0, tree_use_bh=1,
                         walk_cfg=ttw.WalkConfig(leaf_list_max=1024,
                                                 src_cap=8192))
    acc_tree = tg.compute(pdata).numpy()
    assert not bool(tg.last_overflow)
    rs_inv = nmesh / (2 * 1.5) / box
    rcut = 4.5 * 1.5 * box / nmesh
    h_inv = 1.0 / (box / 200.0)
    acc_pair, pot_pair = direct_shortrange_pairwise(
        pdata.ipos, pdata.mass, pdata.valid, box, rs_inv, rcut, h_inv)
    acc_pair = acc_pair.numpy()
    jacc, jpot = jax_direct(jnp.asarray(pdata.ipos.numpy().astype(np.uint32)),
                            jnp.asarray(pdata.mass.numpy()),
                            jnp.ones(n, bool), box, jnp.float32(rs_inv),
                            jnp.float32(rcut), jnp.float32(h_inv))
    assert np.linalg.norm(acc_pair - np.asarray(jacc)) <= \
        1e-5 * np.linalg.norm(np.asarray(jacc))
    assert np.linalg.norm(pot_pair.numpy() - np.asarray(jpot)) <= \
        1e-5 * np.linalg.norm(np.asarray(jpot))
    fmag = np.linalg.norm(acc_pair, axis=1)
    rel = np.linalg.norm(acc_tree - acc_pair, axis=1) / \
        np.sqrt(np.mean(fmag ** 2))
    assert np.mean(rel) < 0.005, np.mean(rel)
    assert np.percentile(rel, 99) < 0.05, np.percentile(rel, 99)


def test_tree_gravity_bh_first_call_and_cutoff():
    """TreeUseBH=2 opens by BH on the first call only; particles beyond
    rcut exert no short-range force."""
    box = 1000.0
    pos = np.array([[100.0, 500, 500], [800.0, 500, 500]])
    pdata = ParticleData.from_numpy(pos, np.zeros((2, 3)), np.ones(2),
                                    np.ones(2, np.int32), np.array([1, 2]),
                                    box, device="cpu")
    tg = ttp.TreeGravity(boxsize=box, nmesh=32, asmth=1.5, rcut=4.5, G=1.0,
                         softening=1.0, tree_use_bh=2,
                         walk_cfg=ttw.WalkConfig(leaf_list_max=64,
                                                 src_cap=64))
    assert tg.force_kwargs(2)["use_bh"]
    acc = tg.compute(pdata).numpy()
    assert not tg.force_kwargs(2)["use_bh"]
    assert np.all(np.abs(acc) < 1e-12)
    acc2, pot = tg.compute(pdata, return_potential=True)
    assert np.all(np.abs(acc2.numpy()) < 1e-12)
    assert np.all(pot.numpy() == 0)
