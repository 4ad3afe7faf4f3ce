"""The port's CUDA path on a card (marked ``cuda``; each test skips when
no card is present).  Imports torch, the port, and the walks' inputs and
numpy mirrors of tests/test_torch_walkkernel.py and
tests/test_torch_neighborkernel.py only, no JAX, so that it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from mpgadget_tpu_torch.gravity import pairkernel as pk
from mpgadget_tpu_torch.gravity import treepm, treewalk
from mpgadget_tpu_torch.ops import pairs
from mpgadget_tpu_torch.physics import fof
from mpgadget_tpu_torch.pm import gravity as pm
from mpgadget_tpu_torch.sph import density, hydra
from mpgadget_tpu_torch.sph import kernels as sphK
from test_torch_neighborkernel import mirror_walks, neighbor_inputs
from test_torch_walkkernel import _stack_walk, walk_inputs

pytestmark = pytest.mark.cuda

RS_INV = 42.666668
H_INV = 300.0
RCUT = 0.0703125

# one intra-op thread: the suite runs in several worker processes that
# share the machine's cores
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _every(args):
    """A count of every slot for each block of _pair_inputs' args."""
    return torch.full((args[0].shape[0],), args[3].shape[1],
                      dtype=torch.int32, device=args[0].device)


def _pair_inputs(device, nb=8, G=256, S=1000, seed=5):
    rng = np.random.RandomState(seed)
    c = rng.rand(nb, 1, 3)
    tgt = np.mod(c + rng.uniform(-0.01, 0.01, (nb, G, 3)), 1.0)
    src = np.mod(c + rng.uniform(-0.1, 0.1, (nb, S, 3)), 1.0)
    sm = rng.uniform(0.5, 1.5, (nb, S))
    sm[:, -S // 10:] = 0.0

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)
    return ([put(tgt[:, :, k]) for k in range(3)]
            + [put(src[:, :, k]) for k in range(3)]
            + [put(sm), put(rng.randn(nb, 3, G)), put(rng.randn(nb, G))])


@pytest.mark.parametrize("with_potential", [False, True])
@pytest.mark.parametrize("G,S", [(256, 1000), (100, 4096), (1024, 512)])
def test_kernel_matches_plain(cuda, with_potential, G, S):
    args = _pair_inputs(cuda, G=G, S=S)
    before = pk.LAUNCHES
    acc, pot = pk.block_pair_accumulate(*args, RS_INV, H_INV, RCUT,
                                        _every(args),
                                        with_potential=with_potential)
    assert pk.LAUNCHES == before + 1
    ref_acc, ref_pot = pk.block_pair_accumulate_reference(
        *args, RS_INV, H_INV, RCUT, _every(args),
        with_potential=with_potential)
    # the fitted erfcx window and __expf vs torch's erfc/exp, and another
    # summation order
    assert float((acc - ref_acc).abs().max()) <= \
        1e-4 * float(ref_acc.abs().max())
    assert float((pot - ref_pot).abs().max()) <= \
        1e-4 * float(ref_pot.abs().max())


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = _pair_inputs(cuda)
    for k, bad in ((3, args[3].double()),
                   (3, args[3].t().contiguous().t()),
                   (3, args[3].cpu())):
        a = list(args)
        a[k] = bad
        with pytest.raises(ValueError):
            pk.block_pair_accumulate(*a, RS_INV, H_INV, RCUT, _every(args))
    big = _pair_inputs(cuda, nb=1, G=1056, S=64)
    with pytest.raises(ValueError):
        pk.block_pair_accumulate(*big, RS_INV, H_INV, RCUT, _every(big))
    nb = args[0].shape[0]
    for bad in (torch.zeros(nb, dtype=torch.int64, device=cuda),
                torch.zeros(nb, dtype=torch.int32),
                torch.zeros(nb + 1, dtype=torch.int32, device=cuda),
                torch.zeros((nb, 2), dtype=torch.int32, device=cuda)[:, 0]):
        with pytest.raises(ValueError):
            pk.block_pair_accumulate(*args, RS_INV, H_INV, RCUT, bad)


@pytest.mark.parametrize("with_potential", [False, True])
@pytest.mark.parametrize("S", [4096, 10000])
def test_kernel_with_counts_matches_plain(cuda, with_potential, S):
    """Per-block source counts: a block filled to S (several work items),
    an empty block, and random counts between."""
    nb = 8
    rng = np.random.RandomState(S)
    counts = np.concatenate([[S, 0], rng.randint(0, S // 8, nb - 2) * 8])
    args = _pair_inputs(cuda, nb=nb, G=256, S=S)
    sm = args[6].clone()
    sm[torch.arange(S, device=cuda)[None, :]
       >= torch.as_tensor(counts, device=cuda)[:, None]] = 0.0
    args[6] = sm
    cnt = torch.as_tensor(counts, dtype=torch.int32, device=cuda)
    before = pk.LAUNCHES
    acc, pot = pk.block_pair_accumulate(*args, RS_INV, H_INV, RCUT, cnt,
                                        with_potential=with_potential)
    assert pk.LAUNCHES == before + 1
    ref_acc, ref_pot = pk.block_pair_accumulate_reference(
        *args, RS_INV, H_INV, RCUT, cnt, with_potential=with_potential)
    assert float((acc - ref_acc).abs().max()) <= \
        1e-4 * float(ref_acc.abs().max())
    assert float((pot - ref_pot).abs().max()) <= \
        1e-4 * float(ref_pot.abs().max())
    # the empty block keeps acc0 and pot0 exactly
    assert torch.equal(acc[1], args[7][1]) and torch.equal(pot[1], args[8][1])
    # the same sum twice: no float atomics
    acc2, pot2 = pk.block_pair_accumulate(*args, RS_INV, H_INV, RCUT, cnt,
                                          with_potential=with_potential)
    assert torch.equal(acc, acc2) and torch.equal(pot, pot2)


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    return type(x)(**{k: _to_cpu(v) for k, v in x.__dict__.items()})


@pytest.mark.parametrize("kind,use_bh,LL,rcut", [
    ("blob", True, 512, RCUT), ("blob", False, 512, RCUT),
    ("blob", True, 16, RCUT), ("clusters", True, 1024, 0.25),
    ("clusters", False, 1024, 0.25)])
def test_walk_kernel_matches_plain(cuda, kind, use_bh, LL, rcut):
    """The walk kernel against the plain walk on 8192 clustered
    particles: the same leaf lists, flags and visit and monopole counts;
    acc and pot within 1e-5 by norm (another window formula). LL=16
    overflows; "clusters" applies thousands of monopoles."""
    args = walk_inputs(kind, cuda, n=8192, seed=21)
    theta = 0.5 if kind == "clusters" else 0.175
    kw = dict(rcut=rcut, bh_angle2=float(np.float32(
        theta ** 2 if use_bh else 0.9 ** 2)), use_bh=use_bh,
        rs_inv=3.0 / rcut, h_inv=H_INV, with_potential=True)
    cfg = treewalk.WalkConfig(leaf_list_max=LL)
    t_gpu, t_cpu = treepm.StageTimer(), treepm.StageTimer()
    before = treewalk.LAUNCHES
    res = treewalk.traverse_fused(*args, cfg, timer=t_gpu, **kw)
    assert treewalk.LAUNCHES == before + 1
    ref = treewalk.traverse_fused_reference(*[_to_cpu(a) for a in args],
                                            cfg, timer=t_cpu, **kw)
    acc, pot, leaf, nl, ovf = (a.cpu() for a in res)
    racc, rpot, rleaf, rnl, rovf = ref
    assert torch.equal(leaf, rleaf) and torch.equal(nl, rnl)
    assert torch.equal(ovf, rovf)
    if LL == 16:
        assert bool(ovf.any())
    assert t_gpu.counts == t_cpu.counts and t_gpu.series == t_cpu.series
    assert (t_gpu.series["walk_monopoles"][0] > 1000) == (kind == "clusters")
    assert np.linalg.norm((acc - racc).numpy()) <= \
        1e-5 * np.linalg.norm(racc.numpy())
    assert np.linalg.norm((pot - rpot).numpy()) <= \
        1e-5 * np.linalg.norm(rpot.numpy())


@pytest.mark.parametrize("kind,use_bh,LL,rcut,stack_cap,node_cap", [
    ("clusters", True, 1024, 0.25, 3072, None),
    ("blob", False, 512, RCUT, 3072, None),
    # a stack too small for the rounds: they are taken again with fewer
    # entries, and serial walks take over
    ("clusters", True, 1024, 0.25, 100, None),
    ("clusters", False, 64, 0.25, 1, None),
    # a tree that overflowed its capacity, walked past its rows
    ("blob", True, 512, 1.0, 3072, 299),
    ("blob", True, 512, 1.0, 40, 299)])
def test_walk_kernel_rounds_and_serial_mode(cuda, kind, use_bh, LL, rcut,
                                            stack_cap, node_cap):
    """The kernel's stack at its full and at a tiny capacity (where the
    serial mode takes over), also on a tree that overflowed its rows: the
    plain walk's results, the numpy mirror's rounds, dependent loads and
    serial visits block by block, and the same bits from a second
    launch."""
    args = walk_inputs(kind, cuda, node_cap=node_cap)
    tree, tpos, center, half, aold, active = args
    active = active.clone()
    active[3] = False
    args = (tree, tpos, center, half, aold, active)
    theta = 0.5 if kind == "clusters" else 0.175
    bh_angle2 = float(np.float32(theta ** 2 if use_bh else 0.9 ** 2))
    kw = dict(rcut=rcut, bh_angle2=bh_angle2, use_bh=use_bh,
              rs_inv=3.0 / rcut, h_inv=H_INV, with_potential=True)
    cfg = treewalk.WalkConfig(leaf_list_max=LL)
    before = treewalk.LAUNCHES
    res, stats = treewalk.walk_kernel(*args, cfg, stack_cap=stack_cap, **kw)
    res2, stats2 = treewalk.walk_kernel(*args, cfg, stack_cap=stack_cap,
                                        **kw)
    assert treewalk.LAUNCHES == before + 2
    for a, b in zip(res, res2):
        assert torch.equal(a, b)
    for name in stats:
        assert torch.equal(stats[name], stats2[name])
    t_cpu = treepm.StageTimer()
    ref = treewalk.traverse_fused_reference(*[_to_cpu(a) for a in args],
                                            cfg, timer=t_cpu, **kw)
    acc, pot, leaf, nl, ovf = (a.cpu() for a in res)
    racc, rpot, rleaf, rnl, rovf = ref
    assert torch.equal(leaf, rleaf) and torch.equal(nl, rnl)
    assert torch.equal(ovf, rovf)
    st = {k: v.cpu().numpy() for k, v in stats.items()}
    assert t_cpu.counts["walk_iterations"] == st["visits"].max()
    assert t_cpu.series["walk_visits_sum"] == [st["visits"].sum()]
    assert t_cpu.series["walk_monopoles"] == [st["monopoles"].sum()]
    assert np.linalg.norm((acc - racc).numpy()) <= \
        1e-5 * np.linalg.norm(racc.numpy())
    assert np.linalg.norm((pot - rpot).numpy()) <= \
        1e-5 * np.linalg.norm(rpot.numpy())
    assert (st["serial"].sum() > 0) == (stack_cap < 3072)
    assert st["rounds"][3] == 0 and st["visits"][3] == 0
    nodes, meta = (a.cpu().numpy() for a in treewalk.pack_nodes(tree))
    c, h, ao, act = (a.cpu().numpy() for a in (center, half, aold, active))
    for b in range(tpos.shape[0]):
        _, _, v, monos, rounds, loads, serial = _stack_walk(
            nodes, meta, int(tree.n_nodes), tree.capacity, c[b], h[b], ao[b],
            act[b], LL, rcut, bh_angle2, use_bh, stack_cap=stack_cap)
        assert (v, len(monos), rounds, loads, serial) == (
            st["visits"][b], st["monopoles"][b], st["rounds"][b],
            st["loads"][b], st["serial"][b])


def test_walk_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    tree, tpos, center, half, aold, active = walk_inputs("blob", cuda,
                                                         n=1024)
    kw = dict(rcut=RCUT, bh_angle2=0.03, use_bh=True, rs_inv=RS_INV,
              h_inv=H_INV)
    cfg = treewalk.WalkConfig()
    for k, bad in ((1, tpos.double()),
                   (1, tpos.transpose(1, 2).contiguous().transpose(1, 2)),
                   (2, center.cpu()), (4, aold[:-1]), (4, aold.double()),
                   (5, active.to(torch.uint8))):
        a = [tree, tpos, center, half, aold, active]
        a[k] = bad
        with pytest.raises(ValueError):
            treewalk.traverse_fused(*a, cfg, **kw)
    for cap in (0, treewalk.STACK_CAP + 1):
        with pytest.raises(ValueError):
            treewalk.walk_kernel(tree, tpos, center, half, aold, active, cfg,
                                 stack_cap=cap, **kw)


def _particles(n, seed, box):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, box, (n, 3))
    pos[: n // 4] = np.mod(box / 2 + rng.randn(n // 4, 3) * box * 0.01, box)
    ipos = torch.as_tensor((pos / box * 2.0 ** 32).astype(np.int64))
    mass = torch.as_tensor(rng.uniform(5, 15, n).astype(np.float32))
    amag = torch.as_tensor(rng.uniform(0, 2e-3, n).astype(np.float32))
    return ipos, mass, torch.ones(n, dtype=torch.bool), amag


@pytest.mark.parametrize("use_bh", [0, 1])
def test_tree_force_cuda_matches_cpu(cuda, use_bh):
    """The whole tree force on the card (walk and pair kernels) against
    the same function on the CPU (their plain versions)."""
    box, n = 10000.0, 8192
    tg = treepm.TreeGravity(boxsize=box, nmesh=32, softening=box / 300,
                            tree_use_bh=use_bh, with_potential=True,
                            walk_cfg=treewalk.WalkConfig(src_cap=8192))
    kw = tg.force_kwargs(n)
    cpu_args = _particles(n, 21, box)
    before, walks = pk.LAUNCHES, treewalk.LAUNCHES
    r_gpu = treepm.tree_force(*[a.to(cuda) for a in cpu_args], **kw)
    assert pk.LAUNCHES == before + 1 and treewalk.LAUNCHES == walks + 1
    r_cpu = treepm.tree_force(*cpu_args, **kw)
    assert bool(r_gpu.overflow) == bool(r_cpu.overflow)
    a_cpu = r_cpu.accel.numpy()
    p_cpu = r_cpu.potential.numpy()
    assert np.linalg.norm(r_gpu.accel.cpu().numpy() - a_cpu) <= \
        1e-5 * np.linalg.norm(a_cpu)
    assert np.linalg.norm(r_gpu.potential.cpu().numpy() - p_cpu) <= \
        1e-5 * np.linalg.norm(p_cpu)


def test_pm_force_cuda_matches_cpu(cuda):
    box = 64000.0
    ipos, mass, _, _ = _particles(16384, 8, box)
    cfg = pm.PMConfig(nmesh=32, boxsize=box)
    a_gpu, p_gpu, ps_gpu = pm.pm_force(ipos.to(cuda), mass.to(cuda), cfg)
    a_cpu, p_cpu, ps_cpu = pm.pm_force(ipos, mass, cfg)
    # cuFFT vs pocketfft, atomics vs ordered scatter-adds: 1e-5 by norm
    assert np.linalg.norm(a_gpu.cpu().numpy() - a_cpu.numpy()) <= \
        1e-5 * np.linalg.norm(a_cpu.numpy())
    assert np.linalg.norm(p_gpu.cpu().numpy() - p_cpu.numpy()) <= \
        1e-5 * np.linalg.norm(p_cpu.numpy())
    np.testing.assert_allclose(ps_gpu.power, ps_cpu.power, rtol=1e-4)


def test_active_target_tree_force_is_bitwise_the_full_one(cuda):
    """tree_force with target_active walks exactly the active blocks (a
    compacted nb on both kernels); on active rows acceleration and
    potential have the bits of the force with every block walked."""
    box, n = 10000.0, 8192
    tg = treepm.TreeGravity(boxsize=box, nmesh=32, softening=box / 300,
                            tree_use_bh=0, with_potential=True,
                            walk_cfg=treewalk.WalkConfig(leaf_list_max=2048,
                                                         src_cap=16384))
    kw = tg.force_kwargs(n)
    args = [a.to(cuda) for a in _particles(n, 21, box)]
    rng = np.random.RandomState(8)
    act = np.zeros(n, bool)
    act[rng.choice(n // 4, 300, replace=False)] = True   # in the clump
    act = torch.as_tensor(act, device=cuda)
    before, walks = pk.LAUNCHES, treewalk.LAUNCHES
    r_act = treepm.tree_force(*args, target_active=act, **kw)
    assert pk.LAUNCHES == before + 1 and treewalk.LAUNCHES == walks + 1
    r_all = treepm.tree_force(*args, **kw)
    nb = n // kw["group_size"]
    assert 0 < r_act.n_active_blocks <= nb // 2
    assert r_all.n_active_blocks == nb
    assert not bool(r_act.overflow) and not bool(r_all.overflow)
    assert torch.equal(r_act.accel[act], r_all.accel[act])
    assert torch.equal(r_act.potential[act], r_all.potential[act])


def test_genic_displacement_cuda_matches_cpu(cuda):
    """The Zel'dovich displacement and density fields on the card
    (cuFFT) against the same function on the CPU, from the same modes."""
    from mpgadget_tpu_torch.genic import zeldovich as zel
    nmesh, box = 64, 64000.0
    noise = torch.as_tensor(np.random.RandomState(5).randn(
        nmesh, nmesh, nmesh).astype(np.float32))
    modes = torch.fft.rfftn(noise) * (1.0 / nmesh ** 1.5)
    logk = np.linspace(np.log(1e-5), np.log(0.02), 256)
    logd = 0.5 * np.log(2e9 * np.exp(logk)
                        / (1 + (np.exp(logk) / 1e-4) ** 2) ** 1.5)
    table = (torch.as_tensor(logk, dtype=torch.float32),
             torch.as_tensor(logd, dtype=torch.float32))
    ipos = torch.as_tensor((np.random.RandomState(6).uniform(
        0, 1, (32768, 3)) * 2.0 ** 32).astype(np.int64))
    d_cpu, _ = zel.displacement_fields(modes, table, table, nmesh, box, ipos)
    g_table = tuple(t.to(cuda) for t in table)
    d_gpu, _ = zel.displacement_fields(modes.to(cuda), g_table, g_table,
                                       nmesh, box, ipos.to(cuda))
    assert d_gpu.is_cuda
    assert np.linalg.norm(d_gpu.cpu().numpy() - d_cpu.numpy()) <= \
        1e-5 * np.linalg.norm(d_cpu.numpy())
    rho_cpu = zel.density_field(modes, table, nmesh, box, ipos)
    rho_gpu = zel.density_field(modes.to(cuda), g_table, nmesh, box,
                                ipos.to(cuda))
    assert np.linalg.norm(rho_gpu.cpu().numpy() - rho_cpu.numpy()) <= \
        1e-5 * np.linalg.norm(rho_cpu.numpy())
    # the generator on the card is seeded as well
    assert torch.equal(zel.gaussian_modes(7, 16, device=cuda),
                       zel.gaussian_modes(7, 16, device=cuda))


@pytest.mark.parametrize("kind", ["uniform", "clusters"])
@pytest.mark.parametrize("symmetric,LL,stack_cap", [
    (False, 64, pairs.STACK_CAP), (False, 8, pairs.STACK_CAP),
    (True, 256, pairs.STACK_CAP),
    # a stack too small for the rounds: they are taken again with fewer
    # entries, and serial walks take over
    (True, 256, 10), (False, 64, 1)])
def test_neighbor_kernel_matches_plain(cuda, kind, symmetric, LL, stack_cap):
    """K3 against find_neighbors_reference on the card: the same leaf
    lists, counts, overflow flags and visits (LL = 8 overflows); per
    group the numpy mirror's rounds, dependent loads and serial visits;
    and the same bits from a second launch."""
    tree, (nodes, gc, gh, _, _, _), hmax = neighbor_inputs(kind, cuda)
    radius = torch.full((nodes.shape[0],), 0.2 / 20.0, device=cuda)
    before = pairs.LAUNCHES
    if stack_cap == pairs.STACK_CAP:
        got = pairs.find_neighbors(tree, nodes, gc, gh, radius, hmax, LL,
                                   symmetric=symmetric)
        assert pairs.LAUNCHES == before + 1
    else:
        got = pairs.neighbor_kernel(tree, nodes, gc, gh, radius, hmax, LL,
                                    symmetric=symmetric,
                                    stack_cap=stack_cap)[0]
    again, stats = pairs.neighbor_kernel(tree, nodes, gc, gh, radius, hmax,
                                         LL, symmetric=symmetric,
                                         stack_cap=stack_cap)
    assert pairs.LAUNCHES == before + 2
    ref = pairs.find_neighbors_reference(tree, nodes, gc, gh, radius, hmax,
                                         LL, symmetric=symmetric)
    for name in ("leaf_idx", "n_leaves", "overflow", "visits"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
        assert torch.equal(getattr(again, name), getattr(got, name)), name
    assert int(got.n_leaves.sum()) > 0
    if LL == 8:
        assert bool(got.overflow.any())
    st = {k: v.cpu().numpy() for k, v in stats.items()}
    assert (st["serial"].sum() > 0) == (stack_cap < pairs.STACK_CAP)
    mirror = mirror_walks(tree, (nodes, gc, gh), radius, hmax, LL,
                          symmetric, stack_cap)
    for g, (_, _, v, rounds, loads, serial) in enumerate(mirror):
        assert (v, rounds, loads, serial) == (
            int(ref.visits[g]), st["rounds"][g], st["loads"][g],
            st["serial"][g]), g


def test_neighbor_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    tree, (nodes, gc, gh, _, _, _), hmax = neighbor_inputs("uniform", cuda,
                                                           n=2048)
    radius = torch.full((nodes.shape[0],), 0.01, device=cuda)
    for k, bad in ((0, nodes.to(torch.int32)), (1, gc.double()),
                   (1, gc.t().contiguous().t()), (2, gh.cpu()),
                   (3, radius[:-1]), (4, hmax[:-1])):
        a = [nodes, gc, gh, radius, hmax]
        a[k] = bad
        with pytest.raises(ValueError):
            pairs.find_neighbors(tree, *a, 64, symmetric=True)
    for LL in (0, 2 ** 31 // nodes.shape[0]):
        with pytest.raises(ValueError):
            pairs.find_neighbors(tree, nodes, gc, gh, radius, hmax, LL)
    for cap in (0, pairs.STACK_CAP + 1):
        with pytest.raises(ValueError):
            pairs.neighbor_kernel(tree, nodes, gc, gh, radius, hmax, 64,
                                  stack_cap=cap)


def test_fof_label_cuda_matches_cpu(cuda):
    """fof_label on the card (K3 and the min-label sweeps) equals the
    same call on the CPU, label for label."""
    rng = np.random.RandomState(9)
    n = 8192
    c = rng.uniform(0, 1, (16, 3))
    pos = np.concatenate([rng.uniform(0, 1, (n // 2, 3)), np.mod(
        c[rng.randint(16, size=n // 2)] + 0.01 * rng.randn(n // 2, 3), 1)])
    ipos = np.minimum((pos * 2.0 ** 32).astype(np.int64), 2 ** 32 - 1)
    valid = rng.rand(n) > 0.05
    ll = 0.2 / n ** (1 / 3)
    before = pairs.LAUNCHES
    got, _, _ = fof.fof_label(torch.as_tensor(ipos, device=cuda),
                              torch.as_tensor(valid, device=cuda), 1.0, ll)
    assert pairs.LAUNCHES > before
    want, _, _ = fof.fof_label(torch.as_tensor(ipos), torch.as_tensor(valid),
                               1.0, ll)
    assert torch.equal(got.cpu(), want)
    assert len(torch.unique(want[want >= 0])) < int(valid.sum())


def _sph_pair_inputs(device, which, ktype=sphK.QUINTIC, formulation=(True, 100.0),
                     ng=16, seed=7, G=32, layout="lattice", holes=0.0,
                     exact_ll=False):
    """K4 or K5 inputs on `device`.  layout "lattice": a perturbed ng^3
    gas lattice with a dense clump and 200 non-gas particles among it,
    smoothing lengths spread by a factor 2.5 around 2 / ng; "leaves16":
    16 gas particles in each of the (ng/2)^3 cells of side 2 / ng, so
    that every leaf holds 16, smoothing lengths of 1-2.5 cells.  Neighbour lists of the plain walk;
    a fifth of the groups list nothing (density: radius 0; hydro: their
    lists dropped).  G: the targets per group the sums take (1..32, the
    groups hold up to 32); holes: the share of the gas made invalid in
    the valid table only, so that invalid sources lie inside leaves and
    tiles; exact_ll: lists cut to the longest, which then fills LL.
    Returns the pair-sum arguments (tree, nbr, src, tgt, valid, ...)."""
    rng = np.random.RandomState(seed)
    if layout == "lattice":
        g = np.indices((ng, ng, ng)).reshape(3, -1).T / ng
        pos = np.mod(g + rng.uniform(-0.3, 0.3, g.shape) / ng, 1.0)
        pos[:ng ** 3 // 8] = np.mod(0.5 + 0.03 * rng.randn(ng ** 3 // 8, 3),
                                    1)
        ngas = ng ** 3
        pos = np.concatenate([pos, rng.rand(200, 3)])
        hscale = 2.0 / ng
    else:
        # 16 particles uniform in each cell of side 1 / ns
        ns = ng // 2
        cells = np.repeat(np.indices((ns, ns, ns)).reshape(3, -1).T, 16, 0)
        pos = (cells + rng.rand(*cells.shape)) / ns
        ngas = len(pos)
        hscale = 1.0 / ns
    n = len(pos)
    box = 1000.0
    gas = torch.as_tensor(np.arange(n) < ngas)
    ipos = torch.as_tensor(np.minimum((pos * 2.0 ** 32).astype(np.int64),
                                      2 ** 32 - 1))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    mass = f(np.where(np.arange(n) < ngas, 1.5, 7.0))
    perm, inv, pos_box, valid_s, tree, (nodes, gc, gh) = density.sorted_tree(
        ipos, mass, gas, 32)
    if layout == "leaves16":
        leaves = tree.is_leaf[:int(tree.n_nodes)]
        assert bool((tree.pcount[:int(tree.n_nodes)][leaves] == 16).all())
    hsml = f(rng.uniform(1.0, 2.5, n) * hscale)[perm]          # box units
    vel = f(rng.randn(n, 3))[perm]
    tidx, tm = density.group_targets(tree, nodes, n, 32)
    gradius = torch.where(tm, hsml[tidx], 0.0).max(dim=1).values
    if which == "density":
        gradius[torch.as_tensor(rng.rand(len(gradius)) < 0.2)] = 0.0
        nbr = pairs.find_neighbors(tree, nodes, gc, gh, gradius, None, 4096,
                                   symmetric=False)
        src, tgt, valid = density.pack_density_inputs(
            pos_box, valid_s, mass[perm], vel, f(rng.uniform(0.5, 1.5, n)),
            hsml, vel + 0.1)
        rest = (ktype, G)
    else:
        leaf_ids, nl, _ = pairs.compact_leaves(tree, tree.capacity)
        hmax = pairs.node_hmax(tree, leaf_ids, nl,
                               torch.where(valid_s, hsml, 0.0))
        nbr = pairs.find_neighbors(tree, nodes, gc, gh, gradius, hmax, 4096,
                                   symmetric=True)
        cols = {k: f(rng.uniform(0.5, 2.0, n))
                for k in ("density", "eomdensity", "pressure", "curlvel",
                          "entvarpred", "dhsml", "soundspeed", "f1",
                          "p_over_rho2", "egyrho")}
        cols.update(mass=mass[perm], hsml=hsml * box,
                    divvel=f(rng.uniform(-1, 1, n)))
        src, tgt, valid = hydra.pack_hydro_inputs(pos_box, valid_s, vel, cols)
        par = hydra.HydroParams(kernel_type=ktype,
                                density_independent=formulation[0],
                                density_contrast_limit=formulation[1],
                                group_max=G)
        rest = (par, hydra.hydro_scalars(par, box, 0.2, 3.0, 0.01))
        drop = torch.as_tensor(rng.rand(len(gradius)) < 0.2)
        nbr = replace(nbr, n_leaves=nbr.n_leaves.masked_fill(drop, 0))
    assert not bool(nbr.overflow.any())
    if holes:
        valid = valid & torch.as_tensor(rng.rand(n) >= holes).to(valid.dtype)
    leaf_idx = nbr.leaf_idx
    if exact_ll:
        leaf_idx = leaf_idx[:, :int(nbr.n_leaves.max())]
    to = lambda t: t.to(device).contiguous()  # noqa: E731
    tree = ttree_to(tree, device)
    nbr = pairs.NeighborLists(
        leaf_idx=to(leaf_idx), n_leaves=to(nbr.n_leaves),
        overflow=to(nbr.overflow), group_nodes=to(nbr.group_nodes),
        visits=to(nbr.visits))
    return (tree, nbr, to(src), to(tgt), to(valid)) + rest


def ttree_to(tree, device):
    from dataclasses import fields
    return replace(tree, **{f.name: getattr(tree, f.name).to(device)
                            for f in fields(tree)})


def _sph_case(which, args):
    kern = density.density_kernel if which == "density" \
        else hydra.hydro_kernel
    plain = density.density_sums_reference if which == "density" \
        else hydra.hydro_sums_reference
    names = density.OUTPUTS if which == "density" else hydra.OUTPUTS
    mod = density if which == "density" else hydra
    before = mod.LAUNCHES
    a = kern(*args)
    b = kern(*args)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + 2
    assert torch.equal(a, b)                  # no atomics: the same bits
    ref = plain(*args)
    _sph_close(names, a, ref)
    return a


def _sph_close(names, a, ref):
    """Every output within 1e-5 by norm; maxsig -inf at the same rows and
    equal bit for bit (and within 1e-6 by norm)."""
    for i, k in enumerate(names):
        x, y = a[:, i].double(), ref[:, i].double()
        if k == "maxsig":
            fin = torch.isfinite(y)
            assert torch.equal(torch.isfinite(x), fin)
            assert torch.equal(a[:, i], ref[:, i])
            x, y = x[fin], y[fin]
            tol = 1e-6
        else:
            tol = 1e-5
        err = float((x - y).norm() / y.norm().clamp(min=1e-300))
        assert err <= tol, (k, err)


def _listed_targets(args, G):
    """Target rows of the groups that list something: min(G, pcount)."""
    tree, nbr = args[0], args[1]
    tpc = torch.clamp(tree.pcount[nbr.group_nodes], max=G)
    return int(tpc[nbr.n_leaves > 0].sum())


# targets per group: powers of two and not; full 16-particle leaves; every
# case with invalid sources inside tiles and the longest list at exactly LL
SPH_SHAPES = [(32, "lattice"), (1, "lattice"), (2, "lattice"),
              (3, "lattice"), (5, "lattice"), (8, "lattice"),
              (17, "lattice"), (32, "leaves16"), (5, "leaves16")]


@pytest.mark.parametrize("G,layout", SPH_SHAPES)
@pytest.mark.parametrize("ktype", [sphK.CUBIC, sphK.QUINTIC, sphK.QUARTIC])
def test_density_kernel_matches_plain(cuda, ktype, G, layout):
    """K4 against its plain version on the same lists: every output within
    1e-5 by norm, two launches bit-identical, and the rows of groups with
    no list zero; the lattice's lists span several segments of the
    stream, and their source counts are not multiples of a tile."""
    args = _sph_pair_inputs(cuda, "density", ktype, G=G, layout=layout,
                            holes=0.1, exact_ll=True)
    import chip_smoke
    tree, nbr = args[0], args[1]
    _, seg, tile = chip_smoke.sph_stream_shape()
    if layout == "lattice":
        assert int(nbr.n_leaves.max()) > seg
    assert int(nbr.n_leaves.max()) == nbr.leaf_idx.shape[1]
    listed = torch.arange(nbr.leaf_idx.shape[1], device=cuda)[None, :] \
        < nbr.n_leaves[:, None]
    leaf = torch.clamp(nbr.leaf_idx.long(), max=tree.capacity - 1)
    sources = torch.where(listed, tree.pcount[leaf], 0)
    assert bool((sources.sum(dim=1) % tile != 0).any())
    out = _sph_case("density", args)
    empty = nbr.group_nodes[nbr.n_leaves == 0]
    assert empty.numel() > 0
    rows = torch.cat([torch.arange(int(tree.pstart[g]),
                                   int(tree.pstart[g] + tree.pcount[g]),
                                   device=cuda) for g in empty.tolist()])
    assert bool((out[rows] == 0).all())
    assert int((out[:, 0] > 0).sum()) > 0.9 * _listed_targets(args, G)


@pytest.mark.parametrize("G,layout", SPH_SHAPES)
@pytest.mark.parametrize("ktype,formulation", [
    (sphK.QUINTIC, (True, 100.0)), (sphK.QUINTIC, (True, 0.0)),
    (sphK.QUINTIC, (True, -1.0)), (sphK.QUINTIC, (False, 100.0)),
    (sphK.CUBIC, (True, 100.0)), (sphK.QUARTIC, (False, 100.0))])
def test_hydro_kernel_matches_plain(cuda, ktype, formulation, G, layout):
    """K5 against its plain version on the same symmetric lists, in every
    formulation branch: acc and dtent within 1e-5 by norm, maxsig bit for
    bit and -inf at the same rows, two launches bit-identical."""
    args = _sph_pair_inputs(cuda, "hydro", ktype, formulation, G=G,
                            layout=layout, holes=0.1, exact_ll=True)
    out = _sph_case("hydro", args)
    assert int(torch.isfinite(out[:, 4]).sum()) \
        > 0.9 * _listed_targets(args, G)
    assert bool((args[1].n_leaves == 0).any())


@pytest.mark.parametrize("which", ["density", "hydro"])
def test_sph_kernels_match_first_designs(cuda, which):
    """K4 and K5 against their first designs (csrc/sph_density_simple.cu,
    csrc/sph_hydro_simple.cu, the yardsticks chip_smoke.py times beside
    them) on the same inputs: every output within 1e-5 by norm, maxsig
    bit for bit; the yardsticks do not count as launches."""
    import chip_smoke
    mod = density if which == "density" else hydra
    args = _sph_pair_inputs(cuda, which, G=17, holes=0.1)
    new = (mod.density_kernel if which == "density"
           else mod.hydro_kernel)(*args)
    before = mod.LAUNCHES
    first = chip_smoke.simple_sums(which, args)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before
    _sph_close(mod.OUTPUTS, new, first)


def test_sph_wrappers_raise_instead_of_falling_back(cuda, monkeypatch):
    """On CUDA tensors the SPH pair sums launch K4 / K5 or raise: wrong
    inputs are refused, and with the kernel library unavailable the call
    raises rather than running the plain version."""
    dargs = _sph_pair_inputs(cuda, "density")
    hargs = _sph_pair_inputs(cuda, "hydro")
    tree, nbr, src, tgt, valid = dargs[:5]
    for i, bad in ((2, src.double()), (2, src.cpu()), (3, tgt[:, :3]),
                   (4, valid.bool()), (2, src.t().contiguous().t())):
        a = list(dargs)
        a[i] = bad
        with pytest.raises(ValueError):
            density.density_kernel(*a)
    with pytest.raises(ValueError):
        density.density_kernel(*dargs[:5], dargs[5], 33)
    with pytest.raises(ValueError):
        density.density_kernel(*dargs[:5], 3, 32)
    a = list(hargs)
    a[3] = hargs[3][:, :4].contiguous()
    with pytest.raises(ValueError):
        hydra.hydro_kernel(*a)

    def refuse(*a, **k):
        raise AssertionError("plain version called on CUDA tensors")

    monkeypatch.setattr(density, "density_sums_reference", refuse)
    monkeypatch.setattr(hydra, "hydro_sums_reference", refuse)
    before = (density.LAUNCHES, hydra.LAUNCHES)
    density.density_sums(*dargs)
    hydra.hydro_sums(*hargs)
    assert (density.LAUNCHES, hydra.LAUNCHES) == (before[0] + 1,
                                                  before[1] + 1)

    def no_library(name):
        raise RuntimeError(f"no {name}")

    monkeypatch.setattr(density, "_fn", None)
    monkeypatch.setattr(hydra, "_fn", None)
    monkeypatch.setattr(density.kernels, "load", no_library)
    with pytest.raises(RuntimeError, match="no sph_density"):
        density.density_sums(*dargs)
    with pytest.raises(RuntimeError, match="no sph_hydro"):
        hydra.hydro_sums(*hargs)


def test_sph_density_and_hydro_cuda_match_cpu(cuda):
    """sph_density and hydro_force on the card (K3, K4, K5) against the
    same calls on the CPU (the plain versions)."""
    rng = np.random.RandomState(4)
    ng = 12
    g = np.indices((ng, ng, ng)).reshape(3, -1).T / ng
    pos = np.mod(g + rng.uniform(-0.3, 0.3, g.shape) / ng, 1.0)
    n = len(pos)
    ipos = np.minimum((pos * 2.0 ** 32).astype(np.int64), 2 ** 32 - 1)
    inputs = dict(ipos=ipos, mass=np.full(n, 1.5, np.float32),
                  gas=np.ones(n, bool),
                  hsml=np.full(n, 2000.0 / ng, np.float32),
                  vel=rng.randn(n, 3).astype(np.float32),
                  ent=rng.uniform(0.5, 1.5, n).astype(np.float32))
    res = {}
    for dev in (cuda, torch.device("cpu")):
        t = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
        d = density.sph_density(t["ipos"], t["mass"], t["gas"], t["hsml"],
                                t["vel"], t["vel"], t["ent"],
                                density.DensityParams(), 1000.0)
        h = hydra.hydro_force(t["ipos"], t["mass"], t["gas"], d["hsml"],
                              t["vel"], t["ent"], d["density"],
                              d["egy_wt_density"], d["div_vel"],
                              d["curl_vel"], d["dhsml_egy_factor"],
                              hydra.HydroParams(), 1000.0, 0.2, 3.0, 0.01)
        res[dev.type] = {**{k: v for k, v in d.items()
                            if isinstance(v, torch.Tensor)}, **h}
    for k, want in res["cpu"].items():
        got = res["cuda"][k].cpu().double()
        err = float((got - want.double()).norm()
                    / want.double().norm().clamp(min=1e-300))
        assert err <= 1e-5, (k, err)


# ---- K6: the cooling network ------------------------------------------------

def _cooling_case(device, dtype, n=512, seed=21):
    """do_cooling's and the rate's inputs over n_H 1e-6 ... 1e2 cm^-3, T
    1e2 ... 1e7 K (internal units: kpc, 1e10 Msun, km/s, h = 0.7)."""
    from mpgadget_tpu_torch.physics import cooling as cool
    from mpgadget_tpu_torch.utils import constants as C
    from mpgadget_tpu_torch.utils import get_unitsystem
    units = get_unitsystem(C.CM_PER_KPC, 1.989e43, 1e5)
    cu = cool.CoolingUnits(units.UnitDensity_in_cgs * 0.49,
                           units.UnitInternalEnergy_in_cgs,
                           units.UnitTime_in_s / 0.7)
    rng = np.random.default_rng(seed)
    nh = 10 ** rng.uniform(-6, 2, n)
    temp = 10 ** rng.uniform(2, 7, n)
    ucgs = temp * C.BOLTZMANN / (C.GAMMA_MINUS1 * 0.6 * C.PROTONMASS)
    rho = nh * C.PROTONMASS / C.HYDROGEN_MASSFRAC / cu.density_in_phys_cgs
    put = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    return dict(cu=cu, u=put(ucgs / cu.uu_in_cgs), rho=put(rho),
                dt=put(10 ** rng.uniform(-6, -2, n)),
                ne=put(rng.uniform(0, 1.2, n)),
                dens=put(nh / C.HYDROGEN_MASSFRAC), ucgs=put(ucgs),
                min_egy=100 * C.BOLTZMANN / C.PROTONMASS / C.GAMMA_MINUS1
                / cu.uu_in_cgs / (4 / (1 + 3 * C.HYDROGEN_MASSFRAC)))


def _uvbg(on):
    from mpgadget_tpu_torch.physics import cooling as cool
    return cool.UVBG(gJH0=1e-12, gJHe0=8e-13, gJHep=3e-14, epsH0=5e-24,
                     epsHe0=6e-24, epsHep=2e-25, self_shield_dens=5e-3) \
        if on else cool.UVBG()


def _cooling_rates():
    from mpgadget_tpu_torch.physics import cooling as cool
    p = cool.CoolingParams(MinGasTemp=100.0)
    return cool.CoolingRates(p, cool.TreeCool(None, p))


@pytest.mark.parametrize("dtype,uv", [(torch.float32, False),
                                      (torch.float32, True),
                                      (torch.float64, True)])
@pytest.mark.parametrize("rows", [False, True])
def test_cooling_kernel_matches_plain(cuda, dtype, uv, rows):
    """K6's do_cooling against its plain version on the card, float32 and
    float64, all rows or a listed third: u_new within 2e-5 relative and
    ne/nh within 2e-6 + 2e-3 relative (the CPU parity tolerances of
    tests/test_torch_cooling.py), 1e-9 in float64; unlisted rows
    untouched; two launches bit-identical."""
    from mpgadget_tpu_torch.physics import cooling as cool
    cr, uvbg = _cooling_rates(), _uvbg(uv)
    c = _cooling_case(cuda, dtype)
    idx = torch.arange(0, 512, 3, device=cuda) if rows else None
    args = (cr, 1.5, c["u"], c["rho"], c["dt"], uvbg, c["ne"], c["min_egy"],
            c["cu"])
    before = cool.LAUNCHES
    u1, n1 = cool.do_cooling(*args, rows=idx)
    u2, n2 = cool.do_cooling(*args, rows=idx)
    assert cool.LAUNCHES == before + 2
    assert torch.equal(u1, u2) and torch.equal(n1, n2)
    ur, nr = cool.do_cooling_reference(cr, 1.5, c["u"], c["rho"], c["dt"],
                                       uvbg, c["ne"], c["min_egy"], c["cu"])
    sel = idx if rows else slice(None)
    tol = (2e-5, 2e-3, 2e-6) if dtype == torch.float32 else (1e-9, 1e-9, 0)
    torch.testing.assert_close(u1[sel], ur[sel], rtol=tol[0], atol=0)
    torch.testing.assert_close(n1[sel], nr[sel], rtol=tol[1], atol=tol[2])
    if rows:
        rest = torch.ones(512, dtype=torch.bool, device=cuda)
        rest[idx] = False
        assert torch.equal(u1[rest], c["u"][rest])
        assert torch.equal(n1[rest], c["ne"][rest])


@pytest.mark.parametrize("dtype,uv", [(torch.float32, False),
                                      (torch.float64, True)])
@pytest.mark.parametrize("rows", [False, True])
def test_heatingcooling_kernel_matches_plain(cuda, dtype, uv, rows):
    """K6's heatingcooling_rate (the equilibrium ne and the net rate)
    against the plain version on the card: ne/nh within 1e-6 and the rate
    within 4e-6 plus 1e-7 of the largest |rate| in float32, 1e-9 in
    float64; unlisted rows 0 and ne_init; two launches bit-identical."""
    from mpgadget_tpu_torch.physics import cooling as cool
    cr, uvbg = _cooling_rates(), _uvbg(uv)
    c = _cooling_case(cuda, dtype, seed=23)
    idx = torch.arange(1, 512, 4, device=cuda) if rows else None
    args = (cr, c["dens"], c["ucgs"], 3.0, uvbg, c["ne"])
    l1, n1 = cool.heatingcooling_rate(*args, rows=idx)
    l2, n2 = cool.heatingcooling_rate(*args, rows=idx)
    assert torch.equal(l1, l2) and torch.equal(n1, n2)
    lr, nr = cr.get_heatingcooling_rate(c["dens"], c["ucgs"], 3.0, uvbg,
                                        c["ne"])
    sel = idx if rows else slice(None)
    scale = float(lr.abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(n1[sel], nr[sel], rtol=0, atol=1e-6)
        torch.testing.assert_close(l1[sel], lr[sel], rtol=4e-6,
                                   atol=1e-7 * scale)
    else:
        torch.testing.assert_close(n1[sel], nr[sel], rtol=1e-9, atol=1e-12)
        torch.testing.assert_close(l1[sel], lr[sel], rtol=1e-9,
                                   atol=1e-12 * scale)
    if rows:
        rest = torch.ones(512, dtype=torch.bool, device=cuda)
        rest[idx] = False
        assert torch.equal(l1[rest], torch.zeros_like(l1[rest]))
        assert torch.equal(n1[rest], c["ne"][rest])


def test_init_sfr_uses_the_double_kernel(cuda, monkeypatch):
    """init_sfr's self-consistent threshold on the card runs K6's float64
    instance (no plain fallback) and equals the CPU's to 1e-9."""
    from mpgadget_tpu_torch.cosmology import Cosmology
    from mpgadget_tpu_torch.physics import cooling as cool
    from mpgadget_tpu_torch.physics import sfr
    from mpgadget_tpu_torch.utils import constants as C
    from mpgadget_tpu_torch.utils import get_unitsystem
    units = get_unitsystem(C.CM_PER_KPC, 1.989e43, 1e5)
    cp = Cosmology(Omega0=0.3, OmegaBaryon=0.045, OmegaLambda=0.7,
                   HubbleParam=0.7).init_units(units)
    cu = cool.CoolingUnits(units.UnitDensity_in_cgs * 0.49,
                           units.UnitInternalEnergy_in_cgs,
                           units.UnitTime_in_s / 0.7)
    cr = _cooling_rates()
    want = sfr.init_sfr(sfr.SFRParams(), cp, units, cr, cu, 1e-3,
                        device="cpu").PhysDensThresh

    def refuse(*a, **k):
        raise AssertionError("plain version called on CUDA tensors")

    monkeypatch.setattr(cr, "get_heatingcooling_rate", refuse)
    before = cool.LAUNCHES
    got = sfr.init_sfr(sfr.SFRParams(), cp, units, cr, cu, 1e-3,
                       device=cuda).PhysDensThresh
    assert cool.LAUNCHES == before + 1
    assert got == pytest.approx(want, rel=1e-9)


def test_cooling_wrappers_raise_instead_of_falling_back(cuda, monkeypatch):
    """On CUDA tensors the K6 wrappers launch the kernel or raise: wrong
    types and mixed devices are refused, and with the kernel library
    unavailable the call raises rather than running the plain version."""
    from mpgadget_tpu_torch.physics import cooling as cool
    cr, uvbg = _cooling_rates(), _uvbg(False)
    c = _cooling_case(cuda, torch.float32, n=64)
    args = [cr, 1.5, c["u"], c["rho"], c["dt"], uvbg, c["ne"], c["min_egy"],
            c["cu"]]
    for i, bad in ((2, c["u"].half()), (3, c["rho"].cpu()),
                   (4, c["dt"].double())):
        a = list(args)
        a[i] = bad
        with pytest.raises(ValueError):
            cool.do_cooling(*a)
    monkeypatch.setattr(cool, "do_cooling_reference", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("plain version on the card")))
    before = cool.LAUNCHES
    cool.do_cooling(*args)
    assert cool.LAUNCHES == before + 1

    def no_library(name):
        raise RuntimeError(f"no {name}")

    monkeypatch.setattr(cool, "_fns", {})
    monkeypatch.setattr(cool.kernels, "load", no_library)
    with pytest.raises(RuntimeError, match="no cooling"):
        cool.do_cooling(*args)


def _rate_params(kind):
    """CoolingParams of one case of the option tests: a (recomb, cooling)
    pair, or "helium" (HeliumHeatOn with the default tables)."""
    from mpgadget_tpu_torch.physics import cooling as cool
    if kind == "helium":
        return cool.CoolingParams(MinGasTemp=100.0, HeliumHeatOn=True,
                                  HeliumHeatThresh=10.0, HeliumHeatAmp=1.5,
                                  HeliumHeatExp=-0.5)
    return cool.CoolingParams(MinGasTemp=100.0, recomb=kind[0],
                              cooling=kind[1])


def _against_first_design(cr, uvbg, c, rows):
    """Both K6 entry points on case c against the first design
    (csrc/cooling_simple.cu, through chip_smoke.simple_cooling): every
    output bit for bit; with rows, the unlisted rows as they came in;
    one launch counted for each call of the kernel, none for the first
    design's."""
    import chip_smoke
    from mpgadget_tpu_torch.physics import cooling as cool

    def cooling():
        return cool.do_cooling(cr, 1.5, c["u"], c["rho"], c["dt"], uvbg,
                               c["ne"], c["min_egy"], c["cu"], rows=rows)

    def rate():
        return cool.heatingcooling_rate(cr, c["dens"], c["ucgs"], 3.0, uvbg,
                                        c["ne"], rows=rows)

    for call, kept in ((cooling, (c["u"], c["ne"])),
                       (rate, (torch.zeros_like(c["u"]), c["ne"]))):
        before = cool.LAUNCHES
        new = call()
        assert cool.LAUNCHES == before + 1
        first = chip_smoke.simple_cooling(call)
        torch.cuda.synchronize()
        assert cool.LAUNCHES == before + 1
        for x, y in zip(new, first):
            assert chip_smoke.same_bits(x, y)
        if rows is not None:
            rest = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
            rest[rows] = False
            for x, k in zip(new, kept):
                assert chip_smoke.same_bits(x[rest], k[rest])


def _unconverged(cr, uvbg, dens, ucgs, ne):
    """The rows whose Steffensen iterates (the rate's fixed point from
    ne) repeat none of the last NE_PERIOD in NE_ITERS iterations: the rows
    on which K6 runs all of them."""
    from mpgadget_tpu_torch.physics import cooling as cool
    nh = dens * (1 - cr.helium)
    x = [torch.where(ne <= 0, 1.0, ne)]
    for _ in range(cool.NE_ITERS):
        x.append(cr.equilib_ne_step(nh, ucgs, x[-1], cr.helium, uvbg))
    it = torch.int32 if ne.dtype == torch.float32 else torch.int64
    moving = torch.ones_like(ne, dtype=torch.bool)
    for i in range(1, len(x)):
        for p in range(1, min(i, cool.NE_PERIOD) + 1):
            moving &= ~((x[i] == x[i - p])
                        & (x[i].view(it) == x[i - p].view(it)))
    return moving


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("uv", [False, True])
@pytest.mark.parametrize("rows", [False, True])
def test_cooling_kernel_matches_first_design(cuda, dtype, uv, rows):
    """K6 against its first design, bit for bit, on 509 rows (a multiple
    neither of a row's lanes nor of a warp), all or a listed third: the
    card-test grid with rows at min_u, zero ne_guess, and dense
    self-shielded rows, some of whose Steffensen iterations (with the UV
    background) run all 30 without repeating (checked on the CPU with the
    plain step)."""
    from mpgadget_tpu_torch.physics import cooling as cool
    cr, uvbg = _cooling_rates(), _uvbg(uv)
    c = _cooling_case(cuda, dtype, n=509, seed=29)
    c["u"][::11] = 0.5 * c["min_egy"]
    c["ne"][::7] = 0.0
    dense = slice(3, None, 4)
    c["rho"][dense] *= 1e4
    c["dens"][dense] *= 1e4
    if uv:
        assert bool(_unconverged(cr, uvbg, c["dens"][dense].cpu(),
                                 c["ucgs"][dense].cpu(),
                                 c["ne"][dense].cpu()).any())
    idx = torch.arange(2, 509, 3, device=cuda) if rows else None
    _against_first_design(cr, uvbg, c, idx)


@pytest.mark.parametrize("kind", [(r, c) for r in range(3) for c in range(3)]
                         + ["helium"])
def test_cooling_kernel_options_match_first_design(cuda, kind):
    """K6 against its first design, bit for bit, with every recombination
    x cooling option and with HeliumHeatOn (float32, UV background on,
    121 rows, a listed half)."""
    from mpgadget_tpu_torch.physics import cooling as cool
    p = _rate_params(kind)
    cr = cool.CoolingRates(p, cool.TreeCool(None, p))
    c = _cooling_case(cuda, torch.float32, n=121, seed=31)
    _against_first_design(cr, _uvbg(True), c,
                          torch.arange(0, 121, 2, device=cuda))
