"""The port's CUDA path on a card (marked ``cuda``; each test skips when
no card is present).  Imports torch, the port and the walk inputs of
tests/test_torch_walkkernel.py only, no JAX, so that it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mpgadget_tpu_torch.gravity import pairkernel as pk
from mpgadget_tpu_torch.gravity import treepm, treewalk
from mpgadget_tpu_torch.pm import gravity as pm
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
