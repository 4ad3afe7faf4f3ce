"""FOF and the neighbour walk of the PyTorch port against the JAX package.

One clumpy box of 2000 particles (eight Gaussian blobs over a uniform
half, tests/test_fof.py's generator, one blob on the box corner so that
it wraps on every axis; 400 of them gas next to a DM particle, which FOF
links as secondaries) is written as an IC and read by both packages'
build_simulation into 2048 slots.  Each package runs Simulation.run_fof
once (module fixture), with its fof_label, fof_secondary and
find_neighbors_auto spied on, so that one JAX run serves the label,
secondary, catalogue, neighbour-list and PIG comparisons (the JAX package
compiles its FOF once per shape and its pair sweeps once per round).
The port runs its plain versions on the CPU: K3 is compared with
find_neighbors_reference in tests/test_torch_cuda.py on a card.
"""

import filecmp
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpgadget_tpu.gravity import tree as jtree
from mpgadget_tpu.gravity import treewalk as jtw
from mpgadget_tpu.main import build_simulation as jax_build
from mpgadget_tpu.ops import morton as jmorton
from mpgadget_tpu.ops import pairs as jpairs
from mpgadget_tpu.params import create_gadget_parameter_set as jax_params
from mpgadget_tpu.physics import fof as jfof
from mpgadget_tpu_torch.gravity import tree as ttree
from mpgadget_tpu_torch.gravity import treewalk as ttw
from mpgadget_tpu_torch.io import snapshot as snap_io
from mpgadget_tpu_torch.io.bigfile import BigFile
from mpgadget_tpu_torch.main import build_simulation
from mpgadget_tpu_torch.ops import morton, pairs
from mpgadget_tpu_torch.params import create_gadget_parameter_set
from mpgadget_tpu_torch.physics import fof

# one intra-op thread: the suite runs in several worker processes that
# share the machine's cores
torch.set_num_threads(1)

BOX = 1000.0
N = 2000
N_GAS = 400
PARAMS = """
InitCondFile = {ic}
OutputDir = {out}
OutputList = 0.12
TimeMax = 0.12
TimeLimitCPU = 10000
Omega0 = 0.288
OmegaLambda = 0.712
OmegaBaryon = 0.0472
HubbleParam = 0.7
HydroOn = 0
CoolingOn = 0
StarformationOn = 0
WindOn = 0
SnapshotWithFOF = 1
BlackHoleOn = 0
MetalReturnOn = 0
MassiveNuLinRespOn = 0
DensityIndependentSphOn = 0
Nmesh = 16
"""


def _clumpy(seed=8):
    """tests/test_fof.py's clumpy set, one blob centred on the corner."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(100, 900, (8, 3))
    centers[0] = 0.5
    blob = centers[rng.randint(8, size=N // 2)] + 8.0 * rng.randn(N // 2, 3)
    pos = np.concatenate([rng.uniform(0, BOX, (N - N // 2, 3)),
                          np.mod(blob, BOX)])
    # the gas sits within a linking length of a DM particle, so that one
    # search radius attaches it all (each doubling costs the JAX package
    # two more compiled sweeps)
    gas = np.zeros(N, bool)
    gas[rng.permutation(N)[:N_GAS]] = True
    host = rng.choice(np.nonzero(~gas)[0], N_GAS)
    pos[gas] = np.mod(pos[host] + rng.uniform(-5.0, 5.0, (N_GAS, 3)), BOX)
    return pos, gas, rng.randn(N, 3) * 10.0


def _write_ic(path):
    pos, gas, vel = _clumpy()
    bf = BigFile(str(path), create=True)
    for t, sel, m in ((0, gas, 0.2), (1, ~gas, 1.0)):
        snap_io.write_species(bf, t, pos=pos[sel], vel=vel[sel],
                              pid=np.nonzero(sel)[0] + 1,
                              mass=np.full(sel.sum(), m), atime=0.1)
    ntot = np.array([gas.sum(), (~gas).sum(), 0, 0, 0, 0], np.uint64)
    snap_io.write_header(bf, snap_io.SnapshotHeader(
        TotNumPart=ntot, MassTable=np.zeros(6), Time=0.1, TimeIC=0.1,
        BoxSize=BOX, Omega0=0.288, OmegaLambda=0.712, HubbleParam=0.7,
        OmegaBaryon=0.0472))
    return str(path)


def _params(create, ic, out):
    ps = create()
    ps.parse_string(PARAMS.format(ic=ic, out=out))
    ps.validate()
    return ps


def _spy(mp, module, name, calls):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        res = real(*args, **kwargs)
        calls.setdefault(name, []).append((args, kwargs, res))
        return res
    mp.setattr(module, name, spy)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Simulation.run_fof in both packages on the same IC."""
    tmp = tmp_path_factory.mktemp("torch_fof")
    ic = _write_ic(tmp / "IC")
    jcalls, tcalls = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("fof_label", "fof_secondary"):
            _spy(mp, jfof, name, jcalls)
            _spy(mp, fof, name, tcalls)
        _spy(mp, jpairs, "find_neighbors_auto", jcalls)
        _spy(mp, pairs, "find_neighbors_auto", tcalls)
        jsim, _ = jax_build(_params(jax_params, ic, tmp / "jax"))
        jcat = jsim.run_fof(save=True, label=0)
        tsim, _ = build_simulation(
            _params(create_gadget_parameter_set, ic, tmp / "torch"),
            device="cpu")
        tcat = tsim.run_fof(save=True, label=0)
    return dict(tmp=tmp, jsim=jsim, tsim=tsim, jcat=jcat, tcat=tcat,
                jcalls=jcalls, tcalls=tcalls)


@pytest.fixture(scope="module")
def trees(runs):
    """Both packages' per-level trees and target groups for fof_label's
    sorted primaries (the gas and the empty slots are invalid)."""
    (ipos, primary, *_), _, _ = runs["jcalls"]["fof_label"][0]
    n = ipos.shape[0]
    keys = jnp.where(primary, jmorton.morton_key(ipos), ~jnp.uint64(0))
    perm = jnp.argsort(keys)
    jt = jtree.build_tree(keys[perm], ipos[perm], jnp.ones(n, jnp.float32),
                          primary[perm], 16, 18, 2 * n + 64, group_max=32)
    pos_box = ipos[perm].astype(jnp.float32) * jnp.float32(2.0 ** -32)
    amag = np.random.RandomState(3).uniform(0.5, 2.0, n).astype(np.float32)
    group_cap = min((8 * n) // 32 + 64, n + 64)
    jg = jtw.make_target_groups(jt, pos_box, jnp.asarray(amag), group_cap,
                                32)

    tipos = torch.as_tensor(np.asarray(ipos).astype(np.int64))
    tprim = torch.as_tensor(np.array(primary))
    tkeys = morton.morton_key(tipos)
    tperm = morton.sort_order(tkeys, tprim)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(perm))
    tt = ttree.build_tree(torch.where(tprim[tperm], tkeys[tperm],
                                      morton.KEY_PAD),
                          tipos[tperm], torch.ones(n), tprim[tperm], 16, 18,
                          2 * n + 64, group_max=32)
    tg = ttw.make_target_groups(tt, tipos[tperm].float() * 2.0 ** -32,
                                torch.as_tensor(amag), group_cap, 32)
    return jt, tt, jg, tg


def test_morton_key_matches_jax():
    rng = np.random.RandomState(5)
    ipos = rng.randint(0, 2 ** 32, (1000, 3), dtype=np.uint64)
    ipos[0] = 2 ** 32 - 1           # the corner cell: key 2^63 - 1
    ipos[1] = 0
    ipos = ipos.astype(np.uint32)
    jk = np.asarray(jmorton.morton_key(jnp.asarray(ipos)))
    tk = morton.morton_key(torch.as_tensor(ipos.astype(np.int64)))
    np.testing.assert_array_equal(tk.numpy(), jk.astype(np.int64))
    assert int(tk[0]) == 2 ** 63 - 1 and int(tk.min()) >= 0
    # bit 3b + 2 - axis of the key is bit b of the axis' top 21 bits
    bits = (tk.numpy()[:, None] >> np.arange(63)) & 1
    cells = np.stack([(bits[:, 2 - a::3] << np.arange(21)).sum(axis=1)
                      for a in range(3)], axis=1)
    np.testing.assert_array_equal(cells, np.asarray(ipos, np.int64) >> 11)
    # the (invalid, key) order is JAX's argsort with the ~0 sentinel
    valid = rng.rand(1000) > 0.3
    jperm = jnp.argsort(jnp.where(jnp.asarray(valid), jnp.asarray(jk),
                                  ~jnp.uint64(0)))
    np.testing.assert_array_equal(
        morton.sort_order(tk, torch.as_tensor(valid)).numpy(),
        np.asarray(jperm))


def test_build_tree_matches_jax(trees):
    jt, tt, _, _ = trees
    for name in ("level", "pstart", "pcount", "skip", "is_leaf",
                 "is_group", "n_nodes"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)
    ks = np.asarray(jt.key_start)
    np.testing.assert_array_equal(
        tt.key_start.numpy(),
        np.where(ks == np.iinfo(np.uint64).max, morton.KEY_PAD,
                 ks.astype(np.int64)))
    np.testing.assert_array_equal(
        ttree.Tree.from_jax_numpy({k: np.asarray(getattr(jt, k)) for k in
                                   ttree.Tree.__dataclass_fields__},
                                  device="cpu").key_start.numpy(),
        tt.key_start.numpy())
    for name in ("mass", "com", "center", "length"):
        np.testing.assert_allclose(getattr(tt, name).numpy(),
                                   np.asarray(getattr(jt, name)), rtol=1e-6,
                                   err_msg=name)
    assert int(tt.n_nodes) < tt.capacity and not bool(tt.overflow)


def test_make_target_groups_matches_jax(trees):
    _, _, jg, tg = trees
    np.testing.assert_array_equal(tg[0].numpy(), np.asarray(jg[0]))
    for a, b in zip(tg[1:4], jg[1:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    assert int(tg[4]) == int(jg[4]) and not bool(tg[5])


@pytest.mark.parametrize("case", ["asymmetric", "symmetric", "overflow",
                                  "exactly_LL"])
def test_find_neighbors_reference_matches_jax(runs, trees, case):
    jt, tt, _, _ = trees
    (_, nodes, gc, gh, grad, _, ll0), kw, (jnbr, ll) = \
        runs["jcalls"]["find_neighbors_auto"][0]
    tnodes = torch.as_tensor(np.asarray(nodes).astype(np.int64))
    args = [torch.as_tensor(np.array(a)) for a in (gc, gh, grad)]
    hmax = None
    if case == "symmetric":
        # a seeded hmax above the radius on a fifth of the nodes
        rng = np.random.RandomState(4)
        h = rng.uniform(0, 4 * float(grad[0]), tt.capacity)
        hmax = (h * (rng.rand(tt.capacity) < 0.2)).astype(np.float32)
        LL, jnbr = 256, jpairs.find_neighbors(
            jt, nodes, gc, gh, grad, jnp.asarray(hmax), 256, symmetric=True)
    elif case == "overflow":
        LL, jnbr = 8, jpairs.find_neighbors(jt, nodes, gc, gh, grad, None, 8,
                                            symmetric=False)
    elif case == "exactly_LL":
        # the list length of the most groups: many hold exactly LL leaves
        counts = np.asarray(jnbr.n_leaves)
        LL = int(np.bincount(counts[counts > 0]).argmax())
        jnbr = jpairs.find_neighbors(jt, nodes, gc, gh, grad, None, LL,
                                     symmetric=False)
    else:
        LL = ll
    tnbr = pairs.find_neighbors(
        tt, tnodes, *args, None if hmax is None else torch.as_tensor(hmax),
        LL, symmetric=case == "symmetric")
    np.testing.assert_array_equal(tnbr.leaf_idx.numpy(),
                                  np.asarray(jnbr.leaf_idx))
    np.testing.assert_array_equal(tnbr.n_leaves.numpy(),
                                  np.asarray(jnbr.n_leaves))
    np.testing.assert_array_equal(tnbr.overflow.numpy(),
                                  np.asarray(jnbr.overflow))
    nl, ovf = tnbr.n_leaves.numpy(), tnbr.overflow.numpy()
    assert (tnbr.visits.numpy() >= nl).all()
    if case == "overflow":
        assert ovf.sum() > 10
    if case == "exactly_LL":
        # a group that holds exactly LL leaves is flagged (JAX's rule)
        assert ovf[nl == LL].all() and (nl == LL).sum() > 0
    if case in ("asymmetric", "symmetric"):
        assert not ovf.any() and nl.sum() > 0


def _partition_equal(a, b):
    """Two labelings define the same partition."""
    pairs_ = set(zip(a.tolist(), b.tolist()))
    return (len(pairs_) == len(set(a.tolist()))
            == len(set(b.tolist())))


def test_fof_label_matches_jax_and_scipy(runs):
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree
    jargs, _, jres = runs["jcalls"]["fof_label"][0]
    targs, _, tres = runs["tcalls"]["fof_label"][0]
    ipos = np.asarray(jargs[0]).astype(np.int64)
    primary = np.asarray(jargs[1])
    np.testing.assert_array_equal(targs[0].numpy(), ipos)
    np.testing.assert_array_equal(targs[1].numpy(), primary)
    assert targs[2:4] == jargs[2:4]
    lab = tres[0].numpy()
    np.testing.assert_array_equal(lab, np.asarray(jres[0]))
    # the same partition as scipy's connected components
    pos = ipos[primary] * (BOX / 2.0 ** 32)
    prs = cKDTree(pos, boxsize=BOX).query_pairs(jargs[3],
                                                output_type="ndarray")
    m = len(pos)
    _, ref = connected_components(csr_matrix(
        (np.ones(len(prs)), (prs[:, 0], prs[:, 1])), shape=(m, m)),
        directed=False)
    assert _partition_equal(lab[primary], ref)
    assert (lab[~primary] == -1).all()
    # the corner blob wraps on every axis and is one group
    near = np.all(np.minimum(pos, BOX - pos) < 12.0, axis=1)
    assert len(set(lab[primary][near].tolist())) == 1 and near.sum() > 20


def test_fof_label_periodic_wrap():
    """A cluster straddling the box boundary is one group."""
    box = 100.0
    pos = np.array([[99.5, 50, 50], [0.2, 50, 50], [0.9, 50, 50],
                    [50, 50, 50]])
    ipos = torch.as_tensor((pos / box * 2.0 ** 32).astype(np.int64))
    lab, _, _ = fof.fof_label(ipos, torch.ones(4, dtype=torch.bool), box,
                              1.0)
    lab = lab.numpy()
    assert lab[0] == lab[1] == lab[2] and lab[3] != lab[0]


def test_fof_secondary_matches_jax(runs):
    jargs, _, jres = runs["jcalls"]["fof_secondary"][0]
    targs, _, tres = runs["tcalls"]["fof_secondary"][0]
    for a, b in zip(targs[:4], jargs[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    att = tres.numpy()
    np.testing.assert_array_equal(att, np.asarray(jres))
    sec = np.asarray(jargs[1])
    assert (att[sec] >= 0).sum() > 50 and (att[~sec] == -1).all()


def test_fof_catalog_matches_jax(runs):
    jcat, tcat = runs["jcat"], runs["tcat"]
    assert tcat["ngroups"] == jcat["ngroups"] >= 8
    for k in ("lengths", "len_by_type", "group_index"):
        np.testing.assert_array_equal(tcat[k], np.asarray(jcat[k]), k)
    for k in ("masses", "cm", "vel", "mass_by_type"):
        np.testing.assert_allclose(tcat[k], np.asarray(jcat[k]), rtol=1e-6,
                                   err_msg=k)
    assert (tcat["len_by_type"][:, 0] > 0).any()      # gas attached


def test_run_fof_pig_matches_jax(runs):
    """Simulation.run_fof writes the PIG the JAX package writes: every
    block's files are the same bytes, and the catalogue reads back."""
    tmp = runs["tmp"]
    jdir, tdir = tmp / "jax" / "PIG_000", tmp / "torch" / "PIG_000"
    files = sorted(os.path.relpath(os.path.join(d, f), jdir)
                   for d, _, fs in os.walk(jdir) for f in fs)
    assert sorted(os.path.relpath(os.path.join(d, f), tdir)
                  for d, _, fs in os.walk(tdir) for f in fs) == files
    for rel in files:
        assert filecmp.cmp(jdir / rel, tdir / rel, shallow=False), rel
    bf = BigFile(str(tdir))
    ng = runs["tcat"]["ngroups"]
    assert len(bf.open("FOFGroups/Mass").read()) == ng
    gid = bf.open("1/GroupID").read()
    assert (np.diff(gid.astype(np.int64)) >= 0).all() and gid.min() == 1
