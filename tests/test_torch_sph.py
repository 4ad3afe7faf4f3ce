"""The port's SPH modules against the JAX package (PyTorch on the CPU).

- sph/kernels: wk, dwk, dW and desnumngb for the three kernel types;
- ops/pairs compact_leaves and node_hmax on one tree: equal values;
- sph_density on a perturbed 8^3 gas lattice with velocities and 40
  non-gas particles among it (quintic), without and with a target mask;
- hydro_force in both formulations (pressure-entropy with the density
  contrast limit, density-entropy) on that density's output, and the
  pair function in every formulation branch;
- the plain K4 and K5 (density_sums_reference, hydro_sums_reference,
  which the CPU runs) against a direct sum over every pair of gas at 5^3,
  so that the neighbour lists miss no pair.

Every JAX result is computed once per module (the JAX package compiles
each SPH loop once per shape and option set, seconds each); the JAX
density runs with a target mask only, and the port's unmasked solve is
held to JAX's solve with every gas particle targeted, which computes the
same (its done mask starts as ~(valid & mask) = ~valid).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpgadget_tpu.gravity import tree as jtree
from mpgadget_tpu.ops import pairs as jpairs
from mpgadget_tpu.particles import pos_to_fixed
from mpgadget_tpu.sph import density as jdens
from mpgadget_tpu.sph import hydra as jhydra
from mpgadget_tpu.sph import kernels as jK
from mpgadget_tpu_torch.gravity import tree as ttree
from mpgadget_tpu_torch.ops import pairs
from mpgadget_tpu_torch.sph import density, hydra
from mpgadget_tpu_torch.sph import kernels as K

# one intra-op thread: the suite runs in several worker processes that
# share the machine's cores
torch.set_num_threads(1)

BOX = 1000.0
NG = 8
NDM = 40
TOL = 1e-5          # relative, by norm
ATIME, HUBBLE, DLOGA = 0.2, 3.0, 0.01


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-300)


def gas_box(ng=NG, ndm=NDM, box=BOX, seed=5):
    """A gas lattice displaced by up to 0.3 cell with ndm non-gas particles
    among it: (ipos uint32, mass, gas mask, vel, entvar, hsml guess)."""
    rng = np.random.RandomState(seed)
    g = np.indices((ng, ng, ng)).reshape(3, -1).T / ng * box
    pos = np.mod(g + rng.uniform(-0.3, 0.3, g.shape) * box / ng, box)
    pos = np.concatenate([pos, rng.uniform(0, box, (ndm, 3))])
    n = len(pos)
    gas = np.arange(n) < ng ** 3
    mass = np.where(gas, 1.5, 7.0).astype(np.float32)
    vel = (rng.randn(n, 3) * 10).astype(np.float32)
    entvar = rng.uniform(0.5, 1.5, n).astype(np.float32)
    hsml = np.full(n, 2 * box / ng, np.float32)
    return pos_to_fixed(pos, box), mass, gas, vel, entvar, hsml


def _t(a):
    a = np.asarray(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.uint32
                           else a.copy())


@pytest.mark.parametrize("ktype", [K.CUBIC, K.QUINTIC, K.QUARTIC])
def test_kernel_functions_match_jax(ktype):
    rng = np.random.RandomState(ktype)
    u = np.concatenate([np.linspace(0, 1.2, 241),
                        rng.uniform(0, 1, 200)]).astype(np.float32)
    hinv = rng.uniform(0.5, 3.0, u.shape).astype(np.float32)
    wk_j = np.asarray(jK.kernel_wk(jnp.asarray(u), jnp.asarray(hinv), ktype))
    dwk_j = np.asarray(jK.kernel_dwk(jnp.asarray(u), jnp.asarray(hinv),
                                     ktype))
    wk = K.kernel_wk(torch.as_tensor(u), torch.as_tensor(hinv), ktype)
    dwk = K.kernel_dwk(torch.as_tensor(u), torch.as_tensor(hinv), ktype)
    scale = np.abs(wk_j).max()
    np.testing.assert_allclose(wk.numpy(), wk_j, rtol=1e-6,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(dwk.numpy(), dwk_j, rtol=1e-6,
                               atol=1e-6 * np.abs(dwk_j).max())
    dW_j = np.asarray(jK.kernel_dW(jnp.asarray(u), wk_j, dwk_j,
                                   jnp.asarray(hinv)))
    dW = K.kernel_dW(torch.as_tensor(u), torch.as_tensor(wk_j),
                     torch.as_tensor(dwk_j), torch.as_tensor(hinv))
    np.testing.assert_allclose(dW.numpy(), dW_j, rtol=1e-6,
                               atol=1e-6 * np.abs(dW_j).max())
    for eta in (1.0, 1.2):
        assert K.desnumngb(eta, ktype) == pytest.approx(
            float(jK.desnumngb(eta, ktype)), rel=1e-12)
    assert float(K.kernel_volume(torch.tensor(2.0), ktype)) == \
        pytest.approx(float(jK.kernel_volume(2.0, ktype)), rel=1e-6)


def test_compact_leaves_and_node_hmax_match_jax():
    """On one per-level tree of a clumpy set (some of it not gas, so that
    leaves and nodes without gas occur; the port's build, which
    tests/test_torch_fof.py holds to the JAX package's, handed to both):
    the same leaf list and the same hmax of every node, exactly."""
    rng = np.random.RandomState(9)
    n = 1500
    c = rng.rand(6, 3)
    pos = np.mod(np.concatenate([rng.rand(n // 2, 3), c[rng.randint(
        6, size=n - n // 2)] + 0.02 * rng.randn(n - n // 2, 3)]), 1.0)
    valid = torch.as_tensor(rng.rand(n) < 0.8)
    perm, _, _, valid_s, tt, _ = density.sorted_tree(
        _t(pos_to_fixed(pos, 1.0)), torch.ones(n), valid, 32)
    ints = ("level", "pstart", "pcount", "skip", "n_nodes")
    fields = {}
    for k in ttree.Tree.__dataclass_fields__:
        a = getattr(tt, k).numpy()
        if k == "key_start":
            a = a.astype(np.uint64)          # KEY_PAD -1 is the JAX ~0
        fields[k] = jnp.asarray(a.astype(np.int32) if k in ints else a)
    jt = jtree.Tree(**fields)
    assert int(tt.pcount[tt.is_leaf].max()) <= 16
    hs = torch.where(valid_s, torch.as_tensor(rng.uniform(
        0.001, 0.05, n).astype(np.float32)), 0.0)
    cap = 4 * min((8 * n) // 32 + 64, n + 64)   # as hydro_force
    jl, jnl, jovf = jpairs.compact_leaves(jt, cap)
    jh = jpairs.node_hmax(jt, jl, jnl, jnp.asarray(hs.numpy()), 16)
    tl, tnl, tovf = pairs.compact_leaves(tt, cap)
    assert int(tnl) == int(jnl) and bool(tovf) == bool(jovf)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    th = pairs.node_hmax(tt, tl, tnl, hs)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert (th.numpy() > 0).sum() > 100 and (th.numpy() == 0).sum() > 0


@pytest.fixture(scope="module")
def box_inputs():
    return gas_box()


@pytest.fixture(scope="module")
def jax_density(box_inputs):
    """JAX sph_density with every gas particle targeted, and with a
    seeded half of them (one compiled graph: the mask's values are not
    static)."""
    ipos, mass, gas, vel, entvar, hsml = box_inputs
    par = jdens.DensityParams(eta=1.0)
    args = [jnp.asarray(a) for a in (ipos, mass, gas, hsml, vel, vel,
                                     entvar)]
    half = gas & (np.random.RandomState(2).rand(len(gas)) < 0.5)
    out = {}
    for name, mask in (("all", gas), ("half", half)):
        res = jdens.sph_density(*args, par, BOX, target_mask=jnp.asarray(mask))
        out[name] = {k: (np.asarray(v) if k != "iterations" else v)
                     for k, v in res.items()}
    return out, half


def _port_density(box_inputs, mask=None):
    ipos, mass, gas, vel, entvar, hsml = box_inputs
    return density.sph_density(
        _t(ipos), _t(mass), _t(gas), _t(hsml), _t(vel), _t(vel), _t(entvar),
        density.DensityParams(eta=1.0), BOX,
        target_mask=None if mask is None else _t(mask))


FIELDS = ("hsml", "numngb", "density", "egy_wt_density",
          "dhsml_density_factor", "dhsml_egy_factor", "div_vel", "curl_vel",
          "dt_hsml")


@pytest.mark.parametrize("masked", [False, True])
def test_sph_density_matches_jax(box_inputs, jax_density, masked):
    jout, half = jax_density
    ref = jout["half" if masked else "all"]
    out = _port_density(box_inputs, half if masked else None)
    gas = box_inputs[2]
    assert out["iterations"] == ref["iterations"]
    assert out["unconverged"] == 0
    # a bisection branch flips where a numngb lies within rounding of
    # DesNumNgb +- MaxNumNgbDeviation: name such particles, bound their
    # count, and hold every other particle to the tolerance
    h = out["hsml"].numpy()
    flipped = np.nonzero(np.abs(h - ref["hsml"]) > TOL * ref["hsml"])[0]
    assert len(flipped) <= 2, f"bisection flipped at particles {flipped}"
    keep = np.ones(len(h), bool)
    keep[flipped] = False
    for k in FIELDS:
        assert _rel(ref[k][keep], out[k].numpy()[keep]) < TOL, k
    # the targets converged; untargeted gas keeps its hsml, up to the
    # box-unit round trip
    tmask = half if masked else gas
    desngb = density.DensityParams(eta=1.0).desnumngb
    assert np.all(np.abs(out["numngb"].numpy()[tmask] - desngb) <= 2.0)
    np.testing.assert_allclose(h[~tmask], box_inputs[5][~tmask], rtol=1e-6)
    assert np.all(out["density"].numpy()[~gas] == 0)


@pytest.fixture(scope="module")
def jax_hydro(box_inputs, jax_density):
    """JAX hydro_force on JAX's density of every gas particle, in both
    formulations."""
    ipos, mass, gas, vel, entvar, hsml = box_inputs
    d = jax_density[0]["all"]
    out = {}
    for di in (True, False):
        par = jhydra.HydroParams(density_independent=di)
        res = jhydra.hydro_force(
            jnp.asarray(ipos), jnp.asarray(mass), jnp.asarray(gas),
            jnp.asarray(d["hsml"]), jnp.asarray(vel), jnp.asarray(entvar),
            jnp.asarray(d["density"]), jnp.asarray(d["egy_wt_density"]),
            jnp.asarray(d["div_vel"]), jnp.asarray(d["curl_vel"]),
            jnp.asarray(d["dhsml_egy_factor"]), par, BOX, ATIME, HUBBLE,
            DLOGA)
        out[di] = {k: np.asarray(v) for k, v in res.items()}
    return out


@pytest.mark.parametrize("density_independent", [True, False])
def test_hydro_force_matches_jax(box_inputs, jax_density, jax_hydro,
                                 density_independent):
    ipos, mass, gas, vel, entvar, hsml = box_inputs
    d = jax_density[0]["all"]
    res = hydra.hydro_force(
        _t(ipos), _t(mass), _t(gas), _t(d["hsml"]), _t(vel), _t(entvar),
        _t(d["density"]), _t(d["egy_wt_density"]), _t(d["div_vel"]),
        _t(d["curl_vel"]), _t(d["dhsml_egy_factor"]),
        hydra.HydroParams(density_independent=density_independent), BOX,
        ATIME, HUBBLE, DLOGA)
    ref = jax_hydro[density_independent]
    for k in ("hydro_accel", "dt_entropy", "max_signal_vel", "pressure"):
        assert _rel(ref[k], res[k].numpy()) < TOL, k
    assert np.all(res["hydro_accel"].numpy()[~gas] == 0)
    assert np.abs(res["hydro_accel"].numpy()[gas]).max() > 0


def _pair_arrays(seed=4, B=2, G=8, S=64, box=BOX):
    """Random (dx, r, tfeat, sfeat) of the hydro pair function: targets
    and sources within about one smoothing length."""
    rng = np.random.RandomState(seed)
    f = np.float32
    dx = rng.uniform(-0.12, 0.12, (B, G, S, 3)).astype(f)
    dx[0, 0, 0] = 0.0                     # a pair at r = 0
    r = np.sqrt(np.sum(dx * dx, axis=-1)).astype(f)
    tf = {k: rng.uniform(lo, hi, (B, G, 1)).astype(f) for k, lo, hi in (
        ("hsml", 60, 140), ("mass", 1, 2), ("density", 0.5, 2),
        ("soundspeed", 1, 3), ("f1", 0, 1), ("p_over_rho2", 0.1, 2),
        ("entvarpred", 0.5, 1.5), ("egyrho", 0.3, 3), ("dhsml", 0.8, 1.2))}
    tf["velpred"] = rng.randn(B, G, 1, 3).astype(f) * 5
    sf = {k: rng.uniform(lo, hi, (B, 1, S)).astype(f) for k, lo, hi in (
        ("hsml", 60, 140), ("mass", 1, 2), ("density", 0.005, 2),
        ("eomdensity", 0.3, 3), ("pressure", 0.1, 3), ("divvel", -1, 1),
        ("curlvel", 0, 1), ("entvarpred", 0.5, 1.5), ("dhsml", 0.8, 1.2))}
    sf["velpred"] = rng.randn(B, 1, S, 3).astype(f) * 5
    return dx, r, tf, sf


@pytest.mark.parametrize("density_independent,limit", [
    (True, 100.0), (True, 0.0), (True, -1.0), (False, 100.0)])
def test_hydro_pair_function_matches_jax(density_independent, limit):
    """Every formulation branch (hydra.py:105-121) of the pair function,
    with the viscosity limiter on (dloga > 0), against the JAX one."""
    dx, r, tf, sf = _pair_arrays()
    jpar = jhydra.HydroParams(density_independent=density_independent,
                              density_contrast_limit=limit)
    tpar = hydra.HydroParams(density_independent=density_independent,
                             density_contrast_limit=limit)
    scal = hydra.hydro_scalars(tpar, BOX, ATIME, HUBBLE, DLOGA)
    jfn = jax.jit(jhydra._hydro_pair_fn(jpar, BOX, *(jnp.float32(s)
                                                      for s in scal[1:])))
    jres = jfn(jnp.asarray(dx), jnp.asarray(r), None, None,
               {k: jnp.asarray(v) for k, v in tf.items()},
               {k: jnp.asarray(v) for k, v in sf.items()})
    sft = {k: torch.as_tensor(v) for k, v in sf.items()}
    sft["valid"] = torch.ones(sf["hsml"].shape, dtype=torch.bool)
    tres = hydra._hydro_pair_fn(tpar, scal)(
        torch.as_tensor(dx), torch.as_tensor(r), None, None,
        {k: torch.as_tensor(v) for k, v in tf.items()}, sft)
    for k in ("accx", "accy", "accz", "dtent"):
        assert _rel(jres[k], tres[k].numpy()) < TOL, k
    ms_j, ms_t = np.asarray(jres["maxsig"]), tres["maxsig"].numpy()
    np.testing.assert_array_equal(np.isfinite(ms_j), np.isfinite(ms_t))
    fin = np.isfinite(ms_j)
    assert fin.sum() > 100 and (~fin).sum() > 100
    assert _rel(ms_j[fin], ms_t[fin]) < TOL


def _direct(pair_fn, pos_box, valid, tfeat, sfeat, reducers):
    """Every (target, source) pair of the valid particles at once:
    (1, n, n) blocks reduced over the sources."""
    v = torch.nonzero(valid)[:, 0]
    p = pos_box[v]
    dx = pairs._wrap(p[None, None, :, :] - p[None, :, None, :])
    r = torch.sqrt(dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1]
                   + dx[..., 2] * dx[..., 2])
    tf = {k: x[v][None, :, None] for k, x in tfeat.items()}
    sf = {k: x[v][None, None, :] for k, x in sfeat.items()}
    out = pair_fn(dx, r, None, None, tf, sf)
    return {k: (out[k].sum(dim=2) if red == "sum"
                else out[k].max(dim=2).values)[0]
            for k, red in reducers.items()}, v


@pytest.mark.parametrize("loop", ["density", "hydro"])
def test_plain_pair_sums_miss_no_pair(loop):
    """The plain K4 / K5 over the neighbour lists (asymmetric at the
    targets' hsml; symmetric with node hmax) against a direct sum over
    every pair of gas: 5^3 gas with 20 non-gas particles, hsml spread by
    a factor 2.5 so that the symmetric search matters."""
    ipos, mass, gas, vel, entvar, _ = gas_box(ng=5, ndm=20, seed=12)
    n = len(gas)
    rng = np.random.RandomState(3)
    hsml = np.where(gas, rng.uniform(0.16, 0.4, n) * BOX, 0.0).astype(
        np.float32)
    perm, inv, pos_box, valid_s, tree, (nodes, gc, gh) = density.sorted_tree(
        _t(ipos), _t(mass), _t(gas), 32)
    s = lambda a: _t(a)[perm]          # noqa: E731
    hbox = s(hsml) * float(np.float32(1 / BOX))
    tidx, tm = density.group_targets(tree, nodes, n, 32)
    gradius = torch.where(tm, hbox[tidx], 0.0).max(dim=1).values
    if loop == "density":
        src, tgt, valid = density.pack_density_inputs(
            pos_box, valid_s, s(mass), s(vel), s(entvar), hbox, s(vel))
        nbr = pairs.find_neighbors(tree, nodes, gc, gh, gradius, None, 256,
                                   symmetric=False)
        got = density.density_sums_reference(tree, nbr, src, tgt, valid,
                                             K.QUINTIC, 32)
        fn = density._density_pair_fn(K.QUINTIC)
        tfeat = {"hsml": tgt[:, 0], "vel": tgt[:, 1:4]}
        sfeat = {"mass": src[:, 3], "velpred": src[:, 4:7],
                 "entvarpred": src[:, 7], "valid": valid_s}
        names = density.OUTPUTS
    else:
        par = hydra.HydroParams()
        scal = hydra.hydro_scalars(par, BOX, ATIME, HUBBLE, DLOGA)
        leaf_ids, nl, _ = pairs.compact_leaves(tree, tree.capacity)
        hmax = pairs.node_hmax(tree, leaf_ids, nl, hbox)
        nbr = pairs.find_neighbors(tree, nodes, gc, gh, gradius, hmax, 256,
                                   symmetric=True)
        cols = {k: s(rng.uniform(0.5, 2.0, n).astype(np.float32))
                for k in ("density", "eomdensity", "pressure", "curlvel",
                          "dhsml", "soundspeed", "f1", "p_over_rho2",
                          "egyrho")}
        cols.update(mass=s(mass), hsml=s(hsml), entvarpred=s(entvar),
                    divvel=s(rng.uniform(-1, 1, n).astype(np.float32)))
        src, tgt, valid = hydra.pack_hydro_inputs(pos_box, valid_s, s(vel),
                                                  cols)
        got = hydra.hydro_sums_reference(tree, nbr, src, tgt, valid, par,
                                         scal)
        fn = hydra._hydro_pair_fn(par, scal)
        col = dict(zip(hydra.SRC_COLUMNS, src.unbind(1)))
        tcol = dict(zip(hydra.TGT_COLUMNS, tgt.unbind(1)))
        velp = src[:, 4:7]
        tfeat = {"hsml": col["hsml"], "velpred": velp, "mass": tcol["mass"],
                 "density": col["density"], "soundspeed": tcol["soundspeed"],
                 "f1": tcol["f1"], "p_over_rho2": tcol["p_over_rho2"],
                 "entvarpred": col["entvarpred"], "egyrho": tcol["egyrho"],
                 "dhsml": col["dhsml"]}
        sfeat = {"hsml": col["hsml"], "velpred": velp, "mass": col["mass"],
                 "density": col["density"], "eomdensity": col["eomdensity"],
                 "pressure": col["pressure"], "divvel": col["divvel"],
                 "curlvel": col["curlvel"], "entvarpred": col["entvarpred"],
                 "dhsml": col["dhsml"], "valid": valid_s}
        names = hydra.OUTPUTS
    assert not bool(nbr.overflow.any())
    red = {k: ("max" if k == "maxsig" else "sum") for k in names}
    want, v = _direct(fn, pos_box, valid_s, tfeat, sfeat, red)
    for i, k in enumerate(names):
        a, b = want[k].numpy(), got[v, i].numpy()
        if k == "maxsig":
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
            a, b = a[np.isfinite(a)], b[np.isfinite(b)]
        assert _rel(a, b) < TOL, k
    assert np.all(got[~valid_s.bool(), :4].numpy() == 0)
