"""The port's sharded gas modules against the JAX package's, at 2 and 4
ranks: parallel/sph.py (the density with its strip re-run, the hydro
force), the driver's entropy integration and star spawning, and the FOF's
secondary attach.

The port's side of the sharded cases runs as gloo ranks on the CPU,
spawned once per rank count (tests/_torch_sharded_worker.py:
gas_module_cases), on the rows of each rank's geometric slab.  The JAX
side is the JAX package's shard_map functions (parallel/sph.py's
sharded_sph_density and sharded_hydro, parallel/fof.py's sharded_fof) at
the same shard count on the host devices of tests/conftest.py, on the same
rows; since those take minutes to compile on the CPU, the cases compare
against the committed record ``torch_sharded/jax_gas_modules.npz``, which
the slow test ``test_jax_gas_module_record`` computes anew and checks
(MPG_WRITE_SHARDED_FIXTURE=1 writes it):

    MPG_WRITE_SHARDED_FIXTURE=1 python -m pytest -m slow \\
        tests/test_torch_sharded_gas.py

The entropy update and the spawning are elementwise; both packages run
them here on the same numpy inputs.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_sharded_worker as W

torch.set_num_threads(1)

RECORD = Path(__file__).resolve().parent / "torch_sharded" / \
    "jax_gas_modules.npz"
RANKS = (2, 4)
TOL = 1e-5          # relative, by norm (the SPH sums, tests/test_torch_sph.py)


@pytest.fixture(scope="module", params=RANKS, ids=lambda s: f"{s}ranks")
def ranks(request, tmp_path_factory):
    """(S, per-rank results of gas_module_cases, the JAX record of S)."""
    S = request.param
    out = tmp_path_factory.mktemp(f"gasmod{S}")
    W.spawn(W.gas_module_cases, S, str(out))
    got = [dict(np.load(out / f"gas_r{r}.npz")) for r in range(S)]
    rec = np.load(RECORD)
    want = {k[len(f"S{S}_"):]: rec[k] for k in rec.files
            if k.startswith(f"S{S}_")}
    return S, got, want


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _rows(got, want, S, name):
    """This case's column of every rank, concatenated in rank order, from
    both sides; the rows are the same (pid checked)."""
    for r in range(S):
        np.testing.assert_array_equal(got[r]["pid"], want[f"pid_r{r}"])
    gas = np.concatenate([want[f"ptype_r{r}"] for r in range(S)]) == 0
    a = np.concatenate([g[name] for g in got])
    b = np.concatenate([want[f"{name}_r{r}"] for r in range(S)])
    return a[gas], b[gas]


def test_density_strip_reruns_as_jax(ranks):
    """The first strip (GAS_HSML0 of the mean separation, times 1.6) is
    too narrow for the converged hsml: both packages widen it the same
    number of times."""
    S, got, want = ranks
    for g in got:
        assert float(g["margin"]) == pytest.approx(float(want["margin"]))
    assert float(want["margin"]) > 1.6


def _columns_within(ranks, prefix, names):
    S, got, want = ranks
    rel = {k: _rel(*_rows(got, want, S, prefix + k)) for k in names}
    print(f"{S} ranks: {rel}")
    bad = {k: v for k, v in rel.items() if not v <= TOL}
    assert not bad, bad


@pytest.mark.parametrize("names", [
    ("hsml", "numngb", "dt_hsml"),
    ("density", "egy_wt_density", "dhsml_density_factor",
     "dhsml_egy_factor"),
    ("div_vel", "curl_vel")], ids=["hsml", "density", "velocity"])
def test_sharded_density_matches_jax(ranks, names):
    """The density's outputs of the gas rows, each within 1e-5 by norm of
    the JAX package's."""
    _columns_within(ranks, "dens_", names)


@pytest.mark.parametrize("names", [("hydro_accel", "dt_entropy"),
                                   ("max_signal_vel", "pressure")],
                         ids=["forces", "signal"])
def test_sharded_hydro_matches_jax(ranks, names):
    """The hydro force's outputs of the gas rows, each within 1e-5 by norm
    of the JAX package's."""
    _columns_within(ranks, "hydro_", names)


def _partition(labels, pids):
    groups = {}
    for lab, p in zip(labels, pids):
        if lab >= 0:
            groups.setdefault(int(lab), set()).add(int(p))
    return {frozenset(g) for g in groups.values()}


def test_fof_secondaries_match_jax_and_single_device(ranks):
    """Gas and stars join the group of their nearest dark-matter particle:
    the same groups, members by type included, as the JAX package's
    sharded FOF and the port's single-device catalogue."""
    from mpgadget_tpu_torch.physics.fof import FOFParams, fof_catalog
    S, got, want = ranks
    pid = np.concatenate([g["pid"] for g in got])
    lab = np.concatenate([g["fof_label"] for g in got])
    wpid = np.concatenate([want[f"pid_r{r}"] for r in range(S)])
    wlab = np.concatenate([want[f"fof_label_r{r}"] for r in range(S)])
    part = _partition(lab, pid)
    assert part == _partition(wlab, wpid)
    g0 = got[0]
    for k in ("lengths", "len_by_type"):
        np.testing.assert_array_equal(g0[f"fof_{k}"], want[f"fof_{k}"])
    for k in ("masses", "mass_by_type"):
        np.testing.assert_allclose(g0[f"fof_{k}"], want[f"fof_{k}"],
                                   rtol=1e-6)
    lbt = g0["fof_len_by_type"]
    assert lbt[:, 0].sum() > 0 and lbt[:, 4].sum() > 0
    # the single-device catalogue of the same particles
    d = W.gas_module_inputs()
    cat = fof_catalog(torch.as_tensor(d["ipos"]).to(torch.int64),
                      torch.as_tensor(d["vel"]), torch.as_tensor(d["mass"]),
                      torch.as_tensor(d["ptype"]),
                      torch.ones(W.N, dtype=torch.bool), W.BOX,
                      W.BOX / np.cbrt(int((d["ptype"] == 1).sum())),
                      FOFParams(linking_length=W.FOF_LL,
                                min_group_length=W.FOF_MIN))
    np.testing.assert_array_equal(np.sort(cat["lengths"]),
                                  np.sort(g0["fof_lengths"]))
    o1 = np.lexsort(cat["len_by_type"].T)
    o2 = np.lexsort(g0["fof_len_by_type"].T)
    np.testing.assert_array_equal(cat["len_by_type"][o1],
                                  g0["fof_len_by_type"][o2])


# ---- elementwise: both packages in this process ----------------------------

def _entropy_inputs(seed=3):
    rng = np.random.RandomState(seed)
    n = 4096
    ent = (10.0 ** rng.uniform(-2, 2, n)).astype(np.float32)
    return dict(entropy=ent,
                dtent=(ent * rng.uniform(-2, 1, n)).astype(np.float32),
                density=(10.0 ** rng.uniform(-10, -6, n)).astype(np.float32),
                gas=rng.rand(n) < 0.8,
                dloga=(0.02 * rng.rand(n)).astype(np.float32))


@pytest.mark.parametrize("per_row", [False, True])
def test_entropy_update_matches_jax(per_row):
    """The half kick's entropy integration with the MinGasTemp floor and
    the halving limiter, with one dloga and with one a row."""
    import jax.numpy as jnp
    from mpgadget_tpu.parallel.driver import _entropy_update as jax_upd
    from mpgadget_tpu_torch.parallel.driver import _entropy_update
    d = _entropy_inputs()
    dl = d["dloga"] if per_row else np.float32(0.013)
    min_egy, atime = 3.5e-4, np.float32(0.1)
    want = np.asarray(jax_upd(jnp.asarray(d["entropy"]),
                              jnp.asarray(d["dtent"]), jnp.asarray(dl),
                              jnp.asarray(d["density"]), min_egy, atime,
                              jnp.asarray(d["gas"])))
    got = _entropy_update(
        torch.as_tensor(d["entropy"]), torch.as_tensor(d["dtent"]),
        torch.as_tensor(dl) if per_row else float(dl),
        torch.as_tensor(d["density"]), min_egy, float(atime),
        torch.as_tensor(d["gas"])).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7)
    assert (got[~d["gas"]] == d["entropy"][~d["gas"]]).all()
    floor = got[d["gas"]] > d["entropy"][d["gas"]] + \
        d["dtent"][d["gas"]] * (dl[d["gas"]] if per_row else dl)
    assert floor.any()


def _spawn_inputs(n=64, nfree=24, seed=5):
    """A state of n gas rows (and, for the JAX package, nfree free rows
    after them), with some rows forming stars: converted whole or
    spawning a new star."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.rand(*s).astype(np.float32)
    st = {"ipos": rng.randint(0, 2 ** 32, (n, 3)).astype(np.int64),
          "vel": f(n, 3), "mass": 1.0 + f(n), "pid": np.arange(n) + 100,
          "ptype": np.zeros(n, np.int32), "gas_mask": np.ones(n, bool),
          "hsml": f(n), "dt_hsml": f(n), "amag": f(n), "grav_acc": f(n, 3),
          "pm_acc": f(n, 3), "bins": rng.randint(1, 8, n).astype(np.int32),
          "dtent": f(n), "density": f(n), "entropy": f(n), "ne": f(n),
          "metallicity": f(n), "sfr": f(n), "delay_time": f(n),
          "formation_time": np.zeros(n, np.float32),
          "birth_density": np.zeros(n, np.float32),
          "birth_metallicity": np.zeros(n, np.float32)}
    make = rng.rand(n) < 0.4
    convert = make & (rng.rand(n) < 0.5)
    star_mass = (0.3 * f(n)).astype(np.float32)
    return st, make, convert, star_mass


def test_spawn_rows_match_jax():
    """Whole conversions flip in place; partial ones put a new star (pid +
    2^40, the parent's position, velocity, kernel and bin, the birth
    record) after the rows, in row order, as the JAX package's spawning
    fills its free rows; the gas keeps its mass less the star's."""
    import jax.numpy as jnp
    from mpgadget_tpu.parallel.driver import spawn_rows as jax_spawn
    from mpgadget_tpu_torch.parallel.driver import spawn_rows
    st, make, convert, star_mass = _spawn_inputs()
    n, nfree = st["mass"].shape[0], 24
    pad = {k: np.concatenate([v, np.zeros((nfree,) + v.shape[1:], v.dtype)])
           for k, v in st.items()}
    pad["valid"] = np.arange(n + nfree) < n
    padb = lambda a: np.concatenate([a, np.zeros(nfree, a.dtype)])
    jst = {k: jnp.asarray(v) for k, v in pad.items()}
    jst, _, nsp, ovf = jax_spawn(jst, jnp.asarray(pad["gas_mask"]),
                                 jnp.asarray(padb(make)),
                                 jnp.asarray(padb(convert)),
                                 jnp.asarray(padb(star_mass)), 0.1)
    assert not bool(ovf)
    v = np.asarray(jst["valid"])
    got, nsp_t = spawn_rows({k: torch.as_tensor(x) for k, x in st.items()},
                            torch.as_tensor(make), torch.as_tensor(convert),
                            torch.as_tensor(star_mass), 0.1)
    assert nsp_t == int(nsp) == int((make & ~convert).sum()) > 0
    assert set(got) == set(st)
    for k in st:
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(jst[k])[v], err_msg=k)


# ---- the JAX record --------------------------------------------------------

def jax_gas_module_record(S):
    """The JAX package's side of the sharded gas cases at S shards."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from mpgadget_tpu.parallel.decomp import exchange_to_slabs
    from mpgadget_tpu.parallel.fof import sharded_fof
    from mpgadget_tpu.parallel.mesh import shard_particles
    from mpgadget_tpu.parallel.sph import (density_caps, sharded_hydro,
                                           sharded_sph_density)
    from mpgadget_tpu.physics.fof import FOFParams
    from mpgadget_tpu.sph.density import DensityParams
    from mpgadget_tpu.sph.hydra import HydroParams
    from mpgadget_tpu.sph.kernels import CUBIC

    mesh = Mesh(np.array(jax.devices("cpu")[:S]), ("x",))
    log2s = int(np.log2(S))
    n_local = W.n_local_of(S)
    npad = n_local * S
    d = W.gas_module_inputs()
    keys = ("ipos", "pid", "mass", "vel", "ptype", "hsml", "entvar")

    def pad(a):
        return np.concatenate([a, np.zeros((npad - len(a),) + a.shape[1:],
                                           a.dtype)])

    sh = shard_particles(dict({k: pad(d[k]) for k in keys},
                              valid=pad(np.ones(W.N, bool))), mesh, axis="x")

    def exch(b, v, *cols):
        out, v2, ovf = exchange_to_slabs(cols, cols[0], v, "x", log2s,
                                         n_local)
        return (*out, v2, jax.lax.psum(ovf.astype(jnp.int32), "x"))

    ex = jax.jit(shard_map(
        lambda v, *c: exch(None, v, *c), mesh=mesh,
        in_specs=(P("x"),) * 8, out_specs=(P("x"),) * 8 + (P(),)))(
        sh["valid"], *(sh[k] for k in keys))
    assert not int(ex[-1])
    e = dict(zip(keys, ex[:7]))
    ev = ex[7]
    nl = int(e["ipos"].shape[0]) // S
    gas = ev & (e["ptype"] == 0)
    rec = {}

    def split(a):
        a, v = np.asarray(a), np.asarray(ev)
        return [a[r * nl:(r + 1) * nl][v[r * nl:(r + 1) * nl]]
                for r in range(S)]

    for r, p in enumerate(split(e["pid"])):
        rec[f"pid_r{r}"] = p
    for r, p in enumerate(split(e["ptype"])):
        rec[f"ptype_r{r}"] = p
    hops = max(S // 2, 1)
    nstrips = 2 * hops - (1 if (2 * hops) % S == 0 else 0)
    dpar = DensityParams(kernel_type=CUBIC)
    caps = density_caps(nl * (1 + nstrips), dpar)
    margin = 1.6
    while True:
        fn = sharded_sph_density(mesh, n_local=nl, ghost_cap=nl, par=dpar,
                                 boxsize=W.BOX, log2s=log2s, caps=caps,
                                 margin=margin, hops=hops)
        dens, fl = fn(e["ipos"], e["vel"], e["mass"], gas, e["hsml"],
                      e["entvar"])
        assert not any(int(fl[k]) for k in ("group", "pack", "pair",
                                             "ghost")), fl
        if not int(fl["strip"]):
            break
        margin *= 1.5
    rec["margin"] = np.float64(margin)
    for k, v in dens.items():
        for r, p in enumerate(split(v)):
            rec[f"dens_{k}_r{r}"] = p
    hfn = sharded_hydro(mesh, n_local=nl, ghost_cap=nl,
                        par=HydroParams(kernel_type=CUBIC), boxsize=W.BOX,
                        log2s=log2s, caps=caps, hops=hops)
    hyd, fl = hfn(e["ipos"], e["vel"], e["mass"], gas, dens["hsml"],
                  e["entvar"], dens["density"], dens["egy_wt_density"],
                  dens["div_vel"], dens["curl_vel"],
                  dens["dhsml_egy_factor"], jnp.float32(W.GAS_ATIME),
                  jnp.float32(W.GAS_HUBBLE), jnp.float32(W.GAS_DLOGA))
    assert not any(int(v) for v in fl.values()), fl
    for k, v in hyd.items():
        for r, p in enumerate(split(v)):
            rec[f"hydro_{k}_r{r}"] = p
    params = FOFParams(linking_length=W.FOF_LL, min_group_length=W.FOF_MIN)
    geo = (np.arange(S, dtype=np.uint64) * (2 ** 32 // S)).astype(np.uint32)
    cat, sorted_labels, _, labels = sharded_fof(
        mesh, {"ipos": e["ipos"], "vel": e["vel"], "mass": e["mass"],
               "ptype": e["ptype"], "valid": ev}, geo, boxsize=W.BOX,
        mean_sep=W.BOX / np.cbrt(int((d["ptype"] == 1).sum())),
        n_local=nl, params=params)
    for r, p in enumerate(split(labels)):
        rec[f"fof_label_r{r}"] = p
    for k in ("lengths", "masses", "len_by_type", "mass_by_type"):
        rec[f"fof_{k}"] = np.asarray(cat[k])
    return rec


@pytest.mark.slow
def test_jax_gas_module_record():
    """Computes the JAX side anew and holds the committed record to it
    (or, with MPG_WRITE_SHARDED_FIXTURE=1, writes it)."""
    new = {}
    for S in RANKS:
        for k, v in jax_gas_module_record(S).items():
            new[f"S{S}_{k}"] = np.asarray(v)
    if os.environ.get("MPG_WRITE_SHARDED_FIXTURE") == "1":
        RECORD.parent.mkdir(exist_ok=True)
        np.savez_compressed(RECORD, **new)
    rec = np.load(RECORD)
    assert sorted(rec.files) == sorted(new)
    for k, v in new.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(rec[k], v, rtol=1e-6, atol=1e-12,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(rec[k], v, err_msg=k)
