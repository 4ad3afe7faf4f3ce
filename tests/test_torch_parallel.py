"""The port's parallel/ modules against the JAX package's, at 2 and 4 ranks.

The port's side runs as gloo ranks on the CPU, spawned once per rank count
(tests/_torch_sharded_worker.py: module_cases, every case in one spawn).
The JAX side is the JAX package's shard_map functions at the same shard
count on the host devices of tests/conftest.py; since those take minutes
to compile on the CPU, what the cases compare against is the committed
record ``torch_sharded/jax_modules.npz``, which the slow test
``test_jax_module_record`` computes anew and checks (with
MPG_WRITE_SHARDED_FIXTURE=1 it writes it anew):

    MPG_WRITE_SHARDED_FIXTURE=1 python -m pytest -m slow \\
        tests/test_torch_parallel.py

Both sides start each case from the same per-shard rows: the JAX side's
padded shards of ``module_inputs`` and the port's ``shard_particles`` of
them (positions uint32 there, int64 here).
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_sharded_worker as W

RECORD = Path(__file__).resolve().parent / "torch_sharded" / \
    "jax_modules.npz"
RANKS = (2, 4)
# forces: |a_port - a_jax| / |a_jax| over all rows (Frobenius norms)
FORCE_RTOL = 1e-5


@pytest.fixture(scope="module", params=RANKS, ids=lambda s: f"{s}ranks")
def ranks(request, tmp_path_factory):
    """(S, per-rank results of module_cases, the JAX record of S)."""
    S = request.param
    out = tmp_path_factory.mktemp(f"mod{S}")
    W.spawn(W.module_cases, S, str(out))
    got = [dict(np.load(out / f"mod_r{r}.npz")) for r in range(S)]
    rec = np.load(RECORD)
    want = {k[len(f"S{S}_"):]: rec[k] for k in rec.files
            if k.startswith(f"S{S}_")}
    return S, got, want


def per_rank(want, name, S):
    return [want[f"{name}_r{r}"] for r in range(S)]


def test_pencil_fft_roundtrip_matches_rfftn(ranks):
    S, got, _ = ranks
    vol = np.random.RandomState(0).randn(16, 16, 16).astype(np.float32)
    ref = torch.fft.rfftn(torch.tensor(vol)).numpy()
    pencil = np.concatenate([g["pencil"] for g in got], axis=1)
    pencil = pencil[..., 0] + 1j * pencil[..., 1]
    np.testing.assert_allclose(pencil, ref, rtol=1e-4, atol=1e-4)
    back = np.concatenate([g["pencil_back"] for g in got], axis=0)
    np.testing.assert_allclose(back, vol, rtol=1e-4, atol=1e-5)


def test_balanced_boundaries_bit_for_bit(ranks):
    from mpgadget_tpu.parallel.decomp import balanced_boundaries as jax_bb
    S, got, want = ranks
    for g in got:
        np.testing.assert_array_equal(g["hist"], want["hist"])
        np.testing.assert_array_equal(g["bounds"], want["bounds"])
        np.testing.assert_array_equal(g["bounds"],
                                      jax_bb(g["hist"], S))
    # the port's copy of the host function, on the same histogram
    from mpgadget_tpu_torch.parallel.decomp import balanced_boundaries
    np.testing.assert_array_equal(balanced_boundaries(want["hist"], S),
                                  jax_bb(want["hist"], S))


def test_exchange_rows_identical(ranks):
    S, got, want = ranks
    for r, (g, w) in enumerate(zip(got, per_rank(want, "exchange_pid", S))):
        np.testing.assert_array_equal(g["exchange_pid"], w, err_msg=f"{r}")
    assert sum(len(g["exchange_pid"]) for g in got) == W.N


@pytest.mark.parametrize("name", ["ghost", "wide"])
def test_ghost_rows_identical(ranks, name):
    S, got, want = ranks
    for r, (g, w) in enumerate(zip(got, per_rank(want, f"{name}_pid", S))):
        np.testing.assert_array_equal(g[f"{name}_pid"], w, err_msg=f"{r}")
    assert int(got[0][f"{name}_hops"]) == int(want[f"{name}_hops"])
    if name == "wide" and S == 4:
        assert int(want["wide_hops"]) == 2    # strips of more than a slab


def test_sharded_sort_global_order(ranks):
    S, got, want = ranks
    keys = np.concatenate([g["sort_keys"] for g in got])
    np.testing.assert_array_equal(keys, np.sort(W.module_inputs()["keys"]))
    for r, (g, w) in enumerate(zip(got, per_rank(want, "sort_pid", S))):
        np.testing.assert_array_equal(g["sort_pid"], w, err_msg=f"{r}")


def _by_pid(got, acc_key, pid_key):
    pid = np.concatenate([g[pid_key] for g in got])
    acc = np.concatenate([g[acc_key] for g in got])
    out = np.zeros((W.N, 3), np.float64)
    out[pid] = acc
    assert np.array_equal(np.sort(pid), np.arange(W.N))
    return out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("case", ["pm", "tree"])
def test_forces_match_jax(ranks, case):
    S, got, want = ranks
    a = _by_pid(got, f"{case}_acc", f"{case}_pid")
    w = np.zeros((W.N, 3))
    w[want[f"{case}_pid"]] = want[f"{case}_acc"]
    rel = _rel(a, w)
    print(f"{case} force at {S} ranks: {rel:.3e} of the JAX package's")
    assert rel <= FORCE_RTOL, rel


def test_treepm_step_within_single_device_bounds(ranks):
    """The JAX package's own bounds of a sharded force against the
    single-device one (tests/test_parallel.py:263-264): local trees differ
    from the global tree near slab faces."""
    S, got, _ = ranks
    a = _by_pid(got, "tree_acc", "tree_pid")
    ref = got[0]["single_acc"]
    rel = np.linalg.norm(a - ref, axis=1) / (np.linalg.norm(ref, axis=1)
                                              + 1e-8)
    assert np.percentile(rel, 95) < 2e-2, np.percentile(rel, 95)
    assert rel.max() < 0.2, rel.max()


def test_sharded_pm_step_matches_single_device(ranks):
    """mesh.sharded_pm_step (exchange to geometric slabs, the pencil PM)
    against the single-device PM force of the same particles."""
    S, got, _ = ranks
    a = _by_pid(got, "pmstep_acc", "pmstep_pid")
    rel = _rel(a, got[0]["pmstep_single"])
    print(f"PM step at {S} ranks: {rel:.3e} of the single-device force")
    assert rel <= FORCE_RTOL, rel


def _partition(labels, pids):
    """Groups as a set of frozensets of pids (labels < 0: none)."""
    groups = {}
    for lab, p in zip(labels, pids):
        if lab >= 0:
            groups.setdefault(int(lab), set()).add(int(p))
    return {frozenset(g) for g in groups.values()}


def test_fof_membership_matches_jax_and_single_device(ranks):
    from mpgadget_tpu_torch.physics.fof import fof_label
    S, got, want = ranks
    lab = np.concatenate([g["fof_label"] for g in got])
    pid = np.concatenate([g["fof_pid"] for g in got])
    part = _partition(lab, pid)
    assert part == _partition(want["fof_label"], want["fof_pid"])
    # the single-device labels of the same particles
    d = W.module_inputs()
    single, _, _ = fof_label(torch.as_tensor(d["ipos"]).to(torch.int64),
                             torch.ones(W.N, dtype=torch.bool), W.BOX,
                             W.FOF_LL * W.BOX / np.cbrt(W.N))
    assert part == _partition(single.numpy(), d["pid"])
    big = [g for g in part if len(g) >= W.FOF_MIN]
    assert len(big) >= 6
    # the catalogue: the same groups, in the same order
    g0 = got[0]
    np.testing.assert_array_equal(g0["fof_lengths"], want["fof_lengths"])
    np.testing.assert_allclose(g0["fof_masses"], want["fof_masses"],
                               rtol=1e-6)
    np.testing.assert_allclose(g0["fof_cm"], want["fof_cm"], rtol=1e-5)
    for g in got[1:]:
        np.testing.assert_array_equal(g["fof_lengths"], g0["fof_lengths"])


def test_parallel_imports_no_jax_and_one_collectives_module():
    """parallel/, utils/log, the physics modules that the sharded
    driver's options run over ranks and the tools import nothing of JAX,
    and parallel/collectives.py is the only module of the port that names
    torch.distributed."""
    import re
    import subprocess
    import sys
    repo = Path(__file__).resolve().parents[1]
    mods = ["parallel." + m for m in (
        "collectives", "mesh", "decomp", "sort", "pfft", "treepm", "driver",
        "fof", "snapshot", "sph", "winds", "blackhole", "metals")] + [
        "physics." + m for m in ("lightcone", "plane", "qso_lightup", "uvbg",
                                 "neutrinos_lra")] + ["run", "main"] + [
        "tools." + m for m in (
            "hmf_from_fof", "plot_gsmf", "convert_from_gadget_1",
            "convert_hdf5", "compare_snap", "make_class_power",
            "make_HI_reionization_table", "make_yield_tables",
            "check_examples")]
    code = ("import sys; import mpgadget_tpu_torch.utils.log; "
            + "; ".join(f"import mpgadget_tpu_torch.{m}" for m in mods)
            + "; bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'mpgadget_tpu.'))]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    use = re.compile(r"(import|from)\s+torch\.distributed"
                     r"|torch\.distributed\.\w+\(")
    named = sorted(str(p.relative_to(repo))
                   for p in (repo / "mpgadget_tpu_torch").rglob("*.py")
                   if use.search(p.read_text()))
    assert named == ["mpgadget_tpu_torch/parallel/collectives.py"], named


# ---- the JAX record ------------------------------------------------------

def jax_module_record(S):
    """The JAX package's side of every module case at S shards."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from mpgadget_tpu.gravity import treepm as jax_treepm
    from mpgadget_tpu.parallel.decomp import (exchange_to_slabs,
                                              ghost_strips_multi,
                                              count_histogram,
                                              balanced_boundaries)
    from mpgadget_tpu.parallel.driver import pm_force_multi
    from mpgadget_tpu.parallel.fof import sharded_fof
    from mpgadget_tpu.parallel.mesh import shard_particles
    from mpgadget_tpu.parallel.sort import sharded_sort
    from mpgadget_tpu.parallel.treepm import sharded_treepm_step
    from mpgadget_tpu.physics.fof import FOFParams
    from mpgadget_tpu_torch.parallel.driver import ghost_hops

    mesh = Mesh(np.array(jax.devices("cpu")[:S]), ("x",))
    n_local = W.n_local_of(S)
    npad = n_local * S
    d = W.module_inputs()

    def pad(a, fill=0):
        return np.concatenate([a, np.full((npad - len(a),) + a.shape[1:],
                                          fill, a.dtype)])

    arrays = {k: pad(d[k]) for k in ("ipos", "pid", "mass", "vel", "keys")}
    valid = pad(np.ones(W.N, bool), False)
    sh = shard_particles(dict(arrays, valid=valid), mesh, axis="x")
    rec = {}

    def split(a, v):
        a, v = np.asarray(a), np.asarray(v)
        per = a.shape[0] // S
        return [a[r * per:(r + 1) * per][v[r * per:(r + 1) * per]]
                for r in range(S)]

    hist = np.asarray(jax.jit(shard_map(
        lambda ip, v: count_histogram(ip, v, "x"), mesh=mesh,
        in_specs=(P("x"), P("x")), out_specs=P()))(sh["ipos"],
                                                   sh["valid"]))
    bounds = balanced_boundaries(hist, S)
    rec["hist"], rec["bounds"] = hist, bounds
    bdev = jnp.asarray(bounds)

    def exch(ip, pid, m, vel, v, b):
        (ip, pid, m, vel), v2, ovf = exchange_to_slabs(
            (ip, pid, m, vel), ip, v, "x", int(np.log2(S)), n_local,
            boundaries=b)
        return ip, pid, m, vel, v2, jax.lax.psum(ovf.astype(jnp.int32),
                                                 "x")

    ex = jax.jit(shard_map(exch, mesh=mesh, in_specs=(P("x"),) * 5 + (P(),),
                           out_specs=(P("x"),) * 5 + (P(),)))(
        sh["ipos"], sh["pid"], sh["mass"], sh["vel"], sh["valid"], bdev)
    assert not int(ex[5])
    e_ip, e_pid, e_m, e_vel, e_v = ex[:5]
    for r, p in enumerate(split(e_pid, e_v)):
        rec[f"exchange_pid_r{r}"] = p

    for name, width in (("ghost", W.GHOST_WIDTH), ("wide", W.WIDE_WIDTH)):
        hops = ghost_hops(bounds, width)
        rec[f"{name}_hops"] = np.int64(hops)

        def gh(ip, pid, v, b, hops=hops, width=width):
            (g,), gv, ovf = ghost_strips_multi(
                (pid,), ip, v, "x", b, jnp.float32(width), n_local, hops)
            return g, gv, jax.lax.psum(ovf.astype(jnp.int32), "x")

        g, gv, ovf = jax.jit(shard_map(
            gh, mesh=mesh, in_specs=(P("x"),) * 3 + (P(),),
            out_specs=(P("x"), P("x"), P())))(e_ip, e_pid, e_v, bdev)
        assert not int(ovf)
        for r, p in enumerate(split(g, gv)):
            rec[f"{name}_pid_r{r}"] = p

    keys = jnp.asarray(pad(d["keys"]))[e_pid]
    k_s, arr, v_s, ovf = jax.jit(shard_map(
        lambda k, p, v: sharded_sort(k, {"pid": p}, v, "x", n_local),
        mesh=mesh, in_specs=(P("x"),) * 3,
        out_specs=(P("x"), {"pid": P("x")}, P("x"), P())))(
        keys, e_pid, e_v)
    assert not int(ovf)
    for r, p in enumerate(split(arr["pid"], v_s)):
        rec[f"sort_pid_r{r}"] = p

    hops_pm = W.pm_hops(bounds)
    acc, _ = jax.jit(shard_map(
        lambda ip, m, v: pm_force_multi(
            ip, jnp.where(v, m, 0.0), W.NMESH_PM, W.BOX, W.G, W.ASMTH, "x",
            hops_pm), mesh=mesh, in_specs=(P("x"),) * 3,
        out_specs=(P("x"), P())))(e_ip, e_m, e_v)
    rec["pm_acc"] = np.concatenate(split(acc, e_v))
    rec["pm_pid"] = np.concatenate(split(e_pid, e_v))

    tg = W.tree_gravity(jax_treepm)
    kw = tg.force_kwargs(n_local + 2 * max(256, n_local // 2))
    kw["with_potential"] = False
    step = sharded_treepm_step(
        mesh, nmesh=W.NMESH_TREE, boxsize=W.BOX, gconst=W.G,
        asmth=W.ASMTH, rcut=W.RCUT, softening=W.BOX / 50.0,
        err_tol_force_acc=0.002, n_local=n_local, tree_kwargs=kw)
    zero3 = shard_particles(np.zeros((npad, 3), np.float32), mesh,
                            axis="x")
    zero = shard_particles(np.zeros(npad, np.float32), mesh, axis="x")
    ip2, vel2, m2, v2, amag2, pid2, ovf = step(
        sh["ipos"], zero3, sh["mass"], sh["valid"], zero, sh["pid"],
        jnp.float32(1.0), jnp.float32(0.0))
    assert not int(ovf)
    rec["tree_acc"] = np.concatenate(split(vel2, v2))
    rec["tree_pid"] = np.concatenate(split(pid2, v2))

    params = FOFParams(linking_length=W.FOF_LL,
                       min_group_length=W.FOF_MIN)
    fst = {"ipos": e_ip, "vel": e_vel, "mass": e_m, "valid": e_v,
           "ptype": shard_particles(np.ones(npad, np.int32), mesh,
                                    axis="x")}
    cat, sorted_labels, _, labels = sharded_fof(
        mesh, fst, bounds, boxsize=W.BOX, mean_sep=W.BOX / np.cbrt(W.N),
        n_local=n_local, params=params)
    rec["fof_label"] = np.concatenate(split(labels, e_v))
    rec["fof_pid"] = np.concatenate(split(e_pid, e_v))
    rec["fof_lengths"] = np.asarray(cat["lengths"])
    rec["fof_masses"] = np.asarray(cat["masses"])
    rec["fof_cm"] = np.asarray(cat["cm"])
    return rec


@pytest.mark.slow
def test_jax_module_record():
    """Computes the JAX side anew and holds the committed record to it
    (or, with MPG_WRITE_SHARDED_FIXTURE=1, writes it)."""
    new = {}
    for S in RANKS:
        for k, v in jax_module_record(S).items():
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
