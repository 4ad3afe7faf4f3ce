"""The port's sharded options against the JAX package's, at 2 and 4 ranks:
the PM with the neutrino table and the power bins, the sharded
measure_power, the light cone's crossers, the lensing planes, QSO bubbles
and the excursion set over ranks.

The port's side runs as gloo ranks on the CPU, spawned once per rank count
(tests/_torch_sharded_worker.py: option_module_cases).  The JAX side is the
JAX package's functions at the same shard count on the host devices of
tests/conftest.py (pm_force_multi and build_sharded_cross in shard_map,
place_bubbles and calculate_uvbg on row-sharded arrays) and, where the
port's sharded function stands for a single-device one, the JAX package's
single-device function (measure_power, the planes' host path).  What the
cases compare against is the committed record
``torch_sharded/jax_options_modules.npz``, which the slow test
``test_jax_options_module_record`` computes anew and checks (with
MPG_WRITE_SHARDED_FIXTURE=1 it writes it anew):

    MPG_WRITE_SHARDED_FIXTURE=1 python -m pytest -m slow \\
        tests/test_torch_sharded_options.py

Both sides start each case from the same per-rank rows (the padded shards
of the JAX side, the port's shard_particles of them).
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_sharded_worker as W

RECORD = Path(__file__).resolve().parent / "torch_sharded" / \
    "jax_options_modules.npz"
RANKS = (2, 4)
# Each tolerance is about three to five times what was measured on these
# inputs at 2 and 4 ranks (CHANGES.md):
# - the PM force with the neutrino table, |a_port - a_jax| / |a_jax| over
#   all rows (Frobenius norms; measured 1.5e-7), and the power bins by norm
#   (7.9e-7) against the JAX package's pm_force_multi: float32 sums in
#   another order;
FORCE_RTOL = 5e-7
POWER_RTOL = 3e-6
# - the sharded measure_power against the JAX package's single-device one
#   (9.5e-7);
MEASURE_RTOL = 3e-6
# - the light cone's crossing positions: the same float32 arithmetic
#   (2.0e-7: two ulps at most);
LC_RTOL = 1e-6
# - the planes against the JAX package's write_planes: max |diff| / max
#   |ref| (3.2e-7);
PLANE_RTOL = 1e-6
# - the QSO bubbles' entropies, float32 elementwise (2.0e-7);
ENTROPY_RTOL = 1e-6
# - the excursion set's J21 grid and the rows' J21, by norm (2.0e-7):
#   float32 deposits summed in another order, float32 FFTs;
J21_RTOL = 1e-6
# - the mass-weighted global xHI (2.3e-5).  The xHI grid itself is not
#   compared cell by cell: most of this sparse box's cells are empty, and
#   there f_coll is a ratio of two float32 noise values, which decides
#   their ionization either way in either package (2.9% of the cells
#   differ; the volume-weighted xHI by 0.019);
XHI_RTOL = 1e-4
# - a row that either package reionizes (J21 > 0) with a J21 above this
#   fraction of the largest, the other reionizes too; below it lie the J21
#   of nearly empty cells, whose ionization float32 noise decides (33 of
#   1152 rows differ, all below 5.0e-7 of the largest).
J21_FLOOR = 1e-6


@pytest.fixture(scope="module", params=RANKS, ids=lambda s: f"{s}ranks")
def ranks(request, tmp_path_factory):
    """(S, per-rank results of option_module_cases, the JAX record of S,
    the spawn's output directory)."""
    S = request.param
    out = tmp_path_factory.mktemp(f"opt{S}")
    W.spawn(W.option_module_cases, S, str(out))
    got = [dict(np.load(out / f"opt_r{r}.npz")) for r in range(S)]
    rec = np.load(RECORD)
    want = {k[len(f"S{S}_"):]: rec[k] for k in rec.files
            if k.startswith(f"S{S}_")}
    return S, got, want, out


def rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-300))


def by_pid(got, key, pid_key):
    pid = np.concatenate([g[pid_key] for g in got])
    val = np.concatenate([g[key] for g in got])
    o = np.argsort(pid)
    return pid[o], val[o]


def test_pm_with_neutrino_table_matches_jax(ranks):
    S, got, want, _ = ranks
    pid, acc = by_pid(got, "pm_acc", "pm_pid")
    o = np.argsort(want["pm_pid"])
    np.testing.assert_array_equal(pid, want["pm_pid"][o])
    assert rel(acc, want["pm_acc"][o]) < FORCE_RTOL


def test_pm_power_bins_match_jax(ranks):
    """The bins summed over ranks: each rank ends with the same sums."""
    S, got, want, _ = ranks
    for g in got:
        for k in ("p", "n", "k"):
            np.testing.assert_array_equal(g[f"pm_pk_{k}"],
                                          got[0][f"pm_pk_{k}"])
            assert rel(g[f"pm_pk_{k}"], want[f"pm_pk_{k}"]) < POWER_RTOL, k
        np.testing.assert_allclose(g["pm_pk_norm"], want["pm_pk_norm"],
                                   rtol=POWER_RTOL)
    assert (got[0]["pm_pk_n"] > 0).sum() > 20


def test_sharded_measure_power_matches_single_device_jax(ranks):
    from mpgadget_tpu_torch.pm.gravity import PMConfig, _finalize_power
    S, got, want, _ = ranks
    ps = _finalize_power(got[0]["mp_p"], got[0]["mp_n"], got[0]["mp_k"],
                         float(got[0]["mp_norm"]),
                         PMConfig(nmesh=W.NMESH_PM, boxsize=W.BOX))
    np.testing.assert_array_equal(ps.nmodes, want["mp_nmodes"])
    assert rel(ps.k, want["mp_k"]) < MEASURE_RTOL
    assert rel(ps.power, want["mp_power"]) < MEASURE_RTOL


def test_lightcone_crossers_match_build_sharded_cross(ranks):
    """Each rank's crossers of each replica: the same rows, in row order,
    as the JAX package's shard of the same rows."""
    S, got, want, _ = ranks
    nrep = int(got[0]["lc_nrep"])
    assert nrep == int(want["lc_nrep"]) > 1
    total = 0
    for r, g in enumerate(got):
        for i in range(nrep):
            a, b = g[f"lc_rows_{i}"], want[f"lc_rows_{i}_r{r}"]
            assert a.shape == b.shape, (r, i, a.shape, b.shape)
            np.testing.assert_allclose(a, b, rtol=LC_RTOL)
            total += len(a)
    assert total > 50


def test_planes_byte_identical_to_host_path(ranks):
    S, _, _, out = ranks
    host = sorted((out / "planes" / "host").glob("*.fits"))
    sharded = sorted((out / "planes" / "sharded").glob("*.fits"))
    assert len(host) == 3 * 4 and [p.name for p in host] == \
        [p.name for p in sharded]
    for a, b in zip(host, sharded):
        assert a.read_bytes() == b.read_bytes(), a.name


def test_planes_match_jax_write_planes(ranks):
    from mpgadget_tpu_torch.io.fits import read_fits_image
    S, _, _, out = ranks
    rec = np.load(RECORD)
    files = sorted((out / "planes" / "sharded").glob("*.fits"))
    for f in files:
        data, hdr = read_fits_image(str(f))
        ref = rec[f"planes_{f.stem}"]
        assert int(hdr["NPART"]) == int(rec[f"planes_{f.stem}_npart"])
        err = np.abs(data - ref).max() / np.abs(ref).max()
        assert err < PLANE_RTOL, (f.name, err)


def test_qso_bubbles_over_ranks_match_jax(ranks):
    """The same ionized IDs, bubbles and helium.txt lines as the JAX
    package's place_bubbles on the rows sharded over S devices."""
    S, got, want, out = ranks
    pid, ion = by_pid(got, "qso_ionized", "qso_pid")
    _, ent = by_pid(got, "qso_entropy", "qso_pid")
    np.testing.assert_array_equal(pid, want["qso_pid"])
    np.testing.assert_array_equal(pid[ion], pid[want["qso_ionized"]])
    assert ion.sum() > 40
    np.testing.assert_allclose(ent, want["qso_entropy"], rtol=ENTROPY_RTOL)
    assert all(int(g["qso_nbub"]) == int(want["qso_nbub"]) > 1 for g in got)
    lines = (out / "qso" / "helium.txt").read_text().splitlines()
    assert lines == want["qso_helium"].tolist()


def test_excursion_set_over_ranks_matches_jax(ranks):
    """The J21 grid (the same on every rank), the mass-weighted xHI and
    the rows that the readout reionizes (J21 > 0: zreion set) against the
    JAX package's calculate_uvbg on the rows sharded over S devices."""
    S, got, want, _ = ranks
    for g in got:
        np.testing.assert_array_equal(g["uvbg_j21"], got[0]["uvbg_j21"])
    j21 = got[0]["uvbg_j21"]
    assert (j21 > 0).any() and (j21 == 0).any()
    assert rel(j21, want["uvbg_j21"]) < J21_RTOL
    np.testing.assert_allclose(float(got[0]["uvbg_mass"]),
                               float(want["uvbg_mass"]), rtol=XHI_RTOL)
    pid, j21_rows = by_pid(got, "uvbg_j21_rows", "uvbg_pid")
    np.testing.assert_array_equal(pid, want["uvbg_pid"])
    w = want["uvbg_j21_rows"]
    floor = J21_FLOOR * w.max()
    lit, lit_jax = j21_rows > 0, w > 0
    assert lit_jax[j21_rows > floor].all() and lit[w > floor].all()
    assert (np.maximum(j21_rows, w)[lit != lit_jax] <= floor).all()
    assert (lit == lit_jax).sum() > 0.9 * len(pid) and lit.sum() > 500
    assert rel(j21_rows, w) < J21_RTOL


# ---- the JAX record ------------------------------------------------------

def jax_options_record(S, tmp):
    """The JAX package's side of every option case at S shards."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from mpgadget_tpu.parallel.decomp import (exchange_to_slabs,
                                              count_histogram,
                                              balanced_boundaries)
    from mpgadget_tpu.parallel.driver import pm_force_multi
    from mpgadget_tpu.parallel.mesh import shard_particles
    from mpgadget_tpu.physics import qso_lightup as qmod
    from mpgadget_tpu.physics import uvbg as umod
    from mpgadget_tpu.physics.lightcone import build_sharded_cross
    from mpgadget_tpu.pm.gravity import PMConfig, measure_power

    mesh = Mesh(np.array(jax.devices("cpu")[:S]), ("x",))
    rows = NamedSharding(mesh, P("x"))
    rec = {}

    def split(a, v):
        a, v = np.asarray(a), np.asarray(v)
        per = a.shape[0] // S
        return [a[r * per:(r + 1) * per][v[r * per:(r + 1) * per]]
                for r in range(S)]

    # ---- PM with the neutrino table and the power bins ----
    n_local = W.n_local_of(S)
    npad = n_local * S
    d = W.module_inputs()

    def pad(a, fill=0):
        return np.concatenate([a, np.full((npad - len(a),) + a.shape[1:],
                                          fill, a.dtype)])

    arrays = {k: pad(d[k]) for k in ("ipos", "pid", "mass")}
    valid = pad(np.ones(W.N, bool), False)
    sh = shard_particles(dict(arrays, valid=valid), mesh, axis="x")
    hist = np.asarray(jax.jit(shard_map(
        lambda ip, v: count_histogram(ip, v, "x"), mesh=mesh,
        in_specs=(P("x"), P("x")), out_specs=P()))(sh["ipos"],
                                                   sh["valid"]))
    bounds = jnp.asarray(balanced_boundaries(hist, S))

    def exch(ip, pid, m, v, b):
        (ip, pid, m), v2, ovf = exchange_to_slabs(
            (ip, pid, m), ip, v, "x", int(np.log2(S)), n_local,
            boundaries=b)
        return ip, pid, m, v2, jax.lax.psum(ovf.astype(jnp.int32), "x")

    e_ip, e_pid, e_m, e_v, ovf = jax.jit(shard_map(
        exch, mesh=mesh, in_specs=(P("x"),) * 4 + (P(),),
        out_specs=(P("x"),) * 4 + (P(),)))(
        sh["ipos"], sh["pid"], sh["mass"], sh["valid"], bounds)
    assert not int(ovf)
    logk, fac = (jnp.asarray(a) for a in W.nu_table())
    hops = W.pm_hops(np.asarray(bounds))
    acc, pk = jax.jit(shard_map(
        lambda ip, m, v, lk, fc: pm_force_multi(
            ip, jnp.where(v, m, 0.0), W.NMESH_PM, W.BOX, W.G, W.ASMTH, "x",
            hops, nu_logk=lk, nu_fac=fc, nbins=W.NMESH_PM),
        mesh=mesh, in_specs=(P("x"),) * 3 + (P(), P()),
        out_specs=(P("x"), (P(), P(), P(), P())),
        check_vma=False))(e_ip, e_m, e_v, logk, fac)
    rec["pm_acc"] = np.concatenate(split(acc, e_v))
    rec["pm_pid"] = np.concatenate(split(e_pid, e_v))
    for k, v in zip(("p", "n", "k", "norm"), pk):
        rec[f"pm_pk_{k}"] = np.asarray(v, np.float64)
    ps = measure_power(jnp.asarray(d["ipos"]), jnp.asarray(d["mass"]),
                       PMConfig(nmesh=W.NMESH_PM, boxsize=W.BOX))
    rec["mp_k"], rec["mp_power"] = np.asarray(ps.k), np.asarray(ps.power)
    rec["mp_nmodes"] = np.asarray(ps.nmodes)

    # ---- the light cone's crossers per shard ----
    d = W.lightcone_module_inputs()
    n = len(d["pid"])
    sub = {k: jax.device_put(jnp.asarray(d[k]), rows)
           for k in ("ipos", "vel", "pid", "ptype")}
    sub["valid"] = jax.device_put(jnp.ones(n, bool), rows)
    lc, reps, ddrift = W.lightcone_shell("mpgadget_tpu", tmp / f"lc{S}")
    cross = build_sharded_cross(mesh, cap=n // S)
    rec["lc_nrep"] = np.int64(len(reps))
    for i, rep in enumerate(reps):
        scal = {"off": jnp.zeros(3, jnp.uint32),
                "box": jnp.float32(W.LC_BOX),
                "ddrift": jnp.float32(ddrift),
                "hd_prev2": jnp.float32(lc.hd_prev2),
                "hd2": jnp.float32(lc.hd2),
                "hd_prev": jnp.float32(lc.hd_prev), "hd": jnp.float32(lc.hd),
                "samplefrac": jnp.float32(lc.sample_fraction),
                "rep": jnp.asarray(rep, jnp.float32)}
        p3, ok, ovf = cross(sub, scal)
        assert not int(ovf)
        for r, x in enumerate(split(p3, ok)):
            rec[f"lc_rows_{i}_r{r}"] = x.astype(np.float64)

    # ---- QSO bubbles on the sharded rows ----
    d = W.qso_inputs()
    hist_path = tmp / f"heii{S}.txt"
    W.write_heii_hist(hist_path)
    hist = qmod.load_heii_reion_hist(str(hist_path))
    par = qmod.QSOParams(heiii_start=hist.zstart, **W.QSO_PARAMS
                         ).with_units(W.option_units(
                             "mpgadget_tpu").UnitInternalEnergy_in_cgs)
    qdir = tmp / f"qso{S}"
    qdir.mkdir()

    def put(a):
        return jax.device_put(jnp.asarray(a), rows)

    ion, ent, nbub = qmod.place_bubbles(
        put(d["ipos"]), put(d["gas"]), put(d["ionized"]), put(d["density"]),
        put(d["entropy"]), W.QSO_CAT, hist, par, W.QSO_ATIME, W.AUX_BOX, 42,
        str(qdir), write=True)
    rec["qso_pid"] = d["pid"]
    rec["qso_ionized"] = np.asarray(ion)
    rec["qso_entropy"] = np.asarray(ent)
    rec["qso_nbub"] = np.int64(nbub)
    rec["qso_helium"] = np.array((qdir / "helium.txt").read_text()
                                 .splitlines(), dtype=str)

    # ---- the excursion set on the sharded rows ----
    par, cp, units, halo_mass, sfr = W.uvbg_case("mpgadget_tpu")
    fesc = umod.escape_fractions(put(halo_mass), par.escape_frac_norm,
                                 par.escape_frac_scaling,
                                 units.UnitMass_in_g, cp.HubbleParam)
    res = umod.calculate_uvbg(
        put(d["ipos"]), put(d["mass"]), put(np.ones(len(d["pid"]), bool)),
        put(d["gas"]), put(d["ptype"] == 4), put(sfr), fesc, par, cp,
        units, W.AUX_BOX, 0.1)
    rec["uvbg_j21"] = np.asarray(res["j21"])
    rec["uvbg_xhi"] = np.asarray(res["xhi"])
    rec["uvbg_vol"] = np.float64(res["volume_weighted_global_xHI"])
    rec["uvbg_mass"] = np.float64(res["mass_weighted_global_xHI"])
    rec["uvbg_pid"] = d["pid"]
    rec["uvbg_j21_rows"] = np.asarray(umod.readout_j21_max(
        res["j21"], put(d["ipos"])))
    return rec


def jax_planes_record(tmp):
    """The JAX package's write_planes (its host path) of module_inputs."""
    from mpgadget_tpu.io.fits import read_fits_image
    from mpgadget_tpu.physics.plane import write_planes
    d = W.module_inputs()
    out = tmp / "jax_planes"
    out.mkdir()
    write_planes(W.plane_sim("mpgadget_tpu", d["ipos"], out), 0,
                 W.plane_params("mpgadget_tpu"))
    rec = {}
    for f in sorted(out.glob("*.fits")):
        data, hdr = read_fits_image(str(f))
        rec[f"planes_{f.stem}"] = np.asarray(data, np.float64)
        rec[f"planes_{f.stem}_npart"] = np.int64(hdr["NPART"])
    return rec


@pytest.mark.slow
def test_jax_options_module_record(tmp_path):
    """Computes the JAX side anew and holds the committed record to it
    (or, with MPG_WRITE_SHARDED_FIXTURE=1, writes it)."""
    new = jax_planes_record(tmp_path)
    for S in RANKS:
        for k, v in jax_options_record(S, tmp_path).items():
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
