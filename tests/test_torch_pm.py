"""Drift/kick, CIC and PM force of the PyTorch port against the JAX
package, on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpgadget_tpu import integrate as jint
from mpgadget_tpu.ops import cic as jcic
from mpgadget_tpu.pm import gravity as jpm
from mpgadget_tpu_torch import integrate as tint
from mpgadget_tpu_torch.ops import cic as tcic
from mpgadget_tpu_torch.pm import gravity as tpm
from mpgadget_tpu_torch.particles import (ParticleData, fixed_to_pos,
                                          pos_to_fixed)

# one intra-op thread: the suite runs in several worker processes that
# share the machine's cores
torch.set_num_threads(1)


def _ipos(n, seed):
    rng = np.random.RandomState(seed)
    ipos = rng.randint(0, 2 ** 32, (n, 3), dtype=np.uint64).astype(np.uint32)
    # rows at the box edges so the drift wraps both ways
    ipos[:4] = [[0, 1, 2], [2 ** 32 - 1, 2 ** 32 - 2, 5],
                [2 ** 31, 2 ** 31 - 1, 0], [7, 2 ** 32 - 3, 2 ** 32 - 1]]
    return ipos


def _t(a):
    """numpy/JAX array -> CPU tensor (uint32 positions -> int64)."""
    a = np.array(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("ddrift,box", [(0.37, 64000.0), (3.1e-3, 1000.0),
                                        (12.5, 250000.0)])
def test_drift_bit_identical(ddrift, box):
    """Bit-identical, wrap at the box edge included, for displacements
    below half the box (the contract of both drifts: the tick increment
    is an int32)."""
    n = 4096
    ipos = _ipos(n, 1)
    rng = np.random.RandomState(2)
    vel = (rng.randn(n, 3) * 300.0).astype(np.float32)
    vel[:4] = [[-900, -800, -700], [900, 800, 700], [1e3, -1e3, -5e2],
               [-3, 4e3, 2e3]]
    jout = np.asarray(jint.drift(jnp.asarray(ipos), jnp.asarray(vel),
                                 ddrift, 1.0 / box))
    tout = tint.drift(_t(ipos), _t(vel), ddrift, 1.0 / box).numpy()
    assert tout.min() >= 0 and tout.max() < 2 ** 32
    np.testing.assert_array_equal(tout, jout.astype(np.int64))


def test_kick_matches_jax():
    rng = np.random.RandomState(3)
    vel = rng.randn(1000, 3).astype(np.float32)
    acc = rng.randn(1000, 3).astype(np.float32)
    jv = np.asarray(jint.kick(jnp.asarray(vel), jnp.asarray(acc), 0.0123))
    tv = tint.kick(_t(vel), _t(acc), 0.0123).numpy()
    # one f32 multiply-add; a fused multiply-add may round once less
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-7)


def test_fixed_point_round_trip_and_from_jax_numpy():
    rng = np.random.RandomState(4)
    box = 64000.0
    pos = rng.uniform(0, box, (100, 3))
    ip = pos_to_fixed(pos, box)
    np.testing.assert_allclose(fixed_to_pos(ip, box), pos, atol=box * 2e-9)
    from mpgadget_tpu.particles import ParticleData as JPD
    jp = JPD.from_numpy(pos, rng.randn(100, 3), np.ones(100),
                        np.ones(100, np.int32), np.arange(100), box,
                        capacity=128)
    arrays = {k: np.asarray(getattr(jp, k))
              for k in ParticleData.__dataclass_fields__}
    tp = ParticleData.from_jax_numpy(arrays, device="cpu")
    tq = ParticleData.from_numpy(pos, rng.randn(100, 3), np.ones(100),
                                 np.ones(100, np.int32), np.arange(100), box,
                                 capacity=128, device="cpu")
    assert tp.capacity == 128 and tp.num_valid == 100
    np.testing.assert_array_equal(tp.ipos.numpy(),
                                  np.asarray(jp.ipos).astype(np.int64))
    np.testing.assert_array_equal(tq.ipos.numpy(), tp.ipos.numpy())
    np.testing.assert_array_equal(tq.valid.numpy(), tp.valid.numpy())
    # the f32 box coordinate of the int64 carrier equals uint32 -> f32
    np.testing.assert_array_equal(
        (tp.ipos.to(torch.float32) * 2.0 ** -32).numpy(),
        np.asarray(jp.ipos).astype(np.float32) * np.float32(2.0 ** -32))


@pytest.mark.parametrize("nmesh", [16, 24])
def test_cic_deposit_and_readout_match_jax(nmesh):
    n = 3000
    ipos = _ipos(n, 5)
    w = np.random.RandomState(6).uniform(0.5, 1.5, n).astype(np.float32)
    jm = np.asarray(jcic.cic_deposit(jnp.asarray(ipos), jnp.asarray(w),
                                     nmesh))
    tm = tcic.cic_deposit(_t(ipos), _t(w), nmesh).numpy()
    # scatter-adds in another order: f32 rounding of the cell sums
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-5)
    assert abs(tm.sum() - w.sum()) < 1e-3 * w.sum()
    meshes = np.random.RandomState(7).randn(nmesh, nmesh, nmesh, 3).astype(
        np.float32)
    jr = np.asarray(jcic.cic_readout_vec(jnp.asarray(meshes),
                                         jnp.asarray(ipos)))
    tr = tcic.cic_readout_vec(_t(meshes), _t(ipos)).numpy()
    np.testing.assert_allclose(tr, jr, rtol=1e-6, atol=1e-6)
    jr1 = np.asarray(jcic.cic_readout(jnp.asarray(meshes[..., 0]),
                                      jnp.asarray(ipos)))
    tr1 = tcic.cic_readout(_t(meshes[..., 0]), _t(ipos)).numpy()
    np.testing.assert_allclose(tr1, jr1, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nmesh,clustered", [(32, False), (32, True),
                                             (24, True)])
def test_pm_force_matches_jax(nmesh, clustered):
    n = 8192
    box = 64000.0
    rng = np.random.RandomState(8)
    pos = rng.uniform(0, box, (n, 3))
    if clustered:
        pos[: n // 2] = np.mod(box / 3 + rng.randn(n // 2, 3) * box * 0.05,
                               box)
    ipos = (pos / box * 2.0 ** 32).astype(np.uint32)
    w = np.full(n, 3.5, np.float32)
    jacc, jpot, (jp, jn, jk, jnorm) = jpm._pm_force_kernel(
        jnp.asarray(ipos), jnp.asarray(w), nmesh, box, 43007.1, 1.5)
    tacc, tpot, (tp, tn, tk, tnorm) = tpm._pm_force_kernel(
        _t(ipos), _t(w), nmesh, box, 43007.1, 1.5)
    jacc, jpot = np.asarray(jacc), np.asarray(jpot)
    # FFT libraries differ (ducc vs pocketfft) and the deposit sums in
    # another order: 1e-5 of the norm
    assert np.linalg.norm(tacc.numpy() - jacc) <= 1e-5 * np.linalg.norm(jacc)
    assert np.linalg.norm(tpot.numpy() - jpot) <= 1e-5 * np.linalg.norm(jpot)
    # identical mode binning; the bin sums agree to f32 accumulation
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    cfg = tpm.PMConfig(nmesh=nmesh, boxsize=box)
    jps = jpm._finalize_power(np.asarray(jp), np.asarray(jn), np.asarray(jk),
                              float(jnorm), cfg)
    tps = tpm._finalize_power(tp.numpy(), tn.numpy(), tk.numpy(), tnorm, cfg)
    np.testing.assert_array_equal(tps.nmodes, jps.nmodes)
    np.testing.assert_allclose(tps.k, jps.k, rtol=1e-5)
    np.testing.assert_allclose(tps.power, jps.power, rtol=1e-5)


def test_pm_force_and_measure_power_entry_points(tmp_path):
    n = 4096
    box = 20000.0
    ipos = _ipos(n, 9)
    w = np.ones(n, np.float32)
    cfg = tpm.PMConfig(nmesh=16, boxsize=box)
    jacc, _, jps = jpm.pm_force(jnp.asarray(ipos), jnp.asarray(w),
                                jpm.PMConfig(nmesh=16, boxsize=box))
    tacc, tpot, tps = tpm.pm_force(_t(ipos), _t(w), cfg)
    assert tpot is not None
    assert np.linalg.norm(tacc.numpy() - np.asarray(jacc)) <= \
        1e-5 * np.linalg.norm(np.asarray(jacc))
    np.testing.assert_allclose(tps.power, jps.power, rtol=1e-5)
    jm = jpm.measure_power(jnp.asarray(ipos), jnp.asarray(w),
                           jpm.PMConfig(nmesh=16, boxsize=box))
    tmp = tpm.measure_power(_t(ipos), _t(w), cfg)
    np.testing.assert_allclose(tmp.power, jm.power, rtol=1e-5)
    np.testing.assert_allclose(tmp.power, tps.power, rtol=1e-6)
    (tmp_path / "jax").mkdir()
    f = tps.save(str(tmp_path), 0.1, 0.5)
    g = jps.save(str(tmp_path / "jax"), 0.1, 0.5)
    with open(f) as a, open(g) as b:
        assert len(a.read().splitlines()) == len(b.read().splitlines())
