"""Pair kernel of the PyTorch port (gravity/pairkernel.py) against the
JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the exact shortrange math and against the JAX Pallas kernel run
in interpret mode (as tests/test_pairkernel.py runs it).  The CUDA kernel
itself is compared with the plain version on a card in
tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpgadget_tpu.gravity.pairkernel import block_pair_accumulate as jax_bpa
from mpgadget_tpu.gravity.shortrange import (
    shortrange_force_window, shortrange_pot_window, softened_force_factor,
    softened_pot_factor)
from mpgadget_tpu_torch.gravity import pairkernel as pk

RS_INV = 42.666668
H_INV = 300.0       # large softening so all spline branches are hit
RCUT = 0.0703125

# one intra-op thread: the suite runs in several worker processes that
# share the machine's cores
torch.set_num_threads(1)


def _inputs(seed=7, nb=4, G=128, S=256):
    rng = np.random.RandomState(seed)
    tx, ty, tz = (rng.rand(nb, G).astype(np.float32) for _ in range(3))
    sx = (np.tile(tx, (1, S // G + 1))[:, :S]
          + rng.uniform(-0.1, 0.1, (nb, S))).astype(np.float32) % 1.0
    sy = (ty[:, :1] + rng.uniform(-0.1, 0.1, (nb, S))).astype(
        np.float32) % 1.0
    sz = (tz[:, :1] + rng.uniform(-0.1, 0.1, (nb, S))).astype(
        np.float32) % 1.0
    sm = rng.uniform(0.5, 2.0, (nb, S)).astype(np.float32)
    sm[:, -10:] = 0.0   # padding slots
    acc0 = rng.randn(nb, 3, G).astype(np.float32)
    pot0 = rng.randn(nb, G).astype(np.float32)
    return tx, ty, tz, sx, sy, sz, sm, acc0, pot0


def _exact(tx, ty, tz, sx, sy, sz, sm, acc0, pot0):
    """Dense pair sum with the JAX shortrange.py math, in numpy."""
    def wrap(d):
        return d - np.round(d)
    dx = wrap(sx[:, None, :] - tx[:, :, None])
    dy = wrap(sy[:, None, :] - ty[:, :, None])
    dz = wrap(sz[:, None, :] - tz[:, :, None])
    rr = np.sqrt(dx * dx + dy * dy + dz * dz)
    jr = jnp.asarray(rr)
    ff = np.asarray(softened_force_factor(jr, H_INV)
                    * shortrange_force_window(jr, RS_INV))
    ff = np.where(rr < RCUT, ff * sm[:, None, :], 0.0)
    acc = acc0 + np.stack([np.sum(ff * d, axis=2) for d in (dx, dy, dz)],
                          axis=1)
    pp = np.asarray(softened_pot_factor(jr, H_INV)
                    * shortrange_pot_window(jr, RS_INV))
    pp = np.where((rr > 0) & (rr < RCUT), pp * sm[:, None, :], 0.0)
    return acc, pot0 + np.sum(pp, axis=2)


def _port(args, with_potential, chunk=128):
    t = [torch.as_tensor(a) for a in args]
    every = torch.full((t[0].shape[0],), t[3].shape[1], dtype=torch.int32)
    acc, pot = pk.block_pair_accumulate(*t, RS_INV, H_INV, RCUT, every,
                                        chunk=chunk,
                                        with_potential=with_potential)
    return acc.numpy(), pot.numpy()


@pytest.mark.parametrize("with_potential", [False, True])
def test_plain_pair_matches_exact_shortrange_math(with_potential):
    args = _inputs()
    acc, pot = _port(args, with_potential)
    acc_ref, pot_ref = _exact(*args)
    # both sum the same f32 terms; only the erfc implementation and the
    # summation order differ: 1e-5 of the largest |acc|
    tol = 1e-5 * np.abs(acc_ref).max()
    assert np.abs(acc - acc_ref).max() <= tol
    if with_potential:
        assert np.abs(pot - pot_ref).max() <= 1e-5 * np.abs(pot_ref).max()
    else:
        np.testing.assert_array_equal(pot, args[-1])


@pytest.mark.parametrize("with_potential", [False, True])
def test_plain_pair_matches_pallas_interpret(with_potential):
    args = _inputs(seed=11)
    acc, pot = _port(args, with_potential)
    jacc, jpot = jax_bpa(*[jnp.asarray(a) for a in args], RS_INV, H_INV,
                         RCUT, chunk=128, with_potential=with_potential,
                         interpret=True)
    # the Pallas kernel uses a fitted window polynomial (abs err < 1.2e-5
    # in w): the tolerance of tests/test_pairkernel.py
    np.testing.assert_allclose(acc, np.asarray(jacc), rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(pot, np.asarray(jpot), rtol=2e-3, atol=2e-2)


@pytest.mark.parametrize("chunk", [64, 256, 100])
def test_plain_pair_chunking_is_exact(chunk):
    """Chunks over sources (and a chunk that does not divide S, which
    falls back to one chunk) give the same sums to f32 rounding."""
    args = _inputs(seed=3)
    acc_a, pot_a = _port(args, True, chunk=chunk)
    acc_b, pot_b = _port(args, True, chunk=256)
    np.testing.assert_allclose(acc_a, acc_b, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(pot_a, pot_b, rtol=1e-5, atol=1e-4)


def test_cpu_tensors_do_not_launch_the_kernel():
    before = pk.LAUNCHES
    _port(_inputs(), True)
    assert pk.LAUNCHES == before
