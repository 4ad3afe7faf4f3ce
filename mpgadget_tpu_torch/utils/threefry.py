"""The JAX PRNG calls that star formation draws from, in numpy.

The JAX package seeds star formation with
``jax.random.PRNGKey((RandomSeed + ti_current) % 2**31)``, splits the key
in three and draws one ``uint32`` word per key (``sfr._id_uniform``:
``fold_in(key, 0)`` then ``bits(key, (1,), uint32)``).  These functions
give the same words bit for bit for JAX's default implementation,
Threefry-2x32 with ``jax_threefry_partitionable`` on (the default since
JAX 0.5), so the port's per-ID draws equal the JAX package's.  Keys are
uint32 arrays of shape (2,), as JAX's raw keys.
"""

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block function (20 rounds) of one key on counter
    words x0, x1 (uint32 arrays of one shape): JAX's
    ``_threefry2x32_lowering``."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0],
             np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r)
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed):
    """``jax.random.PRNGKey(seed)`` for an integer seed: the high and low
    32-bit words of its 64-bit value."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & 0xFFFFFFFF], np.uint32)


def split(key, num=2):
    """``jax.random.split(key, num)`` (partitionable): key i is the block
    function of counter (0, i)."""
    x0, x1 = threefry2x32(key, np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([x0, x1], axis=1)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: the block function of counter
    (0, data), data taken as uint32."""
    x0, x1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([x0[0], x1[0]], np.uint32)


def bits32(key):
    """``jax.random.bits(key, (1,), uint32)[0]`` (partitionable): the xor of
    the block function's two words at counter (0, 0)."""
    x0, x1 = threefry2x32(key, np.zeros(1, np.uint32), np.zeros(1, np.uint32))
    return int(x0[0] ^ x1[0])
