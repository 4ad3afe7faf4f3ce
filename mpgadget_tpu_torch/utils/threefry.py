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


def random_bits(key, n):
    """``jax.random.bits(key, (n,), uint32)`` (partitionable), flattened
    in C order, for n < 2**32: the xor of the block function's two words
    at counter (0, i) for element i."""
    x0, x1 = threefry2x32(key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    return x0 ^ x1


# XLA's float32 erf_inv (M. Giles' single-precision polynomials in
# w = -log1p(-x^2), below and above w = 5), which jax.random.normal calls
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x):
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = np.where(lt, np.float32(a), np.float32(b)) + p * w
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, p * x)


def normal(key, shape):
    """``jax.random.normal(key, shape, float32)`` (partitionable) as a
    float32 numpy array: a uniform in (-1, 1) from the top 23 bits of
    each word, then sqrt(2) erfinv.  The words are JAX's bit for bit;
    the erfinv rounds as XLA's to an ulp or two (numpy's log1p)."""
    n = int(np.prod(shape))
    bits = random_bits(key, n)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    one = np.float32(1.0)
    fl = ((bits >> np.uint32(9)) | one.view(np.uint32)).view(np.float32) - one
    u = np.maximum(lo, fl * (one - lo) + lo)
    with np.errstate(over="ignore"):
        z = np.float32(np.sqrt(2.0)) * _erfinv32(u)
    return z.reshape(shape)
