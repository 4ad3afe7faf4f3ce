"""Morton (Z-order) keys from fixed-point positions (PyTorch port of
mpgadget_tpu/ops/morton.py).

Keys are built from the top 21 bits per axis of the fixed-point positions
(int64 tensors holding [0, 2^32)) and returned as one int64 tensor: the
63 bits used make every key a non-negative value.  The key's 3-bit
groups from the top are octree child indices, so an octree node at level
L is the contiguous range of keys sharing the top 3L bits.

The JAX package marks invalid particles (and padding tree rows) with the
uint64 key ~0, above every valid key.  In int64 that pattern is -1, which
would sort first, and no int64 lies above a particle in the last cell
(key 2^63 - 1).  The port keeps -1 (:data:`KEY_PAD`: its arithmetic right
shift stays -1, so it never shares a prefix with a valid key) and sorts
on the pair (invalid, key): :func:`sort_order`.
"""

import torch

MORTON_BITS = 21  # bits per dimension
KEY_PAD = -1      # key of invalid particles and padding tree rows


def _spread_bits_21(x):
    """Spread the low 21 bits of x so there are two zero bits between
    consecutive bits: b20..b0 -> b20 0 0 b19 0 0 ... b0 (int64)."""
    x = x.to(torch.int64) & 0x1FFFFF
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def morton_key(ipos):
    """63-bit Morton key (int64, non-negative) from fixed-point positions
    [N,3] (int64 in [0, 2^32))."""
    x = _spread_bits_21(ipos[:, 0] >> (32 - MORTON_BITS))
    y = _spread_bits_21(ipos[:, 1] >> (32 - MORTON_BITS))
    z = _spread_bits_21(ipos[:, 2] >> (32 - MORTON_BITS))
    return (x << 2) | (y << 1) | z


def sort_order(keys, valid):
    """Stable sort permutation on the pair (invalid, key): valid particles
    by key, then the invalid ones in index order.  This is the JAX
    package's ``argsort(where(valid, keys, ~0))`` with the uint64 ~0
    sentinel, which int64 cannot hold above a valid key."""
    p = torch.argsort(torch.where(valid, keys, 0), stable=True)
    return p[torch.argsort((~valid[p]).to(torch.int8), stable=True)]
