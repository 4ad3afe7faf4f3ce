"""Distributed sort over the ranks (the mpsort analog).

PyTorch port of mpgadget_tpu/parallel/sort.py, in place of the reference's
massively parallel histogram sort (depends/mpsort, used by FOF group
ordering and snapshot layout): sampled splitters, one split-size
all_to_all of the rows, a local stable sort.  After ``sharded_sort`` every
key on rank s is <= every key on rank s+1 and each rank's rows are sorted,
so the concatenation over ranks is the globally sorted sequence.  Rows are
variable-length, so no bucket can overflow.
"""

import torch

from . import collectives as coll
from .decomp import exchange_by_dest


def _key_max(keys):
    return torch.iinfo(keys.dtype).max if not keys.is_floating_point() \
        else float("inf")


def global_splitters(keys, mesh, n_samples=64):
    """S-1 splitter keys, the same on every rank, from per-rank quantile
    samples (mpsort's histogram refinement in one round: n_samples per
    rank bound the imbalance by ~1/n_samples)."""
    S = mesh.size
    ks = torch.sort(keys).values
    nv = ks.shape[0]
    if nv:
        q = (torch.arange(n_samples, device=keys.device) * nv) // n_samples
        samples = ks[torch.clamp(q, 0, nv - 1)]
    else:
        # an empty rank's samples go to the maximum: weighted out
        samples = torch.full((n_samples,), _key_max(keys), dtype=keys.dtype,
                             device=keys.device)
    allsamp = torch.sort(coll.all_gather(samples, mesh).reshape(-1)).values
    total = S * n_samples
    pos = (torch.arange(1, S, device=keys.device) * total) // S
    return allsamp[pos]


def sharded_sort(keys, arrays, mesh, n_samples=64):
    """Sort (keys, payload columns) globally over the ranks.  arrays:
    tuple or dict of payload columns (need not include keys).  Returns
    (keys_out, arrays_out), rank-monotone and locally sorted (stable)."""
    splitters = global_splitters(keys, mesh, n_samples)
    dest = torch.searchsorted(splitters, keys.contiguous(), right=True)
    (keys_x, arrays_x), _ = _exchange_keyed(keys, arrays, dest, mesh)
    order = torch.sort(keys_x, stable=True).indices
    if isinstance(arrays_x, dict):
        arrays_out = {k: v[order] for k, v in arrays_x.items()}
    else:
        arrays_out = tuple(v[order] for v in arrays_x)
    return keys_x[order], arrays_out


def _exchange_keyed(keys, arrays, dest, mesh):
    """exchange_by_dest of the keys and a tuple or dict of columns."""
    if isinstance(arrays, dict):
        names = list(arrays)
        out, recv = exchange_by_dest(
            (keys,) + tuple(arrays[k] for k in names), dest, mesh)
        return (out[0], dict(zip(names, out[1:]))), recv
    out, recv = exchange_by_dest((keys,) + tuple(arrays), dest, mesh)
    return (out[0], tuple(out[1:])), recv
