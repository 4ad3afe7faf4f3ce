"""The ranks of a sharded run and the placement of particle rows on them.

PyTorch port of mpgadget_tpu/parallel/mesh.py.  A :class:`ShardMesh` (the
process group, this rank, the number of ranks and this rank's device)
stands where the JAX package has a 1-D ``jax.sharding.Mesh``: each rank is
one process that holds its own rows on its own device.  Rows are
variable-length per rank (no padding, no validity column).
"""

from dataclasses import dataclass

import numpy as np
import torch

from . import collectives as coll


@dataclass(frozen=True)
class ShardMesh:
    """One rank's view of a sharded run.  group None is the default
    (world) group; rank and size are within it."""
    rank: int
    size: int
    device: torch.device
    backend: str = "gloo"
    group: object = None

    def global_rank(self, r):
        return r


def make_sim_mesh(device=None):
    """The ShardMesh of the initialised default process group (one rank,
    no process group, when torch.distributed is not initialised)."""
    if coll.is_initialized():
        rank, size, backend = coll.world()
    else:
        rank, size, backend = 0, 1, "none"
    if device is None:
        device = torch.device("cpu")
    return ShardMesh(rank=rank, size=size, device=torch.device(device),
                     backend=str(backend))


def default_n_local(n, size):
    """Rows per shard of the JAX package's padded layout
    (run_sharded: ceil(2 n / S / 256) * 256)."""
    return int(np.ceil(2.0 * n / size / 256)) * 256


def shard_particles(arrays, valid, mesh, n_local=None):
    """This rank's rows of full host arrays, as every JAX process takes
    its shards (shard_particles): the rows [rank * n_local, (rank + 1) *
    n_local) of the arrays padded to size * n_local, of which the valid
    ones.  arrays: dict name -> tensor or ndarray (leading dim N, the same
    on every rank); valid: bool[N].  Returns dict name -> tensor on the
    mesh's device."""
    valid = torch.as_tensor(np.asarray(valid) if not torch.is_tensor(valid)
                            else valid).to("cpu")
    n = valid.shape[0]
    if n_local is None:
        n_local = -(-n // mesh.size)
    lo, hi = mesh.rank * n_local, min((mesh.rank + 1) * n_local, n)
    rows = torch.nonzero(valid[lo:hi]).squeeze(1) + lo if hi > lo \
        else torch.zeros(0, dtype=torch.int64)
    out = {}
    for k, a in arrays.items():
        t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
        out[k] = t.to("cpu")[rows].to(mesh.device)
    return out


def fetch_global(x, mesh):
    """Every rank's rows of x concatenated in rank order, on the host
    (outputs and the final state only, not every step)."""
    return coll.all_gather_v(x, mesh)[0].cpu()


def sharded_pm_step(mesh, nmesh, boxsize, gconst, asmth):
    """PM-only KDK step on x-slabs: a cross-check of the pencil path.

    The JAX package builds this step from sharding annotations and lets
    GSPMD choose the collectives, as a check on its explicit pencil FFT.
    PyTorch has no GSPMD, so here the same step is written with the
    explicit pieces (decomp.exchange_to_slabs, pfft.pm_force_slab) and
    serves the same purpose against the single-device
    pm/gravity._pm_force_kernel.  Returns step(ipos, vel, mass, pid,
    dkick, ddrift) -> (ipos, vel, mass, pid) on this rank's slab (rows
    move)."""
    from ..integrate import drift, kick
    from .decomp import exchange_to_slabs, geometric_boundaries
    from .pfft import pm_force_slab
    bounds = geometric_boundaries(mesh.size)

    def step(ipos, vel, mass, pid, dkick, ddrift):
        (ipos, vel, mass, pid), _ = exchange_to_slabs(
            (ipos, vel, mass, pid), ipos, mesh, bounds)
        acc, _, _ = pm_force_slab(ipos, mass, nmesh, boxsize, gconst,
                                  asmth, mesh)
        vel = kick(vel, acc, dkick)
        ipos = drift(ipos, vel, ddrift, 1.0 / boxsize)
        return ipos, vel, mass, pid

    return step
