"""Multi-rank TreePM step: slab domains, ghost strips and the pencil PM.

PyTorch port of mpgadget_tpu/parallel/treepm.py, the DM-only KDK step over
geometric x-slabs (SURVEY §2.2):

  reference mechanism                  here
  -----------------------------------  ---------------------------------
  domain_decompose (domain.c)          x-slab ownership by position bits
  domain_exchange alltoallv            split-size all_to_all
                                       (decomp.exchange_to_slabs)
  treewalk export/import (treewalk.c)  ghost strips of width rcut
                                       (decomp.ghost_strips)
  PFFT pencil alltoallv (petapm.c)     all_to_all pencil transpose
                                       (pfft.pm_force_slab)

Each rank then runs the single-device short-range force
(gravity/treepm.tree_force: the tree walk K2 and the pair kernel K1) on
its own rows followed by the ghosts.

Constraint (one-hop ghosts): the slab width must exceed rcut.
"""

import numpy as np
import torch

from ..integrate import drift, kick
from .decomp import exchange_to_slabs, ghost_strips
from .pfft import pm_force_slab


def tree_force_retry(tg, ipos, mass, amag, target_active=None,
                     with_potential=False):
    """gravity.treepm.tree_force over this rank's rows (all valid) with
    the kwargs of TreeGravity tg at their count; the tree's own capacities
    double on overflow and the walk runs again, as the single-device
    Simulation._tree_compute_retry does (no collective inside: each rank
    retries on its own)."""
    from ..gravity.treepm import tree_force
    n = ipos.shape[0]
    valid = torch.ones(n, dtype=torch.bool, device=ipos.device)
    for _ in range(8):
        kw = tg.force_kwargs(n)
        kw["with_potential"] = bool(with_potential)
        res = tree_force(ipos, mass, valid, amag,
                         target_active=target_active, **kw)
        if not bool(res.overflow):
            return res
        tg.grow()
    raise RuntimeError("sharded tree walk: capacity overflow after "
                       "retries")


def sharded_treepm_step(mesh, *, nmesh, boxsize, gconst, asmth, rcut, tg):
    """The DM KDK step over geometric slabs.  Returns step(ipos, vel,
    mass, amag, pid, dkick, ddrift) -> (ipos, vel, mass, amag, pid) on
    this rank (rows move to their slab).  tg: gravity.treepm.TreeGravity
    holding the short-range parameters."""
    S = mesh.size
    log2s = int(np.log2(S))
    assert 1 << log2s == S, "rank count must be a power of two"
    rcut_box = rcut * asmth / nmesh
    assert 1.0 / S > rcut_box, (
        f"slab width must exceed rcut (one-hop ghosts): 1/{S} <= "
        f"{rcut_box}")

    def step(ipos, vel, mass, amag, pid, dkick, ddrift):
        # 1. domain exchange: every row to its x-slab owner
        (ipos, vel, mass, amag, pid), _ = exchange_to_slabs(
            (ipos, vel, mass, amag, pid), ipos, mesh)
        n = ipos.shape[0]
        # 2. ghost strips (sources only) from both neighbours
        g_ipos, g_mass = ghost_strips((ipos, mass), ipos, mesh, log2s,
                                      rcut_box)
        ng = g_ipos.shape[0]
        # 3. the tree force over own rows, then ghosts
        res = tree_force_retry(
            tg, torch.cat([ipos, g_ipos]), torch.cat([mass, g_mass]),
            torch.cat([amag, amag.new_zeros(ng)]))
        # 4. the sharded PM long-range force
        acc_pm, _, _ = pm_force_slab(ipos, mass, nmesh, boxsize, gconst,
                                     asmth, mesh)
        acc = res.accel[:n] + acc_pm
        amag = torch.sqrt(torch.sum(acc * acc, dim=-1))
        vel = kick(vel, acc, dkick)
        ipos = drift(ipos, vel, ddrift, 1.0 / boxsize)
        return ipos, vel, mass, amag, pid

    return step
