"""The sharded KDK step of the dark matter: TreePM over balanced slabs.

PyTorch port of the dark-matter part of mpgadget_tpu/parallel/driver.py,
the analog of the reference run loop's per-step machinery (run.c:358-800):
count-balanced slab boundaries (domain.c:106), K-hop ghost strips
(treewalk.c exports reach any rank), the tree (K2 walk, K1 pair sums) and
the pencil-FFT PM, the half-kick / drift / half-kick structure, and
timestep statistics summed over ranks, so that the host policy never
gathers particle rows.  Global steps and the hierarchical per-timebin
substeps (timestep.c:298-503) are both here; the gas branches come with
the sharded SPH.

Each rank holds its rows in a dict of tensors (variable-length, all rows
valid).  No capacity is carried, so a step cannot overflow and is never
retried: exchanges and ghost strips move exactly the rows they need, the
PM routes every row to the rank of its geometric mesh slab whatever its
distance, and the tree's own capacities grow inside the rank's tree force.
"""

import numpy as np
import torch

from ..integrate import drift
from . import collectives as coll
from .decomp import (exchange_to_slabs, ghost_strips_multi,
                     count_histogram, slab_of, pack_rows, unpack_rows)
from .pfft import pm_force_slab
from .treepm import tree_force_retry

MAXB = 46     # timebin-table size == TIMEBINS (timeline.py); bins live in
              # [1, maxbin <= MAXB]


class Layers:
    """Host seconds per layer of the sharded step into a WallTime; with
    sync=True each lap first synchronises the device, so that the seconds
    belong to the layer that queued the work (the smoke's breakdown)."""

    def __init__(self, walltime, device, sync=False):
        self.wt, self.device, self.sync = walltime, device, sync
        self._name = None

    def __call__(self, name):
        if self.wt is None:
            return
        if self.sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self._name is not None:
            self.wt.stop(self._name)
        self._name = name
        if name is not None:
            self.wt.start(name)


def ghost_hops(bounds, width):
    """Ring hops K such that, from every slab, the K neighbours on each
    side span at least ``width`` (box units): the ghost_strips_multi
    contract (the JAX package's run_sharded hops_for)."""
    S = len(bounds)
    b = np.asarray(bounds, np.float64) / 2 ** 32
    widths = np.diff(np.append(b, 1.0))
    K = 1
    for s in range(S):
        left = right = 0.0
        k = 0
        while (left < width or right < width) and k < S // 2:
            k += 1
            left += widths[(s - k) % S]
            right += widths[(s + k) % S]
        K = max(K, k)
    return int(min(max(K, 1), max(S // 2, 1)))


def pm_force_multi(ipos, weights, nmesh, boxsize, gconst, asmth, mesh,
                   with_potential=False):
    """Sharded PM force for rows held under count-balanced ownership,
    whose geometric mesh slab may be any rank's.  Each row (position and
    weight) goes to the rank of its slab through one split-size
    all_to_all, is deposited and read out there (pfft.pm_force_slab), and
    its acceleration (and potential) comes back through the reverse
    exchange.  The JAX package ring-gathers the rows of 2 hops neighbours
    instead and counts the hops on the host; both deposit the same rows
    on each slab.  Returns (accel [n,3], potential [n] or None)."""
    S = mesh.size
    log2s = int(np.log2(S))
    dest = slab_of(ipos, log2s)
    order = torch.sort(dest, stable=True).indices
    buf, spec = pack_rows([ipos[order], weights[order]])
    rbuf, recv = coll.all_to_all(buf, mesh, torch.bincount(dest,
                                                           minlength=S))
    ip_r, w_r = unpack_rows(rbuf, spec)
    acc_r, pot_r = pm_force_slab(ip_r, w_r, nmesh, boxsize, gconst, asmth,
                                 mesh, compute_potential=with_potential)
    out = torch.cat([acc_r, pot_r[:, None]], dim=1) if with_potential \
        else acc_r
    back, _ = coll.all_to_all(out.contiguous(), mesh, recv)
    res = torch.empty_like(back)
    res[order] = back
    return res[:, :3], (res[:, 3] if with_potential else None)


def _type_stats(st, mesh):
    """Per-type sums of v^2, counts and minimum masses over ranks (the PM
    displacement criterion's inputs)."""
    dev = st["mass"].device
    v2 = torch.sum(st["vel"] * st["vel"], dim=-1)
    tid = st["ptype"].long()
    vsum = torch.zeros(6, dtype=torch.float32, device=dev).index_add_(
        0, tid, v2)
    cnt = torch.zeros(6, dtype=torch.float32, device=dev).index_add_(
        0, tid, torch.ones_like(v2))
    mmin = torch.full((6,), float("inf"), dtype=torch.float32,
                      device=dev).scatter_reduce(0, tid, st["mass"], "amin")
    return {"vsum": coll.psum(vsum, mesh), "count": coll.psum(cnt, mesh),
            "min_mass": coll.pmin(mmin, mesh)}


def assign_bins(st, atime, eta_eps, hubble, max_dloga, dloga_tick, maxbin):
    """Power-of-two timebins from the gravity criterion (find_timesteps,
    timestep.c:298-503), elementwise in float32 on each rank's rows; the
    host scalars enter as float32 tensors, so that divisions by them
    round as divisions."""
    from ..timestep import _f32
    dev = st["grav_acc"].device
    a = _f32(atime, dev)
    full = (st["grav_acc"] + st["pm_acc"]) / (a * a)
    ac = torch.sqrt(torch.clamp(torch.sum(full * full, dim=-1), min=1e-60))
    dloga = torch.sqrt(_f32(eta_eps, dev) / ac) * _f32(hubble, dev)
    dloga = torch.minimum(dloga, _f32(max_dloga, dev))
    dti = dloga / _f32(dloga_tick, dev)
    bins = torch.floor(torch.log2(torch.clamp(dti, min=2.0))).to(
        torch.int32)
    return torch.clamp(bins, 1, int(maxbin))


def pm_refresh(st, mesh, scal, *, nmesh, boxsize, gconst, asmth,
               with_potential=False, hist_bits=12, layers=None):
    """PM refresh and boundary half kick of a hierarchical interval
    (compute_forces(tree=False) + apply_PM_half_kick, run.c:605).  st:
    this rank's rows; scal: {"fac": the closing gravkick factor}.  Returns
    (updated columns {pm_acc, vel, amag[, pm_pot, potential]}, stats)."""
    lay = layers or Layers(None, mesh.device)
    lay("PMgrav")
    acc_pm, pm_pot = pm_force_multi(st["ipos"], st["mass"], nmesh, boxsize,
                                    gconst, asmth, mesh, with_potential)
    lay("Kick")
    vel = st["vel"] + acc_pm * float(np.float32(scal["fac"]))
    full = st["grav_acc"] + acc_pm
    upd = {"pm_acc": acc_pm, "vel": vel,
           "amag": torch.sqrt(torch.sum(full * full, dim=-1))}
    if with_potential:
        upd["pm_pot"] = pm_pot
        upd["potential"] = pm_pot + st["tree_pot"]
    lay("Stats")
    stats = _type_stats(dict(st, vel=vel), mesh)
    stats["hist"] = count_histogram(st["ipos"], mesh, hist_bits)
    stats["n_valid"] = int(coll.psum(torch.tensor(
        st["ipos"].shape[0], device=mesh.device), mesh))
    lay(None)
    return upd, stats


def sharded_step(st, bounds, scal, mesh, *, tg, hops_ghost, nmesh,
                 boxsize, gconst, asmth, rcut, hierarchical=False,
                 with_potential=False, hist_bits=12, layers=None):
    """One KDK step (global) or one substep (hierarchical) on this rank's
    rows (build_sharded_step with with_gas=False).

    st: dict of this rank's columns: ipos, vel, mass, pid, ptype, amag,
    grav_acc; hierarchical adds bins (int32) and pm_acc (the long-range
    field, kicked only by :func:`pm_refresh`; grav_acc is then tree-only);
    with_potential adds potential and pm_pot (and tree_pot when
    hierarchical).  bounds: the S balanced left edges.  scal: host
    scalars; global: dk1, ddrift, dk2; hierarchical: ddrift, and the MAXB+1
    tables gk_open, gk_close, al_open, al_close, with eta_eps, hubble,
    max_dloga, dloga_tick, maxbin for the bins' re-derivation.  Returns
    (st', stats): stats summed over ranks (vsum, count, min_mass, max_acc,
    hist, n_valid; hierarchical: min_act_bin, bin_hist, n_closing)."""
    lay = layers or Layers(None, mesh.device)
    dev = mesh.device
    f32 = np.float32
    st = dict(st)
    rcut_box = rcut * asmth / nmesh

    # ---- opening half kick with the carried forces ----
    lay("Kick")
    if hierarchical:
        al_open = torch.as_tensor(scal["al_open"], device=dev)
        gk_open = torch.as_tensor(np.asarray(scal["gk_open"], f32),
                                  device=dev)
        bins0 = torch.clamp(st["bins"], 1, MAXB).long()
        gk1 = torch.where(al_open[bins0], gk_open[bins0], 0.0)
        st["vel"] = st["vel"] + st["grav_acc"] * gk1[:, None]
    else:
        st["vel"] = st["vel"] + st["grav_acc"] * float(f32(scal["dk1"]))
    # ---- drift ----
    st["ipos"] = drift(st["ipos"], st["vel"], scal["ddrift"], 1.0 / boxsize)

    # ---- domain exchange to the balanced owners ----
    lay("Exchange")
    keys = sorted(st)
    cols, _ = exchange_to_slabs(tuple(st[k] for k in keys), st["ipos"],
                                mesh, bounds)
    st = dict(zip(keys, cols))
    n = st["ipos"].shape[0]

    # ---- ghost strips: the tree's sources near the slab faces ----
    lay("Ghosts")
    g_ipos, g_mass = ghost_strips_multi(
        (st["ipos"], st["mass"]), st["ipos"], mesh, bounds,
        float(f32(rcut_box)), hops_ghost)
    ng = g_ipos.shape[0]
    ipos_a = torch.cat([st["ipos"], g_ipos])
    mass_a = torch.cat([st["mass"], g_mass])
    amag_a = torch.cat([st["amag"], st["amag"].new_zeros(ng)])

    lay("Tree")
    g_over_box = float(f32(gconst / boxsize))
    if hierarchical:
        al_close = torch.as_tensor(scal["al_close"], device=dev)
        bins = torch.clamp(st["bins"], 1, MAXB).long()
        closing = al_close[bins]
        tmask = torch.cat([closing, closing.new_zeros(ng)])
        res = tree_force_retry(tg, ipos_a, mass_a, amag_a,
                               target_active=tmask,
                               with_potential=with_potential)
        st["grav_acc"] = torch.where(closing[:, None], res.accel[:n],
                                     st["grav_acc"])
        full = st["grav_acc"] + st["pm_acc"]
        st["amag"] = torch.where(
            closing, torch.sqrt(torch.sum(full * full, dim=-1)), st["amag"])
        if with_potential:
            # the tree part of rows closing their bin, with the carried PM
            # part (the total potential, gravshort-tree.c:137)
            st["tree_pot"] = torch.where(
                closing, res.potential[:n] * g_over_box, st["tree_pot"])
            st["potential"] = st["tree_pot"] + st["pm_pot"]
    else:
        res = tree_force_retry(tg, ipos_a, mass_a, amag_a,
                               with_potential=with_potential)
        lay("PMgrav")
        acc_pm, pm_pot = pm_force_multi(st["ipos"], st["mass"], nmesh,
                                        boxsize, gconst, asmth, mesh,
                                        with_potential)
        if with_potential:
            st["pm_pot"] = pm_pot
            st["potential"] = res.potential[:n] * g_over_box + pm_pot
        grav = res.accel[:n] + acc_pm
        st["amag"] = torch.sqrt(torch.sum(grav * grav, dim=-1))
        st["grav_acc"] = grav

    # ---- closing half kick with the fresh forces ----
    lay("Kick")
    if hierarchical:
        gk_close = torch.as_tensor(np.asarray(scal["gk_close"], f32),
                                   device=dev)
        gk2 = torch.where(closing, gk_close[bins], 0.0)
        st["vel"] = st["vel"] + st["grav_acc"] * gk2[:, None]
        # bins of the rows closing their interval: shrink freely, grow
        # only where the longer interval is aligned with the far clock
        # edge (is_timebin_active)
        nb = assign_bins(st, scal["atime"], scal["eta_eps"],
                         scal["hubble"], scal["max_dloga"],
                         scal["dloga_tick"], scal["maxbin"])
        cur = st["bins"]
        new = torch.where(closing & (nb < cur), nb, cur)
        new = torch.where(closing & (nb > cur) & al_close[nb.long()], nb,
                          new)
        st["bins"] = torch.clamp(new, 1, int(scal["maxbin"]))
    else:
        st["vel"] = st["vel"] + st["grav_acc"] * float(f32(scal["dk2"]))

    # ---- statistics summed over ranks ----
    lay("Stats")
    stats = _type_stats(st, mesh)
    amax = st["amag"].max() if n else torch.zeros((), device=dev)
    stats["max_acc"] = float(coll.pmax(amax, mesh))
    stats["hist"] = count_histogram(st["ipos"], mesh, hist_bits)
    stats["n_valid"] = int(coll.psum(torch.tensor(n, device=dev), mesh))
    if hierarchical:
        bins_c = torch.clamp(st["bins"], 1, MAXB).long()
        al_n = al_close[bins_c]
        mb = torch.where(al_n, bins_c, MAXB).min() if n else \
            torch.tensor(MAXB, device=dev)
        stats["min_act_bin"] = int(coll.pmin(mb, mesh))
        stats["bin_hist"] = coll.psum(
            torch.bincount(bins_c, minlength=MAXB + 1), mesh).cpu().numpy()
        stats["n_closing"] = int(coll.psum(closing.sum(), mesh))
    lay(None)
    return st, stats
