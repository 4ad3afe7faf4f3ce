"""Sharded neighbour winds, the vs08 and ofjt10 models (winds_and_feedback,
winds.c:299-567 at scale).

PyTorch port of mpgadget_tpu/parallel/winds.py.  The kick sources, the
stars formed since the interval opened, are few: every rank's new stars go
to every rank (one all_gather_v of their rows, no slot capacity), so a
star's kernel reaches the gas of any rank, as the reference's treewalk
exports do (treewalk.c:325), without ghost strips.  Each rank then runs
the single-device passes of physics/winds.py over its own rows with the
gathered stars appended as extra rows: the neighbour walk K3 and
ops/pairs.pair_reduce (plain PyTorch) on one tree of the rank's gas, dark
matter and the stars.  The JAX package's lax.scans over [chunk, stars]
blocks are not ported.

The passes, as physics/winds.winds_via_neighbors with the per-star sums
summed over ranks in between:
  1. per star: the eligible gas mass inside its hsml (sfr_wind_weight,
     winds.c:299-318) and, for the halo model, the dark matter's velocity
     sums within 2 mean separations (veldisp.c:35-76); one all-reduce;
  2. per gas row of this rank: the stochastic hits of the pair-ID hash,
     resolved to the nearest hitting star (winds.c:320-345);
  3. wind_do_kick on the hit gas (winds.c:454-489), then every gas row's
     decoupling timer advances over the interval (winds_evolve,
     winds.c:113-136).
The draws are per ID, so the same gas is hit at any rank count; the sums
run in no fixed order across ranks.
"""

import numpy as np
import torch

from ..physics import winds as windmod
from . import collectives as coll
from .decomp import all_gather_rows


def sharded_winds(st, scal, mesh, par, *, boxsize, mean_sep,
                  vdisp_radius_fac=2.0):
    """The neighbour winds of the new stars on this rank's rows
    (build_sharded_winds' step).

    st: this rank's columns ipos, vel, mass, pid, ptype, hsml, entropy,
    density, delay_time, gas_mask, formation_time; scal: atime, dtime (the
    interval in internal time units), aform_min (new stars have
    formation_time >= aform_min) and key (the draws' key, already folded
    with 77).  Returns (updated columns vel, entropy, delay_time; stats
    n_new, n_kicked summed over ranks)."""
    dev = st["ipos"].device
    n = st["ipos"].shape[0]
    atime = float(np.float32(scal["atime"]))
    gas = st["gas_mask"]
    new_star = (st["ptype"] == 4) & (st["formation_time"]
                                     >= float(np.float32(scal["aform_min"])))
    idx = torch.nonzero(new_star).squeeze(1)
    (g_ipos, g_hsml, g_mass, g_pid), _ = all_gather_rows(
        (st["ipos"][idx], st["hsml"][idx], st["mass"][idx],
         st["pid"][idx]), mesh)
    ng = g_ipos.shape[0]
    stats = {"n_new": ng, "n_kicked": 0}
    upd = {}
    delay = st["delay_time"]
    if ng:
        # the rank's rows, then the gathered stars: targets of pass 1 and
        # sources of passes 2-3 only as appended rows
        z = torch.zeros(ng, dtype=torch.bool, device=dev)
        is_gas_a = torch.cat([gas, z])
        star_a = torch.cat([torch.zeros_like(gas), ~z])
        w = windmod.wind_setup(
            torch.cat([st["ipos"], g_ipos]), torch.cat([st["mass"], g_mass]),
            torch.cat([st["hsml"], g_hsml]), torch.cat([st["pid"], g_pid]),
            torch.cat([delay, delay.new_zeros(ng)]), is_gas_a, star_a,
            boxsize)
        perm, inv = w["perm"], w["inv"]
        weight = windmod.wind_weights(w)[inv][n:]
        sums = {"w": weight}
        halo = bool(par.model & windmod.WIND_USE_HALO)
        if halo:
            s = windmod.dm_dispersion_sums(
                torch.cat([st["ipos"], g_ipos]),
                torch.cat([st["vel"], g_mass.new_zeros((ng, 3))]),
                torch.cat([st["mass"], g_mass]),
                torch.cat([st["ptype"] == 1, z]), star_a, boxsize,
                radius_box=vdisp_radius_fac * mean_sep / boxsize)
            sums.update({k: s[k][n:] for k in windmod.DISPERSION_SUMS})
        keys = sorted(sums)
        tot = coll.psum(torch.stack([sums[k] for k in keys], dim=1), mesh)
        sums = {k: tot[:, i] for i, k in enumerate(keys)}
        if halo:
            vdisp_g = windmod.dispersion_from_sums(sums)
        else:
            # fixed efficiency (vs08): the kick speed does not depend on
            # the dispersion, but a star must have a positive one (the
            # JAX package's wind speed scale)
            vdisp_g = torch.full((ng,), float(np.float32(
                max(par.wind_speed, 1e-3))), device=dev)
        full = lambda x: torch.cat([x.new_zeros(n), x])[perm]
        v, ut, nsel = windmod.wind_hits(par, w, full(sums["w"]),
                                        full(vdisp_g), full(g_mass), atime)
        v, ut, nsel = v[:n], ut[:n], nsel[:n]
        kicked = (nsel > 0) & gas & (delay <= 0)
        vel, ent, delay = windmod.wind_do_kick(
            par, scal["key"], v=v, ut=ut, nsel=nsel, kicked=kicked,
            pid=st["pid"], vel=st["vel"], entropy=st["entropy"],
            density=st["density"], delay_time=delay, atime=atime)
        upd.update(vel=vel, entropy=ent)
        stats["n_kicked"] = int(coll.psum(kicked.sum(), mesh))
    # the decoupling timers of every gas row advance over the interval
    delay = windmod.winds_decouple_update(
        par, delay, st["density"], float(np.float32(scal["dtime"])), atime)
    upd["delay_time"] = torch.where(gas, delay, st["delay_time"])
    return upd, stats
