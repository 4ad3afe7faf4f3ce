"""Sharded stellar metal return (metal_return.c:423-500 at scale).

PyTorch port of mpgadget_tpu/parallel/metals.py.  The single-device
physics/metal_return.metal_return_step is gather-formulated (gas targets
gather from star sources), so each rank runs it unchanged on its own rows
and ghost strips of the other ranks' gas and stars
(parallel/sph.gas_ghosts over gas and stars): the rank's gas then
receives every star within reach, and no result travels back.

A ghost star's kernel normalisation (the count pass) needs the star's
whole kernel covered by the rank's rows and ghosts: a star within w of
the slab reaches gas out to w + h, so the strip is twice the largest
smoothing length of stars and gas over all ranks (one all-reduce maximum)
times a margin (1.6: the star hsml bisection's growth and slack).  The
ghost stars' own results are dropped; every star's bookkeeping is written
by its rank from the same data.  Where a star's converged hsml, one growth
step (1.26) wider and doubled, reaches past the strip, the pass runs again
with a strip 1.5 times wider (parallel/sph.strip_overrun's rule); the
caller keeps the wider margin.  Nothing here has a capacity.
"""

import torch

from ..physics import metal_return as mrmod
from ..physics.stars import StarData
from . import collectives as coll
from .sph import (STRIP_WIDEN, gas_ghosts, global_hmax_box, strip_overrun,
                  strip_width)

MARGIN = 1.6
COLS = ("ipos", "mass", "hsml", "density", "gas_mask", "star_mask",
        "star_hsml", "metals", "birth_metallicity", "formation_time",
        "total_mass_returned", "last_enrichment_myr")


def metal_return_pass(st, gas, star, mesh, bounds, atime0, atime1,
                      age_table, params, boxsize, hubble_h, width):
    """The single-device metal return over this rank's rows and the ghosts
    of its gas and stars within width.  Returns the step's outputs of this
    rank's rows."""
    n = st["ipos"].shape[0]
    src = dict(st, gas_mask=gas, star_mask=star)
    cols = tuple(src[k] for k in COLS)
    gh = gas_ghosts(cols, st["ipos"], gas | star, mesh, bounds, width)
    cat = {k: torch.cat([a, b]) for k, a, b in zip(COLS, cols, gh)}
    stars = StarData.zeros(0, st["ipos"].device).replace(
        formation_time=cat["formation_time"],
        metallicity=cat["birth_metallicity"], metals=cat["metals"],
        total_mass_returned=cat["total_mass_returned"],
        last_enrichment_myr=cat["last_enrichment_myr"])
    out = mrmod.metal_return_step(
        cat["ipos"], cat["mass"], cat["hsml"], cat["density"],
        cat["gas_mask"], cat["star_mask"], cat["star_hsml"], stars,
        cat["metals"], atime0, atime1, age_table, boxsize, params,
        hubble_h)
    return {k: v[:n] for k, v in out.items() if torch.is_tensor(v)
            and v.dim() and v.shape[0] == cat["ipos"].shape[0]}


def sharded_metal_return(st, mesh, bounds, atime0, atime1, age_table,
                         params, boxsize, hubble_h=0.7, margin=MARGIN):
    """Stellar mass and metal return on this rank's rows
    (build_sharded_metal_return's step).  st: this rank's columns ipos,
    mass, hsml, density, gas_mask, ptype, star_hsml, metals,
    metallicity, birth_metallicity, formation_time, total_mass_returned,
    last_enrichment_myr.  Returns (updated columns, stats): the gas's
    mass, metals and metallicity (the sum of the species beyond H and He,
    sfr_eff.c's convention) and the stars' mass and bookkeeping; stats
    the margin the strip took (keep it for later calls), the re-runs, and
    the mass returned by this rank's stars and received by its gas, summed
    over ranks."""
    gas = st["gas_mask"]
    star = st["ptype"] == 4
    # a star within the strip reaches gas out to twice its hsml
    hmax2 = 2 * global_hmax_box(torch.maximum(
        torch.where(star, st["star_hsml"], 0.0),
        torch.where(gas, st["hsml"], 0.0)), gas | star, mesh, boxsize)
    reruns = 0
    while True:
        w = strip_width(hmax2, margin)
        out = metal_return_pass(st, gas, star, mesh, bounds, atime0, atime1,
                                age_table, params, boxsize, hubble_h, w)
        if not strip_overrun(2 * out["star_hsml"], star, mesh, boxsize, w):
            break
        margin *= STRIP_WIDEN
        reruns += 1
    upd = {
        "mass": torch.where(gas, out["gas_mass"], torch.where(
            star, out["star_mass"].to(st["mass"].dtype), st["mass"])),
        "metals": torch.where(gas[:, None], out["gas_metals"],
                              st["metals"]),
        "star_hsml": torch.where(star, out["star_hsml"], st["star_hsml"]),
        "total_mass_returned": torch.where(
            star, out["total_mass_returned"].to(torch.float32),
            st["total_mass_returned"]),
        "last_enrichment_myr": torch.where(
            star, out["last_enrichment_myr"], st["last_enrichment_myr"]),
    }
    upd["metallicity"] = torch.where(gas, upd["metals"][:, 2:].sum(dim=1),
                                     st["metallicity"])
    upd = {k: v.to(st[k].dtype) for k, v in upd.items()}
    ret = torch.where(star, upd["total_mass_returned"].double()
                      - st["total_mass_returned"].double(), 0.0).sum()
    rec = torch.where(gas, upd["mass"].double() - st["mass"].double(),
                      0.0).sum()
    tot = coll.psum(torch.stack([ret, rec]), mesh).cpu().numpy()
    return upd, {"margin": margin, "reruns": reruns,
                 "returned": float(tot[0]), "received": float(tot[1])}
