"""Sharded SPH: the density and hydro loops over slab domains with ghosts.

PyTorch port of mpgadget_tpu/parallel/sph.py.  The reference serves every
neighbour loop through its treewalk export/import machinery
(treewalk.c:325-902, used by density.c:235 and hydra.c:154); here ghost
strips (decomp.ghost_strips_multi) play that part.  A strip is as wide as
the GLOBAL maximum smoothing length (one all-reduce maximum) times a
margin, and never narrower than the tree's cut-off: the symmetric search
(treewalk.h:13-16) needs every j with r_ij < max(h_i, h_j), which a strip
of the largest h covers from both sides.

Each rank runs the single-device loops on its rows and the ghosts:
sph/density.sph_density (the neighbour walk K3 and the density sums K4,
the hsml bisection a host loop) with only the rank's own gas as targets,
and sph/hydra.hydro_force (K3 symmetric, the hydro sums K5).  The density
solve stays rank-local; its ghosts carry the positions, velocities,
masses, smoothing lengths and entropy variables, and the hydro ghosts the
ten converged columns.  Nothing here has a capacity: the strips move
exactly the rows they need.

The strip check is a correctness rule: ghost hsml is never read by the
gather density, but a target's hsml may grow past the strip during its
bisection, and then it would miss neighbours.  A solve whose converged
hsml, one growth step (1.26) wider, reaches beyond the strip anywhere is
run again with a strip 1.5 times wider (strip_ok False: the caller
re-runs, as the JAX package's driver does).
"""

import numpy as np
import torch

from ..sph.density import sph_density
from ..sph.hydra import hydro_force
from . import collectives as coll
from .decomp import ghost_hops, ghost_strips_multi

DENSITY_MARGIN = 1.6    # bisection growth (1.26 a pass) plus slack
HYDRO_MARGIN = 1.05     # converged hsml: the largest one suffices
STRIP_GROWTH = 1.26     # one bisection growth step
STRIP_WIDEN = 1.5       # the margin's factor on a strip re-run

DENSITY_OUT = ("hsml", "numngb", "density", "egy_wt_density",
               "dhsml_density_factor", "dhsml_egy_factor", "div_vel",
               "curl_vel", "dt_hsml")
HYDRO_OUT = ("hydro_accel", "dt_entropy", "max_signal_vel", "pressure")

f32 = np.float32


def global_hmax_box(hsml, gas, mesh, boxsize):
    """The largest smoothing length of the gas over all ranks, in box units
    (float32, one all-reduce maximum)."""
    hs = torch.where(gas, hsml * float(f32(1.0 / boxsize)), 0.0)
    loc = hs.max() if hs.numel() else torch.zeros(
        (), dtype=torch.float32, device=hsml.device)
    return f32(float(coll.pmax(loc, mesh)))


def strip_width(hmax_box, margin, rcut_box=0.0):
    """The ghost strip's width in box units (_strip_width): the largest
    hsml times margin, at least rcut_box, in float32."""
    return float(max(f32(hmax_box) * f32(margin), f32(rcut_box)))


def strip_overrun(hsml, gas, mesh, boxsize, width):
    """True on every rank when some gas row's hsml, one growth step wider,
    reaches beyond the strip (one all-reduce sum)."""
    bad = (gas & (hsml * float(f32(1.0 / boxsize * STRIP_GROWTH))
                  > float(width))).any()
    return bool(int(coll.psum(bad.to(torch.int32), mesh)) > 0)


def gas_ghosts(cols, ipos, gas, mesh, bounds, width):
    """Ghost rows of this rank's gas within ``width`` (box units) of the
    other ranks' slabs, over as many ring hops as the width needs."""
    gi = torch.nonzero(gas).squeeze(1)
    return ghost_strips_multi(tuple(c[gi] for c in cols), ipos[gi], mesh,
                              bounds, width, ghost_hops(bounds, width))


def density_local(ipos_a, mass_a, gas_a, hsml_a, vel_a, entvar_a, n, par,
                  boxsize, target_mask, do_egy_density=True):
    """The single-device density solve over a rank's n rows followed by
    its ghosts; the targets are target_mask (its own rows only).  Returns
    the DENSITY_OUT columns of the n rows."""
    out = sph_density(ipos_a, mass_a, gas_a, hsml_a, vel_a, vel_a, entvar_a,
                      par, boxsize, do_egy_density=do_egy_density,
                      target_mask=target_mask)
    return {k: out[k][:n] for k in DENSITY_OUT}


def sharded_sph_density(ipos, vel, mass, gas, hsml, entvar, mesh, bounds,
                        par, boxsize, *, rcut_box=0.0,
                        margin=DENSITY_MARGIN, do_egy_density=True,
                        target_mask=None):
    """The density of this rank's gas (sharded_sph_density's function):
    ghosts of the gas within the strip, the solve with this rank's gas as
    targets (or target_mask of them).  Returns (DENSITY_OUT columns of
    this rank's rows, strip_ok): strip_ok is False on every rank when the
    strip was too narrow (run again with the margin STRIP_WIDEN times
    wider)."""
    n = ipos.shape[0]
    w = strip_width(global_hmax_box(hsml, gas, mesh, boxsize), margin,
                    rcut_box)
    g = gas_ghosts((ipos, vel, mass, hsml, entvar), ipos, gas, mesh,
                   bounds, w)
    ng = g[0].shape[0]
    tgt = torch.ones(n, dtype=torch.bool, device=ipos.device) \
        if target_mask is None else target_mask
    cat = [torch.cat([a, b]) for a, b in
           zip((ipos, vel, mass, hsml, entvar), g)]
    out = density_local(
        cat[0], cat[2], torch.cat([gas, gas.new_ones(ng)]), cat[3], cat[1],
        cat[4], n, par, boxsize, torch.cat([tgt, tgt.new_zeros(ng)]),
        do_egy_density)
    return out, not strip_overrun(out["hsml"], gas, mesh, boxsize, w)


HYDRO_GHOST_COLS = ("ipos", "vel", "mass", "hsml", "entvar", "density",
                    "egywt", "divv", "curlv", "dhsml_egy")


def sharded_hydro(cols, gas, mesh, bounds, par, boxsize, atime, hubble,
                  dloga, margin=HYDRO_MARGIN):
    """The hydro force of this rank's gas (sharded_hydro's function).
    cols: this rank's columns HYDRO_GHOST_COLS (entvar the predicted
    entropy variable, the rest the converged density outputs); the ghosts
    carry all ten, so that the symmetric search sees every neighbour's
    hsml.  The strip takes the global maximum of the converged hsml.
    Returns the HYDRO_OUT columns of this rank's rows."""
    n = cols["ipos"].shape[0]
    w = strip_width(global_hmax_box(cols["hsml"], gas, mesh, boxsize),
                    margin)
    src = tuple(cols[k] for k in HYDRO_GHOST_COLS)
    g = gas_ghosts(src, cols["ipos"], gas, mesh, bounds, w)
    ng = g[0].shape[0]
    a = dict(zip(HYDRO_GHOST_COLS, (torch.cat([x, y]) for x, y in
                                    zip(src, g))))
    res = hydro_force(a["ipos"], a["mass"],
                      torch.cat([gas, gas.new_ones(ng)]), a["hsml"],
                      a["vel"], a["entvar"], a["density"], a["egywt"],
                      a["divv"], a["curlv"], a["dhsml_egy"], par, boxsize,
                      atime, hubble, dloga)
    return {k: res[k][:n] for k in HYDRO_OUT}
