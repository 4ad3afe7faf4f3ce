"""Galactic winds (PyTorch port of mpgadget_tpu/physics/winds.py, after
libgadget/winds.c and veldisp.c).

Wind models as flag combinations (winds.c:60-100):
* sh03  = subgrid + decouple + fixed efficiency
* vs08  = fixed efficiency
* ofjt10 = halo (velocity-dispersion scaled) + decouple (default)

The subgrid model kicks the star-forming gas itself after star formation
(winds_make_after_sf, winds.c:572-589); the halo model scales the wind
speed with the local DM velocity dispersion (veldisp.c), a neighbour-pair
reduction over a tree of DM and gas.  The other models kick the gas
neighbours of new stars (:func:`winds_via_neighbors`: three pair passes
over one tree).  Every pass walks the tree with K3 (ops/pairs.py) and sums
its pairs with ops/pairs.pair_reduce.  Decoupled particles (DelayTime > 0)
skip hydro forces and recouple by time or density (winds.c:113-136).

The draws equal the JAX package's bit for bit: physics/sfr.id_uniform, and
:func:`pair_uniform`'s uint32 hash spelled in int64 with the wrap-around
explicit.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import constants as C
from .cooling import _rdiv
from .sfr import MASK32, _mul32, id_uniform

WIND_SUBGRID = 1
WIND_DECOUPLE_SPH = 2
WIND_USE_HALO = 4
WIND_FIXED_EFFICIENCY = 8


@dataclass
class WindParams:
    model: int = WIND_USE_HALO | WIND_DECOUPLE_SPH  # ofjt10
    efficiency: float = 2.0          # WindEfficiency
    energy_fraction: float = 1.0     # WindEnergyFraction
    sigma0: float = 353.0            # km/s
    speed_factor: float = 3.7
    free_travel_length: float = 20.0
    free_travel_dens_fac: float = 0.1
    min_wind_velocity: float = 0.0
    thermal_factor: float = 0.0
    max_free_travel_time: float = 60.0  # Myr (converted by init)
    # derived
    wind_speed: float = 0.0
    free_travel_dens_thresh: float = 0.0


def init_winds(par: WindParams, factor_sn, egy_spec_sn,
               phys_dens_thresh, unit_time_in_s):
    """init_winds (winds.c:87-102)."""
    par.wind_speed = np.sqrt(2 * par.energy_fraction * factor_sn
                             * egy_spec_sn / (1 - factor_sn))
    par.max_free_travel_time = (par.max_free_travel_time
                                * C.SEC_PER_MEGAYEAR / unit_time_in_s)
    par.free_travel_dens_thresh = par.free_travel_dens_fac \
        * phys_dens_thresh
    if par.model & WIND_FIXED_EFFICIENCY:
        par.wind_speed /= np.sqrt(par.efficiency)
    return par


def get_wind_kick(par: WindParams, vdisp, atime):
    """(vel, windeff, utherm) per particle (get_wind_params,
    winds.c:497-511).  vdisp in internal velocity units."""
    vphys = vdisp / atime
    utherm = par.thermal_factor * 1.5 * vphys * vphys
    if par.model & WIND_FIXED_EFFICIENCY:
        windeff = torch.full_like(vdisp, par.efficiency)
        vel = torch.full_like(vdisp, par.wind_speed * atime)
    else:  # halo model
        windeff = _rdiv(par.sigma0 ** 2,
                        vphys * vphys + 2 * utherm + 1e-30)
        vel = par.speed_factor * vdisp
    vel = torch.clamp(vel, min=par.min_wind_velocity * atime)
    return vel, windeff, utherm


def _directions(key, pid):
    """Isotropic unit vectors from per-ID deviates (wind_do_kick)."""
    u1 = id_uniform(key, pid + 3)
    u2 = id_uniform(key, pid + 4)
    costheta = 2 * u1 - 1
    sintheta = torch.sqrt(torch.clamp(1 - costheta ** 2, min=0.0))
    phi = 2 * np.pi * u2
    return torch.stack([sintheta * torch.cos(phi),
                        sintheta * torch.sin(phi), costheta], dim=-1)


def _entropy_per_u(density, atime):
    a3inv = 1.0 / atime ** 3
    return (density * a3inv) ** C.GAMMA_MINUS1 / C.GAMMA_MINUS1


def _delay(par, wvel, delay_time, kicked, atime):
    if par.model & WIND_DECOUPLE_SPH and par.max_free_travel_time > 0:
        delay = _rdiv(par.free_travel_length,
                      torch.clamp(wvel / atime, min=1e-30))
        delay = torch.clamp(delay, max=par.max_free_travel_time)
        return torch.where(kicked, delay, delay_time)
    return delay_time


def winds_subgrid(par: WindParams, key, *, sm, mass, pid, vdisp, vel,
                  entropy, density, delay_time, eligible, atime):
    """Subgrid wind kicks after star formation (winds_make_after_sf +
    wind_do_kick, winds.c:454-589).  sm: stellar mass formed this step
    per particle.  Returns updated (vel, entropy, delay_time, kicked)."""
    wvel, windeff, utherm = get_wind_kick(par, vdisp, atime)
    pw = windeff * sm / torch.clamp(mass, min=1e-30)
    prob = 1 - torch.exp(-pw)
    draw = id_uniform(key, pid + 2)
    kicked = eligible & (draw < prob) & (wvel > 0)
    direction = _directions(key, pid)
    vel_new = vel + torch.where(kicked[:, None],
                                wvel[:, None] * direction, 0.0)
    enttou = _entropy_per_u(density, atime)
    ent_new = entropy + torch.where(
        kicked, utherm / torch.clamp(enttou, min=1e-30), 0.0)
    return (vel_new, ent_new, _delay(par, wvel, delay_time, kicked, atime),
            kicked)


def winds_decouple_update(par: WindParams, delay_time, density, dtime,
                          atime):
    """Advance the decoupling timers and recouple by density
    (winds.c:113-136).  dtime: a float or a per-particle tensor."""
    delay = torch.clamp(delay_time - dtime, min=0.0)
    a3inv = 1.0 / atime ** 3
    recouple = density * a3inv < par.free_travel_dens_thresh
    return torch.where(recouple, 0.0, delay)


def dm_dispersion_sums(ipos, vel, mass, is_dm, is_target, boxsize,
                       radius_box=None, radius_per_particle=None,
                       caller="vdisp"):
    """The sums behind the 1D DM velocity dispersion (veldisp.c:35-76):
    per target row the count, sum(v) and sum(v^2) of the DM within the
    search radius, a neighbour-pair reduction over a tree of DM and the
    targets.  radius_box: the fixed radius in box units; or
    radius_per_particle, f32[N] per-TARGET radius in internal units (each
    BH's own Hsml).  Returns {"n", "vx", "vy", "vz", "v2"}, [N] each in
    the input order (partial sums where the DM is one rank's rows)."""
    from ..ops import pairs
    from ..sph.density import group_radius, sorted_tree
    n = ipos.shape[0]
    # the tree holds the targets too; sources are filtered to DM in the
    # pair function
    perm, inv, pos_box, _, tree, (nodes, gc, gh) = sorted_tree(
        ipos, mass, is_dm | is_target, 32)
    if radius_per_particle is not None:
        rad_s = radius_per_particle[perm] * float(np.float32(1.0 / boxsize))
        gradius = group_radius(tree, nodes, rad_s, 32)
    else:
        rad_s = torch.full((n,), radius_box, dtype=torch.float32,
                           device=ipos.device)
        gradius = torch.full((gc.shape[0],), radius_box,
                             dtype=torch.float32, device=ipos.device)
    nbr, _ = pairs.spanned(
        caller, "K3", pairs.find_neighbors_auto, tree, nodes, gc, gh,
        gradius, None, 96, symmetric=False, cache_key=("vdisp", n))

    def pair_fn(dx, r, tmask, smask, tfeat, sfeat):
        near = (r < tfeat["rad"]) & (sfeat["isdm"] > 0)
        w = torch.where(near, 1.0, 0.0)
        v = sfeat["v"]
        return {"n": w, "vx": w * v[..., 0], "vy": w * v[..., 1],
                "vz": w * v[..., 2],
                "v2": w * (v[..., 0] ** 2 + v[..., 1] ** 2 + v[..., 2] ** 2)}

    out = pairs.spanned(
        caller, "pair_reduce", pairs.pair_reduce, pair_fn, nbr, tree,
        pos_box, {"rad": rad_s},
        {"v": vel[perm], "isdm": is_dm[perm].to(torch.float32)},
        {k: "sum" for k in DISPERSION_SUMS}, 32,
        pairs.leaf_eval_cap(tree, 16))
    return {k: v[inv] for k, v in out.items()}


DISPERSION_SUMS = ("n", "vx", "vy", "vz", "v2")


def dispersion_from_sums(s):
    """The 1D dispersion sqrt(max(<v^2> - <v>^2, 0) / 3) from
    :func:`dm_dispersion_sums`' sums (summed over ranks where sharded)."""
    cnt = torch.clamp(s["n"], min=1.0)
    vmean2 = (s["vx"] ** 2 + s["vy"] ** 2 + s["vz"] ** 2) / cnt ** 2
    var3d = torch.clamp(s["v2"] / cnt - vmean2, min=0.0)
    return torch.sqrt(var3d / 3.0)


def dm_velocity_dispersion(ipos, vel, mass, is_dm, is_gas, boxsize,
                           mean_sep, nsearch_radius=2.0,
                           radius_per_particle=None):
    """1D DM velocity dispersion around gas particles (winds_find_vel_disp,
    veldisp.c): a neighbour-pair reduction of sum(v), sum(v^2) and the
    count over DM within the search radius.

    radius_per_particle: optional f32[N] per-TARGET radius in internal
    units (each BH's own Hsml, veldisp.c:60-76); overrides the fixed
    nsearch_radius * mean_sep."""
    caller = "BH vdisp" if radius_per_particle is not None else "vdisp"
    s = dm_dispersion_sums(
        ipos, vel, mass, is_dm, is_gas, boxsize,
        radius_box=nsearch_radius * mean_sep / boxsize,
        radius_per_particle=radius_per_particle, caller=caller)
    return dispersion_from_sums(s)


def pair_uniform(a_ids, b_ids):
    """Deterministic uniform in [0, 1) from two particle-ID tensors (the
    reference's get_random_number(I->ID + P[other].ID) analog,
    winds.c:548): the JAX package's splitmix-style uint32 hash of the ID
    sum, in int64 with every product wrapped to 32 bits."""
    x = (a_ids.to(torch.int64) + b_ids.to(torch.int64)) & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7feb352d)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846ca68b)
    x = x ^ (x >> 16)
    return x.to(torch.float32) * (2.0 ** -32)


def wind_setup(ipos, mass, hsml, pid, delay_time, is_gas, new_star,
               boxsize):
    """The tree over gas + new stars that every pass of
    :func:`winds_via_neighbors` walks, with its sorted features: eligible
    gas (not decoupled), its mass, the stars' hsml (box units) and the
    ids reduced mod 2^24 (exact in float32 features)."""
    from ..ops import pairs
    from ..sph.density import sorted_tree
    G = 32
    perm, inv, pos_box, _, tree, (nodes, gc, gh) = sorted_tree(
        ipos, mass, is_gas | new_star, G)
    eligible_s = is_gas[perm] & (delay_time[perm] <= 0)
    new_star_s = new_star[perm]
    return dict(n=ipos.shape[0], G=G, perm=perm, inv=inv, pos_box=pos_box,
                tree=tree, nodes=nodes, gc=gc, gh=gh,
                LE=pairs.leaf_eval_cap(tree, 16), new_star_s=new_star_s,
                eligible_s=eligible_s,
                gmass_s=torch.where(eligible_s, mass[perm], 0.0),
                hsml_s=torch.where(new_star_s, hsml[perm], 0.0)
                * (1.0 / boxsize),
                pid_s=pid[perm] & 0xFFFFFF)


def wind_weights(w):
    """Pass 1 (sfr_wind_weight, winds.c:299-318, wk = 1): each new star's
    eligible gas mass inside its hsml, [N] in sorted order."""
    from ..ops import pairs
    from ..sph.density import group_radius
    gradius = group_radius(w["tree"], w["nodes"], w["hsml_s"], w["G"])

    def weight_fn(dx, r, tmask, smask, tfeat, sfeat):
        inside = (r < tfeat["hsml"]) & (sfeat["gm"] > 0)
        return {"w": torch.where(inside, sfeat["gm"], 0.0)}

    nbr, w["ll"] = pairs.spanned(
        "wind weight", "K3", pairs.find_neighbors_auto, w["tree"],
        w["nodes"], w["gc"], w["gh"], gradius, None, 256, symmetric=False,
        cache_key=("wind_weight", w["n"]))
    return pairs.spanned(
        "wind weight", "pair_reduce", pairs.pair_reduce, weight_fn, nbr,
        w["tree"], w["pos_box"], {"hsml": w["hsml_s"]}, {"gm": w["gmass_s"]},
        {"w": "sum"}, w["G"], w["LE"])["w"]


def wind_hits(par: WindParams, w, total_weight_s, vd_s, mass_s, atime):
    """Passes 2 and 3 (winds.c:320-345): each gas row's nearest hitting
    star (a 'max' of BIGR - r: kick candidates resolve to the closest
    star) and that star's kick velocity and heat gathered to it.  vd_s,
    mass_s: the stars' dispersion and mass in sorted order (zero off the
    stars).  Returns (v, ut, n) in the input order: the kick speed, heat
    and number of (equally near) kicking stars of each row."""
    from ..ops import pairs
    tree, G, LE = w["tree"], w["G"], w["LE"]
    n = w["n"]
    lf_ids, n_lf, _ = pairs.compact_leaves(tree, 2 * n + 64)
    hmax = pairs.node_hmax(tree, lf_ids, n_lf, w["hsml_s"])
    wvel_s, windeff_s, utherm_s = get_wind_kick(par, vd_s, atime)
    p_s = windeff_s * mass_s / torch.clamp(total_weight_s, min=1e-30)
    star_ok_s = w["new_star_s"] & (total_weight_s > 0) & (wvel_s > 0) \
        & (vd_s > 0)

    def hit(r, tfeat, sfeat):
        u = pair_uniform(sfeat["sid"].to(torch.int64),
                         tfeat["tid"].to(torch.int64))
        return ((r < sfeat["hsml"]) & (sfeat["ok"] > 0)
                & (tfeat["elig"] > 0) & (u < sfeat["p"]))

    BIGR = 4.0

    def near_fn(dx, r, tmask, smask, tfeat, sfeat):
        h = hit(r, tfeat, sfeat)
        return {"rkey": torch.where(h, BIGR - r, -float("inf"))}

    zeros = torch.zeros(w["gc"].shape[0], dtype=torch.float32,
                        device=w["gc"].device)
    nbr2, _ = pairs.spanned(
        "wind kick", "K3", pairs.find_neighbors_auto, tree, w["nodes"],
        w["gc"], w["gh"], zeros, hmax, w.get("ll", 256), symmetric=True,
        cache_key=("wind_kick", n))
    tidf = w["pid_s"].to(torch.float32)
    tfeats = {"tid": tidf, "elig": w["eligible_s"].to(torch.float32)}
    sfeats = {"sid": tidf, "hsml": w["hsml_s"],
              "ok": star_ok_s.to(torch.float32), "p": p_s}
    rkey_s = pairs.spanned(
        "wind kick", "pair_reduce", pairs.pair_reduce, near_fn, nbr2, tree,
        w["pos_box"], tfeats, sfeats, {"rkey": "max"}, G, LE)["rkey"]

    def kick_fn(dx, r, tmask, smask, tfeat, sfeat):
        h = hit(r, tfeat, sfeat)
        # r is the same float32 value the max pass computed for the pair
        sel = h & (torch.abs((BIGR - r) - tfeat["rkey"]) < 1e-9)
        wt = sel.to(torch.float32)
        return {"v": wt * sfeat["v"], "ut": wt * sfeat["ut"], "n": wt}

    out3 = pairs.spanned(
        "wind kick", "pair_reduce", pairs.pair_reduce, kick_fn, nbr2, tree,
        w["pos_box"], dict(tfeats, rkey=rkey_s),
        dict(sfeats, v=torch.where(star_ok_s, wvel_s, 0.0),
             ut=torch.where(star_ok_s, utherm_s, 0.0)),
        {"v": "sum", "ut": "sum", "n": "sum"}, G, LE)
    inv = w["inv"]
    return out3["v"][inv], out3["ut"][inv], out3["n"][inv]


def wind_do_kick(par: WindParams, key, *, v, ut, nsel, kicked, pid, vel,
                 entropy, density, delay_time, atime):
    """wind_do_kick (winds.c:454-489) on the rows in kicked: an isotropic
    kick of the mean kick speed v / nsel, the heat ut / nsel, and the
    decoupling time.  Returns (vel, entropy, delay_time)."""
    nsel = torch.clamp(nsel, min=1.0)
    v_g = v / nsel
    ut_g = ut / nsel
    direction = _directions(key, pid)
    vel_new = vel + torch.where(kicked[:, None], v_g[:, None] * direction,
                                0.0)
    enttou = _entropy_per_u(density, atime)
    ent_new = entropy + torch.where(
        kicked, ut_g / torch.clamp(enttou, min=1e-30), 0.0)
    return vel_new, ent_new, _delay(par, v_g, delay_time, kicked, atime)


def winds_via_neighbors(par: WindParams, key, *, ipos, mass, hsml, pid,
                        vel, entropy, density, delay_time, is_gas,
                        new_star, star_vdisp, boxsize, atime):
    """Non-subgrid wind kicks: gas NEIGHBOURS of newly formed stars are
    stochastically ejected (winds_and_feedback + the sfr_wind_weight /
    feedback ngbiters, winds.c:299-567).

    Three pair passes on one tree over gas + new stars (:func:`wind_setup`):
    (1) each star's total gas weight inside its Hsml (:func:`wind_weights`);
    (2) each gas particle's nearest hitting star and (3) that star's kick
    velocity and heat gathered to the gas (:func:`wind_hits`).  Returns
    (vel, entropy, delay_time, kicked)."""
    w = wind_setup(ipos, mass, hsml, pid, delay_time, is_gas, new_star,
                   boxsize)
    perm = w["perm"]
    total_weight_s = wind_weights(w)
    vd_s = torch.where(w["new_star_s"], star_vdisp[perm], 0.0)
    v, ut, nsel = wind_hits(par, w, total_weight_s, vd_s, mass[perm], atime)
    kicked = (nsel > 0) & is_gas & (delay_time <= 0)
    vel_new, ent_new, delay_new = wind_do_kick(
        par, key, v=v, ut=ut, nsel=nsel, kicked=kicked, pid=pid, vel=vel,
        entropy=entropy, density=density, delay_time=delay_time,
        atime=atime)
    return vel_new, ent_new, delay_new, kicked
