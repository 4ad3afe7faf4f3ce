"""Black holes: Bondi accretion, gas swallowing, thermal and kinetic
feedback, dynamical friction, mergers, repositioning and FOF seeding
(PyTorch port of mpgadget_tpu/physics/blackhole.py, after
libgadget/blackhole.c, bhdynfric.c and fof_seed in fof.c).

The per-BH neighbour sums (density, smoothed entropy, gas velocity,
feedback weights; the dynamical-friction environment; the potential
minimum) walk a tree of BHs and their sources with K3 (BH targets, each
group's radius its largest BH Hsml) and sum with ops/pairs.pair_reduce.
Swallowing is a gas-side pass: a symmetric K3 walk through the node hmax
of the BHs' Hsml, each gas particle summing its swallow probability
p = (M_BH - M_dyn) wk / rho (blackhole.c:577-614), its feedback energy and
kick over the BHs that reach it.  Operations over the BH set itself
(mergers, seeding) run on the host in numpy: black holes are few, and
these are O(N_BH) scalar updates.
"""

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import constants as C
from ..utils import threefry
from .sfr import id_uniform

# Eddington rate per unit BH mass, cgs (blackhole.c:373-414)
_EDD = (4 * np.pi * C.GRAVITY * C.LIGHTCGS * C.PROTONMASS
        / (0.1 * C.LIGHTCGS ** 2 * C.THOMPSON))


@dataclass
class BHParams:
    accretion_factor: float = 100.0
    eddington_factor: float = 2.1
    feedback_factor: float = 0.05
    seed_mass: float = 2e-5
    ngb_factor: float = 2.0
    min_fof_mass_for_seed: float = 2.0
    min_mstar_for_seed: float = 5e-4
    seed_bh_dyn_mass: float = -1.0
    reposition_enabled: bool = False
    kinetic_on: bool = False
    merge_grav_bound: bool = True
    # dynamical friction (bhdynfric.c set_blackhole_dynfric_params)
    dynfric_method: int = 0     # 0 off, 1 stars, 2 +DM, 3 +gas
    df_boost: float = 1.0
    df_bmax: float = 20.0
    # kinetic feedback (gadget/params.c:232-239)
    ke_eddington_thr_factor: float = 0.05
    ke_eddington_m_factor: float = 0.002
    ke_eddington_m_pivot: float = 0.05
    ke_eddington_m_index: float = 2.0
    ke_eff_rho_factor: float = 0.05
    ke_eff_cap: float = 0.05
    ke_inj_energy_thr: float = 5.0
    ke_sfr_crit_overdensity: float = 57.7


_VEC3 = ("df_accel", "min_pot_pos")


@dataclass
class BhData:
    """Aligned per-particle BH fields (bh_particle_data analog,
    slotsmanager.h:29-68)."""
    bh_mass: torch.Tensor      # f32[N] subgrid mass
    mdot: torch.Tensor         # f32[N]
    bh_density: torch.Tensor   # f32[N] gas density at the BH
    mtrack: torch.Tensor       # f32[N]
    formation_time: torch.Tensor  # f32[N]
    count_progs: torch.Tensor  # int32[N]
    df_accel: torch.Tensor     # f32[N,3] dynamical friction accel
    kinetic_energy: torch.Tensor  # f32[N] stored KineticFdbkEnergy
    vdisp: torch.Tensor        # f32[N] 1D DM velocity dispersion
    min_pot_pos: torch.Tensor  # f32[N,3] potential-minimum position

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    @staticmethod
    def _dtype(name):
        return torch.int32 if name == "count_progs" else torch.float32

    @classmethod
    def zeros(cls, n: int, device="cuda"):
        return cls(**{f.name: torch.zeros(
            (n, 3) if f.name in _VEC3 else (n,), dtype=cls._dtype(f.name),
            device=device) for f in dataclasses.fields(cls)})

    @classmethod
    def from_jax_numpy(cls, arrays: dict, device="cuda"):
        """Carry JAX BhData state (as numpy arrays, one per field) over
        into the port's tensors."""
        return cls(**{f.name: torch.as_tensor(
            np.asarray(arrays[f.name])).to(dtype=cls._dtype(f.name),
                                           device=device)
            for f in dataclasses.fields(cls)})


def _bh_pair_setup(ipos, mass, hsml, include, is_bh, boxsize,
                   caller="BH sums"):
    """Shared set-up of the BH-target passes: the tree over `include`, its
    target groups and their K3 neighbour lists, each group's search
    radius its largest BH hsml.  Returns (tree, nbr, perm, inv,
    pos_box)."""
    from ..ops import pairs
    from ..sph.density import group_radius, sorted_tree
    n = ipos.shape[0]
    perm, inv, pos_box, _, tree, (nodes, gc, gh) = sorted_tree(
        ipos, mass, include, 32)
    hs = (hsml * float(np.float32(1.0 / boxsize)))[perm]
    gradius = group_radius(tree, nodes, torch.where(is_bh[perm], hs, 0.0),
                           32)
    nbr, _ = pairs.spanned(
        caller, "K3", pairs.find_neighbors_auto, tree, nodes, gc, gh,
        gradius, None, 64, symmetric=False, cache_key=("bh_pair", n))
    return tree, nbr, perm, inv, pos_box


def bh_neighbor_sums(ipos, mass, hsml, velpred, entropy, is_bh, is_gas,
                     boxsize, kernel_type=2):
    """BH accretion treewalk sums (blackhole_accretion_ngbiter): per-BH
    rho, smoothed entropy, mass-weighted gas velocity, feedback weight sum
    and the enclosed gas mass (MgasEnc for kinetic feedback,
    blackhole.c:643-648).  Returns a dict of [N] tensors (nonzero only at
    BH rows)."""
    from ..ops import pairs
    from ..sph import kernels as K
    include = is_bh | is_gas
    tree, nbr, perm, inv, pos_box = _bh_pair_setup(
        ipos, mass, hsml, include, is_bh, boxsize)
    L = boxsize

    def pair_fn(dx, r, tmask, smask, tfeat, sfeat):
        ri = r * L
        h = tfeat["hsml"]
        inside = (ri < h) & (tfeat["isbh"] > 0) & (sfeat["isgas"] > 0)
        hinv = 1.0 / torch.clamp(h, min=1e-30)
        wk = torch.where(inside, K.kernel_wk(ri * hinv, hinv, kernel_type),
                         0.0)
        mj = sfeat["mass"]
        v = sfeat["v"]
        return {"rho": mj * wk, "fbweight": mj * wk,
                "ent": mj * wk * sfeat["entropy"],
                "vx": mj * wk * v[..., 0], "vy": mj * wk * v[..., 1],
                "vz": mj * wk * v[..., 2],
                "mgas": torch.where(inside, mj, 0.0)}

    out = pairs.spanned(
        "BH sums", "pair_reduce", pairs.pair_reduce, pair_fn, nbr, tree,
        pos_box,
        {"hsml": hsml[perm], "isbh": is_bh[perm].to(torch.float32)},
        {"mass": torch.where(is_gas[perm], mass[perm], 0.0),
         "v": velpred[perm], "entropy": entropy[perm],
         "isgas": is_gas[perm].to(torch.float32)},
        {k: "sum" for k in ("rho", "fbweight", "ent", "vx", "vy", "vz",
                            "mgas")}, 32, pairs.leaf_eval_cap(tree, 16))
    return {k: v[inv] for k, v in out.items()}


def bh_dynfric_raw(ipos, mass, hsml, velpred, is_bh, src_mask, boxsize,
                   kernel_type=2):
    """The dynamical-friction environment's kernel-weighted sums around
    each BH (blackhole_dynfric_ngbiter, bhdynfric.c:233-270): rho, the
    mass-weighted velocity vx, vy, vz and squared speed v2 of the sources
    in src_mask.  Returns a dict of [N] (partial sums where the sources
    are one rank's rows)."""
    from ..ops import pairs
    from ..sph import kernels as K
    include = is_bh | src_mask
    tree, nbr, perm, inv, pos_box = _bh_pair_setup(
        ipos, mass, hsml, include, is_bh, boxsize, caller="BH dynfric")
    L = boxsize

    def pair_fn(dx, r, tmask, smask, tfeat, sfeat):
        ri = r * L
        h = tfeat["hsml"]
        inside = (ri < h) & (tfeat["isbh"] > 0) & (sfeat["issrc"] > 0)
        hinv = 1.0 / torch.clamp(h, min=1e-30)
        wk = torch.where(inside, K.kernel_wk(ri * hinv, hinv, kernel_type),
                         0.0)
        mwk = sfeat["mass"] * wk
        v = sfeat["v"]
        return {"rho": mwk, "vx": mwk * v[..., 0], "vy": mwk * v[..., 1],
                "vz": mwk * v[..., 2],
                "v2": mwk * (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                             + v[..., 2] * v[..., 2])}

    out = pairs.spanned(
        "BH dynfric", "pair_reduce", pairs.pair_reduce, pair_fn, nbr, tree,
        pos_box,
        {"hsml": hsml[perm], "isbh": is_bh[perm].to(torch.float32)},
        {"mass": torch.where(src_mask[perm], mass[perm], 0.0),
         "v": velpred[perm], "issrc": src_mask[perm].to(torch.float32)},
        {k: "sum" for k in ("rho", "vx", "vy", "vz", "v2")}, 32,
        pairs.leaf_eval_cap(tree, 16))
    return {k: v[inv] for k, v in out.items()}


def dynfric_environment(s):
    """(rho, mean velocity [N,3], rms speed) from :func:`bh_dynfric_raw`'s
    sums."""
    rho = s["rho"]
    safe = torch.clamp(rho, min=1e-30)
    vel = torch.stack([s["vx"], s["vy"], s["vz"]], dim=-1) / safe[:, None]
    rmsvel = torch.sqrt(torch.clamp(s["v2"] / safe, min=0.0))
    return {"rho": rho, "vel": vel, "rmsvel": rmsvel}


def bh_dynfric_sums(ipos, mass, hsml, velpred, is_bh, src_mask,
                    boxsize, kernel_type=2):
    """Dynamical-friction environment sums (blackhole_dynfric_ngbiter,
    bhdynfric.c:233-270): kernel-weighted density, mean velocity and mean
    squared velocity of the background around each BH.  Returns a dict
    of [N]: rho, vel [N,3], rmsvel (normalized)."""
    return dynfric_environment(bh_dynfric_raw(
        ipos, mass, hsml, velpred, is_bh, src_mask, boxsize, kernel_type))


def dynfric_accel(rho, vel_sur, rmsvel, mass_dyn, vel, atime, G,
                  bmax=20.0, boost=1.0):
    """Chandrasekhar dynamical friction in the Gizmo form
    (blackhole_compute_dfaccel, bhdynfric.c:84-145):
      a_DF = -4 pi G^2 M rho ln(Lambda) f(x) dv / |dv|^3 * a * boost
      f(x) = erf(x) - 2 x exp(-x^2)/sqrt(pi),  x = |dv|/(sqrt2 sigma/3)
      Lambda = 1 + bmax |dv_phys|^2 / (G M).
    Internal (comoving) units; accel [N,3], float64 where the JAX
    package's numpy constants promote it."""
    dv = vel - vel_sur
    bhvel = torch.sqrt(dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1]
                       + dv[:, 2] * dv[:, 2])
    sigma = torch.clamp(rmsvel / 3.0, min=1e-30)
    x = bhvel.double() / (float(np.sqrt(2.0)) * sigma.double())
    # erf via the reference's exp approximation
    a_erf = 8 * (np.pi - 3) / (3 * np.pi * (4.0 - np.pi))
    x2 = x * x
    erf_x = torch.sqrt(torch.clamp(
        1 - torch.exp(-x2 * (4 / np.pi + a_erf * x2) / (1 + a_erf * x2)),
        min=0.0))
    f_of_x = torch.clamp(erf_x - 2 * x / float(np.sqrt(np.pi))
                         * torch.exp(-x2), min=0.0)
    lam = 1.0 + bmax * (bhvel / atime) ** 2 \
        / (G * torch.clamp(mass_dyn, min=1e-30))
    pref = (-4 * np.pi * G * G * mass_dyn * rho * torch.log(lam)).double() \
        * f_of_x / (torch.clamp(bhvel, min=1e-30) ** 3).double() \
        * atime * boost
    pref = torch.where((rho > 0) & (bhvel > 0), pref, 0.0)
    return pref[:, None] * dv.double()


def kinetic_update(par: BHParams, bh_mass, mdot, bh_density, vdisp,
                   mgas_enc, ke_energy, dtime, unit_time_in_s,
                   hubble_param, rho_crit_baryon, unit_velocity):
    """AGN kinetic channel bookkeeping (blackhole.c:437-467): accumulate
    dE = eps mdot c^2 dt while the Eddington ratio is below the
    (mass-dependent) threshold; flag the release when the stored energy
    exceeds BHKE_InjEnergyThr x (1/2) VDisp^2 Mgas_enc.  Returns
    (ke_energy_new, keflag) with keflag 0/1/2."""
    meddington = _EDD * bh_mass * unit_time_in_s / hubble_param
    edd_ratio = mdot / torch.clamp(meddington, min=1e-30)
    lam_thresh = torch.clamp(
        par.ke_eddington_m_factor
        * (bh_mass / par.ke_eddington_m_pivot) ** par.ke_eddington_m_index,
        max=par.ke_eddington_thr_factor)
    accumulating = edd_ratio < lam_thresh
    rho_sfr = par.ke_sfr_crit_overdensity * rho_crit_baryon
    eps = torch.clamp(bh_density / rho_sfr / par.ke_eff_rho_factor,
                      max=par.ke_eff_cap)
    de = eps * mdot * dtime * (C.LIGHTCGS / unit_velocity) ** 2
    ke_new = torch.where(accumulating, ke_energy + de, ke_energy)
    thresh = 0.5 * vdisp * vdisp * mgas_enc * par.ke_inj_energy_thr
    release = (vdisp > 0) & (ke_new > thresh)
    keflag = torch.where(release, 2,
                         torch.where(accumulating, 1, 0)).to(torch.int32)
    return ke_new, keflag


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def bh_mergers(par: BHParams, *, pos, vel, accel, df_accel, pid, is_bh,
               boxsize, atime, softening):
    """BH-BH mergers (blackhole_accretion_ngbiter BH branch,
    blackhole.c:495-560 + check_grav_bound :163-181), on the host in
    numpy: BHs are few and the swallow-ID resolution is sequential.  Two
    BHs merge when r < 2 x softening and, with MergeGravBound, when
    KE/a^2 + (da.dx)/a <= 0.  The larger ID swallows.  Returns a dict of
    the swallowed rows and, row by row, their swallowers."""
    rows = np.nonzero(_host(is_bh))[0]
    nb = len(rows)
    out = {"swallowed": np.zeros(0, np.int64),
           "swallower": np.zeros(0, np.int64)}
    if nb < 2:
        return out
    p = np.asarray(_host(pos), np.float64)[rows]
    v = np.asarray(_host(vel), np.float64)[rows]
    a_full = (np.asarray(_host(accel), np.float64)
              + np.asarray(_host(df_accel), np.float64))[rows]
    ids = _host(pid)[rows]
    dx = p[:, None, :] - p[None, :, :]
    dx -= np.round(dx / boxsize) * boxsize
    r = np.linalg.norm(dx, axis=-1)
    close = (r < 2 * softening) & ~np.eye(nb, dtype=bool)
    if par.merge_grav_bound:
        dv = v[:, None, :] - v[None, :, :]
        da = a_full[:, None, :] - a_full[None, :, :]
        ke = 0.5 * np.sum(dv * dv, axis=-1) / atime ** 2
        pe = np.sum(da * dx, axis=-1) / atime
        close &= (ke + pe) <= 0
    # larger ID swallows smaller (blackhole.c:545-552)
    swallower_of = np.full(nb, -1, np.int64)
    order = np.argsort(-ids.astype(np.int64), kind="stable")
    for i in order:            # big IDs claim prey first
        for j in range(nb):
            if close[i, j] and ids[i] > ids[j] \
                    and swallower_of[j] < 0 and swallower_of[i] < 0:
                swallower_of[j] = i
    for j in range(nb):        # collapse chains
        k = swallower_of[j]
        while k >= 0 and swallower_of[k] >= 0:
            k = swallower_of[k]
        swallower_of[j] = k
    sw = np.nonzero(swallower_of >= 0)[0]
    out["swallowed"] = rows[sw]
    out["swallower"] = rows[swallower_of[sw]]
    return out


def bondi_accretion(par: BHParams, bh_mass, rho_com, entropy_sm, gasvel,
                    vel, atime, G, unit_time_in_s, hubble_param, dtime):
    """Bondi-Hoyle rate with the Eddington cap
    (blackhole_accretion_postprocess, blackhole.c:373-414).  Returns
    (mdot, accreted mass)."""
    a3inv = 1.0 / atime ** 3
    meddington = _EDD * bh_mass * unit_time_in_s / hubble_param
    safe_rho = torch.clamp(rho_com, min=1e-30)
    ent = entropy_sm / safe_rho
    vgas = gasvel / safe_rho[:, None]
    cs = torch.sqrt(C.GAMMA * torch.clamp(ent, min=0.0)
                    * safe_rho ** C.GAMMA_MINUS1) \
        * atime ** (-1.5 * C.GAMMA_MINUS1)
    d = vel - vgas
    bhvel = torch.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2 + d[:, 2] ** 2) / atime
    norm = (cs * cs + bhvel * bhvel) ** 1.5
    mdot = torch.where(
        (rho_com > 0) & (norm > 0),
        4 * np.pi * par.accretion_factor * G * G * bh_mass * bh_mass
        * (rho_com * a3inv) / torch.clamp(norm, min=1e-30), 0.0)
    if par.eddington_factor > 0:
        mdot = torch.minimum(mdot, par.eddington_factor * meddington)
    return mdot, mdot * dtime


def swallow_and_feedback(par: BHParams, key, *, ipos, mass, hsml, entropy,
                         density, is_bh, is_gas, pid, bh_mass, mdot,
                         bh_density, fbweight, boxsize, atime, dtime,
                         unit_velocity, uu_in_cgs, kernel_type=2,
                         ke_energy=None, keflag=None, mtrack=None):
    """Gas-side pass: stochastic swallowing + thermal (and kinetic)
    feedback (blackhole_feedback_ngbiter, blackhole.c:577-614, 843-880).

    Each gas particle sums its swallow probability and injected energy
    over the BHs that reach it (sources).  Returns (swallowed mask, new
    entropy, swallower BH row (the largest row among the BHs in reach; -1
    for none), kick [N,3])."""
    from ..ops import pairs
    from ..sph import kernels as K
    from ..sph.density import sorted_tree
    n = ipos.shape[0]
    include = is_bh | is_gas
    perm, inv, pos_box, _, tree, (nodes, gc, gh) = sorted_tree(
        ipos, mass, include, 32)
    # search radius: the BHs' hsml through the node hmax (a symmetric
    # search, so that gas targets find BHs with larger hsml)
    group_cap = min((8 * n) // 32 + 64, n + 64)
    leaf_ids, n_leaves, _ = pairs.compact_leaves(tree, group_cap * 4)
    hm = pairs.node_hmax(
        tree, leaf_ids, n_leaves,
        torch.where(is_bh[perm], hsml[perm] / boxsize, 0.0))
    zeros = torch.zeros(gc.shape[0], dtype=torch.float32, device=gc.device)
    nbr, _ = pairs.spanned(
        "swallow", "K3", pairs.find_neighbors_auto, tree, nodes, gc, gh,
        zeros, hm, 64, symmetric=True, cache_key=("bh_feedback", n))

    L = boxsize
    fb_energy = par.feedback_factor * 0.1 * mdot * dtime \
        * (C.LIGHTCGS / unit_velocity) ** 2
    if keflag is not None:
        # the kinetic channel suppresses thermal feedback this step
        # (blackhole.c:928-933)
        fb_energy = torch.where(keflag > 0, 0.0, fb_energy)
    if ke_energy is None or keflag is None:
        ke_rel = torch.zeros_like(fb_energy)
    else:
        ke_rel = torch.where(keflag == 2, ke_energy, 0.0)

    def pair_fn(dx, r, tmask, smask, tfeat, sfeat):
        ri = r * L
        h = sfeat["hsml"]
        near = (ri < h) & (sfeat["isbh"] > 0) & (tfeat["isgas"] > 0)
        hinv = 1.0 / torch.clamp(h, min=1e-30)
        wk = torch.where(near, K.kernel_wk(ri * hinv, hinv, kernel_type),
                         0.0)
        bhrho = torch.clamp(sfeat["bhrho"], min=1e-30)
        # swallow probability (blackhole.c:590-594)
        p = torch.where(sfeat["bhrho"] > 0,
                        torch.clamp(sfeat["bhmass"] - sfeat["mdyn"], min=0.0)
                        * wk / bhrho, 0.0)
        # thermal energy share (blackhole.c:843-846)
        du = torch.where(sfeat["fbw"] > 0,
                         sfeat["fbe"] * tfeat["mass"] * wk
                         / torch.clamp(sfeat["fbw"], min=1e-30), 0.0) \
            / torch.clamp(tfeat["mass"], min=1e-30)
        # kinetic kick speed (blackhole.c:870-880)
        dv = torch.where(sfeat["bhrho"] > 0,
                         torch.sqrt(2.0 * sfeat["ke"] * wk / bhrho), 0.0)
        return {"p": p, "du": du, "dv": dv,
                "bhrow": torch.where(near, sfeat["row"], -1.0)}

    rows = torch.arange(n, dtype=torch.float32, device=ipos.device)[perm]
    # sub-resolution accretion: while Mtrack < SeedBHDynMass the swallow
    # probability uses Mtrack, not the dynamical mass (blackhole.c:583-588)
    mdyn = mass
    if mtrack is not None and par.seed_bh_dyn_mass > 0:
        mdyn = torch.where(is_bh & (mtrack < par.seed_bh_dyn_mass), mtrack,
                           mass)
    out = pairs.spanned(
        "swallow", "pair_reduce", pairs.pair_reduce, pair_fn, nbr, tree,
        pos_box,
        {"isgas": is_gas[perm].to(torch.float32), "mass": mass[perm]},
        {"hsml": torch.where(is_bh, hsml, 0.0)[perm],
         "isbh": is_bh[perm].to(torch.float32), "bhmass": bh_mass[perm],
         "mdyn": mdyn[perm], "bhrho": bh_density[perm],
         "fbw": fbweight[perm], "fbe": fb_energy[perm], "ke": ke_rel[perm],
         "row": rows},
        {"p": "sum", "du": "sum", "dv": "sum", "bhrow": "max"}, 32,
        pairs.leaf_eval_cap(tree, 16))
    p = out["p"][inv]
    du = out["du"][inv]
    dv = out["dv"][inv]
    bhrow = out["bhrow"][inv]
    bhrow = torch.where(bhrow >= 0, bhrow, -1.0).to(torch.int64)
    # random unit direction per gas particle (get_random_dir analog)
    u1 = id_uniform(threefry.fold_in(key, 11), pid)
    u2 = id_uniform(threefry.fold_in(key, 13), pid)
    ct = 2.0 * u1 - 1.0
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    phi = 2.0 * np.pi * u2
    kick = dv[:, None] * torch.stack(
        [st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
    draw = id_uniform(key, pid)
    swallowed = is_gas & (draw < p) & (bhrow >= 0)
    # cap the injected temperature at 5e8 K (add_injected_BH_energy)
    u_to_temp = (4 / (8 - 5 * (1 - C.HYDROGEN_MASSFRAC))) \
        * C.PROTONMASS / C.BOLTZMANN * C.GAMMA_MINUS1 * uu_in_cgs
    a3inv = 1.0 / atime ** 3
    enttou = (density * a3inv) ** C.GAMMA_MINUS1 / C.GAMMA_MINUS1
    u_new = entropy * enttou + du
    u_new = torch.clamp(u_new, max=5.0e8 / u_to_temp)
    ent_new = torch.where(is_gas & (du > 0),
                          u_new / torch.clamp(enttou, min=1e-30), entropy)
    kick = torch.where(is_gas[:, None], kick, 0.0)
    return swallowed, ent_new, bhrow, kick


def seed_black_holes(par: BHParams, cat, pdata, bh: BhData, sph, atime):
    """FOF-based seeding (fof_seed, fof.c + run.c:626-630): halos above the
    mass and stellar-mass thresholds without a BH get one, converting
    their densest gas member; on the host over the (small) catalogue.
    Returns (pdata, bh, n_seeded)."""
    gi = np.asarray(cat["group_index"])
    ngroups = cat["ngroups"]
    if ngroups == 0:
        return pdata, bh, 0
    ptype = pdata.ptype.cpu().numpy()
    valid = pdata.valid.cpu().numpy()
    masses = cat["masses"]
    mstar = cat["mass_by_type"][:, 4]
    has_bh = np.zeros(ngroups, bool)
    sel_bh = valid & (ptype == 5) & (gi >= 0)
    if sel_bh.any():
        has_bh[np.unique(gi[sel_bh])] = True
    eligible = (masses > par.min_fof_mass_for_seed) \
        & (mstar > par.min_mstar_for_seed) & (~has_bh)
    dens = (sph.density if sph is not None else pdata.mass).cpu().numpy()
    new_bh_rows = []
    for g in np.nonzero(eligible)[0]:
        members = np.nonzero((gi == g) & valid & (ptype == 0))[0]
        if len(members) == 0:
            continue
        new_bh_rows.append(members[np.argmax(dens[members])])
    if not new_bh_rows:
        return pdata, bh, 0
    rows = torch.as_tensor(np.array(new_bh_rows), device=pdata.device)

    def put(arr, val):
        out = arr.clone()
        out[rows] = val if not isinstance(val, torch.Tensor) \
            else val.to(out.dtype)
        return out

    mtrack = put(bh.mtrack, pdata.mass[rows])
    pdata = pdata.replace(ptype=put(pdata.ptype, 5))
    bh = bh.replace(
        bh_mass=put(bh.bh_mass, float(np.float32(par.seed_mass))),
        mtrack=mtrack,
        formation_time=put(bh.formation_time, float(np.float32(atime))))
    if par.seed_bh_dyn_mass > 0:
        # fixed seed dynamical mass (blackhole_make, blackhole.c:1100)
        pdata = pdata.replace(mass=put(
            pdata.mass, float(np.float32(par.seed_bh_dyn_mass))))
    return pdata, bh, len(new_bh_rows)


def bh_minpot(ipos, hsml, potential, vel, src_mask, is_bh, boxsize):
    """Minimum-potential neighbour per BH within its kernel
    (blackhole_minpot_ngbiter, bhdynfric.c:199-231): two pair passes, the
    max of -Potential, then a gather of the matching neighbour's offset
    and velocity.  Returns (minpot_pos f32[N,3] internal units,
    minpot_vel f32[N,3], found bool[N]), valid where is_bh."""
    from ..ops import pairs
    n = ipos.shape[0]
    include = src_mask | is_bh
    ones = torch.ones(n, dtype=torch.float32, device=ipos.device)
    tree, nbr, perm, inv, pos_box = _bh_pair_setup(
        ipos, ones, hsml, include, is_bh, boxsize, caller="minpot")
    LE = pairs.leaf_eval_cap(tree, 16)
    inv_box = 1.0 / boxsize
    hsml_s = torch.where(is_bh, hsml, 0.0)[perm] * inv_box
    pot_s = potential[perm]
    src_s = src_mask[perm].to(torch.float32)
    BIG = 1e30

    def key_fn(dx, r, tmask, smask, tfeat, sfeat):
        near = (r < tfeat["hsml"]) & (sfeat["src"] > 0)
        return {"negpot": torch.where(near, -sfeat["pot"], -BIG)}

    out1 = pairs.spanned(
        "minpot", "pair_reduce", pairs.pair_reduce, key_fn, nbr, tree,
        pos_box, {"hsml": hsml_s}, {"pot": pot_s, "src": src_s},
        {"negpot": "max"}, 32, LE)
    minpot_s = -out1["negpot"]

    def sel_fn(dx, r, tmask, smask, tfeat, sfeat):
        near = (r < tfeat["hsml"]) & (sfeat["src"] > 0)
        sel = near & (sfeat["pot"] <= tfeat["minpot"] + 1e-30)
        w = sel.to(torch.float32)
        # positions relative to the target (periodic-safe), vel direct
        res = {"n": w}
        for k in range(3):
            res[f"dx{k}"] = w * dx[..., k]
            res[f"v{k}"] = w * sfeat["vel"][..., k]
        return res

    red = {"n": "sum"}
    red.update({f"dx{k}": "sum" for k in range(3)})
    red.update({f"v{k}": "sum" for k in range(3)})
    out2 = pairs.spanned(
        "minpot", "pair_reduce", pairs.pair_reduce, sel_fn, nbr, tree,
        pos_box, {"hsml": hsml_s, "minpot": minpot_s},
        {"pot": pot_s, "src": src_s, "vel": vel[perm]}, red, 32, LE)
    cnt = torch.clamp(out2["n"], min=1.0)
    dxm = torch.stack([out2[f"dx{k}"] / cnt for k in range(3)], dim=-1)
    vm = torch.stack([out2[f"v{k}"] / cnt for k in range(3)], dim=-1)
    pos_min_box = torch.remainder(pos_box + dxm, 1.0)
    found = (out2["n"] > 0)[inv] & is_bh
    return pos_min_box[inv] * boxsize, vm[inv], found


def apply_mtrack_accretion(mass, mtrack, acc_mass, acc_mom, vel, is_bh,
                           seed_bh_dyn_mass):
    """Route swallowed gas mass into Mtrack or the dynamical mass
    (blackhole_feedback_postprocess, blackhole.c:960-978).  Returns
    (mass, mtrack, vel)."""
    newvel = torch.where(
        (acc_mass > 0)[:, None],
        (vel * mass[:, None] + acc_mom)
        / torch.clamp(mass + acc_mass, min=1e-30)[:, None], vel)
    dyn = seed_bh_dyn_mass
    if dyn <= 0:
        return mass + torch.where(is_bh, acc_mass, 0.0), mtrack, newvel
    seed_regime = is_bh & (mtrack + acc_mass < dyn)
    transition = is_bh & (~seed_regime) & (mtrack < dyn)
    regular = is_bh & (mtrack >= dyn)
    new_mass = torch.where(transition, mtrack + acc_mass,
                           torch.where(regular, mass + acc_mass, mass))
    new_mtrack = torch.where(seed_regime, mtrack + acc_mass,
                             torch.where(transition, dyn, mtrack))
    return new_mass, new_mtrack, newvel
