"""Sharded black holes (blackhole.c:216-360 at scale).

PyTorch port of mpgadget_tpu/parallel/blackhole.py.  Black holes are few
and gas rows many, so every rank's BHs go to every rank (one all_gather_v
of their rows, no slot capacity): a BH's kernel reaches the rows of any
rank, as the reference's treewalk exports do (treewalk.c:325).  Each rank
serves the neighbour loops with the single-device passes of
physics/blackhole.py over its own rows with the gathered BHs appended as
extra rows (the neighbour walk K3 and ops/pairs.pair_reduce, plain
PyTorch); the per-BH sums are summed over ranks.  The JAX package's
lax.scans over [chunk, BHs] blocks are not ported.

Covered, as the single-device Simulation.apply_blackholes:
  - the accretion sums (density, smoothed entropy, gas velocity, the
    enclosed gas mass), the dynamical-friction environment and the DM
    dispersion within each BH's hsml, all-reduced
    [blackhole_accretion_ngbiter, bhdynfric.c:233-270, veldisp.c:60-76];
  - Bondi-Hoyle with the Eddington cap, the dynamical-friction
    acceleration and the kinetic channel's bookkeeping on the gathered
    list, the same on every rank [blackhole.c:373-467, bhdynfric.c:84];
  - swallowing and thermal / kinetic feedback on this rank's gas (the
    same per-ID draws: the swallow set does not depend on the ranks)
    [blackhole.c:577-614, 843-880];
  - the swallowed mass and momentum through Mtrack, summed per BH over
    ranks [blackhole.c:960-978];
  - BH-BH mergers on the gathered list, greedy with the bigger ID first
    (the single-device bh_mergers' rule) [blackhole.c:495-560];
  - with reposition, the jump to the minimum-potential neighbour inside
    each BH's kernel: the minimum over ranks, the smaller ID breaking
    ties [bhdynfric.c:199-231 + drift.c:32-49].
Swallowed gas and merged BHs leave their ranks' rows.
"""

import numpy as np
import torch

from ..physics import blackhole as bhmod
from ..physics.winds import DISPERSION_SUMS, dm_dispersion_sums, \
    dispersion_from_sums
from ..ops import pairs
from . import collectives as coll
from .decomp import all_gather_rows

_GATHER = ("ipos", "vel", "mass", "hsml", "pid", "bh_mass", "bh_mtrack",
           "bh_ke", "bh_progs")
INT_MAX = torch.iinfo(torch.int64).max


def _merge_pairs(par, ipos_g, vel_g, acc_g, pid_g, atime, boxsize, soft):
    """The gathered BHs' merger pairs (the JAX package's fori_loop over
    the slot list, in float32): sw_of[j] = the row of j's swallower, -1
    for none.  Two BHs merge when r < 2 soft and, with MergeGravBound,
    KE/a^2 + (da.dx)/a <= 0; a free BH, the biggest ID first, claims every
    free smaller-ID BH in reach."""
    G = ipos_g.shape[0]
    pos = ipos_g.to(torch.float32) * float(2.0 ** -32)
    dxm = pos[:, None, :] - pos[None, :, :]
    dxm = (dxm - torch.round(dxm)) * float(np.float32(boxsize))
    rm = torch.sqrt(torch.sum(dxm * dxm, dim=-1))
    eye = torch.eye(G, dtype=torch.bool, device=pos.device)
    close = ~eye & (rm < 2.0 * float(np.float32(soft)))
    if par.merge_grav_bound:
        a = float(np.float32(atime))
        dvm = vel_g[:, None, :] - vel_g[None, :, :]
        dam = acc_g[:, None, :] - acc_g[None, :, :]
        kem = 0.5 * torch.sum(dvm * dvm, dim=-1) / (a * a)
        pem = torch.sum(dam * dxm, dim=-1) / a
        close = close & ((kem + pem) <= 0)
    claim = (close & (pid_g[:, None] > pid_g[None, :])).cpu().numpy()
    ids = pid_g.cpu().numpy()
    sw_of = np.full(G, -1, np.int64)
    for i in np.argsort(-ids, kind="stable"):
        if sw_of[i] < 0:
            sw_of[claim[i] & (sw_of < 0)] = i
    return torch.as_tensor(sw_of, device=ipos_g.device)


def _minpot(ipos_a, hsml_a, pot_a, pid_a, src_a, bh_a, n, boxsize, mesh):
    """Each appended BH's minimum-potential neighbour over this rank's
    source rows, then over ranks: the smallest potential, the smallest ID
    among the rows holding it, and its position (int64 [G, 3]); found
    False where no source lies inside the kernel."""
    tree, nbr, perm, inv, pos_box = bhmod._bh_pair_setup(
        ipos_a, torch.ones_like(hsml_a), hsml_a, src_a | bh_a, bh_a,
        boxsize, caller="minpot")
    LE = pairs.leaf_eval_cap(tree, 16)
    hs = (torch.where(bh_a, hsml_a, 0.0) * float(np.float32(1.0 / boxsize))
          )[perm]
    pot_s = pot_a[perm]
    src_s = src_a[perm].to(torch.float32)

    def near(r, tfeat, sfeat):
        return (r < tfeat["hsml"]) & (sfeat["src"] > 0)

    def key_fn(dx, r, tmask, smask, tfeat, sfeat):
        return {"negpot": torch.where(near(r, tfeat, sfeat), -sfeat["pot"],
                                      -float("inf"))}

    red = lambda fn, tf, sf, r: pairs.spanned(
        "minpot", "pair_reduce", pairs.pair_reduce, fn, nbr, tree, pos_box,
        tf, sf, r, 32, LE)
    mp = -red(key_fn, {"hsml": hs}, {"pot": pot_s, "src": src_s},
              {"negpot": "max"})["negpot"][inv][n:]
    gpot = coll.pmin(mp, mesh)
    gpot_s = torch.cat([gpot.new_full((n,), float("inf")), gpot])[perm]

    def pid_fn(dx, r, tmask, smask, tfeat, sfeat):
        sel = near(r, tfeat, sfeat) & (sfeat["pot"] == tfeat["gpot"])
        return {"pid": torch.where(sel, sfeat["pid"], INT_MAX)}

    tf = {"hsml": hs, "gpot": gpot_s}
    sf = {"pot": pot_s, "src": src_s, "pid": pid_a[perm]}
    gpid = coll.pmin(red(pid_fn, tf, sf, {"pid": "min"})["pid"][inv][n:],
                     mesh)
    gpid_s = torch.cat([gpid.new_full((n,), INT_MAX), gpid])[perm]
    ip_s = ipos_a[perm]

    def pos_fn(dx, r, tmask, smask, tfeat, sfeat):
        sel = near(r, tfeat, sfeat) & (sfeat["pot"] == tfeat["gpot"]) \
            & (sfeat["pid"] == tfeat["gpid"])
        return {f"x{k}": torch.where(sel, sfeat["ip"][..., k], INT_MAX)
                for k in range(3)}

    out = red(pos_fn, dict(tf, gpid=gpid_s), dict(sf, ip=ip_s),
              {f"x{k}": "min" for k in range(3)})
    gip = coll.pmin(torch.stack([out[f"x{k}"][inv][n:] for k in range(3)],
                                dim=1), mesh)
    found = torch.isfinite(gpot) & (gpid < INT_MAX)
    return gip, found


def sharded_bh(st, scal, mesh, par, *, boxsize, gconst, unit_time_in_s,
               hubble_param, unit_velocity, uu_in_cgs, rho_crit_baryon,
               kernel_type=2, reposition=False, acc=None):
    """One BH step on this rank's rows (build_sharded_bh's step).

    st: this rank's columns ipos, vel, mass, pid, ptype, hsml, entropy,
    density, gas_mask, grav_acc, the BH columns bh_mass, bh_mdot,
    bh_density, bh_mtrack, bh_progs, bh_ke, bh_vdisp and, with
    reposition, potential; acc: the full acceleration of the rows where grav_acc is
    not (the hierarchical step's grav_acc + pm_acc), for the mergers'
    boundness test; scal: atime, dtime (internal time), key (the draws'
    key), bh_soft (the softening of the merger distance).
    Returns (st', stats): st' with the swallowed gas and the merged BHs
    removed; stats n_bh, n_swallowed, n_merged, mdot_sum, bh_mass_total,
    the same on every rank.  A rank without any BH anywhere returns st
    unchanged."""
    dev = st["ipos"].device
    n = st["ipos"].shape[0]
    atime = float(np.float32(scal["atime"]))
    dtime = float(np.float32(scal["dtime"]))
    gas = st["gas_mask"]
    ptype = st["ptype"]
    is_bh = ptype == 5
    mine = torch.nonzero(is_bh).squeeze(1)
    full = st["grav_acc"] if acc is None else acc
    g, counts = all_gather_rows(dict({k: st[k][mine] for k in _GATHER},
                                     grav_acc=full[mine]), mesh)
    G = g["ipos"].shape[0]
    stats = {"n_bh": G, "n_swallowed": 0, "n_merged": 0, "mdot_sum": 0.0,
             "bh_mass_total": 0.0}
    if G == 0:
        return st, stats
    lo = int(sum(counts[:mesh.rank]))
    z = torch.zeros(G, dtype=torch.bool, device=dev)
    cat = lambda k, v: torch.cat([st[k], v])
    ipos_a, vel_a, mass_a, hsml_a, pid_a = (
        cat(k, g[k]) for k in ("ipos", "vel", "mass", "hsml", "pid"))
    bh_a = torch.cat([torch.zeros_like(gas), ~z])
    gas_a = torch.cat([gas, z])

    # ---- the per-BH sums over this rank's rows, summed over ranks ----
    s = bhmod.bh_neighbor_sums(ipos_a, mass_a, hsml_a, vel_a,
                               cat("entropy", g["mass"].new_zeros(G)),
                               bh_a, gas_a, boxsize, kernel_type=kernel_type)
    sums = {k: s[k][n:] for k in ("rho", "ent", "vx", "vy", "vz", "mgas")}
    if par.dynfric_method > 0:
        src = ptype == 4
        if par.dynfric_method > 1:
            src = src | (ptype == 1)
        if par.dynfric_method > 2:
            src = src | gas
        d = bhmod.bh_dynfric_raw(ipos_a, mass_a, hsml_a, vel_a, bh_a,
                                 torch.cat([src, z]), boxsize,
                                 kernel_type=kernel_type)
        sums.update({"df_" + k: d[k][n:] for k in d})
    if par.kinetic_on:
        vd = dm_dispersion_sums(
            ipos_a, vel_a, mass_a, torch.cat([ptype == 1, z]), bh_a,
            boxsize, radius_per_particle=torch.where(bh_a, hsml_a, 0.0),
            caller="BH vdisp")
        sums.update({"vd_" + k: vd[k][n:] for k in DISPERSION_SUMS})
    keys = sorted(sums)
    tot = coll.psum(torch.stack([sums[k] for k in keys], dim=1), mesh)
    sums = {k: tot[:, i] for i, k in enumerate(keys)}

    # ---- the gathered list, the same on every rank ----
    rho = sums["rho"]
    gasvel = torch.stack([sums["vx"], sums["vy"], sums["vz"]], dim=-1)
    mdot, dm = bhmod.bondi_accretion(
        par, g["bh_mass"], rho, sums["ent"], gasvel, g["vel"], atime, gconst,
        unit_time_in_s, hubble_param, dtime)
    bhm = g["bh_mass"] + dm
    if par.dynfric_method > 0:
        env = bhmod.dynfric_environment(
            {k: sums["df_" + k] for k in ("rho", "vx", "vy", "vz", "v2")})
        df = bhmod.dynfric_accel(env["rho"], env["vel"], env["rmsvel"],
                                 g["mass"], g["vel"], atime, gconst,
                                 bmax=par.df_bmax, boost=par.df_boost
                                 ).to(torch.float32)
    else:
        df = torch.zeros((G, 3), dtype=torch.float32, device=dev)
    ke_energy = keflag = None
    vdisp = torch.zeros(G, dtype=torch.float32, device=dev)
    if par.kinetic_on:
        vdisp = dispersion_from_sums(
            {k: sums["vd_" + k] for k in DISPERSION_SUMS})
        ke_energy, keflag = bhmod.kinetic_update(
            par, bhm, mdot, rho, vdisp, sums["mgas"], g["bh_ke"], dtime,
            unit_time_in_s, hubble_param, rho_crit_baryon, unit_velocity)

    # ---- swallowing and feedback on this rank's gas ----
    cat_g = lambda own, v: torch.cat([own, v])
    zf = torch.zeros(n, dtype=torch.float32, device=dev)
    swallowed, ent, bhrow, kick = bhmod.swallow_and_feedback(
        par, scal["key"], ipos=ipos_a, mass=mass_a, hsml=hsml_a,
        entropy=cat_g(st["entropy"], zf.new_zeros(G)),
        density=cat_g(st["density"], zf.new_zeros(G)), is_bh=bh_a,
        is_gas=gas_a, pid=pid_a, bh_mass=cat_g(zf, bhm),
        mdot=cat_g(zf, mdot), bh_density=cat_g(zf, rho),
        fbweight=cat_g(zf, rho), boxsize=boxsize, atime=atime, dtime=dtime,
        unit_velocity=unit_velocity, uu_in_cgs=uu_in_cgs,
        kernel_type=kernel_type,
        ke_energy=None if ke_energy is None else cat_g(zf, ke_energy),
        keflag=None if keflag is None else cat_g(
            zf.to(torch.int32), keflag),
        mtrack=cat_g(zf, g["bh_mtrack"]))
    swallowed = swallowed[:n]
    slot = bhrow[:n] - n
    out = dict(st)
    out["entropy"] = ent[:n]
    vel = st["vel"] + kick[:n]
    out["vel"] = vel
    # the swallowed mass and momentum per BH, summed over ranks
    tgt = torch.where(swallowed, slot, G)
    acc = torch.zeros((G + 1, 4), dtype=torch.float32, device=dev)
    m = st["mass"]
    acc.index_add_(0, tgt, torch.where(
        swallowed[:, None], torch.cat([m[:, None], m[:, None] * vel], 1),
        0.0))
    acc = coll.psum(acc[:G], mesh)
    mass2, mtrack2, vel2 = bhmod.apply_mtrack_accretion(
        g["mass"], g["bh_mtrack"], acc[:, 0], acc[:, 1:], g["vel"], ~z,
        par.seed_bh_dyn_mass)

    # ---- mergers on the gathered list ----
    sw_of = _merge_pairs(par, g["ipos"], vel2, g["grav_acc"] + df, g["pid"],
                         atime, boxsize, scal["bh_soft"])
    merged = sw_of >= 0
    other = mass2
    if par.seed_bh_dyn_mass > 0:
        other = torch.where(mtrack2 < par.seed_bh_dyn_mass, mtrack2, mass2)
    tgt_m = torch.where(merged, sw_of, G)

    def add(vals):
        buf = torch.zeros((G + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                          device=dev)
        return buf.index_add_(0, tgt_m, vals)[:G]

    dm_m = add(torch.where(merged, other, 0.0))
    dmom = add(torch.where(merged[:, None], other[:, None] * vel2, 0.0))
    mass3 = mass2 + dm_m
    vel3 = torch.where((dm_m > 0)[:, None],
                       (vel2 * mass2[:, None] + dmom)
                       / torch.clamp(mass3, min=1e-30)[:, None], vel2)
    bhm3 = bhm + add(torch.where(merged, bhm, 0.0))
    progs3 = g["bh_progs"] + add(torch.where(
        merged, g["bh_progs"] + 1, 0).to(g["bh_progs"].dtype))

    if reposition:
        src = (ptype == 0) | (ptype == 1) | (ptype == 4) | (ptype == 5)
        gip, found = _minpot(ipos_a, hsml_a, cat("potential", g["mass"]
                                                 .new_zeros(G)),
                             pid_a, torch.cat([src, z]), bh_a, n,
                             boxsize, mesh)
        new_ipos = torch.where(found[:, None], gip, g["ipos"])

    # ---- this rank's BH rows take their slots' results ----
    my = slice(lo, lo + mine.shape[0])
    put = lambda k, v: out[k].index_copy(0, mine, v[my].to(out[k].dtype))
    out["mass"] = put("mass", mass3)
    out["vel"] = put("vel", vel3)
    out["bh_mass"] = put("bh_mass", bhm3)
    out["bh_mdot"] = put("bh_mdot", mdot)
    out["bh_density"] = put("bh_density", rho)
    out["bh_mtrack"] = put("bh_mtrack", mtrack2)
    out["bh_progs"] = put("bh_progs", progs3)
    out["bh_ke"] = put("bh_ke", g["bh_ke"] if ke_energy is None else
                       torch.where(keflag == 2, 0.0, ke_energy))
    out["bh_vdisp"] = put("bh_vdisp", vdisp)
    if reposition:
        out["ipos"] = put("ipos", new_ipos)
    gone = swallowed.clone()
    gone[mine] = merged[my]
    keep = ~gone
    out = {k: v[keep] for k, v in out.items()}
    alive = ~merged
    stats.update(
        n_swallowed=int(coll.psum(swallowed.sum(), mesh)),
        n_merged=int(merged.sum()), mdot_sum=float(mdot.sum()),
        bh_mass_total=float(torch.where(alive, bhm3, 0.0).sum()))
    return out, stats
