"""The sharded KDK step: gas and dark-matter TreePM over balanced slabs.

PyTorch port of mpgadget_tpu/parallel/driver.py, the analog of the
reference run loop's per-step machinery (run.c:358-800): count-balanced
slab boundaries (domain.c:106), K-hop ghost strips (treewalk.c exports
reach any rank), the tree (K2 walk, K1 pair sums) and the pencil-FFT PM,
the SPH density and hydro force (parallel/sph.py: K3, K4, K5 on each
rank), the half-kick / drift / half-kick structure with the entropy
integration (apply_hydro_half_kick), the Strang-split cooling and star
formation (K6) with the new stars and the sh03 winds they drive, and
timestep statistics summed over ranks, so that the host policy never
gathers particle rows.  The PM bins each step's power on the slabs and
sums the bins over ranks, scales the modes by the neutrino
linear-response table (PMOptions), and leaves the hybrid neutrino
tracers out of the sources before NuPartTime.  Global steps and the
hierarchical per-timebin substeps (timestep.c:298-503) are both here.  The neighbour winds, black
holes and metal return run between steps (parallel/winds.py,
blackhole.py, metals.py), from Simulation.run_sharded.

Each rank holds its rows in a dict of tensors (variable-length, all rows
valid; new stars are appended).  No capacity is carried, so a step cannot
overflow and is never retried for room: exchanges and ghost strips move
exactly the rows they need, the PM routes every row to the rank of its
geometric mesh slab whatever its distance, and the tree's own capacities
grow inside the rank's tree force.  The one re-run left is the density
strip's correctness rule (parallel/sph.py).
"""

import numpy as np
import torch

from ..integrate import drift
from ..physics.sfr import SPAWN_PID_OFFSET
from . import collectives as coll
from .decomp import (exchange_to_slabs, ghost_hops, ghost_strips_multi,
                     count_histogram, slab_of, pack_rows, unpack_rows)
from .pfft import pm_force_slab, slab_measure_power
from .sph import (DENSITY_MARGIN, density_local, global_hmax_box,
                  sharded_hydro, strip_overrun, strip_width)
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


def _to_slabs(ipos, weights, mesh):
    """Each row (position and weight) to the rank of its geometric mesh
    slab through one split-size all_to_all: (the rows received, the
    order and the counts that bring results back)."""
    S = mesh.size
    dest = slab_of(ipos, int(np.log2(S)))
    order = torch.sort(dest, stable=True).indices
    buf, spec = pack_rows([ipos[order], weights[order]])
    rbuf, recv = coll.all_to_all(buf, mesh, torch.bincount(dest,
                                                           minlength=S))
    ip_r, w_r = unpack_rows(rbuf, spec)
    return ip_r, w_r, order, recv


def pm_force_multi(ipos, weights, nmesh, boxsize, gconst, asmth, mesh,
                   with_potential=False, nu_logk=None, nu_fac=None,
                   nbins=0):
    """Sharded PM force for rows held under count-balanced ownership,
    whose geometric mesh slab may be any rank's.  Each row (position and
    weight) goes to the rank of its slab through one split-size
    all_to_all, is deposited and read out there (pfft.pm_force_slab), and
    its acceleration (and potential) comes back through the reverse
    exchange.  The JAX package ring-gathers the rows of 2 hops neighbours
    instead and counts the hops on the host; both deposit the same rows
    on each slab.  nu_logk/nu_fac: the neutrino linear-response table
    (float32 tensors) that scales the modes; nbins > 0 bins the
    total-matter power on each slab and sums the bins over ranks.
    Returns (accel [n,3], potential [n] or None, (p, n, k, norm) float64
    or None)."""
    ip_r, w_r, order, recv = _to_slabs(ipos, weights, mesh)
    acc_r, pot_r, pk = pm_force_slab(ip_r, w_r, nmesh, boxsize, gconst,
                                     asmth, mesh,
                                     compute_potential=with_potential,
                                     nu_logk=nu_logk, nu_fac=nu_fac,
                                     nbins=nbins)
    out = torch.cat([acc_r, pot_r[:, None]], dim=1) if with_potential \
        else acc_r
    back, _ = coll.all_to_all(out.contiguous(), mesh, recv)
    res = torch.empty_like(back)
    res[order] = back
    return res[:, :3], (res[:, 3] if with_potential else None), pk


def measure_power_multi(ipos, weights, nmesh, mesh, nbins):
    """The power bins of the rows' deposit, summed over ranks (the
    sharded measure_power of run._neutrino_response): the rows go to
    their slabs as in :func:`pm_force_multi`.  Returns (p, n, k, norm)
    float64, the same on every rank."""
    ip_r, w_r, _, _ = _to_slabs(ipos, weights, mesh)
    return slab_measure_power(ip_r, w_r, nmesh, mesh, nbins)


class PMOptions:
    """What the sharded PM of a step adds beyond gravity: nbins > 0 bins
    the total-matter power (stats["pk"]); nu_response(ipos, weights,
    atime) -> (logk, fac) gives the neutrino linear-response table from
    the rows' CDM deposit (MassiveNuLinRespOn); with hybrid neutrinos a
    step's scal["nu_tracer"] (before NuPartTime) takes the type-2 rows'
    mass out of the tree and the PM deposit and gives them no PM force
    (gravpm.c:83-85, 469-475; forcetree.c:162)."""

    def __init__(self, nbins=0, nu_response=None):
        self.nbins = int(nbins)
        self.nu_response = nu_response

    def table(self, ipos, weights, atime, dev):
        """The neutrino table as float32 tensors on dev, or (None,
        None)."""
        if self.nu_response is None:
            return None, None
        logk, fac = self.nu_response(ipos, weights, atime)
        return (torch.as_tensor(np.asarray(logk, np.float32), device=dev),
                torch.as_tensor(np.asarray(fac, np.float32), device=dev))


def _source_mass(st, scal):
    """The rows' gravitating mass: the hybrid neutrino tracers' (type 2)
    is zero before NuPartTime."""
    if scal.get("nu_tracer"):
        return torch.where(st["ptype"] == 2, 0.0, st["mass"])
    return st["mass"]


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


def assign_bins(st, atime, eta_eps, hubble, max_dloga, dloga_tick, maxbin,
                courant=None):
    """Power-of-two timebins from the gravity criterion (find_timesteps,
    timestep.c:298-503), elementwise in float32 on each rank's rows; the
    host scalars enter as float32 tensors, so that divisions by them
    round as divisions.  courant=(courant_fac, fac3) adds the gas's
    Courant and hsml-change criteria (assign_bins_global's with_gas)."""
    from ..timestep import _f32
    dev = st["grav_acc"].device
    a = _f32(atime, dev)
    full = (st["grav_acc"] + st["pm_acc"]) / (a * a)
    ac = torch.sqrt(torch.clamp(torch.sum(full * full, dim=-1), min=1e-60))
    dloga = torch.sqrt(_f32(eta_eps, dev) / ac) * _f32(hubble, dev)
    if courant is not None:
        cfac = _f32(courant[0], dev)
        vsig = torch.clamp(st["maxsig"], min=1e-30)
        dt_c = 2.0 * cfac * a * st["hsml"] / (_f32(courant[1], dev) * vsig)
        dt_h = cfac * a * a * torch.abs(st["hsml"]
                                        / (st["dt_hsml"] + 1e-20))
        dloga_h = torch.minimum(dt_c, dt_h) * _f32(hubble, dev)
        dloga = torch.where(st["gas_mask"], torch.minimum(dloga, dloga_h),
                            dloga)
    dloga = torch.minimum(dloga, _f32(max_dloga, dev))
    dti = dloga / _f32(dloga_tick, dev)
    bins = torch.floor(torch.log2(torch.clamp(dti, min=2.0))).to(
        torch.int32)
    return torch.clamp(bins, 1, int(maxbin))


def _entropy_update(entropy, dtent, dloga, density, min_egy_spec, atime,
                    gas):
    """Half-kick entropy integration with the MinGasTemp floor and the
    at-most-halving limiter (apply_hydro_half_kick, timestep.c), for the
    rows in gas.  dloga: a float32 value or a per-row tensor; atime enters
    as float32 (a^3 in float32, as the JAX package's step)."""
    from ..utils.constants import GAMMA_MINUS1
    a = np.float32(atime)
    a3 = float(a * a * a)
    ent = entropy + dtent * dloga
    minent = GAMMA_MINUS1 * min_egy_spec / torch.clamp(
        density / a3, min=1e-30) ** GAMMA_MINUS1
    ent = torch.maximum(ent, minent)
    ent = torch.maximum(ent, 0.5 * entropy)
    return torch.where(gas, ent, entropy)


# columns a spawned star copies from its parent gas row; every other column
# of the new row starts at zero (the JAX package's free rows)
SPAWN_COPY = ("ipos", "vel", "hsml", "dt_hsml", "amag", "grav_acc", "dtent",
              "density", "metals", "pm_acc", "bins")


def spawn_rows(st, make_star, convert, star_mass, atime):
    """Star spawning on a rank's rows (spawn_stars semantics,
    physics/sfr.py): whole conversions flip ptype in place; partial ones
    append a new star row, in row order, and take its mass from the gas.
    Rows are variable-length, so nothing can overflow.  The birth record
    (formation time, birth density and metallicity) is set for both; with
    metal return a star keeps its parent's species as its birth
    composition, its kernel as the first search radius of the return
    (the stellar hsml seed, slotsmanager.c:105) and no mass returned yet.
    Returns (st, new star rows on this rank)."""
    spawn = make_star & ~convert
    idx = torch.nonzero(spawn).squeeze(1)
    st = dict(st)
    af = float(np.float32(atime))
    four = torch.full_like(st["ptype"], 4)
    st["ptype"] = torch.where(convert, four, st["ptype"])
    birth = {"formation_time": torch.full_like(st["density"], af),
             "birth_density": st["density"],
             "birth_metallicity": st["metallicity"]}
    if "star_hsml" in st:
        birth.update(star_hsml=st["hsml"],
                     total_mass_returned=torch.zeros_like(st["hsml"]),
                     last_enrichment_myr=torch.zeros_like(st["hsml"]))
    for k, v in birth.items():
        st[k] = torch.where(convert, v, st[k])
    new = {k: v.new_zeros((idx.shape[0],) + tuple(v.shape[1:]))
           for k, v in st.items()}
    for k in SPAWN_COPY:
        if k in st:
            new[k] = st[k][idx]
    new["ptype"] = four[idx]
    new["mass"] = star_mass[idx].to(st["mass"].dtype)
    new["pid"] = st["pid"][idx] + SPAWN_PID_OFFSET
    for k, v in birth.items():
        new[k] = v[idx]
    st["mass"] = torch.where(spawn, st["mass"] - star_mass, st["mass"])
    st["gas_mask"] = st["gas_mask"] & (st["ptype"] == 0)
    st = {k: torch.cat([v, new[k]]) for k, v in st.items()}
    return st, int(idx.shape[0])


def pm_refresh(st, mesh, scal, *, nmesh, boxsize, gconst, asmth,
               with_potential=False, hist_bits=12, layers=None, pm=None):
    """PM refresh and boundary half kick of a hierarchical interval
    (compute_forces(tree=False) + apply_PM_half_kick, run.c:605).  st:
    this rank's rows; scal: {"fac": the closing gravkick factor, "atime":
    the refresh's a[, "nu_tracer"]}; pm: :class:`PMOptions`.  Returns
    (updated columns {pm_acc, vel, amag[, pm_pot, potential]}, stats),
    stats["pk"] the power bins when pm.nbins."""
    lay = layers or Layers(None, mesh.device)
    pm = pm or PMOptions()
    lay("PMgrav")
    w = _source_mass(st, scal)
    nu_logk, nu_fac = pm.table(st["ipos"], w, scal.get("atime"),
                               mesh.device)
    acc_pm, pm_pot, pk = pm_force_multi(
        st["ipos"], w, nmesh, boxsize, gconst, asmth, mesh, with_potential,
        nu_logk=nu_logk, nu_fac=nu_fac, nbins=pm.nbins)
    if scal.get("nu_tracer"):
        acc_pm = torch.where((st["ptype"] == 2)[:, None], 0.0, acc_pm)
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
    stats["pk"] = pk
    lay(None)
    return upd, stats


class GasStep:
    """What the gas half of a step needs beyond the dark matter's: the
    density and hydro parameters, whether the density solve also sums the
    entropy-weighted density (DensityIndependentSphOn), the MinGasTemp
    energy floor, the strip margin (widened by the caller on a strip
    re-run, and kept), and the source terms: sfr_fn(st, gas, dloga, scal)
    -> cooling_and_starformation's outputs, or cooling_fn(st, gas, dloga,
    scal) -> (entropy, ne); gas the rows to update, dloga a float32 value
    or a per-row tensor.  wind_fn(st, out, dloga, scal) -> (vel, entropy,
    delay_time): the sh03 subgrid winds on the star-forming gas before the
    new stars spawn.  decouple: WindOn, so that gas with DelayTime > 0
    feels no hydro force (winds.c:113-136, as the single-device loop)."""

    def __init__(self, dpar, hpar, do_egy_density, min_egy_spec,
                 margin=DENSITY_MARGIN, sfr_fn=None, cooling_fn=None,
                 wind_fn=None, decouple=False):
        self.dpar, self.hpar = dpar, hpar
        self.do_egy_density = bool(do_egy_density)
        self.min_egy_spec = float(min_egy_spec)
        self.margin = margin
        self.sfr_fn, self.cooling_fn = sfr_fn, cooling_fn
        self.wind_fn = wind_fn
        self.decouple = bool(decouple)


def _table(scal, name, dev):
    """A per-bin table of the host scalars as a float32 tensor."""
    return torch.as_tensor(np.asarray(scal[name], np.float32), device=dev)


def _source_terms(st, gas_src, dl, scal, gas, mesh):
    """The Strang-split source terms of one step on a rank's rows: cooling
    and star formation with the new stars (sfr_fn), or cooling alone
    (cooling_fn).  Returns (st, sums): sums over ranks (one all-reduce)
    of sfr.txt's inputs, None for cooling alone."""
    if gas.sfr_fn is None:
        ent, ne = gas.cooling_fn(st, gas_src, dl, scal)
        st["entropy"] = torch.where(gas_src, ent, st["entropy"])
        st["ne"] = torch.where(gas_src, ne, st["ne"])
        return st, None
    out = gas.sfr_fn(st, gas_src, dl, scal)
    for k in ("entropy", "ne", "metallicity", "sfr"):
        st[k] = torch.where(gas_src, out[k], st[k])
    # sfr.txt's inputs before the new stars take their mass
    # (sfr_eff.c:319-364): the SFR, the expected mass, the star-forming
    # rows' dt and count, the mass actually formed
    on_sf = out["on_eeqos"] & gas_src
    make = out["make_star"] & gas_src
    dt_sf = torch.broadcast_to(torch.as_tensor(
        dl, dtype=torch.float32, device=st["mass"].device)
        / float(np.float32(scal["hubble"])), on_sf.shape)
    part = torch.stack([
        st["sfr"].sum(), torch.where(gas_src, out["sm"], 0.0).sum(),
        torch.where(on_sf, dt_sf, 0.0).sum(), on_sf.sum().to(torch.float32),
        torch.where(make, torch.where(out["convert"], st["mass"],
                                      out["star_mass"]), 0.0).sum()])
    if gas.wind_fn is not None:
        # subgrid winds kick the star-forming gas itself before the new
        # stars spawn (winds_make_after_sf, winds.c:454)
        vel, ent, delay = gas.wind_fn(st, out, dl, scal)
        st["vel"] = torch.where(gas_src[:, None], vel, st["vel"])
        st["entropy"] = torch.where(gas_src, ent, st["entropy"])
        st["delay_time"] = torch.where(gas_src, delay, st["delay_time"])
    st, nsp = spawn_rows(st, make, out["convert"] & gas_src,
                         out["star_mass"], scal["atime"])
    part = torch.cat([part.to(torch.float64), torch.tensor(
        [nsp], dtype=torch.float64, device=part.device)])
    tot = coll.psum(part, mesh).cpu().numpy()
    sums = dict(zip(("sfr_sum", "sm_sum", "sf_dtime_sum", "sf_count",
                     "mass_formed_sum", "n_spawned"), tot.tolist()))
    # the stars this rank formed (not summed over ranks)
    sums["formed_here"] = int(make.sum())
    return st, sums


def sharded_step(st, bounds, scal, mesh, *, tg, nmesh, boxsize, gconst,
                 asmth, rcut, hierarchical=False, with_potential=False,
                 hist_bits=12, layers=None, gas=None, pm=None):
    """One KDK step (global) or one substep (hierarchical) on this rank's
    rows (build_sharded_step).

    st: dict of this rank's columns: ipos, vel, mass, pid, ptype, amag,
    grav_acc; hierarchical adds bins (int32) and pm_acc (the long-range
    field, kicked only by :func:`pm_refresh`; grav_acc is then tree-only);
    with_potential adds potential and pm_pot (and tree_pot when
    hierarchical); with gas (a :class:`GasStep`) the gas columns gas_mask,
    hsml, entropy, dtent, density, egywt, divv, curlv, dhsml_egy, dt_hsml,
    hydro_acc, maxsig, with the source terms ne and metallicity, with star
    formation sfr, delay_time, formation_time, birth_density and
    birth_metallicity.  bounds: the S balanced left edges.  scal: host
    scalars; global: dk1, ddrift, dk2, atime and hubble (at the step's
    end); with gas hk1, dloga1, hk2, dloga2, dloga_full; hierarchical:
    ddrift, atime, hubble and the MAXB+1 tables gk_open, gk_close, al_open,
    al_close, with eta_eps, max_dloga, dloga_tick, maxbin for the bins'
    re-derivation; with gas the tables hk_open, hk_close, dlg_open,
    dlg_close, dlg_full and dloga_full, courant_fac, fac3; the source
    terms add redshift, uvbg and (star formation) the random key; with
    hybrid neutrinos nu_tracer.  pm: :class:`PMOptions` of the global
    step's PM.

    Only the rows closing their bin are force targets when hierarchical
    (the tree, and the density solve with the rank's own closing gas); the
    hydro force of the closing gas follows with the converged hsml of all
    gas; the source terms act on the closing gas, each row over its own
    bin.  Returns (st', stats): stats summed over ranks (vsum, count,
    min_mass, max_acc, hist, n_valid; hierarchical: min_act_bin,
    bin_hist, n_closing; gas: min_h_over_sig, min_h_over_dth and, with
    star formation, sfr.txt's sums; global: pk, the power bins when
    pm.nbins).  With gas, (None, {"strip_ok":
    False}) when the density strip was too narrow: run the step again
    from the same st with gas.margin widened."""
    from ..utils.constants import GAMMA
    lay = layers or Layers(None, mesh.device)
    pm = pm or PMOptions()
    dev = mesh.device
    f32 = np.float32
    st = dict(st)
    rcut_box = rcut * asmth / nmesh

    # ---- opening half kick with the carried forces ----
    lay("Kick")
    if hierarchical:
        al_open = torch.as_tensor(scal["al_open"], device=dev)
        bins0 = torch.clamp(st["bins"], 1, MAXB).long()
        act = al_open[bins0]
        gk1 = torch.where(act, _table(scal, "gk_open", dev)[bins0], 0.0)
        st["vel"] = st["vel"] + st["grav_acc"] * gk1[:, None]
        if gas is not None:
            gact = st["gas_mask"] & act
            hk1 = torch.where(gact, _table(scal, "hk_open", dev)[bins0],
                              0.0)
            st["vel"] = st["vel"] + st["hydro_acc"] * hk1[:, None]
            st["entropy"] = _entropy_update(
                st["entropy"], st["dtent"],
                _table(scal, "dlg_open", dev)[bins0], st["density"],
                gas.min_egy_spec, scal["atime"], gact)
    else:
        st["vel"] = st["vel"] + st["grav_acc"] * float(f32(scal["dk1"]))
        if gas is not None:
            g = st["gas_mask"]
            st["vel"] = st["vel"] + torch.where(
                g[:, None], st["hydro_acc"], 0.0) * float(f32(scal["hk1"]))
            st["entropy"] = _entropy_update(
                st["entropy"], st["dtent"], float(f32(scal["dloga1"])),
                st["density"], gas.min_egy_spec, scal["atime"], g)
    # ---- drift (positions and predicted hsml) ----
    st["ipos"] = drift(st["ipos"], st["vel"], scal["ddrift"], 1.0 / boxsize)
    if gas is not None:
        hs = st["hsml"] + st["dt_hsml"] * float(f32(scal["ddrift"]))
        st["hsml"] = torch.where(st["gas_mask"],
                                 torch.clamp(hs, 0.0, 0.45 * boxsize),
                                 st["hsml"])

    # ---- domain exchange to the balanced owners ----
    lay("Exchange")
    keys = sorted(st)
    cols, _ = exchange_to_slabs(tuple(st[k] for k in keys), st["ipos"],
                                mesh, bounds)
    st = dict(zip(keys, cols))
    n = st["ipos"].shape[0]
    # the mass that sources gravity (tree and PM)
    gsrc = _source_mass(st, scal)

    # ---- ghost strips: the tree's (and the density's) sources near the
    # slab faces; with gas as wide as the gas's largest hsml times the
    # margin, and never narrower than the tree's cut-off ----
    lay("Ghosts")
    if gas is not None:
        g = st["gas_mask"]
        entvar = torch.where(g, torch.clamp(st["entropy"], min=1e-30)
                             ** (1.0 / GAMMA), 0.0)
        w1 = strip_width(global_hmax_box(st["hsml"], g, mesh, boxsize),
                         gas.margin, rcut_box)
        payload = (st["ipos"], gsrc, st["vel"], st["hsml"], entvar, g)
    else:
        w1 = float(f32(rcut_box))
        payload = (st["ipos"], gsrc)
    gh = ghost_strips_multi(payload, st["ipos"], mesh, bounds, w1,
                            ghost_hops(bounds, w1))
    ng = gh[0].shape[0]
    ipos_a = torch.cat([st["ipos"], gh[0]])
    mass_a = torch.cat([gsrc, gh[1]])
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
        nu_logk, nu_fac = pm.table(st["ipos"], gsrc, scal["atime"], dev)
        acc_pm, pm_pot, pk = pm_force_multi(
            st["ipos"], gsrc, nmesh, boxsize, gconst, asmth, mesh,
            with_potential, nu_logk=nu_logk, nu_fac=nu_fac, nbins=pm.nbins)
        if scal.get("nu_tracer"):
            # the tracers receive no PM force
            acc_pm = torch.where((st["ptype"] == 2)[:, None], 0.0, acc_pm)
        if with_potential:
            st["pm_pot"] = pm_pot
            st["potential"] = res.potential[:n] * g_over_box + pm_pot
        grav = res.accel[:n] + acc_pm
        st["amag"] = torch.sqrt(torch.sum(grav * grav, dim=-1))
        st["grav_acc"] = grav

    # ---- SPH: density of the rank's own (closing) gas over its rows and
    # the ghosts, the strip check, then the hydro force ----
    if gas is not None:
        lay("SPH/Density")
        g = st["gas_mask"]
        if hierarchical:
            gate = g & closing
            tmask = torch.cat([closing, closing.new_zeros(ng)])
        else:
            gate = g
            tmask = torch.cat([torch.ones_like(g), g.new_zeros(ng)])
        d = density_local(
            ipos_a, mass_a, torch.cat([g, gh[5]]),
            torch.cat([st["hsml"], gh[3]]), torch.cat([st["vel"], gh[2]]),
            torch.cat([entvar, gh[4]]), n, gas.dpar, boxsize, tmask,
            gas.do_egy_density)
        hsml_n = torch.where(gate, d["hsml"], st["hsml"])
        if strip_overrun(hsml_n, g, mesh, boxsize, w1):
            lay(None)
            return None, {"strip_ok": False}
        st["hsml"] = hsml_n
        for k, dk in (("density", "density"), ("egywt", "egy_wt_density"),
                      ("divv", "div_vel"), ("curlv", "curl_vel"),
                      ("dhsml_egy", "dhsml_egy_factor"),
                      ("dt_hsml", "dt_hsml")):
            keep = hierarchical or k in ("density", "egywt", "dt_hsml")
            st[k] = torch.where(gate, d[dk], st[k]) if keep else d[dk]
        lay("SPH/Hydro")
        hcols = dict(ipos=st["ipos"], vel=st["vel"], mass=st["mass"],
                     hsml=st["hsml"], entvar=entvar, density=st["density"],
                     egywt=st["egywt"], divv=st["divv"], curlv=st["curlv"],
                     dhsml_egy=st["dhsml_egy"])
        h = sharded_hydro(hcols, g, mesh, bounds, gas.hpar, boxsize,
                          float(f32(scal["atime"])),
                          float(f32(scal["hubble"])),
                          float(f32(scal["dloga_full"])))
        if gas.decouple:
            # decoupled wind gas feels no hydro force (winds.c:113-136,
            # the single-device rule; the JAX package's sharded step has
            # no such mask)
            dec = st["delay_time"] > 0
            h["hydro_accel"] = torch.where(dec[:, None], 0.0,
                                           h["hydro_accel"])
            h["dt_entropy"] = torch.where(dec, 0.0, h["dt_entropy"])
        st["hydro_acc"] = torch.where(
            gate[:, None], h["hydro_accel"],
            torch.where(g[:, None], st["hydro_acc"], 0.0))
        st["dtent"] = torch.where(gate, h["dt_entropy"],
                                  torch.where(g, st["dtent"], 0.0))
        st["maxsig"] = torch.where(gate, h["max_signal_vel"],
                                   torch.where(g, st["maxsig"], 0.0))

    # ---- closing half kick with the fresh forces ----
    lay("Kick")
    if hierarchical:
        gk2 = torch.where(closing, _table(scal, "gk_close", dev)[bins], 0.0)
        st["vel"] = st["vel"] + st["grav_acc"] * gk2[:, None]
        if gas is not None:
            gcl = st["gas_mask"] & closing
            hk2 = torch.where(gcl, _table(scal, "hk_close", dev)[bins], 0.0)
            st["vel"] = st["vel"] + st["hydro_acc"] * hk2[:, None]
            st["entropy"] = _entropy_update(
                st["entropy"], st["dtent"],
                _table(scal, "dlg_close", dev)[bins], st["density"],
                gas.min_egy_spec, scal["atime"], gcl)
    else:
        st["vel"] = st["vel"] + st["grav_acc"] * float(f32(scal["dk2"]))
        if gas is not None:
            g = st["gas_mask"]
            st["vel"] = st["vel"] + torch.where(
                g[:, None], st["hydro_acc"], 0.0) * float(f32(scal["hk2"]))
            st["entropy"] = _entropy_update(
                st["entropy"], st["dtent"], float(f32(scal["dloga2"])),
                st["density"], gas.min_egy_spec, scal["atime"], g)

    # ---- Strang-split source terms: each closing gas row over its own
    # bin (hierarchical), every gas row over the step (global) ----
    sums = None
    if gas is not None and (gas.sfr_fn or gas.cooling_fn):
        lay("Cooling/SFR")
        if hierarchical:
            gas_src = st["gas_mask"] & closing
            dl = torch.where(gas_src, _table(scal, "dlg_full", dev)[bins],
                             0.0)
        else:
            gas_src = st["gas_mask"]
            dl = float(f32(scal["dloga_full"]))
        st, sums = _source_terms(st, gas_src, dl, scal, gas, mesh)
        if hierarchical:
            # new star rows close no bin in this substep
            grown = st["ipos"].shape[0] - n
            closing = torch.cat([closing, closing.new_zeros(grown)])
            n += grown

    # ---- bins of the rows closing their interval ----
    lay("Kick")
    if hierarchical:
        # shrink freely, grow only where the longer interval is aligned
        # with the far clock edge (is_timebin_active)
        nb = assign_bins(st, scal["atime"], scal["eta_eps"],
                         scal["hubble"], scal["max_dloga"],
                         scal["dloga_tick"], scal["maxbin"],
                         courant=None if gas is None else
                         (scal["courant_fac"], scal["fac3"]))
        cur = st["bins"]
        new = torch.where(closing & (nb < cur), nb, cur)
        new = torch.where(closing & (nb > cur) & al_close[nb.long()], nb,
                          new)
        st["bins"] = torch.clamp(new, 1, int(scal["maxbin"]))

    # ---- statistics summed over ranks ----
    lay("Stats")
    stats = _type_stats(st, mesh)
    amax = st["amag"].max() if n else torch.zeros((), device=dev)
    stats["max_acc"] = float(coll.pmax(amax, mesh))
    stats["hist"] = count_histogram(st["ipos"], mesh, hist_bits)
    stats["n_valid"] = int(coll.psum(torch.tensor(n, device=dev), mesh))
    if not hierarchical:
        stats["pk"] = pk
    if gas is not None:
        g = st["gas_mask"]
        inf = float("inf")
        h_sig = torch.where(g, st["hsml"] / torch.clamp(st["maxsig"],
                                                         min=1e-30), inf)
        h_dth = torch.where(g, torch.abs(st["hsml"]
                                         / (st["dt_hsml"] + 1e-20)), inf)
        mins = torch.stack([h_sig.min() if n else torch.tensor(inf),
                            h_dth.min() if n else torch.tensor(inf)])
        mins = coll.pmin(mins.to(dev), mesh).cpu().numpy()
        stats["min_h_over_sig"] = float(mins[0])
        stats["min_h_over_dth"] = float(mins[1])
        stats["strip_ok"] = True
        if sums is not None:
            stats.update(sums)
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
