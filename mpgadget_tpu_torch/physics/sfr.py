"""Star formation: the Springel & Hernquist 2003 effective EOS (PyTorch
port of mpgadget_tpu/physics/sfr.py, after libgadget/sfr_eff.c).

The multiphase subgrid model (cold clouds and a hot SN-heated phase in
pressure equilibrium), entropy relaxation onto the effective EOS,
stochastic star spawning and the quick-Lyman-alpha wholesale conversion,
as tensor passes over the gas.  The cooling it calls is K6 on CUDA
tensors (physics/cooling.py), computed for the rows whose results are
kept; the JAX package computes every row and masks.

The per-ID random draws equal the JAX package's bit for bit: the keys come
from utils/threefry.py (Threefry-2x32, as jax.random), the per-ID hash is
spelled in int64 with the uint32 wrap-around made explicit.
"""

from dataclasses import dataclass

import torch

from ..utils import constants as C
from ..utils import threefry
from .cooling import (CoolingRates, CoolingUnits, UVBG, _rdiv, _scalar,
                      heatingcooling_rate)

METAL_YIELD = 0.02
MASK32 = 0xFFFFFFFF
SPAWN_PID_OFFSET = 2 ** 40     # spawned stars carry pid + 2**40


@dataclass
class SFRParams:
    StarformationCriterion: int = 1   # density
    CritOverDensity: float = 57.7
    CritPhysDensity: float = 0.0
    FactorSN: float = 0.1
    FactorEVP: float = 1000.0
    TempSupernova: float = 1e8
    TempClouds: float = 1000.0
    MaxSfrTimescale: float = 1.5
    Generations: int = 4
    BoostSFDenseGas: bool = True
    BoostSFOverDenseFactor: float = 1000.0
    BHFeedbackUseTcool: int = 1
    QuickLymanAlphaProbability: float = 0.0
    QuickLymanAlphaTempThresh: float = 1e5
    WindOn: bool = False
    # derived (init_sfr)
    OverDensThresh: float = 0.0
    PhysDensThresh: float = 0.0
    EgySpecCold: float = 0.0
    EgySpecSN: float = 0.0
    temp_to_u: float = 0.0
    UnitSfr_in_solar_per_year: float = 1.0
    avg_baryon_mass: float = 0.0


def init_sfr(par: SFRParams, CP, units, cr: CoolingRates,
             cunits: CoolingUnits, avg_baryon_mass, device="cuda"):
    """Derived thresholds (init_cooling_and_star_formation,
    sfr_eff.c:889-1000), including the self-consistent PhysDensThresh
    when CritPhysDensity == 0: one cooling time in float64 at z = 0, on
    the device (K6's double instance on the card)."""
    par.temp_to_u = (1.0 / C.GAMMA_MINUS1) * (C.BOLTZMANN / C.PROTONMASS) \
        / units.UnitInternalEnergy_in_cgs
    par.UnitSfr_in_solar_per_year = (units.UnitMass_in_g / C.SOLAR_MASS) \
        / (units.UnitTime_in_s / C.SEC_PER_YEAR)
    par.avg_baryon_mass = avg_baryon_mass
    par.OverDensThresh = par.CritOverDensity * CP.OmegaBaryon * CP.RhoCrit
    par.PhysDensThresh = (par.CritPhysDensity * C.PROTONMASS
                          / C.HYDROGEN_MASSFRAC
                          / units.UnitDensity_in_cgs)
    mw_neutral = 4.0 / (1 + 3 * C.HYDROGEN_MASSFRAC)
    par.EgySpecCold = par.temp_to_u / mw_neutral * par.TempClouds
    mw_ion = 4 / (8 - 5 * (1 - C.HYDROGEN_MASSFRAC))
    par.EgySpecSN = par.temp_to_u / mw_ion * par.TempSupernova

    if par.PhysDensThresh == 0:
        # self-consistent threshold at z=0 (sfr_eff.c:933-963)
        egyhot = par.EgySpecSN / par.FactorEVP
        u4 = par.temp_to_u / mw_ion * 1.0e4
        dens = 1.0e6 * CP.RhoCrit

        def one(x):
            return torch.tensor([x], dtype=torch.float64, device=device)

        tcool = get_cooling_time(cr, 0.0, one(egyhot), one(dens), UVBG(),
                                 one(1.0), cunits)
        tcool = float(tcool[0])
        coolrate = egyhot / tcool / dens
        x = (egyhot - u4) / (egyhot - par.EgySpecCold)
        par.PhysDensThresh = (
            x / (1 - x) ** 2
            * (par.FactorSN * par.EgySpecSN
               - (1 - par.FactorSN) * par.EgySpecCold)
            / (par.MaxSfrTimescale * coolrate))
    return par


def get_cooling_time(cr: CoolingRates, redshift, u, rho_phys, uvbg, ne,
                     cunits: CoolingUnits, rows=None, metallicity=None):
    """GetCoolingTime (cooling.c:143-163), internal units.  0 where the
    gas is net heated, and on rows not listed in rows (int64 indices or a
    bool mask; all when None).  metallicity (per row) enters with the
    metal cooling table; None is the JAX package's 0.0 (init_sfr's)."""
    rho_cgs = rho_phys * cunits.density_in_phys_cgs / C.PROTONMASS
    u_cgs = u * cunits.uu_in_cgs
    lam, _ = heatingcooling_rate(cr, rho_cgs, u_cgs, redshift, uvbg, ne,
                                 rows=rows, metallicity=metallicity)
    tiny = _scalar(1e-60, lam.dtype)
    tcool = torch.where(lam < 0, u_cgs / torch.clamp(-lam, min=tiny), 0.0)
    return tcool / cunits.tt_in_s


def entropy_to_u(density, a3inv):
    return (density * a3inv) ** C.GAMMA_MINUS1 / C.GAMMA_MINUS1


def sfreff_on_eeqos(par: SFRParams, density, delay_time, a3inv):
    """Which gas is on the effective EOS (sfr_eff.c:535-566)."""
    flag = (density * a3inv >= par.PhysDensThresh) \
        & (density >= par.OverDensThresh)
    return flag & (delay_time <= 0)


def get_sfr_eeqos(par: SFRParams, cr, cunits, density, ne, dtime, uvbg,
                  redshift, a3inv, on_eeqos, metallicity=None):
    """Multiphase model per particle (get_sfr_eeqos, sfr_eff.c:804-842):
    dict of tsfr, egyhot, cloudfrac, trelax, egyeff.  The cooling time is
    computed for the rows of on_eeqos only; the values of other rows are
    not used."""
    rho_phys = density * a3inv
    ratio = rho_phys / par.PhysDensThresh
    tsfr = torch.sqrt(_rdiv(1.0, torch.clamp(ratio, min=1e-30))) \
        * par.MaxSfrTimescale
    if par.BoostSFDenseGas:
        tsfr = torch.where(ratio > par.BoostSFOverDenseFactor,
                           _rdiv(par.MaxSfrTimescale,
                                 torch.clamp(ratio, min=1e-30)), tsfr)
    tsfr = torch.maximum(tsfr, dtime)
    factorEVP = torch.clamp(ratio, min=1e-30) ** -0.8 * par.FactorEVP
    egyhot = _rdiv(par.EgySpecSN, 1 + factorEVP) + par.EgySpecCold
    tcool = get_cooling_time(cr, redshift, egyhot, rho_phys, uvbg, ne,
                             cunits, rows=on_eeqos, metallicity=metallicity)
    tcool = torch.clamp(tcool, min=1e-30)
    y = tsfr / tcool * egyhot / (par.FactorSN * par.EgySpecSN
                                 - (1 - par.FactorSN) * par.EgySpecCold)
    y = torch.clamp(y, min=1e-30)
    cloudfrac = 1 + _rdiv(1, 2 * y) \
        - torch.sqrt(_rdiv(1, y) + _rdiv(1, 4 * y * y))
    cloudfrac = torch.clamp(cloudfrac, 0.0, 1.0)
    trelax = tsfr * (1 - cloudfrac) / torch.clamp(cloudfrac, min=1e-10) \
        / (par.FactorSN * (1 + factorEVP))
    return {"tsfr": tsfr, "egyhot": egyhot, "cloudfrac": cloudfrac,
            "trelax": trelax,
            "egyeff": (par.EgySpecCold * cloudfrac
                       + (1 - cloudfrac) * egyhot)}


def cooling_and_starformation(par: SFRParams, cr, cunits, rng_key, *,
                              density, entropy, ne, metallicity,
                              delay_time, mass, pid, valid_gas, redshift,
                              atime, hubble, dloga, uvbg, do_cooling_fn):
    """One Strang-split source step of the gas in valid_gas
    (cooling_and_starformation, sfr_eff.c:187-330): gas on the eEOS relaxes
    toward it and may form stars; other gas cools normally.

    rng_key: a raw uint32[2] key (utils/threefry.py).  do_cooling_fn(u,
    rho_phys, dt, ne, rows, metallicity) -> (u_new, ne) is the implicit
    cooling of the listed rows (physics/cooling.do_cooling; the
    metallicity feeds the metal cooling table, as the JAX package's Z).
    dloga is a scalar or a per-particle tensor (hierarchical bins close
    over their own interval, timestep.c:298).  Returns the dict of the JAX package: entropy, ne,
    sfr, metallicity, make_star, convert (whole conversion), star_mass,
    sm, on_eeqos."""
    a3inv = 1.0 / atime ** 3
    dtime = torch.as_tensor(dloga, dtype=torch.float32,
                            device=density.device) / hubble
    rho_phys = density * a3inv
    on_eeqos = sfreff_on_eeqos(par, density, delay_time, a3inv) & valid_gas

    enttou = entropy_to_u(density, a3inv)
    u_current = entropy * enttou

    # --- normal cooling branch: the gas off the eEOS ---
    u_cooled, ne_cooled = do_cooling_fn(
        u_current, rho_phys,
        torch.broadcast_to(dtime, u_current.shape).to(u_current.dtype)
        .contiguous(), ne, valid_gas & ~on_eeqos, metallicity)
    ent_cooled = u_cooled / torch.clamp(enttou, min=1e-30)

    # --- eEOS branch ---
    eeqos = get_sfr_eeqos(par, cr, cunits, density, ne, dtime, uvbg,
                          redshift, a3inv, on_eeqos, metallicity)
    # relax toward the effective EOS (cooling_relaxed, sfr_eff.c:667-702)
    egyeff = eeqos["egyeff"]
    ent_relaxed = (egyeff + (u_current - egyeff)
                   * torch.exp(-dtime / torch.clamp(eeqos["trelax"],
                                                    min=1e-30))) \
        / torch.clamp(enttou, min=1e-30)

    # star formation rate (get_starformation_rate_full)
    cloudmass = eeqos["cloudfrac"] * mass
    rate = (1 - par.FactorSN) * cloudmass \
        / torch.clamp(eeqos["tsfr"], min=1e-30)
    rate = torch.where(on_eeqos, rate, 0.0)
    sm = rate * dtime
    p = sm / torch.clamp(mass, min=1e-30)
    # 1 - exp(-p) without the float32 cancellation at small p (the JAX
    # package computes it in float64: its dtime is float64)
    frac = -torch.expm1(-p)
    dM = mass * frac
    sfr = torch.where(dtime > 0, dM / dtime, rate) \
        * par.UnitSfr_in_solar_per_year

    # metal enrichment of the gas itself (sfr_eff.c:772-774)
    k1, k2, k3 = threefry.split(rng_key, 3)
    w = id_uniform(k1, pid)
    met_new = metallicity + torch.where(
        on_eeqos, w * METAL_YIELD * frac / par.Generations, 0.0)

    # stochastic star formation (starformation, sfr_eff.c:740-800)
    mass_of_star = torch.clamp(mass,
                               max=par.avg_baryon_mass / par.Generations)
    prob = dM / torch.clamp(mass_of_star, min=1e-30)
    draw = id_uniform(k2, pid + 1)
    make_star = on_eeqos & (draw < prob)

    if par.QuickLymanAlphaProbability > 0:
        # quicklyastarformation (sfr_eff.c:707-738)
        mw_ion = 4 / (8 - 5 * (1 - C.HYDROGEN_MASSFRAC))
        temp = u_current * mw_ion / par.temp_to_u
        qla = valid_gas & (density > par.OverDensThresh) \
            & (temp < par.QuickLymanAlphaTempThresh) \
            & (id_uniform(k3, pid + 1) < par.QuickLymanAlphaProbability)
        make_star = qla
        mass_of_star = mass  # wholesale conversion

    convert = make_star & (mass_of_star >= 0.995 * mass)

    entropy_new = torch.where(on_eeqos, ent_relaxed,
                              torch.where(valid_gas, ent_cooled, entropy))
    ne_new = torch.where(valid_gas & ~on_eeqos, ne_cooled, ne)
    return {"entropy": entropy_new, "ne": ne_new,
            "sfr": torch.where(valid_gas, sfr, 0.0),
            "metallicity": torch.where(valid_gas, met_new, metallicity),
            "make_star": make_star, "convert": convert,
            "star_mass": torch.where(make_star, mass_of_star, 0.0),
            "sm": torch.where(on_eeqos, dM, 0.0),
            "on_eeqos": on_eeqos}


def _mul32(a, c):
    """(a * c) mod 2^32 for int64 a in [0, 2^32) and a constant c < 2^32,
    without an int64 product above 2^63: c split in 16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def id_uniform(key, pid):
    """Deterministic per-ID uniform deviate in [0, 1] (the JAX package's
    _id_uniform, the RandTable analog): one uint32 word of the key, then a
    multiplicative hash of the ID's low 32 bits (pid.astype(uint32)), in
    int64 with the wrap-around explicit.  Float32, bit for bit the JAX
    package's."""
    bits = threefry.bits32(threefry.fold_in(key, 0))
    h = _mul32(pid & MASK32, 2654435761) ^ bits
    h = ((h ^ (h >> 16)) * 0x45d9f3b) & MASK32
    h = h ^ (h >> 16)
    return h.to(torch.float32) * (2.0 ** -32)


def spawn_stars(pdata, sph, make_star, convert, star_mass, atime,
                stars=None, vdisp=None):
    """Create star particles (make_particle_star + slots_split_particle
    analog): whole conversions flip ptype in place; partial ones claim the
    free (invalid) rows in index order for the new star and reduce the gas
    mass.  stars: optional StarData (aligned); new star rows get the
    source gas's density and metallicity, formation_time = atime and,
    with vdisp (the halo wind model's DM velocity dispersion per row),
    the source row's dispersion.

    Returns (pdata, sph, stars, n_spawned, overflow, new_star_rows), as the
    JAX package's spawn_stars."""
    n = pdata.capacity
    dev = pdata.device
    ptype = torch.where(convert, 4, pdata.ptype)
    spawn = make_star & ~convert
    free = ~pdata.valid
    # free rows first, in index order: the JAX package's stable argsort
    free_idx_of_rank = torch.argsort((~free).to(torch.int32), stable=True)
    spawn_rank = torch.cumsum(spawn.to(torch.int64), 0) - 1
    nspawn = int(spawn.sum())
    nfree = int(free.sum())
    overflow = nspawn > nfree
    dest = free_idx_of_rank[torch.clamp(spawn_rank, 0, n - 1)]
    dest = torch.where(spawn & (spawn_rank < nfree), dest, n)
    src = torch.nonzero(dest < n).flatten()
    to = dest[src]

    def scatter(arr, vals):
        out = arr.clone()
        out[to] = vals[src].to(out.dtype)
        return out

    new_mass = torch.where(spawn, pdata.mass - star_mass, pdata.mass)
    pdata = pdata.replace(
        ptype=scatter(ptype, torch.full((n,), 4, dtype=torch.int32,
                                        device=dev)),
        ipos=scatter(pdata.ipos, pdata.ipos),
        vel=scatter(pdata.vel, pdata.vel),
        # spawned stars inherit the parent gas kernel size
        # (slots_split_particle copies the whole particle incl. Hsml)
        hsml=scatter(pdata.hsml, pdata.hsml),
        dt_hsml=scatter(pdata.dt_hsml, pdata.dt_hsml),
        mass=scatter(new_mass, star_mass),
        pid=scatter(pdata.pid, pdata.pid + SPAWN_PID_OFFSET),
        valid=scatter(pdata.valid, spawn),
        timebin=scatter(pdata.timebin, pdata.timebin),
        grav_accel=scatter(pdata.grav_accel, pdata.grav_accel),
        grav_pm=scatter(pdata.grav_pm, pdata.grav_pm))
    if stars is not None:
        def fill(field, vals):
            # converted rows in place, spawned rows at dest
            m = convert if vals.dim() == 1 else convert[:, None]
            return scatter(torch.where(m, vals, field), vals)

        stars = stars.replace(
            formation_time=fill(stars.formation_time, torch.where(
                make_star, _scalar(atime, torch.float32), 0.0)),
            birth_density=fill(stars.birth_density,
                               torch.where(make_star, sph.density, 0.0)),
            metallicity=fill(stars.metallicity,
                             torch.where(make_star, sph.metallicity, 0.0)),
            metals=fill(stars.metals,
                        torch.where(make_star[:, None], sph.metals, 0.0)),
            total_mass_returned=fill(stars.total_mass_returned,
                                     torch.zeros_like(star_mass)),
            last_enrichment_myr=fill(stars.last_enrichment_myr,
                                     torch.zeros_like(star_mass)),
            vdisp=(fill(stars.vdisp, torch.where(make_star, vdisp, 0.0))
                   if vdisp is not None else stars.vdisp))
    # rows that ARE new stars after the scatters
    new_star_rows = convert.clone()
    new_star_rows[to] = True
    return pdata, sph, stars, nspawn, overflow, new_star_rows
