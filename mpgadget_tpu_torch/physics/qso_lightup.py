"""Quasar-driven helium (HeII -> HeIII) reionization: PyTorch port of
mpgadget_tpu/physics/qso_lightup.py (after
libgadget/cooling_qso_lightup.c, Upton-Sanderbeck et al. 2019).

Quasars are placed in FOF halos within a mass window; each blows an
ionized bubble of Gaussian-distributed radius, flash-heating the gas
inside by the instantaneous short-mean-free-path photoheating Q_inst;
bubbles are added until the global HeIII fraction matches an external
reionization-history table.  A uniform long-mean-free-path heating rate
applies to not-yet-ionized gas.

Each bubble is one dense minimum-image distance mask over all gas
(:func:`_ionize_bubble`), in float32 as in the JAX package; a row whose
distance lies within an ulp of the radius may be decided otherwise there.
The bubbles' order and radii come from numpy's RandomState seeded from
RandomSeed and the scale factor, so they are the JAX package's draws.
"""

import os
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..utils import constants as C

E0_HEII = 54.4          # HeII ionization potential, eV
HEMASS = 4.002602       # amu
EV_IN_ERGS = 1.60217663e-12
GM1_F32 = float(np.float32(C.GAMMA_MINUS1))


@dataclass
class HeIIHistory:
    """Parsed reionization-history table (load_heii_reion_hist,
    cooling_qso_lightup.c:138-246): quasar spectral index, absorption
    threshold, and (a, XHeIII, LMFP heating) columns."""
    alpha_q: float
    emax: float
    atime: np.ndarray       # scale factor, ascending
    xheiii: np.ndarray      # target HeIII fraction
    lmfp: np.ndarray        # uniform heating, erg/s/cm^3 (proper)
    qso_inst_heating: float  # ergs per helium atom

    @property
    def zstart(self):
        return 1.0 / self.atime[0] - 1.0

    @property
    def aend(self):
        return self.atime[-1]


def q_inst(emax, alpha_q):
    """Instantaneous heat per ionization for E < Emax photons, ergs
    (Q_inst, cooling_qso_lightup.c:112-121)."""
    intflux = ((emax ** (-alpha_q + 1.0) - E0_HEII ** (-alpha_q + 1.0))
               / (emax ** -alpha_q - E0_HEII ** -alpha_q))
    return EV_IN_ERGS * ((alpha_q / (alpha_q - 1.0)) * intflux
                         - E0_HEII)


def load_heii_reion_hist(path) -> HeIIHistory:
    """The table: two lines of one number (alpha_q, Emax), then rows of
    (z, XHeIII, LMFP heating); '#' comments."""
    rows = []
    scalars = []
    with open(path) as fh:
        for line in fh:
            t = line.split()
            if not t or t[0].startswith("#"):
                continue
            if len(t) == 1:
                scalars.append(float(t[0]))
            else:
                rows.append([float(x) for x in t[:3]])
    if len(scalars) < 2 or len(rows) < 2:
        raise ValueError(f"Malformed HeII reionization table {path}")
    alpha_q, emax = scalars[0], scalars[1]
    arr = np.asarray(rows)
    a = 1.0 / (1.0 + arr[:, 0])
    order = np.argsort(a)
    return HeIIHistory(
        alpha_q=alpha_q, emax=emax, atime=a[order],
        xheiii=arr[order, 1], lmfp=arr[order, 2],
        qso_inst_heating=q_inst(emax, alpha_q))


@dataclass
class QSOParams:
    min_mass: float = 100.0      # QSOMinMass, 1e10 Msun/h
    max_mass: float = 1000.0     # QSOMaxMass
    mean_bubble: float = 20000.0  # internal length
    var_bubble: float = 0.0
    finish_frac: float = 0.995   # QSOHeIIIReionFinishFrac
    heiii_start: float = 4.0     # heIIIreion_start redshift
    unit_internal_energy_cgs: float = 1e10  # (km/s)^2 default units

    def with_units(self, uu_cgs):
        return replace(self, unit_internal_energy_cgs=float(uu_cgs))


def desired_heiii_frac(hist: HeIIHistory, atime):
    return float(np.interp(atime, hist.atime, hist.xheiii))


def lmfp_heating(hist: Optional[HeIIHistory], params, atime):
    """Uniform long-mean-free-path heating rate erg/s/cm^3 at atime
    (get_long_mean_free_path_heating); 0 outside the table or the
    epoch."""
    if hist is None:
        return 0.0
    z = 1.0 / atime - 1.0
    if z > params.heiii_start or atime > hist.aend:
        return 0.0
    return float(np.interp(atime, hist.atime, hist.lmfp))


def _entropy_to_u(density):
    """max(rho, 1e-30)^(gamma-1) / (gamma-1), float32 (rho physical)."""
    return torch.clamp(density, min=float(np.float32(1e-30))) ** GM1_F32 \
        / density.new_tensor(GM1_F32)


def bubble_r2(ipos, center):
    """Minimum-image squared distance (box units, float32) of each row from
    center (3 float32 box coordinates)."""
    d = ipos.to(torch.float32) * float(np.float32(2.0 ** -32)) - center
    d = d - torch.round(d)
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def _ionize_bubble(ipos, is_gas, ionized, density, entropy, center,
                   radius_box, du_code, a3inv, mesh=None):
    """Mark and heat the un-ionized gas within radius_box of center (the
    ionize_ngbiter analog as one dense mask).  du_code: internal energy
    injected per unit mass, internal units; center, radius_box, du_code
    and a3inv float32 values.  Returns (ionized, entropy, rows hit, over
    the ranks of mesh when given)."""
    r2 = bubble_r2(ipos, center)
    rad = torch.tensor(radius_box, dtype=torch.float32, device=ipos.device)
    hit = is_gas & (~ionized) & (r2 < rad * rad)
    new_ent = entropy + density.new_tensor(du_code) / _entropy_to_u(
        density * a3inv)
    return (ionized | hit, torch.where(hit, new_ent, entropy),
            int(_total(hit.sum(), mesh)))


def _total(x, mesh):
    """x (a count) summed over the ranks of mesh (None: this device's)."""
    if mesh is None:
        return x
    from ..parallel import collectives as coll
    return coll.psum(x, mesh)


def place_bubbles(ipos, gas, ionized, density, entropy, cat,
                  hist: HeIIHistory, params: QSOParams, atime, boxsize,
                  random_seed, output_dir, write=True, mesh=None):
    """Advance helium reionization one PM step on the columns
    (do_heiii_reionization, cooling_qso_lightup.c:642-660): QSO bubbles
    placed one after another around FOF halos until the desired HeIII
    fraction is met, or a flash ionization past finish_frac.  cat: the FOF
    catalogue ("masses", "cm").  ``write`` gates the helium.txt append.
    With mesh (the sharded run's ShardMesh) the columns are one rank's
    rows: the gas count, the ionized count and each bubble's ionized rows
    are summed over ranks (one all-reduce each), while the catalogue and
    the numpy draws are the same on every rank, so every rank places the
    same bubbles.  Returns (ionized, entropy, bubbles)."""
    desired = desired_heiii_frac(hist, atime)
    counts = _total(torch.stack([gas.sum(), (ionized & gas).sum()]),
                    mesh).cpu()
    n_gas = int(counts[0])
    if n_gas == 0:
        return ionized, entropy, 0
    cur = int(counts[1]) / n_gas
    uu = params.unit_internal_energy_cgs
    nheperg = (1.0 - C.HYDROGEN_MASSFRAC) / (C.PROTONMASS * HEMASS)
    du_code = float(np.float32(hist.qso_inst_heating * nheperg / uu))
    a3inv = float(np.float32(1.0 / atime ** 3))
    helium_txt = os.path.join(output_dir, "helium.txt")
    dev = ipos.device

    if desired > params.finish_frac:
        # flash-ionize everything left (turn_on_quasars:540-548)
        ion2, ent2, nion = _ionize_bubble(
            ipos, gas, ionized, density, entropy,
            torch.zeros(3, dtype=torch.float32, device=dev), 2.0, du_code,
            a3inv, mesh)
        if write:
            with open(helium_txt, "a") as fh:
                fh.write(f"{atime:g} flash 0 0 0 1.0 {nion}\n")
        return ion2, ent2, 1

    if cur >= desired:
        return ionized, entropy, 0
    masses = np.asarray(cat["masses"])
    cand = np.flatnonzero((masses > params.min_mass)
                          & (masses < params.max_mass))
    if cand.size == 0:
        return ionized, entropy, 0
    rng = np.random.RandomState(
        (random_seed + int(atime * 1e6)) % (2 ** 31 - 1))
    rng.shuffle(cand)
    nbub = 0
    for qidx in cand:
        if cur >= desired:
            break
        radius = params.mean_bubble
        if params.var_bubble > 0:
            radius = max(rng.normal(params.mean_bubble,
                                    np.sqrt(params.var_bubble)), 0.0)
        pos = np.asarray(cat["cm"][qidx])
        center = torch.as_tensor((pos / boxsize % 1.0).astype(np.float32),
                                 device=dev)
        ionized, entropy, nion = _ionize_bubble(
            ipos, gas, ionized, density, entropy, center,
            float(np.float32(radius / boxsize)), du_code, a3inv, mesh)
        cur += nion / n_gas
        nbub += 1
        if write:
            with open(helium_txt, "a") as fh:
                fh.write(f"{atime:g} {pos[0]:g} {pos[1]:g} "
                         f"{pos[2]:g} {cur:g} {nion}\n")
    return ionized, entropy, nbub


def do_heiii_reionization(sim, cat, hist: HeIIHistory, params: QSOParams):
    """Advance helium reionization one PM step (do_heiii_reionization,
    cooling_qso_lightup.c:642-660) on a Simulation: cat is its FOF
    catalogue; sets sim.sph's he_iii_ionized and entropy and appends to
    helium.txt.  Returns the number of bubbles placed."""
    atime = sim.atime
    if 1.0 / atime - 1.0 > params.heiii_start or atime > hist.aend:
        return 0
    par = params.with_units(sim.cfg.units.UnitInternalEnergy_in_cgs)
    ionized, entropy, nbub = place_bubbles(
        sim.pdata.ipos, sim.gas_mask, sim.sph.he_iii_ionized > 0,
        sim.sph.density, sim.sph.entropy, cat, hist, par, atime,
        sim.cfg.boxsize, sim.cfg.random_seed, sim.cfg.output_dir)
    sim.sph = sim.sph.replace(he_iii_ionized=ionized.to(torch.uint8),
                              entropy=entropy)
    return nbub


def lmfp_heat_entropy(entropy, density, notion, rate, dt_s, atime, units,
                      hubble_param):
    """Entropy after uniform long-mean-free-path heating of the rows in
    notion (the not-yet-ionized gas): erg/s/cm^3 proper -> internal
    entropy, float32."""
    rho_cgs = density / atime ** 3 * units.UnitDensity_in_cgs \
        * hubble_param ** 2
    du_cgs = density.new_tensor(rate * dt_s) / torch.clamp(
        rho_cgs, min=float(np.float32(1e-35)))
    du_code = du_cgs / density.new_tensor(units.UnitInternalEnergy_in_cgs)
    heated = entropy + du_code / _entropy_to_u(density / atime ** 3)
    return torch.where(notion, heated, entropy).to(torch.float32)


def apply_lmfp_heating(sim, hist: HeIIHistory, params: QSOParams, dloga):
    """Uniform heating of the not-yet-ionized gas by long-mean-free-path
    photons over a step of dloga (applied in cooling_rates.c in the
    reference; here an entropy source term of its own)."""
    atime = sim.atime
    rate = lmfp_heating(hist, params, atime)   # erg/s/cm^3 proper
    if rate <= 0:
        return
    hubble = sim.CP.hubble_function(atime)
    dt_s = dloga / hubble * sim.cfg.units.UnitTime_in_s / sim.CP.HubbleParam
    notion = sim.gas_mask & (sim.sph.he_iii_ionized == 0)
    sim.sph = sim.sph.replace(entropy=lmfp_heat_entropy(
        sim.sph.entropy, sim.sph.density, notion, rate, dt_s, atime,
        sim.cfg.units, sim.CP.HubbleParam))
