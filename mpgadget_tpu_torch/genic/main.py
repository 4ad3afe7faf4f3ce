"""MP-GenIC equivalent CLI on one CUDA device: generate initial conditions
from a paramfile (PyTorch port of mpgadget_tpu/genic/main.py).

Usage: python -m mpgadget_tpu_torch.genic.main <paramfile>
Mirrors genic/main.c:22-287: per-species grid setup -> displacement
fields -> thermal velocities -> bigfile IC.  The meshes live on the card
unless the caller of :func:`run_genic` passes ``device="cpu"``.
"""

import os
import sys
import numpy as np
import torch

from ..params import create_genic_parameter_set
from ..cosmology import Cosmology
from ..utils import get_unitsystem, constants as C
from ..io.bigfile import BigFile
from ..io import snapshot as snap_io
from .power import (PowerSpec, PowerParams, DELTA_BAR, DELTA_CDM,
                    DELTA_CB, DELTA_NU)
from .zeldovich import generate_ic_species
from .thermal import (thermal_vel_disp, add_thermal_velocities,
                      ThermalVel, NU_V0)


def run_genic(paramfile_or_ps, override=None, device="cuda"):
    """Write the IC the parameters describe; returns its path."""
    if isinstance(paramfile_or_ps, str):
        ps = create_genic_parameter_set()
        ps.parse_file(paramfile_or_ps)
    else:
        ps = paramfile_or_ps
    for k, v in (override or {}).items():
        ps.set(k, v)

    units = get_unitsystem(ps["UnitLength_in_cm"], ps["UnitMass_in_g"],
                           ps["UnitVelocity_in_cm_per_s"])
    atime = 1.0 / (1 + ps["Redshift"])
    cp = Cosmology(
        Omega0=ps["Omega0"], OmegaBaryon=ps["OmegaBaryon"],
        OmegaLambda=ps["OmegaLambda"], HubbleParam=ps["HubbleParam"],
        CMBTemperature=ps["CMBTemperature"],
        RadiationOn=bool(ps["RadiationOn"]),
        MNu=(ps["MNue"], ps["MNum"], ps["MNut"]),
        Omega_fld=ps["Omega_fld"], w0_fld=ps["w0_fld"],
        wa_fld=ps["wa_fld"], Omega_ur=ps["Omega_ur"],
        use_class_radiation_convention=bool(ps["CLASS_Radiation"]),
        TimeBegin=atime,
    ).init_units(units)

    ppar = PowerParams(
        FileWithInputSpectrum=ps["FileWithInputSpectrum"],
        FileWithTransferFunction=ps["FileWithTransferFunction"],
        DifferentTransferFunctions=bool(ps["DifferentTransferFunctions"]),
        ScaleDepVelocity=(bool(ps["ScaleDepVelocity"])
                          if ps["ScaleDepVelocity"] >= 0
                          else bool(ps["DifferentTransferFunctions"])),
        WhichSpectrum=ps["WhichSpectrum"], Sigma8=ps["Sigma8"],
        InputPowerRedshift=ps["InputPowerRedshift"],
        PrimordialIndex=ps["PrimordialIndex"])
    pspec = PowerSpec(ppar, cp, atime, units.UnitLength_in_cm)

    boxsize = ps["BoxSize"]
    ngrid = ps["Ngrid"]
    ngrid_gas = ps["NgridGas"] if ps["NgridGas"] > 0 else ngrid
    # reference default: displacement mesh at twice the particle grid
    # (genic/params.c:198-199) — keeps CIC-readout smoothing of the
    # displacement field well below the particle Nyquist band
    nmesh = ps["Nmesh"] if ps["Nmesh"] > 0 else 2 * ngrid
    produce_gas = bool(ps["ProduceGas"])
    use_pec = bool(ps["UsePeculiarVelocity"])

    # species masses: total matter split between CDM and gas
    omega_cdm = cp.OmegaCDM
    omega_b = cp.OmegaBaryon if produce_gas else 0.0
    omegam_particles = cp.Omega0 - cp.ONu(1.0)  # particles carry cdm+b
    vol = boxsize ** 3
    rho = cp.RhoCrit * vol
    if produce_gas:
        mass_cdm = omega_cdm * rho / ngrid ** 3
        mass_gas = cp.OmegaBaryon * rho / ngrid_gas ** 3
        # mass-weighted lattice offsets (genic/main.c:63-64): the
        # mass-weighted mean shift of the interleaved grids is zero,
        # cancelling the leading-order chessboard power of two offset
        # lattices with unequal masses
        shift_cdm = (0.5 * cp.OmegaBaryon / cp.Omega0
                     * boxsize / ngrid)
        shift_gas = (-0.5 * (cp.Omega0 - cp.OmegaBaryon) / cp.Omega0
                     * boxsize / ngrid_gas)
        tcdm = DELTA_CDM if ppar.DifferentTransferFunctions else DELTA_CB
        tgas = DELTA_BAR if ppar.DifferentTransferFunctions else DELTA_CB
    else:
        mass_cdm = omegam_particles * rho / ngrid ** 3
        shift_cdm = 0.0
        tcdm = DELTA_CB

    # neutrino particle species (genic/main.c:62-99,205-236): a third
    # lattice of NgridNu^3 type-2 particles carrying the slow tail of
    # the Fermi-Dirac distribution (truncated at Max_nuvel), displaced
    # with the DELTA_NU transfer function.  Without gas the CDM/nu
    # lattices get mass-weighted offsets like the CDM/gas pair.
    ngrid_nu = int(ps["NgridNu"])
    omega_nu = cp.ONu(1.0)
    total_nufrac = 0.0
    nu_therm = None
    mass_nu = 0.0
    if ngrid_nu > 0:
        if not produce_gas:
            mean_sep = boxsize / max(ngrid, ngrid_nu)
            shift_nu = -0.5 * (cp.Omega0 - omega_nu) / cp.Omega0 \
                * mean_sep
            shift_cdm = 0.5 * omega_nu / cp.Omega0 * mean_sep
        else:
            shift_nu = 0.0
        # F-D sampler truncated at Max_nuvel: the particles carry only
        # the slow fraction of the distribution; the rest stays in the
        # linear-response field (hybrid neutrinos).  v_th = kB T_nu /
        # (m_nu c^2) * c / a, peculiar km/s (thermal.c NU_V0).
        kb_mnu = 3.0 * cp.ONu.kBtnu / (cp.MNu[0] + cp.MNu[1]
                                       + cp.MNu[2])
        v_th = NU_V0(atime, kb_mnu, units.UnitVelocity_in_cm_per_s)
        if not use_pec:
            v_th /= np.sqrt(atime)
        nu_therm = ThermalVel(v_th, max_fd=ps["Max_nuvel"] / v_th)
        total_nufrac = nu_therm.total_frac
        # particle mass carries only the sampled mass fraction
        # (libgenic/save.c:99-104 compute_mass)
        mass_nu = total_nufrac * omega_nu * rho / ngrid_nu ** 3

    outdir = ps["OutputDir"]
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, ps["FileBase"])
    bf = BigFile(path, create=True)
    ntot = np.zeros(6, np.uint64)
    species = []

    # Glass pre-positions (genic/main.c:139-154): a baryon glass by
    # default with species transfer functions (avoids lattice coupling
    # between offset grids); coherent relaxation over all species.
    glass_cdm = bool(ps["MakeGlassCDM"])
    glass_gas = ps["MakeGlassGas"]
    if glass_gas < 0:
        glass_gas = 1 if (produce_gas
                          and ppar.DifferentTransferFunctions) else 0
    glass_gas = bool(glass_gas) and produce_gas
    pre_cdm = pre_gas = None
    if glass_cdm or glass_gas:
        pre_cdm, pre_gas = _make_glass(
            glass_cdm, glass_gas and produce_gas, ngrid, ngrid_gas,
            nmesh, boxsize, ps["Seed"], shift_cdm,
            shift_gas if produce_gas else 0.0,
            mass_cdm, mass_gas if produce_gas else 0.0, device=device)

    ic = generate_ic_species(
        pspec, cp, seed=ps["Seed"], ngrid=ngrid, nmesh=nmesh,
        boxsize=boxsize, atime=atime, ptype=tcdm, shift=shift_cdm,
        unitary=bool(ps["UnitaryAmplitude"]),
        invert=bool(ps["InvertPhase"]),
        use_peculiar_velocity=use_pec,
        scale_dep_velocity=ppar.ScaleDepVelocity, pre_pos=pre_cdm,
        device=device)
    species.append((1, ic, mass_cdm))
    if produce_gas:
        icg = generate_ic_species(
            pspec, cp, seed=ps["Seed"], ngrid=ngrid_gas, nmesh=nmesh,
            boxsize=boxsize, atime=atime, ptype=tgas, shift=shift_gas,
            unitary=bool(ps["UnitaryAmplitude"]),
            invert=bool(ps["InvertPhase"]),
            use_peculiar_velocity=use_pec,
            scale_dep_velocity=ppar.ScaleDepVelocity, pre_pos=pre_gas,
            device=device)
        # gas IDs offset so they are unique
        icg["pid"] = icg["pid"] + ngrid ** 3
        species.append((0, icg, mass_gas))

    if ngrid_nu > 0:
        icn = generate_ic_species(
            pspec, cp, seed=ps["Seed"], ngrid=ngrid_nu, nmesh=nmesh,
            boxsize=boxsize, atime=atime, ptype=DELTA_NU,
            shift=shift_nu,
            unitary=bool(ps["UnitaryAmplitude"]),
            invert=bool(ps["InvertPhase"]),
            use_peculiar_velocity=use_pec,
            scale_dep_velocity=ppar.ScaleDepVelocity, device=device)
        icn["pid"] = icn["pid"] + ngrid ** 3 \
            + (ngrid_gas ** 3 if produce_gas else 0)
        # random F-D thermal speeds, deterministic Seed+2 stream
        # (genic/main.c:224-231)
        add_thermal_velocities(icn, nu_therm, ps["Seed"] + 2, atime,
                               use_pec)
        species.append((2, icn, mass_nu))

    if ps["MWDM_therm"] > 0:
        vtherm = thermal_vel_disp_wdm(ps["MWDM_therm"], atime, cp,
                                      units)
        for t, ic_s, m in species:
            if t == 1:
                add_thermal_velocities(ic_s, vtherm, ps["Seed"] + 1,
                                       atime, use_pec)

    masstable = np.zeros(6)
    for ptype, ic_s, mass in species:
        n = len(ic_s["pid"])
        ntot[ptype] = n
        masstable[ptype] = mass
        extra = {}
        if ps["SavePrePos"]:
            extra["PrePosition"] = ic_s["pre_pos"].astype("<f8")
        snap_io.write_species(
            bf, ptype, pos=ic_s["pos"],
            vel=ic_s["vel"], pid=ic_s["pid"], atime=atime,
            use_peculiar=use_pec, extra=extra)

    hubble = cp.hubble_function(atime)
    rsd = 1.0 / (atime * hubble)
    if not use_pec:
        rsd /= np.sqrt(atime)
    header = snap_io.SnapshotHeader(
        TotNumPart=ntot, MassTable=masstable, Time=atime, TimeIC=atime,
        BoxSize=boxsize, Omega0=cp.Omega0, OmegaLambda=cp.OmegaLambda,
        HubbleParam=cp.HubbleParam, OmegaBaryon=cp.OmegaBaryon,
        CMBTemperature=cp.CMBTemperature,
        UnitLength_in_cm=units.UnitLength_in_cm,
        UnitMass_in_g=units.UnitMass_in_g,
        UnitVelocity_in_cm_per_s=units.UnitVelocity_in_cm_per_s,
        UsePeculiarVelocity=int(use_pec), RSDFactor=rsd,
        FractionNuInParticles=total_nufrac,
    )
    snap_io.write_header(bf, header)
    print(f"Wrote ICs to {path}: N = {ntot.tolist()}")
    return path


def _make_glass(glass_cdm, glass_gas, ngrid, ngrid_gas, nmesh, boxsize,
                seed, shift_cdm, shift_gas, mass_cdm, mass_gas,
                device="cuda"):
    """Build glass pre-positions for the flagged species; species not
    flagged keep their regular lattice but still source the joint
    relaxation force (genic/main.c:136-154)."""
    from .glass import random_positions, glass_evolve
    from .zeldovich import make_grid
    n_cdm = ngrid ** 3
    if glass_cdm:
        pos_cdm = random_positions(ngrid, boxsize, seed * 31 + 7,
                                   shift_cdm)
    else:
        pos_cdm, _ = make_grid(ngrid, boxsize, shift_cdm)
    parts = [pos_cdm]
    masses = [np.full(n_cdm, mass_cdm)]
    if glass_gas:
        parts.append(random_positions(ngrid_gas, boxsize,
                                      (seed + 1) * 31 + 7, shift_gas))
        masses.append(np.full(ngrid_gas ** 3, mass_gas))
    allpos = glass_evolve(np.concatenate(parts),
                          np.concatenate(masses), nmesh, boxsize,
                          device=device)
    # the coherent evolution moves *every* species (a lattice adjusts
    # slightly to avoid the glass particles), so keep all positions
    pre_gas = allpos[n_cdm:] if glass_gas else None
    return allpos[:n_cdm], pre_gas


def thermal_vel_disp_wdm(mwdm_kev, atime, cp, units):
    """WDM thermal velocity (thermal.h WDM_V0 analog)."""
    omega_wdm = cp.OmegaCDM
    h = cp.HubbleParam
    v0 = (0.012 * (atime / 0.01) ** -1 * (omega_wdm / 0.3) ** (1.0 / 3)
          * (h / 0.65) ** (2.0 / 3) * (1.0 / mwdm_kev) ** (4.0 / 3))
    return v0 * 1e5 / units.UnitVelocity_in_cm_per_s


def main():
    if len(sys.argv) < 2:
        print("Usage: python -m mpgadget_tpu_torch.genic.main <paramfile>")
        sys.exit(1)
    if not torch.cuda.is_available():
        raise SystemExit("mpgadget_tpu_torch.genic.main needs a CUDA device")
    run_genic(sys.argv[1], device="cuda")


if __name__ == "__main__":
    main()
