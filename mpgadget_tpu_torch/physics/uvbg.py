"""Excursion-set (21cmFAST-style) patchy UV background: PyTorch port of
mpgadget_tpu/physics/uvbg.py (after libgadget/uvbg.c, Mesinger et al.
2011; J21 from Sobacchi & Mesinger 2013 eq. 7).

Three grids (mass, escape-weighted stellar mass, escape-weighted SFR) are
CIC-deposited at UVBGdim^3 (ops/cic.py), filtered at a descending ladder
of radii with one k-space multiply each, and cells whose filtered
collapsed-star fraction exceeds 1/ReionEfficiency are flagged ionized,
recording J21 at the first (largest-R) crossing.  Partial ionization is
assigned at the final (cell-size) filter step.

The ladder is a host loop over radii, one ``torch.fft.irfftn`` per grid
and radius (cuFFT on the card): the JAX package computes these transforms
with ``jnp.fft`` outside any Pallas kernel (its ``lax.scan``), as the PM
step's.  Everything runs in float32 in the JAX package's association;
the FFTs, sin and cos round otherwise, so a cell whose f_coll lies within
a few ulps of the barrier may flip (``ladder``'s margin says how close
each cell came).

In the sharded run each rank deposits its own rows, the grids are summed
over ranks and the ladder runs on every rank (calculate_uvbg's mesh).

J21 is read back to the gas (the max over the CIC cloud) and converted to
photoionization and heating rates with the power-law-spectrum closed forms
(the J21CoeffFile analog): for J_nu = J21 1e-21 (nu/nu_HI)^-alpha and
sigma ~ nu^-3, Gamma_X = 4 pi sigma_X J21e-21 (nu_X/nu_HI)^-alpha /
(h_P (alpha+3)) and heat_X = Gamma_X h nu_X / (alpha + 2), in float64 as
the JAX package's numpy constants make them.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.cic import _cell_frac_col, cic_deposit
from ..utils import constants as C

PLANCK_CGS = 6.62607015e-27
EV_ERG = 1.60217663e-12
# photoionization thresholds (eV) and cross sections (cm^2)
NU_TH_EV = np.array([13.6, 24.59, 54.4])
SIGMA0 = np.array([6.30e-18, 7.83e-18, 1.58e-18])


@dataclass
class UVBGParams:
    uvbg_dim: int = 64
    r_bubble_max: float = 20000.0    # internal units
    r_bubble_min: float = 400.0
    delta_r_factor: float = 1.1
    filter_type: int = 0             # 0 tophat-r, 1 tophat-k, 2 gauss
    rtom_filter_type: int = 0
    nion_phot_per_bary: float = 4000.0
    alpha_uv: float = 5.0
    escape_frac_norm: float = 0.15
    escape_frac_scaling: float = 0.0
    use_particle_sfr: bool = True
    sfr_timescale: float = 0.5       # ReionSFRTimescale (hubble times)
    zstart: float = 20.0
    zstop: float = 5.0
    timestep_myr: float = 10.0       # UVBGTimestep


def _f32(x):
    return float(np.float32(x))


def _filter_fac(k_mag, R, filter_type):
    """The filter at k_mag (a float32 tensor) for radius R (a float32
    value)."""
    kR = k_mag * R
    if filter_type == 0:      # real-space top hat
        kRs = torch.clamp(kR, min=_f32(1e-8))
        # kRs ** 3 and ** 2 as JAX's integer_pow: x * (x * x), x * x
        sq = kRs * kRs
        w = 3.0 * (torch.sin(kRs) / (kRs * sq) - torch.cos(kRs) / sq)
        return torch.where(kR > _f32(1e-4), w, 1.0)
    if filter_type == 1:      # k-space top hat
        return torch.where(kR * _f32(0.413566994) > 1.0, 0.0, 1.0)
    x = kR * _f32(0.643)
    return torch.exp(-0.5 * (x * x))   # gaussian


def rtom(R, omega0, rho_crit, rtom_filter_type):
    if rtom_filter_type == 0:
        return 4.0 / 3.0 * np.pi * R ** 3 * omega0 * rho_crit
    return (2 * np.pi) ** 1.5 * omega0 * rho_crit * R ** 3


def radius_ladder(params: UVBGParams, boxsize):
    """The descending filter radii (calculate_uvbg, uvbg.c:560-590): from
    r_bubble_max down by delta_r_factor while above max(r_bubble_min,
    cell), then that floor; float64."""
    radii = []
    R = params.r_bubble_max
    rmin = max(params.r_bubble_min, boxsize / params.uvbg_dim)
    while R > rmin:
        radii.append(R)
        R /= params.delta_r_factor
    radii.append(rmin)
    return np.asarray(radii)


def k_magnitude(nmesh, boxsize, device):
    """|k| of the r2c grid (nmesh, nmesh, nmesh // 2 + 1), float32."""
    kx = torch.as_tensor(np.fft.fftfreq(nmesh, 1.0 / nmesh).astype(
        np.float32), device=device)
    kz = torch.arange(nmesh // 2 + 1, dtype=torch.float32, device=device)
    s = (kx[:, None, None] ** 2 + kx[None, :, None] ** 2) \
        + kz[None, None, :] ** 2
    # a true division of the two float32 scalars (PyTorch's scalar / tensor
    # multiplies by the reciprocal)
    fac = torch.tensor(_f32(2 * np.pi)) / torch.tensor(_f32(boxsize))
    return fac.to(device) * torch.sqrt(s)


def ladder(mass_k, star_k, sfr_k, radii, rtoms, nmesh, boxsize, filter_type,
           deltax_conv, pixel_volume, reion_eff, j21_const, sfr_norm):
    """The filter-radius ladder -> (xHI, J21, margin) grids (reion_loop_pm,
    uvbg.c:319-455; the JAX package's _excursion_scan): a host loop over
    the radii, three inverse FFTs each.  Scalars are rounded to float32 as
    the JAX package passes them.  margin: per cell, the least |f_coll *
    ReionEfficiency - 1| over the radii, how near the barrier the cell's
    decision came."""
    dev = mass_k.device
    k_mag = k_magnitude(nmesh, boxsize, dev)
    shape = (nmesh, nmesh, nmesh)
    f32 = torch.float32

    def t(x):
        return torch.tensor(_f32(x), dtype=f32, device=dev)

    deltax_conv, pixel_volume = t(deltax_conv), t(pixel_volume)
    reion_eff, j21_const, sfr_norm = t(reion_eff), t(j21_const), t(sfr_norm)
    barrier = t(1.0) / reion_eff
    xhi = torch.ones(shape, dtype=f32, device=dev)
    j21 = torch.zeros(shape, dtype=f32, device=dev)
    margin = torch.full(shape, float("inf"), dtype=f32, device=dev)
    last = len(radii) - 1
    vol_fac = _f32(4.0 / 3.0 * np.pi)
    for i, (R, rtom_r) in enumerate(zip(radii, rtoms)):
        R, rtom_r = t(R), t(rtom_r)
        filt = _filter_fac(k_mag, R, filter_type)
        m = torch.clamp(torch.fft.irfftn(mass_k * filt, s=shape), min=0.0)
        s = torch.clamp(torch.fft.irfftn(star_k * filt, s=shape), min=0.0)
        sf = torch.clamp(torch.fft.irfftn(sfr_k * filt, s=shape), min=0.0)
        dom = m * deltax_conv
        fcoll = s / torch.clamp(rtom_r * dom, min=_f32(1e-30)) \
            * (vol_fac * (R * (R * R))) / pixel_volume
        sfr_density = sf / pixel_volume * sfr_norm
        j21_aux = sfr_density * j21_const * R
        ion = fcoll > barrier
        margin = torch.minimum(margin, (fcoll * reion_eff - 1.0).abs())
        first = ion & (xhi > _f32(1e-5))
        j21 = torch.where(first, j21_aux, j21)
        xhi = torch.where(ion, 0.0, xhi)
        if i == last:
            # final (cell-size) step: partial ionization for neutral cells
            partial = torch.clamp(1.0 - fcoll * reion_eff, 0.0, 1.0)
            xhi = torch.where((~ion) & (xhi > _f32(1e-5)), partial, xhi)
    return xhi, j21, margin


def calculate_uvbg(ipos, mass, valid, is_gas, is_star, sfr, fesc,
                   params: UVBGParams, CP, units, boxsize, atime,
                   mesh=None):
    """The full excursion set: deposits + ladder + global xHI figures.

    fesc: per-row escape fraction (weighting the stellar mass and SFR
    deposits; init_particle_uvbg analog, computed by the caller from FOF
    halo masses).  With mesh (the sharded run's ShardMesh) the rows are
    one rank's: its three CIC deposits of the whole uvbg_dim^3 grid are
    summed over ranks in one all-reduce and the ladder runs on every
    rank.  Returns a dict with the grids ("xhi", "j21", "margin") and the
    volume- and mass-weighted global xHI."""
    nmesh = params.uvbg_dim
    w_mass = torch.where(valid, mass, 0.0)
    w_star = torch.where(valid & is_star, mass * fesc, 0.0)
    w_sfr = torch.where(valid & is_gas, sfr * fesc, 0.0)
    mass_grid = cic_deposit(ipos, w_mass, nmesh)
    star_grid = cic_deposit(ipos, w_star, nmesh)
    sfr_grid = cic_deposit(ipos, w_sfr, nmesh)
    if mesh is not None:
        from ..parallel import collectives as coll
        mass_grid, star_grid, sfr_grid = coll.psum(torch.stack(
            [mass_grid, star_grid, sfr_grid]), mesh).unbind(0)
    mass_k = torch.fft.rfftn(mass_grid)
    star_k = torch.fft.rfftn(star_grid)
    sfr_k = torch.fft.rfftn(sfr_grid)

    radii = radius_ladder(params, boxsize)
    rtoms = rtom(radii, CP.Omega0, CP.RhoCrit, params.rtom_filter_type)
    cell = boxsize / nmesh
    yhe = 1.0 - C.HYDROGEN_MASSFRAC
    baryon_frac = CP.OmegaBaryon / CP.Omega0
    reion_eff = (1.0 / baryon_frac * params.nion_phot_per_bary
                 / (1.0 - 0.75 * yhe))
    redshift = 1.0 / atime - 1.0
    deltax_conv = (nmesh ** 3
                   / (CP.RhoCrit * CP.Omega0 * boxsize ** 3))
    pixel_volume = cell ** 3
    # J21 normalization (uvbg.c:368-372)
    j21_const = ((1 + redshift) ** 2 / (4.0 * np.pi)
                 * params.alpha_uv * PLANCK_CGS * 1e21
                 * units.UnitLength_in_cm
                 * params.nion_phot_per_bary / C.PROTONMASS
                 * units.UnitMass_in_g / units.UnitLength_in_cm ** 3
                 / units.UnitTime_in_s)
    if params.use_particle_sfr:
        sfr_norm = 1.0
    else:
        hubble_time = 1.0 / (CP.hubble_function(atime) * CP.HubbleParam)
        sfr_norm = 1.0 / (params.sfr_timescale * hubble_time)
        sfr_k = star_k
    xhi, j21, margin = ladder(
        mass_k, star_k, sfr_k, radii, rtoms, nmesh, boxsize,
        params.filter_type, deltax_conv, pixel_volume, reion_eff, j21_const,
        sfr_norm)

    dom = torch.clamp(mass_grid * _f32(deltax_conv), min=0.0)
    sums = torch.stack([xhi.mean(), (xhi * dom).sum(), dom.sum()]).cpu()
    return {"xhi": xhi, "j21": j21, "margin": margin,
            "volume_weighted_global_xHI": float(sums[0]),
            "mass_weighted_global_xHI": float(
                sums[1] / torch.clamp(sums[2], min=_f32(1e-30)))}


def readout_j21_max(j21_grid, ipos):
    """Max J21 over each row's 8 CIC cells (readout_J21, uvbg.c:458-470:
    boundary rows count as ionized)."""
    nmesh = j21_grid.shape[0]
    flat = j21_grid.reshape(-1)
    cx, cy, cz = (_cell_frac_col(ipos[:, c], nmesh)[0] for c in range(3))
    out = torch.zeros(ipos.shape[0], dtype=j21_grid.dtype,
                      device=j21_grid.device)
    for dx in (0, 1):
        ix = (cx + dx) % nmesh
        for dy in (0, 1):
            iy = (cy + dy) % nmesh
            for dz in (0, 1):
                iz = (cz + dz) % nmesh
                out = torch.maximum(out, flat[(ix * nmesh + iy) * nmesh + iz])
    return out


def j21_to_rates(j21, alpha_uv):
    """([Gamma_HI, Gamma_HeI, Gamma_HeII] 1/s, [eps_*] erg/s) from J21 with
    a power-law spectrum (the J21CoeffFile analog; closed form for J ~
    nu^-alpha, sigma ~ nu^-3); float64 tensors, as the JAX package's numpy
    constants promote them (J21 times 1e-21 rounded to float32 first, as
    there)."""
    j = (j21.to(torch.float32) * 1e-21).to(torch.float64)
    a = alpha_uv
    out_g = []
    out_e = []
    for i in range(3):
        ratio = (NU_TH_EV[i] / NU_TH_EV[0]) ** (-a)
        gamma = 4 * np.pi * SIGMA0[i] * j * ratio \
            / (PLANCK_CGS * (a + 3.0))
        eps = gamma * (NU_TH_EV[i] * EV_ERG) / (a + 2.0)
        out_g.append(gamma)
        out_e.append(eps)
    return out_g, out_e


def escape_fractions(halo_mass, norm, scaling, unit_mass_in_g, hubble):
    """fesc(M_halo) = norm * (M / 1e10 Msun)^scaling, clipped to [0, 1]
    (init_particle_uvbg, uvbg.c:471-504); halo_mass float32."""
    conv = unit_mass_in_g / 1.989e33 / 1e10 / hubble
    f = norm * torch.clamp(halo_mass * conv, min=_f32(1e-30)) ** scaling
    return torch.where(halo_mass > 0, torch.clamp(f, 0.0, 1.0), 0.0)
