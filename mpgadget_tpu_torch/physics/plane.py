"""Weak-lensing potential planes (libgadget/plane.c:572-668 and the
lenstools.c:168-320 analog), PyTorch port of mpgadget_tpu/physics/plane.py
on one device.

At requested output times the matter distribution is cut into slabs along
chosen axis normals; each slab's projected overdensity is Poisson-solved
in 2-D Fourier space into the lensing potential (in rad^2, the lenstools
convention) and written as a FITS image with the lenstools header keys.

The NGP binning is a bincount of the cells (counts below 2^24 are exact in
float32, so the order of the sum does not matter); the 2-D Poisson solve
is a float32 ``torch.fft.rfft2`` with the reference's multipole factor
-2 (b0 b1/chi^2) / (4 pi^2 l^2) and 1-pixel Gaussian smoothing.  The
optional PM massive-neutrino correction plane (plane.c:389-447) is not
implemented, as in the JAX package; a warning is printed when it would
apply.  The sharded run projects each rank's rows and sums the counts
over ranks, so that its planes are the host path's bit for bit; rank 0
solves and writes them.
"""

import os
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch
from scipy import integrate

from ..utils import constants as C


@dataclass
class PlaneParams:
    output_times: List[float] = field(default_factory=list)
    resolution: int = 256
    thickness: float = -1.0          # internal units; <=0: boxsize
    cut_points: List[float] = field(default_factory=list)
    normals: List[int] = field(default_factory=lambda: [0, 1, 2])
    massive_nu_correction: bool = True
    double_out: bool = False


def comoving_distance(CP, a0, a1, unit_velocity_cm_s):
    """c * int da / (a^2 H) in internal length units
    (compute_comoving_distance, timefac.c:84-98)."""
    val, _ = integrate.quad(
        lambda a: 1.0 / (a * a * CP.hubble_function(a)), a0, a1,
        epsabs=0, epsrel=1e-8, limit=100)
    return C.LIGHTCGS / unit_velocity_cm_s * val


def project_slab(ipos, weights, normal_axis, center_box, half_box,
                 resolution):
    """NGP count of particles within the periodic slab, projected onto the
    perpendicular plane (grid3d_ngb + projectDensity analog).  ipos:
    int64[N, 3] in [0, 2^32); center_box, half_box: float32 values in box
    units.  Returns (counts float32[res, res], particles on the plane)."""
    pos = ipos.to(torch.float32) * float(2.0 ** -32)
    dn = pos[:, normal_axis] - center_box
    dn = dn - torch.round(dn)           # half to even, as jnp.round
    inside = (torch.abs(dn) < half_box) & (weights > 0)
    d0 = (normal_axis + 1) % 3
    d1 = (normal_axis + 2) % 3
    # positions within 2^-25 of the box edge round to 1.0: clipped
    i0 = torch.clamp((pos[:, d0] * resolution).to(torch.int64), 0,
                     resolution - 1)
    i1 = torch.clamp((pos[:, d1] * resolution).to(torch.int64), 0,
                     resolution - 1)
    flat = (i0 * resolution + i1)[inside]
    counts = torch.bincount(flat, minlength=resolution * resolution)
    return (counts.to(torch.float32).reshape(resolution, resolution),
            int(inside.sum()))


def lensing_potential_fft(density, b0, b1, chi, smooth=1.0):
    """2-D Poisson solve with Gaussian smoothing
    (calculate_lensing_potential, lenstools.c:168-230), float32; b0, b1,
    chi are float32 values."""
    res = density.shape[0]
    dev = density.device
    dk = torch.fft.rfft2(density)
    lx = torch.fft.fftfreq(res, device=dev).to(torch.float32)
    ly = torch.arange(res // 2 + 1, dtype=torch.float32, device=dev) / res
    l2 = lx[:, None] ** 2 + ly[None, :] ** 2
    l2[0, 0] = 1.0
    f32 = np.float32
    amp = float(f32(-2.0) * (f32(b0) * f32(b1) / (f32(chi) * f32(chi))))
    fac = (amp / (l2 * 4.0 * float(f32(np.pi ** 2)))
           * torch.exp(float(f32(-0.5 * (2.0 * np.pi * smooth) ** 2)) * l2))
    dk = dk * fac
    dk[0, 0] = 0.0
    return torch.fft.irfft2(dk, s=(res, res))


def cut_plane(ipos, weights, n_tot, boxsize, CP, atime, normal, center,
              thickness, resolution, chi, mesh=None, solve=True):
    """One lensing-potential plane (cutPlaneGaussianGrid,
    lenstools.c:233-320).  With mesh (the sharded run's ShardMesh) each
    rank projects its own rows and the counts are summed over ranks (one
    all-reduce; integer counts in float32, exact below 2^24), so the plane
    is the one of all rows together; solve=False skips the Poisson solve
    (ranks that write nothing).  Returns (plane f64[res,res] or None,
    n_on_plane)."""
    counts, n_plane = project_slab(
        ipos, weights, normal, float(np.float32(center / boxsize)),
        float(np.float32(0.5 * thickness / boxsize)), resolution)
    if mesh is not None:
        from ..parallel import collectives as coll
        tot = coll.psum(torch.cat([counts.reshape(-1), torch.tensor(
            [float(n_plane)], device=counts.device)]), mesh)
        counts = tot[:-1].reshape(resolution, resolution)
        n_plane = int(tot[-1])
    if not solve:
        return None, n_plane
    cell = boxsize / resolution
    norm_fac = (boxsize ** 3
                / (cell * cell * thickness)) / max(float(n_tot), 1.0)
    density = counts * float(np.float32(norm_fac))
    pot = lensing_potential_fft(density, cell, cell, chi)
    omega_source = CP.Omega0
    if getattr(CP, "MassiveNuLinRespOn", False):
        omega_source -= atime ** 3 * CP.ONu.nopart(atime)
    H0 = 100.0 * CP.HubbleParam * 3.2407793e-20      # 1/s
    cosmo_norm = 1.5 * H0 * H0 * omega_source / C.LIGHTCGS ** 2
    density_norm = (thickness * chi
                    * (C.CM_PER_KPC / CP.HubbleParam) ** 2 / atime)
    return (pot.cpu().numpy().astype(np.float64) * cosmo_norm
            * density_norm, n_plane)


def write_planes(sim, snapnum, params: PlaneParams, ipos=None,
                 weights=None, n_tot=None, write=True, mesh=None):
    """Compute and write all (cut, normal) planes (write_plane,
    plane.c:572-668) of sim's particles, with the internal random offset
    removed.

    ipos/weights/n_tot default to sim.pdata's rows; the sharded run
    passes a rank's rows instead (unshifted positions, their weights, the
    rows over all ranks) with its mesh, over which the projected counts
    are summed, and ``write`` true on rank 0 alone, which then solves and
    writes the FITS files.  Returns the files written."""
    from ..io.fits import write_fits_image
    boxsize = sim.cfg.boxsize
    thickness = params.thickness if params.thickness > 0 else boxsize
    cuts = list(params.cut_points)
    if not cuts:
        ncut = max(int(boxsize / thickness), 1)
        cuts = [(0.5 + i) * thickness for i in range(ncut)]
    atime = sim.atime
    chi = comoving_distance(sim.CP, atime, 1.0,
                            sim.cfg.units.UnitVelocity_in_cm_per_s)
    if write and params.massive_nu_correction \
            and getattr(sim.CP, "MassiveNuLinRespOn", False):
        print("PlaneMassiveNuCorrection: PM neutrino-correction plane "
              "not yet implemented; writing particle planes only")
    if ipos is None:
        weights = sim.pdata.valid.to(torch.float32)
        n_tot = int(sim.pdata.num_valid)
        ipos = sim._unshifted_ipos()
    ulen = sim.cfg.units.UnitLength_in_cm
    redshift = 1.0 / atime - 1.0
    written = []
    for ci, cut in enumerate(cuts):
        for normal in params.normals:
            plane, n_plane = cut_plane(
                ipos, weights, n_tot, boxsize, sim.CP, atime, int(normal),
                float(cut), thickness, params.resolution, chi, mesh=mesh,
                solve=write)
            if not write:
                continue
            fname = os.path.join(
                sim.cfg.output_dir,
                f"snap{snapnum}_potentialPlane{ci}_normal{normal}.fits")
            ode0 = sim.CP.OmegaLambda if sim.CP.OmegaLambda > 0 \
                else getattr(sim.CP, "Omega_fld", 0.0)
            header = [
                ("H0", sim.CP.HubbleParam * 100.0,
                 "Hubble constant in km/s*Mpc"),
                ("h", sim.CP.HubbleParam, "Dimensionless Hubble constant"),
                ("OMEGA_M", sim.CP.Omega0, "Dark Matter density"),
                ("OMEGA_L", ode0, "Dark Energy density"),
                ("W0", getattr(sim.CP, "w0_fld", -1.0),
                 "Dark Energy equation of state"),
                ("WA", getattr(sim.CP, "wa_fld", 0.0),
                 "Dark Energy running equation of state"),
                ("Z", redshift, "Redshift of the lens plane"),
                ("CHI", chi * ulen / C.CM_PER_MPC,
                 "Comoving distance in Mpc/h"),
                ("SIDE", boxsize * ulen / C.CM_PER_MPC,
                 "Side length in Mpc/h"),
                ("NPART", n_plane, "Number of particles on the plane"),
                ("UNIT", "rad2", "Pixel value unit"),
            ]
            write_fits_image(fname, plane, header, double=params.double_out)
            written.append(fname)
    return written
