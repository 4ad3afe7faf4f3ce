"""Long-range PM gravity: CIC deposit -> FFT -> Green's function -> forces.

PyTorch port of mpgadget_tpu/pm/gravity.py (the petapm/gravpm stack of
the reference, libgadget/petapm.c, gravpm.c) on one device, through
``torch.fft.rfftn`` / ``irfftn``.  The k-space math matches gravpm.c:

* potential transfer (gravpm.c:384-452):
    fac = -G/(pi*L) * exp(-k2 * (2 pi Asmth/Nmesh)^2) / k2 * deconv^2
  with k2 in integer mode units and deconv = prod_axis 1/sinc^2(pi k_i/N)
  (times Nmesh^3, since irfftn normalizes);
* force transfer (gravpm.c:458-499): the 4th-order "super-Lanczos"
  finite difference i*D(w), D(w) = (8 sin w - sin 2w)/6, w = 2 pi k_i/N,
  scaled by Nmesh/L, with a minus sign for force = -grad phi;
* in-line total-matter power spectrum (powerspectrum.c:120-160).
"""

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.cic import cic_deposit, cic_readout, cic_readout_vec
from ..utils import constants as C


@dataclass(frozen=True)
class PMConfig:
    nmesh: int
    boxsize: float          # internal units
    asmth: float = 1.5      # force split scale in mesh cells
    G: float = 43007.1      # internal gravitational constant
    unitlength_in_cm: float = C.CM_PER_KPC


@dataclass
class PowerSpectrum:
    """Binned total-matter P(k), Mpc/h units (powerspectrum_sum)."""
    k: np.ndarray           # mean k per bin, h/Mpc
    power: np.ndarray       # P(k), (Mpc/h)^3
    nmodes: np.ndarray
    norm: float

    def save(self, outdir, time, D1, filename="powerspectrum"):
        if time <= 1e-4:
            fname = os.path.join(outdir, f"{filename}-{time:0.4e}.txt")
        else:
            fname = os.path.join(outdir, f"{filename}-{time:0.4f}.txt")
        with open(fname, "w") as fp:
            fp.write("# in Mpc/h Units \n")
            fp.write(f"# D1 = {D1:g} \n")
            fp.write("# k P N P(z=0)\n")
            for i in range(len(self.k)):
                if self.nmodes[i] == 0:
                    continue
                fp.write(f"{self.k[i]:g} {self.power[i]:g} "
                         f"{int(self.nmodes[i])} "
                         f"{self.power[i] / (D1 * D1):g}\n")
        return fname


def _kmodes(nmesh, device):
    """Signed integer mode numbers for an rfftn layout (f32)."""
    kx = torch.fft.fftfreq(nmesh, 1.0 / nmesh, device=device).to(
        torch.float32)
    kz = torch.arange(nmesh // 2 + 1, dtype=torch.float32, device=device)
    return (kx[:, None, None], kx[None, :, None], kz[None, None, :])


def _sinc(x):
    """Unnormalized sinc: sin(x)/x with sinc(0)=1."""
    small = torch.abs(x) < 1e-5
    return torch.where(small, 1.0, torch.sin(x) / torch.where(small, 1.0, x))


def _deconv(kmodes, nmesh):
    """CIC deconvolution 1/sinc^2 per axis, product over axes."""
    f = 1.0
    for k in kmodes:
        s = _sinc(k * (math.pi / nmesh))
        f = f / (s * s)
    return f


def _diff_kernel(w):
    """4th-order finite-difference kernel, gravpm.c:458-468."""
    return (8.0 * torch.sin(w) - torch.sin(2.0 * w)) / 6.0


def potential_transfer_fac(k2, deconv, nmesh, boxsize, gconst, asmth):
    """Green's function x Gaussian split x CIC deconv^2, gravpm.c:384-452.
    k2 in integer mode units; includes the nmesh^3 factor cancelling the
    1/N^3 of the normalized inverse FFT."""
    asmth2 = (2.0 * math.pi * asmth / nmesh) ** 2
    k2safe = torch.where(k2 == 0, 1.0, k2)
    scale = float(np.float32(-gconst * float(nmesh) ** 3)
                  / np.float32(np.pi * np.float32(boxsize)))
    fac = scale * torch.exp(-k2 * asmth2) / k2safe * deconv * deconv
    return torch.where(k2 == 0, 0.0, fac)


def force_transfer_fac(k, nmesh, boxsize):
    """i-multiplier for the force along one axis (applied as *1j*fac):
    4th-order super-Lanczos finite difference, gravpm.c:458-499."""
    w = k * (2.0 * math.pi / nmesh)
    return -_diff_kernel(w) * float(np.float32(nmesh) / np.float32(boxsize))


def _power_bins(rho_k, k2, kz, deconv, nmesh, nbins):
    """powerspectrum_add_mode: log-spaced bins of w |rho_k|^2 deconv^2.
    Returns (p_bins, n_bins, k_bins, norm) as float64 tensors/float.
    A bincount with weights replaces the TPU one-hot matmul reduction."""
    m2 = (rho_k.real ** 2 + rho_k.imag ** 2) * deconv * deconv
    w = torch.where((kz == 0) | (kz == nmesh // 2), 1.0, 2.0) \
        * torch.ones_like(k2)
    binsperunit = (nbins - 1) / np.log(np.sqrt(3.0) * nmesh / 2.0)
    # the bin edges are taken in f64, as the JAX package does (its
    # numpy-f64 binsperunit promotes the f32 log)
    kint = torch.floor(float(binsperunit * 0.5) * torch.log(
        torch.clamp(k2, min=1e-30)).to(torch.float64)).to(torch.int64)
    kint = torch.where(k2 == 0, nbins, kint).reshape(-1)  # drop zero mode
    keff = torch.sqrt(k2)

    def bsum(v):
        return torch.bincount(kint, weights=v.reshape(-1).to(torch.float64),
                              minlength=nbins + 1)[:nbins]

    norm = float(rho_k[0, 0, 0].real) ** 2
    return bsum(w * m2), bsum(w), bsum(w * keff), norm


def interp(x, xp, fp):
    """``jnp.interp`` in float32: linear between the knots xp
    (increasing), fp[0] below the first and fp[-1] above the last.  XLA
    contracts the last multiply-add into an FMA: the product of two
    float32 values is exact in float64, so the float64 sum rounded to
    float32 gives its bits."""
    xp = xp.to(torch.float32)
    fp = fp.to(torch.float32)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    lo_x, lo_f = xp[i - 1], fp[i - 1]
    dx = xp[i] - lo_x
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    q = (x - lo_x) / torch.where(dx0, 1.0, dx)
    f = torch.where(dx0, lo_f, (lo_f.double() + q.double()
                                * (fp[i] - lo_f).double()).float())
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _pm_force_kernel(ipos, weights, nmesh, boxsize, gconst, asmth,
                     nu_logk=None, nu_fac=None, compute_potential=True,
                     nbins=None):
    """Core PM computation; returns per-particle accel/potential and the
    raw binned power-spectrum accumulators."""
    device = ipos.device
    mass_mesh = cic_deposit(ipos, weights, nmesh)
    rho_k = torch.fft.rfftn(mass_mesh)

    kx, ky, kz = _kmodes(nmesh, device)
    k2 = kx * kx + ky * ky + kz * kz
    deconv = _deconv((kx, ky, kz), nmesh)

    if nu_logk is not None:
        # massive-neutrino linear response: multiply modes by the
        # interpolated 1 + f_nu delta_nu/delta_cdm table, before the power
        # binning (potential_transfer, gravpm.c:415-436)
        kmag = torch.sqrt(k2) * float(np.float32(2 * np.pi)
                                      / np.float32(boxsize))
        fac_nu = interp(torch.log(torch.clamp(kmag, min=1e-30)),
                        nu_logk, nu_fac)
        rho_k = rho_k * torch.where(k2 > 0, fac_nu, 1.0)

    if nbins is None:
        nbins = nmesh
    pk = _power_bins(rho_k, k2, kz, deconv, nmesh, nbins)

    pot_k = rho_k * potential_transfer_fac(k2, deconv, nmesh, boxsize,
                                           gconst, asmth)
    s = (nmesh,) * 3
    out_pot = None
    if compute_potential:
        out_pot = cic_readout(torch.fft.irfftn(pot_k, s=s), ipos)

    meshes = [torch.fft.irfftn(
        pot_k * (1j * force_transfer_fac(kk, nmesh, boxsize)), s=s)
        for kk in (kx, ky, kz)]
    accel = cic_readout_vec(torch.stack(meshes, dim=-1), ipos)
    return accel, out_pot, pk


def pm_force(ipos, weights, cfg: PMConfig, nu_table=None,
             compute_potential: bool = True):
    """PM long-range force for particles at fixed-point positions.

    nu_table: optional (logk, fac) arrays for the neutrino linear response
    multiplier.  Returns (accel f32[N,3] comoving internal, potential
    f32[N] or None, PowerSpectrum).  weights must be zero for invalid
    particles.
    """
    nu_logk, nu_fac = (None, None) if nu_table is None else (
        torch.as_tensor(np.asarray(nu_table[0], np.float32),
                        device=ipos.device),
        torch.as_tensor(np.asarray(nu_table[1], np.float32),
                        device=ipos.device))
    accel, pot, (p, n, k, norm) = _pm_force_kernel(
        ipos, weights, cfg.nmesh, cfg.boxsize, cfg.G, cfg.asmth,
        nu_logk, nu_fac, compute_potential)
    ps = _finalize_power(p.cpu().numpy(), n.cpu().numpy(),
                         k.cpu().numpy(), norm, cfg)
    return accel, pot, ps


def _finalize_power(p, n, k, norm, cfg: PMConfig) -> PowerSpectrum:
    """powerspectrum_sum: normalize and convert to Mpc/h units."""
    box_mpc = cfg.boxsize * cfg.unitlength_in_cm / C.CM_PER_MPC
    good = n > 0
    pk = np.zeros_like(p)
    kk = np.zeros_like(k)
    with np.errstate(invalid="ignore", divide="ignore"):
        pk[good] = p[good] / n[good] / max(norm, 1e-300) * box_mpc ** 3
        kk[good] = k[good] / n[good] * 2 * np.pi / box_mpc
    return PowerSpectrum(k=kk[good], power=pk[good], nmodes=n[good],
                         norm=norm)


def measure_power(ipos, weights, cfg: PMConfig) -> PowerSpectrum:
    """Deposit + FFT + binned |delta_k|^2 only (measure_power_spectrum,
    powerspectrum.c:163-180)."""
    nmesh = cfg.nmesh
    rho_k = torch.fft.rfftn(cic_deposit(ipos, weights, nmesh))
    kx, ky, kz = _kmodes(nmesh, ipos.device)
    k2 = kx * kx + ky * ky + kz * kz
    deconv = _deconv((kx, ky, kz), nmesh)
    p, n, k, norm = _power_bins(rho_k, k2, kz, deconv, nmesh, nmesh)
    return _finalize_power(p.cpu().numpy(), n.cpu().numpy(),
                           k.cpu().numpy(), norm, cfg)
