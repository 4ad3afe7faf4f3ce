"""Distributed pencil FFT and PM gravity on an x-slab mesh.

PyTorch port of mpgadget_tpu/parallel/pfft.py, the analog of the
reference's PFFT pencil engine (libgadget/petapm.c:105-357).  Each rank
holds nmesh/S x-planes of the mesh; the 3-D real-to-complex transform is

    rfft(z), fft(y)  [local]  ->  all_to_all x<->y  ->  fft(x)

so that every stage is a dense local cuFFT (``torch.fft``) and the one
transpose is the pencil alltoallv of petapm.c:278-320.  The k-space
transfer functions are the single-device ones (pm/gravity.py), so the
Green's function cannot drift between the two paths.
"""

import math

import numpy as np
import torch

from ..ops.cic import _cell_frac_col
from ..pm.gravity import (potential_transfer_fac, force_transfer_fac, _sinc,
                          _power_bins, interp)
from . import collectives as coll


def cell_and_frac(ipos, nmesh):
    cells, fracs = zip(*[_cell_frac_col(ipos[:, c], nmesh)
                         for c in range(3)])
    return torch.stack(cells, dim=1), torch.stack(fracs, dim=1)


def _kmodes_slab(nmesh, ny_loc, s, device):
    """Integer k modes of the (kx full, ky local slice, kz half) layout
    after the forward pencil transform on rank s."""
    kx = torch.fft.fftfreq(nmesh, 1.0 / nmesh, device=device).to(
        torch.float32)
    ky = kx[s * ny_loc:(s + 1) * ny_loc]
    kz = torch.arange(nmesh // 2 + 1, dtype=torch.float32, device=device)
    return kx[:, None, None], ky[None, :, None], kz[None, None, :]


def _deconv_slab(kx, ky, kz, nmesh):
    f = 1.0
    for k in (kx, ky, kz):
        ss = _sinc(k * (math.pi / nmesh))
        f = f / (ss * ss)
    return f


def pencil_r2c(local_mesh, mesh):
    """(nx_loc, N, N) real slab -> (N, ny_loc, N//2+1) complex pencil."""
    S = mesh.size
    nx, N, _ = local_mesh.shape
    rho = torch.fft.rfft(local_mesh, dim=2)
    rho = torch.fft.fft(rho, dim=1)
    nz = rho.shape[2]
    ny = N // S
    # rows for rank j: this slab's y-slice j
    send = rho.reshape(nx, S, ny, nz).permute(1, 0, 2, 3).reshape(
        S * nx, ny, nz)
    recv, _ = coll.all_to_all(send, mesh)
    return torch.fft.fft(recv.reshape(N, ny, nz), dim=0)


def pencil_c2r(pencil, mesh):
    """(N, ny_loc, N//2+1) complex pencil -> (nx_loc, N, N) real slab."""
    S = mesh.size
    N, ny, nz = pencil.shape
    nx = N // S
    out = torch.fft.ifft(pencil, dim=0)
    recv, _ = coll.all_to_all(out.contiguous(), mesh)
    # from rank i: its ky slice of my x-planes
    out = recv.reshape(S, nx, ny, nz).permute(1, 0, 2, 3).reshape(
        nx, N, nz)
    out = torch.fft.ifft(out, dim=1)
    return torch.fft.irfft(out, n=N, dim=2)


def cic_deposit_slab(ipos, weights, nmesh, mesh):
    """CIC deposit of the rows inside this rank's geometric x-slab onto
    its planes (other rows are skipped).  The +1 corner that crosses the
    right face lands in a halo plane, which goes to the right neighbour
    and is added there (petapm.c's region layout with one halo cell)."""
    S, s = mesh.size, mesh.rank
    nx = nmesh // S
    n = nmesh
    cell, frac = cell_and_frac(ipos, nmesh)
    ix_loc = cell[:, 0] - s * nx
    ok = (ix_loc >= 0) & (ix_loc < nx)
    size = (nx + 1) * n * n
    buf = torch.zeros(size + 1, dtype=torch.float32, device=ipos.device)
    for dx in (0, 1):
        wx = (1.0 - frac[:, 0]) if dx == 0 else frac[:, 0]
        ix = ix_loc + dx
        for dy in (0, 1):
            wy = (1.0 - frac[:, 1]) if dy == 0 else frac[:, 1]
            iy = (cell[:, 1] + dy) % n
            for dz in (0, 1):
                wz = (1.0 - frac[:, 2]) if dz == 0 else frac[:, 2]
                iz = (cell[:, 2] + dz) % n
                flat = torch.where(ok, (ix * n + iy) * n + iz, size)
                buf.index_add_(0, flat, weights * wx * wy * wz)
    buf = buf[:size].reshape(nx + 1, n, n)
    halo_from_left = coll.ring_shift(buf[-1].contiguous(), mesh, +1)
    out = buf[:nx].clone()
    out[0] += halo_from_left
    return out


def cic_readout_slab(local_mesh, ipos, mesh):
    """CIC readout from an x-slab mesh with one halo plane from the right
    neighbour; local_mesh (nx_loc, N, N) or stacked (nx_loc, N, N, k).
    Rows outside the slab read zero."""
    S, s = mesh.size, mesh.rank
    nmesh = local_mesh.shape[1]
    nx = nmesh // S
    first = coll.ring_shift(local_mesh[0].contiguous(), mesh, -1)
    ext = torch.cat([local_mesh, first[None]], dim=0)
    vec = ext.ndim == 4
    k = ext.shape[-1] if vec else 1
    flatm = ext.reshape(-1, k)
    cell, frac = cell_and_frac(ipos, nmesh)
    ix_loc = cell[:, 0] - s * nx
    n = nmesh
    out = torch.zeros((ipos.shape[0], k), dtype=torch.float32,
                      device=ipos.device)
    ok = (ix_loc >= 0) & (ix_loc < nx)
    for dx in (0, 1):
        wx = (1.0 - frac[:, 0]) if dx == 0 else frac[:, 0]
        ix = torch.clamp(ix_loc + dx, 0, nx)
        for dy in (0, 1):
            wy = (1.0 - frac[:, 1]) if dy == 0 else frac[:, 1]
            iy = (cell[:, 1] + dy) % n
            for dz in (0, 1):
                wz = (1.0 - frac[:, 2]) if dz == 0 else frac[:, 2]
                iz = (cell[:, 2] + dz) % n
                flat = (ix * n + iy) * n + iz
                w = torch.where(ok, wx * wy * wz, 0.0)
                out = out + flatm[flat] * w[:, None]
    return out if vec else out[:, 0]


def slab_modes(nmesh, mesh, device):
    """(kx, ky, kz, k2, deconv) of this rank's pencil: the integer modes,
    their squared magnitude and the CIC deconvolution."""
    kx, ky, kz = _kmodes_slab(nmesh, nmesh // mesh.size, mesh.rank, device)
    return kx, ky, kz, kx * kx + ky * ky + kz * kz, _deconv_slab(kx, ky, kz,
                                                                 nmesh)


def nu_scale(rho_k, k2, nu_logk, nu_fac, boxsize):
    """The modes times the neutrino linear-response table interpolated at
    log |k| (k2 > 0; potential_transfer, gravpm.c:415-436), as
    pm/gravity._pm_force_kernel on one device."""
    kmag = torch.sqrt(k2) * float(np.float32(2 * np.pi)
                                  / np.float32(boxsize))
    fac_nu = interp(torch.log(torch.clamp(kmag, min=1e-30)), nu_logk,
                    nu_fac)
    return rho_k * torch.where(k2 > 0, fac_nu, 1.0)


def slab_power(rho_k, kz, k2, deconv, nmesh, nbins, mesh):
    """The in-line power bins of this rank's pencil summed over ranks
    (powerspectrum_add_mode at scale; the JAX package's _bin_reduce and
    psums): (p, n, k) float64 arrays of nbins and the zero mode's norm,
    which only rank 0 holds (ky = 0).  pm/gravity._finalize_power turns
    them into a PowerSpectrum."""
    p, n, k, norm = _power_bins(rho_k, k2, kz, deconv, nmesh, nbins)
    norm = torch.tensor([norm if mesh.rank == 0 else 0.0],
                        dtype=torch.float64, device=p.device)
    tot = coll.psum(torch.cat([p, n, k, norm]), mesh).cpu().numpy()
    return (tot[:nbins], tot[nbins:2 * nbins], tot[2 * nbins:3 * nbins],
            float(tot[-1]))


def pm_meshes(rho_k, nmesh, boxsize, gconst, asmth, mesh,
              with_potential=False):
    """Green's function and the 3 (4 with the potential) inverse pencil
    transforms of a forward-transformed density: the stacked real slab
    meshes (nx_loc, N, N, 3 or 4)."""
    kx, ky, kz, k2, deconv = slab_modes(nmesh, mesh, rho_k.device)
    pot_k = rho_k * potential_transfer_fac(k2, deconv, nmesh, boxsize,
                                           gconst, asmth)
    meshes = [pencil_c2r(pot_k * (1j * force_transfer_fac(
        kk, nmesh, boxsize)), mesh) for kk in (kx, ky, kz)]
    if with_potential:
        meshes.append(pencil_c2r(pot_k, mesh))
    return torch.stack(meshes, dim=-1).to(torch.float32)


def pm_force_slab(ipos, weights, nmesh, boxsize, gconst, asmth, mesh,
                  compute_potential=False, nu_logk=None, nu_fac=None,
                  nbins=0):
    """Sharded PM gravity of rows that lie in this rank's geometric slab:
    deposit -> pencil FFT -> [neutrino table] -> Green's function -> 3 (4)
    inverse transforms -> stacked readout.  nu_logk/nu_fac: the neutrino
    linear-response table (float32 tensors), multiplying the modes before
    the power bins; nbins > 0 also bins the total-matter power, summed
    over ranks (:func:`slab_power`).  Returns (accel [n,3], potential [n]
    or None, (p, n, k, norm) or None) in internal units, as
    pm/gravity._pm_force_kernel on one device."""
    rho_k = pencil_r2c(cic_deposit_slab(ipos, weights, nmesh, mesh), mesh)
    pk = None
    if nu_logk is not None or nbins:
        _, _, kz, k2, deconv = slab_modes(nmesh, mesh, rho_k.device)
        if nu_logk is not None:
            rho_k = nu_scale(rho_k, k2, nu_logk, nu_fac, boxsize)
        if nbins:
            pk = slab_power(rho_k, kz, k2, deconv, nmesh, nbins, mesh)
    stacked = pm_meshes(rho_k, nmesh, boxsize, gconst, asmth, mesh,
                        compute_potential)
    out = cic_readout_slab(stacked, ipos, mesh)
    return out[:, :3], (out[:, 3] if compute_potential else None), pk


def slab_measure_power(ipos, weights, nmesh, mesh, nbins):
    """The power bins of the deposit of rows in this rank's geometric slab
    (measure_power_spectrum, powerspectrum.c:163-180, at scale): deposit,
    pencil FFT, :func:`slab_power`."""
    rho_k = pencil_r2c(cic_deposit_slab(ipos, weights, nmesh, mesh), mesh)
    _, _, kz, k2, deconv = slab_modes(nmesh, mesh, rho_k.device)
    return slab_power(rho_k, kz, k2, deconv, nmesh, nbins, mesh)
