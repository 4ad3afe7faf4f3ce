"""Zel'dovich (1LPT) initial conditions on the FFT mesh (PyTorch port of
mpgadget_tpu/genic/zeldovich.py).

The Gaussian random field is real-space white noise from a
``torch.Generator`` seeded with Seed, transformed by ``torch.fft.rfftn``
(hermitian symmetry for free), instead of the reference's per-mode GSL
ranlxd1 seed table (libgenic/pmesh.h:64-195).  The JAX package draws its
noise from JAX's threefry stream, which PyTorch cannot reproduce, so the
two packages give different realisations of the same statistics; this
one is deterministic in (Seed, Nmesh, device).  UnitaryAmplitude and
InvertPhase are supported.

The k-space kernels match zeldovich.c:
* density:       delta_k * exp(-k2/Nmesh^2) [gaussian smoothing, 1 cell]
* displacement:  psi_k = i k/k^2 delta_k    (disp_transfer, :297-313)
* velocity:      psi_k * dlogGrowth(k)      (N-body gauge, :315-323)
with delta_k = whitenoise * sqrt(P(k)/V).

Velocity prefactor (zeldovich.c:193-209): a H(a) [F_Omega(a) if
scale-independent], times sqrt(a) -> internal units if not peculiar.
Meshes are f32 / complex64, as in the JAX package.
"""

import numpy as np
import torch

from .power import DELTA_TOT
from ..ops.cic import cic_readout
from ..particles import pos_to_fixed


def make_grid(ngrid, boxsize, shift=0.0):
    """Regular particle lattice + IDs (idgen_*, zeldovich.c:48-106).

    IDs: i*Ng^2 + j*Ng + k + 1, positions at lattice points + shift.
    """
    idx = np.arange(ngrid)
    x, y, z = np.meshgrid(idx, idx, idx, indexing="ij")
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float64)
    pos = pos * (boxsize / ngrid) + shift
    pid = (x.astype(np.uint64) * ngrid * ngrid
           + y.astype(np.uint64) * ngrid + z.astype(np.uint64) + 1).ravel()
    return pos, pid


def gaussian_modes(seed, nmesh, unitary=False, invert=False, device="cuda"):
    """Hermitian white noise delta_k with E|delta_k|^2 = 1.

    Real-space N(0,1) noise from a torch.Generator on ``device`` seeded
    with ``seed`` -> rfftn / N^{3/2}.  Deterministic in (seed, nmesh,
    device); not the JAX package's realisation (see the module
    docstring).
    """
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    noise = torch.randn((nmesh, nmesh, nmesh), generator=gen,
                        dtype=torch.float32, device=device)
    modes = torch.fft.rfftn(noise) * (1.0 / nmesh ** 1.5)
    if unitary:
        amp = torch.abs(modes)
        modes = modes / torch.where(amp > 0, amp, 1.0)
    if invert:
        modes = -modes
    return modes


def interp(x, xp, fp):
    """jnp.interp for 1-D ascending xp: linear between neighbours,
    clamped to fp[0] below xp[0] and to fp[-1] above xp[-1]."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _kvecs(nmesh, device):
    kx = torch.fft.fftfreq(nmesh, 1.0 / nmesh, device=device).to(
        torch.float32)
    kz = torch.arange(nmesh // 2 + 1, dtype=torch.float32, device=device)
    return kx[:, None, None], kx[None, :, None], kz[None, None, :]


def _sqrt_power(delta_table, nmesh, boxsize, device):
    """(k2 in mode units, log k, sqrt P(k)) on the rfftn mesh."""
    kx, ky, kz = _kvecs(nmesh, device)
    k2 = kx * kx + ky * ky + kz * kz
    kmag = torch.sqrt(k2) * float(np.float32(2 * np.pi / boxsize))
    logk = torch.log(torch.clamp(kmag, min=float(np.float32(1e-30))))
    sqrt_p = torch.exp(interp(logk, delta_table[0], delta_table[1]))
    sqrt_p = torch.where(k2 == 0, 0.0, sqrt_p)
    return (kx, ky, kz), k2, logk, sqrt_p


def displacement_fields(modes, delta_table, growth_table, nmesh, boxsize,
                        ipos, scale_dep_velocity=False):
    """Zel'dovich displacements (and velocity factors) at particle
    positions by CIC readout of the three psi meshes.

    delta_table: (logk_internal, log sqrtP_internal) f32 tensors for
    :func:`interp`; growth_table: the same grid with dlogGrowth values
    (read only if scale_dep_velocity).  ipos: int64 fixed-point
    positions.  Returns (disp f32[N,3], vel_disp f32[N,3]) in internal
    length units; vel_disp must still be multiplied by the velocity
    prefactor.
    """
    dev = modes.device
    kvec, k2, logk, sqrt_p = _sqrt_power(delta_table, nmesh, boxsize, dev)
    # delta_k for a field with V^-1 convention; irfftn normalization
    # absorbs N^3 (see pm/gravity.py)
    amp = sqrt_p * float(np.float32(float(nmesh) ** 3 / boxsize ** 1.5))
    delta_k = (modes * amp).to(torch.complex64)
    k2safe = torch.where(k2 == 0, 1.0, k2)
    s = (nmesh,) * 3
    disp, vel = [], []
    for ka in kvec:
        fac = ka / k2safe * float(np.float32(boxsize / (2 * np.pi)))
        psi = torch.fft.irfftn(delta_k * (1j * fac), s=s)
        disp.append(cic_readout(psi, ipos))
        if scale_dep_velocity:
            growth = interp(logk, growth_table[0], growth_table[1])
            psi_v = torch.fft.irfftn(delta_k * (1j * fac * growth), s=s)
            vel.append(cic_readout(psi_v, ipos))
    disp = torch.stack(disp, dim=-1)
    vel = torch.stack(vel, dim=-1) if scale_dep_velocity else disp
    return disp, vel


def density_field(modes, delta_table, nmesh, boxsize, ipos):
    """delta(x) at particle positions, smoothed by one mesh cell
    (density_transfer, zeldovich.c:283-296)."""
    dev = modes.device
    _, k2, _, sqrt_p = _sqrt_power(delta_table, nmesh, boxsize, dev)
    smooth = torch.exp(-k2 * float(np.float32(1.0 / nmesh) ** 2))
    amp = sqrt_p * smooth * float(np.float32(float(nmesh) ** 3
                                             / boxsize ** 1.5))
    delta = torch.fft.irfftn((modes * amp).to(torch.complex64),
                             s=(nmesh,) * 3)
    return cic_readout(delta, ipos)


def delta_table_from_powerspec(pspec, boxsize, nmesh, ptype=DELTA_TOT,
                               npoints=512, device="cuda"):
    """Tabulate log sqrt(P) on a log-k grid spanning the mesh modes, as
    f32 tensors on ``device`` for :func:`interp`."""
    kmin = 2 * np.pi / boxsize * 0.5
    kmax = 2 * np.pi / boxsize * nmesh * np.sqrt(3.0)
    logk = np.linspace(np.log(kmin), np.log(kmax), npoints)
    delta = pspec.delta_spec(np.exp(logk), ptype)
    return (torch.as_tensor(logk, dtype=torch.float32, device=device),
            torch.as_tensor(np.log(np.maximum(delta, 1e-99)),
                            dtype=torch.float32, device=device))


def generate_ic_species(pspec, cosmology, seed, ngrid, nmesh, boxsize,
                        atime, ptype=DELTA_TOT, shift=0.0,
                        unitary=True, invert=False,
                        use_peculiar_velocity=True,
                        scale_dep_velocity=False,
                        pre_pos=None, device="cuda"):
    """Full Zel'dovich IC for one species, the meshes on ``device``.
    Returns a dict of host arrays: pos (displaced, internal units), vel
    (internal a^2 xdot), pid.

    pre_pos: optional pre-displacement positions (e.g. a relaxed glass
    from genic.glass) replacing the regular lattice; IDs stay the
    lattice IDs (genic/main.c:139-154 keeps idgen ordering)."""
    grid_pos, pid = make_grid(ngrid, boxsize, shift)
    if pre_pos is not None:
        grid_pos = np.asarray(pre_pos, np.float64)
    ipos = torch.as_tensor(pos_to_fixed(grid_pos, boxsize).astype(np.int64),
                           device=device)
    modes = gaussian_modes(seed, nmesh, unitary, invert, device=device)
    dtab = delta_table_from_powerspec(pspec, boxsize, nmesh, ptype,
                                      device=device)
    gtab = dtab
    if scale_dep_velocity:
        logk = dtab[0].cpu().numpy().astype(np.float64)
        growth = pspec.dlog_growth(np.exp(logk), ptype)
        gtab = (dtab[0], torch.as_tensor(growth, dtype=torch.float32,
                                         device=device))
    disp, veldisp = displacement_fields(
        modes, dtab, gtab, nmesh, boxsize, ipos, scale_dep_velocity)
    disp = disp.cpu().numpy().astype(np.float64)
    veldisp = veldisp.cpu().numpy().astype(np.float64)

    # File-value velocity exactly as zeldovich.c:193-209: peculiar
    # v_pec = a H f psi, or classic-gadget v_pec/sqrt(a).
    hubble_a = cosmology.hubble_function(atime)
    vel_prefac = atime * hubble_a
    if not use_peculiar_velocity:
        vel_prefac /= np.sqrt(atime)
    if not scale_dep_velocity:
        vel_prefac *= cosmology.F_Omega(atime)

    pos = np.mod(grid_pos + disp, boxsize)
    vel_file = veldisp * vel_prefac
    # Internal velocity per the snapshot reader (petaio.c STVelocity):
    # internal = file * a if peculiar, else file unchanged.
    vel_internal = vel_file * atime if use_peculiar_velocity else vel_file
    return {"pos": pos, "vel": vel_internal, "vel_file": vel_file,
            "pid": pid, "pre_pos": grid_pos, "disp": disp}
