"""Zel'dovich initial conditions made on the device from the seed.

A frozen copy of MP-Gadget's recipe (libgenic/zeldovich.c, as the port's
genic/zeldovich.py follows it), cut to what the benchmark needs: white
noise from a ``torch.Generator`` (see ``make_ics`` for its seed), its modes
scaled by sqrt(P(k)/V) of the Eisenstein & Hu spectrum normalised to
sigma_8, unitary amplitudes, the displacement psi_k = i k / k^2 delta_k
and the growing-mode velocity a^2 H f psi.  The noise mesh has one cell
per lattice site, so each particle takes its site's displacement without
interpolation.  Dark matter only.

Everything is made in a few large calls on the device in float32; only
the spectrum table (a few hundred numbers) is made on the host.
"""

import math

import numpy as np
import torch

from .reference.cosmology import Background


def background(cfg):
    return Background(cfg["Omega0"], cfg["OmegaLambda"],
                      cfg["OmegaBaryon"], cfg["HubbleParam"])


def _sqrt_power_table(bg, cfg, a, device, npoints=512):
    box, ng = cfg["BoxSize"], cfg["Ngrid"]
    logk = np.linspace(math.log(math.pi / box),
                       math.log(2 * math.pi / box * ng * math.sqrt(3.0)),
                       npoints)
    sp = bg.sqrt_power(np.exp(logk), cfg["Sigma8"], a)
    return (torch.as_tensor(logk, dtype=torch.float32, device=device),
            torch.as_tensor(np.log(sp), dtype=torch.float32, device=device))


def _interp(x, xp, fp):
    i = torch.clamp(torch.searchsorted(xp, x.contiguous()), 1,
                    xp.shape[0] - 1)
    t = (x - xp[i - 1]) / (xp[i] - xp[i - 1])
    return fp[i - 1] + t * (fp[i] - fp[i - 1])


def make_ics(cfg, redshift, seed, device, field_seed=None):
    """The initial conditions of one run: a dict of device tensors
    (ipos int64[N,3] fixed point in [0, 2^32), vel float32[N,3] internal
    a^2 dx/dt, mass float32[N], ptype int32[N], pid int64[N]) and the
    header values (a, box, masses per type).  The same seed gives the
    same arrays on the same device.

    ``field_seed`` (the traffic's, where it names one) fixes the white
    noise, so that every run evolves the same realization and does the
    same work; ``seed`` then only orders the rows.  Without it the seed
    draws the noise too."""
    box, ng = float(cfg["BoxSize"]), int(cfg["Ngrid"])
    a = 1.0 / (1.0 + redshift)
    bg = background(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed if field_seed is None else field_seed)
                    % (1 << 63))
    noise = torch.randn((ng, ng, ng), generator=gen, dtype=torch.float32,
                        device=device)
    modes = torch.fft.rfftn(noise)
    del noise
    amp = torch.abs(modes)
    modes = modes / torch.where(amp > 0, amp, 1.0)      # unitary amplitude
    del amp
    kx = torch.fft.fftfreq(ng, 1.0 / ng, device=device).to(torch.float32)
    kz = torch.arange(ng // 2 + 1, dtype=torch.float32, device=device)
    kvec = (kx[:, None, None], kx[None, :, None], kz[None, None, :])
    k2 = kvec[0] ** 2 + kvec[1] ** 2 + kvec[2] ** 2
    logk = torch.log(torch.clamp(torch.sqrt(k2) * (2 * math.pi / box),
                                 min=1e-30))
    table = _sqrt_power_table(bg, cfg, a, device)
    sqrt_p = torch.exp(_interp(logk, *table))
    # delta_k of a field with the 1/V convention, times N^3 for irfftn's
    # normalisation, times N^-3/2 for the unit white noise's modes
    scale = ng ** 1.5 / box ** 1.5
    delta_k = modes * torch.where(k2 == 0, 0.0, sqrt_p * scale)
    del modes, sqrt_p, logk
    k2safe = torch.where(k2 == 0, 1.0, k2)
    disp = torch.stack([torch.fft.irfftn(
        delta_k * (1j * kk / k2safe * (box / (2 * math.pi))),
        s=(ng, ng, ng)).reshape(-1) for kk in kvec], dim=1)
    del delta_k
    vel_fac = a * a * bg.hubble_rate(a) * bg.growth_rate(a)

    idx = torch.arange(ng, device=device, dtype=torch.float64)
    lattice = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"),
                          dim=-1).reshape(-1, 3) * (box / ng)
    n = ng ** 3
    mass = cfg["Omega0"] * bg.rho_crit * box ** 3 / n
    frac = torch.remainder((lattice + disp.to(torch.float64)) / box, 1.0)
    out = dict(
        ipos=torch.clamp((frac * 2.0 ** 32).to(torch.int64), 0,
                         2 ** 32 - 1),
        vel=(disp * vel_fac).to(torch.float32),
        mass=torch.full((n,), mass, dtype=torch.float32, device=device),
        ptype=torch.ones((n,), dtype=torch.int32, device=device),
        pid=torch.arange(1, n + 1, device=device, dtype=torch.int64))
    gen.manual_seed(int(seed) % (1 << 63))
    order = torch.randperm(n, generator=gen, device=device)
    out = {k: v[order] for k, v in out.items()}
    masses = [0.0] * 6
    counts = [0] * 6
    masses[1], counts[1] = mass, n
    out["header"] = dict(a=a, box=box, masses=masses, counts=counts)
    return out
