"""Glass initial conditions: reversed-gravity relaxation (PyTorch port of
mpgadget_tpu/genic/glass.py).

Re-design of libgenic/glass.c: random positions are evolved under
*inverted* PM gravity with a velocity damping term (setup_glass /
glass_evolve, glass.c:38-144).  The gravitational constant is
normalized so 4 pi G rho_mean = 1, making the linear oscillation
period 2 pi; 14 steps of dt = pi/2 with the damped KDK
(kick: dv = (F - v) * dt/2, glass.c:106-112) land near the energy
minimum — a uniform "glass" with sub-Poisson small-scale power.

As in genic/main.c:139-154, each flagged species starts from its own
random cloud, but the relaxation runs *coherently* over all species at
once so gas and CDM avoid close pairs with each other too.
"""

import numpy as np
import torch

from ..pm.gravity import pm_force, PMConfig
from ..particles import pos_to_fixed, fixed_to_pos
from ..integrate import drift


def random_positions(ngrid, boxsize, seed, shift=0.0):
    """Random cloud for one species (setup_glass, glass.c:38-56):
    lattice + uniform scatter of +-1.5 grid spacings per axis."""
    n = ngrid ** 3
    rng = np.random.RandomState(seed % (2 ** 31))
    idx = np.arange(ngrid)
    x, y, z = np.meshgrid(idx, idx, idx, indexing="ij")
    grid = np.stack([x, y, z], -1).reshape(-1, 3) * (boxsize / ngrid)
    pos = grid + shift + boxsize / ngrid * 3 * (rng.rand(n, 3) - 0.5)
    return np.mod(pos, boxsize)


def glass_evolve(pos, mass, nmesh, boxsize, nsteps=14, verbose=False,
                 device="cuda"):
    """Damped KDK under inverted PM gravity (glass_evolve,
    glass.c:73-144) on ``device``.  pos: (N,3) host float; mass: (N,)
    relative weights (species mass ratios matter for the joint force).
    Returns relaxed positions (host f64)."""
    n = pos.shape[0]
    rho_mean = float(np.sum(mass)) / boxsize ** 3
    geff = 1.0 / (4 * np.pi * rho_mean)  # unit oscillation frequency
    cfg = PMConfig(nmesh=nmesh, boxsize=boxsize, asmth=1.5, G=geff)

    ipos = torch.as_tensor(pos_to_fixed(pos, boxsize).astype(np.int64),
                           device=device)
    vel = torch.zeros((n, 3), dtype=torch.float32, device=device)
    mass_t = torch.as_tensor(mass, dtype=torch.float32, device=device)

    def force(ipos):
        acc, _, _ = pm_force(ipos, mass_t, cfg, compute_potential=False)
        return -acc  # inverted gravity: overdensities repel

    acc = force(ipos)
    dt = np.pi / 2
    hdt = float(np.float32(0.5 * dt))
    for step in range(nsteps):
        vel = vel + (acc - vel) * hdt       # damped kick
        ipos = drift(ipos, vel, dt, 1.0 / boxsize)
        acc = force(ipos)
        vel = vel + (acc - vel) * hdt
        if verbose:  # glass_stats analog (glass.c:147-180)
            f2 = float(torch.mean(torch.sum(acc ** 2, -1))) ** 0.5
            v2 = float(torch.mean(torch.sum(vel ** 2, -1))) ** 0.5
            print(f"glass step {step}: <F^2>^.5={f2:.4g} "
                  f"<V^2>^.5={v2:.4g}")
    return fixed_to_pos(ipos.cpu().numpy(), boxsize)
