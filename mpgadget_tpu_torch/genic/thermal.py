"""Thermal (Fermi-Dirac) velocities for neutrino / WDM particles.

Vectorized numpy re-design of libgenic/thermal.c: inverse-CDF sampling
of x^2/(e^x+1) with isotropic random directions, seeded deterministically.
"""

import numpy as np
from scipy import integrate, interpolate

from ..utils import constants as C

MAX_FERMI_DIRAC = 17.0
LENGTH_FERMI_DIRAC_TABLE = 2000


def NU_V0(Time, kBTNubyMNu, UnitVelocity_in_cm_per_s):
    """Neutrino thermal velocity amplitude (thermal.c:22-27).
    kBTNubyMNu = kB T_nu0 / (m_nu c^2), dimensionless."""
    return kBTNubyMNu / Time * (C.LIGHTCGS / UnitVelocity_in_cm_per_s)


def WDM_V0(Time, WDM_therm_mass, Omega_CDM, HubbleParam,
           UnitVelocity_in_cm_per_s):
    """WDM thermal velocity (Bode, Ostriker & Turok 2001)."""
    v0 = (0.012 / Time * (Omega_CDM / 0.3) ** (1.0 / 3)
          * (HubbleParam / 0.65) ** (2.0 / 3)
          * (1.0 / WDM_therm_mass) ** (4.0 / 3))
    return v0 * 1e5 / UnitVelocity_in_cm_per_s


class ThermalVel:
    """Inverse-CDF sampler for the Fermi-Dirac speed distribution
    (init_thermalvel, thermal.c:44-85)."""

    def __init__(self, v_amp, max_fd=MAX_FERMI_DIRAC, min_fd=0.0):
        if max_fd <= min_fd:
            raise ValueError("negative FD interval")
        max_fd = min(max_fd, MAX_FERMI_DIRAC)
        self.v_amp = v_amp
        xs = np.linspace(min_fd, max_fd, LENGTH_FERMI_DIRAC_TABLE)

        def kern(x):
            return x * x / (np.exp(x) + 1)

        cum = np.array([integrate.quad(kern, min_fd, x, epsrel=1e-6,
                                       limit=100)[0] for x in xs])
        total_fd = integrate.quad(kern, 0, MAX_FERMI_DIRAC, epsrel=1e-6,
                                  limit=100)[0]
        self.total_frac = cum[-1] / total_fd
        cum /= cum[-1]
        # strictly increasing for interpolation
        self._inv_cdf = interpolate.interp1d(cum, xs, kind="cubic")

    def sample_speeds(self, n, rng):
        p = rng.uniform(size=n)
        return self.v_amp * self._inv_cdf(p)

    def add_speeds(self, vel, rng):
        """Add isotropic thermal speeds to vel [N,3] in place."""
        n = len(vel)
        v = self.sample_speeds(n, rng)
        phi = 2 * np.pi * rng.uniform(size=n)
        costheta = 2 * rng.uniform(size=n) - 1
        sintheta = np.sqrt(1 - costheta ** 2)
        vel[:, 0] += v * sintheta * np.cos(phi)
        vel[:, 1] += v * sintheta * np.sin(phi)
        vel[:, 2] += v * costheta
        return vel


def thermal_vel_disp(*args, **kwargs):
    return ThermalVel(*args, **kwargs)


def add_thermal_velocities(ic, v_amp, seed, atime, use_peculiar):
    """Add thermal velocities to an IC species dict (internal units).

    v_amp: a velocity amplitude (full F-D distribution) or a
    pre-built :class:`ThermalVel` (e.g. truncated at Max_nuvel for
    hybrid neutrino particles, genic/main.c:96)."""
    tv = v_amp if isinstance(v_amp, ThermalVel) else ThermalVel(v_amp)
    rng = np.random.RandomState(seed)
    # v_amp is in file (peculiar) units; internal = file * a
    vpec = np.zeros_like(ic["vel"])
    tv.add_speeds(vpec, rng)
    ic["vel"] = ic["vel"] + (vpec * atime if use_peculiar else vpec)
    return ic
