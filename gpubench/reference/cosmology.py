"""Plain NumPy background cosmology for the benchmark: the Hubble rate,
the linear growth factor and rate, the Eisenstein & Hu (1998) transfer
function with its sigma_8 normalisation, and the KDK time integrals.

It is the benchmark's own: the initial conditions are made from it and
the reference integrates the kicks and drifts with it.  It imports
nothing of the program.  The constants are MP-Gadget's (physconst.h);
units are kpc/h, 1e10 Msun/h and km/s, as in MP-Gadget's defaults.
"""

import math

import numpy as np
from scipy import integrate

GRAVITY = 6.672e-8              # cm^3 g^-1 s^-2
LIGHTCGS = 2.99792458e10        # cm/s
CM_PER_MPC = 3.085678e24
CM_PER_KPC = 3.085678e21
HUBBLE = 3.2407789e-18          # H0/h in 1/s
STEFAN_BOLTZMANN = 5.670373e-5  # erg cm^-2 s^-1 K^-4
UNIT_LENGTH_CM = CM_PER_KPC
UNIT_MASS_G = 1.989e43
UNIT_VELOCITY_CM_S = 1e5
TIMEBINS = 46                   # MP-Gadget's integer timeline
TIMEBASE = 1 << TIMEBINS


class Background:
    """Flat LCDM with photons and three massless neutrino species (the
    radiation MP-Gadget keeps with RadiationOn = 1)."""

    def __init__(self, omega0, omega_lambda, omega_baryon, hubble_param,
                 t_cmb=2.7255):
        self.omega0 = omega0
        self.omega_lambda = omega_lambda
        self.omega_baryon = omega_baryon
        self.h = hubble_param
        self.omega_k = 1.0 - omega0 - omega_lambda
        unit_time = UNIT_LENGTH_CM / UNIT_VELOCITY_CM_S
        self.hubble = HUBBLE * unit_time
        self.G = (GRAVITY / UNIT_LENGTH_CM ** 3 * UNIT_MASS_G
                  * unit_time ** 2)
        self.rho_crit = 3.0 * self.hubble ** 2 / (8.0 * math.pi * self.G)
        omega_g = (4 * STEFAN_BOLTZMANN * t_cmb ** 4
                   * (8 * math.pi * GRAVITY)
                   / (3 * LIGHTCGS ** 3 * HUBBLE ** 2) / hubble_param ** 2)
        # three relativistic neutrino species at T_nu = (4/11)^(1/3)
        # T_cmb x 1.00328
        t_ratio = (4.0 / 11.0) ** (1.0 / 3.0) * 1.00328
        self.omega_r = omega_g * (1.0 + 3 * 7.0 / 8.0 * t_ratio ** 4)

    def efunc(self, a):
        a = np.asarray(a, np.float64)
        return np.sqrt(self.omega_lambda + self.omega_k / a ** 2
                       + self.omega0 / a ** 3 + self.omega_r / a ** 4)

    def hubble_rate(self, a):
        """H(a) in internal units (1/(kpc/h / km/s))."""
        return self.hubble * self.efunc(a)

    def _growth(self, a):
        a0 = min(1e-4, a / 10.0)

        def rhs(aa, y):
            e = self.efunc(aa)
            return [y[1] / (aa ** 3 * e),
                    y[0] * 1.5 * aa * self.omega0 / aa ** 3 / e]

        sol = integrate.solve_ivp(rhs, (a0, a),
                                  [a0, a0 ** 3 * self.efunc(a0)],
                                  rtol=1e-9, atol=1e-13)
        d = sol.y[0, -1]
        return d, sol.y[1, -1] / (a ** 3 * self.efunc(a))

    def growth(self, a):
        """Unnormalised linear growth D(a)."""
        return self._growth(a)[0]

    def growth_rate(self, a):
        """f = dlnD/dlna."""
        d, dd = self._growth(a)
        return a * dd / d

    def transfer_eh(self, k_hmpc):
        """Eisenstein & Hu's zero-baryon-oscillation transfer function
        (MP-Gadget's power.c fallback), k in h/Mpc."""
        h = self.h
        ombh2 = self.omega_baryon * h * h
        ommh2 = self.omega0 * h * h
        theta = 2.728 / 2.7
        s = 44.5 * np.log(9.83 / ommh2) / np.sqrt(
            1.0 + 10.0 * ombh2 ** 0.75) * h
        alpha = (1.0 - 0.328 * np.log(431.0 * ommh2) * ombh2 / ommh2
                 + 0.380 * np.log(22.3 * ommh2) * (ombh2 / ommh2) ** 2)
        gamma = alpha + (1.0 - alpha) / (1.0 + (0.43 * k_hmpc * s) ** 4)
        gamma = gamma * self.omega0 * h
        q = k_hmpc * theta * theta / gamma
        l0 = np.log(2.0 * math.e + 1.8 * q)
        c0 = 14.2 + 731.0 / (1.0 + 62.5 * q)
        return l0 / (l0 + c0 * q * q)

    def sqrt_power(self, k, sigma8, a, n_s=0.971):
        """sqrt(P(k)) at scale factor a in internal units (k in h/kpc,
        P in (kpc/h)^3), normalised to sigma8 today."""
        scale = CM_PER_MPC / UNIT_LENGTH_CM

        def raw(kk):
            kk = np.asarray(kk, np.float64)
            return np.sqrt(kk * self.transfer_eh(kk * scale) ** 2
                           * kk ** (n_s - 1.0))

        r8 = 8.0 * scale

        def integrand(kk):
            kr = r8 * kk
            w = (1.0 / 3.0 - kr * kr / 30.0 if kr < 1e-3
                 else 3 * (math.sin(kr) / kr - math.cos(kr)) / kr ** 2)
            return 4 * math.pi / (2 * math.pi) ** 3 * kk * kk * w * w \
                * raw(kk) ** 2

        s2, _ = integrate.quad(integrand, 0, math.pi * 20.5 / r8,
                               epsabs=0, epsrel=1e-6, limit=1000)
        norm = sigma8 / math.sqrt(s2) * self.growth(a) / self.growth(1.0)
        return norm * raw(k)

    # -- the KDK time integrals ---------------------------------------

    def _integral(self, a0, a1, power):
        if a0 == a1:
            return 0.0
        val, _ = integrate.quad(
            lambda a: 1.0 / (self.hubble_rate(a) * a ** power), a0, a1,
            epsabs=0, epsrel=1e-10, limit=200)
        return val

    def drift(self, a0, a1):
        """int dt / a^2 = int da / (H a^3): x += v * drift for the
        internal velocity v = a^2 dx/dt."""
        return self._integral(a0, a1, 3)

    def gravkick(self, a0, a1):
        """int dt / a = int da / (H a^2): v += g * gravkick."""
        return self._integral(a0, a1, 2)


class Ticks:
    """MP-Gadget's integer timeline between a start and an end with no
    output in between: ti = 0 at a_begin, TIMEBASE at a_end, log a linear
    in ti."""

    def __init__(self, a_begin, a_end):
        self.loga0 = math.log(a_begin)
        self.dloga = (math.log(a_end) - self.loga0) / TIMEBASE

    def a(self, ti):
        return math.exp(self.loga0 + ti * self.dloga)
