"""Exact FLRW drift/kick factors.

Quadrature of 1/(H a^3), 1/(H a^2) and 1/(H a^{3*gamma-2} a) between two
integer times (reference: libgadget/timefac.c:12-75).  Host side, cached
per (t0, t1) pair — called once per (timebin, step), never on device.
"""

from functools import lru_cache
import numpy as np
from scipy import integrate

from .utils import constants as C


class ExactTimeFactors:
    def __init__(self, cosmology, timeline):
        self.CP = cosmology
        self.timeline = timeline
        self._cache = {}

    def _factor(self, t0: int, t1: int, kind: str) -> float:
        if t0 == t1:
            return 0.0
        key = (t0, t1, kind)
        if key in self._cache:
            return self._cache[key]
        a0 = np.exp(self.timeline.loga_from_ti(t0))
        a1 = np.exp(self.timeline.loga_from_ti(t1))
        CP = self.CP

        if kind == "drift":
            def f(a):
                return 1.0 / (CP.hubble_function(a) * a ** 3)
        elif kind == "gravkick":
            def f(a):
                return 1.0 / (CP.hubble_function(a) * a ** 2)
        elif kind == "hydrokick":
            def f(a):
                return 1.0 / (CP.hubble_function(a)
                              * a ** (3 * C.GAMMA_MINUS1) * a)
        else:
            raise ValueError(kind)
        val, _ = integrate.quad(f, a0, a1, epsabs=0, epsrel=1e-8, limit=200)
        self._cache[key] = val
        return val

    def drift(self, t0: int, t1: int) -> float:
        return self._factor(t0, t1, "drift")

    def gravkick(self, t0: int, t1: int) -> float:
        return self._factor(t0, t1, "gravkick")

    def hydrokick(self, t0: int, t1: int) -> float:
        return self._factor(t0, t1, "hydrokick")

    def comoving_distance(self, a0: float, a1: float,
                          UnitVelocity_in_cm_per_s: float) -> float:
        """Comoving distance between scale factors (timefac.c:76-100)."""
        CP = self.CP
        val, _ = integrate.quad(
            lambda a: 1.0 / (CP.hubble_function(a) * a * a), a0, a1,
            epsabs=0, epsrel=1e-8, limit=200)
        return (C.LIGHTCGS / UnitVelocity_in_cm_per_s) * val
