"""FLRW background cosmology.

Host-side (numpy/scipy, float64) — these quantities parameterize the
device-side kernels but are themselves cheap scalar computations, exactly
as the reference keeps them on the CPU (libgadget/cosmology.c,
libgadget/omega_nu_single.c).

Includes: Hubble function with radiation, massive neutrinos (exact
Fermi-Dirac integration), curvature, Lambda or (w0,wa) dark-energy fluid;
growth factor by ODE integration; massive-neutrino background tables.
"""

from dataclasses import dataclass, field
import numpy as np
from scipy import integrate, interpolate

from .utils import constants as C

# Neutrino temperature today in units of T_CMB: (4/11)^(1/3) with a
# non-instantaneous-decoupling correction (omega_nu_single.h:16).
TNUCMB = (4.0 / 11.0) ** (1.0 / 3.0) * 1.00328
HBAR_EVS = 6.582119e-16   # hbar in eV s
NUSPECIES = 3
NU_SW = 100.0             # kT/(a m) at which to switch analytic <-> table


def _rho_nu_conversion():
    """(eV/c)^4 -> g/cm^3 for a single neutrino species (+antineutrino)."""
    convert = 4 * np.pi * 2.0
    chbar = 1.0 / (2 * np.pi * C.LIGHTCGS * HBAR_EVS)
    convert *= chbar ** 3
    convert *= 1.60217646e-12 / C.LIGHTCGS ** 2
    return convert


class RhoNuTable:
    """rho_nu(a) for one neutrino species of mass mnu (eV).

    Exact Fermi-Dirac integration, tabulated in log(a) between the deeply
    relativistic and deeply non-relativistic regimes where analytic series
    take over (omega_nu_single.c:118-206).
    """

    NTAB = 200

    def __init__(self, a0, mnu, kBtnu):
        self.mnu = mnu
        self.kBtnu = kBtnu
        self._interp = None
        if mnu <= 0 or kBtnu <= 0:
            return
        if a0 > 1e-3:
            a0 = 1e-3
        if a0 * mnu < 1e-6 * kBtnu:
            a0 = 1e-6 * kBtnu / mnu
        if mnu < 1e-6 * kBtnu:
            return
        loga0 = np.log(a0) - np.log(1.2)
        logaf = np.log(NU_SW * kBtnu / mnu) + np.log(1.2)
        if logaf < loga0:
            return
        conv = _rho_nu_conversion()
        logas = np.linspace(loga0, logaf, self.NTAB)
        rhos = np.empty_like(logas)
        for i, la in enumerate(logas):
            amnu = mnu * np.exp(la)

            def integrand(q):
                eps = np.sqrt(q * q + amnu * amnu)
                return q * q * eps / (np.exp(q / kBtnu) + 1)

            val, _ = integrate.quad(integrand, 0, 500 * kBtnu, epsabs=0,
                                    epsrel=1e-9, limit=200)
            rhos[i] = val / np.exp(la) ** 4 * conv
        self._logas = logas
        self._interp = interpolate.CubicSpline(logas, rhos)

    def _non_rel(self, a):
        kT = self.kBtnu
        amnu = a * self.mnu
        x = (kT / amnu) ** 2
        # Riemann zeta(3), zeta(5), zeta(7), zeta(9) series expansion
        return (amnu * kT ** 3 / a ** 4
                * (1.5 * 1.202056903159594
                   + x * 45.0 / 4.0 * 1.0369277551433704
                   + 2835.0 / 32.0 * x * x * 1.0083492773819229
                   + 80325.0 / 32.0 * x ** 3 * 1.0020083928260826)
                * _rho_nu_conversion())

    def _rel(self, a):
        return 7 * (np.pi * self.kBtnu / a) ** 4 / 120.0 * _rho_nu_conversion()

    def __call__(self, a):
        a = np.asarray(a, dtype=np.float64)
        scalar = a.ndim == 0
        a = np.atleast_1d(a)
        kT = self.kBtnu
        amnu = a * self.mnu
        out = np.empty_like(a)
        with np.errstate(divide="ignore", invalid="ignore"):
            nonrel = NU_SW ** 2 * (kT / amnu) ** 2 < 1
        rel = (~nonrel) & (amnu < 1e-6 * kT)
        tab = ~(nonrel | rel)
        if np.any(nonrel):
            out[nonrel] = self._non_rel(a[nonrel])
        if np.any(rel):
            out[rel] = self._rel(a[rel])
        if np.any(tab):
            loga = np.log(a[tab])
            if self._interp is None:
                out[tab] = self._rel(a[tab])
            else:
                early = loga < self._logas[0]
                v = self._interp(np.clip(loga, self._logas[0], None))
                v[early] = self._rel(a[tab][early])
                out[tab] = v
        return out[0] if scalar else out


class OmegaNu:
    """Total neutrino matter density Omega_nu(a) over all species
    (omega_nu_single.c:19-66). Hybrid particle/analytic split supported."""

    def __init__(self, MNu, a0, HubbleParam, tcmb0):
        self.MNu = tuple(MNu)
        self.tcmb0 = tcmb0
        self.kBtnu = C.BOLEVK * TNUCMB * tcmb0
        self.rhocrit = (3 * (C.HUBBLE * HubbleParam) ** 2
                        / (8 * np.pi * C.GRAVITY))
        # Group degenerate species
        self.degeneracies = [0] * NUSPECIES
        for mi in range(NUSPECIES):
            for mmi in range(mi):
                if abs(MNu[mi] - MNu[mmi]) < 1e-6:
                    self.degeneracies[mmi] += 1
                    break
            else:
                self.degeneracies[mi] = 1
        self.tables = [RhoNuTable(a0, MNu[mi], self.kBtnu)
                       if self.degeneracies[mi] else None
                       for mi in range(NUSPECIES)]
        # hybrid neutrinos
        self.hybrid_enabled = False
        self.nu_crit_time = 1.0
        self.nufrac_low = [0.0] * NUSPECIES

    def enable_hybrid(self, vcrit_kms, nu_crit_time):
        """Hybrid neutrinos: fraction below vcrit becomes particles after
        nu_crit_time (init_hybrid_nu, omega_nu_single.c:235-246)."""
        self.hybrid_enabled = True
        self.nu_crit_time = nu_crit_time
        light_kms = C.LIGHTCGS / 1e5
        for i in range(NUSPECIES):
            qc = self.MNu[i] * vcrit_kms / light_kms / self.kBtnu
            val, _ = integrate.quad(lambda x: x * x / (np.exp(x) + 1), 0, qc)
            self.nufrac_low[i] = val / (1.5 * 1.202056903159594)

    def particle_fraction(self, a, i=0):
        if not self.hybrid_enabled or a <= self.nu_crit_time:
            return 0.0
        return self.nufrac_low[i]

    def __call__(self, a):
        """Omega_nu(a) relative to rhocrit(z=0) (so scales ~a^-3 late)."""
        rhonu = 0.0
        for mi in range(NUSPECIES):
            if self.degeneracies[mi] > 0:
                rhonu = rhonu + self.degeneracies[mi] * self.tables[mi](a)
        return rhonu / self.rhocrit

    def nopart(self, a):
        """Omega_nu excluding the part tracked by actual particles."""
        om = self(a)
        om_part = self(1.0) * self.particle_fraction(a) / a ** 3
        return om - om_part

    def omega_nu_single(self, a, i):
        """Matter density in neutrino species i (minus particle part)."""
        if self.degeneracies[i] == 0:
            for j in range(i, -1, -1):
                if self.degeneracies[j]:
                    i = j
                    break
        om = self.tables[i](a) / self.rhocrit
        om_part = (self.tables[i](1.0) / self.rhocrit
                   * self.particle_fraction(a, i) / a ** 3)
        return om - om_part


@dataclass
class Cosmology:
    """Background cosmology parameters + derived quantities.

    Parameter names match the reference param schema (gadget/params.c) so
    reference parameter files port 1:1.
    """
    Omega0: float = 0.3
    OmegaBaryon: float = 0.045
    OmegaLambda: float = 0.7
    HubbleParam: float = 0.7
    CMBTemperature: float = 2.7255
    RadiationOn: bool = True
    MNu: tuple = (0.0, 0.0, 0.0)
    Omega_fld: float = 0.0
    w0_fld: float = -1.0
    wa_fld: float = 0.0
    Omega_ur: float = 0.0
    use_class_radiation_convention: bool = False
    HybridNeutrinosOn: bool = False
    HybridVcrit: float = 500.0
    HybridNuPartTime: float = 0.3333333
    MassiveNuLinRespOn: bool = False
    TimeBegin: float = 0.01
    # filled by __post_init__ / init_units
    OmegaCDM: float = field(init=False, default=0.0)
    OmegaK: float = field(init=False, default=0.0)
    OmegaG: float = field(init=False, default=0.0)
    Hubble: float = field(init=False, default=0.1)       # internal units
    GravInternal: float = field(init=False, default=1.0)
    RhoCrit: float = field(init=False, default=1.0)
    UnitTime_in_s: float = field(init=False, default=1.0)

    def __post_init__(self):
        self.ONu = OmegaNu(self.MNu, self.TimeBegin, self.HubbleParam,
                           self.CMBTemperature)
        if self.HybridNeutrinosOn:
            self.ONu.enable_hybrid(self.HybridVcrit, self.HybridNuPartTime)
        self.OmegaG = (4 * C.STEFAN_BOLTZMANN * self.CMBTemperature ** 4
                       * (8 * np.pi * C.GRAVITY)
                       / (3 * C.LIGHTCGS ** 3 * C.HUBBLE ** 2)
                       / self.HubbleParam ** 2)
        self.OmegaCDM = self.Omega0 - self.OmegaBaryon
        if sum(self.MNu) > 0:
            self.OmegaCDM -= self.ONu(1.0)
        self.OmegaK = 1.0 - self.Omega0 - self.OmegaLambda - self.Omega_fld
        if self.use_class_radiation_convention:
            self.OmegaK = (1.0 - self.OmegaCDM - self.OmegaBaryon
                           - self.OmegaLambda - self.Omega_fld
                           - self.Omega_ur - self.OmegaG - self.ONu(1.0))
        self._growth_cache = None

    def init_units(self, units):
        """Attach a UnitSystem: sets Hubble, G and rho_crit in internal
        units (init_cosmology, cosmology.c:15-31)."""
        self.Hubble = C.HUBBLE * units.UnitTime_in_s
        self.UnitTime_in_s = units.UnitTime_in_s
        self.GravInternal = (C.GRAVITY / units.UnitLength_in_cm ** 3
                             * units.UnitMass_in_g * units.UnitTime_in_s ** 2)
        self.RhoCrit = (3.0 * self.Hubble ** 2
                        / (8.0 * np.pi * self.GravInternal))
        return self

    # -- background ---------------------------------------------------

    def OmegaFLD(self, a):
        """(w0,wa) dark-energy fluid density (cosmology.c:160-170)."""
        if self.Omega_fld == 0.0:
            return 0.0
        return (self.Omega_fld
                * np.power(a, -3 * (1 + self.w0_fld + self.wa_fld))
                * np.exp(-3 * self.wa_fld * (1 - a)))

    def hubble_function(self, a):
        """H(a) in internal units (cosmology.c:64-88)."""
        a = np.asarray(a, dtype=np.float64)
        h2 = self.OmegaLambda + self.OmegaFLD(a)
        h2 = h2 + self.OmegaK / a ** 2
        h2 = h2 + (self.OmegaCDM + self.OmegaBaryon) / a ** 3
        if self.RadiationOn:
            h2 = h2 + self.OmegaG / a ** 4
            h2 = h2 + self.ONu(a)
        else:
            h2 = h2 + self.ONu(1.0)
        h2 = h2 + self.Omega_ur / a ** 4
        return self.Hubble * np.sqrt(h2)

    def efunc(self, a):
        """Dimensionless E(a) = H(a)/H0."""
        return self.hubble_function(a) / self.Hubble

    def hybrid_nu_tracer(self, atime):
        return self.HybridNeutrinosOn and atime <= self.HybridNuPartTime

    # -- growth -------------------------------------------------------

    def _growth(self, a):
        """Solve D'' + ... = 0 from a=1e-4 (matter-dom) to a.

        State: y = [D, F] with F = a^3 E(a) dD/da; dD/da = F/(a^3 E);
        dF/da = 1.5 a (OmegaCDM+OmegaBaryon)/a^3 / E * D
        (growth_ode, cosmology.c:96-110).  Returns (D, dD/da).
        """
        a0 = 1e-4
        if a0 > a:
            a0 = a / 10.0
        yinit = np.array([a0, a0 ** 3 * self.efunc(a0)])

        def rhs(aa, y):
            E = self.efunc(aa)
            return [y[1] / (aa ** 3 * E),
                    y[0] * 1.5 * aa * (self.OmegaCDM + self.OmegaBaryon)
                    / aa ** 3 / E]

        sol = integrate.solve_ivp(rhs, (a0, a), yinit, rtol=1e-8,
                                  atol=1e-12, method="RK45", dense_output=False)
        D = sol.y[0, -1]
        dDda = sol.y[1, -1] / (a ** 3 * self.efunc(a))
        return D, dDda

    def GrowthFactor(self, astart, aend):
        """D(astart)/D(aend) (cosmology.c:90-94)."""
        return self._growth(astart)[0] / self._growth(aend)[0]

    def F_Omega(self, a):
        """dlnD/dlna — the growth rate used for IC velocities."""
        D, dDda = self._growth(a)
        return a * dDda / D
