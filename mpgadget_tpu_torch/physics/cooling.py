"""Radiative cooling and heating: the primordial H/He rate network with a
UV background (PyTorch port of mpgadget_tpu/physics/cooling.py, after
libgadget/cooling_rates.c and cooling.c).

The reference solves the ionization network per particle with a
Steffensen fixed point and integrates du implicitly by bisection.  Both
loops run per gas particle, up to 3,050 network evaluations for one
implicit step: in plain PyTorch that is some 300,000 elementwise
operations.  So on CUDA tensors they run as one hand-written kernel, K6
(``csrc/cooling.cu``): a group of lanes per particle, the bisection and
the fixed point in registers.  The plain versions here
(:func:`do_cooling_reference`, :meth:`CoolingRates.get_heatingcooling_rate`)
follow the JAX arithmetic operation by operation and run for CPU tensors
(the tests); the wrappers :func:`do_cooling` and
:func:`heatingcooling_rate` launch K6 on CUDA tensors or raise.

Both loops stop where every further step would repeat itself (a
Steffensen iterate or the bisection's state repeating one of the last
few bit for bit, :func:`iterate`): the result is the full count's, bit
for bit.  The kernel stops row by row, the plain versions when every
row of the batch repeats.

Python scalars enter the arithmetic as the JAX package's weak-typed
scalars do: rounded once to the tensors' type, composite scalar factors
evaluated in double first.  So in float32 the ``1e-50`` guards of the
network and the ``1e-60`` of the cooling time are 0.

Rate options follow the reference: recombination Cen92 / Verner96
(default) / Badnell06, cooling KWH92 / Enzo2Nyx / Sherwood (default),
the UVB from a TreeCool table in log10(1+z), Rahmati-Schaye 2013
self-shielding.  The metal cooling and UV fluctuation tables are not
carried (``run.check_supported`` refuses their files).
"""

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..utils import constants as C

# enum values match params.py
KWH92, ENZO2NYX, SHERWOOD = 0, 1, 2
CEN92, VERNER96, BADNELL06 = 0, 1, 2

# Gray opacity table for self-shielding (Rahmati 2012, cooling_rates.c
# GrayOpac): redshifts 0..9, cm^2
GRAYOPAC_Z = np.arange(10.0)
GRAYOPAC = np.array([2.59e-18, 2.37e-18, 2.27e-18, 2.15e-18, 2.02e-18,
                     1.94e-18, 1.82e-18, 1.71e-18, 1.60e-18, 1.60e-18])

# trip counts and the longest cycles closed exactly (iterate), compile-time
# constants of csrc/cooling.cu too
NE_ITERS = 30        # Steffensen iterations of get_equilib_ne
BISECT_ITERS = 50    # bisection steps of do_cooling
NE_PERIOD = 16
BISECT_PERIOD = 2
LOG10_E = 0.4342944819032518   # jnp.log10(x) = log(x) * LOG10_E

LAUNCHES = 0         # K6 launches (not plain calls)
_fns = {}


@dataclass
class CoolingParams:
    recomb: int = VERNER96
    cooling: int = SHERWOOD
    SelfShieldingOn: bool = True
    PhotoIonizationOn: bool = True
    PhotoIonizeFactor: float = 1.0
    MinGasTemp: float = 5.0
    CMBTemperature: float = 2.7255
    fBar: float = 0.17
    HeliumHeatOn: bool = False
    HeliumHeatThresh: float = 10.0
    HeliumHeatAmp: float = 1.0
    HeliumHeatExp: float = 0.0
    rho_crit_baryon: float = 0.0455 * 1.8788e-29  # cgs, overridden
    UVRedshiftThreshold: float = -1.0


@dataclass
class UVBG:
    """Photoionization (1/s) and heating (erg/s) rates + self-shielding
    density; scalars for the global background."""
    gJH0: float = 0.0
    gJHe0: float = 0.0
    gJHep: float = 0.0
    epsH0: float = 0.0
    epsHe0: float = 0.0
    epsHep: float = 0.0
    self_shield_dens: float = 1e10


class TreeCool:
    """TreeCool table: log10(1+z), Gamma_HI/HeI/HeII [1/s],
    Qdot_HI/HeI/HeII [erg/s] (cooling_rates.c:130-180).  path None or ""
    is the reference's no-UV-background case."""

    def __init__(self, path: Optional[str], params: CoolingParams):
        self.par = params
        if not path:
            self.table = None
            return
        rows = []
        with open(path) as fh:
            for line in fh:
                t = line.split()
                if not t or t[0].startswith("#"):
                    continue
                rows.append([float(x) for x in t[:7]])
        self.table = np.array(rows)

    def get_global_uvbg(self, redshift) -> UVBG:
        """get_global_UVBG (cooling_rates.c:365-397)."""
        par = self.par
        if (self.table is None or not par.PhotoIonizationOn
                or (par.UVRedshiftThreshold >= 0
                    and redshift > par.UVRedshiftThreshold)):
            return UVBG()
        lzp = np.log10(1 + redshift)
        tab = self.table
        if lzp > tab[-1, 0]:
            return UVBG()  # before the UVB switches on

        def interp(col):
            vals = tab[:, col]
            good = vals > 0
            if not np.any(good):
                return 0.0
            lv = np.interp(lzp, tab[good, 0], np.log10(vals[good]))
            return float(10.0 ** lv)

        fac = par.PhotoIonizeFactor
        uv = UVBG(gJH0=interp(1) * fac, gJHe0=interp(2) * fac,
                  gJHep=interp(3) * fac, epsH0=interp(4) * fac,
                  epsHe0=interp(5) * fac, epsHep=interp(6) * fac)
        uv.self_shield_dens = self_shield_dens(redshift, uv, par)
        return uv


def self_shield_dens(redshift, uvbg: UVBG, par: CoolingParams):
    """Rahmati 2012 self-shielding density, atoms/cm^3
    (get_self_shield_dens, cooling_rates.c:345-361)."""
    if uvbg.gJH0 == 0:
        return 1e10
    G12 = uvbg.gJH0 / 1e-12
    greyopac = np.interp(np.clip(redshift, 0, 9), GRAYOPAC_Z, GRAYOPAC)
    return float(6.73e-3 * (greyopac / 2.49e-18) ** (-2.0 / 3)
                 * G12 ** (2.0 / 3) * (par.fBar / 0.17) ** (-1.0 / 3))


# ---- rate coefficient formulas (elementwise over temp) -----------------
# Written in the JAX package's association; csrc/cooling.cu spells out the
# same operations.  Change both together.

def _sq(x):
    return x * x


def _rdiv(c, x):
    """c / x for a Python scalar c, as a true division (PyTorch's
    ``c / x`` multiplies by the reciprocal, another rounding)."""
    return x.new_tensor(c) / x


def _log10(x):
    return torch.log(x) * LOG10_E


def _verner96(temp, aa, bb, t0, t1):
    s0 = torch.sqrt(temp / t0)
    s1 = torch.sqrt(temp / t1)
    return _rdiv(aa, s0 * (1 + s0) ** (1 - bb) * (1 + s1) ** (1 + bb))


def _voronov96(temp, dE, PP, AA, XX, KK):
    UU = _rdiv(dE, C.BOLEVK * temp)
    return AA * (1 + PP * torch.sqrt(UU)) / (XX + UU) * UU ** KK \
        * torch.exp(-torch.clamp(UU, max=70.0))


def make_rates(par: CoolingParams):
    """The rate-function dict for the chosen tables (cooling_rates.c
    :480-1050), each a function of a temperature tensor."""
    r = par.recomb
    cmode = par.cooling

    def alphaHp(T):
        if r == CEN92:
            return _rdiv(8.4e-11, torch.sqrt(T)) / (T / 1000) ** 0.2 \
                / (1 + (T / 1e6) ** 0.7)
        if r == VERNER96:
            return _verner96(T, 7.982e-11, 0.748, 3.148, 7.036e5)
        return _verner96(T, 8.318e-11, 0.7472, 2.965, 7.001e5)

    def alphaHep(T):
        if r == CEN92:
            return _rdiv(1.5e-10, T ** 0.6353)
        if r == VERNER96:
            low = _verner96(T, 3.294e-11, 0.6910, 1.554e1, 3.676e7)
            high = _verner96(T, 9.356e-10, 0.7892, 4.266e-2, 4.677e6)
            lo, hi = 6e5, 8e5
            interp = (low * (hi - T) + high * (T - lo)) / (hi - lo)
            return torch.where(T < lo, low,
                               torch.where(T > hi, high, interp))
        return _verner96(T, 1.818e-10, 0.7492, 10.17, 2.786e6)

    def alphad(T):
        if r == CEN92:
            return _rdiv(1.9e-3, T ** 1.5) * torch.exp(_rdiv(-4.7e5, T)) \
                * (1 + 0.3 * torch.exp(_rdiv(-9.4e4, T)))
        return _rdiv(1.23e-3, T ** 1.5) * torch.exp(_rdiv(-4.72e5, T)) \
            * (1 + 0.3 * torch.exp(_rdiv(-9.4e4, T)))

    def alphaHepd(T):
        return alphad(T) + alphaHep(T)

    def alphaHepp(T):
        if r == CEN92:
            return 4 * alphaHp(T)
        if r == VERNER96:
            return _verner96(T, 1.891e-10, 0.7524, 9.370, 2.774e6)
        return _verner96(T, 5.235e-11,
                         0.6988 + 0.0829 * torch.exp(_rdiv(-1.682e5, T)),
                         7.301, 4.475e6)

    def GammaeH0(T):
        if r == CEN92:
            return 5.85e-11 * torch.sqrt(T) * torch.exp(_rdiv(-157809.1, T)) \
                / (1 + torch.sqrt(T / 1e5))
        return _voronov96(T, 13.6, 0, 0.291e-07, 0.232, 0.39)

    def GammaeHe0(T):
        if r == CEN92:
            return 2.38e-11 * torch.sqrt(T) * torch.exp(_rdiv(-285335.4, T)) \
                / (1 + torch.sqrt(T / 1e5))
        return _voronov96(T, 24.6, 0, 0.175e-07, 0.180, 0.35)

    def GammaeHep(T):
        if r == CEN92:
            return 5.68e-12 * torch.sqrt(T) * torch.exp(_rdiv(-631515.0, T)) \
                / (1 + torch.sqrt(T / 1e5))
        return _voronov96(T, 54.4, 1, 0.205e-08, 0.265, 0.25)

    def t5(T):
        t0 = 1e5 if cmode == KWH92 else 5e7
        return 1 + torch.sqrt(T / t0)

    def collisH0(T):
        if cmode == ENZO2NYX:
            y = torch.log(T)
            Ryd = 2.1798741e-11
            tot = _rdiv(-0.75 / C.BOLTZMANN * Ryd, T)
            low = [213.7913, 113.9492, 25.06062, 2.762755, 0.1515352,
                   3.290382e-3]
            high = [271.25446, 98.019455, 14.00728, 0.9780842,
                    3.356289e-2, 4.553323e-4]
            for j in range(6):
                tot = tot + torch.where(T < 1e5, low[j],
                                        torch.full_like(T, high[j])) \
                    * _integer_pow(-y, j)
            return 1e-20 * torch.exp(tot)
        excite = 7.5e-19 * torch.exp(_rdiv(-118348.0, T)) / t5(T)
        ionize = 13.5984 * C.EV_IN_ERGS * GammaeH0(T)
        return excite + ionize

    def collisHe0(T):
        return (9.1e-27 * T ** -0.1687 * torch.exp(_rdiv(-473638.0, T)) / t5(T)
                + 24.5874 * C.EV_IN_ERGS * GammaeHe0(T))

    def collisHeP(T):
        return (5.54e-17 * T ** -0.397 * torch.exp(_rdiv(-473638.0, T)) / t5(T)
                + 54.417760 * C.EV_IN_ERGS * GammaeHep(T))

    def recombHp(T):
        if cmode == ENZO2NYX:
            return 2.851e-27 * torch.sqrt(T) * (
                5.914 - 0.5 * torch.log(T) + 0.01184 * T ** (1.0 / 3))
        return 0.75 * C.BOLTZMANN * T * alphaHp(T)

    def recombHeP(T):
        return 0.75 * C.BOLTZMANN * T * alphaHep(T) \
            + 6.526e-11 * alphad(T)

    def recombHePP(T):
        if cmode == ENZO2NYX:
            return 1.140e-26 * torch.sqrt(T) * (
                6.607 - 0.5 * torch.log(T) + 7.459e-3 * T ** (1.0 / 3))
        return 0.75 * C.BOLTZMANN * T * alphaHepp(T)

    def freefree(T, zz):
        if cmode == ENZO2NYX:
            lt = 2 * _log10(T / zz)
            gff = torch.where(lt <= float(np.log10(3.2e5)),
                              0.79464 + 0.1243 * lt, 2.13164 - 0.1240 * lt)
        else:
            gff = 1.1 + 0.34 * torch.exp(-_sq(5.5 - _log10(T)) / 3.0)
        return 1.426e-27 * torch.sqrt(T) * zz ** 2 * gff

    return dict(alphaHp=alphaHp, alphaHepd=alphaHepd,
                alphaHepp=alphaHepp, GammaeH0=GammaeH0,
                GammaeHe0=GammaeHe0, GammaeHep=GammaeHep,
                collisH0=collisH0, collisHe0=collisHe0,
                collisHeP=collisHeP, recombHp=recombHp,
                recombHeP=recombHeP, recombHePP=recombHePP,
                freefree=freefree)


def _integer_pow(x, j):
    """x ** j for a Python int j >= 0 by repeated squaring, in the order of
    JAX's lax.integer_pow."""
    if j == 0:
        return torch.ones_like(x)
    acc = None
    while j > 0:
        if j & 1:
            acc = x if acc is None else acc * x
        j >>= 1
        if j > 0:
            x = x * x
    return acc


class CoolingRates:
    """The network on tensors (per particle): density in protons/cm^3,
    ienergy in erg/g.  These are the plain versions; see the module
    docstring."""

    def __init__(self, params: CoolingParams, treecool: TreeCool):
        self.par = params
        self.treecool = treecool
        self.rates = make_rates(params)
        self.helium = 1 - C.HYDROGEN_MASSFRAC

    def get_temp_internal(self, nebynh, ienergy, helium):
        hy_mass = 1 - helium
        mui = _rdiv(4, hy_mass * (3 + 4 * nebynh) + 1) * ienergy
        temp = C.GAMMA_MINUS1 * C.PROTONMASS / C.BOLTZMANN * mui
        return torch.clamp(temp, min=self.par.MinGasTemp)

    def _self_shield_corr(self, nh, temp, ssdens):
        if not self.par.SelfShieldingOn:
            return torch.ones_like(nh)
        T4 = (temp / 1e4) ** 0.17
        nSSh = 1.003 * ssdens * T4
        corr = (0.98 * (1 + (nh / nSSh) ** 1.64) ** -2.28
                + 0.02 * (1 + nh / nSSh) ** -0.84)
        return torch.where(nh < ssdens * 0.01, 1.0, corr)

    def _network(self, nh, temp, ne, uvbg: UVBG, photofac):
        """Ion fractions at given ne (cgs): nH0, nHp per nH; nHe0, nHep,
        nHepp as in the reference's nHe_internal."""
        R = self.rates
        tiny = _scalar(1e-50, ne.dtype)
        safe_ne = torch.clamp(ne, min=tiny)
        photoH = torch.where(ne > tiny, _rdiv(uvbg.gJH0, safe_ne) * photofac, 0.0)
        aHp = R["alphaHp"](temp)
        gH0 = R["GammaeH0"](temp)
        nH0 = aHp / (aHp + gH0 + photoH)
        nHp = torch.clamp(1.0 - nH0, min=0.0)
        aHep = R["alphaHepd"](temp)
        aHepp = R["alphaHepp"](temp)
        gHe0 = R["GammaeHe0"](temp) + torch.where(
            ne > tiny, _rdiv(uvbg.gJHe0, safe_ne) * photofac, 0.0)
        gHep = R["GammaeHep"](temp) + torch.where(
            ne > tiny, _rdiv(uvbg.gJHep, safe_ne) * photofac, 0.0)
        on = gHe0 > tiny
        mg = torch.clamp(gHe0, min=tiny)
        nHep = torch.where(on, nh / (1 + aHep / mg + gHep / aHepp), 0.0)
        nHe0 = torch.where(on, nHep * aHep / mg, nh)
        nHepp = torch.where(on, nHep * gHep / aHepp, 0.0)
        return nH0, nHp, nHe0, nHep, nHepp

    def _ne_internal(self, nh, ienergy, ne, helium, uvbg):
        yy = helium / 4 / (1 - helium)
        temp = self.get_temp_internal(ne / nh, ienergy, helium)
        photofac = self._self_shield_corr(nh, temp, uvbg.self_shield_dens)
        nH0, nHp, nHe0, nHep, nHepp = self._network(
            nh, temp, ne, uvbg, photofac)
        return nh * nHp + yy * nHep + 2 * yy * nHepp

    def get_equilib_ne(self, density, ienergy, uvbg, ne_init, helium=None):
        """Fixed-point ne solve with Steffensen acceleration (the
        scipy_optimize_fixed_point analog); ne_init is ne/nh.  NE_ITERS
        iterations, left as soon as the iterates repeat (:func:`iterate`)."""
        helium = self.helium if helium is None else helium
        nh = density * (1 - helium)
        ne0 = torch.where(ne_init <= 0, 1.0, ne_init).to(nh.dtype)
        ne = iterate(lambda x: self.equilib_ne_step(nh, ienergy, x, helium,
                                                    uvbg),
                     ne0, NE_ITERS, NE_PERIOD)
        return ne * nh

    def equilib_ne_step(self, nh, ienergy, ne0, helium, uvbg):
        """One Steffensen iteration of :meth:`get_equilib_ne`: the next
        iterate of ne/nh from ne0, a function of ne0 alone."""
        small = _scalar(1e-15, nh.dtype)
        ne1 = self._ne_internal(nh, ienergy, ne0 * nh, helium, uvbg) / nh
        ne2 = self._ne_internal(nh, ienergy, ne1 * nh, helium, uvbg) / nh
        d = ne0 + ne2 - 2.0 * ne1
        big = torch.abs(d) > small
        pp = torch.where(big, ne0 - _sq(ne1 - ne0)
                         / torch.where(big, d, 1.0), ne2)
        return torch.clamp(pp, min=0.0)

    def get_heatingcooling_rate(self, density, ienergy, redshift, uvbg,
                                ne_init, helium=None):
        """Net (heating - cooling) in erg/s/g and the equilibrium ne/nh
        (get_heatingcooling_rate, cooling_rates.c:1249-1310): the plain
        version of K6's ``heatingcooling_rate``.  The JAX function's
        metallicity argument is not carried: it feeds only the metal
        cooling table, which the port does not carry yet."""
        helium = self.helium if helium is None else helium
        R = self.rates
        ne = self.get_equilib_ne(density, ienergy, uvbg, ne_init, helium)
        nh = density * (1 - helium)
        nebynh = ne / nh
        temp = self.get_temp_internal(nebynh, ienergy, helium)
        photofac = self._self_shield_corr(nh, temp, uvbg.self_shield_dens)
        yy = helium / 4 / (1 - helium)
        nH0, nHp, nHe0, nHep, nHepp = self._network(
            nh, temp, ne, uvbg, photofac)
        nHe0 = nHe0 * yy / nh
        nHep = nHep * yy / nh
        nHepp = nHepp * yy / nh
        LambdaCollis = nebynh * (R["collisH0"](temp) * nH0
                                 + R["collisHe0"](temp) * nHe0
                                 + R["collisHeP"](temp) * nHep)
        LambdaRecomb = nebynh * (R["recombHp"](temp) * nHp
                                 + R["recombHeP"](temp) * nHep
                                 + R["recombHePP"](temp) * nHepp)
        cff = R["freefree"](temp, 1)
        if self.par.cooling == ENZO2NYX:
            LambdaFF = nebynh * (cff * (nHp + nHep)
                                 + R["freefree"](temp, 2) * nHepp)
        else:
            LambdaFF = nebynh * (cff * (nHp + nHep) + 4 * cff * nHepp)
        tcmb = self.par.CMBTemperature * (1 + redshift)
        LambdaCmptn = nebynh * (4 * C.THOMPSON * C.RAD_CONST
                                / (C.ELECTRONMASS * C.LIGHTCGS)
                                * tcmb ** 4 * C.BOLTZMANN
                                * (temp - tcmb)) / nh
        Lambda = LambdaCollis + LambdaRecomb + LambdaFF + LambdaCmptn
        Heat = (nH0 * uvbg.epsH0 + nHe0 * uvbg.epsHe0
                + nHep * uvbg.epsHep) / nh
        if self.par.HeliumHeatOn:
            rho = C.PROTONMASS * density / (1 - helium)
            overden = torch.clamp(
                rho / (self.par.rho_crit_baryon * (1 + redshift) ** 3),
                max=self.par.HeliumHeatThresh)
            Heat = Heat * self.par.HeliumHeatAmp \
                * overden ** self.par.HeliumHeatExp
        LambdaNet = Heat - Lambda
        return (LambdaNet * (1 - helium) ** 2 * density / C.PROTONMASS,
                nebynh)


@dataclass
class CoolingUnits:
    density_in_phys_cgs: float  # UnitDensity * h^2
    uu_in_cgs: float
    tt_in_s: float              # UnitTime / h


def _scalar(x, dtype):
    """A Python scalar rounded to dtype, as JAX's weak typing does."""
    return float(np.float32(x)) if dtype == torch.float32 else float(x)


def _rows(fn, rows, outs, *ins):
    """fn over the rows listed in rows (all when None), results scattered
    into copies of outs; other rows keep the values of outs."""
    if rows is None:
        return fn(*ins)
    res = fn(*[x[rows] for x in ins])
    copies = [o.clone() for o in outs]
    for c, r in zip(copies, res):
        c[rows] = r
    return tuple(copies)


def unchanged(new, old):
    """True when every element of new (a tensor or a tuple of them) equals
    old bit for bit.  A NaN is never unchanged (a NaN never equals
    itself), and -0 differs from +0."""
    if isinstance(new, tuple):
        return all(unchanged(a, b) for a, b in zip(new, old))
    if not torch.equal(new, old):
        return False
    bits = torch.int32 if new.dtype == torch.float32 else torch.int64
    return torch.equal(new.view(bits), old.view(bits))


def iterate(step, x, iters, period):
    """x after ``iters`` applications of ``step``, a function of its
    argument alone, stopped as soon as an iterate repeats one of the last
    ``period`` ones bit for bit: from there the sequence cycles, and the
    iterate the remaining steps would end on is among those kept.  This
    is exact; ``csrc/cooling.cu`` takes the same exits row by row, this
    takes them when every row's iterate repeats (with the same period)."""
    hist = [x]          # the last `period` iterates, the newest last
    for i in range(iters):
        nxt = step(hist[-1])
        for p in range(1, len(hist) + 1):
            if unchanged(nxt, hist[-p]):
                m = (iters - i - 1) % p   # steps left, modulo the cycle
                return nxt if m == 0 else hist[m - p]
        hist = (hist + [nxt])[-period:]
    return hist[-1]


@dataclass
class CoolingBracket:
    """do_cooling's per-particle constants in cgs and its initial bracket
    (:func:`cooling_bracket`)."""
    rho_cgs: torch.Tensor
    u_old_cgs: torch.Tensor
    dt_s: torch.Tensor
    min_u: float
    u_lo: torch.Tensor
    u_hi: torch.Tensor


def cooling_bracket(u_old, rho, dt, min_egy_spec, units: CoolingUnits):
    """The bisection's constants and initial bounds: the reference's
    bracket expanded by 1.1^k as wide bounds (DoCooling, cooling.c:57-140)."""
    rho_cgs = rho * units.density_in_phys_cgs / C.PROTONMASS
    u_old_cgs = torch.clamp(u_old * units.uu_in_cgs,
                            min=min_egy_spec * units.uu_in_cgs)
    dt_s = dt * units.tt_in_s
    min_u = min_egy_spec * units.uu_in_cgs
    # the reference expands by 1.1 from u_old; 1.1^60 ~ 300x
    return CoolingBracket(rho_cgs, u_old_cgs, dt_s, min_u,
                          torch.clamp(u_old_cgs / 300.0, min=min_u),
                          u_old_cgs * 300.0)


def bisection_step(cr: CoolingRates, redshift, uvbg, br: CoolingBracket,
                   u_lo, u_hi, ne):
    """One step of do_cooling's bisection: (u_lo, u_hi, ne/nh) -> the
    next, a function of that triple alone (given br)."""
    u_mid = 0.5 * (u_lo + u_hi)
    lam, ne = cr.get_heatingcooling_rate(br.rho_cgs, u_mid, redshift, uvbg,
                                         ne)
    val = u_mid - br.u_old_cgs - lam * br.dt_s
    heat = val < 0  # u too small -> move lower bound up
    return torch.where(heat, u_mid, u_lo), torch.where(heat, u_hi, u_mid), ne


def do_cooling_reference(cr: CoolingRates, redshift, u_old, rho, dt, uvbg,
                         ne_guess, min_egy_spec, units: CoolingUnits):
    """Implicit du integration (DoCooling, cooling.c:57-140): wide initial
    bounds, then a bisection of BISECT_ITERS steps over (u_lo, u_hi, ne),
    left as soon as that state repeats (:func:`iterate`).  Per-particle
    tensors, internal units.  Returns (u_new internal, ne/nh).  The plain
    version of K6."""
    br = cooling_bracket(u_old, rho, dt, min_egy_spec, units)
    u_lo, u_hi, ne = iterate(
        lambda st: bisection_step(cr, redshift, uvbg, br, *st),
        (br.u_lo, br.u_hi, ne_guess), BISECT_ITERS, BISECT_PERIOD)
    u = torch.clamp(0.5 * (u_lo + u_hi), min=br.min_u)
    return u / units.uu_in_cgs, ne


# ---- K6 ------------------------------------------------------------------

def _kernel(name, n_ptr):
    """The ctypes function of one K6 entry point: n_ptr device pointers
    (inputs, outputs, rows), n_rows, the host scalars and the stream."""
    if name not in _fns:
        fn = getattr(kernels.load("cooling"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int64] \
            + [ctypes.c_void_p] * 3
        _fns[name] = fn
    return _fns[name]


def kernel_args(cr: CoolingRates, redshift, uvbg: UVBG, min_egy_spec=0.0,
                units: Optional[CoolingUnits] = None):
    """K6's scalar arguments: (doubles, ints) as numpy arrays, in the
    order of ``csrc/cooling.cu``'s ``CoolArgs``.  The composite scalar
    factors are evaluated here in Python, as in the JAX package."""
    par = cr.par
    helium = cr.helium
    tcmb = par.CMBTemperature * (1 + redshift)
    units = units or CoolingUnits(1.0, 1.0, 1.0)
    d = [uvbg.gJH0, uvbg.gJHe0, uvbg.gJHep, uvbg.epsH0, uvbg.epsHe0,
         uvbg.epsHep,
         1.003 * uvbg.self_shield_dens, uvbg.self_shield_dens * 0.01,
         1 - helium, helium / 4 / (1 - helium), (1 - helium) ** 2,
         par.MinGasTemp, tcmb,
         4 * C.THOMPSON * C.RAD_CONST / (C.ELECTRONMASS * C.LIGHTCGS)
         * tcmb ** 4 * C.BOLTZMANN,
         par.rho_crit_baryon * (1 + redshift) ** 3, par.HeliumHeatThresh,
         par.HeliumHeatAmp, par.HeliumHeatExp,
         units.density_in_phys_cgs, units.uu_in_cgs, units.tt_in_s,
         min_egy_spec * units.uu_in_cgs]
    i = [par.recomb, par.cooling, int(bool(par.SelfShieldingOn)),
         int(bool(par.HeliumHeatOn))]
    return np.asarray(d, np.float64), np.asarray(i, np.int32)


def _launch(name, n_rows, rows, args, ins, outs):
    global LAUNCHES
    dev = outs[0].device
    dtype = outs[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K6 takes float32 or float64, got {dtype}")
    n = outs[0].shape[0]
    for t in ins + outs:
        kernels.check_tensor("cooling input", t, (n,), dtype)
        if t.device != dev:
            raise ValueError("K6 inputs must be on one device")
    if rows is not None:
        kernels.check_tensor("rows", rows, (n_rows,), torch.int64)
        if rows.device != dev:
            raise ValueError("K6 inputs must be on one device")
    dbl, ints = args
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = _kernel(f"{name}_{suffix}", len(ins) + len(outs) + 1)
    with torch.cuda.device(dev):
        rc = fn(*[t.data_ptr() for t in ins + outs],
                rows.data_ptr() if rows is not None else None, n_rows,
                dbl.ctypes.data, ints.ctypes.data,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cooling kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1


def _as_rows(rows, n, device):
    """rows (None, a bool mask or indices) as int64 indices on device;
    indices outside [0, n) raise (the kernel would write out of bounds)."""
    if rows is None:
        return None
    rows = torch.as_tensor(rows, device=device)
    if rows.dtype == torch.bool:
        return torch.nonzero(rows).flatten()
    rows = rows.to(torch.int64).contiguous()
    if rows.numel() and not bool((rows.min() >= 0) & (rows.max() < n)):
        raise ValueError(f"rows outside [0, {n})")
    return rows


def do_cooling(cr: CoolingRates, redshift, u_old, rho, dt, uvbg, ne_guess,
               min_egy_spec, units: CoolingUnits, rows=None):
    """Implicit cooling of the rows listed in ``rows`` (int64 indices or a
    bool mask; all rows when None): K6's ``do_cooling`` on CUDA tensors (or
    raise), :func:`do_cooling_reference` on CPU tensors.  Returns (u_new,
    ne/nh); unlisted rows keep u_old and ne_guess."""
    rows = _as_rows(rows, u_old.shape[0], u_old.device)
    if u_old.device.type == "cpu":
        return _rows(lambda u, r, t, e: do_cooling_reference(
            cr, redshift, u, r, t, uvbg, e, min_egy_spec, units), rows,
            (u_old, ne_guess), u_old, rho, dt, ne_guess)
    u_new = u_old.clone()
    ne_new = ne_guess.clone()
    n_rows = u_old.shape[0] if rows is None else rows.shape[0]
    if n_rows:
        _launch("do_cooling", n_rows, rows,
                kernel_args(cr, redshift, uvbg, min_egy_spec, units),
                [u_old.contiguous(), rho.contiguous(), dt.contiguous(),
                 ne_guess.contiguous()], [u_new, ne_new])
    return u_new, ne_new


def heatingcooling_rate(cr: CoolingRates, density, ienergy, redshift, uvbg,
                        ne_init, rows=None):
    """(Lambda_net erg/s/g, ne/nh) of the rows listed in ``rows`` (all when
    None): K6's ``heatingcooling_rate`` on CUDA tensors (or raise),
    :meth:`CoolingRates.get_heatingcooling_rate` on CPU tensors.  Unlisted
    rows hold 0 and ne_init."""
    rows = _as_rows(rows, density.shape[0], density.device)
    if density.device.type == "cpu":
        return _rows(lambda d, u, e: cr.get_heatingcooling_rate(
            d, u, redshift, uvbg, e), rows,
            (torch.zeros_like(density), ne_init), density, ienergy, ne_init)
    lam = torch.zeros_like(density)
    ne_new = ne_init.clone()
    n_rows = density.shape[0] if rows is None else rows.shape[0]
    if n_rows:
        _launch("heatingcooling_rate", n_rows, rows,
                kernel_args(cr, redshift, uvbg),
                [density.contiguous(), ienergy.contiguous(),
                 ne_init.contiguous()], [lam, ne_new])
    return lam, ne_new
