"""Input linear power spectrum and transfer functions for IC generation.

Mirrors libgenic/power.c: reads a CAMB/CLASS-style P(k) table (k in
h/Mpc, P in (Mpc/h)^3) and optionally a CLASS transfer-function table
with per-species density and N-body-gauge velocity columns; normalizes
by sigma8 and/or rescales with the growth factor from InputPowerRedshift.

DeltaSpec(k, type) returns sqrt(P(k)) in internal-length^{3/2} units,
after normalization — the same quantity as the reference's DeltaSpec
(power.c:52-66).
"""

from dataclasses import dataclass
from typing import Optional
import numpy as np
from scipy import integrate, interpolate

from ..utils import constants as C

# Transfer column types (power.c enum TransferType)
DELTA_BAR = 0
DELTA_CDM = 1
DELTA_NU = 2
DELTA_CB = 3
VEL_BAR = 4
VEL_CDM = 5
VEL_NU = 6
VEL_CB = 7
VEL_TOT = 8
DELTA_TOT = -2  # no species transfer applied


@dataclass
class PowerParams:
    FileWithInputSpectrum: str = ""
    FileWithTransferFunction: str = ""
    DifferentTransferFunctions: bool = False
    ScaleDepVelocity: bool = False
    WhichSpectrum: int = 2
    Sigma8: float = -1.0
    InputPowerRedshift: float = -1.0
    PrimordialIndex: float = 0.971


class PowerSpec:
    def __init__(self, params: PowerParams, cosmology, InitTime: float,
                 UnitLength_in_cm: float = C.CM_PER_KPC):
        self.par = params
        self.CP = cosmology
        self.UnitLength_in_cm = UnitLength_in_cm
        self.scale = C.CM_PER_MPC / UnitLength_in_cm  # Mpc/h in internal
        self.Norm = 1.0
        self._transfer = None
        if params.WhichSpectrum == 2:
            self._read_power(params.FileWithInputSpectrum)
            if ((params.DifferentTransferFunctions
                 or params.ScaleDepVelocity)
                    and params.FileWithTransferFunction):
                self._read_transfer(params.FileWithTransferFunction,
                                    InitTime)
        if params.InputPowerRedshift >= 0 or params.Sigma8 > 0:
            R8 = 8 * self.scale
            if params.Sigma8 > 0:
                s2 = self.tophat_sigma2(R8)
                self.Norm = params.Sigma8 / np.sqrt(s2)
            if params.InputPowerRedshift >= 0:
                Dplus = cosmology.GrowthFactor(
                    InitTime, 1.0 / (1 + params.InputPowerRedshift))
                self.Norm *= Dplus

    # -- table readers -------------------------------------------------

    def _read_power(self, path):
        rows = []
        with open(path) as fh:
            for line in fh:
                t = line.split()
                if not t or t[0].startswith("#"):
                    continue
                rows.append((float(t[0]), float(t[1])))
        rows = np.array(rows)
        if rows.shape[0] < 2:
            raise ValueError("Input spectrum too short")
        in_log10 = np.any(rows[:, 0] < 0)
        if in_log10:
            logk, logP = rows[:, 0], rows[:, 1]
        else:
            logk = np.log10(rows[:, 0])
            logP = np.log10(rows[:, 1] + 1e-30)
        order = np.argsort(logk)
        self._logk = logk[order]
        # store log10 of delta = sqrt(P) (power.c:169-189)
        self._logD = logP[order] / 2.0
        self._pk_interp = interpolate.interp1d(self._logk, self._logD,
                                               kind="linear")

    def _read_transfer(self, path, InitTime):
        """CLASS transfer table with extra metric transfer functions
        (parse_transfer, power.c:191-256)."""
        rows = []
        with open(path) as fh:
            for line in fh:
                t = line.split()
                if not t or t[0].startswith("#"):
                    continue
                rows.append([float(x) for x in t])
        rows = np.array(rows)
        ncol = rows.shape[1]
        defld = 1 if ncol > 22 else 0
        nnu = int(round((ncol - 1 - 15 - defld * 2) / 2))
        k = rows[:, 0]
        logk = np.log10(k)
        onu_single = np.array([self.CP.ONu.omega_nu_single(InitTime, j)
                               for j in range(max(nnu, 1))])
        onu = max(self.CP.ONu(InitTime), 1e-30)
        cols = {}
        cols[DELTA_BAR] = -rows[:, 2]
        cols[DELTA_CDM] = -rows[:, 3]
        dnu = np.zeros(len(k))
        for j in range(nnu):
            dnu = -rows[:, 5 + j + defld] * onu_single[j]
        cols[DELTA_NU] = dnu / onu
        cols[VEL_BAR] = rows[:, 13 + nnu + defld]
        cols[VEL_CDM] = rows[:, 9 + nnu + defld] * 0.5
        vnu = np.zeros(len(k))
        for j in range(nnu):
            vnu = rows[:, 14 + nnu + defld * 2 + j] * onu_single[j]
        cols[VEL_NU] = vnu / onu
        # -- exact reference conversion (init_transfer_table,
        # power.c:350-400) -------------------------------------------
        # velocity normalization: divide by a H(a) in CLASS 1/Mpc
        # units (fac = a * H/H0 * 100 h / c_km_s), THEN add the
        # synchronous-gauge metric term h'/2 (already stored in
        # VEL_CDM) to the baryon and neutrino velocities — fastpm
        # convention v_x = -(h'/2 + t_x)/d_x
        hubble = self.CP.hubble_function(InitTime)
        light_kms = C.LIGHTCGS / 1e5
        fac = (InitTime * hubble / self.CP.Hubble
               * 100.0 * self.CP.HubbleParam / light_kms)
        cols[VEL_CDM] = cols[VEL_CDM] / fac
        cols[VEL_BAR] = cols[VEL_BAR] / fac + cols[VEL_CDM]
        cols[VEL_NU] = cols[VEL_NU] / fac + cols[VEL_CDM]
        ob, oc = self.CP.OmegaBaryon, self.CP.OmegaCDM
        cols[DELTA_CB] = ob * cols[DELTA_BAR] + oc * cols[DELTA_CDM]
        cols[VEL_CB] = ob * cols[VEL_BAR] + oc * cols[VEL_CDM]
        cols[VEL_TOT] = cols[VEL_CB].copy()
        t_tot = cols[DELTA_CB].copy()
        omega0a3 = ob + oc
        cols[DELTA_CB] = cols[DELTA_CB] / (ob + oc)
        cols[VEL_CB] = cols[VEL_CB] / (ob + oc)
        onu1 = self.CP.ONu(InitTime) * InitTime ** 3
        if nnu > 0:
            cols[VEL_TOT] = cols[VEL_TOT] + onu1 * cols[VEL_NU]
            t_tot = t_tot + onu1 * cols[DELTA_NU]
            omega0a3 += onu1
        cols[VEL_TOT] = cols[VEL_TOT] / omega0a3
        t_tot = t_tot / omega0a3
        # every row stored as T_x(k) / T_tot(k)
        self._transfer = {}
        for t in (DELTA_BAR, DELTA_CDM, DELTA_NU, DELTA_CB,
                  VEL_BAR, VEL_CDM, VEL_NU, VEL_CB, VEL_TOT):
            ratio = cols[t] / t_tot
            self._transfer[t] = interpolate.interp1d(
                logk, ratio, kind="linear",
                fill_value=(ratio[0], ratio[-1]), bounds_error=False)

    # -- evaluation ----------------------------------------------------

    def _tabulated(self, k, trans_type):
        """sqrt(P(k)) * (T_type/T_tot), internal units (get_Tabulated,
        power.c:68-103)."""
        k = np.asarray(k, dtype=np.float64)
        logk = np.log10(np.maximum(k * self.scale, 1e-30))
        lo, hi = self._logk[0], self._logk[-1]
        intlogk = np.clip(logk, lo, hi)
        logD = self._pk_interp(intlogk)
        # extrapolate past table end as P ~ k^-3 log(k)
        past = logk > hi
        logD = np.where(past, logD - 3 * (logk - intlogk)
                        + np.log(np.maximum(logk, 1e-30)
                                 / np.maximum(intlogk, 1e-30)), logD)
        trans = 1.0
        if self._transfer is not None and trans_type in self._transfer:
            trans = self._transfer[trans_type](intlogk)
        delta = 10.0 ** (logD + 1.5 * np.log10(self.scale)) * trans
        return self.Norm * delta

    def delta_spec(self, k, ptype=DELTA_TOT):
        """sqrt(P(k)), internal units; k in internal 1/length."""
        if self.par.WhichSpectrum != 2:
            return self.Norm * self._delta_eh(np.asarray(k, float))
        t = ptype if DELTA_BAR <= ptype <= DELTA_CB else DELTA_TOT
        return self._tabulated(k, t)

    def dlog_growth(self, k, ptype):
        """Velocity-transfer amplitude sqrt(P) * T_vel/T_tot
        (dlogGrowth, power.c:112-121): the scale-dependent analog of
        delta * F_Omega, consumed directly as the velocity potential
        amplitude in zeldovich."""
        if self._transfer is None or not self.par.ScaleDepVelocity:
            return self.delta_spec(k, ptype)
        if not (DELTA_BAR <= ptype <= DELTA_CB):
            vt = VEL_TOT
        else:
            vt = VEL_BAR + (ptype - DELTA_BAR)
        return self._tabulated(k, vt)

    def _delta_eh(self, k):
        """Eisenstein & Hu fallback (power.c:455-492)."""
        kk = np.asarray(k, dtype=np.float64)
        return np.sqrt(kk * self._tk_eh(kk) ** 2
                       * kk ** (self.par.PrimordialIndex - 1.0))

    def _tk_eh(self, k):
        CP = self.CP
        hubble = CP.HubbleParam
        omegam = CP.Omega0
        ombh2 = CP.OmegaBaryon * hubble ** 2
        if CP.OmegaBaryon == 0:
            ombh2 = 0.044 * hubble ** 2
        k = k * self.scale  # h/Mpc
        theta = 2.728 / 2.7
        ommh2 = omegam * hubble * hubble
        s = 44.5 * np.log(9.83 / ommh2) / np.sqrt(
            1.0 + 10.0 * ombh2 ** 0.75) * hubble
        a = (1.0 - 0.328 * np.log(431.0 * ommh2) * ombh2 / ommh2
             + 0.380 * np.log(22.3 * ommh2) * (ombh2 / ommh2) ** 2)
        gamma = a + (1.0 - a) / (1.0 + (0.43 * k * s) ** 4)
        gamma *= omegam * hubble
        q = k * theta * theta / gamma
        L0 = np.log(2.0 * np.e + 1.8 * q)
        C0 = 14.2 + 731.0 / (1.0 + 62.5 * q)
        return L0 / (L0 + C0 * q * q)

    def tophat_sigma2(self, R):
        """sigma^2(R) by direct integration (power.c:494-530)."""
        def integrand(k):
            kr = R * k
            kr2 = kr * kr
            if kr < 1e-3:
                w = 1.0 / 3.0 - kr2 / 30.0 + kr2 * kr2 / 840.0
            else:
                w = 3 * (np.sin(kr) / kr - np.cos(kr)) / kr2
            return (4 * np.pi / (2 * np.pi) ** 3 * k * k * w * w
                    * self.delta_spec(k, DELTA_TOT) ** 2)
        maxk = np.pi * 20.5 / R
        val, _ = integrate.quad(integrand, 0, maxk, epsabs=0, epsrel=1e-4,
                                limit=1000)
        return val
