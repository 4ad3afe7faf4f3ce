"""Linear-response massive neutrinos (Ali-Haimoud & Bird 2012,
arXiv:1209.0461; Bird et al 2018, arXiv:1803.09854).

Host-side numpy re-design of libgadget/neutrinos_lra.c: the code keeps a
table of delta_tot(k, a) sampled at every PM step; at each step the
neutrino overdensity is the free-streaming integral over that history,

  delta_nu(k,a) = J(k F(a_T,a)/x) delta_nu_init(k) (1 + dprefac F)
      + 1.5 Om0 H0^2/c * int dln a' F(a',a)/(a' H(a')) J(k F/x)
                                   delta_tot(k,a')

with F the free-streaming length, x = m_nu/(k_B T_nu), and J the
Fourier-transformed Fermi-Dirac kernel (specialJ, :579-625).  The PM
potential is then multiplied per |k| by
  1 + f_nu * delta_nu/delta_cdm  (potential_transfer, gravpm.c:415-436).

This runs once per PM step over a few hundred k bins — microseconds of
host time — so it stays numpy/f64.
"""

from dataclasses import dataclass, field
from typing import List, Optional
import numpy as np
from scipy import integrate, interpolate

from ..utils import constants as C


def special_j(x, qc=0.0, nufrac_low=0.0):
    """Fermi-Dirac free-streaming kernel fit (specialJ_fit, :579-590)."""
    x = np.asarray(x, dtype=np.float64)
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    out = (1 + 0.0168 * x2 + 0.0407 * x4) / (
        1 + 2.1734 * x2 + 1.6787 * np.exp(4.1811 * np.log(
            np.maximum(x, 1e-30))) + 0.1467 * x8)
    return np.where(x <= 0, 1.0, out)


class DeltaTotTable:
    """delta_tot(k, a) history + neutrino response (the _delta_tot_table
    analog; checkpointed into snapshots like the reference)."""

    def __init__(self, cosmology, wavenum, delta_cdm_init, time_transfer,
                 units, t_nu_ratio=None):
        """wavenum in internal 1/length; delta_cdm_init = sqrt(P_cdm)
        at TimeTransfer; t_nu_ratio = T_nu/T_cb transfer ratio at
        wavenum (defaults to 1: same initial clustering)."""
        self.CP = cosmology
        self.wavenum = np.asarray(wavenum, np.float64)
        self.nk = len(wavenum)
        self.TimeTransfer = time_transfer
        self.light = C.LIGHTCGS * units.UnitTime_in_s \
            / units.UnitLength_in_cm
        self.delta_nu_prefac = 1.5 * cosmology.Omega0 * C.HUBBLE ** 2 \
            * units.UnitTime_in_s ** 2 / self.light
        self.Omeganonu = cosmology.Omega0 - cosmology.ONu(1.0)
        ratio = np.ones(self.nk) if t_nu_ratio is None \
            else np.asarray(t_nu_ratio)
        omnua3 = cosmology.ONu.nopart(time_transfer) * time_transfer ** 3
        omnu1 = cosmology.ONu(1.0)
        self.delta_nu_init = np.asarray(delta_cdm_init) * ratio
        # history arrays
        self.scalefact: List[float] = [np.log(time_transfer)]
        fcdm = 1 - omnua3 / (self.Omeganonu + omnu1)
        d0 = fcdm * (np.asarray(delta_cdm_init)
                     + self.delta_nu_init * omnua3
                     / (self.Omeganonu + omnu1))
        self.delta_tot = [d0]
        self.delta_nu_last = np.zeros(self.nk)

    # -- free streaming -------------------------------------------------

    def fslength(self, logai, logaf):
        """light * int dloga / (a^2 H) (fslength, :539-569)."""
        if logai >= logaf:
            return 0.0
        val, _ = integrate.quad(
            lambda la: 1.0 / np.exp(la)
            / (np.exp(la) * self.CP.hubble_function(np.exp(la))),
            logai, logaf, epsabs=0, epsrel=1e-6, limit=200)
        return self.light * val

    def get_delta_nu(self, a, mnu):
        """delta_nu(k) for one neutrino species (get_delta_nu,
        :670-770); integral discretized over the stored history."""
        kBtnu = self.CP.ONu.kBtnu
        mnubykT = mnu / kBtnu
        loga_T = np.log(self.TimeTransfer)
        loga = np.log(a)
        fsl_A0a = self.fslength(loga_T, loga)
        deriv_prefac = self.TimeTransfer * (
            self.CP.hubble_function(self.TimeTransfer) / self.light) \
            * self.TimeTransfer
        x = self.wavenum * fsl_A0a / (mnubykT if mnubykT > 0 else 1.0)
        delta_nu = special_j(x) * self.delta_nu_init \
            * (1 + deriv_prefac * fsl_A0a)
        na = len(self.scalefact)
        if na > 1 and mnubykT > 0:
            # oversampled free-streaming lengths
            nfs = max(na * 16, 64)
            las = np.linspace(loga_T, loga, nfs)
            fsls = np.array([self.fslength(la, loga) for la in las])
            fsl_i = interpolate.interp1d(las, fsls)
            hist = np.array(self.delta_tot)       # (na, nk)
            kind = "cubic" if na >= 4 else "linear"
            # the reference stores an initial guess for the current
            # step (d_tot->ia includes it); we extrapolate instead
            dtot_i = interpolate.interp1d(self.scalefact, hist, axis=0,
                                          kind=kind,
                                          fill_value="extrapolate",
                                          bounds_error=False)
            # integrate over log a' with trapezoid on a fine grid
            ngrid = max(4 * na, 128)
            lag = np.linspace(loga_T, loga, ngrid)
            fl = fsl_i(lag)
            ag = np.exp(lag)
            hub = np.array([self.CP.hubble_function(av) for av in ag])
            dt = dtot_i(lag)                      # (ngrid, nk)
            sj = special_j(np.outer(fl, self.wavenum) / mnubykT)
            integrand = (fl / (ag * hub))[:, None] * sj * dt
            integral = np.trapezoid(integrand, lag, axis=0)
            delta_nu = delta_nu + self.delta_nu_prefac * integral
        return delta_nu

    def get_delta_nu_combined(self, a):
        """Sum over species weighted by their density (:497-520)."""
        onu = self.CP.ONu
        om_tot = onu.nopart(a)
        if om_tot == 0:
            return np.zeros(self.nk)
        out = np.zeros(self.nk)
        done = set()
        for mi in range(3):
            if onu.degeneracies[mi] == 0:
                continue
            om_i = onu.omega_nu_single(a, mi) * onu.degeneracies[mi]
            out += om_i / om_tot * self.get_delta_nu(a, onu.MNu[mi])
        return out

    # -- per-PM-step update ---------------------------------------------

    def step(self, a, delta_cdm):
        """Called each PM step with the measured sqrt(P_cdm)(k):
        computes delta_nu, appends/overwrites the history, and returns
        the k-space potential multiplier table
        (logk, nufac) (compute_neutrino_power, gravpm.c:307-330)."""
        loga = np.log(a)
        delta_nu = self.get_delta_nu_combined(a)
        self.delta_nu_last = np.maximum(delta_nu, 0.0)
        omnua3 = self.CP.ONu.nopart(a) * a ** 3
        omnu1 = self.CP.ONu(1.0)
        partfrac = self.CP.ONu.particle_fraction(a)
        fcdm = 1 - omnua3 / (self.Omeganonu + omnu1)
        dtot = fcdm * (np.asarray(delta_cdm) + delta_nu * omnua3
                       / (self.Omeganonu + omnu1 * partfrac))
        if loga > self.scalefact[-1] + 1e-12:
            self.scalefact.append(loga)
            self.delta_tot.append(dtot)
        else:
            self.scalefact[-1] = loga
            self.delta_tot[-1] = dtot
        # potential multiplier: 1 + nu_prefac * delta_nu/delta_cdm
        omega_hybrid = omnu1 * partfrac / a ** 3
        nu_prefac = self.CP.ONu.nopart(a) / (
            self.Omeganonu / a ** 3 + omega_hybrid)
        ratio = self.delta_nu_last / np.maximum(delta_cdm, 1e-30)
        nufac = 1.0 + nu_prefac * ratio
        return np.log(self.wavenum), nufac

    # -- checkpoint ------------------------------------------------------

    def state_dict(self):
        return {"scalefact": np.array(self.scalefact),
                "delta_tot": np.array(self.delta_tot),
                "delta_nu_init": self.delta_nu_init,
                "wavenum": self.wavenum}

    def load_state(self, st):
        self.scalefact = list(np.asarray(st["scalefact"]))
        self.delta_tot = list(np.asarray(st["delta_tot"]))
        self.delta_nu_init = np.asarray(st["delta_nu_init"])
        self.wavenum = np.asarray(st["wavenum"])
        self.nk = len(self.wavenum)
        # history starts at the original transfer time, not the
        # restart time (neutrinos_lra.c:379-452 restores it implicitly
        # via scalefact[0])
        self.TimeTransfer = float(np.exp(self.scalefact[0]))
