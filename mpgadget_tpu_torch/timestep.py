"""Timestep criteria and per-particle timebins (PyTorch port of
mpgadget_tpu/timestep.py).

The PM (long-range) step comes from the max RMS displacement criterion
(timestep.c:1220-1300), quantized onto the power-of-two integer
timeline; per-particle power-of-two bins come from the acceleration and
Courant criteria (find_timesteps, timestep.c:298-503).  Per-particle
reductions run on the device; the scalar policy runs on the host.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .timeline import round_down_power_of_two, get_timestep_bin


@dataclass
class TimestepParams:
    ErrTolIntAccuracy: float = 0.02
    CourantFac: float = 0.15
    MaxRMSDisplacementFac: float = 0.2
    MaxSizeTimestep: float = 0.1
    MinSizeTimestep: float = 0.0
    ForceEqualTimesteps: bool = False


def _vel_stats_by_type(vel, mass, ptype, valid):
    """Per-type sum v^2, count, min mass (get_long_range_timestep_dloga),
    accumulated in f64."""
    v2 = torch.sum(vel * vel, dim=-1).to(torch.float64)
    w = valid.to(torch.float64)
    tid = torch.where(valid, ptype, 6).to(torch.int64)
    v_sum = torch.zeros(7, dtype=torch.float64, device=vel.device)
    v_sum.index_add_(0, tid, v2 * w)
    count = torch.zeros(7, dtype=torch.float64, device=vel.device)
    count.index_add_(0, tid, w)
    min_mass = torch.full((7,), float("inf"), dtype=torch.float64,
                          device=vel.device)
    min_mass.scatter_reduce_(0, tid, torch.where(
        valid, mass.to(torch.float64), float("inf")), reduce="amin")
    return (v_sum[:6].cpu().numpy(), count[:6].cpu().numpy(),
            min_mass[:6].cpu().numpy())


def get_long_range_timestep_dloga(pdata, CP, atime, asmth_len,
                                  par: TimestepParams,
                                  fast_particle_type=2,
                                  omega_per_type=None):
    """Max RMS displacement PM step (timestep.c:1246-1290).

    dloga = fac * H(a) * a^2 * min(asmth, dmean) / sqrt(<v^2>) per type;
    the minimum over non-fast types wins.
    """
    v_sum, count, min_mass = _vel_stats_by_type(
        pdata.vel, pdata.mass, pdata.ptype, pdata.valid)
    hubble = CP.hubble_function(atime)
    dloga = par.MaxSizeTimestep
    for t in range(6):
        if count[t] == 0:
            continue
        if omega_per_type is not None:
            omega = omega_per_type[t]
        else:
            omega = min_mass[t] * count[t] / (CP.RhoCrit * 1.0)
        if omega <= 0:
            continue
        dmean = (min_mass[t] / (omega * CP.RhoCrit)) ** (1.0 / 3)
        vrms = np.sqrt(v_sum[t] / count[t])
        if vrms <= 0:      # cold start: no displacement constraint
            continue
        d1 = (par.MaxRMSDisplacementFac * hubble * atime * atime
              * min(asmth_len, dmean) / vrms)
        if t != fast_particle_type and d1 < dloga:
            dloga = d1
    return max(dloga, par.MinSizeTimestep)


def get_pm_timestep_ti(dloga, timeline, times_ti_current, pm_kick_ti):
    """Quantize the PM dloga onto the integer timeline and cap at the next
    sync point (get_PM_timestep_ti, timestep.c:1281-1300)."""
    dti = timeline.dti_from_dloga(dloga, times_ti_current)
    dti = round_down_power_of_two(dti)
    nxt = timeline.find_next_sync_point(times_ti_current)
    if nxt is None:
        raise RuntimeError("Trying to go beyond the last sync point")
    dti_max = nxt.ti - pm_kick_ti
    return min(dti, dti_max)


def _f32(x, device):
    """A host scalar as a 0-dim f32 tensor on the device: divisions by it
    round as a division (a Python float divisor lets CUDA multiply by its
    reciprocal instead)."""
    return torch.tensor(float(np.float32(x)), dtype=torch.float32,
                        device=device)


def _particle_dloga(grav_accel, grav_pm, valid, is_gas, hsml, dt_hsml,
                    max_signal_vel, atime, eta_eps, hubble, courant_fac,
                    fac3, max_dloga):
    """Per-particle combined dloga: gravity acceleration criterion
    (timestep.c:1063-1073) + Courant/Hsml criteria for gas
    (timestep.c:1075-1090).  f32, in the JAX package's order of
    operations."""
    dev = grav_accel.device
    acc = (grav_accel + grav_pm) / (_f32(atime, dev) * _f32(atime, dev))
    # max(., 1e-60) in f32 is max(., 0)
    ac = torch.sqrt(torch.clamp(torch.sum(acc * acc, dim=-1),
                                min=float(np.float32(1e-60))))
    dloga = torch.sqrt(_f32(eta_eps, dev) / ac) * _f32(hubble, dev)
    vsig = torch.clamp(max_signal_vel, min=float(np.float32(1e-30)))
    dt_c = 2.0 * _f32(courant_fac, dev) * _f32(atime, dev) * hsml / (
        _f32(fac3, dev) * vsig)
    dt_h = _f32(courant_fac, dev) * _f32(atime, dev) * _f32(atime, dev) \
        * torch.abs(hsml / (dt_hsml + float(np.float32(1e-20))))
    dloga_h = torch.minimum(dt_c, dt_h) * _f32(hubble, dev)
    dloga = torch.where(is_gas, torch.minimum(dloga, dloga_h), dloga)
    mx = _f32(max_dloga, dev)
    return torch.where(valid, torch.minimum(dloga, mx), mx)


def assign_particle_bins(pdata, sph, gas_mask, CP, atime, softening,
                         timeline, ti_current, par: TimestepParams,
                         dti_max):
    """Per-particle power-of-two timebins (find_timesteps,
    timestep.c:298-503): gravity + hydro criteria, clamped to
    [1, bin(dti_max)].  Returns int32[N] bins on the particles' device.

    sph: the gas state (``max_signal_vel``), read only when given; with
    sph None every particle takes the gravity criterion alone.  The bin
    is floor(log2(max(dti, 2))) in f32 with log2 as log(x) / log(2), as
    the JAX package computes it, so identical inputs give identical
    bins."""
    from .utils.constants import GAMMA
    dev = pdata.device
    hubble = CP.hubble_function(atime)
    eta_eps = 2 * par.ErrTolIntAccuracy * atime * softening
    fac3 = atime ** (3 * (1 - GAMMA) / 2.0)
    if sph is not None:
        msv, hsml, dt_hsml = (sph.max_signal_vel, pdata.hsml,
                              pdata.dt_hsml)
    else:
        z = torch.zeros(pdata.capacity, dtype=torch.float32, device=dev)
        msv = hsml = dt_hsml = z
        gas_mask = torch.zeros(pdata.capacity, dtype=torch.bool, device=dev)
    dloga = _particle_dloga(
        pdata.grav_accel, pdata.grav_pm, pdata.valid, gas_mask, hsml,
        dt_hsml, msv, atime, eta_eps, hubble, par.CourantFac, fac3,
        par.MaxSizeTimestep)
    dloga_tick = timeline._interval_dloga(ti_current)
    maxbin = get_timestep_bin(dti_max)
    dti = dloga / _f32(dloga_tick, dev)
    x = torch.clamp(dti, min=2.0)
    bins = torch.floor(torch.log(x) / torch.log(_f32(2.0, dev))).to(
        torch.int32)
    bins = torch.clamp(bins, 1, maxbin)
    return torch.where(pdata.valid, bins, maxbin)
