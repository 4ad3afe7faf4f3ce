"""Global PM timestep criterion (PyTorch port of the part of
mpgadget_tpu/timestep.py that the global KDK step uses).

The PM (long-range) step comes from the max RMS displacement criterion
(timestep.c:1220-1300), quantized onto the power-of-two integer
timeline.  The per-type velocity reductions run on the device; the
scalar policy runs on the host.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .timeline import round_down_power_of_two


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
