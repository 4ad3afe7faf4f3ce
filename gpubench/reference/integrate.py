"""The kick-drift-kick of one PM step for the rows that stay in the top
timebin, written anew from MP-Gadget's integrator (run.c, timestep.c)
and the benchmark's own cosmology.  It imports nothing of the program.

A row whose bin spans the whole PM step [t0, t1] is kicked at t0 by
half its long-range force over [t0, mid] and half its short-range force
over its half bin, drifts over [t0, t1], and is kicked at t1 by the
forces found there.  The program's internal box shift, re-drawn at each
step's start, moves every row by the same number of ticks.
"""

import torch

from .gravity import _rnd

TICKS = 2 ** 32


def predict(start, end_acc, t0, dti, shift, ticks, bg, box,
            low=False, dtype=torch.float64):
    """Positions (int64 ticks) and velocities that the step gives the
    rows of ``start`` (dict of ipos, vel, grav_pm, grav_accel at t0)
    whose bin spans the step; end_acc: (grav_pm, grav_accel) at t1;
    shift: int64[3], the ticks of the box shift re-drawn at t0.  low:
    every value rounded to bfloat16 (the control)."""
    t1 = t0 + dti
    mid = t0 + dti // 2
    half = dti // 2
    a = ticks.a
    k_pm0 = bg.gravkick(a(t0), a(mid))
    k_pm1 = bg.gravkick(a(mid), a(t1))
    k_open = bg.gravkick(a(t0), a(t0 + half))
    k_close = bg.gravkick(a(t1 - half), a(t1))
    drift = bg.drift(a(t0), a(t1))

    def f(x):
        return _rnd(x.to(dtype), low)

    def c(x):
        return float(_rnd(torch.tensor(x, dtype=dtype), low))

    v1 = f(f(start["vel"]) + f(f(start["grav_pm"]) * c(k_pm0))
           + f(f(start["grav_accel"]) * c(k_open)))
    disp = f(v1 * c(drift * TICKS / box))
    ipos = (start["ipos"] + shift[None, :]
            + torch.round(disp).to(torch.int64)) & 0xFFFFFFFF
    pm1, acc1 = end_acc
    vel = f(v1 + f(f(pm1) * c(k_pm1)) + f(f(acc1) * c(k_close)))
    return ipos, vel, disp


def shift_ticks(offset_before, offset_after):
    """The ticks every row moved by when the program re-drew its box
    shift (one per axis)."""
    return torch.as_tensor(
        [(int(b) - int(a)) & 0xFFFFFFFF for a, b in
         zip(offset_before, offset_after)], dtype=torch.int64)
