"""Whether what the timed path produced is correct, judged by the plain
reference in ``reference/`` and the cell's limits (``limits/<cell>.json``).

Four numbers are compared, each with its limit:

* ``pm_err``: the 99th percentile over sampled rows of the gap between
  the program's long-range acceleration and the reference's mesh force
  from the same positions;
* ``force_err``: the 95th percentile of the gap between the program's
  total acceleration (mesh + tree) and the reference's mesh force plus
  its exact short-range pair sum;
* ``kick_drift_err``: the widest gap, over sampled dark-matter rows whose
  timebin spans the window's last PM step, between the positions and velocities
  the program reached and those the reference's kick-drift-kick gives
  from the program's state at that step's start and the forces at its
  end;
* ``setup_force_err``: ``force_err``'s gap for the start of the run,
  ``run()``'s opening forces, from the initial conditions made again
  from the seed (the one state the reference does not take from the
  program).

Each gap of a row is measured against the reference's norm for that row
or the median row's norm, whichever is larger.
"""

import torch

from .ics import background
from .reference import gravity as refg
from .reference import integrate as refi
from .reference.cosmology import Ticks
from .sim import softening



def sample_rows(n, k, seed, salt, device):
    """k rows (fewer after removing repeats) drawn from the seed."""
    gen = torch.Generator()
    gen.manual_seed((int(seed) * 1000003 + salt) % (1 << 63))
    return torch.unique(torch.randint(n, (k,), generator=gen)).to(device)


def rel_gaps(prog, ref):
    norm = torch.linalg.vector_norm(ref, dim=1)
    floor = float(norm.median())
    return torch.linalg.vector_norm(prog.to(ref.dtype) - ref, dim=1) \
        / torch.clamp(norm, min=floor)


def quantile(x, q):
    return float(torch.quantile(x.to(torch.float64).cpu(), q))


def split_params(cfg):
    """(box, nmesh, asmth, rs, rcut, h) of the configuration's force
    split: r_s = Asmth cells, the cut at TreeRcut r_s, and the softening
    h = 2.8 eps."""
    box, nmesh = float(cfg["BoxSize"]), int(cfg["Nmesh"])
    asmth = float(cfg["params"].get("Asmth", 1.5))
    rs = asmth * box / nmesh
    rcut = float(cfg["params"].get("TreeRcut", 6.0)) * rs
    return box, nmesh, asmth, rs, rcut, softening(cfg)


def reference_forces(ipos, mass, rows, cfg, low=False):
    """(mesh, short-range) accelerations at ipos[rows], float64."""
    box, nmesh, asmth, rs, rcut, h = split_params(cfg)
    G = background(cfg).G
    pm = refg.pm_accel(ipos, mass, rows, nmesh, box, G, asmth, low=low)
    sr = refg.shortrange_accel(ipos, mass, rows, box, G, rs, rcut, h,
                               low=low)
    return pm, sr


def gravity_numbers(pm_prog, sr_prog, pm_ref, sr_ref):
    return {"pm_err": quantile(rel_gaps(pm_prog, pm_ref), 0.99),
            "force_err": quantile(rel_gaps(pm_prog + sr_prog,
                                           pm_ref + sr_ref), 0.95)}


def kick_drift(cfg, traffic, step, low=False):
    """(positions, velocities, displacements) that the reference's
    kick-drift-kick gives the top-bin rows of ``step`` (see
    ``capture_step``), and the mask of those rows; None if no sampled
    row spans the step."""
    start, end = step["start"], step["end"]
    bins = end["timebin"].to(torch.int64)
    # dark matter whose bin spans the step
    top = ((torch.ones_like(bins) << bins) == step["dti"]) \
        & (end["ptype"] == 1)
    if not bool(top.any()):
        return None
    bg = background(cfg)
    ticks = Ticks(1.0 / (1.0 + traffic["redshift"]),
                  float(traffic["TimeMax"]))
    shift = refi.shift_ticks(step["offset_before"], step["offset_after"])
    sel = {k: v[top] for k, v in start.items()}
    ipos, vel, disp = refi.predict(
        sel, (end["grav_pm"][top], end["grav_accel"][top]), step["t0"],
        step["dti"], shift.to(sel["ipos"].device),
        ticks, bg, float(cfg["BoxSize"]), low=low)
    return ipos, vel, disp, top


def kick_drift_gap(ipos, vel, ref):
    """The widest gap of positions (ticks, against the step's
    displacement) and velocities between ``ipos``/``vel`` and the
    reference's prediction ``ref``."""
    ipos_ref, vel_ref, disp, _ = ref
    d = ((ipos - ipos_ref + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31
    pos_gap = rel_gaps(d.to(torch.float64) + disp, disp)
    vel_gap = rel_gaps(vel, vel_ref)
    return max(float(pos_gap.max()), float(vel_gap.max()))


def readings(cfg, traffic, state, control=False):
    """The numbers compared, of the program's output, or with control
    of the reference computed in bfloat16 put in the program's place."""
    from .ics import make_ics
    ref = reference_forces(state["ipos_end"], state["mass_end"],
                           state["rows_e"], cfg)
    prog = state["end_acc"]
    if control:
        prog = reference_forces(state["ipos_end"], state["mass_end"],
                                state["rows_e"], cfg, low=True)
    numbers = gravity_numbers(*prog, *ref)
    last = state["last"]
    kd = kick_drift(cfg, traffic, last)
    if kd is not None:
        top = kd[3]
        if control:
            ipos, vel = kick_drift(cfg, traffic, last, low=True)[:2]
        else:
            ipos, vel = last["end"]["ipos"][top], last["end"]["vel"][top]
        numbers["kick_drift_err"] = kick_drift_gap(ipos, vel, kd)
    # the start: run()'s opening forces, from the initial conditions
    # made again from the seed
    ics = make_ics(cfg, traffic["redshift"], state["seed"],
                   state["rows_f"].device, traffic.get("field_seed"))
    ref = reference_forces(ics["ipos"], ics["mass"], state["rows_f"], cfg)
    prog = state["setup_acc"]
    if control:
        prog = reference_forces(ics["ipos"], ics["mass"], state["rows_f"],
                                cfg, low=True)
    del ics
    numbers["setup_force_err"] = quantile(
        rel_gaps(prog[0] + prog[1], ref[0] + ref[1]), 0.95)
    return numbers


def judge(numbers, limits):
    """(correct, checks): every number the cell's limits name present,
    finite and within its limit."""
    checks = {}
    ok = True
    for name in limits:
        value = numbers.get(name)
        limit = limits[name]
        checks[name] = {"value": value, "limit": limit}
        if value is None or not value == value or value > limit:
            ok = False
    return ok, checks
