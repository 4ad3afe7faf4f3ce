"""Build the port's Simulation for one run, as ``main.build_simulation``
builds it from a paramfile, with the initial conditions handed over from
device memory instead of read from an IC file.

``build_simulation`` reads the IC's header for its defaults and then
calls ``Simulation.from_snapshot``.  The benchmark writes a header-only
IC (one small attribute file in the run's scratch directory) and, for
the length of that call, patches only where the particle arrays enter
(``read_species`` and ``ParticleData.from_numpy``), so that they come
from the benchmark's initial conditions on the device.  Everything else
(the parameters' defaults and parsing, ``from_snapshot`` whole,
SimConfig, the cosmology, the timeline, the units) is the program's own
path.
"""

import os
from unittest import mock

import numpy as np
import torch

PARAM_KEYS = ("Omega0", "OmegaLambda", "OmegaBaryon", "HubbleParam")


def paramfile_text(cfg, traffic, ic_path, out_dir):
    """The run's paramfile: the configuration's parameters, its
    cosmology, and the traffic's end time, with no output before it."""
    lines = [f"InitCondFile = {ic_path}", f"OutputDir = {out_dir}",
             "OutputList = ", f"TimeMax = {traffic['TimeMax']}",
             "TimeLimitCPU = 1000000"]
    lines += [f"{k} = {cfg[k]}" for k in PARAM_KEYS]
    lines += [f"Nmesh = {cfg['Nmesh']}"]
    lines += [f"{k} = {v}" for k, v in cfg["params"].items()]
    return "\n".join(lines) + "\n"


def write_header_ic(path, cfg, ics):
    """A bigfile IC that holds only the Header block."""
    from mpgadget_tpu_torch.io.bigfile import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    h = ics["header"]
    header = snap_io.SnapshotHeader(
        TotNumPart=np.asarray(h["counts"], np.uint64),
        MassTable=np.asarray(h["masses"], np.float64), Time=h["a"],
        TimeIC=h["a"], BoxSize=h["box"], Omega0=cfg["Omega0"],
        OmegaLambda=cfg["OmegaLambda"], HubbleParam=cfg["HubbleParam"],
        OmegaBaryon=cfg["OmegaBaryon"])
    snap_io.write_header(BigFile(path, create=True), header)


def _ics_arrays(ics):
    """Patches for the length of ``from_snapshot``: ``read_species`` gives
    placeholders of each species' length (the IC holds only a header),
    and ``ParticleData.from_numpy`` puts ``ics``' device tensors where
    the read arrays would go."""
    from mpgadget_tpu_torch.io import snapshot as snap_io
    from mpgadget_tpu_torch.particles import ParticleData

    def read_species(bf, ptype, header):
        n = int(header.TotNumPart[ptype])
        if n == 0:
            return None
        return {"pos": np.empty((n, 3)), "vel": np.empty((n, 3)),
                "mass": np.empty(n), "pid": np.empty(n, np.int64)}

    def from_numpy(pos, vel, mass, ptype, pid, boxsize, capacity=None,
                   device="cuda"):
        n = ics["pid"].shape[0]
        cap = capacity or n
        p = ParticleData.zeros(cap, device)

        def put(name, dtype):
            arr = ics[name]
            out = torch.zeros((cap,) + tuple(arr.shape[1:]), dtype=dtype,
                              device=device)
            out[:n] = arr.to(device=device, dtype=dtype)
            return out

        return p.replace(
            ipos=put("ipos", torch.int64), vel=put("vel", torch.float32),
            mass=put("mass", torch.float32),
            ptype=put("ptype", torch.int32), pid=put("pid", torch.int64),
            valid=torch.arange(cap, device=device) < n)

    return (mock.patch.object(snap_io, "read_species", read_species),
            mock.patch.object(ParticleData, "from_numpy",
                              staticmethod(from_numpy)))


def build(cfg, traffic, ics, workdir, device):
    """The port's Simulation for this run, built by
    ``main.build_simulation`` from the paramfile text."""
    from mpgadget_tpu_torch.main import build_simulation
    from mpgadget_tpu_torch.params import create_gadget_parameter_set
    os.makedirs(workdir, exist_ok=True)
    ic_path = os.path.join(workdir, "IC")
    write_header_ic(ic_path, cfg, ics)
    ps = create_gadget_parameter_set()
    ps.parse_string(paramfile_text(cfg, traffic, ic_path,
                                   os.path.join(workdir, "output")))
    ps.validate()
    species, arrays = _ics_arrays(ics)
    with species, arrays:
        sim, _ = build_simulation(ps, device=device)
    return sim


def setup_state(sim):
    """What ``Simulation.run`` does before its loop (dark matter only):
    the opening forces."""
    os.makedirs(sim.cfg.output_dir, exist_ok=True)
    sim.compute_forces()


def pm_timestep(sim):
    """The PM step ``Simulation.run``'s loop takes (dark matter only:
    the long-range criterion)."""
    dti = sim.find_pm_timestep()
    if dti <= 0:
        raise RuntimeError(f"bad PM timestep {dti}")
    return dti


def step(sim, dti):
    """One PM step, as ``Simulation.run``'s loop takes it."""
    if sim.cfg.split_gravity_timesteps and sim.cfg.tree_grav_on:
        return sim.step_hierarchical(dti)
    sim.step(dti)
    return 1


def episode(sim, before=None):
    """PM steps to the traffic's TimeMax (``before(sim, dti)`` ahead of
    each); stops early at a step that does not advance the time, which
    the check then judges.  Returns the number of PM steps."""
    steps = 0
    while sim.ti_current < sim.timeline.ti_end:
        t0 = sim.ti_current
        dti = pm_timestep(sim)
        if before is not None:
            before(sim, dti)
        step(sim, dti)
        steps += 1
        if sim.ti_current == t0:
            break
    return steps


def softening(cfg):
    """The tree's Plummer-equivalent softening h = 2.8 eps, eps =
    GravitySoftening x the mean DM separation (MP-Gadget's rule)."""
    eps = cfg["params"].get("GravitySoftening", 1.0 / 30.0)
    return 2.8 * eps * cfg["BoxSize"] / cfg["Ngrid"]

