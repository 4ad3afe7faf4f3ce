"""Particle state: fixed-capacity structure of arrays (PyTorch port of
mpgadget_tpu/particles.py).

A plain dataclass of tensors on one device, with a validity mask.
Positions are fixed-point fractions of the box,
``x_internal = ipos * (BoxSize / 2^32)``, held as int64 values in
[0, 2^32) (the JAX package holds uint32; this PyTorch has no uint32
arithmetic).  ``ipos.to(torch.float32) * 2**-32`` gives the same f32 box
coordinate as the JAX ``uint32 -> f32`` conversion.

Velocity convention matches the reference: internal Vel = a^2 dx/dt.
"""

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

TYPE_DM = 1   # particle types follow the reference: 0 gas, 1 DM, ...


def pos_to_fixed(pos, boxsize):
    """Float comoving positions -> uint32 fixed point (numpy, host)."""
    frac = np.asarray(pos, dtype=np.float64) / boxsize
    frac = np.mod(frac, 1.0)
    return (frac * 2.0 ** 32).astype(np.uint32)


def fixed_to_pos(ipos, boxsize, dtype=np.float64):
    """Fixed point -> float comoving positions in [0, BoxSize) (numpy)."""
    return (np.asarray(ipos, dtype=np.float64) * (boxsize / 2.0 ** 32)
            ).astype(dtype)


_DTYPES = dict(ipos=torch.int64, vel=torch.float32, mass=torch.float32,
               ptype=torch.int32, pid=torch.int64, valid=torch.bool,
               timebin=torch.int32, timebin_hydro=torch.int32,
               grav_accel=torch.float32, grav_pm=torch.float32,
               potential=torch.float32, hsml=torch.float32,
               dt_hsml=torch.float32, slot_index=torch.int32)
_VEC3 = ("ipos", "vel", "grav_accel", "grav_pm")


@dataclass
class ParticleData:
    """Base particle arrays (all types); capacity-N fixed shapes.

    Mirrors struct particle_data (partmanager.h:9-71) minus pointers.
    """
    ipos: torch.Tensor        # int64[N,3] fixed point in [0, 2^32)
    vel: torch.Tensor         # f32[N,3] internal velocity a^2 dx/dt
    mass: torch.Tensor        # f32[N]
    ptype: torch.Tensor       # int32[N] particle type 0..5
    pid: torch.Tensor         # int64[N] unique ID
    valid: torch.Tensor       # bool[N]; False = garbage / unused slot
    timebin: torch.Tensor     # int32[N] gravity timebin
    timebin_hydro: torch.Tensor  # int32[N] hydro timebin
    grav_accel: torch.Tensor  # f32[N,3] short-range gravity accel
    grav_pm: torch.Tensor     # f32[N,3] long-range PM accel
    potential: torch.Tensor   # f32[N]
    hsml: torch.Tensor        # f32[N] smoothing length (gas/BH)
    dt_hsml: torch.Tensor     # f32[N] predicted dHsml/d(drift)
    slot_index: torch.Tensor  # int32[N] index into per-type slot arrays

    @property
    def capacity(self):
        return self.ipos.shape[0]

    @property
    def device(self):
        return self.ipos.device

    @property
    def num_valid(self):
        return int(self.valid.sum())

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    @classmethod
    def zeros(cls, n: int, device="cuda"):
        fields = {}
        for name, dt in _DTYPES.items():
            shape = (n, 3) if name in _VEC3 else (n,)
            fields[name] = torch.zeros(shape, dtype=dt, device=device)
        fields["ptype"].fill_(TYPE_DM)
        return cls(**fields)

    @classmethod
    def from_numpy(cls, pos, vel, mass, ptype, pid, boxsize,
                   capacity: Optional[int] = None, device="cuda"):
        """Build from host float arrays (IC/snapshot read path)."""
        n = len(pid)
        cap = capacity or n
        if cap < n:
            raise ValueError(f"capacity {cap} < {n} particles")
        p = cls.zeros(cap, device)

        def put(arr, dtype):
            arr = np.asarray(arr)
            out = torch.zeros((cap,) + arr.shape[1:], dtype=dtype,
                              device=device)
            out[:n] = torch.as_tensor(arr.astype(np.int64)
                                      if dtype == torch.int64 else arr,
                                      dtype=dtype).to(device)
            return out

        return p.replace(
            ipos=put(pos_to_fixed(pos, boxsize), torch.int64),
            vel=put(vel, torch.float32),
            mass=put(mass, torch.float32),
            ptype=put(ptype, torch.int32),
            pid=put(pid, torch.int64),
            valid=torch.arange(cap, device=device) < n)

    @classmethod
    def from_jax_numpy(cls, arrays: dict, device="cuda"):
        """Carry JAX ParticleData state (as numpy arrays, one per field;
        uint32 ``ipos``) over into the port's tensors."""
        fields = {}
        for name, dt in _DTYPES.items():
            arr = np.array(arrays[name],
                           dtype=np.int64 if dt == torch.int64 else None)
            fields[name] = torch.as_tensor(arr, dtype=dt).to(device)
        return cls(**fields)
