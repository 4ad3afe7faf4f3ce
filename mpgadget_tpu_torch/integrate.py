"""Drift and kick operators (KDK leapfrog pieces), PyTorch port of
mpgadget_tpu/integrate.py.

Positions are fixed-point fractions of the box carried as int64 values
in [0, 2^32): the comoving displacement vel * ddrift becomes an integer
tick increment, and the periodic wrap is ``& 0xFFFFFFFF`` after the add,
bit-identical to the uint32 overflow of the JAX package.  (This PyTorch
has no uint32 add, subtract or shift, hence int64.)
"""

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def drift(ipos, vel, ddrift, inv_box):
    """ipos += vel * ddrift (periodic). inv_box = 1/BoxSize."""
    fac = float(np.float32(ddrift) * np.float32(inv_box))
    disp_frac = vel * fac
    # frac of box -> fixed-point ticks; torch.round, like jnp.round,
    # rounds half to even.  A physical displacement is << box/2, so it
    # fits int32 as in the JAX package.
    dint = torch.round(disp_frac * 2.0 ** 32).to(torch.int32)
    return (ipos + dint.to(torch.int64)) & MASK32


def kick(vel, accel, dkick):
    """vel += accel * dkick (gravkick factor)."""
    return vel + accel * float(np.float32(dkick))
