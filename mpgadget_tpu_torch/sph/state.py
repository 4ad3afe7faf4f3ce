"""SPH per-particle state (sph_particle_data analog, slotsmanager.h:93-129),
PyTorch port of mpgadget_tpu/sph/state.py.

Tensors are aligned with the base ParticleData index (not slot-indexed):
a few unused rows for non-gas particles are cheaper than an indirection
on every gather.  Only allocated when gas exists.
"""

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import constants as C

NMETALS = 9     # species mass fractions (H, He, C, N, O, Ne, Mg, Si, Fe)

_DTYPES = dict(he_iii_ionized=torch.uint8)
_SHAPES = dict(hydro_accel=3, metals=NMETALS)


@dataclass
class SphData:
    entropy: torch.Tensor          # f32[N] entropic function A = P/rho^gamma
    dt_entropy: torch.Tensor       # f32[N]
    density: torch.Tensor          # f32[N] comoving
    egy_wt_density: torch.Tensor   # f32[N] pressure-entropy density
    dhsml_egy_factor: torch.Tensor  # f32[N] DhsmlEgyDensityFactor
    dhsml_density_factor: torch.Tensor  # f32[N]
    div_vel: torch.Tensor          # f32[N]
    curl_vel: torch.Tensor         # f32[N]
    max_signal_vel: torch.Tensor   # f32[N]
    hydro_accel: torch.Tensor      # f32[N,3]
    ne: torch.Tensor               # f32[N] electron abundance
    metallicity: torch.Tensor      # f32[N]
    metals: torch.Tensor           # f32[N,9] species mass fractions
    sfr: torch.Tensor              # f32[N] star formation rate
    delay_time: torch.Tensor       # f32[N] wind decoupling timer
    he_iii_ionized: torch.Tensor   # u8[N] QSO HeIII flag
    local_j21: torch.Tensor        # f32[N] excursion-set J21
    zreion: torch.Tensor           # f32[N] reionization redshift (-1)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    @classmethod
    def zeros(cls, n: int, device="cuda"):
        """Zeroed state; ne 1, primordial H/He metals (init.c:177-178),
        zreion -1."""
        fields = {}
        for f in dataclasses.fields(cls):
            shape = (n, _SHAPES[f.name]) if f.name in _SHAPES else (n,)
            fields[f.name] = torch.zeros(
                shape, dtype=_DTYPES.get(f.name, torch.float32),
                device=device)
        fields["ne"].fill_(1.0)
        fields["zreion"].fill_(-1.0)
        fields["metals"][:, 0] = C.HYDROGEN_MASSFRAC
        fields["metals"][:, 1] = 1.0 - C.HYDROGEN_MASSFRAC
        return cls(**fields)

    @classmethod
    def from_jax_numpy(cls, arrays: dict, device="cuda"):
        """Carry JAX SphData state (as numpy arrays, one per field) over
        into the port's tensors."""
        fields = {}
        for f in dataclasses.fields(cls):
            dt = _DTYPES.get(f.name, torch.float32)
            fields[f.name] = torch.as_tensor(
                np.asarray(arrays[f.name])).to(dtype=dt, device=device)
        return cls(**fields)
