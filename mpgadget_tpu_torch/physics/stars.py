"""Per-particle star state (star_particle_data analog,
slotsmanager.h:76-90), PyTorch port of mpgadget_tpu/physics/stars.py.

Tensors are aligned with the base ParticleData index like SphData.  Metal
species order follows the reference (metal_tables.h:5): H, He, C, N, O,
Ne, Mg, Si, Fe.
"""

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import constants as C

NMETALS = 9


@dataclass
class StarData:
    formation_time: torch.Tensor      # f32[N] scale factor at birth
    birth_density: torch.Tensor       # f32[N] gas density at formation
    metallicity: torch.Tensor         # f32[N] total metal mass fraction
    metals: torch.Tensor              # f32[N,9] metal mass per species
    total_mass_returned: torch.Tensor  # f32[N] cumulative mass returned
    last_enrichment_myr: torch.Tensor  # f32[N] age of last enrichment
    vdisp: torch.Tensor               # f32[N] DM vel disp at formation

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    @classmethod
    def zeros(cls, n: int, device="cuda"):
        fields = {f.name: torch.zeros(
            (n, NMETALS) if f.name == "metals" else (n,),
            dtype=torch.float32, device=device)
            for f in dataclasses.fields(cls)}
        return cls(**fields)

    @classmethod
    def from_jax_numpy(cls, arrays: dict, device="cuda"):
        """Carry JAX StarData state (as numpy arrays, one per field) over
        into the port's tensors."""
        return cls(**{f.name: torch.as_tensor(
            np.asarray(arrays[f.name], np.float32)).to(device)
            for f in dataclasses.fields(cls)})


def primordial_metals(n: int, device="cuda"):
    """Initial gas Metals fractions: primordial H/He, zero metals
    (init.c:177-178)."""
    metals = torch.zeros((n, NMETALS), dtype=torch.float32, device=device)
    metals[:, 0] = C.HYDROGEN_MASSFRAC
    metals[:, 1] = 1.0 - C.HYDROGEN_MASSFRAC
    return metals
