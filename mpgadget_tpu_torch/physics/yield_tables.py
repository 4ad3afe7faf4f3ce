"""Tabulated stellar yields on (initial mass, metallicity) grids (PyTorch
port of mpgadget_tpu/physics/yield_tables.py).

The node tables are the JAX package's, copied: newly synthesised masses
(Msun) per star from the published core-collapse and AGB yield
calculations the reference interpolates (metal_return.c:9-25):

* SNII: Kobayashi, Umeda, Nomoto, Tominaga & Ohkubo 2006, ApJ 653,
  1145 -- progenitors 13..40 Msun at Z = 0, 0.004, 0.02 (E51 = 1).
* AGB: Karakas 2010, MNRAS 403, 1413 -- 1..6 Msun at
  Z = 0.0001, 0.008, 0.02.

Species order matches metal_return.SPECIES: (H, He, C, N, O, Ne, Mg, Si,
Fe).  H is identically zero (production is debited from the unprocessed
ejecta in the spread step).  The bilinear interpolation runs on tensors
of the caller's device.
"""

import numpy as np
import torch

# ---------------------------------------------------------------- SNII
# Kobayashi+06 Tables 1-3 (SNII, E51=1), newly produced masses [Msun].
SNII_MASSES = np.array([13.0, 15.0, 18.0, 20.0, 25.0, 30.0, 40.0],
                       np.float32)
SNII_Z = np.array([0.0, 0.004, 0.02], np.float32)

# values[z_index, mass_index]
_SNII = {
    # He: newly made helium grows roughly linearly with mass
    "He": [[0.45, 0.65, 0.95, 1.2, 1.7, 2.2, 3.1],
           [0.47, 0.68, 1.0, 1.2, 1.8, 2.3, 3.2],
           [0.50, 0.70, 1.0, 1.3, 1.8, 2.4, 3.3]],
    # C
    "C": [[0.075, 0.095, 0.13, 0.15, 0.21, 0.27, 0.36],
          [0.080, 0.100, 0.14, 0.16, 0.22, 0.28, 0.38],
          [0.085, 0.110, 0.15, 0.17, 0.23, 0.30, 0.42]],
    # N is mostly secondary (scales with initial Z)
    "N": [[1.0e-4, 1.5e-4, 2.0e-4, 2.5e-4, 3.5e-4, 4.5e-4, 6.0e-4],
          [0.012, 0.015, 0.019, 0.022, 0.030, 0.037, 0.052],
          [0.055, 0.068, 0.088, 0.10, 0.14, 0.17, 0.24]],
    # O dominates the alpha budget and rises steeply with mass
    "O": [[0.23, 0.41, 0.78, 1.1, 2.1, 3.2, 5.8],
          [0.22, 0.40, 0.77, 1.1, 2.0, 3.1, 5.6],
          [0.20, 0.38, 0.73, 1.0, 1.9, 2.9, 5.3]],
    "Ne": [[0.07, 0.14, 0.29, 0.42, 0.83, 1.3, 2.4],
           [0.07, 0.14, 0.28, 0.41, 0.81, 1.3, 2.3],
           [0.07, 0.13, 0.27, 0.39, 0.77, 1.2, 2.2]],
    "Mg": [[0.02, 0.04, 0.08, 0.11, 0.20, 0.30, 0.55],
           [0.02, 0.04, 0.08, 0.11, 0.20, 0.30, 0.54],
           [0.02, 0.04, 0.08, 0.10, 0.19, 0.29, 0.52]],
    "Si": [[0.06, 0.08, 0.10, 0.12, 0.17, 0.22, 0.33],
           [0.06, 0.08, 0.10, 0.12, 0.17, 0.22, 0.33],
           [0.06, 0.08, 0.11, 0.12, 0.17, 0.23, 0.34]],
    # Fe is set by the explosion (Ni56 ~ 0.07-0.09), nearly flat in M
    "Fe": [[0.072, 0.072, 0.072, 0.073, 0.074, 0.075, 0.078],
           [0.072, 0.072, 0.072, 0.073, 0.074, 0.075, 0.078],
           [0.072, 0.072, 0.073, 0.074, 0.075, 0.076, 0.080]],
}

# ----------------------------------------------------------------- AGB
# Karakas 2010, newly produced masses [Msun].
AGB_MASSES = np.array([1.0, 1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0],
                      np.float32)
AGB_Z = np.array([1e-4, 0.008, 0.02], np.float32)

_AGB = {
    # He from dredge-up, growing with mass
    "He": [[0.006, 0.02, 0.05, 0.09, 0.13, 0.22, 0.31, 0.38],
           [0.005, 0.015, 0.04, 0.07, 0.10, 0.18, 0.26, 0.33],
           [0.004, 0.012, 0.03, 0.055, 0.085, 0.15, 0.22, 0.28]],
    # C from the third dredge-up: peaks near 3 Msun, stronger at low Z;
    # suppressed above ~4 Msun by hot-bottom burning
    "C": [[0.002, 0.03, 0.08, 0.10, 0.095, 0.02, 0.004, 0.002],
          [0.001, 0.012, 0.035, 0.05, 0.055, 0.02, 0.004, 0.002],
          [0.0005, 0.005, 0.015, 0.028, 0.038, 0.022, 0.005, 0.002]],
    # N from hot-bottom burning (m >~ 4) + secondary CN processing
    "N": [[1e-4, 3e-4, 8e-4, 1.5e-3, 3e-3, 0.03, 0.055, 0.07],
          [5e-4, 1.2e-3, 2.5e-3, 4e-3, 6e-3, 0.025, 0.045, 0.06],
          [1e-3, 2.5e-3, 4.5e-3, 7e-3, 1.0e-2, 0.02, 0.038, 0.05]],
    # O: slightly produced at very low Z, mildly destroyed by HBB
    "O": [[5e-4, 2e-3, 5e-3, 7e-3, 6e-3, 1e-3, 0.0, 0.0],
          [2e-4, 5e-4, 1e-3, 1.5e-3, 1.5e-3, 5e-4, 0.0, 0.0],
          [1e-4, 2e-4, 5e-4, 8e-4, 8e-4, 3e-4, 0.0, 0.0]],
}
_AGB_ZERO = [[0.0] * len(AGB_MASSES)] * len(AGB_Z)


_ON_DEVICE = {}     # (id of a grid or table, device) -> its tensor


def _dev(arr, device):
    """A grid or table as a float32 tensor on device, copied once."""
    key = (id(arr), str(device))
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.as_tensor(np.asarray(arr, np.float32),
                                          device=device)
    return _ON_DEVICE[key]


def _interp2(mass, z, mgrid, zgrid, table):
    """Bilinear interpolation in (mass, Z), clamped at the edges (float32,
    the JAX package's operations).  mass, z: broadcastable float32
    tensors; mgrid, zgrid, table: this module's grids and a (nz, nm)
    table."""
    dev = mass.device
    tab = _dev(table, dev)
    mg = _dev(mgrid, dev)
    zg = _dev(zgrid, dev)
    mass, z = torch.broadcast_tensors(mass, z)
    im = torch.clamp(torch.searchsorted(mg, mass.contiguous(), right=True)
                     - 1, 0, len(mgrid) - 2)
    iz = torch.clamp(torch.searchsorted(zg, z.contiguous(), right=True) - 1,
                     0, len(zgrid) - 2)
    m0, m1 = mg[im], mg[im + 1]
    z0, z1 = zg[iz], zg[iz + 1]
    fm = torch.clamp((mass - m0) / torch.clamp(m1 - m0, min=1e-20), 0.0, 1.0)
    fz = torch.clamp((z - z0) / torch.clamp(z1 - z0, min=1e-20), 0.0, 1.0)
    v00 = tab[iz, im]
    v01 = tab[iz, im + 1]
    v10 = tab[iz + 1, im]
    v11 = tab[iz + 1, im + 1]
    return ((1 - fz) * ((1 - fm) * v00 + fm * v01)
            + fz * ((1 - fm) * v10 + fm * v11))


def snii_produced(mass, z):
    """dict species -> newly-produced Msun for an SNII progenitor."""
    return {k: _interp2(mass, z, SNII_MASSES, SNII_Z, v)
            for k, v in _SNII.items()}


def agb_produced(mass, z):
    """dict species -> newly-produced Msun for an AGB star."""
    out = {k: _interp2(mass, z, AGB_MASSES, AGB_Z, v)
           for k, v in _AGB.items()}
    for k in ("Ne", "Mg", "Si", "Fe"):
        out[k] = torch.zeros_like(out["He"])
    return out
