"""SPH smoothing kernels (Price 2011, arXiv:1012.1885 conventions),
PyTorch port of mpgadget_tpu/sph/kernels.py.

Matches libgadget/densitykernel.c: H is the support radius ("big H");
wk(u) with u = r/H; cubic (support 2h), quartic (2.5h), quintic (3h)
splines with the same normalizations.  Branch-free tensor functions of
float32 tensors.  ``csrc/sph_kernels.cuh`` holds the same polynomials as
device functions for the pair kernels K4 and K5.
"""

import numpy as np
import torch

CUBIC = 1
QUINTIC = 2
QUARTIC = 4

NORM_COEFF = 4.0 / 3 * np.pi  # volume of unit sphere

_SUPPORT = {CUBIC: 2.0, QUINTIC: 3.0, QUARTIC: 2.5}
_SIGMA3 = {CUBIC: 1.0 / np.pi, QUINTIC: 1.0 / (120 * np.pi),
           QUARTIC: 1.0 / (20 * np.pi)}


def _pos(x):
    return torch.clamp(x, min=0.0)


def _wk_cubic(q):
    return 0.25 * _pos(2.0 - q) ** 3 - _pos(1.0 - q) ** 3


def _dwk_cubic(q):
    return -0.75 * _pos(2.0 - q) ** 2 + 3.0 * _pos(1.0 - q) ** 2


def _wk_quartic(q):
    return (_pos(2.5 - q) ** 4 - 5 * _pos(1.5 - q) ** 4
            + 10 * _pos(0.5 - q) ** 4)


def _dwk_quartic(q):
    return (-4 * _pos(2.5 - q) ** 3 + 20 * _pos(1.5 - q) ** 3
            - 40 * _pos(0.5 - q) ** 3)


def _wk_quintic(q):
    return (_pos(3.0 - q) ** 5 - 6 * _pos(2.0 - q) ** 5
            + 15 * _pos(1.0 - q) ** 5)


def _dwk_quintic(q):
    return (-5 * _pos(3.0 - q) ** 4 + 30 * _pos(2.0 - q) ** 4
            - 75 * _pos(1.0 - q) ** 4)


_WK = {CUBIC: _wk_cubic, QUINTIC: _wk_quintic, QUARTIC: _wk_quartic}
_DWK = {CUBIC: _dwk_cubic, QUINTIC: _dwk_quintic, QUARTIC: _dwk_quartic}


def kernel_wk(u, hinv, ktype=QUINTIC):
    """W(r, H) = sigma/h^3 * w(q), q = u * support; u = r/H.
    hinv = 1/H (may be a tensor)."""
    s = _SUPPORT[ktype]
    norm = _SIGMA3[ktype] * (hinv * s) ** 3
    return norm * _WK[ktype](u * s)


def kernel_dwk(u, hinv, ktype=QUINTIC):
    """dW/dr; u = r/H."""
    s = _SUPPORT[ktype]
    norm = _SIGMA3[ktype] * (hinv * s) ** 3 * (hinv * s)
    return norm * _DWK[ktype](u * s)


def kernel_dW(u, wk, dwk, hinv):
    """-(3 W/H + u dW/du...) : d(rho)/dH contribution per neighbor
    (densitykernel.h:47-50)."""
    return -(3.0 * hinv * wk + u * dwk)


def kernel_volume(H, ktype=QUINTIC):
    return NORM_COEFF * H ** 3


def desnumngb(eta, ktype=QUINTIC):
    """Expected neighbor count for resolution eta (Price eq 12;
    densitykernel.c:124-131)."""
    return NORM_COEFF * (_SUPPORT[ktype] * eta) ** 3
