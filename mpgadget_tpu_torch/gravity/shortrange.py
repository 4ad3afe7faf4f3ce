"""Short-range force window and softened gravity kernels (PyTorch).

Port of mpgadget_tpu/gravity/shortrange.py.  The TreePM force-split
window is evaluated analytically:

    u          = r / (2 * Asmth * cellsize)
    w_force(u) = erfc(u) + 2u/sqrt(pi) * exp(-u^2)
    w_pot(u)   = erfc(u)

and the softened point force below h = 2.8 * softening uses the
standard cubic-spline mass distribution (gravshort-tree.c:157-195).
"""

import torch

SQRT_PI = 1.7724538509055159


def shortrange_force_window(r, rs_inv):
    """Force window factor; rs_inv = 1/(2 Asmth cellsize)."""
    u = r * rs_inv
    return torch.special.erfc(u) + (2.0 / SQRT_PI) * u * torch.exp(-u * u)


def shortrange_pot_window(r, rs_inv):
    return torch.special.erfc(r * rs_inv)


def softened_force_factor(r, h_inv):
    """fac(r) such that F = m * fac * dx, with spline softening: 1/r^3
    outside h, the spline-softened equivalent inside."""
    u = r * h_inv
    h3_inv = h_inv * h_inv * h_inv
    rinv = torch.where(r > 0, 1.0 / torch.clamp(r, min=1e-30), 0.0)
    newton = rinv * rinv * rinv
    inner = h3_inv * (10.666666666667 + u * u * (32.0 * u - 38.4))
    us = torch.clamp(u, min=1e-30)
    outer = h3_inv * (21.333333333333 - 48.0 * u + 38.4 * u * u
                      - 10.666666666667 * (u * u * u)
                      - 0.066666666667 / (us * us * us))
    return torch.where(u >= 1.0, newton, torch.where(u < 0.5, inner, outer))


def softened_pot_factor(r, h_inv):
    """phi(r) = m * potfac; -1/r outside h, spline inside."""
    u = r * h_inv
    rinv = torch.where(r > 0, 1.0 / torch.clamp(r, min=1e-30), 0.0)
    newton = -rinv
    wp_in = -2.8 + u * u * (5.333333333333 + u * u * (6.4 * u - 9.6))
    wp_out = (-3.2 + 0.066666666667 / torch.clamp(u, min=1e-30)
              + u * u * (10.666666666667
                         + u * (-16.0 + u * (9.6 - 2.133333333333 * u))))
    return torch.where(u >= 1.0, newton,
                       h_inv * torch.where(u < 0.5, wp_in, wp_out))


def direct_shortrange_pairwise(ipos, mass, valid, boxsize, rs_inv, rcut,
                               h_inv, with_potential=True, batch=1024):
    """O(N^2) direct short-range force (grav_short_pair analog,
    gravshort-pair.c:22), the oracle of the force-accuracy tests.  Every
    pair's distance is computed; the force terms only for the pairs
    closer than rcut, summed per target in source order.

    ipos: int64[N,3] fixed-point positions in [0, 2^32).
    Returns (accel f32[N,3], potential f32[N]).
    """
    scale = float(torch.tensor(boxsize / 2.0 ** 32, dtype=torch.float32))
    n = ipos.shape[0]
    acc = torch.zeros((n, 3), dtype=torch.float32, device=ipos.device)
    pot = torch.zeros(n, dtype=torch.float32, device=ipos.device)
    for b0 in range(0, n, batch):
        blk = ipos[b0:b0 + batch]
        # the int32 view of the wrapped difference, in box ticks
        d = ((ipos[None, :, :] - blk[:, None, :] + 2 ** 31) & 0xFFFFFFFF) \
            - 2 ** 31
        d = d.to(torch.float32) * scale                      # (B, N, 3)
        r = torch.sqrt(torch.sum(d * d, dim=-1))
        near = valid[None, :] & (r > 0) & (r < rcut)
        t, j = torch.nonzero(near, as_tuple=True)
        rn = r[t, j]
        m = mass[j]
        fac = m * softened_force_factor(rn, h_inv) \
            * shortrange_force_window(rn, rs_inv)
        acc.index_add_(0, t + b0, fac[:, None] * d[t, j])
        if with_potential:
            pot.index_add_(0, t + b0, m * softened_pot_factor(rn, h_inv)
                           * shortrange_pot_window(rn, rs_inv))
    return acc, pot
