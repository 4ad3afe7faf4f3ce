"""Plain PyTorch TreePM forces: the particle-mesh long-range force and the
exact short-range pair sum, as MP-Gadget defines them (gravpm.c,
petapm.c, gravshort-tree.c, gravshort-pair.c), written anew from those
definitions.  It imports nothing of the program.

``dtype`` is float64 for the reference.  ``low=True`` gives the control:
the same sums with every stored and computed value rounded to bfloat16
(the FFT itself runs in float32 on bfloat16-rounded inputs, since
cuFFT has no bfloat16), which is the precision one step below the
float32 the program computes in.
"""

import math

import torch

TICKS = 2.0 ** 32


def _rnd(x, low):
    """Round to bfloat16 and back when low, else leave x."""
    if not low:
        return x
    if x.is_complex():
        return torch.complex(_rnd(x.real, True), _rnd(x.imag, True))
    return x.to(torch.bfloat16).to(x.dtype)


def _corners(ipos, nmesh, dtype):
    """(flat index, weight) of the 8 cloud-in-cell corners."""
    x = ipos.to(torch.float64) * (nmesh / TICKS)
    cell = torch.floor(x)
    frac = (x - cell).to(dtype)
    cell = cell.to(torch.int64)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                     * (frac[:, 1] if dy else 1 - frac[:, 1])
                     * (frac[:, 2] if dz else 1 - frac[:, 2]))
                i = (cell[:, 0] + dx) % nmesh
                j = (cell[:, 1] + dy) % nmesh
                k = (cell[:, 2] + dz) % nmesh
                yield (i * nmesh + j) * nmesh + k, w


def pm_accel(ipos, mass, rows, nmesh, box, G, asmth, low=False,
             dtype=torch.float64, chunk=1 << 22):
    """Long-range acceleration at ipos[rows]: cloud-in-cell deposit of
    the masses, the Green's function -4 pi G / k^2 with the Gaussian
    split exp(-k^2 r_s^2), r_s = asmth x the cell, and the CIC window
    divided out twice, MP-Gadget's fourth-order difference
    i (8 sin w - sin 2w) / 6 for the gradient, and a CIC readout."""
    dev = ipos.device
    store = torch.bfloat16 if low else dtype
    mesh = torch.zeros(nmesh ** 3, dtype=store, device=dev)
    for c0 in range(0, ipos.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        m = mass[sl].to(dtype)
        for idx, w in _corners(ipos[sl], nmesh, dtype):
            mesh.index_add_(0, idx, (m * w).to(store))
    fdt = torch.float32 if low else dtype
    rho_k = torch.fft.rfftn(mesh.to(fdt).reshape(nmesh, nmesh, nmesh))
    del mesh
    kx = torch.fft.fftfreq(nmesh, 1.0 / nmesh, device=dev).to(fdt)
    kz = torch.arange(nmesh // 2 + 1, device=dev).to(fdt)
    kv = (kx[:, None, None], kx[None, :, None], kz[None, None, :])
    k2 = kv[0] ** 2 + kv[1] ** 2 + kv[2] ** 2
    deconv = 1.0
    for k in kv:
        x = k * (math.pi / nmesh)
        s = torch.where(x == 0, 1.0, torch.sin(x) / torch.where(
            x == 0, 1.0, x))
        deconv = deconv / (s * s)
    # potential = -G/(pi L) x N^3 / k^2 in mode units (the N^3 undoes the
    # inverse transform's normalisation)
    green = (-G * nmesh ** 3 / (math.pi * box)) * torch.exp(
        -k2 * (2 * math.pi * asmth / nmesh) ** 2) / torch.where(
        k2 == 0, 1.0, k2) * deconv * deconv
    pot_k = _rnd(rho_k * torch.where(k2 == 0, 0.0, green), low)
    del rho_k, green
    sub = ipos[rows]
    out = []
    for k in kv:
        w = k * (2 * math.pi / nmesh)
        d = -(8 * torch.sin(w) - torch.sin(2 * w)) / 6 * (nmesh / box)
        f = _rnd(torch.fft.irfftn(pot_k * (1j * d), s=(nmesh,) * 3), low)
        flat = f.reshape(-1).to(store)
        acc = torch.zeros(sub.shape[0], dtype=store, device=dev)
        for idx, wt in _corners(sub, nmesh, dtype):
            acc = acc + flat[idx] * wt.to(store)
        out.append(acc.to(dtype))
        del f, flat
    return torch.stack(out, dim=1)


def force_factor(r, h):
    """MP-Gadget's softened 1/r^3 (the cubic-spline mass of radius
    h = 2.8 eps inside h, Newton outside)."""
    u = r / h
    newton = 1.0 / (r * r * r)
    inner = (10.666666666667 + u * u * (32.0 * u - 38.4)) / h ** 3
    us = torch.clamp(u, min=1e-30)
    outer = (21.333333333333 - 48.0 * u + 38.4 * u * u
             - 10.666666666667 * u * u * u
             - 0.066666666667 / (us * us * us)) / h ** 3
    return torch.where(u >= 1, newton, torch.where(u < 0.5, inner, outer))


def split_window(r, rs):
    """The short-range part of the force split, u = r / (2 r_s):
    erfc(u) + 2u/sqrt(pi) exp(-u^2)."""
    u = r / (2 * rs)
    return torch.special.erfc(u) + (2 / math.sqrt(math.pi)) * u \
        * torch.exp(-u * u)


class CellList:
    """Particles sorted by cubic cells at least `reach` wide, so that
    every neighbour within reach of a point lies in its 27 cells."""

    def __init__(self, ipos, box, reach):
        self.nc = max(3, int(box // reach))
        nc = self.nc
        cell = (ipos * nc) >> 32
        key = (cell[:, 0] * nc + cell[:, 1]) * nc + cell[:, 2]
        key, self.order = torch.sort(key)
        edges = torch.arange(nc ** 3 + 1, device=ipos.device)
        self.start = torch.searchsorted(key, edges)
        self.ipos = ipos[self.order]

    def neighbours(self, tpos):
        """(target index, particle index into the sorted arrays; ``order``
        maps it back) of every particle in the 27 cells around each
        target."""
        nc = self.nc
        c = (tpos * nc) >> 32
        off = torch.tensor([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                            for k in (-1, 0, 1)], device=tpos.device)
        cc = (c[:, None, :] + off[None]) % nc                  # (T, 27, 3)
        key = (cc[..., 0] * nc + cc[..., 1]) * nc + cc[..., 2]
        s, e = self.start[key], self.start[key + 1]
        cnt = (e - s).reshape(-1)
        tgt = torch.repeat_interleave(
            torch.arange(tpos.shape[0], device=tpos.device).repeat_interleave(
                27), cnt)
        base = torch.repeat_interleave(s.reshape(-1), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        idx = base + torch.arange(cnt.sum(), device=tpos.device) \
            - torch.repeat_interleave(first, cnt)
        return tgt, idx


def shortrange_accel(ipos, mass, rows, box, G, rs, rcut, h, low=False,
                     dtype=torch.float64, cells=None, max_pairs=1 << 24):
    """The exact short-range acceleration at ipos[rows]: every particle
    closer than rcut, G m (x_j - x_i) times the softened 1/r^3 times the
    split window.  Pair separations are taken exactly from the fixed-
    point positions (periodic wrap in ticks)."""
    dev = ipos.device
    cells = cells or CellList(ipos, box, rcut)
    work = torch.bfloat16 if low else dtype
    sm = mass[cells.order].to(dtype)
    rows = torch.as_tensor(rows, device=dev)
    out = torch.zeros((rows.shape[0], 3), dtype=dtype, device=dev)
    tpos = ipos[rows]
    # targets in chunks small enough that their pairs fit max_pairs
    nc = cells.nc
    c = (tpos * nc) >> 32
    per = torch.zeros(rows.shape[0], dtype=torch.int64, device=dev)
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            for k in (-1, 0, 1):
                cc = (c + torch.tensor([i, j, k], device=dev)) % nc
                key = (cc[:, 0] * nc + cc[:, 1]) * nc + cc[:, 2]
                per += cells.start[key + 1] - cells.start[key]
    csum = torch.cumsum(per, 0).cpu()
    t0 = 0
    while t0 < rows.shape[0]:
        base = int(csum[t0 - 1]) if t0 else 0
        t1 = int(torch.searchsorted(csum, base + max_pairs, right=True))
        t1 = max(t1, t0 + 1)
        tgt, idx = cells.neighbours(tpos[t0:t1])
        d = cells.ipos[idx] - tpos[t0:t1][tgt]
        d = ((d + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31
        d = d.to(dtype) * (box / TICKS)
        d = _rnd(d, low).to(work)
        r = torch.sqrt(torch.sum(d * d, dim=1))
        keep = (r > 0) & (r < rcut)
        r, d, tgt, idx = r[keep], d[keep], tgt[keep], idx[keep]
        fac = G * sm[idx].to(work) * force_factor(r, h) * split_window(
            r.to(dtype), rs).to(work)
        # the control sums its bfloat16 pair terms in float32
        acc = torch.zeros((t1 - t0, 3), dtype=torch.float32 if low
                          else dtype, device=dev)
        acc.index_add_(0, tgt, (fac[:, None] * d).to(acc.dtype))
        out[t0:t1] = acc.to(dtype)
        t0 = t1
    return out
