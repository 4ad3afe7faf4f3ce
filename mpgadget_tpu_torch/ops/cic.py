"""Cloud-in-cell deposit and readout on a periodic mesh (PyTorch port of
mpgadget_tpu/ops/cic.py).

With fixed-point positions the cell index and intra-cell fraction are an
exact shift/mask; the deposit is an ``index_add_`` over the flattened
mesh (cell = (ix*n + iy)*n + iz), the readout a gather.
"""

import torch


def _cell_frac_col(x, nmesh: int):
    """(cell int64[N], frac f32[N]) for ONE coordinate column of int64
    fixed-point positions in [0, 2^32)."""
    if nmesh & (nmesh - 1) == 0:
        shift = 32 - (int(nmesh).bit_length() - 1)
        cell = x >> shift
        frac = (x & ((1 << shift) - 1)).to(torch.float32) \
            * (1.0 / (1 << shift))
    else:
        # exact fixed-point multiply: x * nmesh < 2^32 * nmesh fits int64
        scaled = x * nmesh
        cell = scaled >> 32
        frac = (scaled & 0xFFFFFFFF).to(torch.float32) * 2.0 ** -32
    return cell, frac


def _corner_indices_weights(ipos, nmesh: int):
    """Yield (flat_index int64[N], weight f32[N]) for the 8 CIC corners."""
    (cx, fx) = _cell_frac_col(ipos[:, 0], nmesh)
    (cy, fy) = _cell_frac_col(ipos[:, 1], nmesh)
    (cz, fz) = _cell_frac_col(ipos[:, 2], nmesh)
    n = nmesh
    for dx in (0, 1):
        wx = (1.0 - fx) if dx == 0 else fx
        ix = (cx + dx) % n
        for dy in (0, 1):
            wy = (1.0 - fy) if dy == 0 else fy
            iy = (cy + dy) % n
            for dz in (0, 1):
                wz = (1.0 - fz) if dz == 0 else fz
                iz = (cz + dz) % n
                yield (ix * n + iy) * n + iz, wx * wy * wz


def cic_deposit(ipos, weights, nmesh: int):
    """Scatter-add particle weights onto a periodic nmesh^3 mesh.

    weights: f32[N] (set 0 for invalid particles).
    """
    flat = torch.zeros(nmesh ** 3, dtype=torch.float32, device=ipos.device)
    for idx, w in _corner_indices_weights(ipos, nmesh):
        flat.index_add_(0, idx, weights * w)
    return flat.reshape(nmesh, nmesh, nmesh)


def cic_readout(mesh, ipos):
    """Trilinear (CIC) interpolation of mesh values at particle positions."""
    nmesh = mesh.shape[0]
    flatm = mesh.reshape(-1)
    out = torch.zeros(ipos.shape[0], dtype=mesh.dtype, device=mesh.device)
    for idx, w in _corner_indices_weights(ipos, nmesh):
        out = out + flatm[idx] * w
    return out


def cic_readout_vec(meshes, ipos):
    """CIC interpolation of k stacked meshes (nmesh, nmesh, nmesh, k) at
    particle positions in one gather pass; returns [N, k]."""
    nmesh = meshes.shape[0]
    k = meshes.shape[-1]
    flatm = meshes.reshape(-1, k)
    out = torch.zeros((ipos.shape[0], k), dtype=meshes.dtype,
                      device=meshes.device)
    for idx, w in _corner_indices_weights(ipos, nmesh):
        out = out + flatm[idx] * w[:, None]
    return out
