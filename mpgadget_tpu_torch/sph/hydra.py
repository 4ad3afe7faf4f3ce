"""SPH hydro force, the "second SPH loop" (libgadget/hydra.c), PyTorch
port of mpgadget_tpu/sph/hydra.py.

Pressure force in both density-entropy and pressure-entropy
(density-independent) formulations with grad-h correction terms, the
Monaghan artificial viscosity with the Balsara switch and the Gadget
viscosity limiter, signal-velocity tracking and entropy generation
(hydra.c:25-528).  Pair math runs in internal units (distances converted
from box units at entry).

One call: Morton sort, the per-level tree, target groups, each node's
hmax (ops/pairs.node_hmax), the symmetric neighbour walk (K3), then the
hydro pair sums of the hydro kernel K5 (:func:`hydro_sums`) and the
postprocess.
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import kernels as K
from .density import check_pair_inputs, group_targets, sorted_tree
from .. import kernels
from ..ops import pairs
from ..utils.constants import GAMMA, GAMMA_MINUS1

LAUNCHES = 0                   # K5 launches (not plain calls)
# K5's outputs, one float32 column each, in this order
OUTPUTS = ("accx", "accy", "accz", "dtent", "maxsig")
_REDUCERS = {"accx": "sum", "accy": "sum", "accz": "sum", "dtent": "sum",
             "maxsig": "max"}
_fn = None


@dataclass(frozen=True)
class HydroParams:
    kernel_type: int = K.QUINTIC
    art_bulk_visc: float = 0.75
    density_independent: bool = True
    density_contrast_limit: float = 100.0
    group_max: int = 32           # targets per group: one warp in K5
    leaf_list_max: int = 192      # K3's first list capacity


def pressure_pred(eom_density, entvarpred):
    """P = (EntVar * rho_eom)^gamma (hydra.c PressurePred)."""
    x = torch.clamp(entvarpred * eom_density, min=0.0)
    return x ** GAMMA


def hydro_scalars(par: HydroParams, boxsize, atime, hubble, dloga):
    """The pair function's scalars, float32 as the JAX package computes
    them (its atime, hubble and dloga are float32 on the device):
    (boxsize, fac_mu, fac_vsic_fix, hubble_a2, dloga) as Python floats
    holding float32 values."""
    a = np.float32(atime)
    h = np.float32(hubble)
    fac_mu = a ** np.float32(3 * (GAMMA - 1) / 2) / a
    fac_vsic_fix = h * a ** np.float32(3 * GAMMA_MINUS1)
    hubble_a2 = h * a * a
    return tuple(float(np.float32(x)) for x in
                 (boxsize, fac_mu, fac_vsic_fix, hubble_a2, dloga))


def _hydro_pair_fn(par: HydroParams, scalars):
    """The JAX package's pair function; sources that are not valid gas
    contribute nothing."""
    ktype = par.kernel_type
    L, fac_mu, fac_vsic_fix, hubble_a2, dloga = scalars

    def fn(dx, r, tmask, smask, tfeat, sfeat):
        ri = r * L
        hi = tfeat["hsml"]
        hj = sfeat["hsml"]
        in_i = ri < hi
        in_j = ri < hj
        act = (in_i | in_j) & (ri > 0) & sfeat["valid"]
        hic = torch.clamp(hi, min=1e-30)
        hjc = torch.clamp(hj, min=1e-30)
        dwk_i = torch.where(in_i, K.kernel_dwk(ri / hic, 1.0 / hic, ktype),
                            0.0)
        dwk_j = torch.where(in_j, K.kernel_dwk(ri / hjc, 1.0 / hjc, ktype),
                            0.0)

        mj = sfeat["mass"]
        P_j = sfeat["pressure"]
        eom_j = torch.clamp(sfeat["eomdensity"], min=1e-30)
        rho_j = torch.clamp(sfeat["density"], min=1e-30)
        p_over_rho2_j = P_j / (eom_j * eom_j)
        cs_j = torch.sqrt(GAMMA * P_j / eom_j)
        cs_i = tfeat["soundspeed"]

        dv = tfeat["velpred"] - sfeat["velpred"]
        dist = -dx * L
        vdotr = (dist[..., 0] * dv[..., 0] + dist[..., 1] * dv[..., 1]
                 + dist[..., 2] * dv[..., 2])
        vdotr2 = vdotr + hubble_a2 * ri * ri

        vsig_pair = cs_i + cs_j

        # artificial viscosity (Gadget-2 paper eq 13-14)
        rinv = torch.where(ri > 0, 1.0 / torch.clamp(ri, min=1e-30), 0.0)
        mu_ij = fac_mu * vdotr2 * rinv
        rho_ij = 0.5 * (tfeat["density"] + rho_j)
        vsig_visc = cs_i + cs_j - 3.0 * mu_ij
        f2 = torch.abs(sfeat["divvel"]) / (
            torch.abs(sfeat["divvel"]) + sfeat["curlvel"]
            + 0.0001 * cs_j / fac_mu / hjc)
        visc = (0.25 * par.art_bulk_visc * vsig_visc * (-mu_ij)
                / torch.clamp(rho_ij, min=1e-30) * (tfeat["f1"] + f2))
        # viscosity limiter (hydra.c:462-472)
        mi = tfeat["mass"]
        denom = 0.5 * (mi + mj) * (dwk_i + dwk_j) * ri * (2 * dloga)
        cap = 0.5 * fac_vsic_fix * vdotr2 / torch.where(
            torch.abs(denom) > 0, denom, -1e30)
        if dloga > 0:
            visc = torch.where((dwk_i + dwk_j) < 0,
                               torch.minimum(visc, cap), visc)
        visc = torch.where(vdotr2 < 0, visc, 0.0)
        vsig = torch.where(vdotr2 < 0, torch.maximum(vsig_pair, vsig_visc),
                           vsig_pair)

        hfc_visc = 0.5 * mj * visc * (dwk_i + dwk_j) * rinv
        hfc = hfc_visc
        ev_i = torch.clamp(tfeat["entvarpred"], min=1e-30)
        ev_j = torch.clamp(sfeat["entvarpred"], min=1e-30)
        if par.density_independent:
            # pressure-entropy leading term (hydra.c:478-486)
            hfc = hfc + mj * (
                dwk_i * tfeat["p_over_rho2"] * ev_j / ev_i
                + dwk_j * p_over_rho2_j * ev_i / ev_j) * rinv
            if par.density_contrast_limit >= 0:
                rr1 = tfeat["egyrho"] / torch.clamp(tfeat["density"],
                                                    min=1e-30)
                rr2 = eom_j / rho_j
                if par.density_contrast_limit > 0:
                    rr1 = torch.clamp(rr1, max=par.density_contrast_limit)
                    rr2 = torch.clamp(rr2, max=par.density_contrast_limit)
            else:
                rr1 = rr2 = 0.0
        else:
            rr1 = rr2 = 1.0
        # grad-h corrected Lagrangian term (hydra.c:497-500)
        hfc = hfc + mj * (
            tfeat["p_over_rho2"] * tfeat["dhsml"] * dwk_i * rr1
            + p_over_rho2_j * sfeat["dhsml"] * dwk_j * rr2) * rinv

        hfc = torch.where(act, hfc, 0.0)
        hfc_visc = torch.where(act, hfc_visc, 0.0)
        return {
            "accx": -hfc * dist[..., 0],
            "accy": -hfc * dist[..., 1],
            "accz": -hfc * dist[..., 2],
            "dtent": 0.5 * hfc_visc * vdotr2,
            "maxsig": torch.where(act, vsig, -float("inf")),
        }
    return fn


# K5's source table columns (float32[n, 16]) and target table columns
# (float32[n, 8]); the target's own position, hsml, velpred, density,
# entvarpred and dhsml come from its source row
SRC_COLUMNS = ("x", "y", "z", "mass", "vx", "vy", "vz", "hsml", "density",
               "eomdensity", "pressure", "divvel", "curlvel", "entvarpred",
               "dhsml", "pad")
TGT_COLUMNS = ("mass", "soundspeed", "f1", "p_over_rho2", "egyrho", "pad0",
               "pad1", "pad2")


def pack_hydro_inputs(pos_box, valid_s, velpred, cols):
    """K5's particle tables in sorted order: src float32[n, 16]
    (:data:`SRC_COLUMNS`: position in box units, velpred and the columns
    of ``cols`` by name, mass 0 where not valid), tgt float32[n, 8]
    (:data:`TGT_COLUMNS` from ``cols``, "mass" as given) and valid
    uint8[n].  cols: float32[n] tensors named as the table columns."""
    zero = torch.zeros_like(pos_box[:, 0])
    named = dict(cols, x=pos_box[:, 0], y=pos_box[:, 1], z=pos_box[:, 2],
                 vx=velpred[:, 0], vy=velpred[:, 1], vz=velpred[:, 2])
    src = torch.stack([torch.where(valid_s, cols["mass"], 0.0)
                       if k == "mass" else named.get(k, zero)
                       for k in SRC_COLUMNS], dim=1)
    tgt = torch.stack([named.get(k, zero) for k in TGT_COLUMNS], dim=1)
    return src, tgt, valid_s.to(torch.uint8)


def hydro_sums_reference(tree, nbr, src, tgt, valid, par: HydroParams,
                         scalars):
    """Plain version of K5: the JAX pair function over every (target,
    source) pair of the neighbour lists, through ops/pairs.pair_reduce.
    Returns float32[n, 5] (columns :data:`OUTPUTS`) in sorted order: 0
    (maxsig -inf) for particles of no group or of a group with no list."""
    listed = nbr.leaf_idx[nbr.n_leaves > 0]
    le = int(tree.pcount[torch.clamp(listed.to(torch.int64),
                                     max=tree.capacity - 1)].max()) \
        if listed.numel() else 1
    col = {k: src[:, i] for i, k in enumerate(SRC_COLUMNS)}
    tcol = {k: tgt[:, i] for i, k in enumerate(TGT_COLUMNS)}
    velpred = src[:, 4:7]
    target_feats = {
        "hsml": col["hsml"], "velpred": velpred, "mass": tcol["mass"],
        "density": col["density"], "soundspeed": tcol["soundspeed"],
        "f1": tcol["f1"], "p_over_rho2": tcol["p_over_rho2"],
        "entvarpred": col["entvarpred"], "egyrho": tcol["egyrho"],
        "dhsml": col["dhsml"]}
    source_feats = {
        "hsml": col["hsml"], "velpred": velpred, "mass": col["mass"],
        "density": col["density"], "eomdensity": col["eomdensity"],
        "pressure": col["pressure"], "divvel": col["divvel"],
        "curlvel": col["curlvel"], "entvarpred": col["entvarpred"],
        "dhsml": col["dhsml"], "valid": valid.bool()}
    out = pairs.pair_reduce(
        _hydro_pair_fn(par, scalars), nbr, tree, src[:, :3].contiguous(),
        target_feats, source_feats, _REDUCERS, par.group_max, max(le, 1))
    return torch.stack([out[k] for k in OUTPUTS], dim=1)


def _kernel():
    global _fn
    if _fn is None:
        fn = kernels.load("sph_hydro").sph_hydro_f32
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 7 + [ctypes.c_void_p])
        _fn = fn
    return _fn


def _contrast_mode(par):
    """K5's formulation: 0 density-entropy; pressure-entropy with the
    density contrast limited (1), unlimited (2, limit 0) or without the
    grad-h factors' contrast terms (3, limit < 0)."""
    if not par.density_independent:
        return 0
    if par.density_contrast_limit > 0:
        return 1
    return 2 if par.density_contrast_limit == 0 else 3


def hydro_kernel(tree, nbr, src, tgt, valid, par: HydroParams, scalars):
    """One launch of K5 (``csrc/sph_hydro.cu``) on CUDA tensors, no
    synchronisation; same contract as :func:`hydro_sums_reference`.
    Rows of groups with no list are never written: they keep the fill
    the output is allocated with."""
    global LAUNCHES
    n = src.shape[0]
    pstart, pcount = check_pair_inputs(
        tree, nbr, [("src", src, len(SRC_COLUMNS), torch.float32),
                    ("tgt", tgt, len(TGT_COLUMNS), torch.float32),
                    ("valid", valid, None, torch.uint8)], par.group_max)
    if par.kernel_type not in (K.CUBIC, K.QUINTIC, K.QUARTIC):
        raise ValueError(f"unknown kernel type {par.kernel_type}")
    ng, LL = nbr.leaf_idx.shape
    out = torch.zeros((n, len(OUTPUTS)), dtype=torch.float32,
                      device=src.device)
    out[:, 4] = -float("inf")
    L, fac_mu, fac_vsic_fix, hubble_a2, dloga = scalars
    fn = _kernel()
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), valid.data_ptr(), tgt.data_ptr(),
                pstart.data_ptr(), pcount.data_ptr(),
                nbr.group_nodes.data_ptr(), nbr.leaf_idx.data_ptr(),
                nbr.n_leaves.data_ptr(), out.data_ptr(), ng, LL,
                int(par.group_max), int(par.kernel_type),
                _contrast_mode(par), L, fac_mu, fac_vsic_fix, hubble_a2,
                dloga, float(par.art_bulk_visc),
                float(par.density_contrast_limit),
                torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hydro kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def hydro_sums(tree, nbr, src, tgt, valid, par: HydroParams, scalars):
    """The hydro pair sums of every target of every listed group: K5 on
    CUDA tensors (or raise), its plain version on CPU tensors."""
    if src.device.type == "cpu":
        return hydro_sums_reference(tree, nbr, src, tgt, valid, par, scalars)
    return hydro_kernel(tree, nbr, src, tgt, valid, par, scalars)


def hydro_force(ipos, mass, valid_gas, hsml, velpred, entvarpred, density,
                egy_wt_density, div_vel, curl_vel, dhsml_egy_factor,
                par: HydroParams, boxsize, atime, hubble, dloga):
    """Hydro accelerations + DtEntropy + MaxSignalVel for gas particles.

    All inputs in internal units, input particle order.  Returns a dict
    in the input order: hydro_accel [N,3], dt_entropy [N] (entropy units
    per dloga), max_signal_vel [N], pressure [N].
    """
    n = ipos.shape[0]
    G = par.group_max
    perm, inv, pos_box, valid_s, tree, (nodes, gc, gh) = sorted_tree(
        ipos, mass, valid_gas, G)
    # hmax per node for the symmetric search (the JAX package's leaf
    # capacity, which exceeds the tree's below ~200 particles: no tree
    # holds more leaves than nodes)
    leaf_ids, n_leaves, _ = pairs.compact_leaves(
        tree, min(4 * min((8 * n) // G + 64, n + 64), tree.capacity))
    inv_box = float(np.float32(1.0 / boxsize))
    hmax = pairs.node_hmax(tree, leaf_ids, n_leaves,
                           torch.where(valid_s, hsml[perm], 0.0) * inv_box)

    scalars = hydro_scalars(par, boxsize, atime, hubble, dloga)
    fac_mu = scalars[1]
    hubble_a2 = scalars[3]
    eomdensity = egy_wt_density if par.density_independent else density
    pressure = pressure_pred(eomdensity, entvarpred)
    eom_c = torch.clamp(eomdensity, min=1e-30)
    cs = torch.sqrt(GAMMA * pressure / eom_c)
    f1 = torch.abs(div_vel) / (torch.abs(div_vel) + curl_vel
                               + 0.0001 * cs / torch.clamp(hsml, min=1e-30)
                               / fac_mu)
    p_over_rho2 = pressure / eom_c ** 2

    def s(x):
        return x[perm]

    src, tgt, valid = pack_hydro_inputs(pos_box, valid_s, s(velpred), dict(
        mass=s(mass), hsml=s(hsml), density=s(density),
        eomdensity=s(eomdensity), pressure=s(pressure), divvel=s(div_vel),
        curlvel=s(curl_vel), entvarpred=s(entvarpred),
        dhsml=s(dhsml_egy_factor), soundspeed=s(cs), f1=s(f1),
        p_over_rho2=s(p_over_rho2), egyrho=s(egy_wt_density)))

    tidx, tm = group_targets(tree, nodes, n, G)
    hsml_box = s(hsml) * inv_box
    gradius = torch.where(tm, hsml_box[tidx], 0.0).max(dim=1).values
    nbr, _ = pairs.find_neighbors_auto(
        tree, nodes, gc, gh, gradius, hmax, par.leaf_list_max,
        symmetric=True, cache_key=("hydra", n))
    out = hydro_sums(tree, nbr, src, tgt, valid, par, scalars)

    accel = out[:, :3][inv]
    # entropy change rate (hydro_postprocess, hydra.c:516-527)
    dtent = out[:, 3][inv] * GAMMA_MINUS1 / (
        hubble_a2 * torch.clamp(density, min=1e-30) ** GAMMA_MINUS1)
    maxsig = out[:, 4][inv]
    maxsig = torch.where(torch.isfinite(maxsig), maxsig, 0.0)
    accel = torch.where(valid_gas[:, None], accel, 0.0)
    dtent = torch.where(valid_gas, dtent, 0.0)
    return {"hydro_accel": accel, "dt_entropy": dtent,
            "max_signal_vel": maxsig, "pressure": pressure}
