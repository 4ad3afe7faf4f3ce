"""SPH density loop with adaptive smoothing lengths (PyTorch port of
mpgadget_tpu/sph/density.py).

The reference's "first SPH loop" (libgadget/density.c): for every gas
particle, kernel-weighted density, DhsmlDensityFactor (grad-h term),
velocity divergence/curl, and the pressure-entropy EgyWtDensity; the
smoothing length is bisected until the effective neighbour number hits
DesNumNgb +- MaxNumNgbDeviation (treewalk_do_hsml_loop analog,
density.c:591-660).

One solve: Morton sort, the per-level tree (gravity/tree.build_tree),
target groups, then the bisection as a host loop of at most ``max_iter``
passes.  Each pass walks the tree (K3, ops/pairs.find_neighbors) for the
groups that still hold an unconverged target (radius 0 for the others:
their walk lists nothing) and sums their pairs with the density kernel
K4 (:func:`density_sums`), then decides "all converged" with one read
from the device.  The JAX package runs the same loop as one
``lax.while_loop`` on the device.
"""

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import kernels as K
from .. import kernels
from ..ops import pairs
from ..ops.morton import KEY_PAD, morton_key, sort_order
from ..gravity.tree import build_tree
from ..gravity.treewalk import make_target_groups

LAUNCHES = 0                   # K4 launches (not plain calls)
# K4's outputs, one float32 column each, in this order
OUTPUTS = ("ngb", "rho", "dhsml", "egyrho", "dhsmlegy", "div", "rotx",
           "roty", "rotz")
_fn = None


@dataclass(frozen=True)
class DensityParams:
    kernel_type: int = K.QUINTIC
    eta: float = 1.0              # DensityResolutionEta
    max_ngb_deviation: float = 2.0
    min_hsml: float = 0.0
    max_iter: int = 40
    group_max: int = 32           # targets per group: one warp in K4/K5
    leaf_list_max: int = 192      # K3's first list capacity

    @property
    def desnumngb(self):
        return K.desnumngb(self.eta, self.kernel_type)


def _density_pair_fn(ktype):
    """The JAX package's pair function; sources that are not valid gas
    contribute nothing."""
    def fn(dx, r, tmask, smask, tfeat, sfeat):
        hinv = 1.0 / torch.clamp(tfeat["hsml"], min=1e-30)
        u = r * hinv
        inside = (u < 1.0) & sfeat["valid"]
        wk = torch.where(inside, K.kernel_wk(u, hinv, ktype), 0.0)
        dwk = torch.where(inside, K.kernel_dwk(u, hinv, ktype), 0.0)
        mj = sfeat["mass"]
        # Ngb = wk * kernel volume = wk * 4/3 pi H^3
        ngb = wk * K.NORM_COEFF / torch.clamp(hinv ** 3, min=1e-30)
        dW = K.kernel_dW(u, wk, dwk, hinv)
        rinv = torch.where(r > 0, 1.0 / torch.clamp(r, min=1e-30), 0.0)
        fac = mj * dwk * rinv
        tv, sv = tfeat["vel"], sfeat["velpred"]
        dvx, dvy, dvz = (tv[..., k] - sv[..., k] for k in range(3))
        # dist in the reference convention: target - source = -dx
        ux, uy, uz = (-dx[..., k] for k in range(3))
        div = -fac * (ux * dvx + uy * dvy + uz * dvz)
        ment = mj * sfeat["entvarpred"]
        # fac * (dv x dist)
        return {"ngb": ngb, "rho": mj * wk, "dhsml": mj * dW,
                "egyrho": ment * wk, "dhsmlegy": ment * dW, "div": div,
                "rotx": fac * (dvy * uz - dvz * uy),
                "roty": fac * (dvz * ux - dvx * uz),
                "rotz": fac * (dvx * uy - dvy * ux)}
    return fn


def pack_density_inputs(pos_box, valid_s, mass_s, velpred_s, entvar_s,
                        hsml_box, vel_s):
    """K4's particle tables in sorted order: src float32[n, 8] (x, y, z,
    mass (0 where not valid), velpred, entvarpred), tgt float32[n, 4]
    (hsml in box units, vel) and valid uint8[n]."""
    src = torch.cat([pos_box, torch.where(valid_s, mass_s, 0.0)[:, None],
                     velpred_s, entvar_s[:, None]], dim=1).contiguous()
    tgt = torch.cat([hsml_box[:, None], vel_s], dim=1).contiguous()
    return src, tgt, valid_s.to(torch.uint8).contiguous()


def density_sums_reference(tree, nbr, src, tgt, valid, ktype, group_max):
    """Plain version of K4: the JAX pair function over every (target,
    source) pair of the neighbour lists, through ops/pairs.pair_reduce.
    Returns float32[n, 9] (columns :data:`OUTPUTS`) in sorted order, 0
    for particles of no group or of a group with no list."""
    listed = nbr.leaf_idx[nbr.n_leaves > 0]
    le = int(tree.pcount[torch.clamp(listed.to(torch.int64),
                                     max=tree.capacity - 1)].max()) \
        if listed.numel() else 1
    out = pairs.pair_reduce(
        _density_pair_fn(ktype), nbr, tree, src[:, :3].contiguous(),
        {"hsml": tgt[:, 0], "vel": tgt[:, 1:4]},
        {"mass": src[:, 3], "velpred": src[:, 4:7], "entvarpred": src[:, 7],
         "valid": valid.bool()},
        {k: "sum" for k in OUTPUTS}, group_max, max(le, 1))
    return torch.stack([out[k] for k in OUTPUTS], dim=1)


def _kernel():
    global _fn
    if _fn is None:
        fn = kernels.load("sph_density").sph_density_f32
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        _fn = fn
    return _fn


def check_pair_inputs(tree, nbr, tables, group_max):
    """Raise ValueError unless the neighbour lists, the tree's particle
    ranges and the particle tables are what the SPH pair kernels (K4,
    K5) take: contiguous CUDA tensors of one device, their shapes and
    types.  tables: (name, tensor, columns or None, dtype).  Returns the
    tree's (pstart, pcount) as contiguous tensors (the tree keeps them
    as columns of one table)."""
    ng, LL = nbr.leaf_idx.shape
    C = tree.capacity
    n = tables[0][1].shape[0]
    if not 1 <= group_max <= 32:
        raise ValueError(f"group_max {group_max} outside [1, 32]")
    ranges = (tree.pstart.contiguous(), tree.pcount.contiguous())
    checks = [("leaf_idx", nbr.leaf_idx, (ng, LL), torch.int32),
              ("n_leaves", nbr.n_leaves, (ng,), torch.int32),
              ("group_nodes", nbr.group_nodes, (ng,), torch.int64),
              ("tree.pstart", ranges[0], (C,), torch.int64),
              ("tree.pcount", ranges[1], (C,), torch.int64)]
    checks += [(name, t, (n,) if cols is None else (n, cols), dt)
               for name, t, cols, dt in tables]
    dev = nbr.leaf_idx.device
    for name, t, shape, dtype in checks:
        kernels.check_tensor(name, t, shape, dtype)
        if t.device != dev:
            raise ValueError("SPH pair kernel inputs must be on one device")
    return ranges


def density_kernel(tree, nbr, src, tgt, valid, ktype, group_max):
    """One launch of K4 (``csrc/sph_density.cu``) on CUDA tensors, no
    synchronisation; same contract as :func:`density_sums_reference`.
    Rows of groups with no list are never written: they keep the zeros
    the output is allocated with."""
    global LAUNCHES
    n = src.shape[0]
    pstart, pcount = check_pair_inputs(
        tree, nbr, [("src", src, 8, torch.float32),
                    ("tgt", tgt, 4, torch.float32),
                    ("valid", valid, None, torch.uint8)], group_max)
    if ktype not in (K.CUBIC, K.QUINTIC, K.QUARTIC):
        raise ValueError(f"unknown kernel type {ktype}")
    ng, LL = nbr.leaf_idx.shape
    out = torch.zeros((n, len(OUTPUTS)), dtype=torch.float32,
                      device=src.device)
    fn = _kernel()
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), valid.data_ptr(), tgt.data_ptr(),
                pstart.data_ptr(), pcount.data_ptr(),
                nbr.group_nodes.data_ptr(), nbr.leaf_idx.data_ptr(),
                nbr.n_leaves.data_ptr(), out.data_ptr(), ng, LL,
                int(group_max), int(ktype),
                torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"density kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def density_sums(tree, nbr, src, tgt, valid, ktype, group_max):
    """The density pair sums of every target of every listed group: K4 on
    CUDA tensors (or raise), its plain version on CPU tensors."""
    if src.device.type == "cpu":
        return density_sums_reference(tree, nbr, src, tgt, valid, ktype,
                                      group_max)
    return density_kernel(tree, nbr, src, tgt, valid, ktype, group_max)


def sorted_tree(ipos, mass, valid_gas, group_max):
    """Sort by (not gas, Morton key), build the per-level tree over the
    gas and its target groups (the set-up shared by the density and
    hydro loops).  Returns (perm, inv, pos_box, valid_s, tree, (group
    nodes, centres, halves) of the real groups)."""
    n = ipos.shape[0]
    dev = ipos.device
    keys = morton_key(ipos)
    perm = sort_order(keys, valid_gas)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=dev)
    ipos_s = ipos[perm]
    valid_s = valid_gas[perm]
    keys_s = torch.where(valid_s, keys[perm], KEY_PAD)
    pos_box = ipos_s.to(torch.float32) * 2.0 ** -32
    tree = build_tree(keys_s, ipos_s, mass[perm], valid_s, 16, 18,
                      2 * n + 64, group_max=group_max)
    group_cap = min((8 * n) // group_max + 64, n + 64)
    nodes, gc, gh, _, n_groups, govf = make_target_groups(
        tree, pos_box, torch.full((n,), float("inf"), dtype=torch.float32,
                                  device=dev), group_cap, group_max)
    if bool(govf):
        raise RuntimeError("SPH group capacity exceeded")
    # the walk and the pair sums run over the real groups (at least one
    # slot): a padding group lists nothing
    k = max(1, min(int(n_groups), group_cap))
    return perm, inv, pos_box, valid_s, tree, (nodes[:k], gc[:k], gh[:k])


def group_targets(tree, nodes, n, group_max):
    """Per group its target slots: (index int64[ng, G] clamped into the
    particle range, mask bool[ng, G])."""
    offg = torch.arange(group_max, device=nodes.device)
    safe = torch.clamp(nodes, max=tree.capacity - 1)
    tps = tree.pstart[safe]
    tpc = torch.where(nodes < tree.n_nodes, tree.pcount[safe], 0)
    tidx = torch.clamp(tps[:, None] + offg[None, :], 0, n - 1)
    return tidx, offg[None, :] < tpc[:, None]


def group_radius(tree, nodes, r_sorted, group_max):
    """Each group's search radius: the largest r_sorted (box units, sorted
    order) among its targets."""
    tidx, tm = group_targets(tree, nodes, r_sorted.shape[0], group_max)
    return torch.where(tm, r_sorted[tidx], 0.0).max(dim=1).values


def sph_density(ipos, mass, valid_gas, hsml, vel, velpred, entvarpred,
                par: DensityParams, boxsize, update_hsml=True,
                do_egy_density=True, target_mask=None):
    """Compute densities over gas particles (any order); returns a dict of
    tensors in the INPUT particle order with the converged hsml, and
    "iterations" (bisection passes) and "unconverged" (targets that
    were still outside DesNumNgb +- MaxNumNgbDeviation when max_iter
    passes were spent) as ints.

    valid_gas: bool[N], the gas particles to include; velpred and
    entvarpred: predicted source quantities (input order); target_mask:
    optional bool[N], only these particles drive the hsml bisection
    (active-set stepping); the others keep their hsml and the caller
    merges their outputs.
    """
    n = ipos.shape[0]
    dev = ipos.device
    G = par.group_max
    perm, inv, pos_box, valid_s, tree, (nodes, gc, gh) = sorted_tree(
        ipos, mass, valid_gas, G)
    inv_box = 1.0 / boxsize
    f_inv_box = float(np.float32(inv_box))
    desngb = par.desnumngb
    dev_ngb = par.max_ngb_deviation
    hsml_s = hsml[perm]
    vel_s = vel[perm]
    entvar_s = entvarpred[perm]
    if target_mask is not None:
        done = ~(valid_s & target_mask[perm])
    else:
        done = ~valid_s
    tidx, tm = group_targets(tree, nodes, n, G)
    key = ("sph_density", n)
    mass_s = mass[perm]
    velpred_s = velpred[perm]

    def one_pass(hsml_box, eval_mask):
        """Walk + pair sums for the groups with an eval_mask target;
        the others get radius 0, and their walk lists nothing."""
        gradius = torch.where(tm & eval_mask[tidx], hsml_box[tidx],
                              0.0).max(dim=1).values
        nbr, _ = pairs.find_neighbors_auto(
            tree, nodes, gc, gh, gradius, None, par.leaf_list_max,
            symmetric=False, cache_key=key)
        src, tgt, valid = pack_density_inputs(
            pos_box, valid_s, mass_s, velpred_s, entvar_s, hsml_box, vel_s)
        return density_sums(tree, nbr, src, tgt, valid, par.kernel_type, G)

    hsml_box = hsml_s * f_inv_box
    left = torch.zeros(n, dtype=torch.float32, device=dev)
    right = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    out = torch.zeros((n, len(OUTPUTS)), dtype=torch.float32, device=dev)
    min_h_box = float(np.float32(par.min_hsml * inv_box))
    it = 0
    # one read from the device per pass: are all targets done?
    while it < par.max_iter and not bool(done.all()):
        undone = ~done
        out_new = one_pass(hsml_box, undone)
        out = torch.where(done[:, None], out, out_new)
        it += 1
        if not update_hsml:
            done = torch.ones_like(done)
            continue
        numngb = out_new[:, 0]
        converged = (torch.abs(numngb - desngb) <= dev_ngb) | done
        low = numngb < desngb - dev_ngb
        high = numngb > desngb + dev_ngb
        left = torch.where(low & undone, hsml_box, left)
        right = torch.where(high & undone, hsml_box, right)
        have_both = (right < float("inf")) & (left > 0)
        h_new = torch.where(
            have_both, (0.5 * (left ** 3 + right ** 3)) ** (1.0 / 3.0),
            torch.where(low, hsml_box * 1.26, hsml_box / 1.26))
        h_new = torch.clamp(h_new, min=min_h_box, max=0.45)
        hsml_box = torch.where(converged, hsml_box, h_new)
        done = converged
    unconverged = int((~done).sum()) if update_hsml else 0
    hsml_s = hsml_box * float(np.float32(boxsize))

    # postprocess (density_postprocess, density.c:532-588)
    cols = dict(zip(OUTPUTS, out.unbind(dim=1)))
    rho = cols["rho"]
    safe_rho = torch.clamp(rho, min=1e-30)
    dhsml = cols["dhsml"] * hsml_box / (3.0 * safe_rho)
    dhsml_factor = 1.0 / (1.0 + dhsml)
    egyrho = cols["egyrho"]
    if do_egy_density:
        dhsml_egy = cols["dhsmlegy"] * hsml_box \
            / (3.0 * torch.clamp(egyrho, min=1e-30))
        dhsml_egy = -dhsml_egy * dhsml_factor
        egy_wt_density = egyrho / torch.clamp(entvar_s, min=1e-30)
    else:
        dhsml_egy = dhsml_factor
        egy_wt_density = rho
    # div/curl were accumulated with box-unit kernels and distances:
    # dW ~ L^4, dist ~ 1/L, rho ~ L^3 -> extra factor L vs internal
    div_vel = cols["div"] / safe_rho * f_inv_box
    curl = torch.sqrt(cols["rotx"] ** 2 + cols["roty"] ** 2
                      + cols["rotz"] ** 2) / safe_rho * f_inv_box
    dt_hsml = (1.0 / 3.0) * div_vel * hsml_s

    vol_fac = float(np.float32(inv_box ** 3))
    return {
        "hsml": hsml_s[inv],
        "numngb": cols["ngb"][inv],
        "density": rho[inv] * vol_fac,
        "egy_wt_density": egy_wt_density[inv] * vol_fac,
        "dhsml_density_factor": dhsml_factor[inv],
        "dhsml_egy_factor": dhsml_egy[inv],
        "div_vel": div_vel[inv],
        "curl_vel": curl[inv],
        "dt_hsml": dt_hsml[inv],
        "iterations": it,
        "unconverged": unconverged,
    }
