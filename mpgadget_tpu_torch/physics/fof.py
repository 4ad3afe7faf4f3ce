"""Friends-of-friends halo finder (PyTorch port of
mpgadget_tpu/physics/fof.py).

The reference links halos with iterative minimum-label propagation
treewalks plus cross-rank merges (fof_fof, fof.c:158-330); here the same
minimum-label iteration runs as neighbour-pair reductions over the Morton
octree (ops/pairs.py: the neighbour walk K3, then plain PyTorch sweeps),
accelerated by pointer jumping (label = label[label]), which converges in
O(log(halo diameter)) rounds.  Catalogue compilation (group sizes,
masses, centres of mass, velocities; fof_compile_catalogue, fof.c:874)
is a host-side numpy pass.

Secondary linking (attaching stars/BH to the nearest primary,
fof.c:1175-1260) is a nearest-primary search and a min-label reduction.

Labels are carried as int64 in the min reductions; the JAX package
carries them as float32, which is exact below 2^24 rows, where the two
give the same labels.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import pairs
from ..ops.morton import KEY_PAD, morton_key, sort_order
from ..gravity.tree import build_tree
from ..gravity.treewalk import make_target_groups

INT_FILL = pairs.INT_FILL


@dataclass
class FOFParams:
    linking_length: float = 0.2   # of mean primary separation
    min_group_length: int = 32
    primary_link_types: int = 2   # bitmask, default DM
    secondary_link_types: int = 1 + 16 + 32
    group_max: int = 32
    leaf_list_max: int = 64
    leaf_eval_max: int = 16
    max_rounds: int = 64


def _lap(timer, name):
    if timer is not None:
        timer.lap(name)


def _sorted_tree(ipos, include, cfg, timer=None):
    """Sort by (excluded, Morton key), build the per-level tree and its
    target groups (the set-up shared by fof_label and fof_secondary)."""
    n = ipos.shape[0]
    keys = morton_key(ipos)
    perm = sort_order(keys, include)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=perm.device)
    ipos_s = ipos[perm]
    inc_s = include[perm]
    keys_s = torch.where(inc_s, keys[perm], KEY_PAD)
    pos_box = ipos_s.to(torch.float32) * 2.0 ** -32
    _lap(timer, "sort")
    tree = build_tree(keys_s, ipos_s,
                      torch.ones(n, dtype=torch.float32, device=ipos.device),
                      inc_s, 16, 18, 2 * n + 64, group_max=cfg.group_max)
    _lap(timer, "build_tree")
    group_cap = min((8 * n) // cfg.group_max + 64, n + 64)
    nodes, gc, gh, _, n_groups, _ = make_target_groups(
        tree, pos_box,
        torch.full((n,), float("inf"), dtype=torch.float32,
                   device=ipos.device), group_cap, cfg.group_max)
    # the walk and the sweeps run over the real groups only (at least one
    # slot): a padding slot would record nothing
    k = max(1, min(int(n_groups), group_cap))
    _lap(timer, "make_target_groups")
    return perm, inv, pos_box, tree, (nodes[:k], gc[:k], gh[:k])


def _min_label_round(tree, nbr, pos_box, labels_s, valid_s, ll_box, cfg):
    """One neighbour min-label sweep: for each particle the minimum label
    among neighbours within the linking length (including itself)."""

    def pair_fn(dx, r, tmask, smask, tfeat, sfeat):
        return {"minlab": torch.where(r < ll_box, sfeat["label"], INT_FILL)}

    out = pairs.pair_reduce(
        pair_fn, nbr, tree, pos_box, {},
        {"label": torch.where(valid_s, labels_s, INT_FILL)},
        {"minlab": "min"}, cfg.group_max, cfg.leaf_eval_max)
    newlab = out["minlab"]
    return torch.where(valid_s & (newlab < INT_FILL),
                       torch.minimum(labels_s, newlab), labels_s)


def fof_label(ipos, valid_primary, boxsize, linking_length,
              cfg: FOFParams = None, timer=None):
    """Label connected components; returns (int64[N] labels in the input
    order, perm, inv): label = index of the minimum member in sorted
    order; non-primary particles get -1.

    timer: optional gravity.treepm.StageTimer, started by the caller;
    laps "sort", "build_tree", "make_target_groups", "find_neighbors",
    "round" (one min-label sweep with its pointer jumps, also recorded
    one value per round in series "round_seconds") and "canonicalize";
    records "leaf_list_max" and "rounds".
    """
    cfg = cfg or FOFParams()
    n = ipos.shape[0]
    dev = ipos.device
    perm, inv, pos_box, tree, groups = _sorted_tree(
        ipos, valid_primary, cfg, timer)
    valid_s = valid_primary[perm]
    nodes, gc, gh = groups

    ll_box = float(np.float32(linking_length / boxsize))
    gradius = torch.full((gc.shape[0],), ll_box, dtype=torch.float32,
                         device=dev)
    nbr, ll = pairs.find_neighbors_auto(
        tree, nodes, gc, gh, gradius, None, cfg.leaf_list_max,
        symmetric=False, cache_key=("fof_primary", n))
    _lap(timer, "find_neighbors")
    if timer is not None:
        timer.record("leaf_list_max", ll)

    labels = torch.where(valid_s, torch.arange(n, device=dev), n)
    rounds = 0
    for _ in range(cfg.max_rounds):
        t0 = timer.seconds.get("round", 0.0) if timer is not None else 0.0
        new = _min_label_round(tree, nbr, pos_box, labels, valid_s, ll_box,
                               cfg)
        # pointer jumping: labels point at particles; chase twice
        new = torch.minimum(new, new[torch.clamp(new, 0, n - 1)])
        new = torch.minimum(new, new[torch.clamp(new, 0, n - 1)])
        rounds += 1
        done = bool(torch.equal(new, labels))
        if timer is not None:
            timer.lap("round")
            timer.record("round_seconds", timer.seconds["round"] - t0)
        if done:
            break
        labels = new
    # canonicalize: full pointer-jump to the root
    for _ in range(8):
        labels = torch.minimum(labels, labels[torch.clamp(labels, 0, n - 1)])
    _lap(timer, "canonicalize")
    if timer is not None:
        timer.record("rounds", rounds)
    out = torch.where(valid_s, labels, -1)
    return out[inv], perm, inv


def fof_secondary(ipos, is_secondary, is_primary, labels_primary,
                  boxsize, linking_length, cfg: FOFParams = None,
                  max_expand=6):
    """Attach each secondary particle (star/BH/gas per
    secondary_link_types) to the group of its nearest primary
    (fof_secondary, fof.c:1175-1260).

    The search radius starts at the linking length and doubles up to
    max_expand times.  Returns int64[N] labels in input order (-1 where
    unattached / not secondary).
    """
    cfg = cfg or FOFParams()
    n = ipos.shape[0]
    dev = ipos.device
    include = is_secondary | is_primary
    perm, inv, pos_box, tree, groups = _sorted_tree(ipos, include, cfg)
    sec_s = is_secondary[perm]
    prim_s = is_primary[perm]
    lab_s = labels_primary[perm].to(torch.int64)
    nodes, gc, gh = groups

    # primary labels (INT_FILL for non-primaries so min skips them)
    src_lab = torch.where(prim_s, lab_s, INT_FILL)
    rmin = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    attach = torch.full((n,), -1, dtype=torch.int64, device=dev)
    radius = np.float32(linking_length / boxsize)
    for _ in range(max_expand):
        need = sec_s & ~torch.isfinite(rmin)
        if not bool(need.any()):
            break
        gradius = torch.full((gc.shape[0],), float(radius),
                             dtype=torch.float32, device=dev)
        nbr, _ = pairs.find_neighbors_auto(
            tree, nodes, gc, gh, gradius, None, cfg.leaf_list_max,
            symmetric=False, cache_key=("fof_secondary", n))
        rad = float(radius)

        def pair_fn_r(dx, r, tmask, smask, tfeat, sfeat, rad=rad):
            # nearest primary distance (secondaries are never primaries)
            ok = (r < rad) & (sfeat["lab"] < INT_FILL)
            return {"negr": torch.where(ok, -r, -float("inf"))}

        out = pairs.pair_reduce(
            pair_fn_r, nbr, tree, pos_box, {}, {"lab": src_lab},
            {"negr": "max"}, cfg.group_max, cfg.leaf_eval_max)
        rmin_new = -out["negr"]
        found = sec_s & torch.isfinite(rmin_new) & ~torch.isfinite(rmin)
        rmin = torch.where(found, rmin_new, rmin)
        rtol = rmin * np.float32(1.0 + 1e-5) + np.float32(1e-12)

        def pair_fn_l(dx, r, tmask, smask, tfeat, sfeat):
            ok = (r <= tfeat["rtol"]) & (sfeat["lab"] < INT_FILL)
            return {"minlab": torch.where(ok, sfeat["lab"], INT_FILL)}

        out2 = pairs.pair_reduce(
            pair_fn_l, nbr, tree, pos_box, {"rtol": rtol}, {"lab": src_lab},
            {"minlab": "min"}, cfg.group_max, cfg.leaf_eval_max)
        lab_new = out2["minlab"]
        good = found & (lab_new < INT_FILL)
        attach = torch.where(good, lab_new, attach)
        radius = radius * np.float32(2)
    return attach[inv]


def fof_catalog(ipos, vel, mass, ptype, valid, boxsize, mean_sep,
                cfg: FOFParams = None, sfr=None, timer=None):
    """Full FOF: label, filter by minimum length, compile group table.

    Returns dict of host arrays sorted by descending group mass
    (fof_compile_catalogue analog): lengths, masses, CM positions (in
    internal units), velocities, per-type masses/lengths; plus the
    per-particle group index (-1 for ungrouped), input order.  timer: see
    :func:`fof_label`; adds the lap "catalog".
    """
    cfg = cfg or FOFParams()
    ll = cfg.linking_length * mean_sep
    bit = torch.ones_like(ptype, dtype=torch.int64) << ptype.to(torch.int64)
    primary = valid & ((bit & cfg.primary_link_types) > 0)
    labels, perm, inv = fof_label(ipos, primary, boxsize, ll, cfg, timer)

    secondary = valid & ~primary & ((bit & cfg.secondary_link_types) > 0)
    if bool(secondary.any()):
        sec_lab = fof_secondary(ipos, secondary, primary, labels,
                                boxsize, ll, cfg)
        labels = torch.where(secondary, sec_lab, labels)

    # host-side catalogue compilation (runs once per output)
    lab = labels.cpu().numpy()
    good = lab >= 0
    uniq, grp_idx, counts = np.unique(lab[good], return_inverse=True,
                                      return_counts=True)
    full_grp = np.full(lab.shape, -1, np.int64)
    full_grp[good] = grp_idx

    keep = counts >= cfg.min_group_length
    # re-index kept groups
    newid = np.full(len(uniq), -1, np.int64)
    newid[keep] = np.arange(keep.sum())
    grp_of_particle = np.where(full_grp >= 0, newid[full_grp], -1)

    ngroups = int(keep.sum())
    m = mass.cpu().numpy().astype(np.float64)
    v = vel.cpu().numpy().astype(np.float64)
    t = ptype.cpu().numpy()
    pos = ipos.cpu().numpy().astype(np.float64) * (boxsize / 2.0 ** 32)

    masses = np.zeros(ngroups)
    lengths = np.zeros(ngroups, np.int64)
    cm = np.zeros((ngroups, 3))
    vcm = np.zeros((ngroups, 3))
    mass_by_type = np.zeros((ngroups, 6))
    len_by_type = np.zeros((ngroups, 6), np.int64)
    sfr_tot = np.zeros(ngroups)
    sel = grp_of_particle >= 0
    g = grp_of_particle[sel]
    np.add.at(masses, g, m[sel])
    np.add.at(lengths, g, 1)
    if ngroups:
        # periodic-safe CM: average offsets from each group's first member
        # in input order
        idx_sel = np.nonzero(sel)[0]
        _, first = np.unique(g, return_index=True)
        anchors = idx_sel[first]
        d = pos[sel] - pos[anchors[g]]
        d -= np.round(d / boxsize) * boxsize
        np.add.at(cm, g, m[sel, None] * d)
        cm /= masses[:, None]
        cm += pos[anchors]
        cm = np.mod(cm, boxsize)
        np.add.at(vcm, g, m[sel, None] * v[sel])
        vcm /= masses[:, None]
        for tt in range(6):
            ts = sel & (t == tt)
            if ts.any():
                np.add.at(mass_by_type[:, tt], grp_of_particle[ts], m[ts])
                np.add.at(len_by_type[:, tt], grp_of_particle[ts], 1)
        if sfr is not None:
            s = sfr.cpu().numpy().astype(np.float64)
            np.add.at(sfr_tot, g, s[sel])
    # sort by descending mass (reference sorts catalog)
    order = np.argsort(-masses, kind="stable")
    if ngroups:
        remap = np.full(ngroups, -1, np.int64)
        remap[order] = np.arange(ngroups)
        grp_of_particle = np.where(
            grp_of_particle >= 0,
            remap[np.clip(grp_of_particle, 0, None)], -1)
    _lap(timer, "catalog")
    return {
        "ngroups": ngroups,
        "lengths": lengths[order],
        "masses": masses[order],
        "cm": cm[order],
        "vel": vcm[order],
        "mass_by_type": mass_by_type[order],
        "len_by_type": len_by_type[order],
        "sfr": sfr_tot[order],
        "group_index": grp_of_particle,
    }
