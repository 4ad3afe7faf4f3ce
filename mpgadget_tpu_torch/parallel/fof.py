"""Distributed friends-of-friends over the slab decomposition.

PyTorch port of mpgadget_tpu/parallel/fof.py (primary linking, the
secondary attach, counts, catalogue and the black-hole seeding),
the redesign of the reference's distributed FOF (libgadget/fof.c): the
reference links primaries with treewalks whose exports hop ranks until no
label changes (fof_fof, fof.c:158-330) and compiles the catalogue with an
mpsort by minID (fof_compile_catalogue, fof.c:874).

Labels are global row ids: rank r's row i is offset_r + i, offset_r the
rows of the ranks before it, and a group's label is its minimum member's
id.  (The JAX package's ids are shard * n_local + row over its padded
layout; both orders are (rank, row), so the same row is a group's
minimum, its owner, and the catalogue comes out in the same order.)  Each
label round:

1. ghost strips carry (position, label) of primary rows within the
   linking length of the neighbouring slabs (decomp.ghost_strips_multi);
2. each rank finds the connected components of its rows and the ghosts
   with the single-device min-label sweeps (physics/fof.fof_label: the
   neighbour walk K3, then plain PyTorch pair reductions; the JAX
   package's ``_components`` while_loop becomes that host loop), and each
   component takes the minimum label of its members;
3. the count of changed labels, summed over ranks, says whether to go on;
   it takes O(slabs a group spans) rounds.

Secondaries (gas, stars, black holes by FOFSecondaryLinkTypes) then join
the group of their nearest primary (fof_secondary, fof.c:1175): the
primaries within 32 linking lengths of a slab arrive as ghosts with their
labels, and each rank runs the single-device attach
(physics/fof.fof_secondary: radii doubling from the linking length) over
its rows and those ghosts.  Members are counted after the attach, so the
catalogue's by-type columns count the secondaries.

The catalogue routes per-label partial sums to the label's owner rank
through a split-size all_to_all, which reduces them and joins the
all-gathered table.  Centres of mass are circular means (atan2 of
mass-weighted phases), as in the JAX package.
"""

import numpy as np
import torch

from ..physics.fof import FOFParams, fof_label, fof_secondary
from . import collectives as coll
from .decomp import all_gather_rows, exchange_by_dest, ghost_strips_multi

INT_MAX = torch.iinfo(torch.int64).max

# catalogue partial-sum columns per group:
# 0 m | 1:4 m*cos | 4:7 m*sin | 7:10 m*v | 10:16 m_by_type |
# 16 sfr | 17:23 count_by_type | 23 count
_NCOLS = 24


def row_offsets(n_local, mesh):
    """(offset of this rank's first global row id, rows per rank)."""
    counts = coll.all_gather(torch.tensor([n_local], dtype=torch.int64,
                                          device=mesh.device), mesh)
    counts = [int(c) for c in counts[:, 0].tolist()]
    return int(sum(counts[:mesh.rank])), counts


def _hops_for(bounds, width_box, S):
    """Ring hops so that the +-k neighbour slabs cover width_box from any
    slab face (the ghost_strips_multi contract)."""
    b = np.asarray(bounds, np.uint64)
    widths = np.diff(np.append(b, np.uint64(2 ** 32))).astype(
        np.float64) / 2.0 ** 32
    wmin = max(float(widths.min()), 1.0 / 2.0 ** 32)
    hops = int(np.ceil(float(width_box) / wmin))
    return max(1, min(hops, S // 2 if S > 1 else 1))


def fof_round(ipos, prim, label, mesh, bounds, ll_box, hops, cfg):
    """One global label round.  Returns (new labels, changed rows summed
    over ranks)."""
    n = ipos.shape[0]
    gi = torch.nonzero(prim).squeeze(1)
    g_ipos, g_lab = ghost_strips_multi(
        (ipos[gi], label[gi]), ipos[gi], mesh, bounds,
        float(np.float32(ll_box)), hops)
    ipos_a = torch.cat([ipos, g_ipos])
    lab_a = torch.cat([label, g_lab])
    inc_a = torch.cat([prim, torch.ones(g_ipos.shape[0], dtype=torch.bool,
                                        device=ipos.device)])
    # components of own rows and ghosts: labels are sorted row indices,
    # one per component (-1 outside)
    comp, _, _ = fof_label(ipos_a, inc_a, 1.0, float(np.float32(ll_box)),
                           cfg)
    m = comp >= 0
    cmin = torch.full((ipos_a.shape[0],), INT_MAX, dtype=torch.int64,
                      device=ipos.device)
    cmin = cmin.scatter_reduce(0, comp[m], lab_a[m], "amin")
    lab_new = torch.where(m, cmin[comp.clamp(min=0)], lab_a)[:n]
    out = torch.where(prim, torch.minimum(label, lab_new), label)
    changed = int(coll.psum((out != label).sum(), mesh))
    return out, changed


SECONDARY_EXPAND = 6    # attach radii: the linking length times 1..32


def fof_attach_secondaries(ipos, prim, sec, label, mesh, bounds, ll_box,
                           cfg):
    """The secondary attach (build_fof_secondary): each secondary row takes
    the label of its nearest primary within the expanding radii, over this
    rank's rows and the primaries of the other slabs within the widest
    radius.  Returns the labels (secondaries attached, -1 where no primary
    lies within reach)."""
    w_box = float(np.float32(ll_box * 2.0 ** (SECONDARY_EXPAND - 1)))
    gi = torch.nonzero(prim).squeeze(1)
    g_ipos, g_lab = ghost_strips_multi(
        (ipos[gi], label[gi]), ipos[gi], mesh, bounds, w_box,
        _hops_for(bounds, w_box, mesh.size))
    ng = g_ipos.shape[0]
    ones = torch.ones(ng, dtype=torch.bool, device=ipos.device)
    att = fof_secondary(torch.cat([ipos, g_ipos]),
                        torch.cat([sec, ~ones]), torch.cat([prim, ones]),
                        torch.cat([label, g_lab]), 1.0,
                        float(np.float32(ll_box)), cfg,
                        max_expand=SECONDARY_EXPAND)[:ipos.shape[0]]
    return torch.where(sec, att, label)


def fof_counts(label, mesh, offset, counts, min_group_length):
    """Member count per label and the qualifying labels (>= min length),
    sorted, the same on every rank.  Labels are global row ids, so a
    dense count vector summed over ranks and sliced at this rank's rows
    gives each owner its totals (build_fof_counts)."""
    ntot = int(sum(counts))
    grouped = label >= 0
    dense = torch.zeros(ntot, dtype=torch.int64, device=label.device)
    dense.index_add_(0, label[grouped], torch.ones_like(label[grouped]))
    mine = coll.psum_scatter(dense, mesh, counts)
    q = torch.nonzero(mine >= min_group_length).squeeze(1) + offset
    return torch.sort(coll.all_gather_v(q, mesh)[0]).values


SEED_NONE = INT_MAX      # seed_gid of a group without gas


def fof_catalog_table(st, label, qual, mesh, offset, counts, with_bh=False):
    """Per-group sums routed to the label's owner rank and reduced there
    (build_fof_catalog).  Returns the all-gathered (labels, sums
    [ngroups, _NCOLS] float32, seeding extras) of the qualifying groups,
    each owner's groups by descending count.

    With with_bh (BlackHoleOn; st then has a "density" column) the extras
    hold, per group, has_bh (a member is a black hole), seed_density (the
    largest density of its gas members, -1 without gas) and seed_gid: the
    global row of that member, offset + row on its rank (row_offsets), the
    smallest where densities tie, SEED_NONE without gas.  The JAX package
    numbers rows shard * n_local + row over its padded layout; both orders
    are (rank, row), so both pick the same row.  Without with_bh the
    extras are None."""
    dev = label.device
    pos = torch.clamp(torch.searchsorted(qual, label), 0,
                      max(qual.shape[0] - 1, 0))
    grouped = (label >= 0) & (qual[pos] == label) if qual.shape[0] else \
        torch.zeros_like(label, dtype=torch.bool)
    # ---- local per-label partial sums via a label sort ----
    rows = torch.nonzero(grouped).squeeze(1)
    lab = label[rows]
    order = torch.sort(lab, stable=True).indices
    rows, lab = rows[order], lab[order]
    run_lab, run_of_row = torch.unique_consecutive(lab, return_inverse=True)
    nrun = run_lab.shape[0]
    m = st["mass"][rows][:, None]
    theta = st["ipos"][rows].to(torch.float32) * float(
        np.float32(2.0 * np.pi / 2.0 ** 32))
    t = st["ptype"][rows].long()
    onehot = (t[:, None] == torch.arange(6, device=dev)[None, :]).to(
        torch.float32)
    ones = torch.ones((rows.shape[0], 1), dtype=torch.float32, device=dev)
    sfr = st["sfr"][rows][:, None] if "sfr" in st else torch.zeros_like(ones)
    vals = torch.cat([m, m * torch.cos(theta), m * torch.sin(theta),
                      m * st["vel"][rows], m * onehot, sfr, onehot, ones],
                     dim=1)
    seg = torch.zeros((nrun, _NCOLS), dtype=torch.float32,
                      device=dev).index_add_(0, run_of_row, vals)
    cols = [run_lab, seg]
    if with_bh:
        # the densest gas member of each run and its global row
        dens = torch.where(t == 0, st["density"][rows], -1.0)
        dmax = torch.full((nrun,), -1.0, dtype=torch.float32,
                          device=dev).scatter_reduce(0, run_of_row, dens,
                                                     "amax")
        hit = (dens >= dmax[run_of_row]) & (dens > 0)
        gmin = torch.full((nrun,), SEED_NONE, dtype=torch.int64,
                          device=dev).scatter_reduce(
            0, run_of_row, torch.where(hit, offset + rows, SEED_NONE),
            "amin")
        cols += [dmax, gmin]
    # ---- route the partials to the label's owner ----
    ends = torch.tensor(np.cumsum(counts), dtype=torch.int64, device=dev)
    dest = torch.searchsorted(ends, run_lab, right=True)
    recv, _ = exchange_by_dest(tuple(cols), dest, mesh)
    r_lab, r_seg = recv[:2]
    # ---- owner-side reduction into root-row accumulators ----
    n_me = int(counts[mesh.rank])
    acc = torch.zeros((n_me, _NCOLS), dtype=torch.float32, device=dev)
    r_row = r_lab - offset
    acc.index_add_(0, r_row, r_seg)
    cnt = acc[:, -1]
    own = torch.sort(-cnt, stable=True).indices
    own = own[cnt[own] > 0]
    g_lab, _ = coll.all_gather_v(own + offset, mesh)
    g_val, _ = coll.all_gather_v(acc[own], mesh)
    if not with_bh:
        return g_lab, g_val, None
    r_dmax, r_gmin = recv[2:]
    a_dmax = torch.full((n_me,), -1.0, dtype=torch.float32,
                        device=dev).scatter_reduce(0, r_row, r_dmax, "amax")
    a_gmin = torch.full((n_me,), SEED_NONE, dtype=torch.int64,
                        device=dev).scatter_reduce(
        0, r_row, torch.where(r_dmax >= a_dmax[r_row], r_gmin, SEED_NONE),
        "amin")
    (g_dmax, g_gmin), _ = all_gather_rows((a_dmax[own], a_gmin[own]), mesh)
    # has_bh: the group's black-hole count (its one-hot column)
    extras = {"has_bh": g_val[:, 17 + 5] > 0, "seed_density": g_dmax,
              "seed_gid": g_gmin}
    return g_lab, g_val, extras


def finalize_catalog(g_lab, g_val, boxsize, min_group_length, extras=None):
    """Host catalogue from the all-gathered group table: filter by
    minimum length, order by descending mass (the reference sorts the
    catalogue, fof.c:1127).  Returns (cat dict in the physics/fof.py
    layout without group_index, labels in catalogue order); with extras
    (fof_catalog_table's) cat also holds has_bh, seed_density and seed_gid
    in catalogue order."""
    vals = np.asarray(g_val, np.float64)
    counts = np.rint(vals[:, 23]).astype(np.int64)
    keep = counts >= min_group_length
    vals, counts = vals[keep], counts[keep]
    labels = np.asarray(g_lab)[keep]
    masses = vals[:, 0]
    order = np.argsort(-masses, kind="stable")
    vals, counts, masses = vals[order], counts[order], masses[order]
    ang = np.arctan2(vals[:, 4:7], vals[:, 1:4])   # (-pi, pi]
    cm = np.mod(ang / (2 * np.pi), 1.0) * boxsize
    vcm = vals[:, 7:10] / np.maximum(masses[:, None], 1e-30)
    cat = {
        "ngroups": int(keep.sum()),
        "lengths": counts,
        "masses": masses,
        "cm": cm,
        "vel": vcm,
        "mass_by_type": vals[:, 10:16],
        "len_by_type": np.rint(vals[:, 17:23]).astype(np.int64),
        "sfr": vals[:, 16],
    }
    for k, v in (extras or {}).items():
        cat[k] = np.asarray(v.cpu() if torch.is_tensor(v) else v)[keep][order]
    return cat, labels[order]


def group_index(label, sorted_labels):
    """Per-row catalogue rank (-1 ungrouped) from the catalogue-ordered
    labels (the per-particle GrNr, fof.c:1127-1133)."""
    dev = label.device
    lab = torch.as_tensor(np.asarray(sorted_labels, np.int64), device=dev)
    if lab.shape[0] == 0:
        return torch.full_like(label, -1)
    srt = torch.sort(lab)
    pos = torch.clamp(torch.searchsorted(srt.values, label), 0,
                      lab.shape[0] - 1)
    hit = (label >= 0) & (srt.values[pos] == label)
    return torch.where(hit, srt.indices[pos], -1)


def sharded_fof(mesh, st, bounds, *, boxsize, mean_sep, params,
                with_bh=False, max_rounds=None, stats=None):
    """The distributed FOF (runfof, run.c:813 + fof_fof, fof.c:158-330 at
    scale): label rounds to convergence, member counts, catalogue.

    st: this rank's columns {ipos, vel, mass, ptype[, sfr][, density]};
    bounds: the
    S slab left edges; params: physics.fof.FOFParams.  stats: optional
    dict that receives "rounds".  Returns (cat, sorted_labels, labels):
    cat and sorted_labels as :func:`finalize_catalog` (the catalogue's
    StarFormationRate sums the sfr column when st has one; with with_bh
    it carries the seeding extras of fof_catalog_table, from st's density
    column), labels this
    rank's global group label per row (-1 ungrouped), secondaries
    attached."""
    S = mesh.size
    ll_box = params.linking_length * mean_sep / boxsize
    ptype = st["ptype"].long()
    prim = ((torch.ones_like(ptype) << ptype)
            & params.primary_link_types) > 0
    sec = ~prim & (((torch.ones_like(ptype) << ptype)
                    & params.secondary_link_types) > 0)
    n = st["ipos"].shape[0]
    offset, counts = row_offsets(n, mesh)
    gid = offset + torch.arange(n, device=mesh.device)
    label = torch.where(prim, gid, -1)
    hops = _hops_for(bounds, ll_box, S)
    cfg = FOFParams(linking_length=params.linking_length,
                    min_group_length=params.min_group_length,
                    primary_link_types=params.primary_link_types,
                    secondary_link_types=params.secondary_link_types)
    if max_rounds is None:
        max_rounds = 4 * S + 8
    for rnd in range(max_rounds):
        label, changed = fof_round(st["ipos"], prim, label, mesh, bounds,
                                   ll_box, hops, cfg)
        if changed == 0:
            break
    else:
        raise RuntimeError("sharded FOF: label rounds did not converge in "
                           f"{max_rounds}")
    if stats is not None:
        stats["rounds"] = rnd + 1
    if bool(coll.psum(sec.sum(), mesh)):
        label = fof_attach_secondaries(st["ipos"], prim, sec, label, mesh,
                                       bounds, ll_box, cfg)
    qual = fof_counts(label, mesh, offset, counts, params.min_group_length)
    g_lab, g_val, extras = fof_catalog_table(st, label, qual, mesh, offset,
                                             counts, with_bh)
    cat, sorted_labels = finalize_catalog(g_lab.cpu().numpy(),
                                          g_val.cpu().numpy(), boxsize,
                                          params.min_group_length, extras)
    return cat, sorted_labels, label


def seed_convert(st, seed_gids, mesh, *, seed_mass, seed_dyn_mass, atime):
    """The chosen gas rows become freshly seeded black holes (blackhole_make
    via fof_seed, fof.c + blackhole.c:1100 at scale; build_seed_convert).
    seed_gids: the global rows (fof_catalog_table's seed_gid: offset + row,
    the offsets of row_offsets over the rows the FOF ran on) of the
    groups that seed.  On a hit: type 5, out of the gas, the seed BH mass,
    its own mass as Mtrack, the fixed dynamical mass when SeedBHDynMass >
    0, the formation time.  Returns (st', seeded rows summed over
    ranks)."""
    n = st["ptype"].shape[0]
    dev = st["ptype"].device
    offset, _ = row_offsets(n, mesh)
    gid = offset + torch.arange(n, device=dev)
    seeds = torch.as_tensor(np.asarray(seed_gids, np.int64), device=dev)
    hit = torch.isin(gid, seeds)
    out = dict(st)
    out["ptype"] = torch.where(hit, 5, st["ptype"]).to(st["ptype"].dtype)
    out["gas_mask"] = st["gas_mask"] & ~hit
    out["bh_mass"] = torch.where(hit, float(np.float32(seed_mass)),
                                 st["bh_mass"])
    out["bh_mtrack"] = torch.where(hit, st["mass"], st["bh_mtrack"])
    if seed_dyn_mass > 0:
        out["mass"] = torch.where(hit, float(np.float32(seed_dyn_mass)),
                                  st["mass"])
    if "formation_time" in st:
        out["formation_time"] = torch.where(hit, float(np.float32(atime)),
                                            st["formation_time"])
    return out, int(coll.psum(hit.sum(), mesh))
