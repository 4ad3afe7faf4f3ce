"""TreePM short-range gravity orchestration (grav_short_tree analog),
PyTorch port of mpgadget_tpu/gravity/treepm.py.

Morton sort -> octree build -> block walk -> direct leaf sums -> unsort,
with the reference's parameterization (TreeRcut, Asmth, BHOpeningAngle /
relative opening, Plummer-equivalent softening 2.8x;
gravshort-tree.c:32-155).  "Buffer full" conditions surface as overflow
flags in the returned :class:`TreeForceResult` (the reference's
export-buffer retry, treewalk.c:801-902).
"""

from dataclasses import dataclass, field, replace
from time import perf_counter

import numpy as np
import torch

from .tree import TreeConfig
from .tree32 import build_tree32, sort_by_morton32_payload
from .treewalk import (WalkConfig, make_block_groups, make_leaf_sources,
                       traverse_fused, evaluate_leaves)


@dataclass
class TreeForceResult:
    accel: torch.Tensor         # f32[N,3] internal units, original order
    potential: torch.Tensor     # f32[N] internal units (0 if not computed)
    overflow: torch.Tensor      # bool: any capacity exceeded (redo bigger)
    overflow_parts: dict = None  # name -> bool tensor, which capacity
    n_active_blocks: int = 0    # target blocks walked (nb of the kernels)


class StageTimer:
    """Accumulated host wall seconds per tree-force stage, each lap ending
    in a device synchronisation.  Passed to :func:`tree_force` only when
    stage times are wanted: the synchronisations cost overlap."""

    def __init__(self):
        self.seconds = {}
        self.counts = {}
        self.series = {}     # name -> one value per tree-force evaluation
        self._device = None
        self._t0 = 0.0

    def _now(self):
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        return perf_counter()

    def start(self, device):
        self._device = device
        self._t0 = self._now()

    def lap(self, name):
        t = self._now()
        self.seconds[name] = self.seconds.get(name, 0.0) + t - self._t0
        self._t0 = t

    def count(self, name, n):
        self.counts[name] = self.counts.get(name, 0) + n

    def record(self, name, value):
        self.series.setdefault(name, []).append(value)


@dataclass
class WalkInputs:
    """The sorted particles, their tree and target blocks (see
    :func:`walk_inputs`)."""
    tree: object                # tree.Tree
    perm: torch.Tensor          # int64[N+npad] sorted -> original row
    pos_box: torch.Tensor       # f32[N+npad,3] sorted box coordinates
    valid_s: torch.Tensor       # bool[N+npad] sorted validity
    mass_s: torch.Tensor        # f32[N+npad] sorted mass
    tpos: torch.Tensor          # f32[nb,G,3] target blocks
    center: torch.Tensor        # f32[nb,3] block bounding-box centers
    half: torch.Tensor          # f32[nb,3] and half-widths
    amin: torch.Tensor          # f32[nb] block-minimum |old accel|
    active: torch.Tensor        # bool[nb] blocks to walk
    npad: int                   # padding rows appended to whole blocks


def walk_inputs(ipos, mass, valid, acc_old_mag, *, leaf_max, max_level,
                node_cap, group_size, target_active=None, timer=None):
    """Pad to whole target blocks, Morton-sort, build the tree and cut
    the sorted particles into blocks of group_size.  With target_active
    (bool[N]) a block is active only if it holds an active valid target;
    the flag rides the sort as one more payload column."""
    n = ipos.shape[0]
    G = group_size
    npad = (-n) % G
    payload = [mass, acc_old_mag]
    if target_active is not None:
        payload.append(target_active)
    if npad:
        ipos = torch.cat([ipos, ipos.new_zeros((npad, 3))])
        valid = torch.cat([valid, valid.new_zeros(npad)])
        payload = [torch.cat([p, p.new_zeros(npad)]) for p in payload]

    key_s, perm, ipos_s, valid_s, pay_s = \
        sort_by_morton32_payload(ipos, valid, tuple(payload))
    mass_s, amag_s = pay_s[:2]
    if timer is not None:
        timer.lap("sort")

    tree = build_tree32(key_s, ipos_s, mass_s, valid_s, leaf_max, max_level,
                        node_cap, group_max=G)
    pos_box = ipos_s.to(torch.float32) * 2.0 ** -32
    if timer is not None:
        timer.lap("build")

    tpos, gc, gh, amin, active = make_block_groups(pos_box, valid_s, amag_s,
                                                   G)
    if target_active is not None:
        active = active & (valid_s & pay_s[2]).reshape(-1, G).any(dim=1)
    return WalkInputs(tree=tree, perm=perm, pos_box=pos_box, valid_s=valid_s,
                      mass_s=mass_s, tpos=tpos, center=gc, half=gh,
                      amin=amin, active=active, npad=npad)


def tree_force(ipos, mass, valid, acc_old_mag, *, leaf_max, max_level,
               node_cap, group_size, walk_cfg, rcut_box, theta2, use_bh,
               err_tol_force_acc, rs_inv_box, h_inv_box, g_over_box2,
               with_potential, target_active=None, timer=None):
    """Short-range tree force for all particles on their device.

    acc_old_mag: |a_old| per particle in internal units (relative opening
    criterion, gravshort-tree.c:221-240); geometry in box units, result
    scaled by g_over_box2 = G/box^2.  timer: optional StageTimer that
    accumulates the sort, build, walk, pack and pair-kernel seconds and
    records per evaluation the blocks walked ("active_blocks") and
    whether the potential was computed ("with_potential").

    target_active: optional bool[N] (hierarchical timebins, the active
    set of timestep.c:298).  Only blocks holding an active valid target
    are walked, compacted to exactly those blocks (one ``nonzero``, then
    gathers), so the walk and pair kernels run at nb = the number of
    active blocks; results are scattered back to their rows and every
    other row gets zero (the caller keeps its old value).  Every valid
    particle stays a source.  A block's walk and pair sums do not depend
    on the other blocks, so an active row gets the same result as with
    every block walked.
    """
    dev = ipos.device
    if timer is not None:
        timer.start(dev)
    n = ipos.shape[0]
    w = walk_inputs(ipos, mass, valid, acc_old_mag, leaf_max=leaf_max,
                    max_level=max_level, node_cap=node_cap,
                    group_size=group_size, target_active=target_active,
                    timer=timer)
    tree, npad = w.tree, w.npad
    G = group_size
    ntot = n + npad
    aold = err_tol_force_acc * w.amin / g_over_box2
    tpos, center, half, active = w.tpos, w.center, w.half, w.active
    bidx = None
    if target_active is not None:
        bidx = torch.nonzero(active).squeeze(1)
        tpos, center, half, aold = (tpos[bidx], center[bidx], half[bidx],
                                    aold[bidx])
        active = torch.ones(bidx.shape[0], dtype=torch.bool, device=dev)
    nb = tpos.shape[0]
    if timer is not None:
        timer.record("active_blocks", nb)
        timer.record("with_potential", bool(with_potential))
    if nb:
        acc0, pot0, leaf_idx, nl, walk_ovf = traverse_fused(
            tree, tpos, center, half, aold, active, walk_cfg, rcut_box,
            theta2, use_bh, rs_inv_box, h_inv_box,
            with_potential=with_potential, timer=timer)
    if timer is not None:
        timer.lap("walk")

    nleaf_cap = int(walk_cfg.nleaf_frac * ntot) + 256
    sr_cap = int(walk_cfg.sr_frac * ntot) + 256
    leaf_src = make_leaf_sources(tree, w.pos_box, w.mass_s, w.valid_s,
                                 nleaf_cap, sr_cap, walk_cfg.sub)
    if nb:
        acc_box, pot_box, src_ovf = evaluate_leaves(
            tree, leaf_src, tpos, leaf_idx, nl, acc0, pot0, walk_cfg,
            rs_inv_box, h_inv_box, rcut_box, with_potential=with_potential,
            timer=timer)
    else:       # no active target: nothing to walk
        acc_box = torch.zeros((0, 3), dtype=torch.float32, device=dev)
        pot_box = torch.zeros(0, dtype=torch.float32, device=dev)
        walk_ovf = src_ovf = torch.zeros(0, dtype=torch.bool, device=dev)
    if bidx is not None:
        rows = (bidx[:, None] * G + torch.arange(G, device=dev)).reshape(-1)
        acc_full = torch.zeros((ntot, 3), dtype=torch.float32, device=dev)
        acc_full[rows] = acc_box
        pot_full = torch.zeros(ntot, dtype=torch.float32, device=dev)
        pot_full[rows] = pot_box
        acc_box, pot_box = acc_full, pot_full

    # unsort by scattering through perm (direct inverse, no argsort)
    acc = torch.zeros((ntot, 3), dtype=torch.float32, device=dev)
    acc[w.perm] = acc_box * g_over_box2
    acc = torch.where(valid[:n, None], acc[:n], 0.0)
    pot = torch.zeros(ntot, dtype=torch.float32, device=dev)
    pot[w.perm] = pot_box
    parts = {"nodes": tree.overflow, "leaf_table": leaf_src[3],
             "leaf_list": walk_ovf.any(), "sources": src_ovf.any()}
    overflow = (parts["nodes"] | parts["leaf_table"] | parts["leaf_list"]
                | parts["sources"])
    if timer is not None:
        timer.lap("unsort")
    return TreeForceResult(accel=acc, potential=pot[:n], overflow=overflow,
                           overflow_parts=parts, n_active_blocks=nb)


@dataclass
class TreeGravity:
    """Stateful convenience wrapper around :func:`tree_force` holding the
    reference parameterization; see gravshort-tree.c:97-140."""
    boxsize: float
    nmesh: int
    asmth: float = 1.5
    rcut: float = 6.0            # TreeRcut, units of asmth*cellsize
    G: float = 43007.1
    softening: float = 0.0       # FORCE_SOFTENING (=2.8*eps), internal
    err_tol_force_acc: float = 0.002
    bh_opening_angle: float = 0.175
    max_bh_opening_angle: float = 0.9
    tree_use_bh: int = 2         # 2: BH on first call only
    tree_cfg: TreeConfig = field(default_factory=TreeConfig)
    walk_cfg: WalkConfig = field(default_factory=WalkConfig)
    with_potential: bool = True

    def __post_init__(self):
        self._use_bh_now = self.tree_use_bh > 0
        self.last_overflow = None
        self.last_overflow_parts = None
        self.timer = None        # StageTimer to fill, if set

    # geometry in box units
    @property
    def rcut_box(self):
        return self.rcut * self.asmth / self.nmesh

    @property
    def rs_inv_box(self):
        return self.nmesh / (2.0 * self.asmth)

    @property
    def h_inv_box(self):
        return self.boxsize / max(self.softening, 1e-30)

    def force_kwargs(self, n, use_bh=None):
        """Scalar kwargs for tree_force at capacity n."""
        if use_bh is None:
            use_bh = self._use_bh_now
        return dict(
            leaf_max=self.tree_cfg.leaf_max,
            max_level=min(self.tree_cfg.max_level, 16),
            node_cap=int(self.tree_cfg.node_factor * n) + 64,
            group_size=self.tree_cfg.group_max,
            walk_cfg=self.walk_cfg,
            rcut_box=float(np.float32(self.rcut_box)),
            theta2=float(np.float32(
                self.bh_opening_angle ** 2 if use_bh
                else self.max_bh_opening_angle ** 2)),
            use_bh=bool(use_bh),
            err_tol_force_acc=float(np.float32(self.err_tol_force_acc)),
            rs_inv_box=float(np.float32(self.rs_inv_box)),
            h_inv_box=float(np.float32(self.h_inv_box)),
            g_over_box2=float(np.float32(self.G / self.boxsize ** 2)),
            with_potential=self.with_potential,
        )

    def grow(self):
        """Double the capacities after an overflow: leaf list, source
        slots, leaf and sub-row tables, tree nodes (the export-buffer
        retry, treewalk.c:801-902)."""
        wc = self.walk_cfg
        self.walk_cfg = replace(
            wc, leaf_list_max=wc.leaf_list_max * 2, src_cap=wc.src_cap * 2,
            nleaf_frac=min(1.0, wc.nleaf_frac * 2),
            sr_frac=min(1.0, wc.sr_frac * 2))
        self.tree_cfg = replace(
            self.tree_cfg, node_factor=min(2.0, self.tree_cfg.node_factor * 2))

    def compute(self, pdata, return_potential=False, target_active=None):
        """Short-range accel (internal units) for all particles, or for
        the blocks holding a target_active particle (see
        :func:`tree_force`; other rows return zero); with
        return_potential also the short-range potential."""
        acc_old = pdata.grav_accel + pdata.grav_pm
        amag = torch.sqrt(torch.sum(acc_old * acc_old, dim=-1))
        kw = self.force_kwargs(int(pdata.capacity))
        kw["with_potential"] = self.with_potential or return_potential
        res = tree_force(pdata.ipos, pdata.mass, pdata.valid, amag,
                         target_active=target_active, timer=self.timer, **kw)
        if self.tree_use_bh > 1:
            self._use_bh_now = False  # BH on first call only
        self.last_overflow = res.overflow
        self.last_overflow_parts = res.overflow_parts
        if return_potential:
            return res.accel, res.potential * float(
                np.float32(self.G / self.boxsize))
        return res.accel
