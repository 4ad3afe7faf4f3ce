"""Sharded snapshot and PIG output: one stripe file per rank.

PyTorch port of mpgadget_tpu/parallel/snapshot.py, the analog of the
reference's collective petaio writer (libgadget/petaio.c:33-68, :622-700
petaio_save_block): every block is created with one stripe file per rank,
rank 0 writes the header with the per-rank row counts, each rank writes
only its own rows, and rank 0 records the stripes' checksums; a barrier
separates the blocks.  Rows of species t appear in rank order (stripe s
holds rank s's rows), so a snapshot written by S ranks reads back to the
same rows as one written by one writer, after a sort by ID.  The gas
(type 0) and star (type 4) blocks are those of the single writer's
registry (io/registry.py) that the sharded state carries, with the
derived InternalEnergy of the gas; with metal return the Metals of gas and
stars and the stars' return bookkeeping, with black holes their blocks,
with QSO lightup and the excursion set the gas's HeIIIIonized, J21 and
ZReionized, with massive neutrinos the delta_tot history.
"""

import os

import numpy as np
import torch

from ..io.bigfile import BigFile
from ..io import snapshot as snap_io
from ..utils.constants import GAMMA_MINUS1
from . import collectives as coll
from .fof import group_index, row_offsets
from .sort import sharded_sort

MASK32 = 0xFFFFFFFF


def species_block_table(st, t, *, atime, boxsize, ipos_offset):
    """(block name, column(s), dtype, transform) of species t's blocks
    (write_snapshot + io/registry's blocks), keyed on the sharded columns:
    the base blocks, Potential when the state carries it
    (OutputPotential), the gas blocks for t = 0 (InternalEnergy from the
    entropy and density columns), the star blocks for t = 4 and the black
    hole blocks for t = 5 (parallel/snapshot.py:160-200 of the JAX
    package), each only where the state carries its column."""
    inv32 = boxsize / 2.0 ** 32
    off = np.asarray(ipos_offset, np.int64)

    def pos_tr(ip):
        return ((ip - off) & MASK32).astype(np.float64) * inv32

    vfac = 1.0 / atime

    def vel_tr(v):
        # reciprocal multiply, as the single writer (io/snapshot.py)
        return (v * vfac).astype("<f4")

    a3inv = 1.0 / atime ** 3

    def u_tr(ent_rho):
        # InternalEnergy = entropy / (gamma-1) rho_phys^(gamma-1), as the
        # single writer's _species_extra_blocks
        return (ent_rho[:, 0] / GAMMA_MINUS1 * np.maximum(
            ent_rho[:, 1] * a3inv, 1e-30) ** GAMMA_MINUS1).astype("<f4")

    table = [("Position", "ipos", "<f8", pos_tr),
             ("Velocity", "vel", "<f4", vel_tr),
             ("ID", "pid", "<u8", None),
             ("Mass", "mass", "<f4", None),
             ("Potential", "potential", "<f4", None)]
    if t == 0:
        table += [("SmoothingLength", "hsml", "<f4", None),
                  ("Density", "density", "<f4", None),
                  ("EgyWtDensity", "egywt", "<f4", None),
                  ("ElectronAbundance", "ne", "<f4", None),
                  ("StarFormationRate", "sfr", "<f4", None),
                  ("DelayTime", "delay_time", "<f4", None),
                  ("Metallicity", "metallicity", "<f4", None),
                  ("Metals", "metals", "<f4", None),
                  ("HeIIIIonized", "he_iii_ionized", "u1", None),
                  ("J21", "local_j21", "<f4", None),
                  ("ZReionized", "zreion", "<f4", None),
                  ("InternalEnergy", ("entropy", "density"), "<f4", u_tr)]
    elif t == 4:
        table += [("StarFormationTime", "formation_time", "<f4", None),
                  ("BirthDensity", "birth_density", "<f4", None),
                  ("Metallicity", "birth_metallicity", "<f4", None),
                  ("Metals", "metals", "<f4", None),
                  ("TotalMassReturned", "total_mass_returned", "<f4", None),
                  ("LastEnrichmentMyr", "last_enrichment_myr", "<f4",
                   None)]
    elif t == 5:
        table += [("BlackholeMass", "bh_mass", "<f4", None),
                  ("BlackholeAccretionRate", "bh_mdot", "<f4", None),
                  ("BlackholeDensity", "bh_density", "<f4", None),
                  ("BlackholeMtrack", "bh_mtrack", "<f4", None),
                  ("BlackholeProgenitors", "bh_progs", "<i4", None),
                  ("BlackholeKineticFdbkEnergy", "bh_ke", "<f4", None),
                  ("BHVelDisp", "bh_vdisp", "<f4", None),
                  ("StarFormationTime", "formation_time", "<f4", None)]

    def carried(key):
        return all(k in st for k in (key if isinstance(key, tuple)
                                     else (key,)))
    return [row for row in table if carried(row[1])]


def table_columns(table):
    """The state columns a block table reads."""
    return {k for _, key, _, _ in table
            for k in (key if isinstance(key, tuple) else (key,))}


def write_block_sharded(bf, name, rows, counts, dtype, mesh,
                        transform=None):
    """One block with Nfile = S stripes, stripe s = rank s's rows.  rows:
    this rank's host array; counts: rows per rank (list)."""
    S = mesh.size
    dt = np.dtype(dtype)
    if transform is not None:
        rows = transform(rows)
    ncol = 1 if rows.ndim == 1 else rows.shape[1]
    if mesh.rank == 0:
        blk = bf.create(name, dtype=dt, size=int(sum(counts)), nmemb=ncol,
                        Nfile=S)
        # stripe sizes follow the per-rank counts, not an equal split
        blk.Nfile = S
        blk.fsize = [int(c) for c in counts]
        blk.fchecksum = [0] * S
        blk._write_header()
    coll.barrier(mesh)
    if mesh.rank != 0:
        blk = bf.open(name)
    s = blk.write_stripe(mesh.rank, rows.astype(dt, copy=False))
    sums = coll.all_gather(torch.tensor([s], dtype=torch.int64,
                                        device=mesh.device), mesh)
    if mesh.rank == 0:
        blk.finalize_checksums(sums[:, 0].cpu().numpy())
    coll.barrier(mesh)


def _write_species(bf, st, tables, mesh, extra=()):
    """Every species' blocks of this rank's rows st (dict of tensors):
    tables[t] (species_block_table's rows), plus extra (name, column,
    dtype, transform) blocks.  A row's column may be a tuple of columns,
    which its transform reads side by side.  Returns the total rows per
    type."""
    ptype = st["ptype"]
    ntot = np.zeros(6, np.uint64)
    for t in range(6):
        sel = torch.nonzero(ptype == t).squeeze(1)
        counts = coll.all_gather(torch.tensor(
            [sel.shape[0]], dtype=torch.int64, device=mesh.device), mesh)
        counts = [int(c) for c in counts[:, 0].tolist()]
        ntot[t] = sum(counts)
        if ntot[t] == 0:
            continue
        for name, key, dtype, tr in list(tables[t]) + list(extra):
            col = torch.stack([st[k][sel] for k in key], dim=1) \
                if isinstance(key, tuple) else st[key][sel]
            write_block_sharded(bf, f"{t}/{name}", col.cpu().numpy(),
                                counts, dtype, mesh, transform=tr)
    return ntot


def _tables(sim, st):
    return [species_block_table(st, t, atime=sim.atime,
                                boxsize=sim.cfg.boxsize,
                                ipos_offset=sim._ipos_offset)
            for t in range(6)]


def write_snapshot_sharded(sim, mesh, st, label=None):
    """Collective snapshot of the sharded run state (write_checkpoint
    without gathering the rows): every rank writes its stripe of every
    block, rank 0 the header and Snapshots.txt.  Returns the path."""
    if label is None:
        label = sim.snapshot_count
        sim.snapshot_count += 1
    path = os.path.join(sim.cfg.output_dir,
                        f"{sim.cfg.snapshot_base}_{label:03d}")
    if mesh.rank == 0:
        BigFile(path, create=True)
    coll.barrier(mesh)
    bf = BigFile(path)
    atime = sim.atime
    ntot = _write_species(bf, st, _tables(sim, st), mesh)
    if mesh.rank == 0:
        hubble = sim.CP.hubble_function(atime)
        header = snap_io.SnapshotHeader(
            TotNumPart=ntot, MassTable=np.zeros(6), Time=atime,
            TimeIC=sim.time_ic, BoxSize=sim.cfg.boxsize,
            Omega0=sim.CP.Omega0, OmegaLambda=sim.CP.OmegaLambda,
            HubbleParam=sim.CP.HubbleParam,
            OmegaBaryon=sim.CP.OmegaBaryon,
            CMBTemperature=sim.CP.CMBTemperature,
            UnitLength_in_cm=sim.cfg.units.UnitLength_in_cm,
            UnitMass_in_g=sim.cfg.units.UnitMass_in_g,
            UnitVelocity_in_cm_per_s=(
                sim.cfg.units.UnitVelocity_in_cm_per_s),
            RSDFactor=1.0 / (atime * hubble))
        snap_io.write_header(bf, header)
        if sim._nu_table_state is not None:
            # the neutrino delta_tot history (every rank holds the same)
            snap_io.write_neutrino_state(
                bf, sim._nu_table_state.state_dict())
        with open(os.path.join(sim.cfg.output_dir, "Snapshots.txt"),
                  "a") as fh:
            fh.write(f"{label:03d} {atime}\n")
    coll.barrier(mesh)
    return path


def write_pig_sharded(sim, mesh, st, labels, sorted_labels, cat,
                      label=None):
    """FOF catalogue (PIG) of the sharded state (fof_save_groups +
    fof_save_particles, fofpetaio.c:540-570 at scale): rank 0 writes the
    small FOFGroups table; the grouped rows are sorted globally by group
    rank (the mpsort analog, parallel/sort.py) and written a stripe per
    rank as the snapshot is.  Returns the path."""
    if label is None:
        label = max(sim.snapshot_count - 1, 0)
    path = os.path.join(sim.cfg.output_dir,
                        f"{sim.cfg.fof_file_base}_{label:03d}")
    atime = sim.atime
    ng = cat["ngroups"]
    if mesh.rank == 0:
        bf = BigFile(path, create=True)
        bf.create_from_array("FOFGroups/GroupID",
                             np.arange(1, ng + 1, dtype="<u4"))
        bf.create_from_array("FOFGroups/Mass", cat["masses"].astype("<f4"))
        off = sim._ipos_offset.astype(np.float64) / 2.0 ** 32 \
            * sim.cfg.boxsize
        bf.create_from_array(
            "FOFGroups/MassCenterPosition",
            np.mod(cat["cm"] - off, sim.cfg.boxsize).astype("<f8"))
        bf.create_from_array("FOFGroups/MassCenterVelocity",
                             (cat["vel"] / atime).astype("<f4"))
        bf.create_from_array("FOFGroups/LengthByType",
                             cat["len_by_type"].astype("<u4"))
        bf.create_from_array("FOFGroups/MassByType",
                             cat["mass_by_type"].astype("<f4"))
        bf.create_from_array("FOFGroups/StarFormationRate",
                             cat["sfr"].astype("<f4"))
    coll.barrier(mesh)
    bf = BigFile(path)
    ntot = np.zeros(6, np.uint64)
    if sim.cfg.fof_save_particles and ng > 0:
        gi = group_index(labels, sorted_labels)
        sel = torch.nonzero(gi >= 0).squeeze(1)
        # (group rank << 34 | global row) key: a group's members may span
        # ranks in the sorted order (fof_distribute_particles analog)
        offset, _ = row_offsets(st["ipos"].shape[0], mesh)
        key = (gi[sel] << 34) | (sel + offset)
        tables = _tables(sim, st)
        cols = sorted(set().union(*map(table_columns, tables)) | {"ptype"})
        k_s, rows = sharded_sort(key, {k: st[k][sel] for k in cols}, mesh)
        rows["gi"] = k_s >> 34
        ntot = _write_species(
            bf, rows, tables, mesh,
            extra=[("GroupID", "gi", "<u4",
                    lambda g: (g + 1).astype("<u4"))])
    if mesh.rank == 0:
        hdr = bf.create("Header")
        hdr.attrs["NumFOFGroupsTotal"] = np.asarray([ng], "<u8")
        hdr.attrs["NumPartInGroupTotal"] = ntot.astype("<u8")
        hdr.attrs["Time"] = float(atime)
        hdr.attrs["BoxSize"] = float(sim.cfg.boxsize)
        hdr.attrs["Omega0"] = float(sim.CP.Omega0)
        hdr.attrs["OmegaLambda"] = float(sim.CP.OmegaLambda)
        hdr.attrs["HubbleParam"] = float(sim.CP.HubbleParam)
    coll.barrier(mesh)
    return path
