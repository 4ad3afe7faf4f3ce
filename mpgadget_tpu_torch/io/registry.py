"""Declarative per-type snapshot block registry (IO_REG analog).

Mirrors the reference's register_io_blocks table (petaio.c:984-1110):
each entry names a block, its on-disk dtype, the particle type it
belongs to, and which aligned state holder/field supplies it.  Both
write_snapshot and the restart path iterate this ONE table, so a field
added here is automatically checkpointed and restored — the round-1
failure mode (gas-only snapshots silently dropping BH/star/wind state,
ADVICE r1 #1) cannot recur for registered fields.

Holders are the Simulation's aligned state structs: "pdata" (base),
"sph", "stars", "bh".  Derived/output-only blocks (Position, Velocity,
InternalEnergy, Potential, ...) are handled by the writer directly.
"""

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class BlockSpec:
    ptype: int
    name: str          # block name under "<ptype>/"
    dtype: str         # on-disk dtype, e.g. "<f4"
    holder: str        # "pdata" | "sph" | "stars" | "bh"
    field: str         # attribute on the holder
    wronly: bool = False   # written but not restored


# reference: petaio.c:1008-1078
STATE_BLOCKS = (
    # -- gas (type 0) --------------------------------------------------
    BlockSpec(0, "SmoothingLength", "<f4", "pdata", "hsml"),
    BlockSpec(0, "Density", "<f4", "sph", "density"),
    BlockSpec(0, "EgyWtDensity", "<f4", "sph", "egy_wt_density"),
    BlockSpec(0, "ElectronAbundance", "<f4", "sph", "ne"),
    BlockSpec(0, "StarFormationRate", "<f4", "sph", "sfr"),
    BlockSpec(0, "DelayTime", "<f4", "sph", "delay_time"),
    BlockSpec(0, "Metallicity", "<f4", "sph", "metallicity"),
    BlockSpec(0, "Metals", "<f4", "sph", "metals"),
    BlockSpec(0, "HeIIIIonized", "u1", "sph", "he_iii_ionized"),
    BlockSpec(0, "J21", "<f4", "sph", "local_j21"),
    BlockSpec(0, "ZReionized", "<f4", "sph", "zreion"),
    # -- stars (type 4) ------------------------------------------------
    BlockSpec(4, "StarFormationTime", "<f4", "stars", "formation_time"),
    BlockSpec(4, "BirthDensity", "<f4", "stars", "birth_density"),
    BlockSpec(4, "Metallicity", "<f4", "stars", "metallicity"),
    BlockSpec(4, "Metals", "<f4", "stars", "metals"),
    BlockSpec(4, "TotalMassReturned", "<f4", "stars",
              "total_mass_returned"),
    BlockSpec(4, "LastEnrichmentMyr", "<f4", "stars",
              "last_enrichment_myr"),
    # the reference writes this WRONLY (petaio.c:1123); restoring it
    # keeps halo winds working across restarts
    BlockSpec(4, "StarVelDisp", "<f4", "stars", "vdisp"),
    # -- black holes (type 5) ------------------------------------------
    BlockSpec(5, "BlackholeMass", "<f4", "bh", "bh_mass"),
    BlockSpec(5, "BlackholeAccretionRate", "<f4", "bh", "mdot"),
    BlockSpec(5, "BlackholeDensity", "<f4", "bh", "bh_density"),
    BlockSpec(5, "BlackholeMtrack", "<f4", "bh", "mtrack"),
    BlockSpec(5, "BlackholeProgenitors", "<i4", "bh", "count_progs"),
    BlockSpec(5, "BlackholeKineticFdbkEnergy", "<f4", "bh",
              "kinetic_energy"),
    BlockSpec(5, "StarFormationTime", "<f4", "bh", "formation_time"),
    BlockSpec(5, "BlackholeMinPotPos", "<f8", "bh", "min_pot_pos"),
    BlockSpec(5, "BHVelDisp", "<f4", "bh", "vdisp"),
)


def blocks_for_type(ptype: int):
    return [b for b in STATE_BLOCKS if b.ptype == ptype]
