"""Internal unit system.

Mirrors the semantics of the reference (libgadget/utils/unitsystem.c:4-18):
a unit system is fully specified by (UnitLength_in_cm, UnitMass_in_g,
UnitVelocity_in_cm_per_s); time and derived units follow.

Typical cosmological choice (examples/dm-small/paramfile.gadget):
UnitLength = kpc/h, UnitMass = 1e10 Msun/h, UnitVelocity = 1 km/s.
"""

from dataclasses import dataclass, field


@dataclass(frozen=True)
class UnitSystem:
    UnitLength_in_cm: float
    UnitMass_in_g: float
    UnitVelocity_in_cm_per_s: float
    UnitTime_in_s: float = field(init=False)
    UnitDensity_in_cgs: float = field(init=False)
    UnitEnergy_in_cgs: float = field(init=False)
    UnitInternalEnergy_in_cgs: float = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "UnitTime_in_s",
                           self.UnitLength_in_cm / self.UnitVelocity_in_cm_per_s)
        object.__setattr__(self, "UnitDensity_in_cgs",
                           self.UnitMass_in_g / self.UnitLength_in_cm ** 3)
        object.__setattr__(self, "UnitEnergy_in_cgs",
                           self.UnitMass_in_g * self.UnitLength_in_cm ** 2
                           / self.UnitTime_in_s ** 2)
        object.__setattr__(self, "UnitInternalEnergy_in_cgs",
                           self.UnitEnergy_in_cgs / self.UnitMass_in_g)


def get_unitsystem(UnitLength_in_cm: float, UnitMass_in_g: float,
                   UnitVelocity_in_cm_per_s: float) -> UnitSystem:
    return UnitSystem(UnitLength_in_cm, UnitMass_in_g, UnitVelocity_in_cm_per_s)
