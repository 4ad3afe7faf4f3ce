from .unitsystem import UnitSystem, get_unitsystem
from . import constants
