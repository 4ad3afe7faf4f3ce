"""Snapshot read/write: header + declarative block registry.

Mirrors the reference's petaio block-based snapshot format
(libgadget/petaio.c:401-575 header; :984-1110 block registry) so that
snapshots interoperate with MP-Gadget and its analysis tools: a bigfile
with a ``Header`` attr block and per-type blocks ``<ptype>/<Name>``.

Velocity convention (petaio.c:803-830): with UsePeculiarVelocity=1 the
file stores v_pec = Vel / a; internally Vel = a^2 dx/dt.
"""

from dataclasses import dataclass, field
from typing import Dict, Optional
import numpy as np

from .bigfile import BigFile
from ..utils import constants as C


@dataclass
class SnapshotHeader:
    TotNumPart: np.ndarray            # u8[6]
    MassTable: np.ndarray             # f8[6]
    Time: float
    BoxSize: float
    Omega0: float
    OmegaLambda: float
    HubbleParam: float
    OmegaBaryon: float = 0.0
    CMBTemperature: float = 2.7255
    TimeIC: float = 0.0
    TotNumPartInit: Optional[np.ndarray] = None
    UnitLength_in_cm: float = C.CM_PER_KPC
    UnitMass_in_g: float = 1.989e43
    UnitVelocity_in_cm_per_s: float = 1e5
    UsePeculiarVelocity: int = 1
    Omega_fld: float = 0.0
    w0_fld: float = -1.0
    wa_fld: float = 0.0
    Omega_ur: float = 0.0
    OmegaK: float = 0.0
    class_radiation_convention: int = 0
    RSDFactor: float = 0.0
    DensityKernel: int = 2
    # mass fraction of neutrinos sampled as type-2 particles (hybrid
    # neutrinos; libgenic/save.c:130)
    FractionNuInParticles: float = 0.0

    def __post_init__(self):
        if self.TotNumPartInit is None:
            self.TotNumPartInit = np.array(self.TotNumPart)


def write_header(bf: BigFile, h: SnapshotHeader, code_version="mpgadget_tpu"):
    bh = bf.create("Header")
    a = bh.attrs
    a["TotNumPart"] = np.asarray(h.TotNumPart, np.uint64)
    a["TotNumPartInit"] = np.asarray(h.TotNumPartInit, np.uint64)
    a["MassTable"] = np.asarray(h.MassTable, np.float64)
    a["Time"] = float(h.Time)
    a["TimeIC"] = float(h.TimeIC)
    a["BoxSize"] = float(h.BoxSize)
    a["OmegaLambda"] = float(h.OmegaLambda)
    a["OmegaFld"] = float(h.Omega_fld)
    a["W0_Fld"] = float(h.w0_fld)
    a["WA_Fld"] = float(h.wa_fld)
    a["RSDFactor"] = float(h.RSDFactor)
    a["FractionNuInParticles"] = float(h.FractionNuInParticles)
    a["UsePeculiarVelocity"] = np.asarray([h.UsePeculiarVelocity], "<i4")
    a["Omega0"] = float(h.Omega0)
    a["OmegaUR"] = float(h.Omega_ur)
    a["OmegaK"] = float(h.OmegaK)
    a["class_radiation_convention"] = np.asarray(
        [h.class_radiation_convention], "<i4")
    a["CMBTemperature"] = float(h.CMBTemperature)
    a["OmegaBaryon"] = float(h.OmegaBaryon)
    a["UnitLength_in_cm"] = float(h.UnitLength_in_cm)
    a["UnitMass_in_g"] = float(h.UnitMass_in_g)
    a["UnitVelocity_in_cm_per_s"] = float(h.UnitVelocity_in_cm_per_s)
    a["CodeVersion"] = code_version
    a["DensityKernel"] = np.asarray([h.DensityKernel], "<i4")
    a["HubbleParam"] = float(h.HubbleParam)
    return bh


def read_header(bf: BigFile) -> SnapshotHeader:
    bh = bf.open("Header")
    a = bh.attrs

    def getf(name, default=None):
        if name in a:
            return float(np.asarray(a[name]).ravel()[0])
        if default is None:
            raise KeyError(f"Header missing required attr {name}")
        return default

    def geti(name, default=0):
        if name in a:
            return int(np.asarray(a[name]).ravel()[0])
        return default

    return SnapshotHeader(
        TotNumPart=np.asarray(a["TotNumPart"], np.uint64),
        TotNumPartInit=(np.asarray(a["TotNumPartInit"], np.uint64)
                        if "TotNumPartInit" in a
                        else np.asarray(a["TotNumPart"], np.uint64)),
        MassTable=np.asarray(a["MassTable"], np.float64),
        Time=getf("Time"),
        TimeIC=getf("TimeIC", 0.0),
        BoxSize=getf("BoxSize"),
        Omega0=getf("Omega0"),
        OmegaLambda=getf("OmegaLambda"),
        HubbleParam=getf("HubbleParam"),
        OmegaBaryon=getf("OmegaBaryon", 0.0),
        CMBTemperature=getf("CMBTemperature", 2.7255),
        UnitLength_in_cm=getf("UnitLength_in_cm", C.CM_PER_KPC),
        UnitMass_in_g=getf("UnitMass_in_g", 1.989e43),
        UnitVelocity_in_cm_per_s=getf("UnitVelocity_in_cm_per_s", 1e5),
        UsePeculiarVelocity=geti("UsePeculiarVelocity", 0),
        Omega_fld=getf("OmegaFld", 0.0),
        w0_fld=getf("W0_Fld", -1.0),
        wa_fld=getf("WA_Fld", 0.0),
        Omega_ur=getf("OmegaUR", 0.0),
        OmegaK=getf("OmegaK", 0.0),
        RSDFactor=getf("RSDFactor", 0.0),
        FractionNuInParticles=getf("FractionNuInParticles", 0.0),
        DensityKernel=geti("DensityKernel", 2),
    )


def write_species(bf: BigFile, ptype: int, pos=None, vel=None, pid=None,
                  mass=None, atime=1.0, use_peculiar=True, Nfile=1,
                  extra: Optional[Dict[str, np.ndarray]] = None):
    """Write one particle species' base blocks.

    vel is the INTERNAL velocity (a^2 xdot); converted on write.
    """
    prefix = f"{ptype}/"
    if pos is not None:
        bf.create_from_array(prefix + "Position",
                             np.asarray(pos, "<f8"), Nfile=Nfile)
    if vel is not None:
        fac = 1.0 / atime if use_peculiar else 1.0
        bf.create_from_array(prefix + "Velocity",
                             (np.asarray(vel) * fac).astype("<f4"),
                             Nfile=Nfile)
    if pid is not None:
        bf.create_from_array(prefix + "ID", np.asarray(pid, "<u8"),
                             Nfile=Nfile)
    if mass is not None:
        bf.create_from_array(prefix + "Mass", np.asarray(mass, "<f4"),
                             Nfile=Nfile)
    for name, arr in (extra or {}).items():
        bf.create_from_array(prefix + name, arr, Nfile=Nfile)


def read_species(bf: BigFile, ptype: int, header: SnapshotHeader):
    """Read one species; returns dict with internal-unit arrays."""
    prefix = f"{ptype}/"
    out = {}
    n = int(header.TotNumPart[ptype])
    if n == 0:
        return None
    out["pos"] = bf.open(prefix + "Position").read()
    vel = bf.open(prefix + "Velocity").read().astype(np.float64)
    if header.UsePeculiarVelocity:
        vel = vel * header.Time
    out["vel"] = vel
    out["pid"] = bf.open(prefix + "ID").read()
    if prefix + "Mass" in bf:
        out["mass"] = bf.open(prefix + "Mass").read().astype(np.float64)
    else:
        out["mass"] = np.full(n, header.MassTable[ptype])
    return out


def write_neutrino_state(bf: BigFile, state: Dict[str, np.ndarray]):
    """Embed the neutrino delta_tot history in the snapshot
    (petaio_save_neutrinos, neutrinos_lra.c:300-360 layout: 'Neutrino'
    block with Nscale/Nkval/scalefact attrs and Deltas[nk, ia] /
    DeltaNuInit / kvalue blocks)."""
    scalefact = np.asarray(state["scalefact"], np.float64)
    delta_tot = np.asarray(state["delta_tot"], np.float64)   # (ia, nk)
    nb = bf.create("Neutrino")
    nb.attrs["Nscale"] = np.asarray([len(scalefact)], np.uint64)
    nb.attrs["Nkval"] = np.asarray([delta_tot.shape[1]], np.uint64)
    nb.attrs["scalefact"] = scalefact
    bf.create_from_array("Neutrino/Deltas",
                         np.ascontiguousarray(delta_tot.T))
    bf.create_from_array("Neutrino/DeltaNuInit",
                         np.asarray(state["delta_nu_init"], np.float64))
    bf.create_from_array("Neutrino/kvalue",
                         np.asarray(state["wavenum"], np.float64))


def read_neutrino_state(bf: BigFile) -> Dict[str, np.ndarray]:
    """Inverse of write_neutrino_state (petaio_read_neutrinos)."""
    nb = bf.open("Neutrino")
    scalefact = np.asarray(nb.attrs["scalefact"], np.float64)
    deltas = bf.open("Neutrino/Deltas").read()       # (nk, ia)
    return {
        "scalefact": scalefact,
        "delta_tot": np.ascontiguousarray(np.asarray(deltas).T),
        "delta_nu_init": bf.open("Neutrino/DeltaNuInit").read(),
        "wavenum": bf.open("Neutrino/kvalue").read(),
    }
