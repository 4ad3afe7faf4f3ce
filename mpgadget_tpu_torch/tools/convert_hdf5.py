"""Convert a bigfile snapshot to Gadget-style HDF5 (the port's twin of
tools/convert_hdf5.py).

Equivalent of tools/convert_bigfile_gadget_hdf5.py in the reference:
one HDF5 file with a Header group (Gadget attribute names) and
PartTypeN groups holding Coordinates/Velocities/ParticleIDs/Masses plus
every extra block present.  Velocities are written in the GADGET
convention v = Vel_file (already peculiar for UsePeculiarVelocity
snapshots).

Usage: python -m mpgadget_tpu_torch.tools.convert_hdf5 <snapshot_dir>
           [out.hdf5]
"""

import sys

import numpy as np

from ..io.bigfile import BigFile

# bigfile block name -> HDF5 dataset name for the base blocks
RENAME = {
    "Position": "Coordinates",
    "Velocity": "Velocities",
    "ID": "ParticleIDs",
    "Mass": "Masses",
}


def convert(snap, out=None):
    import h5py
    bf = BigFile(snap)
    hdr = bf.open("Header")
    out = out or snap.rstrip("/") + ".hdf5"
    ntot = np.asarray(hdr.attrs["TotNumPart"], np.uint64)
    with h5py.File(out, "w") as h5:
        g = h5.create_group("Header")
        g.attrs["NumPart_ThisFile"] = ntot.astype(np.int64)
        g.attrs["NumPart_Total"] = (ntot & 0xffffffff).astype(np.uint32)
        g.attrs["NumPart_Total_HighWord"] = (ntot >> 32).astype(
            np.uint32)
        g.attrs["MassTable"] = np.asarray(hdr.attrs["MassTable"])
        for name in ("Time", "BoxSize", "Omega0", "OmegaLambda",
                     "HubbleParam", "OmegaBaryon",
                     "UnitLength_in_cm", "UnitMass_in_g",
                     "UnitVelocity_in_cm_per_s"):
            if name in hdr.attrs:
                v = np.asarray(hdr.attrs[name])
                g.attrs[name] = v[0] if v.size == 1 else v
        g.attrs["Redshift"] = 1.0 / float(
            np.asarray(hdr.attrs["Time"])[0]) - 1.0
        g.attrs["NumFilesPerSnapshot"] = 1
        for blk in sorted(bf.blocks()):
            if "/" not in blk:
                continue
            t, name = blk.split("/", 1)
            if not t.isdigit():
                continue
            grp = h5.require_group(f"PartType{t}")
            data = bf.open(blk).read()
            grp.create_dataset(RENAME.get(name, name), data=data)
    print(out)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        sys.exit(__doc__)
    return convert(*argv[:2])


if __name__ == "__main__":
    main()
