"""Regenerate / inspect the stellar yield tables (the port's twin of
tools/make_yield_tables.py).

The (mass, Z) grids in physics/yield_tables.py hold
newly-synthesised masses per star for SNII (Kobayashi et al. 2006, ApJ
653, 1145; progenitors 13-40 Msun) and AGB stars (Karakas 2010, MNRAS
403, 1413; 1-6 Msun), rounded to ~2 significant figures from the
published tables.  This is the analog of the reference's
tools/extract_yields.py:1-209 (which scrapes the machine-readable
tables into metal_tables.h); with no network access the values are
maintained inline, and this script provides the verification side:
it prints the IMF-integrated production per Msun formed and compares
against the published Chabrier-IMF integrations so table edits are
checked the same way extract_yields.py output was.

Usage (the IMF integral runs on the card unless --device cpu):
    python -m mpgadget_tpu_torch.tools.make_yield_tables  # check table
    python -m mpgadget_tpu_torch.tools.make_yield_tables --npz OUT
"""

import argparse

import numpy as np

from . import torch_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--npz", default=None,
                    help="write the raw grids to this npz file")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the IMF integral (cuda or cpu)")
    args = ap.parse_args(argv)

    import torch
    from ..physics import yield_tables as yt
    from ..physics.metal_return import stellar_return, SPECIES
    dev = torch_device(args.device)

    if args.npz:
        np.savez(args.npz,
                 snii_masses=yt.SNII_MASSES, snii_z=yt.SNII_Z,
                 agb_masses=yt.AGB_MASSES, agb_z=yt.AGB_Z,
                 **{f"snii_{k}": np.asarray(v)
                    for k, v in yt._SNII.items()},
                 **{f"agb_{k}": np.asarray(v)
                    for k, v in yt._AGB.items()})
        print(f"wrote {args.npz}")

    # published Chabrier-IMF integrated production per Msun formed at
    # solar metallicity (CCSN only), for the checks in
    # tests/test_metal_return.py
    published = {"O": 7e-3, "Fe": 6e-4, "C": 2.5e-3}
    print("IMF-integrated newly-produced mass per Msun formed "
          "(full population, Z=0.02, CCSN+AGB, no SN1a):")
    _, gen = stellar_return(*(torch.tensor(x, device=dev) for x in (
        1e-2, 13.7e3, 0.02, 1.0, 0.0)))
    gen = gen.cpu().numpy()
    for i, sp in enumerate(SPECIES):
        note = ""
        if sp in published:
            ratio = gen[i] / published[sp]
            note = (f"  (published ~{published[sp]:.1e}, "
                    f"ratio {ratio:.2f})")
        print(f"  {sp:>2s}: {gen[i]:.3e}{note}")


if __name__ == "__main__":
    main()
