#!/usr/bin/env python
"""Generate a patchy-reionization z_reion(x) table (UVFluctuationFile;
the port's twin of tools/make_HI_reionization_table.py).

Different regions reionize at different times — denser regions earlier
(more sources).  This implements the Battaglia et al. 2013
(ApJ 776, 81) correlation model between the density field and the
reionization redshift:

    z_re(k) = zbar + (1 + zbar) * b(k) * delta_m(k, zbar)
    b(k)    = b0 / (1 + k / kb)^alpha

with the published fit b0 = 1/delta_c = 0.593, kb = 0.185 h/Mpc,
alpha = 0.564.  The Gaussian modes are the tool's: jax.random.normal's
draws for (seed, ngrid) (utils/threefry.normal, on the host), so the
table is the tool's from the same (seed, ngrid); the modes' FFT and the
field's run on the card unless --device cpu is given.

Output layout matches what physics/cooling.UVFluctuationTable
(and the reference's cooling_uvfluc.c:114) reads: a bigfile with one
``Zreion_Table`` block (f4[nside^3], C order) with attrs Nmesh,
BoxSize (Mpc/h) and Redshift (median z_re).

Reference analog: tools/make_HI_reionization_table.py:1-216 (which
drives FastPM + pmesh; this version is self-contained).

    python -m mpgadget_tpu_torch.tools.make_HI_reionization_table OUT \
        --box 20 [--ngrid 64] [--device cpu]
"""

import argparse

import numpy as np

from . import torch_device


def gaussian_modes(seed, nmesh, device):
    """The JAX package's genic.zeldovich.gaussian_modes(seed, nmesh):
    jax.random.normal's float32 noise of PRNGKey(seed) -> rfftn /
    N^{3/2}."""
    import torch
    from ..utils import threefry
    noise = torch.as_tensor(threefry.normal(threefry.prng_key(seed),
                                            (nmesh, nmesh, nmesh)),
                            device=device)
    return torch.fft.rfftn(noise) * (1.0 / nmesh ** 1.5)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("output", help="output bigfile directory")
    ap.add_argument("--ngrid", type=int, default=64,
                    help="table resolution per side")
    ap.add_argument("--box", type=float, required=True,
                    help="box size in Mpc/h")
    ap.add_argument("--seed", type=int, default=181170,
                    help="IC seed (use the run's GenIC seed so the "
                    "z_re field correlates with the realisation)")
    ap.add_argument("--zbar", type=float, default=7.5,
                    help="mean reionization redshift")
    ap.add_argument("--omega0", type=float, default=0.3)
    ap.add_argument("--omega-baryon", type=float, default=0.05)
    ap.add_argument("--omega-lambda", type=float, default=0.7)
    ap.add_argument("--hubble", type=float, default=0.7)
    ap.add_argument("--sigma8", type=float, default=0.8)
    ap.add_argument("--ns", type=float, default=0.96)
    ap.add_argument("--power-file", default=None,
                    help="optional CLASS/CAMB matter power file "
                    "(Mpc/h units); Eisenstein-Hu otherwise")
    # Battaglia et al. 2013 bias fit
    ap.add_argument("--b0", type=float, default=1.0 / 1.686)
    ap.add_argument("--kb", type=float, default=0.185)
    ap.add_argument("--alpha", type=float, default=0.564)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the FFTs (cuda or cpu)")
    args = ap.parse_args(argv)

    import torch
    from ..cosmology import Cosmology
    from ..genic.power import PowerParams, PowerSpec
    from ..genic.zeldovich import _sqrt_power, delta_table_from_powerspec
    from ..utils import get_unitsystem, constants as CC
    dev = torch_device(args.device)

    UN = get_unitsystem(CC.CM_PER_MPC, 1.989e43, 1e5)
    zinit = args.zbar
    cp = Cosmology(Omega0=args.omega0, OmegaLambda=args.omega_lambda,
                   OmegaBaryon=args.omega_baryon,
                   HubbleParam=args.hubble,
                   TimeBegin=1.0 / (1.0 + zinit)).init_units(UN)
    pp = PowerParams(
        FileWithInputSpectrum=args.power_file or "",
        WhichSpectrum=2 if args.power_file else 0,   # 0 = Eisenstein-Hu
        InputPowerRedshift=-1 if args.power_file else 0.0,
        Sigma8=args.sigma8, PrimordialIndex=args.ns)
    pspec = PowerSpec(pp, cp, InitTime=1.0 / (1.0 + zinit),
                      UnitLength_in_cm=CC.CM_PER_MPC)

    ng = args.ngrid
    box = args.box
    modes = gaussian_modes(args.seed, ng, dev)
    tab = delta_table_from_powerspec(pspec, box, ng, device=dev)
    _, k2, _, sqrtP = _sqrt_power(tab, ng, box, dev)
    kmag = torch.sqrt(k2) * float(np.float32(2 * np.pi / box))   # h/Mpc
    amp = sqrtP * float(np.float32(float(ng) ** 3 / box ** 1.5))
    bias = args.b0 / (1.0 + kmag / args.kb) ** args.alpha
    dz_k = (modes * amp * bias).to(torch.complex64)
    dz = torch.fft.irfftn(dz_k, s=(ng,) * 3).cpu().numpy() \
        * (1.0 + args.zbar)
    zre = (args.zbar + dz).astype(np.float32)
    med = float(np.median(zre))
    print(f"z_re field: min {zre.min():.2f} median {med:.2f} "
          f"max {zre.max():.2f}")

    from ..io.bigfile import BigFile
    bf = BigFile(args.output, create=True)
    blk = bf.create_from_array("Zreion_Table",
                               zre.reshape(-1).astype("<f4"))
    blk.attrs["Nmesh"] = np.array([ng], "u8")
    blk.attrs["BoxSize"] = np.array([box], "f8")
    blk.attrs["Redshift"] = np.array([med], "f8")
    print(f"wrote {args.output}/Zreion_Table ({ng}^3)")


if __name__ == "__main__":
    main()
