"""Generate linear matter power / transfer tables for MP-GenIC-style
parameter files (the port's twin of tools/make_class_power.py, the
reference's tools/make_class_power.py:1-289 analog).

The reference drives the CLASS Boltzmann code through classylss; this
image has no CLASS, so two backends are provided:

* ``--backend classy`` — use CLASS through the ``classy`` package when
  available (same physics as the reference script);
* ``--backend eh`` (default fallback) — the Eisenstein & Hu (1998)
  analytic transfer function with the growth function from
  ``mpgadget_tpu_torch.cosmology`` (the same fallback MP-GenIC itself uses
  when no table is given, power.c:455-492).  Accurate to a few percent
  without baryon wiggles — fine for test boxes, not for production
  BAO work.

Output files are written next to the parameter file in the CLASS
format MP-GenIC consumes: ``<FileWithInputSpectrum>`` (k [h/Mpc],
P [(Mpc/h)^3]) and optionally ``<FileWithTransferFunction>``.

    python -m mpgadget_tpu_torch.tools.make_class_power paramfile.genic \
        [--backend eh]

The EH spectrum is host numpy and scipy, as in the tool it copies.
"""

import argparse
import os

import numpy as np


def _load_params(paramfile):
    from ..params import create_genic_parameter_set
    ps = create_genic_parameter_set()
    ps.parse_file(paramfile)
    return ps


def make_tables_eh(ps):
    """P(k) at the requested redshift from the EH transfer + growth,
    sigma8-normalized."""
    from ..cosmology import Cosmology
    from ..genic.power import PowerParams, PowerSpec
    from ..utils import get_unitsystem, constants as C

    units = get_unitsystem(ps["UnitLength_in_cm"], ps["UnitMass_in_g"],
                           ps["UnitVelocity_in_cm_per_s"])
    cp = Cosmology(
        Omega0=ps["Omega0"], OmegaLambda=ps["OmegaLambda"],
        OmegaBaryon=ps["OmegaBaryon"], HubbleParam=ps["HubbleParam"],
        TimeBegin=1.0 / (1 + ps["Redshift"])).init_units(units)
    zin = ps["InputPowerRedshift"]
    if zin < 0:
        zin = ps["Redshift"]
    atime = 1.0 / (1.0 + zin)
    sigma8 = ps["Sigma8"]
    if sigma8 <= 0:
        print("Sigma8 not set in the paramfile; normalizing the EH "
              "spectrum to sigma8(z=0) = 0.8")
        sigma8 = 0.8
    # The sigma8 normalization defines the amplitude at z=0
    # (tophat_sigma2 of the raw EH transfer); InputPowerRedshift=0 +
    # InitTime=a(zin) makes PowerSpec carry it to the OUTPUT redshift
    # with the growth factor.  (Passing zin for both left the emitted
    # "z=zin" table at z=0 amplitude: D(a<-a)=1.)
    par = PowerParams(
        FileWithInputSpectrum="",  # force the EH branch
        Sigma8=sigma8, PrimordialIndex=ps["PrimordialIndex"],
        InputPowerRedshift=0, WhichSpectrum=0)
    spec = PowerSpec(par, cp, InitTime=atime,
                     UnitLength_in_cm=ps["UnitLength_in_cm"])
    k = np.logspace(-5, 2.3, 600)                   # h/Mpc
    mpch = C.CM_PER_MPC / ps["UnitLength_in_cm"]    # Mpc/h internal
    delta = spec.delta_spec(k / mpch)               # internal k
    pk = delta ** 2 / mpch ** 3                     # (Mpc/h)^3
    return k, pk


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("paramfile")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "classy", "eh"))
    args = ap.parse_args(argv)
    ps = _load_params(args.paramfile)
    backend = args.backend
    if backend in ("auto", "classy"):
        try:
            import classy  # noqa: F401
            backend = "classy"
        except ImportError:
            if backend == "classy":
                raise SystemExit("classy is not installed")
            backend = "eh"
    base = os.path.dirname(os.path.abspath(args.paramfile))
    out_pk = ps["FileWithInputSpectrum"]
    if not os.path.isabs(out_pk):
        out_pk = os.path.join(base, out_pk)
    if os.path.exists(out_pk):
        raise SystemExit(f"{out_pk} exists; not overwriting")

    if backend == "eh":
        k, pk = make_tables_eh(ps)
    else:
        raise SystemExit("classy backend: install classy and run the "
                         "reference script form; not available here")
    zin = ps["InputPowerRedshift"]
    if zin < 0:
        zin = ps["Redshift"]
    with open(out_pk, "w") as fh:
        fh.write("# k[h/Mpc]  P(k)[(Mpc/h)^3]  "
                 f"(Eisenstein-Hu, z={zin})\n")
        for ki, pi in zip(k, pk):
            fh.write(f"{ki:.8e} {pi:.8e}\n")
    print(f"wrote {out_pk} ({backend} backend)")


if __name__ == "__main__":
    main()
