"""One IC through both packages: dm-small's own paramfiles, run by the
JAX package and by the PyTorch port on the CPU from the same IC file, with
their power spectra and FOF catalogues (PIGs) compared.

- ``test_reduced_dm_small_matches_jax`` (slow, ~9 min): the
  reduced dm-small of tests/test_examples.py (Ngrid 24, Nmesh 48, outputs
  at a = 0.15, 0.2, 0.25) from the committed IC ``torch_parity/IC``, made
  once by the port's genic with the Eisenstein-Hu spectrum
  (``WhichSpectrum = 1``, ``Sigma8 = 0.8``, ``InputPowerRedshift = 0``: the
  example's class_pk_9.dat is not in the repo).  It also holds the JAX
  run to the committed fixture ``torch_parity/jax_outputs.json``, which
  chip_smoke.py holds the card's run of the same IC to (the card machine
  has no JAX).  With MPG_WRITE_PARITY_FIXTURE=1 it writes the IC and the
  fixture anew instead:

      MPG_WRITE_PARITY_FIXTURE=1 python -m pytest -m slow \\
          tests/test_torch_parity.py

- ``test_small_dm_small_matches_jax``: the same comparison at Ngrid 12,
  Nmesh 24, for the PM steps to dm-small's first output (a = 0.15), in
  the suite.
"""

import json
import os
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mpgadget_tpu.main import build_simulation as jax_build
from mpgadget_tpu.params import create_gadget_parameter_set as jax_params
from mpgadget_tpu_torch.genic.main import run_genic
from mpgadget_tpu_torch.io import BigFile
from mpgadget_tpu_torch.main import build_simulation
from mpgadget_tpu_torch.params import (create_gadget_parameter_set,
                                       create_genic_parameter_set)

# one intra-op thread: the suite runs in several worker processes that
# share the machine's cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "torch_parity"
# The runs' power spectra agree bin by bin within 1e-5 (measured at 24^3
# over 16 PM steps: at most 9.8e-6, most bins printed identically by %g):
# the forces agree to ~1e-6 and positions by a few fixed-point ticks.  The
# tolerance leaves 5x room.
PK_RTOL = 5e-5


def genic_text(out, ngrid):
    """dm-small's paramfile.genic at Ngrid ngrid, Eisenstein-Hu spectrum."""
    text = (REPO / "examples/dm-small/paramfile.genic").read_text()
    text = text.replace("Ngrid = 64", f"Ngrid = {ngrid}")
    text = text.replace("OutputDir = IC", f"OutputDir = {out}")
    return text + "\nWhichSpectrum = 1\nSigma8 = 0.8\nInputPowerRedshift = 0\n"


def gadget_text(ic, out, nmesh, outputs="0.15,0.2,0.25", tmax="0.25"):
    """dm-small's paramfile.gadget from IC ic at Nmesh nmesh."""
    text = (REPO / "examples/dm-small/paramfile.gadget").read_text()
    text = text.replace("InitCondFile = IC/IC", f"InitCondFile = {ic}")
    text = text.replace("OutputDir = output", f"OutputDir = {out}")
    text = text.replace("Nmesh = 128", f"Nmesh = {nmesh}")
    text = text.replace("OutputList = 0.15,0.2,0.25", f"OutputList = {outputs}")
    return text.replace("TimeMax = 0.25", f"TimeMax = {tmax}")


def outputs(outdir):
    """Every power spectrum (k, P, N rows by file name) and every PIG's
    group count, sorted lengths and masses."""
    pk = {p.name: np.loadtxt(p, ndmin=2).tolist()
          for p in sorted(Path(outdir).glob("powerspectrum-*.txt"))}
    pigs = {}
    for p in sorted(Path(outdir).glob("PIG_*")):
        bf = BigFile(str(p))
        mass = bf.open("FOFGroups/Mass").read()
        length = bf.open("FOFGroups/LengthByType").read().sum(axis=1)
        pigs[p.name] = {"ngroups": int(len(mass)),
                        "lengths": sorted(int(x) for x in length),
                        "masses": sorted(float(x) for x in mass)}
    return {"powerspectra": pk, "pigs": pigs}


def compare(got, want, pk_rtol=PK_RTOL, mass_rtol=1e-6):
    """Hold one run's outputs to another's: the same files, mode counts and
    k; P within pk_rtol; the same groups and lengths, masses within
    mass_rtol.  Returns the largest relative difference of P."""
    assert sorted(got["powerspectra"]) == sorted(want["powerspectra"])
    worst = 0.0
    for name, w in want["powerspectra"].items():
        g, w = np.asarray(got["powerspectra"][name]), np.asarray(w)
        np.testing.assert_array_equal(g[:, 2], w[:, 2], err_msg=name)
        np.testing.assert_allclose(g[:, 0], w[:, 0], rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=pk_rtol,
                                   err_msg=name)
        worst = max(worst, float(np.abs(g[:, 1] / w[:, 1] - 1).max()))
    assert sorted(got["pigs"]) == sorted(want["pigs"])
    for name, w in want["pigs"].items():
        g = got["pigs"][name]
        assert g["ngroups"] == w["ngroups"], name
        assert g["lengths"] == w["lengths"], name
        np.testing.assert_allclose(g["masses"], w["masses"], rtol=mass_rtol)
    return worst


def run_both(ic, tmp, nmesh, **kw):
    """Both packages from the IC file ic on the CPU; returns their
    outputs (JAX, port) and prints each run's seconds."""
    out = {}
    for name, create, build, extra in (
            ("jax", jax_params, jax_build, {}),
            ("torch", create_gadget_parameter_set, build_simulation,
             {"device": "cpu"})):
        ps = create()
        ps.parse_string(gadget_text(ic, tmp / name, nmesh, **kw))
        sim, _ = build(ps, **extra)
        t0 = time.perf_counter()
        sim.run(verbose=False)
        print(f"{name}: {time.perf_counter() - t0:.1f} s")
        out[name] = outputs(tmp / name)
    return out["jax"], out["torch"]


def _genic(out, ngrid):
    gps = create_genic_parameter_set()
    gps.parse_string(genic_text(out, ngrid))
    gps.validate()
    return run_genic(gps, device="cpu")


@pytest.mark.slow
def test_reduced_dm_small_matches_jax(tmp_path):
    write = os.environ.get("MPG_WRITE_PARITY_FIXTURE") == "1"
    if write:
        ic = _genic(tmp_path / "ic", 24)
        shutil.rmtree(FIXTURE / "IC", ignore_errors=True)
        shutil.copytree(ic, FIXTURE / "IC")
    jax_out, port_out = run_both(FIXTURE / "IC", tmp_path, 48)
    worst = compare(port_out, jax_out)
    print(f"{len(jax_out['powerspectra'])} power spectra, P within "
          f"{worst:.3e} of the JAX package's; PIGs {jax_out['pigs']}")
    if write:
        (FIXTURE / "jax_outputs.json").write_text(json.dumps(jax_out))
    compare(jax_out, json.loads((FIXTURE / "jax_outputs.json").read_text()),
            pk_rtol=1e-6, mass_rtol=1e-6)


def test_small_dm_small_matches_jax(tmp_path):
    ic = _genic(tmp_path / "ic", 12)
    jax_out, port_out = run_both(ic, tmp_path, 24, outputs="0.15",
                                 tmax="0.15")
    assert len(jax_out["powerspectra"]) >= 3
    assert list(jax_out["pigs"]) == ["PIG_000"]
    compare(port_out, jax_out)
