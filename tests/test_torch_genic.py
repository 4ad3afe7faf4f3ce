"""The PyTorch port's IC generator (mpgadget_tpu_torch.genic) against the
JAX package's, on the same inputs.

The two packages draw their white noise from different generators, so
the comparisons feed both the same modes: numpy noise from a seed,
FFT'd on each side, or the JAX modes handed to the port's run_genic.
"""

import dataclasses
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpgadget_tpu.genic import zeldovich as jz
from mpgadget_tpu.genic.main import run_genic as jax_run_genic
from mpgadget_tpu.params import create_genic_parameter_set as jax_genic_params
from mpgadget_tpu_torch.genic import zeldovich as tz
from mpgadget_tpu_torch.genic.main import run_genic
from mpgadget_tpu_torch.io import BigFile
from mpgadget_tpu_torch.io import snapshot as snap_io
from mpgadget_tpu_torch.params import create_genic_parameter_set

# one intra-op thread: the suite runs in several worker processes that
# share the machine's cores
torch.set_num_threads(1)

BOX = 64000.0
# dm-small's paramfile.genic at Ngrid 16, with the Eisenstein-Hu spectrum
# (WhichSpectrum 1; the named table is then not read)
GENIC = """
OutputDir = {out}
FileBase = IC
Ngrid = 16
BoxSize = 64000
Omega0 = 0.288
OmegaLambda = 0.712
OmegaBaryon = 0.0472
ProduceGas = 0
HubbleParam = 0.7
Redshift = 9
FileWithInputSpectrum = class_pk_9.dat
WhichSpectrum = 1
Sigma8 = 0.8
InputPowerRedshift = 0
DifferentTransferFunctions = 0
UsePeculiarVelocity = 1
Seed = 181170
UnitaryAmplitude = 1
"""


def _norm_err(a, ref):
    return np.linalg.norm(np.asarray(a) - np.asarray(ref)) / \
        np.linalg.norm(np.asarray(ref))


@pytest.fixture(scope="module")
def same_modes():
    """(JAX modes, port modes, table, ipos as uint32) from one numpy
    noise field at Nmesh 32 and an EH-like sqrt P table."""
    nmesh = 32
    noise = np.random.RandomState(5).randn(nmesh, nmesh, nmesh).astype(
        np.float32)
    jmodes = jnp.fft.rfftn(jnp.asarray(noise)) * (1.0 / nmesh ** 1.5)
    tmodes = torch.fft.rfftn(torch.as_tensor(noise)) * (1.0 / nmesh ** 1.5)
    logk = np.linspace(np.log(1e-5), np.log(0.01), 256)
    logd = 0.5 * np.log(2e9 * np.exp(logk) / (1 + (np.exp(logk) / 1e-4)
                                                  ** 2) ** 1.5)
    rng = np.random.RandomState(6)
    ipos = (rng.uniform(0, 1, (3000, 3)) * 2.0 ** 32).astype(np.uint32)
    return jmodes, tmodes, (logk, logd), ipos, nmesh


@pytest.mark.parametrize("scale_dep", [False, True])
def test_displacement_fields_match_jax(same_modes, scale_dep):
    jmodes, tmodes, (logk, logd), ipos, nmesh = same_modes
    jtab = (jnp.asarray(logk, jnp.float32), jnp.asarray(logd, jnp.float32))
    ttab = (torch.as_tensor(logk, dtype=torch.float32),
            torch.as_tensor(logd, dtype=torch.float32))
    # a growth table that differs from the density one
    jg = (jtab[0], jtab[1] * 0.5)
    tg = (ttab[0], ttab[1] * 0.5)
    jd, jv = jz.displacement_fields(jmodes, jtab, jg, nmesh, BOX,
                                   jnp.asarray(ipos), scale_dep)
    td, tv = tz.displacement_fields(tmodes, ttab, tg, nmesh, BOX,
                                   torch.as_tensor(ipos.astype(np.int64)),
                                   scale_dep)
    assert td.dtype == torch.float32
    assert _norm_err(td.numpy(), jd) <= 1e-5
    assert _norm_err(tv.numpy(), jv) <= 1e-5
    if not scale_dep:
        assert tv is td


def test_density_field_and_interp_match_jax(same_modes):
    jmodes, tmodes, (logk, logd), ipos, nmesh = same_modes
    jtab = (jnp.asarray(logk, jnp.float32), jnp.asarray(logd, jnp.float32))
    ttab = (torch.as_tensor(logk, dtype=torch.float32),
            torch.as_tensor(logd, dtype=torch.float32))
    jd = jz.density_field(jmodes, jtab, nmesh, BOX, jnp.asarray(ipos))
    td = tz.density_field(tmodes, ttab, nmesh, BOX,
                          torch.as_tensor(ipos.astype(np.int64)))
    assert _norm_err(td.numpy(), jd) <= 1e-5
    # interp: inside, on the nodes and clamped past both ends
    x = np.concatenate([np.linspace(logk[0] - 1, logk[-1] + 1, 999),
                        logk[::17]]).astype(np.float32)
    want = np.asarray(jnp.interp(jnp.asarray(x), jtab[0], jtab[1]))
    got = tz.interp(torch.as_tensor(x), *ttab).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got[0] == logd.astype(np.float32)[0]
    assert got[998] == logd.astype(np.float32)[-1]


def test_gaussian_modes_seeded_and_unitary():
    a = tz.gaussian_modes(181170, 16, device="cpu")
    b = tz.gaussian_modes(181170, 16, device="cpu")
    c = tz.gaussian_modes(181171, 16, device="cpu")
    assert a.shape == (16, 16, 9) and a.dtype == torch.complex64
    assert torch.equal(a, b) and not torch.equal(a, c)
    # E|delta_k|^2 = 1
    assert abs(float(torch.mean(torch.abs(a) ** 2)) - 1.0) < 0.1
    u = tz.gaussian_modes(181170, 16, unitary=True, device="cpu")
    amp = torch.abs(u)
    nz = torch.abs(a) > 0
    np.testing.assert_allclose(amp[nz].numpy(), 1.0, rtol=1e-6)
    # unitary keeps the phases; invert flips them
    np.testing.assert_allclose((u * torch.abs(a)).numpy(), a.numpy(),
                               rtol=1e-5, atol=1e-6)
    v = tz.gaussian_modes(181170, 16, unitary=True, invert=True,
                          device="cpu")
    assert torch.equal(v, -u)


@pytest.fixture(scope="module")
def genic_pair(tmp_path_factory):
    """The IC from the JAX run_genic and from the port's, the port fed
    the JAX modes."""
    tmp = tmp_path_factory.mktemp("torch_genic")
    jps = jax_genic_params()
    jps.parse_string(GENIC.format(out=tmp / "jax"))
    jps.validate()
    jpath = jax_run_genic(jps)
    tps = create_genic_parameter_set()
    tps.parse_string(GENIC.format(out=tmp / "torch"))
    tps.validate()
    seen = []

    def jax_modes(seed, nmesh, unitary=False, invert=False, device="cuda"):
        seen.append((seed, nmesh, unitary, invert, str(device)))
        m = np.array(jz.gaussian_modes(seed, nmesh, unitary, invert))
        return torch.as_tensor(m, device=device)

    mp = pytest.MonkeyPatch()
    mp.setattr(tz, "gaussian_modes", jax_modes)
    try:
        tpath = run_genic(tps, device="cpu")
    finally:
        mp.undo()
    assert seen == [(181170, 32, True, False, "cpu")]

    def read(path):
        bf = BigFile(path)
        hdr = snap_io.read_header(bf)
        return hdr, snap_io.read_species(bf, 1, hdr)
    return read(jpath), read(tpath)


def test_run_genic_matches_jax_with_the_same_modes(genic_pair):
    (jh, js), (th, ts) = genic_pair
    n = 16 ** 3
    assert len(ts["pid"]) == n
    np.testing.assert_array_equal(ts["pid"], js["pid"])
    np.testing.assert_array_equal(ts["mass"], js["mass"])
    for f in dataclasses.fields(snap_io.SnapshotHeader):
        np.testing.assert_array_equal(getattr(th, f.name),
                                      getattr(jh, f.name), err_msg=f.name)
    grid, _ = tz.make_grid(16, BOX)
    disp = (js["pos"] - grid + BOX / 2) % BOX - BOX / 2
    rms = np.sqrt(np.mean(np.sum(disp ** 2, axis=1)))
    assert rms > 10.0                     # the IC is displaced
    d = (ts["pos"] - js["pos"] + BOX / 2) % BOX - BOX / 2
    assert np.abs(d).max() <= 1e-5 * rms
    assert _norm_err(ts["vel"], js["vel"]) <= 1e-5


def test_genic_cli_runs_on_the_card_only(monkeypatch, tmp_path, capsys):
    """python -m mpgadget_tpu_torch.genic.main <paramfile>: usage without
    a paramfile, and no silent CPU run without a card."""
    from mpgadget_tpu_torch.genic import main as gmain
    monkeypatch.setattr(sys, "argv", ["main"])
    with pytest.raises(SystemExit):
        gmain.main()
    assert "mpgadget_tpu_torch.genic.main" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["main", str(tmp_path / "p.genic")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        gmain.main()
