"""The dark-matter options of the PyTorch port against the JAX package:
massive neutrinos in linear response (physics/neutrinos_lra.py and the
``nu_table`` of pm_force), hybrid neutrino particles, the past light cone,
lensing potential planes, OutputEnergyDebug, and RestartFlag 1, 2, 4 and 99.

One IC (the port's genic on the CPU: 16^3 DM in a 500 Mpc/h box from z = 9,
Eisenstein-Hu spectrum, MNue = 0.2) goes through both packages' runs with
every option on, shared by the tests below through a module-scoped
fixture: PM gravity only (TreeGravOn 0), the settings of
tests/test_neutrinos.py's run (16^3, Nmesh 32).  The box is large enough
that the light cone's replicas reach the horizon at z ~ 9 (a 64 Mpc/h box
writes no row before z = 3).  The hybrid neutrinos have their own IC
(type-2 particles from NgridNu) and run with the tree (TreeGravOn 1), as
tests/test_neutrinos.py's hybrid test does; RestartFlag 99 runs on them."""

import copy
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpgadget_tpu.main import build_simulation as jax_build
from mpgadget_tpu.params import create_gadget_parameter_set as jax_params
from mpgadget_tpu.physics import lightcone as jlc
from mpgadget_tpu.physics import plane as jplane
from mpgadget_tpu.physics import neutrinos_lra as jnu
from mpgadget_tpu.pm import gravity as jpm
from mpgadget_tpu_torch.genic.main import run_genic
from mpgadget_tpu_torch.main import build_simulation, run_cli
from mpgadget_tpu_torch.params import (create_gadget_parameter_set,
                                       create_genic_parameter_set)
from mpgadget_tpu_torch.physics import lightcone as tlc
from mpgadget_tpu_torch.physics import plane as tplane
from mpgadget_tpu_torch.physics import neutrinos_lra as tnu
from mpgadget_tpu_torch.pm import gravity as tpm

# one intra-op thread: the suite runs in several worker processes that
# share the machine's cores
torch.set_num_threads(1)

BOX = 500000.0
GENIC = """
OutputDir = {out}
FileBase = IC
Ngrid = 16
BoxSize = 500000
Omega0 = 0.288
OmegaLambda = 0.712
OmegaBaryon = 0.0
ProduceGas = 0
HubbleParam = 0.7
Redshift = 9
FileWithInputSpectrum = none
WhichSpectrum = 1
Sigma8 = 0.8
InputPowerRedshift = 0
DifferentTransferFunctions = 0
Seed = 181170
UnitaryAmplitude = 1
MNue = 0.2
{extra}
"""

PARAMS = """
InitCondFile = {ic}
OutputDir = {out}
OutputList = 0.106,0.112
TimeMax = 0.112
TimeLimitCPU = 10000
Omega0 = 0.288
OmegaLambda = 0.712
OmegaBaryon = 0.0
HubbleParam = 0.7
HydroOn = 0
CoolingOn = 0
StarformationOn = 0
WindOn = 0
SnapshotWithFOF = 0
BlackHoleOn = 0
MetalReturnOn = 0
DensityIndependentSphOn = 0
SplitGravityTimestepsOn = 0
TreeGravOn = 0
Nmesh = 32
MaxSizeTimestep = 0.02
MassiveNuLinRespOn = 1
MNue = 0.2
LightconeOn = 1
PlaneOutputList = 0.104
PlaneResolution = 32
OutputEnergyDebug = 1
RandomParticleOffset = 0
"""


def _ic(tmp, extra=""):
    gps = create_genic_parameter_set()
    gps.parse_string(GENIC.format(out=tmp, extra=extra))
    gps.validate()
    return run_genic(gps, device="cpu")


def _params(create, ic, out, text=PARAMS, **override):
    ps = create()
    ps.parse_string(text.format(ic=ic, out=out))
    for k, v in override.items():
        ps.set(k, v)
    ps.validate()
    return ps


def _paramfile(path, ic, out):
    path.write_text(PARAMS.format(ic=ic, out=out))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages from one IC, every option on, to a = 0.112 with
    snapshots at 0.106 and 0.112, planes at 0.104."""
    tmp = tmp_path_factory.mktemp("torch_dmopts")
    ic = _ic(tmp / "ics")
    jsim, _ = jax_build(_params(jax_params, ic, tmp / "jax"))
    tsim, _ = build_simulation(
        _params(create_gadget_parameter_set, ic, tmp / "torch"),
        device="cpu")
    nj = jsim.run(verbose=False)
    nt = tsim.run(verbose=False)
    return dict(tmp=tmp, ic=ic, jsim=jsim, tsim=tsim, nj=nj, nt=nt,
                jdir=tmp / "jax", tdir=tmp / "torch")


def _read_table(path):
    return np.loadtxt(path, ndmin=2)


# -- copied modules ----------------------------------------------------

def test_special_j_and_delta_tot_table_identical():
    """The copied numpy module gives the JAX package's numbers exactly:
    special_j on a grid, and a DeltaTotTable stepped four times."""
    x = np.linspace(0, 30, 301)
    np.testing.assert_array_equal(tnu.special_j(x), jnu.special_j(x))
    from mpgadget_tpu.cosmology import Cosmology as JCosmology
    from mpgadget_tpu_torch.cosmology import Cosmology
    from mpgadget_tpu_torch.utils import get_unitsystem, constants as C
    units = get_unitsystem(C.CM_PER_KPC, 1.989e43, 1e5)
    k = np.logspace(-2.5, 0, 40) / 1000.0
    d0 = 10.0 * (k * 1000.0) ** -0.8
    out = []
    for cosmo, mod in ((JCosmology, jnu), (Cosmology, tnu)):
        cp = cosmo(Omega0=0.3, OmegaBaryon=0.045, OmegaLambda=0.7,
                   HubbleParam=0.7, MNu=(0.1, 0.1, 0.1),
                   MassiveNuLinRespOn=True, TimeBegin=0.02).init_units(units)
        tab = mod.DeltaTotTable(cp, k, d0, 0.02, units)
        steps = [tab.step(a, d0 * a / 0.02) for a in (0.05, 0.1, 0.2, 0.3)]
        out.append((steps, tab.state_dict()))
    for (lk_j, f_j), (lk_t, f_t) in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(lk_t, lk_j)
        np.testing.assert_array_equal(f_t, f_j)
    for key in out[0][1]:
        np.testing.assert_array_equal(out[1][1][key], out[0][1][key])


# -- PM force with the neutrino multiplier -----------------------------

def test_interp_matches_jnp_interp():
    """The port's float32 interp clamps at both ends as jnp.interp does:
    bit for bit inside, below and above the knots, and at the knots."""
    rng = np.random.RandomState(5)
    xp = np.sort(rng.uniform(-3, 2, 50)).astype(np.float32)
    fp = rng.uniform(0.9, 1.3, 50).astype(np.float32)
    x = np.concatenate([rng.uniform(-5, 4, 4000), xp]).astype(np.float32)
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                 jnp.asarray(fp)))
    got = tpm.interp(torch.as_tensor(x), torch.as_tensor(xp),
                     torch.as_tensor(fp)).numpy()
    np.testing.assert_array_equal(got, want)


def test_pm_force_with_nu_table_matches_jax():
    """pm_force with a neutrino table against the JAX package's, on 8192
    clustered particles at Nmesh 32: accelerations and potential within
    1e-5 of the norm (FFT libraries and the deposit's order differ, as in
    test_torch_pm), the same mode counts, and the multiplier moves the
    force by far more than that."""
    n, nmesh = 8192, 32
    rng = np.random.RandomState(8)
    pos = rng.uniform(0, BOX, (n, 3))
    pos[: n // 2] = np.mod(BOX / 3 + rng.randn(n // 2, 3) * BOX * 0.05, BOX)
    ipos = (pos / BOX * 2.0 ** 32).astype(np.uint32)
    w = np.full(n, 3.5, np.float32)
    logk = np.log(np.logspace(-5, -2, 30))
    fac = 1.0 + 0.2 / (1 + np.exp(logk + 9.0))
    cfg_j = jpm.PMConfig(nmesh=nmesh, boxsize=BOX)
    cfg_t = tpm.PMConfig(nmesh=nmesh, boxsize=BOX)
    jacc, jpot, jps = jpm.pm_force(jnp.asarray(ipos), jnp.asarray(w), cfg_j,
                                   nu_table=(logk, fac))
    tacc, tpot, tps = tpm.pm_force(torch.as_tensor(ipos.astype(np.int64)),
                                   torch.as_tensor(w), cfg_t,
                                   nu_table=(logk, fac))
    jacc, jpot = np.asarray(jacc), np.asarray(jpot)
    assert np.linalg.norm(tacc.numpy() - jacc) <= 1e-5 * np.linalg.norm(jacc)
    assert np.linalg.norm(tpot.numpy() - jpot) <= 1e-5 * np.linalg.norm(jpot)
    np.testing.assert_array_equal(tps.nmodes, jps.nmodes)
    np.testing.assert_allclose(tps.power, jps.power, rtol=1e-4)
    plain, _, _ = tpm.pm_force(torch.as_tensor(ipos.astype(np.int64)),
                               torch.as_tensor(w), cfg_t)
    assert np.linalg.norm(plain.numpy() - jacc) > 1e-3 * np.linalg.norm(jacc)


# -- the run with every option on --------------------------------------

def test_run_reaches_the_end_in_both(runs):
    assert runs["nt"] == runs["nj"] >= 4
    assert runs["tsim"].ti_current == runs["jsim"].ti_current
    for name in ("PART_000", "PART_001", "energy.txt", "Snapshots.txt",
                 "snap0_potentialPlane0_normal2.fits"):
        assert (runs["tdir"] / name).exists(), name


def test_neutrino_history_matches_jax(runs):
    """The delta_tot history has one entry a PM step, at the same a, and
    follows the JAX package's within 1e-4 (the P(k) tolerance of the
    slice test; delta_tot is sqrt(P) times factors); the JAX test's own
    checks hold (grav_pm finite, nufac above 1 at the lowest k)."""
    jt, tt = runs["jsim"]._nu_table_state, runs["tsim"]._nu_table_state
    assert len(tt.scalefact) == len(jt.scalefact) >= runs["nt"]
    np.testing.assert_allclose(tt.scalefact, jt.scalefact, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(np.array(tt.delta_tot),
                               np.array(jt.delta_tot), rtol=1e-4)
    # the bins' mean k: the JAX package sums in float32, the port in
    # float64
    np.testing.assert_allclose(tt.wavenum, jt.wavenum, rtol=1e-5)
    tsim = runs["tsim"]
    gpm = tsim.pdata.grav_pm.numpy()
    assert np.isfinite(gpm).all()
    jpm_ = np.asarray(runs["jsim"].pdata.grav_pm)
    assert np.linalg.norm(gpm - jpm_) <= 1e-4 * np.linalg.norm(jpm_)
    ps = tsim.last_power
    _, nufac = copy.deepcopy(tt).step(tsim.atime, np.sqrt(np.maximum(
        ps.power[ps.nmodes > 0], 0)))
    assert nufac[0] > 1.0


def test_power_spectra_match_jax(runs):
    """Every powerspectrum-*.txt of the run, bin by bin: the same k and
    mode counts, P within 1e-4 (as the slice test after two steps)."""
    names = sorted(p.name for p in runs["jdir"].glob("powerspectrum-*.txt"))
    assert len(names) == runs["nj"]
    assert sorted(p.name for p in runs["tdir"].glob(
        "powerspectrum-*.txt")) == names
    for name in names:
        j = _read_table(runs["jdir"] / name)
        t = _read_table(runs["tdir"] / name)
        np.testing.assert_array_equal(t[:, 2], j[:, 2])
        np.testing.assert_allclose(t[:, 0], j[:, 0], rtol=1e-5)
        np.testing.assert_allclose(t[:, 1], j[:, 1], rtol=1e-4)


def test_neutrino_state_in_snapshot_round_trips(runs):
    """The snapshot's Neutrino block holds the run's history, and a
    simulation built from it restores it."""
    from mpgadget_tpu_torch.io import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    st = snap_io.read_neutrino_state(BigFile(str(runs["tdir"] / "PART_001")))
    tt = runs["tsim"]._nu_table_state.state_dict()
    np.testing.assert_array_equal(st["scalefact"], tt["scalefact"])
    np.testing.assert_array_equal(st["delta_tot"], tt["delta_tot"])
    sim, _ = build_simulation(
        _params(create_gadget_parameter_set, runs["ic"], runs["tmp"] / "rb"),
        snapshot=str(runs["tdir"] / "PART_001"), device="cpu")
    np.testing.assert_array_equal(sim._nu_restore["delta_tot"],
                                  tt["delta_tot"])


def test_lightcone_rows_match_jax(runs):
    """The light cone wrote rows (the box reaches the horizon), the same
    number as the JAX package, in the same order; positions within 1e-5
    of the horizon distance (the runs' positions differ by a few ticks,
    and the crossing interpolates in float32); every row lies in the
    shell of the horizon distances the run crossed."""
    path = "lightcone/000/lightcone-00000.raw"
    j = np.fromfile(runs["jdir"] / path, np.float64).reshape(-1, 4)
    t = np.fromfile(runs["tdir"] / path, np.float64).reshape(-1, 4)
    assert len(j) > 1000
    assert t.shape == j.shape
    assert runs["tsim"]._lightcone.n_written == len(t)
    np.testing.assert_array_equal(t[:, 3], j[:, 3])
    d = np.linalg.norm(t[:, :3], axis=1)
    assert np.abs(t[:, :3] - j[:, :3]).max() <= 1e-5 * d.max()
    lc = runs["tsim"]._lightcone
    a0 = runs["tsim"].time_ic
    assert (d <= lc.get_horizon(a0) * (1 + 1e-6)).all()
    assert (d >= lc.get_horizon(runs["tsim"].atime) * (1 - 1e-6)).all()
    assert ((t[:, 3] > 0) & (t[:, 3] <= 1)).all()


def test_cross_mask_matches_jax():
    """One replica's crossing test on the same float32 inputs: the same
    hits (the uint32 ID hash carried in int64, the float32 replica sum,
    the draw's float32 rounding) and crossings within 2 ulp of the
    horizon; IDs above 2^32 wrap as the JAX package's uint32 cast."""
    n = 20000
    rng = np.random.RandomState(4)
    hd_prev, hd = 6.1e6, 6.0e6
    rep = (4 * BOX, 7 * BOX, 6 * BOX)
    r = rng.uniform(hd - 2e4, hd_prev + 2e4, n)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1)[:, None]
    pos = (np.abs(u) * r[:, None] - np.asarray(rep)).astype(np.float32)
    vel = rng.normal(0, 300, (n, 3)).astype(np.float32)
    pid = rng.randint(0, 2 ** 40, n).astype(np.int64)
    f32 = np.float32
    args = (f32(40.0), f32(hd_prev ** 2), f32(hd ** 2), f32(hd_prev),
            f32(hd), f32(0.3))
    jhit, jp3 = jlc._cross_mask(jnp.asarray(pos), jnp.asarray(vel),
                                jnp.asarray(rep, jnp.float32), *args,
                                jnp.asarray(pid))
    thit, tp3 = tlc.cross_mask(torch.as_tensor(pos), torch.as_tensor(vel),
                               rep, *(float(a) for a in args),
                               torch.as_tensor(pid))
    jhit = np.asarray(jhit)
    np.testing.assert_array_equal(thit.numpy(), jhit)
    assert 100 < jhit.sum() < n
    assert np.abs(tp3.numpy()[jhit] - np.asarray(jp3)[jhit]).max() \
        <= 2 * np.spacing(f32(hd))


def test_planes_match_jax(runs):
    """The planes at a = 0.104: FITS headers byte for byte, pixels within
    1e-5 of the largest |pixel| (float32 FFTs of two libraries), and the
    planes' sum over normals counts every particle once per normal."""
    names = sorted(p.name for p in runs["jdir"].glob("*.fits"))
    assert len(names) == 3
    assert sorted(p.name for p in runs["tdir"].glob("*.fits")) == names
    for name in names:
        jb = (runs["jdir"] / name).read_bytes()
        tb = (runs["tdir"] / name).read_bytes()
        assert len(tb) == len(jb)
        assert tb[:2880] == jb[:2880]
        jpix = np.frombuffer(jb[2880:2880 + 32 * 32 * 4], ">f4")
        tpix = np.frombuffer(tb[2880:2880 + 32 * 32 * 4], ">f4")
        assert np.abs(jpix).max() > 0
        assert np.abs(tpix - jpix).max() <= 1e-5 * np.abs(jpix).max()
        cards = [tb[i:i + 80].decode() for i in range(0, 2880, 80)]
        npart = [c for c in cards if c.startswith("NPART")]
        assert int(npart[0].split("=")[1].split("/")[0]) == 4096


def test_plane_slab_and_potential_match_jax():
    """The NGP slab count on the same positions, also with positions next
    to the box edge (float32 rounds them to 1.0: clipped), is identical;
    the potential from the same counts agrees within 1e-6."""
    rng = np.random.RandomState(9)
    ip = rng.randint(0, 2 ** 32, (6000, 3), dtype=np.uint64)
    ip[:50] = 2 ** 32 - rng.randint(1, 200, (50, 3))
    w = (rng.uniform(size=6000) > 0.1).astype(np.float32)
    for axis in range(3):
        jc, jn = jplane._project_slab(jnp.asarray(ip.astype(np.uint32)),
                                      jnp.asarray(w), axis,
                                      np.float32(0.3), np.float32(0.25), 48)
        tc, tn = tplane.project_slab(torch.as_tensor(ip.astype(np.int64)),
                                     torch.as_tensor(w), axis, 0.3, 0.25, 48)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert tn == int(jn)
    dens = np.asarray(jc) * np.float32(3.7)
    jpot = np.asarray(jplane._lensing_potential_fft(
        jnp.asarray(dens), np.float32(1e4), np.float32(1e4),
        np.float32(3e6)))
    tpot = tplane.lensing_potential_fft(torch.as_tensor(dens), 1e4, 1e4,
                                        3e6).numpy()
    assert np.abs(tpot - jpot).max() <= 1e-6 * np.abs(jpot).max()


def test_planes_remove_the_random_shift(runs, tmp_path):
    """The planes of a box shifted by the internal random offset equal the
    unshifted box's byte for byte (the run itself has no shift)."""
    files = []
    for name, off in (("plain", (0, 0, 0)),
                      ("shifted", (123456789, 7, 4000000000))):
        sim, _ = build_simulation(
            _params(create_gadget_parameter_set, runs["ic"], tmp_path / name),
            device="cpu")
        sim._ipos_offset = np.asarray(off, np.uint32)
        sim.pdata = sim.pdata.replace(ipos=(sim.pdata.ipos + torch.as_tensor(
            off, dtype=torch.int64)[None, :]) & 0xFFFFFFFF)
        os.makedirs(sim.cfg.output_dir, exist_ok=True)
        sim._ensure_plane_params()
        files.append(tplane.write_planes(sim, 0, sim._plane_params))
    for a, b in zip(*files):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_energy_statistics_match_jax(runs):
    """energy.txt, one row a snapshot, column by column: a, the gas
    temperature and the energies within 1e-4 (the %g format keeps 6
    digits; kinetic and potential energies follow the runs' velocities
    and PM potentials), masses to the printed digits."""
    j = _read_table(runs["jdir"] / "energy.txt")
    t = _read_table(runs["tdir"] / "energy.txt")
    assert t.shape == j.shape == (2, 29)
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=0)
    assert (t[:, 3] < 0).all() and (t[:, 4] > 0).all()


def test_check_invariants_stops_a_bad_state(runs, tmp_path):
    """A non-finite velocity stops the run with an emergency snapshot, as
    the JAX package's check does."""
    sim, _ = build_simulation(
        _params(create_gadget_parameter_set, runs["ic"], tmp_path),
        device="cpu")
    sim._check_invariants()
    vel = sim.pdata.vel.clone()
    vel[7, 1] = float("nan")
    sim.pdata = sim.pdata.replace(vel=vel)
    with pytest.raises(RuntimeError, match="non-finite velocity"):
        sim._check_invariants()
    assert (tmp_path / "PART_999").exists()


# -- RestartFlag 1, 2, 4, 99 -------------------------------------------

def test_restart_flags_1_2_4_through_the_cli(runs, tmp_path):
    """run_cli (the CLI's body) on the CPU.  Flag 4 on the first snapshot:
    its P(k) equals the JAX package's flag 4 within 1e-4 (measured 4.2e-6:
    the deposit's order and the FFT library) and the in-run P(k) of the
    same a to the printed digits (the run has no random box shift, so the
    snapshot holds the positions the in-run P(k) saw; measured: equal).
    Flag 2 from that snapshot resumes to the end, numbers its snapshot on
    from it, and its final positions lie within 1e-8 of the box (43 ticks)
    of the uninterrupted run's (measured 4.7e-10, 2 ticks: the restored
    neutrino history and the tree's first-call state replay the same
    steps), and within 16 ticks of the JAX package's flag 2 from the same
    snapshot.  Flag 1 resumes from the last snapshot that Snapshots.txt
    lists, already at the end: nothing to run."""
    import shutil
    from mpgadget_tpu_torch.io import BigFile
    from mpgadget_tpu_torch.io import snapshot as snap_io
    out = tmp_path / "out"
    shutil.copytree(runs["tdir"], out, ignore=shutil.ignore_patterns(
        "lightcone", "*.fits"))
    pf = _paramfile(tmp_path / "param.txt", runs["ic"], out)
    a0 = float(np.loadtxt(out / "Snapshots.txt", ndmin=2)[0, 1])
    inrun = _read_table(out / f"powerspectrum-{a0:0.4f}.txt")
    sim4 = run_cli(pf, 4, 0, device="cpu")
    assert sim4.atime == pytest.approx(a0, abs=1e-12)
    flag4 = _read_table(out / f"powerspectrum-{a0:0.4f}.txt")
    jsim, _ = jax_build(_params(jax_params, runs["ic"], tmp_path / "j4"),
                        snapshot=str(out / "PART_000"))
    jsim.compute_forces()
    np.testing.assert_array_equal(flag4[:, 2], inrun[:, 2])
    np.testing.assert_allclose(flag4[:, 1], jsim.last_power.power,
                               rtol=1e-4)
    print("flag 4 against JAX's, against the in-run P(k):",
          np.abs(flag4[:, 1] / jsim.last_power.power - 1).max(),
          np.abs(flag4[:, 1] / inrun[:, 1] - 1).max())
    np.testing.assert_allclose(flag4[:, 1], inrun[:, 1], rtol=1e-6)

    (out / "PART_001").rename(out / "full_001")
    sim2 = run_cli(pf, 2, 0, device="cpu")
    assert sim2.snapshot_count == 2 and (out / "PART_001").exists()
    assert sim2.atime == pytest.approx(runs["tsim"].atime, abs=1e-12)

    def positions(path):
        bf = BigFile(str(path))
        sp = snap_io.read_species(bf, 1, snap_io.read_header(bf))
        return sp["pos"][np.argsort(sp["pid"])]

    d = positions(out / "PART_001") - positions(out / "full_001")
    d = (d + BOX / 2) % BOX - BOX / 2
    print("flag 2 against the uninterrupted run, of the box:",
          np.abs(d).max() / BOX)
    assert np.abs(d).max() <= 1e-8 * BOX
    # the JAX package's flag 2 from the same snapshot (its simulation of
    # flag 4 above, run on): positions within 16 ticks, as the slice test
    jsim.run(verbose=False)
    a = np.asarray(jsim.pdata.ipos).astype(np.int64)
    ticks = np.abs((sim2.pdata.ipos.numpy() - a + 2 ** 31) % 2 ** 32
                   - 2 ** 31).max()
    print("flag 2 against the JAX package's, ticks:", ticks)
    assert jsim.atime == pytest.approx(sim2.atime, abs=1e-12)
    assert ticks <= 16
    sim1 = run_cli(pf, 1, device="cpu")
    assert sim1.atime == pytest.approx(sim2.atime, abs=1e-12)


# -- hybrid neutrinos ---------------------------------------------------

HYBRID = PARAMS.replace("LightconeOn = 1", "LightconeOn = 0").replace(
    "PlaneOutputList = 0.104\n", "").replace(
    "TreeGravOn = 0", "TreeGravOn = 1").replace(
    "MNue = 0.2", "MNue = 0.2\nMNum = 0.2\nMNut = 0.2\nHybridNeutrinosOn = 1\n"
    "Vcrit = 3000\nNuPartTime = {npt}")


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    """Both packages' simulations of the hybrid IC with their first forces,
    before NuPartTime (0.5: tracers) and after it (0.01)."""
    tmp = tmp_path_factory.mktemp("torch_hybrid")
    ic = _ic(tmp / "ics", extra="NgridNu = 8\nMax_nuvel = 3000\nMNum = 0.2\n"
             "MNut = 0.2")
    out = {}
    for npt in (0.5, 0.01):
        text = HYBRID.replace("{npt}", str(npt))
        jsim, _ = jax_build(_params(jax_params, ic, tmp / f"j{npt}",
                                    text=text))
        tsim, _ = build_simulation(_params(
            create_gadget_parameter_set, ic, tmp / f"t{npt}", text=text),
            device="cpu")
        jsim.compute_forces()
        tsim.compute_forces()
        out[npt] = (jsim, tsim)
    return out


@pytest.mark.parametrize("npt", [0.5, 0.01])
def test_hybrid_forces_match_jax(hybrid, npt):
    """The hybrid run's first forces (tests/test_neutrinos.py's settings)
    in both packages: before NuPartTime (0.5) the type-2 tracers receive
    no PM force and source none; after it (0.01) they do.  grav_pm within
    1e-5 of the norm, the tree force within 1e-5 (PM and tree tolerances
    of the slice tests)."""
    jsim, tsim = hybrid[npt]
    assert tsim.CP.hybrid_nu_tracer(tsim.atime) == (npt > 0.1)
    nu = (tsim.pdata.ptype == 2).numpy() & tsim.pdata.valid.numpy()
    assert nu.sum() == 8 ** 3
    for key in ("grav_pm", "grav_accel"):
        got = getattr(tsim.pdata, key).numpy()
        want = np.asarray(getattr(jsim.pdata, key))
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    gpm = tsim.pdata.grav_pm.numpy()[nu]
    if npt > 0.1:
        assert (gpm == 0).all()
    else:
        assert np.abs(gpm).max() > 0


def test_restart_flag_99_matches_jax(hybrid):
    """The force-accuracy self-test (RestartFlag 99) in both packages on
    the hybrid IC after NuPartTime, every particle gravitating: the tree
    against the direct sum.  On so uniform an IC both trees equal the
    direct sum to float32 rounding (mean ~8e-6), so the statistics measure
    rounding and agree within 20% (measured: 5% mean and p99, 2% max);
    they meet the accuracy phase's limits (mean 5e-3, p99 5e-2)."""
    jsim, tsim = hybrid[0.01]
    want = jsim.run_gravity_test()
    got = tsim.run_gravity_test()
    print(want, got)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=0.2), key
    assert got["mean_rel_err"] < 5e-3 and got["p99_rel_err"] < 5e-2
