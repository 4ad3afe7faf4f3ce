"""The port's tools (mpgadget_tpu_torch/tools) against the repo's tools/
and the examples' check_results.py, on the CPU.

Each twin and the JAX-side tool it copies run on the same inputs, made
from a numpy seed in a temporary directory; the tolerance of each
comparison is stated beside it.  A subprocess runs every twin's main and
the five tools that import neither package under an import blocker that
fails any import of jax or mpgadget_tpu.
"""

import importlib.util
import json
import os
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpgadget_tpu_torch.io.bigfile import BigFile
from mpgadget_tpu_torch.io import snapshot as snap_io
from mpgadget_tpu_torch.tools import (check_examples, compare_snap,
                                      convert_from_gadget_1, convert_hdf5,
                                      hmf_from_fof, make_class_power,
                                      make_HI_reionization_table,
                                      make_yield_tables, plot_gsmf)

REPO = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def load(path, name):
    """A module of tools/ or examples/ (not packages) by its file."""
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tool():
    mods = {}

    def get(name):
        if name not in mods:
            mods[name] = load(f"tools/{name}.py", f"jax_tool_{name}")
        return mods[name]
    return get


def run_main(monkeypatch, mod, argv):
    """A JAX-side tool's command line, in this process."""
    monkeypatch.setattr(sys, "argv", [mod.__file__] + list(argv))
    return mod.main()


# -- inputs made from a seed -------------------------------------------

def write_pig(path, ngroups, seed, box=25000.0, hubble=0.7, stars=True):
    """A PIG: FOFGroups/Mass and MassByType (types 1 and 4), a Header."""
    rng = np.random.default_rng(seed)
    mass = 10 ** rng.uniform(0, 3, ngroups)
    mbt = np.zeros((ngroups, 6), np.float32)
    mbt[:, 1] = mass
    if stars:
        mbt[::2, 4] = mass[::2] * rng.uniform(1e-3, 1e-2, len(mass[::2]))
    bf = BigFile(path, create=True)
    bf.create_from_array("FOFGroups/Mass", mass.astype("<f4"))
    bf.create_from_array("FOFGroups/MassByType", mbt)
    hdr = bf.create("Header")
    hdr.attrs["BoxSize"] = box
    hdr.attrs["HubbleParam"] = hubble
    return mass


def write_snap(path, n=64, box=500.0, seed=1, atime=0.5, gas=None,
               stars=None, shift=0.0):
    """A snapshot of n DM particles (type 1); gas / stars: dicts of extra
    blocks of types 0 and 4 (their rows count from the first block)."""
    rng = np.random.RandomState(seed)
    pos = np.mod(rng.uniform(0, box, (n, 3)) + shift, box)
    bf = BigFile(path, create=True)
    snap_io.write_species(bf, 1, pos=pos, vel=rng.randn(n, 3),
                          pid=np.arange(n, dtype=np.uint64) + 1,
                          mass=np.full(n, 2.0), atime=atime)
    ntot = np.zeros(6, np.uint64)
    ntot[1] = n
    init = ntot.copy()
    for t, blocks in ((0, gas), (4, stars)):
        if blocks:
            ntot[t] = len(next(iter(blocks.values())))
            init[t] = blocks.pop("_init", ntot[t])
            for name, v in blocks.items():
                bf.create_from_array(f"{t}/{name}", np.asarray(v))
    snap_io.write_header(bf, snap_io.SnapshotHeader(
        TotNumPart=ntot, TotNumPartInit=init, MassTable=np.zeros(6),
        Time=atime, TimeIC=atime, BoxSize=box, Omega0=0.3,
        OmegaLambda=0.7, HubbleParam=0.7))
    return pos


def gadget1_file(path, seed=4):
    """A Gadget-1 file of 4 gas (mass block, u) and 8 DM particles."""
    rng = np.random.RandomState(seed)
    n0, n1 = 4, 8
    npart = [n0, n1, 0, 0, 0, 0]
    a = 0.25
    pos = rng.uniform(0, 1000.0, (n0 + n1, 3)).astype("<f4")
    vel = rng.randn(n0 + n1, 3).astype("<f4")
    ids = np.arange(1, n0 + n1 + 1, dtype="<u4")
    hdr = struct.pack("<6i", *npart) + struct.pack(
        "<6d", 0.0, 2.5, 0, 0, 0, 0)
    hdr += struct.pack("<dd", a, 1 / a - 1) + struct.pack("<2i", 0, 0)
    hdr += struct.pack("<6I", *npart) + struct.pack("<2i", 0, 1)
    hdr += struct.pack("<4d", 1000.0, 0.3, 0.7, 0.7)
    hdr += struct.pack("<2i", 0, 0) + struct.pack("<6I", 0, 0, 0, 0, 0, 0)
    hdr += b"\x00" * (256 - len(hdr))

    def rec(payload):
        return (struct.pack("<i", len(payload)) + payload
                + struct.pack("<i", len(payload)))
    with open(path, "wb") as fh:
        for p in (hdr, pos.tobytes(), vel.tobytes(), ids.tobytes(),
                  np.full(n0, 0.5, "<f4").tobytes(),
                  np.linspace(10, 40, n0).astype("<f4").tobytes()):
            fh.write(rec(p))


def bigfile_contents(path):
    """{block: (data, {attr: value})} of a bigfile, Header included."""
    bf = BigFile(path)
    out = {}
    for name in sorted(bf.blocks()):
        blk = bf.open(name)
        attrs = {k: np.asarray(blk.attrs[k]) for k in sorted(blk.attrs.keys())}
        data = blk.read() if name != "Header" else None
        out[name] = (data, attrs)
    return out


def assert_same_bigfile(a, b):
    ca, cb = bigfile_contents(a), bigfile_contents(b)
    assert sorted(ca) == sorted(cb)
    for name in ca:
        (da, aa), (db, ab) = ca[name], cb[name]
        if da is not None:
            assert da.dtype == db.dtype and np.array_equal(da, db), name
        assert sorted(aa) == sorted(ab), name
        for k in aa:
            assert np.array_equal(aa[k], ab[k]), (name, k)


# -- the halo tools -----------------------------------------------------

def test_hmf_rows_equal(tmp_path, jax_tool, capsys):
    """hmf_from_fof.hmf: the same rows (exactly) and the same output."""
    pig = str(tmp_path / "PIG_000")
    write_pig(pig, 40, seed=11)
    want = jax_tool("hmf_from_fof").hmf(pig, nbins=8)
    out_jax = capsys.readouterr().out
    got = hmf_from_fof.hmf(pig, nbins=8)
    assert capsys.readouterr().out == out_jax
    assert np.array_equal(got, want) and int(got[:, 2].sum()) == 40


def test_gsmf_rows_equal(tmp_path, jax_tool):
    """plot_gsmf.gsmf: the same bins, phi and counts (exactly)."""
    pig = str(tmp_path / "PIG_000")
    write_pig(pig, 40, seed=12)
    want = jax_tool("plot_gsmf").gsmf(pig, nbins=6)
    got = plot_gsmf.gsmf(pig, nbins=6)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert int(got[2].sum()) == 20


# -- the converters -----------------------------------------------------

def test_convert_from_gadget_1_blocks_equal(tmp_path, jax_tool,
                                            monkeypatch):
    """Every block and header attribute of the two bigfiles equal."""
    src = str(tmp_path / "snap_000")
    gadget1_file(src)
    run_main(monkeypatch, jax_tool("convert_from_gadget_1"),
             [src, str(tmp_path / "jax")])
    convert_from_gadget_1.main([src, str(tmp_path / "port")])
    assert_same_bigfile(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_convert_hdf5_datasets_equal(tmp_path, jax_tool):
    """Every dataset and header attribute of the two HDF5 files equal."""
    h5py = pytest.importorskip("h5py")
    snap = str(tmp_path / "PART_000")
    write_snap(snap, gas={"InternalEnergy": np.arange(5, dtype="<f4"),
                          "Density": np.ones(5, "<f4")})
    a = jax_tool("convert_hdf5").convert(snap, str(tmp_path / "jax.hdf5"))
    b = convert_hdf5.convert(snap, str(tmp_path / "port.hdf5"))
    with h5py.File(a) as fa, h5py.File(b) as fb:
        names = []
        fa.visit(names.append)
        other = []
        fb.visit(other.append)
        assert names == other and "PartType0/InternalEnergy" in names
        for n in names:
            assert dict(fa[n].attrs).keys() == dict(fb[n].attrs).keys()
            for k, v in fa[n].attrs.items():
                assert np.array_equal(v, fb[n].attrs[k]), (n, k)
            if isinstance(fa[n], h5py.Dataset):
                assert np.array_equal(fa[n][()], fb[n][()]), n


# -- compare_snap ---------------------------------------------------------

def test_compare_snap_dr_equal_and_pk_ratio(tmp_path, jax_tool):
    """The same displacements (exactly) and the P(k) ratio within 1e-5,
    for a snapshot against a displaced copy of it."""
    a, b = str(tmp_path / "A"), str(tmp_path / "B")
    write_snap(a, n=512, seed=3)
    write_snap(b, n=512, seed=3, shift=7.5)
    dr_j, ratio_j = jax_tool("compare_snap").compare(a, b)
    dr, ratio = compare_snap.compare(a, b, device="cpu")
    assert np.array_equal(dr, dr_j)
    assert ratio.shape == ratio_j.shape and len(ratio) > 3
    np.testing.assert_allclose(ratio, ratio_j, rtol=1e-5, atol=0)


# -- the tables ----------------------------------------------------------

@pytest.mark.parametrize("example", ["dm-small", "lya"])
def test_make_class_power_tables_equal(tmp_path, jax_tool, monkeypatch,
                                       example):
    """The EH table of the example's paramfile.genic: byte for byte."""
    files = []
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        pf = d / "paramfile.genic"
        shutil.copy(REPO / "examples" / example / "paramfile.genic", pf)
        if side == "jax":
            run_main(monkeypatch, jax_tool("make_class_power"),
                     [str(pf), "--backend", "eh"])
        else:
            make_class_power.main([str(pf), "--backend", "eh"])
        files += [p for p in d.iterdir() if p.name.startswith("class_pk")]
    assert len(files) == 2
    assert files[0].read_bytes() == files[1].read_bytes()
    assert len(files[0].read_text().splitlines()) == 601


def test_make_HI_reionization_table(tmp_path, jax_tool, monkeypatch):
    """--ngrid 16: the z_re field within 1e-5 of the JAX tool's (by norm,
    relative to its departure from --zbar), the attributes equal."""
    args = ["--ngrid", "16", "--box", "5", "--zbar", "7"]
    run_main(monkeypatch, jax_tool("make_HI_reionization_table"),
             [str(tmp_path / "jax")] + args)
    make_HI_reionization_table.main([str(tmp_path / "port")] + args
                                    + ["--device", "cpu"])
    want = BigFile(str(tmp_path / "jax")).open("Zreion_Table")
    got = BigFile(str(tmp_path / "port")).open("Zreion_Table")
    w, g = want.read(), got.read()
    assert g.dtype == w.dtype and g.shape == w.shape == (16 ** 3,)
    dz = w.astype(np.float64) - 7.0
    assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(dz)
    for k in ("Nmesh", "BoxSize"):
        assert np.array_equal(np.asarray(got.attrs[k]),
                              np.asarray(want.attrs[k])), k
    np.testing.assert_allclose(np.asarray(got.attrs["Redshift"]),
                               np.asarray(want.attrs["Redshift"]),
                               rtol=1e-6)


def test_make_yield_tables_npz_equal(tmp_path, jax_tool, monkeypatch,
                                     capsys):
    """--npz: every grid equal; the printed check table equal."""
    run_main(monkeypatch, jax_tool("make_yield_tables"),
             ["--npz", str(tmp_path / "jax.npz")])
    out_jax = capsys.readouterr().out
    make_yield_tables.main(["--npz", str(tmp_path / "port.npz"),
                            "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.replace("port.npz", "jax.npz") == out_jax
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) > 4
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_table_genic_matches_the_eh_override(tmp_path):
    """make_class_power's table through the port's genic gives the IC of
    the Eisenstein-Hu override (WhichSpectrum 1, Sigma8 0.8,
    InputPowerRedshift 0) at Ngrid 16: velocities within 1e-4 by norm
    (2.0e-5 measured for dm-small, 7.8e-6 for lya's gas and DM)."""
    from mpgadget_tpu_torch.genic.main import run_genic
    from mpgadget_tpu_torch.params import create_genic_parameter_set
    ics = {}
    for side in ("table", "eh"):
        d = tmp_path / side
        d.mkdir()
        pf = d / "paramfile.genic"
        over = {"Ngrid": 16}
        if side == "eh":
            over.update(WhichSpectrum=1, Sigma8=0.8, InputPowerRedshift=0)
        else:
            shutil.copy(REPO / "examples" / "dm-small" / "paramfile.genic",
                        pf)
            make_class_power.main([str(pf), "--backend", "eh"])
        lines = [ln for ln in (REPO / "examples" / "dm-small"
                               / "paramfile.genic").read_text().splitlines()
                 if ln.split("=")[0].strip() not in over]
        pf.write_text("\n".join(lines + [f"{k} = {v}" for k, v in
                                         over.items()]) + "\n")
        ps = create_genic_parameter_set()
        ps.parse_file(str(pf))
        cwd = os.getcwd()
        os.chdir(d)
        try:
            run_genic(ps, device="cpu")
        finally:
            os.chdir(cwd)
        bf = BigFile(str(d / "IC" / "IC"))
        sp = snap_io.read_species(bf, 1, snap_io.read_header(bf))
        order = np.argsort(sp["pid"])
        ics[side] = sp["pos"][order], sp["vel"][order]
    (pa, va), (pb, vb) = ics["table"], ics["eh"]
    assert np.linalg.norm(va - vb) <= 1e-4 * np.linalg.norm(vb)
    d = pa - pb
    d -= np.round(d / 64000.0) * 64000.0
    assert np.abs(d).max() < 1.0      # kpc/h, of a 4000 kpc/h spacing


# -- the examples' checkers ---------------------------------------------

def power_file(path, k, p, nmodes, d1):
    with open(path, "w") as fh:
        fh.write(f"# in Mpc/h Units \n# D1 = {d1:g} \n# k P N P(z=0)\n")
        for row in zip(k, p, nmodes):
            fh.write(f"{row[0]:g} {row[1]:g} {int(row[2])} "
                     f"{row[1] / d1 ** 2:g}\n")


def spectra(out, rng, kmin, nfiles, growth, noise=0.02):
    """powerspectrum files from a linear spectrum P = k^-1.5 (written as
    the input spectrum beside them): each file's P times D1^2 with noise,
    D1 the first entry of growth, then the others."""
    k = kmin * np.arange(1, 40)
    nmodes = 4 * np.pi * np.arange(1, 40) ** 2
    lin = np.column_stack([np.logspace(np.log10(kmin) - 1,
                                       np.log10(k[-1]) + 1, 200)])
    lin = np.column_stack([lin[:, 0], lin[:, 0] ** -1.5])
    np.savetxt(out / "linear.txt", lin)
    for i, d1 in enumerate(growth[:nfiles]):
        p = k ** -1.5 * d1 ** 2 * (1 + noise * rng.standard_normal(len(k)))
        power_file(out / f"powerspectrum-{0.1 + 0.05 * i:0.4f}.txt", k, p,
                   nmodes, d1)


def gas_blocks(rng, n, ne=1.1, t0=1.2e4, gamma=1.5):
    """Gas rows on T = t0 delta^(gamma-1), ionized (electron abundance
    ne), u from T as the lya checker converts it."""
    delta = np.exp(rng.normal(0, 0.6, n))
    temp = t0 * delta ** (gamma - 1)
    mu = 4.0 / (1.0 + 3 * 0.76 + 4 * 0.76 * ne)
    u = temp * 1.38066e-16 / ((2.0 / 3.0) * 1e10 * mu * 1.6726e-24)
    return {"InternalEnergy": u.astype("<f4"),
            "Density": (delta * 3.0).astype("<f4"),
            "ElectronAbundance": np.full(n, ne, "<f4"),
            "Mass": np.full(n, 0.25, "<f4")}


def example_outputs(out, example, broken, seed=21):
    """Synthetic outputs of an example that its checks pass, or, broken,
    that one of them fails."""
    rng = np.random.default_rng(seed)
    out.mkdir()
    if example == "dm-small":
        spectra(out, rng, 0.1, 2, (0.1, 0.15))
        write_pig(str(out / "PIG_000"), 5, seed, stars=False)
        pig = str(out / "PIG_001")
        write_pig(pig, 12, seed + 1, stars=False)
        bf = BigFile(pig)
        mass = bf.open("FOFGroups/Mass").read()
        mass[0] = 2e3                  # 1e10 Msun/h: 2.9e13 Msun
        if broken:                     # the largest halo below 9e12 Msun
            mass *= 0.1
        bf.create_from_array("FOFGroups/Mass", mass)
    elif example == "lya":
        gas = gas_blocks(rng, 400, ne=0.1 if broken else 1.1)
        gas["_init"] = 410
        write_snap(str(out / "PART_000"), atime=1 / 3.0, gas=gas,
                   stars={"Mass": np.full(10, 0.25, "<f4")})
    elif example == "star-small":
        rate = np.abs(rng.normal(0, 1e-3, 20)) * (0 if broken else 1)
        np.savetxt(out / "sfr.txt", np.column_stack(
            [np.linspace(0.1, 0.2, 20), rate, rate, rate * 10, rate]))
        write_snap(str(out / "PART_000"), atime=0.2, gas=gas_blocks(rng, 30),
                   stars={"Mass": np.full(3, 0.2, "<f4"),
                          "Metallicity": np.full(3, 0.01, "<f4")})
    else:       # travis
        spectra(out, rng, 50.0, 3, (0.01, 0.013, 0.018))
        gas = gas_blocks(rng, 50)
        if broken:
            gas["Density"][7] = -1.0
        write_snap(str(out / "PART_000"), atime=0.015, gas=gas)
    return out


JAX_MAIN = {   # examples/<x>/check_results.py's __main__, as calls
    "dm-small": lambda m, out: (m.check_power(out, out + "/linear.txt"),
                                m.check_hmf(out)),
    "lya": lambda m, out: m.check_lya(out),
    "star-small": lambda m, out: (m.check_sfr_history(out),
                                  m.check_stars_in_snapshot(out)),
    "travis": lambda m, out: (m.check_linear_growth(out,
                                                    out + "/linear.txt"),
                              m.check_gas_state(out)),
}


@pytest.mark.parametrize("broken", [False, True], ids=["good", "broken"])
@pytest.mark.parametrize("example", sorted(JAX_MAIN))
def test_checker_against_check_results(tmp_path, example, broken):
    """The port's checks of an example and its check_results.py: both pass
    on synthetic outputs, both raise AssertionError on a broken copy."""
    jax_mod = load(f"examples/{example}/check_results.py",
                   f"check_results_{example.replace('-', '_')}")
    out = str(example_outputs(tmp_path / "output", example, broken))
    if broken:
        with pytest.raises(AssertionError):
            JAX_MAIN[example](jax_mod, out)
        with pytest.raises(AssertionError):
            check_examples.run_checks(example, out, out + "/linear.txt")
    else:
        JAX_MAIN[example](jax_mod, out)
        check_examples.run_checks(example, out, out + "/linear.txt")
    if example == "lya":      # its parts one by one, as the smoke calls them
        failed = []
        for part in check_examples.LYA_PARTS:
            try:
                part(out)
            except AssertionError:
                failed.append(part.__name__)
        assert failed == (["check_lya_ionized"] if broken else [])


@pytest.mark.parametrize("broken", [False, True], ids=["good", "broken"])
def test_golden_pk_check_against_check_results(tmp_path, broken):
    """dm-small's check_golden_pk (not in its __main__): both pass against
    a golden table equal to the last output, both raise where one bin is
    10% off (rtol 5e-2)."""
    jax_mod = load("examples/dm-small/check_results.py",
                   "check_results_dm_small")
    out = str(example_outputs(tmp_path / "output", "dm-small", False))
    golden = np.loadtxt(check_examples._power_files(out)[-1])
    if broken:
        golden[3, 1] *= 1.1
    np.savetxt(tmp_path / "golden.txt", golden)
    for fn in (jax_mod.check_golden_pk, check_examples.check_golden_pk):
        if broken:
            with pytest.raises(AssertionError):
                fn(out, str(tmp_path / "golden.txt"))
        else:
            fn(out, str(tmp_path / "golden.txt"))


# -- no JAX ---------------------------------------------------------------

# the calls, a json list of (module or tools/ file, argv), in sys.argv[1]
BLOCKER = """
import importlib.abc, json, runpy, sys
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mpgadget_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Blocker())
for mod, argv in json.loads(sys.argv[1]):
    sys.argv = [mod] + argv
    print("== " + mod, flush=True)
    if mod.endswith(".py"):
        runpy.run_path(mod, run_name="__main__")
    else:
        runpy.run_module(mod, run_name="__main__", alter_sys=True)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "mpgadget_tpu")]
assert not bad, bad
"""


def test_tools_run_without_jax(tmp_path):
    """Every twin's command line and the five tools that import neither
    package run in one process whose imports of jax and mpgadget_tpu
    fail, on temporary inputs; their outputs are there after."""
    t = str(tmp_path)
    write_pig(t + "/PIG_000", 10, seed=5)
    write_snap(t + "/A", n=64, seed=1)
    write_snap(t + "/B", n=64, seed=1, shift=1.0)
    gadget1_file(t + "/g1")
    shutil.copy(REPO / "examples" / "lya" / "paramfile.genic",
                t + "/paramfile.genic")
    example_outputs(tmp_path / "star", "star-small", False)
    (tmp_path / "cpu.txt").write_text(
        "Step 0\nName Seconds Percent\nPMgrav 1.0 50.0%\nTree 1.0 50.0%\n")
    (tmp_path / "bh" / "BlackholeDetails").mkdir(parents=True)
    np.arange(24, dtype=np.float64).tofile(
        t + "/bh/BlackholeDetails/BH-Details-R0")
    power_file(t + "/powerspectrum-0.2000.txt", np.arange(1, 30) * 0.1,
               np.arange(1, 30) ** -1.5, np.arange(1, 30) * 4, 0.5)
    tw = "mpgadget_tpu_torch.tools."
    calls = [
        (tw + "hmf_from_fof", [t + "/PIG_000", "8"]),
        (tw + "plot_gsmf", [t + "/PIG_000"]),
        (tw + "convert_from_gadget_1", [t + "/g1", t + "/g1_bf"]),
        (tw + "compare_snap", [t + "/A", t + "/B", "--device", "cpu"]),
        (tw + "make_class_power", [t + "/paramfile.genic", "--backend",
                                   "eh"]),
        (tw + "make_HI_reionization_table", [t + "/zreion", "--ngrid",
                                             "8", "--box", "5",
                                             "--device", "cpu"]),
        (tw + "make_yield_tables", ["--npz", t + "/y.npz", "--device",
                                    "cpu"]),
        (tw + "check_examples", ["star-small", t + "/star"]),
    ]
    if importlib.util.find_spec("h5py"):
        calls.append((tw + "convert_hdf5", [t + "/A", t + "/A.hdf5"]))
    for name, argv in (
            ("make_heii_reion_table", [t + "/heii.txt"]),
            ("parse_walltime", [t + "/cpu.txt"]),
            ("plot_powerspectrum", [t + "/powerspectrum-0.2000.txt",
                                    "-o", t + "/pk.png"]),
            ("read_bh_details", [t + "/bh"]),
            ("rebin_powerspectrum", [t + "/powerspectrum-0.2000.txt",
                                     "--nbins", "5"])):
        calls.append((str(REPO / "tools" / f"{name}.py"), argv))
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", BLOCKER, json.dumps(calls)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.count("== ") == len(calls)
    for f in ("g1_bf", "class_pk_99.dat", "zreion", "y.npz", "heii.txt",
              "pk.png"):
        assert os.path.exists(t + "/" + f), f
    assert "all star-small checks passed" in res.stdout


def test_twins_refuse_the_card_without_one(tmp_path):
    """No fallback: asked for the card (the default) where there is none,
    a twin exits with an error instead of computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        make_yield_tables.main([])
    write_snap(str(tmp_path / "A"), n=8)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        compare_snap.compare(str(tmp_path / "A"), str(tmp_path / "A"))
