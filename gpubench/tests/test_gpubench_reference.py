"""The benchmark's initial conditions and plain reference against the
port's plain paths at tiny sizes on the CPU, and the work counts of the
roofline on known shapes."""

import math

import numpy as np
import pytest
import torch

from gpubench import check, ics
from gpubench.reference import gravity as refg
from gpubench.reference.cosmology import Background
from gpubench.roofline import k1, k2, peaks
from gpubench.tests.tiny import REPO, make_root

CFG = dict(BoxSize=1562.5, Ngrid=16, Nmesh=32, Omega0=0.288,
           OmegaLambda=0.712, OmegaBaryon=0.0472, HubbleParam=0.7,
           Sigma8=0.8, params={})


def test_ics_are_fixed_by_the_seed():
    a = ics.make_ics(CFG, 9.0, 2 ** 33 + 17, "cpu")
    b = ics.make_ics(CFG, 9.0, 2 ** 33 + 17, "cpu")
    c = ics.make_ics(CFG, 9.0, 2 ** 33 + 18, "cpu")
    for k in ("ipos", "vel", "mass", "ptype", "pid"):
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["ipos"], c["ipos"])
    assert a["ipos"].shape == (16 ** 3, 3) and int(a["ipos"].max()) < 2 ** 32


def test_a_field_seed_fixes_the_realization_and_the_seed_its_order():
    a = ics.make_ics(CFG, 9.0, 2 ** 33 + 17, "cpu", field_seed=181170)
    b = ics.make_ics(CFG, 9.0, 2 ** 33 + 18, "cpu", field_seed=181170)
    assert not torch.equal(a["pid"], b["pid"])
    ia, ib = torch.argsort(a["pid"]), torch.argsort(b["pid"])
    for k in ("ipos", "vel", "mass", "pid"):
        assert torch.equal(a[k][ia], b[k][ib])


def test_ics_hold_the_matter_of_the_box():
    out = ics.make_ics(CFG, 9.0, 5, "cpu")
    assert out["ptype"].eq(1).all()
    total = float(out["mass"].double().sum())
    bg = Background(0.288, 0.712, 0.0472, 0.7)
    assert total == pytest.approx(0.288 * bg.rho_crit * 1562.5 ** 3,
                                  rel=1e-6)


def test_background_matches_the_port():
    from mpgadget_tpu_torch.cosmology import Cosmology
    from mpgadget_tpu_torch.utils import get_unitsystem
    from mpgadget_tpu_torch.utils import constants as C
    cp = Cosmology(Omega0=0.288, OmegaLambda=0.712, OmegaBaryon=0.0472,
                   HubbleParam=0.7, TimeBegin=0.1).init_units(
        get_unitsystem(C.CM_PER_KPC, 1.989e43, 1e5))
    bg = Background(0.288, 0.712, 0.0472, 0.7)
    for a in (0.01, 0.1, 0.25, 1.0):
        assert bg.hubble_rate(a) == pytest.approx(cp.hubble_function(a),
                                                  rel=1e-6)
    assert bg.G == pytest.approx(cp.GravInternal, rel=1e-12)
    assert bg.growth_rate(0.1) == pytest.approx(cp.F_Omega(0.1), rel=1e-6)


def _state():
    out = ics.make_ics(CFG, 9.0, 11, "cpu")
    w = torch.ones(out["ipos"].shape[0]) * out["mass"]
    return out["ipos"], w


def test_mesh_force_matches_the_port():
    from mpgadget_tpu_torch.pm.gravity import PMConfig, pm_force
    ipos, mass = _state()
    G = Background(0.288, 0.712, 0.0472, 0.7).G
    acc, _, _ = pm_force(ipos, mass, PMConfig(nmesh=32, boxsize=1562.5,
                                              asmth=1.5, G=G))
    rows = torch.arange(0, ipos.shape[0], 7)
    ref = refg.pm_accel(ipos, mass, rows, 32, 1562.5, G, 1.5)
    assert float(check.rel_gaps(acc[rows], ref).max()) < 2e-5


def test_pair_sum_matches_the_ports_direct_sum():
    from mpgadget_tpu_torch.gravity.shortrange import \
        direct_shortrange_pairwise
    ipos, mass = _state()
    G = Background(0.288, 0.712, 0.0472, 0.7).G
    rs = 1.5 * 1562.5 / 32
    rcut, h = 6 * rs, 2.8 / 30 * 1562.5 / 16
    acc, _ = direct_shortrange_pairwise(
        ipos, mass, torch.ones(ipos.shape[0], dtype=torch.bool), 1562.5,
        1.0 / (2 * rs), rcut, 1.0 / h, with_potential=False)
    rows = torch.arange(0, ipos.shape[0], 5)
    ref = refg.shortrange_accel(ipos, mass, rows, 1562.5, G, rs, rcut, h)
    # the port's direct sum adds its float32 pair terms in float32
    assert float(check.rel_gaps(G * acc[rows], ref).max()) < 2e-4
    # chunked by pairs as small as one target at a time: the same sums
    small = refg.shortrange_accel(ipos, mass, rows[:9], 1562.5, G, rs,
                                  rcut, h, max_pairs=1)
    assert torch.allclose(small, ref[:9], rtol=1e-12, atol=0)


def test_the_control_is_coarser():
    ipos, mass = _state()
    rows = torch.arange(0, ipos.shape[0], 11)
    cfg = dict(CFG, params={})
    hi = check.reference_forces(ipos, mass, rows, cfg)
    lo = check.reference_forces(ipos, mass, rows, cfg, low=True)
    gap = check.gravity_numbers(*lo, *hi)
    assert gap["pm_err"] > 1e-3 and gap["force_err"] > 1e-3


def test_a_tiny_run_on_the_cpu_is_correct(tmp_path):
    from gpubench import run
    root = make_root(tmp_path)
    res = run.run_cell("tiny-z9", 2 ** 40 + 3, 0.0, 0, device="cpu",
                       root=root, log=lambda *a: None)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"updates_per_s", "setup_s"}
    assert set(res["checks"]) == {"pm_err", "force_err", "kick_drift_err",
                                  "setup_force_err"}
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert c["value"] < 1e-4


def _k1_launch(with_potential=False):
    # 2 blocks of 2 targets at the origin; sources 0.1 (and, wrapped,
    # 0.95) from them lie inside rcut 0.2, those at 0.3 outside; the
    # third slot of block 1 is past its count
    t = torch.zeros(2, 2)
    sx = torch.tensor([[0.1, 0.3, 0.95], [0.3, 0.3, 0.1]])
    zero = torch.zeros(2, 3)
    count = torch.tensor([3, 2], dtype=torch.int32)
    return dict(nb=2, G=2, count=count, rcut=0.2,
                with_potential=with_potential,
                sample=[t, t, t, sx, zero, zero], sample_count=count)


def test_roofline_counts_on_known_shapes():
    # K1: 2 blocks of 256 rows, 1000 sources, a quarter of the pairs
    # inside rcut at 64 operations, the rest at 15
    pairs = 256 * 1000
    ops = pairs // 4 * 64 + (pairs - pairs // 4) * 15
    nbytes = 4 * (3 * 512 + 4 * 1000 + 4 * 512 + 4 * 512 + 2)
    assert k1.launch_bound_s(2, 256, 1000, pairs // 4, False) == \
        pytest.approx(max(ops / peaks.FP32_OPS_PER_S,
                          nbytes / peaks.HBM_BYTES_PER_S))
    ln = _k1_launch()
    assert k1.pairs_within(*ln["sample"], ln["count"], 0.2) == (4, 10)
    # the sample's share, 4 of 10, scaled to the launch's 2 x 5 pairs
    assert k1.bound_total_s([ln, _k1_launch(True)]) == pytest.approx(
        k1.launch_bound_s(2, 2, 5, 4, False)
        + k1.launch_bound_s(2, 2, 5, 4, True))
    # K2: 10 visits, 3 monopoles on 256 targets, a 100-node tree
    ops = 10 * 44 + 3 * 256 * 64
    nbytes = 10 * 36 + 256 * 12 + 29 + 256 * 16 + 64 * 8 + 17
    assert k2.launch_bound_s(1, 256, 64, 100, 10, 3, False) == \
        pytest.approx(max(ops / peaks.FP32_OPS_PER_S,
                          nbytes / peaks.HBM_BYTES_PER_S))
    series = dict(active_blocks=[2, 2], with_potential=[False, True],
                  walk_nodes=[100, 100], walk_visits_sum=[10, 10],
                  walk_monopoles=[3, 3])
    assert math.isfinite(k2.bound_total_s(series, 256, 64))


def test_readers_on_a_known_trace():
    from gpubench import run
    from gpubench.trace import Tracer

    class Timer:
        seconds = {"sort": 0.1, "build": 0.3, "walk": 0.2, "pair": 0.4}
        series = dict(active_blocks=[2, 2], with_potential=[False, False],
                      walk_nodes=[100, 100], walk_visits_sum=[10, 10],
                      walk_monopoles=[3, 3])

    class Event:
        def __init__(self, ms):
            self.ms = ms

        def elapsed_time(self, end):
            return end.ms - self.ms

    tr = Tracer.__new__(Tracer)
    tr.notes = {"pm": [(Event(0.0), Event(2.0)), (Event(5.0), Event(9.0))],
                "k1": [_k1_launch(), _k1_launch()]}
    tr.kernels = {"void pair_items_kernel<1>(...)": 0.5,
                  "pair_reduce_kernel": 0.5, "tree_walk_kernel": 0.25}
    ctx = dict(tracer=tr, timer=Timer, step_log=[{"n_sub": 4},
                                                  {"n_sub": 8}],
               tree_config=dict(G=256, LL=64))
    got = {m: run.load_reader(REPO, m).read(ctx) for m in (
        "step.substeps_per_pm", "tree.ms_per_eval",
        "tree.sortbuild_ms_per_eval", "pm.ms_per_call", "k1_roofline",
        "k2_roofline")}
    assert got["step.substeps_per_pm"] == 6
    assert got["tree.ms_per_eval"] == pytest.approx(500.0)
    assert got["tree.sortbuild_ms_per_eval"] == pytest.approx(200.0)
    assert got["pm.ms_per_call"] == pytest.approx(3.0)
    assert got["k1_roofline"] == pytest.approx(
        100 * k1.bound_total_s(tr.notes["k1"]) / 1.0)
    assert got["k2_roofline"] == pytest.approx(
        100 * k2.bound_total_s(Timer.series, 256, 64) / 0.25)
    tr.kernels = {}
    assert run.load_reader(REPO, "k1_roofline").read(ctx) is None
    tr.notes = {}
    assert run.load_reader(REPO, "pm.ms_per_call").read(ctx) is None


def test_the_k1_watch_records_each_launch():
    from gpubench import run
    from gpubench.trace import Tracer
    from mpgadget_tpu_torch.gravity import pairkernel
    tr = Tracer.__new__(Tracer)
    tr.notes = {}
    nb, G, S = 3, 4, 8
    gen = torch.Generator().manual_seed(3)
    t = [torch.rand(nb, G, generator=gen) for _ in range(3)]
    src = [torch.rand(nb, S, generator=gen) for _ in range(4)]
    count = torch.tensor([8, 4, 0], dtype=torch.int32)
    args = (*t, *src, torch.zeros(nb, 3, G), torch.zeros(nb, G), 2.0,
            30.0, 0.3)
    want = pairkernel.block_pair_accumulate(*args, count=count)
    with run.load_reader(REPO, "k1_roofline").watch(tr):
        got = pairkernel.block_pair_accumulate(*args, count=count)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    (ln,) = tr.notes["k1"]
    assert (ln["nb"], ln["G"], ln["rcut"]) == (3, 4, 0.3)
    assert torch.equal(ln["count"], count)
    assert ln["sample"][3].shape == (64, 8)


def test_idle_gaps_are_named_by_the_innermost_span():
    from gpubench.trace import Tracer
    tr = Tracer.__new__(Tracer)
    tr.spans = [("tree", 0, 100), ("kick", 10, 20), ("pm", 200, 300)]
    assert tr._host_at([5, 15, 50, 150, 250]) == [
        "host:tree", "host:kick", "host:tree", "host:step", "host:pm"]


def test_sample_rows_fixed_by_seed():
    a = check.sample_rows(1000, 50, 2 ** 35, 1, "cpu")
    b = check.sample_rows(1000, 50, 2 ** 35, 1, "cpu")
    assert torch.equal(a, b) and int(a.max()) < 1000
    assert not torch.equal(a, check.sample_rows(1000, 50, 2 ** 35, 2,
                                                "cpu"))
    assert np.all(np.diff(a.numpy()) > 0)


def test_busy_time_and_idle_gaps_from_a_device_timeline():
    from gpubench.trace import Tracer

    class Ev:
        def __init__(self, name, s, d):
            self.n, self.s, self.d = name, s, d

        def name(self):
            return self.n

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.d

        def device_type(self):
            return torch.autograd.DeviceType.CUDA

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [Ev("k1", 100, 50), Ev("k2", 120, 80),
                            Ev("k1", 400, 100), Ev("late", 990, 100)]

    tr = Tracer.__new__(Tracer)
    tr.spans = [("tree", 0, 350), ("pm", 500, 1000)]
    tr.kernels, tr.gaps = {}, []
    tr._read_profile(Prof, 0, 1000)
    # busy: [100, 200] + [400, 500] + [990, 1000] = 210 ns
    assert tr.busy_s == pytest.approx(210e-9)
    assert tr.kernels == pytest.approx({"k1": 150e-9, "k2": 80e-9,
                                       "late": 100e-9})
    # idle: [0,100] and [200,400] under tree (mid 50, 300), [500,990] pm
    assert dict((n, s) for s, n in tr.gaps) == pytest.approx(
        {"host:tree": 300e-9, "host:pm": 490e-9})
