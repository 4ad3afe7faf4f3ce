"""The comparison that decides ``correct`` fails a broken timed path: a
whole run on the CPU at a tiny size (the harness's look for a card
skipped), with the program broken underneath, reads correct false.  The
cells run on one card, so there is no exchange between cards to leave
out.  And the control (the reference in bfloat16 in the program's
place) fails the cells' limits."""

import pytest
import torch
from unittest import mock

from gpubench import check, readings, run
from gpubench.tests.tiny import make_root

SEED = 2 ** 34 + 99


def _run(root):
    return run.run_cell("tiny-z9", SEED, 0.0, 0, device="cpu", root=root,
                        log=lambda *a: None)


def _half_left_out(fn):
    def broken(*args, **kwargs):
        res = fn(*args, **kwargs)
        keep = torch.arange(res.accel.shape[0]) % 2 == 0
        res.accel = torch.where(keep[:, None], res.accel, 0.0)
        return res
    return broken


def _altered(fn):
    def broken(*args, **kwargs):
        acc, pot, ps = fn(*args, **kwargs)
        return acc * 1.02, pot, ps
    return broken


def _unchanged(self, dti):
    return 0


@pytest.mark.parametrize("fault", ["none", "unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault):
    import mpgadget_tpu_torch.gravity.treepm as treepm
    import mpgadget_tpu_torch.run as prog
    root = make_root(tmp_path)
    if fault == "none":
        assert _run(root)["correct"]
        return
    # the set-up runs whole; the fault is planted for the window only
    measure = run.measure

    def faulty(name, seed, seconds, trace, device, root):
        patch = {
            "unchanged": mock.patch.object(prog.Simulation,
                                           "step_hierarchical", _unchanged),
            "half": mock.patch.object(treepm, "tree_force",
                                      _half_left_out(treepm.tree_force)),
            "altered": mock.patch.object(prog, "pm_force",
                                         _altered(prog.pm_force)),
        }[fault]
        from gpubench import sim as simmod
        step = simmod.step
        calls = {"n": 0}

        def step_in_window(sim, dti):
            calls["n"] += 1
            if calls["n"] == 1:       # the warm-up step
                return step(sim, dti)
            with patch:
                return step(sim, dti)

        with mock.patch.object(simmod, "step", step_in_window):
            return measure(name, seed, seconds, trace, device, root)

    with mock.patch.object(run, "measure", faulty):
        res = _run(root)
    assert not res["correct"], res["checks"]


def test_the_control_fails_the_limits(tmp_path):
    root = make_root(tmp_path)
    r = readings.read_seed("tiny-z9", SEED, 0.0, device="cpu", root=root)
    limits = run.load_cell(root, "tiny-z9")[4]
    assert check.judge(r["program"], limits)[0]
    assert not check.judge(r["control"], limits)[0]
