"""BENCHMARK.json and the files it names: every piece loads by its name,
a new cell or metric needs only new files, and nothing of the JAX side
is imported."""

import json
import re
import subprocess
import sys

import pytest

from gpubench import imports, run
from gpubench.tests.tiny import REPO, make_root

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(cell):
    bench, w, cfg, traffic, limits = run.load_cell(REPO, cell)
    assert w["chips"] == 1
    assert set(limits) == {"pm_err", "force_err", "kick_drift_err",
                           "setup_force_err"}
    assert {"redshift", "TimeMax"} <= set(traffic)
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    assert set(conf["reduced"]) <= set(cfg["published"])
    for key, value in cfg["published"].items():
        assert key in conf["reduced"] or cfg[key] == value


READERS = sorted(p.stem for p in (REPO / "gpubench" / "metrics").glob("*.py"))


def test_every_metric_has_a_reader():
    assert {m["name"] for m in BENCH["per_layer"]} <= set(READERS)


@pytest.mark.parametrize("metric", READERS)
def test_every_reader_loads_by_name(metric):
    assert callable(run.load_reader(REPO, metric).read)


def test_run_seconds_fits_a_full_check():
    # 24 cells: 2 + 14 x 24 runs of run_seconds + 60, 2 x 90 s of compile
    # a cell, 1200 s spare, within 43200 s
    s = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 180 + 1200 <= 43200


def test_a_new_cell_and_metric_are_only_new_files(tmp_path):
    root = make_root(tmp_path, cell="extra-z5", traffic="extra-z5")
    (root / "gpubench" / "traffic" / "extra-z5.json").write_text(
        json.dumps({"why": "a throwaway mix", "redshift": 5.0,
                    "TimeMax": 1.0}))
    reader = root / "gpubench" / "metrics" / "extra.count.py"
    reader.write_text("def read(ctx):\n    return ctx['n']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append(
        {"name": "extra.count", "unit": "rows", "better": "higher",
         "source": "program_counter", "layer": "step loop",
         "moves": "updates_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _, cell, cfg, traffic, _ = run.load_cell(root, "extra-z5")
    assert traffic["redshift"] == 5.0 and cfg["Ngrid"] == 16
    assert run.load_reader(root, "extra.count").read({"n": 7}) == 7


def test_top_level_names_are_compared_whole():
    assert imports.forbidden_loaded({"mpgadget_tpu_torch.run": 1,
                                     "numpy": 1}) == []
    assert imports.forbidden_loaded({"mpgadget_tpu.run": 1,
                                     "jaxlib.xla": 1}) == [
        "jaxlib", "mpgadget_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    names = imports.reference_imports(REPO / "gpubench" / "reference")
    assert not names & (imports.FORBIDDEN | {imports.PROGRAM})


def test_the_harness_loads_no_jax_side():
    code = ("import sys; import gpubench.run, gpubench.check, "
            "gpubench.trace, gpubench.readings, gpubench.sim; "
            "import mpgadget_tpu_torch.run, mpgadget_tpu_torch.main; "
            "from gpubench import imports; "
            "bad = imports.forbidden_loaded(); "
            "ref = {m for m in sys.modules if m.startswith('gpubench.ref')}; "
            "print(bad, sorted(ref)); assert not bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    code = ("import sys; import gpubench.reference.gravity, "
            "gpubench.reference.integrate, gpubench.reference.cosmology; "
            "assert not {m.split('.')[0] for m in sys.modules} & "
            "{'mpgadget_tpu_torch', 'mpgadget_tpu', 'jax', 'jaxlib'}")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_no_card_means_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin",
                          "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
