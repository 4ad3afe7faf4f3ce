"""The port's CPU runs of tests/test_torch_gas_run.py and
tests/test_torch_star_run.py, measured against their committed JAX
records on a machine without JAX (for example the card's host, with
CUDA_VISIBLE_DEVICES set empty): how far the port's own CPU run moves
between machines.

    CUDA_VISIBLE_DEVICES= python3 host_cpu_runs.py [out.json]

Each test module is imported with the JAX package's entry points stubbed
(only its port side runs); prints, for every state the tests compare, the
largest position difference in fixed-point ticks (the tests allow 0, 16
and 32) and the largest relative difference by norm over the compared
columns (the tests allow 1e-5 and 2e-5), and writes them to out.json.
"""

import json
import os
import sys
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _stub_jax_package():
    """mpgadget_tpu's two entry points the test modules import at the top;
    calling either fails (the JAX side is the committed record)."""
    def unavailable(*a, **k):
        raise RuntimeError("the JAX package is not run here")
    for name, attr in (("mpgadget_tpu.main", "build_simulation"),
                       ("mpgadget_tpu.params",
                        "create_gadget_parameter_set")):
        mod = types.ModuleType(name)
        setattr(mod, attr, unavailable)
        sys.modules[name] = mod
    sys.modules.setdefault("mpgadget_tpu", types.ModuleType("mpgadget_tpu"))


def _spread(a, b, keys):
    """The largest tick difference (of the spawned stars apart: the star
    test allows them 1024) and the largest relative difference by norm."""
    d = np.abs((np.asarray(b["ipos"], np.int64)
                - np.asarray(a["ipos"], np.int64) + 2 ** 31) % 2 ** 32
               - 2 ** 31)
    d = d.reshape(d.shape[0], -1).max(axis=1)
    spawned = np.asarray(a["pid"]) >= 2 ** 40 if "pid" in a else \
        np.zeros(d.shape[0], bool)
    out = {"ticks": int(d[~spawned].max(initial=0)),
           "spawned_ticks": int(d[spawned].max(initial=0))}
    rel = {}
    for k in keys:
        if k in a and k in b:
            x = np.asarray(a[k], np.float64)
            y = np.asarray(b[k], np.float64)
            rel[k] = float(np.linalg.norm(y - x)
                           / max(np.linalg.norm(x), 1e-300))
    worst = max(rel, key=rel.get)
    return dict(out, max_rel=rel[worst], max_rel_column=worst)


def main(argv):
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    _stub_jax_package()
    import tempfile
    import torch
    torch.set_num_threads(1)
    import test_torch_gas_run as G
    import test_torch_star_run as R
    out = {"cpu": os.uname().machine, "torch": torch.__version__}
    with tempfile.TemporaryDirectory() as tmp:
        from pathlib import Path
        t0 = time.perf_counter()
        got = G.run_package("torch", str(G.IC), Path(tmp) / "gas")
        rec = G.read_record()
        keys = ("vel", "hsml") + G.SPH_FIELDS
        out["gas_run"] = {part: _spread(rec[part], got[part], keys)
                          for part in ("first", "global", "hier")}
        out["gas_run_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = R.run_package("torch", str(R.IC), Path(tmp) / "star")
        rec = R.read_record()
        keys = R.PDATA + R.SPH + tuple("star_" + s for s in R.STARS)
        out["star_run"] = {f"{c}/{part}": _spread(rec[c][part],
                                                  got[c][part], keys)
                           for c in R.CONFIGS for part in ("global", "hier")}
        out["star_run_seconds"] = time.perf_counter() - t0
    text = json.dumps(out, indent=1)
    print(text)
    if argv:
        os.makedirs(os.path.dirname(os.path.abspath(argv[0])), exist_ok=True)
        with open(argv[0], "w") as fh:
            fh.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
