"""One run of one cell of BENCHMARK.json on one CUDA card.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (timed as ``setup_s``, from the process's first line to the
window): the kernels (built once per checkout into ``build/kernels/``),
the initial conditions made on the card from the seed, the port's
Simulation built through ``main.build_simulation``, ``run()``'s opening
forces and one warm-up PM step.  That state is kept as the template of
the window's episodes, and one unmeasured episode is run from it.  The
window runs whole episodes until ``--seconds`` have passed: each is a
copy of the template driven by ``Simulation.step_hierarchical`` as
``Simulation.run``'s loop drives it, PM step after PM step to the
traffic's ``TimeMax``, so that every window does the same work in the
same order however fast the program is.  After the window the
program's state is freed and the plain reference judges what the last
episode produced.

The last line of standard output is one JSON object; the numbers compared
with their limits are the last lines of standard error and the last key
of that object.  Exit codes: 2 without enough CUDA cards, 3 when a
module of the JAX side is loaded; neither prints a result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import copy  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
K_FORCE = 4096       # rows drawn for the force comparisons
K_KICK = 65536       # rows drawn for the kick-drift comparison
GIB = 2.0 ** 30


def load_cell(root, name):
    """(BENCHMARK.json, the cell, its configuration, traffic, limits)."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "gpubench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    limits = json.loads((root / "gpubench" / "limits"
                         / f"{name}.json").read_text())
    return bench, cell, cfg, traffic, limits


def load_reader(root, name):
    """The module gpubench/metrics/<name>.py: its ``read(ctx)``, and
    optionally ``watch(tracer)``, a context manager entered for the
    traced window."""
    path = Path(root) / "gpubench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gather(sim, rows, names):
    pd = sim.pdata
    return {k: getattr(pd, k)[rows].clone() for k in names}


START_FIELDS = ("ipos", "vel", "grav_pm", "grav_accel")
END_FIELDS = ("ipos", "vel", "grav_pm", "grav_accel", "timebin", "ptype")


def measure(name, seed, seconds, trace, device="cuda", root=ROOT):
    """Set up, run the window and free the program's state.  Returns
    (run, state): what the run measured, and what the reference needs to
    judge the window's output (device tensors of the sampled rows, the
    final positions and masses)."""
    import torch
    from . import check, ics as icmod, imports
    from . import sim as simmod
    bench, cell, cfg, traffic, limits = load_cell(root, name)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    workdir = tempfile.mkdtemp(prefix="gpubench-")
    try:
        ics = icmod.make_ics(cfg, traffic["redshift"], seed, dev,
                             traffic.get("field_seed"))
        n = ics["pid"].shape[0]
        sim = simmod.build(cfg, traffic, ics, workdir, dev)
        del ics
        simmod.setup_state(sim)
        rows_f = check.sample_rows(n, K_FORCE, seed, 1, dev)
        setup_acc = (sim.pdata.grav_pm[rows_f].clone(),
                     sim.pdata.grav_accel[rows_f].clone())
        simmod.step(sim, simmod.pm_timestep(sim))    # one warm-up PM step
        # every episode of the window starts from this state; one more,
        # unmeasured, warms what the window's episodes reuse
        template = copy.deepcopy(sim)
        simmod.episode(sim)
        del sim
        sync()
        setup_s = time.perf_counter() - T_START

        tracer, readers = None, {}
        if trace:
            from .trace import Tracer
            readers = {m["name"]: load_reader(root, m["name"])
                       for m in bench["per_layer"]}
            tracer = Tracer(dev, [r.watch for r in readers.values()
                                  if hasattr(r, "watch")])
        rows_k = check.sample_rows(n, K_KICK, seed, 2, dev)
        steps = updates = episodes = 0
        step_log, last = [], None

        def before(sim, dti):
            nonlocal last       # the window's last PM step, for the check
            last = dict(start=_gather(sim, rows_k, START_FIELDS),
                        t0=sim.ti_current, dti=dti,
                        offset_before=sim._ipos_offset.copy())

        with (tracer.window() if tracer else contextlib.nullcontext()):
            t0 = time.perf_counter()
            while True:
                # one episode: the traffic's span of PM steps, to TimeMax
                sim = copy.deepcopy(template)
                if tracer:
                    sim.tree_timer = tracer.timer
                evals0, log0 = sim.force_evals, len(sim.step_log)
                steps += simmod.episode(sim, before)
                sync()
                episodes += 1
                updates += sim.force_evals - evals0
                step_log += sim.step_log[log0:]
                if time.perf_counter() - t0 >= seconds:
                    break
                del sim
            elapsed = time.perf_counter() - t0
        sim.tree_timer = None
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        bad = imports.forbidden_loaded()
        if bad:
            raise ForbiddenModules(bad)

        layer = {}
        if tracer:
            tg = sim._tree_grav
            ctx = dict(tracer=tracer, timer=tracer.timer,
                       step_log=step_log, tree_config=dict(
                           G=tg.tree_cfg.group_max,
                           LL=tg.walk_cfg.leaf_list_max))
            for mname, reader in readers.items():
                v = reader.read(ctx)
                if v is not None:
                    layer[mname] = v

        # the window's output, then the program's state freed
        last["end"] = _gather(sim, rows_k, END_FIELDS)
        last["offset_after"] = sim._ipos_offset.copy()
        valid = sim.pdata.valid
        ipos_end = sim.pdata.ipos[valid].clone()
        mass_end = sim.pdata.mass[valid].clone()
        rows_e = check.sample_rows(ipos_end.shape[0], K_FORCE, seed, 3, dev)
        end_acc = (sim.pdata.grav_pm[valid][rows_e].clone(),
                   sim.pdata.grav_accel[valid][rows_e].clone())
        del sim, template, valid
        if tracer:
            tracer.notes.clear()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    run = dict(bench=bench, cell=cell, cfg=cfg, traffic=traffic,
               limits=limits, steps=steps, updates=updates,
               episodes=episodes, elapsed=elapsed, setup_s=setup_s,
               peak=peak, layer=layer, tracer=tracer, device=dev)
    state = dict(rows_f=rows_f, setup_acc=setup_acc, ipos_end=ipos_end,
                 mass_end=mass_end, rows_e=rows_e, end_acc=end_acc,
                 last=last, seed=seed)
    return run, state


def run_cell(name, seed, seconds, trace, device="cuda", root=ROOT,
             log=None):
    """Run one cell and return the result object (a dict)."""
    import torch
    from . import check
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    run, state = measure(name, seed, seconds, trace, device, root)
    cfg, traffic, bench = run["cfg"], run["traffic"], run["bench"]
    dev, peak, tracer = run["device"], run["peak"], run["tracer"]
    cuda = dev.type == "cuda"
    values = {"updates_per_s": run["updates"] / run["elapsed"],
              "setup_s": run["setup_s"]}
    t_ref = time.perf_counter()
    numbers = check.readings(cfg, traffic, state)
    t_ref = time.perf_counter() - t_ref
    correct, checks = check.judge(numbers, run["limits"])

    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    if trace:
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in run["layer"].items()}
    else:
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]}
                   for m in bench["end_to_end"]}
    devinfo = {"platform": "gpu" if cuda else dev.type,
               "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
               "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": run["steps"],
              "failed": 0, "metrics": metrics, "device": devinfo}
    if tracer:
        devinfo["busy_s"] = tracer.busy_s
        devinfo["window_s"] = tracer.window_s
        result["breakdown"] = tracer.breakdown()
    log(f"[gpubench] {name} seed {seed}: {run['episodes']} episodes, "
        f"{run['steps']} PM steps, "
        f"{run['updates']} updates in {run['elapsed']:.3f} s, setup "
        f"{run['setup_s']:.3f} s, peak {peak / GIB:.3f} GiB, reference "
        f"{t_ref:.3f} s")
    for k, c in checks.items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    result["checks"] = checks
    return result


class ForbiddenModules(RuntimeError):
    pass


def card_line():
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, cell, _, _, _ = load_cell(ROOT, args.workload)
    import torch
    from . import imports
    need = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"gpubench: {args.workload} needs {need} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"[gpubench] card {card_line()}", file=sys.stderr, flush=True)
    bad = imports.forbidden_loaded()
    if bad:
        print(f"gpubench: modules of the JAX side loaded: {bad}",
              file=sys.stderr)
        return 3
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          args.trace)
    except ForbiddenModules as exc:
        print(f"gpubench: modules of the JAX side loaded: {exc}",
              file=sys.stderr)
        return 3
    bad = imports.forbidden_loaded()
    if bad:
        print(f"gpubench: modules of the JAX side loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
