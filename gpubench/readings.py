"""The readings that a cell's limits are set from: for each seed, the
numbers that ``check`` compares, of the program's output and of the
control (the reference computed in bfloat16, put in the program's
place), at the cell's own size, all seeds in one process.

    python3 -m gpubench.readings --workload <cell> --seeds 1,2,3
        [--seconds S] [--out file.jsonl]

Each seed runs the cell's set-up and a window of at least one PM step
(``--seconds`` long, 0 for exactly one), as a benchmark run does.  One
JSON line per seed: {"seed", "steps", "program": {...},
"control": {...}}.  The benchmark's own runs never run the control.
"""

import argparse
import json
import sys


def read_seed(workload, seed, seconds, device="cuda", root=None):
    from . import check, run as runmod
    run, state = runmod.measure(workload, seed, seconds, 0, device,
                                root or runmod.ROOT)
    cfg, traffic = run["cfg"], run["traffic"]
    return {"seed": seed, "steps": run["steps"],
            "program": check.readings(cfg, traffic, state),
            "control": check.readings(cfg, traffic, state, control=True)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gpubench.readings needs a CUDA card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        line = json.dumps(read_seed(args.workload, int(s), args.seconds))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
