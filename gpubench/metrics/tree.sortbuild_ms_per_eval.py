"""Milliseconds per tree-force evaluation in the Morton sort and the tree
build (the StageTimer's "sort" and "build" laps): the full-N work that
every substep repeats however few rows are active."""


def read(ctx):
    timer = ctx["timer"]
    evals = len(timer.series.get("active_blocks", []))
    if not evals:
        return None
    s = timer.seconds
    return 1e3 * (s.get("sort", 0.0) + s.get("build", 0.0)) / evals
