"""Milliseconds per short-range tree-force evaluation in the window: all
of the StageTimer's synchronised laps (sort, build, walk, pack, pair,
unsort) over the evaluations it recorded."""


def read(ctx):
    timer = ctx["timer"]
    evals = len(timer.series.get("active_blocks", []))
    if not evals:
        return None
    return 1e3 * sum(timer.seconds.values()) / evals
