"""Substeps per PM step in the window (Simulation.step_log's n_sub)."""


def read(ctx):
    log = ctx["step_log"]
    if not log:
        return None
    return sum(e["n_sub"] for e in log) / len(log)
