"""K2's share of its roofline bound (gpubench/roofline/k2.py) over the
window's tree evaluations, as the StageTimer recorded them, against its
device time in the trace."""

from gpubench.roofline import k2

KEYS = ("active_blocks", "with_potential", "walk_nodes", "walk_visits_sum",
        "walk_monopoles")


def read(ctx):
    series = ctx["timer"].series
    n = len(series.get("active_blocks", []))
    if not n or any(len(series.get(k, [])) != n for k in KEYS):
        return None
    dev_s = sum(s for name, s in ctx["tracer"].kernels.items()
                if any(k in name for k in k2.KERNELS))
    if dev_s <= 0:
        return None
    tg = ctx["tree_config"]
    return 100.0 * k2.bound_total_s(series, tg["G"], tg["LL"]) / dev_s
