"""Milliseconds per long-range force (pm_force) on the card: CUDA events
recorded on the stream before and after each call in the window, read
once the window has closed (no synchronisation inside it)."""

import contextlib
from unittest import mock

import torch


@contextlib.contextmanager
def watch(tracer):
    if tracer.device.type != "cuda":      # no card's clock to read
        yield
        return
    from mpgadget_tpu_torch import run
    events = tracer.notes.setdefault("pm", [])
    inner = run.pm_force

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            return inner(*args, **kwargs)
        finally:
            end.record()
            events.append((start, end))

    with mock.patch.object(run, "pm_force", timed):
        yield


def read(ctx):
    events = ctx["tracer"].notes.get("pm")
    if not events:
        return None
    return sum(s.elapsed_time(e) for s, e in events) / len(events)
