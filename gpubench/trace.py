"""What a ``--trace 1`` run adds: the tree's StageTimer, host spans around
the calls into the program's layers, what each per-layer metric's reader
watches (its optional ``watch(tracer)``), and a CUDA-only
``torch.profiler`` trace of the window.  Nothing of this is installed in
a ``--trace 0`` run.

Host spans are taken with ``time.time_ns()``, the clock the profiler's
events carry, so that an idle stretch of the card can be named by the
span the host was in.  They do not synchronise the card; the
StageTimer does, at each of the tree's stages, so the traced window's
idle share includes those synchronisations.
"""

import contextlib
import heapq
import time
from unittest import mock

import torch

# (module path, attribute) -> span name; the innermost open span names an
# idle gap.  Each is a function the window's step calls by that name.
HOST_SPANS = (
    ("mpgadget_tpu_torch.run", "assign_particle_bins", "bins"),
    ("mpgadget_tpu_torch.run", "pm_force", "pm"),
    ("mpgadget_tpu_torch.gravity.treepm", "tree_force", "tree"),
    ("mpgadget_tpu_torch.run.Simulation", "_bin_half_kick", "kick"),
    ("mpgadget_tpu_torch.run.Simulation", "_drift_all", "drift"),
    ("mpgadget_tpu_torch.run.Simulation", "find_pm_timestep",
     "pm_timestep"),
)


def resolve(path):
    """The module or class that ``path`` names."""
    import importlib
    parts = path.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for p in parts[i:]:
            obj = getattr(obj, p)
        return obj
    raise ImportError(path)


def _device_events(prof):
    """(name, start_ns, end_ns) of every operation the profiler saw on
    the card, in the wall clock's nanoseconds."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and e.duration_ns() > 0]


class Tracer:
    def __init__(self, device, watches=()):
        from mpgadget_tpu_torch.gravity.treepm import StageTimer
        self.device = torch.device(device)
        self.timer = StageTimer()  # the harness hands it to each Simulation
        self.watches = watches   # readers' watch(tracer) context managers
        self.notes = {}          # what the watches record, by their name
        self.spans = []          # (name, start_ns, end_ns)
        self.window_s = 0.0
        self.kernels = {}        # device op name -> seconds
        self.busy_s = 0.0
        self.gaps = []           # (idle seconds, host span), by span

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wrap(self, fn, name):
        spans = self.spans

        def wrapped(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                spans.append((name, t0, time.time_ns()))
        return wrapped

    @contextlib.contextmanager
    def window(self):
        """Trace the window: spans, the tree's stages, the readers'
        watches and the card."""
        from torch.profiler import ProfilerActivity, profile
        with contextlib.ExitStack() as stack:
            for path, attr, name in HOST_SPANS:
                owner = resolve(path)
                stack.enter_context(mock.patch.object(
                    owner, attr, self._wrap(getattr(owner, attr), name)))
            for watch in self.watches:
                stack.enter_context(watch(self))
            prof = None
            if self.device.type == "cuda":
                prof = stack.enter_context(
                    profile(activities=[ProfilerActivity.CUDA]))
            t0 = time.time_ns()
            yield self
            self._sync()
            t1 = time.time_ns()
        self.window_s = (t1 - t0) * 1e-9
        if prof is not None:
            self._read_profile(prof, t0, t1)

    def _read_profile(self, prof, t0, t1):
        ivals = []
        for name, s, e in _device_events(prof):
            self.kernels[name] = self.kernels.get(name, 0.0) \
                + (e - s) * 1e-9
            if min(e, t1) > max(s, t0):
                ivals.append((max(s, t0), min(e, t1)))
        ivals.sort()
        merged = []
        for s, e in ivals:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        edges = [t0] + [x for iv in merged for x in iv] + [t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        by_name = {}
        for (a, b), name in zip(gaps, self._host_at(
                [(a + b) // 2 for a, b in gaps])):
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
        self.gaps = sorted(((v, k) for k, v in by_name.items()),
                           reverse=True)

    def _host_at(self, times):
        """For each time (ascending), the innermost span open then, or
        "host:step" outside every span."""
        spans = sorted(self.spans, key=lambda sp: sp[1])
        heap, out, j = [], [], 0
        for t in times:
            while j < len(spans) and spans[j][1] <= t:
                heapq.heappush(heap, (-spans[j][1], spans[j][2],
                                      spans[j][0]))
                j += 1
            while heap and heap[0][1] < t:
                heapq.heappop(heap)
            out.append("host:" + (heap[0][2] if heap else "step"))
        return out

    def breakdown(self):
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[n, s] for s, n in self.gaps[:10]]}
