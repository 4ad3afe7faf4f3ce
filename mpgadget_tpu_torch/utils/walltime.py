"""Hierarchical walltime measurement (libgadget/walltime.{c,h} analog).

Named timers with accumulated totals, dumped per step to cpu.txt in the
same "name seconds percent" spirit so tools/parsebench.py-style analysis
works.
"""

import time
from collections import defaultdict


class WallTime:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._open = {}
        self._t0 = time.monotonic()

    def start(self, name):
        self._open[name] = time.monotonic()

    def stop(self, name):
        t = self._open.pop(name, None)
        if t is not None:
            self.totals[name] += time.monotonic() - t
            self.counts[name] += 1

    def measure(self, name):
        """walltime_measure style: charge time since last measure."""
        now = time.monotonic()
        self.totals[name] += now - self._t0
        self.counts[name] += 1
        self._t0 = now

    def elapsed(self):
        return sum(self.totals.values())

    def summary(self) -> str:
        total = max(self.elapsed(), 1e-12)
        lines = ["Name Seconds Percent"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            s = self.totals[name]
            lines.append(f"{name} {s:.3f} {100 * s / total:.1f}%")
        return "\n".join(lines)

    def write_cpu_log(self, path, step):
        with open(path, "a") as fh:
            fh.write(f"Step {step}\n{self.summary()}\n")
