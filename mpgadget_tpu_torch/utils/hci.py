"""Human-computer interface (libgadget/hci.{c,h}).

Polls control files dropped in the output directory:
* ``stop``       — checkpoint and stop
* ``checkpoint`` — checkpoint and continue
* ``terminate``  — stop immediately without output
plus automatic checkpointing on a wall-clock cadence (AutoSnapshotTime)
and a TimeLimitCPU budget that stops before the next (PM) step would
exceed the remaining time (hci.h:4-36, run.c:391-398).
"""

import os
import time
from dataclasses import dataclass, field

HCI_NO_ACTION = 0
HCI_STOP = 1
HCI_CHECKPOINT = 2
HCI_TERMINATE = 3
HCI_TIMEOUT = 4
HCI_AUTO_CHECKPOINT = 5


@dataclass
class HCIManager:
    output_dir: str
    time_limit_cpu: float = 0.0       # seconds; 0 = unlimited
    auto_checkpoint_time: float = 0.0  # seconds; 0 = disabled
    _start: float = field(default_factory=time.monotonic)
    _last_checkpoint: float = field(default_factory=time.monotonic)
    longest_step: float = 0.0

    def _consume(self, name):
        path = os.path.join(self.output_dir, name)
        if os.path.exists(path):
            os.remove(path)
            return True
        return False

    def update_longest_step(self, seconds):
        self.longest_step = max(self.longest_step, seconds)

    def query(self) -> int:
        """Check control files and budgets (hci_query)."""
        if self._consume("terminate"):
            return HCI_TERMINATE
        if self._consume("stop"):
            return HCI_STOP
        if self._consume("checkpoint"):
            self._last_checkpoint = time.monotonic()
            return HCI_CHECKPOINT
        elapsed = time.monotonic() - self._start
        if self.time_limit_cpu > 0 and \
                elapsed + 1.5 * self.longest_step > self.time_limit_cpu:
            return HCI_TIMEOUT
        if self.auto_checkpoint_time > 0 and \
                (time.monotonic() - self._last_checkpoint
                 > self.auto_checkpoint_time):
            self._last_checkpoint = time.monotonic()
            return HCI_AUTO_CHECKPOINT
        return HCI_NO_ACTION
