"""Integer timeline and sync points.

The simulated log(a) span is mapped piecewise onto an integer timeline:
each interval between consecutive sync points (output times) covers
TIMEBASE = 2**TIMEBINS integer ticks, so ti = (sync_index << TIMEBINS) + dti
(reference: libgadget/timebinmgr.{c,h}; TIMEBINS=46, timebinmgr.h:13-15).

Host-side Python ints (arbitrary precision) — the timeline never goes on
device; device code receives the float dloga/drift/kick factors instead.
"""

from dataclasses import dataclass, field
from typing import List, Optional
import numpy as np

TIMEBINS = 46
TIMEBASE = 1 << TIMEBINS
MAXSNAPSHOTS = 1 << (62 - TIMEBINS)


@dataclass
class SyncPoint:
    a: float
    loga: float
    write_snapshot: bool = False
    write_fof: bool = False
    calc_uvbg: bool = False
    write_plane: bool = False
    ti: int = 0


class Timeline:
    """Sync-point list + ti<->loga conversions (setup_sync_points,
    timebinmgr.c:73-180)."""

    def __init__(self, output_times, TimeIC: float, TimeMax: float,
                 SnapshotWithFOF: bool = False,
                 no_snapshot_until_time: float = 0.0):
        times = sorted(set(float(t) for t in output_times))
        if len(times) > MAXSNAPSHOTS:
            raise ValueError("too many output times")
        self.syncpoints: List[SyncPoint] = []

        def add(a, **kw):
            self.syncpoints.append(SyncPoint(a=a, loga=np.log(a), **kw))

        # The simulation start is always a sync point; the end always is.
        if not times or times[0] > TimeIC:
            add(TimeIC)
        for t in times:
            if t < TimeIC or t > TimeMax:
                continue
            write_snap = t > no_snapshot_until_time
            add(t, write_snapshot=write_snap,
                write_fof=write_snap and SnapshotWithFOF)
        if not self.syncpoints or self.syncpoints[-1].a < TimeMax:
            add(TimeMax, write_snapshot=True,
                write_fof=SnapshotWithFOF)
        for i, sp in enumerate(self.syncpoints):
            sp.ti = i << TIMEBINS

    # -- conversions --------------------------------------------------

    def _interval_dloga(self, ti: int) -> float:
        lastsnap = ti >> TIMEBINS
        if lastsnap >= len(self.syncpoints) - 1:
            return 0.0
        return ((self.syncpoints[lastsnap + 1].loga
                 - self.syncpoints[lastsnap].loga) / TIMEBASE)

    def loga_from_ti(self, ti: int) -> float:
        lastsnap = ti >> TIMEBINS
        if lastsnap > len(self.syncpoints):
            raise ValueError(f"ti {ti} beyond last sync point")
        lastsnap = min(lastsnap, len(self.syncpoints) - 1)
        last = self.syncpoints[lastsnap].loga
        dti = ti & (TIMEBASE - 1)
        return last + dti * self._interval_dloga(ti)

    def ti_from_loga(self, loga: float) -> int:
        if len(self.syncpoints) < 2:
            return 0  # degenerate timeline (start == end)
        i = 1
        while i < len(self.syncpoints) - 1 and self.syncpoints[i].loga <= loga:
            i += 1
        dloga_tick = (self.syncpoints[i].loga
                      - self.syncpoints[i - 1].loga) / TIMEBASE
        ti = (i - 1) << TIMEBINS
        ti += int((loga - self.syncpoints[i - 1].loga) / dloga_tick)
        return ti

    def dloga_from_dti(self, dti: int, ti_current: int) -> float:
        return dti * self._interval_dloga(ti_current)

    def dti_from_dloga(self, dloga: float, ti_current: int) -> int:
        ti = self.ti_from_loga(self.loga_from_ti(ti_current))
        tip = self.ti_from_loga(dloga + self.loga_from_ti(ti_current))
        return tip - ti

    def get_dloga_for_bin(self, timebin: int, ti_current: int) -> float:
        return dti_from_timebin(timebin) * self._interval_dloga(ti_current)

    # -- sync point lookup --------------------------------------------

    def find_next_sync_point(self, ti: int) -> Optional[SyncPoint]:
        for sp in self.syncpoints:
            if sp.ti > ti:
                return sp
        return None

    def find_current_sync_point(self, ti: int) -> Optional[SyncPoint]:
        for sp in self.syncpoints:
            if sp.ti == ti:
                return sp
        return None

    @property
    def ti_end(self) -> int:
        return self.syncpoints[-1].ti


def dti_from_timebin(bin: int) -> int:
    return (1 << bin) if bin > 0 else 0


def round_down_power_of_two(ti: int) -> int:
    """Largest power of two <= ti, capped at TIMEBASE
    (timebinmgr.c round_down_power_of_two)."""
    if ti <= 0:
        return 0
    p = 1 << (ti.bit_length() - 1)
    return min(p, TIMEBASE)


def get_timestep_bin(dti: int) -> int:
    """Timebin index such that 2^bin <= dti (timestep.c:get_timestep_bin)."""
    if dti <= 1:
        return 0
    return dti.bit_length() - 1
