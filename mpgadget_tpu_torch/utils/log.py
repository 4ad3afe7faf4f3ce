"""Rank-gated logging and the fatal abort (message/endrun analog,
libgadget/utils/endrun.c and system.c's message), PyTorch port of
mpgadget_tpu/utils/log.py: on a multi-rank job only rank 0 speaks, and a
fatal error ends every rank instead of leaving the others waiting in a
collective."""

import os
import sys
import time

_T0 = time.monotonic()


def _dist():
    """(rank, world size) of the process group once it is initialised
    (parallel/collectives.py), else (0, 1)."""
    from ..parallel import collectives as coll
    if coll.is_initialized():
        return coll.world()[:2]
    return 0, 1


def message(fmt, *args, all_ranks=False):
    """Rank-0 print with an elapsed-walltime prefix (message(),
    system.c).  all_ranks=True prints on every rank, tagged."""
    rank = _dist()[0]
    if rank != 0 and not all_ranks:
        return
    txt = fmt % args if args else fmt
    tag = f"[{time.monotonic() - _T0:9.2f}] "
    if all_ranks and rank != 0:
        tag += f"(rank {rank}) "
    print(tag + txt, flush=True)


def endrun(code, fmt, *args):
    """Fatal abort (endrun, endrun.c:47): prints on the failing rank, then
    on a multi-rank job ends this process at once with a non-zero code, so
    that the launcher tears the others down; a RuntimeError there would
    leave them blocked in a collective.  One rank raises RuntimeError."""
    txt = fmt % args if args else fmt
    rank, size = _dist()
    print(f"ENDRUN {code} (rank {rank}): {txt}", file=sys.stderr,
          flush=True)
    if size > 1:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(int(code) or 1)
    raise RuntimeError(txt)
