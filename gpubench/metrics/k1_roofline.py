"""K1's share of its roofline bound (gpubench/roofline/k1.py) over the
window's launches, against its device time in the trace.  The watch
records each launch's block counts and a copy of the targets and
sources of 64 of its blocks (drawn with repeats), from which the pairs
inside rcut are counted once the window has closed."""

import contextlib
import inspect
from unittest import mock

import torch

from gpubench.roofline import k1

SAMPLE_BLOCKS = 64


@contextlib.contextmanager
def watch(tracer):
    from mpgadget_tpu_torch.gravity import pairkernel
    launches = tracer.notes.setdefault("k1", [])
    inner = pairkernel.block_pair_accumulate
    sig = inspect.signature(inner)
    gens = {}

    def watched(*args, **kwargs):
        a = sig.bind(*args, **kwargs)
        a.apply_defaults()
        a = a.arguments
        tx = a["tx"]
        if tx.device not in gens:
            gens[tx.device] = torch.Generator(tx.device).manual_seed(0)
        # drawn on the card, so that the host does not wait for it
        pick = torch.randint(tx.shape[0], (SAMPLE_BLOCKS,),
                             generator=gens[tx.device], device=tx.device)
        count = a["count"][pick]
        # the sources past the sample's longest count are padding: one
        # synchronisation a launch keeps the copy small
        width = int(count.max())
        launches.append(dict(
            nb=tx.shape[0], G=tx.shape[1], count=a["count"].clone(),
            rcut=float(a["rcut"]), with_potential=bool(a["with_potential"]),
            sample=[a[k][pick].clone() for k in ("tx", "ty", "tz")]
            + [a[k][pick, :width].clone() for k in ("sx", "sy", "sz")],
            sample_count=count))
        return inner(*args, **kwargs)

    with mock.patch.object(pairkernel, "block_pair_accumulate", watched):
        yield


def read(ctx):
    tracer = ctx["tracer"]
    launches = tracer.notes.get("k1")
    dev_s = sum(s for name, s in tracer.kernels.items()
                if any(k in name for k in k1.KERNELS))
    if not launches or dev_s <= 0:
        return None
    bound = k1.bound_total_s(launches)
    return None if bound is None else 100.0 * bound / dev_s
