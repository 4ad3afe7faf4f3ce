"""Collective helpers of the sharded (multi-rank) path: the only module of
the port that calls ``torch.distributed``.

PyTorch port of mpgadget_tpu/parallel/collectives.py.  The reference's MPI
alltoallv / Isend patterns (exchange.c, petapm.c, treewalk.c; SURVEY §2.2)
become ``torch.distributed`` collectives over one process per rank: NCCL
between cards, gloo on the CPU (and, when asked for, between ranks that
share one card).  Every function takes the :class:`~.mesh.ShardMesh` of
the run in place of the JAX package's mesh-axis name.

Arrays are variable-length per rank: an exchange first swaps its
per-destination row counts (``all_to_all_single`` of int64), then moves
the rows with split sizes.  Complex tensors travel as
``torch.view_as_real``.

Accounting: every collective adds the bytes this rank sends to other
ranks to ``STATS["bytes"]`` and one to ``STATS["calls"]``; with
``TIMED = True``
each one also synchronises the device before and after itself and adds
its host-clock seconds to ``STATS["seconds"]``.
"""

import datetime
import time

import torch
import torch.distributed as dist

STATS = {"seconds": 0.0, "bytes": 0, "calls": 0}
TIMED = False

# Collectives that gloo does not run on CUDA tensors (measured on the H100
# machine, torch 2.11): for these alone, under gloo, a CUDA tensor is
# copied through pinned host memory and back.  This is a transport choice
# for ranks that share one card; all compute stays on the card.
GLOO_HOST_STAGED = frozenset({"ring_shift"})

# all_gather_into_tensor is called all_gather_single from torch 2.13 on
_all_gather_flat = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def reset_stats():
    STATS.update(seconds=0.0, bytes=0, calls=0)


class _Span:
    """Counts one collective: bytes sent and, with TIMED, its seconds."""

    def __init__(self, mesh, nbytes):
        self.mesh = mesh
        STATS["bytes"] += int(nbytes)
        STATS["calls"] += 1

    def __enter__(self):
        if TIMED:
            self._sync()
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if TIMED:
            self._sync()
            STATS["seconds"] += time.perf_counter() - self.t0
        return False

    def _sync(self):
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)


def _staged(mesh, name, t):
    """True when collective ``name`` must carry tensor t through host
    memory (gloo, CUDA tensor, and listed in GLOO_HOST_STAGED)."""
    return (mesh.backend == "gloo" and t.is_cuda
            and name in GLOO_HOST_STAGED)


def _host(t):
    return t.to("cpu").pin_memory() if torch.cuda.is_available() \
        else t.to("cpu")


def _real(t):
    """Complex tensors travel as their real view."""
    return torch.view_as_real(t).contiguous() if t.is_complex() \
        else t.contiguous()


def axis_size(mesh):
    return mesh.size


def axis_index(mesh):
    return mesh.rank


def _all_reduce(x, mesh, op):
    x = torch.as_tensor(x, device=mesh.device)
    if mesh.size == 1:
        return x.clone()
    buf = _real(x).clone()
    with _Span(mesh, buf.numel() * buf.element_size()):
        if _staged(mesh, "all_reduce", buf):
            h = _host(buf)
            dist.all_reduce(h, op=op, group=mesh.group)
            buf.copy_(h)
        else:
            dist.all_reduce(buf, op=op, group=mesh.group)
    return torch.view_as_complex(buf) if x.is_complex() else buf


def psum(x, mesh):
    """Sum over ranks (lax.psum)."""
    return _all_reduce(x, mesh, dist.ReduceOp.SUM)


def pmax(x, mesh):
    """Maximum over ranks (lax.pmax)."""
    return _all_reduce(x, mesh, dist.ReduceOp.MAX)


def pmin(x, mesh):
    """Minimum over ranks (lax.pmin)."""
    return _all_reduce(x, mesh, dist.ReduceOp.MIN)


def psum_scatter(x, mesh, sizes):
    """Sum over ranks of x (equal shapes everywhere), of which this rank
    keeps rows [sum(sizes[:r]), sum(sizes[:r+1])) (lax.psum_scatter, with
    uneven pieces): an all_reduce and a slice, since gloo's reduce_scatter
    is deprecated."""
    tot = psum(x, mesh)
    lo = int(sum(sizes[:mesh.rank]))
    return tot[lo:lo + int(sizes[mesh.rank])]


def all_gather(x, mesh):
    """Every rank's x stacked on a new leading axis (lax.all_gather,
    tiled=False); x has the same shape on every rank."""
    x = torch.as_tensor(x, device=mesh.device)
    if mesh.size == 1:
        return x[None].clone()
    src = _real(x)
    shape = (mesh.size,) + tuple(src.shape)
    src = src.reshape(-1)
    out = torch.empty(mesh.size * src.numel(), dtype=src.dtype,
                      device=src.device)
    with _Span(mesh, src.numel() * src.element_size()):
        if _staged(mesh, "all_gather", src):
            h = torch.empty(out.shape, dtype=out.dtype).pin_memory()
            _all_gather_flat(h, _host(src), group=mesh.group)
            out.copy_(h)
        else:
            _all_gather_flat(out, src, group=mesh.group)
    out = out.reshape(shape)
    return torch.view_as_complex(out) if x.is_complex() else out


def all_gather_v(x, mesh):
    """Every rank's rows of x concatenated in rank order, for x whose
    first dimension differs between ranks.  Returns (rows, counts: list of
    int)."""
    x = torch.as_tensor(x, device=mesh.device)
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=mesh.device)
    counts = [int(c) for c in all_gather(n, mesh)[:, 0].tolist()]
    m = max(counts) if counts else 0
    pad = torch.zeros((m - x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    g = all_gather(torch.cat([x, pad]), mesh)
    return torch.cat([g[r, :counts[r]] for r in range(mesh.size)]), counts


def all_to_all(x, mesh, send_counts=None):
    """Row exchange (lax.all_to_all / MPI_Alltoallv).  x holds the rows
    for rank 0 first, then rank 1, ...  send_counts=None: the even split
    (x's first dimension a multiple of the size; lax.all_to_all with
    tiled=True).  Otherwise send_counts (list or int64 tensor of S) gives
    the rows for each rank: the counts are swapped first (an int64
    all_to_all_single), then the rows.  Returns (rows received, in source
    rank order, recv_counts list)."""
    S = mesh.size
    if send_counts is None:
        assert x.shape[0] % S == 0, "even all_to_all needs S | rows"
        send = [x.shape[0] // S] * S
        recv = list(send)
    else:
        send = [int(c) for c in (send_counts.tolist()
                                 if torch.is_tensor(send_counts)
                                 else send_counts)]
        assert sum(send) == x.shape[0], (sum(send), x.shape[0])
        if S == 1:
            recv = list(send)
        else:
            sc = torch.tensor(send, dtype=torch.int64, device=mesh.device)
            rc = torch.empty_like(sc)
            with _Span(mesh, sc.numel() * 8):
                if _staged(mesh, "all_to_all", sc):
                    h = torch.empty(S, dtype=torch.int64).pin_memory()
                    dist.all_to_all_single(h, _host(sc), group=mesh.group)
                    rc.copy_(h)
                else:
                    dist.all_to_all_single(rc, sc, group=mesh.group)
            recv = [int(c) for c in rc.tolist()]
    if S == 1:
        return x.clone(), recv
    src = _real(x)
    # this rank's own rows stay here: only the others' travel
    me = mesh.rank
    lo = sum(send[:me])
    own = src[lo:lo + send[me]]
    src = torch.cat([src[:lo], src[lo + send[me]:]])
    send2 = send[:me] + [0] + send[me + 1:]
    recv2 = recv[:me] + [0] + recv[me + 1:]
    out = torch.empty((sum(recv2),) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    row = src[0].numel() * src.element_size() if src.shape[0] else 0
    with _Span(mesh, src.shape[0] * row):
        if _staged(mesh, "all_to_all", src):
            h = torch.empty(out.shape, dtype=out.dtype).pin_memory()
            dist.all_to_all_single(h, _host(src), recv2, send2,
                                   group=mesh.group)
            out.copy_(h)
        else:
            dist.all_to_all_single(out, src, recv2, send2, group=mesh.group)
    at = sum(recv[:me])
    out = torch.cat([out[:at], own, out[at:]])
    return (torch.view_as_complex(out) if x.is_complex() else out), recv


def ring_shift(x, mesh, shift):
    """Value of x held by rank (i - shift) mod S: ring_shift(x, m, +1)
    gives every rank its LEFT neighbour's x.  One send/recv pair (x has the
    same shape on every rank)."""
    x = torch.as_tensor(x, device=mesh.device)
    S = mesh.size
    if shift % S == 0:
        return x.clone()
    src = _real(x)
    out = torch.empty_like(src)
    to = (mesh.rank + shift) % S
    frm = (mesh.rank - shift) % S
    with _Span(mesh, src.numel() * src.element_size()):
        staged = _staged(mesh, "ring_shift", src)
        a, b = (_host(src), torch.empty(out.shape, dtype=out.dtype)
                .pin_memory()) if staged else (src, out)
        ops = [dist.P2POp(dist.isend, a, mesh.global_rank(to), mesh.group),
               dist.P2POp(dist.irecv, b, mesh.global_rank(frm), mesh.group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        if staged:
            out.copy_(b)
    return torch.view_as_complex(out) if x.is_complex() else out


def broadcast(x, mesh, src=0):
    """Rank src's x on every rank (multihost broadcast_one_to_all)."""
    x = torch.as_tensor(x, device=mesh.device).clone()
    if mesh.size == 1:
        return x
    with _Span(mesh, x.numel() * x.element_size()):
        if _staged(mesh, "broadcast", x):
            h = _host(x)
            dist.broadcast(h, mesh.global_rank(src), group=mesh.group)
            x.copy_(h)
        else:
            dist.broadcast(x, mesh.global_rank(src), group=mesh.group)
    return x


def barrier(mesh):
    """Every rank waits for the others (sync_global_devices)."""
    if mesh.size > 1:
        psum(torch.zeros(1, device=mesh.device), mesh)


def init_process_group(backend, init_method, world_size, rank,
                       timeout=None):
    """``torch.distributed.init_process_group``; main.init_distributed is
    the only caller.  timeout: seconds that the rendezvous and each
    collective may wait (None: torch.distributed's default)."""
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=float(timeout))}
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    return dist.group.WORLD


def destroy_process_group():
    if dist.is_initialized():
        dist.destroy_process_group()


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def world():
    """(rank, world size, backend name) of the default process group."""
    return dist.get_rank(), dist.get_world_size(), dist.get_backend()
