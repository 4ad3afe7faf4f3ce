"""Dense block pair interactions (direct forces): CUDA kernel + plain version.

The direct (opened-leaf) part of the short-range gravity is a dense
(G targets) x (S sources) pair sum per target block, of which only each
block's first ``count[b]`` sources are real (the rest is zero-mass
padding).  On CUDA tensors :func:`block_pair_accumulate` launches the
hand-written kernel in ``csrc/pairkernel.cu`` (the port of the Pallas
kernel ``mpgadget_tpu/gravity/pairkernel.py:block_pair_accumulate``); on
CPU tensors it runs :func:`block_pair_accumulate_reference`, the same math
in plain PyTorch.  There is no switch between the two other than the
device of the tensors: a CUDA tensor launches the kernel or raises.

The kernel is built by :mod:`mpgadget_tpu_torch.kernels` at first use.
``LAUNCHES`` counts wrapper calls that launched it (one call runs both of
its passes).
"""

import ctypes

import torch

from .. import kernels
from .shortrange import (shortrange_force_window, shortrange_pot_window,
                         softened_force_factor, softened_pot_factor)

MAX_G = 1024
MAX_BLOCK_ITEMS = 32      # work items per block at most (bounds the
#                           kernel's partial sums: 32 x 4 x G f32 a block)
PLAIN_BLOCK_BATCH = 512   # blocks per plain-version batch (bounds memory)

LAUNCHES = 0          # kernel launches (not plain-version calls)
_fn = None


def _wrap(d):
    """Minimum image for box-unit coordinate differences."""
    return d - torch.round(d)


def _kernel():
    global _fn
    if _fn is None:
        fn = kernels.load("pairkernel").block_pair_accumulate_f32
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 3
                       + [ctypes.c_int, ctypes.c_void_p])
        _fn = fn
    return _fn


def item_sources(S):
    """Sources per work item: 512, doubled while a block of S slots could
    need more than MAX_BLOCK_ITEMS items.  Small items keep the last round
    of the persistent grid short.  A function of S alone: a block's items,
    and so the order in which its partial sums are added, do not depend
    on how many blocks share the launch, so a block gets the same bits
    in a launch over every block and over the active ones only."""
    T = 512
    while T < S and -(-S // T) > MAX_BLOCK_ITEMS:
        T *= 2
    return T


def pair_work_items(count, S, T):
    """The kernel's work list: (block, first source) items of up to T
    sources covering each block's first min(count, S) sources, in block
    order, built on count's device without a host synchronisation.

    Returns (item_block int32[M], item_start int32[M], first_item
    int32[nb], n_items int32[nb], M) with M = nb * ceil(S / T) the most
    items there can be; rows past the last item hold block nb.
    """
    nb = count.shape[0]
    cnt = torch.clamp(count.to(torch.int64), 0, S)
    n_items = (cnt + (T - 1)) // T
    last = torch.cumsum(n_items, 0)              # inclusive
    first = last - n_items
    M = nb * (-(-S // T))
    k = torch.arange(M, device=count.device)
    item_block = torch.searchsorted(last, k, right=True)
    item_start = (k - first[torch.clamp(item_block, max=max(nb - 1, 0))]) * T
    return (item_block.to(torch.int32), item_start.to(torch.int32),
            first.to(torch.int32), n_items.to(torch.int32), M)


def _launch(tx, ty, tz, sx, sy, sz, sm, acc0, pot0, rs_inv, h_inv, rcut,
            with_potential, count):
    global LAUNCHES
    nb, G = tx.shape
    S = sx.shape[1]
    if G > MAX_G:
        raise ValueError(f"group size {G} > {MAX_G} threads per block")
    if any(t.device != tx.device for t in (ty, tz, sx, sy, sz, sm, acc0,
                                           pot0, count)):
        raise ValueError("pair kernel inputs must be on one device")
    for name, t, shape in (("tx", tx, (nb, G)), ("ty", ty, (nb, G)),
                           ("tz", tz, (nb, G)), ("sx", sx, (nb, S)),
                           ("sy", sy, (nb, S)), ("sz", sz, (nb, S)),
                           ("sm", sm, (nb, S)), ("acc0", acc0, (nb, 3, G)),
                           ("pot0", pot0, (nb, G))):
        kernels.check_tensor(name, t, shape, torch.float32)
    kernels.check_tensor("count", count, (nb,), torch.int32)
    fn = _kernel()
    T = item_sources(S)
    item_block, item_start, first_item, n_items, M = pair_work_items(
        count, S, T)
    acc = torch.empty_like(acc0)
    pot = torch.empty_like(pot0)
    part = torch.empty((M, 4, G), dtype=torch.float32, device=tx.device)
    with torch.cuda.device(tx.device):
        rc = fn(tx.data_ptr(), ty.data_ptr(), tz.data_ptr(), sx.data_ptr(),
                sy.data_ptr(), sz.data_ptr(), sm.data_ptr(), acc0.data_ptr(),
                pot0.data_ptr(), acc.data_ptr(), pot.data_ptr(),
                part.data_ptr(), item_block.data_ptr(),
                item_start.data_ptr(), count.data_ptr(),
                first_item.data_ptr(), n_items.data_ptr(), nb, G, S, T, M,
                float(rs_inv), float(h_inv), float(rcut),
                int(with_potential),
                torch.cuda.current_stream(tx.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pair kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return acc, pot


def block_pair_accumulate_reference(tx, ty, tz, sx, sy, sz, sm, acc0, pot0,
                                    rs_inv, h_inv, rcut, count, chunk=512,
                                    with_potential=False):
    """Plain PyTorch version: chunked over S, batched over blocks (the
    jnp branch of mpgadget_tpu's evaluate_leaves).  Same contract as
    :func:`block_pair_accumulate`.  Slots at or past a block's count are
    left out: their mass is taken as zero, and a chunk past a block's
    count is not computed for that block (it would add zeros)."""
    nb, G = tx.shape
    S = sx.shape[1]
    CH = min(chunk, S)
    if S % CH:
        CH = S
    cnt = torch.clamp(count.to(torch.int64), 0, S)
    sm = torch.where(torch.arange(S, device=sm.device)[None, :]
                     < cnt[:, None], sm, 0.0)
    acc = acc0.clone()
    pot = pot0.clone()
    for b0 in range(0, nb, PLAIN_BLOCK_BATCH):
        bs = slice(b0, min(nb, b0 + PLAIN_BLOCK_BATCH))
        send = int(cnt[bs].max())
        txb = tx[bs, :, None]
        tyb = ty[bs, :, None]
        tzb = tz[bs, :, None]
        ax, ay, az = acc[bs, 0], acc[bs, 1], acc[bs, 2]
        pb = pot[bs]
        for c0 in range(0, send, CH):
            cs = slice(c0, c0 + CH)
            # the blocks of the batch whose count reaches into this chunk
            live = torch.nonzero(cnt[bs] > c0).squeeze(1)
            if live.shape[0] == txb.shape[0]:
                live = slice(None)
            dx = _wrap(sx[bs][live, None, cs] - txb[live])
            dy = _wrap(sy[bs][live, None, cs] - tyb[live])
            dz = _wrap(sz[bs][live, None, cs] - tzb[live])
            m = sm[bs][live, None, cs]
            rr = torch.sqrt(dx * dx + dy * dy + dz * dz)      # (B, G, CH)
            # the pair terms only for the pairs within rcut, zero elsewhere
            near = rr < rcut
            rn = rr[near]
            mn = m.expand_as(rr)[near]
            ff = torch.zeros_like(rr)
            ff[near] = softened_force_factor(rn, h_inv) \
                * shortrange_force_window(rn, rs_inv) * mn
            ax[live] += torch.sum(ff * dx, dim=2)
            ay[live] += torch.sum(ff * dy, dim=2)
            az[live] += torch.sum(ff * dz, dim=2)
            if with_potential:
                pp = torch.zeros_like(rr)
                pp[near] = torch.where(
                    rn > 0, softened_pot_factor(rn, h_inv)
                    * shortrange_pot_window(rn, rs_inv) * mn, 0.0)
                pb[live] += torch.sum(pp, dim=2)
    return acc, pot


def block_pair_accumulate(tx, ty, tz, sx, sy, sz, sm, acc0, pot0, rs_inv,
                          h_inv, rcut, count, chunk=512, with_potential=False):
    """acc0 (nb,3,G) += dense pair forces of (nb,S) sources on (nb,G)
    targets; returns (acc (nb,3,G), pot (nb,G)).  Geometry in box units,
    minimum-image wrap per component.  count: int32 (nb,), the number of
    real sources at the head of each block's row (S for every slot).
    CPU tensors run the plain version; any other tensor launches the
    CUDA kernel or raises."""
    if tx.device.type == "cpu":
        return block_pair_accumulate_reference(
            tx, ty, tz, sx, sy, sz, sm, acc0, pot0, rs_inv, h_inv, rcut,
            count, chunk=chunk, with_potential=with_potential)
    return _launch(tx, ty, tz, sx, sy, sz, sm, acc0, pot0, rs_inv, h_inv,
                   rcut, with_potential, count)
