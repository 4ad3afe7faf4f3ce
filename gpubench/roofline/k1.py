"""K1, the leaf pair sums (csrc/pairkernel.cu: pair_items_kernel and
pair_reduce_kernel).  Per launch: nb target blocks of G rows and
`sources` real sources summed over the blocks, of which `within`
(source, target) pairs lie closer than rcut and need the pair terms; the
others need only their distance (chip_smoke.py's pair_bound, frozen).
``within`` is counted on a sample of each launch's blocks
(``pairs_within``) and scaled to all of its listed pairs."""

import torch

from .peaks import bound_s

KERNELS = ("pair_items_kernel", "pair_reduce_kernel")
# FP32 operations per source-target pair (an FMA counted as 2), counted
# from csrc/shortrange.cuh and the K1 loop: wrap 9, r2 5, rsqrt and r 3,
# u and -u^2 2, exp 2, erfcx fit 26, windows 3, softening 5, cut 2, sums 6
PAIR_OPS = {False: 64, True: 72}     # with_potential -> ops
DISTANCE_OPS = 15        # a pair beyond rcut: wrap 9, r2 5, the cut 1


def launch_bound_s(nb, G, sources, within, with_potential):
    pairs = G * sources
    ops = (within * PAIR_OPS[bool(with_potential)]
           + (pairs - within) * DISTANCE_OPS)
    # targets, sources (x, y, z, m), acc0 + pot0 read; acc + pot written
    nbytes = 4 * (3 * nb * G + 4 * sources + 4 * nb * G + 4 * nb * G + nb)
    return bound_s(ops, nbytes)


def pairs_within(tx, ty, tz, sx, sy, sz, count, rcut, batch=16, chunk=512):
    """(pairs closer than rcut, pairs listed) over the (target, real
    source) pairs of these blocks: tx (nb, G), sx (nb, S) in box units,
    count (nb,) real sources at the head of each row."""
    def wrap(d):
        return d - torch.round(d)

    nb, S = sx.shape
    slot = torch.arange(S, device=sx.device)
    n = 0
    for b0 in range(0, nb, batch):
        bs = slice(b0, b0 + batch)
        for c0 in range(0, S, chunk):
            cs = slice(c0, c0 + chunk)
            dx = wrap(sx[bs, None, cs] - tx[bs, :, None])
            dy = wrap(sy[bs, None, cs] - ty[bs, :, None])
            dz = wrap(sz[bs, None, cs] - tz[bs, :, None])
            near = torch.sqrt(dx * dx + dy * dy + dz * dz) < rcut
            real = slot[None, cs] < count[bs, None]
            n += int((near & real[:, None, :]).sum())
    return n, int(count.to(torch.int64).sum()) * tx.shape[1]


def bound_total_s(launches):
    """Summed over the launches that metrics/k1_roofline.py's watch
    recorded; None where a launch's sample lists no pair."""
    total = 0.0
    for ln in launches:
        near, listed = pairs_within(*ln["sample"], ln["sample_count"],
                                    ln["rcut"])
        if listed == 0:
            return None
        sources = int(ln["count"].to(torch.int64).sum())
        within = round(ln["G"] * sources * near / listed)
        total += launch_bound_s(ln["nb"], ln["G"], sources, within,
                                ln["with_potential"])
    return total
