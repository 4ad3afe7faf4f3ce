// The flat stream of source tiles that the SPH pair kernels K4
// (sph_density.cu) and K5 (sph_hydro.cu) share.
//
// One CTA of WARPS warps takes one target group.  Its neighbour list (K3's
// leaf indices, in list order) is read SEG entries at a time, one entry a
// thread: the CTA gathers those leaves' pstart and pcount at once and
// takes an inclusive prefix sum of the counts (warp shuffles, then the
// warps' totals), which turns up to SEG leaves into one flat range of
// sources [0, total).  That range is cut into tiles of TILE sources,
// which cross leaf boundaries; warp w takes tiles w, w + WARPS, ...  A
// lane finds its source in the segment's table by a binary search of
// log2(SEG) steps in shared memory, and copies the source's first two
// float4 rows into a two-stage ring in shared memory with cp.async, one
// tile ahead of the tile being computed.  A tile's rows are gathers of
// irregular rows, not a box that TMA could copy.  The chain of dependent
// global loads is list -> pstart/pcount -> rows, once per segment
// instead of once per leaf.
//
// Lanes run over (target, source) pairs: a group of T targets takes T'
// target slots, the smallest power of two >= T, and each tile splits
// into S = 32 / T' slices; lane = t + T' s sums target t over the
// sources k = s + S i (i < T') of every tile it sees, in tile and index
// order.  At the end a fixed __shfl_xor_sync tree adds the slices and
// warp 0 adds the warps' rows in warp order: the order of every sum is
// fixed, so two launches give the same bits, with no atomics.
//
// A tile is computed in two passes.  The decisions: each lane takes its
// T' pairs' squared distances and a band test against its radius (band),
// so that a pair well inside or well outside needs no square root, and
// sets one bit a counted pair.  The body (for_each_counted): the warp
// queues the tile's counted pairs in lane and bit order and deals them
// out 32 at a time, one to a lane, whatever their target; each lane then
// adds its own pairs' terms back in bit order.  The warp pays for its
// counted pairs over 32, not for its busiest lane's.
//
// The decisions (whether a pair counts) are computed with __fsub_rn,
// __fmul_rn, __fadd_rn, __fdiv_rn and __fsqrt_rn, which are never
// contracted into multiply-adds nor approximated: the files build
// without -fmad=false and with -prec-div=false, and the decisions still
// round as the plain version's separate float32 operations do, while
// the sums' products may fuse and their divisions be approximate.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sph {

constexpr int WARPS = 4;           // warps per CTA, all on one group
constexpr int SEG = WARPS * 32;    // list entries per segment, one a thread
constexpr int TILE = 32;           // sources per tile, one a lane
constexpr unsigned FULL = 0xffffffffu;
static_assert((SEG & (SEG - 1)) == 0, "SEG must be a power of two");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// min-image difference in box units, d - round(d), and the pair's
// distance ((dx^2 + dy^2) + dz^2)^(1/2): each operation rounded on its
// own, as the plain version's
__device__ __forceinline__ float wrap_rn(float d) {
    return __fsub_rn(d, rintf(d));
}

__device__ __forceinline__ float dist2_rn(float4 a, float tx, float ty,
                                          float tz, float& dx, float& dy,
                                          float& dz) {
    dx = wrap_rn(__fsub_rn(a.x, tx));
    dy = wrap_rn(__fsub_rn(a.y, ty));
    dz = wrap_rn(__fsub_rn(a.z, tz));
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                     __fmul_rn(dz, dz));
}

__device__ __forceinline__ float distance_rn(float4 a, float tx, float ty,
                                             float tz, float& dx, float& dy,
                                             float& dz) {
    return __fsqrt_rn(dist2_rn(a, tx, ty, tz, dx, dy, dz));
}

// A decision r < R on the squared distance s, with lo2 = 0.9999 R^2 and
// hi2 = 1.0001 R^2: 1 (inside) where s < lo2, 0 where s > hi2, and -1
// in the band between, where the plain version's own arithmetic (the
// square root and its rounding) decides.  The band, 5e-5 of R wide, is
// far wider than the few roundings (6e-8 each) between s, lo2, hi2 and
// that arithmetic, so outside it the answer is the plain version's; the
// square root is taken for the rare pair in the band only.
constexpr float BAND_LO = 0.9999f;
constexpr float BAND_HI = 1.0001f;

__device__ __forceinline__ int band(float s, float lo2, float hi2) {
    return s < lo2 ? 1 : (s > hi2 ? 0 : -1);
}

// A lane's slot: target t of T' = 2^lg slots, slice s of S = 32 / T'.
struct Slot {
    int lg, t, s;
    // the tile index of the lane's i-th source
    __device__ int k(int i) const { return s + (i << (5 - lg)); }
};

__device__ __forceinline__ Slot slot_of(int T, int lane) {
    const int lg = T > 1 ? 32 - __clz(T - 1) : 0;
    return Slot{lg, lane & ((1 << lg) - 1), lane >> lg};
}

// v summed over the lane's slices (a fixed xor tree over lanes t + T' s):
// every lane of target t ends with the same sum
__device__ __forceinline__ float slice_sum(float v, int lg) {
    for (int o = 1 << lg; o < 32; o <<= 1)
        v += __shfl_xor_sync(FULL, v, o);
    return v;
}

__device__ __forceinline__ float slice_max(float v, int lg) {
    for (int o = 1 << lg; o < 32; o <<= 1)
        v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

// One segment of a group's list: incl[i] the inclusive prefix of the
// source counts of entries 0..i, off[i] = pstart - exclusive prefix, so
// that flat position p of entry i is source off[i] + p.
struct Segment {
    int incl[SEG];
    int off[SEG];
    int wsum[WARPS];
};

// Fill the table for list entries [l0, l0 + SEG) of a list of nl; every
// thread of the CTA calls it.  Returns the segment's source count.
__device__ __forceinline__ int build_segment(
    Segment& sg, const int* __restrict__ list, int l0, int nl,
    const int64_t* __restrict__ pstart, const int64_t* __restrict__ pcount) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int cnt = 0, start = 0;
    if (l0 + tid < nl) {
        const int leaf = list[l0 + tid];
        start = (int)pstart[leaf];
        cnt = (int)pcount[leaf];
    }
    int v = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v += y;
    }
    if (lane == 31) sg.wsum[warp] = v;
    __syncthreads();             // also: the previous segment is done
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        const int x = sg.wsum[w];
        before += w < warp ? x : 0;
        total += x;
    }
    v += before;
    sg.incl[tid] = v;
    sg.off[tid] = start - (v - cnt);
    __syncthreads();
    return total;
}

// The source at flat position p < total of the segment: the first entry
// whose inclusive prefix exceeds p (empty leaves are passed over).
__device__ __forceinline__ int source_at(const Segment& sg, int p) {
    int i = 0;
#pragma unroll
    for (int b = SEG >> 1; b > 0; b >>= 1)
        if (sg.incl[i + b - 1] <= p) i += b;
    return sg.off[i] + p;
}

// A warp's ring: two stages of TILE sources, two float4 rows each, and
// each source's index (for rows read later, straight from the table);
// and its queue of a tile's counted pairs, (target << 5 | tile slot),
// with one round's pair terms (later the warp's rows of sums).
template <int NOUT>
struct Ring {
    float4 row[2][2][TILE];
    int j[2][TILE];
    uint16_t queue[32 * TILE];
    float res[NOUT][32];
};

// Start copying the source at flat position p (if p < total) into stage
// b, lane `lane`'s slot; returns its valid flag (false past the end).
template <int STRIDE, class R>
__device__ __forceinline__ bool stage(R& rg, int b, const Segment& sg,
                                      int p, int total,
                                      const float4* __restrict__ src,
                                      const uint8_t* __restrict__ valid,
                                      int lane) {
    bool ok = false;
    if (p < total) {
        const int j = source_at(sg, p);
        const float4* row = src + (int64_t)STRIDE * j;
        cp_async16(&rg.row[b][0][lane], row);
        cp_async16(&rg.row[b][1][lane], row + 1);
        rg.j[b][lane] = j;
        ok = valid[j] != 0;
    }
    cp_async_commit();
    return ok;
}

// Run f(rows a, rows b, source indices, valid mask) over every tile of a
// group's list that falls to this warp, in order; bit k of the mask says
// that tile slot k holds a valid source.  Every thread of the CTA calls
// it (it synchronises the CTA once per segment).
template <int STRIDE, class R, class F>
__device__ __forceinline__ void for_each_tile(
    Segment& sg, R& rg, const int* __restrict__ list, int nl,
    const int64_t* __restrict__ pstart, const int64_t* __restrict__ pcount,
    const float4* __restrict__ src, const uint8_t* __restrict__ valid,
    F&& f) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int l0 = 0; l0 < nl; l0 += SEG) {
        const int total = build_segment(sg, list, l0, nl, pstart, pcount);
        const int ntiles = (total + TILE - 1) / TILE;
        int tile = warp;
        bool ok_next = false;
        if (tile < ntiles)
            ok_next = stage<STRIDE>(rg, 0, sg, tile * TILE + lane, total,
                                    src, valid, lane);
        for (int b = 0; tile < ntiles; tile += WARPS, b ^= 1) {
            const bool ok = ok_next;
            const int next = tile + WARPS;
            ok_next = false;
            if (next < ntiles)
                ok_next = stage<STRIDE>(rg, b ^ 1, sg, next * TILE + lane,
                                        total, src, valid, lane);
            else
                cp_async_commit();
            cp_async_wait<1>();              // this tile's copies landed
            __syncwarp();
            const unsigned vmask = __ballot_sync(FULL, ok);
            f(rg.row[b][0], rg.row[b][1], rg.j[b], vmask);
            __syncwarp();                    // before stage b is refilled
        }
        cp_async_wait<0>();
    }
}

// The body over a tile's counted pairs, all lanes busy: lane (t, s)
// holds bit i of m for each counted pair with its i-th source.  The
// warp lists the pairs in a queue in lane and bit order (a prefix sum
// of the lanes' counts), deals them out 32 at a time, one to a lane:
// body(t, k, v) computes the pair of target t and tile slot k into v;
// then each lane adds the terms of its own pairs, add(res, slot), in
// bit order, so that every sum keeps the order of the lane's sources.
// The warp pays for ceil(pairs / 32) bodies, not for its busiest lane.
template <int NOUT, class R, class Body, class Add>
__device__ __forceinline__ void for_each_counted(R& rg, unsigned m,
                                                 const Slot& sl, Body&& body,
                                                 Add&& add) {
    const int lane = threadIdx.x & 31;
    const int cnt = __popc(m);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(FULL, incl, 31);
    const int off = incl - cnt;
    int e = off;
    for (unsigned mm = m; mm; mm &= mm - 1)
        rg.queue[e++] = (uint16_t)((sl.t << 5) | sl.k(__ffs(mm) - 1));
    __syncwarp();
    for (int r0 = 0; r0 < total; r0 += 32) {
        if (r0 + lane < total) {
            const int w = rg.queue[r0 + lane];
            float v[NOUT];
            body(w >> 5, w & 31, v);
#pragma unroll
            for (int o = 0; o < NOUT; ++o) rg.res[o][lane] = v[o];
        }
        __syncwarp();
        const int end = min(off + cnt, r0 + 32);
        for (int f = max(off, r0); f < end; ++f) add(rg.res, f - r0);
        __syncwarp();
    }
}

}  // namespace sph
