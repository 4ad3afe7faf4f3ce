// SPH density pair sums (kernel K4) for Hopper.
//
// Replaces the XLA loop mpgadget_tpu/ops/pairs.py:pair_reduce_packed
// (:355-503) as it runs the density pair function
// mpgadget_tpu/sph/density.py:_density_pair_fn (:52-87), and the port's
// plain version sph/density.py:density_sums_reference.  For each target
// group (a tree node of at most G <= 32 particles, pstart/pcount in the
// Morton-sorted arrays) it sums over the particles of every leaf of the
// group's neighbour list (K3's), for each target i:
//
//   dx = min_image(x_j - x_i)  (box units);  r = sqrt((dx^2+dy^2)+dz^2)
//   u = r / H_i;  a pair counts where u < 1 and j is valid gas
//   ngb += W 4/3 pi H^3,  rho += m W,  dhsml += m dW/dH,
//   egyrho += m A_j W,  dhsmlegy += m A_j dW/dH,
//   div += -(m dW/dr / r) (dist . dv),  rot += (m dW/dr / r) (dv x dist)
//
// with dist = x_i - x_j and dv = v_i - vpred_j.  A group with no list
// (converged in a bisection pass) is skipped and its rows keep what the
// wrapper allocated (zeros).
//
// Bound: operations.  A counted pair costs ~116 FP32 operations, a pair
// beyond H its distance and the decision (~17); the particle tables are
// read once and the rows written once, far below that.  What held the
// first design (sph_density_simple.cu, one warp per group and one lane
// per target, a leaf at a time) far from the bound, and what this one
// does about it (the stream itself: sph_stream.cuh):
//
//  - A quarter of the warp worked (~8 targets a group).  Lanes now run
//    over (target, source slice) pairs: T' target slots, the smallest
//    power of two >= T, and 32 / T' slices of each tile; only T' - T
//    slots idle in the decisions, none in the body.
//  - Leaves are small (~6 particles at star-small's state) and each cost
//    a chain of three dependent loads.  The CTA now turns up to 128 list
//    entries at once into one flat range of sources and streams it in
//    full 32-source tiles across leaf boundaries, the next tile's
//    cp.async in flight while this one is computed.
//  - The longest lists set the launch's time.  One CTA of four warps
//    takes one group and deals its tiles out in turn, so a long list is
//    spread over four warps (star-small's first pass: ~26 tiles a
//    group), and a later bisection pass that lists few groups still has
//    four warps each; with more, 2 x 64^3's ~7 tiles a group would leave
//    warps idle.  The warps' rows are added in warp order in shared
//    memory.
//  - The body ran for every source where any lane counted (12% of the
//    pairs count).  The decisions now come first, as a bit mask a lane,
//    with no square root outside a thin band around H; the body runs
//    over the tile's counted pairs only, dealt out 32 at a time.
//  - -fmad=false on the whole file halved the sums' arithmetic rate.
//    The decision's arithmetic (wrap, r^2, the band, r and u = r / H in
//    the band) is spelled with never-contracted, correctly rounded
//    intrinsics, so u < 1 is the plain version's bit for bit, and the
//    file builds without the flag (and with -prec-div=false).
//
// Culling a leaf per target before the tile was left out: with lanes
// over (target, source), a target's lane skips nothing unless every lane
// does, and a leaf that no target reaches is one K3's own box test
// (group box + largest H) mostly drops already.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "sph_kernels.cuh"
#include "sph_stream.cuh"

namespace {

constexpr int NOUT = 9;

template <int KT>
__global__ void __launch_bounds__(sph::WARPS * 32)
density_kernel(const float4* __restrict__ src,        // (n, 2) float4
               const uint8_t* __restrict__ valid,     // (n)
               const float4* __restrict__ tgt,        // (n) h, vx, vy, vz
               const int64_t* __restrict__ pstart,
               const int64_t* __restrict__ pcount,
               const int64_t* __restrict__ group_nodes,
               const int* __restrict__ leaf_idx,       // (ng, LL)
               const int* __restrict__ n_leaves,
               float* __restrict__ out,                // (n, NOUT)
               int LL, int G) {
    __shared__ sph::Segment sg;
    __shared__ sph::Ring<NOUT> ring[sph::WARPS];
    // the group's targets: x, y, z, 1/H, vx, vy, vz, 4/3 pi H^3
    __shared__ float tg[8][32];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = blockIdx.x;
    const int nl = n_leaves[g];
    if (nl <= 0) return;                 // the whole CTA leaves together
    const int64_t node = group_nodes[g];
    const int64_t tps = pstart[node];
    const int T = (int)sph::lmin((int64_t)G, pcount[node]);
    if (T <= 0) return;
    const sph::Slot sl = sph::slot_of(T, lane);
    const bool live = sl.t < T;
    const int64_t ti = tps + (live ? sl.t : 0);

    // the lane's target, for its decisions: u = r / H < 1 where
    // r^2 < 0.9999 H^2, not where r^2 > 1.0001 H^2
    const float4 ta = src[2 * ti];
    const float tx = ta.x, ty = ta.y, tz = ta.z;
    const float hinv = __fdiv_rn(1.0f, fmaxf(tgt[ti].x, 1e-30f));
    const float H = 1.0f / hinv;
    const float lo2 = H * H * sph::BAND_LO, hi2 = H * H * sph::BAND_HI;
    if (warp == 0 && lane < T) {
        const float4 tv = tgt[ti];
        const float h3 = fmaxf(sph::p3(hinv), 1e-30f);
        const float row[8] = {tx, ty, tz, hinv, tv.y, tv.z, tv.w,
                              sph::NORM_COEFF / h3};
#pragma unroll
        for (int c = 0; c < 8; ++c) tg[c][lane] = row[c];
    }   // read after the first segment's barriers
    const int nslot = 1 << sl.lg;      // T': sources of a tile per lane
    float ngb = 0.f, rho = 0.f, dhsml = 0.f, egyrho = 0.f, dhsmlegy = 0.f,
          div = 0.f, rotx = 0.f, roty = 0.f, rotz = 0.f;

    sph::for_each_tile<2>(
        sg, ring[warp], leaf_idx + (int64_t)g * LL, nl, pstart, pcount, src,
        valid,
        [&](const float4* ra, const float4* rb, const int*, unsigned vmask) {
            // the decisions: bit i for the lane's i-th source of the tile
            unsigned m = 0;
            if (live) {
                for (int i = 0; i < nslot; ++i) {
                    const int k = sl.k(i);
                    float dx, dy, dz;
                    const float s2 = sph::dist2_rn(ra[k], tx, ty, tz, dx, dy,
                                                   dz);
                    int in = sph::band(s2, lo2, hi2);
                    if (in < 0) in = __fmul_rn(__fsqrt_rn(s2), hinv) < 1.0f;
                    m |= (unsigned)(in && ((vmask >> k) & 1u)) << i;
                }
            }
            // the body, over the counted pairs only
            sph::for_each_counted<NOUT>(
                ring[warp], m, sl,
                [&](int t, int k, float* v) {
                    const float4 a = ra[k];
                    const float4 b = rb[k];
                    const float hi_ = tg[3][t];
                    float dx, dy, dz;
                    const float r = sph::distance_rn(a, tg[0][t], tg[1][t],
                                                     tg[2][t], dx, dy, dz);
                    const float u = __fmul_rn(r, hi_);
                    const float wk = sph::kernel_wk<KT>(u, hi_);
                    const float dwk = sph::kernel_dwk<KT>(u, hi_);
                    const float mj = a.w;
                    const float dW = sph::kernel_dW(u, wk, dwk, hi_);
                    const float rinv = r > 0.f ? 1.0f / fmaxf(r, 1e-30f)
                                               : 0.f;
                    const float fac = mj * dwk * rinv;
                    const float dvx = tg[4][t] - b.x, dvy = tg[5][t] - b.y,
                                dvz = tg[6][t] - b.z;
                    const float ux = -dx, uy = -dy, uz = -dz;   // dist
                    const float ment = mj * b.w;
                    v[0] = wk * tg[7][t];
                    v[1] = mj * wk;
                    v[2] = mj * dW;
                    v[3] = ment * wk;
                    v[4] = ment * dW;
                    v[5] = -fac * ((ux * dvx + uy * dvy) + uz * dvz);
                    v[6] = fac * (dvy * uz - dvz * uy);
                    v[7] = fac * (dvz * ux - dvx * uz);
                    v[8] = fac * (dvx * uy - dvy * ux);
                },
                [&](float (*res)[32], int e) {
                    ngb += res[0][e];
                    rho += res[1][e];
                    dhsml += res[2][e];
                    egyrho += res[3][e];
                    dhsmlegy += res[4][e];
                    div += res[5][e];
                    rotx += res[6][e];
                    roty += res[7][e];
                    rotz += res[8][e];
                });
        });

    // the slices' sums, then the warps' rows in warp order
    float acc[NOUT] = {ngb, rho, dhsml, egyrho, dhsmlegy, div, rotx, roty,
                       rotz};
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
        acc[o] = sph::slice_sum(acc[o], sl.lg);
        if (lane < T) ring[warp].res[o][lane] = acc[o];
    }
    __syncthreads();
    if (warp == 0 && lane < T) {
        float* row = out + (tps + lane) * NOUT;
#pragma unroll
        for (int o = 0; o < NOUT; ++o) {
            float v = ring[0].res[o][lane];
#pragma unroll
            for (int w = 1; w < sph::WARPS; ++w) v += ring[w].res[o][lane];
            row[o] = v;
        }
    }
}

template <int KT>
int launch(const void* src, const uint8_t* valid, const void* tgt,
           const int64_t* pstart, const int64_t* pcount,
           const int64_t* group_nodes, const int* leaf_idx,
           const int* n_leaves, float* out, int ng, int LL, int G,
           cudaStream_t stream) {
    density_kernel<KT><<<ng, sph::WARPS * 32, 0, stream>>>(
        (const float4*)src, valid, (const float4*)tgt, pstart, pcount,
        group_nodes, leaf_idx, n_leaves, out, LL, G);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Device pointers in the
// Morton-sorted particle order: src f32 (n, 8) = x, y, z (box units),
// mass (0 where not valid), velpred, entvarpred; valid uint8 (n); tgt f32
// (n, 4) = hsml (box units), vel; the tree's pstart/pcount int64 (C);
// group_nodes int64 (ng); leaf_idx int32 (ng, LL) and n_leaves int32
// (ng), K3's lists; out f32 (n, 9), zeroed by the caller, rows of listed
// groups' targets written.  G: targets per group (1..32); ktype 1 cubic,
// 2 quintic, 4 quartic.  Launches one CTA a group on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a G or ktype it does not
// take); does not synchronise.
extern "C" int sph_density_f32(const void* src, const uint8_t* valid,
                               const void* tgt, const int64_t* pstart,
                               const int64_t* pcount,
                               const int64_t* group_nodes,
                               const int* leaf_idx, const int* n_leaves,
                               float* out, int ng, int LL, int G, int ktype,
                               cudaStream_t stream) {
    if (ng <= 0) return (int)cudaSuccess;
    if (G < 1 || G > 32 || LL < 1) return (int)cudaErrorInvalidValue;
    switch (ktype) {
    case sph::CUBIC:
        return launch<sph::CUBIC>(src, valid, tgt, pstart, pcount,
                                  group_nodes, leaf_idx, n_leaves, out, ng,
                                  LL, G, stream);
    case sph::QUINTIC:
        return launch<sph::QUINTIC>(src, valid, tgt, pstart, pcount,
                                    group_nodes, leaf_idx, n_leaves, out, ng,
                                    LL, G, stream);
    case sph::QUARTIC:
        return launch<sph::QUARTIC>(src, valid, tgt, pstart, pcount,
                                    group_nodes, leaf_idx, n_leaves, out, ng,
                                    LL, G, stream);
    }
    return (int)cudaErrorInvalidValue;
}
