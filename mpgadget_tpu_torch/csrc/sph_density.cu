// SPH density pair sums (kernel K4) for Hopper.
//
// Replaces the XLA loop mpgadget_tpu/ops/pairs.py:pair_reduce_packed
// (:355-503) as it runs the density pair function
// mpgadget_tpu/sph/density.py:_density_pair_fn (:52-87), and the port's
// plain version sph/density.py:density_sums_reference.  For each target
// group (a tree node of at most G <= 32 particles, pstart/pcount in the
// Morton-sorted arrays) it sums over the particles of every leaf of the
// group's neighbour list (K3's, in list order), for each target i:
//
//   dx = min_image(x_j - x_i)  (box units);  r = sqrt((dx^2+dy^2)+dz^2)
//   u = r / H_i;  a pair counts where u < 1 and j is valid gas
//   ngb += W 4/3 pi H^3,  rho += m W,  dhsml += m dW/dH,
//   egyrho += m A_j W,  dhsmlegy += m A_j dW/dH,
//   div += -(m dW/dr / r) (dist . dv),  rot += (m dW/dr / r) (dv x dist)
//
// with dist = x_i - x_j and dv = v_i - vpred_j.  The pair math keeps the
// plain version's association; the file is compiled with -fmad=false, so
// r and u round as the plain version's separate float32 operations do,
// and the decision u < 1 is the plain version's.
//
// Design (a first, simple one): one warp per group, one lane per target.
// The warp stages each listed leaf's particles, 32 at a time, in shared
// memory (two float4 and a valid flag each) with coalesced loads; each
// lane sums over them in registers, in list and particle order, and
// writes its target's row once.  No atomics, so two launches give the
// same bits.  A group with no list (converged in a bisection pass) is
// skipped and its rows keep what the wrapper allocated (zeros).
//
// Bound: operations.  A pair inside the kernel costs ~100 FP32
// operations (distance 14, u and the quintic's powers and norms ~45, the
// nine sums and the velocity terms ~40); the bytes are the particle
// tables read once and the rows written once, far below that.  Each
// staged source is read by 32 lanes from shared memory, so the sums run
// at the rate of the warp's arithmetic, with lanes idle where a group has
// fewer than 32 targets or a pair lies outside H.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "sph_kernels.cuh"

namespace {

constexpr int WARPS = 4;   // groups per CTA
constexpr int NOUT = 9;

template <int KT>
__global__ void __launch_bounds__(WARPS * 32)
density_kernel(const float4* __restrict__ src,        // (n, 2) float4
               const uint8_t* __restrict__ valid,     // (n)
               const float4* __restrict__ tgt,        // (n) h, vx, vy, vz
               const int64_t* __restrict__ pstart,
               const int64_t* __restrict__ pcount,
               const int64_t* __restrict__ group_nodes,
               const int* __restrict__ leaf_idx,       // (ng, LL)
               const int* __restrict__ n_leaves,
               float* __restrict__ out,                // (n, NOUT)
               int ng, int LL, int G) {
    __shared__ float4 s_a[WARPS][32];   // x, y, z, mass
    __shared__ float4 s_b[WARPS][32];   // velpred, entvarpred
    __shared__ uint8_t s_ok[WARPS][32];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = blockIdx.x * WARPS + warp;
    if (g >= ng) return;
    const int nl = n_leaves[g];
    if (nl <= 0) return;                 // the whole warp leaves together
    const int64_t node = group_nodes[g];
    const int64_t tps = pstart[node];
    const int tpc = (int)sph::lmin((int64_t)G, pcount[node]);
    const bool live = lane < tpc;
    const int64_t ti = tps + lane;

    float tx = 0.f, ty = 0.f, tz = 0.f, h = 1.f, vx = 0.f, vy = 0.f,
          vz = 0.f;
    if (live) {
        const float4 a = src[2 * ti];
        const float4 t = tgt[ti];
        tx = a.x; ty = a.y; tz = a.z;
        h = t.x; vx = t.y; vy = t.z; vz = t.w;
    }
    const float hinv = 1.0f / fmaxf(h, 1e-30f);
    const float h3 = fmaxf(sph::p3(hinv), 1e-30f);
    float ngb = 0.f, rho = 0.f, dhsml = 0.f, egyrho = 0.f, dhsmlegy = 0.f,
          div = 0.f, rotx = 0.f, roty = 0.f, rotz = 0.f;

    const int* list = leaf_idx + (int64_t)g * LL;
    for (int l = 0; l < nl; ++l) {
        const int leaf = list[l];
        const int64_t lps = pstart[leaf];
        const int64_t lpc = pcount[leaf];
        for (int64_t c = 0; c < lpc; c += 32) {
            const int cnt = (int)sph::lmin((int64_t)32, lpc - c);
            if (lane < cnt) {
                const int64_t j = lps + c + lane;
                s_a[warp][lane] = src[2 * j];
                s_b[warp][lane] = src[2 * j + 1];
                s_ok[warp][lane] = valid[j];
            }
            __syncwarp();
            if (live) {
                for (int k = 0; k < cnt; ++k) {
                    if (!s_ok[warp][k]) continue;
                    const float4 a = s_a[warp][k];
                    const float dx = sph::wrap(a.x - tx);
                    const float dy = sph::wrap(a.y - ty);
                    const float dz = sph::wrap(a.z - tz);
                    const float r = sqrtf((dx * dx + dy * dy) + dz * dz);
                    const float u = r * hinv;
                    if (!(u < 1.0f)) continue;
                    const float4 b = s_b[warp][k];
                    const float wk = sph::kernel_wk<KT>(u, hinv);
                    const float dwk = sph::kernel_dwk<KT>(u, hinv);
                    const float mj = a.w;
                    const float dW = sph::kernel_dW(u, wk, dwk, hinv);
                    const float rinv = r > 0.f ? 1.0f / fmaxf(r, 1e-30f)
                                               : 0.f;
                    const float fac = mj * dwk * rinv;
                    const float dvx = vx - b.x, dvy = vy - b.y,
                                dvz = vz - b.z;
                    const float ux = -dx, uy = -dy, uz = -dz;   // dist
                    ngb += wk * sph::NORM_COEFF / h3;
                    rho += mj * wk;
                    dhsml += mj * dW;
                    const float ment = mj * b.w;
                    egyrho += ment * wk;
                    dhsmlegy += ment * dW;
                    div += -fac * ((ux * dvx + uy * dvy) + uz * dvz);
                    rotx += fac * (dvy * uz - dvz * uy);
                    roty += fac * (dvz * ux - dvx * uz);
                    rotz += fac * (dvx * uy - dvy * ux);
                }
            }
            __syncwarp();
        }
    }
    if (live) {
        float* o = out + ti * NOUT;
        o[0] = ngb; o[1] = rho; o[2] = dhsml; o[3] = egyrho;
        o[4] = dhsmlegy; o[5] = div; o[6] = rotx; o[7] = roty; o[8] = rotz;
    }
}

template <int KT>
void launch(const void* src, const uint8_t* valid, const void* tgt,
            const int64_t* pstart, const int64_t* pcount,
            const int64_t* group_nodes, const int* leaf_idx,
            const int* n_leaves, float* out, int ng, int LL, int G,
            cudaStream_t stream) {
    density_kernel<KT><<<(ng + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
        (const float4*)src, valid, (const float4*)tgt, pstart, pcount,
        group_nodes, leaf_idx, n_leaves, out, ng, LL, G);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Device pointers in the
// Morton-sorted particle order: src f32 (n, 8) = x, y, z (box units),
// mass (0 where not valid), velpred, entvarpred; valid uint8 (n); tgt f32
// (n, 4) = hsml (box units), vel; the tree's pstart/pcount int64 (C);
// group_nodes int64 (ng); leaf_idx int32 (ng, LL) and n_leaves int32
// (ng), K3's lists; out f32 (n, 9), zeroed by the caller, rows of listed
// groups' targets written.  G: targets per group (1..32); ktype 1 cubic,
// 2 quintic, 4 quartic.  Launches on `stream` and returns
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
        launch<sph::CUBIC>(src, valid, tgt, pstart, pcount, group_nodes,
                           leaf_idx, n_leaves, out, ng, LL, G, stream);
        break;
    case sph::QUINTIC:
        launch<sph::QUINTIC>(src, valid, tgt, pstart, pcount, group_nodes,
                             leaf_idx, n_leaves, out, ng, LL, G, stream);
        break;
    case sph::QUARTIC:
        launch<sph::QUARTIC>(src, valid, tgt, pstart, pcount, group_nodes,
                             leaf_idx, n_leaves, out, ng, LL, G, stream);
        break;
    default:
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
