// SPH hydro force pair sums, the first design of kernel K5: a yardstick.
//
// The kernel the port first ran as K5, kept unchanged under its own
// entry point so that chip_smoke.py can time it beside sph_hydro.cu, its
// redesign, on the same inputs in the same run.  Only the smoke (and
// the card tests, through it) loads this library; no wrapper falls
// back to it.  What it computes is sph_hydro.cu's contract, word for word.
//
// Replaces the XLA loop mpgadget_tpu/ops/pairs.py:pair_reduce_packed
// (:355-503) as it runs the hydro pair function
// mpgadget_tpu/sph/hydra.py:_hydro_pair_fn (:45-139), and the port's
// plain version sph/hydra.py:hydro_sums_reference.  For each target group
// (a tree node of at most G <= 32 particles) it sums over the particles of
// every leaf of the group's symmetric neighbour list (K3's, searched with
// each node's hmax), for each target i and source j:
//
//   r_ij = |min_image(x_j - x_i)| L;  a pair counts where
//   (r < H_i or r < H_j) and r > 0 and j is valid gas
//   acc_i += -hfc dist,  dtent_i += hfc_visc vdotr2 / 2,
//   maxsig_i = max(maxsig_i, v_sig)
//
// with the pressure term (density-entropy, or pressure-entropy with the
// density contrast limit), the grad-h terms, the Monaghan viscosity with
// the Balsara switch and the Gadget limiter (hydra.c:25-528); maxsig is
// -inf where a target has no pair.  The formulation is a template
// argument (MODE: 0 density-entropy; pressure-entropy with the contrast
// limited, 1, unlimited, 2, or without the contrast terms, 3), and so is
// the kernel type.  The pair math keeps the plain version's association;
// the file is compiled with -fmad=false, so r, r L and the decisions
// r < H_i, r < H_j and vdotr2 < 0 are the plain version's.
//
// Design (a first, simple one, as K4): one warp per group, one lane per
// target; each listed leaf's particles staged 32 at a time in shared
// memory (four float4 and a valid flag each) by coalesced loads; sums in
// registers in list and particle order, each target's row written once.
// No atomics: two launches give the same bits.  A group with no list
// keeps the rows the wrapper allocated (0, maxsig -inf).
//
// Bound: operations.  A counted pair costs ~150 FP32 operations (two
// kernel derivatives, the viscosity and its limiter, the pressure and
// grad-h terms, four sums and a max); a pair beyond both H costs its
// distance (~16).  The tables are read once and the rows written once.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "sph_kernels.cuh"

namespace {

constexpr int WARPS = 4;   // groups per CTA
constexpr int NOUT = 5;
constexpr float GAMMA = (float)(5.0 / 3.0);

struct Scalars {
    float L, fac_mu, fac_vsic_fix, hubble_a2, dloga, visc0, half_vsic,
        limit;
};

template <int KT, int MODE>
__global__ void __launch_bounds__(WARPS * 32)
hydro_kernel(const float4* __restrict__ src,      // (n, 4) float4
             const uint8_t* __restrict__ valid,   // (n)
             const float4* __restrict__ tgt,      // (n, 2) float4
             const int64_t* __restrict__ pstart,
             const int64_t* __restrict__ pcount,
             const int64_t* __restrict__ group_nodes,
             const int* __restrict__ leaf_idx,     // (ng, LL)
             const int* __restrict__ n_leaves,
             float* __restrict__ out,              // (n, NOUT)
             int ng, int LL, int G, Scalars sc) {
    __shared__ float4 s_row[WARPS][4][32];
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

    float4 ta = make_float4(0.f, 0.f, 0.f, 0.f), tb = ta, tc = ta, td = ta,
           te = ta, tf = ta;
    if (live) {
        ta = src[4 * ti];       // x, y, z, mass
        tb = src[4 * ti + 1];   // velpred, hsml
        tc = src[4 * ti + 2];   // density, eomdensity, pressure, divvel
        td = src[4 * ti + 3];   // curlvel, entvarpred, dhsml
        te = tgt[2 * ti];       // mass, soundspeed, f1, p_over_rho2
        tf = tgt[2 * ti + 1];   // egyrho
    }
    const float hi = tb.w;
    const float hic = fmaxf(hi, 1e-30f);
    const float rho_i = tc.x;
    const float mi = te.x, cs_i = te.y, f1 = te.z, por2_i = te.w;
    const float ev_i = fmaxf(td.y, 1e-30f);
    const float dhsml_i = td.z;
    float rr1 = 1.0f;
    if (MODE == 1 || MODE == 2) {
        rr1 = tf.x / fmaxf(rho_i, 1e-30f);
        if (MODE == 1) rr1 = fminf(rr1, sc.limit);
    } else if (MODE == 3) {
        rr1 = 0.0f;
    }
    float accx = 0.f, accy = 0.f, accz = 0.f, dtent = 0.f,
          maxsig = -INFINITY;

    const int* list = leaf_idx + (int64_t)g * LL;
    for (int l = 0; l < nl; ++l) {
        const int leaf = list[l];
        const int64_t lps = pstart[leaf];
        const int64_t lpc = pcount[leaf];
        for (int64_t c = 0; c < lpc; c += 32) {
            const int cnt = (int)sph::lmin((int64_t)32, lpc - c);
            if (lane < cnt) {
                const int64_t j = lps + c + lane;
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    s_row[warp][q][lane] = src[4 * j + q];
                s_ok[warp][lane] = valid[j];
            }
            __syncwarp();
            if (live) {
                for (int k = 0; k < cnt; ++k) {
                    if (!s_ok[warp][k]) continue;
                    const float4 a = s_row[warp][0][k];
                    const float dx = sph::wrap(a.x - ta.x);
                    const float dy = sph::wrap(a.y - ta.y);
                    const float dz = sph::wrap(a.z - ta.z);
                    const float r = sqrtf((dx * dx + dy * dy) + dz * dz);
                    const float ri = r * sc.L;
                    const float4 b = s_row[warp][1][k];
                    const float hj = b.w;
                    const bool in_i = ri < hi;
                    const bool in_j = ri < hj;
                    if (!((in_i || in_j) && ri > 0.f)) continue;
                    const float4 cc = s_row[warp][2][k];
                    const float4 d = s_row[warp][3][k];
                    const float hjc = fmaxf(hj, 1e-30f);
                    const float dwk_i =
                        in_i ? sph::kernel_dwk<KT>(ri / hic, 1.0f / hic)
                             : 0.f;
                    const float dwk_j =
                        in_j ? sph::kernel_dwk<KT>(ri / hjc, 1.0f / hjc)
                             : 0.f;
                    const float mj = a.w;
                    const float P_j = cc.z;
                    const float eom_j = fmaxf(cc.y, 1e-30f);
                    const float rho_j = fmaxf(cc.x, 1e-30f);
                    const float por2_j = P_j / (eom_j * eom_j);
                    const float cs_j = sqrtf(GAMMA * P_j / eom_j);

                    const float dvx = tb.x - b.x, dvy = tb.y - b.y,
                                dvz = tb.z - b.z;
                    const float ux = -dx * sc.L, uy = -dy * sc.L,
                                uz = -dz * sc.L;          // dist
                    const float vdotr = (ux * dvx + uy * dvy) + uz * dvz;
                    const float vdotr2 = vdotr + sc.hubble_a2 * ri * ri;
                    const float vsig_pair = cs_i + cs_j;

                    const float rinv = 1.0f / fmaxf(ri, 1e-30f);
                    const float mu = sc.fac_mu * vdotr2 * rinv;
                    const float rho_ij = 0.5f * (rho_i + rho_j);
                    const float vsig_visc = cs_i + cs_j - 3.0f * mu;
                    const float adiv = fabsf(cc.w);
                    const float f2 = adiv / (adiv + d.x
                                             + 0.0001f * cs_j / sc.fac_mu
                                                 / hjc);
                    float visc = sc.visc0 * vsig_visc * (-mu)
                                 / fmaxf(rho_ij, 1e-30f) * (f1 + f2);
                    // viscosity limiter (hydra.c:462-472)
                    const float dwk_s = dwk_i + dwk_j;
                    const float denom = 0.5f * (mi + mj) * dwk_s * ri
                                        * (2.0f * sc.dloga);
                    const float cap = sc.half_vsic * vdotr2
                                      / (fabsf(denom) > 0.f ? denom
                                                            : -1e30f);
                    if (sc.dloga > 0.f && dwk_s < 0.f)
                        visc = fminf(visc, cap);
                    float vsig = vsig_pair;
                    if (vdotr2 < 0.f) {
                        vsig = fmaxf(vsig_pair, vsig_visc);
                    } else {
                        visc = 0.f;
                    }
                    const float hfc_visc = 0.5f * mj * visc * dwk_s * rinv;
                    float hfc = hfc_visc;
                    const float ev_j = fmaxf(d.y, 1e-30f);
                    float rr2 = 1.0f;
                    if (MODE != 0) {
                        // pressure-entropy leading term (hydra.c:478-486)
                        hfc = hfc + mj * (dwk_i * por2_i * ev_j / ev_i
                                          + dwk_j * por2_j * ev_i / ev_j)
                                        * rinv;
                        if (MODE == 3) {
                            rr2 = 0.0f;
                        } else {
                            rr2 = eom_j / rho_j;
                            if (MODE == 1) rr2 = fminf(rr2, sc.limit);
                        }
                    }
                    // grad-h corrected Lagrangian term (hydra.c:497-500)
                    hfc = hfc + mj * (por2_i * dhsml_i * dwk_i * rr1
                                      + por2_j * d.z * dwk_j * rr2) * rinv;
                    accx += -hfc * ux;
                    accy += -hfc * uy;
                    accz += -hfc * uz;
                    dtent += 0.5f * hfc_visc * vdotr2;
                    maxsig = fmaxf(maxsig, vsig);
                }
            }
            __syncwarp();
        }
    }
    if (live) {
        float* o = out + ti * NOUT;
        o[0] = accx; o[1] = accy; o[2] = accz; o[3] = dtent; o[4] = maxsig;
    }
}

template <int KT, int MODE>
void launch(const void* src, const uint8_t* valid, const void* tgt,
            const int64_t* pstart, const int64_t* pcount,
            const int64_t* group_nodes, const int* leaf_idx,
            const int* n_leaves, float* out, int ng, int LL, int G,
            const Scalars& sc, cudaStream_t stream) {
    hydro_kernel<KT, MODE><<<(ng + WARPS - 1) / WARPS, WARPS * 32, 0,
                             stream>>>(
        (const float4*)src, valid, (const float4*)tgt, pstart, pcount,
        group_nodes, leaf_idx, n_leaves, out, ng, LL, G, sc);
}

template <int KT>
int launch_mode(int mode, const void* src, const uint8_t* valid,
                const void* tgt, const int64_t* pstart,
                const int64_t* pcount, const int64_t* group_nodes,
                const int* leaf_idx, const int* n_leaves, float* out,
                int ng, int LL, int G, const Scalars& sc,
                cudaStream_t stream) {
#define SPH_HYDRO_MODE(M)                                                  \
    case M:                                                                \
        launch<KT, M>(src, valid, tgt, pstart, pcount, group_nodes,        \
                      leaf_idx, n_leaves, out, ng, LL, G, sc, stream);     \
        return 0;
    switch (mode) {
        SPH_HYDRO_MODE(0)
        SPH_HYDRO_MODE(1)
        SPH_HYDRO_MODE(2)
        SPH_HYDRO_MODE(3)
    }
#undef SPH_HYDRO_MODE
    return 1;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Device pointers in the
// Morton-sorted particle order: src f32 (n, 16) = x, y, z (box units),
// mass (0 where not valid), velpred, hsml, density, eomdensity, pressure,
// divvel, curlvel, entvarpred, dhsml, pad; valid uint8 (n); tgt f32 (n, 8)
// = mass, soundspeed, f1, p_over_rho2, egyrho, pad; the tree's
// pstart/pcount int64 (C); group_nodes int64 (ng); leaf_idx int32 (ng, LL)
// and n_leaves int32 (ng), K3's symmetric lists; out f32 (n, 5) = acc,
// dtent, maxsig, filled by the caller (0, maxsig -inf), rows of listed
// groups' targets written.  G: targets per group (1..32); ktype 1 cubic,
// 2 quintic, 4 quartic; mode the formulation (see above).
// Scalars: L (BoxSize), fac_mu, fac_vsic_fix, hubble_a2, dloga, the
// artificial viscosity constant and the density contrast limit, float32
// as the plain version holds them.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a G, ktype or mode it
// does not take); does not synchronise.
extern "C" int sph_hydro_simple_f32(const void* src, const uint8_t* valid,
                                    const void* tgt, const int64_t* pstart,
                                    const int64_t* pcount,
                                    const int64_t* group_nodes, const int* leaf_idx,
                                    const int* n_leaves, float* out, int ng, int LL,
                                    int G, int ktype, int mode,
                                    float L, float fac_mu, float fac_vsic_fix,
                                    float hubble_a2, float dloga,
                                    float art_bulk_visc, float limit,
                                    cudaStream_t stream) {
    if (ng <= 0) return (int)cudaSuccess;
    if (G < 1 || G > 32 || LL < 1) return (int)cudaErrorInvalidValue;
    const Scalars sc{L, fac_mu, fac_vsic_fix, hubble_a2, dloga,
                     (float)(0.25 * (double)art_bulk_visc),
                     (float)(0.5 * (double)fac_vsic_fix), limit};
    int bad = 1;
    switch (ktype) {
    case sph::CUBIC:
        bad = launch_mode<sph::CUBIC>(mode, src, valid, tgt, pstart, pcount,
                                      group_nodes, leaf_idx, n_leaves, out,
                                      ng, LL, G, sc, stream);
        break;
    case sph::QUINTIC:
        bad = launch_mode<sph::QUINTIC>(mode, src, valid, tgt, pstart,
                                        pcount, group_nodes, leaf_idx,
                                        n_leaves, out, ng, LL, G, sc,
                                        stream);
        break;
    case sph::QUARTIC:
        bad = launch_mode<sph::QUARTIC>(mode, src, valid, tgt, pstart,
                                        pcount, group_nodes, leaf_idx,
                                        n_leaves, out, ng, LL, G, sc,
                                        stream);
        break;
    }
    if (bad) return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
