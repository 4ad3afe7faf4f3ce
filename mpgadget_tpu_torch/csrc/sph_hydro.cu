// SPH hydro force pair sums (kernel K5) for Hopper.
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
// the kernel type.  A group with no list keeps the rows the wrapper
// allocated (0, maxsig -inf).
//
// Bound: operations.  A counted pair costs ~165 FP32 operations (two
// kernel derivatives, the viscosity and its limiter, the pressure and
// grad-h terms, four sums and a max); a pair beyond both H its distance
// and the decision (~19).  The tables are read once and the rows written
// once.  The design is K4's (sph_density.cu: one CTA of four warps a
// group over the flat stream of sph_stream.cuh, lanes over (target,
// source slice), the decisions apart from the body and the counted
// pairs dealt out 32 at a time, the decisions' arithmetic never
// contracted), with two differences:
//
//  - The stream stages a source's first two rows only (x, y, z, mass;
//    velpred, hsml): what the decision needs, and the velocities of the
//    body.  The body's other 32 bytes (density, eomdensity, pressure,
//    divvel; curlvel, entvarpred, dhsml) are read from the table by the
//    lane that computes a counted pair (14% of the pairs at star-small's
//    state), and for no other.  Copying them into shared memory a tile
//    ahead, for the slots where some pair counts, was tried on the card
//    and was slower (a deeper ring, fewer CTAs an SM).
//  - v_sig, whose max must equal the plain version's bit for bit, is
//    spelled with never-contracted, correctly rounded intrinsics as the
//    decisions are (cs_j, dist . dv, vdotr2, mu, cs_i + cs_j - 3 mu); so
//    is vdotr2 < 0, which decides whether the viscosity acts.  The
//    decision r < H_i or r < H_j is one band test against max(H_i, H_j).
//
// Culling a leaf before the tile was left out: the test would be against
// max(H_i, the leaf's hmax), and hmax is not among the kernel's inputs.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "sph_kernels.cuh"
#include "sph_stream.cuh"

namespace {

constexpr int NOUT = 5;
constexpr float GAMMA = (float)(5.0 / 3.0);

struct Scalars {
    float L, fac_mu, fac_vsic_fix, hubble_a2, dloga, visc0, half_vsic,
        limit;
};

template <int KT, int MODE>
__global__ void __launch_bounds__(sph::WARPS * 32)
hydro_kernel(const float4* __restrict__ src,      // (n, 4) float4
             const uint8_t* __restrict__ valid,   // (n)
             const float4* __restrict__ tgt,      // (n, 2) float4
             const int64_t* __restrict__ pstart,
             const int64_t* __restrict__ pcount,
             const int64_t* __restrict__ group_nodes,
             const int* __restrict__ leaf_idx,     // (ng, LL)
             const int* __restrict__ n_leaves,
             float* __restrict__ out,              // (n, NOUT)
             int LL, int G, Scalars sc) {
    __shared__ sph::Segment sg;
    __shared__ sph::Ring<NOUT> ring[sph::WARPS];
    // the group's targets: x, y, z, velpred, H, H clamped and its
    // inverse, density, mass, soundspeed, f1, P / rho^2, entvarpred
    // (clamped), dhsml and the contrast factor rr1
    __shared__ float tg[17][32];
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

    // the lane's target, for its decisions
    const float4 ta = src[4 * ti];       // x, y, z, mass
    const float hi = src[4 * ti + 1].w;  // hsml
    const float invL = 1.0f / sc.L;
    if (warp == 0 && lane < T) {
        const float4 tb = src[4 * ti + 1];   // velpred, hsml
        const float4 tc = src[4 * ti + 2];   // density, eomdensity, P, divvel
        const float4 td = src[4 * ti + 3];   // curlvel, entvarpred, dhsml
        const float4 te = tgt[2 * ti];       // mass, soundspeed, f1, P/rho^2
        const float4 tf = tgt[2 * ti + 1];   // egyrho
        const float hic = fmaxf(hi, 1e-30f);
        float rr1 = 1.0f;
        if (MODE == 1 || MODE == 2) {
            rr1 = tf.x / fmaxf(tc.x, 1e-30f);
            if (MODE == 1) rr1 = fminf(rr1, sc.limit);
        } else if (MODE == 3) {
            rr1 = 0.0f;
        }
        const float row[17] = {ta.x, ta.y, ta.z, tb.x, tb.y, tb.z, hi, hic,
                               1.0f / hic, tc.x, te.x, te.y, te.z, te.w,
                               fmaxf(td.y, 1e-30f), td.z, rr1};
#pragma unroll
        for (int c = 0; c < 17; ++c) tg[c][lane] = row[c];
    }   // read after the first segment's barriers
    const int nslot = 1 << sl.lg;      // T': sources of a tile per lane
    float accx = 0.f, accy = 0.f, accz = 0.f, dtent = 0.f,
          maxsig = -INFINITY;

    sph::for_each_tile<4>(
        sg, ring[warp], leaf_idx + (int64_t)g * LL, nl, pstart, pcount, src,
        valid,
        [&](const float4* ra, const float4* rb, const int* jb,
            unsigned vmask) {
            // the decisions: bit i for the lane's i-th source of the tile;
            // r L < H_i or r L < H_j where r^2 < 0.9999 max(H_i, H_j)^2 /
            // L^2, not where r^2 > 1.0001 of it; and r > 0
            unsigned m = 0;
            if (live) {
                for (int i = 0; i < nslot; ++i) {
                    const int k = sl.k(i);
                    const float hj = rb[k].w;
                    float dx, dy, dz;
                    const float s2 = sph::dist2_rn(ra[k], ta.x, ta.y, ta.z,
                                                   dx, dy, dz);
                    const float w = fmaxf(fmaxf(hi, hj), 0.0f) * invL;
                    int in = sph::band(s2, w * w * sph::BAND_LO,
                                       w * w * sph::BAND_HI);
                    if (in < 0) {
                        const float ri = __fmul_rn(__fsqrt_rn(s2), sc.L);
                        in = (ri < hi || ri < hj) && ri > 0.f;
                    }
                    m |= (unsigned)(in && s2 > 0.f && ((vmask >> k) & 1u))
                         << i;
                }
            }
            // the body, over the counted pairs only, its rows 2-3 read
            // from the table for those alone
            sph::for_each_counted<NOUT>(
                ring[warp], m, sl,
                [&](int t, int k, float* v) {
                    const float4* row = src + 4 * (int64_t)jb[k];
                    const float4 cc = __ldg(row + 2);
                    const float4 d = __ldg(row + 3);
                    const float4 a = ra[k];
                    const float4 b = rb[k];
                    const float hi_ = tg[6][t], hic = tg[7][t];
                    const float cs_i = tg[11][t];
                    float dx, dy, dz;
                    const float r = sph::distance_rn(a, tg[0][t], tg[1][t],
                                                     tg[2][t], dx, dy, dz);
                    const float ri = __fmul_rn(r, sc.L);
                    const float hj = b.w;
                    const bool in_i = ri < hi_;
                    const bool in_j = ri < hj;
                    const float hjc = fmaxf(hj, 1e-30f);
                    const float dwk_i =
                        in_i ? sph::kernel_dwk<KT>(ri / hic, tg[8][t]) : 0.f;
                    const float dwk_j =
                        in_j ? sph::kernel_dwk<KT>(ri / hjc, 1.0f / hjc)
                             : 0.f;
                    const float mj = a.w;
                    const float P_j = cc.z;
                    const float eom_j = fmaxf(cc.y, 1e-30f);
                    const float rho_j = fmaxf(cc.x, 1e-30f);
                    const float por2_j = P_j / (eom_j * eom_j);
                    const float cs_j =
                        __fsqrt_rn(__fdiv_rn(__fmul_rn(GAMMA, P_j), eom_j));

                    const float dvx = __fsub_rn(tg[3][t], b.x);
                    const float dvy = __fsub_rn(tg[4][t], b.y);
                    const float dvz = __fsub_rn(tg[5][t], b.z);
                    const float ux = __fmul_rn(-dx, sc.L);     // dist
                    const float uy = __fmul_rn(-dy, sc.L);
                    const float uz = __fmul_rn(-dz, sc.L);
                    const float vdotr = __fadd_rn(
                        __fadd_rn(__fmul_rn(ux, dvx), __fmul_rn(uy, dvy)),
                        __fmul_rn(uz, dvz));
                    const float vdotr2 = __fadd_rn(
                        vdotr, __fmul_rn(__fmul_rn(sc.hubble_a2, ri), ri));
                    const float vsig_pair = __fadd_rn(cs_i, cs_j);

                    const float rinv = __fdiv_rn(1.0f, fmaxf(ri, 1e-30f));
                    const float mu =
                        __fmul_rn(__fmul_rn(sc.fac_mu, vdotr2), rinv);
                    const float rho_ij = 0.5f * (tg[9][t] + rho_j);
                    const float vsig_visc =
                        __fsub_rn(vsig_pair, __fmul_rn(3.0f, mu));
                    const float adiv = fabsf(cc.w);
                    const float f2 = adiv / (adiv + d.x
                                             + 0.0001f * cs_j / sc.fac_mu
                                                 / hjc);
                    float visc = sc.visc0 * vsig_visc * (-mu)
                                 / fmaxf(rho_ij, 1e-30f) * (tg[12][t] + f2);
                    // viscosity limiter (hydra.c:462-472)
                    const float dwk_s = dwk_i + dwk_j;
                    const float denom = 0.5f * (tg[10][t] + mj) * dwk_s * ri
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
                    const float por2_i = tg[13][t], ev_i = tg[14][t];
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
                    hfc = hfc + mj * (por2_i * tg[15][t] * dwk_i * tg[16][t]
                                      + por2_j * d.z * dwk_j * rr2) * rinv;
                    v[0] = -hfc * ux;
                    v[1] = -hfc * uy;
                    v[2] = -hfc * uz;
                    v[3] = 0.5f * hfc_visc * vdotr2;
                    v[4] = vsig;
                },
                [&](float (*res)[32], int e) {
                    accx += res[0][e];
                    accy += res[1][e];
                    accz += res[2][e];
                    dtent += res[3][e];
                    maxsig = fmaxf(maxsig, res[4][e]);
                });
        });

    // the slices' sums, then the warps' rows in warp order
    float acc[NOUT] = {accx, accy, accz, dtent, maxsig};
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
        acc[o] = o == NOUT - 1 ? sph::slice_max(acc[o], sl.lg)
                               : sph::slice_sum(acc[o], sl.lg);
        if (lane < T) ring[warp].res[o][lane] = acc[o];
    }
    __syncthreads();
    if (warp == 0 && lane < T) {
        float* row = out + (tps + lane) * NOUT;
#pragma unroll
        for (int o = 0; o < NOUT; ++o) {
            float v = ring[0].res[o][lane];
#pragma unroll
            for (int w = 1; w < sph::WARPS; ++w)
                v = o == NOUT - 1 ? fmaxf(v, ring[w].res[o][lane])
                                  : v + ring[w].res[o][lane];
            row[o] = v;
        }
    }
}

template <int KT, int MODE>
int launch(const void* src, const uint8_t* valid, const void* tgt,
           const int64_t* pstart, const int64_t* pcount,
           const int64_t* group_nodes, const int* leaf_idx,
           const int* n_leaves, float* out, int ng, int LL, int G,
           const Scalars& sc, cudaStream_t stream) {
    hydro_kernel<KT, MODE><<<ng, sph::WARPS * 32, 0, stream>>>(
        (const float4*)src, valid, (const float4*)tgt, pstart, pcount,
        group_nodes, leaf_idx, n_leaves, out, LL, G, sc);
    return (int)cudaGetLastError();
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
        return launch<KT, M>(src, valid, tgt, pstart, pcount, group_nodes, \
                             leaf_idx, n_leaves, out, ng, LL, G, sc,       \
                             stream);
    switch (mode) {
        SPH_HYDRO_MODE(0)
        SPH_HYDRO_MODE(1)
        SPH_HYDRO_MODE(2)
        SPH_HYDRO_MODE(3)
    }
#undef SPH_HYDRO_MODE
    return (int)cudaErrorInvalidValue;
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
// as the plain version holds them.  Launches one CTA a group on `stream`
// and returns cudaGetLastError() (cudaErrorInvalidValue for a G, ktype or
// mode it does not take); does not synchronise.
extern "C" int sph_hydro_f32(const void* src, const uint8_t* valid,
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
    switch (ktype) {
    case sph::CUBIC:
        return launch_mode<sph::CUBIC>(mode, src, valid, tgt, pstart, pcount,
                                       group_nodes, leaf_idx, n_leaves, out,
                                       ng, LL, G, sc, stream);
    case sph::QUINTIC:
        return launch_mode<sph::QUINTIC>(mode, src, valid, tgt, pstart,
                                         pcount, group_nodes, leaf_idx,
                                         n_leaves, out, ng, LL, G, sc,
                                         stream);
    case sph::QUARTIC:
        return launch_mode<sph::QUARTIC>(mode, src, valid, tgt, pstart,
                                         pcount, group_nodes, leaf_idx,
                                         n_leaves, out, ng, LL, G, sc,
                                         stream);
    }
    return (int)cudaErrorInvalidValue;
}
