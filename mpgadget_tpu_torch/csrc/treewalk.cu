// Block tree walk with fused monopoles (short-range gravity) for Hopper.
//
// Replaces the TPU walk mpgadget_tpu/gravity/treewalk.py:traverse_fused,
// a vmap of lax.while_loop (body :145-194), and the port's plain batched
// loop gravity/treewalk.py:traverse_fused_reference.  For each target
// block of G particles, a stackless preorder walk over the skip-pointer
// tree (descend = i + 1, reject / accept = skip[i]):
//
//  - discard a node whose nearest distance from the block's bounding box
//    is beyond rcut;
//  - open it by the relative criterion (m l^2 > r^4 aold, with the BH
//    angle as a cap) or by BH, or when the box is inside it or touches it;
//  - otherwise apply its monopole to all G targets (and the potential,
//    a template branch as in the pair kernel);
//  - record opened leaves, up to LL; when the list is full the overflow
//    flag is set and the walk goes on.
//
// Bound: latency, not bytes or operations.  Each visit's next node
// depends on this one's row, so a block's walk is a chain of dependent
// loads (mostly L2 hits: the node table is a few MB).  Design: one CTA
// per block and TPT targets per thread with their sums in registers; the
// decision depends only on block-level data and the node, so every
// thread computes it identically and the branch is uniform: no
// divergence and no __syncthreads per node.  The whole walk is one
// launch.  A node is two float4 rows (center, length; com, mass) and one
// int (skip | leaf bit << 31), packed once per tree by
// gravity/treewalk.py:pack_nodes.
//
// The decisions must equal the plain version's bit for bit (the leaf
// lists feed the pair kernel and the overflow retries), so this file is
// compiled with -fmad=false and the criterion spells out the plain
// version's association with __fmul_rn / __fadd_rn.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shortrange.cuh"

// targets per thread: the decision is made once per warp, so fewer warps
// per block spend fewer issue slots on it (G = 256 -> 2 warps)
#define TPT 4

template <bool WITH_POT>
__global__ void tree_walk_kernel(
    const float4* __restrict__ nodes, const int* __restrict__ meta,
    const int64_t* __restrict__ n_nodes_p, const float* __restrict__ tpos,
    const float* __restrict__ center, const float* __restrict__ half,
    const float* __restrict__ aold, const uint8_t* __restrict__ active,
    float* __restrict__ acc, float* __restrict__ pot,
    int64_t* __restrict__ leaf_idx, int64_t* __restrict__ n_leaves,
    uint8_t* __restrict__ overflow, int* __restrict__ visits,
    int* __restrict__ monopoles, int G, int C, int LL, float rcut,
    float rcut2, float bh_angle2, int use_bh, float rs_inv, float h_inv) {
    const int b = blockIdx.x;
    const int n_nodes = (int)*n_nodes_p;
    const float h3_inv = h_inv * h_inv * h_inv;

    // target g = threadIdx.x + t * blockDim.x, t < TPT
    float x[TPT], y[TPT], z[TPT], ax[TPT], ay[TPT], az[TPT], ph[TPT];
#pragma unroll
    for (int t = 0; t < TPT; ++t) {
        const int g = threadIdx.x + t * blockDim.x;
        x[t] = y[t] = z[t] = 0.f;
        ax[t] = ay[t] = az[t] = ph[t] = 0.f;
        if (g < G) {
            const int64_t r = ((int64_t)b * G + g) * 3;
            x[t] = tpos[r];
            y[t] = tpos[r + 1];
            z[t] = tpos[r + 2];
        }
    }
    const float cx = center[3 * b], cy = center[3 * b + 1],
                cz = center[3 * b + 2];
    const float hx = half[3 * b], hy = half[3 * b + 1], hz = half[3 * b + 2];
    const float ao = aold[b];
    const bool bh_only = use_bh || ao <= 0.f;
    int64_t* leaves = leaf_idx + (int64_t)b * LL;

    int nl = 0, nvis = 0, nmono = 0;
    bool ovf = false;
    int i = active[b] ? 0 : n_nodes;
    while (i < n_nodes) {
        // a tree that overflowed its capacity may point past it: read
        // its last row then, as the plain version does
        const int ic = min(i, C - 1);
        const float4 geo = __ldg(nodes + 2 * (int64_t)ic);      // c, length
        const float4 mom = __ldg(nodes + 2 * (int64_t)ic + 1);  // com, mass
        const int mt = __ldg(meta + ic);
        ++nvis;
        const float ln = geo.w;
        const float dcx = fabsf(min_image(__fsub_rn(geo.x, cx)));
        const float dcy = fabsf(min_image(__fsub_rn(geo.y, cy)));
        const float dcz = fabsf(min_image(__fsub_rn(geo.z, cz)));
        const float hl = __fmul_rn(0.5f, ln);
        const float dmx = fmaxf(__fsub_rn(__fsub_rn(dcx, hx), hl), 0.f);
        const float dmy = fmaxf(__fsub_rn(__fsub_rn(dcy, hy), hl), 0.f);
        const float dmz = fmaxf(__fsub_rn(__fsub_rn(dcz, hz), hl), 0.f);
        const float r2min = __fadd_rn(
            __fadd_rn(__fmul_rn(dmx, dmx), __fmul_rn(dmy, dmy)),
            __fmul_rn(dmz, dmz));
        const int skip = mt & 0x7FFFFFFF;
        if (r2min > rcut2) {            // discard
            i = skip;
            continue;
        }
        bool open = __fmul_rn(ln, ln) > __fmul_rn(bh_angle2, r2min);
        if (!bh_only) {
            open = open || (__fmul_rn(__fmul_rn(mom.w, ln), ln)
                            > __fmul_rn(__fmul_rn(r2min, r2min), ao));
        }
        const float l6 = __fmul_rn(0.6f, ln);
        open = open || r2min <= 0.f
               || (dcx < __fadd_rn(hx, l6) && dcy < __fadd_rn(hy, l6)
                   && dcz < __fadd_rn(hz, l6));
        if (!open) {                    // monopole on every target
            ++nmono;
#pragma unroll
            for (int t = 0; t < TPT; ++t) {
                const float dx = min_image(mom.x - x[t]);
                const float dy = min_image(mom.y - y[t]);
                const float dz = min_image(mom.z - z[t]);
                float ff, pp;
                pair_terms<WITH_POT, true>(dx * dx + dy * dy + dz * dz,
                                           mom.w, rs_inv, h_inv, h3_inv,
                                           rcut, ff, pp);
                ax[t] += ff * dx;
                ay[t] += ff * dy;
                az[t] += ff * dz;
                if (WITH_POT) ph[t] += pp;
            }
            i = skip;
        } else if (mt < 0) {            // opened leaf: record it
            if (nl < LL) {
                if (threadIdx.x == 0) leaves[nl] = i;
                ++nl;
            } else {
                ovf = true;
            }
            i = skip;
        } else {
            i = i + 1;                  // descend
        }
    }
    for (int s = nl + threadIdx.x; s < LL; s += blockDim.x) leaves[s] = C;
#pragma unroll
    for (int t = 0; t < TPT; ++t) {
        const int g = threadIdx.x + t * blockDim.x;
        if (g < G) {
            const int64_t arow = (int64_t)b * 3 * G + g;
            acc[arow] = ax[t];
            acc[arow + G] = ay[t];
            acc[arow + 2 * G] = az[t];
            pot[(int64_t)b * G + g] = ph[t];
        }
    }
    if (threadIdx.x == 0) {
        n_leaves[b] = nl;
        overflow[b] = ovf;
        visits[b] = nvis;
        monopoles[b] = nmono;
    }
}

// Plain C entry point, loaded with ctypes.  Device pointers: nodes f32
// (C, 8), meta int32 (C), n_nodes int64 scalar, tpos f32 (nb, G, 3),
// center/half f32 (nb, 3), aold f32 (nb), active bool (nb); outputs acc
// f32 (nb, 3, G), pot f32 (nb, G), leaf_idx int64 (nb, LL), n_leaves int64
// (nb), overflow bool (nb), visits/monopoles int32 (nb).  Launches on
// `stream` and returns cudaGetLastError() (0 on success); does not
// synchronise.
extern "C" int tree_walk_f32(
    const float* nodes, const int* meta, const int64_t* n_nodes,
    const float* tpos, const float* center, const float* half,
    const float* aold, const uint8_t* active, float* acc, float* pot,
    int64_t* leaf_idx, int64_t* n_leaves, uint8_t* overflow, int* visits,
    int* monopoles, int nb, int G, int C, int LL, float rcut, float rcut2,
    float bh_angle2, int use_bh, float rs_inv, float h_inv,
    int with_potential, void* stream) {
    if (nb <= 0) return (int)cudaSuccess;
    const int threads = ((G + TPT * 32 - 1) / (TPT * 32)) * 32;
    cudaStream_t st = (cudaStream_t)stream;
    const float4* nd = reinterpret_cast<const float4*>(nodes);
    if (with_potential) {
        tree_walk_kernel<true><<<nb, threads, 0, st>>>(
            nd, meta, n_nodes, tpos, center, half, aold, active, acc, pot,
            leaf_idx, n_leaves, overflow, visits, monopoles, G, C, LL, rcut,
            rcut2, bh_angle2, use_bh, rs_inv, h_inv);
    } else {
        tree_walk_kernel<false><<<nb, threads, 0, st>>>(
            nd, meta, n_nodes, tpos, center, half, aold, active, acc, pot,
            leaf_idx, n_leaves, overflow, visits, monopoles, G, C, LL, rcut,
            rcut2, bh_angle2, use_bh, rs_inv, h_inv);
    }
    return (int)cudaGetLastError();
}
