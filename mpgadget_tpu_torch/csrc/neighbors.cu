// Neighbour walk (kernel K3) for Hopper: the source leaves near each
// target group.
//
// Replaces mpgadget_tpu/ops/pairs.py:find_neighbors (:108-160), a vmap of
// lax.while_loop, and the port's plain batched loop
// ops/pairs.py:find_neighbors_reference.  For each target group (a tree
// node holding at most group_max particles, with its particles' bounding
// box) it walks the per-level tree in preorder, stackless (descend =
// i + 1, skip = skip[i]):
//
//   dc    = |min_image(center_node - center_group)|       per axis
//   dmin  = max(dc - half_group - 0.5 length_node, 0)      per axis
//   r2min = (dmin_x^2 + dmin_y^2) + dmin_z^2
//   reach = max(radius, hmax[node]) if symmetric, else radius
//
// a node with r2min < reach^2 is near: a near leaf is recorded in DFS
// order, a near internal node is descended, anything else is skipped.
// The count is incremented first and the flag set when it reaches LL
// (pairs.py:146-147), so a group with exactly LL leaves is flagged too:
// flags and retries are the JAX package's.  A padding group (node index
// >= n_nodes) records nothing.
//
// Bound: the node table is read once (16 + 4 bytes a node) and the leaf
// lists written once, against ~25 FP32 operations a visit; the walk is a
// chain of dependent loads as long as the group's visits.  The test is
// made once per group, not once per particle, so the first form is one
// thread per group walking serially: every group's chain runs at once,
// and the card's many threads hide each other's L2 round trips.  A walk
// shared across a CTA (K2's stack of ranges and markers, treewalk.cu) is
// later work.
//
// The decisions must equal the plain version's bit for bit: compiled with
// -fmad=false, with its association spelled out (__fsub_rn and friends),
// and min_image rounds half to even as torch.round and jnp.round do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shortrange.cuh"

#define NT 128

template <bool SYMMETRIC>
__global__ void __launch_bounds__(NT) find_neighbors_kernel(
    const float4* __restrict__ nodes, const float* __restrict__ hmax,
    const int* __restrict__ meta, const int64_t* __restrict__ n_nodes_p,
    const int64_t* __restrict__ group_nodes, const float* __restrict__ center,
    const float* __restrict__ half, const float* __restrict__ radius,
    int* __restrict__ leaf_idx, int* __restrict__ n_leaves,
    uint8_t* __restrict__ overflow, int* __restrict__ visits, int ng, int C,
    int LL) {
    const int g = blockIdx.x * NT + threadIdx.x;
    if (g >= ng) return;
    const int n_nodes = (int)*n_nodes_p;
    const float cx = center[3 * g], cy = center[3 * g + 1],
                cz = center[3 * g + 2];
    const float hx = half[3 * g], hy = half[3 * g + 1], hz = half[3 * g + 2];
    const float rad = radius[g];
    int* out = leaf_idx + (int64_t)g * LL;

    int nl = 0, nvis = 0;
    bool ovf = false;
    int i = group_nodes[g] < (int64_t)n_nodes ? 0 : n_nodes;
    while (i < n_nodes) {
        // a tree that overflowed its capacity may point past it: read its
        // last row then, as the plain version does
        const int ic = min(i, C - 1);
        const float4 geo = __ldg(nodes + ic);      // center, length
        const int mt = __ldg(meta + ic);
        ++nvis;
        const float dcx = fabsf(min_image(__fsub_rn(geo.x, cx)));
        const float dcy = fabsf(min_image(__fsub_rn(geo.y, cy)));
        const float dcz = fabsf(min_image(__fsub_rn(geo.z, cz)));
        const float hl = __fmul_rn(0.5f, geo.w);
        const float dmx = fmaxf(__fsub_rn(__fsub_rn(dcx, hx), hl), 0.f);
        const float dmy = fmaxf(__fsub_rn(__fsub_rn(dcy, hy), hl), 0.f);
        const float dmz = fmaxf(__fsub_rn(__fsub_rn(dcz, hz), hl), 0.f);
        const float r2min = __fadd_rn(
            __fadd_rn(__fmul_rn(dmx, dmx), __fmul_rn(dmy, dmy)),
            __fmul_rn(dmz, dmz));
        const float reach = SYMMETRIC ? fmaxf(rad, __ldg(hmax + ic)) : rad;
        const bool near = r2min < __fmul_rn(reach, reach);
        const bool leaf = mt < 0;
        if (near && leaf) {
            if (nl < LL) out[nl++] = i;
            ovf |= nl >= LL;
        }
        i = (near && !leaf) ? i + 1 : (mt & 0x7FFFFFFF);
    }
    n_leaves[g] = nl;
    overflow[g] = ovf;
    visits[g] = nvis;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// leaf_idx must hold C in every slot beforehand (the wrapper fills it):
// the kernel writes only the recorded leaves.
extern "C" int find_neighbors_f32(
    const void* nodes, const float* hmax, const int* meta,
    const int64_t* n_nodes, const int64_t* group_nodes, const float* center,
    const float* half, const float* radius, int* leaf_idx, int* n_leaves,
    uint8_t* overflow, int* visits, int ng, int C, int LL, int symmetric,
    cudaStream_t stream) {
    if (ng <= 0) return (int)cudaSuccess;
    if (C <= 0 || LL <= 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((ng + NT - 1) / NT);
    if (symmetric)
        find_neighbors_kernel<true><<<grid, NT, 0, stream>>>(
            (const float4*)nodes, hmax, meta, n_nodes, group_nodes, center,
            half, radius, leaf_idx, n_leaves, overflow, visits, ng, C, LL);
    else
        find_neighbors_kernel<false><<<grid, NT, 0, stream>>>(
            (const float4*)nodes, hmax, meta, n_nodes, group_nodes, center,
            half, radius, leaf_idx, n_leaves, overflow, visits, ng, C, LL);
    return (int)cudaGetLastError();
}
