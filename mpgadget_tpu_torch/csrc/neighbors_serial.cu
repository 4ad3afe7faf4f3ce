// Serial neighbour walk: a yardstick, not on the simulation's path
// (chip_smoke.py alone loads it).  This was the port's first neighbour
// walk kernel; csrc/neighbors.cu computes the same function and is what
// the package launches.  It is kept so that one run on one card can time
// the two designs side by side and hold their results against each other
// bit for bit.
//
// One thread per target group walks the per-level tree in preorder,
// stackless (descend = i + 1, skip = skip[i]), and makes the decision of
// csrc/neighbors.cu on every node it visits.  Each visit's next node
// depends on this one's row, so a group's walk is one chain of dependent
// loads as long as its visits: the serial design's limit, not the
// function's.  Compiled with -fmad=false like neighbors.cu; the arguments
// of find_neighbors_f32 without rounds, loads, serial and qcap, and
// leaf_idx must hold C in every slot beforehand.

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
extern "C" int find_neighbors_serial_f32(
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
