// Dense block pair interactions (direct short-range gravity) for Hopper.
//
// Replaces the Pallas TPU kernel mpgadget_tpu/gravity/pairkernel.py
// (block_pair_accumulate, body _make_kernel).  For each of nb target
// blocks, G targets x the block's first count[b] of S source slots:
//
//   acc[b, :, g] = acc0[b, :, g] + sum_s m_s f(r) d
//   pot[b, g]    = pot0[b, g]    + sum_{s, r > 0} m_s phi(r) erfc(r rs_inv)
//
// with d the minimum-image separation in box units, f the cubic-spline
// softened Newton factor times the erfc force-split window, and both
// terms zero for r >= rcut (shortrange.cuh, in the TPU kernel's form).
//
// Bound: FP32 work, not bytes.  A pair costs ~64 FP32 operations (~72
// with the potential) against 16 B per source read once for G = 256
// targets.  Design:
//  - Work items are (block, range of T sources), listed on the device by
//    gravity/pairkernel.py:pair_work_items from the per-block counts, so
//    the zero-mass padding after count[b] costs nothing and a block with
//    many sources is spread over many CTAs: the launch time follows the
//    real work, not the widest block.
//  - A persistent grid (as many CTAs as fit on the card) strides over the
//    items; one thread per target keeps its sums in registers (threads
//    past G run the loop too, so that every warp is whole).
//  - A source beyond rcut of all 32 targets of a warp is skipped by the
//    whole warp (a vote, so the branch is uniform).
//  - Sources stream through shared memory in chunks of CHUNK, as float4
//    (x, y, z, m), double-buffered with cp.async so that the next chunk
//    loads while this one is computed; every thread reads the same
//    source at once (a broadcast).
//  - A block of one item writes acc0 + its sums directly; a block of
//    several writes one partial (3, G) + (G,) per item, and a second pass
//    adds acc0 and the partials in item order.  No float atomics: the
//    result is the same on every run.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "shortrange.cuh"

#define CHUNK 256

__device__ __forceinline__ void cp_async4(void* smem, const float* gmem) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Start copying sources [c0, c0 + n) of one row into dst as (x, y, z, m).
__device__ __forceinline__ void load_chunk(float4* dst, const float* sx,
                                           const float* sy, const float* sz,
                                           const float* sm, int64_t off,
                                           int n) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        float* d = reinterpret_cast<float*>(dst + j);
        cp_async4(d + 0, sx + off + j);
        cp_async4(d + 1, sy + off + j);
        cp_async4(d + 2, sz + off + j);
        cp_async4(d + 3, sm + off + j);
    }
    cp_async_commit();
}

template <bool WITH_POT>
__global__ void pair_items_kernel(
    const float* __restrict__ tx, const float* __restrict__ ty,
    const float* __restrict__ tz, const float* __restrict__ sx,
    const float* __restrict__ sy, const float* __restrict__ sz,
    const float* __restrict__ sm, const float* __restrict__ acc0,
    const float* __restrict__ pot0, float* __restrict__ acc,
    float* __restrict__ pot, float* __restrict__ part,
    const int* __restrict__ item_block, const int* __restrict__ item_start,
    const int* __restrict__ count, const int* __restrict__ n_items,
    int nb, int G, int S, int T, int max_items, float rs_inv, float h_inv,
    float rcut) {
    __shared__ float4 s_src[2][CHUNK];
    const int g = threadIdx.x;
    const bool live = g < G;
    const float h3_inv = h_inv * h_inv * h_inv;
    // a little above rcut^2: the exact cut is pair_terms' r < rcut
    const float rc2 = rcut * rcut * 1.0001f;

    for (int k = blockIdx.x; k < max_items; k += gridDim.x) {
        const int b = item_block[k];
        if (b >= nb) break;             // items past the last are sentinels
        const int s0 = item_start[k];
        const int s1 = min(s0 + T, min(count[b], S));
        const int64_t srow = (int64_t)b * S;
        const int64_t trow = (int64_t)b * G + g;
        float x = 0.f, y = 0.f, z = 0.f;
        if (live) {
            x = tx[trow];
            y = ty[trow];
            z = tz[trow];
        }
        float ax = 0.f, ay = 0.f, az = 0.f, ph = 0.f;
        const int nchunk = (s1 - s0 + CHUNK - 1) / CHUNK;
        __syncthreads();                // the last item's reads are done
        if (nchunk > 0) {
            load_chunk(s_src[0], sx, sy, sz, sm, srow + s0,
                       min(CHUNK, s1 - s0));
        }
        for (int c = 0; c < nchunk; ++c) {
            const int c0 = s0 + c * CHUNK;
            const int n = min(CHUNK, s1 - c0);
            if (c + 1 < nchunk) {
                load_chunk(s_src[(c + 1) & 1], sx, sy, sz, sm,
                           srow + c0 + CHUNK, min(CHUNK, s1 - c0 - CHUNK));
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            const float4* src = s_src[c & 1];
#pragma unroll 4
            for (int j = 0; j < n; ++j) {
                const float4 s = src[j];
                const float dx = min_image(s.x - x);
                const float dy = min_image(s.y - y);
                const float dz = min_image(s.z - z);
                const float r2 = dx * dx + dy * dy + dz * dz;
                // a source beyond rcut of every target of the warp adds
                // nothing: skip it for the whole warp (uniform branch)
                if (__any_sync(0xFFFFFFFFu, r2 < rc2)) {
                    float ff, pp;
                    pair_terms<WITH_POT, false>(r2, s.w, rs_inv, h_inv,
                                                h3_inv, rcut, ff, pp);
                    ax += ff * dx;
                    ay += ff * dy;
                    az += ff * dz;
                    if (WITH_POT) ph += pp;
                }
            }
            __syncthreads();            // buffer c & 1 is free again
        }
        if (!live) continue;
        if (n_items[b] == 1) {
            const int64_t arow = (int64_t)b * 3 * G + g;
            acc[arow] = acc0[arow] + ax;
            acc[arow + G] = acc0[arow + G] + ay;
            acc[arow + 2 * G] = acc0[arow + 2 * G] + az;
            pot[trow] = WITH_POT ? pot0[trow] + ph : pot0[trow];
        } else {
            const int64_t prow = (int64_t)k * 4 * G + g;
            part[prow] = ax;
            part[prow + G] = ay;
            part[prow + 2 * G] = az;
            part[prow + 3 * G] = ph;
        }
    }
}

// Blocks of zero or several items: acc0 + the partials, in item order.
__global__ void pair_reduce_kernel(
    const float* __restrict__ acc0, const float* __restrict__ pot0,
    float* __restrict__ acc, float* __restrict__ pot,
    const float* __restrict__ part, const int* __restrict__ first_item,
    const int* __restrict__ n_items, int nb, int G, int with_potential) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (int64_t)nb * G) return;
    const int b = (int)(t / G);
    const int g = (int)(t - (int64_t)b * G);
    const int n = n_items[b];
    if (n == 1) return;                 // written by pair_items_kernel
    float ax = 0.f, ay = 0.f, az = 0.f, ph = 0.f;
    for (int i = 0; i < n; ++i) {
        const int64_t prow = (int64_t)(first_item[b] + i) * 4 * G + g;
        ax += part[prow];
        ay += part[prow + G];
        az += part[prow + 2 * G];
        ph += part[prow + 3 * G];
    }
    const int64_t arow = (int64_t)b * 3 * G + g;
    acc[arow] = acc0[arow] + ax;
    acc[arow + G] = acc0[arow + G] + ay;
    acc[arow + 2 * G] = acc0[arow + 2 * G] + az;
    pot[t] = with_potential ? pot0[t] + ph : pot0[t];
}

// Plain C entry point, loaded with ctypes.  All pointers are device
// pointers to contiguous arrays: t* f32 (nb, G), s* f32 (nb, S),
// acc0/acc f32 (nb, 3, G), pot0/pot f32 (nb, G), part f32
// (max_items, 4, G) scratch; item_block/item_start int32 (max_items),
// count/first_item/n_items int32 (nb), from pair_work_items.  Launches
// both passes on `stream` and returns the first CUDA error (0 on
// success); does not synchronise.
extern "C" int block_pair_accumulate_f32(
    const float* tx, const float* ty, const float* tz, const float* sx,
    const float* sy, const float* sz, const float* sm, const float* acc0,
    const float* pot0, float* acc, float* pot, float* part,
    const int* item_block, const int* item_start, const int* count,
    const int* first_item, const int* n_items, int nb, int G, int S, int T,
    int max_items, float rs_inv, float h_inv, float rcut,
    int with_potential, void* stream) {
    if (nb <= 0) return (int)cudaSuccess;
    const int threads = ((G + 31) / 32) * 32;
    cudaStream_t st = (cudaStream_t)stream;
    int dev = 0, nsm = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, with_potential ? pair_items_kernel<true>
                                    : pair_items_kernel<false>,
            threads, 0);
    if (err != cudaSuccess) return (int)err;
    const int grid = std::max(1, std::min(max_items,
                                          nsm * std::max(per_sm, 1)));
    if (max_items > 0) {
        if (with_potential) {
            pair_items_kernel<true><<<grid, threads, 0, st>>>(
                tx, ty, tz, sx, sy, sz, sm, acc0, pot0, acc, pot, part,
                item_block, item_start, count, n_items, nb, G, S, T,
                max_items, rs_inv, h_inv, rcut);
        } else {
            pair_items_kernel<false><<<grid, threads, 0, st>>>(
                tx, ty, tz, sx, sy, sz, sm, acc0, pot0, acc, pot, part,
                item_block, item_start, count, n_items, nb, G, S, T,
                max_items, rs_inv, h_inv, rcut);
        }
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const int64_t nt = (int64_t)nb * G;
    pair_reduce_kernel<<<(unsigned)((nt + 255) / 256), 256, 0, st>>>(
        acc0, pot0, acc, pot, part, first_item, n_items, nb, G,
        with_potential);
    return (int)cudaGetLastError();
}
