// Dense block pair interactions (direct short-range gravity) for Hopper.
//
// Replaces the Pallas TPU kernel mpgadget_tpu/gravity/pairkernel.py
// (block_pair_accumulate, body _make_kernel).  For each of nb target
// blocks, G targets x S sources:
//
//   acc[b, :, g] = acc0[b, :, g] + sum_s m_s f(r) d
//   pot[b, g]    = pot0[b, g]    + sum_{s, r > 0} m_s phi(r) erfc(r rs_inv)
//
// with d the minimum-image separation in box units, f the cubic-spline
// softened Newton factor times the erfc force-split window, and both
// terms zero for r >= rcut.  The math is gravity/shortrange.py's
// (erfcf/expf here, torch.special.erfc in the plain version), not the
// TPU kernel's fitted window polynomial.
//
// Bound: FP32 ALU and SFU work, not bytes.  Each pair costs a sqrt, a
// divide, an exp and an erfc (~60 FP32 ops); a block reads 16 B per
// source once for G = 256 targets, so the arithmetic intensity is ~1000
// flop/B.  Design: one CTA per target block with one thread per target
// and the accumulators in registers; sources are streamed through
// shared memory in chunks of CHUNK (16 B each, 8 KB per chunk) and
// every thread reads the same source at once (a shared-memory
// broadcast).  Making it fast (fast-math intrinsics, several targets
// per thread, a second CTA per SM) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK 512

__device__ __forceinline__ float min_image(float d) {
    // d - round-half-even(d), as jnp.round / torch.round do
    return d - rintf(d);
}

template <bool WITH_POT>
__global__ void block_pair_kernel(
    const float* __restrict__ tx, const float* __restrict__ ty,
    const float* __restrict__ tz, const float* __restrict__ sx,
    const float* __restrict__ sy, const float* __restrict__ sz,
    const float* __restrict__ sm, const float* __restrict__ acc0,
    const float* __restrict__ pot0, float* __restrict__ acc,
    float* __restrict__ pot, int G, int S, float rs_inv, float h_inv,
    float rcut) {
    __shared__ float s_x[CHUNK];
    __shared__ float s_y[CHUNK];
    __shared__ float s_z[CHUNK];
    __shared__ float s_m[CHUNK];

    const int b = blockIdx.x;
    const int g = threadIdx.x;
    const bool live = g < G;
    const int64_t trow = (int64_t)b * G + g;
    const int64_t srow = (int64_t)b * S;

    float x = 0.f, y = 0.f, z = 0.f;
    float ax = 0.f, ay = 0.f, az = 0.f, ph = 0.f;
    if (live) {
        x = tx[trow];
        y = ty[trow];
        z = tz[trow];
    }
    const float h3_inv = h_inv * h_inv * h_inv;
    const float two_over_sqrt_pi = 1.1283791670955126f;

    for (int c0 = 0; c0 < S; c0 += CHUNK) {
        const int n = min(CHUNK, S - c0);
        __syncthreads();
        for (int j = threadIdx.x; j < n; j += blockDim.x) {
            s_x[j] = sx[srow + c0 + j];
            s_y[j] = sy[srow + c0 + j];
            s_z[j] = sz[srow + c0 + j];
            s_m[j] = sm[srow + c0 + j];
        }
        __syncthreads();
        if (!live) continue;
        for (int j = 0; j < n; ++j) {
            const float dx = min_image(s_x[j] - x);
            const float dy = min_image(s_y[j] - y);
            const float dz = min_image(s_z[j] - z);
            const float r = sqrtf(dx * dx + dy * dy + dz * dz);
            if (!(r < rcut)) continue;
            const float m = s_m[j];
            const float u = r * rs_inv;
            const float erfc_u = erfcf(u);
            const float w = erfc_u + two_over_sqrt_pi * u * expf(-u * u);
            const float rinv = r > 0.f ? 1.0f / fmaxf(r, 1e-30f) : 0.f;
            const float uh = r * h_inv;
            float fac;
            if (uh >= 1.0f) {
                fac = rinv * rinv * rinv;
            } else if (uh < 0.5f) {
                fac = h3_inv * (10.666666666667f
                                + uh * uh * (32.0f * uh - 38.4f));
            } else {
                const float uhs = fmaxf(uh, 1e-30f);
                fac = h3_inv * (21.333333333333f - 48.0f * uh
                                + 38.4f * uh * uh
                                - 10.666666666667f * uh * uh * uh
                                - 0.066666666667f / (uhs * uhs * uhs));
            }
            const float ff = fac * w * m;
            ax += ff * dx;
            ay += ff * dy;
            az += ff * dz;
            if (WITH_POT && r > 0.f) {
                float pfac;
                if (uh >= 1.0f) {
                    pfac = -rinv;
                } else if (uh < 0.5f) {
                    pfac = h_inv * (-2.8f + uh * uh * (5.333333333333f
                                    + uh * uh * (6.4f * uh - 9.6f)));
                } else {
                    pfac = h_inv * (-3.2f
                                    + 0.066666666667f / fmaxf(uh, 1e-30f)
                                    + uh * uh * (10.666666666667f
                                    + uh * (-16.0f + uh * (9.6f
                                    - 2.133333333333f * uh))));
                }
                ph += pfac * erfc_u * m;
            }
        }
    }
    if (!live) return;
    const int64_t arow = (int64_t)b * 3 * G + g;
    acc[arow] = acc0[arow] + ax;
    acc[arow + G] = acc0[arow + G] + ay;
    acc[arow + 2 * G] = acc0[arow + 2 * G] + az;
    pot[trow] = pot0[trow] + ph;
}

// Plain C entry point, loaded with ctypes.  All pointers are device
// pointers to contiguous float32 arrays: t* (nb, G), s* (nb, S),
// acc0/acc (nb, 3, G), pot0/pot (nb, G).  Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronise.
extern "C" int block_pair_accumulate_f32(
    const float* tx, const float* ty, const float* tz, const float* sx,
    const float* sy, const float* sz, const float* sm, const float* acc0,
    const float* pot0, float* acc, float* pot, int nb, int G, int S,
    float rs_inv, float h_inv, float rcut, int with_potential,
    void* stream) {
    if (nb <= 0) return (int)cudaSuccess;
    const int threads = ((G + 31) / 32) * 32;
    cudaStream_t st = (cudaStream_t)stream;
    if (with_potential) {
        block_pair_kernel<true><<<nb, threads, 0, st>>>(
            tx, ty, tz, sx, sy, sz, sm, acc0, pot0, acc, pot, G, S,
            rs_inv, h_inv, rcut);
    } else {
        block_pair_kernel<false><<<nb, threads, 0, st>>>(
            tx, ty, tz, sx, sy, sz, sm, acc0, pot0, acc, pot, G, S,
            rs_inv, h_inv, rcut);
    }
    return (int)cudaGetLastError();
}
