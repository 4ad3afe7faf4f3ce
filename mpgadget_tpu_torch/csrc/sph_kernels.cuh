// SPH smoothing kernels as device functions for the pair kernels K4
// (sph_density.cu) and K5 (sph_hydro.cu): the polynomials of
// mpgadget_tpu_torch/sph/kernels.py (and mpgadget_tpu/sph/kernels.py,
// libgadget/densitykernel.c), Price 2011 conventions.  H is the support
// radius; u = r/H; q = u * support.  Each function keeps the plain
// version's association, so that with -fmad=false it rounds as the
// plain version's separate float32 operations do wherever the powers
// are exact products (the plain version's integer powers above 3 may
// differ in the last bit; they only enter sums).
#pragma once

#include <cstdint>

namespace sph {

enum KernelType { CUBIC = 1, QUINTIC = 2, QUARTIC = 4 };

__device__ __forceinline__ float pos(float x) { return fmaxf(x, 0.0f); }
__device__ __forceinline__ float p2(float x) { return x * x; }
__device__ __forceinline__ float p3(float x) { return x * x * x; }
__device__ __forceinline__ float p4(float x) { return p2(x) * p2(x); }
__device__ __forceinline__ float p5(float x) { return p4(x) * x; }

template <int K> struct Kernel;

template <> struct Kernel<CUBIC> {
    static constexpr float support = 2.0f;
    static constexpr double sigma3 = 1.0 / 3.14159265358979323846;
    __device__ static float wk(float q) {
        return 0.25f * p3(pos(2.0f - q)) - p3(pos(1.0f - q));
    }
    __device__ static float dwk(float q) {
        return -0.75f * p2(pos(2.0f - q)) + 3.0f * p2(pos(1.0f - q));
    }
};

template <> struct Kernel<QUARTIC> {
    static constexpr float support = 2.5f;
    static constexpr double sigma3 = 1.0 / (20 * 3.14159265358979323846);
    __device__ static float wk(float q) {
        return p4(pos(2.5f - q)) - 5.0f * p4(pos(1.5f - q))
               + 10.0f * p4(pos(0.5f - q));
    }
    __device__ static float dwk(float q) {
        return -4.0f * p3(pos(2.5f - q)) + 20.0f * p3(pos(1.5f - q))
               - 40.0f * p3(pos(0.5f - q));
    }
};

template <> struct Kernel<QUINTIC> {
    static constexpr float support = 3.0f;
    static constexpr double sigma3 = 1.0 / (120 * 3.14159265358979323846);
    __device__ static float wk(float q) {
        return p5(pos(3.0f - q)) - 6.0f * p5(pos(2.0f - q))
               + 15.0f * p5(pos(1.0f - q));
    }
    __device__ static float dwk(float q) {
        return -5.0f * p4(pos(3.0f - q)) + 30.0f * p4(pos(2.0f - q))
               - 75.0f * p4(pos(1.0f - q));
    }
};

// W(r, H) = sigma / h^3 w(q); hinv = 1/H
template <int K>
__device__ __forceinline__ float kernel_wk(float u, float hinv) {
    const float s = Kernel<K>::support;
    const float norm = (float)Kernel<K>::sigma3 * p3(hinv * s);
    return norm * Kernel<K>::wk(u * s);
}

// dW/dr
template <int K>
__device__ __forceinline__ float kernel_dwk(float u, float hinv) {
    const float s = Kernel<K>::support;
    const float norm = (float)Kernel<K>::sigma3 * p3(hinv * s) * (hinv * s);
    return norm * Kernel<K>::dwk(u * s);
}

// d(rho)/dH per neighbour (densitykernel.h:47-50)
__device__ __forceinline__ float kernel_dW(float u, float wk, float dwk,
                                           float hinv) {
    return -(3.0f * hinv * wk + u * dwk);
}

// 4/3 pi, the kernel volume of a unit support radius
constexpr float NORM_COEFF = (float)(4.0 / 3 * 3.14159265358979323846);

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
    return a < b ? a : b;
}

// min-image difference in box units: d - round(d), round half to even
// (torch.round, jnp.round)
__device__ __forceinline__ float wrap(float d) { return d - rintf(d); }

}  // namespace sph
