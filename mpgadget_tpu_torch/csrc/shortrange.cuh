// Short-range pair terms shared by the pair kernel (pairkernel.cu, K1) and
// the tree walk's monopoles (treewalk.cu, K2).
//
// The math is gravity/shortrange.py's: the erfc force-split window times
// the cubic-spline softened Newton factor (gravshort-tree.c:157-195),
// zero for r >= rcut.  It is written in the form of the TPU kernel's
// _pair_terms (mpgadget_tpu/gravity/pairkernel.py:45-81): one rsqrt of
// max(r2, 1e-30), r = r2 * rinv, and one exp(-u^2) shared by both windows,
//
//   w_force(u) = exp(-u^2) * (erfcx(u) + 2u/sqrt(pi)),
//   w_pot(u)   = exp(-u^2) * erfcx(u)             (= erfc(u)),
//
// so there is no divide, no sqrt and no second exponential on the common
// path.  erfcx is a polynomial fit (below); the TPU kernel fitted
// Q = erfcx + 2u/sqrt(pi) to 1.2e-5 in w, this fit is tighter so that the
// card's tree force stays within 1e-5 by norm of the CPU's.

#pragma once

#include <cuda_runtime.h>

#define TWO_OVER_SQRT_PI 1.1283791670955126f

__device__ __forceinline__ float min_image(float d) {
    // d - round-half-even(d), as torch.round does
    return __fsub_rn(d, rintf(d));
}

// erfcx(u) on u in [0, 3.5]: degree-12 polynomial in t = u/1.75 - 1,
// weighted least squares on a Chebyshev basis (numpy, scipy.special.erfcx
// as the target).  Relative error < 1e-6 in float32 Horner form
// (tests/test_torch_walkkernel.py holds these coefficients against
// scipy).  Beyond u = 3.5 the window is crushed by exp(-u^2) < 5e-6, and
// dm-small's rcut is u = 3.
#define ERFCX_NCOEF 13
__device__ __forceinline__ float erfcx_fit(float u) {
    const float t = fmaf(u, 0.571428571f, -1.0f);
    float p = 1.322439755e-03f;            // ERFCX_COEF (descending)
    p = fmaf(p, t, -3.050815780e-03f);
    p = fmaf(p, t, 2.034642501e-03f);
    p = fmaf(p, t, -2.875122475e-03f);
    p = fmaf(p, t, 9.868625551e-03f);
    p = fmaf(p, t, -1.870233938e-02f);
    p = fmaf(p, t, 2.987133339e-02f);
    p = fmaf(p, t, -4.916772246e-02f);
    p = fmaf(p, t, 7.879809290e-02f);
    p = fmaf(p, t, -1.193499863e-01f);
    p = fmaf(p, t, 1.707793027e-01f);
    p = fmaf(p, t, -2.292069048e-01f);
    p = fmaf(p, t, 2.849721909e-01f);      // end ERFCX_COEF
    return p;
}

// Force factor ff (F = ff * d) and potential pp of one source of mass m at
// squared separation r2, both zero for r >= rcut.  POT_AT_R0: whether a
// source at r = 0 adds to the potential (the walk's monopoles do, the
// direct pair sum excludes the self pair).
template <bool WITH_POT, bool POT_AT_R0>
__device__ __forceinline__ void pair_terms(float r2, float m, float rs_inv,
                                           float h_inv, float h3_inv,
                                           float rcut, float& ff, float& pp) {
    const float rinv = rsqrtf(fmaxf(r2, 1e-30f));
    const float r = r2 * rinv;
    const float u = r * rs_inv;
    const float e = __expf(-u * u);
    const float p = erfcx_fit(u);
    const float uh = r * h_inv;
    const bool in = r < rcut;
    float fac = rinv * rinv * rinv;
    if (uh < 1.0f) {     // inside the softening length: rare
        if (uh < 0.5f) {
            fac = h3_inv * (10.666666666667f + uh * uh * (32.0f * uh - 38.4f));
        } else {
            fac = h3_inv * (21.333333333333f - 48.0f * uh + 38.4f * uh * uh
                            - 10.666666666667f * uh * uh * uh
                            - 0.066666666667f / (uh * uh * uh));
        }
    }
    ff = in ? fac * (e * fmaf(TWO_OVER_SQRT_PI, u, p)) * m : 0.0f;
    if (WITH_POT) {
        float pfac = -rinv;
        if (uh < 1.0f) {
            if (uh < 0.5f) {
                pfac = h_inv * (-2.8f + uh * uh * (5.333333333333f
                                + uh * uh * (6.4f * uh - 9.6f)));
            } else {
                pfac = h_inv * (-3.2f + 0.066666666667f / uh
                                + uh * uh * (10.666666666667f
                                + uh * (-16.0f + uh * (9.6f
                                - 2.133333333333f * uh))));
            }
        }
        pp = (in && (POT_AT_R0 || r > 0.0f)) ? pfac * (e * p) * m : 0.0f;
    }
}
