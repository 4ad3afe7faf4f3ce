// K6's first design: the primordial cooling network of one gas
// particle per thread.  A measurement aid: chip_smoke.py times it beside
// csrc/cooling.cu, the kernel the port runs, and holds the two to the same
// bits; the run never launches it.  Its entry points are cooling.cu's.
//
// One thread holds one particle's whole bisection and fixed point in
// registers and runs every iteration: 50 x (30 x 2 + 1) network
// evaluations, one chain of ~4M dependent instructions.  On an NVIDIA H100
// 80GB HBM3 (700 W) one row alone takes 14.4 ms and lya's 31k gas rows
// 20.9 ms (chip_smoke.py), against an operation bound of 0.23 ms: it is
// bound by the latency of that chain.
//
// Every operation follows the plain version (physics/cooling.py) in the
// JAX package's association, so the two differ only by the library's exp,
// log and pow: Python scalars become T(x) (rounded once, as JAX's weak
// types are), composite scalar factors arrive precomputed in double
// (CoolArgs), a Python scalar over a tensor is a true division.  Built
// with -fmad=false and without fast math: no contraction, IEEE division
// and square root, denormals kept.  Templated on the scalar type: float
// in the run, double for init_sfr's one-particle threshold.  Change the
// arithmetic here, in cooling.cu and in physics/cooling.py together.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr double BOLTZMANN = 1.38066e-16;
constexpr double BOLEVK = 8.61734e-5;
constexpr double EV_IN_ERGS = 1.60218e-12;
constexpr double PROTONMASS = 1.6726e-24;
constexpr double GAMMA_MINUS1 = 5.0 / 3.0 - 1.0;
constexpr double LOG10_E = 0.4342944819032518;
constexpr double LOG10_3P2E5 = 5.505149978319906;   // numpy log10(3.2e5)

enum { KWH92 = 0, ENZO2NYX = 1, SHERWOOD = 2 };
enum { CEN92 = 0, VERNER96 = 1, BADNELL06 = 2 };

// fixed trip counts, as physics/cooling.py:NE_ITERS and BISECT_ITERS
constexpr int NE_ITERS = 30;       // Steffensen iterations of equilib_ne
constexpr int BISECT_ITERS = 50;   // bisection steps of do_cooling

// Scalars, in the order of physics/cooling.py:kernel_args.
struct CoolArgs {
    double gJH0, gJHe0, gJHep, epsH0, epsHe0, epsHep;
    double nssh_fac;      // 1.003 * self_shield_dens
    double ss_cut;        // self_shield_dens * 0.01
    double hy;            // 1 - helium
    double yy;            // helium / 4 / (1 - helium)
    double hy2;           // (1 - helium) ** 2
    double min_gas_temp;
    double tcmb;          // CMBTemperature * (1 + z)
    double cmptn;         // the Compton factor times tcmb ** 4
    double rcb_z3;        // rho_crit_baryon * (1 + z) ** 3
    double he_thresh, he_amp, he_exp;
    double dens_cgs, uu, tt, min_u;
    int recomb, cooling, self_shield, helium_heat;
};
constexpr int N_DOUBLES = 22;
constexpr int N_INTS = 4;

__device__ __forceinline__ float Sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double Sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float Exp(float x) { return expf(x); }
__device__ __forceinline__ double Exp(double x) { return exp(x); }
__device__ __forceinline__ float Log(float x) { return logf(x); }
__device__ __forceinline__ double Log(double x) { return log(x); }
__device__ __forceinline__ float Pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double Pow(double x, double y) { return pow(x, y); }
// maximum / minimum that keep a NaN in x, as torch.clamp and jnp.maximum
template <typename T> __device__ __forceinline__ T Max(T x, T y) {
    return x < y ? y : x;
}
template <typename T> __device__ __forceinline__ T Min(T x, T y) {
    return x > y ? y : x;
}
template <typename T> __device__ __forceinline__ T Log10(T x) {
    return Log(x) * T(LOG10_E);
}

// ---- rate coefficients (make_rates) ---------------------------------------

template <typename T>
__device__ T verner96(T t, double aa, T one_m_bb, T one_p_bb, double t0,
                      double t1) {
    T s0 = Sqrt(t / T(t0));
    T s1 = Sqrt(t / T(t1));
    return T(aa) / (s0 * Pow(T(1) + s0, one_m_bb) * Pow(T(1) + s1, one_p_bb));
}

template <typename T>
__device__ T verner96(T t, double aa, double bb, double t0, double t1) {
    return verner96(t, aa, T(1 - bb), T(1 + bb), t0, t1);
}

template <typename T>
__device__ T voronov96(T t, double dE, int PP, double AA, double XX,
                       double KK) {
    T UU = T(dE) / (T(BOLEVK) * t);
    return T(AA) * (T(1) + T(PP) * Sqrt(UU)) / (T(XX) + UU) * Pow(UU, T(KK))
           * Exp(-Min(UU, T(70)));
}

template <typename T> __device__ T alphaHp(const CoolArgs& a, T t) {
    if (a.recomb == CEN92)
        return T(8.4e-11) / Sqrt(t) / Pow(t / T(1000), T(0.2))
               / (T(1) + Pow(t / T(1e6), T(0.7)));
    if (a.recomb == VERNER96)
        return verner96(t, 7.982e-11, 0.748, 3.148, 7.036e5);
    return verner96(t, 8.318e-11, 0.7472, 2.965, 7.001e5);
}

template <typename T> __device__ T alphaHep(const CoolArgs& a, T t) {
    if (a.recomb == CEN92) return T(1.5e-10) / Pow(t, T(0.6353));
    if (a.recomb == VERNER96) {
        T low = verner96(t, 3.294e-11, 0.6910, 1.554e1, 3.676e7);
        T high = verner96(t, 9.356e-10, 0.7892, 4.266e-2, 4.677e6);
        T interp = (low * (T(8e5) - t) + high * (t - T(6e5))) / T(2e5);
        return t < T(6e5) ? low : (t > T(8e5) ? high : interp);
    }
    return verner96(t, 1.818e-10, 0.7492, 10.17, 2.786e6);
}

template <typename T> __device__ T alphad(const CoolArgs& a, T t) {
    if (a.recomb == CEN92)
        return T(1.9e-3) / Pow(t, T(1.5)) * Exp(T(-4.7e5) / t)
               * (T(1) + T(0.3) * Exp(T(-9.4e4) / t));
    return T(1.23e-3) / Pow(t, T(1.5)) * Exp(T(-4.72e5) / t)
           * (T(1) + T(0.3) * Exp(T(-9.4e4) / t));
}

template <typename T> __device__ T alphaHepp(const CoolArgs& a, T t) {
    if (a.recomb == CEN92) return T(4) * alphaHp(a, t);
    if (a.recomb == VERNER96)
        return verner96(t, 1.891e-10, 0.7524, 9.370, 2.774e6);
    T bb = T(0.6988) + T(0.0829) * Exp(T(-1.682e5) / t);
    return verner96(t, 5.235e-11, T(1) - bb, T(1) + bb, 7.301, 4.475e6);
}

template <typename T> __device__ T GammaeH0(const CoolArgs& a, T t) {
    if (a.recomb == CEN92)
        return T(5.85e-11) * Sqrt(t) * Exp(T(-157809.1) / t)
               / (T(1) + Sqrt(t / T(1e5)));
    return voronov96(t, 13.6, 0, 0.291e-07, 0.232, 0.39);
}

template <typename T> __device__ T GammaeHe0(const CoolArgs& a, T t) {
    if (a.recomb == CEN92)
        return T(2.38e-11) * Sqrt(t) * Exp(T(-285335.4) / t)
               / (T(1) + Sqrt(t / T(1e5)));
    return voronov96(t, 24.6, 0, 0.175e-07, 0.180, 0.35);
}

template <typename T> __device__ T GammaeHep(const CoolArgs& a, T t) {
    if (a.recomb == CEN92)
        return T(5.68e-12) * Sqrt(t) * Exp(T(-631515.0) / t)
               / (T(1) + Sqrt(t / T(1e5)));
    return voronov96(t, 54.4, 1, 0.205e-08, 0.265, 0.25);
}

template <typename T> __device__ T t5(const CoolArgs& a, T t) {
    return T(1) + Sqrt(t / T(a.cooling == KWH92 ? 1e5 : 5e7));
}

// x ** j by repeated squaring, in the order of JAX's lax.integer_pow
template <typename T> __device__ T integer_pow(T x, int j) {
    if (j == 0) return T(1);
    T acc = T(0);
    bool have = false;
    while (j > 0) {
        if (j & 1) {
            acc = have ? acc * x : x;
            have = true;
        }
        j >>= 1;
        if (j > 0) x = x * x;
    }
    return acc;
}

template <typename T> __device__ T collisH0(const CoolArgs& a, T t) {
    if (a.cooling == ENZO2NYX) {
        const double low[6] = {213.7913, 113.9492, 25.06062, 2.762755,
                               0.1515352, 3.290382e-3};
        const double high[6] = {271.25446, 98.019455, 14.00728, 0.9780842,
                                3.356289e-2, 4.553323e-4};
        T y = Log(t);
        T tot = T(-0.75 / BOLTZMANN * 2.1798741e-11) / t;
        for (int j = 0; j < 6; ++j)
            tot = tot + (t < T(1e5) ? T(low[j]) : T(high[j]))
                            * integer_pow(-y, j);
        return T(1e-20) * Exp(tot);
    }
    T excite = T(7.5e-19) * Exp(T(-118348.0) / t) / t5(a, t);
    T ionize = T(13.5984 * EV_IN_ERGS) * GammaeH0(a, t);
    return excite + ionize;
}

template <typename T> __device__ T collisHe0(const CoolArgs& a, T t) {
    return T(9.1e-27) * Pow(t, T(-0.1687)) * Exp(T(-473638.0) / t) / t5(a, t)
           + T(24.5874 * EV_IN_ERGS) * GammaeHe0(a, t);
}

template <typename T> __device__ T collisHeP(const CoolArgs& a, T t) {
    return T(5.54e-17) * Pow(t, T(-0.397)) * Exp(T(-473638.0) / t) / t5(a, t)
           + T(54.417760 * EV_IN_ERGS) * GammaeHep(a, t);
}

template <typename T> __device__ T recombHp(const CoolArgs& a, T t) {
    if (a.cooling == ENZO2NYX)
        return T(2.851e-27) * Sqrt(t)
               * (T(5.914) - T(0.5) * Log(t)
                  + T(0.01184) * Pow(t, T(1.0 / 3)));
    return T(0.75 * BOLTZMANN) * t * alphaHp(a, t);
}

template <typename T> __device__ T recombHeP(const CoolArgs& a, T t) {
    return T(0.75 * BOLTZMANN) * t * alphaHep(a, t)
           + T(6.526e-11) * alphad(a, t);
}

template <typename T> __device__ T recombHePP(const CoolArgs& a, T t) {
    if (a.cooling == ENZO2NYX)
        return T(1.140e-26) * Sqrt(t)
               * (T(6.607) - T(0.5) * Log(t)
                  + T(7.459e-3) * Pow(t, T(1.0 / 3)));
    return T(0.75 * BOLTZMANN) * t * alphaHepp(a, t);
}

template <typename T> __device__ T freefree(const CoolArgs& a, T t, int zz) {
    T gff;
    if (a.cooling == ENZO2NYX) {
        T lt = T(2) * Log10(t / T(zz));
        gff = lt <= T(LOG10_3P2E5) ? T(0.79464) + T(0.1243) * lt
                                   : T(2.13164) - T(0.1240) * lt;
    } else {
        T x = T(5.5) - Log10(t);
        gff = T(1.1) + T(0.34) * Exp(-(x * x) / T(3));
    }
    return T(1.426e-27) * Sqrt(t) * T(zz * zz) * gff;
}

// ---- the network (CoolingRates) -------------------------------------------

template <typename T>
__device__ T temp_internal(const CoolArgs& a, T nebynh, T ienergy) {
    T mui = T(4) / (T(a.hy) * (T(3) + T(4) * nebynh) + T(1)) * ienergy;
    T temp = T(GAMMA_MINUS1 * PROTONMASS / BOLTZMANN) * mui;
    return Max(temp, T(a.min_gas_temp));
}

template <typename T>
__device__ T self_shield_corr(const CoolArgs& a, T nh, T temp) {
    if (!a.self_shield) return T(1);
    T T4 = Pow(temp / T(1e4), T(0.17));
    T nSSh = T(a.nssh_fac) * T4;
    T corr = T(0.98) * Pow(T(1) + Pow(nh / nSSh, T(1.64)), T(-2.28))
             + T(0.02) * Pow(T(1) + nh / nSSh, T(-0.84));
    return nh < T(a.ss_cut) ? T(1) : corr;
}

template <typename T> struct Ions { T nH0, nHp, nHe0, nHep, nHepp; };

template <typename T>
__device__ Ions<T> network(const CoolArgs& a, T nh, T temp, T ne, T photofac) {
    const T tiny = T(1e-50);   // 0 in float, as in the JAX package's f32
    Ions<T> r;
    T safe_ne = Max(ne, tiny);
    bool has_ne = ne > tiny;
    T photoH = has_ne ? T(a.gJH0) / safe_ne * photofac : T(0);
    T aHp = alphaHp(a, temp);
    T gH0 = GammaeH0(a, temp);
    r.nH0 = aHp / (aHp + gH0 + photoH);
    r.nHp = Max(T(1) - r.nH0, T(0));
    T aHep = alphad(a, temp) + alphaHep(a, temp);
    T aHepp = alphaHepp(a, temp);
    T gHe0 = GammaeHe0(a, temp)
             + (has_ne ? T(a.gJHe0) / safe_ne * photofac : T(0));
    T gHep = GammaeHep(a, temp)
             + (has_ne ? T(a.gJHep) / safe_ne * photofac : T(0));
    if (gHe0 > tiny) {
        T mg = Max(gHe0, tiny);
        r.nHep = nh / (T(1) + aHep / mg + gHep / aHepp);
        r.nHe0 = r.nHep * aHep / mg;
        r.nHepp = r.nHep * gHep / aHepp;
    } else {
        r.nHep = T(0);
        r.nHe0 = nh;
        r.nHepp = T(0);
    }
    return r;
}

template <typename T>
__device__ T ne_internal(const CoolArgs& a, T nh, T ienergy, T ne) {
    T temp = temp_internal(a, ne / nh, ienergy);
    T photofac = self_shield_corr(a, nh, temp);
    Ions<T> r = network(a, nh, temp, ne, photofac);
    return nh * r.nHp + T(a.yy) * r.nHep + T(2 * a.yy) * r.nHepp;
}

// equilibrium ne (cgs) by the Steffensen fixed point on ne/nh
template <typename T>
__device__ T equilib_ne(const CoolArgs& a, T density, T ienergy, T ne_init) {
    T nh = density * T(a.hy);
    T ne0 = ne_init <= T(0) ? T(1) : ne_init;
    for (int i = 0; i < NE_ITERS; ++i) {
        T ne1 = ne_internal(a, nh, ienergy, ne0 * nh) / nh;
        T ne2 = ne_internal(a, nh, ienergy, ne1 * nh) / nh;
        T d = ne0 + ne2 - T(2) * ne1;
        T pp = (d < T(0) ? -d : d) > T(1e-15)
                   ? ne0 - (ne1 - ne0) * (ne1 - ne0) / d
                   : ne2;
        ne0 = Max(pp, T(0));
    }
    return ne0 * nh;
}

// net heating - cooling in erg/s/g, and ne/nh
template <typename T>
__device__ void heatingcooling(const CoolArgs& a, T density, T ienergy,
                               T ne_init, T& lam, T& nebynh) {
    T ne = equilib_ne(a, density, ienergy, ne_init);
    T nh = density * T(a.hy);
    nebynh = ne / nh;
    T temp = temp_internal(a, nebynh, ienergy);
    T photofac = self_shield_corr(a, nh, temp);
    Ions<T> r = network(a, nh, temp, ne, photofac);
    T nHe0 = r.nHe0 * T(a.yy) / nh;
    T nHep = r.nHep * T(a.yy) / nh;
    T nHepp = r.nHepp * T(a.yy) / nh;
    T collis = nebynh * (collisH0(a, temp) * r.nH0
                         + collisHe0(a, temp) * nHe0
                         + collisHeP(a, temp) * nHep);
    T recomb = nebynh * (recombHp(a, temp) * r.nHp
                         + recombHeP(a, temp) * nHep
                         + recombHePP(a, temp) * nHepp);
    T cff = freefree(a, temp, 1);
    T ff = a.cooling == ENZO2NYX
               ? nebynh * (cff * (r.nHp + nHep)
                           + freefree(a, temp, 2) * nHepp)
               : nebynh * (cff * (r.nHp + nHep) + T(4) * cff * nHepp);
    T cmptn = nebynh * (T(a.cmptn) * (temp - T(a.tcmb))) / nh;
    T lambda = collis + recomb + ff + cmptn;
    T heat = (r.nH0 * T(a.epsH0) + nHe0 * T(a.epsHe0) + nHep * T(a.epsHep))
             / nh;
    if (a.helium_heat) {
        T rho = T(PROTONMASS) * density / T(a.hy);
        T overden = Min(rho / T(a.rcb_z3), T(a.he_thresh));
        heat = heat * T(a.he_amp) * Pow(overden, T(a.he_exp));
    }
    T net = heat - lambda;
    lam = net * T(a.hy2) * density / T(PROTONMASS);
}

__device__ __forceinline__ int64_t row_of(const int64_t* rows, int64_t i) {
    return rows ? rows[i] : i;
}

template <typename T>
__global__ void __launch_bounds__(128)
do_cooling_kernel(const T* __restrict__ u_old, const T* __restrict__ rho,
                  const T* __restrict__ dt, const T* __restrict__ ne_guess,
                  T* __restrict__ u_new, T* __restrict__ ne_new,
                  const int64_t* __restrict__ rows, int64_t n_rows,
                  CoolArgs a) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_rows) return;
    int64_t p = row_of(rows, i);
    T rho_cgs = rho[p] * T(a.dens_cgs) / T(PROTONMASS);
    T min_u = T(a.min_u);
    T u_old_cgs = Max(u_old[p] * T(a.uu), min_u);
    T dt_s = dt[p] * T(a.tt);
    // the reference expands the bracket by 1.1 from u_old; 1.1^60 ~ 300x
    T u_lo = Max(u_old_cgs / T(300), min_u);
    T u_hi = u_old_cgs * T(300);
    T ne = ne_guess[p];
    for (int k = 0; k < BISECT_ITERS; ++k) {
        T u_mid = T(0.5) * (u_lo + u_hi);
        T lam, nebynh;
        heatingcooling(a, rho_cgs, u_mid, ne, lam, nebynh);
        ne = nebynh;
        T val = u_mid - u_old_cgs - lam * dt_s;
        if (val < T(0)) u_lo = u_mid;   // u too small: raise the lower bound
        else u_hi = u_mid;
    }
    T u = Max(T(0.5) * (u_lo + u_hi), min_u);
    u_new[p] = u / T(a.uu);
    ne_new[p] = ne;
}

template <typename T>
__global__ void __launch_bounds__(128)
heatingcooling_kernel(const T* __restrict__ density,
                      const T* __restrict__ ienergy,
                      const T* __restrict__ ne_init, T* __restrict__ lam,
                      T* __restrict__ ne_new,
                      const int64_t* __restrict__ rows, int64_t n_rows,
                      CoolArgs a) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_rows) return;
    int64_t p = row_of(rows, i);
    T l, e;
    heatingcooling(a, density[p], ienergy[p], ne_init[p], l, e);
    lam[p] = l;
    ne_new[p] = e;
}

CoolArgs unpack(const double* d, const int* k) {
    CoolArgs a;
    memcpy(&a.gJH0, d, N_DOUBLES * sizeof(double));
    memcpy(&a.recomb, k, N_INTS * sizeof(int));
    return a;
}

bool valid_options(const CoolArgs& a) {
    return a.recomb >= CEN92 && a.recomb <= BADNELL06 && a.cooling >= KWH92
           && a.cooling <= SHERWOOD;
}

constexpr int THREADS = 128;

template <typename T>
int launch_do_cooling(const T* u_old, const T* rho, const T* dt,
                      const T* ne_guess, T* u_new, T* ne_new,
                      const int64_t* rows, int64_t n_rows, const double* d,
                      const int* k, cudaStream_t stream) {
    if (n_rows <= 0) return (int)cudaSuccess;
    CoolArgs a = unpack(d, k);
    if (!valid_options(a)) return (int)cudaErrorInvalidValue;
    int64_t blocks = (n_rows + THREADS - 1) / THREADS;
    do_cooling_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
        u_old, rho, dt, ne_guess, u_new, ne_new, rows, n_rows, a);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_heatingcooling(const T* density, const T* ienergy,
                          const T* ne_init, T* lam, T* ne_new,
                          const int64_t* rows, int64_t n_rows,
                          const double* d, const int* k,
                          cudaStream_t stream) {
    if (n_rows <= 0) return (int)cudaSuccess;
    CoolArgs a = unpack(d, k);
    if (!valid_options(a)) return (int)cudaErrorInvalidValue;
    int64_t blocks = (n_rows + THREADS - 1) / THREADS;
    heatingcooling_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
        density, ienergy, ne_init, lam, ne_new, rows, n_rows, a);
    return (int)cudaGetLastError();
}

static_assert(offsetof(CoolArgs, recomb) == N_DOUBLES * sizeof(double)
                  && offsetof(CoolArgs, helium_heat)
                         == N_DOUBLES * sizeof(double)
                                + (N_INTS - 1) * sizeof(int),
              "CoolArgs: the doubles, then the ints, packed");

}  // namespace

// Plain C entry points, loaded with ctypes.  Device pointers to n-element
// arrays of one type (float or double); rows: int64 device array of the
// n_rows rows to compute, or null for rows 0..n_rows-1; other rows of the
// outputs are not written.  d (22 doubles) and k (4 ints): host arrays in
// the order of physics/cooling.py:kernel_args.  One thread a row on
// `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for an
// unknown rate option); does not synchronise.
//
// do_cooling: u_old, rho (internal units, physical), dt (internal time),
// ne_guess (ne/nh) -> u_new (internal), ne_new (ne/nh).
// heatingcooling_rate: density (protons/cm^3), ienergy (erg/g), ne_init
// (ne/nh) -> lam (erg/s/g), ne_new (ne/nh).
#define COOLING_ENTRIES(T, SUF)                                                \
    extern "C" int do_cooling_##SUF(                                           \
        const T* u_old, const T* rho, const T* dt, const T* ne_guess,          \
        T* u_new, T* ne_new, const int64_t* rows, int64_t n_rows,              \
        const double* d, const int* k, cudaStream_t stream) {                  \
        return launch_do_cooling<T>(u_old, rho, dt, ne_guess, u_new, ne_new,   \
                                    rows, n_rows, d, k, stream);               \
    }                                                                          \
    extern "C" int heatingcooling_rate_##SUF(                                  \
        const T* density, const T* ienergy, const T* ne_init, T* lam,          \
        T* ne_new, const int64_t* rows, int64_t n_rows, const double* d,       \
        const int* k, cudaStream_t stream) {                                   \
        return launch_heatingcooling<T>(density, ienergy, ne_init, lam,        \
                                        ne_new, rows, n_rows, d, k, stream);   \
    }

COOLING_ENTRIES(float, f32)
COOLING_ENTRIES(double, f64)
