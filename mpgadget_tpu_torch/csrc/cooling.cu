// K6: the primordial cooling network, a group of LANES lanes per gas
// particle, leaving its loops where they would only repeat themselves.
//
// Replaces the two XLA loops of mpgadget_tpu/physics/cooling.py: the
// Steffensen fixed point for the equilibrium electron density
// (get_equilib_ne, its fori_loop at :462) inside the net heating/cooling
// rate (get_heatingcooling_rate, :465-519), and the implicit energy update
// of do_cooling (:548-587), a 50-step bisection (:584) over that rate.
//
// What bounds it: the latency of one particle's chain of dependent
// instructions, not throughput.  The first design (csrc/cooling_simple.cu,
// kept as the yardstick) runs every iteration, 50 x (30 x 2 + 1) network
// evaluations of ~1,300 instructions each in one thread: on an NVIDIA H100
// 80GB HBM3 (700 W) 14.4 ms for one row, 20.9 ms for lya's 31k gas rows,
// against an operation bound of 0.23 ms.  This design shortens the chain
// in two ways, neither of which changes a bit of the result:
//
// * Exact exits.  A Steffensen iteration is a function of its iterate
//   alone (given the row's density and energy), and a bisection step a
//   function of (u_lo, u_hi, ne) alone.  So once an iterate repeats one of
//   the last NE_PERIOD iterates bit for bit (a fixed point, or a cycle in
//   the last bits), every further iteration runs through that cycle, and
//   the value the full count would end on is the member the iterations
//   left select: the loop stops there.  The bisection does the same with
//   its state over BISECT_PERIOD steps.  A NaN never equals itself, -0
//   is told from +0, and the caps NE_ITERS and BISECT_ITERS stay.  In
//   float32 a warm-started row needs a median of one to two hundred
//   network evaluations instead of 3,050 (PERF.md section 6, from
//   chip_smoke.cooling_exits).  When the Steffensen iteration ends on its
//   own input, the closing network evaluation of the rate is the one
//   already made at that input, and is reused.
// * Lanes.  The rate coefficients of one network evaluation depend on the
//   temperature alone.  The LANES lanes of a row compute them side by
//   side: the Verner & Ferland recombination fits (up to four) one a lane,
//   the three collisional ionization rates one a lane, and in the closing
//   terms the He0 / He+ excitation rates one a lane; every lane then reads
//   them all with __shfl_sync within the group and carries on with the
//   same values.  Lanes of one warp that ran different functions would
//   run them one after another, so a slot is one function on every lane
//   with the lane's constants; what has one instance (alphad, the
//   self-shielding factor, the ion network itself) every lane computes
//   alike.  So every lane of a row holds the same state, takes the same
//   branches and exits, and lane 0 writes the row.  Each row's loop makes
//   one network evaluation an iteration, whether for the fixed point or
//   for the closing rate, so the rows of a warp at different points of
//   their loops still evaluate the network together.
//
// Every operation follows the plain version (physics/cooling.py) in the
// JAX package's association, so the two differ only by the library's exp,
// log and pow: Python scalars become T(x) (rounded once, as JAX's weak
// types are), composite scalar factors arrive precomputed in double
// (CoolArgs), a Python scalar over a tensor is a true division.  A value
// computed on another lane is computed by the same operations, and a rate
// reused is the one the first design computes again, so the outputs equal
// the first design's bit for bit.  Built with -fmad=false and without fast
// math: no contraction, IEEE division and square root, denormals kept.
// Templated on the scalar type: float in the run, double for init_sfr's
// one-particle threshold.  Change the arithmetic here, in
// cooling_simple.cu and in physics/cooling.py together.
//
// Two optional per-row inputs (null: off), which the first design does not
// take:
// * the six UV rates of each row (patchy reionization gates them row by
//   row, the excursion set derives them from each row's J21), in the rows'
//   type, in place of the scalars of CoolArgs; they enter the photo-rates
//   of every network evaluation and the heating of the net rate;
// * the metallicity of each row (float) with a Cloudy metal cooling table
//   (float, on the device): the net rate loses Z times the table's rate at
//   (z, log10 nH, log10 T), an 8-corner trilinear lookup with edge clamps
//   done in float whatever the rows' type, as the JAX package does
//   (physics/cooling.py:MetalCoolingTable).  Only the net rate sees it: the
//   Steffensen loop for ne does not, and a bisection step stays a function
//   of (u_lo, u_hi, ne) alone, so the exits stay exact.  The table is small
//   and read through the read-only cache, by every lane of a row alike.
// The kernels are instantiated twice, on EXT: a launch with neither input
// runs the EXT = false code, which reads the scalars where the first
// design does and has no branch on the optional inputs.

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

// trip counts and the longest cycles closed, as physics/cooling.py's
constexpr int NE_ITERS = 30;       // Steffensen iterations of equilib_ne
constexpr int BISECT_ITERS = 50;   // bisection steps of do_cooling
constexpr int NE_PERIOD = 16;
constexpr int BISECT_PERIOD = 2;

constexpr int LANES = 4;           // lanes a row: the most fits a slot has
constexpr int THREADS = 128;

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
    // the metal cooling table's grid, float values: the redshift, the first
    // bin, the bin width and the last index of each axis
    double met_z, met_min[3], met_step[3], met_top[3];
    int recomb, cooling, self_shield, helium_heat;
    int met_dims[3];
};
constexpr int N_DOUBLES = 32;
constexpr int N_INTS = 7;

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
// x and y hold the same bits and are no NaN
__device__ __forceinline__ bool same(float x, float y) {
    return x == y && __float_as_uint(x) == __float_as_uint(y);
}
__device__ __forceinline__ bool same(double x, double y) {
    return x == y && __double_as_longlong(x) == __double_as_longlong(y);
}

// A row's UV rates: the per-row array's, or CoolArgs' scalars rounded to T.
template <typename T> struct Uv { T gJH0, gJHe0, gJHep, epsH0, epsHe0, epsHep; };

template <typename T>
__device__ __forceinline__ Uv<T> uv_of(const CoolArgs& a, const T* uv,
                                       int64_t p) {
    if (uv) {
        const T* r = uv + 6 * p;
        return {r[0], r[1], r[2], r[3], r[4], r[5]};
    }
    return {T(a.gJH0), T(a.gJHe0), T(a.gJHep), T(a.epsH0), T(a.epsHe0),
            T(a.epsHep)};
}

// One UV rate: the row's with EXT, else CoolArgs' scalar rounded to T.
template <bool EXT, typename T>
__device__ __forceinline__ T uv_rate(T row, double scalar) {
    return EXT ? row : T(scalar);
}

// The metal table's net cooling rate at (z, lnh, lt) in float
// (MetalCoolingTable.__call__): f clamped to [0, dims - 1], its corner cell
// to [0, dims - 2], the corners summed in the order 0..7 (z the slowest
// bit), each weight the product of three in axis order.
__device__ float metal_rate(const CoolArgs& a, const float* __restrict__ tab,
                            float lnh, float lt) {
    const float x[3] = {float(a.met_z), lnh, lt};
    int i0[3];
    float w[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        float f = (x[k] - float(a.met_min[k])) / float(a.met_step[k]);
        f = Min(Max(f, 0.0f), float(a.met_top[k]));
        int i = (int)f;
        i0[k] = i < 0 ? 0 : (i > a.met_dims[k] - 2 ? a.met_dims[k] - 2 : i);
        w[k] = f - float(i0[k]);
    }
    float out = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const int b0 = (c >> 2) & 1, b1 = (c >> 1) & 1, b2 = c & 1;
        float wt = (b0 ? w[0] : 1.0f - w[0]) * (b1 ? w[1] : 1.0f - w[1]);
        wt = wt * (b2 ? w[2] : 1.0f - w[2]);
        int64_t idx = ((int64_t)(i0[0] + b0) * a.met_dims[1] + (i0[1] + b1))
                          * a.met_dims[2] + (i0[2] + b2);
        out = out + wt * __ldg(tab + idx);
    }
    return out;
}

// What a row brings besides its density and energy: its UV rates, and its
// metallicity with the metal table (tab null: no metal term).
template <typename T> struct RowIn {
    Uv<T> uv;
    float z_met;
    const float* tab;
};

// ---- the lanes of a row ----------------------------------------------------

// A Verner & Ferland 1996 fit, aa / (s0 (1+s0)^(1-bb) (1+s1)^(1+bb)) with
// s = sqrt(t / t0), or (dyn) Badnell's alphaHepp, whose bb depends on t.
template <typename T> struct FitC { T aa, omb, opb, t0, t1; bool dyn; };
// A collisional ionization rate: Voronov 1997 (dE, PP, AA, XX, KK), or
// Cen 1992's AA sqrt(t) exp(dE / t) / (1 + sqrt(t / 1e5)) (dE = -E).
template <typename T> struct IonC { T dE, PP, AA, XX, KK; };
// A collisional excitation rate of He0 or He+ (Cen 1992): cc t^ee
// exp(-473638 / t) / t5.
template <typename T> struct ExcC { T cc, ee; };

constexpr int N_FIT = 4;   // VERNER96: alphaHp, alphaHep's two fits, alphaHepp
constexpr int N_ION = 3;   // GammaeH0, GammaeHe0, GammaeHep
constexpr int N_EXC = 2;   // collisHe0's and collisHeP's excitation parts
static_assert(N_FIT <= LANES && N_ION <= LANES && N_EXC <= LANES,
              "a lane computes at most one instance of a slot");

template <typename T>
__device__ void set_fit(FitC<T>& c, double aa, double bb, double t0,
                        double t1) {
    c.aa = T(aa);
    c.omb = T(1 - bb);
    c.opb = T(1 + bb);
    c.t0 = T(t0);
    c.t1 = T(t1);
    c.dyn = false;
}

// fit k of the recombination option (CEN92's two rates are no fits: the
// slot computes them by their own formulas, fit_rate)
template <typename T> __device__ FitC<T> fit_consts(int recomb, int k) {
    FitC<T> c{};
    if (recomb == VERNER96) {
        if (k == 0) set_fit(c, 7.982e-11, 0.748, 3.148, 7.036e5);
        if (k == 1) set_fit(c, 3.294e-11, 0.6910, 1.554e1, 3.676e7);
        if (k == 2) set_fit(c, 9.356e-10, 0.7892, 4.266e-2, 4.677e6);
        if (k == 3) set_fit(c, 1.891e-10, 0.7524, 9.370, 2.774e6);
    } else if (recomb == BADNELL06) {
        if (k == 0) set_fit(c, 8.318e-11, 0.7472, 2.965, 7.001e5);
        if (k == 1) set_fit(c, 1.818e-10, 0.7492, 10.17, 2.786e6);
        if (k == 2) {
            set_fit(c, 5.235e-11, 0.0, 7.301, 4.475e6);
            c.dyn = true;
        }
    }
    return c;
}

template <typename T> __device__ IonC<T> ion_consts(int recomb, int k) {
    IonC<T> c{};
    const double cen_c[3] = {5.85e-11, 2.38e-11, 5.68e-12};
    const double cen_e[3] = {-157809.1, -285335.4, -631515.0};
    const double dE[3] = {13.6, 24.6, 54.4};
    const int PP[3] = {0, 0, 1};
    const double AA[3] = {0.291e-07, 0.175e-07, 0.205e-08};
    const double XX[3] = {0.232, 0.180, 0.265};
    const double KK[3] = {0.39, 0.35, 0.25};
    if (k >= N_ION) return c;
    if (recomb == CEN92) {
        c.AA = T(cen_c[k]);
        c.dE = T(cen_e[k]);
    } else {
        c.dE = T(dE[k]);
        c.PP = T(PP[k]);
        c.AA = T(AA[k]);
        c.XX = T(XX[k]);
        c.KK = T(KK[k]);
    }
    return c;
}

template <typename T> __device__ ExcC<T> exc_consts(int k) {
    ExcC<T> c{};
    if (k == 0) { c.cc = T(9.1e-27); c.ee = T(-0.1687); }
    if (k == 1) { c.cc = T(5.54e-17); c.ee = T(-0.397); }
    return c;
}

// lane `lane` of a row's group: instance k = lane of each slot, and the
// shuffle mask of its group
template <typename T> struct Lane {
    int lane, n_fit;
    unsigned mask;
    FitC<T> fit;
    IonC<T> ion;
    ExcC<T> exc;
};

template <typename T>
__device__ Lane<T> make_lane(const CoolArgs& a, int lane) {
    Lane<T> L;
    L.lane = lane;
    L.n_fit = a.recomb == VERNER96 ? 4 : (a.recomb == BADNELL06 ? 3 : 2);
    int first = (threadIdx.x & 31) & ~(LANES - 1);
    L.mask = ((1u << LANES) - 1) << first;
    L.fit = fit_consts<T>(a.recomb, lane);
    L.ion = ion_consts<T>(a.recomb, lane);
    L.exc = exc_consts<T>(lane);
    return L;
}

// instance k of a slot whose lane value is v: lane k of the group holds it
template <typename T>
__device__ __forceinline__ T gather(const Lane<T>& L, T v, int k) {
    return __shfl_sync(L.mask, v, k, LANES);
}

// ---- rate coefficients (make_rates) ---------------------------------------

template <typename T>
__device__ T verner96(T t, T aa, T one_m_bb, T one_p_bb, T t0, T t1) {
    T s0 = Sqrt(t / t0);
    T s1 = Sqrt(t / t1);
    return aa / (s0 * Pow(T(1) + s0, one_m_bb) * Pow(T(1) + s1, one_p_bb));
}

// slot "fit", instance k: the recombination rate k of the option
// (VERNER96: alphaHp, alphaHep below 6e5 K, above 8e5 K, alphaHepp;
// BADNELL06: alphaHp, alphaHep, alphaHepp; CEN92: alphaHp, alphaHep)
template <typename T>
__device__ T fit_rate(const CoolArgs& a, const FitC<T>& c, T t, int k) {
    if (a.recomb == CEN92) {
        if (k == 0)
            return T(8.4e-11) / Sqrt(t) / Pow(t / T(1000), T(0.2))
                   / (T(1) + Pow(t / T(1e6), T(0.7)));
        return T(1.5e-10) / Pow(t, T(0.6353));
    }
    T omb = c.omb, opb = c.opb;
    if (c.dyn) {
        T bb = T(0.6988) + T(0.0829) * Exp(T(-1.682e5) / t);
        omb = T(1) - bb;
        opb = T(1) + bb;
    }
    return verner96(t, c.aa, omb, opb, c.t0, c.t1);
}

// slot "ion": GammaeH0, GammaeHe0 or GammaeHep
template <typename T>
__device__ T ion_rate(const CoolArgs& a, const IonC<T>& c, T t) {
    if (a.recomb == CEN92)
        return c.AA * Sqrt(t) * Exp(c.dE / t) / (T(1) + Sqrt(t / T(1e5)));
    T UU = c.dE / (T(BOLEVK) * t);
    return c.AA * (T(1) + c.PP * Sqrt(UU)) / (c.XX + UU) * Pow(UU, c.KK)
           * Exp(-Min(UU, T(70)));
}

template <typename T> __device__ T alphad(const CoolArgs& a, T t) {
    if (a.recomb == CEN92)
        return T(1.9e-3) / Pow(t, T(1.5)) * Exp(T(-4.7e5) / t)
               * (T(1) + T(0.3) * Exp(T(-9.4e4) / t));
    return T(1.23e-3) / Pow(t, T(1.5)) * Exp(T(-4.72e5) / t)
           * (T(1) + T(0.3) * Exp(T(-9.4e4) / t));
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

// collisH0 of Enzo2Nyx cooling (the other options: excitation + ionization)
template <typename T> __device__ T collisH0_enzo(T t) {
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

// (the plain version computes corr on every row and then selects 1 below
// ss_cut; a row there is 1 whatever corr is, so it is not computed)
template <typename T>
__device__ T self_shield_corr(const CoolArgs& a, T nh, T temp) {
    if (!a.self_shield || nh < T(a.ss_cut)) return T(1);
    T T4 = Pow(temp / T(1e4), T(0.17));
    T nSSh = T(a.nssh_fac) * T4;
    return T(0.98) * Pow(T(1) + Pow(nh / nSSh, T(1.64)), T(-2.28))
           + T(0.02) * Pow(T(1) + nh / nSSh, T(-0.84));
}

// One network evaluation at ne (cgs): the temperature, the rates there
// (kept for the closing terms of the net rate) and the ion fractions.
template <typename T> struct Eval {
    T xe, temp;                          // ne/nh and the temperature
    T nH0, nHp, nHe0, nHep, nHepp;
    T aHp, aHep, aD, aHepp, gH0, gHe0, gHep;   // alphaHep, alphad apart
};

template <typename T, bool EXT>
__device__ Eval<T> evaluate(const CoolArgs& a, const Lane<T>& L,
                            const Uv<T>& uv, T nh, T ienergy, T ne) {
    Eval<T> e;
    e.xe = ne / nh;
    T temp = temp_internal(a, e.xe, ienergy);
    e.temp = temp;
    T fv = L.lane < L.n_fit ? fit_rate(a, L.fit, temp, L.lane) : T(0);
    T iv = L.lane < N_ION ? ion_rate(a, L.ion, temp) : T(0);
    T photofac = self_shield_corr(a, nh, temp);
    e.aD = alphad(a, temp);
    e.aHp = gather(L, fv, 0);
    if (a.recomb == VERNER96) {
        T low = gather(L, fv, 1), high = gather(L, fv, 2);
        T interp = (low * (T(8e5) - temp) + high * (temp - T(6e5))) / T(2e5);
        e.aHep = temp < T(6e5) ? low : (temp > T(8e5) ? high : interp);
        e.aHepp = gather(L, fv, 3);
    } else if (a.recomb == BADNELL06) {
        e.aHep = gather(L, fv, 1);
        e.aHepp = gather(L, fv, 2);
    } else {
        e.aHep = gather(L, fv, 1);
        e.aHepp = T(4) * e.aHp;
    }
    e.gH0 = gather(L, iv, 0);
    e.gHe0 = gather(L, iv, 1);
    e.gHep = gather(L, iv, 2);

    const T tiny = T(1e-50);   // 0 in float, as in the JAX package's f32
    T safe_ne = Max(ne, tiny);
    bool has_ne = ne > tiny;
    T photoH = has_ne ? uv_rate<EXT>(uv.gJH0, a.gJH0) / safe_ne * photofac
                      : T(0);
    e.nH0 = e.aHp / (e.aHp + e.gH0 + photoH);
    e.nHp = Max(T(1) - e.nH0, T(0));
    T aHep = e.aD + e.aHep;
    T gHe0 = e.gHe0 + (has_ne ? uv_rate<EXT>(uv.gJHe0, a.gJHe0) / safe_ne
                                    * photofac
                              : T(0));
    T gHep = e.gHep + (has_ne ? uv_rate<EXT>(uv.gJHep, a.gJHep) / safe_ne
                                    * photofac
                              : T(0));
    if (gHe0 > tiny) {
        T mg = Max(gHe0, tiny);
        e.nHep = nh / (T(1) + aHep / mg + gHep / e.aHepp);
        e.nHe0 = e.nHep * aHep / mg;
        e.nHepp = e.nHep * gHep / e.aHepp;
    } else {
        e.nHep = T(0);
        e.nHe0 = nh;
        e.nHepp = T(0);
    }
    return e;
}

// ne (cgs) from the ion fractions of an evaluation (ne_internal)
template <typename T>
__device__ T ne_of(const CoolArgs& a, T nh, const Eval<T>& e) {
    return nh * e.nHp + T(a.yy) * e.nHep + T(2 * a.yy) * e.nHepp;
}

// net heating - cooling in erg/s/g from the evaluation at the equilibrium
template <typename T, bool EXT>
__device__ T closing(const CoolArgs& a, const Lane<T>& L, const RowIn<T>& in,
                     const Eval<T>& e, T nh, T density) {
    T temp = e.temp, nebynh = e.xe;
    T nHe0 = e.nHe0 * T(a.yy) / nh;
    T nHep = e.nHep * T(a.yy) / nh;
    T nHepp = e.nHepp * T(a.yy) / nh;
    T t5v = t5(a, temp);
    T xv = L.lane < N_EXC ? L.exc.cc * Pow(temp, L.exc.ee)
                                * Exp(T(-473638.0) / temp) / t5v
                          : T(0);
    T cH0 = a.cooling == ENZO2NYX
                ? collisH0_enzo(temp)
                : T(7.5e-19) * Exp(T(-118348.0) / temp) / t5v
                      + T(13.5984 * EV_IN_ERGS) * e.gH0;
    T cHe0 = gather(L, xv, 0) + T(24.5874 * EV_IN_ERGS) * e.gHe0;
    T cHeP = gather(L, xv, 1) + T(54.417760 * EV_IN_ERGS) * e.gHep;
    T rHp, rHePP;
    if (a.cooling == ENZO2NYX) {
        rHp = T(2.851e-27) * Sqrt(temp)
              * (T(5.914) - T(0.5) * Log(temp)
                 + T(0.01184) * Pow(temp, T(1.0 / 3)));
        rHePP = T(1.140e-26) * Sqrt(temp)
                * (T(6.607) - T(0.5) * Log(temp)
                   + T(7.459e-3) * Pow(temp, T(1.0 / 3)));
    } else {
        rHp = T(0.75 * BOLTZMANN) * temp * e.aHp;
        rHePP = T(0.75 * BOLTZMANN) * temp * e.aHepp;
    }
    T rHeP = T(0.75 * BOLTZMANN) * temp * e.aHep + T(6.526e-11) * e.aD;
    T collis = nebynh * (cH0 * e.nH0 + cHe0 * nHe0 + cHeP * nHep);
    T recomb = nebynh * (rHp * e.nHp + rHeP * nHep + rHePP * nHepp);
    T cff = freefree(a, temp, 1);
    T ff = a.cooling == ENZO2NYX
               ? nebynh * (cff * (e.nHp + nHep)
                           + freefree(a, temp, 2) * nHepp)
               : nebynh * (cff * (e.nHp + nHep) + T(4) * cff * nHepp);
    T cmptn = nebynh * (T(a.cmptn) * (temp - T(a.tcmb))) / nh;
    T lambda = collis + recomb + ff + cmptn;
    T heat = (e.nH0 * uv_rate<EXT>(in.uv.epsH0, a.epsH0)
              + nHe0 * uv_rate<EXT>(in.uv.epsHe0, a.epsHe0)
              + nHep * uv_rate<EXT>(in.uv.epsHep, a.epsHep)) / nh;
    if (a.helium_heat) {
        T rho = T(PROTONMASS) * density / T(a.hy);
        T overden = Min(rho / T(a.rcb_z3), T(a.he_thresh));
        heat = heat * T(a.he_amp) * Pow(overden, T(a.he_exp));
    }
    T net = heat - lambda;
    if (EXT && in.tab) {
        // the lookup's coordinates in T, then rounded to float
        float lnh = (float)Log10(Max(nh, T(1e-30)));
        float lt = (float)Log10(Max(temp, T(1)));
        net = net - T(in.z_met * metal_rate(a, in.tab, lnh, lt));
    }
    return net * T(a.hy2) * density / T(PROTONMASS);
}

// ---- exact exits ------------------------------------------------------------

// After `done` steps of `iters`, the newest iterate x against the last P
// ones in h (h[0] the newest before x; `done` of them valid): if x repeats
// h[p-1] the sequence cycles with period p, and the iterate the remaining
// steps end on is h[p-1-m], m the steps left modulo p.  Returns whether the
// loop ends (a cycle, or the cap) with that iterate in fin; otherwise
// shifts x into h.  physics/cooling.py:iterate is the same rule.
template <int P, typename S, typename Same>
__device__ __forceinline__ bool cycle_end(const S& x, S (&h)[P], int done,
                                          int iters, S& fin, Same eq) {
    int hit = 0;
#pragma unroll
    for (int p = P; p >= 1; --p)
        if (p < done + 1 && eq(x, h[p - 1])) hit = p;
    if (hit) {
        int m = (iters - done) % hit;
        fin = x;
#pragma unroll
        for (int p = 1; p <= P; ++p)
            if (m && p == hit - m) fin = h[p - 1];
        return true;
    }
    if (done == iters) {
        fin = x;
        return true;
    }
#pragma unroll
    for (int p = P - 1; p >= 1; --p) h[p] = h[p - 1];
    h[0] = x;
    return false;
}

template <typename T> struct Bracket { T lo, hi, ne; };

// One row, every lane of its group alike: the net rate and ne/nh at
// (density, ienergy) from ne_init (heatingcooling_rate), or with BISECT
// do_cooling's bisection from u_old (ienergy) over dt_s, rate after rate.
// Its points: STEFF_A evaluates the network at the iterate ne0, STEFF_B
// at its image ne1 and takes the Steffensen step, TAIL at the equilibrium,
// adding the closing terms.  One evaluation an iteration, so that the rows
// of a warp evaluate together.  An evaluation is a function of (ienergy,
// ne) alone: where STEFF_B's point or the equilibrium is STEFF_A's, A's
// evaluation (kept) serves in the same iteration.  Results: (lam, ne/nh)
// or (u, ne/nh).
template <typename T, bool BISECT, bool EXT>
__device__ void solve_row(const CoolArgs& a, const Lane<T>& L,
                          const RowIn<T>& in, T density, T ienergy,
                          T ne_init, T dt_s, T& r0, T& r1) {
    enum { STEFF_A, STEFF_B, TAIL };
    T nh = density * T(a.hy);
    T min_u = T(a.min_u);
    T u_old = ienergy;
    // the reference expands the bracket by 1.1 from u_old; 1.1^60 ~ 300x
    Bracket<T> b[BISECT_PERIOD] = {};
    b[0] = {Max(u_old / T(300), min_u), u_old * T(300), ne_init};
    if (BISECT) ienergy = T(0.5) * (b[0].lo + b[0].hi);
    int steps = 0;
    T h[NE_PERIOD] = {};
    h[0] = ne_init <= T(0) ? T(1) : ne_init;
    int its = 0;
    int phase = STEFF_A;
    T ne1 = T(0);
    Eval<T> kept;                  // STEFF_A's evaluation, at h[0]
    auto eq = [](T x, T y) { return same(x, y); };
    auto eq3 = [](const Bracket<T>& x, const Bracket<T>& y) {
        return same(x.lo, y.lo) && same(x.hi, y.hi) && same(x.ne, y.ne);
    };
    for (;;) {
        Eval<T> e = evaluate<T, EXT>(a, L, in.uv, nh, ienergy,
                             (phase == STEFF_B ? ne1 : h[0]) * nh);
        int at = phase;
        bool tail = at == TAIL;
        if (at == STEFF_A) {
            kept = e;
            ne1 = ne_of(a, nh, e) / nh;
            phase = STEFF_B;
        }
        // STEFF_B, with A's evaluation where B's point is A's
        if (at == STEFF_B || (at == STEFF_A && same(ne1 * nh, h[0] * nh))) {
            T ne0 = h[0];
            T ne2 = ne_of(a, nh, e) / nh;
            T d = ne0 + ne2 - T(2) * ne1;
            T pp = (d < T(0) ? -d : d) > T(1e-15)
                       ? ne0 - (ne1 - ne0) * (ne1 - ne0) / d
                       : ne2;
            T fin;
            if (!cycle_end(Max(pp, T(0)), h, ++its, NE_ITERS, fin, eq)) {
                phase = STEFF_A;
            } else {
                phase = TAIL;
                tail = same(fin * nh, ne0 * nh);   // the equilibrium is A's
                if (tail) e = kept;
                h[0] = fin;
            }
        }
        if (!tail) continue;
        // the closing terms at one place, so that rows close together
        T lam = closing<T, EXT>(a, L, in, e, nh, density);
        if (!BISECT) {
            r0 = lam;
            r1 = e.xe;
            return;
        }
        T val = ienergy - u_old - lam * dt_s;
        // u too small: raise the lower bound
        Bracket<T> nb = val < T(0) ? Bracket<T>{ienergy, b[0].hi, e.xe}
                                   : Bracket<T>{b[0].lo, ienergy, e.xe};
        Bracket<T> fin;
        if (cycle_end(nb, b, ++steps, BISECT_ITERS, fin, eq3)) {
            r0 = Max(T(0.5) * (fin.lo + fin.hi), min_u);
            r1 = fin.ne;
            return;
        }
        ienergy = T(0.5) * (b[0].lo + b[0].hi);
        h[0] = b[0].ne <= T(0) ? T(1) : b[0].ne;
        its = 0;
        phase = STEFF_A;
    }
}

__device__ __forceinline__ int64_t row_of(const int64_t* rows, int64_t i) {
    return rows ? rows[i] : i;
}

template <typename T, bool EXT>
__device__ __forceinline__ RowIn<T> row_in(const CoolArgs& a, const T* uv,
                                           const float* met,
                                           const float* tab, int64_t p) {
    RowIn<T> in = {};
    if (!EXT) return in;            // unread: the scalars, no metal term
    in.uv = uv_of(a, uv, p);
    in.tab = met ? tab : nullptr;
    in.z_met = met ? met[p] : 0.0f;
    return in;
}

template <typename T, bool EXT>
__global__ void __launch_bounds__(THREADS)
do_cooling_kernel(const T* __restrict__ u_old, const T* __restrict__ rho,
                  const T* __restrict__ dt, const T* __restrict__ ne_guess,
                  T* __restrict__ u_new, T* __restrict__ ne_new,
                  const T* __restrict__ uv, const float* __restrict__ met,
                  const float* __restrict__ tab,
                  const int64_t* __restrict__ rows, int64_t n_rows,
                  CoolArgs a) {
    int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    int64_t i = t / LANES;
    if (i >= n_rows) return;
    Lane<T> L = make_lane<T>(a, (int)(t % LANES));
    int64_t p = row_of(rows, i);
    T rho_cgs = rho[p] * T(a.dens_cgs) / T(PROTONMASS);
    T u_old_cgs = Max(u_old[p] * T(a.uu), T(a.min_u));
    T dt_s = dt[p] * T(a.tt);
    T u, ne;
    solve_row<T, true, EXT>(a, L, row_in<T, EXT>(a, uv, met, tab, p),
                            rho_cgs, u_old_cgs, ne_guess[p], dt_s, u, ne);
    if (L.lane == 0) {
        u_new[p] = u / T(a.uu);
        ne_new[p] = ne;
    }
}

template <typename T, bool EXT>
__global__ void __launch_bounds__(THREADS)
heatingcooling_kernel(const T* __restrict__ density,
                      const T* __restrict__ ienergy,
                      const T* __restrict__ ne_init, T* __restrict__ lam,
                      T* __restrict__ ne_new, const T* __restrict__ uv,
                      const float* __restrict__ met,
                      const float* __restrict__ tab,
                      const int64_t* __restrict__ rows, int64_t n_rows,
                      CoolArgs a) {
    int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    int64_t i = t / LANES;
    if (i >= n_rows) return;
    Lane<T> L = make_lane<T>(a, (int)(t % LANES));
    int64_t p = row_of(rows, i);
    T l, e;
    solve_row<T, false, EXT>(a, L, row_in<T, EXT>(a, uv, met, tab, p),
                             density[p], ienergy[p], ne_init[p], T(0), l, e);
    if (L.lane == 0) {
        lam[p] = l;
        ne_new[p] = e;
    }
}

CoolArgs unpack(const double* d, const int* k) {
    CoolArgs a;
    memcpy(&a.gJH0, d, N_DOUBLES * sizeof(double));
    memcpy(&a.recomb, k, N_INTS * sizeof(int));
    return a;
}

bool valid_options(const CoolArgs& a, const float* met, const float* tab) {
    if ((met == nullptr) != (tab == nullptr)) return false;
    for (int k = 0; k < 3; ++k)
        if (met && a.met_dims[k] < 2) return false;
    return a.recomb >= CEN92 && a.recomb <= BADNELL06 && a.cooling >= KWH92
           && a.cooling <= SHERWOOD;
}

template <typename T, bool EXT>
int launch_do_cooling(const T* u_old, const T* rho, const T* dt,
                      const T* ne_guess, T* u_new, T* ne_new, const T* uv,
                      const float* met, const float* tab,
                      const int64_t* rows, int64_t n_rows, const double* d,
                      const int* k, cudaStream_t stream) {
    if (n_rows <= 0) return (int)cudaSuccess;
    CoolArgs a = unpack(d, k);
    if (!valid_options(a, met, tab)) return (int)cudaErrorInvalidValue;
    int64_t blocks = (n_rows * LANES + THREADS - 1) / THREADS;
    do_cooling_kernel<T, EXT><<<(unsigned)blocks, THREADS, 0, stream>>>(
        u_old, rho, dt, ne_guess, u_new, ne_new, uv, met, tab, rows, n_rows,
        a);
    return (int)cudaGetLastError();
}

template <typename T, bool EXT>
int launch_heatingcooling(const T* density, const T* ienergy,
                          const T* ne_init, T* lam, T* ne_new, const T* uv,
                          const float* met, const float* tab,
                          const int64_t* rows, int64_t n_rows,
                          const double* d, const int* k,
                          cudaStream_t stream) {
    if (n_rows <= 0) return (int)cudaSuccess;
    CoolArgs a = unpack(d, k);
    if (!valid_options(a, met, tab)) return (int)cudaErrorInvalidValue;
    int64_t blocks = (n_rows * LANES + THREADS - 1) / THREADS;
    heatingcooling_kernel<T, EXT><<<(unsigned)blocks, THREADS, 0, stream>>>(
        density, ienergy, ne_init, lam, ne_new, uv, met, tab, rows, n_rows,
        a);
    return (int)cudaGetLastError();
}

static_assert(offsetof(CoolArgs, recomb) == N_DOUBLES * sizeof(double)
                  && offsetof(CoolArgs, met_dims)
                         == N_DOUBLES * sizeof(double)
                                + (N_INTS - 3) * sizeof(int),
              "CoolArgs: the doubles, then the ints, packed");
static_assert(32 % LANES == 0 && LANES < 32 && THREADS % 32 == 0,
              "a row's lanes lie in one warp");

}  // namespace

// Plain C entry points, loaded with ctypes.  Device pointers to n-element
// arrays of one type (float or double); rows: int64 device array of the
// n_rows rows to compute, or null for rows 0..n_rows-1; other rows of the
// outputs are not written.  The optional inputs (null: off): uv, the six UV
// rates of each row ([n, 6], the rows' type; null: the scalars of d);
// met, the float metallicity of each row, and tab, the float metal cooling
// table on the device (dims in k; both or neither).  d (32 doubles) and k
// (7 ints): host arrays in the order of physics/cooling.py:kernel_args.
// LANES threads a row on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for an unknown rate option, or a metallicity
// without a table); does not synchronise.
//
// do_cooling: u_old, rho (internal units, physical), dt (internal time),
// ne_guess (ne/nh) -> u_new (internal), ne_new (ne/nh).
// heatingcooling_rate: density (protons/cm^3), ienergy (erg/g), ne_init
// (ne/nh) -> lam (erg/s/g), ne_new (ne/nh).
#define COOLING_ENTRIES(T, SUF)                                                \
    extern "C" int do_cooling_##SUF(                                           \
        const T* u_old, const T* rho, const T* dt, const T* ne_guess,          \
        T* u_new, T* ne_new, const T* uv, const float* met, const float* tab,  \
        const int64_t* rows, int64_t n_rows, const double* d, const int* k,    \
        cudaStream_t stream) {                                                 \
        return uv || met                                                       \
                   ? launch_do_cooling<T, true>(u_old, rho, dt, ne_guess,      \
                                                u_new, ne_new, uv, met, tab,   \
                                                rows, n_rows, d, k, stream)    \
                   : launch_do_cooling<T, false>(u_old, rho, dt, ne_guess,     \
                                                 u_new, ne_new, uv, met, tab,  \
                                                 rows, n_rows, d, k, stream);  \
    }                                                                          \
    extern "C" int heatingcooling_rate_##SUF(                                  \
        const T* density, const T* ienergy, const T* ne_init, T* lam,          \
        T* ne_new, const T* uv, const float* met, const float* tab,            \
        const int64_t* rows, int64_t n_rows, const double* d, const int* k,    \
        cudaStream_t stream) {                                                 \
        return uv || met                                                       \
                   ? launch_heatingcooling<T, true>(density, ienergy, ne_init, \
                                                    lam, ne_new, uv, met, tab, \
                                                    rows, n_rows, d, k,        \
                                                    stream)                    \
                   : launch_heatingcooling<T, false>(                          \
                         density, ienergy, ne_init, lam, ne_new, uv, met, tab, \
                         rows, n_rows, d, k, stream);                          \
    }

COOLING_ENTRIES(float, f32)
COOLING_ENTRIES(double, f64)
