// Block tree walk with fused monopoles (short-range gravity) for Hopper.
//
// Replaces the TPU walk mpgadget_tpu/gravity/treewalk.py:traverse_fused,
// a vmap of lax.while_loop (body :145-194), and the port's plain batched
// loop gravity/treewalk.py:traverse_fused_reference.  For each target
// block of G particles it visits the nodes the stackless preorder walk
// over the skip-pointer tree visits (descend = i + 1, reject / accept =
// skip[i]) and
//
//  - discards a node whose nearest distance from the block's bounding box
//    is beyond rcut;
//  - opens it by the relative criterion (m l^2 > r^4 aold, with the BH
//    angle as a cap) or by BH, or when the box is inside it or touches it;
//  - otherwise applies its monopole to all G targets (and the potential,
//    a template branch as in the pair kernel);
//  - records opened leaves, the LL of smallest node index in ascending
//    order; more than LL set the overflow flag.
//
// Bound: bytes on a tree that yields no monopoles, FP32 operations where
// monopoles do the work; in between stands the walk's critical path, the
// chain of loads of which each needs the one before.  A serial walk makes
// that chain as long as the block's visits (csrc/treewalk_serial.cu, the
// first port of this walk, kept as chip_smoke.py's yardstick).  The
// function needs no such chain: what happens in one subtree does not
// depend on another, so only the tree's depth times the siblings of a
// node (each found through the skip pointer of the one before) is
// dependent.  Design, one CTA of NT threads per block:
//
//  - Phase A, decide in parallel.  A stack in shared memory holds, in
//    ascending node order from its top, ranges [a, b) of preorder indices
//    still to walk (a node's later siblings, or a node's children) and
//    markers of decisions made (opened leaf, accepted monopole).  Each
//    round the threads take the top WIN entries, one each.  A thread that
//    holds a range visits up to SIBS of its siblings, each found through
//    the skip pointer of the one before, and decides on each as the
//    serial walk does; the range becomes, in order, each sibling's marker
//    if it has one or its children's range [node + 1, skip) if it is
//    opened, and the range of the siblings not yet visited.  One block
//    scan places the new entries, so the stack stays sorted with no sort.
//    Markers that no range precedes are final: nothing smaller can
//    follow.  They leave the stack in order, leaves to the block's leaf
//    list, monopoles to phase B.  Every node the serial walk visits is
//    taken once.  A round descends one level, so a block needs about as
//    many rounds as the tree is deep, each up to SIBS dependent loads
//    long, and the markers of siblings are final at once: few wait on
//    the stack to be moved again by the next round.
//  - Phase B, monopoles by the whole CTA.  The final monopoles' node
//    indices wait in shared memory; when MSTAGE wait (and at the end)
//    their (com, mass) rows are copied to shared memory by cp.async, NT
//    at a time, and every thread sums them over its own targets:
//    broadcast reads, no dependent global load in the loop.  They are
//    applied in ascending node index, the serial walk's order, by the
//    same operations: acc and pot have the serial kernel's bits (held so
//    by chip_smoke.py), and the same bits on every run.  No atomics on
//    floats.
//  - Bounded by construction.  An entry yields at most 2 SIBS + 1.  A
//    round first takes min(WIN, entries); if the scan shows that the new
//    entries would not fit, nothing has been written yet and the round is
//    taken again with at most (capacity - entries) / (2 SIBS) entries,
//    which always fit.  When that is 0 the CTA walks the top range
//    serially and stacklessly, emitting directly (nothing on the stack is
//    smaller), so any tree and any block finish, however wide, with
//    nothing dropped.  In chip_smoke.py's cases no block leaves the
//    rounds.
//
// The decisions must equal the plain version's bit for bit (the leaf
// lists feed the pair kernel and the overflow retries), so this file is
// compiled with -fmad=false and the criterion spells out the plain
// version's association with __fmul_rn / __fadd_rn.
//
// A tree that overflowed its capacity points past its rows: an index at
// or beyond C reads row C - 1, and a skip pointer that does not lie in
// (a, b] counts as b, so ranges only shrink and every walk ends.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shortrange.cuh"

#define NT 256                  // threads per CTA
#define MIN_BLOCKS 4            // CTAs per SM the registers must allow (64)
#define WIN NT                  // stack entries per round, one per thread
#define SIBS 8                  // siblings a thread visits in one round
#define GROW (2 * SIBS)         // entries one entry can add, at most
#define QCAP 3072               // stack entries (24 KB)
#define MSTAGE 256              // staged monopoles that start phase B
#define MCAP (MSTAGE + SIBS * WIN)  // staged node indices (9 KB)
#define MAX_TPT (1024 / NT)     // targets per thread: G <= NT * MAX_TPT

// a visited node's fate (two bits); on the stack a marker is (node, -fate)
#define DISCARD 0
#define MONOPOLE 1
#define LEAF 2
#define DESCEND 3

// packed counts of a thread's new entries: all << 40 | leaf markers << 20
// | monopole markers
typedef unsigned long long u64;
#define PACK(all, leaves, monos) \
    (((u64)(all) << 40) | ((u64)(leaves) << 20) | (u64)(monos))
#define FIELD 0xFFFFFull
#define NO_RANGE (~0ull)

struct BlockBox {
    float cx, cy, cz, hx, hy, hz, ao;
    bool bh_only;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// The walk's decision on one node, from its (center, length) row, its
// mass and its meta word, for a block's box: the plain version's
// operations in its association.
__device__ __forceinline__ int decide(const float4 geo, const float mass,
                                      const int mt, const BlockBox& q,
                                      const float rcut2,
                                      const float bh_angle2) {
    const float ln = geo.w;
    const float dcx = fabsf(min_image(__fsub_rn(geo.x, q.cx)));
    const float dcy = fabsf(min_image(__fsub_rn(geo.y, q.cy)));
    const float dcz = fabsf(min_image(__fsub_rn(geo.z, q.cz)));
    const float hl = __fmul_rn(0.5f, ln);
    const float dmx = fmaxf(__fsub_rn(__fsub_rn(dcx, q.hx), hl), 0.f);
    const float dmy = fmaxf(__fsub_rn(__fsub_rn(dcy, q.hy), hl), 0.f);
    const float dmz = fmaxf(__fsub_rn(__fsub_rn(dcz, q.hz), hl), 0.f);
    const float r2min = __fadd_rn(
        __fadd_rn(__fmul_rn(dmx, dmx), __fmul_rn(dmy, dmy)),
        __fmul_rn(dmz, dmz));
    if (r2min > rcut2) return DISCARD;
    bool open = __fmul_rn(ln, ln) > __fmul_rn(bh_angle2, r2min);
    if (!q.bh_only) {
        open = open || (__fmul_rn(__fmul_rn(mass, ln), ln)
                        > __fmul_rn(__fmul_rn(r2min, r2min), q.ao));
    }
    const float l6 = __fmul_rn(0.6f, ln);
    open = open || r2min <= 0.f
           || (dcx < __fadd_rn(q.hx, l6) && dcy < __fadd_rn(q.hy, l6)
               && dcz < __fadd_rn(q.hz, l6));
    if (!open) return MONOPOLE;
    return mt < 0 ? LEAF : DESCEND;
}

// One visit: the fate of `node`, a node of the range that ends at `end`,
// and in `next` the node after its subtree (its skip pointer, held to
// (node, end]).  An index at or beyond C reads row C - 1.
__device__ __forceinline__ int visit(const float4* __restrict__ nodes,
                                     const int* __restrict__ meta,
                                     const int node, const int end,
                                     const int C, const BlockBox& q,
                                     const float rcut2,
                                     const float bh_angle2, int& next) {
    const int ic = min(node, C - 1);
    const float4 geo = __ldg(nodes + 2 * (int64_t)ic);
    const int mt = __ldg(meta + ic);
    const float mass =
        q.bh_only ? 0.f
                  : __ldg(reinterpret_cast<const float*>(nodes)
                          + 8 * (int64_t)ic + 7);
    const int s = mt & 0x7FFFFFFF;
    next = (s <= node || s > end) ? end : s;
    return decide(geo, mass, mt, q, rcut2, bh_angle2);
}

// A thread's entry of this round and what it found: a marker (a, -fate),
// or the range [a, b) with the fates of the nsib siblings it visited and
// next[k], the node after sibling k; a = b = 0 without an entry.
struct Taken {
    int a, b, nsib;
    unsigned fates;
    int next[SIBS];
};

// What the entry becomes, in ascending node order: f(entry) for a marker
// kept, each new marker, each opened sibling's children and the siblings
// not visited yet.
template <typename F>
__device__ __forceinline__ void new_entries(const Taken& t, F&& f) {
    if (t.b < 0) {
        f(make_int2(t.a, t.b));
        return;
    }
    int node = t.a;
#pragma unroll
    for (int k = 0; k < SIBS; ++k) {
        if (k < t.nsib) {
            const int fate = (int)((t.fates >> (2 * k)) & 3u);
            if (fate == MONOPOLE || fate == LEAF) f(make_int2(node, -fate));
            if (fate == DESCEND && node + 1 < t.next[k])
                f(make_int2(node + 1, t.next[k]));
            node = t.next[k];
        }
    }
    if (node < t.b) f(make_int2(node, t.b));
}

template <bool WITH_POT, int TPT>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) tree_walk_kernel(
    const float4* __restrict__ nodes, const int* __restrict__ meta,
    const int64_t* __restrict__ n_nodes_p, const float* __restrict__ tpos,
    const float* __restrict__ center, const float* __restrict__ half,
    const float* __restrict__ aold, const uint8_t* __restrict__ active,
    float* __restrict__ acc, float* __restrict__ pot,
    int64_t* __restrict__ leaf_idx, int64_t* __restrict__ n_leaves,
    uint8_t* __restrict__ overflow, int* __restrict__ visits,
    int* __restrict__ monopoles, int* __restrict__ rounds_out,
    int* __restrict__ loads_out, int* __restrict__ serial_out, int G, int C,
    int LL, int qcap, float rcut, float rcut2, float bh_angle2, int use_bh,
    float rs_inv, float h_inv) {
    __shared__ int2 s_stack[QCAP];
    __shared__ int s_idx[MCAP];         // staged monopoles' nodes
    __shared__ float4 s_mom[NT];        // their (com, mass) rows, NT at a time
    __shared__ u64 s_warp[NT / 32];
    __shared__ u64 s_first;
    __shared__ int s_deepest;           // a round's longest sibling chain
    __shared__ int s_visits;

    const int b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int64_t n_nodes64 = *n_nodes_p;
    const int n_nodes = n_nodes64 > 0x7FFFFFFF ? 0x7FFFFFFF : (int)n_nodes64;
    const float h3_inv = h_inv * h_inv * h_inv;

    // target g = tid + t * NT, t < TPT
    float x[TPT], y[TPT], z[TPT], ax[TPT], ay[TPT], az[TPT], ph[TPT];
#pragma unroll
    for (int t = 0; t < TPT; ++t) {
        const int g = tid + t * NT;
        x[t] = y[t] = z[t] = 0.f;
        ax[t] = ay[t] = az[t] = ph[t] = 0.f;
        if (g < G) {
            const int64_t r = ((int64_t)b * G + g) * 3;
            x[t] = tpos[r];
            y[t] = tpos[r + 1];
            z[t] = tpos[r + 2];
        }
    }
    BlockBox q;
    q.cx = center[3 * b];
    q.cy = center[3 * b + 1];
    q.cz = center[3 * b + 2];
    q.hx = half[3 * b];
    q.hy = half[3 * b + 1];
    q.hz = half[3 * b + 2];
    q.ao = aold[b];
    q.bh_only = use_bh || q.ao <= 0.f;
    int64_t* leaves = leaf_idx + (int64_t)b * LL;

    // the same in every thread: entries on the stack, opened leaves and
    // accepted monopoles emitted so far, monopoles staged, rounds, the
    // dependent loads on the block's critical path, nodes visited serially
    int len = 0, nl = 0, nmono = 0, nm = 0, rounds = 0, loads = 0;
    int nserial = 0;
    bool safe = false;                  // take only what is sure to fit
    int nvis = 0;                       // this thread's visits
    if (active[b] && n_nodes > 0) {
        if (tid == 0) s_stack[0] = make_int2(0, n_nodes);
        len = 1;
    }
    if (tid == 0) {
        s_first = NO_RANGE;
        s_deepest = 0;
        s_visits = 0;
    }
    __syncthreads();

    // phase B: every thread sums the n staged monopoles over its targets
    auto apply_staged = [&](const int n) {
        __syncthreads();                // s_idx is written
        for (int c0 = 0; c0 < n; c0 += NT) {
            const int m = min(NT, n - c0);
            if (tid < m) {
                const int ic = min(s_idx[c0 + tid], C - 1);
                cp_async16(&s_mom[tid], nodes + 2 * (int64_t)ic + 1);
            }
            cp_async_commit();
            cp_async_wait_all();
            __syncthreads();
            for (int j = 0; j < m; ++j) {
                const float4 mom = s_mom[j];
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
            }
            __syncthreads();
        }
    };
    // one final marker, emitted by the CTA as a whole (uniform call)
    auto emit = [&](const int node, const int fate) {
        if (fate == LEAF) {
            if (nl < LL && tid == 0) leaves[nl] = node;
            ++nl;
        } else {
            if (tid == 0) s_idx[nm] = node;
            ++nmono;
            if (++nm >= MSTAGE) {
                apply_staged(nm);
                nm = 0;
            }
        }
    };

    while (len > 0) {
        ++rounds;
        int w = min(WIN, len);
        if (safe) w = min(w, (qcap - len) / GROW);
        if (w <= 0) {
            // no room for what a round may add: the top entry alone, its
            // range walked serially by every thread alike
            safe = false;
            const int2 top = s_stack[--len];
            if (top.y < 0) {
                emit(top.x, -top.y);
                continue;
            }
            int i = top.x;
            while (i < top.y) {
                int s;
                const int fate = visit(nodes, meta, i, top.y, C, q, rcut2,
                                       bh_angle2, s);
                if (tid == 0) ++nvis;
                ++nserial;
                ++loads;
                if (fate == DESCEND) {
                    ++i;
                } else {
                    if (fate != DISCARD) emit(i, fate);
                    i = s;
                }
            }
            continue;
        }

        // my entry, the tid-th from the top; a range's siblings one after
        // the other, each found through the one before
        Taken t;
        t.a = t.b = t.nsib = 0;
        t.fates = 0u;
#pragma unroll
        for (int k = 0; k < SIBS; ++k) t.next[k] = 0;
        if (tid < w) {
            const int2 ent = s_stack[len - 1 - tid];
            t.a = ent.x;
            t.b = ent.y;
            int node = ent.x;
#pragma unroll
            for (int k = 0; k < SIBS; ++k) {
                if (node < ent.y) {     // never true for a marker
                    const int fate = visit(nodes, meta, node, ent.y, C, q,
                                           rcut2, bh_angle2, t.next[k]);
                    t.fates |= (unsigned)fate << (2 * k);
                    t.nsib = k + 1;
                    node = t.next[k];
                }
            }
        }
        const int deepest = (int)__reduce_max_sync(0xFFFFFFFFu,
                                                   (unsigned)t.nsib);

        // count my new entries, and what precedes my first range
        u64 cnt = 0, first = NO_RANGE;
        new_entries(t, [&](const int2 it) {
            if (it.y >= 0) {
                if (first == NO_RANGE) first = cnt;
            } else {
                cnt += it.y == -LEAF ? PACK(0, 1, 0) : PACK(0, 0, 1);
            }
            cnt += PACK(1, 0, 0);
        });
        // exclusive block scan of the packed counts
        u64 inc = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const u64 v = __shfl_up_sync(0xFFFFFFFFu, inc, d);
            if (lane >= d) inc += v;
        }
        if (lane == 31) s_warp[warp] = inc;
        __syncthreads();
        u64 base = inc - cnt, total = 0;
#pragma unroll
        for (int i = 0; i < NT / 32; ++i) {
            const u64 v = s_warp[i];
            if (i < warp) base += v;
            total += v;
        }
        if (first != NO_RANGE) atomicMin(&s_first, base + first);
        if (lane == 0 && deepest > 0) atomicMax(&s_deepest, deepest);
        __syncthreads();
        // the first range of the new sequence: all before it is final
        u64 fk = s_first;
        if (fk == NO_RANGE) fk = total;
        const int nfinal = (int)(fk >> 40);
        const int final_leaves = (int)((fk >> 20) & FIELD);
        const int final_monos = (int)(fk & FIELD);
        const int newlen = len - w + (int)(total >> 40) - nfinal;
        loads += s_deepest;
        const bool fits = newlen <= qcap;   // always, when safe

        if (fits) {
            int o = (int)(base >> 40);
            int lr = (int)((base >> 20) & FIELD), mr = (int)(base & FIELD);
            new_entries(t, [&](const int2 it) {
                if (o >= nfinal) {
                    s_stack[newlen - 1 - (o - nfinal)] = it;
                } else if (it.y == -LEAF) {
                    if (nl + lr < LL) leaves[nl + lr] = it.x;
                } else {
                    s_idx[nm + mr] = it.x;
                }
                if (it.y == -LEAF) ++lr;
                if (it.y == -MONOPOLE) ++mr;
                ++o;
            });
            nvis += t.nsib;
        }
        __syncthreads();
        if (tid == 0) {
            s_first = NO_RANGE;
            s_deepest = 0;
        }
        safe = !fits;                   // nothing written: take fewer
        if (fits) {
            len = newlen;
            nl += final_leaves;
            nmono += final_monos;
            nm += final_monos;
            if (nm >= MSTAGE) {
                apply_staged(nm);
                nm = 0;
            }
        }
    }
    if (nm > 0) apply_staged(nm);

    const int kept = min(nl, LL);
    for (int s = kept + tid; s < LL; s += NT) leaves[s] = C;
#pragma unroll
    for (int t = 0; t < TPT; ++t) {
        const int g = tid + t * NT;
        if (g < G) {
            const int64_t arow = (int64_t)b * 3 * G + g;
            acc[arow] = ax[t];
            acc[arow + G] = ay[t];
            acc[arow + 2 * G] = az[t];
            pot[(int64_t)b * G + g] = ph[t];
        }
    }
    if (nvis) atomicAdd(&s_visits, nvis);
    __syncthreads();
    if (tid == 0) {
        n_leaves[b] = kept;
        overflow[b] = nl > LL;
        visits[b] = s_visits;
        monopoles[b] = nmono;
        rounds_out[b] = rounds;
        loads_out[b] = loads;
        serial_out[b] = nserial;
    }
}

template <bool WITH_POT, int TPT>
static int launch(const float* nodes, const int* meta, const int64_t* n_nodes,
                  const float* tpos, const float* center, const float* half,
                  const float* aold, const uint8_t* active, float* acc,
                  float* pot, int64_t* leaf_idx, int64_t* n_leaves,
                  uint8_t* overflow, int* visits, int* monopoles, int* rounds,
                  int* loads, int* serial, int nb, int G, int C, int LL,
                  int qcap, float rcut, float rcut2, float bh_angle2,
                  int use_bh, float rs_inv, float h_inv, cudaStream_t st) {
    tree_walk_kernel<WITH_POT, TPT><<<nb, NT, 0, st>>>(
        reinterpret_cast<const float4*>(nodes), meta, n_nodes, tpos, center,
        half, aold, active, acc, pot, leaf_idx, n_leaves, overflow, visits,
        monopoles, rounds, loads, serial, G, C, LL, qcap, rcut, rcut2,
        bh_angle2, use_bh, rs_inv, h_inv);
    return (int)cudaGetLastError();
}

// Plain C entry point, loaded with ctypes.  Device pointers: nodes f32
// (C, 8), meta int32 (C), n_nodes int64 scalar, tpos f32 (nb, G, 3),
// center/half f32 (nb, 3), aold f32 (nb), active bool (nb); outputs acc
// f32 (nb, 3, G), pot f32 (nb, G), leaf_idx int64 (nb, LL), n_leaves int64
// (nb), overflow bool (nb), visits/monopoles/rounds/loads/serial int32
// (nb): rounds counts a block's rounds (those taken again and the
// entries taken serially included), loads the dependent loads on its
// critical path (each round's longest sibling chain, and every node
// visited serially), serial the nodes it visited serially.  qcap: stack
// entries to use, at most QCAP (less only to test the serial mode).
// Launches on `stream` and returns cudaGetLastError() (0 on success,
// cudaErrorInvalidValue for a G or qcap it does not take); does not
// synchronise.
extern "C" int tree_walk_f32(
    const float* nodes, const int* meta, const int64_t* n_nodes,
    const float* tpos, const float* center, const float* half,
    const float* aold, const uint8_t* active, float* acc, float* pot,
    int64_t* leaf_idx, int64_t* n_leaves, uint8_t* overflow, int* visits,
    int* monopoles, int* rounds, int* loads, int* serial, int nb, int G,
    int C, int LL, int qcap, float rcut, float rcut2, float bh_angle2,
    int use_bh, float rs_inv, float h_inv, int with_potential,
    void* stream) {
    if (nb <= 0) return (int)cudaSuccess;
    if (G < 1 || G > NT * MAX_TPT || qcap < 1 || qcap > QCAP || C < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define WALK_ARGS nodes, meta, n_nodes, tpos, center, half, aold, active,   \
        acc, pot, leaf_idx, n_leaves, overflow, visits, monopoles, rounds,  \
        loads, serial, nb, G, C, LL, qcap, rcut, rcut2, bh_angle2, use_bh,  \
        rs_inv, h_inv, st
    // targets per thread: as few as hold G, to keep registers free
    if (with_potential) {
        if (G <= NT) return launch<true, 1>(WALK_ARGS);
        if (G <= 2 * NT) return launch<true, 2>(WALK_ARGS);
        return launch<true, MAX_TPT>(WALK_ARGS);
    }
    if (G <= NT) return launch<false, 1>(WALK_ARGS);
    if (G <= 2 * NT) return launch<false, 2>(WALK_ARGS);
    return launch<false, MAX_TPT>(WALK_ARGS);
#undef WALK_ARGS
}
