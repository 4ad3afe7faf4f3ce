// Neighbour walk (kernel K3) for Hopper: the source leaves near each
// target group.
//
// Replaces mpgadget_tpu/ops/pairs.py:find_neighbors (:108-160), a vmap of
// lax.while_loop, and the port's plain batched loop
// ops/pairs.py:find_neighbors_reference.  For each target group (a tree
// node holding at most group_max particles, with its particles' bounding
// box) it visits the nodes the stackless preorder walk over the
// skip-pointer tree visits (descend = i + 1, skip = skip[i]):
//
//   dc    = |min_image(center_node - center_group)|       per axis
//   dmin  = max(dc - half_group - 0.5 length_node, 0)      per axis
//   r2min = (dmin_x^2 + dmin_y^2) + dmin_z^2
//   reach = max(radius, hmax[node]) if symmetric, else radius
//
// a node with r2min < reach^2 is near: a near leaf is recorded in DFS
// order (ascending node index), a near internal node is descended,
// anything else is skipped.  The count is incremented first and the flag
// set when it reaches LL (pairs.py:146-147), so a group with exactly LL
// leaves is flagged too: flags and retries are the JAX package's.  A
// padding group (node index >= n_nodes) records nothing.
//
// Bound: the node table is read once (16 + 4 bytes a node, + 4 for hmax)
// and the leaf lists written once, against ~30 FP32 operations a visit;
// bytes bound it, nearly all of them the (groups x LL) lists.  In between
// stands the walk's critical path, the chain of loads of which each needs
// the one before.  A serial walk makes that chain as long as the group's
// visits (csrc/neighbors_serial.cu, the first port of this walk, kept as
// chip_smoke.py's yardstick): 448 visits of one L2 round trip each on
// dm-small's final state.  The function needs no such chain: what happens
// in one subtree does not depend on another.  Design, K2's rounds over a
// sorted stack (csrc/treewalk.cu) sized for groups of ~80-500 visits:
//
//  - build_table writes, one thread a node, a 64-byte row: the node's
//    (center, length) and meta word in one 32-byte sector, and its child
//    list, the nodes its children's skip pointers lead to, with leaf
//    flags.  The walk launches after it, in the same call.
//  - A team of TEAM lanes walks a group; GPC groups share a CTA and no
//    barrier.  A private stack per group in shared memory holds, in
//    ascending node order from its top, ranges [a, b) of preorder indices
//    still to walk, each with the sibling list of its nodes where known,
//    and markers of near leaves (node, -1).  Each round the team takes
//    the top EPR entries, SIBS lanes each.  The lanes visit a range's
//    siblings at once, lane k the k-th of the list (without a list, lane
//    0 visits the first sibling alone).  A list follows the same skip
//    pointers as the walk, ascends, and ends before its node's own skip
//    pointer, which lies at or past the range's end; so its entries
//    inside the range are exactly the siblings the walk visits, and a
//    list saves loads and changes no result, whatever the tree.  A lane
//    that visits an internal node loads that node's child list with its
//    row, as the list of the children's range [node + 1, skip) it may
//    push.  The range becomes, in order, each near leaf's marker, each
//    near internal node's children's range, and the rest of the range
//    where its last sibling's skip pointer leads on inside it.  Ballots
//    place the new entries, so the stack stays sorted with no sort.
//  - Markers that no range precedes are final: nothing smaller can
//    follow.  They leave the stack in order and go straight to the
//    group's row, counted first and flagged at LL.  A round descends one
//    level for one dependent L2 round trip, so a group's critical path is
//    its rounds instead of its visits.  A team of TEAM lanes and not a
//    warp: a round finds few ranges on the stack.
//  - Bounded by construction.  An entry yields at most SIBS + 1.  A round
//    first takes min(EPR, entries); if the new entries would not fit,
//    nothing has been written yet and the round is taken again with at
//    most (capacity - entries) / SIBS entries, which always fit.  When
//    that is 0 the team walks the top range serially and stacklessly,
//    emitting directly (nothing on the stack is smaller), so any tree
//    finishes with nothing dropped.
//  - The team writes its whole row: the listed leaves as they become
//    final, then C in every unused slot; the wrapper allocates the lists
//    without filling them.
//
// The decisions must equal the plain version's bit for bit: compiled with
// -fmad=false, with its association spelled out (__fsub_rn and friends),
// and min_image rounds half to even as torch.round and jnp.round do.
//
// A tree that overflowed its capacity points past its rows: an index at
// or beyond C reads row C - 1, and a skip pointer that does not lie in
// (a, b] counts as b, so ranges only shrink and every walk ends.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shortrange.cuh"

#define TEAM 16                 // lanes per target group
#define NT 128                  // threads per CTA
#define GPC (NT / TEAM)         // groups per CTA
#define SIBS 8                  // siblings of a range visited in one round
#define EPR (TEAM / SIBS)       // entries a team takes in one round
#define QCAP 64                 // stack entries per group (2.5 KB)
#define FULL 0xFFFFFFFFu
#define INDEX 0x7FFFFFFF        // a node index; bit 31 flags a leaf
#define TB 256                  // threads per CTA of build_table

// a visited node's fate; on the stack a leaf marker is (node, -1)
#define FAR 0
#define LEAF 1
#define DESCEND 2

struct GroupBox {
    float cx, cy, cz, hx, hy, hz, rad, rad2;
};

// A node's row: its (center, length), meta word and, when symmetric,
// hmax.  An index at or beyond C reads row C - 1.
struct Row {
    float4 geo;
    int mt;
    float hm;
};

template <bool SYMMETRIC>
__device__ __forceinline__ Row load_row(const int4* __restrict__ table,
                                        const float* __restrict__ hmax,
                                        const int node, const int C) {
    const int ic = min(node, C - 1);
    const int4 geo = __ldg(table + 4 * (int64_t)ic);
    Row r;
    r.geo = make_float4(__int_as_float(geo.x), __int_as_float(geo.y),
                        __int_as_float(geo.z), __int_as_float(geo.w));
    r.mt = __ldg(reinterpret_cast<const int*>(table + 4 * (int64_t)ic + 1));
    r.hm = SYMMETRIC ? __ldg(hmax + ic) : 0.f;
    return r;
}

// The walk's table, one 64-byte row a node: (center, length), then the
// meta word, then the node's child list: the nodes that 0, 1, ..., SIBS
// - 1 skip pointers lead to from node + 1 while they ascend and lie
// before the node's own skip pointer `end` (an index at or past C reads
// row C - 1), each with bit 31 set where it is a leaf, and `end` in the
// slots left.  For an internal node of a well-formed tree these are its
// children in order.  One thread a node.
__global__ void __launch_bounds__(TB) build_table(
    const float4* __restrict__ nodes, const int* __restrict__ meta,
    int4* __restrict__ table, int C) {
    // the CTA's rows are assembled in shared memory and written out
    // together, whole 32-byte sectors from consecutive lanes
    __shared__ int4 s_rows[TB * 4];
    const int i0 = blockIdx.x * TB, i = i0 + threadIdx.x;
    if (i < C) {
        const float4 geo = __ldg(nodes + i);
        const int mi = __ldg(meta + i);
        const int end = mi & INDEX;
        int kid[SIBS];
        int prev = i, cur = i + 1;
#pragma unroll
        for (int k = 0; k < SIBS; ++k) {
            kid[k] = end;
            if (prev < cur && cur < end) {
                const int mt = __ldg(meta + min(cur, C - 1));
                kid[k] = cur | (mt & ~INDEX);
                prev = cur;
                cur = mt & INDEX;
            } else {
                prev = end;             // the list ends here
            }
        }
        int4* row = s_rows + 4 * threadIdx.x;
        row[0] = make_int4(__float_as_int(geo.x), __float_as_int(geo.y),
                           __float_as_int(geo.z), __float_as_int(geo.w));
        row[1] = make_int4(mi, 0, 0, 0);
        row[2] = make_int4(kid[0], kid[1], kid[2], kid[3]);
        row[3] = make_int4(kid[4], kid[5], kid[6], kid[7]);
    }
    __syncthreads();
    const int n = 4 * min(TB, C - i0);
    for (int j = threadIdx.x; j < n; j += TB)
        table[4 * (int64_t)i0 + j] = s_rows[j];
}

// The fate of `node` (its row r), a node of the range that ends at `end`,
// and in `next` the node after its subtree (its skip pointer, held to
// (node, end]): the plain version's operations in its association.
template <bool SYMMETRIC>
__device__ __forceinline__ int decide(const Row& r, const int node,
                                      const int end, const GroupBox& q,
                                      int& next) {
    const float dcx = fabsf(min_image(__fsub_rn(r.geo.x, q.cx)));
    const float dcy = fabsf(min_image(__fsub_rn(r.geo.y, q.cy)));
    const float dcz = fabsf(min_image(__fsub_rn(r.geo.z, q.cz)));
    const float hl = __fmul_rn(0.5f, r.geo.w);
    const float dmx = fmaxf(__fsub_rn(__fsub_rn(dcx, q.hx), hl), 0.f);
    const float dmy = fmaxf(__fsub_rn(__fsub_rn(dcy, q.hy), hl), 0.f);
    const float dmz = fmaxf(__fsub_rn(__fsub_rn(dcz, q.hz), hl), 0.f);
    const float r2min = __fadd_rn(
        __fadd_rn(__fmul_rn(dmx, dmx), __fmul_rn(dmy, dmy)),
        __fmul_rn(dmz, dmz));
    float reach2 = q.rad2;
    if (SYMMETRIC) {
        const float reach = fmaxf(q.rad, r.hm);
        reach2 = __fmul_rn(reach, reach);
    }
    const int s = r.mt & INDEX;
    next = (s <= node || s > end) ? end : s;
    if (!(r2min < reach2)) return FAR;
    return r.mt < 0 ? LEAF : DESCEND;
}

template <bool SYMMETRIC>
__global__ void __launch_bounds__(NT) neighbor_walk_kernel(
    const int4* __restrict__ table, const float* __restrict__ hmax,
    const int64_t* __restrict__ n_nodes_p,
    const int64_t* __restrict__ group_nodes, const float* __restrict__ center,
    const float* __restrict__ half, const float* __restrict__ radius,
    int* __restrict__ leaf_idx, int* __restrict__ n_leaves,
    uint8_t* __restrict__ overflow, int* __restrict__ visits,
    int* __restrict__ rounds_out, int* __restrict__ loads_out,
    int* __restrict__ serial_out, int ng, int C, int LL, int qcap) {
    __shared__ int2 s_stack[GPC][QCAP];
    __shared__ int4 s_sibs[GPC][QCAP][2];   // a range's siblings, if known
    // a team of TEAM lanes per group, a segment of SIBS lanes per entry
    const int wl = threadIdx.x & 31;        // lane in the warp
    const int lane = wl & (TEAM - 1), slot = threadIdx.x / TEAM;
    const int seg = lane / SIBS, k = lane & (SIBS - 1);
    const unsigned team_bits = ((1u << TEAM) - 1u) << (wl & ~(TEAM - 1));
    const unsigned below = (1u << wl) - 1u;
    int2* stack = s_stack[slot];
    int4(*sibs)[2] = s_sibs[slot];
    const int64_t n_nodes64 = *n_nodes_p;
    const int n_nodes = n_nodes64 > INDEX ? INDEX : (int)n_nodes64;
    const int g = blockIdx.x * GPC + slot;
    GroupBox q = {};
    int* out = leaf_idx;
    // the same in every lane of a team: entries on the stack, near leaves
    // emitted so far (past LL too), visits, rounds, the dependent loads on
    // the group's critical path, nodes visited serially
    int len = 0, nl = 0, nvis = 0, rounds = 0, loads = 0, nserial = 0;
    bool safe = false;                  // take only what is sure to fit
    if (g < ng) {
        q.cx = center[3 * g];
        q.cy = center[3 * g + 1];
        q.cz = center[3 * g + 2];
        q.hx = half[3 * g];
        q.hy = half[3 * g + 1];
        q.hz = half[3 * g + 2];
        q.rad = radius[g];
        q.rad2 = __fmul_rn(q.rad, q.rad);
        out = leaf_idx + (int64_t)g * LL;
        if (group_nodes[g] < n_nodes64 && n_nodes > 0) {
            if (lane == 0) {
                stack[0] = make_int2(0, n_nodes);
                sibs[0][0].x = -1;      // the root: no sibling list
            }
            len = 1;
        }
    }
    __syncwarp();

    // the warp's teams take their rounds together, until all are done
    while (__any_sync(FULL, len > 0)) {
        int w = 0;                      // entries my team takes
        if (len > 0) {
            ++rounds;
            w = min(EPR, len);
            if (safe) w = min(w, (qcap - len) / SIBS);
            if (w <= 0) {
                // no room for what a round may add: the top entry alone,
                // its range walked serially by every lane of the team
                safe = false;
                const int2 top = stack[--len];
                if (top.y < 0) {
                    if (lane == 0 && nl < LL) out[nl] = top.x;
                    ++nl;
                }
                for (int i = top.x; i < top.y;) {
                    int nxt;
                    const int fate = decide<SYMMETRIC>(
                        load_row<SYMMETRIC>(table, hmax, i, C), i, top.y, q,
                        nxt);
                    ++nvis;
                    ++nserial;
                    ++loads;
                    if (fate == DESCEND) {
                        ++i;
                    } else {
                        if (fate == LEAF) {
                            if (lane == 0 && nl < LL) out[nl] = i;
                            ++nl;
                        }
                        i = nxt;
                    }
                }
                w = 0;
            }
        }

        // my segment's entry, the seg-th from the top.  A marker stays a
        // marker (lane 0).  A range [a, b) is visited by the segment at
        // once: lane k takes its k-th sibling from the range's sibling
        // list (the node k skip pointers lead to from a, with its leaf
        // flag; lane 0 alone takes a where the range has none).  A list
        // ascends and ends before its node's own skip pointer, which is at
        // or past b, so its entries inside the range are exactly the
        // siblings the walk's skip pointers lead to (a pointer outside
        // (node, b] ends the range).  The last sibling whose pointer leads
        // on inside the range leaves the rest of it.  A lane that visits
        // an internal node loads that node's child list with its row, as
        // the sibling list of the children's range it may push.  own /
        // rest: my new entries
        const int pos = len - 1 - seg;
        int2 ent = make_int2(0, 0);
        int sib = -1;
        if (seg < w) {
            ent = stack[pos];
            if (ent.y >= 0) sib = reinterpret_cast<const int*>(sibs[pos])[k];
        }
        const bool is_range = seg < w && ent.y >= 0;
        const bool listed =
            (__shfl_sync(FULL, sib, wl & ~(SIBS - 1)) & INDEX) == ent.x;
        const int node = listed ? (sib & INDEX) : (k == 0 ? ent.x : INDEX);
        const bool valid = is_range && node < ent.y;
        int s = 0, fate = FAR, nxt = 0;
        bool link = false;
        int4 kid0 = make_int4(-1, 0, 0, 0), kid1 = make_int4(0, 0, 0, 0);
        if (valid) {
            const Row r = load_row<SYMMETRIC>(table, hmax, node, C);
            if (!listed || sib >= 0) {  // internal, or not known
                const int ic = min(node, C - 1);
                kid0 = __ldg(table + 4 * (int64_t)ic + 2);
                kid1 = __ldg(table + 4 * (int64_t)ic + 3);
            }
            s = r.mt & INDEX;
            fate = decide<SYMMETRIC>(r, node, ent.y, q, nxt);
            link = s > node && s < ent.y;
        }
        const unsigned kept = __ballot_sync(FULL, valid);
        int2 own = make_int2(0, 0), rest = make_int2(0, 0);
        bool has_own = false, has_rest = false;
        if (seg < w && ent.y < 0 && k == 0) {
            own = ent;
            has_own = true;
        }
        if (valid) {
            if (fate == LEAF) {
                own = make_int2(node, -1);
                has_own = true;
            } else if (fate == DESCEND && node + 1 < nxt) {
                own = make_int2(node + 1, nxt);
                has_own = true;
            }
            // the last sibling visited, whose pointer leads on
            if (link && (k == SIBS - 1 || (kept >> (wl + 1) & 1u) == 0)) {
                rest = make_int2(s, ent.y);
                has_rest = true;
            }
        }
        const int seen = __popc(kept & team_bits);  // my team's visits

        // place the team's new entries in lane order (own, then rest)
        const unsigned own_m = __ballot_sync(FULL, has_own) & team_bits;
        const unsigned rest_m = __ballot_sync(FULL, has_rest) & team_bits;
        const int base = __popc(own_m & below) + __popc(rest_m & below);
        const int total = __popc(own_m) + __popc(rest_m);
        // the first range of the new sequence: all before it is final
        const bool own_range = has_own && own.y >= 0;
        const unsigned range_m =
            __ballot_sync(FULL, own_range || has_rest) & team_bits;
        const int f = __ffs(range_m) - 1;     // -1: no range
        const int fpos = __shfl_sync(
            FULL, base + (own_range ? 0 : (int)has_own), f < 0 ? wl : f);
        const int nfinal = f < 0 ? total : fpos;
        const int newlen = len - w + total - nfinal;
        const bool fits = newlen <= qcap;   // always, when safe

        __syncwarp();                   // every lane has read its entry
        if (fits) {
            int o = base;
            if (has_own) {
                if (o >= nfinal) {
                    const int p = newlen - 1 - (o - nfinal);
                    stack[p] = own;
                    if (own_range) {
                        sibs[p][0] = kid0;
                        sibs[p][1] = kid1;
                    }
                } else if (nl + o < LL) {
                    out[nl + o] = own.x;
                }
                ++o;
            }
            if (has_rest) {
                const int p = newlen - 1 - (o - nfinal);
                stack[p] = rest;
                sibs[p][0].x = -1;      // the rest of a range: no list
            }
            len = newlen;
            nl += nfinal;
            nvis += seen;
        }
        loads += seen > 0;
        if (w > 0) safe = !fits;        // nothing written: take fewer
        __syncwarp();                   // the stack is written
    }

    if (g < ng) {
        const int kept = min(nl, LL);
        for (int i = kept + lane; i < LL; i += TEAM) out[i] = C;
        if (lane == 0) {
            n_leaves[g] = kept;
            overflow[g] = nl >= LL;
            visits[g] = nvis;
            rounds_out[g] = rounds;
            loads_out[g] = loads;
            serial_out[g] = nserial;
        }
    }
}

// Plain C entry point, loaded with ctypes.  Device pointers: nodes f32
// (C, 4) = center, length; hmax f32 (C) (read only when symmetric); meta
// int32 (C), skip pointer | leaf bit; table int32 (C, 16), scratch for
// build_table; n_nodes int64 scalar; group_nodes int64 (ng); center/half
// f32 (ng, 3); radius f32 (ng); outputs leaf_idx int32 (ng, LL), every
// slot written; n_leaves int32 (ng); overflow bool (ng);
// visits/rounds/loads/serial int32 (ng): rounds counts a group's rounds
// (those taken again and the entries taken serially included), loads the
// dependent loads on its critical path (one a round that visits, one a
// node visited serially), serial the nodes it visited serially.  qcap:
// stack entries to use, at most QCAP (less only to test the serial mode).
// Launches build_table and the walk on `stream` and returns
// cudaGetLastError() (0 on success, cudaErrorInvalidValue for a C, LL or
// qcap it does not take); does not synchronise.
extern "C" int find_neighbors_f32(
    const void* nodes, const float* hmax, const int* meta, void* table,
    const int64_t* n_nodes, const int64_t* group_nodes, const float* center,
    const float* half, const float* radius, int* leaf_idx, int* n_leaves,
    uint8_t* overflow, int* visits, int* rounds, int* loads, int* serial,
    int ng, int C, int LL, int qcap, int symmetric, cudaStream_t stream) {
    if (ng <= 0) return (int)cudaSuccess;
    if (C <= 0 || LL <= 0 || qcap < 1 || qcap > QCAP)
        return (int)cudaErrorInvalidValue;
    build_table<<<(C + TB - 1) / TB, TB, 0, stream>>>(
        (const float4*)nodes, meta, (int4*)table, C);
    const dim3 grid((ng + GPC - 1) / GPC);
    if (symmetric)
        neighbor_walk_kernel<true><<<grid, NT, 0, stream>>>(
            (const int4*)table, hmax, n_nodes, group_nodes, center, half,
            radius, leaf_idx, n_leaves, overflow, visits, rounds, loads,
            serial, ng, C, LL, qcap);
    else
        neighbor_walk_kernel<false><<<grid, NT, 0, stream>>>(
            (const int4*)table, hmax, n_nodes, group_nodes, center, half,
            radius, leaf_idx, n_leaves, overflow, visits, rounds, loads,
            serial, ng, C, LL, qcap);
    return (int)cudaGetLastError();
}
