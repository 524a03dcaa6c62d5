// Forward table (logsumexp) of the general semi-Markov model over the split
// tables (K5), for Hopper (sm_90a): the logsumexp twin of K2
// (csrc/scan.cu).
//
// Replaces augustus_tpu/engine/scan.py:make_forward_fn (the lax.scan
// forward pass driven by ForwardEngine, scan.py:937) with its hint quotient
// _hint_quot where the 64-lane forward kernel csrc/forward.cu cannot take a
// piece: the 71-state UTR architecture (S and lanes above 64, begin-bounded
// UTR variants).  It is make_scan_fn's recursion with every maximum replaced
// by a logsumexp and no backpointers.  The plain PyTorch version with the
// same operations is augustus_tpu_torch/engine/scan.py:scan_table_reference.
//
// A logsumexp over candidates x is the reference's lse_vec: m = max(x);
// s = the sum of expf(x - m) over the x > GATE; m + logf(s) when m > GATE,
// else NEG.  Candidates at or below GATE add nothing, so a band clipped to
// [smin, smax] (and vb_lo / vb_hi) gives the same value: every clipped
// entry is NEG in the reference, and when no entry passes GATE the value is
// NEG either way.
//
// What bounds it on the card: as K2, position j depends on position j - 1
// and on the lane history, so the positions run in order in ONE thread
// block; bytes and operations are far below the card's rates
// (engine/scan.py:scan_table_work), and a position takes the latency of its
// longest chain of dependent steps between its three barriers.  K2 and K5
// walk the same band entries with the same loads; what K5 adds is
// arithmetic whose latency is long: a full-precision expf or logf is a
// chain of several dependent instructions.  The earlier design
// (-DK5_SIMPLE) put those on serial chains, and its clock64 split
// (chip_smoke.py's k5_compare) shows where: on one H100, of about 20,700
// cycles a position on the 6 kb UTR piece, phase A took 14,900, of which
// the merges of the parked pairs (32 dependent merges of two expf each per
// chunk) about 4,400 a warp, as much as the runs; phase C took 3,200,
// each thread pushing 20 candidates one by one, though a lane or a chain
// state has at most a few live predecessors.
//
// This design keeps K2's layout (csrc/k2_common.cuh; one CTA of 16 warps,
// three barriers per position) and takes every logsumexp as an exact
// maximum (compares, fmaxf) and then a sum of terms that wait on nothing
// but that maximum:
// - Phase A: the clipped entries of every gated convolution variant and
//   every lessD window of position j form one list of segments, cut into
//   16 near-equal contiguous shares, one per warp.  Lane l of a warp walks
//   entries l, l + 32, ... of its share as runs of one segment, BATCH loads
//   at a time, and keeps a running pair (m, s) over its run: per batch the
//   batch's maximum first, s rescaled at most once, then the batch's expf
//   terms added in a fixed pairwise tree (lse_batch).  The pair is parked
//   in a scratch row of the segment (rows of SROW = 33 words: no bank
//   conflicts either way); then group g of 4 lanes merges the 32 parked
//   pairs of the chunk's g-th segment, all 8 segments at once: each lane 8
//   pairs, the maximum over the 32 by a tree of fmaxf and two xor shuffles,
//   one expf per pair, a tree of adds and two xor shuffles (merge_parked).
//   A segment inside one share is final; a cut one leaves a pair at each
//   warp that holds a piece of it (FIRST / LAST slots as in K2).  Warp 11
//   copies the lane history of the fixed and pinned states with cp.async.
// - Phase B: groups of 8 lanes per convolution or lessD state (warps 0-10).
//   A cut segment's pieces: their maximum, then their terms added in
//   ascending share order (seg_value); each variant its value M + logf(S)
//   and the H gate, a lessD state's segment meanwhile; then the state's
//   variants on the group's 8 lanes: the group maximum by three xor
//   shuffles, one expf per variant, the lane's terms in variant order and
//   three xor shuffles of adds, in place of one lane's chain of lse2.  Warp
//   11: the previous position's row (K5_SIMPLE: warp 15 in phase A, where
//   it often arrives last), the fixed states (kind 2 a two-term lse2) and
//   the pinned states; warps 12-15: the segments of position j + 1.
// - Phase C: groups of 4 lanes reduce over the S states: each lane of
//   position j and each chain state of position j + 1; each thread a
//   quarter of the states: the maximum and a bit per live candidate, the
//   group's maximum, one expf per live candidate in state order, the
//   group's sum.
// - An empty pair is (-inf, 0); a term of a pair whose m is -inf is 0, and
//   no -inf - -inf is taken.
// - Every sum runs in an order that the data fixes (the share cut, the
//   batches and their trees, the groups' trees and xor shuffles, whose
//   pairwise adds give the same bits on every lane of the group, ascending
//   shares, the variants' lanes, the live candidates' states), so two
//   launches on the same piece give the same bits.  Against the reference,
//   and against the earlier design, the sums run in another order: the table
//   agrees within a tolerance, not bit for bit.
// - Operand order of a score as the reference: ((L + G) + lenvec) [+ quot],
//   then + H on the variant's value.  expf / logf (not the intrinsics),
//   built with -fmad=false.
// - Lane history in global memory, lane-major, PAD columns of front padding
//   (lanes[l][j + PAD]); no lane args.
// What is left is K2's: phase A's runs, a few global loads per entry in
// flight per lane, and the share whose walk is slowest (the first, with the
// most segment pieces, and the last, the lessD windows' five loads per
// entry); the fixed work of phases B and C.
// engine/scan.py:lse_batch_ref, merge_parked_ref, seg_value_ref,
// fold_variants_ref and reduce_c_ref copy these combine shapes in float32
// numpy for the CPU tests.
//
// -DK5_SIMPLE builds the earlier design (one kernel body; `if constexpr
// (SIMPLE)` where the designs differ), the yardstick of chip_smoke.py's
// k5_compare; -DK5_SPLIT either design with clock64 stamps per position and
// warp (k5_split_fetch).  The main path loads neither.

#include "k2_common.cuh"

namespace {

using namespace k2;

struct Args : Tables {
  float* rows;              // (n, S): row j the values of position j >= 1
};

// K5_SPLIT: a measurement build (never the main path's library) that
// stamps clock64() where each warp arrives at each barrier and adds the
// cycles up per warp in shared memory, copied at the end to k5_split and
// read back by k5_split_fetch.  Only the arrivals are stamped: a stamp
// placed right after a barrier can be taken before the warp is released
// from it.  The last arrival at a barrier is its release; warp 0 turns the
// arrivals into each warp's work (from the previous release to its
// arrival) and wait (from its arrival to the release).  Slots per warp:
enum {
  SP_W1 = 0,   // phase A: row staging, the share's runs and merges
  SP_BAR1,     // the wait at the barrier after phase A
  SP_W2,       // phase B: conv and lessD states, fixed and pinned states,
               // next segments
  SP_BAR2,
  SP_W3,       // phase C: lanes and next chain states
  SP_BAR3,
  SP_ENTRIES,  // band entries of the warp's share
  SP_PIECES,   // segment pieces merged in phase A
  SP_MAXENT,   // the most entries of the warp's share at one position
  SP_RUNS,     // phase A: cycles in the lanes' runs (loads, scores, pairs)
  SP_MERGE,    // phase A: cycles in the merges of the parked pairs
  SP_BSEG,     // phase B, warps 0-10: the variants' and lessD values
               // (segments' pairs, cut ones merged, logf, H)
  SP_BFOLD,    // phase B, warps 0-10: the fold of each state's variants
  SP_LAST1,    // positions where the warp reached barrier 1 last
  SP_LAST2,
  SP_LAST3,
  SP_PH1,      // warp 0: phases A-C from release to release
  SP_PH2,
  SP_PH3,
  SP_MIN1,     // warp 0: the fewest cycles of phases A-C at one position
  SP_MIN2,
  SP_MIN3,
  SP_NPOS,     // warp 0: the positions counted
  NSPLIT
};
#ifdef K5_SPLIT
#define SPLIT(...) __VA_ARGS__
#define SPLIT_ADD(k, x) \
  if (lane == 0) split_s[warp * NSPLIT + (k)] += (unsigned long long)(x);
#define SPLIT_MAX(k, x) \
  if (lane == 0 && (unsigned long long)(x) > split_s[warp * NSPLIT + (k)]) \
    split_s[warp * NSPLIT + (k)] = (unsigned long long)(x);
__device__ unsigned long long k5_split[K2_WARPS * NSPLIT];
// clock64 that the compiler keeps in place among memory operations
__device__ __forceinline__ long long clock_ordered() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
  return t;
}
// warp 0 after barrier b (0-2): from the arrivals arr, the release (the
// last arrival), each warp's work since the previous release `rel` and
// its wait, the warp that arrived last, the phase from release to release
__device__ __forceinline__ void split_barrier(const long long* arr,
                                              unsigned long long* split_s,
                                              int lane, int b,
                                              long long& rel) {
  const long long t = lane < K2_WARPS ? arr[lane] : LLONG_MIN;
  long long mx = t;
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_xor_sync(FULL, mx, o);
    mx = y > mx ? y : mx;
  }
  const int w = __ffs(__ballot_sync(FULL, t == mx)) - 1;
  if (rel > 0) {
    if (lane < K2_WARPS) {
      split_s[lane * NSPLIT + SP_W1 + 2 * b] += t - rel;
      split_s[lane * NSPLIT + SP_BAR1 + 2 * b] += mx - t;
    }
    if (lane == 0) {
      split_s[w * NSPLIT + SP_LAST1 + b] += 1;
      const unsigned long long d = mx - rel;
      split_s[SP_PH1 + b] += d;
      if (split_s[SP_MIN1 + b] == 0 || d < split_s[SP_MIN1 + b]) {
        split_s[SP_MIN1 + b] = d;
      }
      if (b == 2) split_s[SP_NPOS] += 1;
    }
  }
  // the first counted phase is phase A of a position
  rel = (rel > 0 || b == 2) ? mx : 0;
}
#define SPLIT_SHARED \
  __shared__ unsigned long long split_s[K2_WARPS * NSPLIT]; \
  __shared__ long long arr_s[3 * K2_WARPS]; \
  long long rel = 0; \
  for (int i = threadIdx.x; i < K2_WARPS * NSPLIT; i += blockDim.x) \
    split_s[i] = 0;
// before barrier b (0-2): this warp's arrival
#define ARRIVE(b) \
  if (lane == 0) arr_s[(b) * K2_WARPS + warp] = clock_ordered();
// after it: warp 0 accounts for it
#define RELEASED(b) \
  if (warp == 0) split_barrier(arr_s + (b) * K2_WARPS, split_s, lane, b, rel);
#define SPLIT_STORE \
  __syncthreads(); \
  for (int i = threadIdx.x; i < K2_WARPS * NSPLIT; i += blockDim.x) \
    k5_split[i] = split_s[i];
#else
#define SPLIT(...)
#endif

__device__ __forceinline__ float lse_value(float m, float s) {
  return m > GATE ? m + logf(s) : NEG;
}

// the reference's lse2
__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  const float s = (a > GATE ? expf(a - m) : 0.0f) +
                  (b > GATE ? expf(b - m) : 0.0f);
  return m > GATE ? m + logf(s) : NEG;
}

#ifdef K5_SIMPLE
constexpr bool SIMPLE = true;
#else
constexpr bool SIMPLE = false;
#endif

// -------- the earlier design (K5_SIMPLE): serial pushes and merges -----

// (m, s) += x: the running pair of a logsumexp over the live scores
__device__ __forceinline__ void lse_push(float& m, float& s, float x) {
  if (x > GATE) {
    if (x > m) {
      s = s * expf(m - x) + 1.0f;
      m = x;
    } else {
      s = s + expf(x - m);
    }
  }
}

// (m, s) merged with (om, os); two empty pairs stay (-inf, 0)
__device__ __forceinline__ void lse_merge(float& m, float& s, float om,
                                          float os) {
  const float M = fmaxf(m, om);
  if (M == ninf()) return;
  s = s * expf(m - M) + os * expf(om - M);
  m = M;
}

// -------- this design: maximum first, then independent terms --------

// words per scratch row of a segment: 33 spreads merge_parked's reads of
// a row over all banks (the earlier design reads 32-word rows skewed)
constexpr int SROW = SIMPLE ? 32 : 33;
constexpr int MERGE_G = 4;             // lanes per segment in merge_parked
constexpr int MERGE_K = 32 / MERGE_G;  // parked pairs per lane
static_assert(MAXP * MERGE_G == 32, "a group of 4 lanes per segment");
static_assert(2 * MAXP * SROW <= 3 * MAXP * 32, "the scratch region");

// a fixed pairwise tree over K values in place (x[0] the result): the
// maximum, or the sum
template <int K>
__device__ __forceinline__ float tree_max(float (&x)[K]) {
#pragma unroll
  for (int w = 1; w < K; w <<= 1) {
#pragma unroll
    for (int i = 0; i + w < K; i += 2 * w) x[i] = fmaxf(x[i], x[i + w]);
  }
  return x[0];
}
template <int K>
__device__ __forceinline__ float tree_sum(float (&x)[K]) {
#pragma unroll
  for (int w = 1; w < K; w <<= 1) {
#pragma unroll
    for (int i = 0; i + w < K; i += 2 * w) x[i] = x[i] + x[i + w];
  }
  return x[0];
}

// (m, s) += the live (> GATE) scores x of one batch: the batch's maximum
// first, s rescaled at most once, then the batch's terms (they wait on
// nothing but the new m) added in a fixed pairwise tree.  m is -inf (with
// s 0) or live.
__device__ __forceinline__ void lse_batch(float& m, float& s,
                                          const float (&x)[BATCH]) {
  float bm = x[0];
#pragma unroll
  for (int u = 1; u < BATCH; ++u) bm = fmaxf(bm, x[u]);
  if (bm > GATE) {
    const float nm = fmaxf(m, bm);
    const float r = m < nm ? expf(m - nm) : 1.0f;
    float e[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      e[u] = x[u] > GATE ? expf(x[u] - nm) : 0.0f;
    }
    s = s * r + tree_sum(e);
    m = nm;
  }
}

// the maximum and the sum over an aligned group of G lanes, by xor
// shuffles: every lane of the group gets the same bits (each pairwise
// fmaxf and add is commutative)
template <int G>
__device__ __forceinline__ float group_max(float m) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  return m;
}
template <int G>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) s = s + __shfl_xor_sync(FULL, s, o);
  return s;
}

__global__ void __launch_bounds__(K2_THREADS, 1)
scan_table_kernel(Args a, const int* __restrict__ desc_g, int desc_len) {
  extern __shared__ int smem[];
  const int* desc = smem;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  SPLIT(SPLIT_SHARED)
  for (int i = tid; i < desc_len; i += K2_THREADS) smem[i] = desc_g[i];
  __syncthreads();

  const K2Ctx x(smem);
  const int n = x.n, S = x.S, NL = x.NL, SP = x.SP, PAD = x.PAD;
  const int GPAD = x.GPAD, NSC = x.NSC, cls_col = x.cls_col;
  const int nconv = x.nconv, nchain = x.nchain, nfixed = x.nfixed;
  const int nfp = x.nfp, ncomb = x.ncomb, NSEG = x.NSEG;
  const size_t LW = x.LW, ML = x.ML, HL = x.HL;
  const float* lm = a.fdesc;
  float* vbuf = (float*)(smem + desc[D_SM_VBUF]);     // 2 x MAX_STATES
  // a segment's final pair, and a variant's value (MAX_SEG each)
  float* res_m = (float*)(smem + desc[D_SM_RES]);
  float* res_s = res_m + MAX_SEG;
  float* var_v = res_s + MAX_SEG;
  // the warps' FIRST ([w][0]) and LAST ([w][1]) pieces
  float* edge_m = (float*)(smem + desc[D_SM_EDGE]);
  float* edge_s = edge_m + 2 * K2_WARPS;
  __shared__ int seg_tot[SEG_THREADS / 32];

  // phase C of position jc (0 for the start column): groups of RED_G
  // lanes; the lanes of jc from the values vsrc, the chain states of jc + 1
  // into vdst; thread k of a group takes the states k SP / 4 .. (k + 1)
  // SP / 4 - 1 (the values' padding is -inf, never live): the group's
  // maximum, then each thread's terms of its live candidates in state
  // order, then the group's sum (K5_SIMPLE: a running pair per thread, the
  // four pairs merged)
  auto reduce_c = [&](int jc, const float* vsrc, float* vdst) {
    const bool next = jc + 1 < n;
    const int k = lane & (RED_G - 1);
    const int nitems = NL + (next ? nchain : 0);
    const float* srow1 = next ? x.srow_of(jc + 1) : nullptr;
    const int* irow1 = next ? (const int*)(srow1 + NSC) : nullptr;
    const int CH = SP / RED_G;
    constexpr int PER_WARP = 32 / RED_G;
    for (int base = warp * PER_WARP; base < nitems;
         base += K2_WARPS * PER_WARP) {
      const int item = base + lane / RED_G;
      const bool on = item < nitems;
      const float* lt = !on ? x.lt_s : item < NL ? x.lt_s + item * SP
          : x.ltc_s + ((size_t)irow1[cls_col] * nchain + (item - NL)) * SP;
      const float4* v4 = (const float4*)(vsrc + k * CH);
      const float4* l4 = (const float4*)(lt + k * CH);
      float m = ninf(), s = 0.0f;
      if constexpr (SIMPLE) {
        if (on) {
          for (int i = 0; i < CH / 4; ++i) {
            const float4 v = v4[i], l = l4[i];
            lse_push(m, s, v.x + l.x);
            lse_push(m, s, v.y + l.y);
            lse_push(m, s, v.z + l.z);
            lse_push(m, s, v.w + l.w);
          }
        }
        for (int o = 1; o < RED_G; o <<= 1) {
          const float om = __shfl_xor_sync(FULL, m, o);
          const float os = __shfl_xor_sync(FULL, s, o);
          lse_merge(m, s, om, os);
        }
      } else {
        // the maximum, and a bit per live candidate of the quarter (CH <=
        // 32); the transitions are sparse (a lane or a chain state has a
        // few live predecessors), so the terms are taken only for those
        unsigned live = 0;
        if (on) {
          for (int i = 0; i < CH / 4; ++i) {
            const float4 v = v4[i], l = l4[i];
            const float c[4] = {v.x + l.x, v.y + l.y, v.z + l.z, v.w + l.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              m = fmaxf(m, c[u]);
              live |= (c[u] > GATE ? 1u : 0u) << (4 * i + u);
            }
          }
        }
        m = group_max<RED_G>(m);
        const float* vq = vsrc + k * CH;
        const float* lq = lt + k * CH;
        for (; live; live &= live - 1) {
          const int b = __ffs(live) - 1;
          s = s + expf((vq[b] + lq[b]) - m);
        }
        s = group_sum<RED_G>(s);
      }
      const float val = lse_value(m, s);
      if (k == 0 && item < NL) {
        const int c0 = jc == 0 ? 0 : jc + PAD;
        for (int col = c0; col <= jc + PAD; ++col) {
          a.lanes[item * LW + col] = val;
        }
      } else if (k == 0 && on) {
        const int* r = desc + (x.chain_tasks[item - NL] & 0xFFFFFF);
        vdst[r[CH_STATE]] = val > GATE ? val + srow1[r[CH_EMI]] : NEG;
      }
    }
  };

  // row jr of the output from the value buffer b (a warp; the buffer of
  // jr is rewritten only in phase C of jr + 1)
  auto write_row = [&](int jr, int b) {
    const float* vp = vbuf + b * MAX_STATES;
    for (int s = lane; s < S; s += 32) a.rows[(size_t)jr * S + s] = vp[s];
  };

  // ---- prologue: constants, the first rows, the start column ----
  for (int i = tid; i < NL * SP; i += K2_THREADS) {
    const int l = i / SP, s = i % SP;
    x.lt_s[i] = s < S ? a.lane_trans[l * S + s] : 0.0f;
  }
  for (int i = tid; i < x.C * nchain * SP; i += K2_THREADS) {
    const int p = i % SP, kk = (i / SP) % nchain, c = i / (SP * nchain);
    const int s = desc[(x.chain_tasks[kk] & 0xFFFFFF) + CH_STATE];
    x.ltc_s[i] = p < S ? a.log_trans[((size_t)c * S + p) * S + s] : 0.0f;
  }
  // a state that no task writes keeps NEG
  for (int s = tid; s < SP; s += K2_THREADS) {
    vbuf[s] = s < S ? a.v0[s] : ninf();
    vbuf[MAX_STATES + s] = s < S ? NEG : ninf();
  }
  x.stage_row(1, a, tid);
  x.stage_row(2, a, tid);
  cp_async_wait<1>();
  __syncthreads();

  // j = 0 runs phases B and C only: the segments of position 1, the start
  // column's lanes and the chain states of position 1
  for (int j = 0; j < n; ++j) {
    const int cur = j & 1;
    float* vcur = vbuf + cur * MAX_STATES;
    const float* srow = x.srow_of(j);
    const int* irow = (const int*)(srow + NSC);
    const int* so = x.segoff + cur * (MAX_SEG + 1);
    const int* sw0 = x.segw0 + cur * MAX_SEG;
    if (j == 1) {  // v0 was read: the even positions' buffer starts at NEG
      for (int s = tid; s < S; s += K2_THREADS) vbuf[s] = NEG;
    }

    if (j > 0) {
      // ---------------- phase A: band shares -------------------------------
      if (warp == FP_WARP) {
        for (int t = lane; t < nfp; t += 32) {
          const int2 at = x.fp_at(t, j, irow);
          cp_async4(x.fpw + 4 * t, a.lanes + at.x);
          if (at.y >= 0) cp_async4(x.fpw + 4 * t + 2, a.lanes + at.y);
        }
      }
      cp_async_commit();
      x.stage_row(j + 2, a, tid);
      if (SIMPLE && warp == ROW_WARP && j > 1) write_row(j - 1, cur ^ 1);

      const int T = so[NSEG];
      const int sh0 = share_start(T, warp), sh1 = share_start(T, warp + 1);
      if (sh0 == sh1 && lane == 0) {
        edge_m[2 * warp] = ninf();
        edge_s[2 * warp] = 0.0f;
      }
      const int qa = x.first_segment(so, sh0, sh1, lane);
      SPLIT(SPLIT_ADD(SP_ENTRIES, sh1 - sh0) SPLIT_MAX(SP_MAXENT, sh1 - sh0))
      float* scr_m = x.scratch + warp * (3 * MAXP * 32);
      float* scr_s = scr_m + MAXP * SROW;
      // the share in chunks of at most MAXP segments (the scratch rows)
      for (int qb = qa, e0 = sh0; e0 < sh1; qb += MAXP) {
        SPLIT(const long long tb = clock_ordered();)
        const int e1 = qb + MAXP < NSEG ? min(sh1, so[qb + MAXP]) : sh1;
        for (int k = 0; k < MAXP; ++k) {
          scr_m[k * SROW + lane] = ninf();
          scr_s[k * SROW + lane] = 0.0f;
        }
        // lane l walks its entries e0 + l, e0 + l + 32, ... segment by
        // segment, BATCH entries at a time: their loads first, then their
        // scores (NEG past the run), then the batch into the run's pair
        // (K5_SIMPLE: each score pushed in turn)
        auto push = [&](float& rm, float& rs, const float (&sc)[BATCH]) {
          if constexpr (SIMPLE) {
#pragma unroll
            for (int u = 0; u < BATCH; ++u) lse_push(rm, rs, sc[u]);
          } else {
            lse_batch(rm, rs, sc);
          }
        };
        int q = qb;
        for (int i = e0 + lane; i < e1;) {
          while (so[q + 1] <= i) ++q;
          const int* sg = x.segs + q * SG_SIZE;
          const int nrun = (min(so[q + 1], e1) - i + 31) >> 5;
          const int w0 = sw0[q] + (i - so[q]);
          const int eo = j + sg[SG_EOFF];
          const float* pV = a.fdesc + sg[SG_LV];
          const float* pB = (sg[SG_VAR] < 0 ? a.cum_all : a.G_all) +
                            x.segbase[cur * MAX_SEG + q];
          float rm = ninf(), rs = 0.0f;
          if (sg[SG_VAR] < 0) {  // a lessD window
            const int* r = desc + sg[SG_REC];
            const int W = sg[SG_WIDTH];
            const int lo = sg[SG_LANE] * (int)LW + eo;
            const int8_t* pM = a.bvalid + (r[LD_LI] * (int)ML + eo);
            const int8_t* pS = a.bstop + (r[LD_LI] * (int)ML + eo);
            const float cumj = srow[r[LD_CUMJ]], psi = srow[r[LD_PSI]];
            const int8_t jsel = (int8_t)irow[r[LD_JSEL]];
            for (int m = 0; m < nrun; m += BATCH) {
              float Lb[BATCH], cb[BATCH], vb[BATCH];
              int mv[BATCH], ms[BATCH];
#pragma unroll
              for (int u = 0; u < BATCH; ++u) {
                const int w = w0 + 32 * (m + u);
                if (m + u < nrun) {
                  Lb[u] = a.lanes[lo + w];
                  cb[u] = pB[w];
                  vb[u] = pV[w];
                  mv[u] = pM[w];
                  ms[u] = pS[w];
                }
              }
              float sc[BATCH];
#pragma unroll
              for (int u = 0; u < BATCH; ++u) {
                const int w = w0 + 32 * (m + u);
                const bool ok = m + u < nrun && (j - W + w) >= 0 &&
                                mv[u] != 0 && ((int8_t)ms[u] & jsel) == 0 &&
                                Lb[u] > GATE;
                sc[u] = ok ? ((Lb[u] + (cumj - cb[u])) + vb[u]) + psi : NEG;
              }
              push(rm, rs, sc);
            }
          } else {  // a convolution variant: lane rows cl + frame
            const int r0 = sg[SG_R0];
            const int row0 = sg[SG_LANE] * (int)LW + eo;
            // the frame of entry w0 and its step per 32 entries
            int f = frame_of(r0, sg[SG_FMODE], w0);
            const int df = r0 < 0 ? 0 : (sg[SG_FMODE] == 1 ? 2 : 1);
            const int hint = sg[SG_HINT];
            for (int m = 0; m < nrun; m += BATCH) {
              float Lb[BATCH], gb[BATCH], vb[BATCH];
#pragma unroll
              for (int u = 0; u < BATCH; ++u) {
                const int w = w0 + 32 * (m + u);
                if (m + u < nrun) {
                  Lb[u] = a.lanes[row0 + f * (int)LW + w];
                  gb[u] = pB[w];
                  vb[u] = pV[w];
                  f += df;
                  f -= f >= 3 ? 3 : 0;
                }
              }
              float sc[BATCH];
#pragma unroll
              for (int u = 0; u < BATCH; ++u) {
                const int w = w0 + 32 * (m + u);
                sc[u] = NEG;
                if (m + u < nrun && Lb[u] > GATE && gb[u] > GATE) {
                  sc[u] = (Lb[u] + gb[u]) + vb[u];
                  if (hint >= 0) {
                    const int b0 = j + sg[SG_BOFF];
                    const int len_hi = desc[sg[SG_REC] + CV_AOFF] -
                                       sg[SG_BOFF];
                    sc[u] = sc[u] + hint_quot(desc + hint, srow, irow, a.hw,
                                              (int)HL, GPAD, lm, b0 + w, w,
                                              len_hi);
                  }
                }
              }
              push(rm, rs, sc);
            }
          }
          scr_m[(q - qb) * SROW + lane] = rm;
          scr_s[(q - qb) * SROW + lane] = rs;
          i += 32 * nrun;
        }
        __syncwarp();
        SPLIT(const long long tr = clock_ordered();
              SPLIT_ADD(SP_RUNS, tr - tb))
        // the parked pairs of segment qb + g, g < MAXP, merged into (pm,
        // ps); K5_SIMPLE: lane g, the 32 one after another (skewed: no two
        // lanes in one bank); else merge_parked: group g of 4 lanes, lane c
        // of the group pairs 8 c .. 8 c + 7 (row g at g SROW: bank g + 8 c
        // + i, no conflict), the exact maximum, one expf per pair, a fixed
        // tree of adds, the group's xor tree
        const int g = SIMPLE ? lane : lane / MERGE_G;
        const bool lead = SIMPLE ? lane < MAXP : (lane & (MERGE_G - 1)) == 0;
        const int qk = qb + g;
        int off = 0, end = 0;
        if (lead && qk < NSEG) { off = so[qk]; end = so[qk + 1]; }
        const bool has = lead && qk < NSEG && off < e1 && end > off &&
                         end > e0;
        SPLIT(const int npieces = __popc(__ballot_sync(FULL, has));
              SPLIT_ADD(SP_PIECES, npieces))
        float pm = ninf(), ps = 0.0f;
        if constexpr (SIMPLE) {
          if (has) {
            for (int l = 0; l < 32; ++l) {
              const int xi = lane * SROW + ((l + lane) & 31);
              lse_merge(pm, ps, scr_m[xi], scr_s[xi]);
            }
          }
        } else {
          const int c0 = g * SROW + (lane & (MERGE_G - 1)) * MERGE_K;
          float mk[MERGE_K], t[MERGE_K];
#pragma unroll
          for (int i = 0; i < MERGE_K; ++i) mk[i] = scr_m[c0 + i];
          pm = group_max<MERGE_G>(tree_max(mk));
          // a parked pair's m is -inf (s 0) or live
#pragma unroll
          for (int i = 0; i < MERGE_K; ++i) {
            const float mi = scr_m[c0 + i];
            t[i] = mi > GATE ? scr_s[c0 + i] * expf(mi - pm) : 0.0f;
          }
          ps = group_sum<MERGE_G>(tree_sum(t));
        }
        if (has) {
          // whole: the final pair; else the warp's FIRST or LAST piece
          const int i0 = max(sh0, off), i1 = min(sh1, end);
          const int slot = i0 > off ? 2 * warp : (i1 < end ? 2 * warp + 1
                                                           : -1);
          if (slot < 0) {
            res_m[qk] = pm; res_s[qk] = ps;
          } else {
            edge_m[slot] = pm; edge_s[slot] = ps;
          }
          if (i0 == off) x.segwf[qk] = warp;
          if (i1 == end) x.segwl[qk] = warp;
        }
        __syncwarp();
        SPLIT(SPLIT_ADD(SP_MERGE, clock_ordered() - tr))
        e0 = e1;
      }
      // row j + 1 and the fixed / pinned history landed; row j + 2 may not
      cp_async_wait<1>();
      SPLIT(ARRIVE(0))
      __syncthreads();
      SPLIT(RELEASED(0))
    }

    // ------- phase B: conv and lessD states, fixed and pinned states, ------
    // -------           the segments of position j + 1                 ------
    if (j > 0 && warp < FP_WARP) {
      // a segment's value: its final pair, or its pieces (the LAST piece
      // of its first warp, the FIRST pieces of the others): their maximum,
      // then their terms added in ascending share order (K5_SIMPLE: the
      // pieces merged in ascending share order)
      auto seg_value = [&](int q) -> float {
        if (so[q + 1] == so[q]) return NEG;
        const int wf = x.segwf[q], wl = x.segwl[q];
        if (wf == wl) return lse_value(res_m[q], res_s[q]);
        if constexpr (SIMPLE) {
          float m = edge_m[2 * wf + 1], s = edge_s[2 * wf + 1];
          for (int w = wf + 1; w <= wl; ++w) {
            lse_merge(m, s, edge_m[2 * w], edge_s[2 * w]);
          }
          return lse_value(m, s);
        } else {
          float M = edge_m[2 * wf + 1];
          for (int w = wf + 1; w <= wl; ++w) M = fmaxf(M, edge_m[2 * w]);
          if (!(M > GATE)) return NEG;
          // an empty piece's term: 0 * expf(-inf) = 0
          float s = edge_s[2 * wf + 1] * expf(edge_m[2 * wf + 1] - M);
#pragma unroll 4
          for (int w = wf + 1; w <= wl; ++w) {
            s = s + edge_s[2 * w] * expf(edge_m[2 * w] - M);
          }
          return M + logf(s);
        }
      };
      constexpr int PER_WARP = 32 / COMB_G;
      const int k = lane & (COMB_G - 1);
      for (int base = warp * PER_WARP; base < ncomb;
           base += FP_WARP * PER_WARP) {
        SPLIT(const long long tb = clock_ordered();)
        const int item = base + lane / COMB_G;
        const int* r = desc + (x.tasks[min(item, ncomb - 1)] & 0xFFFFFF);
        const bool gated = item < nconv && (irow[r[CV_GATE]] & 1);
        const int nv = gated ? r[CV_NVAR] : 0;
        // a conv state: lane k gives variants k, k + 8, ... their values;
        // a lessD state: lane 0 its segment's value, meanwhile (K5_SIMPLE:
        // after the fold)
        float vm = ninf();
        const float lb = !SIMPLE && k == 0 && item >= nconv && item < ncomb
            ? seg_value(r[LD_SEG]) : NEG;
        for (int vi = k; vi < nv; vi += COMB_G) {
          const int q = r[CV_SEG] + vi;
          const float sb = seg_value(q);
          const float H = srow[x.segs[q * SG_SIZE + SG_H]];
          const float v = (sb > GATE && H > GATE) ? sb + H : NEG;
          var_v[q] = v;
          vm = fmaxf(vm, v);
        }
        __syncwarp();
        SPLIT(const long long tf = clock_ordered();
              SPLIT_ADD(SP_BSEG, tf - tb))
        // the state's logsumexp over its variants: on the group's 8 lanes,
        // the maximum, the lane's terms in variant order, the group's sum
        // (K5_SIMPLE: one lane folds the variants in their order by lse2,
        // from NEG)
        float best = NEG;
        if constexpr (SIMPLE) {
          if (k == 0) {
            for (int vi = 0; vi < nv; ++vi) {
              best = lse2(best, var_v[r[CV_SEG] + vi]);
            }
          }
        } else {
          const float M = group_max<COMB_G>(vm);
          float s = 0.0f;
          if (M > GATE) {
            for (int vi = k; vi < nv; vi += COMB_G) {
              const float v = var_v[r[CV_SEG] + vi];
              s = s + (v > GATE ? expf(v - M) : 0.0f);
            }
          }
          best = lse_value(M, group_sum<COMB_G>(s));
        }
        if (k == 0 && item < nconv) {
          vcur[r[CV_STATE]] = best;
        } else if (k == 0 && item < ncomb) {  // a lessD state
          const float v = SIMPLE ? seg_value(r[LD_SEG]) : lb;
          vcur[r[LD_STATE]] = irow[r[LD_JGATE]] != 0 && v > GATE ? v : NEG;
        }
        __syncwarp();
        SPLIT(SPLIT_ADD(SP_BFOLD, clock_ordered() - tf))
      }
    } else if (j > 0 && warp == FP_WARP) {
      if (!SIMPLE && j > 1) write_row(j - 1, cur ^ 1);
      for (int t = lane; t < nfp; t += 32) {
        const int* fr = desc + (x.fp_tasks[t] & 0xFFFFFF);
        float lv = __int_as_float(x.fpw[4 * t]);
        if (t < nfixed) {
          const int D = fr[FX_JUMP];
          const float emi = srow[fr[FX_EMI]];
          if (fr[FX_KIND] == 1) {
            lv = lv + srow[fr[FX_EXTRA]];
          } else if (fr[FX_KIND] == 2) {
            lv = lse2(lv, __int_as_float(x.fpw[4 * t + 2]) +
                              srow[fr[FX_EXTRA]]);
          }
          const bool ok = j >= D && lv > GATE && emi > GATE;
          vcur[fr[FX_STATE]] = ok ? lv + emi : NEG;
        } else {
          const float sc = srow[fr[PN_SCORE]];
          vcur[fr[PN_STATE]] = (sc > GATE && lv > GATE) ? lv + sc : NEG;
        }
      }
    } else if (warp >= SEG_WARP && j + 1 < n) {
      x.seg_counts(j + 1, cur ^ 1, tid, lane, warp, seg_tot);
    }
    SPLIT(ARRIVE(1))
    __syncthreads();
    SPLIT(RELEASED(1))

    // ---------------- phase C: lanes of j, chain states of j + 1 ----------
    reduce_c(j, vcur, vbuf + (cur ^ 1) * MAX_STATES);
    SPLIT(ARRIVE(2))
    __syncthreads();
    SPLIT(RELEASED(2))
  }
  cp_async_wait<0>();
  if (warp == ROW_WARP && n > 1) write_row(n - 1, (n - 1) & 1);
  SPLIT(SPLIT_STORE)
}

}  // namespace

extern "C" int scan_table_launch(
    const void* desc, int desc_len, const void* fdesc, const void* G_all,
    const void* cum_all, const void* log_trans, const void* lane_trans,
    const void* stab, const void* itab, const void* bvalid,
    const void* bstop, const void* hw, const void* v0, void* lanes,
    void* rows, int smem_bytes, void* stream) {
  if (desc_len > MAX_DESC || desc_len < D_HEADER) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      scan_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.fdesc = (const float*)fdesc;
  a.G_all = (const float*)G_all;
  a.cum_all = (const float*)cum_all;
  a.log_trans = (const float*)log_trans;
  a.lane_trans = (const float*)lane_trans;
  a.stab = (const float*)stab;
  a.itab = (const int*)itab;
  a.bvalid = (const int8_t*)bvalid;
  a.bstop = (const int8_t*)bstop;
  a.hw = (const float*)hw;
  a.v0 = (const float*)v0;
  a.lanes = (float*)lanes;
  a.rows = (float*)rows;
  scan_table_kernel<<<1, K2_THREADS, smem_bytes, (cudaStream_t)stream>>>(
      a, (const int*)desc, desc_len);
  return (int)cudaGetLastError();
}

#ifdef K5_SPLIT
// the shape of the split, (warps, slots)
extern "C" int k5_split_warps() { return K2_WARPS; }
extern "C" int k5_split_slots() { return NSPLIT; }
// the last launch's cycles, (K2_WARPS, NSPLIT) uint64, into host memory dst
extern "C" int k5_split_fetch(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, k5_split, sizeof(k5_split));
}
#endif
