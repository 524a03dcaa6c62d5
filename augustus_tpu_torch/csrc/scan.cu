// General semi-Markov Viterbi forward pass (K2) of one sequence piece, for
// Hopper (sm_90a).
//
// Replaces augustus_tpu/engine/scan.py:make_scan_fn (the lax.scan Viterbi
// over the split tables, any number of states) with its hint quotient
// _hint_quot.  The port runs it where the 64-state kernel csrc/viterbi.cu
// cannot: the 71-state UTR architecture (S and lanes above 64, begin-bounded
// UTR variants).  The plain PyTorch version with the same arithmetic is
// augustus_tpu_torch/engine/scan.py:scan_forward_reference.
//
// What bounds it on the card: position j depends on the values of j-1 and
// on the lane history of older positions, so the n positions run in order
// inside ONE thread block on one SM.  Bytes and operations are far below
// the card's rates (engine/scan.py:scan_work); the time per position is the
// latency of its longest chain of dependent steps between block barriers.
// The band entries of the gated convolutions (on the 71-state UTR pieces a
// mean of about 3,400 clipped entries per position and up to 36,000, half
// of them in the 3' single UTR's two 5,500-wide variants) are the bulk of
// the work; the rest is fixed per position: 11 chain states and 75 lanes,
// each a maximum over 71 states, 6 lessD windows of 59, 22 one-load states.
//
// Design (one CTA of K2_THREADS = 512 threads, 16 warps; three barriers per
// position):
// - Phase A: the clipped entries of every gated convolution variant and
//   every lessD window of position j form ONE list of segments (one segment
//   per variant or window, in descriptor order), cut into 16 near-equal
//   contiguous shares, one per warp (share w: entries [T w / 16,
//   T (w + 1) / 16) of the T in the list; engine/scan.py:k2_shares is the
//   same arithmetic).  Lane l of a warp takes entries l, l + 32, ... of
//   its share, as runs of one segment each: the run's pointers are set
//   once, the frame stepped per entry, and BATCH entries at a time issue
//   every load (lane value and arg, G or the cumulative sum, the length
//   value, the lessD masks) before any is scored; each score is folded
//   into the lane's running (value, index, pred) last maximum of the run,
//   which is parked in a scratch row of the segment at the run's end; then
//   lane k reduces the 32 parked partials of the share's k-th segment (up
//   to MAXP = 8 segments at a time).  A segment inside one share is final;
//   a cut one leaves a partial at each warp that holds a piece of it (the
//   end piece in the warp's LAST slot, the others in FIRST).  Warp 11
//   copies the lane history of the fixed and pinned states into shared
//   memory with cp.async, warp 15 writes the previous position's rows.
// - Phase B: groups of 8 lanes per convolution or lessD state (warps
//   0-10) combine the state's segments (the partials of a cut one in
//   ascending order), then its variants with the strict `>` that keeps the
//   earlier one (a first maximum over (value, variant)), the H gate, and
//   write value and (pred << 20) | off; warp 11 the fixed and pinned
//   states; warps 12-15 the segments of position j + 1 (gate, clipping,
//   counts, band bases and their prefix, two segments a thread, a named
//   barrier between the four warps).
// - Phase C: groups of 4 lanes reduce over the S states: each lane of
//   position j (first argmax) and each chain state of position j + 1 (its
//   predecessors, first argmax; class and emission from row j + 1), with
//   lane_trans and the chain states' log_trans columns staged in shared
//   memory in rows padded to 16, each thread a contiguous quarter in
//   float4 loads.
// - The scalar and int table rows are brought into shared memory with
//   cp.async two positions ahead (4 slots); values and backpointers are
//   double-buffered by position parity, so no copy between positions; the
//   segment offsets, clipped starts and band bases of a position are
//   computed one phase ahead.
// - Bit-equality with the earlier design (-DK2_SIMPLE below) and with the
//   reference: every entry's score comes from the same operations whichever
//   thread computes it; the maximum over (value, index) pairs with ties to
//   the larger index is associative and commutative, so every partition of
//   a band gives the same pair (and its pred, read at that index), and an
//   empty share gives (-inf, -1), below NEG, as a band's start value.
// - Tie rules as make_scan_fn: chain states and lanes take the first
//   argmax; a lessD window and each convolution band the LAST maximum
//   (ridx = max(where(score == best))); between the variants of one state a
//   strict `>` keeps the earlier variant.
// - Operand order as the reference: score = ((L + G) + lenvec) [+ quot],
//   then + H once the band's best passes GATE.  The phase one-hot sums of
//   the reference (G = sum_k G3[k] * onehot[k], the framed L and lane arg)
//   are G3[phi] exactly for finite entries and are read as such.  Built with
//   -fmad=false, so no multiply-add is contracted.
// - Band clipping: a variant reads only the begins b in [smin, smax] (and
//   its vb_lo / vb_hi).  Exact: the reference scores every other entry NEG;
//   such an entry can be the band's last maximum only when no entry passes
//   GATE, and then the variant's value is NEG and `vbest > best` is false,
//   so neither the value nor pred/off comes from it.  A lessD window is
//   never clipped (its backpointer is written gated or not).
// - Convolutions whose end gate is off at j are skipped (lax.cond in the
//   reference): value NEG, pred 0, off 1.
// - Lane history in global memory, lane-major, PAD columns of front padding
//   (lanes[l][j + PAD]); values float32, args int8 as in JAX.
//
// -DK2_SIMPLE builds the earlier design (a warp per state task, tasks w,
// w + 16, ... on warp w, each band walked by one warp) as the yardstick of
// chip_smoke.py's k2_compare; -DK2_SPLIT either design with clock64 stamps
// per position and warp (k2_split_fetch).  The main path loads neither.
//
// The descriptor records, the hint quotient, the share cut, the segments'
// clipping and the cp.async staging live in csrc/k2_common.cuh, shared with
// K2's logsumexp twin csrc/scan_lse.cu.

#include "k2_common.cuh"

namespace {

using namespace k2;

struct Args : Tables {
  int8_t* largs;            // (NL, LW)
  int* bp;                  // (n, S)
  float* vals;              // (n, S) or null
  float* v_final;           // (S,)
};

// K2_SPLIT: a measurement build (never the main path's library) that
// stamps clock64() where each warp arrives at each barrier and adds the
// cycles up per warp in shared memory, copied at the end to k2_split and
// read back by k2_split_fetch.  Only the arrivals are stamped: a stamp
// placed right after a barrier can be taken before the warp is released
// from it.  The last arrival at a barrier is its release; warp 0 turns the
// arrivals into each warp's work (from the previous release to its
// arrival) and wait (from its arrival to the release).  Slots per warp:
enum {
  SP_W1 = 0,   // phase 1: tasks (simple) / row staging, bands (new)
  SP_BAR1,     // the wait at the barrier after phase 1
  SP_W2,       // phase 2: bp row and lane update (simple) / combine, fixed
               // and pinned states, next segments (new)
  SP_BAR2,
  SP_W3,       // phase 3: the vprev copy (simple) / lanes and next chain
               // states (new)
  SP_BAR3,
  SP_ENTRIES,  // clipped band entries the warp walked (lessD windows: new)
  SP_SEGS,     // gated conv tasks (simple) / segment pieces walked (new)
  SP_MAXENT,   // the most entries the warp walked at one position
  SP_BAND,     // cycles in band walks: conv tasks (simple) / the share's
               // runs and reductions (new)
  SP_LOADS,    // new: of those, the runs (loads and scores),
  SP_RED,      // and the reductions of the parked partials
  SP_LAST1,    // positions where the warp reached barrier 1 last
  SP_LAST2,
  SP_LAST3,
  SP_PH1,      // warp 0: phases 1-3 from release to release
  SP_PH2,
  SP_PH3,
  SP_NPOS,     // warp 0: the positions counted
  NSPLIT
};
#ifdef K2_SPLIT
#define SPLIT(...) __VA_ARGS__
#define SPLIT_ADD(k, x) \
  if (lane == 0) split_s[warp * NSPLIT + (k)] += (unsigned long long)(x);
#define SPLIT_MAX(k, x) \
  if (lane == 0 && (unsigned long long)(x) > split_s[warp * NSPLIT + (k)]) \
    split_s[warp * NSPLIT + (k)] = (unsigned long long)(x);
__device__ unsigned long long k2_split[K2_WARPS * NSPLIT];
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
      split_s[SP_PH1 + b] += mx - rel;
      if (b == 2) split_s[SP_NPOS] += 1;
    }
  }
  // the first counted phase is phase 1 of a position
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
    k2_split[i] = split_s[i];
#else
#define SPLIT(...)
#endif

#ifdef K2_SIMPLE
// ---------------------------------------------------------------------------
// The earlier design: warp w takes tasks w, w + 16, ...; each band is
// walked by one warp; three barriers per position and a copy of vprev.
// ---------------------------------------------------------------------------

// (value, index) warp reductions with the reference's tie rules
__device__ __forceinline__ void warp_first_max(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(FULL, v, o);
    int oi = __shfl_xor_sync(FULL, i, o);
    if (ov > v || (ov == v && oi >= 0 && (i < 0 || oi < i))) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ void warp_last_max(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(FULL, v, o);
    int oi = __shfl_xor_sync(FULL, i, o);
    if (ov > v || (ov == v && oi > i)) { v = ov; i = oi; }
  }
}

template <bool EXT>
__global__ void __launch_bounds__(K2_THREADS, 1)
scan_forward_kernel(Args a, const int* __restrict__ desc_g, int desc_len) {
  extern __shared__ int smem[];
  int* desc = smem;
  // the ints in shared memory; a deep piece's slot lists stay in desc_g
  const int share = desc_g[D_SHARE];
  float* vprev = (float*)(smem + share);
  float* vals = vprev + MAX_STATES;
  int* bps = (int*)(vals + MAX_STATES);
  float* l0 = (float*)(bps + MAX_STATES);
  int* a0 = (int*)(l0 + MAX_STATES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  SPLIT(SPLIT_SHARED)
  for (int i = tid; i < share; i += blockDim.x) desc[i] = desc_g[i];
  __syncthreads();
  if (tid == 0) put_globals(smem, desc_g, a);
  __syncthreads();

  const int n = desc[D_N], S = desc[D_S], NL = desc[D_NL];
  const int PAD = desc[D_PAD], GPAD = desc[D_GPAD];
  const int NSC = desc[D_NSC], NIC = desc[D_NIC], cls_col = desc[D_CLS];
  const int ntask = desc[D_NTASK];
  const int* tasks = desc + desc[D_OFF_TASK];
  const size_t LW = desc[D_LW], GL = desc[D_GL], CL = desc[D_CL];
  const size_t ML = desc[D_ML], HL = desc[D_HL];
  const int C = desc[D_C];
  const float* lm = a.fdesc;

  // start column: lanes at positions <= 0 hold max_s v0[s] + lane_trans
  for (int s = tid; s < S; s += blockDim.x) {
    vprev[s] = a.v0[s];
    vals[s] = NEG;
    bps[s] = 0;
  }
  if (tid < NL) {
    float best = ninf();
    int arg = 0;
    for (int s = 0; s < S; ++s) {
      const float c = a.v0[s] + a.lane_trans[tid * S + s];
      if (c > best) { best = c; arg = s; }
    }
    l0[tid] = best;
    a0[tid] = arg;
  }
  __syncthreads();
  for (size_t i = tid; i < (size_t)NL * (PAD + 1); i += blockDim.x) {
    const int l = (int)(i / (PAD + 1)), col = (int)(i % (PAD + 1));
    a.lanes[l * LW + col] = l0[l];
    a.largs[l * LW + col] = (int8_t)a0[l];
  }
  __syncthreads();

  for (int j = 1; j < n; ++j) {
    const float* srow = a.stab + (size_t)j * NSC;
    const int* irow = a.itab + (size_t)j * NIC;
    const int c = irow[cls_col];

    for (int t = warp; t < ntask; t += nwarps) {
      const int kind = tasks[t] >> 24;
      const int* r = desc + (tasks[t] & 0xFFFFFF);
      if (kind == T_CHAIN) {
        const int s = r[CH_STATE];
        const float* lt = a.log_trans + (size_t)c * S * S + s;
        float best = ninf();
        int arg = -1;
        for (int p = lane; p < S; p += 32) {
          const float cand = vprev[p] + lt[(size_t)p * S];
          if (cand > best) { best = cand; arg = p; }
        }
        warp_first_max(best, arg);
        if (lane == 0) {
          vals[s] = best > GATE ? best + srow[r[CH_EMI]] : NEG;
          bps[s] = (arg << 20) | 1;
        }
      } else if (kind == T_FIXED) {
        if (lane == 0) {
          const int s = r[FX_STATE], D = r[FX_JUMP], l = r[FX_LANE];
          const size_t col = (size_t)(j - D + PAD);
          const float emi = srow[r[FX_EMI]];
          float lv = a.lanes[l * LW + col];
          int la = a.largs[l * LW + col];
          if (r[FX_KIND] == 1) {
            lv = lv + srow[r[FX_EXTRA]];
          } else if (r[FX_KIND] == 2) {
            const float B = a.lanes[(l + 1) * LW + col] + srow[r[FX_EXTRA]];
            if (B > lv) la = a.largs[(l + 1) * LW + col];
            lv = fmaxf(lv, B);
          }
          const bool ok = j >= D && lv > GATE && emi > GATE;
          vals[s] = ok ? lv + emi : NEG;
          bps[s] = (la << 20) | D;
        }
      } else if (kind == T_LESSD) {
        const int s = r[LD_STATE], l = r[LD_LANE], W = r[LD_W];
        const int li = r[LD_LI];
        const size_t c0 = (size_t)(j - W + PAD);
        const float* lsl = a.lanes + l * LW + c0;
        const float* csl = a.cum_all + ((size_t)r[LD_CUM] * C + c) * CL +
                           (j - W + GPAD + 1);
        const int8_t* bv = a.bvalid + li * ML + c0;
        const int8_t* bs = a.bstop + li * ML + c0;
        const float* lvd = a.fdesc + r[LD_LV];
        const float cumj = srow[r[LD_CUMJ]], psi = srow[r[LD_PSI]];
        const int8_t jsel = (int8_t)irow[r[LD_JSEL]];
        float best = ninf();
        int idx = -1;
        for (int w = lane; w < W; w += 32) {
          const float L = lsl[w];
          const bool ok = (j - W + w) >= 0 && bv[w] != 0 &&
                          (bs[w] & jsel) == 0 && L > GATE;
          const float sc = ok ? ((L + (cumj - csl[w])) + lvd[w]) + psi : NEG;
          if (sc >= best) { best = sc; idx = w; }
        }
        warp_last_max(best, idx);
        if (lane == 0) {
          const bool gated = irow[r[LD_JGATE]] != 0 && best > GATE;
          vals[s] = gated ? best : NEG;
          bps[s] = ((int)a.largs[l * LW + c0 + idx] << 20) | (W - idx);
        }
      } else if (kind == T_PINNED) {
        if (lane == 0) {
          const int s = r[PN_STATE], l = r[PN_LANE];
          const int eop = irow[r[PN_EOP]];
          const float sc = srow[r[PN_SCORE]];
          const size_t row = (size_t)(max(eop, -PAD) + PAD);
          const float lv = a.lanes[l * LW + row];
          const int la = a.largs[l * LW + row];
          float v = (sc > GATE && lv > GATE) ? lv + sc : NEG;
          int b = (la << 20) | (j - eop);
          if constexpr (EXT) {
            if (const float* m = pinned_more(r, irow, a.fdesc))
              pinned_max(m, a.lanes, a.largs, l, LW, PAD, j, v, b);
          }
          vals[s] = v;
          bps[s] = b;
        }
      } else {  // T_CONV
        const int s = r[CV_STATE];
        const int gp = irow[r[CV_GATE]];
        if (!(gp & 1)) {
          if (lane == 0) { vals[s] = NEG; bps[s] = 1; }
          continue;
        }
        const int phi = gp >> 1;
        const int smin = irow[r[CV_SMIN]], smax = irow[r[CV_SMAX]];
        const int a_off = r[CV_AOFF], bpl = r[CV_BPL], cl = r[CV_LANE];
        const int fmode = r[CV_FMODE];
        const int* hrec = r[CV_HINT] >= 0 ? desc + r[CV_HINT] : nullptr;
        float best = NEG;
        int bpred = 0, boff = 1;
        SPLIT(int walked = 0; const long long tb = clock_ordered();)
        for (int vi = 0; vi < r[CV_NVAR]; ++vi) {
          const int* v = desc + r[CV_VAR] + vi * VR_SIZE;
          const int len_hi = v[VR_HI], wd = v[VR_W], r0 = v[VR_R0];
          const int b0 = j + a_off - len_hi;
          const int e0 = b0 - bpl - 1 + PAD;     // lanes column of w = 0
          int lo = smin, hi = smax;
          if (v[VR_HAS_LO]) lo = max(lo, v[VR_VB_LO]);
          if (v[VR_HAS_HI]) hi = min(hi, v[VR_VB_HI]);
          const int w0 = max(0, lo - b0);
          const int w1 = min(wd - 1, hi - b0);
          SPLIT(walked += max(0, w1 - w0 + 1);)
          const float* G = a.G_all +
              (((size_t)v[VR_G] * C + c) * 3 + phi) * GL + (GPAD + b0);
          const float* lvd = a.fdesc + v[VR_LV];
          float sb = ninf();
          int ridx = -1;
          if (hrec) {
            for (int w = w0 + lane; w <= w1; w += 32) {
              const int f = frame_of(r0, fmode, w);
              const float L = a.lanes[(cl + f) * LW + e0 + w];
              const float g = G[w];
              float sc = NEG;
              if (L > GATE && g > GATE) {
                sc = ((L + g) + lvd[w]) +
                     hint_quot<EXT>(hrec, srow, irow, a.hw, (int)HL, GPAD,
                                    lm, b0 + w, w, len_hi);
              }
              if (sc >= sb) { sb = sc; ridx = w; }
            }
          } else {
            // every entry's three loads are independent of the others and
            // unconditional, so a lane keeps several entries' loads in
            // flight; unrolled 4 times
#pragma unroll 4
            for (int w = w0 + lane; w <= w1; w += 32) {
              const int f = frame_of(r0, fmode, w);
              const float L = a.lanes[(cl + f) * LW + e0 + w];
              const float g = G[w];
              const float lv = lvd[w];
              const float sc = (L > GATE && g > GATE) ? (L + g) + lv : NEG;
              if (sc >= sb) { sb = sc; ridx = w; }
            }
          }
          warp_last_max(sb, ridx);
          const float H = srow[v[VR_H]];
          const float vbest = (sb > GATE && H > GATE) ? sb + H : NEG;
          if (vbest > best) {
            best = vbest;
            const int f = frame_of(r0, fmode, ridx);
            bpred = a.largs[(cl + f) * LW + e0 + ridx];
            boff = (len_hi - a_off + bpl + 1) - ridx;
          }
        }
        SPLIT(SPLIT_ADD(SP_ENTRIES, walked) SPLIT_ADD(SP_SEGS, 1)
              SPLIT_MAX(SP_MAXENT, walked)
              SPLIT_ADD(SP_BAND, clock_ordered() - tb))
        if (lane == 0) {
          vals[s] = best;
          bps[s] = (bpred << 20) | boff;
        }
      }
    }
    SPLIT(ARRIVE(0))
    __syncthreads();
    SPLIT(RELEASED(0))

    for (int s = tid; s < S; s += blockDim.x) {
      a.bp[(size_t)j * S + s] = bps[s];
      if (a.vals) a.vals[(size_t)j * S + s] = vals[s];
    }
    if (tid < NL) {
      const float* lt = a.lane_trans + tid * S;
      float best = ninf();
      int arg = 0;
      for (int s = 0; s < S; ++s) {
        const float cand = vals[s] + lt[s];
        if (cand > best) { best = cand; arg = s; }
      }
      a.lanes[tid * LW + j + PAD] = best;
      a.largs[tid * LW + j + PAD] = (int8_t)arg;
    }
    SPLIT(ARRIVE(1))
    __syncthreads();
    SPLIT(RELEASED(1))
    for (int s = tid; s < S; s += blockDim.x) vprev[s] = vals[s];
    SPLIT(ARRIVE(2))
    __syncthreads();
    SPLIT(RELEASED(2))
  }
  for (int s = tid; s < S; s += blockDim.x) a.v_final[s] = vprev[s];
  SPLIT(SPLIT_STORE)
}

constexpr bool SIMPLE = true;

#else  // the design described at the top
// ---------------------------------------------------------------------------


// (v, i, p) = the last maximum of itself and (ov, oi, op)
__device__ __forceinline__ void last_max_into(float& v, int& i, int& p,
                                              float ov, int oi, int op) {
  if (ov > v || (ov == v && oi > i)) { v = ov; i = oi; p = op; }
}

// first maximum of (v, i) over an aligned group of RED_G lanes
__device__ __forceinline__ void group_first_max(float& v, int& i) {
  for (int o = 1; o < RED_G; o <<= 1) {
    const float ov = __shfl_xor_sync(FULL, v, o);
    const int oi = __shfl_xor_sync(FULL, i, o);
    if (ov > v || (ov == v && oi >= 0 && (i < 0 || oi < i))) {
      v = ov;
      i = oi;
    }
  }
}


// The whole pass of one piece, by one block: the body of the single and the
// batched kernel.
template <bool EXT>
__device__ __forceinline__ void scan_body(const Args& a,
                                          const int* __restrict__ desc_g,
                                          int desc_len) {
  extern __shared__ int smem[];
  const int* desc = smem;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  SPLIT(SPLIT_SHARED)
  const int share = desc_g[D_SHARE];
  for (int i = tid; i < share; i += K2_THREADS) smem[i] = desc_g[i];
  __syncthreads();
  if (tid == 0) put_globals(smem, desc_g, a);
  __syncthreads();

  const K2Ctx x(smem);
  const int n = x.n, S = x.S, NL = x.NL, SP = x.SP, PAD = x.PAD;
  const int GPAD = x.GPAD, cls_col = x.cls_col;
  const int* tasks = x.tasks;
  const int nconv = x.nconv, nchain = x.nchain, nfixed = x.nfixed;
  const int* chain_tasks = x.chain_tasks;
  const int* fp_tasks = x.fp_tasks;
  const int nfp = x.nfp, ncomb = x.ncomb, NSEG = x.NSEG;
  const int* segs = x.segs;
  const size_t LW = x.LW, ML = x.ML, HL = x.HL;
  const int C = x.C;
  const float* lm = a.fdesc;
  float* lt_s = x.lt_s;
  float* ltc_s = x.ltc_s;
  float* vbuf = (float*)(smem + desc[D_SM_VBUF]);     // 2 x MAX_STATES
  int* bpbuf = smem + desc[D_SM_BPBUF];               // 2 x MAX_STATES
  int* segoff = x.segoff;
  int* segw0 = x.segw0;
  int* segwf = x.segwf;
  int* segwl = x.segwl;
  float* res_v = (float*)(smem + desc[D_SM_RES]);     // MAX_SEG each
  int* res_i = (int*)(res_v + MAX_SEG);
  int* res_p = res_i + MAX_SEG;
  float* edge_v = (float*)(smem + desc[D_SM_EDGE]);   // 2 K2_WARPS each:
  int* edge_i = (int*)(edge_v + 2 * K2_WARPS);        // [w][0] FIRST,
  int* edge_p = edge_i + 2 * K2_WARPS;                // [w][1] LAST
  int* fpw = x.fpw;
  long long* segbase = x.segbase;
  // the lanes' parked partials, K2_WARPS x (3 x MAXP x 32)
  float* scratch = x.scratch;
  __shared__ int seg_tot[SEG_THREADS / 32];

  auto stage_row = [&](int r) { x.template stage_row<EXT>(r, a, tid); };
  auto srow_of = [&](int r) -> const float* { return x.srow_of(r); };
  auto fp_at = [&](int t, int j, const int* irow) -> int2 {
    return x.fp_at(t, j, irow);
  };
  auto arg_word = [&](int at) -> const void* {
    return (const void*)((uintptr_t)(a.largs + at) & ~(uintptr_t)3);
  };
  auto arg_byte = [&](int word, int at) -> int {
    return (int)(int8_t)(word >> (8 * ((uintptr_t)(a.largs + at) & 3)));
  };
  auto seg_counts = [&](int jn, int nb) {
    x.template seg_counts<EXT>(jn, nb, tid, lane, warp, seg_tot);
  };
  // phase C of position jc (0 for the start column): every warp, groups of
  // RED_G lanes; the lanes of jc from the values vsrc, the chain states of
  // jc + 1 into vdst / bdst.  Rows of SP floats (S padded to 16; the
  // values' padding is -inf), thread k of a group takes the states
  // k SP / 4 .. (k + 1) SP / 4 - 1 in float4 loads
  auto reduce_c = [&](int jc, const float* vsrc, float* vdst, int* bdst) {
    const bool next = jc + 1 < n;
    const int k = lane & (RED_G - 1);
    const int nitems = NL + (next ? nchain : 0);
    const float* srow1 = next ? srow_of(jc + 1) : nullptr;
    const int* irow1 = next ? x.template irow_of<EXT>(jc + 1) : nullptr;
    const int CH = SP / RED_G;
    constexpr int PER_WARP = 32 / RED_G;
    for (int base = warp * PER_WARP; base < nitems;
         base += K2_WARPS * PER_WARP) {
      const int item = base + lane / RED_G;
      float best = ninf();
      int arg = -1;
      if (item < nitems) {
        const float* lt = item < NL ? lt_s + item * SP
            : ltc_s + ((size_t)irow1[cls_col] * nchain + (item - NL)) * SP;
        const float4* v4 = (const float4*)(vsrc + k * CH);
        const float4* l4 = (const float4*)(lt + k * CH);
        for (int i = 0; i < CH / 4; ++i) {
          const float4 v = v4[i], l = l4[i];
          const int s0 = k * CH + 4 * i;
          float cand = v.x + l.x;
          if (cand > best) { best = cand; arg = s0; }
          cand = v.y + l.y;
          if (cand > best) { best = cand; arg = s0 + 1; }
          cand = v.z + l.z;
          if (cand > best) { best = cand; arg = s0 + 2; }
          cand = v.w + l.w;
          if (cand > best) { best = cand; arg = s0 + 3; }
        }
      }
      group_first_max(best, arg);
      if (k == 0 && item < NL) {
        const int ac = arg < 0 ? 0 : arg;
        const int c0 = jc == 0 ? 0 : jc + PAD;
        for (int col = c0; col <= jc + PAD; ++col) {
          a.lanes[item * LW + col] = best;
          a.largs[item * LW + col] = (int8_t)ac;
        }
      } else if (k == 0 && item < nitems) {
        const int* r = desc + (chain_tasks[item - NL] & 0xFFFFFF);
        const int s = r[CH_STATE];
        vdst[s] = best > GATE ? best + srow1[r[CH_EMI]] : NEG;
        bdst[s] = (arg << 20) | 1;
      }
    }
  };
  // the bp (and debug value) row of position jr; warp ROW_WARP
  auto write_row = [&](int jr, const float* vsrc, const int* bsrc) {
    for (int s = lane; s < S; s += 32) {
      a.bp[(size_t)jr * S + s] = bsrc[s];
      if (a.vals) a.vals[(size_t)jr * S + s] = vsrc[s];
    }
  };

  // ---- prologue: constants, the first rows, the start column ----
  for (int i = tid; i < NL * SP; i += K2_THREADS) {
    const int l = i / SP, s = i % SP;
    lt_s[i] = s < S ? a.lane_trans[l * S + s] : 0.0f;
  }
  for (int i = tid; i < C * nchain * SP; i += K2_THREADS) {
    const int p = i % SP, kk = (i / SP) % nchain, c = i / (SP * nchain);
    const int s = desc[(chain_tasks[kk] & 0xFFFFFF) + CH_STATE];
    ltc_s[i] = p < S ? a.log_trans[((size_t)c * S + p) * S + s] : 0.0f;
  }
  // a state that no task writes keeps NEG and backpointer 0 (the buffer of
  // odd positions before the chain states of position 1 are written, the
  // other after v0 was read)
  for (int s = tid; s < SP; s += K2_THREADS) {
    vbuf[s] = s < S ? a.v0[s] : ninf();
    vbuf[MAX_STATES + s] = s < S ? NEG : ninf();
    bpbuf[s] = 0;
    bpbuf[MAX_STATES + s] = 0;
  }
  stage_row(1);
  stage_row(2);
  cp_async_wait<1>();
  __syncthreads();

  // j = 0 runs phases B and C only: the segments of position 1, the start
  // column's lanes and the chain states of position 1
  for (int j = 0; j < n; ++j) {
    const int cur = j & 1;
    float* vcur = vbuf + cur * MAX_STATES;
    int* bcur = bpbuf + cur * MAX_STATES;
    const float* srow = srow_of(j);
    const int* irow = x.template irow_of<EXT>(j);
    const int* so = segoff + cur * (MAX_SEG + 1);
    const int* sw0 = segw0 + cur * MAX_SEG;
    if (j == 1) {  // v0 was read: the even positions' buffer starts at NEG
      for (int s = tid; s < S; s += K2_THREADS) vbuf[s] = NEG;
    }

    if (j > 0) {
      // ---------------- phase A: band shares -------------------------------
      // the lane history of the fixed and pinned states into shared memory
      // (read in phase B), then row j + 2: one commit group each
      if (warp == FP_WARP) {
        for (int t = lane; t < nfp; t += 32) {
          const int2 at = fp_at(t, j, irow);
          cp_async4(fpw + 4 * t, a.lanes + at.x);
          cp_async4(fpw + 4 * t + 1, arg_word(at.x));
          if (at.y >= 0) {
            cp_async4(fpw + 4 * t + 2, a.lanes + at.y);
            cp_async4(fpw + 4 * t + 3, arg_word(at.y));
          }
        }
      }
      cp_async_commit();
      stage_row(j + 2);
      if (warp == ROW_WARP && j > 1) {
        write_row(j - 1, vbuf + (cur ^ 1) * MAX_STATES,
                  bpbuf + (cur ^ 1) * MAX_STATES);
      }

      const int T = so[NSEG];
      const int sh0 = share_start(T, warp), sh1 = share_start(T, warp + 1);
      if (sh0 == sh1 && lane == 0) {
        edge_v[2 * warp] = ninf();
        edge_i[2 * warp] = -1;
        edge_p[2 * warp] = 0;
      }
      const int qa = x.first_segment(so, sh0, sh1, lane);
      SPLIT(SPLIT_ADD(SP_ENTRIES, sh1 - sh0) SPLIT_MAX(SP_MAXENT, sh1 - sh0))
      float* scr_v = scratch + warp * (3 * MAXP * 32);
      int* scr_i = (int*)(scr_v + MAXP * 32);
      int* scr_p = scr_i + MAXP * 32;
      // the share in chunks of at most MAXP segments (the scratch rows)
      for (int qb = qa, e0 = sh0; e0 < sh1; qb += MAXP) {
        SPLIT(const long long tb = clock_ordered();)
        const int e1 = qb + MAXP < NSEG ? min(sh1, so[qb + MAXP]) : sh1;
        for (int k = 0; k < MAXP; ++k) {
          scr_v[k * 32 + lane] = ninf();
          scr_i[k * 32 + lane] = -1;
          scr_p[k * 32 + lane] = 0;
        }
        // lane l walks its entries e0 + l, e0 + l + 32, ... segment by
        // segment: a run of the entries of one segment, with the
        // segment's pointers set once and the frame stepped per entry,
        // BATCH entries at a time (their loads first, then their scores)
        int q = qb;
        for (int i = e0 + lane; i < e1;) {
          while (so[q + 1] <= i) ++q;
          const int* sg = segs + q * SG_SIZE;
          const int nrun = (min(so[q + 1], e1) - i + 31) >> 5;
          const int w0 = sw0[q] + (i - so[q]);
          const int eo = j + sg[SG_EOFF];
          const float* pV = a.fdesc + sg[SG_LV];
          const float* pB = (sg[SG_VAR] < 0 ? a.cum_all : a.G_all) +
                            segbase[cur * MAX_SEG + q];
          float sb = ninf();
          int ridx = -1, rp = 0;
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
              int pb[BATCH], mv[BATCH], ms[BATCH];
#pragma unroll
              for (int u = 0; u < BATCH; ++u) {
                const int w = w0 + 32 * (m + u);
                if (m + u < nrun) {
                  Lb[u] = a.lanes[lo + w];
                  pb[u] = a.largs[lo + w];
                  cb[u] = pB[w];
                  vb[u] = pV[w];
                  mv[u] = pM[w];
                  ms[u] = pS[w];
                }
              }
#pragma unroll
              for (int u = 0; u < BATCH; ++u) {
                const int w = w0 + 32 * (m + u);
                if (m + u < nrun) {
                  const bool ok = (j - W + w) >= 0 && mv[u] != 0 &&
                                  ((int8_t)ms[u] & jsel) == 0 &&
                                  Lb[u] > GATE;
                  const float sc =
                      ok ? ((Lb[u] + (cumj - cb[u])) + vb[u]) + psi : NEG;
                  if (sc >= sb) { sb = sc; ridx = w; rp = pb[u]; }
                }
              }
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
              int pb[BATCH];
#pragma unroll
              for (int u = 0; u < BATCH; ++u) {
                const int w = w0 + 32 * (m + u);
                if (m + u < nrun) {
                  const int at = row0 + f * (int)LW + w;
                  Lb[u] = a.lanes[at];
                  pb[u] = a.largs[at];
                  gb[u] = pB[w];
                  vb[u] = pV[w];
                  f += df;
                  f -= f >= 3 ? 3 : 0;
                }
              }
#pragma unroll
              for (int u = 0; u < BATCH; ++u) {
                const int w = w0 + 32 * (m + u);
                if (m + u < nrun) {
                  float sc = NEG;
                  if (Lb[u] > GATE && gb[u] > GATE) {
                    sc = (Lb[u] + gb[u]) + vb[u];
                    if (hint >= 0) {
                      const int b0 = j + sg[SG_BOFF];
                      const int len_hi = desc[sg[SG_REC] + CV_AOFF] -
                                         sg[SG_BOFF];
                      sc = sc + hint_quot<EXT>(desc + hint, srow, irow,
                                               a.hw, (int)HL, GPAD, lm,
                                               b0 + w, w, len_hi);
                    }
                  }
                  if (sc >= sb) { sb = sc; ridx = w; rp = pb[u]; }
                }
              }
            }
          }
          scr_v[(q - qb) * 32 + lane] = sb;
          scr_i[(q - qb) * 32 + lane] = ridx;
          scr_p[(q - qb) * 32 + lane] = rp;
          i += 32 * nrun;
        }
        __syncwarp();
        SPLIT(const long long tr = clock_ordered();
              SPLIT_ADD(SP_LOADS, tr - tb))
        // lane k reduces the 32 parked partials of segment qb + k, if it
        // has entries here (in a skewed order: no two lanes in one bank)
        {
          const int qk = qb + lane;
          int off = 0, end = 0;
          if (lane < MAXP && qk < NSEG) { off = so[qk]; end = so[qk + 1]; }
          const bool has = lane < MAXP && qk < NSEG && off < e1 &&
                           end > off && end > e0;
          SPLIT(const int nseg_ = __popc(__ballot_sync(FULL, has));
                SPLIT_ADD(SP_SEGS, nseg_))
          if (has) {
            float v = ninf();
            int ri = -1, pr = 0;
            for (int l = 0; l < 32; ++l) {
              const int x = lane * 32 + ((l + lane) & 31);
              last_max_into(v, ri, pr, scr_v[x], scr_i[x], scr_p[x]);
            }
            // whole: the final result; else the warp's FIRST or LAST piece
            const int i0 = max(sh0, off), i1 = min(sh1, end);
            const int slot = i0 > off ? 2 * warp : (i1 < end ? 2 * warp + 1
                                                             : -1);
            if (slot < 0) {
              res_v[qk] = v; res_i[qk] = ri; res_p[qk] = pr;
            } else {
              edge_v[slot] = v; edge_i[slot] = ri; edge_p[slot] = pr;
            }
            if (i0 == off) segwf[qk] = warp;
            if (i1 == end) segwl[qk] = warp;
          }
        }
        __syncwarp();
        SPLIT(const long long te = clock_ordered();
              SPLIT_ADD(SP_RED, te - tr) SPLIT_ADD(SP_BAND, te - tb))
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
      // a segment's (value, index, pred): final, or its pieces combined
      auto seg_result = [&](int q, float& v, int& i, int& p) {
        v = ninf(); i = -1; p = 0;
        if (so[q + 1] == so[q]) return;
        const int wf = segwf[q], wl = segwl[q];
        if (wf == wl) {
          v = res_v[q]; i = res_i[q]; p = res_p[q];
          return;
        }
        v = edge_v[2 * wf + 1]; i = edge_i[2 * wf + 1]; p = edge_p[2 * wf + 1];
        for (int w = wf + 1; w <= wl; ++w)
          last_max_into(v, i, p, edge_v[2 * w], edge_i[2 * w],
                        edge_p[2 * w]);
      };
      constexpr int PER_WARP = 32 / COMB_G;
      const int k = lane & (COMB_G - 1);
      for (int base = warp * PER_WARP; base < ncomb;
           base += FP_WARP * PER_WARP) {
        const int item = base + lane / COMB_G;
        const int* r = desc + (tasks[min(item, ncomb - 1)] & 0xFFFFFF);
        // a conv state: the variants of lane k, then the group's first
        // maximum over (value, variant): the strict `>` in variant order
        float best = NEG;
        int bvi = -1, bpred = 0, boff = 1;
        if (item < nconv && (irow[r[CV_GATE]] & 1)) {
          for (int vi = k; vi < r[CV_NVAR]; vi += COMB_G) {
            const int q = r[CV_SEG] + vi;
            const int* sg = segs + q * SG_SIZE;
            float sb;
            int ridx, rp;
            seg_result(q, sb, ridx, rp);
            const float H = srow[sg[SG_H]];
            const float vbest = (sb > GATE && H > GATE) ? sb + H : NEG;
            if (vbest > best) {
              best = vbest;
              bvi = vi;
              bpred = rp;
              boff = sg[SG_OFFB] - ridx;
            }
          }
        }
        for (int o = 1; o < COMB_G; o <<= 1) {
          const float ov = __shfl_xor_sync(FULL, best, o);
          const int ovi = __shfl_xor_sync(FULL, bvi, o);
          const int op = __shfl_xor_sync(FULL, bpred, o);
          const int oo = __shfl_xor_sync(FULL, boff, o);
          if (ov > best || (ov == best && ovi >= 0 &&
                            (bvi < 0 || ovi < bvi))) {
            best = ov; bvi = ovi; bpred = op; boff = oo;
          }
        }
        if (k == 0 && item < nconv) {
          vcur[r[CV_STATE]] = best;
          bcur[r[CV_STATE]] = (bpred << 20) | boff;
        } else if (k == 0 && item < ncomb) {  // a lessD state
          float lb;
          int idx, rp;
          seg_result(r[LD_SEG], lb, idx, rp);
          const bool gated = irow[r[LD_JGATE]] != 0 && lb > GATE;
          vcur[r[LD_STATE]] = gated ? lb : NEG;
          bcur[r[LD_STATE]] = (rp << 20) | (r[LD_W] - idx);
        }
      }
    } else if (j > 0 && warp == FP_WARP) {
      for (int t = lane; t < nfp; t += 32) {
        const int* fr = desc + (fp_tasks[t] & 0xFFFFFF);
        const int2 at = fp_at(t, j, irow);
        float lv = __int_as_float(fpw[4 * t]);
        int la = arg_byte(fpw[4 * t + 1], at.x);
        if (t < nfixed) {
          const int D = fr[FX_JUMP];
          const float emi = srow[fr[FX_EMI]];
          if (fr[FX_KIND] == 1) {
            lv = lv + srow[fr[FX_EXTRA]];
          } else if (fr[FX_KIND] == 2) {
            const float B = __int_as_float(fpw[4 * t + 2]) +
                            srow[fr[FX_EXTRA]];
            if (B > lv) la = arg_byte(fpw[4 * t + 3], at.y);
            lv = fmaxf(lv, B);
          }
          const bool ok = j >= D && lv > GATE && emi > GATE;
          vcur[fr[FX_STATE]] = ok ? lv + emi : NEG;
          bcur[fr[FX_STATE]] = (la << 20) | D;
        } else {
          const int eop = irow[fr[PN_EOP]];
          const float sc = srow[fr[PN_SCORE]];
          float v = (sc > GATE && lv > GATE) ? lv + sc : NEG;
          int b = (la << 20) | (j - eop);
          if constexpr (EXT) {
            if (const float* m = pinned_more(fr, irow, a.fdesc))
              pinned_max(m, a.lanes, a.largs, fr[PN_LANE], LW, PAD, j, v,
                         b);
          }
          vcur[fr[PN_STATE]] = v;
          bcur[fr[PN_STATE]] = b;
        }
      }
    } else if (warp >= SEG_WARP && j + 1 < n) {
      seg_counts(j + 1, cur ^ 1);
    }
    SPLIT(ARRIVE(1))
    __syncthreads();
    SPLIT(RELEASED(1))

    // ---------------- phase C: lanes of j, chain states of j + 1 ----------
    reduce_c(j, vcur, vbuf + (cur ^ 1) * MAX_STATES,
             bpbuf + (cur ^ 1) * MAX_STATES);
    SPLIT(ARRIVE(2))
    __syncthreads();
    SPLIT(RELEASED(2))
  }
  cp_async_wait<0>();
  const float* vlast = n == 1 ? a.v0 : vbuf + ((n - 1) & 1) * MAX_STATES;
  if (warp == ROW_WARP && n > 1) {
    write_row(n - 1, vlast, bpbuf + ((n - 1) & 1) * MAX_STATES);
  }
  for (int s = tid; s < S; s += K2_THREADS) a.v_final[s] = vlast[s];
  SPLIT(SPLIT_STORE)
}

template <bool EXT>
__global__ void __launch_bounds__(K2_THREADS, 1)
scan_forward_kernel(Args a, const int* __restrict__ desc_g, int desc_len) {
  scan_body<EXT>(a, desc_g, desc_len);
}

// A batch record: the arguments of scan_forward_launch from desc to v_final,
// each as one int64 (pointers and ints alike), in that order
// (engine/scan.py:_launch_fields).
constexpr int NFIELDS = 18;

struct BatchRec {
  Args a;
  const int* desc;
  int desc_len;
};

// One block per piece of a batch: block b copies record b into shared
// memory and runs the same body as a single launch, so each piece's bp and
// v_final are those of its own launch.
template <bool EXT>
__global__ void __launch_bounds__(K2_THREADS, 1)
scan_forward_batch_kernel(const long long* __restrict__ recs) {
  __shared__ BatchRec rec;
  if (threadIdx.x == 0) {
    const long long* f = recs + (size_t)blockIdx.x * NFIELDS;
    rec.desc = (const int*)f[0];
    rec.desc_len = (int)f[1];
    rec.a.fdesc = (const float*)f[2];
    rec.a.G_all = (const float*)f[3];
    rec.a.cum_all = (const float*)f[4];
    rec.a.log_trans = (const float*)f[5];
    rec.a.lane_trans = (const float*)f[6];
    rec.a.stab = (const float*)f[7];
    rec.a.itab = (const int*)f[8];
    rec.a.bvalid = (const int8_t*)f[9];
    rec.a.bstop = (const int8_t*)f[10];
    rec.a.hw = (const float*)f[11];
    rec.a.v0 = (const float*)f[12];
    rec.a.lanes = (float*)f[13];
    rec.a.largs = (int8_t*)f[14];
    rec.a.bp = (int*)f[15];
    rec.a.vals = (float*)f[16];
    rec.a.v_final = (float*)f[17];
  }
  __syncthreads();
  scan_body<EXT>(rec.a, rec.desc, rec.desc_len);
}

constexpr bool SIMPLE = false;

#endif  // K2_SIMPLE

}  // namespace

extern "C" int scan_forward_launch(
    const void* desc, int desc_len, const void* fdesc, const void* G_all,
    const void* cum_all, const void* log_trans, const void* lane_trans,
    const void* stab, const void* itab, const void* bvalid,
    const void* bstop, const void* hw, const void* v0, void* lanes,
    void* largs, void* bp, void* vals, void* v_final, int smem_bytes,
    int ext, void* stream) {
  if (desc_len < D_HEADER) return (int)cudaErrorInvalidValue;
  // ext: the piece takes the deep layout or has pinned states of several
  // candidates (engine/scan.py:_launch_fields), which only the EXT
  // instantiation reads
  auto kernel = ext ? scan_forward_kernel<true> : scan_forward_kernel<false>;
  // the earlier design holds the descriptor (at most MAX_DESC ints of it)
  // and five state vectors
  const int smem = SIMPLE ? (desc_len < MAX_DESC ? desc_len : MAX_DESC) * 4 +
                                MAX_STATES * 4 * 5
                          : smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  a.largs = (int8_t*)largs;
  a.bp = (int*)bp;
  a.vals = (float*)vals;
  a.v_final = (float*)v_final;
  kernel<<<1, K2_THREADS, smem, (cudaStream_t)stream>>>(
      a, (const int*)desc, desc_len);
  return (int)cudaGetLastError();
}

#ifndef K2_SIMPLE
// recs: (P, NFIELDS) int64 on the card, one record per piece (each checked
// by the caller as scan_forward_launch checks its arguments); smem_bytes:
// the most dynamic shared memory of any piece of the batch; ext: any piece
// needs the EXT instantiation.  One block per piece; returns
// cudaGetLastError() (0 when the launch was taken).  The earlier design
// (K2_SIMPLE) has no batched launch.
extern "C" int scan_forward_batch_launch(const void* recs, int P,
                                         int smem_bytes, int ext,
                                         void* stream) {
  if (P < 1) return (int)cudaErrorInvalidValue;
  auto kernel = ext ? scan_forward_batch_kernel<true>
                    : scan_forward_batch_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<P, K2_THREADS, smem_bytes, (cudaStream_t)stream>>>(
      (const long long*)recs);
  return (int)cudaGetLastError();
}
#endif

#ifdef K2_SPLIT
// the shape of the split, (warps, slots)
extern "C" int k2_split_warps() { return K2_WARPS; }
extern "C" int k2_split_slots() { return NSPLIT; }
// the last launch's cycles, (K2_WARPS, NSPLIT) uint64, into host memory dst
extern "C" int k2_split_fetch(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, k2_split, sizeof(k2_split));
}
#endif
