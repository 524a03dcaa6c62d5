// Semi-Markov forward table (logsumexp) of one sequence chunk, for Hopper
// (sm_90a).
//
// Replaces the JAX package's device forward pass K3,
// augustus_tpu/engine/scan.py:make_forward_fn (a lax.scan over positions),
// with its sparse exon/CDS hint quotient _hint_quot (scan.py:419-500) for
// chunks with NHW > 0.  The plain PyTorch version is
// augustus_tpu_torch/engine/forward.py:forward_reference.
//
// It is the recursion of csrc/viterbi.cu (K1) with every maximum replaced by
// a logsumexp, and no backpointers: it reads the same planes and the same
// descriptor (engine/viterbi.py:_descriptor, smem_layout) and writes the
// values of every position, f (n, 64) float32.  A logsumexp over candidates
// x is the two-pass form of the reference's lse_vec / lse2: m = max(x), then
// s = the sum of expf(x - m) over the x > GATE, then m + logf(s) when
// m > GATE, else NEG.
//
// What bounds it on the card: as for K1, position j depends on the values of
// j-1 and on older lane values, so the n positions run in order inside ONE
// thread block on one SM and the latency of each position's dependent chain
// sets the pace: two block barriers, the slowest item of phase A (a conv's
// band, a lessD window, the fixed and pinned states), then phase B (the
// lane update), each waiting on L2 loads of lane history and on shared
// memory, not on bytes or arithmetic (thousands of times over its
// roofline bound).  A clock64 split of the earlier two-pass design (the
// K3_SPLIT build, chip_smoke.py phase k3_compare) found that the one warp
// of chain states reached the second barrier last in 73 % of positions,
// before the convs (17 %) and the lessD windows (10 %): a logsumexp read
// every candidate twice, through dependent shared-memory loads, and the 80
// registers that 768 threads leave spilled.
//
// Design, one CTA per chunk and a loop over positions as in K1:
// - One read per candidate.  A conv's clipped band entries, a lessD window's
//   entries and a lane's or chain state's predecessor candidates are built
//   once and kept in registers (K3_R, two, K3_LANE_R, K3_CHAIN_R per lane)
//   for both passes of the logsumexp; entries beyond are rebuilt.  Each lane
//   adds the same terms in the same order as the two-pass design, so the
//   table is bit-equal to its (the K3_TWO_PASS build).
// - Loads in flight: a lane issues the loads of all its kept band entries
//   (lane history, gcum, length term, H) before it uses the first, and
//   finds each entry's variant with a cursor that only moves forward; a
//   lessD window's eight loads go out together.
// - Chain states in phase B: they read only the previous position's values,
//   so the chain states of j + 1 are computed beside the lane update of j,
//   on an item warp that phase B leaves idle, from plane rows staged one
//   position earlier (cp.async.wait_group STAGES - 2).
// - 16 warps (K3_WARPS): 128 registers a thread and no spills, where K1's 24
//   warps leave 80; 14 item warps, so a few take a conv and a lessD window.
// - Kept from the two-pass design and K1: band clipping to [smin, smax]
//   (every entry outside scores NEG <= GATE and adds nothing; its maximum
//   could only be <= GATE when every entry is, and then the result is NEG
//   either way),
//   ONE logsumexp over the union of a conv's clipped variant entries, each
//   gated on its own variant's H (the variants' logsumexps and the two-term
//   one between them of scan.py:893-908, in another order), possible
//   predecessors only (a transition of NEG adds nothing), plane rows staged
//   with cp.async, the b-indexed windows prefetched into L2, lane values in
//   global memory, transition tables and descriptor in shared memory.
//
// Compiled with -fmad=false like K1, so that the hint quotient's multiplies
// are not contracted, with expf/logf (not the intrinsics).  The sums run in
// another order than augustus_tpu's, so the result is held to a tolerance,
// not bit for bit (tests/test_torch_forward.py, chip_smoke.py phase
// forward_parity), and bit for bit to the K3_TWO_PASS build.

#include <climits>

#include "k1_common.cuh"

// The shape of the design (measured on full's planes, PERF.md section 6):
// K3_WARPS    warps of the block, the last two for thread items: 16 give
//             128 registers a thread and no spills, where K1's 24 give 80
//             and spill (engine/forward.py names it too)
// K3_R        band entries of a conv kept in registers per lane (32 K3_R
//             per conv and position; the rest are rebuilt)
// K3_CHAIN_R, K3_LANE_R  predecessor candidates kept in registers by a
//             chain state / a lane (pred_lse)
// Built with -DK3_TWO_PASS, the kernel is the earlier two-pass design, the
// yardstick of chip_smoke.py's k3_compare: every band entry, window entry
// and predecessor built twice, chain states in phase A, 24 warps; the same
// bits.
#ifdef K3_TWO_PASS
constexpr int K3_WARPS = 24, K3_CHAIN_R = 0, K3_LANE_R = 0;
#else
constexpr int K3_WARPS = 16, K3_CHAIN_R = 6, K3_LANE_R = 2;
#endif
constexpr int K3_R = 3;
constexpr int K3_NTHREADS = K3_WARPS * 32;
constexpr int K3_ITEM_WARPS = K3_WARPS - 2;

// K3_SPLIT: a measurement build (never the main path's library) that
// stamps clock64() around each part of a position and adds the cycles up
// per warp in shared memory (lane 0 of each warp), copied at the end to
// k3_split and read back by forward_split_fetch.  Slots per warp:
enum {
  SP_STAGE = 0,   // staging of plane rows, cp.async wait
  SP_BAR1,        // the barrier before phase A
  SP_WORK,        // phase A: the warp's items
  SP_BAR2,        // the barrier after phase A
  SP_LANE,        // phase B: the lane update
  SP_ENTRIES,     // clipped entries (conv) or window entries (lessD)
  SP_MAXTOTAL,    // the most clipped entries of a conv at one position
  SP_OVER_R,      // positions with more than 32 K3_R (some rebuilt)
  SP_GATED,       // positions where the item is gated on
  SP_LAST1,       // positions where the warp reached the first barrier last
  SP_LAST2,       // ... the second barrier last
  SP_GAP2,        // and by how many cycles after the one before it
  SP_LOOP,        // the loop over positions
  NSPLIT
};
#ifdef K3_SPLIT
#define SPLIT(...) __VA_ARGS__
// add x to this warp's slot k / stamp the cycles since the last stamp
// (and, before a barrier, the warp's arrival in arr)
#define SPLIT_ADD(k, x) \
  if (lane == 0) split_s[warp * NSPLIT + (k)] += (unsigned long long)(x);
#define STAMP(k) { const long long t_ = clock_ordered(); \
                   SPLIT_ADD(k, t_ - tk); tk = t_; }
#define ARRIVE(k, arr) { const long long t_ = clock_ordered(); \
                         SPLIT_ADD(k, t_ - tk); tk = t_; \
                         if (lane == 0) arr[warp] = t_; }
__device__ unsigned long long k3_split[K3_WARPS * NSPLIT];
// clock64 that the compiler keeps in place among memory operations
__device__ __forceinline__ long long clock_ordered() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
  return t;
}
// one warp: the warp that arrived last (arr: arrival clocks) gets one in
// slot `last` and its lead over the one before it in slot `gap`
__device__ __forceinline__ void split_last(const long long* arr,
                                           unsigned long long* split_s,
                                           int lane, int last, int gap) {
  const long long t = lane < K3_WARPS ? arr[lane] : LLONG_MIN;
  long long mx = t;
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_xor_sync(FULL, mx, o);
    mx = y > mx ? y : mx;
  }
  const int w = __ffs(__ballot_sync(FULL, t == mx)) - 1;
  long long t2 = lane == w ? LLONG_MIN : t;
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_xor_sync(FULL, t2, o);
    t2 = y > t2 ? y : t2;
  }
  if (lane == 0) {
    split_s[w * NSPLIT + last] += 1;
    if (gap >= 0) split_s[w * NSPLIT + gap] += mx - t2;
  }
}
#else
#define SPLIT(...)
#endif

namespace {

struct Args {
  const float* sp_state;   // (n_pad, 128)
  const float* sp_geo;     // (n_pad, 128)
  const float* sp_convH;   // (n_pad, 256)
  const int* ip_conv;      // (n_pad, 128)
  const int* ip_misc;      // (n_pad, 128)
  const float* gcum;       // (C, NGR, gw)
  const int* msk;          // (NMS, gw)
  const float* ltcT;       // (C, 64, 64): [c][s][p]
  const float* lane_tr;    // (64, 64): [l][p]
  const float* lv_pack;    // (LVP,)
  const float* v0;         // (64,)
  const float* l0;         // (64,) initial lane values (logsumexp)
  const int* desc;
  float* hist_v;           // (64, hs) lane-major lane values
  float* f_out;            // (n, 64) forward values
  const float* xh;         // (n_pad, nxh) hint scalars, or null
  const int* xi;           // (n_pad, nxi) hint ints
  const float* hw;         // (NHW, gw) hint window rows
  int n, NGR, NMS, NHW, gw, hs, desc_len, nxh, nxi;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
// expf(x - m) for a live candidate, else 0
__device__ __forceinline__ float term(float x, float m) {
  return x > GATE ? expf(x - m) : 0.0f;
}

// The logsumexp of v[p] + t[p] over the np possible predecessors p =
// pi[0..np) of a lane or chain state, NEG when its maximum is <= GATE (and
// only then is the result <= GATE).  The candidates of the first CR are
// built once and kept in registers; the rest are built in each pass (CR =
// 0: the two-pass design).  The same terms in the same order either way.
template <int CR>
__device__ __forceinline__ float pred_lse(const float* v, const float* t,
                                          const int* pi, int np) {
  float x[CR > 0 ? CR : 1];
  float m = -INFINITY;
#pragma unroll
  for (int q = 0; q < CR; ++q) {
    x[q] = -INFINITY;
    if (q < np) x[q] = v[pi[q]] + t[pi[q]];
    m = fmaxf(m, x[q]);
  }
  for (int q = CR; q < np; ++q) m = fmaxf(m, v[pi[q]] + t[pi[q]]);
  if (!(m > GATE)) return NEGF;
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < CR; ++q) s += term(x[q], m);
  for (int q = CR; q < np; ++q) s += term(v[pi[q]] + t[pi[q]], m);
  return m + logf(s);
}

// What a conv's band entries need at one gated position.
struct Conv {
  const int* var;          // descriptor rows of the conv's variants
  const int* f0;           // first frame of each variant
  int jb, bpl, cl, fmode, sgn, phi, gw, hs;
  const float* hv;         // lane values at column W_PAD
  const float* gc;         // gcum of the position's GC class
  const float* lv;         // lv_pack
  const float* sph;        // staged sp_convH row
  // hint quotient (HINTED only)
  const int* hr; const float* X; Slots sl; const int* lmb; const float* hw;
};

// The candidate of entry w of variant v (its begin b is inside
// [smin, smax]): L + G + length term (+ quotient) + the variant's H, NEG
// unless L, G and H are all > GATE.  Split in two so that a lane can issue
// the loads of several entries before it uses the first: the four loads
// (L: lane history, G: gcum, the length term, H: the staged sp_convH row),
// then the value.
struct Loads { float L, G, lt, H; };

__device__ __forceinline__ Loads entry_loads(const Conv& cx, int v, int w) {
  const int* vr = cx.var + v * VAR_W;
  const int b = cx.jb - vr[1] + w;
  const int f = cx.fmode ? mod3(cx.f0[v] + cx.sgn * w) : 0;
  const int grow = (vr[7] >= 0 && w >= vr[8]) ? vr[7] : vr[4];
  Loads d;
  d.L = cx.hv[(size_t)(cx.cl + f) * cx.hs + b - cx.bpl - 1];
  d.G = __ldg(cx.gc + (size_t)(grow + cx.phi) * cx.gw + W_PAD + b);
  d.lt = __ldg(cx.lv + vr[2] + w);
  d.H = vr[6] >= 0 ? cx.sph[vr[6] + w] : cx.sph[vr[5]];
  return d;
}

template <bool HINTED>
__device__ __forceinline__ float entry_value(const Conv& cx, int v, int w,
                                             const Loads& d) {
  float base = (d.L + d.G) + d.lt;
  if (HINTED) {
    const int len_hi = cx.var[v * VAR_W + 1];
    const int bob = cx.jb - len_hi + w - cx.hr[HR_IPO];
    base = base + hint_quot(cx.hr, cx.X, cx.sl, cx.lmb,
                            cx.hw + W_PAD + bob - 1, cx.gw, bob,
                            (float)len_hi - (float)w);
  }
  return (d.L > GATE && d.G > GATE && d.H > GATE) ? base + d.H : NEGF;
}

template <bool HINTED>
__device__ __forceinline__ float band_entry(const Conv& cx, int v, int w) {
  return entry_value<HINTED>(cx, v, w, entry_loads(cx, v, w));
}

#ifdef K3_TWO_PASS
// The two-pass conv walk, kept as the yardstick of chip_smoke.py's
// k3_compare: the logsumexp over the `total` clipped entries of a conv's
// variants (in variant order; vstart/vlo give each variant's first entry
// and its w), walked 32 at a time, twice, each entry's variant found from
// the first.
template <bool HINTED>
__device__ __forceinline__ float conv_lse(const Conv& cx, int lane, int nv,
                                          int total, const int* vstart,
                                          const int* vlo) {
  float m = -INFINITY;
  for (int e = lane; e < total; e += 32) {
    int v = 0;
    while (v + 1 < nv && vstart[v + 1] <= e) ++v;
    m = fmaxf(m, band_entry<HINTED>(cx, v, vlo[v] + (e - vstart[v])));
  }
  m = warp_max(m);
  if (!(m > GATE)) return NEGF;
  float s = 0.0f;
  for (int e = lane; e < total; e += 32) {
    int v = 0;
    while (v + 1 < nv && vstart[v + 1] <= e) ++v;
    s += term(band_entry<HINTED>(cx, v, vlo[v] + (e - vstart[v])), m);
  }
  return m + logf(warp_sum(s));
}
#else
// The variant of a lane's current entry in a conv's list of clipped
// entries (variant order: vstart/vlo give each variant's first entry and
// its w).  A lane's entries lane + 32 r ascend, so the variant only moves
// forward, and the next variant's start, kept here, is the one compare
// that most entries need.
struct Cursor {
  int v, next, off;        // variant, next variant's first entry, w - e
  const int* vstart; const int* vlo; int nv;
  __device__ __forceinline__ Cursor(const int* vs, const int* vl, int n)
      : v(0), next(n > 1 ? vs[1] : INT_MAX), off(vl[0] - vs[0]), vstart(vs),
        vlo(vl), nv(n) {}
  __device__ __forceinline__ void seek(int e) {
    if (next > e) return;
    do {
      ++v;
      next = v + 1 < nv ? vstart[v + 1] : INT_MAX;
    } while (next <= e);
    off = vlo[v] - vstart[v];
  }
};

// The logsumexp over the `total` clipped entries of a conv's variants: the
// same terms in the same order per lane as the two-pass walks (e = lane,
// lane + 32, ...; maximum, then the sum of expf), so the same bits, but the
// first K3_R entries of each lane are built once, all their loads issued
// before the first is used, and kept in registers for the sum; entries
// past 32 * K3_R are built in each pass.  Warp-uniform result.
template <bool HINTED>
__device__ __forceinline__ float conv_lse(const Conv& cx, int lane, int nv,
                                          int total, const int* vstart,
                                          const int* vlo) {
  Cursor cur(vstart, vlo, nv);
  Loads d[K3_R];
#pragma unroll
  for (int r = 0; r < K3_R; ++r) {
    const int e = lane + 32 * r;
    if (e < total) {
      cur.seek(e);
      d[r] = entry_loads(cx, cur.v, e + cur.off);
    }
  }
  float x[K3_R];
  float m = -INFINITY;
  {
    Cursor c(vstart, vlo, nv);
#pragma unroll
    for (int r = 0; r < K3_R; ++r) {
      const int e = lane + 32 * r;
      x[r] = -INFINITY;             // adds nothing to either pass
      if (e < total) {
        if (HINTED) c.seek(e);
        x[r] = entry_value<HINTED>(cx, c.v, e + c.off, d[r]);
      }
      m = fmaxf(m, x[r]);
    }
  }
  const Cursor tail = cur;
  for (int e = lane + 32 * K3_R; e < total; e += 32) {
    cur.seek(e);
    m = fmaxf(m, band_entry<HINTED>(cx, cur.v, e + cur.off));
  }
  m = warp_max(m);
  if (!(m > GATE)) return NEGF;
  float s = 0.0f;
#pragma unroll
  for (int r = 0; r < K3_R; ++r) s += term(x[r], m);
  cur = tail;
  for (int e = lane + 32 * K3_R; e < total; e += 32) {
    cur.seek(e);
    s += term(band_entry<HINTED>(cx, cur.v, e + cur.off), m);
  }
  return m + logf(warp_sum(s));
}
#endif

__global__ void __launch_bounds__(K3_NTHREADS, 1)
forward_table_kernel(Args a) {
  extern __shared__ __align__(16) int sm[];
  int* desc = sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#ifdef K3_SPLIT
  __shared__ unsigned long long split_s[K3_WARPS * NSPLIT];
  __shared__ long long arr1[K3_WARPS], arr2[K3_WARPS];
  for (int i = tid; i < K3_WARPS * NSPLIT; i += K3_NTHREADS) split_s[i] = 0;
  long long tk = clock_ordered();
#endif
  for (int i = tid; i < a.desc_len; i += K3_NTHREADS) desc[i] = a.desc[i];
  __syncthreads();

  const int n_chain = desc[H_NCHAIN], n_fixed = desc[H_NFIXED];
  const int n_lessd = desc[H_NLESSD], n_pinned = desc[H_NPINNED];
  const int n_conv = desc[H_NCONV];
  const int gate_lane = desc[H_GATE_LANE], cls_lane = desc[H_CLS_LANE];
  const int S = desc[H_S], NL = desc[H_NL], C = desc[H_C];
  const int* chain = desc + desc[H_OFF_CHAIN];
  const int* fixed = desc + desc[H_OFF_FIXED];
  const int* lessd = desc + desc[H_OFF_LESSD];
  const int* pinned = desc + desc[H_OFF_PINNED];
  const int* conv = desc + desc[H_OFF_CONV];
  const int* var = desc + desc[H_OFF_VAR];
  const int* hint = desc + desc[H_OFF_HINT];
  float* lt_s = reinterpret_cast<float*>(sm + desc[H_SM_LT]);
  float* ltc_s = reinterpret_cast<float*>(sm + desc[H_SM_LTC]);
  int* lpi = sm + desc[H_SM_LPI];           // possible predecessors of a
  int* lpc = sm + desc[H_SM_LPC];           // lane, and their count
  int* chi = sm + desc[H_SM_CHI];           // the same for each chain state
  int* chc = sm + desc[H_SM_CHC];           // of each GC class
  float* lvl_s = reinterpret_cast<float*>(sm + desc[H_SM_LVL]);
  int* f0_s = sm + desc[H_SM_F0];
  float* vbuf = reinterpret_cast<float*>(sm + desc[H_SM_VBUF]);
  int* kind_s = sm + desc[H_SM_KIND];
  float* stage = reinterpret_cast<float*>(sm + desc[H_SM_STAGE]);
  const int STW = desc[H_ST_W], o_ipc = desc[H_ST_IPC];
  const int o_ipm = desc[H_ST_IPM], o_xh = desc[H_ST_XH];
  const int o_xi = desc[H_ST_XI];
  const int warp_w = desc[H_WARP_W], KC = desc[H_KC], KE = desc[H_KE];
#ifdef K3_TWO_PASS
  const int n_witems = n_conv + n_lessd + (n_chain + 31) / 32;
#else
  const int n_witems = n_conv + n_lessd;     // chain groups run in phase B
#endif
  const int hs = a.hs;
  const float* hv = a.hist_v + W_PAD;       // lane l, position r: l*hs + r
  const int lvw = desc[H_LVW];

  // ---- constant tables and history padding ----
  for (int i = tid; i < 64 * 64; i += K3_NTHREADS) {
    lt_s[i] = a.lane_tr[i];
  }
  for (int i = tid; i < C * n_chain * 64; i += K3_NTHREADS) {
    const int row = i >> 6, c = row / n_chain, k = row % n_chain;
    ltc_s[row * 64 + (i & 63)] =
        a.ltcT[((size_t)c * 64 + chain[k]) * 64 + (i & 63)];
  }
  for (int i = tid; i < n_lessd * lvw; i += K3_NTHREADS) {
    const int* ld = lessd + (i / lvw) * LESSD_W;
    const int w = i % lvw;
    lvl_s[i] = w < ld[2] ? a.lv_pack[ld[6] + w] : 0.0f;
  }
  for (int k = tid; k < n_conv; k += K3_NTHREADS) {
    const int* cv = conv + k * CONV_W;
    for (int vi = cv[6]; vi < cv[6] + cv[7]; ++vi) {
      const int* vr = var + vi * VAR_W;
      int f0 = 0;
      if (cv[4]) {
        f0 = a.lv_pack[vr[3]] > 0.5f ? 0
             : (a.lv_pack[vr[3] + vr[0]] > 0.5f ? 1 : 2);
      }
      f0_s[vi] = f0;
    }
  }
  for (int i = tid; i < 64 * W_PAD; i += K3_NTHREADS) {
    const int l = i / W_PAD, c = i % W_PAD;
    a.hist_v[(size_t)l * hs + c] = a.l0[l];
  }
  // state -> thread item: kind << 8 | item (kind 0 none, 1 fixed, 2 pinned)
  if (tid < 64) kind_s[tid] = 0;
  __syncthreads();
  // the possible predecessors of each lane and chain state, ascending
  for (int r = tid; r < 64 + C * n_chain; r += K3_NTHREADS) {
    const float* row = r < 64 ? lt_s + r * 64 : ltc_s + (r - 64) * 64;
    int* idx = r < 64 ? lpi + r * 64 : chi + (r - 64) * 64;
    int cnt = 0;
    for (int p = 0; p < S; ++p) {
      if (row[p] > POSSIBLE) idx[cnt++] = p;
    }
    if (r < 64) lpc[r] = cnt; else chc[r - 64] = cnt;
  }
  if (tid < n_fixed) {
    kind_s[fixed[tid * FIXED_W]] = (1 << 8) | tid;
  } else if (tid >= 64 && tid < 64 + n_pinned) {
    kind_s[pinned[(tid - 64) * PINNED_W]] = (2 << 8) | (tid - 64);
  }
  // the thread-item warps: state s = tid - (K3_NTHREADS - 64)
  const int ts = tid - (K3_NTHREADS - 64);
  bool warp_state = false;
  if (ts >= 0) {
    for (int k = 0; k < n_chain; ++k) warp_state |= chain[k] == ts;
    for (int k = 0; k < n_lessd; ++k) warp_state |= lessd[k * LESSD_W] == ts;
    for (int k = 0; k < n_conv; ++k) warp_state |= conv[k * CONV_W] == ts;
  }
  if (tid < 64) {
    vbuf[tid] = a.v0[tid];
    a.f_out[tid] = a.v0[tid];
  }

  // ---- staging of plane rows: one 4-byte cp.async per word of a stage ----
  auto stage_rows = [&](int j) {
    if (j < a.n) {
      float* dst = stage + (j & (STAGES - 1)) * STW;
      for (int t = tid; t < STW; t += K3_NTHREADS) {
        const void* src;
        if (t < ST_SPG) src = a.sp_state + (size_t)j * 128 + t;
        else if (t < ST_SPH) src = a.sp_geo + (size_t)j * 128 + (t - ST_SPG);
        else if (t < o_ipc) src = a.sp_convH + (size_t)j * 256 + (t - ST_SPH);
        else if (t < o_ipm) src = a.ip_conv + (size_t)j * 128 + (t - o_ipc);
        else if (t < o_xh) src = a.ip_misc + (size_t)j * 128 + (t - o_ipm);
        else if (t < o_xi) src = a.xh + (size_t)j * a.nxh + (t - o_xh);
        else src = a.xi + (size_t)j * a.nxi + (t - o_xi);
        cp_async4(dst + t, src);
      }
      // the b-indexed windows' next cache line, once per 32 positions
      const int col = W_PAD + j + PF;
      if ((col & 31) == 0 && col < a.gw) {
        const int ng = C * a.NGR;
        if (tid < ng) {
          prefetch_l2(a.gcum + (size_t)tid * a.gw + col);
        } else if (tid < ng + a.NMS) {
          prefetch_l2(a.msk + (size_t)(tid - ng) * a.gw + col);
        } else if (tid < ng + a.NMS + a.NHW) {
          prefetch_l2(a.hw + (size_t)(tid - ng - a.NMS) * a.gw + col);
        }
      }
    }
    cp_async_commit();
  };

  // ---- lane update at position j from the values vcur ----
  auto lane_update = [&](int j, const float* vcur) {
    if (tid < NL) {
      const int l = tid;
      a.hist_v[(size_t)l * hs + W_PAD + j] =
          pred_lse<K3_LANE_R>(vcur, lt_s + l * 64, lpi + l * 64, lpc[l]);
    }
  };

  // ---- chain state k of GC class c from the values vcur ----
  auto chain_state = [&](int c, int k, const float* vcur, const float* sps,
                         float* vdst, float* fdst) {
    const int row = c * n_chain + k;
    const float r = pred_lse<K3_CHAIN_R>(vcur, ltc_s + row * 64,
                                         chi + row * 64, chc[row]);
    const int s = chain[k];
    const float v = r > GATE ? r + sps[s] : NEGF;
    vdst[s] = v;
    fdst[s] = v;
  };
#ifndef K3_TWO_PASS
  // the chain states of position j + 1, in phase B of position j, on the
  // warps K3_ITEM_WARPS - 1 - g (g: chain group): their rows are staged and
  // visible one position early (cp_async_wait<STAGES - 2>)
  auto chain_ahead = [&](int j, const float* vcur) {
    const int g = K3_ITEM_WARPS - 1 - warp;
    const int k = g * 32 + lane;
    if (j + 1 < a.n && g >= 0 && k < n_chain) {
      const float* row1 = stage + ((j + 1) & (STAGES - 1)) * STW;
      const int* ipm1 = reinterpret_cast<const int*>(row1 + o_ipm);
      chain_state(ipm1[cls_lane], k, vcur, row1,
                  vbuf + ((j + 1) & 1) * 64, a.f_out + (size_t)(j + 1) * 64);
    }
  };
  constexpr int WAIT = STAGES - 2;
#else
  constexpr int WAIT = STAGES - 1;
#endif

  for (int k = 1; k < STAGES; ++k) stage_rows(k);
#ifndef K3_TWO_PASS
  cp_async_wait<WAIT>();
#endif
  __syncthreads();
  lane_update(0, vbuf);
#ifndef K3_TWO_PASS
  chain_ahead(0, vbuf);
#endif
  SPLIT(const long long t_loop = clock_ordered(); tk = t_loop;)

  for (int j = 1; j < a.n; ++j) {
    stage_rows(j + STAGES - 1);
    cp_async_wait<WAIT>();
    SPLIT(ARRIVE(SP_STAGE, arr1))
    __syncthreads();
    SPLIT(STAMP(SP_BAR1)
          if (warp == K3_ITEM_WARPS - 2) {
            split_last(arr1, split_s, lane, SP_LAST1, -1);
          })
    // ---------------- phase A: every state at position j ----------------
    const float* row = stage + (j & (STAGES - 1)) * STW;
    const float* sps = row;
    const float* spg = row + ST_SPG;
    const float* sph = row + ST_SPH;
    const int* ipc = reinterpret_cast<const int*>(row + o_ipc);
    const int* ipm = reinterpret_cast<const int*>(row + o_ipm);
    const float* xrow = row + o_xh;
    const int* irow = reinterpret_cast<const int*>(row + o_xi);
    const int c = ipm[cls_lane];
    const float* gc = a.gcum + (size_t)c * a.NGR * a.gw;
    const float* vprev = vbuf + ((j - 1) & 1) * 64;
    float* vnew = vbuf + (j & 1) * 64;
    float* fj = a.f_out + (size_t)j * 64;

    if (ts >= 0) {
      // thread items: fixed and pinned states, and states nobody owns
      const int s = ts;
      const int kind = kind_s[s] >> 8, item = kind_s[s] & 255;
      float v = NEGF;
      if (kind == 1) {
        const int* f = fixed + item * FIXED_W;
        if ((ipm[gate_lane] >> f[5]) & 1) {
          const int r = j - f[4];
          float lv = hv[(size_t)f[1] * hs + r];
          if (f[3] == 1) {
            lv = lv + spg[s];
          } else if (f[3] == 2) {
            const float lb = hv[(size_t)f[2] * hs + r] + spg[s];
            const float m = fmaxf(lv, lb);
            lv = m > GATE ? m + logf(term(lv, m) + term(lb, m)) : NEGF;
          }
          const float e = sps[s];
          if (lv > GATE && e > GATE) v = lv + e;
        }
      } else if (kind == 2) {
        const int* p = pinned + item * PINNED_W;
        const float sc = sps[s];
        if (sc > GATE) {
          const int eop = max(ipm[p[2]], -W_PAD);
          const float lv = hv[(size_t)p[1] * hs + eop];
          if (lv > GATE) v = lv + sc;
        }
      }
      if (kind != 0 || !warp_state) {
        vnew[s] = v;
        fj[s] = v;
      }
    } else {
      // warp items: exon convolutions, lessD introns, chain-state groups
      for (int it = warp; it < n_witems; it += K3_ITEM_WARPS) {
        if (it < n_conv) {
          const int* cv = conv + it * CONV_W;
          const int s = cv[0], bpl = cv[1], a_off = cv[2], cl = cv[3];
          const int fmode = cv[4], ipl = cv[5], vbeg = cv[6], nv = cv[7];
          const int gp = ipc[ipl];
          float best = NEGF;
          if (gp & 1) {
            const int smin = ipc[ipl + 1], smax = ipc[ipl + 2];
            const int* hr = cv[8] >= 0 ? hint + cv[8] : nullptr;
            // the per-warp region of smem_layout: X, vstart, vlo, three
            // per-variant accumulators of K1 (unused here), the slots
            float* X = reinterpret_cast<float*>(
                sm + desc[H_SM_WARP] + warp * warp_w);
            int* vstart = reinterpret_cast<int*>(X + NX);
            int* vlo = vstart + MAXV + 1;
            int* cs = vlo + 4 * MAXV;
            float* cw = reinterpret_cast<float*>(cs + KC);
            int* cf = reinterpret_cast<int*>(cw + KC);
            int* ep = cf + KC;
            float* ew = reinterpret_cast<float*>(ep + KE);
            int* ek = reinterpret_cast<int*>(ew + KE);
            const int* vrow = var + vbeg * VAR_W;
            // each variant's clipped range of w, on lane v
            int cnt = 0;
            if (lane < nv) {
              const int* vr = vrow + lane * VAR_W;
              const int b0 = j + a_off - vr[1];
              const int lo = max(0, smin - b0);
              const int hi = min(vr[0] - 1, smax - b0);
              cnt = max(hi - lo + 1, 0);
              vlo[lane] = lo;
            }
            int inc = cnt;
            for (int o = 1; o < 32; o <<= 1) {
              const int t = __shfl_up_sync(FULL, inc, o);
              if (lane >= o) inc += t;
            }
            if (lane < nv) vstart[lane] = inc - cnt;
            const int total = __shfl_sync(FULL, inc, 31);
            SPLIT(SPLIT_ADD(SP_ENTRIES, total) SPLIT_ADD(SP_GATED, 1)
                  SPLIT_ADD(SP_OVER_R, total > 32 * K3_R)
                  if (lane == 0 && total > split_s[warp * NSPLIT +
                                                   SP_MAXTOTAL])
                    split_s[warp * NSPLIT + SP_MAXTOTAL] = total;)
            Conv cx;
            cx.var = vrow;
            cx.f0 = f0_s + vbeg;
            cx.jb = j + a_off;
            cx.bpl = bpl;
            cx.cl = cl;
            cx.fmode = fmode;
            cx.sgn = fmode == 1 ? 1 : -1;
            cx.phi = gp >> 1;
            cx.gw = a.gw;
            cx.hs = hs;
            cx.hv = hv;
            cx.gc = gc;
            cx.lv = a.lv_pack;
            cx.sph = sph;
            if (hr) {
              // the position's hint scalars and slots, once per conv
              const int K = hr[HR_K], K2 = hr[HR_K2];
              const int* cslot = hr + HR_SLOTS;
              const int* eslot = cslot + 3 * K;
              if (lane < NX) {
                X[lane] = (hr[HR_AR] || (lane != X_C2_EP &&
                                         lane != X_CNTC2_EP))
                          ? xrow[hr[HR_X + lane]] : 0.0f;
              }
              for (int k = lane; k < K; k += 32) {
                cs[k] = irow[cslot[3 * k]];
                cw[k] = xrow[cslot[3 * k + 1]];
                cf[k] = irow[cslot[3 * k + 2]];
              }
              for (int k = lane; k < K2; k += 32) {
                ep[k] = irow[eslot[3 * k]];
                ew[k] = xrow[eslot[3 * k + 1]];
                ek[k] = irow[eslot[3 * k + 2]];
              }
              cx.hr = hr;
              cx.X = X;
              cx.sl = {cs, cw, cf, ep, ew, ek};
              cx.lmb = hint;
              cx.hw = a.hw;
            }
            __syncwarp();
            best = hr ? conv_lse<true>(cx, lane, nv, total, vstart, vlo)
                      : conv_lse<false>(cx, lane, nv, total, vstart, vlo);
            __syncwarp();
          }
          if (lane == 0) {
            vnew[s] = best;
            fj[s] = best;
          }
        } else if (it < n_conv + n_lessd) {
          const int k = it - n_conv;
          const int* ld = lessd + k * LESSD_W;
          const int s = ld[0], ll = ld[1], W5 = ld[2];
          const float psi = sps[s];
          float val = NEGF;
          if (psi > GATE) {
            SPLIT(SPLIT_ADD(SP_ENTRIES, W5) SPLIT_ADD(SP_GATED, 1))
            const int r0 = j - W5;                    // eop at widx 0
            const float* crow = gc + (size_t)ld[3] * a.gw + W_PAD;
            const int* vrw = a.msk + (size_t)ld[4] * a.gw + W_PAD;
            const int* srw = a.msk + (size_t)ld[5] * a.gw + W_PAD;
            const float* lvd = lvl_s + k * lvw;
            const int jsel = ipm[ld[7]];
            const float cumj = __ldg(crow + j);
            const float* hl = hv + (size_t)ll * hs;
#ifdef K3_TWO_PASS
            auto score = [&](int w) {
              const int r = r0 + w;
              const float Lsh = hl[r];
              const float seg = cumj - __ldg(crow + r);
              const bool ok = r >= 0 && __ldg(vrw + r) != 0 &&
                              (__ldg(srw + r) & jsel) == 0;
              return (ok && Lsh > GATE) ? ((Lsh + seg) + lvd[w]) + psi
                                        : NEGF;
            };
            float m = -INFINITY;
            for (int w = lane; w < W5; w += 32) m = fmaxf(m, score(w));
            m = warp_max(m);
            if (m > GATE) {
              float sum = 0.0f;
              for (int w = lane; w < W5; w += 32) sum += term(score(w), m);
              val = m + logf(warp_sum(sum));
            }
#else
            // entries lane and lane + 32 (W5 <= 64, checked by the
            // wrapper), built once, their eight loads issued together (the
            // front padding of every row makes r < 0 safe to read; an
            // absent entry reads entry W5 - 1's column): an absent entry is
            // -inf and adds nothing, so these are the bits of the two-pass
            // walks
            float x[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const int w = lane + 32 * q;
              const int r = r0 + min(w, W5 - 1);
              const float Lsh = hl[r];
              const float cr = __ldg(crow + r);
              const int vv = __ldg(vrw + r), ss = __ldg(srw + r);
              const bool ok = r >= 0 && vv != 0 && (ss & jsel) == 0;
              x[q] = w >= W5 ? -INFINITY
                   : (ok && Lsh > GATE) ? ((Lsh + (cumj - cr)) + lvd[w]) + psi
                                        : NEGF;
            }
            const float m = warp_max(fmaxf(fmaxf(-INFINITY, x[0]), x[1]));
            if (m > GATE) {
              float sum = 0.0f;
              sum += term(x[0], m);
              sum += term(x[1], m);
              val = m + logf(warp_sum(sum));
            }
#endif
          }
          if (lane == 0) {
            vnew[s] = val;
            fj[s] = val;
          }
        } else {
          const int k = (it - n_conv - n_lessd) * 32 + lane;
          if (k < n_chain) {
            chain_state(c, k, vprev, sps, vnew, fj);
          }
        }
      }
    }
    SPLIT(ARRIVE(SP_WORK, arr2))
    __syncthreads();
    // who reached each barrier last: on a warp with no chain states, the
    // first barrier's arrivals in phase A, the second's in phase B
    SPLIT(STAMP(SP_BAR2)
          if (warp == K3_ITEM_WARPS - 2) {
            split_last(arr2, split_s, lane, SP_LAST2, SP_GAP2);
          })
    // ---------------- phase B: lane update at position j ----------------
    lane_update(j, vnew);
#ifndef K3_TWO_PASS
    chain_ahead(j, vnew);
#endif
    SPLIT(STAMP(SP_LANE))
  }
  cp_async_wait<0>();
#ifdef K3_SPLIT
  SPLIT_ADD(SP_LOOP, clock_ordered() - t_loop)
  __syncthreads();
  for (int i = tid; i < K3_WARPS * NSPLIT; i += K3_NTHREADS) {
    k3_split[i] = split_s[i];
  }
#endif
}

}  // namespace

extern "C" int forward_table_launch(
    const void* sp_state, const void* sp_geo, const void* sp_convH,
    const void* ip_conv, const void* ip_misc, const void* gcum,
    const void* msk, const void* ltcT, const void* lane_tr,
    const void* lv_pack, const void* v0, const void* l0, int desc_len,
    const void* desc, void* hist_v, void* f_out, int n, int NGR, int NMS,
    int NHW, int gw, int hs, const void* xh, const void* xi, const void* hw,
    int nxh, int nxi, int smem_bytes, void* stream) {
  if (desc_len > MAX_DESC || n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      forward_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.sp_state = (const float*)sp_state;
  a.sp_geo = (const float*)sp_geo;
  a.sp_convH = (const float*)sp_convH;
  a.ip_conv = (const int*)ip_conv;
  a.ip_misc = (const int*)ip_misc;
  a.gcum = (const float*)gcum;
  a.msk = (const int*)msk;
  a.ltcT = (const float*)ltcT;
  a.lane_tr = (const float*)lane_tr;
  a.lv_pack = (const float*)lv_pack;
  a.v0 = (const float*)v0;
  a.l0 = (const float*)l0;
  a.desc = (const int*)desc;
  a.hist_v = (float*)hist_v;
  a.f_out = (float*)f_out;
  a.n = n;
  a.NGR = NGR;
  a.NMS = NMS;
  a.NHW = NHW;
  a.gw = gw;
  a.hs = hs;
  a.desc_len = desc_len;
  a.xh = (const float*)xh;
  a.xi = (const int*)xi;
  a.hw = (const float*)hw;
  a.nxh = nxh;
  a.nxi = nxi;
  forward_table_kernel<<<1, K3_NTHREADS, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#ifdef K3_SPLIT
// the shape of the split, (warps, slots)
extern "C" int forward_split_warps() { return K3_WARPS; }
extern "C" int forward_split_slots() { return NSPLIT; }
// the last launch's cycles, (K3_WARPS, NSPLIT) uint64, into host memory dst
extern "C" int forward_split_fetch(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, k3_split, sizeof(k3_split));
}
#endif
