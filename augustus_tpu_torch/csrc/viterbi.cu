// Semi-Markov Viterbi forward pass of one sequence chunk, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel augustus_tpu/engine/pallas_scan.py:make_kernel
// (pl.pallas_call in build_call), with its sparse exon/CDS hint quotient
// hint_quot (K1.f, pallas_scan.py:134) for chunks with NHW > 0.  The plain
// PyTorch version with the same arithmetic is
// augustus_tpu_torch/engine/viterbi.py:viterbi_forward_reference.
//
// What bounds it on the card: position j depends on the values of j-1 (and
// of older positions through the lane history), so the n positions run in
// order inside ONE thread block and the chunk uses one SM.  Per position the
// block reads one row of each j-plane (about 3.6 KB in this layout) plus the
// windows of the exon convolutions and lessD introns (up to CONV_CAP = 3040
// positions of lane history, G pool and length vector, from L2).  The
// latency of that dependent chain, not HBM bandwidth, sets the pace.
//
// Design: one CTA per chunk with a loop over positions; a phase in which
// every state computes its value and backpointer (one thread per fixed or
// pinned state, one warp per chain, lessD or exon-convolution state with a
// shuffle reduction for its max and tie rule), a __syncthreads(), the lane
// update (one warp per lane), a second __syncthreads().  The lane history
// that the TPU kept in VMEM (PM/LM, the 128-step flush, the PHL ring) does
// not fit in shared memory here: it lives in global memory, lane-major with
// W_PAD columns of front padding, so window reads are coalesced and stay in
// L2.  The GC class of every position is read from ip_misc, so class
// switches need no per-block schedule.
//
// Hint quotient (K1.f): in a hinted conv every band entry's score gets the
// exonpart/CDSpart/exon/CDS quotient of its candidate exon [bob, ebx] added
// before the gate and the last-argmax.  It reads the position's hint scalars
// (xh/xi rows: cumulative tracks at ebx, the K crossing and K2 exact-match
// slots) once per conv into registers and per-warp shared memory, and per
// band entry up to 11 window rows of `hw` at bob - 1 and bob, row-major like
// gcum so that a warp's reads coalesce.
//
// Exactness: float32 arithmetic in the reference's operand order, compiled
// with -fmad=false so that no multiply of the hint quotient (its only
// multiplies) is contracted into an FMA.  Chain states and the lane update
// take the FIRST argmax, convolutions and lessD the LAST.  Gated-off
// states get (NEG, pred 0, off 0) for fixed states and (NEG, 0, 1) for the
// others; the live test is v > -5e29 and is never applied here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int W_PAD = 3200;
constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEGF = -1.0e30f;
constexpr float GATE = -1.0e29f;
constexpr int MAX_DESC = 4096;
constexpr int MAX_SLOTS = 64;   // crossing / exact-match hint slots per conv

// descriptor header (written by engine/viterbi.py:_descriptor)
enum {
  H_NCHAIN = 0, H_NFIXED, H_NLESSD, H_NPINNED, H_NCONV,
  H_GATE_LANE, H_CLS_LANE, H_S, H_NL,
  H_OFF_CHAIN, H_OFF_FIXED, H_OFF_LESSD, H_OFF_PINNED, H_OFF_CONV,
  H_OFF_VAR, H_OFF_HINT, H_LEN
};
constexpr int FIXED_W = 6;   // s, laneA, laneB, kind, jump, gate_bit
constexpr int LESSD_W = 8;   // s, lane, window, cum_row, valid_row,
                             // stop_row, lv_off, jsel_lane
constexpr int PINNED_W = 3;  // s, lane, eop_lane
constexpr int CONV_W = 9;    // s, bpl, a_off, lane, frame_mode, ip_lane,
                             // var_begin, var_count, hint record or -1
constexpr int VAR_W = 9;     // width, len_hi, lv_off, fm_off, g3row, h_lane,
                             // hv_base, g2row, g2_from

// hint part: 5 float32 log maluses (ep, cp, exon, CDS, local cp) as int
// bits, then one record per hinted conv (engine/viterbi.py:_hint_record)
enum {
  HR_IPO = 0, HR_AL, HR_AR, HR_EXCLASS, HR_K, HR_K2,
  HR_W,                  // 11 window rows, in this order:
  HW_BE_EP = 0, HW_BE_CP, HW_CNTBE_EP, HW_CNTBE_CP, HW_CR_EP, HW_CR_CP,
  HW_CNTCR_EP, HW_CNTCR_CP, HW_CNTE_EP, HW_CNTE_CP, HW_ZC,
  HR_X = HR_W + 11,      // 13 xh lanes, in this order:
  X_BE_EP = 0, X_BE_CP, X_CNTBE_EP, X_CNTBE_CP, X_C2_EP, X_CNTC2_EP,
  X_CNTE_EP, X_CNTE_CP, X_ZC, X_TX_EP, X_TX_CP, X_TXC_EP, X_TXC_CP, NX,
  HR_SLOTS = HR_X + 13   // K x (start, weight, flag), K2 x (pos, w, kind)
};

struct HintSlots {             // one position's slots of one hinted conv
  int cs[MAX_SLOTS]; float cw[MAX_SLOTS]; int cf[MAX_SLOTS];
  int ep[MAX_SLOTS]; float ew[MAX_SLOTS]; int ek[MAX_SLOTS];
};

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
  const float* l0;         // (64,)
  const int* a0;           // (64,)
  const int* desc;
  float* hist_v;           // (64, hs) lane-major lane values
  int* hist_a;             // (64, hs) lane-major lane args
  int* bp_out;             // (n, 64)
  float* val_out;          // (n, 64) or null
  float* v_final;          // (64,)
  const float* xh;         // (n_pad, nxh) hint scalars, or null
  const int* xi;           // (n_pad, nxi) hint ints
  const float* hw;         // (NHW, gw) hint window rows
  int n, NGR, gw, hs, desc_len, nxh, nxi;
};

__device__ __forceinline__ void reduce_first(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(FULL, v, o);
    int oi = __shfl_xor_sync(FULL, i, o);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ void reduce_last(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(FULL, v, o);
    int oi = __shfl_xor_sync(FULL, i, o);
    if (ov > v || (ov == v && oi > i)) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ int mod3(int x) { return ((x % 3) + 3) % 3; }

// The hint quotient of the candidate exon [bob, ebx] of one band entry
// (augustus_tpu scan._hint_quot, term for term).  X: the position's xh
// scalars; lm: ep, cp, exon, CDS, local-cp log maluses; hw1: the window rows'
// column of bob - 1.  A crossing slot whose flag is neither 1 nor 2
// subtracts +0 from the covering sums and is skipped (exact).
__device__ __forceinline__ float hint_quot(
    const int* hr, const float* X, const HintSlots& sl, const float* lm,
    const float* hw1, int gw, int bob, float lenv) {
#define WR(r, off) hw1[(size_t)hr[HR_W + (r)] * gw + (off)]
  const int K = hr[HR_K], K2 = hr[HR_K2], exclass = hr[HR_EXCLASS];
  float cov_ep = X[X_TX_EP], cov_cp = X[X_TX_CP];
  float covc_ep = X[X_TXC_EP], covc_cp = X[X_TXC_CP];
  for (int k = 0; k < K; ++k) {
    const int fl = sl.cf[k];
    if (fl != 1 && fl != 2) continue;
    const float sub = sl.cs[k] >= bob ? 1.0f : 0.0f;
    if (fl == 1) {
      cov_ep = cov_ep - sl.cw[k] * sub;
      covc_ep = covc_ep - sub;
    } else {
      cov_cp = cov_cp - sl.cw[k] * sub;
      covc_cp = covc_cp - sub;
    }
  }
  const float crw_ep = WR(HW_CR_EP, 1);
  const float inside_ep = ((X[X_BE_EP] - WR(HW_BE_EP, 0)) - crw_ep) + cov_ep;
  const float inside_cp =
      ((X[X_BE_CP] - WR(HW_BE_CP, 0)) - WR(HW_CR_CP, 1)) + cov_cp;
  const float ccw_ep = WR(HW_CNTCR_EP, 1);
  const float cin_ep =
      ((X[X_CNTBE_EP] - WR(HW_CNTBE_EP, 0)) - ccw_ep) + covc_ep;
  const float cin_cp =
      ((X[X_CNTBE_CP] - WR(HW_CNTBE_CP, 0)) - WR(HW_CNTCR_CP, 1)) + covc_cp;
  float part_bonus = inside_ep + inside_cp;
  float nep = cin_ep + cin_cp;
  if (hr[HR_AL]) {
    part_bonus = part_bonus + 0.5f * (crw_ep - cov_ep);
    nep = nep + (ccw_ep - covc_ep);
  }
  if (hr[HR_AR]) {
    part_bonus = part_bonus + 0.5f * (X[X_C2_EP] - cov_ep);
    nep = nep + (X[X_CNTC2_EP] - covc_ep);
  }
  float quot = part_bonus, sup_ex = 0.0f, sup_cds = 0.0f;
  for (int k = 0; k < K2; ++k) {
    const int pk = sl.ep[k], kd = sl.ek[k];
    const float wk = sl.ew[k];
    float cond = (bob == pk && kd == 1) ? 1.0f : 0.0f;
    quot = quot + wk * cond;
    sup_cds = fmaxf(sup_cds, cond);
    if (exclass == 1) {
      cond = (bob == pk && kd == 2) ? 1.0f : 0.0f;
      quot = quot + wk * cond;
      sup_ex = fmaxf(sup_ex, cond);
    } else if (exclass == 3) {
      cond = (bob > pk && kd == 3 && pk > -(1 << 29)) ? 1.0f : 0.0f;
      quot = quot + (0.5f * wk) * cond;
      sup_ex = fmaxf(sup_ex, cond);
    }
  }
  if (exclass == 2) {
    for (int k = 0; k < K; ++k) {
      const float cond = (bob == sl.cs[k] && sl.cf[k] == 4) ? 1.0f : 0.0f;
      quot = quot + (0.5f * sl.cw[k]) * cond;
      sup_ex = fmaxf(sup_ex, cond);
    }
  }
  quot = (quot + lm[2] * (1.0f - sup_ex)) + lm[3] * (1.0f - sup_cds);
  const float d_ep = lenv - (X[X_CNTE_EP] - WR(HW_CNTE_EP, 0));
  const float d_cp = lenv - (X[X_CNTE_CP] - WR(HW_CNTE_CP, 0));
  quot = quot + (d_ep > 0.0f ? d_ep * lm[0] : 0.0f);
  quot = quot + (d_cp > 0.0f ? d_cp * lm[1] : 0.0f);
  const float zc = X[X_ZC] - WR(HW_ZC, 0);
  float lpm = zc > 0.0f ? zc * lm[4] : 0.0f;
  lpm = fmaxf(lpm, -part_bonus);
  return quot + (nep >= 4.5f ? lpm : 0.0f);
#undef WR
}

// One variant's band of an exon convolution at one position.
struct Band {
  const float* L;          // lane history of the state's first lane at r0
  int hs, b0, wd, fmode, f0, sgn;
  const float* G1;         // G pool row(s) at b0
  const float* G2;
  int g2row, g2_from;
  const float* lvd;        // reversed length vector
  int smin, smax, hv_base;
  const float* sph;        // conv H lanes of the position
  int len_hi;
};

// This lane's (last) best score and band index over its entries of the
// band; with HINTED each entry's score gets its hint quotient.  The
// unhinted instantiation is the loop of a chunk without sparse hints.
template <bool HINTED>
__device__ __forceinline__ void band_max(
    const Band& bd, int lane, const int* hr, const float* X,
    const HintSlots& sl, const float* lm, const float* hw, int gw,
    float& bv, int& bi) {
  bv = -INFINITY;
  bi = -1;
  for (int w = lane; w < bd.wd; w += 32) {
    const int b = bd.b0 + w;
    const int f = bd.fmode ? mod3(bd.f0 + bd.sgn * w) : 0;
    const float L = bd.L[(size_t)f * bd.hs + w];
    const float G = (bd.g2row >= 0 && w >= bd.g2_from) ? bd.G2[w] : bd.G1[w];
    float base = (L + G) + bd.lvd[w];
    if (HINTED) {
      const int bob = b - hr[HR_IPO];
      base = base + hint_quot(hr, X, sl, lm, hw + W_PAD + bob - 1, gw, bob,
                              (float)bd.len_hi - (float)w);
    }
    const bool okb = b >= bd.smin && b <= bd.smax;
    float sc;
    if (bd.hv_base >= 0) {
      const float Hv = bd.sph[bd.hv_base + w];
      sc = (okb && L > GATE && G > GATE && Hv > GATE) ? base + Hv : NEGF;
    } else {
      sc = (okb && L > GATE && G > GATE) ? base : NEGF;
    }
    if (sc >= bv) { bv = sc; bi = w; }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
viterbi_forward_kernel(Args a) {
  __shared__ int desc[MAX_DESC];
  __shared__ float vprev[64];
  __shared__ float vnew[64];
  __shared__ int pnew[64];
  __shared__ int onew[64];
  __shared__ signed char thread_kind[64];   // 0 none, 1 fixed, 2 pinned
  __shared__ unsigned char thread_item[64];
  __shared__ HintSlots slots[NWARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < a.desc_len; i += NTHREADS) desc[i] = a.desc[i];
  __syncthreads();

  const int n_chain = desc[H_NCHAIN], n_fixed = desc[H_NFIXED];
  const int n_lessd = desc[H_NLESSD], n_pinned = desc[H_NPINNED];
  const int n_conv = desc[H_NCONV];
  const int gate_lane = desc[H_GATE_LANE], cls_lane = desc[H_CLS_LANE];
  const int S = desc[H_S], NL = desc[H_NL];
  const int* chain = desc + desc[H_OFF_CHAIN];
  const int* fixed = desc + desc[H_OFF_FIXED];
  const int* lessd = desc + desc[H_OFF_LESSD];
  const int* pinned = desc + desc[H_OFF_PINNED];
  const int* conv = desc + desc[H_OFF_CONV];
  const int* var = desc + desc[H_OFF_VAR];
  const int* hint = desc + desc[H_OFF_HINT];
  float lm[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (a.hw) {
    for (int q = 0; q < 5; ++q) lm[q] = __int_as_float(hint[q]);
  }
  const int n_witems = n_conv + n_lessd + n_chain;
  const int hs = a.hs;

  // state -> thread item (fixed / pinned / none); warp items own the rest
  if (tid < 64) {
    thread_kind[tid] = 0;
    thread_item[tid] = 0;
  }
  __syncthreads();
  if (tid < n_fixed) {
    thread_kind[fixed[tid * FIXED_W]] = 1;
    thread_item[fixed[tid * FIXED_W]] = (unsigned char)tid;
  } else if (tid >= 64 && tid < 64 + n_pinned) {
    int k = tid - 64;
    thread_kind[pinned[k * PINNED_W]] = 2;
    thread_item[pinned[k * PINNED_W]] = (unsigned char)k;
  }
  __syncthreads();
  bool warp_state = false;
  if (tid < 64) {
    for (int k = 0; k < n_chain; ++k) warp_state |= chain[k] == tid;
    for (int k = 0; k < n_lessd; ++k) warp_state |= lessd[k * LESSD_W] == tid;
    for (int k = 0; k < n_conv; ++k) warp_state |= conv[k * CONV_W] == tid;
  }

  // front padding of the lane history: positions -W_PAD .. -1 hold l0/a0
  for (int i = tid; i < 64 * W_PAD; i += NTHREADS) {
    int l = i / W_PAD, c = i % W_PAD;
    a.hist_v[(size_t)l * hs + c] = a.l0[l];
    a.hist_a[(size_t)l * hs + c] = a.a0[l];
  }
  if (tid < 64) vnew[tid] = a.v0[tid];
  __syncthreads();

  for (int j = 0; j < a.n; ++j) {
    if (j > 0) {
      // ---------------- phase A: every state at position j ----------------
      const float* sps = a.sp_state + (size_t)j * 128;
      const float* spg = a.sp_geo + (size_t)j * 128;
      const float* sph = a.sp_convH + (size_t)j * 256;
      const int* ipm = a.ip_misc + (size_t)j * 128;
      const int* ipc = a.ip_conv + (size_t)j * 128;
      const int c = ipm[cls_lane];
      const float* gc = a.gcum + (size_t)c * a.NGR * a.gw;

      // thread items: fixed and pinned states, and states nobody owns
      if (tid < 64) {
        const int s = tid;
        const int kind = thread_kind[s];
        if (kind == 1) {
          const int* f = fixed + thread_item[s] * FIXED_W;
          float v = NEGF;
          int pr = 0, of = 0;
          if ((ipm[gate_lane] >> f[5]) & 1) {
            const int r = W_PAD + j - f[4];
            float lv = a.hist_v[(size_t)f[1] * hs + r];
            int la = a.hist_a[(size_t)f[1] * hs + r];
            if (f[3] == 1) {
              lv = lv + spg[s];
            } else if (f[3] == 2) {
              const float lvB = a.hist_v[(size_t)f[2] * hs + r] + spg[s];
              if (lvB > lv) la = a.hist_a[(size_t)f[2] * hs + r];
              lv = fmaxf(lv, lvB);
            }
            const float e = sps[s];
            if (lv > GATE && e > GATE) {
              v = lv + e;
              pr = la;
              of = f[4];
            }
          }
          vnew[s] = v; pnew[s] = pr; onew[s] = of;
        } else if (kind == 2) {
          const int* p = pinned + thread_item[s] * PINNED_W;
          const float sc = sps[s];
          float v = NEGF;
          int pr = 0, of = 1;
          if (sc > GATE) {
            const int eop = ipm[p[2]];
            const int r = W_PAD + max(eop, -W_PAD);
            const float lv = a.hist_v[(size_t)p[1] * hs + r];
            pr = a.hist_a[(size_t)p[1] * hs + r];
            of = j - eop;
            if (lv > GATE) v = lv + sc;
          }
          vnew[s] = v; pnew[s] = pr; onew[s] = of;
        } else if (!warp_state) {
          vnew[s] = NEGF; pnew[s] = 0; onew[s] = 0;
        }
      }

      // warp items: exon convolutions, lessD introns, chain states
      for (int it = warp; it < n_witems; it += NWARPS) {
        if (it < n_conv) {
          const int* cv = conv + it * CONV_W;
          const int s = cv[0], bpl = cv[1], a_off = cv[2], cl = cv[3];
          const int fmode = cv[4], ipl = cv[5];
          const int gp = ipc[ipl];
          float best = NEGF;
          int bpred = 0, boff = 1;
          if (gp & 1) {
            const int phi = gp >> 1;
            const int smin = ipc[ipl + 1], smax = ipc[ipl + 2];
            // this position's hint scalars, once per conv
            const int* hr = cv[8] >= 0 ? hint + cv[8] : nullptr;
            float X[NX];
            HintSlots& sl = slots[warp];
            if (hr) {
              const float* xrow = a.xh + (size_t)j * a.nxh;
              const int* irow = a.xi + (size_t)j * a.nxi;
#pragma unroll
              for (int q = 0; q < NX; ++q) {
                X[q] = (hr[HR_AR] || (q != X_C2_EP && q != X_CNTC2_EP))
                       ? xrow[hr[HR_X + q]] : 0.0f;
              }
              const int K = hr[HR_K], K2 = hr[HR_K2];
              const int* cslot = hr + HR_SLOTS;
              const int* eslot = cslot + 3 * K;
              __syncwarp();
              for (int k = lane; k < K; k += 32) {
                sl.cs[k] = irow[cslot[3 * k]];
                sl.cw[k] = xrow[cslot[3 * k + 1]];
                sl.cf[k] = irow[cslot[3 * k + 2]];
              }
              for (int k = lane; k < K2; k += 32) {
                sl.ep[k] = irow[eslot[3 * k]];
                sl.ew[k] = xrow[eslot[3 * k + 1]];
                sl.ek[k] = irow[eslot[3 * k + 2]];
              }
              __syncwarp();
            }
            for (int vi = 0; vi < cv[7]; ++vi) {
              const int* vr = var + (cv[6] + vi) * VAR_W;
              const int wd = vr[0], len_hi = vr[1], lv_off = vr[2];
              const int fm_off = vr[3], g3row = vr[4], h_lane = vr[5];
              const int hv_base = vr[6], g2row = vr[7], g2_from = vr[8];
              const int b0 = j + a_off - len_hi;     // b at widx 0
              const int r0 = b0 - bpl - 1;           // lane position at 0
              int f0 = 0, sgn = 0;
              if (fmode) {
                f0 = a.lv_pack[fm_off] > 0.5f ? 0
                     : (a.lv_pack[fm_off + wd] > 0.5f ? 1 : 2);
                sgn = fmode == 1 ? 1 : -1;
              }
              const float* G1 = gc + (size_t)(g3row + phi) * a.gw + W_PAD + b0;
              const float* G2 = g2row >= 0
                  ? gc + (size_t)(g2row + phi) * a.gw + W_PAD + b0 : G1;
              const float* lvd = a.lv_pack + lv_off;
              const Band bd = {a.hist_v + (size_t)cl * hs + W_PAD + r0, hs,
                               b0, wd, fmode, f0, sgn, G1, G2, g2row, g2_from,
                               lvd, smin, smax, hv_base, sph, len_hi};
              float bv;
              int bi;
              if (hr) {
                band_max<true>(bd, lane, hr, X, sl, lm, a.hw, a.gw, bv, bi);
              } else {
                band_max<false>(bd, lane, hr, X, sl, lm, a.hw, a.gw, bv, bi);
              }
              reduce_last(bv, bi);
              float vbest;
              if (hv_base >= 0) {
                vbest = bv > GATE ? bv : NEGF;
              } else {
                const float H = sph[h_lane];
                vbest = (bv > GATE && H > GATE) ? bv + H : NEGF;
              }
              if (vbest > best) {
                const int f = fmode ? mod3(f0 + sgn * bi) : 0;
                best = vbest;
                bpred = a.hist_a[(size_t)(cl + f) * hs + W_PAD + r0 + bi];
                boff = (len_hi - a_off + bpl + 1) - bi;
              }
            }
          }
          if (lane == 0) { vnew[s] = best; pnew[s] = bpred; onew[s] = boff; }
        } else if (it < n_conv + n_lessd) {
          const int* ld = lessd + (it - n_conv) * LESSD_W;
          const int s = ld[0], ll = ld[1], W5 = ld[2];
          const float psi = sps[s];
          float val = NEGF;
          int pr = 0, of = 1;
          if (psi > GATE) {
            const int r0 = j - W5;                    // eop at widx 0
            const float* crow = gc + (size_t)ld[3] * a.gw + W_PAD;
            const int* vrow = a.msk + (size_t)ld[4] * a.gw + W_PAD;
            const int* srow = a.msk + (size_t)ld[5] * a.gw + W_PAD;
            const float* lvd = a.lv_pack + ld[6];
            const int jsel = ipm[ld[7]];
            const float cumj = crow[j];
            const float* hv = a.hist_v + (size_t)ll * hs + W_PAD;
            float bv = -INFINITY;
            int bi = -1;
            for (int w = lane; w < W5; w += 32) {
              const int r = r0 + w;
              const float Lsh = hv[r];
              const float seg = cumj - crow[r];
              const bool ok = r >= 0 && vrow[r] != 0 && (srow[r] & jsel) == 0;
              const float sc = (ok && Lsh > GATE)
                               ? ((Lsh + seg) + lvd[w]) + psi : NEGF;
              if (sc >= bv) { bv = sc; bi = w; }
            }
            reduce_last(bv, bi);
            pr = a.hist_a[(size_t)ll * hs + W_PAD + r0 + bi];
            of = W5 - bi;
            val = bv > GATE ? bv : NEGF;
          }
          if (lane == 0) { vnew[s] = val; pnew[s] = pr; onew[s] = of; }
        } else {
          const int s = chain[it - n_conv - n_lessd];
          const float* lt = a.ltcT + ((size_t)c * 64 + s) * 64;
          float bv = -INFINITY;
          int bi = 0x7fffffff;
          for (int p = lane; p < S; p += 32) {
            const float x = vprev[p] + lt[p];
            if (x > bv) { bv = x; bi = p; }
          }
          reduce_first(bv, bi);
          if (lane == 0) {
            vnew[s] = bv > GATE ? bv + sps[s] : NEGF;
            pnew[s] = bi;
            onew[s] = 1;
          }
        }
      }
      __syncthreads();
      if (tid < 64) {
        a.bp_out[(size_t)j * 64 + tid] = (pnew[tid] << 20) | onew[tid];
        if (a.val_out) a.val_out[(size_t)j * 64 + tid] = vnew[tid];
      }
    } else if (tid < 64) {
      a.bp_out[tid] = 0;
      if (a.val_out) a.val_out[tid] = vnew[tid];
    }

    // ---------------- phase B: lane update at position j ----------------
    for (int l = warp; l < NL; l += NWARPS) {
      const float* lt = a.lane_tr + l * 64;
      float bv = -INFINITY;
      int bi = 0x7fffffff;
      for (int p = lane; p < S; p += 32) {
        const float x = vnew[p] + lt[p];
        if (x > bv) { bv = x; bi = p; }
      }
      reduce_first(bv, bi);
      if (lane == 0) {
        a.hist_v[(size_t)l * hs + W_PAD + j] = bv;
        a.hist_a[(size_t)l * hs + W_PAD + j] = bi;
      }
    }
    if (tid < 64) vprev[tid] = vnew[tid];
    __syncthreads();
  }
  if (tid < 64) a.v_final[tid] = vprev[tid];
}

}  // namespace

extern "C" int viterbi_forward_launch(
    const void* sp_state, const void* sp_geo, const void* sp_convH,
    const void* ip_conv, const void* ip_misc, const void* gcum,
    const void* msk, const void* ltcT, const void* lane_tr,
    const void* lv_pack, const void* v0, const void* l0, const void* a0,
    const void* desc, int desc_len, void* hist_v, void* hist_a,
    void* bp_out, void* val_out, void* v_final, int n, int NGR, int gw,
    int hs, const void* xh, const void* xi, const void* hw, int nxh, int nxi,
    void* stream) {
  if (desc_len > MAX_DESC || n < 1) return (int)cudaErrorInvalidValue;
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
  a.a0 = (const int*)a0;
  a.desc = (const int*)desc;
  a.hist_v = (float*)hist_v;
  a.hist_a = (int*)hist_a;
  a.bp_out = (int*)bp_out;
  a.val_out = (float*)val_out;
  a.v_final = (float*)v_final;
  a.n = n;
  a.NGR = NGR;
  a.gw = gw;
  a.hs = hs;
  a.desc_len = desc_len;
  a.xh = (const float*)xh;
  a.xi = (const int*)xi;
  a.hw = (const float*)hw;
  a.nxh = nxh;
  a.nxi = nxi;
  viterbi_forward_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
