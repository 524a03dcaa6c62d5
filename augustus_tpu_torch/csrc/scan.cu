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
// inside ONE thread block on one SM; the time per position is the latency of
// its slowest state (an exon or UTR convolution at a gated position: up to
// 5,500 band entries for a 3' single UTR) plus two block barriers and the
// lane update.  Bytes and operations are far below the card's rates
// (engine/scan.py:scan_work).
//
// Design (simple and right first; one CTA of K2_THREADS = 512 threads):
// - The work is a table of records (engine/scan.py:_descriptor): one task
//   per chain, fixed-jump, lessD, pinned and convolution state, and the
//   variants and hint records of the convolutions.  Nothing is specialised
//   per model; the descriptor sits in shared memory.
// - Per position: (1) warp w takes tasks w, w + 16, ... and writes each
//   state's value and packed backpointer (pred << 20) | off to shared
//   memory; (2) barrier; the bp row (and with debug the value row) goes to
//   global memory, and thread l < NL updates lane l: the maximum over the S
//   states of vals[s] + lane_trans[l][s], first argmax, in ascending s;
//   (3) barrier.
// - Tie rules as make_scan_fn: chain states and lanes take the first
//   argmax; a lessD window and each convolution band the LAST maximum
//   (ridx = max(where(score == best))); between the variants of one state a
//   strict `>` keeps the earlier variant.  A warp reduces (value, index)
//   pairs with that rule; each lane walks its entries in ascending order.
// - Operand order as the reference: score = ((L + G) + lenvec) [+ quot],
//   then + H once the band's best passes GATE.  The phase one-hot sums of
//   the reference (G = sum_k G3[k] * onehot[k], the framed L and lane arg)
//   are G3[phi] exactly for finite entries and are read as such.  Built with
//   -fmad=false, so no multiply-add is contracted.
// - An unhinted band's entries load their lane value, G and length value
//   unconditionally (the score masks them afterwards), so their loads
//   overlap; a hinted band computes the quotient only for entries whose
//   lane and G pass GATE.
// - Band clipping: a variant reads only the begins b in [smin, smax] (and
//   its vb_lo / vb_hi).  Exact: the reference scores every other entry NEG;
//   such an entry can be the band's last maximum only when no entry passes
//   GATE, and then the variant's value is NEG and `vbest > best` is false,
//   so neither the value nor pred/off comes from it.
// - Convolutions whose end gate is off at j are skipped (lax.cond in the
//   reference): value NEG, pred 0, off 1.
// - Lane history in global memory, lane-major, PAD columns of front padding
//   (lanes[l][j + PAD]); values float32, args int8 as in JAX.  Written by
//   thread l at position j and read back through L1/L2 by later positions of
//   the same block after the barrier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1.0e30f;
constexpr float GATE = -1.0e29f;
constexpr int MAX_STATES = 128;
constexpr int MAX_DESC = 12288;

__device__ __forceinline__ float ninf() { return __int_as_float(0xff800000); }

// descriptor header (engine/scan.py:_descriptor)
enum {
  D_N, D_S, D_NL, D_C, D_PAD, D_GPAD, D_NSC, D_NIC, D_CLS, D_NTASK,
  D_OFF_TASK, D_LW, D_GL, D_CL, D_ML, D_HL, D_HINTED, D_HEADER = 32
};
// task kinds (high 8 bits of a task word; the low 24 bits: record offset)
enum { T_CHAIN, T_FIXED, T_LESSD, T_PINNED, T_CONV };
// record fields
enum { CH_STATE, CH_EMI };
enum { FX_STATE, FX_JUMP, FX_KIND, FX_LANE, FX_EMI, FX_EXTRA };
enum { LD_STATE, LD_LANE, LD_W, LD_CUM, LD_CUMJ, LD_PSI, LD_JSEL, LD_JGATE,
       LD_LV, LD_LI };
enum { PN_STATE, PN_LANE, PN_SCORE, PN_EOP };
enum { CV_STATE, CV_BPL, CV_AOFF, CV_LANE, CV_FMODE, CV_SMIN, CV_SMAX,
       CV_GATE, CV_NVAR, CV_VAR, CV_HINT };
enum { VR_G, VR_H, VR_LO, VR_HI, VR_W, VR_R0, VR_HAS_LO, VR_VB_LO,
       VR_HAS_HI, VR_VB_HI, VR_LV, VR_SIZE };
// hint record: ipo, aL, aR, exclass, 11 window rows, 13 x columns, the
// counts of crossing and exact-match slots, then their (int, scalar, int)
// column triples
enum { HR_IPO, HR_AL, HR_AR, HR_EXCLASS, HR_W, HR_X = HR_W + 11,
       HR_NCROSS = HR_X + 13, HR_NEX, HR_SLOTS };
enum { W_BE_EP, W_BE_CP, W_CNTBE_EP, W_CNTBE_CP, W_CR_EP, W_CR_CP,
       W_CNTCR_EP, W_CNTCR_CP, W_CNTE_EP, W_CNTE_CP, W_ZC };
enum { X_BE_EP, X_BE_CP, X_CNTBE_EP, X_CNTBE_CP, X_C2_EP, X_CNTC2_EP,
       X_CNTE_EP, X_CNTE_CP, X_ZC, X_TX_EP, X_TX_CP, X_TXC_EP, X_TXC_CP };

struct Args {
  const float* fdesc;       // hint_lm[5], then the length vectors
  const float* G_all;       // (NG, C, 3, GL)
  const float* cum_all;     // (NCU, C, CL)
  const float* log_trans;   // (C, S, S) [c][p][s]
  const float* lane_trans;  // (NL, S)
  const float* stab;        // (n, NSC)
  const int* itab;          // (n, NIC)
  const int8_t* bvalid;     // (NLD, ML)
  const int8_t* bstop;      // (NLD, ML)
  const float* hw;          // (NHW, HL)
  const float* v0;          // (S,)
  float* lanes;             // (NL, LW)
  int8_t* largs;            // (NL, LW)
  int* bp;                  // (n, S)
  float* vals;              // (n, S) or null
  float* v_final;           // (S,)
};

// (value, index) warp reductions with the reference's tie rules
__device__ __forceinline__ void warp_first_max(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, o);
    int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov > v || (ov == v && oi >= 0 && (i < 0 || oi < i))) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ void warp_last_max(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, o);
    int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ov > v || (ov == v && oi > i)) { v = ov; i = oi; }
  }
}

// augustus_tpu/engine/scan.py:_hint_quot at one begin b (entry w of a band
// of len_hi), term for term in its operand order
__device__ float hint_quot(const int* h, const float* srow, const int* irow,
                           const float* hw, int HL, int GPAD, const float* lm,
                           int b, int w, int len_hi) {
  const int bob = b - h[HR_IPO];
  const int c1 = GPAD + bob - 1;
  const int* W = h + HR_W;
  const int* X = h + HR_X;
  const int ncross = h[HR_NCROSS], nex = h[HR_NEX];
  const int* cross = h + HR_SLOTS;
  const int* ex = cross + 3 * ncross;
#define WR(k, col) hw[(size_t)W[k] * HL + (col)]
  float cov_ep = srow[X[X_TX_EP]], cov_cp = srow[X[X_TX_CP]];
  float covc_ep = srow[X[X_TXC_EP]], covc_cp = srow[X[X_TXC_CP]];
  for (int k = 0; k < ncross; ++k) {
    const int sk = irow[cross[3 * k]], fl = irow[cross[3 * k + 2]];
    const float wk = srow[cross[3 * k + 1]];
    const float sub = sk >= bob ? 1.0f : 0.0f;
    cov_ep = cov_ep - (fl == 1 ? wk : 0.0f) * sub;
    covc_ep = covc_ep - (fl == 1 ? 1.0f : 0.0f) * sub;
    cov_cp = cov_cp - (fl == 2 ? wk : 0.0f) * sub;
    covc_cp = covc_cp - (fl == 2 ? 1.0f : 0.0f) * sub;
  }
  const float crw_ep = WR(W_CR_EP, c1 + 1);
  const float inside_ep =
      ((srow[X[X_BE_EP]] - WR(W_BE_EP, c1)) - crw_ep) + cov_ep;
  const float inside_cp =
      ((srow[X[X_BE_CP]] - WR(W_BE_CP, c1)) - WR(W_CR_CP, c1 + 1)) + cov_cp;
  const float ccw_ep = WR(W_CNTCR_EP, c1 + 1);
  const float cin_ep =
      ((srow[X[X_CNTBE_EP]] - WR(W_CNTBE_EP, c1)) - ccw_ep) + covc_ep;
  const float cin_cp = ((srow[X[X_CNTBE_CP]] - WR(W_CNTBE_CP, c1)) -
                        WR(W_CNTCR_CP, c1 + 1)) + covc_cp;
  float part_bonus = inside_ep + inside_cp;
  float nep = cin_ep + cin_cp;
  if (h[HR_AL]) {
    part_bonus = part_bonus + 0.5f * (crw_ep - cov_ep);
    nep = nep + (ccw_ep - covc_ep);
  }
  if (h[HR_AR]) {
    part_bonus = part_bonus + 0.5f * (srow[X[X_C2_EP]] - cov_ep);
    nep = nep + (srow[X[X_CNTC2_EP]] - covc_ep);
  }
  float quot = part_bonus;
  float sup_ex = 0.0f, sup_cds = 0.0f;
  const int exclass = h[HR_EXCLASS];
  for (int k = 0; k < nex; ++k) {
    const int pk = irow[ex[3 * k]], kd = irow[ex[3 * k + 2]];
    const float wk = srow[ex[3 * k + 1]];
    float cond = (bob == pk && kd == 1) ? 1.0f : 0.0f;
    quot = quot + wk * cond;
    sup_cds = fmaxf(sup_cds, cond);
    if (exclass == 1) {
      cond = (bob == pk && kd == 2) ? 1.0f : 0.0f;
      quot = quot + wk * cond;
      sup_ex = fmaxf(sup_ex, cond);
    } else if (exclass == 3) {
      cond = (pk < bob && kd == 3 && pk > -(1 << 29)) ? 1.0f : 0.0f;
      quot = quot + (0.5f * wk) * cond;
      sup_ex = fmaxf(sup_ex, cond);
    }
  }
  if (exclass == 2) {
    for (int k = 0; k < ncross; ++k) {
      const int sk = irow[cross[3 * k]], fl = irow[cross[3 * k + 2]];
      const float wk = srow[cross[3 * k + 1]];
      const float cond = (bob == sk && fl == 4) ? 1.0f : 0.0f;
      quot = quot + (0.5f * wk) * cond;
      sup_ex = fmaxf(sup_ex, cond);
    }
  }
  quot = (quot + lm[2] * (1.0f - sup_ex)) + lm[3] * (1.0f - sup_cds);
  const float lenv = (float)len_hi - (float)w;
  const float d_ep = lenv - (srow[X[X_CNTE_EP]] - WR(W_CNTE_EP, c1));
  const float d_cp = lenv - (srow[X[X_CNTE_CP]] - WR(W_CNTE_CP, c1));
  quot = quot + (d_ep > 0.0f ? d_ep * lm[0] : 0.0f);
  quot = quot + (d_cp > 0.0f ? d_cp * lm[1] : 0.0f);
  const float zc = srow[X[X_ZC]] - WR(W_ZC, c1);
  float lpm = zc > 0.0f ? zc * lm[4] : 0.0f;
  lpm = fmaxf(lpm, -part_bonus);
  return quot + (nep >= 4.5f ? lpm : 0.0f);
#undef WR
}

__global__ void __launch_bounds__(512, 1)
scan_forward_kernel(Args a, const int* __restrict__ desc_g, int desc_len) {
  extern __shared__ int smem[];
  int* desc = smem;
  float* vprev = (float*)(smem + desc_len);
  float* vals = vprev + MAX_STATES;
  int* bps = (int*)(vals + MAX_STATES);
  float* l0 = (float*)(bps + MAX_STATES);
  int* a0 = (int*)(l0 + MAX_STATES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = tid; i < desc_len; i += blockDim.x) desc[i] = desc_g[i];
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
          vals[s] = (sc > GATE && lv > GATE) ? lv + sc : NEG;
          bps[s] = (la << 20) | (j - eop);
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
          const float* G = a.G_all +
              (((size_t)v[VR_G] * C + c) * 3 + phi) * GL + (GPAD + b0);
          const float* lvd = a.fdesc + v[VR_LV];
          float sb = ninf();
          int ridx = -1;
          if (hrec) {
            for (int w = w0 + lane; w <= w1; w += 32) {
              int f = 0;
              if (r0 >= 0)
                f = fmode == 1 ? (r0 + w) % 3 : ((r0 - w) % 3 + 3) % 3;
              const float L = a.lanes[(cl + f) * LW + e0 + w];
              const float g = G[w];
              float sc = NEG;
              if (L > GATE && g > GATE) {
                sc = ((L + g) + lvd[w]) +
                     hint_quot(hrec, srow, irow, a.hw, (int)HL, GPAD, lm,
                               b0 + w, w, len_hi);
              }
              if (sc >= sb) { sb = sc; ridx = w; }
            }
          } else {
            // every entry's three loads are independent of the others and
            // unconditional, so a lane keeps several entries' loads in
            // flight; unrolled 4 times (on an H100: 15.49 s against 16.18 s
            // rolled for the 1.02 Mb tiled UTR piece, bit-equal, 106
            // registers)
#pragma unroll 4
            for (int w = w0 + lane; w <= w1; w += 32) {
              int f = 0;
              if (r0 >= 0)
                f = fmode == 1 ? (r0 + w) % 3 : ((r0 - w) % 3 + 3) % 3;
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
            const int f = r0 < 0 ? 0
                : (fmode == 1 ? (r0 + ridx) % 3 : ((r0 - ridx) % 3 + 3) % 3);
            bpred = a.largs[(cl + f) * LW + e0 + ridx];
            boff = (len_hi - a_off + bpl + 1) - ridx;
          }
        }
        if (lane == 0) {
          vals[s] = best;
          bps[s] = (bpred << 20) | boff;
        }
      }
    }
    __syncthreads();

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
    __syncthreads();
    for (int s = tid; s < S; s += blockDim.x) vprev[s] = vals[s];
    __syncthreads();
  }
  for (int s = tid; s < S; s += blockDim.x) a.v_final[s] = vprev[s];
}

}  // namespace

extern "C" int scan_forward_launch(
    const void* desc, int desc_len, const void* fdesc, const void* G_all,
    const void* cum_all, const void* log_trans, const void* lane_trans,
    const void* stab, const void* itab, const void* bvalid,
    const void* bstop, const void* hw, const void* v0, void* lanes,
    void* largs, void* bp, void* vals, void* v_final, int nthreads,
    void* stream) {
  if (desc_len > MAX_DESC || desc_len < D_HEADER) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = desc_len * 4 + MAX_STATES * 4 * 5;
  cudaError_t err = cudaFuncSetAttribute(
      scan_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  scan_forward_kernel<<<1, nthreads, smem, (cudaStream_t)stream>>>(
      a, (const int*)desc, desc_len);
  return (int)cudaGetLastError();
}
