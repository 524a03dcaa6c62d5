// What the Viterbi kernel (csrc/viterbi.cu, K1) and the forward-table kernel
// (csrc/forward.cu, K3) share: the kernel shape and constants, the layout of
// the descriptor that engine/viterbi.py:_descriptor and smem_layout write
// (a change to a region there needs the same change here), the cp.async
// and L2 prefetch helpers, and the sparse exon/CDS hint quotient K1.f.
// Everything is force-inlined into each kernel.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int W_PAD = 3200;
constexpr int NTHREADS = 768;
constexpr int NWARPS = NTHREADS / 32;
constexpr int ITEM_WARPS = NWARPS - 2;   // the last 2 warps: thread items
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEGF = -1.0e30f;
constexpr float GATE = -1.0e29f;
constexpr int MAX_DESC = 4096;
constexpr int STAGES = 8;                // plane rows staged ahead
constexpr float POSSIBLE = -5.0e29f;     // a transition above it can happen
constexpr int MAXV = 16;                 // variants of one conv
constexpr int PF = 64;                   // L2 prefetch distance (positions)

// descriptor header (written by engine/viterbi.py:_descriptor)
enum {
  H_NCHAIN = 0, H_NFIXED, H_NLESSD, H_NPINNED, H_NCONV,
  H_GATE_LANE, H_CLS_LANE, H_S, H_NL,
  H_OFF_CHAIN, H_OFF_FIXED, H_OFF_LESSD, H_OFF_PINNED, H_OFF_CONV,
  H_OFF_VAR, H_OFF_HINT,
  // shared-memory layout in 4-byte words (engine/viterbi.py:smem_layout)
  H_C, H_LVW, H_SM_LT, H_SM_LTC, H_SM_LVL, H_SM_F0,
  H_SM_VBUF, H_SM_KIND, H_SM_STAGE, H_SM_WARP, H_ST_W, H_ST_IPC, H_ST_IPM,
  H_ST_XH, H_ST_XI, H_WARP_W, H_KC, H_KE, H_SM_LPI, H_SM_LPC, H_SM_CHI,
  H_SM_CHC,
  H_LEN
};
constexpr int ST_SPG = 64, ST_SPH = 128;   // fixed offsets inside a stage
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

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

__device__ __forceinline__ int mod3(int x) { return ((x % 3) + 3) % 3; }

// one position's slots of one hinted conv, in per-warp shared memory
struct Slots {
  const int* cs; const float* cw; const int* cf;
  const int* ep; const float* ew; const int* ek;
};

// The hint quotient of the candidate exon [bob, ebx] of one band entry
// (augustus_tpu scan._hint_quot, term for term).  X: the position's xh
// scalars; lmb: ep, cp, exon, CDS, local-cp log maluses as float bits; hw1:
// the window rows' column of bob - 1.  A crossing slot whose flag is
// neither 1 nor 2 subtracts +0 from the covering sums and is skipped
// (exact).
__device__ __forceinline__ float hint_quot(
    const int* hr, const float* X, const Slots& sl, const int* lmb,
    const float* hw1, int gw, int bob, float lenv) {
#define WR(r, off) __ldg(hw1 + (size_t)hr[HR_W + (r)] * gw + (off))
#define LM(q) __int_as_float(lmb[q])
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
  quot = (quot + LM(2) * (1.0f - sup_ex)) + LM(3) * (1.0f - sup_cds);
  const float d_ep = lenv - (X[X_CNTE_EP] - WR(HW_CNTE_EP, 0));
  const float d_cp = lenv - (X[X_CNTE_CP] - WR(HW_CNTE_CP, 0));
  quot = quot + (d_ep > 0.0f ? d_ep * LM(0) : 0.0f);
  quot = quot + (d_cp > 0.0f ? d_cp * LM(1) : 0.0f);
  const float zc = X[X_ZC] - WR(HW_ZC, 0);
  float lpm = zc > 0.0f ? zc * LM(4) : 0.0f;
  lpm = fmaxf(lpm, -part_bonus);
  return quot + (nep >= 4.5f ? lpm : 0.0f);
#undef WR
#undef LM
}

}  // namespace
