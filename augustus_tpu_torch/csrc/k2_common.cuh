// What the two kernels over the split tables share: the general Viterbi K2
// (csrc/scan.cu) and its logsumexp twin K5 (csrc/scan_lse.cu).
//
// - the constants, the descriptor header and the records of the states,
//   variants, hint records and band segments (engine/scan.py:_descriptor,
//   which writes them; smem_layout places the shared-memory regions);
// - the hint quotient (augustus_tpu/engine/scan.py:_hint_quot) and the
//   frame of a band entry;
// - cp.async helpers;
// - K2Ctx: the descriptor's fields and the shared-memory regions as one
//   kernel reads them, with the band list's arithmetic: the segments of a
//   position (gate, clipping to [smin, smax] and vb_lo / vb_hi, counts,
//   band bases and their prefix; engine/scan.py:segment_counts), a warp's
//   share of it (engine/scan.py:k2_shares) and the first segment of a
//   share; the staging of the scalar and int table rows with cp.async; the
//   lane history that a fixed or pinned state reads.
//
// A change here changes both kernels; engine/scan.py's enums and layout
// must follow (tests/test_torch_scan_split.py checks the arithmetic).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace k2 {

constexpr float NEG = -1.0e30f;
constexpr float GATE = -1.0e29f;
constexpr int MAX_STATES = 128;
constexpr int MAX_DESC = 12288;
constexpr int K2_WARPS = 16;
constexpr int K2_THREADS = K2_WARPS * 32;
constexpr int MAX_SEG = 256;      // segments of the band list (8 per lane)
constexpr int STAGES = 4;         // staged table rows
constexpr unsigned FULL = 0xffffffffu;

// the roles of the warps in the segment design
constexpr int FP_WARP = 11;       // phase B: the fixed and pinned states
constexpr int SEG_WARP = 12;      // phase B: warps 12-15, the next
                                  // position's segments, 2 a thread
constexpr int ROW_WARP = 15;      // phase A: the previous position's rows
constexpr int SEG_THREADS = K2_THREADS - SEG_WARP * 32;
constexpr int COMB_G = 8;         // phase B: lanes per conv / lessD state
constexpr int MAXP = 8;           // phase A: segments of a chunk of a share
constexpr int RED_G = 4;          // phase C: lanes per lane / chain state
constexpr int BATCH = 4;          // band entries a lane loads at once

__device__ __forceinline__ float ninf() { return __int_as_float(0xff800000); }

// descriptor header (engine/scan.py:_descriptor)
enum {
  D_N, D_S, D_NL, D_C, D_PAD, D_GPAD, D_NSC, D_NIC, D_CLS, D_NTASK,
  D_OFF_TASK, D_LW, D_GL, D_CL, D_ML, D_HL, D_HINTED,
  // task counts (tasks: convs, lessD, chain, fixed, pinned, in this order)
  D_NCONV, D_NLESSD, D_NCHAIN, D_NFIXED, D_NPINNED,
  // the segment table: a record of SG_SIZE ints per segment
  D_NSEG, D_OFF_SEG,
  // shared-memory layout in 4-byte words (engine/scan.py:smem_layout)
  D_SM_LT, D_SM_LTC, D_SM_STAGE, D_SM_RW, D_SM_VBUF, D_SM_BPBUF,
  D_SM_SEGOFF, D_SM_SEGW0, D_SM_SEGWF, D_SM_RES, D_SM_EDGE, D_SM_FP,
  D_SM_SEGBASE, D_SM_SCRATCH, D_SM_WORDS,
  // the ints of the descriptor in shared memory (the slot lists of a deep
  // piece stay in global memory past them), the scalar and int columns of
  // a staged row, 1 for the deep layout, the shared memory in bytes
  D_SHARE, D_NSS, D_NIS, D_DEEP, D_BYTES,
  // written by the kernel into its shared copy, 8-byte aligned: the
  // global descriptor and tables, where a deep piece's slots are read
  D_GDESC = 44, D_GSTAB = 46, D_GITAB = 48,
  D_HEADER = 56
};
// task kinds (high 8 bits of a task word; the low 24 bits: record offset)
enum { T_CHAIN, T_FIXED, T_LESSD, T_PINNED, T_CONV };
// record fields
enum { CH_STATE, CH_EMI };
enum { FX_STATE, FX_JUMP, FX_KIND, FX_LANE, FX_EMI, FX_EXTRA };
enum { LD_STATE, LD_LANE, LD_W, LD_CUM, LD_CUMJ, LD_PSI, LD_JSEL, LD_JGATE,
       LD_LV, LD_LI, LD_SEG };
// PN_X: the int column of the offset of a position's further candidates
// (-1: none at this position; the field -1: none in the piece), PN_XB:
// where the lists start in the float table; a list is [count, then eop and
// score per candidate] (engine/scan.py:_pinned_lists)
enum { PN_STATE, PN_LANE, PN_SCORE, PN_EOP, PN_X, PN_XB };
enum { CV_STATE, CV_BPL, CV_AOFF, CV_LANE, CV_FMODE, CV_SMIN, CV_SMAX,
       CV_GATE, CV_NVAR, CV_VAR, CV_HINT, CV_SEG };
enum { VR_G, VR_H, VR_LO, VR_HI, VR_W, VR_R0, VR_HAS_LO, VR_VB_LO,
       VR_HAS_HI, VR_VB_HI, VR_LV, VR_SIZE };
// hint record: ipo, aL, aR, exclass, 11 window rows, 13 x columns, the
// counts of crossing and exact-match slots, the offset from the record to
// their (int, scalar, int) column triples (one list per distinct list,
// after the segment table), the record's own offset in the descriptor and
// its conv's a_off (hint_quot finds the descriptor and the position j
// from them)
enum { HR_IPO, HR_AL, HR_AR, HR_EXCLASS, HR_W, HR_X = HR_W + 11,
       HR_NCROSS = HR_X + 13, HR_NEX, HR_SLOTS, HR_OFF, HR_AOFF };
enum { W_BE_EP, W_BE_CP, W_CNTBE_EP, W_CNTBE_CP, W_CR_EP, W_CR_CP,
       W_CNTCR_EP, W_CNTCR_CP, W_CNTE_EP, W_CNTE_CP, W_ZC };
enum { X_BE_EP, X_BE_CP, X_CNTBE_EP, X_CNTBE_CP, X_C2_EP, X_CNTC2_EP,
       X_CNTE_EP, X_CNTE_CP, X_ZC, X_TX_EP, X_TX_CP, X_TXC_EP, X_TXC_CP };
// a segment record of the descriptor (engine/scan.py:_descriptor)
enum { SG_REC, SG_VAR, SG_GATE, SG_SMIN, SG_SMAX, SG_BOFF, SG_VLO, SG_VHI,
       SG_WIDTH, SG_G, SG_LV, SG_R0, SG_FMODE, SG_LANE, SG_EOFF, SG_HINT,
       SG_H, SG_OFFB, SG_SIZE };

// the tables both kernels read
struct Tables {
  const float* fdesc;       // hint_lm[6], then the length vectors
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
  float* lanes;             // (NL, LW) the lane history
};

// augustus_tpu/engine/scan.py:_hint_quot at one begin b (entry w of a band
// of len_hi), term for term in its operand order; exclass 4 is the nc
// model's quotient (augustus_tpu/engine/gold_nc.py:_not_end_part) over the
// nc hint tables (engine/device.py:_nc_hint_tables); out of line, since
// only hinted bands call it
// h: the hint record in the descriptor's shared copy, srow / irow: the
// position's staged rows.  EXT: the kernel may run a deep piece (header
// D_DEEP), whose record is read from the global descriptor (its slot lists
// lie past the shared part) and its columns from the position's global
// rows (their first columns are the staged ones, then the slot columns;
// engine/scan.py:deep_perms), through the pointers the kernel wrote into
// its shared header.  K2 instantiates both (its EXT build only for the
// pieces that need it: the extra registers of the deep branch cost its
// caller spills), K5 the EXT one.
template <bool EXT>
__device__ __noinline__ float hint_quot(const int* h, const float* srow,
                                        const int* irow, const float* hw,
                                        int HL, int GPAD, const float* lm,
                                        int b, int w, int len_hi) {
  if constexpr (EXT) {
    const int* desc = h - h[HR_OFF];
    if (desc[D_DEEP]) {
      const int j = b - w + len_hi - h[HR_AOFF];
      const int off = h[HR_OFF];
      h = *(const int* const*)(desc + D_GDESC) + off;
      srow = *(const float* const*)(desc + D_GSTAB) +
             (size_t)j * desc[D_NSC];
      irow = *(const int* const*)(desc + D_GITAB) +
             (size_t)j * desc[D_NIC];
    }
  }
  const int bob = b - h[HR_IPO];
  const int c1 = GPAD + bob - 1;
  const int* W = h + HR_W;
  const int* X = h + HR_X;
  const int ncross = h[HR_NCROSS], nex = h[HR_NEX];
  const int* cross = h + h[HR_SLOTS];
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
    if (exclass == 1 || exclass == 4) {
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
  if (exclass == 4) {
    // the nc model (gold_nc._not_end_part): no CDS or CDSpart terms, the
    // exonpart local malus lm[5] from one hint inside on, none when it is 1
    quot = quot + lm[2] * (1.0f - sup_ex);
    const float lenv = (float)len_hi - (float)w;
    const float d_ep = lenv - (srow[X[X_CNTE_EP]] - WR(W_CNTE_EP, c1));
    quot = quot + (d_ep > 0.0f ? d_ep * lm[0] : 0.0f);
    if (lm[5] == 0.0f) return quot;
    const float zc = srow[X[X_ZC]] - WR(W_ZC, c1);
    float lpm = zc > 0.0f ? zc * lm[5] : 0.0f;
    lpm = fmaxf(lpm, -part_bonus);
    return quot + (nep >= 0.5f ? lpm : 0.0f);
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

// the further candidates of pinned record fr at the position of irow, or
// null: nc intron hints of one end and several starts
__device__ __forceinline__ const float* pinned_more(const int* fr,
                                                    const int* irow,
                                                    const float* fdesc) {
  if (fr[PN_X] < 0) return nullptr;
  const int x = irow[fr[PN_X]];
  return x < 0 ? nullptr : fdesc + fr[PN_XB] + x;
}

// K2's pinned value with the further candidates m of its position: the
// last maximum of the live ones in candidate order (v, bp in and out); out
// of line, since few pieces have any
__device__ __noinline__ void pinned_max(const float* m, const float* lanes,
                                           const int8_t* largs, int l,
                                           size_t LW, int PAD, int j,
                                           float& v, int& bp) {
  const int cnt = (int)m[0];
  for (int k = 0; k < cnt; ++k) {
    const int e = (int)m[1 + 2 * k];
    const float sc = m[2 + 2 * k];
    const size_t row = (size_t)(max(e, -PAD) + PAD);
    const float lv = lanes[l * LW + row];
    const float c = lv + sc;
    if (sc > GATE && lv > GATE && c >= v) {
      v = c;
      bp = ((int)largs[l * LW + row] << 20) | (j - e);
    }
  }
}

__device__ __forceinline__ int frame_of(int r0, int fmode, int w) {
  return r0 < 0 ? 0
      : (fmode == 1 ? (r0 + w) % 3 : ((r0 - w) % 3 + 3) % 3);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The descriptor's fields and the shared-memory regions that both kernels
// of the segment design read (the descriptor is already in shared memory
// at smem), and the band list's arithmetic.
struct K2Ctx {
  const int* desc;
  // NSC / NIC: the tables' widths; a staged row holds their first
  // desc[D_NSS] / desc[D_NIS] columns (all of them but in the deep layout,
  // read from the shared header where they are used: no register more)
  int n, S, NL, SP, PAD, GPAD, NSC, NIC, cls_col, C;
  const int* tasks;
  int nconv, nlessd, nchain, nfixed, npinned, nfp, ncomb, NSEG;
  const int* chain_tasks;
  const int* fp_tasks;
  const int* segs;                  // SG_SIZE ints per segment
  size_t LW, GL, CL, ML, HL;
  float* lt_s;                      // (NL, SP)
  float* ltc_s;                     // (C, nchain, SP)
  float* stage;                     // STAGES rows of RW words
  int RW;
  int* segoff;                      // 2 x (MAX_SEG + 1)
  int* segw0;                       // 2 x MAX_SEG
  int* segwf;                       // MAX_SEG: the first warp of a segment
  int* segwl;                       // MAX_SEG: its last warp
  int* fpw;                         // 4 x MAX_STATES
  long long* segbase;               // 2 x MAX_SEG: the band bases
  float* scratch;                   // the lanes' parked partials

  __device__ __forceinline__ explicit K2Ctx(int* smem) {
    desc = smem;
    n = desc[D_N]; S = desc[D_S]; NL = desc[D_NL];
    SP = (S + 15) & ~15;            // S padded (engine/scan.py:smem_layout)
    PAD = desc[D_PAD]; GPAD = desc[D_GPAD];
    NSC = desc[D_NSC]; NIC = desc[D_NIC]; cls_col = desc[D_CLS];
    C = desc[D_C];
    tasks = desc + desc[D_OFF_TASK];
    nconv = desc[D_NCONV]; nlessd = desc[D_NLESSD];
    nchain = desc[D_NCHAIN];
    nfixed = desc[D_NFIXED]; npinned = desc[D_NPINNED];
    chain_tasks = tasks + nconv + nlessd;
    fp_tasks = chain_tasks + nchain;
    nfp = nfixed + npinned;
    ncomb = nconv + nlessd;
    NSEG = desc[D_NSEG];
    segs = desc + desc[D_OFF_SEG];
    LW = desc[D_LW]; GL = desc[D_GL]; CL = desc[D_CL];
    ML = desc[D_ML]; HL = desc[D_HL];
    lt_s = (float*)(smem + desc[D_SM_LT]);
    ltc_s = (float*)(smem + desc[D_SM_LTC]);
    stage = (float*)(smem + desc[D_SM_STAGE]);
    RW = desc[D_SM_RW];
    segoff = smem + desc[D_SM_SEGOFF];
    segw0 = smem + desc[D_SM_SEGW0];
    segwf = smem + desc[D_SM_SEGWF];
    segwl = segwf + MAX_SEG;
    fpw = smem + desc[D_SM_FP];
    segbase = (long long*)(smem + desc[D_SM_SEGBASE]);
    scratch = (float*)(smem + desc[D_SM_SCRATCH]);
  }

  // the staged scalar row of position r (its int row follows at
  // + desc[D_NSS]).  EXT false: a kernel that runs no deep piece, whose
  // staged rows hold all NSC + NIC columns (K2's other instantiation)
  __device__ __forceinline__ const float* srow_of(int r) const {
    return stage + (r & (STAGES - 1)) * RW;
  }
  template <bool EXT = true>
  __device__ __forceinline__ const int* irow_of(int r) const {
    return (const int*)(srow_of(r) + (EXT ? desc[D_NSS] : NSC));
  }

  // row r of the scalar and int tables into its slot (one commit group)
  template <bool EXT = true>
  __device__ __forceinline__ void stage_row(int r, const Tables& a,
                                            int tid) const {
    if (r < n) {
      float* dst = stage + (r & (STAGES - 1)) * RW;
      const int ns = EXT ? desc[D_NSS] : NSC, ni = EXT ? desc[D_NIS] : NIC;
      for (int i = tid; i < ns + ni; i += K2_THREADS) {
        if (i < ns) cp_async4(dst + i, a.stab + (size_t)r * NSC + i);
        else cp_async4(dst + i, a.itab + (size_t)r * NIC + (i - ns));
      }
    }
    cp_async_commit();
  }

  // the lane history that fixed / pinned state t reads at position j:
  // (index of the value of its lane, index of the second lane's or -1)
  __device__ __forceinline__ int2 fp_at(int t, int j, const int* irow) const {
    const int* fr = desc + (fp_tasks[t] & 0xFFFFFF);
    if (t < nfixed) {
      const int l = fr[FX_LANE], col = j - fr[FX_JUMP] + PAD;
      return make_int2(l * (int)LW + col,
                       fr[FX_KIND] == 2 ? (l + 1) * (int)LW + col : -1);
    }
    const int eop = irow[fr[PN_EOP]];
    return make_int2(fr[PN_LANE] * (int)LW + max(eop, -PAD) + PAD, -1);
  }

  // the segments of position jn: counts, clipped starts, band bases and
  // the counts' exclusive prefix into buffer nb; warps SEG_WARP.., thread
  // t takes segments 2t and 2t + 1 (seg_tot: SEG_THREADS / 32 ints of
  // shared memory)
  template <bool EXT = true>
  __device__ __forceinline__ void seg_counts(int jn, int nb, int tid,
                                             int lane, int warp,
                                             int* seg_tot) const {
    const int* irow1 = irow_of<EXT>(jn);
    int* so = segoff + nb * (MAX_SEG + 1);
    int* sw = segw0 + nb * MAX_SEG;
    long long* sb = segbase + nb * MAX_SEG;
    const int t = tid - SEG_WARP * 32;
    const int c1 = irow1[cls_col];
    int cnt[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int q = 2 * t + u;
      int cq = 0, w0 = 0;
      if (q < NSEG) {
        const int* sg = segs + q * SG_SIZE;
        if (sg[SG_GATE] < 0) {   // a lessD window: cum_all at its start
          const int W = sg[SG_WIDTH];
          cq = W;
          sb[q] = ((long long)desc[sg[SG_REC] + LD_CUM] * C + c1) *
                  (long long)CL + (jn - W + GPAD + 1);
        } else if (irow1[sg[SG_GATE]] & 1) {
          const int b0 = jn + sg[SG_BOFF];
          const int lo = max(irow1[sg[SG_SMIN]], sg[SG_VLO]);
          const int hi = min(irow1[sg[SG_SMAX]], sg[SG_VHI]);
          w0 = max(0, lo - b0);
          cq = max(0, min(sg[SG_WIDTH] - 1, hi - b0) - w0 + 1);
          // G at the variant's begin b0, phase phi(jn), class c(jn)
          sb[q] = (((long long)sg[SG_G] * C + c1) * 3 +
                   (irow1[sg[SG_GATE]] >> 1)) * (long long)GL + GPAD + b0;
        }
        sw[q] = w0;
      }
      cnt[u] = cq;
    }
    const int tot = cnt[0] + cnt[1];
    int incl = tot;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    // add the totals of the segment warps before this one
    if (lane == 31) seg_tot[warp - SEG_WARP] = incl;
    asm volatile("bar.sync 1, %0;" :: "n"(SEG_THREADS) : "memory");
    int off = incl - tot;
    for (int w = 0; w < warp - SEG_WARP; ++w) off += seg_tot[w];
    if (2 * t < NSEG) so[2 * t] = off;
    if (2 * t + 1 < NSEG) so[2 * t + 1] = off + cnt[0];
    if (t == SEG_THREADS - 1) so[NSEG] = off + tot;
  }

  // the first segment whose end passes sh0 (with so the segment offsets of
  // the position), by chunks of 8, then in it; the whole warp calls it
  __device__ __forceinline__ int first_segment(const int* so, int sh0,
                                               int sh1, int lane) const {
    if (sh0 >= sh1) return 0;
    const int qe = min(lane * 8 + 8, NSEG);
    const unsigned m1 = __ballot_sync(FULL, lane * 8 < NSEG && so[qe] > sh0);
    const int ch = __ffs(m1) - 1;
    const int q2 = ch * 8 + lane;
    const unsigned m2 =
        __ballot_sync(FULL, lane < 8 && q2 < NSEG && so[q2 + 1] > sh0);
    return ch * 8 + __ffs(m2) - 1;
  }
};

// after the copy of the descriptor's first D_SHARE ints into smem: where
// hint_quot finds a deep piece's slot lists and columns (one thread)
__device__ __forceinline__ void put_globals(int* smem, const int* desc_g,
                                           const Tables& a) {
  *(const int**)(smem + D_GDESC) = desc_g;
  *(const float**)(smem + D_GSTAB) = a.stab;
  *(const int**)(smem + D_GITAB) = a.itab;
}

// share w of the T entries of a position's band list: entries [T w / 16,
// T (w + 1) / 16) (engine/scan.py:k2_shares)
__device__ __forceinline__ int share_start(int T, int w) {
  return (int)((long long)T * w / K2_WARPS);
}

}  // namespace k2
