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
// Design: K2's layout (csrc/k2_common.cuh), one CTA of 16 warps, three
// barriers per position.
// - Phase A: the clipped entries of every gated convolution variant and
//   every lessD window of position j form one list of segments, cut into
//   16 near-equal contiguous shares, one per warp.  Lane l of a warp walks
//   entries l, l + 32, ... of its share as runs of one segment, BATCH loads
//   at a time, and keeps a running pair (m, s) over its run: the largest
//   live score and the sum of expf(x - m) over the live scores, s rescaled
//   by expf(m_old - m_new) when m grows (a band's 2,300 entries per warp
//   never overflow and keep their small terms).  The pair is parked in a
//   scratch row of the segment; lane k then merges the 32 parked pairs of
//   the chunk's k-th segment in a fixed order.  A segment inside one share
//   is final; a cut one leaves a pair at each warp that holds a piece of it
//   (FIRST / LAST slots as in K2).  Warp 11 copies the lane history of the
//   fixed and pinned states with cp.async, warp 15 writes the previous
//   position's row.
// - Phase B: groups of 8 lanes per convolution or lessD state (warps 0-10)
//   merge each variant's pieces in ascending share order (M = max m_i,
//   S = sum of s_i expf(m_i - M)), give each variant its value M + logf(S)
//   and the H gate; then one lane takes the variants in their order with
//   the reference's two-term lse2, from NEG.  Warp 11: the fixed states
//   (kind 2 a two-term lse2) and the pinned states; warps 12-15: the
//   segments of position j + 1.
// - Phase C: groups of 4 lanes reduce over the S states: each lane of
//   position j and each chain state of position j + 1, each thread a
//   running pair over a quarter of the states, then the 4 pairs merged.
// - An empty pair is (-inf, 0); a merge of two empty pairs stays empty
//   (no -inf - -inf).
// - Every sum runs in an order that the data fixes (the share cut, the
//   lanes' runs, the skewed merge of parked pairs, ascending shares, the
//   variants' order, the xor-tree of 4 lanes; a merge of two pairs is
//   commutative bit for bit), so two launches on the same piece give the
//   same bits.  Against the reference the sums run in another order: the
//   table agrees within a tolerance, not bit for bit.
// - Operand order of a score as the reference: ((L + G) + lenvec) [+ quot],
//   then + H on the variant's value.  expf / logf (not the intrinsics),
//   built with -fmad=false.
// - Lane history in global memory, lane-major, PAD columns of front padding
//   (lanes[l][j + PAD]); no lane args.

#include "k2_common.cuh"

namespace {

using namespace k2;

struct Args : Tables {
  float* rows;              // (n, S): row j the values of position j >= 1
};

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

__global__ void __launch_bounds__(K2_THREADS, 1)
scan_table_kernel(Args a, const int* __restrict__ desc_g, int desc_len) {
  extern __shared__ int smem[];
  const int* desc = smem;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
  // SP / 4 - 1 (the values' padding is -inf, never live)
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
      float m = ninf(), s = 0.0f;
      if (item < nitems) {
        const float* lt = item < NL ? x.lt_s + item * SP
            : x.ltc_s + ((size_t)irow1[cls_col] * nchain + (item - NL)) * SP;
        const float4* v4 = (const float4*)(vsrc + k * CH);
        const float4* l4 = (const float4*)(lt + k * CH);
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
      const float val = lse_value(m, s);
      if (k == 0 && item < NL) {
        const int c0 = jc == 0 ? 0 : jc + PAD;
        for (int col = c0; col <= jc + PAD; ++col) {
          a.lanes[item * LW + col] = val;
        }
      } else if (k == 0 && item < nitems) {
        const int* r = desc + (x.chain_tasks[item - NL] & 0xFFFFFF);
        vdst[r[CH_STATE]] = val > GATE ? val + srow1[r[CH_EMI]] : NEG;
      }
    }
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
      if (warp == ROW_WARP && j > 1) {
        const float* vp = vbuf + (cur ^ 1) * MAX_STATES;
        for (int s = lane; s < S; s += 32) {
          a.rows[(size_t)(j - 1) * S + s] = vp[s];
        }
      }

      const int T = so[NSEG];
      const int sh0 = share_start(T, warp), sh1 = share_start(T, warp + 1);
      if (sh0 == sh1 && lane == 0) {
        edge_m[2 * warp] = ninf();
        edge_s[2 * warp] = 0.0f;
      }
      const int qa = x.first_segment(so, sh0, sh1, lane);
      float* scr_m = x.scratch + warp * (3 * MAXP * 32);
      float* scr_s = scr_m + MAXP * 32;
      // the share in chunks of at most MAXP segments (the scratch rows)
      for (int qb = qa, e0 = sh0; e0 < sh1; qb += MAXP) {
        const int e1 = qb + MAXP < NSEG ? min(sh1, so[qb + MAXP]) : sh1;
        for (int k = 0; k < MAXP; ++k) {
          scr_m[k * 32 + lane] = ninf();
          scr_s[k * 32 + lane] = 0.0f;
        }
        // lane l walks its entries e0 + l, e0 + l + 32, ... segment by
        // segment, BATCH entries at a time (their loads first, then their
        // scores into the run's pair)
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
#pragma unroll
              for (int u = 0; u < BATCH; ++u) {
                const int w = w0 + 32 * (m + u);
                if (m + u < nrun) {
                  const bool ok = (j - W + w) >= 0 && mv[u] != 0 &&
                                  ((int8_t)ms[u] & jsel) == 0 &&
                                  Lb[u] > GATE;
                  const float sc =
                      ok ? ((Lb[u] + (cumj - cb[u])) + vb[u]) + psi : NEG;
                  lse_push(rm, rs, sc);
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
                      sc = sc + hint_quot(desc + hint, srow, irow, a.hw,
                                          (int)HL, GPAD, lm, b0 + w, w,
                                          len_hi);
                    }
                  }
                  lse_push(rm, rs, sc);
                }
              }
            }
          }
          scr_m[(q - qb) * 32 + lane] = rm;
          scr_s[(q - qb) * 32 + lane] = rs;
          i += 32 * nrun;
        }
        __syncwarp();
        // lane k merges the 32 parked pairs of segment qb + k, if it has
        // entries here (in a skewed order: no two lanes in one bank)
        {
          const int qk = qb + lane;
          int off = 0, end = 0;
          if (lane < MAXP && qk < NSEG) { off = so[qk]; end = so[qk + 1]; }
          const bool has = lane < MAXP && qk < NSEG && off < e1 &&
                           end > off && end > e0;
          if (has) {
            float m = ninf(), s = 0.0f;
            for (int l = 0; l < 32; ++l) {
              const int xi = lane * 32 + ((l + lane) & 31);
              lse_merge(m, s, scr_m[xi], scr_s[xi]);
            }
            // whole: the final pair; else the warp's FIRST or LAST piece
            const int i0 = max(sh0, off), i1 = min(sh1, end);
            const int slot = i0 > off ? 2 * warp : (i1 < end ? 2 * warp + 1
                                                             : -1);
            if (slot < 0) {
              res_m[qk] = m; res_s[qk] = s;
            } else {
              edge_m[slot] = m; edge_s[slot] = s;
            }
            if (i0 == off) x.segwf[qk] = warp;
            if (i1 == end) x.segwl[qk] = warp;
          }
        }
        __syncwarp();
        e0 = e1;
      }
      // row j + 1 and the fixed / pinned history landed; row j + 2 may not
      cp_async_wait<1>();
      __syncthreads();
    }

    // ------- phase B: conv and lessD states, fixed and pinned states, ------
    // -------           the segments of position j + 1                 ------
    if (j > 0 && warp < FP_WARP) {
      // a segment's value: its final pair, or its pieces merged in
      // ascending share order
      auto seg_value = [&](int q) -> float {
        if (so[q + 1] == so[q]) return NEG;
        const int wf = x.segwf[q], wl = x.segwl[q];
        if (wf == wl) return lse_value(res_m[q], res_s[q]);
        float m = edge_m[2 * wf + 1], s = edge_s[2 * wf + 1];
        for (int w = wf + 1; w <= wl; ++w) {
          lse_merge(m, s, edge_m[2 * w], edge_s[2 * w]);
        }
        return lse_value(m, s);
      };
      constexpr int PER_WARP = 32 / COMB_G;
      const int k = lane & (COMB_G - 1);
      for (int base = warp * PER_WARP; base < ncomb;
           base += FP_WARP * PER_WARP) {
        const int item = base + lane / COMB_G;
        const int* r = desc + (x.tasks[min(item, ncomb - 1)] & 0xFFFFFF);
        const bool gated = item < nconv && (irow[r[CV_GATE]] & 1);
        // a conv state: lane k gives variants k, k + 8, ... their values
        if (gated) {
          for (int vi = k; vi < r[CV_NVAR]; vi += COMB_G) {
            const int q = r[CV_SEG] + vi;
            const float sb = seg_value(q);
            const float H = srow[x.segs[q * SG_SIZE + SG_H]];
            var_v[q] = (sb > GATE && H > GATE) ? sb + H : NEG;
          }
        }
        __syncwarp();
        if (k == 0 && item < nconv) {
          // the variants in their order, from NEG
          float best = NEG;
          if (gated) {
            for (int vi = 0; vi < r[CV_NVAR]; ++vi) {
              best = lse2(best, var_v[r[CV_SEG] + vi]);
            }
          }
          vcur[r[CV_STATE]] = best;
        } else if (k == 0 && item < ncomb) {  // a lessD state
          const float lb = seg_value(r[LD_SEG]);
          vcur[r[LD_STATE]] = irow[r[LD_JGATE]] != 0 && lb > GATE ? lb : NEG;
        }
        __syncwarp();
      }
    } else if (j > 0 && warp == FP_WARP) {
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
    __syncthreads();

    // ---------------- phase C: lanes of j, chain states of j + 1 ----------
    reduce_c(j, vcur, vbuf + (cur ^ 1) * MAX_STATES);
    __syncthreads();
  }
  cp_async_wait<0>();
  if (warp == ROW_WARP && n > 1) {
    const float* vl = vbuf + ((n - 1) & 1) * MAX_STATES;
    for (int s = lane; s < S; s += 32) {
      a.rows[(size_t)(n - 1) * S + s] = vl[s];
    }
  }
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
