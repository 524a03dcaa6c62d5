// Semi-Markov Viterbi forward pass of one sequence chunk, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel augustus_tpu/engine/pallas_scan.py:make_kernel
// (pl.pallas_call in build_call) for chunks without sparse exon/CDS hints
// (NHW == 0).  The plain PyTorch version with the same arithmetic is
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
// Exactness: float32 adds in the reference's operand order, compiled with
// -fmad=false (there are no multiplies).  Chain states and the lane update
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
constexpr int MAX_DESC = 2048;

// descriptor header (written by engine/viterbi.py:_descriptor)
enum {
  H_NCHAIN = 0, H_NFIXED, H_NLESSD, H_NPINNED, H_NCONV,
  H_GATE_LANE, H_CLS_LANE, H_S, H_NL,
  H_OFF_CHAIN, H_OFF_FIXED, H_OFF_LESSD, H_OFF_PINNED, H_OFF_CONV,
  H_OFF_VAR, H_LEN
};
constexpr int FIXED_W = 6;   // s, laneA, laneB, kind, jump, gate_bit
constexpr int LESSD_W = 8;   // s, lane, window, cum_row, valid_row,
                             // stop_row, lv_off, jsel_lane
constexpr int PINNED_W = 3;  // s, lane, eop_lane
constexpr int CONV_W = 8;    // s, bpl, a_off, lane, frame_mode, ip_lane,
                             // var_begin, var_count
constexpr int VAR_W = 9;     // width, len_hi, lv_off, fm_off, g3row, h_lane,
                             // hv_base, g2row, g2_from

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
  int n, NGR, gw, hs, desc_len;
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

__global__ void __launch_bounds__(NTHREADS, 1)
viterbi_forward_kernel(Args a) {
  __shared__ int desc[MAX_DESC];
  __shared__ float vprev[64];
  __shared__ float vnew[64];
  __shared__ int pnew[64];
  __shared__ int onew[64];
  __shared__ signed char thread_kind[64];   // 0 none, 1 fixed, 2 pinned
  __shared__ unsigned char thread_item[64];

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
              float bv = -INFINITY;
              int bi = -1;
              for (int w = lane; w < wd; w += 32) {
                const int b = b0 + w;
                const int f = fmode ? mod3(f0 + sgn * w) : 0;
                const float L = a.hist_v[(size_t)(cl + f) * hs + W_PAD + r0 + w];
                const float G = (g2row >= 0 && w >= g2_from) ? G2[w] : G1[w];
                const float base = (L + G) + lvd[w];
                const bool okb = b >= smin && b <= smax;
                float sc;
                if (hv_base >= 0) {
                  const float Hv = sph[hv_base + w];
                  sc = (okb && L > GATE && G > GATE && Hv > GATE)
                       ? base + Hv : NEGF;
                } else {
                  sc = (okb && L > GATE && G > GATE) ? base : NEGF;
                }
                if (sc >= bv) { bv = sc; bi = w; }
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
    int hs, void* stream) {
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
  viterbi_forward_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
