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
// order inside ONE thread block on one SM.  The time per position is the
// latency of its dependent chain: two block barriers, the slowest state of
// phase A (an exon convolution at a gated position: its clipped band, the
// segmented reduction, with hints the quotient; else a lessD window) and the
// lane update.  Bytes and operations are thousands of times below the card's
// rates (engine/viterbi.py:kernel_work).
//
// Design (one CTA of 768 threads per chunk, a loop over positions; 80
// registers a thread, no spills to speak of; a batch of chunks runs one CTA
// per chunk in one launch, viterbi_forward_batch_launch):
// - Band clipping.  An exon convolution's variant reads only the begins b in
//   [smin, smax]: w in [max(0, smin - b0), min(wd - 1, smax - b0)].  The
//   clipped entries of all variants of a conv form one list, walked by the
//   conv's warp 32 entries at a time; a segmented shuffle reduction gives
//   each variant's last argmax, carrying the lane arg of its entry, and one
//   more reduction over the variants the first variant of the largest
//   value.  The hint quotient (K1.f) runs only on these entries.
//   Exactness: the plain version scores every entry outside [smin, smax]
//   exactly NEGF <= GATE.  Such an entry can be the variant's last argmax
//   only when no entry exceeds GATE; then vbest is NEGF, `vbest > best` is
//   false, and neither the value nor pred/off is taken from it.  Inside the
//   range the scores are the same floats, and a (value, index) maximum with
//   a fixed tie rule is the same under any partition of the entries.
// - Plane rows prefetched.  The rows of sp_state, sp_geo, sp_convH (the
//   lanes in use), ip_conv, ip_misc and, with hints, xh/xi are staged with
//   cp.async (4-byte copies, one per thread) STAGES = 8 positions ahead into
//   a ring in shared memory; position j waits for its group and reads shared
//   memory only.  The b-indexed windows (gcum, msk, hint rows) are
//   prefetched into L2 64 positions ahead.
// - Lane history in global memory, lane-major with W_PAD columns of front
//   padding l0/a0: every lane's value and arg is written once per position
//   and read back through L1/L2 by fixed jumps, lessD windows, pinned
//   states and exon convolutions (up to CONV_CAP = 3040 back).  A ring of
//   the last 64 positions in shared memory was measured and made the full
//   cells 2.2-2.7 % slower (PERF.md), so there is none.
// - Constant tables in shared memory: the lane transitions, every GC
//   class' transitions into the chain states, the lessD length vectors, each
//   variant's first frame and the descriptor.  engine/viterbi.py:smem_layout
//   places them and checks the sum against the 232,448 bytes a block may
//   have.
// - Possible predecessors only.  A lane or chain state takes its maximum
//   over the predecessors p whose transition exceeds POSSIBLE = -5e29, one
//   thread each, in ascending p (the fixtures have at most 2 per lane and 5
//   per chain state).  Exact where it matters: a transition of NEG (-1e30)
//   gives v + NEG <= GATE for any value v below 4e29, so it can be the
//   maximum only when the maximum is <= GATE; such a lane value, or chain
//   value, enters every state only through a `> GATE` test that turns it
//   into NEG, and its arg only into backpointers of states that are not
//   live.  The plain version keeps the dense maximum.
// - vnew/vprev are double-buffered: two barriers per position (after the
//   staged row lands, and between the states and the lane update), no copy.
//
// Exactness: float32 arithmetic in the reference's operand order, compiled
// with -fmad=false so that no multiply of the hint quotient (its only
// multiplies) is contracted into an FMA.  Chain states and the lane update
// take the FIRST argmax, convolutions and lessD the LAST, and between the
// variants of a conv the first of equal values wins.  Gated-off states get
// (NEG, pred 0, off 0) for fixed states and (NEG, 0, 1) for the others; the
// live test is v > -5e29 and is never applied here.

#include "k1_common.cuh"

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
  int n, NGR, NMS, NHW, gw, hs, desc_len, nxh, nxi;
};

__device__ __forceinline__ void reduce_last(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, o);
    const int oi = __shfl_xor_sync(FULL, i, o);
    if (ov > v || (ov == v && oi > i)) { v = ov; i = oi; }
  }
}

// The lane history in global memory, lane-major, at column W_PAD.
struct Hist {
  const float* hv; const int* ha;
  int hs;
  __device__ __forceinline__ float val(int l, int r) const {
    return hv[(size_t)l * hs + r];
  }
  __device__ __forceinline__ int arg(int l, int r) const {
    return ha[(size_t)l * hs + r];
  }
};

// What a conv's band entries need at one gated position.
struct Conv {
  const int* var;          // descriptor rows of the conv's variants
  const int* f0;           // first frame of each variant
  int jb, bpl, cl, fmode, sgn, phi, gw;
  const float* gc;         // gcum of the position's GC class
  const float* lv;         // lv_pack
  const float* sph;        // staged sp_convH row
  // hint quotient (HINTED only)
  const int* hr; const float* X; Slots sl; const int* lmb; const float* hw;
};

// The score of entry w of variant v (its begin b is inside [smin, smax]).
template <bool HINTED>
__device__ __forceinline__ float band_entry(const Conv& cx, const Hist& h,
                                            int v, int w, int& arg) {
  const int* vr = cx.var + v * VAR_W;
  const int len_hi = vr[1];
  const int b = cx.jb - len_hi + w;
  const int f = cx.fmode ? mod3(cx.f0[v] + cx.sgn * w) : 0;
  const float L = h.val(cx.cl + f, b - cx.bpl - 1);
  arg = h.arg(cx.cl + f, b - cx.bpl - 1);
  const int grow = (vr[7] >= 0 && w >= vr[8]) ? vr[7] : vr[4];
  const float G = __ldg(cx.gc + (size_t)(grow + cx.phi) * cx.gw + W_PAD + b);
  float base = (L + G) + __ldg(cx.lv + vr[2] + w);
  if (HINTED) {
    const int bob = b - cx.hr[HR_IPO];
    base = base + hint_quot(cx.hr, cx.X, cx.sl, cx.lmb,
                            cx.hw + W_PAD + bob - 1, cx.gw, bob,
                            (float)len_hi - (float)w);
  }
  if (vr[6] >= 0) {
    const float Hv = cx.sph[vr[6] + w];
    return (L > GATE && G > GATE && Hv > GATE) ? base + Hv : NEGF;
  }
  return (L > GATE && G > GATE) ? base : NEGF;
}

// Walk the `total` clipped entries of a conv's variants, 32 at a time, and
// keep each variant's last argmax (value, w) and the lane arg of its entry
// in accv/acci/acca.  Entries are in variant order, so a chunk's entries
// of one variant sit on consecutive lanes: a segmented shuffle reduction
// leaves the chunk's maximum of each variant on its first lane, which
// merges it into the variant's slot.
template <bool HINTED>
__device__ __forceinline__ void conv_walk(
    const Conv& cx, const Hist& h, int lane, int nv, int total,
    const int* vstart, const int* vlo, float* accv, int* acci, int* acca) {
  for (int base = 0; base < total; base += 32) {
    const int e = base + lane;
    float sv = -INFINITY;
    int si = -1, sa = 0, v = -1;
    if (e < total) {
      v = 0;
      while (v + 1 < nv && vstart[v + 1] <= e) ++v;
      si = vlo[v] + (e - vstart[v]);
      sv = band_entry<HINTED>(cx, h, v, si, sa);
    }
    for (int o = 1; o < 32; o <<= 1) {
      const float ov = __shfl_down_sync(FULL, sv, o);
      const int oi = __shfl_down_sync(FULL, si, o);
      const int oa = __shfl_down_sync(FULL, sa, o);
      const int ok = __shfl_down_sync(FULL, v, o);
      if (lane + o < 32 && ok == v && (ov > sv || (ov == sv && oi > si))) {
        sv = ov;
        si = oi;
        sa = oa;
      }
    }
    const int vup = __shfl_up_sync(FULL, v, 1);
    if (e < total && (lane == 0 || vup != v)) {
      if (sv > accv[v] || (sv == accv[v] && si > acci[v])) {
        accv[v] = sv;
        acci[v] = si;
        acca[v] = sa;
      }
    }
    __syncwarp();
  }
}

// The whole forward pass of one chunk, by one block: the body of both
// kernels below.
__device__ __forceinline__ void forward_body(const Args& a) {
  extern __shared__ __align__(16) int sm[];
  int* desc = sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < a.desc_len; i += NTHREADS) desc[i] = a.desc[i];
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
  const int n_cgroups = (n_chain + 31) / 32;
  const int n_witems = n_conv + n_lessd + n_cgroups;
  const int hs = a.hs;
  const Hist hist = {a.hist_v + W_PAD, a.hist_a + W_PAD, hs};
  const int lvw = desc[H_LVW];

  // ---- constant tables and history padding ----
  for (int i = tid; i < 64 * 64; i += NTHREADS) {
    lt_s[i] = a.lane_tr[i];
  }
  for (int i = tid; i < C * n_chain * 64; i += NTHREADS) {
    const int row = i >> 6, c = row / n_chain, k = row % n_chain;
    ltc_s[row * 64 + (i & 63)] =
        a.ltcT[((size_t)c * 64 + chain[k]) * 64 + (i & 63)];
  }
  for (int i = tid; i < n_lessd * lvw; i += NTHREADS) {
    const int* ld = lessd + (i / lvw) * LESSD_W;
    const int w = i % lvw;
    lvl_s[i] = w < ld[2] ? a.lv_pack[ld[6] + w] : 0.0f;
  }
  for (int k = tid; k < n_conv; k += NTHREADS) {
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
  for (int i = tid; i < 64 * W_PAD; i += NTHREADS) {
    const int l = i / W_PAD, c = i % W_PAD;
    a.hist_v[(size_t)l * hs + c] = a.l0[l];
    a.hist_a[(size_t)l * hs + c] = a.a0[l];
  }
  // state -> thread item: kind << 8 | item (kind 0 none, 1 fixed, 2 pinned)
  if (tid < 64) kind_s[tid] = 0;
  __syncthreads();
  // the possible predecessors of each lane and chain state, ascending
  for (int r = tid; r < 64 + C * n_chain; r += NTHREADS) {
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
  // the thread-item warps: state s = tid - (NTHREADS - 64)
  const int ts = tid - (NTHREADS - 64);
  bool warp_state = false;
  if (ts >= 0) {
    for (int k = 0; k < n_chain; ++k) warp_state |= chain[k] == ts;
    for (int k = 0; k < n_lessd; ++k) warp_state |= lessd[k * LESSD_W] == ts;
    for (int k = 0; k < n_conv; ++k) warp_state |= conv[k * CONV_W] == ts;
  }
  if (tid < 64) {
    vbuf[tid] = a.v0[tid];
    a.bp_out[tid] = 0;
    if (a.val_out) a.val_out[tid] = a.v0[tid];
  }

  // ---- staging of plane rows: one 4-byte cp.async per word of a stage ----
  auto stage_rows = [&](int j) {
    if (j < a.n) {
      float* dst = stage + (j & (STAGES - 1)) * STW;
      for (int t = tid; t < STW; t += NTHREADS) {
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
      const float* lt = lt_s + l * 64;
      float bv = -INFINITY;
      int bi = 0;
      for (int k = 0; k < lpc[l]; ++k) {
        const int p = lpi[l * 64 + k];
        const float x = vcur[p] + lt[p];
        if (x > bv) { bv = x; bi = p; }
      }
      a.hist_v[(size_t)l * hs + W_PAD + j] = bv;
      a.hist_a[(size_t)l * hs + W_PAD + j] = bi;
    }
  };

  for (int k = 1; k < STAGES; ++k) stage_rows(k);
  __syncthreads();
  lane_update(0, vbuf);

  for (int j = 1; j < a.n; ++j) {
    stage_rows(j + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    __syncthreads();
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
    int* bpj = a.bp_out + (size_t)j * 64;
    float* valj = a.val_out ? a.val_out + (size_t)j * 64 : nullptr;

    if (ts >= 0) {
      // thread items: fixed and pinned states, and states nobody owns
      const int s = ts;
      const int kind = kind_s[s] >> 8, item = kind_s[s] & 255;
      float v = NEGF;
      int pr = 0, of = 0;
      if (kind == 1) {
        const int* f = fixed + item * FIXED_W;
        if ((ipm[gate_lane] >> f[5]) & 1) {
          const int r = j - f[4];
          float lv = hist.val(f[1], r);
          int la = hist.arg(f[1], r);
          if (f[3] == 1) {
            lv = lv + spg[s];
          } else if (f[3] == 2) {
            const float lvB = hist.val(f[2], r) + spg[s];
            if (lvB > lv) la = hist.arg(f[2], r);
            lv = fmaxf(lv, lvB);
          }
          const float e = sps[s];
          if (lv > GATE && e > GATE) {
            v = lv + e;
            pr = la;
            of = f[4];
          }
        }
      } else if (kind == 2) {
        const int* p = pinned + item * PINNED_W;
        const float sc = sps[s];
        of = 1;
        if (sc > GATE) {
          const int eop = max(ipm[p[2]], -W_PAD);
          const float lv = hist.val(p[1], eop);
          pr = hist.arg(p[1], eop);
          of = j - ipm[p[2]];
          if (lv > GATE) v = lv + sc;
        }
      }
      if (kind != 0 || !warp_state) {
        vnew[s] = v;
        bpj[s] = (pr << 20) | of;
        if (valj) valj[s] = v;
      }
    } else {
      // warp items: exon convolutions, lessD introns, chain-state groups
      for (int it = warp; it < n_witems; it += ITEM_WARPS) {
        if (it < n_conv) {
          const int* cv = conv + it * CONV_W;
          const int s = cv[0], bpl = cv[1], a_off = cv[2], cl = cv[3];
          const int fmode = cv[4], ipl = cv[5], vbeg = cv[6], nv = cv[7];
          const int gp = ipc[ipl];
          float best = NEGF;
          int bpred = 0, boff = 1;
          if (gp & 1) {
            const int smin = ipc[ipl + 1], smax = ipc[ipl + 2];
            const int* hr = cv[8] >= 0 ? hint + cv[8] : nullptr;
            float* X = reinterpret_cast<float*>(
                sm + desc[H_SM_WARP] + warp * warp_w);
            int* vstart = reinterpret_cast<int*>(X + NX);
            int* vlo = vstart + MAXV + 1;
            float* accv = reinterpret_cast<float*>(vlo + MAXV);
            int* acci = reinterpret_cast<int*>(accv + MAXV);
            int* acca = acci + MAXV;
            int* cs = acca + MAXV;
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
              accv[lane] = -INFINITY;
              acci[lane] = -1;
            }
            int inc = cnt;
            for (int o = 1; o < 32; o <<= 1) {
              const int t = __shfl_up_sync(FULL, inc, o);
              if (lane >= o) inc += t;
            }
            if (lane < nv) vstart[lane] = inc - cnt;
            const int total = __shfl_sync(FULL, inc, 31);
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
            if (hr) {
              conv_walk<true>(cx, hist, lane, nv, total, vstart, vlo, accv,
                              acci, acca);
            } else {
              conv_walk<false>(cx, hist, lane, nv, total, vstart, vlo, accv,
                               acci, acca);
            }
            // each variant's vbest, then the first variant of the largest
            float vb = -INFINITY;
            int wi = 0, wa = 0, vv = 0x7fffffff;
            if (lane < nv) {
              const int* vr = vrow + lane * VAR_W;
              const float bv = accv[lane];
              if (vr[6] >= 0) {
                vb = bv > GATE ? bv : NEGF;
              } else {
                const float H = sph[vr[5]];
                vb = (bv > GATE && H > GATE) ? bv + H : NEGF;
              }
              wi = acci[lane];
              wa = acca[lane];
              vv = lane;
            }
            for (int o = 16; o > 0; o >>= 1) {
              const float ov = __shfl_xor_sync(FULL, vb, o);
              const int ow = __shfl_xor_sync(FULL, wi, o);
              const int oa = __shfl_xor_sync(FULL, wa, o);
              const int ovv = __shfl_xor_sync(FULL, vv, o);
              if (ov > vb || (ov == vb && ovv < vv)) {
                vb = ov;
                wi = ow;
                wa = oa;
                vv = ovv;
              }
            }
            if (vb > best) {
              best = vb;
              bpred = wa;
              boff = (vrow[vv * VAR_W + 1] - a_off + bpl + 1) - wi;
            }
            __syncwarp();
          }
          if (lane == 0) {
            vnew[s] = best;
            bpj[s] = (bpred << 20) | boff;
            if (valj) valj[s] = best;
          }
        } else if (it < n_conv + n_lessd) {
          const int k = it - n_conv;
          const int* ld = lessd + k * LESSD_W;
          const int s = ld[0], ll = ld[1], W5 = ld[2];
          const float psi = sps[s];
          float val = NEGF;
          int pr = 0, of = 1;
          if (psi > GATE) {
            const int r0 = j - W5;                    // eop at widx 0
            const float* crow = gc + (size_t)ld[3] * a.gw + W_PAD;
            const int* vrw = a.msk + (size_t)ld[4] * a.gw + W_PAD;
            const int* srw = a.msk + (size_t)ld[5] * a.gw + W_PAD;
            const float* lvd = lvl_s + k * lvw;
            const int jsel = ipm[ld[7]];
            const float cumj = __ldg(crow + j);
            float bv = -INFINITY;
            int bi = -1;
            for (int w = lane; w < W5; w += 32) {
              const int r = r0 + w;
              const float Lsh = hist.val(ll, r);
              const float seg = cumj - __ldg(crow + r);
              const bool ok = r >= 0 && __ldg(vrw + r) != 0 &&
                              (__ldg(srw + r) & jsel) == 0;
              const float sc = (ok && Lsh > GATE)
                               ? ((Lsh + seg) + lvd[w]) + psi : NEGF;
              if (sc >= bv) { bv = sc; bi = w; }
            }
            reduce_last(bv, bi);
            pr = hist.arg(ll, r0 + bi);
            of = W5 - bi;
            val = bv > GATE ? bv : NEGF;
          }
          if (lane == 0) {
            vnew[s] = val;
            bpj[s] = (pr << 20) | of;
            if (valj) valj[s] = val;
          }
        } else {
          const int k = (it - n_conv - n_lessd) * 32 + lane;
          if (k < n_chain) {
            const int row = c * n_chain + k;
            const float* lt = ltc_s + row * 64;
            float bv = -INFINITY;
            int bi = 0;
            for (int q = 0; q < chc[row]; ++q) {
              const int p = chi[row * 64 + q];
              const float x = vprev[p] + lt[p];
              if (x > bv) { bv = x; bi = p; }
            }
            const int s = chain[k];
            const float v = bv > GATE ? bv + sps[s] : NEGF;
            vnew[s] = v;
            bpj[s] = (bi << 20) | 1;
            if (valj) valj[s] = v;
          }
        }
      }
    }
    __syncthreads();
    // ---------------- phase B: lane update at position j ----------------
    lane_update(j, vnew);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tid < 64) a.v_final[tid] = vbuf[((a.n - 1) & 1) * 64 + tid];
}

__global__ void __launch_bounds__(NTHREADS, 1)
viterbi_forward_kernel(Args a) {
  forward_body(a);
}

// A batch record: the arguments of viterbi_forward_launch from sp_state to
// nxi, each as one int64 (pointers and ints alike), in that order
// (engine/viterbi.py:_launch_fields).
constexpr int NFIELDS = 31;

__device__ __forceinline__ Args args_of(const long long* f) {
  Args a;
  a.sp_state = (const float*)f[0];
  a.sp_geo = (const float*)f[1];
  a.sp_convH = (const float*)f[2];
  a.ip_conv = (const int*)f[3];
  a.ip_misc = (const int*)f[4];
  a.gcum = (const float*)f[5];
  a.msk = (const int*)f[6];
  a.ltcT = (const float*)f[7];
  a.lane_tr = (const float*)f[8];
  a.lv_pack = (const float*)f[9];
  a.v0 = (const float*)f[10];
  a.l0 = (const float*)f[11];
  a.a0 = (const int*)f[12];
  a.desc = (const int*)f[13];
  a.desc_len = (int)f[14];
  a.hist_v = (float*)f[15];
  a.hist_a = (int*)f[16];
  a.bp_out = (int*)f[17];
  a.val_out = (float*)f[18];
  a.v_final = (float*)f[19];
  a.n = (int)f[20];
  a.NGR = (int)f[21];
  a.NMS = (int)f[22];
  a.NHW = (int)f[23];
  a.gw = (int)f[24];
  a.hs = (int)f[25];
  a.xh = (const float*)f[26];
  a.xi = (const int*)f[27];
  a.hw = (const float*)f[28];
  a.nxh = (int)f[29];
  a.nxi = (int)f[30];
  return a;
}

// One block per chunk of a batch: block b copies record b into shared
// memory and runs the same body as a single launch, so each chunk's bp and
// v_final are those of its own launch.
__global__ void __launch_bounds__(NTHREADS, 1)
viterbi_forward_batch_kernel(const long long* __restrict__ recs) {
  __shared__ Args rec;
  if (threadIdx.x == 0) rec = args_of(recs + (size_t)blockIdx.x * NFIELDS);
  __syncthreads();
  forward_body(rec);
}

}  // namespace

extern "C" int viterbi_forward_launch(
    const void* sp_state, const void* sp_geo, const void* sp_convH,
    const void* ip_conv, const void* ip_misc, const void* gcum,
    const void* msk, const void* ltcT, const void* lane_tr,
    const void* lv_pack, const void* v0, const void* l0, const void* a0,
    const void* desc, int desc_len, void* hist_v, void* hist_a,
    void* bp_out, void* val_out, void* v_final, int n, int NGR, int NMS,
    int NHW, int gw, int hs, const void* xh, const void* xi, const void* hw,
    int nxh, int nxi, int smem_bytes, void* stream) {
  if (desc_len > MAX_DESC || n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      viterbi_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  a.a0 = (const int*)a0;
  a.desc = (const int*)desc;
  a.hist_v = (float*)hist_v;
  a.hist_a = (int*)hist_a;
  a.bp_out = (int*)bp_out;
  a.val_out = (float*)val_out;
  a.v_final = (float*)v_final;
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
  viterbi_forward_kernel<<<1, NTHREADS, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// recs: (P, NFIELDS) int64 on the card, one record per chunk (each checked
// by the caller as viterbi_forward_launch checks its arguments);
// smem_bytes: the most dynamic shared memory of any chunk of the batch.
// One block per chunk; returns cudaGetLastError() (0 when the launch was
// taken).
extern "C" int viterbi_forward_batch_launch(const void* recs, int P,
                                            int smem_bytes, void* stream) {
  if (P < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      viterbi_forward_batch_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  viterbi_forward_batch_kernel<<<P, NTHREADS, smem_bytes,
                                 (cudaStream_t)stream>>>(
      (const long long*)recs);
  return (int)cudaGetLastError();
}
