// Ordered float64 prefix sum over rows, for Hopper (sm_90a).
//
// out[r, 0] = x[r, 0], out[r, i] = out[r, i-1] + x[r, i]: every row is
// added strictly left to right, one double add after the other, so the
// result is the same float64 sum as torch.cumsum on the CPU (the plain
// version, augustus_tpu_torch/engine/xputil.py:prefix_sum_f64_reference)
// and as np.cumsum, the host route's cumulative sums, for every input.  The
// running sum starts at -0.0, the additive identity (-0.0 + x == x for
// every x, -0.0 and +0.0 included).  A parallel scan (torch.cumsum on CUDA,
// a Triton scan) adds in another association and moves single float32
// table entries by an ulp after the final rounding.
//
// Replaces augustus_tpu/engine/xputil.py:DD.cumsum_dd, the compensated
// (double-float32) lax.associative_scan of the TPU's device prep route.
// The H100 computes in float64, so no compensation term is carried.
//
// What bounds it on the card: the order.  Each row is one chain of L
// dependent double adds, so a row of a megabase takes milliseconds however
// the bytes move; the bytes (each input read once, each output written
// once: 16 B per entry) would take microseconds at 3.35 TB/s.  Rows run in
// parallel, one warp each, so the callers hand over every row they can in
// one launch.
//
// Design: a warp owns a row and walks it in tiles of TILE entries.  The 32
// lanes load the next tile into registers (coalesced, 8 doubles a lane)
// while lane 0 runs the adds over the current tile in shared memory; lane 0
// reads GROUP entries into registers before it adds them, so the dependent
// adds do not wait on shared-memory loads (the tile loop is unrolled and
// the next group's loads are issued during the current group's adds).  The
// warp then stores the tile's sums coalesced.  Entries past the row's end
// are zeros that are added and never stored.  No float operation other
// than the ordered adds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;            // rows per block
constexpr int PER_LANE = 8;
constexpr int TILE = 32 * PER_LANE; // entries per tile
constexpr int GROUP = 16;           // entries lane 0 holds in registers

__global__ void __launch_bounds__(32 * WARPS)
prefix_sum_f64_kernel(const double* __restrict__ x, double* __restrict__ out,
                      long long rows, long long L) {
  __shared__ double buf[WARPS][TILE];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= rows) return;
  const double* xr = x + row * L;
  double* orow = out + row * L;
  double* b = buf[warp];

  double reg[PER_LANE];
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const long long i = k * 32 + lane;
    reg[k] = i < L ? xr[i] : 0.0;
  }
  double acc = -0.0;
  for (long long base = 0; base < L; base += TILE) {
    __syncwarp();
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) b[k * 32 + lane] = reg[k];
    __syncwarp();
    // the next tile's loads are in flight during the adds
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const long long i = base + TILE + k * 32 + lane;
      reg[k] = i < L ? xr[i] : 0.0;
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < TILE; g += GROUP) {
        double v[GROUP];
#pragma unroll
        for (int k = 0; k < GROUP; ++k) v[k] = b[g + k];
#pragma unroll
        for (int k = 0; k < GROUP; ++k) {
          acc = acc + v[k];
          v[k] = acc;
        }
#pragma unroll
        for (int k = 0; k < GROUP; ++k) b[g + k] = v[k];
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const long long i = base + k * 32 + lane;
      if (i < L) orow[i] = b[k * 32 + lane];
    }
  }
}

}  // namespace

// x, out: (rows, L) contiguous float64 on the card; launches on `stream`
// and returns cudaGetLastError() (0 when the launch was taken).
extern "C" int prefix_sum_f64_launch(const void* x, void* out, long long rows,
                                     long long L, void* stream) {
  if (rows < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + WARPS - 1) / WARPS;
  prefix_sum_f64_kernel<<<(unsigned)blocks, 32 * WARPS, 0,
                          (cudaStream_t)stream>>>(
      (const double*)x, (double*)out, rows, L);
  return (int)cudaGetLastError();
}
