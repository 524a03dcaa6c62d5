// Event-walk Viterbi traceback K4 on the card, for Hopper (sm_90a).
//
// Replaces augustus_tpu/engine/traceback.py:make_event_trace_fn (a
// lax.scan of M steps on the TPU).  The plain PyTorch version with the same
// step is augustus_tpu_torch/engine/traceback.py:event_walk_reference.
//
// The walk starts at base0 in state0 and reads, per step, the packed
// backpointer (pred << 20) | off of the Viterbi kernel's plane bp (row j =
// base j, 64 states).  A state whose backpointer at base b reads off == 1
// and pred == itself (a chain state's per-base self loop) is skipped to
// brk[state][b-1], the last base <= b whose read is not such a self loop
// (torch.cummax along each state's row of the transposed plane, as
// lax.cummax in the reference; base 1 always reads).  Each step emits one event row [run_lo, run_hi, seg_lo,
// seg_hi, state]: the skipped run [b2+1, base] (empty when b2 == base) and
// the read segment [b2-off+1, b2]; then (base, state) = (b2-off, pred).
// A launch stops when base <= 0 or after M events and returns the final
// base, the final state and the count; the wrapper relaunches from that
// base and state into a fresh events buffer until the walk reaches base 0
// (a launch from (base0, state0) continues the walk exactly: each step
// depends on the pair alone).  Rows past count stay as the wrapper zeroed
// them, as the reference's scan emits zeros once the walk is done.
//
// What bounds it on the card: each step depends on the previous one
// through three global loads (bp at base, brk, bp at b2), so the walk is
// one thread's chain of dependent memory latencies, about a microsecond a
// step and 10^3-10^4 steps per megabase; the bytes it touches (12 B a step
// and 20 B an event row) are nothing at 3.35 TB/s.  One thread, one block:
// what it saves is the copy of the (n, 64) plane to the host and the host's
// walk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 64;

__global__ void event_walk_kernel(const int* __restrict__ bp,
                                  const int* __restrict__ brk, int n,
                                  int base0, int state0, int M,
                                  int* __restrict__ events,
                                  int* __restrict__ result) {
  int base = base0;
  int state = state0;
  int count = 0;
  while (count < M && base > 0) {
    const int p = bp[(size_t)base * LANES + state];
    const bool selfrun = base >= 2 && (p & 0xFFFFF) == 1 && (p >> 20) == state;
    const int b2 = selfrun ? brk[(size_t)state * (n - 1) + (base - 1)] : base;
    const int packed = bp[(size_t)b2 * LANES + state];
    const int off = packed & 0xFFFFF;
    const int pred = packed >> 20;
    int* ev = events + (size_t)count * 5;
    ev[0] = b2 + 1;
    ev[1] = base;
    ev[2] = b2 - off + 1;
    ev[3] = b2;
    ev[4] = state;
    base = b2 - off;
    state = pred;
    ++count;
  }
  result[0] = base;
  result[1] = state;
  result[2] = count;
}

}  // namespace

// bp: (n, 64) int32, brk: (64, n-1) int32, events: (M, 5) int32 zeroed,
// result: 3 int32 (final base, final state, count), all on the card; the
// walk starts at base0 (1 <= base0 <= n-1) in state0.  Launches on `stream`
// and returns cudaGetLastError() (0 when the launch was taken).
extern "C" int event_walk_launch(const void* bp, const void* brk, int n,
                                 int base0, int state0, int M, void* events,
                                 void* result, void* stream) {
  if (n < 2 || base0 < 1 || base0 >= n || M < 1 || state0 < 0 ||
      state0 >= LANES)
    return (int)cudaErrorInvalidValue;
  event_walk_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const int*)bp, (const int*)brk, n, base0, state0, M, (int*)events,
      (int*)result);
  return (int)cudaGetLastError();
}
