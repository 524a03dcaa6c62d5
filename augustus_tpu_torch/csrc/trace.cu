// Event-walk Viterbi traceback K4 on the card, for Hopper (sm_90a).
//
// Replaces augustus_tpu/engine/traceback.py:make_event_trace_fn (a
// lax.scan of M steps on the TPU), and with it the per-base walks
// make_trace_fn (the host routes' walk) and make_trace_body (the walk that
// parallel/mesh.py vmaps over a batch of pieces): the port walks every
// plane, K1's and K2's, by events.  The plain PyTorch version with the
// same step is augustus_tpu_torch/engine/traceback.py:event_walk_reference.
//
// The walk starts at base0 in state0 and reads, per step, the packed
// backpointer (pred << 20) | off of a Viterbi kernel's plane bp (row j =
// base j, W states: 64 for K1's plane, S for K2's).  A state whose
// backpointer at base b reads off == 1 and pred == itself (a chain state's
// per-base self loop) is skipped to brk[state][b-1], the last base <= b
// whose read is not such a self loop (torch.cummax along each state's row
// of the transposed plane, as lax.cummax in the reference; base 1 always
// reads).  Each step emits one event row [run_lo, run_hi, seg_lo, seg_hi,
// state]: the skipped run [b2+1, base] (empty when b2 == base) and the
// read segment [b2-off+1, b2]; then (base, state) = (b2-off, pred).  A
// launch stops when base <= 0 or after M events and returns the final
// base, the final state, the count and whether it met an invalid
// backpointer (off < 1, which would never move the walk; the wrapper
// raises); the wrapper relaunches from that base and state into a fresh
// events buffer until the walk reaches base 0 (a launch from (base0,
// state0) continues the walk exactly: each step depends on the pair
// alone).  Rows past count stay as the wrapper zeroed them, as the
// reference's scan emits zeros once the walk is done.
//
// Two entry points: event_walk_launch walks one plane in one block of one
// thread; event_walk_batch_launch walks a batch of planes, one block of one
// thread per plane, each reading its record (plane, breaks, length, width,
// start base and state, outputs) from a device array of int64 fields, so
// that the start state can be written there on the card (the argmax of the
// final column) without a round trip through the host.
//
// What bounds it on the card: each step depends on the previous one
// through three global loads (bp at base, brk, bp at b2), so the walk is
// one thread's chain of dependent memory latencies, about a microsecond a
// step and 10^3-10^4 steps per megabase; the bytes it touches (12 B a step
// and 20 B an event row) are nothing at 3.35 TB/s.  What it saves is the
// copy of the (n, W) plane to the host and the host's walk; a batch runs
// its pieces' chains side by side on as many SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the fields of a batch record, int64 each (engine/traceback.py:WALK_FIELDS)
enum { R_BP = 0, R_BRK, R_EVENTS, R_RESULT, R_N, R_W, R_BASE, R_STATE,
       R_FIELDS };

__device__ __forceinline__ void walk(const int* __restrict__ bp,
                                     const int* __restrict__ brk, int n,
                                     int W, int base, int state, int M,
                                     int* __restrict__ events,
                                     int* __restrict__ result) {
  int count = 0, bad = 0;
  while (count < M && base > 0) {
    const int p = bp[(size_t)base * W + state];
    const bool selfrun = base >= 2 && (p & 0xFFFFF) == 1 && (p >> 20) == state;
    const int b2 = selfrun ? brk[(size_t)state * (n - 1) + (base - 1)] : base;
    const int packed = bp[(size_t)b2 * W + state];
    const int off = packed & 0xFFFFF;
    const int pred = packed >> 20;
    if (off < 1) {
      bad = 1;
      break;
    }
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
  result[3] = bad;
}

__global__ void event_walk_kernel(const int* __restrict__ bp,
                                  const int* __restrict__ brk, int n, int W,
                                  int base0, int state0, int M,
                                  int* __restrict__ events,
                                  int* __restrict__ result) {
  walk(bp, brk, n, W, base0, state0, M, events, result);
}

__global__ void event_walk_batch_kernel(const long long* __restrict__ recs,
                                        int M) {
  const long long* r = recs + (size_t)blockIdx.x * R_FIELDS;
  const int n = (int)r[R_N], W = (int)r[R_W];
  const int base = (int)r[R_BASE], state = (int)r[R_STATE];
  int* result = (int*)r[R_RESULT];
  if (state < 0 || state >= W || base >= n) {
    // a start the wrapper did not check (the state is written on the card)
    result[0] = base;
    result[1] = state;
    result[2] = 0;
    result[3] = 1;
    return;
  }
  walk((const int*)r[R_BP], (const int*)r[R_BRK], n, W, base, state, M,
       (int*)r[R_EVENTS], result);
}

}  // namespace

// bp: (n, W) int32, brk: (W, n-1) int32, events: (M, 5) int32 zeroed,
// result: 4 int32 (final base, final state, count, invalid backpointer), all
// on the card; the walk starts at base0 (1 <= base0 <= n-1) in state0.
// Launches on `stream` and returns cudaGetLastError() (0 when the launch
// was taken).
extern "C" int event_walk_launch(const void* bp, const void* brk, int n,
                                 int W, int base0, int state0, int M,
                                 void* events, void* result, void* stream) {
  if (n < 2 || base0 < 1 || base0 >= n || M < 1 || W < 1 || state0 < 0 ||
      state0 >= W)
    return (int)cudaErrorInvalidValue;
  event_walk_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const int*)bp, (const int*)brk, n, W, base0, state0, M, (int*)events,
      (int*)result);
  return (int)cudaGetLastError();
}

// recs: (P, R_FIELDS) int64 on the card, one record per plane (each plane
// with n >= 2 and 1 <= base <= n-1, its events (M, 5) zeroed and result 4
// int32 as above); one block per record.
extern "C" int event_walk_batch_launch(const void* recs, int P, int M,
                                       void* stream) {
  if (P < 1 || M < 1) return (int)cudaErrorInvalidValue;
  event_walk_batch_kernel<<<P, 1, 0, (cudaStream_t)stream>>>(
      (const long long*)recs, M);
  return (int)cudaGetLastError();
}
