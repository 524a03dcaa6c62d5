// Latency probes for Hopper (sm_90a): the time of one dependent float64 add
// and of one dependent global read on the card, measured apart from the
// kernels whose time they bound.
//
// prefix.cu (the float64 prefix sums of the device route) adds each row
// strictly left to right, so a row of L entries is a chain of L dependent
// double adds; trace.cu (the event walk K4) reads, per step, a backpointer
// whose address comes from the read before.  Their bounds in PERF.md are
// those chains' lengths times the latencies measured here, not figures read
// off the kernels themselves.
//
// add_chain: one thread adds d to x0 n times, each add waiting for the one
// before (built with -fmad=false and without fast math, so nvcc keeps the
// order and the n rounded adds).  read_chain: one thread follows n links
// of `next`, i = next[i], each address the value of the read before.  Both
// stamp clock64() around their loop and write the result, so that nothing
// is folded away; the caller times the launch with CUDA events as well.
// These kernels are measurement probes: no path of the package launches
// them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void add_chain_kernel(double x0, double d, long long n,
                                 double* __restrict__ out,
                                 long long* __restrict__ cycles) {
  double acc = x0;
  const long long t0 = clock64();
  for (long long i = 0; i < n; ++i) acc = acc + d;
  const long long t1 = clock64();
  out[0] = acc;
  cycles[0] = t1 - t0;
}

__global__ void read_chain_kernel(const int* next, long long n, int start,
                                  int* __restrict__ out,
                                  long long* __restrict__ cycles) {
  int i = start;
  const long long t0 = clock64();
  for (long long k = 0; k < n; ++k) i = next[i];
  const long long t1 = clock64();
  out[0] = i;
  cycles[0] = t1 - t0;
}

}  // namespace

// out: one double, cycles: one int64, both on the card; returns
// cudaGetLastError() (0 when the launch was taken).
extern "C" int add_chain_launch(double x0, double d, long long n, void* out,
                                void* cycles, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  add_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      x0, d, n, (double*)out, (long long*)cycles);
  return (int)cudaGetLastError();
}

// next: int32 links on the card (every value a valid index), out: one
// int32, cycles: one int64.
extern "C" int read_chain_launch(const void* next, long long n, int start,
                                 void* out, void* cycles, void* stream) {
  if (n < 1 || start < 0) return (int)cudaErrorInvalidValue;
  read_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const int*)next, n, start, (int*)out, (long long*)cycles);
  return (int)cudaGetLastError();
}
