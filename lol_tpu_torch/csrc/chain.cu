// The u32 integer ceiling: independent multiply-add chains held in
// registers, for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// lol_tpu_torch/bench/mxu_ntt.py.
//
// Replaces the Pallas kernel lol_tpu/bench/mxu_ntt.py::_chain_kernel: every
// element runs y = y * x + 1 (u32, wrapping) `iters` times from y = x, and
// y is stored once.  The loop never touches memory, so the rate it reaches
// is the card's u32 multiply-add issue rate (one IMAD per iteration per
// chain), the denominator of the roofline's integer shares.
//
// What bounds it: the integer pipes, if the chains hide IMAD's latency.  A
// single dependent chain per thread measures latency, so each thread owns
// CHAINS independent chains (elements blockDim.x apart, so the one load
// and one store per element coalesce) and interleaves them in the loop.
// `iters` is a run-time argument, so the compiler cannot fold the loop.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHAINS = 8;

__global__ void u32_chain(const uint32_t* x, uint32_t* y, long long count,
                          int iters) {
  const long long base =
      (long long)blockIdx.x * blockDim.x * CHAINS + threadIdx.x;
  uint32_t xv[CHAINS], yv[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
    const long long i = base + (long long)j * blockDim.x;
    xv[j] = i < count ? x[i] : 0u;
    yv[j] = xv[j];
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) yv[j] = yv[j] * xv[j] + 1u;
  }
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
    const long long i = base + (long long)j * blockDim.x;
    if (i < count) y[i] = yv[j];
  }
}

}  // namespace

extern "C" {

// count elements of x -> y after `iters` steps each; returns
// cudaGetLastError() after the launch (0 = launched).
int lol_u32_chain(const void* x, void* y, long long count, int iters,
                  int threads, void* stream) {
  if (count < 1 || iters < 0 || threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)threads * CHAINS;
  const unsigned blocks = (unsigned)((count + per_block - 1) / per_block);
  u32_chain<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y), count, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
