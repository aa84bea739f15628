// Shared code of the NTT pass kernels: the Shoup multiply and the host-side
// helpers that every pass uses, and the first design's pass arguments, tile
// loads and stores, geometry and launch, which the route-B kernel
// (csrc/ntt.cu::ntt_invb_pass) still runs.  The pass geometry is described
// at the top of csrc/ntt.cu.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct PassArgs {
  const uint32_t* x;
  uint32_t* y;
  const uint32_t* w;    // psi_rev (forward) or ipsi_rev (inverse), length n
  const uint32_t* wsh;  // Shoup companions floor(w * 2^32 / q)
  int B, L, logL, nseq, elem_stride, seq_stride, base0, base_step;
  int G, logG, TB, logTB;  // powers of two
  uint32_t q;
  int last;             // last pass: fold to [0, q) (inverse: also scale)
  // the first design's prologue and folded n^-1, unused since its stage
  // loops went: kept so that ntt_invb_pass's parameter layout, and so its
  // code, stays as measured
  int has_pre;
  uint32_t pre_q, pre_half, pre_qmod, pre_mu;
  uint32_t ninv, ninv_sh, w0n, w0n_sh;
};

// (a * w) mod q up to one q, for ANY u32 a and w in [0, q): the Shoup
// quotient estimate is floor(a*w/q) or one less, so the wrapping u32
// difference is the true value, in [0, 2q).
__device__ __forceinline__ uint32_t mul_shoup_lazy(uint32_t a, uint32_t w,
                                                   uint32_t wsh, uint32_t q) {
  return a * w - __umulhi(a, wsh) * q;
}

__device__ __forceinline__ size_t row_of(const PassArgs& a, int i, int sq) {
  return (size_t)i * a.elem_stride + (size_t)sq * a.seq_stride;
}

__device__ __forceinline__ void load_tile(const PassArgs& a, uint32_t* sm,
                                          int col0, int seq0) {
  const int tile = a.L * a.G * a.TB;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int c = e & (a.TB - 1);
    const int g = (e >> a.logTB) & (a.G - 1);
    const int i = e >> (a.logTB + a.logG);
    const int col = col0 + c;
    uint32_t v = 0;
    if (col < a.B) v = a.x[row_of(a, i, seq0 + g) * a.B + col];
    sm[e] = v;
  }
  __syncthreads();
}

__device__ __forceinline__ void store_tile(const PassArgs& a,
                                           const uint32_t* sm, int col0,
                                           int seq0, uint32_t fold_hi) {
  const int tile = a.L * a.G * a.TB;
  const uint32_t q = a.q;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int col = col0 + (e & (a.TB - 1));
    if (col >= a.B) continue;
    const int g = (e >> a.logTB) & (a.G - 1);
    const int i = e >> (a.logTB + a.logG);
    uint32_t v = sm[e];
    if (a.last) {
      if (v >= fold_hi) v -= fold_hi;  // forward: [0, 4q) -> [0, 2q)
      if (v >= q) v -= q;
    }
    a.y[row_of(a, i, seq0 + g) * a.B + col] = v;
  }
}

bool pow2(int v) { return v >= 1 && (v & (v - 1)) == 0; }

int ilog2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

// Checks and fills the pass geometry shared by every kernel; false if the
// geometry is one the kernels cannot run.
bool set_geometry(PassArgs& a, const void* x, void* y, const void* w,
                  const void* wsh, int B, int L, int nseq, int elem_stride,
                  int seq_stride, int G, int TB, int threads, int last,
                  uint32_t q) {
  if (B < 1 || !pow2(L) || !pow2(G) || !pow2(TB) || nseq % G ||
      threads < 32 || threads > 1024)
    return false;
  a = PassArgs{};
  a.x = static_cast<const uint32_t*>(x);
  a.y = static_cast<uint32_t*>(y);
  a.w = static_cast<const uint32_t*>(w);
  a.wsh = static_cast<const uint32_t*>(wsh);
  a.B = B; a.L = L; a.nseq = nseq; a.elem_stride = elem_stride;
  a.seq_stride = seq_stride; a.G = G; a.TB = TB; a.q = q; a.last = last;
  a.logL = ilog2(L);
  a.logG = ilog2(G);
  a.logTB = ilog2(TB);
  return true;
}

// Opts the kernel into pass a's tile of dynamic shared memory and launches
// it on args; returns cudaGetLastError() after the launch (0 = launched).
template <typename Args>
int launch(void (*kernel)(Args), const Args& args, const PassArgs& a,
           int threads, void* stream) {
  const size_t smem = (size_t)a.L * a.G * a.TB * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.B + a.TB - 1) / a.TB, a.nseq / a.G);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace
