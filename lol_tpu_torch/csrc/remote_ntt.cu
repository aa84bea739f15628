// Ring-sharded negacyclic NTT over a mesh of D shards, for Hopper (sm_90a):
// the chunk all-to-all, and the phase-B passes with the second exchange folded
// into their tile loads (forward) and tile stores (inverse).  Plain C
// interface, loaded with ctypes by lol_tpu_torch/ops/cuda/remote_ntt.py.
//
// Replaces the Pallas kernels of lol_tpu/ops/pallas/remote_ntt.py:
//   a2a_chunks            _a2a_kernel (:61), the chunked all-to-all
//   ntt_fwd_gather_pass   _fused_a2a_phaseB_kernel (:111), a2a #2 + phase B
//   ntt_inv_scatter_pass  _fused_phaseBinv_a2a_kernel (:283), phase B' + a2a
//
// Layout: a ring-sharded (n, B) u32 array is D shards of tS = n/D contiguous
// rows, (tS, B) each; chunk e of a shard is its rows [e*C, (e+1)*C), C = tS/D,
// one contiguous C*B span.  The kernel launched for shard d gets every
// shard's base pointer by value (at most MAX_D), so any shard's memory is
// peer[e] + offset: on one card these are local pointers, across the cards of
// one host NVLink peer pointers (the wrapper enables peer access first).
//
// What bounds them on the H100.  a2a_chunks moves bytes only: each shard
// reads its tS*B words once and writes them once, (D-1)/D of them to other
// shards, so the exchange's floor is 8*n*B bytes at the memory rate on one
// card and (D-1)/D * 4*tS*B bytes per card at NVLink's 450 GB/s each way
// across cards.  It copies 16-byte vectors (a scalar tail and a scalar path
// for misaligned chunks), one launch per shard with a grid over its D chunks.
// The fused passes are csrc/ntt.cu's pass kernels, whose tile load (forward)
// or store (inverse) addresses the other shards: row r = e*C + c of shard d's
// block lives at row d*C + c of shard e.  The exchange then costs no array of
// its own and no device-memory round trip: the pass reads and writes exactly
// the bytes an unfused phase-B pass does, and the other resident blocks hide
// the remote latency.  That replaces the TPU kernels' landing-zone slots, ack
// rounds and send windows, which Mosaic's VMEM and DMA semaphores forced.
// Above tS = 4096 phase B is two passes; the gather sits in the first
// (forward) and the scatter in the last (inverse).

#include "ntt_common.cuh"

namespace {

constexpr int MAX_D = 8;

struct A2AArgs {
  const uint32_t* x;       // shard d
  uint32_t* out[MAX_D];    // every shard's exchange output
  size_t chunk;            // C*B words
  int d;
};

// out[r] chunk d = x chunk r, for r = blockIdx.y.
__global__ void a2a_chunks(const __grid_constant__ A2AArgs a) {
  const int r = blockIdx.y;
  const uint32_t* src = a.x + (size_t)r * a.chunk;
  uint32_t* dst = a.out[r] + (size_t)a.d * a.chunk;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t t0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t head = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    head = a.chunk & ~(size_t)3;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (size_t i = t0; i < head / 4; i += stride) d4[i] = s4[i];
  }
  for (size_t i = head + t0; i < a.chunk; i += stride) dst[i] = src[i];
}

struct RingArgs {
  PassArgs p;              // the pass over shard d's (tS, B) block rows
  uint32_t* peer[MAX_D];   // gather: the phase-A outputs; scatter: the landing buffers
  int logC, d;
};

// Where block row `row` of shard d lives: row d*C + c of shard e.
__device__ __forceinline__ uint32_t* peer_row(const RingArgs& r, size_t row) {
  const size_t c = row & (((size_t)1 << r.logC) - 1);
  return r.peer[row >> r.logC] + ((((size_t)r.d << r.logC) + c) * r.p.B);
}

// load_tile<false> of ntt_common.cuh reading every shard's phase-A output
// (lazy, below 4q: the first stage folds u once).
__device__ __forceinline__ void load_gather(const RingArgs& r, uint32_t* sm,
                                            int col0, int seq0) {
  const PassArgs& a = r.p;
  const int tile = a.L * a.G * a.TB;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int c = e & (a.TB - 1);
    const int g = (e >> a.logTB) & (a.G - 1);
    const int i = e >> (a.logTB + a.logG);
    const int col = col0 + c;
    sm[e] = col < a.B ? peer_row(r, row_of(a, i, seq0 + g))[col] : 0;
  }
  __syncthreads();
}

// store_tile of ntt_common.cuh writing into every shard's landing buffer.
__device__ __forceinline__ void store_scatter(const RingArgs& r,
                                              const uint32_t* sm, int col0,
                                              int seq0) {
  const PassArgs& a = r.p;
  const int tile = a.L * a.G * a.TB;
  const uint32_t q = a.q;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int col = col0 + (e & (a.TB - 1));
    if (col >= a.B) continue;
    const int g = (e >> a.logTB) & (a.G - 1);
    const int i = e >> (a.logTB + a.logG);
    uint32_t v = sm[e];
    if (a.last && v >= q) v -= q;  // inverse values are < 2q: one fold
    peer_row(r, row_of(a, i, seq0 + g))[col] = v;
  }
}

__global__ void ntt_fwd_gather_pass(const __grid_constant__ RingArgs r) {
  extern __shared__ uint32_t sm[];
  const PassArgs& a = r.p;
  const int col0 = blockIdx.x * a.TB;
  const int seq0 = blockIdx.y * a.G;
  load_gather(r, sm, col0, seq0);
  fwd_stages(a, sm, seq0);
  store_tile(a, sm, col0, seq0, 2u * a.q);
}

__global__ void ntt_inv_scatter_pass(const __grid_constant__ RingArgs r) {
  extern __shared__ uint32_t sm[];
  const PassArgs& a = r.p;
  const int col0 = blockIdx.x * a.TB;
  const int seq0 = blockIdx.y * a.G;
  load_tile<true>(a, sm, col0, seq0);
  inv_stages(a, sm, seq0);
  store_scatter(r, sm, col0, seq0);
}

}  // namespace

extern "C" {

// Shard d's part of the chunk all-to-all: its chunk r goes to out[r] at slot
// d, for every r < D.  out: D device pointers.
int lol_a2a_chunks(const void* x, void* const* out, int D, int d,
                   long long chunk, int threads, void* stream) {
  if (D < 1 || D > MAX_D || d < 0 || d >= D || chunk < 1 || threads < 32 ||
      threads > 1024)
    return (int)cudaErrorInvalidValue;
  A2AArgs a{};
  a.x = static_cast<const uint32_t*>(x);
  for (int e = 0; e < D; ++e) a.out[e] = static_cast<uint32_t*>(out[e]);
  a.chunk = (size_t)chunk;
  a.d = d;
  const long long vec_blocks = (chunk / 4 + threads - 1) / threads;
  dim3 grid((unsigned)(vec_blocks < 1 ? 1 : vec_blocks > 1024 ? 1024 : vec_blocks), D);
  a2a_chunks<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// One fused pass of shard d over its block: scatter = 0, the forward pass
// reading every shard's phase-A output (peers) and writing y; scatter = 1,
// the GS inverse pass reading x and writing every shard's landing buffer
// (peers).  C = tS/D, a power of two.
int lol_ntt_ring_pass(int scatter, const void* x, void* y,
                      void* const* peers, int D, int C, int d,
                      const void* w, const void* wsh, int B, int L, int nseq,
                      int elem_stride, int seq_stride, int base0,
                      int base_step, int G, int TB, int threads, int last,
                      uint32_t q, uint32_t ninv, uint32_t ninv_sh,
                      uint32_t w0n, uint32_t w0n_sh, void* stream) {
  RingArgs r{};
  if (D < 1 || D > MAX_D || d < 0 || d >= D || !pow2(C) ||
      !set_geometry(r.p, x, y, w, wsh, B, L, nseq, elem_stride, seq_stride, G,
                    TB, threads, last, q))
    return (int)cudaErrorInvalidValue;
  r.p.base0 = base0; r.p.base_step = base_step;
  r.p.ninv = ninv; r.p.ninv_sh = ninv_sh; r.p.w0n = w0n; r.p.w0n_sh = w0n_sh;
  for (int e = 0; e < D; ++e) r.peer[e] = static_cast<uint32_t*>(peers[e]);
  r.logC = ilog2(C);
  r.d = d;
  return launch(scatter ? ntt_inv_scatter_pass : ntt_fwd_gather_pass, r, r.p,
                threads, stream);
}

// Lets `device` address `peer`'s memory (NVLink / PCIe peer access); 0 when
// it can or already could.  The calling thread's current device is kept.
int lol_enable_peer_access(int device, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();  // clear the sticky-free "already enabled" status
      err = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : back);
}

}  // extern "C"
