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
// The fused passes are the register-round pass kernels of csrc/ntt.cu
// (csrc/ntt_rounds.cuh) whose first round's loads (forward) or last round's
// stores (inverse) address the other shards: row r = e*C + c of shard d's
// block lives at row d*C + c of shard e.  Both rounds run the pass's stages
// [0, RS), so word m of a unit is element (m << LK) | k of its sequence and
// its row's shard is the top log2 D bits of m: a template constant of each
// word once D is one, while RS >= log2 D, which the host checks.  A unit
// then reads every shard's pointer from the kernel's parameters at a fixed
// offset and adds one offset a word, as the plain pass does.  The exchange
// costs no array of its own and no device-memory round trip: the pass reads
// and writes exactly the bytes an unfused phase-B pass does, with its
// threads, tile and rounds, and the other resident blocks hide the remote
// latency.  That replaces the TPU kernels' landing-zone slots, ack rounds
// and send windows, which Mosaic's VMEM and DMA semaphores forced.  Phase
// B is `ntt_cm`'s schedule at base D + d: at tS = 8192 and 16384 one pass
// over a thread-block cluster, whose first round the gather's loads feed
// (it stores into the cluster's shared memory) and whose last round the
// scatter's stores drain (it loads from there); above 16384 two passes, the
// gather the first and the scatter the last.

#include "ntt_rounds.cuh"

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
  NttArgs a;               // the pass over shard d's (tS, B) block rows
  uint32_t* shard[MAX_D];  // shard e's buffer offset by (d - e)*C rows (below)
};

// The gather's loads (SCATTER = 0) or the scatter's stores: block row r of
// shard d, in shard e = r >> log2 C, lives at row d*C + r - e*C of shard e,
// shard[e] + r*B with shard[e] = peer[e] + (d - e)*C*B, the pointers the
// host passes.  Its other words are the pass's own x (scatter) or y.
template <int LOGD, bool SCATTER>
struct RingIO {
  const RingArgs& r;

  template <int A, int RS, int M>
  __device__ __forceinline__ uint32_t* peer() const {
    static_assert(A == 0 && RS >= LOGD,
                  "a word's shard is static in a round of stages [0, RS), RS >= log2 D");
    return r.shard[M >> (RS - LOGD)];
  }
  template <int A, int RS, int M>
  __device__ __forceinline__ const uint32_t* src(const NttArgs& a) const {
    if constexpr (SCATTER) return a.x;
    else return peer<A, RS, M>();
  }
  template <int A, int RS, int M>
  __device__ __forceinline__ uint32_t* dst(const NttArgs& a) const {
    if constexpr (SCATTER) return peer<A, RS, M>();
    else return a.y;
  }
};

template <int LOGL, int TB, int LOGC, int LOGD>
__global__ void __launch_bounds__(1024) ntt_fwd_gather_pass(const __grid_constant__ RingArgs r) {
  extern __shared__ uint32_t sm[];
  if constexpr (LOGC > 0) cluster_arrive();  // waited for before the first remote store
  ntt_rounds<LOGL, TB, LOGC, Net::FWD, 0>(r.a, sm, (blockIdx.x >> LOGC) * TB,
                                          blockIdx.y << r.a.logG, RingIO<LOGD, false>{r});
}

template <int LOGL, int TB, int LOGC, int LOGD>
__global__ void __launch_bounds__(1024) ntt_inv_scatter_pass(const __grid_constant__ RingArgs r) {
  extern __shared__ uint32_t sm[];
  ntt_rounds<LOGL, TB, LOGC, Net::GS, 0>(r.a, sm, (blockIdx.x >> LOGC) * TB,
                                         blockIdx.y << r.a.logG, RingIO<LOGD, true>{r});
  if constexpr (LOGC > 0) cluster_sync();  // no CTA leaves while others read it
}

template <int LOGD>
int launch_ring_pass(const RingArgs& r, bool scatter, int L, int G, int nseq, int TB,
                     int threads, int log_cluster, void* stream) {
  return with_pass_tile(L, TB, log_cluster, [&](auto lg, auto tb, auto lc) {
    constexpr int LOGL = decltype(lg)::value, T = decltype(tb)::value, LOGC = decltype(lc)::value;
    if constexpr (Rounds<LOGL>::size(0) < LOGD) {
      return (int)cudaErrorInvalidValue;  // a unit's words would not map to shards statically
    } else {
      void (*kernel)(RingArgs) = scatter ? ntt_inv_scatter_pass<LOGL, T, LOGC, LOGD>
                                         : ntt_fwd_gather_pass<LOGL, T, LOGC, LOGD>;
      return launch_rounds<LOGL, T, LOGC>(kernel, r, r.a.B, G, nseq, threads, stream);
    }
  });
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

// One fused pass of shard d over its block, a pass of csrc/ntt.cu's
// lol_ntt_pass geometry: scatter = 0, the forward pass reading every shard's
// phase-A output (peers, lazy words below 4q are fine) and writing y, folded
// to [0, q) if `last`; scatter = 1, the GS inverse pass reading x and
// writing every shard's landing buffer (peers), lazy in [0, 2q).  D in {2,
// 4, 8}, C = tS/D a power of two.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue, launching nothing, for a pass whose
// element index is not the top of its block row (elem_stride * L = tS,
// (nseq - 1) * seq_stride < elem_stride), whose first round has fewer than
// log2 D stages, or that no kernel is built for.
int lol_ntt_ring_pass(int scatter, const void* x, void* y, void* const* peers, int D, int C,
                      int d, const void* w, const void* wsh, int B, int L, int nseq,
                      int elem_stride, int seq_stride, int base0, int base_step, int G, int TB,
                      int threads, int log_cluster, int last, uint32_t q, void* stream) {
  if (!pow2(D) || D < 2 || D > MAX_D || d < 0 || d >= D || !pow2(C) || B < 1 || !pow2(L) ||
      !pow2(G) || nseq % G || threads < 32 || threads > 1024 || threads % 32 ||
      (scatter && last) || (long long)elem_stride * L != (long long)D * C ||
      (long long)(nseq - 1) * seq_stride >= elem_stride)
    return (int)cudaErrorInvalidValue;
  RingArgs r{};
  NttArgs& a = r.a;
  a.x = static_cast<const uint32_t*>(x);
  a.y = static_cast<uint32_t*>(y);
  a.w = static_cast<const uint32_t*>(w);
  a.wsh = static_cast<const uint32_t*>(wsh);
  a.B = B; a.logG = ilog2(G); a.elem_stride = elem_stride; a.seq_stride = seq_stride;
  a.base0 = base0; a.base_step = base_step; a.q = q; a.last = last;
  for (int e = 0; e < D; ++e)
    r.shard[e] = reinterpret_cast<uint32_t*>(reinterpret_cast<uintptr_t>(peers[e]) +
                                             (intptr_t)(d - e) * C * B * sizeof(uint32_t));
  const bool s = scatter != 0;
  switch (ilog2(D)) {
    case 1: return launch_ring_pass<1>(r, s, L, G, nseq, TB, threads, log_cluster, stream);
    case 2: return launch_ring_pass<2>(r, s, L, G, nseq, TB, threads, log_cluster, stream);
    default: return launch_ring_pass<3>(r, s, L, G, nseq, TB, threads, log_cluster, stream);
  }
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
