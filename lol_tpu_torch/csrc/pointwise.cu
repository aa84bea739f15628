// Degree-2 ciphertext product of one RNS channel, elementwise over an
// (n, B) u32 array, for Hopper (sm_90a).  Plain C interface, loaded with
// ctypes by lol_tpu_torch/ops/cuda/pointwise.py.
//
// Replaces the Pallas kernel lol_tpu/ops/pallas/pointwise.py::_ct_mul_kernel:
// (e0, e1, e2) = (c0 d0, c0 d1 + c1 d0, c1 d1) mod q, with the JAX package's
// u32 Barrett multiply (zq.mul_mod: mu = floor(2^2k / q), k = bitlength(q),
// q < 2^30; the quotient estimate is at most 2 short, so the remainder is
// below 3q < 2^32 and two conditional subtractions finish it).  e1 reduces
// both products first and adds after: 2(q - 1) < 2^31, one fold.
//
// What bounds it on the H100: device memory.  Each element reads four u32
// and writes three, 28 bytes, against ~40 integer instructions; at one
// channel of the BGV step (n = 2^14, B = 1024) that is 448 MiB per call.
// The design streams: each thread takes four consecutive elements of every
// operand as one 16-byte load (when all seven pointers are 16-byte aligned)
// and keeps nothing in shared memory.  The element count need not be a
// multiple of four or of B: the last count % 4 elements go one per thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Barrett {
  uint32_t q, mu;
  int k;
};

struct CtMulArgs {
  const uint32_t *c0, *c1, *d0, *d1;
  uint32_t *e0, *e1, *e2;
  long long count;
  Barrett m;
};

// zq.mul_mod: (a * b) mod q for a, b in [0, q).
__device__ __forceinline__ uint32_t mul_mod(uint32_t a, uint32_t b,
                                            const Barrett& m) {
  const uint32_t hi = __umulhi(a, b), lo = a * b;
  const uint32_t t = (hi << (33 - m.k)) | (lo >> (m.k - 1));  // < 2^(k+1)
  const uint32_t quot =
      (__umulhi(t, m.mu) << (31 - m.k)) | ((t * m.mu) >> (m.k + 1));
  uint32_t r = lo - quot * m.q;  // wrapping; the true value is < 3q
  if (r >= m.q) r -= m.q;
  if (r >= m.q) r -= m.q;
  return r;
}

__device__ __forceinline__ void ct_mul_one(uint32_t a0, uint32_t a1,
                                           uint32_t b0, uint32_t b1,
                                           const Barrett& m, uint32_t& r0,
                                           uint32_t& r1, uint32_t& r2) {
  r0 = mul_mod(a0, b0, m);
  uint32_t s = mul_mod(a0, b1, m) + mul_mod(a1, b0, m);  // < 2q < 2^31
  r1 = s >= m.q ? s - m.q : s;
  r2 = mul_mod(a1, b1, m);
}

// VEC = 4: element quads as uint4, then the last count % 4 elements one
// per thread; VEC = 1: one element per thread.
template <int VEC>
__global__ void ct_mul(CtMulArgs a) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC == 1) {
    if (tid < a.count)
      ct_mul_one(a.c0[tid], a.c1[tid], a.d0[tid], a.d1[tid], a.m, a.e0[tid],
                 a.e1[tid], a.e2[tid]);
    return;
  }
  const long long nvec = a.count / 4;
  if (tid < nvec) {
    const uint4 x0 = reinterpret_cast<const uint4*>(a.c0)[tid];
    const uint4 x1 = reinterpret_cast<const uint4*>(a.c1)[tid];
    const uint4 y0 = reinterpret_cast<const uint4*>(a.d0)[tid];
    const uint4 y1 = reinterpret_cast<const uint4*>(a.d1)[tid];
    uint4 r0, r1, r2;
    ct_mul_one(x0.x, x1.x, y0.x, y1.x, a.m, r0.x, r1.x, r2.x);
    ct_mul_one(x0.y, x1.y, y0.y, y1.y, a.m, r0.y, r1.y, r2.y);
    ct_mul_one(x0.z, x1.z, y0.z, y1.z, a.m, r0.z, r1.z, r2.z);
    ct_mul_one(x0.w, x1.w, y0.w, y1.w, a.m, r0.w, r1.w, r2.w);
    reinterpret_cast<uint4*>(a.e0)[tid] = r0;
    reinterpret_cast<uint4*>(a.e1)[tid] = r1;
    reinterpret_cast<uint4*>(a.e2)[tid] = r2;
  }
  const long long j = nvec * 4 + tid;
  if (j < a.count)
    ct_mul_one(a.c0[j], a.c1[j], a.d0[j], a.d1[j], a.m, a.e0[j], a.e1[j],
               a.e2[j]);
}

constexpr int THREADS = 256;

}  // namespace

extern "C" {

// One channel: count elements of each operand, all residues in [0, q).
// Returns cudaGetLastError() after the launch (0 = launched).
int lol_ct_mul(const void* c0, const void* c1, const void* d0, const void* d1,
               void* e0, void* e1, void* e2, long long count, uint32_t q,
               uint32_t mu, int k, void* stream) {
  if (count < 1 || k < 2 || k > 30) return (int)cudaErrorInvalidValue;
  CtMulArgs a{static_cast<const uint32_t*>(c0), static_cast<const uint32_t*>(c1),
              static_cast<const uint32_t*>(d0), static_cast<const uint32_t*>(d1),
              static_cast<uint32_t*>(e0),       static_cast<uint32_t*>(e1),
              static_cast<uint32_t*>(e2),       count,
              Barrett{q, mu, k}};
  const uintptr_t align = reinterpret_cast<uintptr_t>(c0) |
                          reinterpret_cast<uintptr_t>(c1) |
                          reinterpret_cast<uintptr_t>(d0) |
                          reinterpret_cast<uintptr_t>(d1) |
                          reinterpret_cast<uintptr_t>(e0) |
                          reinterpret_cast<uintptr_t>(e1) |
                          reinterpret_cast<uintptr_t>(e2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((align & 15) == 0) {
    const long long threads_needed = count / 4 > count % 4 ? count / 4 : count % 4;
    const unsigned blocks = (unsigned)((threads_needed + THREADS - 1) / THREADS);
    ct_mul<4><<<blocks, THREADS, 0, s>>>(a);
  } else {
    const unsigned blocks = (unsigned)((count + THREADS - 1) / THREADS);
    ct_mul<1><<<blocks, THREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
