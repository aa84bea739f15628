// Exact modular matrix products along a short axis, for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by lol_tpu_torch/ops/cuda/modmat.py
// (modmat_small).
//
// For M (a, b) and residues x viewed as (pre, b, post) it computes
//   out[p, i, c] = sum_j M[i, j] x[p, j, c]  mod q,
// the odd axes of the general-m transforms below MXU_MIN_AXIS (phi = 6 at
// m = 18432).  It replaces the JAX package's XLA route of
// `matvec_mod_jnp` below that axis (lol_tpu/ops/general.py:108-109, a
// broadcast `mul_mod` and a mod-sum tree; no pallas_call), and the port's
// int64 torch chain in its place (`modmat_small_ref`: a cast, b products,
// b - 1 adds, a remainder and a cast, 14 launches at phi = 6).
//
// Arithmetic: M and x hold residues below q < 2^30, so a product is below
// 2^60 and 15 of them beside a residue sum below 2^64.  Each output
// accumulates its products in a u64 (one mad.wide.u32 a term) and is
// reduced once per TERMS terms by a 64-bit Barrett step with the host's
// mu = floor((2^64 - 1) / q) >= 2^64 / q - 1: qhat = umulhi64(t, mu) is
// floor(t / q) or one below it, so t - qhat q lies in [0, 2q) (computed in
// u32, exact since 2q < 2^32), and one conditional subtraction makes it
// canonical.
//
// What bounds it on the H100: device memory.  A call reads each word of x
// once and writes each word of out once, 4 (a + b) bytes a (p, c) column,
// against ~(2 a b + 7 a) integer instructions there.  The design streams
// and keeps nothing in shared memory: each thread owns one p and four
// consecutive columns c, loads each of its b rows as one 16-byte load
// (coalesced along c, the coefficient-major layout's contiguous axis),
// keeps them in registers, and stores each of its a output rows as one
// 16-byte store (one column a thread where post % 4 != 0 or a pointer is
// not 16-byte aligned).  The matrix and the constants are a small table on
// the device, made once per matrix by the host, which every thread reads
// with uniform loads; the square axes below 16 (phi in {2, 4, 6, 10, 12},
// p in {3, 5, 7, 9, 11, 13}) have instances with (a, b) as template
// constants and every loop unrolled, and one instance with run-time loops
// takes any other shape, re-reading x's rows from the cache per output row
// and reducing every TERMS terms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TERMS = 15;  // products a u64 holds beside a residue
constexpr int HEAD = 4;    // the table's words before M: q, mu (lo, hi), 0

struct SmallArgs {
  const uint32_t* table;  // HEAD words, then M (a, b) row-major, residues mod q
  const uint32_t* x;      // (pre, b, post) in [0, q)
  uint32_t* out;          // (pre, a, post)
  long long pre, post;
  long long cols;         // threads a p: post / VEC
  int a, b;
};

// t mod q for any u64 t, by the Barrett step above.
__device__ __forceinline__ uint32_t reduce(unsigned long long t, uint32_t q,
                                           unsigned long long mu) {
  const unsigned long long qhat = __umul64hi(t, mu);
  const uint32_t r = (uint32_t)t - (uint32_t)qhat * q;
  return r >= q ? r - q : r;
}

template <int VEC>
__device__ __forceinline__ void load(const uint32_t* p, uint32_t (&w)[VEC]) {
  if constexpr (VEC == 4) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else {
    w[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store(uint32_t* p, const uint32_t (&w)[VEC]) {
  if constexpr (VEC == 4)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    p[0] = w[0];
}

// A = B = 0: a and b at run time.
template <int A, int B, int VEC>
__global__ void __launch_bounds__(THREADS) modmat_small(const __grid_constant__ SmallArgs s) {
  static_assert(B <= TERMS, "a fixed instance reduces once");
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= s.pre * s.cols) return;
  const long long p = t / s.cols;
  const long long c = (t - p * s.cols) * VEC;
  const uint32_t q = __ldg(s.table);
  const unsigned long long mu =
      __ldg(s.table + 1) | ((unsigned long long)__ldg(s.table + 2) << 32);
  const uint32_t* M = s.table + HEAD;
  const long long post = s.post;
  if constexpr (A > 0) {
    const uint32_t* xp = s.x + p * B * post + c;
    uint32_t* op = s.out + p * A * post + c;
    uint32_t xv[B][VEC];
#pragma unroll
    for (int j = 0; j < B; ++j) load<VEC>(xp + j * post, xv[j]);
#pragma unroll
    for (int i = 0; i < A; ++i) {
      uint32_t r[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        unsigned long long acc = 0;
#pragma unroll
        for (int j = 0; j < B; ++j)
          acc += (unsigned long long)__ldg(M + i * B + j) * xv[j][e];
        r[e] = reduce(acc, q, mu);
      }
      store<VEC>(op + i * post, r);
    }
  } else {
    const int a = s.a, b = s.b;
    const uint32_t* xp = s.x + p * b * post + c;
    uint32_t* op = s.out + p * a * post + c;
    for (int i = 0; i < a; ++i) {
      unsigned long long acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0;
      for (int j0 = 0; j0 < b; j0 += TERMS) {
        const int j1 = j0 + TERMS < b ? j0 + TERMS : b;
        for (int j = j0; j < j1; ++j) {
          uint32_t w[VEC];
          load<VEC>(xp + j * post, w);
          const unsigned long long m = __ldg(M + (long long)i * b + j);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] += m * w[e];
        }
        if (j1 < b) {  // a residue and the next TERMS products stay below 2^64
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = reduce(acc[e], q, mu);
        }
      }
      uint32_t r[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) r[e] = reduce(acc[e], q, mu);
      store<VEC>(op + (long long)i * post, r);
    }
  }
}

template <int A, int B>
void launch(const SmallArgs& s, bool vec4, unsigned blocks, cudaStream_t st) {
  if (vec4)
    modmat_small<A, B, 4><<<blocks, THREADS, 0, st>>>(s);
  else
    modmat_small<A, B, 1><<<blocks, THREADS, 0, st>>>(s);
}

}  // namespace

extern "C" {

// One launch: out (pre, a, post) = M @ x mod q along x's middle axis, x
// (pre, b, post) u32 residues, table the device words of
// `modmat._small_table` (q, mu lo, mu hi, 0, then M row-major).  Returns
// cudaGetLastError() after the launch (0 = launched).
int lol_modmat_small(const void* table, const void* x, void* out, long long pre, long long post,
                     int a, int b, void* stream) {
  if (pre < 1 || post < 1 || a < 1 || b < 1) return (int)cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  const bool vec4 = post % 4 == 0 && (align & 15) == 0;
  SmallArgs s{};
  s.table = static_cast<const uint32_t*>(table);
  s.x = static_cast<const uint32_t*>(x);
  s.out = static_cast<uint32_t*>(out);
  s.pre = pre;
  s.post = post;
  s.cols = vec4 ? post / 4 : post;
  s.a = a;
  s.b = b;
  const long long blocks = (pre * s.cols + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = (unsigned)blocks;
  switch (a == b ? a : 0) {
    case 2: launch<2, 2>(s, vec4, nb, st); break;
    case 4: launch<4, 4>(s, vec4, nb, st); break;
    case 6: launch<6, 6>(s, vec4, nb, st); break;
    case 10: launch<10, 10>(s, vec4, nb, st); break;
    case 12: launch<12, 12>(s, vec4, nb, st); break;
    default: launch<0, 0>(s, vec4, nb, st); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
