// The RNS-gadget key switch's hint inner products, every digit of a key
// switch in one launch, for Hopper (sm_90a).  Plain C interface, loaded
// with ctypes by lol_tpu_torch/ops/cuda/pointwise.py (ks_inner_cm).
//
// For each word (channel j, coefficient c, column b) of the (k, n, B)
// stacks it computes
//   e0' = e0 + sum_i d_i h0[i, j, c]   and   e1' = e1 + sum_i d_i h1[i, j, c]
// mod q_j, over the nd digit stacks d_i of one launch.  The hint is a
// constant, so each product is Harvey's lazy Shoup multiply with the
// precomputed companion floor(h 2^32 / q_j) (the JAX package's
// `_hint_const_sh` / `_mulmod_sh_ch`), a word in [0, 2q).  The
// accumulators stay in [0, 2q): an add reaches at most 4q < 2^32 (q <
// 2^30) and one conditional subtraction of 2q folds it back; a last one of
// q makes each output canonical in [0, q).  e1 may be absent (the key
// switch alone starts it at zero).  Inputs and outputs may be the same
// buffers: each thread reads its words before it writes them, which is
// how the front end chains launches past MAX_DIGITS digits.
//
// What bounds it on the H100: device memory.  At nd = 3 a word reads e0,
// e1 and three digits and writes two words, 28 bytes, against ~30 integer
// instructions.  The design streams and keeps nothing in shared memory:
// the grid is (coefficient rows / TY, column tiles, channels), so the
// channel (and its modulus) is the block's, and each thread reads its
// row's 4 nd hint words once (a broadcast within the row's threads) and
// applies them to four consecutive columns as one 16-byte load of every
// operand, where B % 4 == 0 and every pointer is 16-byte aligned; else
// one column a thread (ragged B, misaligned views).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIGITS = 8;  // keep in step with pointwise.KS_MAX_DIGITS
constexpr int THREADS = 256;

struct KsInnerArgs {
  const uint32_t* e0;              // (k, n, B) in [0, q)
  const uint32_t* e1;              // (k, n, B) in [0, q), or null: zero
  const uint32_t* d[MAX_DIGITS];   // nd digit stacks, (k, n, B) in [0, q)
  const uint32_t* hint;            // this launch's first digit of plane 0
  long long plane;                 // words between the hint's planes
  long long digit;                 // words between its digits (k n)
  const uint32_t* q;               // (k,) moduli
  uint32_t* o0;
  uint32_t* o1;
  int n, B;
};

// a w mod q, lazily: a word in [0, 2q) for any u32 a and w in [0, q).
__device__ __forceinline__ uint32_t mul_shoup_lazy(uint32_t a, uint32_t w,
                                                   uint32_t wsh, uint32_t q) {
  return a * w - __umulhi(a, wsh) * q;
}

// acc in [0, 2q) plus a lazy product in [0, 2q), back in [0, 2q).
__device__ __forceinline__ uint32_t add_lazy(uint32_t acc, uint32_t p,
                                             uint32_t q2) {
  acc += p;
  return acc >= q2 ? acc - q2 : acc;
}

__device__ __forceinline__ uint32_t canon(uint32_t x, uint32_t q) {
  return x >= q ? x - q : x;
}

// The row's hint words of every digit, as plane-major (h0, h0_sh, h1, h1_sh).
template <int ND>
struct RowHint {
  uint32_t w0[ND], s0[ND], w1[ND], s1[ND];

  __device__ __forceinline__ RowHint(const KsInnerArgs& a, long long row) {
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const uint32_t* h = a.hint + i * a.digit + row;
      w0[i] = __ldg(h);
      s0[i] = __ldg(h + a.plane);
      w1[i] = __ldg(h + 2 * a.plane);
      s1[i] = __ldg(h + 3 * a.plane);
    }
  }

  // One column: (x0, x1) plus the digits' words ds, folded to [0, q).
  __device__ __forceinline__ void apply(uint32_t& x0, uint32_t& x1,
                                        const uint32_t (&ds)[ND], uint32_t q) const {
    const uint32_t q2 = 2 * q;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      x0 = add_lazy(x0, mul_shoup_lazy(ds[i], w0[i], s0[i], q), q2);
      x1 = add_lazy(x1, mul_shoup_lazy(ds[i], w1[i], s1[i], q), q2);
    }
    x0 = canon(x0, q);
    x1 = canon(x1, q);
  }
};

// VEC = 4: four columns a thread as uint4; VEC = 1: one column a thread.
template <int ND, int VEC>
__global__ void ks_inner(KsInnerArgs a) {
  const int c = blockIdx.x * blockDim.y + threadIdx.y;
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (c >= a.n || col >= a.B) return;
  const int j = blockIdx.z;
  const long long row = (long long)j * a.n + c;
  const uint32_t q = __ldg(a.q + j);
  const RowHint<ND> h(a, row);
  const long long at = row * a.B + col;
  if (VEC == 4) {
    uint4 x0 = *reinterpret_cast<const uint4*>(a.e0 + at);
    uint4 x1 = a.e1 ? *reinterpret_cast<const uint4*>(a.e1 + at) : make_uint4(0, 0, 0, 0);
    uint4 dv[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) dv[i] = *reinterpret_cast<const uint4*>(a.d[i] + at);
    uint32_t ds[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) ds[i] = dv[i].x;
    h.apply(x0.x, x1.x, ds, q);
#pragma unroll
    for (int i = 0; i < ND; ++i) ds[i] = dv[i].y;
    h.apply(x0.y, x1.y, ds, q);
#pragma unroll
    for (int i = 0; i < ND; ++i) ds[i] = dv[i].z;
    h.apply(x0.z, x1.z, ds, q);
#pragma unroll
    for (int i = 0; i < ND; ++i) ds[i] = dv[i].w;
    h.apply(x0.w, x1.w, ds, q);
    *reinterpret_cast<uint4*>(a.o0 + at) = x0;
    *reinterpret_cast<uint4*>(a.o1 + at) = x1;
  } else {
    uint32_t x0 = a.e0[at], x1 = a.e1 ? a.e1[at] : 0u;
    uint32_t ds[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) ds[i] = a.d[i][at];
    h.apply(x0, x1, ds, q);
    a.o0[at] = x0;
    a.o1[at] = x1;
  }
}

template <int ND>
void launch(const KsInnerArgs& a, int k, bool vec4, cudaStream_t s) {
  const int per_row = vec4 ? a.B / 4 : a.B;  // threads a row
  int tx = 1;
  while (tx < per_row && tx < THREADS) tx *= 2;
  const int ty = THREADS / tx;
  const dim3 block(tx, ty);
  const dim3 grid((a.n + ty - 1) / ty, (per_row + tx - 1) / tx, k);
  if (vec4)
    ks_inner<ND, 4><<<grid, block, 0, s>>>(a);
  else
    ks_inner<ND, 1><<<grid, block, 0, s>>>(a);
}

}  // namespace

extern "C" {

// One launch over nd <= MAX_DIGITS digits: d points to nd device pointers
// of (k, n, B) u32 stacks; hint points to the first of them in plane 0 of
// the (4, nrns, k, n) hint (h0, h0_sh, h1, h1_sh; plane words apart); q to
// k moduli on the device; e1 may be null.  Returns cudaGetLastError()
// after the launch (0 = launched).
int lol_ks_inner(const void* e0, const void* e1, const void* const* d, int nd,
                 const void* hint, long long plane, const void* q, void* o0,
                 void* o1, int k, int n, int B, void* stream) {
  if (nd < 1 || nd > MAX_DIGITS || k < 1 || k > 65535 || n < 1 || B < 1 ||
      (B + THREADS - 1) / THREADS > 65535)
    return (int)cudaErrorInvalidValue;
  KsInnerArgs a{};
  a.e0 = static_cast<const uint32_t*>(e0);
  a.e1 = static_cast<const uint32_t*>(e1);
  uintptr_t align = reinterpret_cast<uintptr_t>(e0) | reinterpret_cast<uintptr_t>(e1) |
                    reinterpret_cast<uintptr_t>(o0) | reinterpret_cast<uintptr_t>(o1);
  for (int i = 0; i < nd; ++i) {
    a.d[i] = static_cast<const uint32_t*>(d[i]);
    align |= reinterpret_cast<uintptr_t>(d[i]);
  }
  a.hint = static_cast<const uint32_t*>(hint);
  a.plane = plane;
  a.digit = (long long)k * n;
  a.q = static_cast<const uint32_t*>(q);
  a.o0 = static_cast<uint32_t*>(o0);
  a.o1 = static_cast<uint32_t*>(o1);
  a.n = n;
  a.B = B;
  const bool vec4 = (align & 15) == 0 && B % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nd) {
    case 1: launch<1>(a, k, vec4, s); break;
    case 2: launch<2>(a, k, vec4, s); break;
    case 3: launch<3>(a, k, vec4, s); break;
    case 4: launch<4>(a, k, vec4, s); break;
    case 5: launch<5>(a, k, vec4, s); break;
    case 6: launch<6>(a, k, vec4, s); break;
    case 7: launch<7>(a, k, vec4, s); break;
    default: launch<8>(a, k, vec4, s); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
