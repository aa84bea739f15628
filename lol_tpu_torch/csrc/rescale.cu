// The exact BGV drop-last rescale's epilogue, every surviving channel of a
// component in one launch, for Hopper (sm_90a).  Plain C interface, loaded
// with ctypes by lol_tpu_torch/ops/cuda/pointwise.py (rescale_out).
//
// The rescale of a component c over q_0 .. q_l drops q_l: v = iNTT(c_l)
// (times p^-1 mod q_l for LSD), and each surviving channel j gets
//   out_j = (c_j - NTT_j(p [v]_centered)) q_l^-1  mod q_j.
// The transforms are linear, so the caller forward-transforms the centered
// re-expansion nd_j = NTT_j([v]_centered mod q_j) alone (the forward
// kernel's digit prologue) and this kernel computes
//   out_j = (c_j a_j - nd_j b_j) mod q_j,  a_j = q_l^-1,  b_j = p q_l^-1
// (b_j = a_j for MSD).  Both products are Harvey's lazy Shoup multiply by a
// constant with its companion floor(w 2^32 / q_j), each a word in [0, 2q);
// their difference plus 2q lies in (0, 4q) < 2^32 (q < 2^30), and two
// conditional subtractions make it canonical in [0, q).  It replaces the
// JAX package's XLA u32 chain of lol_tpu/she_batched.py:707-734 (after the
// transforms) and the port's int64 torch glue in its place.
//
// What bounds it on the H100: device memory.  A word reads c_j and nd_j
// and writes out_j, 12 bytes, against ~12 integer instructions.  The
// design streams and keeps nothing in shared memory: the grid is (word
// tiles, channels), so the channel (and its constants, kernel parameters)
// is the block's, and each thread takes four consecutive words of every
// operand as one 16-byte load where the words a channel are a multiple of
// four and every pointer is 16-byte aligned; else one word a thread.  The
// transforms come by pointer, one per channel, so nothing stacks them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_CHANNELS = 16;  // keep in step with pointwise.RESCALE_MAX_CHANNELS
constexpr int THREADS = 256;

struct RescaleArgs {
  const uint32_t* comp;                // (k, N) in [0, q_j): channel j at comp + j N
  const uint32_t* nd[MAX_CHANNELS];    // k (N,) forward transforms in [0, q_j)
  uint32_t* out;                       // (k, N)
  long long N;                         // words a channel (n B)
  uint32_t q[MAX_CHANNELS];
  uint32_t a[MAX_CHANNELS], a_sh[MAX_CHANNELS];  // q_l^-1 and its companion
  uint32_t b[MAX_CHANNELS], b_sh[MAX_CHANNELS];  // p q_l^-1 (LSD) or q_l^-1
};

// a w mod q, lazily: a word in [0, 2q) for any u32 a and w in [0, q).
__device__ __forceinline__ uint32_t mul_shoup_lazy(uint32_t a, uint32_t w,
                                                   uint32_t wsh, uint32_t q) {
  return a * w - __umulhi(a, wsh) * q;
}

struct Channel {
  uint32_t q, a, a_sh, b, b_sh;

  // (c a - d b) mod q in [0, q).
  __device__ __forceinline__ uint32_t word(uint32_t c, uint32_t d) const {
    const uint32_t q2 = 2 * q;
    uint32_t r = mul_shoup_lazy(c, a, a_sh, q) + q2 - mul_shoup_lazy(d, b, b_sh, q);
    r = r >= q2 ? r - q2 : r;
    return r >= q ? r - q : r;
  }
};

// VEC = 4: four words a thread as uint4; VEC = 1: one word a thread.
template <int VEC>
__global__ void __launch_bounds__(THREADS) rescale_out(const __grid_constant__ RescaleArgs a) {
  const long long i = ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (i >= a.N) return;
  const int j = blockIdx.y;
  const Channel ch{a.q[j], a.a[j], a.a_sh[j], a.b[j], a.b_sh[j]};
  const long long at = j * a.N + i;
  if (VEC == 4) {
    const uint4 c = *reinterpret_cast<const uint4*>(a.comp + at);
    const uint4 d = *reinterpret_cast<const uint4*>(a.nd[j] + i);
    *reinterpret_cast<uint4*>(a.out + at) =
        make_uint4(ch.word(c.x, d.x), ch.word(c.y, d.y), ch.word(c.z, d.z), ch.word(c.w, d.w));
  } else {
    a.out[at] = ch.word(a.comp[at], a.nd[j][i]);
  }
}

}  // namespace

extern "C" {

// One launch over k <= MAX_CHANNELS channels: comp and out point to (k, N)
// u32 stacks, nd to k device pointers of (N,) u32 transforms, consts to
// 5 k host words, the rows (q, a, a_sh, b, b_sh) of k each.  Returns
// cudaGetLastError() after the launch (0 = launched).
int lol_rescale_out(const void* comp, const void* const* nd, void* out, const uint32_t* consts,
                    int k, long long N, void* stream) {
  if (k < 1 || k > MAX_CHANNELS || N < 1) return (int)cudaErrorInvalidValue;
  RescaleArgs a{};
  a.comp = static_cast<const uint32_t*>(comp);
  a.out = static_cast<uint32_t*>(out);
  a.N = N;
  uintptr_t align = reinterpret_cast<uintptr_t>(comp) | reinterpret_cast<uintptr_t>(out);
  for (int j = 0; j < k; ++j) {
    a.nd[j] = static_cast<const uint32_t*>(nd[j]);
    align |= reinterpret_cast<uintptr_t>(nd[j]);
    a.q[j] = consts[j];
    a.a[j] = consts[k + j];
    a.a_sh[j] = consts[2 * k + j];
    a.b[j] = consts[3 * k + j];
    a.b_sh[j] = consts[4 * k + j];
  }
  const bool vec4 = (align & 15) == 0 && N % 4 == 0;
  const long long per = vec4 ? N / 4 : N;  // threads a channel
  if ((per + THREADS - 1) / THREADS > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((per + THREADS - 1) / THREADS), k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4)
    rescale_out<4><<<grid, THREADS, 0, s>>>(a);
  else
    rescale_out<1><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
