// Exact modular matrix product on the int8 tensor cores, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// lol_tpu_torch/ops/cuda/modmat.py.
//
//   Y[g] = M[g] @ X[g] mod q,   X[g]: (b, N) u32 residues, Y[g]: (a, N),
//   M[g]: (a, b), one matrix shared by every g or one per g.
//
// Replaces no pallas_call: the JAX package computes this function with
// XLA's int8 dot_general on the MXU, in lol_tpu/ops/general.py:116
// (matvec_mod_mxu, the odd dense axes of the general-m CRT and the g ops at
// phi >= 16) and lol_tpu/bench/mxu_ntt.py:108 (mxu_modmat_apply, the
// four-step NTT's two stage matrices).  The algorithm is theirs, bit for
// bit: both operands split into nl = ceil(bitlength(q - 1) / 8) limbs of 8
// bits, centred to int8 (limb - 128); every limb pair (i, j) multiplied with
// int32 accumulation; the centring undone with the row sums of M's centred
// limbs (precomputed on the host, 128 x the sum over the pairs of a class,
// `rowcorr`) and the column sums of X's raw limbs (summed here while X is
// staged); the pairs of one weight class k = i + j summed into S_k; and
// sum_k S_k 2^(8k) folded mod q.  |centred limb| <= 128, so a class of at
// most 4 pairs stays below 2^31 for b <= 4096 (lol_tpu/ops/general.py:130).
//
// The product: warp mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.  A
// block takes NT = 32 columns of one g and up to 16 MT rows of Y; each of
// its 4 warps owns 8 columns and every row tile of the block, and keeps
// 2 nl - 1 accumulator tiles (one per class) a row tile in registers.  The
// contraction runs in chunks of 32: the block stages X's chunk once, as
// centred int8 limb tiles in shared memory in the B fragment's order (32
// k-bytes of a column together, 48-byte rows so the 8 columns a fragment
// load touches fall in distinct banks); M's centred limb planes, padded to
// (16 ceil(a / 16), 32 ceil(b / 32)) with centred zeros, are read as A
// fragments straight from memory (small and cached).  A padded k entry is 0
// on both sides and is left out of the column sums, so it adds nothing.
// The epilogue adds the corrections, reduces each S_k by a Shoup product
// with 2^(8k) mod q (any u32 word times a constant below q lands in
// [0, 2q), one subtraction more), sums mod q and stores u32.
//
// What bounds it on the H100: device memory.  At the general-m odd axis of
// the step (a = b = 16) a word of X is read once and a word of Y written
// once against 2 a nl^2 / (a + b) = 16 int8 multiply-adds a byte pair, far
// below the tensor cores' 1979 TOP/s; the epilogue's ~8 (2 nl - 1) integer
// instructions an output word are the next limit.  This first design
// streams: no wgmma, no TMA, no persistent schedule.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 32;       // columns of Y a block
constexpr int KC = 32;       // contraction chunk: the instruction's k
constexpr int WARPS = NT / 8;
constexpr int THREADS = 32 * WARPS;
constexpr int XSTR = KC + 16;  // bytes a staged column row
constexpr int MAX_CLASSES = 7;

struct ModmatArgs {
  const int8_t* planes;     // [G'][nl][a_pad][b_pad] centred limbs of M
  const int32_t* rowcorr;   // [G'][2 nl - 1][a_pad]
  long long plane_stride;   // elements from one g's planes to the next (0: shared)
  long long corr_stride;
  const uint32_t* x;        // [G][b][N]
  uint32_t* y;              // [G][a][N]
  long long N;
  int a, b, a_pad, b_pad;
  uint32_t q;
  uint32_t w[MAX_CLASSES], wsh[MAX_CLASSES];  // 2^(8k) mod q and its Shoup word
};

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// NL limbs; MT row tiles of 16 a block (1, or up to 4 with the last ones
// skipped where a ends).
template <int NL, int MT>
__global__ void __launch_bounds__(THREADS) modmat_s8(ModmatArgs p) {
  constexpr int NK = 2 * NL - 1;
  __shared__ __align__(16) uint8_t xs[NL][NT * XSTR];
  __shared__ uint32_t cs_part[WARPS][NL][NT];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const long long g = blockIdx.y;
  const long long col0 = (long long)blockIdx.x * NT;
  const int row0 = blockIdx.z * 16 * MT;
  const uint32_t* xg = p.x + g * p.b * p.N;
  const int8_t* pl = p.planes + g * p.plane_stride;

  // staging role: column sn of the block, k rows [sk, sk + 8) of a chunk
  const int sn = lane, sk = warp * 8;
  const bool col_ok = col0 + sn < p.N;
  uint32_t cs[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) cs[j] = 0;
  int32_t acc[MT][NK][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int k = 0; k < NK; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][k][r] = 0;

  for (int kc = 0; kc < p.b_pad; kc += KC) {
    uint32_t wd[NL][2];
#pragma unroll
    for (int j = 0; j < NL; ++j) wd[j][0] = wd[j][1] = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = kc + sk + e;
      const bool real = col_ok && k < p.b;
      const uint32_t v = real ? xg[(long long)k * p.N + col0 + sn] : 0u;
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        const uint32_t raw = (v >> (8 * j)) & 0xFFu;
        cs[j] += real ? raw : 0u;
        const uint32_t c = real ? ((raw - 128u) & 0xFFu) : 0u;  // int8 bits
        wd[j][e >> 2] |= c << (8 * (e & 3));
      }
    }
    __syncthreads();  // the previous chunk's fragments are read
#pragma unroll
    for (int j = 0; j < NL; ++j)
      *reinterpret_cast<uint2*>(&xs[j][sn * XSTR + sk]) = make_uint2(wd[j][0], wd[j][1]);
    __syncthreads();

    uint32_t bf[NL][2];
    const int bn = warp * 8 + gid;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      bf[j][0] = *reinterpret_cast<const uint32_t*>(&xs[j][bn * XSTR + tig * 4]);
      bf[j][1] = *reinterpret_cast<const uint32_t*>(&xs[j][bn * XSTR + 16 + tig * 4]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (row0 + mt * 16 >= p.a) break;  // uniform over the block
      const long long rA = (long long)(row0 + mt * 16 + gid) * p.b_pad + kc + tig * 4;
      const long long rB = rA + 8LL * p.b_pad;
      uint32_t af[NL][4];
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int8_t* base = pl + (long long)i * p.a_pad * p.b_pad;
        af[i][0] = ld32(base + rA);
        af[i][1] = ld32(base + rB);
        af[i][2] = ld32(base + rA + 16);
        af[i][3] = ld32(base + rB + 16);
      }
#pragma unroll
      for (int i = 0; i < NL; ++i)
#pragma unroll
        for (int j = 0; j < NL; ++j) mma_s8(acc[mt][i + j], af[i], bf[j]);
    }
  }

#pragma unroll
  for (int j = 0; j < NL; ++j) cs_part[warp][j][sn] = cs[j];
  __syncthreads();

  const int32_t* rc = p.rowcorr + g * p.corr_stride;
  uint32_t* yg = p.y + g * p.a * p.N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (row0 + mt * 16 >= p.a) break;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + mt * 16 + gid + (r >= 2 ? 8 : 0);
      const int col = warp * 8 + 2 * tig + (r & 1);
      if (row >= p.a || col0 + col >= p.N) continue;
      uint32_t colsum[NL];
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        uint32_t s = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += cs_part[w][j][col];
        colsum[j] = s;
      }
      uint32_t res = 0;
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        int32_t cc = 0;
#pragma unroll
        for (int i = 0; i < NL; ++i)
          if (k - i >= 0 && k - i < NL) cc += (int32_t)colsum[k - i];
        // the class's true value, in [0, 2^31)
        const uint32_t s = (uint32_t)(acc[mt][k][r] + rc[(long long)k * p.a_pad + row] + 128 * cc);
        uint32_t t = s * p.w[k] - __umulhi(s, p.wsh[k]) * p.q;  // in [0, 2q)
        if (t >= p.q) t -= p.q;
        res += t;
        if (res >= p.q) res -= p.q;
      }
      yg[(long long)row * p.N + col0 + col] = res;
    }
  }
}

template <int NL>
cudaError_t launch(const ModmatArgs& p, long long G, cudaStream_t s) {
  const int tiles = p.a_pad / 16;
  const long long gx = (p.N + NT - 1) / NT;
  if (tiles == 1) {
    modmat_s8<NL, 1><<<dim3((unsigned)gx, (unsigned)G, 1), THREADS, 0, s>>>(p);
  } else {
    modmat_s8<NL, 4><<<dim3((unsigned)gx, (unsigned)G, (unsigned)((tiles + 3) / 4)),
                       THREADS, 0, s>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Y (G, a, N) = M @ X (G, b, N) mod q over u32 residues; planes / rowcorr
// as in ModmatArgs, plane_stride / corr_stride 0 for one shared matrix;
// w / wsh: the 2 nl - 1 class weights 2^(8k) mod q and their Shoup words
// floor(w 2^32 / q).  Returns cudaGetLastError() after the launch.
int lol_modmat_s8(const void* planes, const void* rowcorr, long long plane_stride,
                  long long corr_stride, const void* x, void* y, long long G,
                  long long N, int a, int b, int a_pad, int b_pad, int nl, uint32_t q,
                  const uint32_t* w, const uint32_t* wsh, void* stream) {
  if (G < 1 || G > 65535 || N < 1 || (N + NT - 1) / NT > 0x7FFFFFFFLL || a < 1 || b < 1 ||
      b > 4096 || nl < 1 || nl > 4 || a_pad % 16 || b_pad % KC || a_pad < a || b_pad < b ||
      (a_pad / 16 + 3) / 4 > 65535 || q < 2)
    return (int)cudaErrorInvalidValue;
  ModmatArgs p{static_cast<const int8_t*>(planes), static_cast<const int32_t*>(rowcorr),
               plane_stride, corr_stride, static_cast<const uint32_t*>(x),
               static_cast<uint32_t*>(y), N, a, b, a_pad, b_pad, q, {}, {}};
  for (int k = 0; k < 2 * nl - 1; ++k) {
    p.w[k] = w[k];
    p.wsh[k] = wsh[k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nl) {
    case 1: return (int)launch<1>(p, G, s);
    case 2: return (int)launch<2>(p, G, s);
    case 3: return (int)launch<3>(p, G, s);
    default: return (int)launch<4>(p, G, s);
  }
}

}  // extern "C"
