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
// four-step NTT's two stage matrices).  The reference centres its limbs to
// int8 because the MXU multiplies signed bytes only; Hopper's mma takes
// unsigned bytes, so this kernel contracts the raw bytes of X's words:
//
//   M X = sum_j (M 2^(8j)) X_j = sum_{i < nl} 2^(8i) (A_i @ Xbytes)  (mod q),
//
// X_j byte j of X's words (j < 4), nl = ceil(bitlength(q - 1) / 8), and
// A_i the (a, 4b) u8 matrix A_i[r][4c + j] = byte i of (M[r][c] 2^(8j) mod q),
// stored as (a, b) u32 words like X (`_prepare`, once a matrix and device).
// With the contraction index k = 4c + j, a B fragment register of
// mma.m16n8k32 (four consecutive k of one column, element e at bits 8e) is
// a word of X as it lies in memory, and an A fragment register a word of
// A_i.  Range: each class sum S_i = A_i @ Xbytes is at most 4 b 255^2,
// below 2^31 for b <= 8256, so the int32 accumulators are exact and the
// reference's refusal above b = 4096 is the only one.  Padding adds zero
// words to A_i (rows to 16, columns to 8), which add nothing whatever X
// holds there; no centring, no row or column sums.  The fold sums the
// S_i 2^(8i) mod q in 64 bits and reduces the sum by two Shoup products
// (any u32 word times a constant below q lands in [0, 2q)).
//
// What bounds it on the H100: device memory.  At the general-m odd axis
// of the step ((G, a, b, N) = (1024, 16, 16, 1024), q < 2^30, nl = 4) the
// call reads X and writes Y once, 134 MB (0.040 ms at 3.35 TB/s), against
// 8.6 G int8 operations (0.004 ms at 1979 TOP/s).  So the design streams:
// - a persistent grid, a few blocks an SM (the occupancy calculator's
//   count times the SMs), each warp an independent worker over work items
//   (g, row tile of 16, column tile of 32), column tiles fastest.  Where A
//   sits in registers, warp w of W takes items w, w + W, ..., so the card
//   reads and writes one window of consecutive items at a time; where A is
//   read through L1, a block takes a run of consecutive items and deals
//   them to its warps in turn, so its warps share their rows of A;
// - X arrives through a ring of STAGES chunks (8 rows x 32 columns) in
//   shared memory private to the warp, filled by 16-byte cp.async
//   STAGES - 1 chunks ahead of the product across item boundaries, so one
//   tile's loads overlap the previous tile's mma and fold; each lane reads
//   back only what it copied (no barrier, no bank conflict);
// - the B fragments come from 16-byte loads: lane (gid, tig) copies 4
//   adjacent columns, 4 pi(gid) + [0, 4), of rows tig and 4 + tig, and each
//   of the four words feeds its own mma ("virtual" 8-column tile e holds
//   column 4 pi(n) + e at its column n); with pi(2t) = t, pi(2t + 1) = 4 + t
//   the accumulators of lane (gid, tig) are columns 4 tig + [0, 4) and
//   16 + 4 tig + [0, 4) of rows gid and gid + 8, stored as 16-byte words
//   (`__stwb`: a plain uint4 store was split into 4-byte ones), a row's
//   four lanes writing 64 contiguous bytes;
// - A fragments in a fragment-ordered table (one 16-byte load a lane a
//   class a chunk, issued before the ring's wait): held in registers where
//   one shared 16-row tile has at most two chunks (the 17-axis: 32
//   registers), else read through L1.
// Where N % 4 or an address does not allow 16-byte words, the same
// schedule copies and stores 4-byte words.  As measured (PERF.md), neither
// stream alone binds it: leaving out the stores, or the copies, saves
// little; the product, the fold and the addressing of each item at 12
// warps an SM are what is left between it and a copy of the same bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;       // a block: independent warps
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 3;  // blocks an SM the registers must allow
constexpr int STAGES = 4;      // chunks in a warp's ring
constexpr int ROWS = 16;       // rows of Y a work item: the instruction's m
constexpr int COLS = 32;       // columns a work item: four 8-column tiles
constexpr int KROWS = 8;       // rows of X a chunk: the instruction's k, 32 bytes
static_assert((STAGES & (STAGES - 1)) == 0, "the ring's index wraps by a mask");

struct ModmatArgs {
  const uint4* frag;      // [G'][RT][KS][nl][32 lanes] A fragments
  long long frag_stride;  // uint4s from one g's fragments to the next (0: shared)
  const uint32_t* x;      // [G][b][N]
  uint32_t* y;            // [G][a][N]
  long long N, items;     // items = G RT CG
  int a, b, rt, ks, cg;   // RT = ceil(a / 16), KS = ceil(b / 8), CG = ceil(N / 32)
  int vec;                // 16-byte copies and stores
  uint32_t q;
  uint32_t w[4];          // class weights 2^(8i) mod q (w[0] = 1)
  uint32_t w32, w32sh;    // 2^32 mod q and its Shoup word floor(w32 2^32 / q)
  uint32_t onesh;         // the Shoup word of 1, floor(2^32 / q)
};

// c += a b, or c = a b where FIRST
template <bool FIRST>
__device__ __forceinline__ void mma_u8(int32_t (&c)[4], const uint4& a, uint32_t b0,
                                       uint32_t b1) {
  if constexpr (FIRST) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1), "r"(0));
  } else {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// src_bytes < the copy's size fills the rest with zeros (0: reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ uint32_t umin(uint32_t u, uint32_t v) { return u < v ? u : v; }

// A work item's place: g, row tile, column tile (fastest), and a step
// of `step` items in the same terms.
struct Cursor {
  long long g, sg;
  int rt, cg, srt, scg;
  __device__ __forceinline__ void start(long long item, long long step, const ModmatArgs& p) {
    cg = static_cast<int>(item % p.cg);
    rt = static_cast<int>(item / p.cg % p.rt);
    g = item / p.cg / p.rt;
    scg = static_cast<int>(step % p.cg);
    srt = static_cast<int>(step / p.cg % p.rt);
    sg = step / p.cg / p.rt;
  }
  __device__ __forceinline__ void next(const ModmatArgs& p) {
    cg += scg;
    const int c1 = cg >= p.cg;
    if (c1) cg -= p.cg;
    rt += srt + c1;
    const int c2 = rt >= p.rt;
    if (c2) rt -= p.rt;
    g += sg + c2;
  }
};

// sum_i S_i 2^(8i) mod q over the class sums of one output word: T =
// sum_i S_i w_i below 2^31 + 3 2^61 in 64 bits, then hi(T) 2^32 + lo(T)
// by two Shoup products, each in [0, 2q)
template <int NL>
__device__ __forceinline__ uint32_t fold(const int32_t (&acc)[NL][4][4], int e, int r,
                                         const ModmatArgs& p) {
  unsigned long long t = static_cast<uint32_t>(acc[0][e][r]);
#pragma unroll
  for (int c = 1; c < NL; ++c)
    t += static_cast<unsigned long long>(static_cast<uint32_t>(acc[c][e][r])) * p.w[c];
  const uint32_t hi = static_cast<uint32_t>(t >> 32), lo = static_cast<uint32_t>(t);
  uint32_t res = hi * p.w32 - __umulhi(hi, p.w32sh) * p.q;
  res += lo - __umulhi(lo, p.onesh) * p.q;  // below 4q
  res = umin(res, res - 2 * p.q);
  return umin(res, res - p.q);
}

// The producer: chunk ks of item c into stage st, this lane's 2 x 4 words,
// rows 8 ks + tig and 8 ks + 4 + tig at columns 32 cg + col + [0, 4);
// src: the lane's word of row tig in the item, ncol: its columns below N.
struct Producer {
  Cursor c;
  const uint32_t* src;
  long long left;  // items not yet fully issued
  int ks, st, col, ncol;

  __device__ __forceinline__ void item(const ModmatArgs& p, int tig) {
    const long long cn = static_cast<long long>(c.cg) * COLS + col;
    src = p.x + (c.g * p.b + tig) * p.N + cn;
    ncol = cn >= p.N ? 0 : p.N - cn >= 4 ? 4 : static_cast<int>(p.N - cn);
  }

  __device__ __forceinline__ void issue(const ModmatArgs& p, uint4 (*ring)[2][32], int lane,
                                        int tig, int ksn) {
    if (left > 0) {
      const uint32_t* s = src + static_cast<long long>(ks * KROWS) * p.N;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool row_ok = ks * KROWS + 4 * h + tig < p.b;
        const uint32_t* sh = s + (h ? 4 * p.N : 0);
        uint32_t* dst = reinterpret_cast<uint32_t*>(&ring[st][h][lane]);
        if (p.vec) {
          const bool ok = row_ok && ncol > 0;
          cp_async16(dst, ok ? sh : p.x, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = row_ok && e < ncol;
            cp_async4(dst + e, ok ? sh + e : p.x, ok ? 4 : 0);
          }
        }
      }
      if (++ks == ksn) {
        ks = 0;
        c.next(p);
        if (--left > 0) item(p, tig);
      }
      st = (st + 1) & (STAGES - 1);
    }
    cp_commit();  // one group a call, empty past the end: the wait counts groups
  }
};

// One chunk: issue the chunk STAGES - 1 ahead, wait for this one, and
// multiply it into the NL classes' accumulators of the four virtual tiles
// (FIRST: the item's first chunk, which sets them).
template <int NL, int KSR, bool FIRST>
__device__ __forceinline__ void chunk(const ModmatArgs& p, Producer& pr, uint4 (*ring)[2][32],
                                      int& st, int lane, int tig, int ksn, int k,
                                      const uint4* fa, const uint4 (&ar)[KSR > 0 ? KSR : 1][NL],
                                      int32_t (&acc)[NL][4][4]) {
  uint4 af[NL];  // loads issued before the wait, which orders memory
#pragma unroll
  for (int c = 0; c < NL; ++c) {
    if constexpr (KSR > 0) {
      af[c] = ar[k][c];
    } else {
      af[c] = __ldg(fa + (k * NL + c) * 32);
    }
  }
  pr.issue(p, ring, lane, tig, ksn);
  cp_wait<STAGES - 1>();  // this chunk's group has landed
  const uint4 x0 = ring[st][0][lane], x1 = ring[st][1][lane];
  st = (st + 1) & (STAGES - 1);
#pragma unroll
  for (int c = 0; c < NL; ++c) {
    mma_u8<FIRST>(acc[c][0], af[c], x0.x, x1.x);
    mma_u8<FIRST>(acc[c][1], af[c], x0.y, x1.y);
    mma_u8<FIRST>(acc[c][2], af[c], x0.z, x1.z);
    mma_u8<FIRST>(acc[c][3], af[c], x0.w, x1.w);
  }
}

// NL classes; KSR > 0: one shared 16-row tile of KSR chunks, its A
// fragments held in registers.
template <int NL, int KSR>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) modmat_s8(ModmatArgs p) {
  __shared__ __align__(16) uint4 ring[WARPS][STAGES][2][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // The warp's items: first, first + step, ... (count of them).  A in
  // registers: every warp in turn (first = its rank, step = the warps), so
  // at any time the card reads and writes one window of consecutive items.
  // A through L1: the block's run of items dealt to its warps in turn, so
  // a block's warps share their rows of A.
  long long first, step, last;
  if constexpr (KSR > 0) {
    first = static_cast<long long>(blockIdx.x) * WARPS + warp;
    step = static_cast<long long>(gridDim.x) * WARPS;
    last = p.items;
  } else {
    first = p.items * blockIdx.x / gridDim.x + warp;
    step = WARPS;
    last = p.items * (blockIdx.x + 1) / gridDim.x;
  }
  if (first >= last) return;
  const long long count = (last - first + step - 1) / step;
  uint4 (*const my)[2][32] = ring[warp];
  const int KS = KSR > 0 ? KSR : p.ks;

  Producer pr;
  pr.c.start(first, step, p);
  pr.left = count;
  pr.ks = 0;
  pr.st = 0;
  pr.col = 4 * ((gid & 1) ? 4 + (gid >> 1) : (gid >> 1));  // 4 pi(gid)
  pr.item(p, tig);

  uint4 ar[KSR > 0 ? KSR : 1][NL];
  if constexpr (KSR > 0) {
#pragma unroll
    for (int k = 0; k < KSR; ++k)
#pragma unroll
      for (int c = 0; c < NL; ++c) ar[k][c] = __ldg(p.frag + (k * NL + c) * 32 + lane);
  }

#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) pr.issue(p, my, lane, tig, KS);

  Cursor cc;
  cc.start(first, step, p);
  int st = 0;
#pragma unroll 1
  for (long long it = 0; it < count; ++it) {
    __syncwarp();
    int32_t acc[NL][4][4];
    const uint4* fa = p.frag + cc.g * p.frag_stride +
                      static_cast<long long>(cc.rt) * KS * NL * 32 + lane;
    chunk<NL, KSR, true>(p, pr, my, st, lane, tig, KS, 0, fa, ar, acc);
    if constexpr (KSR > 0) {
#pragma unroll
      for (int k = 1; k < KSR; ++k)
        chunk<NL, KSR, false>(p, pr, my, st, lane, tig, KS, k, fa, ar, acc);
    } else {
#pragma unroll 1
      for (int k = 1; k < KS; ++k)
        chunk<NL, KSR, false>(p, pr, my, st, lane, tig, KS, k, fa, ar, acc);
    }

    // accumulator r of virtual tile e: row gid + 8 (r >> 1), column
    // 16 (r & 1) + 4 tig + e of the item
    const long long col = static_cast<long long>(cc.cg) * COLS + 4 * tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = cc.rt * ROWS + gid + 8 * h;
      if (row >= p.a) continue;
      uint32_t* yr = p.y + (cc.g * p.a + row) * p.N + col;
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = fold<NL>(acc, e, 2 * h + ch, p);
        uint32_t* dst = yr + 16 * ch;
        const long long c0 = col + 16 * ch;
        if (p.vec) {
          if (c0 < p.N)
            __stwb(reinterpret_cast<uint4*>(dst), make_uint4(v[0], v[1], v[2], v[3]));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c0 + e < p.N) dst[e] = v[e];
        }
      }
    }
    cc.next(p);
  }
}

template <int NL, int KSR>
cudaError_t launch(const ModmatArgs& p, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, modmat_s8<NL, KSR>, THREADS, 0);
  if (e != cudaSuccess) return e;
  const long long want = (p.items + WARPS - 1) / WARPS;
  const long long room = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  modmat_s8<NL, KSR><<<static_cast<unsigned>(want < room ? want : room), THREADS, 0, s>>>(p);
  return cudaGetLastError();
}

template <int NL>
cudaError_t launch_nl(const ModmatArgs& p, int ksr, cudaStream_t s) {
  switch (ksr) {
    case 1: return launch<NL, 1>(p, s);
    case 2: return launch<NL, 2>(p, s);
    default: return launch<NL, 0>(p, s);
  }
}

}  // namespace

extern "C" {

// Y (G, a, N) = M @ X (G, b, N) mod q over u32 residues.  frag: M's A
// fragments as `modmat._fragments` lays them out, 16-byte aligned;
// frag_stride: u32 words from one g's fragments to the next, 0 for one
// shared matrix; nl: the classes (limbs of q).  Returns
// cudaGetLastError() after the launch.
int lol_modmat_s8(const void* frag, long long frag_stride, const void* x, void* y, long long G,
                  long long N, int a, int b, int nl, uint32_t q, void* stream) {
  const long long cg = (N + COLS - 1) / COLS;
  if (G < 1 || N < 1 || cg > 0x7FFFFFFFLL || a < 1 || b < 1 || b > 4096 || nl < 1 || nl > 4 ||
      q < 2 || q >= (1u << 30) || frag_stride < 0 || frag_stride % 4 ||
      reinterpret_cast<uintptr_t>(frag) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  ModmatArgs p{};
  p.frag = static_cast<const uint4*>(frag);
  p.frag_stride = frag_stride / 4;
  p.x = static_cast<const uint32_t*>(x);
  p.y = static_cast<uint32_t*>(y);
  p.N = N;
  p.a = a;
  p.b = b;
  p.rt = (a + ROWS - 1) / ROWS;
  p.ks = (b + KROWS - 1) / KROWS;
  p.cg = static_cast<int>(cg);
  p.items = G * p.rt * cg;
  p.vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(y) % 16 == 0;
  p.q = q;
  for (int i = 0; i < 4; ++i) p.w[i] = static_cast<uint32_t>((1ULL << (8 * i)) % q);
  p.w32 = static_cast<uint32_t>((1ULL << 32) % q);
  p.w32sh = static_cast<uint32_t>((static_cast<unsigned long long>(p.w32) << 32) / q);
  p.onesh = static_cast<uint32_t>((1ULL << 32) / q);
  const int ksr = frag_stride == 0 && p.rt == 1 && p.ks <= 2 ? p.ks : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nl) {
    case 1: return static_cast<int>(launch_nl<1>(p, ksr, s));
    case 2: return static_cast<int>(launch_nl<2>(p, ksr, s));
    case 3: return static_cast<int>(launch_nl<3>(p, ksr, s));
    default: return static_cast<int>(launch_nl<4>(p, ksr, s));
  }
}

}  // extern "C"
