// Negacyclic NTT passes along axis 0 of a coefficient-major (n, B) u32
// array, for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// lol_tpu_torch/ops/cuda/ntt_kernel.py.
//
// Replaces the Pallas kernels lol_tpu/ops/pallas/ntt_kernel.py::_kernel_cross
// and ::_kernel_block, forward (ntt_fwd_pass: DIT, Harvey-lazy in [0, 4q),
// optional _redigit prologue) and inverse (ntt_inv_pass: Gentleman-Sande,
// lazy in [0, 2q), the 1/n scale folded into global stage 0); and
// ::_kernel_block_invb and ::_kernel_cross_invb, the route-B inverse
// (ntt_invb_pass: a DIT-bitrev-input network, Harvey-lazy in [0, 4q), then a
// multiply by a per-row table: the twist after the block DFT, n^-1 psi^-j
// after the last).
//
// Geometry of one pass: it runs `nseq` independent length-L transforms
// (L = 2^logL) on every column.  Element i of sequence sq lives in row
// i*elem_stride + sq*seq_stride.  Local stage sp, group g uses twiddle
// w[((base0 + sq*base_step) << sp) + g]; this one formula gives the plain
// prefix psi_rev[2^sp + g] for the cross pass and for a single pass
// (base0 = 1, base_step = 0) and the per-block tables of the block pass
// (base0 = P, base_step = 1: global group (P + b)*2^sp + g).  One pass for
// n <= 4096 (the whole column tile fits in shared memory), two for larger n
// (first the stages that pair rows WINDOW apart, then the stages inside
// contiguous WINDOW-row blocks); a thread block owns G sequences times TB
// consecutive columns, and columns >= B are masked.
//
// What bounds ntt_fwd_pass / ntt_inv_pass on the H100: ~9 u32 ops per
// butterfly (the Shoup multiply and the lazy folds), n/2*log2(n)*B
// butterflies, against 8*n*B bytes per pass.  Their design spends the
// instruction slots on those ops:
//
// - Register rounds.  The pass's log2 L stages are cut into rounds of at
//   most MAX_ROUND stages (`Rounds`).  In a round each thread takes units of
//   R = 2^r words of one column -- the rows a radix-R butterfly group of
//   those r stages touches -- and runs all r stages in registers, loading
//   the unit's R - 1 twiddle pairs once.  The first round reads its units
//   straight from device memory (the digit prologue applied in registers),
//   the last writes them straight back (the final fold in registers);
//   shared memory carries only the exchanges between rounds, so a pass has
//   ceil(log2 L / MAX_ROUND) - 1 barriers, not log2 L.
// - Everything geometric is a template constant: the pass length, the
//   column tile TB and the round plan, so each unit decodes its column,
//   sequence and rows once and every word's shared-memory offset is an
//   immediate.
// - Bank conflicts.  Lanes of a warp take consecutive columns, then
//   consecutive units of one sequence.  With TB = 32 a warp's words are one
//   32-word row: conflict-free.  With TB < 32 a warp spans 32/TB rows; the
//   tile gets one padding row every 2^t rows (t = the last round's stages),
//   which makes both the consecutive rows of the early rounds and the rows
//   2^t apart of the last round land in distinct banks.
// - One pass at n = 8192 and 2^14 over a thread-block cluster of 4 and 8
//   CTAs (`ntt_cm`'s schedule; route B and the ring keep two passes).  The
//   CTAs share an (n, 8) column tile, CTA r holding rows [r, r + 1) * 2048
//   in its shared memory.
//   Only the first round's stages pair rows that different CTAs hold: the
//   forward's first round stores each word into the shared memory of the CTA
//   that holds its row, the inverse's last round loads from there
//   (distributed shared memory), and a cluster barrier separates that round
//   from the others, which stay inside each CTA.  The array crosses device
//   memory once instead of twice.  512 threads and ~68 KB a CTA, so two
//   CTAs share an SM (4 CTAs of 4096 rows, one a SM, lost to two passes;
//   at n = 4096 a cluster of 2 lost to one CTA at B = 1024: PERF.md).
// - The digit prologue leaves its word lazy (below 4q, which the first
//   stage folds) when pre_q <= 2q: one compare and one add a word.
//
// ntt_invb_pass keeps the first design: the tile in shared memory laid out
// [i][g][c], every stage there with a barrier between stages.  Its stage
// twiddles come from the packed per-row tables of the JAX package's
// _stage_table_bitrev (stage s of a length-L pass at w[s*L + i] for v-row i)
// and its per-row multiplier from an (n,) table indexed by the row of the
// (n, B) array.  PassArgs, its tile loads and stores and the stage loops of
// that design live in ntt_common.cuh, which csrc/remote_ntt.cu shares.

#include <cooperative_groups.h>

#include <utility>

#include "ntt_common.cuh"

namespace {

// route B: the pass plus the per-row multiplier (twist or n^-1 psi^-j).
struct InvbArgs {
  PassArgs p;
  const uint32_t* post;
  const uint32_t* post_sh;
};

__global__ void ntt_invb_pass(InvbArgs b) {
  const PassArgs& a = b.p;
  extern __shared__ uint32_t sm[];
  const int col0 = blockIdx.x * a.TB;
  const int seq0 = blockIdx.y * a.G;
  const uint32_t q = a.q, q2 = 2u * a.q;
  load_tile<true>(a, sm, col0, seq0);  // [0, q) or, after the twist, [0, 2q)
  const int GT = a.G * a.TB;
  const int nbf = (a.L >> 1) * GT;
  for (int s = 0; s < a.logL; ++s) {  // bit-reversed in, natural out
    const int h = 1 << s;
    const uint32_t* w = a.w + (size_t)s * a.L;
    const uint32_t* wsh = a.wsh + (size_t)s * a.L;
    for (int e = threadIdx.x; e < nbf; e += blockDim.x) {
      const int c = e & (a.TB - 1);
      const int g = (e >> a.logTB) & (a.G - 1);
      const int k = e >> (a.logTB + a.logG);
      const int l = k & (h - 1);
      const int iu = ((k >> s) << (s + 1)) + l;
      // the stage's table repeats with period 2h over its v-rows: every
      // group reads group 0's entry (row h + l), so a stage touches h words
      const uint32_t tw = __ldg(w + h + l), twsh = __ldg(wsh + h + l);
      uint32_t* pu = sm + (iu * a.G + g) * a.TB + c;
      uint32_t* pv = pu + h * GT;
      uint32_t u = *pu;
      if (u >= q2) u -= q2;
      const uint32_t t = mul_shoup_lazy(*pv, tw, twsh, q);  // [0, 2q)
      *pu = u + t;        // [0, 4q)
      *pv = u + q2 - t;   // (0, 4q)
    }
    __syncthreads();
  }
  // per-row multiply, [0, 2q); each thread stores the elements it multiplied
  const int tile = a.L * GT;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int g = (e >> a.logTB) & (a.G - 1);
    const int i = e >> (a.logTB + a.logG);
    const size_t row = row_of(a, i, seq0 + g);
    sm[e] = mul_shoup_lazy(sm[e], __ldg(b.post + row), __ldg(b.post_sh + row), q);
  }
  store_tile(a, sm, col0, seq0, q);  // last pass: one fold to [0, q)
}

// ---------------------------------------------------------------------------
// ntt_fwd_pass / ntt_inv_pass
// ---------------------------------------------------------------------------

struct NttArgs {
  const uint32_t* x;
  uint32_t* y;
  const uint32_t* w;    // psi_rev (forward) or ipsi_rev (inverse), length n
  const uint32_t* wsh;  // Shoup companions floor(w * 2^32 / q)
  int B, logG, elem_stride, seq_stride, base0, base_step;
  uint32_t q;
  int last;             // last pass: fold to [0, q) (inverse: also scale)
  // forward prologue: centered [x]_{pre_q} re-expanded mod q; PRE_LAZY
  // (pre_q <= 2q) leaves it below 4q, PRE_EXACT reduces it to [0, q)
  int has_pre;
  uint32_t pre_q, pre_half, pre_qmod, pre_mu;  // pre_mu = floor(2^32 / q)
  uint32_t pre_add;                            // 2q - pre_q (PRE_LAZY)
  // inverse global stage 0 with n^-1 folded in
  uint32_t ninv, ninv_sh, w0n, w0n_sh;
};

enum { PRE_NONE = 0, PRE_EXACT = 1, PRE_LAZY = 2 };

constexpr int MAX_ROUND = 4;  // stages per register round: 16-word units

__host__ __device__ constexpr int clog2(int v) { return v <= 1 ? 0 : 1 + clog2(v >> 1); }

// The round plan of a length-2^LOGL pass in forward order: N rounds of
// `size` stages from `start`, as even as possible, larger first (so the
// last round has at least 2 stages when LOGL >= 2).
template <int LOGL>
struct Rounds {
  static constexpr int N = (LOGL + MAX_ROUND - 1) / MAX_ROUND;
  __host__ __device__ static constexpr int size(int i) { return LOGL / N + (i < LOGL % N ? 1 : 0); }
  __host__ __device__ static constexpr int start(int i) { return i == 0 ? 0 : start(i - 1) + size(i - 1); }
};

// Shared-memory layout of one CTA's part of the tile: [g][row(i)][c], TB
// words a row, one padding row every 2^PAD_SHIFT rows when TB < 32 (see the
// note at the top).  In a cluster of 2^LOGC CTAs (G = 1) each holds 2^LOGC-th
// of the rows: CTA r rows [r, r + 1) * 2^(LOGL - LOGC).
template <int LOGL, int TB, int LOGC>
struct Tile {
  static constexpr int ROWS = 1 << (LOGL - LOGC);
  static constexpr bool PADDED = TB < 32 && Rounds<LOGL>::N > 1;
  static constexpr int PAD_SHIFT = Rounds<LOGL>::size(Rounds<LOGL>::N - 1);
  __host__ __device__ static constexpr int row(int i) { return PADDED ? i + (i >> PAD_SHIFT) : i; }
  static constexpr int SEQ_WORDS = (PADDED ? ROWS + (ROWS >> PAD_SHIFT) : ROWS) * TB;
  static constexpr size_t smem_bytes(int G) {
    return Rounds<LOGL>::N > 1 ? (size_t)G * SEQ_WORDS * sizeof(uint32_t) : 0;
  }
};

template <typename F, int... I>
__device__ __forceinline__ void static_for_impl(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

// f(integral_constant<int, 0>), ..., f(integral_constant<int, N - 1>)
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// The digit prologue on x in [0, pre_q).  The first forward stage takes any
// word below 4q, so with pre_q <= 2q the centered value x - pre_q (x >=
// pre_q/2) needs only 2q added: x + 2q - pre_q lies in [2q - pre_q/2, 2q).
__device__ __forceinline__ uint32_t redigit_word(uint32_t x, const NttArgs& a) {
  if (a.has_pre == PRE_LAZY) return x >= a.pre_half ? x + a.pre_add : x;
  uint32_t r = x;
  if (a.pre_q > a.q) {  // x mod q: Shoup multiply by 1, then one fold
    r = x - __umulhi(x, a.pre_mu) * a.q;
    if (r >= a.q) r -= a.q;
  }
  if (x >= a.pre_half)  // sub_mod(r, pre_q mod q) with the borrow branch
    r = (r >= a.pre_qmod) ? r - a.pre_qmod : r + (a.q - a.pre_qmod);
  return r;
}

// The two halves of a cluster barrier: every thread arrives once, then
// waits once, before it arrives again.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;" ::: "memory"); }

// A barrier over every thread of the cluster, with release / acquire order
// on shared memory (the local CTA's and the others').
__device__ __forceinline__ void cluster_sync() { cooperative_groups::this_cluster().sync(); }

// One round: stages [A, A + RS) of the pass (the inverse runs them in
// reverse), over every unit of the tile.  Unit u of sequence g, column c,
// holds rows row0 + m*2^LK, m < 2^RS, row0 = j*2^(LOGL-A) + k, k < 2^LK:
// stage A + s pairs m with m + 2^(RS-s-1) in group (j << s) + (m >> (RS-s)).
// FIRST reads the units from device memory, LAST writes them there; other
// rounds read and write the tile in shared memory.  In a cluster of 2^LOGC
// CTAs, CTA r takes the r-th 2^LOGC-th of each round's units: those of the
// rounds after the first touch its own rows only; the first round's
// (stages 0..RS-1, RS >= LOGC) span every CTA's rows, and its words go to,
// or come from, the CTA that holds them (distributed shared memory).
template <int LOGL, int TB, int LOGC, bool INV, int A, int RS, bool FIRST, bool LAST>
__device__ __forceinline__ void ntt_round(const NttArgs& a, uint32_t* sm, int col0,
                                          int seq0) {
  constexpr int R = 1 << RS;
  constexpr int LOGTB = clog2(TB);
  constexpr int LOGU = LOGL - RS;  // units per (sequence, column)
  constexpr int LK = LOGL - A - RS;
  constexpr int LMASK = (1 << (LOGL - LOGC)) - 1;
  constexpr bool CROSS = A < LOGC;  // the round's units span the cluster
  static_assert(!CROSS || (A == 0 && RS >= LOGC && (INV ? LAST && !FIRST : FIRST && !LAST)),
                "a cluster pass exchanges through the first round's stores (forward) "
                "or the last round's loads (inverse)");
  using T = Tile<LOGL, TB, LOGC>;
  const uint32_t q = a.q, q2 = 2u * a.q;
  int rank = 0;
  uint32_t* peer[1 << LOGC];  // every CTA's tile (cross rounds)
  if constexpr (LOGC > 0) {
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    rank = (int)cl.block_rank();
    if constexpr (CROSS)
      static_for<(1 << LOGC)>([&](auto rc) {
        constexpr int r = decltype(rc)::value;
        peer[r] = cl.map_shared_rank(sm, r);
      });
  }
  const int units = TB << (LOGU - LOGC + a.logG);
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int c = u & (TB - 1);
    const int rest = ((u >> LOGTB) & ((1 << (LOGU - LOGC)) - 1)) | (rank << (LOGU - LOGC));
    const int g = u >> (LOGTB + LOGU - LOGC);
    const int j = rest >> LK;
    const int row0 = (j << (LOGL - A)) | (rest & ((1 << LK) - 1));
    const int sq = seq0 + g;
    const int col = col0 + c;
    const size_t gstep = ((size_t)a.elem_stride * a.B) << LK;
    const size_t gofs = ((size_t)row0 * a.elem_stride + (size_t)sq * a.seq_stride) * a.B + col;
    const int sofs = g * T::SEQ_WORDS + T::row(row0 & LMASK) * TB + c;
    uint32_t* sp = sm + sofs;
    uint32_t v[R];
    if constexpr (FIRST) {
      const bool in = col < a.B;
      const uint32_t* src = a.x + gofs;
      static_for<R>([&](auto mc) {
        constexpr int m = decltype(mc)::value;
        v[m] = in ? src[m * gstep] : 0u;
      });
      if (!INV && a.has_pre)  // after the loads, so that all R are in flight at once
        static_for<R>([&](auto mc) {
          constexpr int m = decltype(mc)::value;
          v[m] = redigit_word(v[m], a);
        });
    } else if constexpr (CROSS) {
      static_for<R>([&](auto mc) {
        constexpr int m = decltype(mc)::value;
        v[m] = peer[(m << LK) >> (LOGL - LOGC)][sofs + T::row((m << LK) & LMASK) * TB];
      });
    } else {
      static_for<R>([&](auto mc) {
        constexpr int m = decltype(mc)::value;
        v[m] = sp[T::row(m << LK) * TB];
      });
    }
    const int tw = a.base0 + sq * a.base_step;
    static_for<RS>([&](auto sc) {
      constexpr int s = INV ? RS - 1 - decltype(sc)::value : decltype(sc)::value;
      constexpr int h = R >> (s + 1);  // the inverse runs the stages down
      const int tw0 = (tw << (A + s)) + (j << s);
      static_for<(1 << s)>([&](auto gc) {
        constexpr int g0 = decltype(gc)::value * 2 * h;
        if (INV && A == 0 && s == 0 && a.last) {  // global stage 0, n^-1 folded in
          static_for<h>([&](auto ic) {
            constexpr int i = g0 + decltype(ic)::value;
            const uint32_t u0 = v[i], u1 = v[i + h];
            v[i] = mul_shoup_lazy(u0 + u1, a.ninv, a.ninv_sh, q);
            v[i + h] = mul_shoup_lazy(u0 + q2 - u1, a.w0n, a.w0n_sh, q);
          });
          return;
        }
        const int t = tw0 + decltype(gc)::value;
        const uint32_t w = __ldg(a.w + t), wsh = __ldg(a.wsh + t);
        static_for<h>([&](auto ic) {
          constexpr int i = g0 + decltype(ic)::value;
          if constexpr (!INV) {  // inputs below 4q, outputs in [0, 4q)
            uint32_t u0 = v[i];
            if (u0 >= q2) u0 -= q2;
            const uint32_t tv = mul_shoup_lazy(v[i + h], w, wsh, q);  // [0, 2q)
            v[i] = u0 + tv;
            v[i + h] = u0 + q2 - tv;
          } else {  // inputs and outputs in [0, 2q)
            const uint32_t u0 = v[i], u1 = v[i + h];
            uint32_t s0 = u0 + u1;
            if (s0 >= q2) s0 -= q2;
            v[i] = s0;
            v[i + h] = mul_shoup_lazy(u0 + q2 - u1, w, wsh, q);
          }
        });
      });
    });
    if constexpr (LAST) {
      if (a.last)  // forward [0, 4q) or inverse [0, 2q) -> [0, q)
        static_for<R>([&](auto mc) {
          constexpr int m = decltype(mc)::value;
          if (!INV && v[m] >= q2) v[m] -= q2;
          if (v[m] >= q) v[m] -= q;
        });
      if (col < a.B) {
        uint32_t* dst = a.y + gofs;
        static_for<R>([&](auto mc) { dst[decltype(mc)::value * gstep] = v[decltype(mc)::value]; });
      }
    } else if constexpr (CROSS) {
      // the kernel arrived at a cluster barrier on entry: every CTA of the
      // cluster runs before its tile is written (each thread has a unit)
      if (u == (int)threadIdx.x) cluster_wait();
      static_for<R>([&](auto mc) {
        constexpr int m = decltype(mc)::value;
        peer[(m << LK) >> (LOGL - LOGC)][sofs + T::row((m << LK) & LMASK) * TB] = v[m];
      });
    } else {
      static_for<R>([&](auto mc) {
        constexpr int m = decltype(mc)::value;
        sp[T::row(m << LK) * TB] = v[m];
      });
    }
  }
}

// Round I of the pass in execution order (the inverse runs the plan's
// rounds from the last), then the rest, a barrier between rounds: over the
// cluster around the round that exchanges across it, else over the CTA.
template <int LOGL, int TB, int LOGC, bool INV, int I>
__device__ __forceinline__ void ntt_rounds(const NttArgs& a, uint32_t* sm, int col0,
                                           int seq0) {
  using P = Rounds<LOGL>;
  constexpr int PR = INV ? P::N - 1 - I : I;
  ntt_round<LOGL, TB, LOGC, INV, P::start(PR), P::size(PR), I == 0, I == P::N - 1>(
      a, sm, col0, seq0);
  if constexpr (I + 1 < P::N) {
    constexpr bool cross = LOGC > 0 && (INV ? I + 2 == P::N : I == 0);
    if constexpr (cross) cluster_sync();
    else __syncthreads();
    ntt_rounds<LOGL, TB, LOGC, INV, I + 1>(a, sm, col0, seq0);
  }
}

// Grid: x = column tiles x 2^LOGC CTAs (a cluster's CTAs share a column
// tile), y = sequence tiles.
template <int LOGL, int TB, int LOGC>
__global__ void __launch_bounds__(1024) ntt_fwd_pass(const __grid_constant__ NttArgs a) {
  extern __shared__ uint32_t sm[];
  if constexpr (LOGC > 0) cluster_arrive();  // waited for before the first remote store
  ntt_rounds<LOGL, TB, LOGC, false, 0>(a, sm, (blockIdx.x >> LOGC) * TB, blockIdx.y << a.logG);
}

template <int LOGL, int TB, int LOGC>
__global__ void __launch_bounds__(1024) ntt_inv_pass(const __grid_constant__ NttArgs a) {
  extern __shared__ uint32_t sm[];
  ntt_rounds<LOGL, TB, LOGC, true, 0>(a, sm, (blockIdx.x >> LOGC) * TB, blockIdx.y << a.logG);
  if constexpr (LOGC > 0) cluster_sync();  // no CTA leaves while others read it
}

template <int LOGL, int TB, int LOGC = 0>
int launch_ntt_pass(const NttArgs& a, bool inverse, int G, int nseq, int threads,
                    void* stream) {
  void (*kernel)(NttArgs) =
      inverse ? ntt_inv_pass<LOGL, TB, LOGC> : ntt_fwd_pass<LOGL, TB, LOGC>;
  const size_t smem = Tile<LOGL, TB, LOGC>::smem_bytes(G);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((a.B + TB - 1) / TB) << LOGC, nseq / G);
  if constexpr (LOGC == 0) {
    kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  } else {
    // each thread must own a unit of the first round (its cluster barrier)
    constexpr int first_units = TB << (LOGL - Rounds<LOGL>::size(0) - LOGC);
    if (G != 1 || nseq != 1 || threads > first_units) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1 << LOGC;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, a);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One forward or GS inverse pass; returns cudaGetLastError() after the
// launch (0 = launched), cudaErrorInvalidValue for a geometry no kernel is
// built for: (L, TB) in {2..1024} x {32}, {1024, 2048} x {16}, {2048, 4096} x {8},
// and (L, 8) over a cluster of 2^log_cluster = L / 2048 CTAs, L in {8192, 16384}.
int lol_ntt_pass(const void* x, void* y, const void* w, const void* wsh,
                 int B, int L, int nseq, int elem_stride, int seq_stride,
                 int base0, int base_step, int G, int TB, int threads,
                 int log_cluster, int inverse, int last, uint32_t q,
                 int has_pre, uint32_t pre_q, uint32_t pre_half,
                 uint32_t pre_qmod, uint32_t pre_mu,
                 uint32_t ninv, uint32_t ninv_sh, uint32_t w0n,
                 uint32_t w0n_sh, void* stream) {
  if (B < 1 || !pow2(L) || L < 2 || !pow2(G) || nseq % G || threads < 32 ||
      threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  NttArgs a{};
  a.x = static_cast<const uint32_t*>(x);
  a.y = static_cast<uint32_t*>(y);
  a.w = static_cast<const uint32_t*>(w);
  a.wsh = static_cast<const uint32_t*>(wsh);
  a.B = B; a.logG = ilog2(G); a.elem_stride = elem_stride; a.seq_stride = seq_stride;
  a.base0 = base0; a.base_step = base_step; a.q = q; a.last = last;
  a.has_pre = !has_pre ? PRE_NONE : pre_q <= 2u * q ? PRE_LAZY : PRE_EXACT;
  a.pre_q = pre_q; a.pre_half = pre_half; a.pre_qmod = pre_qmod; a.pre_mu = pre_mu;
  a.pre_add = 2u * q - pre_q;
  a.ninv = ninv; a.ninv_sh = ninv_sh; a.w0n = w0n; a.w0n_sh = w0n_sh;
  const bool inv = inverse != 0;
  if (log_cluster == 2 && TB == 8 && L == 8192)
    return launch_ntt_pass<13, 8, 2>(a, inv, G, nseq, threads, stream);
  if (log_cluster == 3 && TB == 8 && L == 16384)
    return launch_ntt_pass<14, 8, 3>(a, inv, G, nseq, threads, stream);
  if (log_cluster != 0) return (int)cudaErrorInvalidValue;
#define LOL_PASS(LG, T) \
  case LG: return launch_ntt_pass<LG, T>(a, inv, G, nseq, threads, stream);
  switch (TB) {
    case 32:
      switch (ilog2(L)) {
        LOL_PASS(1, 32) LOL_PASS(2, 32) LOL_PASS(3, 32) LOL_PASS(4, 32) LOL_PASS(5, 32)
        LOL_PASS(6, 32) LOL_PASS(7, 32) LOL_PASS(8, 32) LOL_PASS(9, 32) LOL_PASS(10, 32)
      }
      break;
    case 16:
      switch (ilog2(L)) { LOL_PASS(10, 16) LOL_PASS(11, 16) }
      break;
    case 8:
      switch (ilog2(L)) { LOL_PASS(11, 8) LOL_PASS(12, 8) }
      break;
  }
#undef LOL_PASS
  return (int)cudaErrorInvalidValue;
}

// One route-B inverse pass: st/st_sh the packed per-row stage table of
// this pass's DFT, post/post_sh the (n,) per-row multiplier.
int lol_ntt_invb_pass(const void* x, void* y, const void* st,
                      const void* st_sh, const void* post,
                      const void* post_sh, int B, int L, int nseq,
                      int elem_stride, int seq_stride, int G, int TB,
                      int threads, int last, uint32_t q, void* stream) {
  InvbArgs b;
  if (!set_geometry(b.p, x, y, st, st_sh, B, L, nseq, elem_stride, seq_stride,
                    G, TB, threads, last, q))
    return (int)cudaErrorInvalidValue;
  b.post = static_cast<const uint32_t*>(post);
  b.post_sh = static_cast<const uint32_t*>(post_sh);
  return launch(ntt_invb_pass, b, b.p, threads, stream);
}

const char* lol_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
