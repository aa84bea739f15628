// The register-round core of every NTT pass kernel, shared by csrc/ntt.cu
// (ntt_fwd_pass, ntt_inv_pass, ntt_invb_pass) and csrc/remote_ntt.cu (the
// ring's gather and scatter passes): the pass arguments, the Shoup multiply,
// the round plan, the tile layout, one round and the rounds of a pass, where a
// pass's words come from and go to, and the host-side dispatch and launch.
// The design is described at the top of csrc/ntt.cu.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>
#include <utility>

namespace {

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

// The network a pass runs.  FWD: the forward DIT network, stages in order,
// Harvey-lazy in [0, 4q), the digit prologue.  GS: the Gentleman-Sande
// inverse, stages in reverse, lazy in [0, 2q), n^-1 folded into global stage
// 0.  INVB: route B's DIT-bitrev-input network, GS's stage order with FWD's
// butterfly, each butterfly's twiddle taken by its row's low bits from the
// packed per-row stage table, and a per-row multiplier before the last
// round's stores (see ntt_round).
enum class Net { FWD, GS, INVB };

constexpr int MAX_ROUND = 4;  // stages per register round: 16-word units

// (a * w) mod q up to one q, for ANY u32 a and w in [0, q): the Shoup
// quotient estimate is floor(a*w/q) or one less, so the wrapping u32
// difference is the true value, in [0, 2q).
__device__ __forceinline__ uint32_t mul_shoup_lazy(uint32_t a, uint32_t w,
                                                   uint32_t wsh, uint32_t q) {
  return a * w - __umulhi(a, wsh) * q;
}

// The DIT butterfly (x, y) <- (x + w*y, x - w*y) on words below 4q, outputs
// in [0, 4q).
__device__ __forceinline__ void dit_butterfly(uint32_t& x, uint32_t& y, uint32_t w,
                                              uint32_t wsh, uint32_t q, uint32_t q2) {
  uint32_t u0 = x;
  if (u0 >= q2) u0 -= q2;
  const uint32_t tv = mul_shoup_lazy(y, w, wsh, q);  // [0, 2q)
  x = u0 + tv;
  y = u0 + q2 - tv;
}

bool pow2(int v) { return v >= 1 && (v & (v - 1)) == 0; }

int ilog2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

__host__ __device__ constexpr int clog2(int v) { return v <= 1 ? 0 : 1 + clog2(v >> 1); }

// The round plan of a length-2^LOGL pass in forward order: N rounds of
// `size` stages from `start`, as even as possible, larger first (so the
// last round has at least 2 stages when LOGL >= 2).  A length-1 pass (LOGL =
// 0, the m = 2 ring) is one round of no stages: its loads, the digit
// prologue, the inverse's n^-1 and the fold.
template <int LOGL>
struct Rounds {
  static constexpr int N = LOGL == 0 ? 1 : (LOGL + MAX_ROUND - 1) / MAX_ROUND;
  __host__ __device__ static constexpr int size(int i) { return LOGL / N + (i < LOGL % N ? 1 : 0); }
  __host__ __device__ static constexpr int start(int i) { return i == 0 ? 0 : start(i - 1) + size(i - 1); }
};

// Shared-memory layout of one CTA's part of the tile: [g][row(i)][c], TB
// words a row, one padding row every 2^PAD_SHIFT rows when TB < 32 (see the
// note at the top of csrc/ntt.cu).  In a cluster of 2^LOGC CTAs (G = 1) each
// holds 2^LOGC-th of the rows: CTA r rows [r, r + 1) * 2^(LOGL - LOGC).
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

// Where a pass's words come from (its first round's loads) and go to (its
// last round's stores): word m of a unit of the round of stages [A, A + RS)
// lies at src / dst<A, RS, m>(a) + gofs + m * gstep (see ntt_round).  A pass
// of ntt_fwd_pass / ntt_inv_pass / ntt_invb_pass reads x and writes y; route
// B's policy (csrc/ntt.cu) also gives its per-row multiplier, post / post_sh.
struct PassIO {
  template <int A, int RS, int M>
  __device__ __forceinline__ const uint32_t* src(const NttArgs& a) const { return a.x; }
  template <int A, int RS, int M>
  __device__ __forceinline__ uint32_t* dst(const NttArgs& a) const { return a.y; }
};

// One round: stages [A, A + RS) of the pass (GS and route B run them in
// reverse), over every unit of the tile.  Unit u of sequence g, column c,
// holds rows row0 + m*2^LK, m < 2^RS, row0 = j*2^(LOGL-A) + k, k < 2^LK:
// stage A + s pairs m with m + 2^(RS-s-1) in group (j << s) + (m >> (RS-s)).
// FIRST reads the units from device memory, LAST writes them there, at the
// addresses `io` gives; other rounds read and write the tile in shared
// memory.  In a cluster of 2^LOGC CTAs, CTA r takes the r-th 2^LOGC-th of
// each round's units: those of the rounds after the first touch its own
// rows only; the first round's (stages 0..RS-1, RS >= LOGC) span every CTA's
// rows, and its words go to, or come from, the CTA that holds them
// (distributed shared memory).
//
// Route B (Net::INVB): its stage s_b = LOGL-1-(A+s) pairs rows h_b = 2^s_b
// apart, and the butterfly of u row r takes entry h_b + (r mod h_b) of the
// stage's row of the packed (log2 L, L) table, r mod h_b = k + (m mod
// 2^(RS-s-1)) * 2^LK: still R - 1 twiddle pairs a unit and round.  Its last
// round multiplies word m by post[row] (Shoup, lazy), row = its (n, B) row.
template <int LOGL, int TB, int LOGC, Net NET, int A, int RS, bool FIRST, bool LAST,
          typename IO = PassIO>
__device__ __forceinline__ void ntt_round(const NttArgs& a, uint32_t* sm, int col0,
                                          int seq0, const IO& io = IO{}) {
  constexpr bool INV = NET != Net::FWD;  // the stages run down
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
    const int k = rest & ((1 << LK) - 1);
    const int row0 = (j << (LOGL - A)) | k;
    const int sq = seq0 + g;
    const int col = col0 + c;
    const size_t gstep = ((size_t)a.elem_stride * a.B) << LK;
    const size_t gofs = ((size_t)row0 * a.elem_stride + (size_t)sq * a.seq_stride) * a.B + col;
    const int sofs = g * T::SEQ_WORDS + T::row(row0 & LMASK) * TB + c;
    uint32_t* sp = sm + sofs;
    uint32_t v[R];
    if constexpr (FIRST) {
      const bool in = col < a.B;
      static_for<R>([&](auto mc) {
        constexpr int m = decltype(mc)::value;
        const uint32_t* src = io.template src<A, RS, m>(a) + gofs;
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
      if constexpr (NET == Net::INVB) {  // inputs below 4q, outputs in [0, 4q)
        constexpr int stage_row = (LK + RS - 1 - s) << LOGL;  // s_b * L
        static_for<h>([&](auto ic) {
          constexpr int i0 = decltype(ic)::value;
          const int t = stage_row + ((h + i0) << LK) + k;
          const uint32_t w = __ldg(a.w + t), wsh = __ldg(a.wsh + t);
          static_for<(1 << s)>([&](auto gc) {
            constexpr int i = decltype(gc)::value * 2 * h + i0;
            dit_butterfly(v[i], v[i + h], w, wsh, q, q2);
          });
        });
      } else {
        const int tw0 = (tw << (A + s)) + (j << s);
        static_for<(1 << s)>([&](auto gc) {
          constexpr int g0 = decltype(gc)::value * 2 * h;
          if (NET == Net::GS && A == 0 && s == 0 && a.last) {  // global stage 0, n^-1 folded in
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
              dit_butterfly(v[i], v[i + h], w, wsh, q, q2);
            } else {  // inputs and outputs in [0, 2q)
              const uint32_t u0 = v[i], u1 = v[i + h];
              uint32_t s0 = u0 + u1;
              if (s0 >= q2) s0 -= q2;
              v[i] = s0;
              v[i + h] = mul_shoup_lazy(u0 + q2 - u1, w, wsh, q);
            }
          });
        });
      }
    });
    if constexpr (LAST) {
      if constexpr (NET == Net::GS && RS == 0) {  // no stage 0 to fold n^-1 into
        if (a.last) v[0] = mul_shoup_lazy(v[0], a.ninv, a.ninv_sh, q);
      }
      if constexpr (NET == Net::INVB) {  // the per-row multiplier: [0, 4q) -> [0, 2q)
        const int prow = row0 * a.elem_stride + sq * a.seq_stride;
        const int pstep = a.elem_stride << LK;
        static_for<R>([&](auto mc) {
          constexpr int m = decltype(mc)::value;
          const int r = prow + m * pstep;
          v[m] = mul_shoup_lazy(v[m], __ldg(io.post + r), __ldg(io.post_sh + r), q);
        });
      }
      if (a.last)  // forward [0, 4q) or inverse [0, 2q) -> [0, q)
        static_for<R>([&](auto mc) {
          constexpr int m = decltype(mc)::value;
          if (!INV && v[m] >= q2) v[m] -= q2;
          if (v[m] >= q) v[m] -= q;
        });
      if (col < a.B)
        static_for<R>([&](auto mc) {
          constexpr int m = decltype(mc)::value;
          uint32_t* dst = io.template dst<A, RS, m>(a) + gofs;
          dst[m * gstep] = v[m];
        });
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

// Round I of the pass in execution order (GS and route B run the plan's
// rounds from the last), then the rest, a barrier between rounds: over the
// cluster around the round that exchanges across it, else over the CTA.
template <int LOGL, int TB, int LOGC, Net NET, int I, typename IO = PassIO>
__device__ __forceinline__ void ntt_rounds(const NttArgs& a, uint32_t* sm, int col0,
                                           int seq0, const IO& io = IO{}) {
  using P = Rounds<LOGL>;
  constexpr bool INV = NET != Net::FWD;
  constexpr int PR = INV ? P::N - 1 - I : I;
  ntt_round<LOGL, TB, LOGC, NET, P::start(PR), P::size(PR), I == 0, I == P::N - 1>(
      a, sm, col0, seq0, io);
  if constexpr (I + 1 < P::N) {
    constexpr bool cross = LOGC > 0 && (INV ? I + 2 == P::N : I == 0);
    if constexpr (cross) cluster_sync();
    else __syncthreads();
    ntt_rounds<LOGL, TB, LOGC, NET, I + 1>(a, sm, col0, seq0, io);
  }
}

// Calls f(LOGL, TB, LOGC), each a std::integral_constant, for a pass that
// the round kernels are built for: (L, TB) in {1..1024} x {32}, {1024,
// 2048} x {16}, {2048, 4096} x {8}, and (L, 8) over a cluster of
// 2^log_cluster = L / 2048 CTAs, L in {8192, 16384}; returns what f returns,
// or cudaErrorInvalidValue for any other geometry.
template <typename F>
int with_pass_tile(int L, int TB, int log_cluster, F&& f) {
  using std::integral_constant;
#define LOL_TILE(LG, T, C) \
  return f(integral_constant<int, LG>{}, integral_constant<int, T>{}, integral_constant<int, C>{})
  if (log_cluster == 2 && TB == 8 && L == 8192) LOL_TILE(13, 8, 2);
  if (log_cluster == 3 && TB == 8 && L == 16384) LOL_TILE(14, 8, 3);
  if (log_cluster != 0 || !pow2(L)) return (int)cudaErrorInvalidValue;
  switch (TB) {
    case 32:
      switch (ilog2(L)) {
        case 0: LOL_TILE(0, 32, 0);
        case 1: LOL_TILE(1, 32, 0);
        case 2: LOL_TILE(2, 32, 0);
        case 3: LOL_TILE(3, 32, 0);
        case 4: LOL_TILE(4, 32, 0);
        case 5: LOL_TILE(5, 32, 0);
        case 6: LOL_TILE(6, 32, 0);
        case 7: LOL_TILE(7, 32, 0);
        case 8: LOL_TILE(8, 32, 0);
        case 9: LOL_TILE(9, 32, 0);
        case 10: LOL_TILE(10, 32, 0);
      }
      break;
    case 16:
      switch (ilog2(L)) {
        case 10: LOL_TILE(10, 16, 0);
        case 11: LOL_TILE(11, 16, 0);
      }
      break;
    case 8:
      switch (ilog2(L)) {
        case 11: LOL_TILE(11, 8, 0);
        case 12: LOL_TILE(12, 8, 0);
      }
      break;
  }
#undef LOL_TILE
  return (int)cudaErrorInvalidValue;
}

// Launches a round kernel of a length-2^LOGL pass with column tile TB over
// clusters of 2^LOGC CTAs on `args`, with `Tile`'s shared memory.  Grid: x
// = column tiles x 2^LOGC CTAs (a cluster's CTAs share a column tile), y =
// sequence tiles.  Returns cudaGetLastError() after the launch (0 =
// launched), or the error that refused it.
template <int LOGL, int TB, int LOGC, typename Args>
int launch_rounds(void (*kernel)(Args), const Args& args, int B, int G, int nseq, int threads,
                  void* stream) {
  const size_t smem = Tile<LOGL, TB, LOGC>::smem_bytes(G);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(((B + TB - 1) / TB) << LOGC, nseq / G);
  if constexpr (LOGC == 0) {
    kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args);
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
    err = cudaLaunchKernelEx(&cfg, kernel, args);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace
