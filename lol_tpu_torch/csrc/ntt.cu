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
// i*elem_stride + sq*seq_stride.  In the forward and GS networks local stage
// sp, group g uses twiddle w[((base0 + sq*base_step) << sp) + g] (route B:
// below); this one formula gives the plain
// prefix psi_rev[2^sp + g] for the cross pass and for a single pass
// (base0 = 1, base_step = 0) and the per-block tables of the block pass
// (base0 = P, base_step = 1: global group (P + b)*2^sp + g).  One pass for
// n <= 4096 (the whole column tile fits in shared memory), two for larger n
// (first the stages that pair rows WINDOW apart, then the stages inside
// contiguous WINDOW-row blocks); a thread block owns G sequences times TB
// consecutive columns, and columns >= B are masked.
//
// What bounds the pass kernels on the H100: ~9 u32 ops per butterfly (the
// Shoup multiply and the lazy folds), n/2*log2(n)*B butterflies, and route
// B's one Shoup multiply a word per pass, against 8*n*B bytes per pass.
// Their design spends the instruction slots on those ops:
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
//   CTAs (`ntt_cm`'s schedule, which the ring's phase B shares; route B
//   takes it at 2^14 only: PERF.md).  The CTAs share an (n, 8) column tile, CTA r
//   holding rows [r, r + 1) * 2048 in its shared memory.
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
// - Route B (ntt_invb_pass) is the same round kernel on another network
//   (Net::INVB in csrc/ntt_rounds.cuh): GS's stage order (its stage s_b pairs
//   rows 2^s_b apart, stride 1 first), the forward's DIT butterfly, each
//   butterfly's twiddle read from the packed per-row stage table of the JAX
//   package's _stage_table_bitrev (stage s_b of a length-L pass at w[s_b*L +
//   i] for v-row i) at the index its row's low bits give, and the per-row
//   multiplier (the twist after the block DFT, n^-1 psi^-j after the last)
//   applied in the last round's registers before the store, from an (n,)
//   table indexed by the row of the (n, B) array.

#include "ntt_rounds.cuh"

namespace {

// route B: the pass plus the per-row multiplier (twist or n^-1 psi^-j).
struct InvbArgs {
  NttArgs a;  // w / wsh: the pass's packed stage table
  const uint32_t* post;
  const uint32_t* post_sh;
};

// Route B's words: x in, y out, and the multiplier of its last round.
struct InvbIO : PassIO {
  const uint32_t* post;
  const uint32_t* post_sh;
};

// Grid: see launch_rounds.
template <int LOGL, int TB, int LOGC>
__global__ void __launch_bounds__(1024) ntt_fwd_pass(const __grid_constant__ NttArgs a) {
  extern __shared__ uint32_t sm[];
  if constexpr (LOGC > 0) cluster_arrive();  // waited for before the first remote store
  ntt_rounds<LOGL, TB, LOGC, Net::FWD, 0>(a, sm, (blockIdx.x >> LOGC) * TB, blockIdx.y << a.logG);
}

template <int LOGL, int TB, int LOGC>
__global__ void __launch_bounds__(1024) ntt_inv_pass(const __grid_constant__ NttArgs a) {
  extern __shared__ uint32_t sm[];
  ntt_rounds<LOGL, TB, LOGC, Net::GS, 0>(a, sm, (blockIdx.x >> LOGC) * TB, blockIdx.y << a.logG);
  if constexpr (LOGC > 0) cluster_sync();  // no CTA leaves while others read it
}

template <int LOGL, int TB, int LOGC>
__global__ void __launch_bounds__(1024) ntt_invb_pass(const __grid_constant__ InvbArgs b) {
  extern __shared__ uint32_t sm[];
  ntt_rounds<LOGL, TB, LOGC, Net::INVB, 0>(b.a, sm, (blockIdx.x >> LOGC) * TB,
                                           blockIdx.y << b.a.logG, InvbIO{{}, b.post, b.post_sh});
  if constexpr (LOGC > 0) cluster_sync();  // no CTA leaves while others read it
}

// The checks and the fields shared by both entries; false for a geometry that
// no kernel takes.
bool pass_args(NttArgs& a, const void* x, void* y, const void* w, const void* wsh, int B,
               int L, int nseq, int elem_stride, int seq_stride, int G, int threads, int last,
               uint32_t q) {
  if (B < 1 || !pow2(L) || !pow2(G) || nseq % G || threads < 32 ||
      threads > 1024 || threads % 32)
    return false;
  a = NttArgs{};
  a.x = static_cast<const uint32_t*>(x);
  a.y = static_cast<uint32_t*>(y);
  a.w = static_cast<const uint32_t*>(w);
  a.wsh = static_cast<const uint32_t*>(wsh);
  a.B = B; a.logG = ilog2(G); a.elem_stride = elem_stride; a.seq_stride = seq_stride;
  a.q = q; a.last = last;
  return true;
}

}  // namespace

extern "C" {

// One forward or GS inverse pass; returns cudaGetLastError() after the
// launch (0 = launched), cudaErrorInvalidValue for a geometry no kernel is
// built for (with_pass_tile).
int lol_ntt_pass(const void* x, void* y, const void* w, const void* wsh,
                 int B, int L, int nseq, int elem_stride, int seq_stride,
                 int base0, int base_step, int G, int TB, int threads,
                 int log_cluster, int inverse, int last, uint32_t q,
                 int has_pre, uint32_t pre_q, uint32_t pre_half,
                 uint32_t pre_qmod, uint32_t pre_mu,
                 uint32_t ninv, uint32_t ninv_sh, uint32_t w0n,
                 uint32_t w0n_sh, void* stream) {
  NttArgs a;
  if (!pass_args(a, x, y, w, wsh, B, L, nseq, elem_stride, seq_stride, G, threads, last, q))
    return (int)cudaErrorInvalidValue;
  a.base0 = base0; a.base_step = base_step;
  a.has_pre = !has_pre ? PRE_NONE : pre_q <= 2u * q ? PRE_LAZY : PRE_EXACT;
  a.pre_q = pre_q; a.pre_half = pre_half; a.pre_qmod = pre_qmod; a.pre_mu = pre_mu;
  a.pre_add = 2u * q - pre_q;
  a.ninv = ninv; a.ninv_sh = ninv_sh; a.w0n = w0n; a.w0n_sh = w0n_sh;
  return with_pass_tile(L, TB, log_cluster, [&](auto lg, auto tb, auto lc) {
    constexpr int LOGL = decltype(lg)::value, T = decltype(tb)::value, LOGC = decltype(lc)::value;
    void (*kernel)(NttArgs) = inverse ? ntt_inv_pass<LOGL, T, LOGC> : ntt_fwd_pass<LOGL, T, LOGC>;
    return launch_rounds<LOGL, T, LOGC>(kernel, a, B, G, nseq, threads, stream);
  });
}

// One route-B inverse pass, of lol_ntt_pass's geometry: st / st_sh the
// packed per-row stage table of this pass's DFT, post / post_sh the (n,)
// per-row multiplier; last: fold the output to [0, q) (else it stays in
// [0, 2q)).  Returns as lol_ntt_pass; route B has no 4-CTA cluster pass
// (it runs n = 8192 in two passes) and no length-1 pass, so those
// geometries are refused too.
int lol_ntt_invb_pass(const void* x, void* y, const void* st, const void* st_sh,
                      const void* post, const void* post_sh, int B, int L, int nseq,
                      int elem_stride, int seq_stride, int G, int TB, int threads,
                      int log_cluster, int last, uint32_t q, void* stream) {
  InvbArgs b;
  if (!pass_args(b.a, x, y, st, st_sh, B, L, nseq, elem_stride, seq_stride, G, threads, last,
                 q))
    return (int)cudaErrorInvalidValue;
  b.post = static_cast<const uint32_t*>(post);
  b.post_sh = static_cast<const uint32_t*>(post_sh);
  return with_pass_tile(L, TB, log_cluster, [&](auto lg, auto tb, auto lc) {
    constexpr int LOGL = decltype(lg)::value, T = decltype(tb)::value, LOGC = decltype(lc)::value;
    if constexpr (LOGC == 2 || LOGL == 0)
      return (int)cudaErrorInvalidValue;
    else
      return launch_rounds<LOGL, T, LOGC>(ntt_invb_pass<LOGL, T, LOGC>, b, B, G, nseq, threads,
                                          stream);
  });
}

const char* lol_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
