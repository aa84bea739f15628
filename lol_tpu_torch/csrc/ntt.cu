// Negacyclic NTT passes along axis 0 of a coefficient-major (n, B) u32
// array, for Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// lol_tpu_torch/ops/cuda/ntt_kernel.py.
//
// Replaces the Pallas kernels lol_tpu/ops/pallas/ntt_kernel.py::_kernel_cross
// and ::_kernel_block, forward (DIT, Harvey-lazy in [0, 4q), optional
// _redigit prologue) and inverse (Gentleman-Sande, lazy in [0, 2q), the
// 1/n scale folded into global stage 0); and ::_kernel_block_invb and
// ::_kernel_cross_invb, the route-B inverse (ntt_invb_pass: a
// DIT-bitrev-input network, Harvey-lazy in [0, 4q), then a multiply by a
// per-row table: the twist after the block DFT, n^-1 psi^-j after the last).
//
// What bounds it on the H100: each pass reads and writes the whole (n, B)
// array once, 8*n*B bytes (128 MiB per pass at n = 2^14, B = 1024), against
// ~7 integer ops per butterfly times n/2*log2(n)*B butterflies.  The design
// keeps every stage of a pass in shared memory, so the array crosses device
// memory once per pass: one pass for n <= 4096 (the whole column tile fits
// in shared memory), two for larger n (the TPU's cross/block split: first the
// S = log2(n/tS) stages that pair rows tS apart, then the log2(tS) stages
// inside contiguous tS-row blocks).
//
// Geometry of one pass: it runs `nseq` independent length-L transforms
// (L = 2^logL) on every column.  Element i of sequence sq lives in row
// i*elem_stride + sq*seq_stride.  Local stage sp, group g uses twiddle
// w[((base0 + sq*base_step) << sp) + g]; this one formula gives the plain
// prefix psi_rev[2^sp + g] for the cross pass and for a single pass
// (base0 = 1, base_step = 0) and the per-block tables of the block pass
// (base0 = P, base_step = 1: global group (P + b)*2^sp + g).
//
// A thread block owns G sequences times TB consecutive columns (TB >= 8, so
// each row segment it loads is at least one 32-byte sector), stages them in
// dynamic shared memory laid out [i][g][c], and runs every stage of the pass
// there with a barrier between stages.  Columns >= B are masked.
//
// The route-B inverse runs the same geometry in the GS inverse's pass order
// (block pass, then cross pass).  Its stage twiddles come from the packed
// per-row tables of the JAX package's _stage_table_bitrev (stage s of a
// length-L pass at w[s*L + i] for v-row i) and its per-row multiplier from
// an (n,) table indexed by the row of the (n, B) array.
//
// PassArgs, the tile loads and stores and the forward and GS stage loops live
// in ntt_common.cuh, which csrc/remote_ntt.cu shares.

#include "ntt_common.cuh"

namespace {

// route B: the pass plus the per-row multiplier (twist or n^-1 psi^-j).  Kept
// out of PassArgs: two more fields there changed ptxas's register allocation
// for ntt_fwd_pass / ntt_inv_pass (29 -> 28 / 27) and slowed the GS inverse
// by ~10% on the H100.
struct InvbArgs {
  PassArgs p;
  const uint32_t* post;
  const uint32_t* post_sh;
};

__global__ void ntt_fwd_pass(PassArgs a) {
  extern __shared__ uint32_t sm[];
  const int col0 = blockIdx.x * a.TB;
  const int seq0 = blockIdx.y * a.G;
  load_tile<false>(a, sm, col0, seq0);
  fwd_stages(a, sm, seq0);
  store_tile(a, sm, col0, seq0, 2u * a.q);
}

__global__ void ntt_inv_pass(PassArgs a) {
  extern __shared__ uint32_t sm[];
  const int col0 = blockIdx.x * a.TB;
  const int seq0 = blockIdx.y * a.G;
  load_tile<true>(a, sm, col0, seq0);
  inv_stages(a, sm, seq0);
  store_tile(a, sm, col0, seq0, a.q);  // inverse values are < 2q: one fold
}

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

}  // namespace

extern "C" {

// One pass; returns cudaGetLastError() after the launch (0 = launched).
int lol_ntt_pass(const void* x, void* y, const void* w, const void* wsh,
                 int B, int L, int nseq, int elem_stride, int seq_stride,
                 int base0, int base_step, int G, int TB, int threads,
                 int inverse, int last, uint32_t q,
                 int has_pre, uint32_t pre_q, uint32_t pre_half,
                 uint32_t pre_qmod, uint32_t pre_mu,
                 uint32_t ninv, uint32_t ninv_sh, uint32_t w0n,
                 uint32_t w0n_sh, void* stream) {
  PassArgs a;
  if (!set_geometry(a, x, y, w, wsh, B, L, nseq, elem_stride, seq_stride, G,
                    TB, threads, last, q))
    return (int)cudaErrorInvalidValue;
  a.base0 = base0; a.base_step = base_step;
  a.has_pre = has_pre; a.pre_q = pre_q; a.pre_half = pre_half;
  a.pre_qmod = pre_qmod; a.pre_mu = pre_mu;
  a.ninv = ninv; a.ninv_sh = ninv_sh; a.w0n = w0n; a.w0n_sh = w0n_sh;
  return launch(inverse ? ntt_inv_pass : ntt_fwd_pass, a, a, threads, stream);
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
