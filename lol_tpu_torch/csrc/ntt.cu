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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct PassArgs {
  const uint32_t* x;
  uint32_t* y;
  const uint32_t* w;    // psi_rev (forward) or ipsi_rev (inverse), length n
  const uint32_t* wsh;  // Shoup companions floor(w * 2^32 / q)
  int B, L, logL, nseq, elem_stride, seq_stride, base0, base_step;
  int G, logG, TB, logTB;  // powers of two
  uint32_t q;
  int last;             // last pass: fold to [0, q) (inverse: also scale)
  // forward prologue: centered [x]_{pre_q} re-expanded mod q
  int has_pre;
  uint32_t pre_q, pre_half, pre_qmod, pre_mu;  // pre_mu = floor(2^32 / q)
  // inverse global stage 0 with n^-1 folded in
  uint32_t ninv, ninv_sh, w0n, w0n_sh;
};

// route B: the pass plus the per-row multiplier (twist or n^-1 psi^-j).  Kept
// out of PassArgs: two more fields there changed ptxas's register allocation
// for ntt_fwd_pass / ntt_inv_pass (29 -> 28 / 27) and slowed the GS inverse
// by ~10% on the H100.
struct InvbArgs {
  PassArgs p;
  const uint32_t* post;
  const uint32_t* post_sh;
};

// (a * w) mod q up to one q, for ANY u32 a and w in [0, q): the Shoup
// quotient estimate is floor(a*w/q) or one less, so the wrapping u32
// difference is the true value, in [0, 2q).
__device__ __forceinline__ uint32_t mul_shoup_lazy(uint32_t a, uint32_t w,
                                                   uint32_t wsh, uint32_t q) {
  return a * w - __umulhi(a, wsh) * q;
}

// _redigit: x in [0, pre_q) -> the centered representative's residue mod q.
__device__ __forceinline__ uint32_t redigit(uint32_t x, const PassArgs& a) {
  uint32_t r = x;
  if (a.pre_q > a.q) {  // x mod q: Shoup multiply by 1, then one fold
    r = x - __umulhi(x, a.pre_mu) * a.q;
    if (r >= a.q) r -= a.q;
  }
  if (x >= a.pre_half)  // sub_mod(r, pre_q mod q) with the borrow branch
    r = (r >= a.pre_qmod) ? r - a.pre_qmod : r + (a.q - a.pre_qmod);
  return r;
}

__device__ __forceinline__ size_t row_of(const PassArgs& a, int i, int sq) {
  return (size_t)i * a.elem_stride + (size_t)sq * a.seq_stride;
}

template <bool INVERSE>
__device__ __forceinline__ void load_tile(const PassArgs& a, uint32_t* sm,
                                          int col0, int seq0) {
  const int tile = a.L * a.G * a.TB;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int c = e & (a.TB - 1);
    const int g = (e >> a.logTB) & (a.G - 1);
    const int i = e >> (a.logTB + a.logG);
    const int col = col0 + c;
    uint32_t v = 0;
    if (col < a.B) {
      v = a.x[row_of(a, i, seq0 + g) * a.B + col];
      if (!INVERSE && a.has_pre) v = redigit(v, a);
    }
    sm[e] = v;
  }
  __syncthreads();
}

__device__ __forceinline__ void store_tile(const PassArgs& a,
                                           const uint32_t* sm, int col0,
                                           int seq0, uint32_t fold_hi) {
  const int tile = a.L * a.G * a.TB;
  const uint32_t q = a.q;
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int col = col0 + (e & (a.TB - 1));
    if (col >= a.B) continue;
    const int g = (e >> a.logTB) & (a.G - 1);
    const int i = e >> (a.logTB + a.logG);
    uint32_t v = sm[e];
    if (a.last) {
      if (v >= fold_hi) v -= fold_hi;  // forward: [0, 4q) -> [0, 2q)
      if (v >= q) v -= q;
    }
    a.y[row_of(a, i, seq0 + g) * a.B + col] = v;
  }
}

__global__ void ntt_fwd_pass(PassArgs a) {
  extern __shared__ uint32_t sm[];
  const int col0 = blockIdx.x * a.TB;
  const int seq0 = blockIdx.y * a.G;
  const uint32_t q = a.q, q2 = 2u * a.q;
  load_tile<false>(a, sm, col0, seq0);
  const int GT = a.G * a.TB;
  const int nbf = (a.L >> 1) * GT;
  for (int sp = 0; sp < a.logL; ++sp) {
    const int lt = a.logL - sp - 1;  // t = L >> (sp + 1)
    const int t = 1 << lt;
    for (int e = threadIdx.x; e < nbf; e += blockDim.x) {
      const int c = e & (a.TB - 1);
      const int g = (e >> a.logTB) & (a.G - 1);
      const int k = e >> (a.logTB + a.logG);
      const int grp = k >> lt;
      const int iu = (grp << (lt + 1)) + (k & (t - 1));
      const int tw = ((a.base0 + (seq0 + g) * a.base_step) << sp) + grp;
      const uint32_t w = __ldg(a.w + tw), wsh = __ldg(a.wsh + tw);
      uint32_t* pu = sm + (iu * a.G + g) * a.TB + c;
      uint32_t* pv = pu + t * GT;
      uint32_t u = *pu;
      if (u >= q2) u -= q2;
      const uint32_t tv = mul_shoup_lazy(*pv, w, wsh, q);  // [0, 2q)
      *pu = u + tv;        // [0, 4q)
      *pv = u + q2 - tv;   // (0, 4q)
    }
    __syncthreads();
  }
  store_tile(a, sm, col0, seq0, q2);
}

__global__ void ntt_inv_pass(PassArgs a) {
  extern __shared__ uint32_t sm[];
  const int col0 = blockIdx.x * a.TB;
  const int seq0 = blockIdx.y * a.G;
  const uint32_t q = a.q, q2 = 2u * a.q;
  load_tile<true>(a, sm, col0, seq0);
  const int GT = a.G * a.TB;
  const int nbf = (a.L >> 1) * GT;
  for (int sp = a.logL - 1; sp >= 0; --sp) {
    const int lt = a.logL - sp - 1;
    const int t = 1 << lt;
    const bool scale = a.last && sp == 0;  // global stage 0: n^-1 folded in
    for (int e = threadIdx.x; e < nbf; e += blockDim.x) {
      const int c = e & (a.TB - 1);
      const int g = (e >> a.logTB) & (a.G - 1);
      const int k = e >> (a.logTB + a.logG);
      const int grp = k >> lt;
      const int iu = (grp << (lt + 1)) + (k & (t - 1));
      uint32_t* pu = sm + (iu * a.G + g) * a.TB + c;
      uint32_t* pv = pu + t * GT;
      const uint32_t u = *pu, v = *pv;  // both in [0, 2q)
      if (scale) {
        *pu = mul_shoup_lazy(u + v, a.ninv, a.ninv_sh, q);
        *pv = mul_shoup_lazy(u + q2 - v, a.w0n, a.w0n_sh, q);
      } else {
        const int tw = ((a.base0 + (seq0 + g) * a.base_step) << sp) + grp;
        const uint32_t w = __ldg(a.w + tw), wsh = __ldg(a.wsh + tw);
        uint32_t s = u + v;
        if (s >= q2) s -= q2;
        *pu = s;
        *pv = mul_shoup_lazy(u + q2 - v, w, wsh, q);
      }
    }
    __syncthreads();
  }
  store_tile(a, sm, col0, seq0, q);  // inverse values are < 2q: one fold
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

bool pow2(int v) { return v >= 1 && (v & (v - 1)) == 0; }

int ilog2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

// Checks and fills the pass geometry shared by every kernel; false if the
// geometry is one the kernels cannot run.
bool set_geometry(PassArgs& a, const void* x, void* y, const void* w,
                  const void* wsh, int B, int L, int nseq, int elem_stride,
                  int seq_stride, int G, int TB, int threads, int last,
                  uint32_t q) {
  if (B < 1 || !pow2(L) || !pow2(G) || !pow2(TB) || nseq % G ||
      threads < 32 || threads > 1024)
    return false;
  a = PassArgs{};
  a.x = static_cast<const uint32_t*>(x);
  a.y = static_cast<uint32_t*>(y);
  a.w = static_cast<const uint32_t*>(w);
  a.wsh = static_cast<const uint32_t*>(wsh);
  a.B = B; a.L = L; a.nseq = nseq; a.elem_stride = elem_stride;
  a.seq_stride = seq_stride; a.G = G; a.TB = TB; a.q = q; a.last = last;
  a.logL = ilog2(L);
  a.logG = ilog2(G);
  a.logTB = ilog2(TB);
  return true;
}

// Opts the kernel into pass a's tile of dynamic shared memory and launches
// it on args; returns cudaGetLastError() after the launch (0 = launched).
template <typename Args>
int launch(void (*kernel)(Args), const Args& args, const PassArgs& a,
           int threads, void* stream) {
  const size_t smem = (size_t)a.L * a.G * a.TB * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.B + a.TB - 1) / a.TB, a.nseq / a.G);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
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
