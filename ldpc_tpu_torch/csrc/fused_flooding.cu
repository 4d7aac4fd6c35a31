// Whole-decode flooding min-sum kernel for QC LDPC codes, for Hopper (sm_90a).
//
// Replaces ldpc_tpu/decode/pallas_fused.py::_make_kernel (K4, launched by
// qc_fused_decode_batch), with the quantizer K2 (common.cuh) and the
// syndrome K3 inlined. Its plain PyTorch version, with the same loops, op
// order and rounding points, is
// ldpc_tpu_torch/decode/fused.py::_fused_flooding_plain.
//
// Design. One CTA decodes one frame; blockDim.x = lift L. The frame's whole
// message state lives in shared memory for all T iterations: the
// check-aligned messages M[NB, L] (slot u of block b is the edge between
// check u of row(b) and variable (u + shift_b) mod L of col(b)) and the
// channel LLRs llr[nb, L], both in the storage type S.
//   - check-node phase: thread u owns check u of every base row and reads
//     and writes only M[b][u]; rows are independent, so no ordering;
//   - variable-node phase: thread v owns variable v of every base column
//     and touches M[b][(v - shift_b) mod L] for the column's blocks; again
//     no two threads share a slot.
// One __syncthreads() between the phases is the only ordering needed.
// At t = T-1 thread v overwrites llr[j][v] (which only it reads in this
// phase) with the stored posterior, which K3 and the output then read.
//
// What bounds it. At the zoo's (9472, 8192) code (5x37 base, L = 256) the
// state is (185 + 37) * 256 * 2 B = 113,664 B per CTA in bf16 (227,328 B
// in f32), so 2 CTAs (bf16) or 1 (f32) fit an SM. Device memory sees only
// the LLRs in and the bits or posterior out, once each; the kernel is
// bound by its per-edge arithmetic (about 30 float32 operations per edge
// and iteration with the bc=3 staircase and the bv=8 uniform quantizer)
// and by the latency of each thread's serial block loops at that low
// occupancy, not by bandwidth.
//
// Numerics: see common.cuh. The variable-node sums run in S, in the
// column's block order, each add rounded to S, as the TPU kernel does.

#include "common.cuh"

namespace {

struct FloodParams {
  const void* llr;      // [B, n] S
  void* post;           // [B, n] S, or null (lean)
  int8_t* bits;         // [B, n] int8, or null (full)
  uint8_t* ok;          // [B]
  const float* beta;    // [T, NB]
  const float* alpha;   // [T, NB]
  const float* vthr;    // [T, vthr_w]
  const float* vqp;     // [T, 2]
  const int* row_ptr;   // [mb + 1]; row i owns blocks row_ptr[i]..row_ptr[i+1)
  const int* col_ptr;   // [nb + 1]; column j owns col_blocks[col_ptr[j]..)
  const int* col_blocks;   // [NB] block ids, column by column, in row order
  const int* block_col;    // [NB]
  const int* block_shift;  // [NB]
  int nb, mb, NB, L, T;
  int vthr_w, with_vqdq, v_mode, v_levels;
  Variant var;
};

template <typename S>
__global__ void fused_flooding_kernel(FloodParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = p.L;
  const int n = p.nb * L;
  S* llr_s = reinterpret_cast<S*>(smem_raw);  // later the stored posterior
  S* msg = llr_s + n;                          // [NB, L], check-aligned

  const int u = threadIdx.x;
  const size_t f = blockIdx.x;
  const S* llr_g = static_cast<const S*>(p.llr) + f * n;

  for (int j = 0; j < p.nb; ++j) llr_s[j * L + u] = llr_g[j * L + u];
  __syncthreads();
  // the first v2c is the rolled channel LLR itself (no quantizer)
  for (int b = 0; b < p.NB; ++b) {
    int v = u + p.block_shift[b];
    v = (v >= L) ? v - L : v;
    msg[b * L + u] = llr_s[p.block_col[b] * L + v];
  }
  __syncthreads();

  const float kInf = __int_as_float(0x7f800000);
  for (int t = 0; t < p.T; ++t) {
    const float* bt = p.beta + t * p.NB;
    const float* at = p.alpha + t * p.NB;
    // ---- check-node update: thread u = check u of every base row
    for (int i = 0; i < p.mb; ++i) {
      const int b0 = p.row_ptr[i];
      const int dc = p.row_ptr[i + 1] - b0;
      float min1 = 0.0f, min2 = kInf;
      int argm = 0, neg_cnt = 0;
      for (int k = 0; k < dc; ++k) {
        const float x = ld(&msg[(b0 + k) * L + u]);
        const float mk = fabsf(x);
        const int negk = x < 0.0f;
        if (k == 0) {
          min1 = mk;
          min2 = kInf;
          argm = 0;
          neg_cnt = negk;
        } else {
          const bool new_min = mk < min1;
          min2 = new_min ? min1 : nan_min(min2, mk);
          min1 = new_min ? mk : min1;
          argm = new_min ? k : argm;
          neg_cnt += negk;
        }
      }
      if (dc == 1) min2 = min1;  // degree-1 checks
      for (int k = 0; k < dc; ++k) {
        const int b = b0 + k;
        const float x = ld(&msg[b * L + u]);
        const float loo_mag = (argm == k) ? min2 : min1;
        const int loo_neg = (neg_cnt - (int)(x < 0.0f)) & 1;
        const float loo_sign = 1.0f - 2.0f * (float)loo_neg;
        st(&msg[b * L + u], c2v(p.var, loo_sign, loo_mag, bt[b], at[b], t));
      }
    }
    __syncthreads();

    // ---- variable-node update: thread v = variable v of every base column
    const int v = u;
    for (int j = 0; j < p.nb; ++j) {
      const int c0 = p.col_ptr[j];
      const int dv = p.col_ptr[j + 1] - c0;
      float colsum = 0.0f;
      for (int k = 0; k < dv; ++k) {
        const int b = p.col_blocks[c0 + k];
        int c = v - p.block_shift[b];
        c = (c < 0) ? c + L : c;
        const float ca = ld(&msg[b * L + c]);
        colsum = (k == 0) ? ca : rnd<S>(colsum + ca);
      }
      const float l = ld(&llr_s[j * L + v]);
      for (int k = 0; k < dv; ++k) {
        const int b = p.col_blocks[c0 + k];
        int c = v - p.block_shift[b];
        c = (c < 0) ? c + L : c;
        const float ext = rnd<S>(colsum - ld(&msg[b * L + c]));
        // alpha inside the CN: a storage-type add; otherwise the float32
        // weight promotes llr + alpha * ext to float32
        float nv = p.var.alpha_in_cn ? rnd<S>(l + ext) : l + at[b] * ext;
        if (p.with_vqdq)
          nv = qdq(nv, t, p.v_mode, p.v_levels, p.vthr, p.vthr_w, p.vqp);
        st(&msg[b * L + c], nv);
      }
      if (t == p.T - 1) {
        float post = rnd<S>(l + colsum);
        if (p.with_vqdq)
          post = qdq(post, t, p.v_mode, p.v_levels, p.vthr, p.vthr_w, p.vqp);
        st(&llr_s[j * L + v], post);
      }
    }
    __syncthreads();
  }

  // output: the stored posterior, or its hard decisions
  for (int j = 0; j < p.nb; ++j) {
    const int idx = j * L + u;
    const float stored = ld(&llr_s[idx]);
    if (p.post != nullptr)
      st(static_cast<S*>(p.post) + f * n + idx, stored);
    else
      p.bits[f * n + idx] = (int8_t)(stored < 0.0f);
  }

  // K3: syndrome of the stored posterior, per base row
  int fail = 0;
  for (int i = 0; i < p.mb; ++i) {
    int parity = 0;
    for (int b = p.row_ptr[i]; b < p.row_ptr[i + 1]; ++b) {
      int v = u + p.block_shift[b];
      v = (v >= L) ? v - L : v;
      parity ^= (int)(ld(&llr_s[p.block_col[b] * L + v]) < 0.0f);
    }
    fail |= parity;
  }
  const int any_fail = __syncthreads_or(fail);
  if (u == 0) p.ok[f] = (uint8_t)(any_fail == 0);
}

template <typename S>
cudaError_t launch(const FloodParams& p, int B, cudaStream_t stream) {
  const size_t smem = (size_t)(p.nb + p.NB) * p.L * sizeof(S);
  cudaError_t err = cudaFuncSetAttribute(
      fused_flooding_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_flooding_kernel<S><<<B, p.L, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ldpc_fused_flooding(
    const void* llr, void* post, void* bits, void* ok, const void* beta,
    const void* alpha, const void* thr, int thr_w, const void* qp,
    const void* vthr, int vthr_w, const void* vqp, const void* row_ptr,
    const void* col_ptr, const void* col_blocks, const void* block_col,
    const void* block_shift, int B, int nb, int mb, int NB, int L, int T,
    int is_bf16, int kind, int alpha_in_cn, int q_mode, int q_levels,
    int with_vqdq, int v_mode, int v_levels, void* stream) {
  FloodParams p;
  p.llr = llr;
  p.post = post;
  p.bits = static_cast<int8_t*>(bits);
  p.ok = static_cast<uint8_t*>(ok);
  p.beta = static_cast<const float*>(beta);
  p.alpha = static_cast<const float*>(alpha);
  p.vthr = static_cast<const float*>(vthr);
  p.vqp = static_cast<const float*>(vqp);
  p.row_ptr = static_cast<const int*>(row_ptr);
  p.col_ptr = static_cast<const int*>(col_ptr);
  p.col_blocks = static_cast<const int*>(col_blocks);
  p.block_col = static_cast<const int*>(block_col);
  p.block_shift = static_cast<const int*>(block_shift);
  p.nb = nb;
  p.mb = mb;
  p.NB = NB;
  p.L = L;
  p.T = T;
  p.vthr_w = vthr_w;
  p.with_vqdq = with_vqdq;
  p.v_mode = v_mode;
  p.v_levels = v_levels;
  p.var = Variant{kind, alpha_in_cn, q_mode, q_levels, thr_w,
                  static_cast<const float*>(thr),
                  static_cast<const float*>(qp)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(p, B, s)
                       : launch<float>(p, B, s));
}
