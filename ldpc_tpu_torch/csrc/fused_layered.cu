// Whole-decode layered min-sum kernel for QC LDPC codes, for Hopper (sm_90a).
//
// Replaces ldpc_tpu/decode/pallas_fused.py::_make_layered_kernel (K1), with
// its in-kernel quantizer _kernel_qdq (K2, common.cuh) and syndrome
// _syndrome_epilogue (K3) inlined. Its plain PyTorch version, with the same
// loop, op order and rounding points, is
// ldpc_tpu_torch/decode/fused.py::_fused_layered_plain.
//
// Design. One CTA decodes one frame; blockDim.x = lift L, and thread u owns
// check u of the current base row. Check u of block b touches variable
// (u + shift_b) % L of column col_b, so within a base row every thread
// touches distinct addresses and one __syncthreads() between base rows
// (layers) is the only ordering needed. The frame's channel LLRs and its
// column sums colsum[nb, L] live in shared memory in the storage type S
// (bf16 or f32). The per-block c2v memory C[NB, L] lives in a per-frame
// global scratch [B, NB, L] in S; iteration 0 never reads it (the memory
// starts at zero and x - 0 == x exactly), so the scratch needs no clearing.
// Pass 2 needs each block's v2c sign again: it recomputes v2c from the
// stored colsum (which holds exactly the value pass 1 computed from), so no
// sign stash is kept.
//
// What bounds it. At the bench width (5x37 base, L = 256, bf16) the C
// scratch is 185 * 256 * 2 B ~= 95 KB per frame, read and written once per
// iteration (~190 KB per frame per iteration): the kernel's only large
// memory traffic. The shared-memory state is 2 * 37 * 256 * 2 B ~= 38 KB
// per CTA. On an H100 (700 W) the bench's stage-1 launch (32768 frames,
// T = 3) moves that scratch at ~0.5 TB/s of the 3.35 available, so the
// latency of each thread's serial block loop and of its dependent scratch
// loads bounds it, not bandwidth. Keeping C compressed on chip (min1,
// min2, argmin and sign bits per check) and overlapping the scratch loads
// are the planned next steps.
//
// Numerics. Every storage-type operation is a float32 operation followed by
// round-to-nearest-even to S; check-node math and the quantizers run in
// float32. Build with -fmad=false and without --use_fast_math: the f32
// kernel then matches the plain version bit for bit, and the uniform
// quantizer's M / C and C / M are IEEE divisions.

#include "common.cuh"

namespace {

struct Params {
  const void* llr;      // [B, n] S
  void* post;           // [B, n] S, or null (lean)
  int8_t* bits;         // [B, n] int8, or null (full)
  uint8_t* ok;          // [B]
  void* cmem;           // [B, NB, L] S scratch
  const float* beta;    // [T, NB]
  const float* alpha;   // [T, NB]
  const float* thr;     // [T, thr_w]
  const float* qp;      // [T, 2]
  const float* vthr;    // [T, vthr_w]
  const float* vqp;     // [T, 2]
  const int* row_ptr;   // [mb + 1]; row i owns blocks row_ptr[i]..row_ptr[i+1)
  const int* block_col;    // [NB]
  const int* block_shift;  // [NB]
  int nb, mb, NB, L, T;
  int thr_w, vthr_w;
  int kind, alpha_in_cn;
  int q_mode, q_levels;
  int with_vqdq, v_mode, v_levels;
};

template <typename S>
__global__ void fused_layered_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = p.L;
  const int n = p.nb * L;
  S* llr_s = reinterpret_cast<S*>(smem_raw);
  S* colsum = llr_s + n;  // later reused for the stored posterior

  const int u = threadIdx.x;
  const size_t f = blockIdx.x;
  const S* llr_g = static_cast<const S*>(p.llr) + f * n;
  S* C = static_cast<S*>(p.cmem) + f * (size_t)p.NB * L;

  for (int j = 0; j < p.nb; ++j) {
    llr_s[j * L + u] = llr_g[j * L + u];
    st(&colsum[j * L + u], 0.0f);
  }
  __syncthreads();

  const float kInf = __int_as_float(0x7f800000);
  const Variant var{p.kind, p.alpha_in_cn, p.q_mode, p.q_levels, p.thr_w,
                    p.thr, p.qp};
  for (int t = 0; t < p.T; ++t) {
    const float* bt = p.beta + t * p.NB;
    const float* at = p.alpha + t * p.NB;
    for (int i = 0; i < p.mb; ++i) {
      const int b0 = p.row_ptr[i];
      const int dc = p.row_ptr[i + 1] - b0;
      // pass 1: fresh v2c from the current column sums; the old c2v leaves
      // colsum; running (min1, min2, first argmin) and negative count
      float min1 = 0.0f, min2 = kInf;
      int argm = 0, neg_cnt = 0;
      for (int k = 0; k < dc; ++k) {
        const int b = b0 + k;
        int v = u + p.block_shift[b];
        v = (v >= L) ? v - L : v;
        const int idx = p.block_col[b] * L + v;
        const float cs = ld(&colsum[idx]);
        const float ext =
            (t == 0) ? cs : rnd<S>(cs - ld(&C[(size_t)b * L + v]));
        const float l = ld(&llr_s[idx]);
        const float nv = p.alpha_in_cn ? rnd<S>(l + ext) : l + at[b] * ext;
        st(&colsum[idx], ext);
        const int negk = nv < 0.0f;
        const float mk = fabsf(nv);
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
      if (dc == 1) min2 = min1;
      const float row_sign = 1.0f - 2.0f * (float)(neg_cnt & 1);
      // pass 2: leave-one-out, variant transform, back into colsum and C
      for (int k = 0; k < dc; ++k) {
        const int b = b0 + k;
        int v = u + p.block_shift[b];
        v = (v >= L) ? v - L : v;
        const int idx = p.block_col[b] * L + v;
        const float ext = ld(&colsum[idx]);
        const float l = ld(&llr_s[idx]);
        const float nv = p.alpha_in_cn ? rnd<S>(l + ext) : l + at[b] * ext;
        const float sk = 1.0f - 2.0f * (float)(nv < 0.0f);
        const float loo_mag = (argm == k) ? min2 : min1;
        const float loo_sign = row_sign * sk;
        const float nw =
            rnd<S>(c2v(var, loo_sign, loo_mag, bt[b], at[b], t));
        st(&colsum[idx], ext + nw);
        st(&C[(size_t)b * L + v], nw);
      }
      __syncthreads();
    }
  }

  // posterior = llr + colsum, bv quantizer, stored in S
  for (int j = 0; j < p.nb; ++j) {
    const int idx = j * L + u;
    float post = rnd<S>(ld(&llr_s[idx]) + ld(&colsum[idx]));
    if (p.with_vqdq)
      post = qdq(post, p.T - 1, p.v_mode, p.v_levels, p.vthr, p.vthr_w,
                 p.vqp);
    st(&colsum[idx], post);
    const float stored = ld(&colsum[idx]);
    if (p.post != nullptr)
      st(static_cast<S*>(p.post) + f * n + idx, stored);
    else
      p.bits[f * n + idx] = (int8_t)(stored < 0.0f);
  }
  __syncthreads();

  // K3: syndrome of the stored posterior, per base row
  int fail = 0;
  for (int i = 0; i < p.mb; ++i) {
    int parity = 0;
    for (int b = p.row_ptr[i]; b < p.row_ptr[i + 1]; ++b) {
      int v = u + p.block_shift[b];
      v = (v >= L) ? v - L : v;
      parity ^= (int)(ld(&colsum[p.block_col[b] * L + v]) < 0.0f);
    }
    fail |= parity;
  }
  const int any_fail = __syncthreads_or(fail);
  if (u == 0) p.ok[f] = (uint8_t)(any_fail == 0);
}

template <typename S>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)p.nb * p.L * sizeof(S);
  cudaError_t err = cudaFuncSetAttribute(
      fused_layered_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_layered_kernel<S><<<B, p.L, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ldpc_fused_layered(
    const void* llr, void* post, void* bits, void* ok, void* cmem,
    const void* beta, const void* alpha, const void* thr, int thr_w,
    const void* qp, const void* vthr, int vthr_w, const void* vqp,
    const void* row_ptr, const void* block_col, const void* block_shift,
    int B, int nb, int mb, int NB, int L, int T, int is_bf16, int kind,
    int alpha_in_cn, int q_mode, int q_levels, int with_vqdq, int v_mode,
    int v_levels, void* stream) {
  Params p;
  p.llr = llr;
  p.post = post;
  p.bits = static_cast<int8_t*>(bits);
  p.ok = static_cast<uint8_t*>(ok);
  p.cmem = cmem;
  p.beta = static_cast<const float*>(beta);
  p.alpha = static_cast<const float*>(alpha);
  p.thr = static_cast<const float*>(thr);
  p.qp = static_cast<const float*>(qp);
  p.vthr = static_cast<const float*>(vthr);
  p.vqp = static_cast<const float*>(vqp);
  p.row_ptr = static_cast<const int*>(row_ptr);
  p.block_col = static_cast<const int*>(block_col);
  p.block_shift = static_cast<const int*>(block_shift);
  p.nb = nb;
  p.mb = mb;
  p.NB = NB;
  p.L = L;
  p.T = T;
  p.thr_w = thr_w;
  p.vthr_w = vthr_w;
  p.kind = kind;
  p.alpha_in_cn = alpha_in_cn;
  p.q_mode = q_mode;
  p.q_levels = q_levels;
  p.with_vqdq = with_vqdq;
  p.v_mode = v_mode;
  p.v_levels = v_levels;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(p, B, s) : launch<float>(p, B, s));
}
