// Check-node update of one base row of a QC LDPC code, for Hopper (sm_90a).
//
// Replaces ldpc_tpu/decode/pallas_qc.py::_make_cn_kernel (K5, launched per
// base row by qc_pallas_decode_batch through _row_call), with its quantizer
// pallas_qc.py::_kernel_qdq (common.cuh's qdq, staircase or power). Its plain
// PyTorch version, with the same op order and rounding points, is
// ldpc_tpu_torch/decode/qc_rowcol.py::_cn_row_plain.
//
// Layout: the variable-aligned message states v2c and c2v [NB, L, B] in
// device memory, batch innermost; element (b, v, f) is at (b*L + v)*B + f.
// The row's blocks are b0 .. b0+dc-1 (blocks are numbered row-major).
// Check u of the row meets variable (u + s_b) mod L of block b, so the
// TPU kernel's rolls become row offsets.
//
// Design. One thread per (check u, frame f): blockIdx.y = u, and the 128
// threads of a block cover 128 consecutive frames, so every load and store
// of a warp touches 32 consecutive frames of one row (coalesced). Pass 0
// copies the thread's dc messages into shared memory, with the loop
// unrolled so that several loads are in flight per thread; pass 1 runs the
// min1/min2/first-argmin tree and the negative count from there; pass 2
// forms each leave-one-out output, the variant transform and the quantizer
// in float32, and stores it in the storage type S. Device memory sees each
// input message read once and each output written once.
//
// What bounds it. At the zoo's (9472, 8192) code (dc = 37, L = 256) and
// B = 32768 in bf16 a launch reads and writes 1.24 GB: 0.371 ms at
// 3.35 TB/s, against about 35 float32 operations per edge (0.16 ms at
// 67 TFLOP/s), so it is bound by bytes. Its 2-byte accesses keep 64 B per
// warp per load in flight; wider accesses are left for later work.
//
// Numerics: see common.cuh. Ties resolve to the first argmin (strict <),
// -0.0 counts as positive, min2 of a degree-1 check is min1.

#include "common.cuh"

namespace {

constexpr int kFrames = 128;  // threads (frames) per block

struct CnParams {
  const void* v2c;   // [NB, L, B] S
  void* c2v;         // [NB, L, B] S
  const float* beta;   // [T, NB]
  const float* alpha;  // [T, NB]
  const int* block_shift;  // [NB]
  int b0, dc, NB, L, B, t;
  Variant var;
};

template <typename S>
__global__ void qc_cn_kernel(CnParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* xs = reinterpret_cast<S*>(smem_raw);  // [dc, kFrames]
  const int tid = threadIdx.x;
  const int f = blockIdx.x * kFrames + tid;
  const int u = blockIdx.y;
  if (f >= p.B) return;  // no barrier below: a partial block may exit
  const size_t B = p.B;
  const S* v2c = static_cast<const S*>(p.v2c);
  S* out = static_cast<S*>(p.c2v);

  // pass 0: the row's messages to check u, one read each
#pragma unroll 8
  for (int k = 0; k < p.dc; ++k) {
    const int b = p.b0 + k;
    int v = u + p.block_shift[b];
    v = (v >= p.L) ? v - p.L : v;
    xs[k * kFrames + tid] = v2c[((size_t)b * p.L + v) * B + f];
  }

  // pass 1: running (min1, min2, argmin) and the negative count
  const float kInf = __int_as_float(0x7f800000);
  float min1 = 0.0f, min2 = kInf;
  int argm = 0, neg_cnt = 0;
  for (int k = 0; k < p.dc; ++k) {
    const float x = ld(&xs[k * kFrames + tid]);
    const float mk = fabsf(x);
    const int negk = x < 0.0f;
    if (k == 0) {
      min1 = mk;
      neg_cnt = negk;
    } else {
      const bool new_min = mk < min1;
      min2 = new_min ? min1 : nan_min(min2, mk);
      min1 = new_min ? mk : min1;
      argm = new_min ? k : argm;
      neg_cnt += negk;
    }
  }
  if (p.dc == 1) min2 = min1;  // degree-1 checks

  // pass 2: leave-one-out outputs, transform, quantizer, store
  const float* bt = p.beta + (size_t)p.t * p.NB;
  const float* at = p.alpha + (size_t)p.t * p.NB;
  for (int k = 0; k < p.dc; ++k) {
    const int b = p.b0 + k;
    const float x = ld(&xs[k * kFrames + tid]);
    const float loo_mag = (argm == k) ? min2 : min1;
    const int loo_neg = (neg_cnt - (int)(x < 0.0f)) & 1;
    const float loo_sign = 1.0f - 2.0f * (float)loo_neg;
    int v = u + p.block_shift[b];
    v = (v >= p.L) ? v - p.L : v;
    st(&out[((size_t)b * p.L + v) * B + f],
       c2v(p.var, loo_sign, loo_mag, bt[b], at[b], p.t));
  }
}

template <typename S>
cudaError_t launch(const CnParams& p, cudaStream_t stream) {
  const size_t smem = (size_t)p.dc * kFrames * sizeof(S);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        qc_cn_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.B + kFrames - 1) / kFrames, p.L);
  qc_cn_kernel<S><<<grid, kFrames, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ldpc_qc_cn(const void* v2c, void* c2v, const void* beta,
                          const void* alpha, const void* thr, int thr_w,
                          const void* qp, const void* block_shift, int b0,
                          int dc, int NB, int L, int B, int t, int is_bf16,
                          int kind, int alpha_in_cn, int q_mode, int q_levels,
                          void* stream) {
  CnParams p;
  p.v2c = v2c;
  p.c2v = c2v;
  p.beta = static_cast<const float*>(beta);
  p.alpha = static_cast<const float*>(alpha);
  p.block_shift = static_cast<const int*>(block_shift);
  p.b0 = b0;
  p.dc = dc;
  p.NB = NB;
  p.L = L;
  p.B = B;
  p.t = t;
  p.var = Variant{kind, alpha_in_cn, q_mode, q_levels, thr_w,
                  static_cast<const float*>(thr),
                  static_cast<const float*>(qp)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s));
}

// resident CTAs per SM of the kernel for a row of degree dc (-1 on a CUDA
// error)
extern "C" int ldpc_qc_cn_occupancy(int dc, int is_bf16) {
  int blocks = -1;
  const size_t smem =
      (size_t)dc * kFrames * (is_bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
  const void* fn = is_bf16 ? (const void*)qc_cn_kernel<__nv_bfloat16>
                           : (const void*)qc_cn_kernel<float>;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kFrames,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
}
