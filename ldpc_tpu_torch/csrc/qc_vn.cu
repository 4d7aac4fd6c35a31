// Variable-node update of one base column of a QC LDPC code, for Hopper
// (sm_90a).
//
// Replaces ldpc_tpu/decode/pallas_qc.py::_make_vn_kernel (K6, launched per
// base column by qc_pallas_decode_batch through _col_call), with its
// quantizer pallas_qc.py::_kernel_qdq (common.cuh's qdq, staircase or
// power). Its plain PyTorch version, with the same op order and rounding
// points, is ldpc_tpu_torch/decode/qc_rowcol.py::_vn_col_plain.
//
// Layout: c2v and v2c [NB, L, B] (variable-aligned, in device memory, batch
// innermost), the channel LLRs llr and the posterior post [nb, L, B];
// element (b, v, f) is at (b*L + v)*B + f. The column's block ids come from
// the graph's col_blocks table, so the kernel reads the row-major c2v state
// in place (the TPU driver gathers and restacks it instead).
//
// Design. One thread per (variable v, frame f): blockIdx.y = v, the 128
// threads of a block cover 128 consecutive frames (coalesced). Pass 0
// copies the column's dv messages to shared memory (one read each, several
// in flight); the column sum, llr + colsum, colsum - c2v and llr + alpha*ext
// all stay in float32, with one cast to the storage type S at each store,
// as the TPU kernel does.
//
// What bounds it. At the zoo's code (dv = 5, L = 256) and B = 32768 in bf16
// a launch reads c2v and the LLRs and writes v2c and the posterior, 201 MB:
// 0.060 ms at 3.35 TB/s; its float32 operations (the bv = 8 power-law
// quantizer on every output) take well under that at 67 TFLOP/s. Bound by
// bytes.

#include "common.cuh"

namespace {

constexpr int kFrames = 128;  // threads (frames) per block

struct VnParams {
  const void* c2v;   // [NB, L, B] S
  const void* llr;   // [nb, L, B] S
  void* v2c;         // [NB, L, B] S
  void* post;        // [nb, L, B] S
  const float* alpha;  // [T, NB]
  const float* vthr;   // [T, vthr_w]
  const float* vqp;    // [T, 2]
  const int* blocks;   // the column's dv block ids
  int col, dv, NB, L, B, t;
  int vthr_w, alpha_in_cn, with_vqdq, v_mode, v_levels;
};

template <typename S>
__global__ void qc_vn_kernel(VnParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* cs = reinterpret_cast<S*>(smem_raw);  // [dv, kFrames]
  const int tid = threadIdx.x;
  const int f = blockIdx.x * kFrames + tid;
  const int v = blockIdx.y;
  if (f >= p.B) return;  // no barrier below: a partial block may exit
  const size_t B = p.B;
  const S* c2v = static_cast<const S*>(p.c2v);
  S* v2c = static_cast<S*>(p.v2c);

  // pass 0: the column's messages to variable v, one read each
#pragma unroll 8
  for (int k = 0; k < p.dv; ++k)
    cs[k * kFrames + tid] =
        c2v[((size_t)p.blocks[k] * p.L + v) * B + f];
  const size_t iv = ((size_t)p.col * p.L + v) * B + f;
  const float l = ld(static_cast<const S*>(p.llr) + iv);

  float colsum = ld(&cs[tid]);
  for (int k = 1; k < p.dv; ++k) colsum = colsum + ld(&cs[k * kFrames + tid]);

  const float* at = p.alpha + (size_t)p.t * p.NB;
  for (int k = 0; k < p.dv; ++k) {
    const int b = p.blocks[k];
    const float ext = colsum - ld(&cs[k * kFrames + tid]);
    float nv = p.alpha_in_cn ? l + ext : l + at[b] * ext;
    if (p.with_vqdq)
      nv = qdq(nv, p.t, p.v_mode, p.v_levels, p.vthr, p.vthr_w, p.vqp);
    st(&v2c[((size_t)b * p.L + v) * B + f], nv);
  }
  float post = l + colsum;
  if (p.with_vqdq)
    post = qdq(post, p.t, p.v_mode, p.v_levels, p.vthr, p.vthr_w, p.vqp);
  st(static_cast<S*>(p.post) + iv, post);
}

template <typename S>
cudaError_t launch(const VnParams& p, cudaStream_t stream) {
  const size_t smem = (size_t)p.dv * kFrames * sizeof(S);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        qc_vn_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.B + kFrames - 1) / kFrames, p.L);
  qc_vn_kernel<S><<<grid, kFrames, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ldpc_qc_vn(const void* c2v, const void* llr, void* v2c,
                          void* post, const void* alpha, const void* vthr,
                          int vthr_w, const void* vqp, const void* blocks,
                          int col, int dv, int NB, int L, int B, int t,
                          int is_bf16, int alpha_in_cn, int with_vqdq,
                          int v_mode, int v_levels, void* stream) {
  VnParams p;
  p.c2v = c2v;
  p.llr = llr;
  p.v2c = v2c;
  p.post = post;
  p.alpha = static_cast<const float*>(alpha);
  p.vthr = static_cast<const float*>(vthr);
  p.vqp = static_cast<const float*>(vqp);
  p.blocks = static_cast<const int*>(blocks);
  p.col = col;
  p.dv = dv;
  p.NB = NB;
  p.L = L;
  p.B = B;
  p.t = t;
  p.vthr_w = vthr_w;
  p.alpha_in_cn = alpha_in_cn;
  p.with_vqdq = with_vqdq;
  p.v_mode = v_mode;
  p.v_levels = v_levels;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s));
}
