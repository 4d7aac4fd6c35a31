// Variable-node update of one base column of a QC LDPC code, for Hopper
// (sm_90a).
//
// Replaces ldpc_tpu/decode/pallas_qc.py::_make_vn_kernel (K6, launched per
// base column by qc_pallas_decode_batch through _col_call), with its
// quantizer pallas_qc.py::_kernel_qdq (common.cuh's qdq_staged, staircase
// or power). Its plain PyTorch version, with the same op order and
// rounding points, is ldpc_tpu_torch/decode/qc_rowcol.py::_vn_col_plain.
//
// Layout: c2v and v2c [NB, L, B] (variable-aligned, in device memory, batch
// innermost), the channel LLRs llr and the posterior post [nb, L, B];
// element (b, v, f) is at (b*L + v)*B + f. The column's block ids come from
// the graph's col_blocks table, so the kernel reads the row-major c2v state
// in place (the TPU driver gathers and restacks it instead).
//
// Design. One thread per (variable v, V consecutive frames): blockIdx.y =
// v, the 256 threads of a block cover 256 * V frames, and every access is
// 8 bytes a thread (V = 4 frames in bf16, 2 in f32; a batch that is not a
// multiple of V, or a misaligned tensor, takes frame-by-frame accesses).
// The column's block ids and alpha weights are read once per thread, and
// its dv messages (dv = 1..8: a template instance each) stay in registers
// between the column sum and the outputs; above 8 they are read twice. A
// thread requests its messages and LLRs first; meanwhile the block writes
// its quantizer's table to shared memory: the staircase's thresholds, or
// the power law's M + 1 reconstruction levels. So an output costs one
// powf and one IEEE division (common.cuh's qdq_staged) instead of four
// powf and five divisions, and no powf at gamma == 1. The column sum,
// llr + colsum, colsum - c2v and llr + alpha*ext stay in float32 per
// frame, in the plain version's order, with one cast to the storage type
// S at each store, as the TPU kernel does.
//
// What bounds it. At the zoo's code (dv = 5, L = 256) and B = 32768 in bf16
// a launch reads c2v and the LLRs and writes v2c and the posterior, 201 MB:
// 0.060 ms at 3.35 TB/s. Bound by bytes; what keeps it above that is the
// quantizer's float32 work (one IEEE division per output) between a
// thread's loads and its stores.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // threads per block (128 measured 4% slower)

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
  int vec;  // 8-byte accesses: B % V == 0 and every tensor aligned
};

// DV = the column's degree, or 0: any degree, the messages read twice
template <typename S, int DV>
__global__ void __launch_bounds__(kThreads) qc_vn_kernel(VnParams p) {
  constexpr int V = Frames<S>::V;
  extern __shared__ float tab[];  // [v_levels]: the quantizer's table
  const int f0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  const int n = p.B - f0, v = blockIdx.y;
  const size_t B = p.B, L = p.L;
  const S* c2v = static_cast<const S*>(p.c2v) + v * B + f0;
  S* v2c = static_cast<S*>(p.v2c) + v * B + f0;
  const float* at = p.alpha + (size_t)p.t * p.NB;
  const size_t iv = ((size_t)p.col * L + v) * B + f0;
  float l[V], post[V];
  int blk[DV > 0 ? DV : 1];
  float a[DV > 0 ? DV : 1], c[DV > 0 ? DV : 1][V];
  // the column's messages and LLRs are requested before the table is built
  if (n > 0) {
    load_frames(static_cast<const S*>(p.llr) + iv, p.vec, n, l);
    if constexpr (DV > 0) {
#pragma unroll
      for (int k = 0; k < DV; ++k) {
        blk[k] = p.blocks[k];
        a[k] = at[blk[k]];
        load_frames(c2v + blk[k] * L * B, p.vec, n, c[k]);
      }
    }
  }
  const QConst q = qconst(p.t, p.v_mode, p.v_levels, p.vqp);
  const int vq = p.with_vqdq;
  if (vq && q.mode != kUniform) {
    for (int i = threadIdx.x; i < q.levels; i += kThreads)
      tab[i] = qtable_entry(q, i, p.t, p.vthr, p.vthr_w);
    __syncthreads();
  }
  if (n <= 0) return;  // no barrier below: a partial block may exit

  if constexpr (DV > 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float colsum = c[0][i];
#pragma unroll
      for (int k = 1; k < DV; ++k) colsum = colsum + c[k][i];
#pragma unroll
      for (int k = 0; k < DV; ++k) {
        const float ext = colsum - c[k][i];
        float nv = p.alpha_in_cn ? l[i] + ext : l[i] + a[k] * ext;
        c[k][i] = vq ? qdq_staged(nv, q, tab) : nv;
      }
      post[i] = l[i] + colsum;
    }
#pragma unroll
    for (int k = 0; k < DV; ++k)
      store_frames(v2c + blk[k] * L * B, p.vec, n, c[k]);
  } else {
    float colsum[V] = {}, x[V];
    for (int k = 0; k < p.dv; ++k) {
      load_frames(c2v + p.blocks[k] * L * B, p.vec, n, x);
#pragma unroll
      for (int i = 0; i < V; ++i) colsum[i] = k ? colsum[i] + x[i] : x[i];
    }
    for (int k = 0; k < p.dv; ++k) {
      const int b = p.blocks[k];
      const float ab = at[b];
      load_frames(c2v + b * L * B, p.vec, n, x);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float ext = colsum[i] - x[i];
        const float nv = p.alpha_in_cn ? l[i] + ext : l[i] + ab * ext;
        x[i] = vq ? qdq_staged(nv, q, tab) : nv;
      }
      store_frames(v2c + b * L * B, p.vec, n, x);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) post[i] = l[i] + colsum[i];
  }
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (vq) post[i] = qdq_staged(post[i], q, tab);
  store_frames(static_cast<S*>(p.post) + iv, p.vec, n, post);
}

template <typename S, int DV>
cudaError_t launch_dv(const VnParams& p, cudaStream_t stream) {
  const size_t smem = (size_t)p.v_levels * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        qc_vn_kernel<S, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  constexpr int V = Frames<S>::V;
  const int threads = (p.B + V - 1) / V;
  const dim3 grid((threads + kThreads - 1) / kThreads, p.L);
  qc_vn_kernel<S, DV><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch(VnParams p, cudaStream_t stream) {
  const uintptr_t any =
      (uintptr_t)p.c2v | (uintptr_t)p.llr | (uintptr_t)p.v2c |
      (uintptr_t)p.post;
  p.vec = p.B % Frames<S>::V == 0 && any % 8 == 0;
  switch (p.dv) {
    case 1: return launch_dv<S, 1>(p, stream);
    case 2: return launch_dv<S, 2>(p, stream);
    case 3: return launch_dv<S, 3>(p, stream);
    case 4: return launch_dv<S, 4>(p, stream);
    case 5: return launch_dv<S, 5>(p, stream);
    case 6: return launch_dv<S, 6>(p, stream);
    case 7: return launch_dv<S, 7>(p, stream);
    case 8: return launch_dv<S, 8>(p, stream);
    default: return launch_dv<S, 0>(p, stream);
  }
}

template <typename S, int DV>
int occupancy_dv(int v_levels) {
  const size_t smem = (size_t)v_levels * sizeof(float);
  int blocks = -1;
  if (cudaFuncSetAttribute(qc_vn_kernel<S, DV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, qc_vn_kernel<S, DV>, kThreads, smem) != cudaSuccess)
    return -1;
  return blocks;
}

template <typename S>
int occupancy(int dv, int v_levels) {
  switch (dv) {
    case 1: return occupancy_dv<S, 1>(v_levels);
    case 2: return occupancy_dv<S, 2>(v_levels);
    case 3: return occupancy_dv<S, 3>(v_levels);
    case 4: return occupancy_dv<S, 4>(v_levels);
    case 5: return occupancy_dv<S, 5>(v_levels);
    case 6: return occupancy_dv<S, 6>(v_levels);
    case 7: return occupancy_dv<S, 7>(v_levels);
    case 8: return occupancy_dv<S, 8>(v_levels);
    default: return occupancy_dv<S, 0>(v_levels);
  }
}

// counts the float32 r in [-0, 1] (every bit pattern) with
// powf(r, one) != r bit for bit, for one = 1.0f
__global__ void powf_one_kernel(float one, unsigned int* mismatches) {
  const uint32_t stride = gridDim.x * blockDim.x;
  unsigned int bad = 0;
  for (uint32_t b = blockIdx.x * blockDim.x + threadIdx.x; b <= 0x3f800000u;
       b += stride) {
    const float r = __uint_as_float(b);
    bad += __float_as_uint(powf(r, one)) != b;
  }
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    const float z = __uint_as_float(0x80000000u);
    bad += __float_as_uint(powf(z, one)) != 0x80000000u;
  }
  if (bad) atomicAdd(mismatches, bad);
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

// resident CTAs per SM of the instance for a column of degree dv (-1 on a
// CUDA error)
extern "C" int ldpc_qc_vn_occupancy(int dv, int v_levels, int is_bf16) {
  return is_bf16 ? occupancy<__nv_bfloat16>(dv, v_levels)
                 : occupancy<float>(dv, v_levels);
}

// the check behind qdq_staged's gamma == 1 shortcut: counts into
// *mismatches (device memory, zeroed by the caller) the float32 r in
// [-0, 1] with powf(r, 1.0f) != r
extern "C" int ldpc_powf_one_mismatches(void* mismatches, float one,
                                        void* stream) {
  powf_one_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      one, static_cast<unsigned int*>(mismatches));
  return (int)cudaGetLastError();
}
