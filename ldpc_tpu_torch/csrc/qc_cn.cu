// Check-node update of one base row of a QC LDPC code, for Hopper (sm_90a).
//
// Replaces ldpc_tpu/decode/pallas_qc.py::_make_cn_kernel (K5, launched per
// base row by qc_pallas_decode_batch through _row_call), with its quantizer
// pallas_qc.py::_kernel_qdq (common.cuh's qdq_staged, staircase or power).
// Its plain PyTorch version, with the same op order and rounding points, is
// ldpc_tpu_torch/decode/qc_rowcol.py::_cn_row_plain.
//
// Layout: the variable-aligned message states v2c and c2v [NB, L, B] in
// device memory, batch innermost; element (b, v, f) is at (b*L + v)*B + f.
// The row's blocks are b0 .. b0+dc-1 (blocks are numbered row-major).
// Check u of the row meets variable (u + s_b) mod L of block b, so the
// TPU kernel's rolls become row offsets.
//
// Design. One thread per (check u, V consecutive frames): blockIdx.y = u,
// and every access is 8 bytes a thread (V = 4 frames in bf16, 2 in f32; a
// batch that is not a multiple of V, or a misaligned tensor, takes
// frame-by-frame accesses). The only parts of a message the update needs
// are its sign and its place in the min chain, so each message is read
// once, straight into the running (min1, min2, first argmin, negative
// count) of its frame and one sign bit per edge (x < 0: -0.0 counts as
// positive and NaN as not negative, as in the plain version); no message
// is staged. The block stages the row's shifts and (beta, alpha) of
// iteration t and its quantizer's table once in shared memory. Where every
// block of the row shares (beta, alpha) at t (every row of the zoo's
// decoders), a check can send only four c2v, c2v(+-1, min1 or min2): they
// are computed once per (check, frame), each from its own operands (a slot
// is never negated: qdq(-0.0) is +1e-30), and each edge picks one; other
// rows compute the transform per edge. The variant's kind is a template
// parameter. Rows of degree up to 64 keep their sign bits in a register
// per frame; above that the generic instance reads each message again for
// its sign.
//
// What bounds it. At the zoo's (9472, 8192) code (dc = 37, L = 256) and
// B = 32768 in bf16 a launch reads and writes 1.24 GB: 0.371 ms at
// 3.35 TB/s; its float32 work on a row that shares (beta, alpha) is the
// min chain and sign bit per edge and four transforms and quantizations
// per (check, frame), so it is bound by bytes.
//
// Numerics: see common.cuh. Ties resolve to the first argmin (strict <),
// min2 of a degree-1 check is min1.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // threads per block

struct CnParams {
  const void* v2c;   // [NB, L, B] S
  void* c2v;         // [NB, L, B] S
  const float* beta;   // [T, NB]
  const float* alpha;  // [T, NB]
  const int* block_shift;  // [NB]
  int b0, dc, NB, L, B, t;
  int vec;  // 8-byte accesses: B % V == 0 and both tensors aligned
  Variant var;
};

// the row's staged constants in shared memory: (beta, alpha) and shift
// per block, then the quantizer's table
__host__ __device__ inline size_t cn_smem(int dc, int q_levels) {
  return (size_t)dc * (sizeof(float2) + sizeof(int)) +
         (size_t)q_levels * sizeof(float);
}

// SIGNS: the row's degree is at most 64 and its sign bits stay in a
// register per frame; otherwise each message is read again for its sign
template <typename S, int KIND, bool SIGNS>
__global__ void __launch_bounds__(kThreads) qc_cn_kernel(CnParams p) {
  constexpr int V = Frames<S>::V;
  constexpr bool kQuantized = KIND == kRcq || KIND == kWrcq || KIND == kOrcq;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* ba = reinterpret_cast<float2*>(smem);        // [dc]
  int* shift = reinterpret_cast<int*>(ba + p.dc);      // [dc]
  float* tab = reinterpret_cast<float*>(shift + p.dc);  // [q_levels]
  const Variant& var = p.var;
  const int tid = threadIdx.x, u = blockIdx.y, dc = p.dc;
  const float* bt = p.beta + (size_t)p.t * p.NB + p.b0;
  const float* at = p.alpha + (size_t)p.t * p.NB + p.b0;
  int same = 1;
  for (int k = tid; k < dc; k += kThreads) {
    const float bb = bt[k], ab = at[k];
    ba[k] = make_float2(bb, ab);
    shift[k] = p.block_shift[p.b0 + k];
    same = __float_as_uint(bb) == __float_as_uint(bt[0]) &&
           __float_as_uint(ab) == __float_as_uint(at[0]);
  }
  const QConst q = qconst(p.t, var.q_mode, var.q_levels, var.qp);
  if (kQuantized)
    for (int i = tid; i < q.levels; i += kThreads)
      tab[i] = qtable_entry(q, i, p.t, var.thr, var.thr_w);
  const int uni = __syncthreads_and(same);  // the row shares (beta, alpha)
  const int f0 = (blockIdx.x * kThreads + tid) * V;
  const int n = p.B - f0;
  if (n <= 0) return;  // no barrier below: a partial block may exit

  const size_t B = p.B, L = p.L;
  const S* in = static_cast<const S*>(p.v2c) + (size_t)p.b0 * L * B + f0;
  S* out = static_cast<S*>(p.c2v) + (size_t)p.b0 * L * B + f0;
  const auto at_edge = [&](int k) {  // offset of edge k's frames
    int v = u + shift[k];
    v = (v >= p.L) ? v - p.L : v;
    return ((size_t)k * L + v) * B;
  };

  // one read per message: the running (min1, min2, first argmin) and the
  // negative count of each frame, and its sign bits
  const float kInf = __int_as_float(0x7f800000);
  float min1[V], min2[V];
  int argm[V], neg[V];
  uint64_t sgn[V];
  {
    float x[V];
    load_frames(in + at_edge(0), p.vec, n, x);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      min1[i] = fabsf(x[i]);
      min2[i] = kInf;
      argm[i] = 0;
      neg[i] = x[i] < 0.0f;
      sgn[i] = (uint64_t)neg[i];
    }
  }
#pragma unroll 2
  for (int k = 1; k < dc; ++k) {
    float x[V];
    load_frames(in + at_edge(k), p.vec, n, x);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float mk = fabsf(x[i]);
      const int negk = x[i] < 0.0f;
      const bool new_min = mk < min1[i];
      min2[i] = new_min ? min1[i] : nan_min(min2[i], mk);
      min1[i] = new_min ? mk : min1[i];
      argm[i] = new_min ? k : argm[i];
      neg[i] += negk;
      if (SIGNS) sgn[i] |= (uint64_t)negk << k;
    }
  }

  const Quant cq{q, tab};
  const int aic = var.alpha_in_cn;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (dc == 1) min2[i] = min1[i];  // degree-1 checks
    neg[i] &= 1;                     // the parity
  }

  // each edge's leave-one-out c2v, stored in S: picked from the frame's
  // four (PICK: the row shares (beta, alpha) at t) or transformed; a loop
  // for each
  const auto store_all = [&](auto pick) {
    constexpr bool PICK = decltype(pick)::value;
    float p1[V], n1[V], p2[V], n2[V];  // c2v(+-1, min1), c2v(+-1, min2)
    if constexpr (PICK) {
      const float2 b0 = ba[0];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        p1[i] = c2v_kind<KIND>(aic, 1.0f, min1[i], b0.x, b0.y, cq);
        n1[i] = c2v_kind<KIND>(aic, -1.0f, min1[i], b0.x, b0.y, cq);
        p2[i] = c2v_kind<KIND>(aic, 1.0f, min2[i], b0.x, b0.y, cq);
        n2[i] = c2v_kind<KIND>(aic, -1.0f, min2[i], b0.x, b0.y, cq);
      }
    }
#pragma unroll 2
    for (int k = 0; k < dc; ++k) {
      const size_t o = at_edge(k);
      float x[V];
      if (!SIGNS) load_frames(in + o, p.vec, n, x);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int negk =
            SIGNS ? (int)((sgn[i] >> k) & 1) : (int)(x[i] < 0.0f);
        const int loo_neg = negk ^ neg[i];
        const int j = argm[i] == k;
        if constexpr (PICK) {
          const float one = loo_neg ? n1[i] : p1[i];
          const float two = loo_neg ? n2[i] : p2[i];
          x[i] = j ? two : one;
        } else {
          const float2 bk = ba[k];
          x[i] = c2v_kind<KIND>(aic, loo_neg ? -1.0f : 1.0f,
                                j ? min2[i] : min1[i], bk.x, bk.y, cq);
        }
      }
      store_frames(out + o, p.vec, n, x);
    }
  };
  if (uni)
    store_all(Const<1>{});
  else
    store_all(Const<0>{});
}

template <typename S, int KIND>
const void* instance_kind(bool signs) {
  return signs ? (const void*)qc_cn_kernel<S, KIND, true>
               : (const void*)qc_cn_kernel<S, KIND, false>;
}

// the instance for the variant's kind and the row's degree
template <typename S>
const void* instance(int kind, int dc) {
  const bool signs = dc <= 64;
  switch (kind) {
    case kNms: return instance_kind<S, kNms>(signs);
    case kOms: return instance_kind<S, kOms>(signs);
    case kRcq: return instance_kind<S, kRcq>(signs);
    case kWrcq: return instance_kind<S, kWrcq>(signs);
    default: return instance_kind<S, kOrcq>(signs);
  }
}

template <typename S>
cudaError_t launch(CnParams p, cudaStream_t stream) {
  const uintptr_t any = (uintptr_t)p.v2c | (uintptr_t)p.c2v;
  p.vec = p.B % Frames<S>::V == 0 && any % 8 == 0;
  const size_t smem = cn_smem(p.dc, p.var.q_levels);
  const void* fn = instance<S>(p.var.kind, p.dc);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  constexpr int V = Frames<S>::V;
  const int threads = (p.B + V - 1) / V;
  const dim3 grid((threads + kThreads - 1) / kThreads, p.L);
  void* args[] = {&p};
  return cudaLaunchKernel(fn, grid, dim3(kThreads), args, smem, stream);
}

template <typename S>
int occupancy(int kind, int dc, int q_levels) {
  const size_t smem = cn_smem(dc, q_levels);
  const void* fn = instance<S>(kind, dc);
  int blocks = -1;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return blocks;
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

// resident CTAs per SM of the instance for a row of degree dc and a
// variant kind (-1 on a CUDA error)
extern "C" int ldpc_qc_cn_occupancy(int dc, int is_bf16, int kind,
                                    int q_levels) {
  return is_bf16 ? occupancy<__nv_bfloat16>(kind, dc, q_levels)
                 : occupancy<float>(kind, dc, q_levels);
}
