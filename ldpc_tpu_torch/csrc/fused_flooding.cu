// Whole-decode flooding min-sum kernel for QC LDPC codes, for Hopper (sm_90a).
//
// Replaces ldpc_tpu/decode/pallas_fused.py::_make_kernel (K4, launched by
// qc_fused_decode_batch), with the quantizer K2 (common.cuh) and the
// syndrome K3 inlined. Its plain PyTorch version, with the same loops, op
// order and rounding points, is
// ldpc_tpu_torch/decode/fused.py::_fused_flooding_plain.
//
// Design. One CTA decodes one frame for all T iterations; blockDim.x = lift
// L. Device memory sees only the LLRs in and the bits or posterior out. The
// frame's state in shared memory is compressed (layout() below):
//   - per check (row i, check u): min1, min2 (|x| of stored S values, so
//     exact in S), the first argmin, the parity of the negative v2c count,
//     and one sign bit per edge (the v2c's x < 0);
//   - per variable: the channel LLR (at T-1 the stored posterior) and the
//     column sum, a pair of S read with one load.
// Every c2v of row i is a function of its check's state and the
// (iteration, block) tables, so the plain version's stored c2v,
// rnd_S(transform(loo_sign, loo_mag)), is recomputed where it is needed
// with the same operands, and so the same bits. Where the row's blocks
// share (beta, alpha) at the iteration (the zoo's decoders), the check
// keeps instead the four c2v it can send, transform(+-1, min1 or min2)
// rounded to S, and each edge picks one (Chk below):
//   - check-node phase t, thread u = check u of every base row: for each
//     edge, the previous iteration's c2v from the old state, then
//     ext = rnd_S(colsum - c2v) and v2c = rnd_S(qdq(llr + alpha*ext)) with
//     the tables of t-1 (at t = 0 the v2c is the rolled LLR), then the min
//     chain; it writes the check's new state;
//   - variable-node phase t, thread v = variable v of every base column:
//     each c2v of the column from its check's state with the tables of t,
//     the column sum rounded to S at each add in the column's block order;
//     at t = T-1 the posterior rnd_S(llr + colsum), V2C-quantized,
//     overwrites the LLR.
// Each phase reads only what the other wrote, so one __syncthreads()
// after each phase is the only ordering needed. The graph tables are
// staged in shared memory once; the (beta, alpha) pairs and the quantizer
// tables and constants of iteration t (common.cuh's QConst, qdq_staged:
// M / C and C / M divided once) at the start of check-node phase t,
// double-buffered by the parity of t. The variant's kind is a template
// parameter (one instance per kind), so the transform carries no
// dispatch, and the edge loops are unrolled by two; wider unrolling grew
// the code past what the instruction cache holds and ran slower. Lifts up
// to 768 take an instance capped at 80 registers a thread, larger ones one
// capped at 64 (MAXT below).
//
// What bounds it. At the zoo's (9472, 8192) code (5x37 base, L = 256) the
// state is 66,144 B per CTA in bf16 (3 CTAs per SM, 24 warps; the
// uncompressed one, 113,664 B, allowed 2) and 114,272 B in f32 (2 CTAs, was
// 1). The kernel is bound by instruction issue: its per-edge float32 work
// (56 operations per edge and iteration with the bc=3 staircase and the
// bv=8 uniform quantizer, chip_smoke.py's edge_ops, plus the second c2v of
// the compressed state) and the shared-memory loads and address
// arithmetic around it, not by bandwidth.
//
// Lifts above 1024 (more checks per base row than a block has threads)
// take the WIDE instances: 1024 threads, each running the per-check and
// per-variable work of ceil(L / 1024) units in turn (each_unit,
// common.cuh). No phase has an ordering inside it, so the result is the
// same; the instances for L <= 1024 are compiled as before.
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

// a check's four S slots: on a row whose blocks share (beta, alpha) at
// the iteration, the four c2v it can send, c2v(+1, min1), c2v(-1, min1),
// c2v(+1, min2), c2v(-1, min2), each rounded to S; on any other row min1
// and min2 (slots 0 and 1). bf16 packs them into 8 bytes, f32 into 16.
template <typename S>
struct Chk;
template <>
struct Chk<__nv_bfloat16> {
  uint2 w;
  __device__ __forceinline__ float slot(int s) const {
    const uint32_t x = (s & 2) ? w.y : w.x;
    return __uint_as_float((s & 1) ? (x & 0xffff0000u) : (x << 16));
  }
  __device__ __forceinline__ void set(float a, float b, float c, float d) {
    w = make_uint2(
        (__float_as_uint(a) >> 16) | (__float_as_uint(b) & 0xffff0000u),
        (__float_as_uint(c) >> 16) | (__float_as_uint(d) & 0xffff0000u));
  }
};
template <>
struct Chk<float> {
  uint4 w;
  __device__ __forceinline__ float slot(int s) const {
    const uint32_t x = (s & 2) ? ((s & 1) ? w.w : w.z)
                               : ((s & 1) ? w.y : w.x);
    return __uint_as_float(x);
  }
  __device__ __forceinline__ void set(float a, float b, float c, float d) {
    w = make_uint4(__float_as_uint(a), __float_as_uint(b),
                   __float_as_uint(c), __float_as_uint(d));
  }
};

// a check's meta word (first argmin, parity of the negative count, whether
// its slots hold c2v values) sits in bits 14..31 of its last sign word; the
// sign bits of that word use bits 0..13 (nw below)
constexpr int kMetaShift = 14;

// byte offsets of the shared-memory regions of one CTA, each aligned for
// its type (ldpc_fused_flooding_smem reports the total)
struct Layout {
  size_t cedge, chk, qcs, bcs, tabs, vars, signs, rptr, cptr, uni, total;
  int qlen, vlen, tab_w, nw;
};

template <typename S>
__host__ __device__ Layout layout(int nb, int mb, int NB, int L, int q_mode,
                                  int q_levels, int v_mode, int v_levels) {
  Layout y;
  y.qlen = (q_mode == kUniform) ? 0 : q_levels;
  y.vlen = (v_mode == kUniform) ? 0 : v_levels;
  // (beta, alpha) pairs, the q table, the v table; even, so that the
  // pairs of both parities are 8-byte aligned
  y.tab_w = 2 * NB + y.qlen + y.vlen;
  y.tab_w += y.tab_w & 1;
  // sign words per check: dc <= nb sign bits and the 18 meta bits
  y.nw = (nb + 18 + 31) / 32;
  size_t o = 0;
  y.cedge = o;  o += (size_t)NB * sizeof(int4);
  y.chk = o;    o += (size_t)mb * L * sizeof(Chk<S>);
  y.qcs = o;    o += 4 * sizeof(QConst);
  y.bcs = o;    o += (size_t)NB * sizeof(int2);
  y.tabs = o;   o += (size_t)2 * y.tab_w * sizeof(float);
  y.vars = o;   o += (size_t)nb * L * 2 * sizeof(S);
  y.signs = o;  o += (size_t)y.nw * mb * L * sizeof(uint32_t);
  y.rptr = o;   o += (size_t)(mb + 1) * sizeof(int);
  y.cptr = o;   o += (size_t)(nb + 1) * sizeof(int);
  y.uni = o;    o += (size_t)2 * mb * sizeof(int);
  y.total = o;
  return y;
}

// MAXT: the most threads the instance takes; 768 lets ptxas use 80
// registers a thread (3 CTAs of 256 threads per SM), 1024 only 64. WIDE:
// L > 1024, each thread takes several checks and variables of a block
template <typename S, int KIND, int MAXT, bool WIDE>
__global__ void __launch_bounds__(MAXT) fused_flooding_kernel(FloodParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Variant& var = p.var;
  const Layout y = layout<S>(p.nb, p.mb, p.NB, p.L, var.q_mode, var.q_levels,
                             p.v_mode, p.v_levels);
  // column-ordered edges: (block, row * L, the row's sign-word base,
  // position in the row | shift << 16)
  int4* cedge = reinterpret_cast<int4*>(smem + y.cedge);
  Chk<S>* chk = reinterpret_cast<Chk<S>*>(smem + y.chk);     // [mb, L]
  QConst* qcs = reinterpret_cast<QConst*>(smem + y.qcs);     // [2][q, v]
  int2* bcs = reinterpret_cast<int2*>(smem + y.bcs);  // block: col * L, shift
  float* tabs = reinterpret_cast<float*>(smem + y.tabs);     // [2][tab_w]
  // per variable (LLR, column sum); at T-1 the LLR becomes the posterior
  S* vars = reinterpret_cast<S*>(smem + y.vars);             // [nb, L][2]
  uint32_t* signs = reinterpret_cast<uint32_t*>(smem + y.signs);  // [nw][mb, L]
  int* rptr = reinterpret_cast<int*>(smem + y.rptr);
  int* cptr = reinterpret_cast<int*>(smem + y.cptr);
  // per row and parity of t: its blocks share (beta, alpha) at t
  int* uni = reinterpret_cast<int*>(smem + y.uni);           // [2][mb]

  const int L = p.L, NB = p.NB, ML = p.mb * L;
  const int last = (y.nw - 1) * ML;  // the last sign word of check 0
  // the block's threads stride the tables' staging loops
  const int tid = threadIdx.x, nt = WIDE ? (int)blockDim.x : L;
  const size_t f = blockIdx.x;
  const size_t n = (size_t)p.nb * L;
  const S* llr_g = static_cast<const S*>(p.llr) + f * n;
  const int aic = var.alpha_in_cn, vq = p.with_vqdq;

  for (int i = tid; i <= p.mb; i += nt) rptr[i] = p.row_ptr[i];
  for (int j = tid; j <= p.nb; j += nt) cptr[j] = p.col_ptr[j];
  for (int e = tid; e < NB; e += nt) {
    const int b = p.col_blocks[e];
    int i = 0;
    while (p.row_ptr[i + 1] <= b) ++i;
    const int k = b - p.row_ptr[i];
    cedge[e] = make_int4(b, i * L, (k >> 5) * ML + i * L,
                         k | (p.block_shift[b] << 16));
    bcs[e] = make_int2(p.block_col[e] * L, p.block_shift[e]);
  }
  each_unit<WIDE>(L, [&](int u) {
    for (int j = 0; j < p.nb; ++j) vars[2 * (j * L + u)] = llr_g[j * L + u];
  });

  const float kInf = __int_as_float(0x7f800000);
  for (int t = 0; t < p.T; ++t) {
    const int cur = t & 1, prv = cur ^ 1;
    // stage the tables of t (read by variable-node phase t and check-node
    // phase t + 1) beside those of t - 1 (read by this phase)
    {
      float* tc = tabs + cur * y.tab_w;
      const QConst q = qconst(t, var.q_mode, var.q_levels, var.qp);
      const QConst w = qconst(t, p.v_mode, p.v_levels, p.vqp);
      if (tid == 0) {
        qcs[2 * cur] = q;
        qcs[2 * cur + 1] = w;
      }
      for (int b = tid; b < NB; b += nt) {
        tc[2 * b] = p.beta[t * NB + b];
        tc[2 * b + 1] = p.alpha[t * NB + b];
      }
      for (int i = tid; i < y.qlen; i += nt)
        tc[2 * NB + i] = qtable_entry(q, i, t, var.thr, var.thr_w);
      for (int i = tid; i < y.vlen; i += nt)
        tc[2 * NB + y.qlen + i] = qtable_entry(w, i, t, p.vthr, p.vthr_w);
      for (int i = tid; i < p.mb; i += nt) {
        const float* bt = p.beta + t * NB;
        const float* at = p.alpha + t * NB;
        const int b0 = p.row_ptr[i];
        int same = 1;
        for (int b = b0 + 1; b < p.row_ptr[i + 1]; ++b)
          same &= __float_as_uint(bt[b]) == __float_as_uint(bt[b0]) &&
                  __float_as_uint(at[b]) == __float_as_uint(at[b0]);
        uni[cur * p.mb + i] = same;
      }
    }
    __syncthreads();  // t = 0: the graph tables and LLRs; else the VN phase

    // ---- check-node update: thread u = check u of every base row
    each_unit<WIDE>(L, [&](int u) {
      const float* tp = tabs + prv * y.tab_w;
      const float* tc = tabs + cur * y.tab_w;
      const Quant cq{qcs[2 * prv], tp + 2 * NB};  // tables of t - 1
      const Quant vqf{qcs[2 * prv + 1], tp + 2 * NB + y.qlen};
      for (int i = 0; i < p.mb; ++i) {
        const int b0 = rptr[i];
        const int dc = rptr[i + 1] - b0;
        const int ci = i * L + u;
        Chk<S> old;
        uint32_t ometa = 0;
        if (t > 0) {
          old = chk[ci];
          ometa = signs[last + ci] >> kMetaShift;
        }
        const int oargm = ometa & 0xffff, opar = (ometa >> 16) & 1;
        const int ouni = ometa >> 17;
        float min1 = 0.0f, min2 = kInf;
        int argm = 0, neg_cnt = 0;
        for (int kw = 0; kw < dc; kw += 32) {
          uint32_t* sw = signs + (kw >> 5) * ML + ci;
          const uint32_t osigns = (t > 0) ? *sw : 0u;
          uint32_t nsigns = 0u;
          const int kend = min(kw + 32, dc);
#pragma unroll 2
          for (int k = kw; k < kend; ++k) {
            const int b = b0 + k;
            const int2 cs = bcs[b];
            int v = u + cs.y;
            v = (v >= L) ? v - L : v;
            const int vi = cs.x + v;
            float x, colsum;  // t = 0: x is the rolled LLR
            ld_pair(&vars[2 * vi], x, colsum);
            if (t > 0) {
              // the c2v this edge received at t - 1
              const int j = oargm == k;
              const int loo_neg = ((osigns >> (k & 31)) & 1) ^ opar;
              const float2 ba = reinterpret_cast<const float2*>(tp)[b];
              const float c2 =
                  ouni ? old.slot(2 * j + loo_neg)
                       : rnd<S>(c2v_kind<KIND>(aic, loo_neg ? -1.0f : 1.0f,
                                               old.slot(j), ba.x, ba.y, cq));
              const float ext = rnd<S>(colsum - c2);
              // alpha inside the CN: a storage-type add; otherwise the
              // float32 weight promotes llr + alpha * ext to float32
              float nv = aic ? rnd<S>(x + ext) : x + ba.y * ext;
              if (vq) nv = vqf(nv);
              x = rnd<S>(nv);
            }
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
            nsigns |= (uint32_t)negk << (k & 31);
          }
          *sw = nsigns;
        }
        if (dc == 1) min2 = min1;  // degree-1 checks
        // the new state: the row's four c2v with the tables of t, or the
        // two minima
        const int un = uni[cur * p.mb + i];
        if (un) {
          const Quant cqt{qcs[2 * cur], tc + 2 * NB};
          const float2 ba = reinterpret_cast<const float2*>(tc)[b0];
          const auto c2v_of = [&](float sign, float mag) {
            return rnd<S>(c2v_kind<KIND>(aic, sign, mag, ba.x, ba.y, cqt));
          };
          chk[ci].set(c2v_of(1.0f, min1), c2v_of(-1.0f, min1),
                      c2v_of(1.0f, min2), c2v_of(-1.0f, min2));
        } else {
          chk[ci].set(min1, min2, 0.0f, 0.0f);
        }
        const uint32_t meta = (uint32_t)argm |
                              ((uint32_t)(neg_cnt & 1) << 16) |
                              ((uint32_t)un << 17);
        uint32_t* lw = signs + last + ci;  // keeps this row's sign bits
        const uint32_t bits = (dc > 32 * (y.nw - 1)) ? *lw & 0x3fffu : 0u;
        *lw = bits | (meta << kMetaShift);
      }
    });
    __syncthreads();

    // ---- variable-node update: thread v = variable v of every base column
    each_unit<WIDE>(L, [&](int v) {
      const float* tc = tabs + cur * y.tab_w;
      const Quant cq{qcs[2 * cur], tc + 2 * NB};
      const Quant vqf{qcs[2 * cur + 1], tc + 2 * NB + y.qlen};
      for (int j = 0; j < p.nb; ++j) {
        const int c0 = cptr[j];
        const int dv = cptr[j + 1] - c0;
        float colsum = 0.0f;
#pragma unroll 2
        for (int k = 0; k < dv; ++k) {
          const int4 e = cedge[c0 + k];
          const int pos = e.w & 0xffff;
          int c = v - (e.w >> 16);
          c = (c < 0) ? c + L : c;
          const Chk<S> s = chk[e.y + c];
          const uint32_t sw = signs[e.z + c];
          const uint32_t meta = signs[last + e.y + c] >> kMetaShift;
          const int loo_neg = ((sw >> (pos & 31)) & 1) ^ ((meta >> 16) & 1);
          const int jj = (int)(meta & 0xffff) == pos;
          float ca;
          if (meta >> 17) {
            ca = s.slot(2 * jj + loo_neg);
          } else {
            const float2 ba = reinterpret_cast<const float2*>(tc)[e.x];
            ca = rnd<S>(c2v_kind<KIND>(aic, loo_neg ? -1.0f : 1.0f,
                                       s.slot(jj), ba.x, ba.y, cq));
          }
          colsum = (k == 0) ? ca : rnd<S>(colsum + ca);
        }
        S* var_v = &vars[2 * (j * L + v)];
        st(var_v + 1, colsum);
        if (t == p.T - 1) {
          float post = rnd<S>(ld(var_v) + colsum);
          if (vq) post = vqf(post);
          st(var_v, post);
        }
      }
    });
    __syncthreads();
  }
  if (p.T == 0) __syncthreads();  // the LLRs are the posterior

  // output: the stored posterior, or its hard decisions; K3: syndrome of
  // the stored posterior, per base row
  int fail = 0;
  each_unit<WIDE>(L, [&](int u) {
    for (int j = 0; j < p.nb; ++j) {
      const int idx = j * L + u;
      const float stored = ld(&vars[2 * idx]);
      if (p.post != nullptr)
        st(static_cast<S*>(p.post) + f * n + idx, stored);
      else
        p.bits[f * n + idx] = (int8_t)(stored < 0.0f);
    }
    for (int i = 0; i < p.mb; ++i) {
      int parity = 0;
      for (int b = rptr[i]; b < rptr[i + 1]; ++b) {
        const int2 cs = bcs[b];
        int v = u + cs.y;
        v = (v >= L) ? v - L : v;
        parity ^= (int)(ld(&vars[2 * (cs.x + v)]) < 0.0f);
      }
      fail |= parity;
    }
  });
  const int any_fail = __syncthreads_or(fail);
  if (tid == 0) p.ok[f] = (uint8_t)(any_fail == 0);
}

template <typename S>
size_t smem_bytes(const FloodParams& p) {
  return layout<S>(p.nb, p.mb, p.NB, p.L, p.var.q_mode, p.var.q_levels,
                   p.v_mode, p.v_levels).total;
}

// the kernel instance of the variant's kind for MAXT threads
template <typename S, int MAXT, bool WIDE>
const void* instance(int kind) {
  switch (kind) {
    case kNms: return (const void*)fused_flooding_kernel<S, kNms, MAXT, WIDE>;
    case kOms: return (const void*)fused_flooding_kernel<S, kOms, MAXT, WIDE>;
    case kRcq: return (const void*)fused_flooding_kernel<S, kRcq, MAXT, WIDE>;
    case kWrcq:
      return (const void*)fused_flooding_kernel<S, kWrcq, MAXT, WIDE>;
    default: return (const void*)fused_flooding_kernel<S, kOrcq, MAXT, WIDE>;
  }
}

// the instance for a lift of L (block_threads(L) threads): the register cap
// of 768 threads measured 6% faster than that of 1024 at the zoo's L = 256
// (PERF.md)
template <typename S>
const void* kernel_for(int kind, int L) {
  if (L <= 768) return instance<S, 768, false>(kind);
  return (L <= 1024) ? instance<S, 1024, false>(kind)
                     : instance<S, 1024, true>(kind);
}

template <typename S>
cudaError_t launch(FloodParams p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<S>(p);
  const void* fn = kernel_for<S>(p.var.kind, p.L);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  return cudaLaunchKernel(fn, dim3(B), dim3(block_threads(p.L)), args, smem,
                          stream);
}

// CTAs of the kernel resident on one SM at the lift's block size, or -1
template <typename S>
int occupancy(const FloodParams& p) {
  const size_t smem = smem_bytes<S>(p);
  const void* fn = kernel_for<S>(p.var.kind, p.L);
  int blocks = -1;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fn, block_threads(p.L), smem) != cudaSuccess)
    return -1;
  return blocks;
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

// the kernel's shared memory per CTA, in bytes (the wrapper checks it
// against the card's limit before a launch)
extern "C" int ldpc_fused_flooding_smem(int nb, int mb, int NB, int L,
                                        int is_bf16, int q_mode, int q_levels,
                                        int v_mode, int v_levels) {
  const Layout y =
      is_bf16 ? layout<__nv_bfloat16>(nb, mb, NB, L, q_mode, q_levels, v_mode,
                                      v_levels)
              : layout<float>(nb, mb, NB, L, q_mode, q_levels, v_mode,
                              v_levels);
  return (int)y.total;
}

// resident CTAs per SM of the kernel for a lift of L (-1 on a CUDA error)
extern "C" int ldpc_fused_flooding_occupancy(int nb, int mb, int NB, int L,
                                             int is_bf16, int kind,
                                             int q_mode, int q_levels,
                                             int v_mode, int v_levels) {
  FloodParams p{};
  p.var.kind = kind;
  p.nb = nb;
  p.mb = mb;
  p.NB = NB;
  p.L = L;
  p.v_mode = v_mode;
  p.v_levels = v_levels;
  p.var.q_mode = q_mode;
  p.var.q_levels = q_levels;
  return is_bf16 ? occupancy<__nv_bfloat16>(p) : occupancy<float>(p);
}
