// Whole-decode layered min-sum kernel for QC LDPC codes, for Hopper (sm_90a).
//
// Replaces ldpc_tpu/decode/pallas_fused.py::_make_layered_kernel (K1), with
// its in-kernel quantizer _kernel_qdq (K2, common.cuh) and syndrome
// _syndrome_epilogue (K3) inlined. Its plain PyTorch version, with the same
// loop, op order and rounding points, is
// ldpc_tpu_torch/decode/fused.py::_fused_layered_plain.
//
// Design. One CTA decodes one frame for all T iterations; blockDim.x = lift
// L, and thread u owns check u of the current base row. Check u of block b
// touches variable (u + shift_b) % L of column col_b, so within a base row
// every thread touches distinct addresses and one __syncthreads() between
// base rows (layers) is the only ordering needed. Per variable the frame
// keeps its channel LLR (at the end the posterior) and its column sum, a
// pair of S read with one load. The plain version's c2v memory C[NB, L]
// is kept compressed, per check (row i, check u), as K4 keeps its check
// state (layout() below):
//   - the first argmin, the parity of the negative v2c count and one sign
//     bit per edge (the v2c's x < 0), written by pass 1 and read by pass 2
//     (so pass 2 neither recomputes the v2c nor reloads the LLR);
//   - on a row whose blocks share (beta, alpha) at the iteration, the four
//     c2v a check can send, c2v(+-1, min1 or min2) rounded to S, of which
//     each edge picks one; on any other row min1 and min2 as float32 (the
//     v2c llr + alpha * ext is not rounded to S), from which each c2v is
//     recomputed with the same operands, so the same bits (Chk below).
// Row i's pass 1 at iteration t subtracts the c2v it stored at t - 1, so
// the (beta, alpha) pairs and the CN quantizer (QConst and table) of t are
// staged at the start of iteration t beside those of t - 1, double-
// buffered by the parity of t. Iteration 0 reads no state (the plain
// version's C starts at zero and x - 0 == x), so nothing is cleared. The
// check state lives in shared memory where it fits (ldpc_fused_layered_smem
// says how much a CTA needs); otherwise it lives, compressed the same way,
// in a per-frame device scratch (the ONCHIP = false instance). The
// variant's kind is a template parameter, each edge loop is specialised
// on whether its c2v are picked or transformed (so the common loop carries
// no inlined quantizer it skips) and unrolled by two, and lifts up to 768
// take an instance capped at 80 registers a thread, larger ones one capped
// at 64 (MAXT), as in K4. Lifts above 1024 take the WIDE instances: 1024
// threads, each running checks u, u + 1024, ... of the row in turn
// (each_unit, common.cuh); a row's checks touch distinct variables, so
// the order within the row does not matter.
//
// What bounds it. At the bench width (5x37 base, L = 256, bf16) a CTA holds
// 37,888 B of LLRs and column sums and 20,480 B of check state (8-byte
// slots and two sign words per check), 63 KB with the tables: 3 CTAs per
// SM. Device memory sees only the LLRs in and the bits or posterior out,
// so the kernel is bound by its float32 operations and the shared-memory
// loads and address arithmetic around them (chip_smoke.py's edge_ops).
//
// Numerics: see common.cuh. Every storage-type operation is a float32
// operation followed by round-to-nearest-even to S; check-node math and
// the quantizers run in float32, as in the plain version.

#include "common.cuh"

namespace {

struct LayerParams {
  const void* llr;      // [B, n] S
  void* post;           // [B, n] S, or null (lean)
  int8_t* bits;         // [B, n] int8, or null (full)
  uint8_t* ok;          // [B]
  void* state;          // [B, state bytes]: the check state, or null (on chip)
  const float* beta;    // [T, NB]
  const float* alpha;   // [T, NB]
  const float* vthr;    // [T, vthr_w]
  const float* vqp;     // [T, 2]
  const int* row_ptr;   // [mb + 1]; row i owns blocks row_ptr[i]..row_ptr[i+1)
  const int* block_col;    // [NB]
  const int* block_shift;  // [NB]
  int nb, mb, NB, L, T, dcmax;
  int vthr_w, with_vqdq, v_mode, v_levels;
  Variant var;
};

// a check's slot word: on a row whose blocks share (beta, alpha) at the
// iteration, the four c2v it can send, c2v(+1, min1), c2v(-1, min1),
// c2v(+1, min2), c2v(-1, min2), each rounded to S; on any other row min1
// and min2 as float32. bf16 packs four c2v or two minima into 8 bytes, f32
// takes 16.
template <typename S>
struct Chk;
template <>
struct Chk<__nv_bfloat16> {
  uint2 w;
  __device__ __forceinline__ float c2v(int s) const {
    const uint32_t x = (s & 2) ? w.y : w.x;
    return __uint_as_float((s & 1) ? (x & 0xffff0000u) : (x << 16));
  }
  __device__ __forceinline__ float min(int j) const {
    return __uint_as_float(j ? w.y : w.x);
  }
  __device__ __forceinline__ void set_c2v(float a, float b, float c,
                                          float d) {
    w = make_uint2(
        (__float_as_uint(a) >> 16) | (__float_as_uint(b) & 0xffff0000u),
        (__float_as_uint(c) >> 16) | (__float_as_uint(d) & 0xffff0000u));
  }
  __device__ __forceinline__ void set_min(float a, float b) {
    w = make_uint2(__float_as_uint(a), __float_as_uint(b));
  }
};
template <>
struct Chk<float> {
  uint4 w;
  __device__ __forceinline__ float c2v(int s) const {
    const uint32_t x = (s & 2) ? ((s & 1) ? w.w : w.z)
                               : ((s & 1) ? w.y : w.x);
    return __uint_as_float(x);
  }
  __device__ __forceinline__ float min(int j) const {
    return __uint_as_float(j ? w.y : w.x);
  }
  __device__ __forceinline__ void set_c2v(float a, float b, float c,
                                          float d) {
    w = make_uint4(__float_as_uint(a), __float_as_uint(b),
                   __float_as_uint(c), __float_as_uint(d));
  }
  __device__ __forceinline__ void set_min(float a, float b) {
    w = make_uint4(__float_as_uint(a), __float_as_uint(b), 0u, 0u);
  }
};

// a check's four c2v slots unpacked to float32 once per check, and the
// pick of an edge (j: it is the argmin; loo_neg: its leave-one-out sign)
template <typename S>
struct Slots {
  float c[4];
  __device__ __forceinline__ explicit Slots(const Chk<S>& k) {
#pragma unroll
    for (int s = 0; s < 4; ++s) c[s] = k.c2v(s);
  }
  __device__ __forceinline__ float pick(int j, int loo_neg) const {
    const float one = loo_neg ? c[1] : c[0];
    const float two = loo_neg ? c[3] : c[2];
    return j ? two : one;
  }
};

// a check's meta word (first argmin, parity of the negative count, whether
// its slots hold c2v values) sits in bits 14..31 of its last sign word; the
// sign bits of that word use bits 0..13 (nw below)
constexpr int kMetaShift = 14;

// byte offsets of one CTA's regions: the check state (chk, signs) from
// the start of shared memory when it is on chip, else from the start of
// the frame's scratch (state bytes per frame), and the rest in shared
// memory after it (ldpc_fused_layered_smem reports the total)
struct Layout {
  size_t chk, signs, state, qcs, bcs, tabs, vtab, vars, rptr, uni, total;
  int qlen, vlen, tab_w, nw;
};

template <typename S>
__host__ __device__ Layout layout(int nb, int mb, int NB, int L, int dcmax,
                                  int q_mode, int q_levels, int v_mode,
                                  int v_levels, bool onchip) {
  Layout y;
  y.qlen = (q_mode == kUniform) ? 0 : q_levels;
  y.vlen = (v_mode == kUniform) ? 0 : v_levels;
  // (beta, alpha) pairs and the q table; even, so that the pairs of both
  // parities are 8-byte aligned
  y.tab_w = 2 * NB + y.qlen;
  y.tab_w += y.tab_w & 1;
  // sign words per check: dc <= dcmax sign bits and the 18 meta bits
  y.nw = (dcmax + 18 + 31) / 32;
  size_t o = 0;
  y.chk = o;    o += (size_t)mb * L * sizeof(Chk<S>);
  y.signs = o;  o += (size_t)y.nw * mb * L * sizeof(uint32_t);
  y.state = (o + 15) & ~(size_t)15;  // frames' scratches stay 16-aligned
  o = onchip ? y.state : 0;
  y.qcs = o;    o += 3 * sizeof(QConst);
  y.bcs = o;    o += (size_t)NB * sizeof(int2);
  y.tabs = o;   o += (size_t)2 * y.tab_w * sizeof(float);
  y.vtab = o;   o += (size_t)y.vlen * sizeof(float);
  o = (o + 7) & ~(size_t)7;
  y.vars = o;   o += (size_t)nb * L * 2 * sizeof(S);
  y.rptr = o;   o += (size_t)(mb + 1) * sizeof(int);
  y.uni = o;    o += (size_t)2 * mb * sizeof(int);
  y.total = o;
  return y;
}

// MAXT: the most threads the instance takes (768: up to 80 registers a
// thread, 1024: 64); ONCHIP: the check state in shared memory; WIDE:
// L > 1024, each thread takes several checks and variables of a block
template <typename S, int KIND, int MAXT, bool ONCHIP, bool WIDE>
__global__ void __launch_bounds__(MAXT) fused_layered_kernel(LayerParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Variant& var = p.var;
  const Layout y = layout<S>(p.nb, p.mb, p.NB, p.L, p.dcmax, var.q_mode,
                             var.q_levels, p.v_mode, p.v_levels, ONCHIP);
  const int L = p.L, NB = p.NB, ML = p.mb * L;
  // the block's threads stride the tables' staging loops
  const int tid = threadIdx.x, nt = WIDE ? (int)blockDim.x : L;
  const size_t f = blockIdx.x;
  const size_t n = (size_t)p.nb * L;
  unsigned char* sbase =
      ONCHIP ? smem : static_cast<unsigned char*>(p.state) + f * y.state;
  Chk<S>* chk = reinterpret_cast<Chk<S>*>(sbase + y.chk);          // [mb, L]
  uint32_t* signs = reinterpret_cast<uint32_t*>(sbase + y.signs);  // [nw][mb, L]
  QConst* qcs = reinterpret_cast<QConst*>(smem + y.qcs);  // [2] q, then v
  int2* bcs = reinterpret_cast<int2*>(smem + y.bcs);  // block: col * L, shift
  float* tabs = reinterpret_cast<float*>(smem + y.tabs);  // [2][tab_w]
  float* vtab = reinterpret_cast<float*>(smem + y.vtab);  // v table of T - 1
  // per variable (LLR, column sum); at the end the LLR becomes the posterior
  S* vars = reinterpret_cast<S*>(smem + y.vars);          // [nb, L][2]
  int* rptr = reinterpret_cast<int*>(smem + y.rptr);
  // per row and parity of t: its blocks share (beta, alpha) at t
  int* uni = reinterpret_cast<int*>(smem + y.uni);        // [2][mb]
  const int last = (y.nw - 1) * ML;  // the last sign word of check 0
  const S* llr_g = static_cast<const S*>(p.llr) + f * n;
  const int aic = var.alpha_in_cn;

  for (int i = tid; i <= p.mb; i += nt) rptr[i] = p.row_ptr[i];
  for (int b = tid; b < NB; b += nt)
    bcs[b] = make_int2(p.block_col[b] * L, p.block_shift[b]);
  each_unit<WIDE>(L, [&](int u) {
    for (int j = 0; j < p.nb; ++j) {
      vars[2 * (j * L + u)] = llr_g[j * L + u];
      st(&vars[2 * (j * L + u) + 1], 0.0f);
    }
  });
  const int vq = p.with_vqdq && p.T > 0;
  if (vq) {  // the posterior's quantizer, of iteration T - 1
    const QConst q = qconst(p.T - 1, p.v_mode, p.v_levels, p.vqp);
    if (tid == 0) qcs[2] = q;
    for (int i = tid; i < y.vlen; i += nt)
      vtab[i] = qtable_entry(q, i, p.T - 1, p.vthr, p.vthr_w);
  }

  const float kInf = __int_as_float(0x7f800000);
  for (int t = 0; t < p.T; ++t) {
    const int cur = t & 1, prv = cur ^ 1;
    // stage the tables of t beside those of t - 1 (read by pass 1)
    {
      float* tc = tabs + cur * y.tab_w;
      const QConst q = qconst(t, var.q_mode, var.q_levels, var.qp);
      if (tid == 0) qcs[cur] = q;
      for (int b = tid; b < NB; b += nt) {
        tc[2 * b] = p.beta[t * NB + b];
        tc[2 * b + 1] = p.alpha[t * NB + b];
      }
      for (int i = tid; i < y.qlen; i += nt)
        tc[2 * NB + i] = qtable_entry(q, i, t, var.thr, var.thr_w);
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
    __syncthreads();  // t = 0: the graph tables and LLRs; else the last row

    const float2* bap = reinterpret_cast<const float2*>(tabs + prv * y.tab_w);
    const float2* bac = reinterpret_cast<const float2*>(tabs + cur * y.tab_w);
    const Quant cqp{qcs[prv], tabs + prv * y.tab_w + 2 * NB};  // of t - 1
    const Quant cqt{qcs[cur], tabs + cur * y.tab_w + 2 * NB};  // of t
    for (int i = 0; i < p.mb; ++i) {
      each_unit<WIDE>(L, [&](int u) {
        const int b0 = rptr[i];
        const int dc = rptr[i + 1] - b0;
        const int ci = i * L + u;
        Chk<S> old{};
        uint32_t ometa = 0;
        if (t > 0) {
          old = chk[ci];
          ometa = signs[last + ci] >> kMetaShift;
        }
        const int oargm = ometa & 0xffff, opar = (ometa >> 16) & 1;
        const int ouni = ometa >> 17;
        // where the row shares (beta, alpha) at t, every block's alpha is
        // this one, bit for bit
        const int un = uni[cur * p.mb + i];
        const float arow = bac[b0].y;
        // pass 1: the c2v stored at t - 1 leaves the column sum (ext), the
        // fresh v2c from ext, the running (min1, min2, first argmin), the
        // negative count and the sign bits. OLD: the c2v taken back is none
        // (t = 0), picked from the four (1) or transformed from min1 or min2
        // with the tables of t - 1 (2); a loop for each
        float min1 = 0.0f, min2 = kInf;
        int argm = 0, neg_cnt = 0;
        const auto pass1 = [&](auto old_kind) {
          constexpr int OLD = decltype(old_kind)::value;
          const Slots<S> oslot(old);
          for (int kw = 0; kw < dc; kw += 32) {
            uint32_t* sw = signs + (kw >> 5) * ML + ci;
            const uint32_t osigns = OLD ? *sw : 0u;
            const auto v2c_at = [&](int k) {
              const int b = b0 + k;
              const int2 cs = bcs[b];
              int v = u + cs.y;
              v = (v >= L) ? v - L : v;
              S* var_v = &vars[2 * (cs.x + v)];
              float l, ext;
              ld_pair(var_v, l, ext);
              if constexpr (OLD != 0) {
                const int j = oargm == k;
                const int loo_neg = ((osigns >> (k & 31)) & 1) ^ opar;
                float c2;
                if constexpr (OLD == 1) {
                  c2 = oslot.pick(j, loo_neg);
                } else {
                  const float2 ba = bap[b];
                  c2 = rnd<S>(c2v_kind<KIND>(aic, loo_neg ? -1.0f : 1.0f,
                                             old.min(j), ba.x, ba.y, cqp));
                }
                ext = rnd<S>(ext - c2);
              }
              st(var_v + 1, ext);
              // alpha inside the CN: a storage-type add; otherwise the
              // float32 weight promotes llr + alpha * ext to float32
              const float ab = un ? arow : bac[b].y;
              return aic ? rnd<S>(l + ext) : l + ab * ext;
            };
            uint32_t nsigns = 0u;
            int k = kw;
            if (k == 0) {  // edge 0 starts the chain
              const float nv = v2c_at(0);
              min1 = fabsf(nv);
              neg_cnt = nv < 0.0f;
              nsigns = (uint32_t)neg_cnt;
              k = 1;
            }
            const int kend = min(kw + 32, dc);
  #pragma unroll 2
            for (; k < kend; ++k) {
              const float nv = v2c_at(k);
              const float mk = fabsf(nv);
              const int negk = nv < 0.0f;
              const bool new_min = mk < min1;
              min2 = new_min ? min1 : nan_min(min2, mk);
              min1 = new_min ? mk : min1;
              argm = new_min ? k : argm;
              neg_cnt += negk;
              nsigns |= (uint32_t)negk << (k & 31);
            }
            *sw = nsigns;
          }
        };
        if (t == 0)
          pass1(Const<0>{});
        else if (ouni)
          pass1(Const<1>{});
        else
          pass1(Const<2>{});
        if (dc == 1) min2 = min1;  // degree-1 checks
        const int par = neg_cnt & 1;
        // the new state: the row's four c2v with the tables of t, or the
        // two minima
        Chk<S> s;
        if (un) {
          const float2 ba = bac[b0];
          const auto c2v_of = [&](float sign, float mag) {
            return rnd<S>(c2v_kind<KIND>(aic, sign, mag, ba.x, ba.y, cqt));
          };
          s.set_c2v(c2v_of(1.0f, min1), c2v_of(-1.0f, min1),
                    c2v_of(1.0f, min2), c2v_of(-1.0f, min2));
        } else {
          s.set_min(min1, min2);
        }
        // pass 2: each edge's c2v at t, picked (PICK) or transformed, back
        // into the column sum; a loop for each
        const auto pass2 = [&](auto pick) {
          constexpr bool PICK = decltype(pick)::value;
          const Slots<S> slot(s);
          for (int kw = 0; kw < dc; kw += 32) {
            const uint32_t w = signs[(kw >> 5) * ML + ci];
            const int kend = min(kw + 32, dc);
  #pragma unroll 2
            for (int k = kw; k < kend; ++k) {
              const int b = b0 + k;
              const int2 cs = bcs[b];
              int v = u + cs.y;
              v = (v >= L) ? v - L : v;
              S* cs_v = &vars[2 * (cs.x + v) + 1];
              const int j = argm == k;
              const int loo_neg = ((w >> (k & 31)) & 1) ^ par;
              float c2;
              if constexpr (PICK) {
                c2 = slot.pick(j, loo_neg);
              } else {
                const float2 ba = bac[b];
                c2 = rnd<S>(c2v_kind<KIND>(aic, loo_neg ? -1.0f : 1.0f,
                                           s.min(j), ba.x, ba.y, cqt));
              }
              st(cs_v, ld(cs_v) + c2);
            }
          }
        };
        if (un)
          pass2(Const<1>{});
        else
          pass2(Const<0>{});
        chk[ci] = s;
        const uint32_t meta = (uint32_t)argm | ((uint32_t)par << 16) |
                              ((uint32_t)un << 17);
        uint32_t* lw = signs + last + ci;  // keeps this row's sign bits
        const uint32_t bits = (dc > 32 * (y.nw - 1)) ? *lw & 0x3fffu : 0u;
        *lw = bits | (meta << kMetaShift);
      });
      __syncthreads();
    }
  }
  if (p.T == 0) __syncthreads();

  // posterior = llr + colsum, bv quantizer of T - 1, stored in S
  const Quant vqf{qcs[2], vtab};
  each_unit<WIDE>(L, [&](int u) {
    for (int j = 0; j < p.nb; ++j) {
      const int idx = j * L + u;
      S* var_v = &vars[2 * idx];
      float l, colsum;
      ld_pair(var_v, l, colsum);
      float post = rnd<S>(l + colsum);
      if (vq) post = vqf(post);
      st(var_v, post);
      const float stored = ld(var_v);
      if (p.post != nullptr)
        st(static_cast<S*>(p.post) + f * n + idx, stored);
      else
        p.bits[f * n + idx] = (int8_t)(stored < 0.0f);
    }
  });
  __syncthreads();

  // K3: syndrome of the stored posterior, per base row
  int fail = 0;
  each_unit<WIDE>(L, [&](int u) {
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
Layout layout_of(const LayerParams& p, bool onchip) {
  return layout<S>(p.nb, p.mb, p.NB, p.L, p.dcmax, p.var.q_mode,
                   p.var.q_levels, p.v_mode, p.v_levels, onchip);
}

template <typename S, int MAXT, bool ONCHIP, bool WIDE>
const void* instance(int kind) {
  switch (kind) {
    case kNms:
      return (const void*)fused_layered_kernel<S, kNms, MAXT, ONCHIP, WIDE>;
    case kOms:
      return (const void*)fused_layered_kernel<S, kOms, MAXT, ONCHIP, WIDE>;
    case kRcq:
      return (const void*)fused_layered_kernel<S, kRcq, MAXT, ONCHIP, WIDE>;
    case kWrcq:
      return (const void*)fused_layered_kernel<S, kWrcq, MAXT, ONCHIP, WIDE>;
    default:
      return (const void*)fused_layered_kernel<S, kOrcq, MAXT, ONCHIP, WIDE>;
  }
}

template <typename S, bool ONCHIP>
const void* instance_for(int kind, int L) {
  if (L <= 768) return instance<S, 768, ONCHIP, false>(kind);
  return (L <= 1024) ? instance<S, 1024, ONCHIP, false>(kind)
                     : instance<S, 1024, ONCHIP, true>(kind);
}

// the instance for a lift of L (block_threads(L) threads) with the check
// state on chip or in the scratch
template <typename S>
const void* kernel_for(int kind, int L, bool onchip) {
  return onchip ? instance_for<S, true>(kind, L)
                : instance_for<S, false>(kind, L);
}

template <typename S>
cudaError_t launch(LayerParams p, int B, cudaStream_t stream) {
  const bool onchip = p.state == nullptr;
  const size_t smem = layout_of<S>(p, onchip).total;
  const void* fn = kernel_for<S>(p.var.kind, p.L, onchip);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  return cudaLaunchKernel(fn, dim3(B), dim3(block_threads(p.L)), args, smem,
                          stream);
}

template <typename S>
int occupancy(const LayerParams& p, bool onchip) {
  const size_t smem = layout_of<S>(p, onchip).total;
  const void* fn = kernel_for<S>(p.var.kind, p.L, onchip);
  int blocks = -1;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fn, block_threads(p.L), smem) != cudaSuccess)
    return -1;
  return blocks;
}

LayerParams sizes(int nb, int mb, int NB, int L, int dcmax, int kind,
                  int q_mode, int q_levels, int v_mode, int v_levels) {
  LayerParams p{};
  p.nb = nb;
  p.mb = mb;
  p.NB = NB;
  p.L = L;
  p.dcmax = dcmax;
  p.v_mode = v_mode;
  p.v_levels = v_levels;
  p.var.kind = kind;
  p.var.q_mode = q_mode;
  p.var.q_levels = q_levels;
  return p;
}

template <typename S>
Layout layout_of(int nb, int mb, int NB, int L, int dcmax, int q_mode,
                 int q_levels, int v_mode, int v_levels, int onchip) {
  return layout_of<S>(
      sizes(nb, mb, NB, L, dcmax, 0, q_mode, q_levels, v_mode, v_levels),
      onchip != 0);
}

}  // namespace

extern "C" int ldpc_fused_layered(
    const void* llr, void* post, void* bits, void* ok, void* state,
    const void* beta, const void* alpha, const void* thr, int thr_w,
    const void* qp, const void* vthr, int vthr_w, const void* vqp,
    const void* row_ptr, const void* block_col, const void* block_shift,
    int B, int nb, int mb, int NB, int L, int T, int dcmax, int is_bf16,
    int kind, int alpha_in_cn, int q_mode, int q_levels, int with_vqdq,
    int v_mode, int v_levels, void* stream) {
  LayerParams p =
      sizes(nb, mb, NB, L, dcmax, kind, q_mode, q_levels, v_mode, v_levels);
  p.llr = llr;
  p.post = post;
  p.bits = static_cast<int8_t*>(bits);
  p.ok = static_cast<uint8_t*>(ok);
  p.state = state;
  p.beta = static_cast<const float*>(beta);
  p.alpha = static_cast<const float*>(alpha);
  p.vthr = static_cast<const float*>(vthr);
  p.vqp = static_cast<const float*>(vqp);
  p.row_ptr = static_cast<const int*>(row_ptr);
  p.block_col = static_cast<const int*>(block_col);
  p.block_shift = static_cast<const int*>(block_shift);
  p.T = T;
  p.vthr_w = vthr_w;
  p.with_vqdq = with_vqdq;
  p.var.alpha_in_cn = alpha_in_cn;
  p.var.thr = static_cast<const float*>(thr);
  p.var.thr_w = thr_w;
  p.var.qp = static_cast<const float*>(qp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<__nv_bfloat16>(p, B, s)
                       : launch<float>(p, B, s));
}

// the kernel's shared memory per CTA in bytes, with the check state on
// chip (onchip = 1) or in the per-frame scratch (0); the wrapper picks the
// placement that fits the card and checks it before a launch
extern "C" int ldpc_fused_layered_smem(int nb, int mb, int NB, int L,
                                       int dcmax, int is_bf16, int q_mode,
                                       int q_levels, int v_mode, int v_levels,
                                       int onchip) {
  return (int)(is_bf16 ? layout_of<__nv_bfloat16>(nb, mb, NB, L, dcmax,
                                                  q_mode, q_levels, v_mode,
                                                  v_levels, onchip)
                       : layout_of<float>(nb, mb, NB, L, dcmax, q_mode,
                                          q_levels, v_mode, v_levels, onchip))
      .total;
}

// the bytes of one frame's check state (the per-frame scratch of the
// instance that keeps it in device memory)
extern "C" int ldpc_fused_layered_state_bytes(int nb, int mb, int NB, int L,
                                              int dcmax, int is_bf16,
                                              int q_mode, int q_levels,
                                              int v_mode, int v_levels) {
  return (int)(is_bf16 ? layout_of<__nv_bfloat16>(nb, mb, NB, L, dcmax,
                                                  q_mode, q_levels, v_mode,
                                                  v_levels, 0)
                       : layout_of<float>(nb, mb, NB, L, dcmax, q_mode,
                                          q_levels, v_mode, v_levels, 0))
      .state;
}

// resident CTAs per SM of the kernel for a lift of L with the check state
// on chip or not (-1 on a CUDA error)
extern "C" int ldpc_fused_layered_occupancy(int nb, int mb, int NB, int L,
                                            int dcmax, int is_bf16, int kind,
                                            int q_mode, int q_levels,
                                            int v_mode, int v_levels,
                                            int onchip) {
  const LayerParams p =
      sizes(nb, mb, NB, L, dcmax, kind, q_mode, q_levels, v_mode, v_levels);
  return is_bf16 ? occupancy<__nv_bfloat16>(p, onchip != 0)
                 : occupancy<float>(p, onchip != 0);
}
