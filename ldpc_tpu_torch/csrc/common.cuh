// Device helpers shared by the kernels (fused_layered.cu,
// fused_flooding.cu, qc_cn.cu, qc_vn.cu): storage-type loads, stores and
// rounding, NaN-aware min, K2 (the in-kernel quantize-dequantize), the
// variants' check-node transform, and K5's and K6's 8-byte frame accesses.
//
// K2 replaces ldpc_tpu/decode/pallas_fused.py::_kernel_qdq and
// pallas_qc.py::_kernel_qdq (with the static routing of _qdq_mode done by
// the Python wrappers). Its plain PyTorch counterparts are
// ldpc_tpu_torch/quantizer.py's staircase_qdq, uniform_qdq and power_qdq.
//
// Numerics. Every storage-type operation is a float32 operation followed by
// round-to-nearest-even to the storage type S (bf16 or f32); the quantizers
// run in float32. Build with -fmad=false and without --use_fast_math so
// that every float32 operation is rounded separately and M / C and C / M
// are IEEE divisions, as in the plain versions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSignTiny = 1e-30f;  // quantizer.QDQ_SIGN_TINY

enum Kind { kNms = 0, kOms = 1, kRcq = 2, kWrcq = 3, kOrcq = 4 };
enum QMode { kStaircase = 0, kUniform = 1, kPower = 2 };

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// round a float32 value to the storage type S and back
template <typename S>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// NaN-propagating min/max, as jnp.minimum / jnp.maximum
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float relu(float x) {
  return (x < 0.0f) ? 0.0f : x;  // NaN passes through
}

// K2, the quantize-dequantize of x for iteration t (quantizer.py's
// staircase_qdq, uniform_qdq and power_qdq), with its per-iteration work
// done once: the quantizer of one iteration as constants (M / C, C / M and
// 1 / gamma, the plain versions' IEEE divisions, divided once) and a table
// of float32 values: the staircase's thresholds, or the power law's
// reconstruction levels C * powf(i / M, gamma), i = 0..M, the expression
// the plain version evaluates for its index corrections and its snapped
// value. qdq_staged then costs one powf per call (none when 1 / gamma ==
// 1) instead of four.
struct QConst {
  int mode, levels;
  float C, M, scale, step, gamma, inv_gamma;
};

__device__ __forceinline__ QConst qconst(int t, int mode, int levels,
                                         const float* __restrict__ qp) {
  QConst q;
  q.mode = mode;
  q.levels = levels;
  q.C = qp[2 * t];
  q.gamma = qp[2 * t + 1];
  q.M = (float)(levels - 1);
  q.scale = q.M / q.C;
  q.step = q.C / q.M;
  q.inv_gamma = 1.0f / q.gamma;
  return q;
}

// entry i of the quantizer's table for iteration t (no table for uniform);
// powf(r, 1.0f) == r for every float32 r in [0, 1] on the H100
// (tests_gpu/test_qc_rowcol_cuda.py checks all of them), so gamma == 1
// skips it, here and in qdq_staged
__device__ __forceinline__ float qtable_entry(const QConst& q, int i, int t,
                                              const float* __restrict__ thr,
                                              int thr_w) {
  if (q.mode == kStaircase) return thr[t * thr_w + i];
  const float r = (float)i / q.M;
  return q.C * ((q.gamma == 1.0f) ? r : powf(r, q.gamma));
}

// powf as a call: the power law's one remaining powf stays out of the
// unrolled bodies that inline qdq_staged (and is skipped at gamma == 1)
__device__ __noinline__ float powf_call(float r, float e) {
  return powf(r, e);
}

// the uniform closed form of K2 with its constants staged
__device__ __forceinline__ float qdq_uniform(float x, const QConst& q) {
  const float mag = fabsf(x);
  if (mag != mag) return mag;  // the plain versions' clamps keep a NaN
  float idx = fminf(fmaxf(floorf(mag * q.scale), 0.0f), q.M);
  const float up = fminf(idx + 1.0f, q.M) * q.step;
  if (mag >= up && idx < q.M) idx = idx + 1.0f;
  const float down = idx * q.step;
  if (mag < down) idx = fmaxf(idx - 1.0f, 0.0f);
  float snapped = idx * q.step;
  snapped = (snapped < kSignTiny) ? kSignTiny : snapped;
  return (x < 0.0f) ? -snapped : snapped;
}

__device__ __forceinline__ float qdq_staged(float x, const QConst& q,
                                            const float* tab) {
  if (q.mode == kUniform) return qdq_uniform(x, q);
  const float mag = fabsf(x);
  float snapped;
  if (q.mode == kStaircase) {
    snapped = 0.0f;
    for (int j = 1; j < q.levels; ++j) {
      const float step = tab[j] - tab[j - 1];
      snapped = snapped + ((mag >= tab[j]) ? step : 0.0f);
    }
  } else if (mag != mag) {
    return mag;  // the plain versions' clamps keep a NaN
  } else {
    const float r = fminf(fmaxf(mag / q.C, 0.0f), 1.0f);
    const float p = (q.inv_gamma == 1.0f) ? r : powf_call(r, q.inv_gamma);
    const int m = q.levels - 1;
    int i = (int)fminf(fmaxf(floorf(q.M * p), 0.0f), q.M);
    if (i < m && mag >= tab[i + 1]) i = i + 1;  // up = level min(i+1, M)
    if (mag < tab[i]) i = (i > 0) ? i - 1 : 0;  // down = level i
    snapped = tab[i];
  }
  snapped = (snapped < kSignTiny) ? kSignTiny : snapped;
  return (x < 0.0f) ? -snapped : snapped;
}

// the variant of a decode: its kind, whether alpha subtracts inside the
// check node, and its CN quantizer's routing and tables
struct Variant {
  int kind, alpha_in_cn;
  int q_mode, q_levels, thr_w;
  const float* thr;  // [T, thr_w]
  const float* qp;   // [T, 2]
};

// a value known at compile time, to pick the instance of a generic lambda
// (a loop specialised on what its edges do)
template <int N>
struct Const {
  static constexpr int value = N;
};

// the fused kernels' threads per block for a lift of L: one per check or
// variable of a block up to 1024, else 1024 threads that each take
// ceil(L / 1024) of them (the WIDE instances)
__host__ __device__ __forceinline__ int block_threads(int L) {
  return L <= 1024 ? L : 1024;
}

// f(u) for each check or variable u of a block that this thread owns: u =
// threadIdx.x where the block has L threads, else threadIdx.x,
// threadIdx.x + blockDim.x, ... below L (WIDE)
template <bool WIDE, typename F>
__device__ __forceinline__ void each_unit(int L, F&& f) {
  if constexpr (WIDE) {
    for (int u = threadIdx.x; u < L; u += blockDim.x) f(u);
  } else {
    f((int)threadIdx.x);
  }
}

// a quantizer of one iteration as a kernel applies it: its constants and
// its table (in shared memory)
struct Quant {
  QConst q;
  const float* tab;
  __device__ __forceinline__ float operator()(float x) const {
    return qdq_staged(x, q, tab);
  }
};

// the variant's check-to-variable transform of the leave-one-out sign and
// magnitude for block b (beta bb, alpha ab) of kind KIND (compile time),
// with the quantizer quantize
template <int KIND, typename Q>
__device__ __forceinline__ float c2v_kind(int alpha_in_cn, float loo_sign,
                                          float loo_mag, float bb, float ab,
                                          Q quantize) {
  if constexpr (KIND == kNms) {
    return bb * loo_sign * loo_mag;
  } else if constexpr (KIND == kRcq) {
    return quantize(loo_sign * loo_mag);
  } else if constexpr (KIND == kWrcq) {
    return quantize(bb * loo_sign * loo_mag);
  } else {  // oms, orcq
    float off = relu(loo_mag - bb);
    if (alpha_in_cn) off = off - ab;
    const float out = loo_sign * off;
    if constexpr (KIND == kOrcq) return quantize(out);
    return out;
  }
}

// the two S values at p, p + 1 (8-byte aligned in f32, 4 in bf16)
__device__ __forceinline__ void ld_pair(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void ld_pair(const __nv_bfloat16* p, float& a,
                                        float& b) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}

// K5, K6: V consecutive frames of S in one 8-byte access, 4 bf16 or 2 f32
// frames (4- and 16-byte accesses measured slower in K6 on the H100,
// PERF.md)
template <typename S>
struct Frames {
  static constexpr int V = 8 / (int)sizeof(S);
};

__device__ __forceinline__ void unpack(uint32_t w, float* x, float) {
  x[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(uint32_t w, float* x, __nv_bfloat16) {
  x[0] = __uint_as_float(w << 16);  // element 0 is the low half
  x[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack(const float* x, float) {
  return __float_as_uint(x[0]);
}
__device__ __forceinline__ uint32_t pack(const float* x, __nv_bfloat16) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x[0])) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x[1])) << 16);
}

// frames f0.. of one [*, B] row; n = B - f0 of them are in the batch; vec:
// one 8-byte access (B % V == 0 and the tensor 8-byte aligned), else frame
// by frame
template <typename S>
__device__ __forceinline__ void load_frames(const S* p, int vec, int n,
                                            float (&x)[Frames<S>::V]) {
  constexpr int V = Frames<S>::V, E = V / 2;  // elements per 32-bit word
  if (vec) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    unpack(r.x, &x[0], S());
    unpack(r.y, &x[E], S());
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = (i < n) ? ld(p + i) : 0.0f;
  }
}
template <typename S>
__device__ __forceinline__ void store_frames(S* p, int vec, int n,
                                             const float (&x)[Frames<S>::V]) {
  constexpr int V = Frames<S>::V, E = V / 2;
  if (vec) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack(&x[0], S()),
                                              pack(&x[E], S()));
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (i < n) st(p + i, x[i]);
  }
}


}  // namespace
