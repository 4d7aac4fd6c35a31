// Device helpers shared by the kernels (fused_layered.cu,
// fused_flooding.cu, qc_cn.cu, qc_vn.cu): storage-type loads, stores and
// rounding, NaN-aware min, and K2, the in-kernel quantize-dequantize.
//
// K2 replaces ldpc_tpu/decode/pallas_fused.py::_kernel_qdq (with the static
// routing of _qdq_mode done by the Python wrapper). Its plain PyTorch
// counterparts are ldpc_tpu_torch/quantizer.py's staircase_qdq,
// uniform_qdq and power_qdq.
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

// K2: quantize-dequantize of x for iteration t (quantizer.py forms)
__device__ float qdq(float x, int t, int mode, int levels,
                     const float* __restrict__ thr, int thr_w,
                     const float* __restrict__ qp) {
  const float mag = fabsf(x);
  float snapped;
  if (mode == kStaircase) {
    const float* row = thr + t * thr_w;
    snapped = 0.0f;
    for (int j = 1; j < levels; ++j) {
      const float step = row[j] - row[j - 1];
      snapped = snapped + ((mag >= row[j]) ? step : 0.0f);
    }
  } else {
    if (mag != mag) return mag;  // the plain versions' clamps keep a NaN
    const float C = qp[2 * t];
    const float M = (float)(levels - 1);
    float idx;
    if (mode == kUniform) {
      const float scale = M / C;
      const float step = C / M;
      idx = fminf(fmaxf(floorf(mag * scale), 0.0f), M);
      const float up = fminf(idx + 1.0f, M) * step;
      if (mag >= up && idx < M) idx = idx + 1.0f;
      const float down = idx * step;
      if (mag < down) idx = fmaxf(idx - 1.0f, 0.0f);
      snapped = idx * step;
    } else {
      const float gamma = qp[2 * t + 1];
      const float r = fminf(fmaxf(mag / C, 0.0f), 1.0f);
      idx = floorf(M * powf(r, 1.0f / gamma));
      idx = fminf(fmaxf(idx, 0.0f), M);
      const float up = C * powf(fminf(idx + 1.0f, M) / M, gamma);
      if (mag >= up && idx < M) idx = idx + 1.0f;
      const float down = C * powf(idx / M, gamma);
      if (mag < down) idx = fmaxf(idx - 1.0f, 0.0f);
      snapped = C * powf(idx / M, gamma);
    }
  }
  snapped = (snapped < kSignTiny) ? kSignTiny : snapped;
  return (x < 0.0f) ? -snapped : snapped;
}

// K2 with its per-iteration work done once (K4, K6): the quantizer of one
// iteration as constants (M / C, C / M and 1 / gamma divided once, the
// same IEEE divisions qdq does per call) and a table of float32 values:
// the staircase's thresholds, or the power law's reconstruction levels
// C * powf(i / M, gamma), i = 0..M, the expression qdq evaluates for its
// index correction and its snapped value. qdq_staged then gives qdq's bits
// with one powf per call (none when 1 / gamma == 1) instead of four.
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

// the uniform closed form of qdq with its constants staged
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

// the variant's check-to-variable transform of the leave-one-out sign and
// magnitude, for iteration t and block b (beta bb, alpha ab)
struct Variant {
  int kind, alpha_in_cn;
  int q_mode, q_levels, thr_w;
  const float* thr;  // [T, thr_w]
  const float* qp;   // [T, 2]
};

// the transform of kind KIND (compile time) with the quantizer quantize
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

__device__ __forceinline__ float c2v(const Variant& v, float loo_sign,
                                     float loo_mag, float bb, float ab,
                                     int t) {
  const auto q = [&](float x) {
    return qdq(x, t, v.q_mode, v.q_levels, v.thr, v.thr_w, v.qp);
  };
  const int aic = v.alpha_in_cn;
  switch (v.kind) {
    case kNms: return c2v_kind<kNms>(aic, loo_sign, loo_mag, bb, ab, q);
    case kOms: return c2v_kind<kOms>(aic, loo_sign, loo_mag, bb, ab, q);
    case kRcq: return c2v_kind<kRcq>(aic, loo_sign, loo_mag, bb, ab, q);
    case kWrcq: return c2v_kind<kWrcq>(aic, loo_sign, loo_mag, bb, ab, q);
    default: return c2v_kind<kOrcq>(aic, loo_sign, loo_mag, bb, ab, q);
  }
}

}  // namespace
