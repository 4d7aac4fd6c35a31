// Device helpers shared by the whole-decode kernels (fused_layered.cu,
// fused_flooding.cu): storage-type loads, stores and rounding, NaN-aware
// min, and K2, the in-kernel quantize-dequantize.
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

// the variant's check-to-variable transform of the leave-one-out sign and
// magnitude, for iteration t and block b (beta bb, alpha ab)
struct Variant {
  int kind, alpha_in_cn;
  int q_mode, q_levels, thr_w;
  const float* thr;  // [T, thr_w]
  const float* qp;   // [T, 2]
};

__device__ __forceinline__ float c2v(const Variant& v, float loo_sign,
                                     float loo_mag, float bb, float ab,
                                     int t) {
  if (v.kind == kNms) return bb * loo_sign * loo_mag;
  if (v.kind == kRcq)
    return qdq(loo_sign * loo_mag, t, v.q_mode, v.q_levels, v.thr, v.thr_w,
               v.qp);
  if (v.kind == kWrcq)
    return qdq(bb * loo_sign * loo_mag, t, v.q_mode, v.q_levels, v.thr,
               v.thr_w, v.qp);
  // oms, orcq
  float off = relu(loo_mag - bb);
  if (v.alpha_in_cn) off = off - ab;
  float out = loo_sign * off;
  if (v.kind == kOrcq)
    out = qdq(out, t, v.q_mode, v.q_levels, v.thr, v.thr_w, v.qp);
  return out;
}

}  // namespace
