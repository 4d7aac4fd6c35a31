"""Non-uniform (RCQ) quantization on torch tensors.

Counterpart of ``ldpc_tpu/quantizer.py``. The numpy half (threshold
ladders, the thirds phase schedule, the stacked per-iteration tables) is a
copy; the quantize-dequantize forms the decoders use are torch functions
computed in float32, with the same op order as the JAX versions so the two
agree bit for bit (``tests/test_torch_codes_quantizer.py``).

Semantics (reference ``rcq_decoder.py:22-121``): thresholds
``tau_j = C * (j / (2^(bc-1) - 1))^gamma``; the magnitude snaps DOWN to the
largest ``tau_j <= |x|`` (inclusive compare), the sign is kept, and the
reconstructed magnitude is floored at ``QDQ_SIGN_TINY`` so a negative
dead-zone value keeps its sign through every ``< 0`` consumer.

The straight-through (training) variants copy JAX's expression and its
derivative rules exactly: the forward is ``clipped + (qdq(x) - clipped)``
evaluated in float32 (NOT ``qdq(x)``: where ``qdq`` gives the +-1e-30
floor and ``|x|`` is larger, the sum rounds to an exact 0.0), and the clip
to [-C, C] is ``minimum(maximum(x, -C), C)``, whose derivative at a tie is
one half, as ``jnp.clip``'s (``torch.clamp`` passes the whole gradient).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "QDQ_SIGN_TINY",
    "NonUniformQuantizer",
    "power_thresholds",
    "power_thresholds_for_levels",
    "quantize",
    "dequantize",
    "quantize_dequantize",
    "qdq_ste",
    "staircase_qdq",
    "staircase_qdq_ste",
    "uniform_qdq",
    "uniform_qdq_ste",
    "power_qdq",
    "power_qdq_ste",
    "phase_schedule",
    "stack_quantizer_params",
    "stack_quantizer_thresholds",
]


# sign-preserving dead-zone floor; representable in bf16 (~9.9e-31) but
# not in fp16, so message storage is bf16 or f32 only
QDQ_SIGN_TINY = 1e-30


def power_thresholds_for_levels(levels: int, C: float,
                                gamma: float) -> np.ndarray:
    """tau_j = C * (j / (levels-1))^gamma, j = 0..levels-1 — the ladder
    parameterized by its level count (= 2^(bc-1)) directly."""
    max_idx = levels - 1
    j = np.arange(levels, dtype=np.float64)
    return (C * (j / max_idx) ** gamma).astype(np.float32)


def power_thresholds(bc: int, C: float, gamma: float) -> np.ndarray:
    """tau_j = C * (j / (2^(bc-1)-1))^gamma, j = 0..2^(bc-1)-1
    (reference ``rcq_decoder.py:48-57``)."""
    return power_thresholds_for_levels(2 ** (bc - 1), C, gamma)


def _f32(v, like: torch.Tensor):
    """A quantizer parameter with JAX's typing: tensors and numpy scalars
    become float32 tensors on ``like``'s device (their scalar arithmetic
    then runs in float32), Python numbers stay Python floats (weakly
    typed: their scalar arithmetic runs in float64 and the result is
    rounded to float32 where it meets a tensor)."""
    if isinstance(v, (torch.Tensor, np.ndarray, np.floating)):
        return torch.as_tensor(v, dtype=torch.float32, device=like.device)
    return float(v)


def _div(a, b):
    """``a / b`` as an IEEE division. Python numbers divide in Python; with
    a tensor on either side both become float32 tensors and go through
    ``torch.div`` (``number / tensor`` would multiply by a reciprocal, and
    CUDA divides by a host scalar the same way). A number meeting a tensor
    is filled on the tensor's device, not copied from the host."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        dev = (a if isinstance(a, torch.Tensor) else b).device

        def f32(v):
            if isinstance(v, torch.Tensor):
                return v.to(dtype=torch.float32, device=dev)
            return torch.full((), float(v), dtype=torch.float32, device=dev)

        return torch.div(f32(a), f32(b))
    return a / b


def _pow(a: torch.Tensor, e) -> torch.Tensor:
    """``a ** e`` as JAX evaluates it: an integral Python exponent is an
    integer power (``lax.integer_pow``), any other exponent is rounded to
    float32 first (torch would keep a Python exponent in float64)."""
    if isinstance(e, float) and e.is_integer():
        return torch.pow(a, int(e))
    return torch.pow(a, torch.as_tensor(e, dtype=torch.float32,
                                        device=a.device))


def _lut(thresholds, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(thresholds, dtype=torch.float32, device=like.device)


def _threshold_index(mag: torch.Tensor, thresholds: torch.Tensor
                     ) -> torch.Tensor:
    """Largest ``j`` with ``tau_j <= mag`` (the reference's inclusive
    ``>=`` scan), int64: a binary search for a rank-1 LUT, a compare-count
    for per-element LUT rows ``[..., L]``."""
    if thresholds.ndim == 1:
        idx = torch.searchsorted(thresholds, mag.contiguous(), right=True) - 1
    else:
        idx = (mag[..., None] >= thresholds).sum(dim=-1) - 1
    return torch.clamp_min(idx, 0)


def _snap(thresholds: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if thresholds.ndim == 1:
        return thresholds[idx]
    return torch.take_along_dim(thresholds, idx[..., None], dim=-1)[..., 0]


def quantize(x: torch.Tensor, thresholds) -> torch.Tensor:
    """Sign-magnitude quantize against a threshold LUT ``[..., L]``
    (L = 2^(bc-1)): int32 codes ``(x < 0) * L + idx`` in [0, 2^bc)
    (reference ``rcq_decoder.py:59-91``)."""
    thr = _lut(thresholds, x)
    idx = _threshold_index(x.abs(), thr).to(torch.int32)
    return (x < 0).to(torch.int32) * thr.shape[-1] + idx


def dequantize(code: torch.Tensor, thresholds) -> torch.Tensor:
    """Invert :func:`quantize`: the threshold value with its sign
    (reference ``rcq_decoder.py:93-121``), float32."""
    thr = _lut(thresholds, code)
    levels = thr.shape[-1]
    sign_bit = (code >= levels).to(torch.float32)
    return (1.0 - 2.0 * sign_bit) * _snap(thr, (code % levels).long())


def quantize_dequantize(x: torch.Tensor, thresholds) -> torch.Tensor:
    """``dequantize(quantize(x))`` without the integer codes, with the
    reconstructed magnitude floored at ``QDQ_SIGN_TINY`` (so a negative
    dead-zone value stays negative)."""
    thr = _lut(thresholds, x)
    snapped = torch.clamp_min(_snap(thr, _threshold_index(x.abs(), thr)),
                              QDQ_SIGN_TINY)
    return torch.where(x < 0, -1.0, 1.0) * snapped


def _clip(x: torch.Tensor, C) -> torch.Tensor:
    """``jnp.clip(x, -C, C)``: its derivative is 1/2 at x = +-C."""
    C = torch.as_tensor(C, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, -C), C)


def _ste(x: torch.Tensor, C, qdq) -> torch.Tensor:
    """``clipped + stop_gradient(qdq(x) - clipped)`` in float32, as JAX
    writes it: the forward is that sum (see the module docstring), the
    derivative that of the clip."""
    clipped = _clip(x.to(torch.float32), C)
    return clipped + (qdq(x.detach()) - clipped.detach())


def qdq_ste(x: torch.Tensor, thresholds) -> torch.Tensor:
    """Straight-through :func:`quantize_dequantize`: backward is the
    identity clipped to the LUT's range [-C, C], C its last threshold."""
    thr = _lut(thresholds, x)
    return _ste(x, thr[..., -1], lambda v: quantize_dequantize(v, thr))


def staircase_qdq(x: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """Exact quantize-dequantize for small LUTs as a staircase sum:
    ``sign(x) * sum_j (|x| >= tau_j) * (tau_j - tau_{j-1})``.

    ``thresholds`` is a rank-1 [L] float32 tensor. Runs in float32."""
    x = x.to(torch.float32)
    thr = torch.as_tensor(thresholds, dtype=torch.float32, device=x.device)
    mag = x.abs()
    snapped = torch.zeros_like(mag)
    for j in range(1, thr.shape[-1]):
        step = thr[j] - thr[j - 1]
        snapped = snapped + torch.where(mag >= thr[j], step,
                                        torch.zeros_like(step))
    snapped = torch.clamp_min(snapped, QDQ_SIGN_TINY)
    return torch.where(x < 0, -snapped, snapped)


def uniform_qdq(x: torch.Tensor, C, levels: int) -> torch.Tensor:
    """Closed-form quantize-dequantize for uniform thresholds
    ``tau_j = C*j/M`` (the gamma == 1 case), with the boundary-correction
    selects of ``ldpc_tpu/quantizer.py::uniform_qdq``."""
    x = x.to(torch.float32)
    C = _f32(C, x)
    M = levels - 1
    scale = _div(M, C)   # hoisted scalars, as in the JAX version
    step = _div(C, M)
    mag = x.abs()
    idx = torch.clamp(torch.floor(mag * scale), 0.0, float(M))
    up = torch.clamp_max(idx + 1.0, float(M)) * step
    idx = torch.where((mag >= up) & (idx < M), idx + 1.0, idx)
    down = idx * step
    idx = torch.where(mag < down, torch.clamp_min(idx - 1.0, 0.0), idx)
    snapped = torch.clamp_min(idx * step, QDQ_SIGN_TINY)
    return torch.where(x < 0, -snapped, snapped)


def power_qdq(x: torch.Tensor, C, gamma, levels: int) -> torch.Tensor:
    """Closed-form quantize-dequantize for power-law thresholds
    ``tau_j = C*(j/M)^gamma``: invert the power law, then two
    boundary-correction selects make the index exact under float rounding
    (``ldpc_tpu/quantizer.py::power_qdq``)."""
    x = x.to(torch.float32)
    C = _f32(C, x)
    gamma = _f32(gamma, x)
    M = levels - 1
    mag = x.abs()
    r = torch.clamp(_div(mag, C), 0.0, 1.0)
    idx = torch.floor(M * _pow(r, _div(1.0, gamma)))
    idx = torch.clamp(idx, 0.0, float(M))
    up = C * _pow(_div(torch.clamp_max(idx + 1.0, float(M)), M), gamma)
    idx = torch.where((mag >= up) & (idx < M), idx + 1.0, idx)
    down = C * _pow(_div(idx, M), gamma)
    idx = torch.where(mag < down, torch.clamp_min(idx - 1.0, 0.0), idx)
    snapped = torch.clamp_min(C * _pow(_div(idx, M), gamma), QDQ_SIGN_TINY)
    return torch.where(x < 0, -snapped, snapped)


def staircase_qdq_ste(x: torch.Tensor, thresholds) -> torch.Tensor:
    """Straight-through :func:`staircase_qdq` (see :func:`qdq_ste`)."""
    thr = _lut(thresholds, x)
    return _ste(x, thr[..., -1], lambda v: staircase_qdq(v, thr))


def uniform_qdq_ste(x: torch.Tensor, C, levels: int) -> torch.Tensor:
    """Straight-through :func:`uniform_qdq`: backward is the identity
    clipped to [-C, C]."""
    return _ste(x, C, lambda v: uniform_qdq(v, C, levels))


def power_qdq_ste(x: torch.Tensor, C, gamma, levels: int) -> torch.Tensor:
    """Straight-through :func:`power_qdq`: backward is the identity
    clipped to [-C, C]."""
    return _ste(x, C, lambda v: power_qdq(v, C, gamma, levels))


@dataclasses.dataclass(frozen=True)
class NonUniformQuantizer:
    """(bc, C, gamma) with its LUT, the reference class surface: ``.bc``,
    ``.C``, ``.gamma``, ``.thresholds``, ``.quantize(x)``,
    ``.dequantize(code)`` and ``__call__`` (quantize-dequantize)."""

    bc: int
    C: float
    gamma: float

    @property
    def thresholds(self) -> np.ndarray:
        return power_thresholds(self.bc, self.C, self.gamma)

    def quantize(self, x) -> torch.Tensor:
        return quantize(torch.as_tensor(x), self.thresholds)

    def dequantize(self, code) -> torch.Tensor:
        return dequantize(torch.as_tensor(code), self.thresholds)

    def __call__(self, x) -> torch.Tensor:
        return quantize_dequantize(torch.as_tensor(x), self.thresholds)


def phase_schedule(max_iterations: int, num_quantizers: int) -> np.ndarray:
    """Per-iteration quantizer index: the reference's thirds rule for up to
    3 quantizers (``rcq_decoder.py:156-167``), an even spread beyond."""
    T = max_iterations
    sched = np.zeros(T, dtype=np.int32)
    if num_quantizers <= 1:
        return sched
    if num_quantizers > 3:
        for t in range(T):
            sched[t] = min(t * num_quantizers // T, num_quantizers - 1)
        return sched
    for t in range(T):
        if t < T // 3:
            sched[t] = 0
        elif t < 2 * T // 3:
            sched[t] = min(1, num_quantizers - 1)
        else:
            sched[t] = num_quantizers - 1
    return sched


def stack_quantizer_params(
    quantizer_params: Sequence[Tuple[float, float]], max_iterations: int
) -> np.ndarray:
    """[T, 2] per-iteration (C, gamma) following the phase schedule."""
    params = np.asarray(quantizer_params, dtype=np.float32)  # [Q, 2]
    sched = phase_schedule(max_iterations, len(quantizer_params))
    return params[sched]


def stack_quantizer_thresholds(
    bc: int, quantizer_params: Sequence[Tuple[float, float]], max_iterations: int
) -> np.ndarray:
    """[T, L] per-iteration threshold LUT from (C, gamma) pairs plus the
    phase schedule."""
    luts = np.stack([power_thresholds(bc, C, g) for C, g in quantizer_params])
    sched = phase_schedule(max_iterations, len(quantizer_params))
    return luts[sched]
