"""Decoder spec, result type and quantizer routing shared by the engines.

Counterpart of ``ldpc_tpu/decode/engine.py``: :class:`VariantSpec` (numpy
fields, the same validation), :class:`DecodeResult` (a NamedTuple of
tensors), the static quantize-dequantize routing of ``_make_qdq`` and the
numpy ``make_layers``. The general and layered torch engines (``decode_batch``,
``decode_batch_layered``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ldpc_tpu_torch.codes import DecoderGraph
from ldpc_tpu_torch.quantizer import power_qdq, staircase_qdq, uniform_qdq

__all__ = ["VariantSpec", "DecodeResult", "qdq_mode", "make_qdq",
           "make_layers"]


@dataclasses.dataclass(frozen=True, eq=False)
class VariantSpec:
    """Static wiring of a decoder variant.

    ``kind``:
      - ``'nms'``  — c2v = beta * sign * mag
      - ``'oms'``  — c2v = sign * (relu(mag - beta) - alpha_cn)
      - ``'rcq'``  — c2v = qdq(sign * mag)
      - ``'wrcq'`` — c2v = qdq(beta * sign * mag)
      - ``'orcq'`` — c2v = qdq(sign * (relu(mag - beta) - alpha_cn))

    ``beta_idx`` / ``alpha_idx``: per-edge (or, for QC decoders, per-block)
    int32 bucket indices into ``weights['beta'][T, n_beta]`` /
    ``weights['alpha'][T, n_alpha]``, or None for a fixed scalar
    (``fixed_beta`` / ``fixed_alpha``). ``alpha_in_cn``: alpha subtracts
    inside the CN transform (OMS kinds) instead of scaling the VN sum.

    ``thresholds`` / ``v2c_thresholds``: [T, L] per-iteration LUTs;
    ``qparams`` / ``v2c_qparams``: [T, 2] per-iteration (C, gamma) for the
    closed forms; ``closed_qdq`` forces the closed form for small LUTs too.
    """

    kind: str
    beta_idx: Optional[np.ndarray] = None
    alpha_idx: Optional[np.ndarray] = None
    fixed_beta: float = 0.7
    fixed_alpha: float = 1.0
    n_beta: int = 0
    n_alpha: int = 0
    alpha_in_cn: bool = False
    thresholds: Optional[np.ndarray] = None
    v2c_thresholds: Optional[np.ndarray] = None
    qparams: Optional[np.ndarray] = None
    q_levels: int = 0
    v2c_qparams: Optional[np.ndarray] = None
    v2c_levels: int = 0
    closed_qdq: bool = False

    def __post_init__(self):
        if self.kind not in ("nms", "oms", "rcq", "wrcq", "orcq"):
            raise ValueError(f"unknown variant kind {self.kind!r}")


class DecodeResult(NamedTuple):
    bits: torch.Tensor        # [B, n] int32 (int8 on the lean fused path)
    posterior: Optional[torch.Tensor]  # [B, n] float, None when lean
    iterations: torch.Tensor  # [B] int32, first-converged iter + 1 or T
    success: torch.Tensor     # [B] bool, syndrome == 0
    posteriors_all: Optional[torch.Tensor] = None  # [T, B, n] if requested


def qdq_mode(qparams, levels: int, closed: bool = False) -> str:
    """The static routing of ``ldpc_tpu.decode.engine._make_qdq``:
    'uniform' (closed form, every gamma == 1), 'power' (closed form) or
    'staircase' (exact LUT). The closed form applies when (C, gamma)
    parameters exist and the LUT is large (levels > 16) or ``closed``."""
    if qparams is not None and (closed or levels > 16):
        if np.all(np.asarray(qparams)[:, 1] == 1.0):
            return "uniform"
        return "power"
    return "staircase"


def make_qdq(spec: VariantSpec, x: dict, v2c: bool, closed: bool = False):
    """This iteration's quantize-dequantize callable, or None.

    ``x`` holds the iteration's rows of the tables: ``thr``/``vthr`` ([L]
    float32 tensors) and ``qp``/``vqp`` ([2] float32 tensors, (C, gamma)).
    ``closed`` adds to ``spec.closed_qdq`` (the fused kernels' option)."""
    if v2c:
        if spec.v2c_qparams is None and spec.v2c_thresholds is None:
            return None
        qparams, levels, thr, qp = (spec.v2c_qparams, spec.v2c_levels,
                                    x["vthr"], x["vqp"])
    else:
        if spec.kind not in ("rcq", "wrcq", "orcq"):
            return None
        qparams, levels, thr, qp = (spec.qparams, spec.q_levels,
                                    x["thr"], x["qp"])
    mode = qdq_mode(qparams, levels, closed or spec.closed_qdq)
    if mode == "uniform":
        return lambda v: uniform_qdq(v, qp[0], levels)
    if mode == "power":
        return lambda v: power_qdq(v, qp[0], qp[1], levels)
    return lambda v: staircase_qdq(v, thr)


def make_layers(graph: DecoderGraph, num_layers: Optional[int] = None):
    """Partition checks into layers for the general layered schedule
    (numpy copy of ``ldpc_tpu.decode.engine.make_layers``): each check goes
    to the first layer where it shares no variable with a placed check;
    past ``num_layers`` collisions go to the smallest layer. Returns
    ``layer_checks [L, m_per_layer]`` padded with ``m``."""
    m = graph.m
    var_sets = [set(graph.cn_var_slots[i][graph.cn_mask[i]].tolist())
                for i in range(m)]
    layers: list[list[int]] = []
    layer_vars: list[set] = []
    for i in range(m):
        placed = False
        for li, lv in enumerate(layer_vars):
            if not (lv & var_sets[i]):
                layers[li].append(i)
                lv.update(var_sets[i])
                placed = True
                break
        if not placed:
            if num_layers is not None and len(layers) >= num_layers:
                li = min(range(len(layers)), key=lambda x: len(layers[x]))
                layers[li].append(i)
                layer_vars[li].update(var_sets[i])
            else:
                layers.append([i])
                layer_vars.append(set(var_sets[i]))
    width = max(len(l) for l in layers)
    out = np.full((len(layers), width), m, dtype=np.int32)
    for li, l in enumerate(layers):
        out[li, : len(l)] = l
    return out
