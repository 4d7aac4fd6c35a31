"""Decoder spec, result type and quantizer routing shared by the engines.

Counterpart of ``ldpc_tpu/decode/engine.py``: :class:`VariantSpec` (numpy
fields, the same validation), :class:`DecodeResult` (a NamedTuple of
tensors), the static quantize-dequantize routing of ``_make_qdq`` and the
numpy ``make_layers``. Also the pieces every QC decode shares: the
per-iteration tables (``_scan_xs`` with the per-block beta/alpha of
``qc_engine._per_block_weights``, built on the device once per spec), the
check-node min tree and variant transform, and the syndrome. The general
and layered torch engines (``decode_batch``, ``decode_batch_layered``) are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from ldpc_tpu_torch.codes import DecoderGraph
from ldpc_tpu_torch.quantizer import power_qdq, staircase_qdq, uniform_qdq

__all__ = ["VariantSpec", "DecodeResult", "qdq_mode", "make_qdq",
           "make_layers"]

# device copies of a spec's tables, per (T, device); an entry goes when its
# spec does
_SPEC_TABLES: "weakref.WeakKeyDictionary[VariantSpec, dict]" = \
    weakref.WeakKeyDictionary()


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


def _spec_tables(spec: VariantSpec, T: int, NB: int, device) -> dict:
    per = _SPEC_TABLES.setdefault(spec, {})
    key = (T, torch.device(device))
    if key not in per:
        def tab(a, w):
            if a is None:
                return torch.zeros((T, w), dtype=torch.float32, device=device)
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        def idx(a):
            return (None if a is None else
                    torch.as_tensor(np.asarray(a, np.int64), device=device))

        per[key] = dict(
            thr=tab(spec.thresholds, 1), qp=tab(spec.qparams, 2),
            vthr=tab(spec.v2c_thresholds, 1), vqp=tab(spec.v2c_qparams, 2),
            beta_idx=idx(spec.beta_idx), alpha_idx=idx(spec.alpha_idx),
            beta_fixed=torch.full((T, NB), spec.fixed_beta,
                                  dtype=torch.float32, device=device),
            alpha_fixed=torch.full((T, NB), spec.fixed_alpha,
                                   dtype=torch.float32, device=device))
    return per[key]


def _tables(weights, spec: VariantSpec, T: int, NB: int, device) -> dict:
    """Per-(iteration, block) float32 weight tables ``beta``/``alpha``
    [T, NB] and the quantizer tables ``thr``/``vthr`` [T, L] and
    ``qp``/``vqp`` [T, 2], on ``device``: ``ldpc_tpu``'s ``_scan_xs`` with
    ``_per_block_weights`` applied (a fixed weight fills its table).
    Weights on another device are moved there."""
    c = _spec_tables(spec, T, NB, device)

    def wtab(key):
        idx = c[f"{key}_idx"]
        if idx is None:
            return c[f"{key}_fixed"]
        w = torch.as_tensor(weights[key], dtype=torch.float32, device=device)
        return w[:, idx].contiguous()

    return dict(beta=wtab("beta"), alpha=wtab("alpha"),
                **{k: c[k] for k in ("thr", "qp", "vthr", "vqp")})


def _qdq_at(spec, tabs, t, v2c, closed):
    x = {k: tabs[k][t] for k in ("thr", "qp", "vthr", "vqp")}
    return make_qdq(spec, x, v2c=v2c, closed=closed)


def _min_tree(xs):
    """Running (min1, min2, first argmin, negative count) over the f32
    messages ``xs`` of one row, with strict ``<`` as the kernels."""
    inf = float("inf")
    for k, xk in enumerate(xs):
        negk = (xk < 0).to(torch.int32)
        mk = xk.abs()
        if k == 0:
            min1, min2 = mk, torch.full_like(mk, inf)
            argm = torch.zeros(mk.shape, dtype=torch.int32, device=mk.device)
            neg_cnt = negk
        else:
            new_min = mk < min1
            min2 = torch.where(new_min, min1, torch.minimum(min2, mk))
            min1 = torch.where(new_min, mk, min1)
            argm = torch.where(new_min, k, argm)
            neg_cnt = neg_cnt + negk
    if len(xs) == 1:
        min2 = min1  # degree-1 checks
    return min1, min2, argm, neg_cnt


def _leave_one_out(min1, min2, argm, neg_cnt, k, xk):
    """The leave-one-out (sign, magnitude) of message ``k`` of a row."""
    loo_mag = torch.where(argm == k, min2, min1)
    loo_neg = (neg_cnt - (xk < 0).to(torch.int32)) & 1
    return 1.0 - 2.0 * loo_neg.to(torch.float32), loo_mag


def _transform(spec, qdq, bb, ab, loo_sign, loo_mag):
    """The variant's c2v from the leave-one-out sign and magnitude."""
    if spec.kind == "nms":
        return bb * loo_sign * loo_mag
    if spec.kind == "rcq":
        return qdq(loo_sign * loo_mag)
    if spec.kind == "wrcq":
        return qdq(bb * loo_sign * loo_mag)
    off = torch.clamp_min(loo_mag - bb, 0.0)  # oms, orcq
    if spec.alpha_in_cn:
        off = off - ab
    out = loo_sign * off
    return qdq(out) if spec.kind == "orcq" else out


def _syndrome_ok(post, qc, lift_dim: int = -1):
    """Per-frame success from the stored posterior ``post`` [nb, ...]: per
    base row, the parity of the check-aligned negative signs. Each column
    tile ``post[j]`` holds the lift along ``lift_dim`` (-1 for [nb, B, L],
    0 for [nb, L, B])."""
    neg = post < 0
    fail = torch.zeros(post.shape[1:], dtype=torch.bool, device=post.device)
    for blocks in qc.row_blocks:
        par = torch.zeros_like(fail)
        for b in blocks:
            par ^= torch.roll(neg[int(qc.block_col[b])],
                              -int(qc.block_shift[b]), dims=lift_dim)
        fail |= par
    return ~fail.any(dim=lift_dim)
