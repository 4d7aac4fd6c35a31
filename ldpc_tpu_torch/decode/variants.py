"""Decoder variant registry: wiring, weight initialization, parameter counts
and call routing (counterpart of ``ldpc_tpu/decode/variants.py``).

Weight-sharing types (paper Table I):

====  =======================================  =========================
type  beta (CN weight) keyed by                alpha (VN weight) keyed by
====  =======================================  =========================
0     every edge (N-NMS / N-OMS)               — (1.0 / 0.0)
1     (deg(c), deg(v)) pair, full cartesian    — fixed
2     deg(c)                                   deg(v)
3     deg(c)                                   — fixed
4     — fixed (0.7 NMS / 0.0 OMS)              deg(v)
====  =======================================  =========================

The spec arrays ``make_decoder`` builds equal the JAX package's for the
same arguments. Initial weights come from a ``torch.Generator`` seeded
with ``seed`` on the decoder's device, with the same means and standard
deviation as the ``jax.random`` draws there, but the values differ; use
``ldpc_tpu_torch.interop.weights_from_numpy`` to run the two packages on
identical weights.

A decoder lives on a device, the card (``"cuda"``) unless the caller asks
for ``"cpu"``: its weights are kept there, and on a machine without a
card ``make_decoder`` raises rather than fall back to the CPU.

Every inference route is ported:

- a QC decoder with ``qc_options={"fused": True, ...}`` runs the fused
  layered or flooding decode (``decode/fused.py``); without ``fused`` the
  torch QC engine (``decode/qc_engine.py``), flooding with the
  ``check_every``, ``dtype`` and ``unroll`` options, layered in f32;
- a non-QC decoder runs the general engines (``decode/engine.py``):
  ``decode_batch`` (flooding) or, when ``layered``, ``decode_batch_layered``
  over its ``layer_checks``, both in f32 with the syndrome checked every
  iteration (they take no options);
- ``make_decoder(bucketed=True)`` runs the degree-bucketed flooding engine
  (``decode/bucketed_engine.py``) with ``dtype`` and ``check_every`` from
  ``qc_options``.

Each runs on the device of the LLRs it is given. A training call
(``ste`` or ``return_trajectory``) takes the route ``ldpc_tpu`` takes: a
fused decoder falls back to its engine (the kernels are inference-only),
the QC flooding engine runs in float32 with the syndrome checked every
iteration (it drops every option but ``unroll``), the QC layered engine
in float32, and the bucketed engine in float32 with its ``check_every``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ldpc_tpu_torch.codes import DecoderGraph, LDPCCode, build_graph
from ldpc_tpu_torch.decode.bucketed_engine import (BucketedGraph,
                                                   bucketed_decode_batch,
                                                   build_bucketed_graph)
from ldpc_tpu_torch.decode.engine import (DecodeResult, VariantSpec,
                                          decode_batch, decode_batch_layered,
                                          make_layers)
from ldpc_tpu_torch.decode.qc_engine import (QCGraph, qc_decode_batch,
                                             qc_decode_batch_layered)
from ldpc_tpu_torch.quantizer import (
    stack_quantizer_params,
    stack_quantizer_thresholds,
)

__all__ = [
    "Decoder",
    "make_decoder",
    "basic_min_sum",
    "neural_min_sum",
    "neural_offset_min_sum",
    "neural_2d_min_sum",
    "neural_2d_offset_min_sum",
    "rcq_min_sum",
    "weighted_rcq",
    "weighted_oms_rcq",
    "param_count",
]


def _not_ported(route: str, item: str):
    return NotImplementedError(
        f"{route} is not ported to ldpc_tpu_torch yet (ROADMAP.md Queue 1: "
        f"{item}); use ldpc_tpu for it")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist (the port
    never falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs a CUDA card and none is visible; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return device


def _bucket_wiring(graph: DecoderGraph, sharing_type: int, offset_style: bool):
    """Return (beta_idx, n_beta, alpha_idx, n_alpha, fixed_beta, fixed_alpha,
    alpha_in_cn) for a sharing type."""
    n_dc = len(graph.unique_dc)
    n_dv = len(graph.unique_dv)
    fixed_beta = 0.0 if offset_style else 0.7
    fixed_alpha = 0.0 if offset_style else 1.0
    if sharing_type == 0:
        E = graph.num_edges
        return (np.arange(E, dtype=np.int32), E, None, 0,
                fixed_beta, fixed_alpha, offset_style)
    if sharing_type == 1:
        return (graph.edge_dcdv_bucket, n_dc * n_dv, None, 0,
                fixed_beta, fixed_alpha, offset_style)
    if sharing_type == 2:
        return (graph.edge_dc_bucket, n_dc, graph.edge_dv_bucket, n_dv,
                fixed_beta, fixed_alpha, offset_style)
    if sharing_type == 3:
        return (graph.edge_dc_bucket, n_dc, None, 0,
                fixed_beta, fixed_alpha, offset_style)
    if sharing_type == 4:
        return (None, 0, graph.edge_dv_bucket, n_dv,
                fixed_beta, fixed_alpha, offset_style)
    raise ValueError(f"Invalid weight sharing type: {sharing_type}")


def _qc_bucket_wiring(qc: QCGraph, sharing_type: int, offset_style: bool):
    """Per-BLOCK analogue of :func:`_bucket_wiring` (a lifted node's degree
    equals its protograph node's, so the bucket universes are the same)."""
    n_dc = len(qc.unique_dc)
    n_dv = len(qc.unique_dv)
    fixed_beta = 0.0 if offset_style else 0.7
    fixed_alpha = 0.0 if offset_style else 1.0
    if sharing_type == 0:
        raise ValueError(
            "per-edge (type 0) weights are not block-constant; use the "
            "general engine for N-NMS/N-OMS on QC codes")
    if sharing_type == 1:
        return (qc.block_dcdv_bucket, n_dc * n_dv, None, 0,
                fixed_beta, fixed_alpha, offset_style)
    if sharing_type == 2:
        return (qc.block_dc_bucket, n_dc, qc.block_dv_bucket, n_dv,
                fixed_beta, fixed_alpha, offset_style)
    if sharing_type == 3:
        return (qc.block_dc_bucket, n_dc, None, 0,
                fixed_beta, fixed_alpha, offset_style)
    if sharing_type == 4:
        return (None, 0, qc.block_dv_bucket, n_dv,
                fixed_beta, fixed_alpha, offset_style)
    raise ValueError(f"Invalid weight sharing type: {sharing_type}")


@dataclasses.dataclass(eq=False)
class Decoder:
    """A configured decoder: static spec + weights + call surface.

    ``weights`` is ``{"beta": [T, n_beta] | None, "alpha": [T, n_alpha] |
    None}`` of float32 tensors on ``device``. ``qc_options`` carries the
    QC paths' options: ``fused`` picks the fused kernels (``dtype``,
    ``lean``, ``closed_qdq``, ``check_every``; the TPU-only
    ``batch_tile``/``natural``/``interpret`` are accepted and ignored),
    else the flooding engine takes ``check_every``, ``dtype`` and
    ``unroll`` and drops the fused-only keys. A decoder with a
    ``bucketed_graph`` takes ``dtype`` and ``check_every`` from them; the
    general engines read none.
    """

    name: str
    code: LDPCCode
    graph: DecoderGraph
    spec: VariantSpec
    max_iterations: int
    weights: Dict[str, Optional[torch.Tensor]]
    layered: bool = False
    layer_checks: Optional[np.ndarray] = None
    qc: Optional[QCGraph] = None
    qc_options: Optional[dict] = None
    # degree-bucketed layouts for the non-QC flooding fast path
    bucketed_graph: Optional[BucketedGraph] = None
    recipe: Optional[dict] = None
    device: torch.device = torch.device("cuda")

    def __call__(self, llr: torch.Tensor, weights=None, *, ste: bool = False,
                 return_trajectory: bool = False) -> DecodeResult:
        """Decode ``llr`` of shape [B, n] (or [n] — auto-promoted)."""
        w = self.weights if weights is None else weights
        squeeze = llr.ndim == 1
        if squeeze:
            llr = llr[None, :]
        opts = dict(self.qc_options or {})
        fused = opts.pop("fused", False)
        train = dict(ste=ste, return_trajectory=return_trajectory)
        if ste or return_trajectory:
            # the training route: per-iteration semantics in float32 on
            # the engines (ldpc_tpu/decode/variants.py:170-240)
            fused = False
            opts = {k: v for k, v in opts.items() if k == "unroll" or (
                k == "check_every" and self.bucketed_graph is not None)}
        if self.layered and self.qc is not None:
            if fused:
                from ldpc_tpu_torch.decode.fused import \
                    qc_fused_decode_batch_layered
                opts.pop("check_every", None)
                opts.pop("unroll", None)
                out = qc_fused_decode_batch_layered(
                    llr, w, qc=self.qc, spec=self.spec,
                    max_iterations=self.max_iterations, **opts)
            else:  # the engine takes no options: f32 messages
                out = qc_decode_batch_layered(
                    llr, w, qc=self.qc, spec=self.spec,
                    max_iterations=self.max_iterations, **train)
        elif self.layered:
            out = decode_batch_layered(
                llr, w, self.layer_checks, graph=self.graph, spec=self.spec,
                max_iterations=self.max_iterations, **train)
        elif self.qc is not None and fused:
            from ldpc_tpu_torch.decode.fused import qc_fused_decode_batch
            # the kernel checks the syndrome once, at T
            ce = opts.pop("check_every", self.max_iterations)
            if ce != self.max_iterations:
                raise ValueError(
                    f"fused kernel checks the syndrome once at T="
                    f"{self.max_iterations}; qc_options check_every={ce} is "
                    "incompatible")
            opts.pop("unroll", None)
            out = qc_fused_decode_batch(
                llr, w, qc=self.qc, spec=self.spec,
                max_iterations=self.max_iterations, **opts)
        elif self.qc is not None:
            for key in ("lean", "natural", "closed_qdq"):  # fused-only
                opts.pop(key, None)
            out = qc_decode_batch(
                llr, w, qc=self.qc, spec=self.spec,
                max_iterations=self.max_iterations, **train, **opts)
        elif self.bucketed_graph is not None:
            out = bucketed_decode_batch(
                llr, w, bg=self.bucketed_graph, spec=self.spec,
                max_iterations=self.max_iterations, **train,
                **{k: opts[k] for k in ("dtype", "check_every")
                   if k in opts})
        else:
            out = decode_batch(llr, w, graph=self.graph, spec=self.spec,
                               max_iterations=self.max_iterations, **train)
        if squeeze:
            out = DecodeResult(
                bits=out.bits[0],
                posterior=(out.posterior[0]
                           if out.posterior is not None else None),
                iterations=out.iterations[0], success=out.success[0],
                posteriors_all=(out.posteriors_all[:, 0]
                                if out.posteriors_all is not None
                                else None))
        return out

    def decode(self, llr: torch.Tensor):
        """Plain-decoder calling convention: (bits, success, iterations)."""
        r = self(llr)
        return r.bits, r.success, r.iterations

    def param_count(self) -> int:
        return param_count(self.weights)

    def truncated(self, T1: int) -> "Decoder":
        """A decoder identical to this one for the FIRST ``T1`` iterations
        (weights, quantizer schedule, thresholds all sliced)."""
        if T1 > self.max_iterations:
            raise ValueError(f"T1={T1} > max_iterations={self.max_iterations}")

        def cut(a):
            return None if a is None else a[:T1]

        spec = dataclasses.replace(
            self.spec,
            thresholds=cut(self.spec.thresholds),
            v2c_thresholds=cut(self.spec.v2c_thresholds),
            qparams=cut(self.spec.qparams),
            v2c_qparams=cut(self.spec.v2c_qparams),
        )
        weights = {k: cut(w) for k, w in self.weights.items()}
        opts = dict(self.qc_options or {})
        if opts.get("fused") and T1 != self.max_iterations:
            # the fused kernel's only syndrome check is at T, so any T1 < T
            # checks at an iteration the parent never does
            raise ValueError(
                "cannot truncate a fused-kernel decoder (its check schedule "
                "is {T}); build the truncated stage on the engine")
        ce = opts.get("check_every")
        if ce and T1 % ce:
            raise ValueError(
                f"T1={T1} is not a multiple of this decoder's "
                f"check_every={ce}; the truncated decoder would check/freeze "
                "on a different schedule than the full decoder")
        return dataclasses.replace(self, spec=spec, weights=weights,
                                   max_iterations=T1,
                                   qc_options=(opts or None))

    def replace_weights(self, weights) -> "Decoder":
        """This decoder with ``weights``, moved to its device."""
        return dataclasses.replace(self, weights={
            k: (None if w is None else
                torch.as_tensor(w, dtype=torch.float32, device=self.device))
            for k, w in weights.items()})


def param_count(weights) -> int:
    return int(sum(w.numel() for w in weights.values() if w is not None))


def _init_weights(gen: torch.Generator, T: int, n_beta: int, n_alpha: int,
                  *, beta_mean: float, alpha_mean: float,
                  std: float = 0.1) -> Dict[str, Optional[torch.Tensor]]:
    w: Dict[str, Optional[torch.Tensor]] = {"beta": None, "alpha": None}
    draw = lambda n: torch.randn((T, n), generator=gen, device=gen.device)
    if n_beta:
        w["beta"] = beta_mean + std * draw(n_beta)
    if n_alpha:
        w["alpha"] = alpha_mean + std * draw(n_alpha)
    return w


def make_decoder(
    code: LDPCCode,
    *,
    kind: str = "nms",
    sharing_type: Optional[int] = None,
    factor: float = 0.7,
    max_iterations: Optional[int] = None,
    bc: int = 3,
    bv: Optional[int] = None,
    quantizer_params: Sequence[Tuple[float, float]] = ((5.0, 1.3),),
    v2c_quantizer_params: Optional[Sequence[Tuple[float, float]]] = None,
    layered: bool = False,
    num_layers: Optional[int] = None,
    init: str = "reference",
    seed: int = 0,
    name: Optional[str] = None,
    graph: Optional[DecoderGraph] = None,
    qc: Optional[QCGraph] = None,
    qc_options: Optional[dict] = None,
    bucketed: bool = False,
    per_layer: bool = False,
    closed_qdq: bool = False,
    device="cuda",
) -> Decoder:
    """Build any decoder variant (arguments as ``ldpc_tpu.make_decoder``).

    kind: 'ms' (fixed factor) | 'nms' | 'oms' | 'rcq' | 'wrcq' | 'orcq'.
    sharing_type: None/0 = per-edge; 1-4 = degree sharing. ``qc`` switches
    to the QC structure (base rows are the layers when ``layered``).
    ``device``: where the decoder's weights live and its initial weights
    are drawn (the card unless ``"cpu"``; raises if there is no card).
    Initial weights: see the module docstring. ``bucketed=True`` builds
    the degree-bucketed layouts (non-QC flooding only).
    """
    device = resolve_device(device)
    if bucketed and (qc is not None or layered):
        raise ValueError("bucketed engine is flooding-only and non-QC; "
                         "drop bucketed=, or drop qc=/layered=")
    if kind not in ("ms", "nms", "oms", "rcq", "wrcq", "orcq"):
        raise ValueError(
            f"unknown decoder kind {kind!r}; expected one of "
            "'ms', 'nms', 'oms', 'rcq', 'wrcq', 'orcq'")
    if qc is not None and kind in ("nms", "oms", "wrcq", "orcq") and \
            (sharing_type is None or sharing_type == 0):
        raise ValueError("per-edge (type 0) weights need the general "
                         "engine; omit qc= or use sharing types 1-4")
    if per_layer and (qc is None or not layered):
        raise ValueError("per_layer weights need a QC layered decoder "
                         "(layers are base rows); pass qc= and "
                         "layered=True")
    if per_layer and kind in ("ms", "rcq"):
        raise ValueError("per_layer needs a weighted kind "
                         "('nms'/'oms'/'wrcq'/'orcq')")
    graph = graph if graph is not None else build_graph(code)
    T = max_iterations if max_iterations is not None else code.max_iterations
    gen = torch.Generator(device=device).manual_seed(seed)

    offset_style = kind in ("oms", "orcq")
    thresholds = None
    v2c_thresholds = None
    qparams = None
    q_levels = 0
    v2c_qparams = None
    v2c_levels = 0
    if closed_qdq and kind not in ("rcq", "wrcq", "orcq"):
        raise ValueError("closed_qdq only applies to quantized kinds")
    if kind in ("rcq", "wrcq", "orcq"):
        thresholds = stack_quantizer_thresholds(bc, quantizer_params, T)
        qparams = stack_quantizer_params(quantizer_params, T)
        q_levels = 2 ** (bc - 1)
    if bv is not None and kind in ("rcq", "wrcq", "orcq"):
        vparams = (v2c_quantizer_params if v2c_quantizer_params is not None
                   else [(C * 2.0, g) for C, g in quantizer_params])
        v2c_thresholds = stack_quantizer_thresholds(bv, vparams, T)
        v2c_qparams = stack_quantizer_params(vparams, T)
        v2c_levels = 2 ** (bv - 1)

    if kind == "ms":
        spec = VariantSpec(kind="nms", fixed_beta=factor, fixed_alpha=1.0)
        weights: Dict[str, Optional[torch.Tensor]] = {"beta": None,
                                                      "alpha": None}
        dname = name or f"MS(factor={factor})"
    elif kind == "rcq" and (sharing_type is None or sharing_type == 0):
        spec = VariantSpec(kind="rcq", fixed_beta=1.0, fixed_alpha=1.0,
                           thresholds=thresholds, v2c_thresholds=v2c_thresholds,
                           qparams=qparams, q_levels=q_levels,
                           v2c_qparams=v2c_qparams, v2c_levels=v2c_levels,
                           closed_qdq=closed_qdq)
        weights = {"beta": None, "alpha": None}
        dname = name or f"RCQ(bc={bc})"
    else:
        st = 0 if sharing_type is None else sharing_type
        wiring = (_qc_bucket_wiring(qc, st, offset_style) if qc is not None
                  else _bucket_wiring(graph, st, offset_style))
        (beta_idx, n_beta, alpha_idx, n_alpha,
         fixed_beta, fixed_alpha, alpha_in_cn) = wiring
        if per_layer:
            # bucket universes become (base row x degree bucket)
            row = np.asarray(qc.block_row, dtype=np.int32)
            if beta_idx is not None:
                beta_idx = row * n_beta + np.asarray(beta_idx,
                                                     dtype=np.int32)
                n_beta *= qc.mb
            if alpha_idx is not None:
                alpha_idx = row * n_alpha + np.asarray(alpha_idx,
                                                       dtype=np.int32)
                n_alpha *= qc.mb
        spec = VariantSpec(
            kind=kind,
            beta_idx=beta_idx,
            alpha_idx=alpha_idx,
            fixed_beta=fixed_beta,
            fixed_alpha=fixed_alpha,
            n_beta=n_beta,
            n_alpha=n_alpha,
            alpha_in_cn=offset_style,
            thresholds=thresholds,
            v2c_thresholds=v2c_thresholds,
            qparams=qparams,
            q_levels=q_levels,
            v2c_qparams=v2c_qparams,
            v2c_levels=v2c_levels,
            closed_qdq=closed_qdq,
        )
        if init == "reference":
            if kind == "nms" and st == 0:
                beta_mean, alpha_mean = 0.7, 1.0
            else:
                beta_mean, alpha_mean = 0.0, 0.0
        elif init == "nms":
            beta_mean = 0.0 if offset_style else 0.7
            alpha_mean = 0.0 if offset_style else 1.0
        else:
            raise ValueError(f"unknown init {init!r}")
        weights = _init_weights(gen, T, n_beta, n_alpha,
                                beta_mean=beta_mean, alpha_mean=alpha_mean)
        base = {"nms": "N-NMS" if st == 0 else f"N-2D-NMS(t{st})",
                "oms": "N-OMS" if st == 0 else f"N-2D-OMS(t{st})",
                "wrcq": f"W-RCQ(t{st},bc={bc})",
                "orcq": f"W-OMS-RCQ(t{st},bc={bc})"}[kind]
        if per_layer:
            base += "+perlayer"
        dname = name or base

    layer_checks = (make_layers(graph, num_layers)
                    if layered and qc is None else None)
    bg = build_bucketed_graph(graph) if bucketed else None
    recipe = dict(
        kind=kind, sharing_type=sharing_type, factor=factor,
        max_iterations=T, bc=bc, bv=bv,
        quantizer_params=[list(p) for p in quantizer_params],
        v2c_quantizer_params=(None if v2c_quantizer_params is None
                              else [list(p) for p in v2c_quantizer_params]),
        layered=layered, num_layers=num_layers, init=init, seed=seed,
        name=dname, bucketed=bucketed, per_layer=per_layer,
        closed_qdq=closed_qdq)
    return Decoder(
        name=dname, code=code, graph=graph, spec=spec, max_iterations=T,
        weights=weights, layered=layered, layer_checks=layer_checks, qc=qc,
        qc_options=qc_options, bucketed_graph=bg, recipe=recipe,
        device=device)


# -- reference-parity constructors -----------------------------------------


def basic_min_sum(code, factor: float = 0.7, max_iterations=None, **kw):
    """Fixed-factor normalized min-sum (``ldpc_decoder.py:56-153``)."""
    return make_decoder(code, kind="ms", factor=factor,
                        max_iterations=max_iterations, **kw)


def neural_min_sum(code, max_iterations=None, seed=0, **kw):
    """N-NMS: one weight per (iteration, edge)."""
    return make_decoder(code, kind="nms", sharing_type=0,
                        max_iterations=max_iterations, seed=seed, **kw)


def neural_offset_min_sum(code, max_iterations=None, seed=0, **kw):
    """N-OMS: per-edge offsets, c2v = sign * relu(mag - beta)."""
    return make_decoder(code, kind="oms", sharing_type=0,
                        max_iterations=max_iterations, seed=seed, **kw)


def neural_2d_min_sum(code, weight_sharing_type: int = 2, max_iterations=None,
                      seed=0, **kw):
    """N-2D-NMS types 1-4."""
    return make_decoder(code, kind="nms", sharing_type=weight_sharing_type,
                        max_iterations=max_iterations, seed=seed, **kw)


def neural_2d_offset_min_sum(code, weight_sharing_type: int = 2,
                             max_iterations=None, seed=0, **kw):
    """N-2D-OMS types 1-4."""
    return make_decoder(code, kind="oms", sharing_type=weight_sharing_type,
                        max_iterations=max_iterations, seed=seed, **kw)


def rcq_min_sum(code, bc: int = 3, bv: Optional[int] = None,
                quantizer_params=((3.0, 1.3), (5.0, 1.3), (7.0, 1.3)),
                max_iterations=None, layered: bool = False, **kw):
    """RCQ min-sum; ``bv`` quantizes V2C messages and posteriors."""
    return make_decoder(code, kind="rcq", bc=bc, bv=bv,
                        quantizer_params=quantizer_params,
                        max_iterations=max_iterations, layered=layered, **kw)


def weighted_oms_rcq(code, bc: int = 3, bv: Optional[int] = None,
                     quantizer_params=((3.0, 1.3), (5.0, 1.3), (7.0, 1.3)),
                     weight_sharing_type: int = 2, max_iterations=None,
                     layered: bool = False, seed=0, **kw):
    """W-OMS-RCQ: ``c2v = qdq(sign * (relu(mag - beta) - alpha))``."""
    return make_decoder(code, kind="orcq", bc=bc, bv=bv,
                        quantizer_params=quantizer_params,
                        sharing_type=weight_sharing_type,
                        max_iterations=max_iterations, layered=layered,
                        seed=seed, **kw)


def weighted_rcq(code, bc: int = 3, bv: Optional[int] = None,
                 quantizer_params=((3.0, 1.3), (5.0, 1.3), (7.0, 1.3)),
                 weight_sharing_type: int = 2, max_iterations=None,
                 layered: bool = False, seed=0, **kw):
    """W-RCQ: degree-shared weights + RCQ."""
    return make_decoder(code, kind="wrcq", bc=bc, bv=bv,
                        quantizer_params=quantizer_params,
                        sharing_type=weight_sharing_type,
                        max_iterations=max_iterations, layered=layered,
                        seed=seed, **kw)
