"""Decoder spec, result type and the general (non-QC) engines.

Counterpart of ``ldpc_tpu/decode/engine.py``: :class:`VariantSpec` (numpy
fields, the same validation), :class:`DecodeResult` (a NamedTuple of
tensors), the static quantize-dequantize routing of ``_make_qdq`` and the
numpy ``make_layers``. Also the pieces every decode shares: the
per-iteration tables (``_scan_xs`` with the per-block or per-edge
beta/alpha, built on the device once per spec), the check-node min tree
and variant transform, the QC syndrome and the convergence freezing.

:func:`decode_batch` (flooding) and :func:`decode_batch_layered` are the
JAX package's general engines as plain PyTorch ops on whatever device the
LLRs are on. Layout ``[E, B]`` for edge messages and
``[m, max_dc, B]`` for the check slots, batch innermost; the graph's
index tables go to the device once per (graph, device). Every sum runs in
a fixed order, one add at a time in slot order, so the card gives the
CPU's bits and the flooding engine the bucketed engine's
(``bucketed_engine.py``); the check-node minimum and argmin are
``torch.amin``/``torch.argmin``, which, as ``jnp.min``/``jnp.argmin``,
return a NaN as the minimum and the first NaN's index.

Training. Every engine takes ``ste`` (the quantizers' straight-through
twins, ``quantizer.*_ste``) and ``return_trajectory`` (every iteration's
unfrozen posterior, after the V2C quantizer, as ``posteriors_all``
[T, B, n]), and autograd differentiates it with respect to the weight
tables as ``jax.grad`` differentiates ``ldpc_tpu``'s: the ties of a
minimum split the gradient evenly (``amin``, ``torch.minimum``), ``|x|``
has JAX's derivative +1 at x = +-0 (:func:`jax_abs`; torch's is 0, and a
punctured position's message is exactly 0) and the offset kinds' ``relu``
has derivative 0 at 0. Where the gradient is taken, no engine writes into
a buffer in place, so ``torch.func.vmap`` of ``torch.func.grad`` runs
through it too (the gradient analyzer's per-sample norms).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from ldpc_tpu_torch.codes import DecoderGraph
from ldpc_tpu_torch.quantizer import (power_qdq, power_qdq_ste,
                                      staircase_qdq, staircase_qdq_ste,
                                      uniform_qdq, uniform_qdq_ste)

__all__ = ["VariantSpec", "DecodeResult", "qdq_mode", "make_qdq",
           "make_layers", "decode_batch", "decode_batch_layered",
           "jax_abs"]

# device copies of a spec's tables, per (T, NB, device), and of a general
# graph's index tables, per device (and per layering); an entry goes when
# its spec or graph does
_SPEC_TABLES: "weakref.WeakKeyDictionary[VariantSpec, dict]" = \
    weakref.WeakKeyDictionary()
_GRAPH_TABLES: "weakref.WeakKeyDictionary[DecoderGraph, dict]" = \
    weakref.WeakKeyDictionary()
_INF = float("inf")


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
    """The static routing of ``ldpc_tpu/decode/engine.py::_make_qdq``:
    'uniform' (closed form, every gamma == 1), 'power' (closed form) or
    'staircase' (exact LUT). The closed form applies when (C, gamma)
    parameters exist and the LUT is large (levels > 16) or ``closed``."""
    if qparams is not None and (closed or levels > 16):
        if np.all(np.asarray(qparams)[:, 1] == 1.0):
            return "uniform"
        return "power"
    return "staircase"


def make_qdq(spec: VariantSpec, x: dict, v2c: bool, closed: bool = False,
             ste: bool = False):
    """This iteration's quantize-dequantize callable, or None.

    ``x`` holds the iteration's rows of the tables: ``thr``/``vthr`` ([L]
    float32 tensors) and ``qp``/``vqp`` ([2] float32 tensors, (C, gamma)).
    ``closed`` adds to ``spec.closed_qdq`` (the fused kernels' option);
    ``ste`` picks the straight-through twin of the same form."""
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
        f = uniform_qdq_ste if ste else uniform_qdq
        return lambda v: f(v, qp[0], levels)
    if mode == "power":
        f = power_qdq_ste if ste else power_qdq
        return lambda v: f(v, qp[0], qp[1], levels)
    f = staircase_qdq_ste if ste else staircase_qdq
    return lambda v: f(v, thr)


def make_layers(graph: DecoderGraph, num_layers: Optional[int] = None):
    """Partition checks into layers for the general layered schedule
    (numpy copy of ``ldpc_tpu/decode/engine.py::make_layers``): each check
    goes to the first layer where it shares no variable with a placed check;
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
    key = (T, NB, torch.device(device))
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
    ``_per_block_weights`` applied (a fixed weight fills its table). For a
    general (non-QC) spec NB is the edge count E and the tables are
    per-edge (``_per_edge_weights``). Weights on another device are moved
    there."""
    c = _spec_tables(spec, T, NB, device)

    def wtab(key):
        idx = c[f"{key}_idx"]
        if idx is None:
            return c[f"{key}_fixed"]
        w = torch.as_tensor(weights[key], dtype=torch.float32, device=device)
        return w[:, idx].contiguous()

    return dict(beta=wtab("beta"), alpha=wtab("alpha"),
                **{k: c[k] for k in ("thr", "qp", "vthr", "vqp")})


def _qdq_at(spec, tabs, t, v2c, closed, ste=False):
    x = {k: tabs[k][t] for k in ("thr", "qp", "vthr", "vqp")}
    return make_qdq(spec, x, v2c=v2c, closed=closed, ste=ste)


class _JaxAbs(torch.autograd.Function):
    """``|x|`` whose derivative is JAX's: +1 for x >= 0 (so at +-0 too)
    and -1 below (``torch.abs``'s is 0 at 0)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return x.abs()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def jax_abs(x: torch.Tensor) -> torch.Tensor:
    """``x.abs()``, with JAX's derivative where a gradient is taken."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _JaxAbs.apply(x)
    return x.abs()


def _differentiable(*tensors) -> bool:
    """True where autograd (or ``torch.func.grad``) tracks one of
    ``tensors``: the engines then write no buffer in place."""
    return torch.is_grad_enabled() and any(
        getattr(t, "requires_grad", False) for t in tensors)


def _min_tree(xs):
    """Running (min1, min2, first argmin, negative count) over the f32
    messages ``xs`` of one row, with strict ``<`` as the kernels."""
    inf = float("inf")
    for k, xk in enumerate(xs):
        negk = (xk < 0).to(torch.int32)
        mk = jax_abs(xk)
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
    off = torch.relu(loo_mag - bb)  # oms, orcq: derivative 0 at 0
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
            par = par ^ torch.roll(neg[int(qc.block_col[b])],
                                   -int(qc.block_shift[b]), dims=lift_dim)
        fail = fail | par
    return ~fail.any(dim=lift_dim)


class _Freeze:
    """Convergence freezing (``ldpc_tpu``'s scan carry): after each syndrome
    check, frames not yet done take this check's posterior and iteration
    count; a frame whose syndrome passes is done from then on. The
    posterior's last axis is the batch."""

    def __init__(self, post0):
        B = post0.shape[-1]
        self.post = post0
        self.done = torch.zeros(B, dtype=torch.bool, device=post0.device)
        self.iters = torch.zeros(B, dtype=torch.int32, device=post0.device)

    def check(self, post, ok, t_last: int):
        self.post = torch.where(self.done, self.post, post)
        self.iters = self.iters.masked_fill(~self.done, t_last + 1)
        self.done = self.done | ok

    def result(self, n: int, trajectory=None) -> DecodeResult:
        """The decode's result; ``trajectory`` (a list of the iterations'
        posteriors, each [B, n]) becomes ``posteriors_all`` [T, B, n]."""
        post = self.post.reshape(n, self.post.shape[-1]).T.contiguous()
        return DecodeResult(
            bits=(post < 0).to(torch.int32), posterior=post,
            iterations=self.iters, success=self.done,
            posteriors_all=(None if trajectory is None
                            else torch.stack(trajectory)))


# -- the general engines: padded slot tables of a DecoderGraph --------------


def _pad(x):
    """``x`` with one zero row appended (the padding slot's target)."""
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])


def _general_tables(graph: DecoderGraph, device) -> dict:
    """int64 index tables of a general graph on ``device``: the check slots
    ``cn_slots`` [m * max_dc] (pad E) with ``cn_mask`` [m, max_dc, 1], the
    inverse ``edge_cn_slot`` [E], the variable slots ``vn_slots``
    [max_dv, n] (slot k of every variable; pad E), ``edge_var`` [E] and
    the syndrome's ``cn_var_slots`` [m * max_dc] (pad n)."""
    per = _GRAPH_TABLES.setdefault(graph, {})
    device = torch.device(device)
    if device not in per:
        def ints(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int64),
                                   device=device)

        per[device] = dict(
            cn_slots=ints(graph.cn_slots.reshape(-1)),
            cn_mask=torch.as_tensor(graph.cn_mask[..., None], device=device),
            edge_cn_slot=ints(graph.edge_cn_slot),
            vn_slots=ints(graph.vn_slots.T),
            edge_var=ints(graph.edge_var),
            cn_var_slots=ints(graph.cn_var_slots.reshape(-1)),
            iota=torch.arange(graph.max_dc, device=device).view(1, -1, 1))
    return per[device]


def _cn_loo(msgs, mask, iota, min2_where_inf: bool):
    """Leave-one-out (sign, magnitude) of every slot of the float32
    messages ``msgs`` [rows, d, B] (slots outside ``mask`` ignored):
    min1/min2 over |x| with the first argmin, the sign from the parity of
    the negative count (x < 0, so -0.0 is positive). A NaN is the minimum,
    and the first NaN the argmin, as in ``jnp.min``/``jnp.argmin``.
    Degree-1 rows take min2 = min1; the general engine also where min2 is
    infinite (``min2_where_inf``), the bucketed engine only there."""
    mag = jax_abs(msgs)
    neg = msgs < 0
    if mask is not None:
        mag = torch.where(mask, mag, _INF)
        neg = neg & mask
    min1 = mag.amin(dim=1, keepdim=True)
    is_min = iota == mag.argmin(dim=1, keepdim=True)
    if msgs.shape[1] > 1:
        min2 = torch.where(is_min, _INF, mag).amin(dim=1, keepdim=True)
        if min2_where_inf:
            min2 = torch.where(torch.isinf(min2), min1, min2)
    else:
        min2 = min1
    neg = neg.to(torch.int32)
    neg_cnt = neg.sum(dim=1, keepdim=True, dtype=torch.int32)
    loo_sign = 1.0 - 2.0 * ((neg_cnt - neg) & 1).to(torch.float32)
    return loo_sign, torch.where(is_min, min2, min1)


def _slot_sum(x, slots):
    """``sum_k x[slots[k]]`` over the rows of ``slots`` [K, n], added one
    slot at a time in slot order (a padding slot adds the zero row)."""
    out = x.index_select(0, slots[0])
    for k in range(1, slots.shape[0]):
        out = out + x.index_select(0, slots[k])
    return out


def _parity_ok(neg, slots, m: int):
    """Per-frame success from ``neg`` [n, B] (bool, x < 0) and a check
    slot table ``slots`` [m * max_dc] (pad n): every check's parity 0."""
    par = _pad(neg).index_select(0, slots).view(m, -1, neg.shape[-1])
    return ~(par.sum(dim=1, dtype=torch.int32) & 1).bool().any(dim=0)


def _check_llr_general(llr, graph: DecoderGraph):
    if llr.ndim != 2 or llr.shape[1] != graph.n:
        raise ValueError(f"llr must be [B, {graph.n}], got "
                         f"{tuple(llr.shape)}")


def _cn_update(v2c, g, graph: DecoderGraph, spec: VariantSpec, beta,
               alpha, qdq):
    """One flooding check-node update: v2c [E, B] -> c2v [E, B], with the
    per-edge ``beta``/``alpha`` [E] of the iteration."""
    B = v2c.shape[-1]
    msgs = _pad(v2c).index_select(0, g["cn_slots"]).view(
        graph.m, graph.max_dc, B)
    loo_sign, loo_mag = _cn_loo(msgs, g["cn_mask"], g["iota"], True)
    sign_e = loo_sign.view(-1, B).index_select(0, g["edge_cn_slot"])
    mag_e = loo_mag.view(-1, B).index_select(0, g["edge_cn_slot"])
    return _transform(spec, qdq, beta[:, None], alpha[:, None], sign_e,
                      mag_e)


def _vn_update(c2v, llr_T, llr_e, g, spec: VariantSpec, alpha, vqdq):
    """Variable-node update: c2v [E, B] -> (v2c [E, B], posterior [n, B]);
    the column sums add a variable's c2v one by one in slot order."""
    colsum = _slot_sum(_pad(c2v), g["vn_slots"])
    post = llr_T + colsum  # plain sum, no alpha
    ext = colsum.index_select(0, g["edge_var"]) - c2v
    v2c = llr_e + ext if spec.alpha_in_cn else llr_e + alpha[:, None] * ext
    if vqdq is not None:
        v2c, post = vqdq(v2c), vqdq(post)
    return v2c, post


def decode_batch(
    llr: torch.Tensor,           # [B, n]
    weights,                     # {'beta': [T, n_beta] | None, 'alpha': ...}
    *,
    graph: DecoderGraph,
    spec: VariantSpec,
    max_iterations: int,
    ste: bool = False,
    return_trajectory: bool = False,
) -> DecodeResult:
    """Flooding-schedule batched decode of ``llr`` [B, n] over a general
    Tanner graph, in float32 on ``llr``'s device. Early exit is realized
    as output freezing (the syndrome is checked after every iteration), so
    ``iterations`` is the first converged iteration + 1, or T. Returns
    int32 bits, the float32 posterior, iterations and success, and with
    ``return_trajectory`` every iteration's posterior [T, B, n]
    (differentiable; ``ste`` puts the straight-through quantizers in)."""
    _check_llr_general(llr, graph)
    T, dev = max_iterations, llr.device
    g = _general_tables(graph, dev)
    tabs = _tables(weights, spec, T, graph.num_edges, dev)
    llr_T = llr.to(torch.float32).T.contiguous()          # [n, B]
    llr_e = llr_T.index_select(0, g["edge_var"])           # [E, B]
    v2c = llr_e
    freeze = _Freeze(llr_T)
    traj = [] if return_trajectory else None
    for t in range(T):
        qdq = _qdq_at(spec, tabs, t, False, False, ste)
        vqdq = _qdq_at(spec, tabs, t, True, False, ste)
        beta, alpha = tabs["beta"][t], tabs["alpha"][t]
        c2v = _cn_update(v2c, g, graph, spec, beta, alpha, qdq)
        v2c, post = _vn_update(c2v, llr_T, llr_e, g, spec, alpha, vqdq)
        freeze.check(post, _parity_ok(post < 0, g["cn_var_slots"], graph.m),
                     t)
        if traj is not None:
            traj.append(post.T)
    return freeze.result(graph.n, traj)


def _layer_tables(graph: DecoderGraph, layer_checks: np.ndarray,
                  device) -> list:
    """Per layer of ``layer_checks`` [L, ml] (pad m), on ``device``: the
    flat check slots ``slots`` [ml * max_dc] (pad E) and their variables
    ``evar`` (pad n), the ``mask`` [ml, max_dc, 1], the real slots'
    positions ``pos`` and edge ids ``edges`` (where the new c2v go), and
    the column-sum ``rounds``: (positions, variables) of the r-th
    occurrence of each variable in slot order. A layer whose checks share
    no variable has one round; where ``num_layers`` forced checks that
    share variables into one layer, round r adds each variable's r-th
    difference, so duplicates add in slot order, as ``ldpc_tpu``'s
    scatter-add does on the CPU, with no atomics."""
    per = _GRAPH_TABLES.setdefault(graph, {})
    lc = np.ascontiguousarray(layer_checks, np.int64)
    key = (torch.device(device), lc.shape, lc.tobytes())
    if key not in per:
        E, n = graph.num_edges, graph.n
        slots_p = np.concatenate(
            [graph.cn_slots, np.full((1, graph.max_dc), E, np.int32)])
        evar_p = np.concatenate([graph.edge_var, np.int32([n])])

        def ints(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        layers = []
        for checks in lc:
            slots = slots_p[checks].reshape(-1)
            evar = evar_p[slots]
            pos = np.flatnonzero(slots != E)
            seen: dict = {}
            rounds: list = []
            for p in pos:
                r = seen.get(int(evar[p]), 0)
                seen[int(evar[p])] = r + 1
                if r == len(rounds):
                    rounds.append([])
                rounds[r].append(p)
            layers.append(dict(
                slots=ints(slots), evar=ints(evar),
                mask=torch.as_tensor((slots != E).reshape(len(checks), -1, 1),
                                     device=device),
                pos=ints(pos), edges=ints(slots[pos]),
                rounds=[(ints(r), ints(evar[r])) for r in rounds]))
        per[key] = layers
    return per[key]


def decode_batch_layered(
    llr: torch.Tensor,           # [B, n]
    weights,
    layer_checks,                # [L, ml] check ids per layer, pad m
    *,
    graph: DecoderGraph,
    spec: VariantSpec,
    max_iterations: int,
    ste: bool = False,
    return_trajectory: bool = False,
) -> DecodeResult:
    """Layered-schedule batched decode over a general Tanner graph, in
    float32 on ``llr``'s device: a persistent per-edge c2v memory and
    per-variable column sums, updated layer by layer. Each layer forms
    fresh v2c from the current sums, ``llr + alpha * (colsum - old)``, runs
    the check-node update and folds ``new - old`` back into the sums. At
    each iteration's end the V2C quantizer applies to the posterior
    ``llr + colsum`` and the syndrome is checked. ``ste`` and
    ``return_trajectory`` as in :func:`decode_batch`; where a gradient is
    taken the sums and the c2v memory are replaced, not written in
    place."""
    _check_llr_general(llr, graph)
    T, dev = max_iterations, llr.device
    E, B = graph.num_edges, llr.shape[0]
    g = _general_tables(graph, dev)
    layers = _layer_tables(graph, np.asarray(layer_checks), dev)
    tabs = _tables(weights, spec, T, E, dev)
    llr_T = llr.to(torch.float32).T.contiguous()          # [n, B]
    llr_ext = _pad(llr_T)
    # c2v and column sums with a padding row that stays zero
    c2v_ext = torch.zeros((E + 1, B), dtype=torch.float32, device=dev)
    colsum_ext = torch.zeros_like(llr_ext)
    freeze = _Freeze(llr_T)
    traj = [] if return_trajectory else None
    functional = _differentiable(llr, *weights.values())

    def put(buf, index, src):
        if functional:
            return buf.index_copy(0, index, src)
        return buf.index_copy_(0, index, src)

    for t in range(T):
        qdq = _qdq_at(spec, tabs, t, False, False, ste)
        vqdq = _qdq_at(spec, tabs, t, True, False, ste)
        beta_ext, alpha_ext = _pad(tabs["beta"][t]), _pad(tabs["alpha"][t])
        for lay in layers:
            slots, mask = lay["slots"], lay["mask"]
            shape = mask.shape[:2] + (B,)
            old = c2v_ext.index_select(0, slots).view(shape)
            ext = colsum_ext.index_select(0, lay["evar"]).view(shape) - old
            x = llr_ext.index_select(0, lay["evar"]).view(shape)
            if spec.alpha_in_cn:
                v2c = x + ext
            else:
                v2c = x + alpha_ext.index_select(0, slots).view(
                    shape[:2] + (1,)) * ext
            loo_sign, loo_mag = _cn_loo(v2c, mask, g["iota"], True)
            bb = beta_ext.index_select(0, slots).view(shape[:2] + (1,))
            ab = (alpha_ext.index_select(0, slots).view(shape[:2] + (1,))
                  if spec.alpha_in_cn and spec.alpha_idx is not None
                  else 0.0)
            new = torch.where(mask, _transform(spec, qdq, bb, ab, loo_sign,
                                               loo_mag), 0.0).view(-1, B)
            delta = new - old.view(-1, B)
            for pos, var in lay["rounds"]:
                colsum_ext = put(colsum_ext, var, colsum_ext.index_select(
                    0, var) + delta.index_select(0, pos))
            c2v_ext = put(c2v_ext, lay["edges"],
                          new.index_select(0, lay["pos"]))
        post = llr_T + colsum_ext[:-1]
        if vqdq is not None:
            post = vqdq(post)
        freeze.check(post, _parity_ok(post < 0, g["cn_var_slots"], graph.m),
                     t)
        if traj is not None:
            traj.append(post.T)
    return freeze.result(graph.n, traj)
