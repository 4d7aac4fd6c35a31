"""Whole-decode QC decodes: the CUDA kernels and their plain versions.

Counterparts of ``ldpc_tpu/decode/pallas_fused.py``:

- :func:`qc_fused_decode_batch`, the flooding schedule (K4,
  ``csrc/fused_flooding.cu``; plain version :func:`_fused_flooding_plain`).
  A check-aligned message state starts as the rolled channel LLRs; each
  iteration runs the min-sum check update with the variant transform and
  the RCQ quantizer row by row, then the variable update column by column
  (column sums in the storage type, the V2C quantizer), all in place.
- :func:`qc_fused_decode_batch_layered`, the layered schedule (K1,
  ``csrc/fused_layered.cu``; plain version :func:`_fused_layered_plain`).
  A per-block c2v memory and per-column sums; row by row (a layer per base
  row) it forms fresh v2c messages from the current sums, runs the check
  update and folds the new c2v back.

Both have the check-at-the-end contract: the returned posterior is
iteration T's, ``success`` is its syndrome (K3), ``iterations`` is T for
every frame.

On a CUDA tensor a wrapper launches its kernel (built by
``decode/_build.py``) or raises. On a CPU tensor, and only there, it runs
the plain version: the same loops with the same op order and rounding
points in PyTorch ops. Every storage-dtype operation is a float32
operation rounded to ``dtype``; the check-node math and the quantizers
run in float32.

The quantizer and weight-index tables a spec needs are built once per
(spec, T, device) and kept while the spec lives, and the graph's index
tables once per (QCGraph, device); the per-call β/α tables are gathered
on the device. A steady-state call copies nothing from the host.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from ldpc_tpu_torch.decode.engine import (DecodeResult, VariantSpec,
                                          make_qdq, qdq_mode)
from ldpc_tpu_torch.decode.qc_engine import QCGraph

__all__ = ["qc_fused_decode_batch", "qc_fused_decode_batch_layered",
           "LAYERED_LAUNCHES", "FLOODING_LAUNCHES"]

# launches of each CUDA kernel (the plain versions never count)
LAYERED_LAUNCHES = 0   # K1, csrc/fused_layered.cu
FLOODING_LAUNCHES = 0  # K4, csrc/fused_flooding.cu

_TPU_KEYS = frozenset({"batch_tile", "natural", "interpret"})
_KINDS = {"nms": 0, "oms": 1, "rcq": 2, "wrcq": 3, "orcq": 4}
_QMODES = {"staircase": 0, "uniform": 1, "power": 2}

# device copies of a spec's tables, per (T, device), and of a graph's
# index tables, per device; an entry goes when its spec or graph does
_SPEC_TABLES: "weakref.WeakKeyDictionary[VariantSpec, dict]" = \
    weakref.WeakKeyDictionary()
_GRAPH_TABLES: "weakref.WeakKeyDictionary[QCGraph, dict]" = \
    weakref.WeakKeyDictionary()


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
    """Per-(iteration, block) float32 weight tables and the quantizer
    tables, on ``device``. Weights on another device are moved there."""
    c = _spec_tables(spec, T, NB, device)

    def wtab(key):
        idx = c[f"{key}_idx"]
        if idx is None:
            return c[f"{key}_fixed"]
        w = torch.as_tensor(weights[key], dtype=torch.float32, device=device)
        return w[:, idx].contiguous()

    return dict(beta=wtab("beta"), alpha=wtab("alpha"),
                **{k: c[k] for k in ("thr", "qp", "vthr", "vqp")})


def _graph_tables(qc: QCGraph, device) -> dict:
    """int32 index tables of the kernels: row_ptr [mb+1], col_ptr [nb+1],
    col_blocks [NB] (block ids column by column), block_col, block_shift."""
    per = _GRAPH_TABLES.setdefault(qc, {})
    device = torch.device(device)
    if device not in per:
        if [b for r in qc.row_blocks for b in r] != list(range(qc.num_blocks)):
            raise ValueError("QCGraph blocks must be ordered row-major")
        ints = lambda a: torch.as_tensor(np.asarray(a, np.int32),
                                         device=device)
        per[device] = dict(
            row_ptr=ints(np.cumsum([0] + [len(r) for r in qc.row_blocks])),
            col_ptr=ints(np.cumsum([0] + [len(c) for c in qc.col_blocks])),
            col_blocks=ints([b for c in qc.col_blocks for b in c]),
            block_col=ints(qc.block_col), block_shift=ints(qc.block_shift))
    return per[device]


def _qdq_at(spec, tabs, t, v2c, closed):
    x = {k: tabs[k][t] for k in ("thr", "qp", "vthr", "vqp")}
    return make_qdq(spec, x, v2c=v2c, closed=closed)


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


def _syndrome_ok(post, qc: QCGraph):
    """Per-frame success from the stored posterior ``post`` [nb, B, L]:
    per base row, the parity of the check-aligned negative signs."""
    neg = post < 0
    B, L = post.shape[1], post.shape[2]
    fail = torch.zeros((B, L), dtype=torch.bool, device=post.device)
    for blocks in qc.row_blocks:
        par = torch.zeros((B, L), dtype=torch.bool, device=post.device)
        for b in blocks:
            par = par ^ torch.roll(neg[int(qc.block_col[b])],
                                   -int(qc.block_shift[b]), dims=-1)
        fail = fail | par
    return ~fail.any(dim=-1)


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


def _plain_flooding(llr, tabs, qc: QCGraph, spec: VariantSpec, T: int,
                    closed: bool):
    """The flooding kernel's computation in PyTorch ops: ``llr`` [B, n] in
    the storage dtype -> (posterior [B, n] in that dtype, success [B]).

    ``M`` [NB, B, L] is check-aligned: ``roll(x, -s)`` aligns block ``b``'s
    variables to its checks, ``roll(x, +s)`` back."""
    dtype = llr.dtype
    B = llr.shape[0]
    L, nb = qc.lift, qc.nb
    f32 = torch.float32
    lcol = llr.view(B, nb, L).transpose(0, 1)          # [nb, B, L]
    cols = [int(c) for c in qc.block_col]
    shifts = [int(s) for s in qc.block_shift]
    beta, alpha = tabs["beta"], tabs["alpha"]
    M = torch.stack([torch.roll(lcol[cols[b]], -shifts[b], dims=-1)
                     for b in range(qc.num_blocks)])
    posts = [None] * nb

    for t in range(T):
        qdq = _qdq_at(spec, tabs, t, False, closed)
        vqdq = _qdq_at(spec, tabs, t, True, closed)
        for blocks in qc.row_blocks:
            xs = [M[b].to(f32) for b in blocks]
            min1, min2, argm, neg_cnt = _min_tree(xs)
            for k, b in enumerate(blocks):
                loo_mag = torch.where(argm == k, min2, min1)
                loo_neg = (neg_cnt - (xs[k] < 0).to(torch.int32)) & 1
                loo_sign = 1.0 - 2.0 * loo_neg.to(f32)
                M[b] = _transform(spec, qdq, beta[t, b], alpha[t, b],
                                  loo_sign, loo_mag).to(dtype)
        for j, blocks in enumerate(qc.col_blocks):
            ca = [torch.roll(M[b], shifts[b], dims=-1) for b in blocks]
            colsum = ca[0]
            for k in range(1, len(blocks)):
                colsum = (colsum.to(f32) + ca[k].to(f32)).to(dtype)
            lj = lcol[j].to(f32)
            for k, b in enumerate(blocks):
                ext = (colsum.to(f32) - ca[k].to(f32)).to(dtype).to(f32)
                if spec.alpha_in_cn:
                    nv = (lj + ext).to(dtype).to(f32)
                else:
                    nv = lj + alpha[t, b] * ext
                if vqdq is not None:
                    nv = vqdq(nv)
                M[b] = torch.roll(nv.to(dtype), -shifts[b], dims=-1)
            if t == T - 1:
                post = (lj + colsum.to(f32)).to(dtype)
                if vqdq is not None:
                    post = vqdq(post).to(dtype)
                posts[j] = post
    post = torch.stack(posts)                           # [nb, B, L]
    return post.transpose(0, 1).reshape(B, qc.n), _syndrome_ok(post, qc)


def _plain_layered(llr, tabs, qc: QCGraph, spec: VariantSpec, T: int,
                   closed: bool):
    """The layered kernel's computation in PyTorch ops: ``llr`` [B, n] in
    the storage dtype -> (posterior [B, n] in that dtype, success [B]).

    Layout: ``colsum`` [nb, B, L] and ``C`` [NB, B, L] are var-aligned;
    ``roll(x, -s)`` aligns block ``b``'s variables to its checks."""
    dtype = llr.dtype
    B = llr.shape[0]
    L, nb = qc.lift, qc.nb
    f32 = torch.float32
    lcol = llr.view(B, nb, L).transpose(0, 1)          # [nb, B, L]
    colsum = torch.zeros((nb, B, L), dtype=dtype, device=llr.device)
    C = torch.zeros((qc.num_blocks, B, L), dtype=dtype, device=llr.device)
    cols = [int(c) for c in qc.block_col]
    shifts = [int(s) for s in qc.block_shift]
    beta, alpha = tabs["beta"], tabs["alpha"]

    def v2c(j, b, t, ext):
        if spec.alpha_in_cn:
            return (lcol[j].to(f32) + ext.to(f32)).to(dtype).to(f32)
        return lcol[j].to(f32) + alpha[t, b] * ext.to(f32)

    for t in range(T):
        qdq = _qdq_at(spec, tabs, t, False, closed)
        for blocks in qc.row_blocks:
            xs = []
            for b in blocks:
                j = cols[b]
                ext = (colsum[j].to(f32) - C[b].to(f32)).to(dtype)
                xs.append(torch.roll(v2c(j, b, t, ext), -shifts[b], dims=-1))
                colsum[j] = ext
            min1, min2, argm, neg_cnt = _min_tree(xs)
            row_sign = 1.0 - 2.0 * (neg_cnt & 1).to(f32)
            for k, b in enumerate(blocks):
                j = cols[b]
                loo_mag = torch.where(argm == k, min2, min1)
                loo_sign = row_sign * (1.0 - 2.0 * (xs[k] < 0).to(f32))
                out = _transform(spec, qdq, beta[t, b], alpha[t, b],
                                 loo_sign, loo_mag)
                new = torch.roll(out, shifts[b], dims=-1).to(dtype)
                colsum[j] = (colsum[j].to(f32) + new.to(f32)).to(dtype)
                C[b] = new

    post = (lcol.to(f32) + colsum.to(f32)).to(dtype)
    vqdq = _qdq_at(spec, tabs, T - 1, True, closed)
    if vqdq is not None:
        post = vqdq(post).to(dtype)
    return post.transpose(0, 1).reshape(B, qc.n), _syndrome_ok(post, qc)


def _launch(flooding: bool, llr, tabs, qc: QCGraph, spec: VariantSpec,
            T: int, lean: bool, closed: bool):
    """Launch a CUDA kernel on ``llr`` [B, n] (storage dtype, CUDA) ->
    (posterior or None, int8 bits or None, success)."""
    global LAYERED_LAUNCHES, FLOODING_LAUNCHES
    from ldpc_tpu_torch.decode._build import load_library

    B, n = llr.shape
    L, dev = qc.lift, llr.device
    if L > 1024:
        raise ValueError(f"lift {L} > 1024 threads per block")
    elt = llr.element_size()
    # flooding keeps LLRs + the whole message state on chip; layered keeps
    # LLRs + column sums (its c2v memory is a global scratch)
    smem = (qc.nb + qc.num_blocks) * L * elt if flooding else 2 * n * elt
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"kernel needs {smem} B of shared memory per frame, "
                         f"the card allows {limit} B")
    g = _graph_tables(qc, dev)
    post = None if lean else torch.empty((B, n), dtype=llr.dtype, device=dev)
    bits = torch.empty((B, n), dtype=torch.int8, device=dev) if lean else None
    ok = torch.empty((B,), dtype=torch.uint8, device=dev)
    if B == 0:
        return post, bits, ok.bool()
    q_mode = qdq_mode(spec.qparams, spec.q_levels, closed)
    v_mode = qdq_mode(spec.v2c_qparams, spec.v2c_levels, closed)
    with_vqdq = (spec.v2c_qparams is not None or
                 spec.v2c_thresholds is not None)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr()) if x is not None else None
    tables = [ptr(tabs["beta"]), ptr(tabs["alpha"]),
              ptr(tabs["thr"]), tabs["thr"].shape[1], ptr(tabs["qp"]),
              ptr(tabs["vthr"]), tabs["vthr"].shape[1], ptr(tabs["vqp"])]
    sizes = [B, qc.nb, qc.mb, qc.num_blocks, L, T,
             int(llr.dtype == torch.bfloat16), _KINDS[spec.kind],
             int(spec.alpha_in_cn), _QMODES[q_mode], spec.q_levels,
             int(with_vqdq), _QMODES[v_mode], spec.v2c_levels,
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)]
    lib = load_library()
    with torch.cuda.device(dev):  # the launch goes to the current device
        if flooding:
            err = lib.ldpc_fused_flooding(
                ptr(llr), ptr(post), ptr(bits), ptr(ok), *tables,
                *[ptr(g[k]) for k in ("row_ptr", "col_ptr", "col_blocks",
                                      "block_col", "block_shift")], *sizes)
        else:
            cmem = torch.empty((B, qc.num_blocks, L), dtype=llr.dtype,
                               device=dev)
            err = lib.ldpc_fused_layered(
                ptr(llr), ptr(post), ptr(bits), ptr(ok), ptr(cmem), *tables,
                *[ptr(g[k]) for k in ("row_ptr", "block_col",
                                      "block_shift")], *sizes)
    name = "flooding" if flooding else "layered"
    if err != 0:
        raise RuntimeError(f"fused {name} kernel launch failed: CUDA error "
                           f"{err}")
    if flooding:
        FLOODING_LAUNCHES += 1
    else:
        LAYERED_LAUNCHES += 1
    return post, bits, ok.bool()


class _Call:
    """One call's checked arguments, storage-dtype input and device tables
    (shared by the kernels and their plain versions)."""

    def __init__(self, llr, weights, qc, spec, max_iterations, dtype,
                 closed_qdq, tpu_keys):
        unknown = set(tpu_keys) - _TPU_KEYS
        if unknown:
            raise TypeError(f"unexpected keyword arguments {sorted(unknown)}")
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"dtype must be torch.bfloat16 or torch.float32, "
                             f"got {dtype}")
        if llr.shape[1] != qc.n:
            raise ValueError(f"llr has {llr.shape[1]} columns, the code has "
                             f"n={qc.n}")
        self.closed = closed_qdq or spec.closed_qdq
        self.T = max_iterations
        self.tabs = _tables(weights, spec, self.T, qc.num_blocks, llr.device)
        self.x = llr.to(dtype).contiguous()

    def result(self, post, bits, ok, lean):
        B = self.x.shape[0]
        iters = torch.full((B,), self.T, dtype=torch.int32,
                           device=self.x.device)
        if lean:
            if bits is None:
                bits = (post < 0).to(torch.int8)
            return DecodeResult(bits=bits, posterior=None, iterations=iters,
                                success=ok)
        return DecodeResult(bits=(post < 0).to(torch.int32), posterior=post,
                            iterations=iters, success=ok)


def _fused_flooding_plain(llr, weights, *, qc: QCGraph, spec: VariantSpec,
                          max_iterations: int, dtype=torch.bfloat16,
                          lean: bool = False, closed_qdq: bool = False,
                          **tpu_keys) -> DecodeResult:
    """The plain PyTorch version of :func:`qc_fused_decode_batch`, with the
    same contract, on any device. The wrapper runs it for CPU tensors; on
    the card it is the reference the kernel is held to."""
    c = _Call(llr, weights, qc, spec, max_iterations, dtype, closed_qdq,
              tpu_keys)
    post, ok = _plain_flooding(c.x, c.tabs, qc, spec, c.T, c.closed)
    return c.result(post, None, ok, lean)


def _fused_layered_plain(llr, weights, *, qc: QCGraph, spec: VariantSpec,
                         max_iterations: int, dtype=torch.bfloat16,
                         lean: bool = False, closed_qdq: bool = False,
                         **tpu_keys) -> DecodeResult:
    """The plain PyTorch version of :func:`qc_fused_decode_batch_layered`,
    with the same contract, on any device. The wrapper runs it for CPU
    tensors; on the card it is the reference the kernel is held to."""
    c = _Call(llr, weights, qc, spec, max_iterations, dtype, closed_qdq,
              tpu_keys)
    post, ok = _plain_layered(c.x, c.tabs, qc, spec, c.T, c.closed)
    return c.result(post, None, ok, lean)


def _decode(flooding: bool, llr, weights, qc, spec, max_iterations, dtype,
            lean, closed_qdq, tpu_keys) -> DecodeResult:
    if llr.device.type == "cpu":
        plain = _fused_flooding_plain if flooding else _fused_layered_plain
        return plain(llr, weights, qc=qc, spec=spec,
                     max_iterations=max_iterations, dtype=dtype, lean=lean,
                     closed_qdq=closed_qdq, **tpu_keys)
    if llr.device.type != "cuda":
        raise ValueError(f"no fused {'flooding' if flooding else 'layered'} "
                         f"decode for device {llr.device}")
    c = _Call(llr, weights, qc, spec, max_iterations, dtype, closed_qdq,
              tpu_keys)
    post, bits, ok = _launch(flooding, c.x, c.tabs, qc, spec, c.T, lean,
                             c.closed)
    return c.result(post, bits, ok, lean)


def qc_fused_decode_batch(
    llr: torch.Tensor,           # [B, n]
    weights,                     # {'beta': [T, n_beta] | None, 'alpha': ...}
    *,
    qc: QCGraph,
    spec: VariantSpec,
    max_iterations: int,
    dtype: torch.dtype = torch.bfloat16,
    lean: bool = False,
    closed_qdq: bool = False,
    **tpu_keys,
) -> DecodeResult:
    """Flooding-schedule whole decode of ``llr`` [B, n] (any B).

    ``dtype`` is the message storage type, bf16 or f32 (fp16 cannot hold
    the quantizer's 1e-30 sign floor). ``lean=True`` returns int8 bits and
    ``posterior=None``; otherwise int32 bits and the posterior in
    ``dtype``. ``closed_qdq`` forces the closed-form quantizer as in the
    JAX kernel. The JAX kernel's TPU-only keys ``batch_tile``, ``natural``
    and ``interpret`` are accepted and ignored, so existing ``qc_options``
    run unchanged; the CUDA kernel decodes one frame per thread block and
    needs no tiling.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    :func:`_fused_flooding_plain`; any other device raises."""
    return _decode(True, llr, weights, qc, spec, max_iterations, dtype, lean,
                   closed_qdq, tpu_keys)


def qc_fused_decode_batch_layered(
    llr: torch.Tensor,           # [B, n]
    weights,                     # {'beta': [T, n_beta] | None, 'alpha': ...}
    *,
    qc: QCGraph,
    spec: VariantSpec,
    max_iterations: int,
    dtype: torch.dtype = torch.bfloat16,
    lean: bool = False,
    closed_qdq: bool = False,
    **tpu_keys,
) -> DecodeResult:
    """Layered-schedule whole decode of ``llr`` [B, n] (any B), with the
    arguments and device rules of :func:`qc_fused_decode_batch`; a CPU
    tensor runs :func:`_fused_layered_plain`."""
    return _decode(False, llr, weights, qc, spec, max_iterations, dtype, lean,
                   closed_qdq, tpu_keys)

