"""Whole-decode layered QC decode: the CUDA kernel and its plain version.

Counterpart of ``ldpc_tpu/decode/pallas_fused.py::
qc_fused_decode_batch_layered``. The layered schedule keeps a per-block
c2v memory and per-column sums; row by row (a layer per base row) it forms
fresh v2c messages from the current sums, runs the min-sum check update
with the variant transform and the RCQ quantizer, and folds the new c2v
back. The contract is check-at-the-end: the returned posterior is
iteration T's, ``success`` is its syndrome, ``iterations`` is T for every
frame.

On a CUDA tensor the wrapper launches the kernel
``csrc/fused_layered.cu`` (built by ``decode/_build.py``) or raises. On a
CPU tensor, and only there, it runs :func:`_fused_layered_plain`, the same
loop with the same op order and rounding points in PyTorch ops. Every
storage-dtype operation is a float32 operation rounded to ``dtype``; the
check-node math and the quantizers run in float32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ldpc_tpu_torch.decode.engine import (DecodeResult, VariantSpec,
                                          make_qdq, qdq_mode)
from ldpc_tpu_torch.decode.qc_engine import QCGraph

__all__ = ["qc_fused_decode_batch_layered", "KERNEL_LAUNCHES"]

# launches of the CUDA kernel (never counts the plain version)
KERNEL_LAUNCHES = 0

_TPU_KEYS = frozenset({"batch_tile", "natural", "interpret"})
_KINDS = {"nms": 0, "oms": 1, "rcq": 2, "wrcq": 3, "orcq": 4}
_QMODES = {"staircase": 0, "uniform": 1, "power": 2}


def _tables(weights, spec: VariantSpec, T: int, NB: int, device):
    """Per-(iteration, block) float32 weight tables and the quantizer
    tables, on ``device``."""
    def tab(a, w):
        if a is None:
            return torch.zeros((T, w), dtype=torch.float32, device=device)
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def wtab(key, idx, fixed):
        if idx is None:
            return torch.full((T, NB), fixed, dtype=torch.float32,
                              device=device)
        w = torch.as_tensor(weights[key], dtype=torch.float32, device=device)
        return w[:, torch.as_tensor(np.asarray(idx, np.int64),
                                    device=device)].contiguous()

    return dict(
        beta=wtab("beta", spec.beta_idx, spec.fixed_beta),
        alpha=wtab("alpha", spec.alpha_idx, spec.fixed_alpha),
        thr=tab(spec.thresholds, 1), qp=tab(spec.qparams, 2),
        vthr=tab(spec.v2c_thresholds, 1), vqp=tab(spec.v2c_qparams, 2))


def _plain_decode(llr, tabs, qc: QCGraph, spec: VariantSpec, T: int,
                  closed: bool):
    """The kernel's computation in PyTorch ops: ``llr`` [B, n] in the
    storage dtype -> (posterior [B, n] in that dtype, success [B] bool).

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
    inf = float("inf")

    def v2c(j, b, t, ext):
        if spec.alpha_in_cn:
            return (lcol[j].to(f32) + ext.to(f32)).to(dtype).to(f32)
        return lcol[j].to(f32) + alpha[t, b] * ext.to(f32)

    def qdq_at(t, v2c):
        x = {k: tabs[k][t] for k in ("thr", "qp", "vthr", "vqp")}
        return make_qdq(spec, x, v2c=v2c, closed=closed)

    for t in range(T):
        qdq = qdq_at(t, v2c=False)
        for blocks in qc.row_blocks:
            dc = len(blocks)
            negs = []
            for k, b in enumerate(blocks):
                j = cols[b]
                ext = (colsum[j].to(f32) - C[b].to(f32)).to(dtype)
                xk = torch.roll(v2c(j, b, t, ext), -shifts[b], dims=-1)
                colsum[j] = ext
                negk = xk < 0
                negs.append(negk)
                mk = xk.abs()
                if k == 0:
                    min1 = mk
                    min2 = torch.full_like(mk, inf)
                    argm = torch.zeros(mk.shape, dtype=torch.int32,
                                       device=mk.device)
                    neg_cnt = negk.to(torch.int32)
                else:
                    new_min = mk < min1
                    min2 = torch.where(new_min, min1, torch.minimum(min2, mk))
                    min1 = torch.where(new_min, mk, min1)
                    argm = torch.where(new_min, k, argm)
                    neg_cnt = neg_cnt + negk.to(torch.int32)
            if dc == 1:
                min2 = min1
            row_sign = 1.0 - 2.0 * (neg_cnt & 1).to(f32)
            for k, b in enumerate(blocks):
                j = cols[b]
                loo_mag = torch.where(argm == k, min2, min1)
                loo_sign = row_sign * (1.0 - 2.0 * negs[k].to(f32))
                bb = beta[t, b]
                if spec.kind == "nms":
                    out = bb * loo_sign * loo_mag
                elif spec.kind == "rcq":
                    out = qdq(loo_sign * loo_mag)
                elif spec.kind == "wrcq":
                    out = qdq(bb * loo_sign * loo_mag)
                else:  # oms, orcq
                    off = torch.clamp_min(loo_mag - bb, 0.0)
                    if spec.alpha_in_cn:
                        off = off - alpha[t, b]
                    out = loo_sign * off
                    if spec.kind == "orcq":
                        out = qdq(out)
                new = torch.roll(out, shifts[b], dims=-1).to(dtype)
                colsum[j] = (colsum[j].to(f32) + new.to(f32)).to(dtype)
                C[b] = new

    post = (lcol.to(f32) + colsum.to(f32)).to(dtype)
    vqdq = qdq_at(T - 1, v2c=True)
    if vqdq is not None:
        post = vqdq(post).to(dtype)
    # syndrome of the stored posterior: per base row, the parity of the
    # check-aligned negative signs
    neg = post < 0
    fail = torch.zeros((B, L), dtype=torch.bool, device=llr.device)
    for blocks in qc.row_blocks:
        par = torch.zeros((B, L), dtype=torch.bool, device=llr.device)
        for b in blocks:
            par = par ^ torch.roll(neg[cols[b]], -shifts[b], dims=-1)
        fail = fail | par
    return post.transpose(0, 1).reshape(B, qc.n), ~fail.any(dim=-1)


def _launch(llr, tabs, qc: QCGraph, spec: VariantSpec, T: int, lean: bool,
            closed: bool):
    """Launch the CUDA kernel on ``llr`` [B, n] (storage dtype, CUDA) ->
    (posterior or None, int8 bits or None, success)."""
    global KERNEL_LAUNCHES
    from ldpc_tpu_torch.decode._build import load_library

    B, n = llr.shape
    L, dev = qc.lift, llr.device
    q_mode = qdq_mode(spec.qparams, spec.q_levels, closed)
    v_mode = qdq_mode(spec.v2c_qparams, spec.v2c_levels, closed)
    with_vqdq = (spec.v2c_qparams is not None or
                 spec.v2c_thresholds is not None)
    if L > 1024:
        raise ValueError(f"lift {L} > 1024 threads per block")
    smem = 2 * n * llr.element_size()
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"kernel needs {smem} B of shared memory per frame, "
                         f"the card allows {limit} B")
    row_ptr = np.cumsum([0] + [len(r) for r in qc.row_blocks])
    if [b for r in qc.row_blocks for b in r] != list(range(qc.num_blocks)):
        raise ValueError("QCGraph blocks must be ordered row-major")
    ints = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    graph = [ints(row_ptr), ints(qc.block_col), ints(qc.block_shift)]
    post = None if lean else torch.empty((B, n), dtype=llr.dtype, device=dev)
    bits = torch.empty((B, n), dtype=torch.int8, device=dev) if lean else None
    ok = torch.empty((B,), dtype=torch.uint8, device=dev)
    cmem = torch.empty((B, qc.num_blocks, L), dtype=llr.dtype, device=dev)
    if B == 0:
        return post, bits, ok.bool()
    ptr = lambda x: ctypes.c_void_p(x.data_ptr()) if x is not None else None
    lib = load_library()
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.ldpc_fused_layered(
            ptr(llr), ptr(post), ptr(bits), ptr(ok), ptr(cmem),
            ptr(tabs["beta"]), ptr(tabs["alpha"]),
            ptr(tabs["thr"]), tabs["thr"].shape[1], ptr(tabs["qp"]),
            ptr(tabs["vthr"]), tabs["vthr"].shape[1], ptr(tabs["vqp"]),
            *[ptr(g) for g in graph],
            B, qc.nb, qc.mb, qc.num_blocks, L, T,
            int(llr.dtype == torch.bfloat16), _KINDS[spec.kind],
            int(spec.alpha_in_cn), _QMODES[q_mode], spec.q_levels,
            int(with_vqdq), _QMODES[v_mode], spec.v2c_levels,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"fused layered kernel launch failed: CUDA error "
                           f"{err}")
    KERNEL_LAUNCHES += 1
    return post, bits, ok.bool()


class _Call:
    """One call's checked arguments, storage-dtype input and device tables
    (shared by the kernel and its plain version)."""

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


def _fused_layered_plain(llr, weights, *, qc: QCGraph, spec: VariantSpec,
                         max_iterations: int, dtype=torch.bfloat16,
                         lean: bool = False, closed_qdq: bool = False,
                         **tpu_keys) -> DecodeResult:
    """The plain PyTorch version of :func:`qc_fused_decode_batch_layered`,
    with the same contract, on any device. The wrapper runs it for CPU
    tensors; on the card it is the reference the kernel is held to."""
    c = _Call(llr, weights, qc, spec, max_iterations, dtype, closed_qdq,
              tpu_keys)
    post, ok = _plain_decode(c.x, c.tabs, qc, spec, c.T, c.closed)
    return c.result(post, None, ok, lean)


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
    """Layered-schedule whole decode of ``llr`` [B, n] (any B).

    ``dtype`` is the message storage type, bf16 or f32 (fp16 cannot hold
    the quantizer's 1e-30 sign floor). ``lean=True`` returns int8 bits and
    ``posterior=None``; otherwise int32 bits and the posterior in
    ``dtype``. ``closed_qdq`` forces the closed-form quantizer as in the
    JAX kernel. The JAX kernel's TPU-only keys ``batch_tile``, ``natural``
    and ``interpret`` are accepted and ignored, so existing ``qc_options``
    run unchanged; the CUDA kernel decodes one frame per thread block and
    needs no tiling.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    :func:`_fused_layered_plain`; any other device raises."""
    if llr.device.type == "cpu":
        return _fused_layered_plain(
            llr, weights, qc=qc, spec=spec, max_iterations=max_iterations,
            dtype=dtype, lean=lean, closed_qdq=closed_qdq, **tpu_keys)
    if llr.device.type != "cuda":
        raise ValueError(f"no fused layered decode for device {llr.device}")
    c = _Call(llr, weights, qc, spec, max_iterations, dtype, closed_qdq,
              tpu_keys)
    post, bits, ok = _launch(c.x, c.tabs, qc, spec, c.T, lean, c.closed)
    return c.result(post, bits, ok, lean)
