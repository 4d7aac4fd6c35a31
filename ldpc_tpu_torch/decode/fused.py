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
  update and folds the new c2v back. The kernel keeps the c2v memory
  compressed per check, on chip where it fits and otherwise in a
  per-frame device scratch.

Both have the check-at-the-end contract: the returned posterior is
iteration T's, ``success`` is its syndrome (K3), ``iterations`` is T for
every frame. Any lift whose frame state fits the card's shared memory
(K1: whose LLRs, column sums and tables fit) decodes: a block has one
thread per check or variable of a base row or column up to lift 1024,
and 1024 threads that each take several above it.

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

import torch

from ldpc_tpu_torch.decode.engine import (DecodeResult, VariantSpec,
                                          _leave_one_out, _min_tree, _qdq_at,
                                          _syndrome_ok, _tables, _transform,
                                          qdq_mode)
from ldpc_tpu_torch.decode.qc_engine import (QCGraph, _check_llr,
                                             _graph_tables)

__all__ = ["qc_fused_decode_batch", "qc_fused_decode_batch_layered",
           "LAYERED_LAUNCHES", "FLOODING_LAUNCHES"]

# launches of each CUDA kernel (the plain versions never count)
LAYERED_LAUNCHES = 0   # K1, csrc/fused_layered.cu
FLOODING_LAUNCHES = 0  # K4, csrc/fused_flooding.cu

_TPU_KEYS = frozenset({"batch_tile", "natural", "interpret"})
_KINDS = {"nms": 0, "oms": 1, "rcq": 2, "wrcq": 3, "orcq": 4}
_QMODES = {"staircase": 0, "uniform": 1, "power": 2}


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
                loo_sign, loo_mag = _leave_one_out(min1, min2, argm, neg_cnt,
                                                   k, xs[k])
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
    is_bf16 = int(llr.dtype == torch.bfloat16)
    q_mode = qdq_mode(spec.qparams, spec.q_levels, closed)
    v_mode = qdq_mode(spec.v2c_qparams, spec.v2c_levels, closed)
    lib = load_library()
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    modes = (_QMODES[q_mode], spec.q_levels, _QMODES[v_mode], spec.v2c_levels)
    # both keep the LLRs, the column sums and a compressed check state on
    # chip (the layout is the library's); where layered's check state does
    # not fit, it goes to a per-frame scratch in device memory
    state_bytes = 0
    if flooding:
        smem = lib.ldpc_fused_flooding_smem(qc.nb, qc.mb, qc.num_blocks, L,
                                            is_bf16, *modes)
    else:
        dcmax = max(len(r) for r in qc.row_blocks)
        sizes = (qc.nb, qc.mb, qc.num_blocks, L, dcmax, is_bf16, *modes)
        smem = lib.ldpc_fused_layered_smem(*sizes, 1)
        if smem > limit:
            smem = lib.ldpc_fused_layered_smem(*sizes, 0)
            state_bytes = lib.ldpc_fused_layered_state_bytes(*sizes)
    if smem > limit:
        raise ValueError(f"kernel needs {smem} B of shared memory per frame, "
                         f"the card allows {limit} B")
    g = _graph_tables(qc, dev)
    post = None if lean else torch.empty((B, n), dtype=llr.dtype, device=dev)
    bits = torch.empty((B, n), dtype=torch.int8, device=dev) if lean else None
    ok = torch.empty((B,), dtype=torch.uint8, device=dev)
    if B == 0:
        return post, bits, ok.bool()
    with_vqdq = (spec.v2c_qparams is not None or
                 spec.v2c_thresholds is not None)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr()) if x is not None else None
    tables = [ptr(tabs["beta"]), ptr(tabs["alpha"]),
              ptr(tabs["thr"]), tabs["thr"].shape[1], ptr(tabs["qp"]),
              ptr(tabs["vthr"]), tabs["vthr"].shape[1], ptr(tabs["vqp"])]
    variant = [_KINDS[spec.kind], int(spec.alpha_in_cn), _QMODES[q_mode],
               spec.q_levels, int(with_vqdq), _QMODES[v_mode],
               spec.v2c_levels,
               ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)]
    with torch.cuda.device(dev):  # the launch goes to the current device
        if flooding:
            err = lib.ldpc_fused_flooding(
                ptr(llr), ptr(post), ptr(bits), ptr(ok), *tables,
                *[ptr(g[k]) for k in ("row_ptr", "col_ptr", "col_blocks",
                                      "block_col", "block_shift")],
                B, qc.nb, qc.mb, qc.num_blocks, L, T, is_bf16, *variant)
        else:
            state = (torch.empty((B, state_bytes), dtype=torch.uint8,
                                 device=dev) if state_bytes else None)
            err = lib.ldpc_fused_layered(
                ptr(llr), ptr(post), ptr(bits), ptr(ok), ptr(state), *tables,
                *[ptr(g[k]) for k in ("row_ptr", "block_col",
                                      "block_shift")],
                B, qc.nb, qc.mb, qc.num_blocks, L, T, dcmax, is_bf16,
                *variant)
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
        _check_llr(llr, qc, dtype)
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

