"""The flooding QC decode through one kernel per base row and one per base
column (counterpart of ``ldpc_tpu/decode/pallas_qc.py``).

Each iteration launches K5 (``csrc/qc_cn.cu``, plain version
:func:`_cn_row_plain`) once per base row, then K6 (``csrc/qc_vn.cu``, plain
version :func:`_vn_col_plain`) once per base column, over the message
state in device memory. The layout is JAX's: the channel LLRs
``llr_T[nb, L, B]`` and the variable-aligned states ``v2c``/``c2v``
``[NB, L, B]``, batch innermost.

- K5, row ``i``: for each check ``u`` of the row, the min-sum update over
  the row's blocks, reading ``v2c[b][(u + s_b) % L]`` and writing
  ``c2v[b][(u + s_b) % L]`` (the circulant rolls are row offsets): min1,
  min2 and first argmin with strict ``<``, negative-count parity, the
  variant transform and the RCQ quantizer in float32, one cast to the
  storage type.
- K6, column ``j``: reads the column's c2v blocks in place, sums them in
  float32 in ``col_blocks`` order, forms ``llr + alpha*(colsum - c2v)``
  (``llr + (colsum - c2v)`` for the OMS kinds) and the posterior
  ``llr + colsum`` in float32, applies the V2C quantizer and casts once.
  The engine (``qc_engine.qc_decode_batch``) instead rounds the column
  sum, the posterior and the extrinsic to the storage type, so in bf16 the
  two paths differ slightly; in f32 they agree to rounding.

The kernels' quantizer routing is ``pallas_qc._kernel_qdq``'s, not the
engine's: the staircase LUT whenever the LUT has at most 16 levels (even
with ``closed_qdq``), the power law above (even when every gamma is 1).

Around the kernels, :func:`qc_pallas_decode_batch` runs ``ldpc_tpu``'s
driver as torch ops: ``check_every`` chunks, the syndrome of the last
posterior of each chunk, and convergence freezing. A CUDA tensor launches
the kernels (or raises); a CPU tensor, and only that, runs the plain
versions.
"""

from __future__ import annotations

import ctypes

import torch

from ldpc_tpu_torch.decode.engine import (DecodeResult, VariantSpec,
                                          _Freeze, _leave_one_out, _min_tree,
                                          _syndrome_ok, _tables, _transform)
from ldpc_tpu_torch.decode.fused import _KINDS, _QMODES
from ldpc_tpu_torch.decode.qc_engine import (QCGraph, _graph_tables,
                                             _storage)
from ldpc_tpu_torch.quantizer import power_qdq, staircase_qdq

__all__ = ["qc_pallas_decode_batch", "CN_LAUNCHES", "VN_LAUNCHES"]

# launches of each CUDA kernel (the plain versions never count)
CN_LAUNCHES = 0  # K5, csrc/qc_cn.cu
VN_LAUNCHES = 0  # K6, csrc/qc_vn.cu


def _qdq_mode(levels: int) -> str:
    return "staircase" if levels <= 16 else "power"


def _kernel_qdq(levels: int, thr, qp):
    """``pallas_qc._kernel_qdq``: this iteration's quantizer with ``levels``
    levels, LUT row ``thr`` and (C, gamma) ``qp``."""
    if _qdq_mode(levels) == "staircase":
        return lambda v: staircase_qdq(v, thr)
    return lambda v: power_qdq(v, qp[0], qp[1], levels)


def _with_vqdq(spec: VariantSpec) -> bool:
    return spec.v2c_qparams is not None or spec.v2c_thresholds is not None


def _cn_row_plain(v2c, c2v, tabs, qc: QCGraph, spec: VariantSpec, row: int,
                  t: int):
    """K5's computation in PyTorch ops: base row ``row``'s c2v messages at
    iteration ``t``, from ``v2c`` into ``c2v`` ([NB, L, B], storage type)."""
    blocks = qc.row_blocks[row]
    shifts = [int(qc.block_shift[b]) for b in blocks]
    qdq = _kernel_qdq(spec.q_levels, tabs["thr"][t], tabs["qp"][t])
    xs = [torch.roll(v2c[b], -s, dims=0).to(torch.float32)
          for b, s in zip(blocks, shifts)]
    tree = _min_tree(xs)
    for k, (b, s) in enumerate(zip(blocks, shifts)):
        loo_sign, loo_mag = _leave_one_out(*tree, k, xs[k])
        out = _transform(spec, qdq, tabs["beta"][t, b], tabs["alpha"][t, b],
                         loo_sign, loo_mag)
        c2v[b] = torch.roll(out.to(c2v.dtype), s, dims=0)


def _vn_col_plain(c2v, llr_T, v2c, post, tabs, qc: QCGraph,
                  spec: VariantSpec, col: int, t: int):
    """K6's computation in PyTorch ops: base column ``col``'s v2c messages
    (into ``v2c``) and posterior (into ``post[col]``) at iteration ``t``,
    from ``c2v`` [NB, L, B] and ``llr_T`` [nb, L, B]."""
    blocks = qc.col_blocks[col]
    f32 = torch.float32
    vqdq = (_kernel_qdq(spec.v2c_levels, tabs["vthr"][t], tabs["vqp"][t])
            if _with_vqdq(spec) else None)
    llr = llr_T[col].to(f32)
    cs = [c2v[b].to(f32) for b in blocks]
    colsum = cs[0]
    for c in cs[1:]:
        colsum = colsum + c
    for k, b in enumerate(blocks):
        ext = colsum - cs[k]
        nv = (llr + ext if spec.alpha_in_cn
              else llr + tabs["alpha"][t, b] * ext)
        v2c[b] = vqdq(nv) if vqdq is not None else nv
    p = llr + colsum
    post[col] = vqdq(p) if vqdq is not None else p


def _check_state(*xs):
    dev, dtype, shape = xs[0].device, xs[0].dtype, xs[0].shape[1:]
    for x in xs:
        if x.device != dev or x.dtype != dtype or x.shape[1:] != shape or \
                not x.is_contiguous():
            raise ValueError("K5/K6 states must be contiguous [*, L, B] "
                             "tensors of one dtype on one device")


def _ptr(x, offset=0):
    return ctypes.c_void_p(x.data_ptr() + offset * x.element_size())


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def cn_row(v2c, c2v, tabs, qc: QCGraph, spec: VariantSpec, row: int, t: int):
    """K5 on base row ``row`` at iteration ``t``: writes the row's blocks of
    ``c2v`` from ``v2c`` ([NB, L, B], bf16 or f32). A CPU tensor runs
    :func:`_cn_row_plain`; a CUDA tensor launches the kernel or raises."""
    global CN_LAUNCHES
    if v2c.device.type == "cpu":
        return _cn_row_plain(v2c, c2v, tabs, qc, spec, row, t)
    if v2c.device.type != "cuda":
        raise ValueError(f"no K5 kernel for device {v2c.device}")
    _check_state(v2c, c2v)
    from ldpc_tpu_torch.decode._build import load_library

    blocks = qc.row_blocks[row]
    NB, L, B = v2c.shape
    if B == 0:
        return
    g = _graph_tables(qc, v2c.device)
    with torch.cuda.device(v2c.device):
        err = load_library().ldpc_qc_cn(
            _ptr(v2c), _ptr(c2v), _ptr(tabs["beta"]), _ptr(tabs["alpha"]),
            _ptr(tabs["thr"]), tabs["thr"].shape[1], _ptr(tabs["qp"]),
            _ptr(g["block_shift"]), blocks[0], len(blocks), NB, L, B, t,
            int(v2c.dtype == torch.bfloat16), _KINDS[spec.kind],
            int(spec.alpha_in_cn), _QMODES[_qdq_mode(spec.q_levels)],
            spec.q_levels, _stream(v2c.device))
    if err != 0:
        raise RuntimeError(f"K5 (qc_cn) launch failed: CUDA error {err}")
    CN_LAUNCHES += 1


def vn_col(c2v, llr_T, v2c, post, tabs, qc: QCGraph, spec: VariantSpec,
           col: int, t: int):
    """K6 on base column ``col`` at iteration ``t``: writes the column's
    blocks of ``v2c`` and ``post[col]`` from ``c2v`` and ``llr_T``. A CPU
    tensor runs :func:`_vn_col_plain`; a CUDA tensor launches the kernel
    or raises."""
    global VN_LAUNCHES
    if c2v.device.type == "cpu":
        return _vn_col_plain(c2v, llr_T, v2c, post, tabs, qc, spec, col, t)
    if c2v.device.type != "cuda":
        raise ValueError(f"no K6 kernel for device {c2v.device}")
    _check_state(c2v, v2c, llr_T, post)
    from ldpc_tpu_torch.decode._build import load_library

    NB, L, B = c2v.shape
    if B == 0:
        return
    g = _graph_tables(qc, c2v.device)
    c0 = sum(len(c) for c in qc.col_blocks[:col])
    with torch.cuda.device(c2v.device):
        err = load_library().ldpc_qc_vn(
            _ptr(c2v), _ptr(llr_T), _ptr(v2c), _ptr(post),
            _ptr(tabs["alpha"]), _ptr(tabs["vthr"]), tabs["vthr"].shape[1],
            _ptr(tabs["vqp"]), _ptr(g["col_blocks"], c0), col,
            len(qc.col_blocks[col]), NB, L, B, t,
            int(c2v.dtype == torch.bfloat16), int(spec.alpha_in_cn),
            int(_with_vqdq(spec)), _QMODES[_qdq_mode(spec.v2c_levels)],
            spec.v2c_levels, _stream(c2v.device))
    if err != 0:
        raise RuntimeError(f"K6 (qc_vn) launch failed: CUDA error {err}")
    VN_LAUNCHES += 1


def _decode(llr, weights, qc: QCGraph, spec: VariantSpec, T: int,
            check_every: int, dtype, batch_tile: int, plain: bool):
    if T % check_every:
        raise ValueError(f"check_every={check_every} must divide T={T}")
    B = llr.shape[0]
    if B % batch_tile:
        raise ValueError(f"batch {B} not divisible by tile {batch_tile}")
    row, col = (_cn_row_plain, _vn_col_plain) if plain else (cn_row, vn_col)
    llr_T = _storage(llr, qc, dtype)
    dev = llr.device
    tabs = _tables(weights, spec, T, qc.num_blocks, dev)
    v2c = llr_T.index_select(0, _graph_tables(qc, dev)["block_col"])
    c2v = torch.empty_like(v2c)
    post = torch.empty_like(llr_T)
    freeze = _Freeze(llr_T)
    for t in range(T):
        for i in range(qc.mb):
            row(v2c, c2v, tabs, qc, spec, i, t)
        for j in range(qc.nb):
            col(c2v, llr_T, v2c, post, tabs, qc, spec, j, t)
        if (t + 1) % check_every == 0:
            freeze.check(post, _syndrome_ok(post, qc, lift_dim=0), t)
    return freeze.result(qc.n)


def _qc_pallas_plain(llr, weights, *, qc: QCGraph, spec: VariantSpec,
                     max_iterations: int, check_every: int = 1,
                     dtype=torch.bfloat16, batch_tile: int = 128,
                     interpret: bool = False,
                     unroll: bool = False) -> DecodeResult:
    """The plain PyTorch version of :func:`qc_pallas_decode_batch`, with the
    same contract, on any device: the same driver with the plain K5/K6.
    The wrapper runs it for CPU tensors; on the card it is the reference
    the kernels are held to."""
    return _decode(llr, weights, qc, spec, max_iterations, check_every,
                   dtype, batch_tile, plain=True)


def qc_pallas_decode_batch(
    llr: torch.Tensor,           # [B, n]
    weights,                     # {'beta': [T, n_beta] | None, 'alpha': ...}
    *,
    qc: QCGraph,
    spec: VariantSpec,
    max_iterations: int,
    check_every: int = 1,
    dtype: torch.dtype = torch.bfloat16,
    batch_tile: int = 128,
    interpret: bool = False,
    unroll: bool = False,
) -> DecodeResult:
    """Flooding QC decode of ``llr`` [B, n] through K5 and K6 (inference).

    The contract is ``ldpc_tpu``'s: ``check_every`` must divide T and sets
    the syndrome-check and freezing granularity; B must be a multiple of
    ``batch_tile`` (the TPU kernels' tile), else ``ValueError``; the CUDA
    kernels pick their own thread blocks. ``interpret`` and ``unroll`` are
    accepted and ignored. ``dtype`` is the message storage type, bf16 or
    f32. Returns int32 bits, the posterior in ``dtype``, per-frame
    iterations and success.

    A CUDA tensor launches the kernels (or raises); a CPU tensor runs
    :func:`_qc_pallas_plain`; any other device raises."""
    if llr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no K5/K6 decode for device {llr.device}")
    return _decode(llr, weights, qc, spec, max_iterations, check_every,
                   dtype, batch_tile, plain=llr.device.type == "cpu")
