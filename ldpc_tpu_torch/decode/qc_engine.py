"""QC-structured decode engines: circulant rolls instead of gathers
(counterpart of ``ldpc_tpu/decode/qc_engine.py``).

``QCGraph`` and ``build_qc_graph`` are numpy copies. Check ``r`` of base
row ``row(b)`` connects to variable ``col(b)*lift + (r + shift(b)) % lift``
along block ``b``.

:func:`qc_decode_batch` (flooding) and :func:`qc_decode_batch_layered` are
the JAX package's XLA engines as plain PyTorch ops on whatever device the
LLRs are on, differentiable with respect to the weights (``ste`` and
``return_trajectory`` as in ``engine.decode_batch``). The layout is
JAX's: channel LLRs ``llr_T[nb, lift, B]`` and the variable-aligned
message state, one ``[lift, B]`` tile per block (kept as a list of tiles,
so no buffer is written in place), batch innermost; ``roll(x,
-shift(b))`` along the lift aligns block ``b``'s variables to its
checks. Each function rounds where
its JAX counterpart does under JAX's type promotion: a storage-type
(``dtype``) operation is a float32 operation rounded to ``dtype``, a
float32 weight or quantizer promotes to float32, and every check-node
result is cast to ``dtype`` once. With bf16 storage that matches
``ldpc_tpu`` compiled with ``xla_allow_excess_precision=False``.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Tuple

import numpy as np
import torch

from ldpc_tpu_torch.decode.engine import (DecodeResult, VariantSpec,
                                          _Freeze, _leave_one_out, _min_tree,
                                          _qdq_at, _syndrome_ok, _tables,
                                          _transform)

__all__ = ["QCGraph", "build_qc_graph", "qc_decode_batch",
           "qc_decode_batch_layered"]

# device copies of a graph's index tables, per device; an entry goes when
# its graph does
_GRAPH_TABLES: "weakref.WeakKeyDictionary[QCGraph, dict]" = \
    weakref.WeakKeyDictionary()


@dataclasses.dataclass(frozen=True, eq=False)
class QCGraph:
    """Static protograph structure of a QC-lifted code.

    Blocks are ordered row-major over the base matrix — the same (check,
    var)-major order as ``DecoderGraph`` edges, so per-edge weight-bucket
    vectors translate to per-block vectors by taking each block's first edge.
    """

    mb: int          # base rows
    nb: int          # base cols
    lift: int
    num_blocks: int
    block_row: np.ndarray    # [NB] int32
    block_col: np.ndarray    # [NB] int32
    block_shift: np.ndarray  # [NB] int32
    row_blocks: Tuple[Tuple[int, ...], ...]  # blocks per base row
    col_blocks: Tuple[Tuple[int, ...], ...]  # blocks per base col
    # per-block weight-bucket indices (same universes as DecoderGraph)
    block_dc_bucket: np.ndarray
    block_dv_bucket: np.ndarray
    block_dcdv_bucket: np.ndarray
    unique_dc: Tuple[int, ...]
    unique_dv: Tuple[int, ...]

    @property
    def n(self) -> int:
        return self.nb * self.lift

    @property
    def m(self) -> int:
        return self.mb * self.lift


def build_qc_graph(base_matrix: np.ndarray, lift: int) -> QCGraph:
    """Host-side analysis of a protograph (entries: -1 = zero block,
    s >= 0 = identity right-shifted by s, as ``codes.create_qc_code``)."""
    B = np.asarray(base_matrix, dtype=np.int64)
    mb, nb = B.shape
    rows, cols = np.nonzero(B >= 0)
    order = np.lexsort((cols, rows))  # row-major over the base matrix
    rows, cols = rows[order], cols[order]
    shifts = B[rows, cols] % lift

    row_deg = (B >= 0).sum(axis=1)
    col_deg = (B >= 0).sum(axis=0)
    # node degrees in the lifted graph equal base-row/-col degrees
    unique_dc = tuple(sorted(int(d) for d in np.unique(row_deg[row_deg > 0])))
    unique_dv = tuple(sorted(int(d) for d in np.unique(col_deg[col_deg > 0])))
    dc_to_bucket = {d: i for i, d in enumerate(unique_dc)}
    dv_to_bucket = {d: i for i, d in enumerate(unique_dv)}
    bdc = np.array([dc_to_bucket[int(row_deg[r])] for r in rows], np.int32)
    bdv = np.array([dv_to_bucket[int(col_deg[c])] for c in cols], np.int32)

    row_blocks = tuple(
        tuple(int(b) for b in np.flatnonzero(rows == i)) for i in range(mb))
    col_blocks = tuple(
        tuple(int(b) for b in np.flatnonzero(cols == j)) for j in range(nb))

    return QCGraph(
        mb=mb, nb=nb, lift=lift, num_blocks=len(rows),
        block_row=rows.astype(np.int32), block_col=cols.astype(np.int32),
        block_shift=shifts.astype(np.int32),
        row_blocks=row_blocks, col_blocks=col_blocks,
        block_dc_bucket=bdc, block_dv_bucket=bdv,
        block_dcdv_bucket=(bdc * len(unique_dv) + bdv).astype(np.int32),
        unique_dc=unique_dc, unique_dv=unique_dv,
    )


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


def _check_llr(llr, qc: QCGraph, dtype):
    """Refuse a storage type other than bf16 or f32 (fp16 cannot hold the
    quantizer's 1e-30 sign floor) and LLRs of another code length."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtype must be torch.bfloat16 or torch.float32, "
                         f"got {dtype}")
    if llr.shape[1] != qc.n:
        raise ValueError(f"llr has {llr.shape[1]} columns, the code has "
                         f"n={qc.n}")


def _storage(llr, qc: QCGraph, dtype):
    """``llr`` [B, n] as the per-column storage-type tiles [nb, L, B]."""
    _check_llr(llr, qc, dtype)
    return llr.to(dtype).T.contiguous().view(qc.nb, qc.lift, llr.shape[0])


def qc_decode_batch(
    llr: torch.Tensor,           # [B, n]
    weights,                     # {'beta': [T, n_beta] | None, 'alpha': ...}
    *,
    qc: QCGraph,
    spec: VariantSpec,
    max_iterations: int,
    ste: bool = False,
    return_trajectory: bool = False,
    check_every: int = 1,
    dtype: torch.dtype = torch.float32,
    unroll: bool = False,
) -> DecodeResult:
    """Flooding decode over the QC structure.

    ``check_every``: the syndrome is checked (and outputs frozen) after
    every chunk of that many iterations; it must divide T. ``dtype``: the
    message and posterior storage type, bf16 or f32. ``unroll`` (XLA
    tuning) is accepted and ignored. Returns int32 bits, the posterior in
    ``dtype``, per-frame iterations and success; with ``return_trajectory``
    also every iteration's posterior [T, B, n] (``check_every`` does not
    thin it)."""
    T = max_iterations
    if T % check_every:
        raise ValueError(f"check_every={check_every} must divide T={T}")
    llr_T = _storage(llr, qc, dtype)
    dev = llr.device
    tabs = _tables(weights, spec, T, qc.num_blocks, dev)
    shifts = [int(s) for s in qc.block_shift]
    f32 = torch.float32
    v2c = [llr_T[int(c)] for c in qc.block_col]

    def iteration(v2c, t):
        qdq = _qdq_at(spec, tabs, t, False, False, ste)
        vqdq = _qdq_at(spec, tabs, t, True, False, ste)
        beta, alpha = tabs["beta"][t], tabs["alpha"][t]
        # check-node update, per base row, in float32
        c2v = [None] * qc.num_blocks
        for blocks in qc.row_blocks:
            xs = [torch.roll(v2c[b], -shifts[b], dims=0).to(f32)
                  for b in blocks]
            tree = _min_tree(xs)
            for k, b in enumerate(blocks):
                loo_sign, loo_mag = _leave_one_out(*tree, k, xs[k])
                out = _transform(spec, qdq, beta[b], alpha[b], loo_sign,
                                 loo_mag)
                c2v[b] = torch.roll(out.to(dtype), shifts[b], dims=0)
        # variable-node update, per base column: sums in dtype
        new = [None] * qc.num_blocks
        posts = []
        for j, blocks in enumerate(qc.col_blocks):
            colsum = c2v[blocks[0]]
            for b in blocks[1:]:
                colsum = colsum + c2v[b]
            posts.append(llr_T[j] + colsum)
            for b in blocks:
                ext = colsum - c2v[b]
                if spec.alpha_in_cn:
                    nv = llr_T[j] + ext
                else:  # the float32 weight promotes the sum to float32
                    nv = llr_T[j].to(f32) + alpha[b] * ext.to(f32)
                new[b] = (vqdq(nv) if vqdq is not None else nv).to(dtype)
        post = torch.stack(posts)
        if vqdq is not None:
            post = vqdq(post).to(dtype)
        return new, post

    freeze = _Freeze(llr_T)
    traj = [] if return_trajectory else None
    for t in range(T):
        v2c, post = iteration(v2c, t)
        if (t + 1) % check_every == 0:
            freeze.check(post, _syndrome_ok(post, qc, lift_dim=0), t)
        if traj is not None:
            traj.append(post.reshape(qc.n, -1).T)
    return freeze.result(qc.n, traj)


def qc_decode_batch_layered(
    llr: torch.Tensor,           # [B, n]
    weights,
    *,
    qc: QCGraph,
    spec: VariantSpec,
    max_iterations: int,
    ste: bool = False,
    return_trajectory: bool = False,
    dtype: torch.dtype = torch.float32,
) -> DecodeResult:
    """Layered-schedule QC decode: base rows are the layers.

    A persistent per-block c2v memory and per-column sums in ``dtype``;
    row by row, fresh v2c messages are formed from the current sums, run
    through the check-node update, and folded back as
    ``colsum + (new - old)`` (the difference rounded first). The V2C
    quantizer applies to the posterior at each iteration's end; the
    syndrome is checked after every iteration. ``ste`` and
    ``return_trajectory`` as in :func:`qc_decode_batch`."""
    T = max_iterations
    llr_T = _storage(llr, qc, dtype)
    dev = llr.device
    tabs = _tables(weights, spec, T, qc.num_blocks, dev)
    shifts = [int(s) for s in qc.block_shift]
    cols = [int(c) for c in qc.block_col]
    f32 = torch.float32
    zero = torch.zeros(llr_T.shape[1:], dtype=dtype, device=dev)
    c2v = [zero] * qc.num_blocks
    colsum = [zero] * qc.nb
    freeze = _Freeze(llr_T)
    traj = [] if return_trajectory else None

    for t in range(T):
        qdq = _qdq_at(spec, tabs, t, False, False, ste)
        vqdq = _qdq_at(spec, tabs, t, True, False, ste)
        beta, alpha = tabs["beta"][t], tabs["alpha"][t]
        for blocks in qc.row_blocks:
            xs = []
            for b in blocks:
                j = cols[b]
                ext = colsum[j] - c2v[b]
                if spec.alpha_in_cn:
                    nv = llr_T[j] + ext
                else:
                    nv = llr_T[j].to(f32) + alpha[b] * ext.to(f32)
                xs.append(torch.roll(nv.to(f32), -shifts[b], dims=0))
            tree = _min_tree(xs)
            for k, b in enumerate(blocks):
                loo_sign, loo_mag = _leave_one_out(*tree, k, xs[k])
                out = _transform(spec, qdq, beta[b], alpha[b], loo_sign,
                                 loo_mag)
                new = torch.roll(out, shifts[b], dims=0).to(dtype)
                j = cols[b]
                colsum[j] = colsum[j] + (new - c2v[b])
                c2v[b] = new
        post = llr_T + torch.stack(colsum)
        if vqdq is not None:
            post = vqdq(post).to(dtype)
        freeze.check(post, _syndrome_ok(post, qc, lift_dim=0), t)
        if traj is not None:
            traj.append(post.reshape(qc.n, -1).T)
    return freeze.result(qc.n, traj)
