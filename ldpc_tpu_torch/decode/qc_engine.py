"""QC protograph structure (a numpy copy of ``ldpc_tpu/decode/qc_engine.py``'s
``QCGraph`` and ``build_qc_graph``).

Check ``r`` of base row ``row(b)`` connects to variable
``col(b)*lift + (r + shift(b)) % lift`` along block ``b``. The torch QC
engines (``qc_decode_batch``, ``qc_decode_batch_layered``: the training
path) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["QCGraph", "build_qc_graph"]


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
