"""Degree-bucketed decode engine: the irregular-code fast path (counterpart
of ``ldpc_tpu/decode/bucketed_engine.py``).

The general flooding engine (``engine.decode_batch``) pads every check to
the largest check degree and every variable to the largest variable
degree. Here edges are laid out twice, once sorted by (check degree,
check, slot) and once by (variable degree, variable, slot). In each order
every same-degree group is a contiguous block that views as
``[nodes_d, d, B]``, so the check-node min tree and the variable-node
column sum run without slot tables, masks or padding, and the only
per-iteration gathers are the two ``[E, B]`` permutations between the
orders. ``BucketedGraph`` and ``build_bucketed_graph`` are numpy copies.

:func:`bucketed_decode_batch` runs as plain PyTorch ops on ``llr``'s
device, differentiable with respect to the weights (``ste`` and
``return_trajectory`` as in ``engine.decode_batch``). Its semantics are
``decode_batch``'s, with the ``check_every`` freezing granularity; a
node's messages are added one by one in slot order, as in the general
engine, so in float32 the two give the same results (up to the sign of a
zero sum). ``dtype`` is the message
state's storage type, bf16 or f32: the state is rounded to it only at the
two ``[E, B]`` permutations, and all arithmetic runs in float32.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Tuple

import numpy as np
import torch

from ldpc_tpu_torch.codes import DecoderGraph
from ldpc_tpu_torch.decode.engine import (DecodeResult, VariantSpec, _Freeze,
                                          _check_llr_general, _cn_loo,
                                          _parity_ok, _qdq_at, _tables,
                                          _transform)

__all__ = ["BucketedGraph", "build_bucketed_graph", "bucketed_decode_batch"]

# device copies of a bucketed graph's index tables, per device; an entry
# goes when its graph does
_BG_TABLES: "weakref.WeakKeyDictionary[BucketedGraph, dict]" = \
    weakref.WeakKeyDictionary()


@dataclasses.dataclass(frozen=True, eq=False)
class BucketedGraph:
    """Degree-bucketed edge layouts for one code (host-side, static)."""

    graph: DecoderGraph
    # CN-sorted order: edges sorted by (check degree, check id, slot)
    cn_buckets: Tuple[Tuple[int, int, int], ...]  # (degree, n_checks, offset)
    cn_order: np.ndarray       # [E] edge id at each CN-sorted position
    # VN-sorted order: edges sorted by (var degree, var id, slot)
    vn_buckets: Tuple[Tuple[int, int, int], ...]  # (degree, n_vars, offset)
    vn_order: np.ndarray       # [E] edge id at each VN-sorted position
    cn_to_vn: np.ndarray       # [E] perm: vn_pos -> cn_pos
    vn_to_cn: np.ndarray       # [E] perm: cn_pos -> vn_pos
    var_order: np.ndarray      # [n] variable id at each sorted-var position
    var_rank: np.ndarray       # [n] sorted position of each variable
    llr_edge_var: np.ndarray   # [n] == var_order (llr rows per sorted var)
    cn_var_slots_sorted: np.ndarray  # [m, max_dc] sorted-var ids, pad n


def build_bucketed_graph(graph: DecoderGraph) -> BucketedGraph:
    """Precompute the two degree-sorted edge layouts (host-side)."""
    E = graph.num_edges

    # CN order: stable sort of edges by (check degree, check id); within a
    # check, edge ids are already in slot order (row-major build)
    cdeg_e = graph.check_degree[graph.edge_check]
    cn_order = np.lexsort((np.arange(E), graph.edge_check, cdeg_e))
    cn_buckets = []
    off = 0
    for d in graph.unique_dc:
        cnt = int((graph.check_degree == d).sum())
        cn_buckets.append((int(d), cnt, off))
        off += cnt * d
    assert off == E

    vdeg_e = graph.var_degree[graph.edge_var]
    vn_order = np.lexsort((np.arange(E), graph.edge_var, vdeg_e))
    vn_buckets = []
    off = 0
    for d in graph.unique_dv:
        cnt = int((graph.var_degree == d).sum())
        vn_buckets.append((int(d), cnt, off))
        off += cnt * d
    assert off == E

    pos_in_cn = np.empty(E, np.int64)
    pos_in_cn[cn_order] = np.arange(E)
    pos_in_vn = np.empty(E, np.int64)
    pos_in_vn[vn_order] = np.arange(E)
    # cn_to_vn[p] = CN-sorted position of the edge at VN-sorted position p
    cn_to_vn = pos_in_cn[vn_order].astype(np.int32)
    vn_to_cn = pos_in_vn[cn_order].astype(np.int32)

    var_order = np.lexsort((np.arange(graph.n), graph.var_degree)).astype(
        np.int32)
    var_rank = np.empty(graph.n, np.int32)
    var_rank[var_order] = np.arange(graph.n, dtype=np.int32)
    # syndrome in sorted-var space: remap slot table entries (pad n -> n)
    var_rank_ext = np.concatenate([var_rank, np.int32([graph.n])])
    cn_var_slots_sorted = var_rank_ext[graph.cn_var_slots].astype(np.int32)

    return BucketedGraph(
        graph=graph,
        cn_buckets=tuple(cn_buckets), cn_order=cn_order.astype(np.int32),
        vn_buckets=tuple(vn_buckets), vn_order=vn_order.astype(np.int32),
        cn_to_vn=cn_to_vn, vn_to_cn=vn_to_cn,
        var_order=var_order, var_rank=var_rank,
        llr_edge_var=var_order,
        cn_var_slots_sorted=cn_var_slots_sorted,
    )


def _bg_tables(bg: BucketedGraph, device) -> dict:
    """int64 index tables of ``bg`` on ``device``: the permutations, the
    variable order and rank, ``llr_vn`` [E] (the sorted variable of each
    VN-sorted edge), the syndrome slots [m * max_dc] and the slot iota."""
    per = _BG_TABLES.setdefault(bg, {})
    device = torch.device(device)
    if device not in per:
        def ints(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int64),
                                   device=device)

        # the sorted variable of each VN-sorted edge
        rows = bg.var_rank[bg.graph.edge_var[bg.vn_order]]
        dmax = max(d for d, _, _ in bg.cn_buckets)
        per[device] = dict(
            cn_order=ints(bg.cn_order), vn_order=ints(bg.vn_order),
            cn_to_vn=ints(bg.cn_to_vn), vn_to_cn=ints(bg.vn_to_cn),
            var_order=ints(bg.var_order), var_rank=ints(bg.var_rank),
            llr_vn=ints(rows),
            syn=ints(bg.cn_var_slots_sorted.reshape(-1)),
            iota=torch.arange(dmax, device=device).view(1, -1, 1))
    return per[device]


def bucketed_decode_batch(
    llr: torch.Tensor,           # [B, n]
    weights,                     # {'beta': [T, n_beta] | None, 'alpha': ...}
    *,
    bg: BucketedGraph,
    spec: VariantSpec,
    max_iterations: int,
    ste: bool = False,
    return_trajectory: bool = False,
    check_every: int = 1,
    dtype: torch.dtype = torch.float32,
) -> DecodeResult:
    """Flooding decode via degree buckets; contract == ``decode_batch``
    with ``check_every`` freezing granularity (the syndrome is checked,
    and outputs frozen, after every chunk of that many iterations; it must
    divide T), which does not thin the trajectory.

    ``dtype`` is the message-state storage type, bf16 or f32 (fp16 cannot
    hold the quantizer's 1e-30 sign floor): the check-node output and the
    variable-node output are rounded to it before their permutation, and
    all check- and variable-node arithmetic runs in float32. Returns int32
    bits, the float32 posterior, iterations and success."""
    T = max_iterations
    if T % check_every:
        raise ValueError(f"check_every={check_every} must divide T={T}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dtype must be torch.bfloat16 or torch.float32, "
                         f"got {dtype}")
    graph = bg.graph
    _check_llr_general(llr, graph)
    dev, B, f32 = llr.device, llr.shape[0], torch.float32
    g = _bg_tables(bg, dev)
    tabs = _tables(weights, spec, T, graph.num_edges, dev)
    # per-edge weights of every iteration in the CN and the VN order (the
    # JAX engine's _perm_weights, applied to the device tables)
    beta_cn = tabs["beta"].index_select(1, g["cn_order"])
    alpha_cn = tabs["alpha"].index_select(1, g["cn_order"])
    alpha_vn = tabs["alpha"].index_select(1, g["vn_order"])
    llr_s = llr.to(f32).T.index_select(0, g["var_order"])  # [n, B] sorted
    v2c_cn = llr_s.index_select(0, g["llr_vn"]).to(dtype).index_select(
        0, g["vn_to_cn"])

    def cn_update(v2c_cn, t, qdq):
        """All CN buckets; returns c2v in CN-sorted order (float32)."""
        outs = []
        for d, cnt, off in bg.cn_buckets:
            msgs = v2c_cn[off:off + cnt * d].view(cnt, d, B).to(f32)
            loo_sign, loo_mag = _cn_loo(msgs, None, g["iota"][:, :d], False)
            bb = beta_cn[t, off:off + cnt * d].view(cnt, d, 1)
            ab = (alpha_cn[t, off:off + cnt * d].view(cnt, d, 1)
                  if spec.alpha_in_cn and spec.alpha_idx is not None
                  else 0.0)
            outs.append(_transform(spec, qdq, bb, ab, loo_sign,
                                   loo_mag).view(cnt * d, B))
        return torch.cat(outs)

    def vn_update(c2v_vn, t, vqdq):
        """All VN buckets; returns (v2c VN-sorted, posterior sorted-var),
        each column sum added one message at a time in slot order."""
        v2c_parts, post_parts = [], []
        voff = 0
        for d, cnt, off in bg.vn_buckets:
            msgs = c2v_vn[off:off + cnt * d].view(cnt, d, B).to(f32)
            colsum = msgs[:, 0]
            for k in range(1, d):
                colsum = colsum + msgs[:, k]
            rows = llr_s[voff:voff + cnt]
            post_parts.append(rows + colsum)
            ext = colsum[:, None, :] - msgs
            if spec.alpha_in_cn:
                v2c = rows[:, None, :] + ext
            else:
                v2c = rows[:, None, :] + alpha_vn[
                    t, off:off + cnt * d].view(cnt, d, 1) * ext
            if vqdq is not None:
                v2c = vqdq(v2c)
            v2c_parts.append(v2c.view(cnt * d, B))
            voff += cnt
        post = torch.cat(post_parts)
        if vqdq is not None:
            post = vqdq(post)
        return torch.cat(v2c_parts), post

    freeze = _Freeze(llr_s)
    traj = [] if return_trajectory else None
    for t in range(T):
        qdq = _qdq_at(spec, tabs, t, False, False, ste)
        vqdq = _qdq_at(spec, tabs, t, True, False, ste)
        c2v_vn = cn_update(v2c_cn, t, qdq).to(dtype).index_select(
            0, g["cn_to_vn"])
        v2c_vn, post_s = vn_update(c2v_vn, t, vqdq)
        v2c_cn = v2c_vn.to(dtype).index_select(0, g["vn_to_cn"])
        if (t + 1) % check_every == 0:
            freeze.check(post_s, _parity_ok(post_s < 0, g["syn"], graph.m),
                         t)
        if traj is not None:
            traj.append(post_s.index_select(0, g["var_rank"]).T)
    # sorted -> real variable order
    freeze.post = freeze.post.index_select(0, g["var_rank"])
    return freeze.result(graph.n, traj)
