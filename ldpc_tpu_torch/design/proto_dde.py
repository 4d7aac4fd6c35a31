"""Protograph (multi-edge-type) density evolution, layered-aware.

``dde.density_evolution`` models the unstructured ensemble of a degree
profile under FLOODING — good for fast ladder ranking, but the shipped
bench decoder is a *protograph* code decoded with the *layered* schedule
(qc_engine.qc_decode_batch_layered / pallas_fused layered kernel). This
module tracks one message density PER PROTOGRAPH EDGE, so it captures:

- the exact base-matrix structure (degree assignments per edge, not an
  averaged mixture) — lifting to any circulant size leaves protograph DE
  unchanged (cycles excepted, as always for DE);
- PUNCTURED columns (PBRL rate-compatible codes transmit the degree-1 IR
  bits but puncture the high-degree precode bits — ``codes.py``
  ``create_pbrl_qc_protograph``): a punctured column's channel pmf is a
  delta at LLR 0;
- the LAYERED schedule exactly: rows are processed in order within an
  iteration, each row's fresh v2c densities formed from the CURRENT
  c2v state of the other rows (mirroring ``qc_engine.py``'s persistent
  c2v memory + incremental column sums; v2c is NOT bv-quantized
  mid-iteration — only the posterior is, matching the engines).

All pmf machinery (grid, tie-aware min/sign combine, sparse/FFT signed
convolution, snap-down qdq index maps) is shared with ``dde``.

This is a numpy copy of ``ldpc_tpu/design/proto_dde.py`` (the port imports no
JAX); ``tests/test_torch_design.py`` holds the two equal.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from ldpc_tpu_torch.quantizer import (phase_schedule, power_thresholds,
                                      power_thresholds_for_levels)

from ldpc_tpu_torch.design.dde import (
    DEResult,
    _bit_error_cut,
    _channel_pmf_signed,
    _cn_combine,
    _conv_signed,
    _make_grid,
    _qdq_index_map,
    _quantile_mag,
    _remap_mag,
    _sched_luts,
    _signed,
    _unsigned,
)

__all__ = ["protograph_density_evolution", "analyze_decoder",
           "refine_ladders_protograph", "design_dynamic_quantizers"]


def _loo_folds(pmfs):
    """Leave-one-out (sign, min)-folds of a list of magnitude pmfs via
    prefix/suffix combines: out[k] = fold of all pmfs except k."""
    d = len(pmfs)
    if d == 1:
        # degree-1 check reflects the input (engine min2=min1 behavior)
        return [pmfs[0]]
    pre = [None] * d
    suf = [None] * d
    pre[0] = pmfs[0]
    for k in range(1, d):
        pre[k] = _cn_combine(*pre[k - 1], *pmfs[k])
    suf[d - 1] = pmfs[d - 1]
    for k in range(d - 2, -1, -1):
        suf[k] = _cn_combine(*pmfs[k], *suf[k + 1])
    out = [None] * d
    out[0] = suf[1]
    out[d - 1] = pre[d - 2]
    for k in range(1, d - 1):
        out[k] = _cn_combine(*pre[k - 1], *suf[k + 1])
    return out


def protograph_density_evolution(
    base: np.ndarray,
    *,
    snr_db: float,
    max_iterations: int,
    kind: str = "rcq",
    beta=0.0,
    alpha=1.0,
    alpha_in_cn: bool = False,
    bc: Optional[int] = None,
    quantizer_params: Optional[Sequence[Tuple[float, float]]] = None,
    bv: Optional[int] = None,
    v2c_quantizer_params: Optional[Sequence[Tuple[float, float]]] = None,
    c_luts: Optional[Sequence[np.ndarray]] = None,
    v_luts: Optional[Sequence[np.ndarray]] = None,
    schedule: str = "layered",
    punctured_cols: Sequence[int] = (),
    grid_step: float = 1.0 / 64.0,
    grid_max: Optional[float] = None,
    quantile: float = 0.995,
) -> DEResult:
    """Per-edge DE on a protograph ``base`` (entries < 0 = empty block).

    ``schedule``: 'flooding' or 'layered' (base rows in order — the
    engines' layer order). ``punctured_cols``: base columns transmitted
    with no channel observation (LLR 0). ``error_prob[t]`` averages the
    posterior bit-error over ALL base columns (punctured included — they
    are decoded bits), matching the engines' bit counting.

    ``beta`` / ``alpha`` may be scalars or per-(iteration, edge) arrays
    of shape [T, E] (edges in base row-major order — QCGraph block
    order), so TRAINED degree-shared decoders analyze exactly;
    ``alpha_in_cn`` selects the OMS-style second CN offset vs the
    NMS-style VN extrinsic scaling (``VariantSpec.alpha_in_cn``).
    ``c_luts``/``v_luts`` (one [L] threshold array per iteration)
    override the (bc, quantizer_params)-derived schedule — pass
    ``spec.thresholds`` rows to reproduce a built decoder exactly.
    Use :func:`analyze_decoder` to derive every argument from a
    ``Decoder``.
    """
    base = np.asarray(base)
    mb, nb = base.shape
    T = max_iterations
    sigma2 = 10.0 ** (-snr_db / 10.0)
    mu = 2.0 / sigma2
    sd = 2.0 / math.sqrt(sigma2)

    edges = [(r, c) for r in range(mb) for c in range(nb) if base[r, c] >= 0]
    E = len(edges)
    eidx = {e: i for i, e in enumerate(edges)}
    row_edges = [[eidx[(r, c)] for c in range(nb) if base[r, c] >= 0]
                 for r in range(mb)]
    col_edges = [[eidx[(r, c)] for r in range(mb) if base[r, c] >= 0]
                 for c in range(nb)]
    for c, es in enumerate(col_edges):
        if not es:
            raise ValueError(f"base column {c} has no checks")
    punct = set(int(c) for c in punctured_cols)

    beta = np.asarray(beta, dtype=np.float64)
    alpha = np.asarray(alpha, dtype=np.float64)
    if beta.ndim not in (0, 2) or alpha.ndim not in (0, 2):
        raise ValueError("beta/alpha must be scalars or [T, E] arrays")

    def wt(tab, t, e):
        return float(tab[t, e]) if tab.ndim == 2 else float(tab)

    if c_luts is None:
        c_luts = _sched_luts(quantizer_params, bc, T) if kind in (
            "rcq", "wrcq", "orcq") else None
    if v_luts is None:
        v_luts = _sched_luts(v2c_quantizer_params, bv, T)

    if grid_max is None:
        if c_luts is not None and len(c_luts):
            reach = max(float(l[-1]) for l in c_luts)
        else:
            bmax = float(beta.max()) if beta.ndim else float(beta)
            reach = (mu + 8 * sd) * max(bmax, 1.0)
        dv_max = max(len(es) for es in col_edges)
        grid_max = mu + 8.0 * sd + dv_max * reach
    K, values = _make_grid(grid_max, grid_step)
    chan = _channel_pmf_signed(mu, sd, K, grid_step)
    zero = np.zeros(2 * K - 1)
    zero[K - 1] = 1.0
    chan_col = [zero if c in punct else chan for c in range(nb)]

    amap_cache = {}

    def alpha_scale(full, a):
        """NMS-style VN extrinsic scaling by the output edge's alpha."""
        if a == 1.0 or alpha_in_cn:
            return full
        if a not in amap_cache:
            amap_cache[a] = np.clip(np.round(values * a / grid_step), 0,
                                    K - 1).astype(np.int64)
        p, n_ = _unsigned(full, K)
        p, n_ = _remap_mag(p, n_, amap_cache[a])
        return _signed(p, n_)

    tmap_cache = {}

    def cn_apply(lp, ln, t, e):
        """Push (pos, neg) through this edge's CN transform + C2V qdq.

        Handles the OMS second offset going NEGATIVE (relu(m-b)-a < 0
        flips the message sign — the engines do exactly this:
        ``out = loo_sign * off`` with no second relu)."""
        b = wt(beta, t, e)
        a = wt(alpha, t, e) if alpha_in_cn else 0.0
        key = (t, b, a)
        if key not in tmap_cache:
            v = values.astype(np.float64)
            if kind in ("ms", "nms", "wrcq"):
                v = b * v
            elif kind in ("oms", "orcq"):
                v = np.maximum(v - b, 0.0) - a
            if c_luts is not None:
                taus = np.asarray(c_luts[t], np.float64)
                mag = np.abs(v)
                snapped = taus[np.clip(
                    np.searchsorted(taus, mag + 1e-12, side="right") - 1,
                    0, len(taus) - 1)]
                v = np.sign(v) * snapped
            idx = np.clip(np.round(np.abs(v) / grid_step), 0,
                          K - 1).astype(np.int64)
            tmap_cache[key] = (idx, v < 0)
        idx, flip = tmap_cache[key]
        pos_out = np.zeros(K)
        neg_out = np.zeros(K)
        keep = ~flip
        np.add.at(pos_out, idx[keep], lp[keep])
        np.add.at(neg_out, idx[flip], lp[flip])
        np.add.at(neg_out, idx[keep], ln[keep])
        np.add.at(pos_out, idx[flip], ln[flip])
        pos_out[0] += neg_out[0]
        neg_out[0] = 0.0
        return pos_out, neg_out

    def renorm(full):
        return full / full.sum()

    # state: per-edge signed pmfs. flooding tracks v2c; layered tracks
    # c2v (init delta at 0, the engines' zero message memory)
    if schedule == "flooding":
        v2c = [chan_col[c].copy() for (r, c) in edges]
    elif schedule == "layered":
        c2v = [zero.copy() for _ in edges]
    else:
        raise ValueError(f"unknown schedule {schedule!r}")

    err = np.zeros(T)
    cn_q = np.zeros(T)
    vn_q = np.zeros(T)
    col_err = np.zeros(nb)   # stays all-zero when max_iterations == 0

    for t in range(T):
        v_map = (_qdq_index_map(values, v_luts[t], grid_step, K,
                                dead_zone_to_min=True)
                 if v_luts is not None else None)
        pre_p = np.zeros(K)
        pre_n = np.zeros(K)
        pre_vp = np.zeros(K)
        pre_vn = np.zeros(K)

        if schedule == "flooding":
            c2v = [None] * len(edges)
            for r in range(mb):
                mags = [_unsigned(v2c[e], K) for e in row_edges[r]]
                loo = _loo_folds(mags)
                for k, e in enumerate(row_edges[r]):
                    lp, ln = loo[k]
                    pre_p += lp
                    pre_n += ln
                    qp2, qn2 = cn_apply(lp, ln, t, e)
                    c2v[e] = _signed(qp2, qn2)
            new_v2c = [None] * len(edges)
            for c in range(nb):
                es = col_edges[c]
                for k, e in enumerate(es):
                    s = zero
                    for k2, e2 in enumerate(es):
                        if k2 != k:
                            s = _conv_signed(s, c2v[e2], K)
                    s = alpha_scale(s, wt(alpha, t, e))
                    pre = _conv_signed(s, chan_col[c], K)
                    pp, pn = _unsigned(pre, K)
                    pre_vp += pp
                    pre_vn += pn
                    if v_map is not None:
                        pp, pn = _remap_mag(pp, pn, v_map)
                    new_v2c[e] = renorm(_signed(pp, pn))
            v2c = new_v2c
        else:  # layered: rows in order, fresh v2c from current state
            for r in range(mb):
                row_v2c = []
                for e in row_edges[r]:
                    c = edges[e][1]
                    s = zero
                    for e2 in col_edges[c]:
                        if e2 != e:
                            s = _conv_signed(s, c2v[e2], K)
                    s = alpha_scale(s, wt(alpha, t, e))
                    pre = _conv_signed(s, chan_col[c], K)
                    pp, pn = _unsigned(renorm(pre), K)
                    pre_vp += pp
                    pre_vn += pn
                    row_v2c.append((pp, pn))
                loo = _loo_folds(row_v2c)
                for k, e in enumerate(row_edges[r]):
                    lp, ln = loo[k]
                    pre_p += lp
                    pre_n += ln
                    qp2, qn2 = cn_apply(lp, ln, t, e)
                    c2v[e] = renorm(_signed(qp2, qn2))

        cn_q[t] = _quantile_mag(pre_p / len(edges), pre_n / len(edges),
                                values, quantile)
        vn_q[t] = _quantile_mag(pre_vp / len(edges), pre_vn / len(edges),
                                values, quantile)

        # posterior error per column: with the sign-preserving dead zone
        # (quantizer.QDQ_SIGN_TINY) the decision is the posterior's sign
        # regardless of the bv qdq — error mass = strictly-negative tail
        neg_cut = _bit_error_cut(v_luts[t] if v_luts is not None else None,
                                 K, grid_step)
        # engines compute posterior = llr + colsum with NO alpha scaling
        # (pallas_fused _store_post / layered epilogue)
        col_err = np.zeros(nb)
        for c in range(nb):
            s = zero
            for e2 in col_edges[c]:
                s = _conv_signed(s, c2v[e2], K)
            post = _conv_signed(s, chan_col[c], K)
            post = post / post.sum()
            col_err[c] = post[:neg_cut].sum()
        err[t] = col_err.mean()

    return DEResult(error_prob=err, cn_pre_q=cn_q, vn_pre_q=vn_q,
                    quantile=quantile, col_error=col_err)


def analyze_decoder(
    decoder,
    *,
    snr_db: float,
    max_iterations: Optional[int] = None,
    schedule: Optional[str] = None,
    punctured_cols: Sequence[int] = (),
    grid_step: float = 1.0 / 64.0,
    grid_max: Optional[float] = None,
) -> DEResult:
    """Protograph DE of a built QC :class:`~ldpc_tpu_torch.decode.variants
    .Decoder` — trained weights, exact per-iteration quantizer LUTs, and
    its schedule, all read off the decoder itself. The weights are torch
    tensors on any device (possibly requiring grad) and are read on the
    host; the graph's block tables and the spec's quantizer tables are
    numpy already.

    QCGraph blocks are base-row-major (qc_engine.py QCGraph docstring),
    the same order this module enumerates protograph edges, so the
    decoder's per-block weight tables map 1:1 onto per-edge DE weights.
    """
    qc = decoder.qc
    if qc is None:
        raise ValueError("analyze_decoder needs a QC decoder (qc= set); "
                         "for plain codes use density_evolution on "
                         "degree_profile_from_H")
    spec = decoder.spec
    T = max_iterations or decoder.max_iterations
    if T > decoder.max_iterations:
        raise ValueError(
            f"decoder has weights/LUTs for T={decoder.max_iterations} "
            f"iterations; cannot analyze at max_iterations={T}")

    base = np.full((qc.mb, qc.nb), -1, dtype=np.int64)
    base[np.asarray(qc.block_row), np.asarray(qc.block_col)] = \
        np.asarray(qc.block_shift)

    def tab(idx, fixed, name):
        if idx is None:
            return float(fixed)
        w = decoder.weights[name].detach().cpu().numpy()  # [T_w, n_buckets]
        return w[:T, np.asarray(idx)]  # [T, E]

    beta = tab(spec.beta_idx, spec.fixed_beta, "beta")
    alpha = tab(spec.alpha_idx, spec.fixed_alpha, "alpha")

    def luts(thresholds, qparams, levels):
        if thresholds is not None:
            return [np.asarray(thresholds[t]) for t in range(T)]
        if qparams is not None:
            return [power_thresholds_for_levels(levels, *qparams[t])
                    for t in range(T)]
        return None

    c_luts = (luts(spec.thresholds, spec.qparams, spec.q_levels)
              if spec.kind in ("rcq", "wrcq", "orcq") else None)
    v_luts = luts(spec.v2c_thresholds, spec.v2c_qparams, spec.v2c_levels)

    return protograph_density_evolution(
        base, snr_db=snr_db, max_iterations=T, kind=spec.kind,
        beta=beta, alpha=alpha, alpha_in_cn=spec.alpha_in_cn,
        c_luts=c_luts, v_luts=v_luts,
        schedule=schedule or ("layered" if decoder.layered else "flooding"),
        punctured_cols=punctured_cols, grid_step=grid_step,
        grid_max=grid_max)


def refine_ladders_protograph(
    base: np.ndarray,
    quantizer_params,
    v2c_quantizer_params,
    *,
    bc: int,
    bv: Optional[int],
    max_iterations: int,
    snr_db: float,
    schedule: str = "layered",
    punctured_cols: Sequence[int] = (),
    sweep: Sequence[float] = (0.8, 0.9, 1.1, 1.25),
    gammas: Optional[Sequence[float]] = None,
    objective: str = "threshold",
    guard_snr: Optional[float] = None,
    guard_slack: float = 1.5,
    grid_step: float = 1.0 / 32.0,
    eps: float = 1e-7,
):
    """One coordinate-descent pass over a designed ladder using the
    PROTOGRAPH DE under the actual decode schedule (layered by default)
    — the final polish ``design_rcq_ladders``'s flooding-ensemble
    objective cannot do. Uses a coarser grid (1/32) to keep the
    per-candidate threshold bisection to seconds.

    ``sweep`` multiplies each pair's C (reach); ``gammas`` (optional)
    additionally sweeps each pair's exponent — gamma sets the DEAD-ZONE
    edge tau_1 = C/(L-1)^gamma, the knob that controls the
    quantization-induced error floor on graphs with degree-1 variable
    nodes (a C2V that lands in the dead zone erases the only check of a
    degree-1 bit, leaving it channel-limited).

    ``objective``:

    - ``"threshold"`` (default): minimize the DE convergence threshold
      (lowest SNR with final error < ``eps``, bisected in
      ``snr_db ± 3``). Returns ``(qp, vqp, threshold_db)``.
    - ``"floor"``: minimize the final DE error AT ``snr_db``
      (lexicographically back-to-front, as ``design_dynamic_quantizers``
      does) — the right objective when no ladder in the neighbourhood
      converges below ``eps`` at any SNR (quantization floor regime).
      Returns ``(qp, vqp, final_error)``.

    ``guard_snr`` (floor mode only): a second, lower SNR — typically
    the ladder's threshold — where candidates must not degrade. A
    candidate is rejected outright if its final error at ``guard_snr``
    exceeds ``guard_slack`` x the incumbent's starting value there.
    Without a guard, floor descent at a post-waterfall SNR will happily
    trade unlimited waterfall position for floor (measured: 0.5 dB of
    threshold on the rate-1/3 PBRL polish, RESULTS §34).
    """
    if objective not in ("threshold", "floor"):
        raise ValueError(f"unknown objective {objective!r}")
    qp = [list(p) for p in quantizer_params]
    vqp = ([list(p) for p in v2c_quantizer_params]
           if v2c_quantizer_params is not None else None)
    # In the LAYERED schedule the bv qdq touches only the final
    # posterior (qc_engine.qc_decode_batch_layered / pallas_fused
    # _make_layered_kernel: fresh v2c is never quantized), and since the
    # sign-preserving dead zone the posterior qdq cannot change the bit
    # decision either — so V2C ladder coordinates are decode-neutral:
    # sweeping them burns DE runs on guaranteed no-ops. (Round 3's
    # measured "V2C reach" gains were the pre-fix decision-bias
    # artifact — docs/RESULTS.md §33.)
    sweep_v2c = schedule != "layered"
    lo0, hi0 = snr_db - 3.0, snr_db + 3.0

    def run(q, v, snr):
        return protograph_density_evolution(
            base, snr_db=snr, schedule=schedule,
            max_iterations=max_iterations, kind="rcq", bc=bc,
            quantizer_params=tuple(tuple(p) for p in q), bv=bv,
            v2c_quantizer_params=(tuple(tuple(p) for p in v)
                                  if v is not None else None),
            punctured_cols=punctured_cols, grid_step=grid_step)

    def threshold(q, v, prune_at=None):
        """Bisected threshold on the FIXED bracket ``snr_db ± 3`` (every
        candidate sees the identical mid sequence, so equal ladders get
        exactly equal thresholds). ``prune_at`` aborts as soon as the
        bracket's lower edge proves the candidate cannot beat the
        incumbent, saving most of the bisection on losing candidates."""
        lo, hi = lo0, hi0
        if run(q, v, hi).error_prob[-1] > eps:
            return hi0 + 1.0
        for _ in range(7):
            mid = 0.5 * (lo + hi)
            if run(q, v, mid).error_prob[-1] > eps:
                lo = mid
                if prune_at is not None and lo >= prune_at:
                    return hi0 + 1.0  # threshold >= lo > incumbent
            else:
                hi = mid
        return hi

    def floor_key(q, v):
        return tuple(run(q, v, snr_db).error_prob[::-1])

    if objective == "floor":
        if guard_snr is not None:
            guard0 = guard_slack * float(
                run(qp, vqp, guard_snr).error_prob[-1])

            def floor_guarded():
                # guard first: a candidate that damages the waterfall at
                # guard_snr loses to any candidate that does not,
                # regardless of its floor
                g = float(run(qp, vqp, guard_snr).error_prob[-1])
                return (g > guard0, floor_key(qp, vqp))

            best = floor_guarded()
            score = floor_guarded
        else:
            best = floor_key(qp, vqp)
            score = lambda: floor_key(qp, vqp)  # noqa: E731
    else:
        best = threshold(qp, vqp)
        score = lambda: threshold(qp, vqp, prune_at=best)  # noqa: E731

    for lad in ([qp] if (vqp is None or not sweep_v2c) else [qp, vqp]):
        for p in range(len(lad)):
            for f in sweep:
                old = lad[p][0]
                lad[p][0] = old * f
                cand = score()
                if cand < best:
                    best = cand
                else:
                    lad[p][0] = old
            for g in (gammas or ()):
                if g == lad[p][1]:
                    continue
                old_g = lad[p][1]
                lad[p][1] = g
                cand = score()
                if cand < best:
                    best = cand
                else:
                    lad[p][1] = old_g
    return (tuple((round(c, 4), g) for c, g in qp),
            (tuple((round(c, 4), g) for c, g in vqp)
             if vqp is not None else None),
            float((best[1][0] if guard_snr is not None else best[0])
                  if objective == "floor" else best))


def design_dynamic_quantizers(
    base: np.ndarray,
    *,
    snr_db: float,
    max_iterations: int,
    bc: int,
    bv: Optional[int] = None,
    v2c_quantizer_params=None,
    kind: str = "rcq",
    schedule: str = "layered",
    punctured_cols: Sequence[int] = (),
    init_params: Sequence[Tuple[float, float]] = (
        (3.0, 1.3), (5.0, 1.3), (7.0, 1.3)),
    C_factors: Sequence[float] = (0.6, 0.75, 0.9, 1.0, 1.15, 1.4),
    gammas: Sequence[float] = (1.0, 1.3),
    passes: int = 2,
    grid_step: float = 1.0 / 32.0,
    beta=0.0,
    alpha=1.0,
    alpha_in_cn: bool = False,
):
    """Per-ITERATION (C, gamma) C2V-quantizer design by greedy DE descent
    — the paper's dynamic-quantization design rule (RCQ decoders use a
    different quantizer each iteration, designed from the iteration's
    message statistics; SS VI / Fig. 4 of the W-RCQ paper; reference
    approximation: the fixed thirds ``phase_schedule`` in
    ``rcq_decoder.py:66-71``), realized here as coordinate descent on
    the protograph DE under the ACTUAL schedule (layered by default).

    Starting from ``init_params`` expanded onto the thirds schedule,
    each pass sweeps iterations t = 0..T-1 in order; for every candidate
    ``(f * C_t, gamma)`` it re-runs the full DE and keeps the candidate
    iff it improves the error-probability trajectory LEXICOGRAPHICALLY
    from the last iteration backwards (final error first; earlier
    iterations break ties — at a fixed design SNR many candidates drive
    the final error to the same floor, and faster convergence is what
    the early-exit bench config monetizes).

    Returns ``(per_iter_params, de_result)`` where ``per_iter_params``
    is a length-T tuple of (C, gamma) — pass it directly to
    :func:`ldpc_tpu_torch.make_decoder` as ``quantizer_params`` (the engines'
    ``phase_schedule(T, Q=T)`` assigns one entry per iteration).

    The internal bv ladder (``v2c_quantizer_params``) is held fixed:
    the engines' posterior/v2c quantizer reach must stay aligned with
    the accumulated-LLR growth, and the CN ladder is where the paper's
    dynamic rule acts.
    """
    T = max_iterations
    sched = phase_schedule(T, len(init_params))
    params = [list(init_params[p]) for p in sched]

    def run(ps):
        luts = [power_thresholds(bc, c, g) for (c, g) in ps]
        return protograph_density_evolution(
            base, snr_db=snr_db, max_iterations=T, kind=kind,
            beta=beta, alpha=alpha, alpha_in_cn=alpha_in_cn,
            bc=bc, c_luts=luts, bv=bv,
            v2c_quantizer_params=v2c_quantizer_params,
            schedule=schedule, punctured_cols=punctured_cols,
            grid_step=grid_step)

    def key(res):
        # final error dominates; earlier iterations break ties
        return tuple(res.error_prob[::-1])

    best_res = run(params)
    best_key = key(best_res)
    for _ in range(passes):
        improved = False
        for t in range(T):
            c0, g0 = params[t]
            for f in C_factors:
                for g in gammas:
                    cand = (round(c0 * f, 4), g)
                    if cand == (c0, g0):
                        continue
                    params[t] = list(cand)
                    res = run(params)
                    k = key(res)
                    if k < best_key:
                        best_key, best_res = k, res
                        c0, g0 = cand
                        improved = True
                    else:
                        params[t] = [c0, g0]
        if not improved:
            break
    return tuple((float(c), float(g)) for c, g in params), best_res
