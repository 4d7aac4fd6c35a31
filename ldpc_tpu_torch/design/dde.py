"""Discretized density evolution (DDE) for the quantized min-sum family.

The paper's §VI quantizer design step ("accept the decoder if no error
floor appears above the target FER, else add a quantizer") presupposes a
way to *predict* how a (C, gamma) ladder behaves without running a
Monte-Carlo campaign per candidate. The reference repo has no such tool —
its ladders are hand-picked constants (``rcq_decoder.py:124-153``). This
module implements the standard machinery: track the probability density
of messages on the cycle-free ensemble through the exact engine
semantics — the same CN min/sign algebra, variant transform, RCQ
quantize-dequantize (snap-down to ``tau_j = C (j/M)^gamma``,
``quantizer.py``), bv-bit uniform internal quantizer, and the channel
convention ``llr ~ N(2/sigma^2, 4/sigma^2)`` (``channel.py:41-52``) —
and on top of it a per-phase (C, gamma) coordinate-descent designer.

Everything is plain numpy on a uniform value grid (default step 1/64,
half-width auto-sized to the channel + message range): messages are
(pos, neg) magnitude pmfs; the CN leave-one-out min/sign fold uses the
exact tie-aware two-message combine; VN sums convolve via FFT (or sparse
shift-adds when the c2v alphabet is small, the RCQ case). Runs in
milliseconds per (config, SNR) — cheap enough for nested design loops.

Caveats (documented, inherent to DE): predictions are for the cycle-free
ensemble of the degree profile — finite codes with cycles have higher
error floors; and the decoder's LAYERED schedule is approximated by
flooding with more iterations (layered T ~ flooding 1.7-2T, measured in
docs/RESULTS.md §10). Use DDE to *rank* ladders, then confirm the
winner with a dev-FER run.

This is a numpy copy of ``ldpc_tpu/design/dde.py`` (the port imports no
JAX); ``tests/test_torch_design.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ldpc_tpu_torch.quantizer import phase_schedule, power_thresholds

__all__ = [
    "DegreeProfile",
    "DEResult",
    "degree_profile_from_H",
    "degree_profile_from_base",
    "density_evolution",
    "design_rcq_ladders",
]


# --------------------------------------------------------------------------
# degree profiles
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DegreeProfile:
    """Edge- and node-perspective degree distributions of an ensemble.

    ``rho``/``lam`` are edge-perspective (fraction of EDGES attached to a
    check/variable node of that degree) — the distributions DE recursions
    mix over. ``var_nodes`` is node-perspective, used for the posterior
    bit-error probability."""

    rho: Tuple[Tuple[int, float], ...]        # (dc, edge fraction)
    lam: Tuple[Tuple[int, float], ...]        # (dv, edge fraction)
    var_nodes: Tuple[Tuple[int, float], ...]  # (dv, node fraction)

    @property
    def max_dv(self) -> int:
        return max(d for d, _ in self.lam)

    @property
    def max_dc(self) -> int:
        return max(d for d, _ in self.rho)


def _profile_from_degrees(row_deg: np.ndarray,
                          col_deg: np.ndarray) -> DegreeProfile:
    row_deg = row_deg[row_deg > 0]
    col_deg = col_deg[col_deg > 0]
    E = int(col_deg.sum())
    assert int(row_deg.sum()) == E, "row/col degree sums disagree"

    def edge_dist(deg):
        out = []
        for d in np.unique(deg):
            out.append((int(d), float(deg[deg == d].sum()) / E))
        return tuple(out)

    def node_dist(deg):
        out = []
        for d in np.unique(deg):
            out.append((int(d), float((deg == d).sum()) / len(deg)))
        return tuple(out)

    return DegreeProfile(rho=edge_dist(row_deg), lam=edge_dist(col_deg),
                         var_nodes=node_dist(col_deg))


def degree_profile_from_H(H: np.ndarray) -> DegreeProfile:
    """Degree profile of a parity-check matrix (dense {0,1})."""
    H = np.asarray(H)
    return _profile_from_degrees(H.sum(axis=1).astype(np.int64),
                                 H.sum(axis=0).astype(np.int64))


def degree_profile_from_base(base: np.ndarray) -> DegreeProfile:
    """Degree profile of a QC protograph (entries < 0 = empty block).
    Lifting replicates every node with its protograph degree, so the
    lifted code's profile equals the base occupancy profile."""
    occ = np.asarray(base) >= 0
    return _profile_from_degrees(occ.sum(axis=1).astype(np.int64),
                                 occ.sum(axis=0).astype(np.int64))


# --------------------------------------------------------------------------
# grid pmf helpers. A message distribution is a pair (pos, neg) of pmfs
# over magnitudes {0, step, 2*step, ...}; pos[0] carries P(value == 0),
# neg[0] is always 0.
# --------------------------------------------------------------------------

def _tails(p: np.ndarray) -> np.ndarray:
    """t[i] = sum_{j > i} p[j]."""
    c = np.cumsum(p[::-1])[::-1]
    t = np.empty_like(c)
    t[:-1] = c[1:]
    t[-1] = 0.0
    return t


def _cn_combine(xp, xn, yp, yn):
    """Distribution of (sign_x*sign_y, min(|x|, |y|)) for independent
    messages — the exact tie-aware min/sign fold (the DE counterpart of
    the engine's running min/negative-count parity, engine.py)."""
    Txp, Txn, Typ, Tyn = _tails(xp), _tails(xn), _tails(yp), _tails(yn)
    zp = (xp * (Typ + yp) + xn * (Tyn + yn) + Txp * yp + Txn * yn)
    zn = (xp * (Tyn + yn) + xn * (Typ + yp) + Txp * yn + Txn * yp)
    # magnitude 0 has no sign (value is 0 either way): canonicalize
    zp[0] += zn[0]
    zn[0] = 0.0
    return zp, zn


def _fold_min(pos, neg, k: int):
    """(sign, min)-fold of ``k`` iid copies of (pos, neg) — binary
    exponentiation over the associative combine, O(log k) combines."""
    if k <= 0:
        raise ValueError("fold needs k >= 1")
    rp = rn = None
    cp, cn = pos, neg
    while k:
        if k & 1:
            rp, rn = ((cp, cn) if rp is None
                      else _cn_combine(rp, rn, cp, cn))
        k >>= 1
        if k:
            cp, cn = _cn_combine(cp, cn, cp, cn)
    return rp.copy(), rn.copy()


def _fold_min_loo(pos, neg, dc: int):
    """Leave-one-out fold: min/sign over dc-1 iid messages."""
    if dc <= 1:
        # degree-1 check: the engine reflects the input (min2 = min1,
        # ldpc_decoder.py:112-115 behavior) — output = the message itself
        return pos.copy(), neg.copy()
    return _fold_min(pos, neg, dc - 1)


def _remap_mag(pos, neg, idx_map: np.ndarray):
    """Pushforward through a deterministic magnitude map given as an index
    map on the grid (e.g. a quantizer or a beta transform)."""
    K = pos.shape[0]
    np_out = np.zeros(K)
    pp_out = np.zeros(K)
    np.add.at(pp_out, idx_map, pos)
    np.add.at(np_out, idx_map, neg)
    pp_out[0] += np_out[0]
    np_out[0] = 0.0
    return pp_out, np_out


def _signed(pos, neg):
    """[-N..N] signed pmf vector from a magnitude pair; index N is 0 and
    carries the full zero-bin mass pos[0] + neg[0]."""
    full = np.concatenate([neg[::-1], pos[1:]])
    full[len(neg) - 1] = pos[0] + neg[0]
    return full


def _unsigned(full, K):
    """Inverse of :func:`_signed` for a length 2K-1 vector."""
    neg = np.zeros(K)
    neg[1:] = full[:K - 1][::-1]
    pos = full[K - 1:].copy()
    return pos, neg


def _fft_conv(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    n = len(a) + len(b) - 1
    nf = 1 << (n - 1).bit_length()
    out = np.fft.irfft(np.fft.rfft(a, nf) * np.fft.rfft(b, nf), nf)[:n]
    np.clip(out, 0.0, None, out=out)
    return out


def _conv_clip(full_a, full_b, K):
    """Convolve signed pmfs and clip the support back to [-R, R], lumping
    out-of-range mass at the boundary (safe: every downstream consumer
    either clips at C <= R or only reads the sign)."""
    c = _fft_conv(full_a, full_b)
    # supports are [-(Ka-1), Ka-1] and [-(Kb-1), Kb-1] in grid units
    Ka = (len(full_a) + 1) // 2
    Kb = (len(full_b) + 1) // 2
    span = Ka + Kb - 1  # zero offset in c
    out = np.zeros(2 * K - 1)
    lo = span - 1 - (K - 1)
    hi = span - 1 + (K - 1)
    out[:] = c[lo:hi + 1]
    out[0] += c[:lo].sum()
    out[-1] += c[hi + 1:].sum()
    return out


def _sparse_support(full, tol=0.0):
    idx = np.nonzero(full > tol)[0]
    return idx


def _conv_signed(a, b, K):
    """Signed-pmf convolution with boundary lumping; sparse shift-add
    when one operand has small support (quantized c2v alphabets), FFT
    otherwise."""
    sa, sb = _sparse_support(a), _sparse_support(b)
    if len(sb) < len(sa):
        a, b, sa, sb = b, a, sb, sa
    if len(sa) <= 32:
        out = np.zeros(2 * K - 1)
        n = 2 * K - 1
        for i in sa:
            off = i - (K - 1)
            pr = a[i]
            if off >= 0:
                out[off:] += pr * b[:n - off]
                if off > 0:
                    out[-1] += pr * b[n - off:].sum()
            else:
                out[:off] += pr * b[-off:]
                out[0] += pr * b[:-off].sum()
        return out
    return _conv_clip(a, b, K)


def _qdq_index_map(values, lut, grid_step, K,
                   dead_zone_to_min: bool = False):
    """Grid-index map of snap-down-to-threshold quantization (the exact
    ``quantizer.py`` semantics: largest tau_j <= |x|, reconstruct to the
    threshold).

    ``dead_zone_to_min=True`` models the engines' sign-preserving dead
    zone (``quantizer.QDQ_SIGN_TINY``): nonzero magnitudes below tau_1
    keep their sign with an epsilon magnitude, which on the grid is the
    smallest nonzero bin — without it the ``_signed`` zero slot merges
    the two signs and the DE's CN sign products (and the bit decision)
    inherit the old ``-0.0 < 0 == False`` bias that predicted
    below-capacity "convergence" (docs/RESULTS.md §33). Use it for V2C
    quantizer maps (signs feed CN products); leave it off for additive
    consumers (C2V into VN sums), where an epsilon-vs-zero magnitude is
    exactly absorbed but a grid_step one is not."""
    taus = np.asarray(lut, dtype=np.float64)
    snapped = taus[np.clip(
        np.searchsorted(taus, values + 1e-12, side="right") - 1,
        0, len(taus) - 1)]
    idx = np.clip(np.round(snapped / grid_step), 0, K - 1).astype(np.int64)
    if dead_zone_to_min:
        idx[(np.asarray(values) > 0) & (idx == 0)] = 1
    return idx


def _cn_transform_index_map(values, K, grid_step, kind, beta, c_lut):
    """Magnitude-value map of a CN variant transform + optional C2V qdq
    (mirrors ``engine.py``'s variant kinds with scalar weights)."""
    v = values.copy()
    if kind in ("ms", "nms", "wrcq"):
        v = beta * v
    elif kind in ("oms", "orcq"):
        v = np.maximum(v - beta, 0.0)
    idx = np.clip(np.round(v / grid_step), 0, K - 1).astype(np.int64)
    if c_lut is not None:
        idx = _qdq_index_map(values, c_lut, grid_step, K)[idx]
    return idx


def _make_grid(grid_max: float, grid_step: float):
    """(K, magnitude values) for a symmetric grid of the given reach."""
    K = int(math.ceil(grid_max / grid_step)) + 1
    return K, np.arange(K) * grid_step


def _channel_pmf_signed(mu: float, sd: float, K: int,
                        grid_step: float) -> np.ndarray:
    """Signed [-R..R] channel-LLR pmf: erf bin integrals with the tail
    mass lumped into the boundary bins (llr ~ N(mu, sd^2),
    ``channel.py:41-52``)."""
    from math import erf

    def phi(x):
        return 0.5 * (1.0 + erf(x / math.sqrt(2.0)))

    edges = (np.arange(-(K - 1), K + 1) - 0.5) * grid_step
    cdf = np.array([phi((e - mu) / sd) for e in edges])
    full = np.diff(cdf)
    full[0] += cdf[0]
    full[-1] += 1.0 - cdf[-1]
    return full


def _sched_luts(params, bits, T):
    """Per-iteration threshold LUTs from (C, gamma) pairs on the thirds
    phase schedule (``quantizer.phase_schedule``)."""
    if params is None or bits is None:
        return None
    s = phase_schedule(T, len(params))
    return [power_thresholds(bits, *params[p]) for p in s]


def _bit_error_cut(v_lut, K: int, grid_step: float) -> int:
    """Slice end ``e`` such that ``signed_pmf[:e].sum()`` is the bit
    error probability under the engines' decision rule.

    Since the sign-preserving dead zone (``quantizer.QDQ_SIGN_TINY``),
    ``bit = vqdq(posterior) < 0`` equals ``posterior < 0`` for every
    input — the bv qdq changes magnitudes, never the decision — so the
    error mass is always the strictly-negative tail. (The previous
    semantics excluded the ``(-tau1, 0]`` region: snap-down produced
    ``-0.0`` and ``-0.0 < 0`` is false, a decision bias that predicted
    below-capacity "convergence" for large-reach ladders and broke the
    all-zero-codeword symmetry argument — docs/RESULTS.md §33.)"""
    return K - 1


# --------------------------------------------------------------------------
# density evolution
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DEResult:
    """Per-iteration DE telemetry.

    ``error_prob[t]`` is the ensemble bit-error probability of the hard
    decision on the posterior after iteration t+1 (engine rule:
    ``bit = vqdq(posterior) < 0`` — mass at zero counts as correct, and
    with bv active the whole snap-down dead zone (-tau1, 0) does too;
    see ``_bit_error_cut``).
    ``cn_pre_q[t]`` / ``vn_pre_q[t]`` are high quantiles (given by
    ``quantile``) of the CN / VN pre-quantizer magnitude distributions —
    the natural anchors for choosing C."""

    error_prob: np.ndarray
    cn_pre_q: np.ndarray
    vn_pre_q: np.ndarray
    quantile: float
    # set by design_rcq_ladders: the designed ladder's DE convergence
    # threshold (lowest SNR whose final error < 1e-7 within T iterations)
    threshold_db: Optional[float] = None
    # protograph DE only: per-base-column posterior error after the
    # final iteration (error_prob[-1] == col_error.mean()) — localizes
    # a DE floor to the columns that hold it
    col_error: Optional[np.ndarray] = None


def _quantile_mag(pos, neg, values, q):
    mag = pos + neg
    mag[0] = pos[0]
    c = np.cumsum(mag)
    tot = c[-1]
    if tot <= 0:
        return 0.0
    i = int(np.searchsorted(c, q * tot))
    return float(values[min(i, len(values) - 1)])


def density_evolution(
    profile: DegreeProfile,
    *,
    snr_db: float,
    max_iterations: int,
    kind: str = "rcq",
    beta: float = 0.0,
    alpha: float = 1.0,
    bc: Optional[int] = None,
    quantizer_params: Optional[Sequence[Tuple[float, float]]] = None,
    bv: Optional[int] = None,
    v2c_quantizer_params: Optional[Sequence[Tuple[float, float]]] = None,
    grid_step: float = 1.0 / 64.0,
    grid_max: Optional[float] = None,
    quantile: float = 0.995,
) -> DEResult:
    """Run DDE for ``max_iterations`` flooding iterations.

    kind: 'ms' (beta = NMS factor), 'oms' (beta = offset), 'rcq'
    (C2V qdq of the raw min), 'wrcq' (qdq of beta*min), 'orcq' (qdq of
    relu(min - beta)) — mirroring ``engine.py``'s variant transforms with
    scalar weights. ``quantizer_params``/``v2c_quantizer_params`` are
    (C, gamma) ladders on the thirds ``phase_schedule``, exactly like
    ``make_decoder``.
    """
    T = max_iterations
    sigma2 = 10.0 ** (-snr_db / 10.0)
    mu = 2.0 / sigma2
    sd = 2.0 / math.sqrt(sigma2)

    # per-iteration quantizer LUTs (values snapped to the grid later)
    c_luts = _sched_luts(quantizer_params, bc, T) if kind in (
        "rcq", "wrcq", "orcq") else None
    v_luts = _sched_luts(v2c_quantizer_params, bv, T)

    if grid_max is None:
        # cover the channel (mu + 8 sd) plus the largest VN sum the
        # transform can produce
        if c_luts is not None:
            reach = max(float(l[-1]) for l in c_luts)
        elif kind == "ms":
            reach = (mu + 8 * sd) * max(beta, 1.0)
        else:
            reach = mu + 8 * sd
        grid_max = mu + 8.0 * sd + (profile.max_dv) * reach
    K, values = _make_grid(grid_max, grid_step)

    chan_full = _channel_pmf_signed(mu, sd, K, grid_step)
    chan_pos, chan_neg = _unsigned(chan_full, K)

    def cn_transform_map(t):
        return _cn_transform_index_map(
            values, K, grid_step, kind, beta,
            c_luts[t] if c_luts is not None else None)

    # initial v2c = raw channel llr (engine init, SURVEY §2b step 2)
    v2c_p, v2c_n = chan_pos.copy(), chan_neg.copy()

    err = np.zeros(T)
    cn_q = np.zeros(T)
    vn_q = np.zeros(T)

    for t in range(T):
        # ---- check-node update ----
        cp_mix = np.zeros(K)
        cn_mix = np.zeros(K)
        pre_p = np.zeros(K)
        pre_n = np.zeros(K)
        tmap = cn_transform_map(t)
        for dc, frac in profile.rho:
            lp, ln = _fold_min_loo(v2c_p, v2c_n, dc)
            pre_p += frac * lp
            pre_n += frac * ln
            qp2, qn2 = _remap_mag(lp, ln, tmap)
            cp_mix += frac * qp2
            cn_mix += frac * qn2
        cn_q[t] = _quantile_mag(pre_p, pre_n, values, quantile)

        # ---- variable-node update ----
        c_full = _signed(cp_mix, cn_mix)
        support = _sparse_support(c_full, tol=1e-300)
        sparse = len(support) <= 64

        def vn_sum_sparse(k_msgs):
            """Signed pmf of a sum of k iid c2v messages via shift-adds
            over the (small) c2v alphabet, clipping at the grid edge."""
            base_idx = support - (K - 1)  # signed offsets
            base_p = c_full[support]
            cur = np.zeros(2 * K - 1)
            cur[K - 1] = 1.0
            for _ in range(k_msgs):
                nxt = np.zeros(2 * K - 1)
                for off, pr in zip(base_idx, base_p):
                    if off >= 0:
                        nxt[off:] += pr * cur[:2 * K - 1 - off]
                        if off > 0:
                            nxt[-1] += pr * cur[2 * K - 1 - off:].sum()
                    else:
                        nxt[:off] += pr * cur[-off:]
                        nxt[0] += pr * cur[:-off].sum()
                cur = nxt
            return cur

        # cache sums by count (shared across degrees)
        sums: Dict[int, np.ndarray] = {}

        def get_sum(k_msgs):
            if k_msgs in sums:
                return sums[k_msgs]
            if k_msgs == 0:
                s = np.zeros(2 * K - 1)
                s[K - 1] = 1.0
            elif k_msgs == 1:
                s = c_full.copy()
            elif sparse:
                s = vn_sum_sparse(k_msgs)
            else:
                half = get_sum(k_msgs // 2)
                s = _conv_clip(half, half, K)
                if k_msgs % 2:
                    s = _conv_clip(s, c_full, K)
            sums[k_msgs] = s
            return s

        v_map = (_qdq_index_map(values, v_luts[t], grid_step, K,
                                dead_zone_to_min=True)
                 if v_luts is not None else None)

        new_p = np.zeros(K)
        new_n = np.zeros(K)
        pre_vp = np.zeros(K)
        pre_vn = np.zeros(K)
        for dv, frac in profile.lam:
            s = get_sum(dv - 1)
            if alpha != 1.0:
                sp, sn = _unsigned(s, K)
                amap = np.clip(np.round(values * alpha / grid_step), 0,
                               K - 1).astype(np.int64)
                sp, sn = _remap_mag(sp, sn, amap)
                s = _signed(sp, sn)
            pre = _conv_clip(s, chan_full, K)
            pp, pn = _unsigned(pre, K)
            pre_vp += frac * pp
            pre_vn += frac * pn
            if v_map is not None:
                pp, pn = _remap_mag(pp, pn, v_map)
            new_p += frac * pp
            new_n += frac * pn
        vn_q[t] = _quantile_mag(pre_vp, pre_vn, values, quantile)

        # ---- posterior error (node-perspective) ----
        # the engines compute posterior = llr + colsum with NO alpha
        # scaling (pallas_fused _store_post), so neither does DE; the
        # bit rule includes the bv dead zone (see _bit_error_cut)
        cut = _bit_error_cut(v_luts[t] if v_luts is not None else None,
                             K, grid_step)
        e = 0.0
        for dv, frac in profile.var_nodes:
            s = get_sum(dv)
            post = _conv_clip(s, chan_full, K)
            e += frac * post[:cut].sum()
        err[t] = e

        # renormalize: FFT rounding seeds a ~1e-9 mass drift that the
        # mass-exponentiating fold/conv chain amplifies ~10x per
        # iteration (measured) — divide it out every iteration
        tot = new_p.sum() + new_n.sum()
        v2c_p, v2c_n = new_p / tot, new_n / tot

    return DEResult(error_prob=err, cn_pre_q=cn_q, vn_pre_q=vn_q,
                    quantile=quantile)


# --------------------------------------------------------------------------
# ladder design
# --------------------------------------------------------------------------

def design_rcq_ladders(
    profile: DegreeProfile,
    *,
    bc: int,
    bv: Optional[int],
    max_iterations: int,
    snr_db: float,
    phases: int = 3,
    gamma: float = 1.3,
    v2c_gamma: float = 1.0,
    kind: str = "rcq",
    beta: float = 0.0,
    sweep: Sequence[float] = (0.8, 0.9, 1.0, 1.1, 1.25),
    passes: int = 2,
    grid_step: float = 1.0 / 64.0,
):
    """Design per-phase (C, gamma) ladders by DDE coordinate descent.

    Two-stage search, robust to bad seeds (float-decoder message
    quantiles grow without bound over iterations, so a purely local
    search around them can get stuck at absurdly wide ladders): first a
    common-C basin sweep + per-phase sweep over an ABSOLUTE geometric
    C-grid spanning 2% to 2x the channel range, then ``passes`` local
    refinement rounds over multiplicative ``sweep`` factors. The
    objective is the DE CONVERGENCE THRESHOLD (bisected; tie-broken by
    trajectory sum) — the standard DE design criterion; ``snr_db``
    centers the bisection bracket and is the SNR of the returned
    trajectory. Returns ``(quantizer_params, v2c_quantizer_params,
    result)`` in the exact form ``make_decoder`` consumes, with
    ``result.threshold_db`` set.

    Validated end to end (tests/test_design.py): on the PEG (256,128)
    profile the designed bc=3 ladder's DE threshold (2.42 dB) and
    measured FER match/beat the hand-swept 2-4-6 ladder (2.49 dB).
    """
    T = max_iterations
    sched = phase_schedule(T, phases)

    def phase_iters(p):
        its = [t for t in range(T) if sched[t] == p]
        return its or [T - 1]

    # --- seed from the FLOAT decoder's message quantiles: run DE without
    # any quantizer (plain min-sum — factor 1.0, or the oms offset) and
    # anchor each phase's C at the pre-quantizer magnitude quantile of
    # that phase's iterations. The probe grid is deliberately modest
    # (message magnitudes grow multiplicatively once unquantized; the
    # boundary lump only caps late-phase seeds, which coordinate descent
    # re-scales anyway).
    sigma2 = 10.0 ** (-snr_db / 10.0)
    chan_hi = 2.0 / sigma2 + 8.0 * 2.0 / math.sqrt(sigma2)
    probe_kind = "oms" if kind in ("oms", "orcq") else "ms"
    probe = density_evolution(
        profile, snr_db=snr_db, max_iterations=T, kind=probe_kind,
        beta=beta if probe_kind == "oms" else 1.0,
        grid_step=grid_step, grid_max=8.0 * chan_hi)
    c_lad = [max(0.25, float(np.mean([probe.cn_pre_q[t]
                                      for t in phase_iters(p)])))
             for p in range(phases)]
    v_lad = ([max(1.0, float(np.mean([probe.vn_pre_q[t]
                                      for t in phase_iters(p)])))
              for p in range(phases)] if bv else None)

    def de_run(cs, vs, snr):
        return density_evolution(
            profile, snr_db=snr, max_iterations=T, kind=kind, beta=beta,
            bc=bc, quantizer_params=tuple((c, gamma) for c in cs),
            bv=bv,
            v2c_quantizer_params=(tuple((v, v2c_gamma) for v in vs)
                                  if vs else None),
            grid_step=grid_step)

    # Objective: the DE CONVERGENCE THRESHOLD (lowest SNR whose final
    # error drops below eps within T iterations), found by bisection.
    # A single-SNR error objective is useless above threshold — nearly
    # every ladder reads exactly 0 there, including ladders that are
    # terrible on finite codes (e.g. phase-2 C of 40: by then the
    # CONVERGED ensemble has huge messages, but a finite code's
    # still-failing frames do not — maximizing the threshold margin is
    # the standard DE design criterion and penalizes exactly that).
    eps = 1e-7
    lo0, hi0 = snr_db - 3.0, snr_db + 3.0

    def threshold(cs, vs):
        lo, hi = lo0, hi0
        if de_run(cs, vs, hi).error_prob[-1] > eps:
            return hi + 1.0  # hopeless ladder
        for _ in range(9):
            mid = 0.5 * (lo + hi)
            if de_run(cs, vs, mid).error_prob[-1] > eps:
                lo = mid
            else:
                hi = mid
        return hi

    def evaluate(cs, vs):
        thr = threshold(cs, vs)
        # tie-break: trajectory sum at the design SNR (convergence speed)
        r = de_run(cs, vs, max(snr_db, thr))
        return (thr, float(r.error_prob.sum())), r

    best_err, best_r = evaluate(c_lad, v_lad)

    def coord_pass(candidates):
        """One coordinate-descent round over every phase of both ladders;
        ``candidates(cur)`` yields the C values to try for a phase."""
        nonlocal best_err, best_r, c_lad, v_lad
        for p in range(phases):
            for cval in candidates(c_lad[p]):
                cand = list(c_lad)
                cand[p] = float(cval)
                e, r = evaluate(cand, v_lad)
                if e < best_err:
                    best_err, best_r, c_lad = e, r, cand
        if v_lad is not None:
            for p in range(phases):
                for cval in candidates(v_lad[p]):
                    cand = list(v_lad)
                    cand[p] = float(cval)
                    e, r = evaluate(c_lad, cand)
                    if e < best_err:
                        best_err, best_r, v_lad = e, r, cand

    # stage 0: find the right BASIN with one shared C per ladder — a
    # per-phase sweep from a bad seed conditions every phase's choice on
    # the other phases' bad values and parks in a poor local optimum
    # (measured: per-phase-first landed 0.9 dB above the hand ladder's
    # threshold on the PEG profile; common-C-first recovers it)
    abs_grid = np.geomspace(0.02 * chan_hi, 2.0 * chan_hi, 14)
    for cval in abs_grid:
        e, r = evaluate([float(cval)] * phases, v_lad)
        if e < best_err:
            best_err, best_r, c_lad = e, r, [float(cval)] * phases
    if v_lad is not None:
        for cval in abs_grid:
            e, r = evaluate(c_lad, [float(cval)] * phases)
            if e < best_err:
                best_err, best_r, v_lad = e, r, [float(cval)] * phases
    # stage 1: per-phase absolute grid
    coord_pass(lambda cur: abs_grid)
    # stage 2: local multiplicative refinement
    for _ in range(passes):
        coord_pass(lambda cur: [cur * f for f in sweep])

    qp = tuple((round(c, 4), gamma) for c in c_lad)
    vqp = tuple((round(v, 4), v2c_gamma) for v in v_lad) if v_lad else None
    # report the winner's trajectory AT the design SNR plus its threshold
    final = de_run(c_lad, v_lad, snr_db)
    final = dataclasses.replace(final, threshold_db=float(best_err[0]))
    return qp, vqp, final
