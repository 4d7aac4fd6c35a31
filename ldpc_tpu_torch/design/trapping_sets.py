"""Finite-graph error-floor diagnosis: (a, b) trapping-set enumeration.

Density evolution (``dde.py`` / ``proto_dde.py``) is an ENSEMBLE tool —
it predicts waterfall thresholds but is blind to the floors a PARTICULAR
lifted graph exhibits. Measured floors (docs/RESULTS.md §16-18) come
from small trapping sets: a set ``S`` of ``a`` variable nodes whose
induced subgraph leaves only ``b`` odd-degree checks. Channel noise
that confuses exactly those ``a`` bits leaves a near-zero syndrome and
iterative decoding stalls; the floor FER scales with the multiplicity
of the dominant (small ``a``, small ``b``) classes.

This module enumerates the low-(a, b) spectrum with a batched greedy
expansion search (the standard hill-climbing enumerator): every variable
node seeds a set, and each step adds the variable that minimizes the
number of odd-degree checks. One numpy matmul scores ALL candidate
variables for ALL seeds at once — the parity-flip delta for adding
``v`` to ``S`` is ``sum_c H[c, v] * (+1 if deg_S(c) even else -1)``, so
a step is ``sign-matrix @ H``. Randomized tie-breaking across
``restarts`` explores beyond the deterministic greedy path.

Heuristic coverage, exact reporting: every returned set's (a, b) is
recomputed from H (never trusted from the search), and small-code
exhaustive enumeration in ``tests/test_trapping_sets.py`` checks the
greedy finds the true minimum-b sets. No reference counterpart (the
reference has no graph-diagnosis tooling); pure numpy, design-time only.

This is a numpy copy of ``ldpc_tpu/design/trapping_sets.py`` (the port
imports no JAX); ``tests/test_torch_design.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["TrappingSet", "TrappingSetReport", "find_trapping_sets",
           "trapping_set_profile"]


@dataclasses.dataclass(frozen=True)
class TrappingSet:
    """One (a, b) trapping set: ``a`` variables, ``b`` odd-degree checks."""

    variables: Tuple[int, ...]    # sorted VN indices
    a: int
    b: int
    odd_checks: Tuple[int, ...]   # checks with odd induced degree
    elementary: bool              # all induced check degrees <= 2
    absorbing: bool               # every VN: more even- than odd-degree
    #   neighbor checks (absorbing sets are the ones min-sum cannot leave)


@dataclasses.dataclass
class TrappingSetReport:
    """Deduplicated low-(a, b) spectrum of one parity-check matrix."""

    spectrum: Dict[Tuple[int, int], int]   # {(a, b): count of unique sets}
    sets: List[TrappingSet]                # sorted by (b, a)
    a_max: int
    b_max: int
    n: int
    m: int

    def min_b(self, a: int) -> Optional[int]:
        """Smallest b found among size-a sets (None if none recorded)."""
        bs = [b for (aa, b) in self.spectrum if aa == a]
        return min(bs) if bs else None

    def dominant(self, k: int = 10) -> List[TrappingSet]:
        """The k most floor-relevant sets (smallest b, then smallest a)."""
        return self.sets[:k]

    # per-(a, b) unique/elementary/absorbing counts over ALL unique sets
    # found (``sets`` itself is capped at max_sets; these counts are not —
    # and ``spectrum[(a, b)] == counts[(a, b)]['unique']`` by construction)
    counts: Dict[Tuple[int, int], Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    def class_counts(self) -> Dict[Tuple[int, int], Dict[str, int]]:
        return self.counts

    def summary(self) -> str:
        lines = [f"trapping-set spectrum (a<={self.a_max}, b<={self.b_max}, "
                 f"greedy search) of H [{self.m}, {self.n}]:"]
        cc = self.class_counts()
        for (a, b) in sorted(cc, key=lambda ab: (ab[1], ab[0])):
            d = cc[(a, b)]
            lines.append(f"  ({a:2d},{b:2d}): {d['unique']:5d} unique, "
                         f"{d['elementary']:5d} elementary, "
                         f"{d['absorbing']:5d} absorbing")
        return "\n".join(lines)


def _as_H(code_or_H) -> np.ndarray:
    H = getattr(code_or_H, "H", code_or_H)
    H = np.asarray(H)
    return (H != 0).astype(np.int8)


def _classify(H: np.ndarray, members: np.ndarray) -> TrappingSet:
    """Exact (a, b) + elementary/absorbing flags for one VN set."""
    deg = H[:, members].sum(axis=1)
    odd = np.flatnonzero(deg % 2 == 1)
    touched = deg > 0
    elementary = bool(np.all(deg[touched] <= 2)) if touched.any() else True
    odd_mask = np.zeros(H.shape[0], bool)
    odd_mask[odd] = True
    sub = H[:, members].astype(bool)
    n_odd = sub[odd_mask].sum(axis=0)     # per-VN odd-check neighbors
    n_all = sub.sum(axis=0)
    absorbing = bool(np.all(n_odd * 2 < n_all))
    return TrappingSet(variables=tuple(int(v) for v in members),
                       a=len(members), b=len(odd),
                       odd_checks=tuple(int(c) for c in odd),
                       elementary=elementary, absorbing=absorbing)


def find_trapping_sets(code_or_H, a_max: int = 8, b_max: int = 4,
                       restarts: int = 2, seed: int = 0,
                       max_sets: int = 2000) -> TrappingSetReport:
    """Greedy low-(a, b) trapping-set search over every VN seed.

    ``restarts``: greedy passes; the first breaks score ties by lowest
    index (deterministic), later ones by a random perturbation <1 (only
    reorders exact ties). Sets with ``b <= b_max`` along every greedy
    trajectory are recorded, deduplicated, re-verified against H, and
    returned sorted by (b, a); ``max_sets`` caps the report (counts in
    ``spectrum`` are over unique recorded sets).
    """
    H = _as_H(code_or_H)
    m, n = H.shape
    # a seed saturates all n variables after n-1 additions; past that the
    # all-inf argmin would re-add v=0 and corrupt the degree counters
    a_max = min(a_max, n)
    Hf = H.astype(np.float32)
    HTi = H.T.astype(np.int32)            # [n, m] row gather per added VN
    rng = np.random.default_rng(seed)
    found: Dict[frozenset, None] = {}

    for r in range(restarts):
        deg = HTi.copy()                   # [n_seeds=n, m] induced degrees
        member = np.eye(n, dtype=bool)     # [seeds, n]

        def record():
            bs = (deg % 2 == 1).sum(axis=1)
            for i in np.flatnonzero(bs <= b_max):
                found[frozenset(np.flatnonzero(member[i]).tolist())] = None

        record()                           # a=1 seeds (b = dv)
        for _ in range(a_max - 1):
            s = np.where(deg % 2 == 0, 1.0, -1.0).astype(np.float32)
            delta = s @ Hf                 # [seeds, n] b-change per candidate
            delta[member] = np.inf
            if r > 0:
                # integer deltas: a <1 perturbation only reorders exact ties
                delta = delta + rng.random(delta.shape, np.float32) * 0.5
            v = np.argmin(delta, axis=1)   # [seeds]
            member[np.arange(n), v] = True
            deg += HTi[v]
            record()

    sets = []
    spectrum: Dict[Tuple[int, int], int] = {}
    counts: Dict[Tuple[int, int], Dict[str, int]] = {}
    for fs in found:
        ts = _classify(H, np.array(sorted(fs), dtype=np.int64))
        assert ts.b <= b_max
        spectrum[(ts.a, ts.b)] = spectrum.get((ts.a, ts.b), 0) + 1
        d = counts.setdefault((ts.a, ts.b),
                              dict(unique=0, elementary=0, absorbing=0))
        d["unique"] += 1
        d["elementary"] += int(ts.elementary)
        d["absorbing"] += int(ts.absorbing)
        sets.append(ts)
    sets.sort(key=lambda t: (t.b, t.a, t.variables))
    return TrappingSetReport(spectrum=spectrum, sets=sets[:max_sets],
                             a_max=a_max, b_max=b_max, n=n, m=m,
                             counts=counts)


def trapping_set_profile(code_or_H, a_max: int = 8,
                         restarts: int = 2, seed: int = 0
                         ) -> Dict[int, int]:
    """{a: minimum b found} — the floor-relevance fingerprint of a graph
    (lower b at small a = worse floor). Runs the same greedy search with
    an unbounded record threshold."""
    H = _as_H(code_or_H)
    rep = find_trapping_sets(H, a_max=a_max, b_max=int(H.sum(axis=0).max())
                             * a_max, restarts=restarts, seed=seed,
                             max_sets=1)
    out: Dict[int, int] = {}
    for (a, b) in rep.spectrum:
        out[a] = min(out.get(a, b), b)
    return out
