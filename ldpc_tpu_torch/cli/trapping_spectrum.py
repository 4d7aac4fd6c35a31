"""Trapping-set spectra of the measured codes, computed without decoding a
frame (twin of ``experiments/trapping_spectrum.py``).

The structural side of the PBRL floor study: the low-(a, b) trapping-set
spectrum of each graph from ``design.find_trapping_sets`` (host numpy,
seeded, so the spectra are those of the JAX program exactly). A graph
with more small-(a, b) classes, low-b absorbing sets above all, is
expected to floor higher. Five codes:

- QC PBRL (3096, 1032) at lift 86 (``create_pbrl_qc_protograph(k=1032,
  rate=1/3)``, the floored code);
- ``k=1032`` at lift 258: an 8x12 base, n = 3096 (the program's own
  "lift 258" code; ``pbrl_lift_floor``'s lift-258 code is ``k=3096``);
- the precoded PBRL code at lift 86 (25x37 base, n = 3182);
- the bench QC (9472, 8192) code (``default_rng(0)``'s 5x37 base, lift
  256), searched with 2 restarts;
- Tanner (155, 64) (``codes/tanner_155_64.proto``, lift 31).

One search a code (a <= 8, b unbounded: the largest column degree times
a; 3 restarts, seed 0, at most 10000 sets) gives both outputs: the
spectrum of the classes with b <= 4 (unique, elementary and absorbing
counts) and the min-b fingerprint, the smallest b recorded at each a.
The report goes to ``out_path`` (default ``trapping_spectrum_torch.json``
in the working directory) with the program's keys. No device is used, and
like the program the twin has no options.

    python -m ldpc_tpu_torch.cli.trapping_spectrum
"""

from __future__ import annotations

import json
import os

import numpy as np

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.design import find_trapping_sets

__all__ = ["CODES", "DEFAULT_OUT", "profile", "codes", "main"]

CODES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "codes")
DEFAULT_OUT = "trapping_spectrum_torch.json"


def profile(name, H, a_max=8, b_max=4, restarts=3, verbose=True):
    """``{"spectrum": {"a,b": counts}, "min_b_fingerprint": {a: b}}`` of
    ``H`` from one search with b unbounded
    (``trapping_spectrum.py:44-70``)."""
    dv_max = int(np.asarray(H).sum(axis=0).max())
    rep = find_trapping_sets(H, a_max=a_max, b_max=dv_max * a_max,
                             restarts=restarts, seed=0, max_sets=10000)
    low = {ab: d for ab, d in rep.class_counts().items() if ab[1] <= b_max}
    if verbose:
        print(f"== {name} ==", flush=True)
        print(f"trapping-set spectrum (a<={a_max}, b<={b_max} shown) of "
              f"H {list(np.asarray(H).shape)}:", flush=True)
        for (a, b) in sorted(low, key=lambda ab: (ab[1], ab[0])):
            d = low[(a, b)]
            print(f"  ({a:2d},{b:2d}): {d['unique']:5d} unique, "
                  f"{d['elementary']:5d} elementary, "
                  f"{d['absorbing']:5d} absorbing", flush=True)
    fingerprint = {}
    for (a, b) in rep.class_counts():
        fingerprint[a] = min(fingerprint.get(a, b), b)
    if verbose:
        print(f"  min-b fingerprint: "
              f"{ {a: fingerprint[a] for a in sorted(fingerprint)} }",
              flush=True)
    spec = {f"{a},{b}": d for (a, b), d in sorted(low.items())}
    return dict(spectrum=spec, min_b_fingerprint=dict(sorted(
        fingerprint.items())))


def codes():
    """``[(key, title, H, restarts)]`` of the five codes in the program's
    order (``trapping_spectrum.py:73-106``)."""
    out = []
    for key, title, kw in (
            ("pbrl_qc_lift86", "QC PBRL (3096,1032) lift 86", dict(lift=86)),
            ("pbrl_qc_lift258", "QC PBRL (3096,1032) lift 258",
             dict(lift=258)),
            ("pbrl_qc_precoded_lift86", "QC PBRL precoded (punctured "
             "high-degree node), lift 86", dict(lift=86, precode=True))):
        base, lift = lt.create_pbrl_qc_protograph(k=1032, rate=1 / 3,
                                                  **kw)[:2]
        out.append((key, title, lt.create_qc_code(
            base, lift=lift, max_iterations=5).H, 3))
    bench_base = np.random.default_rng(0).integers(0, 256, size=(5, 37))
    out.append(("bench_qc_9472", "bench QC (9472,8192) lift 256",
                lt.create_qc_code(bench_base, lift=256,
                                  max_iterations=5).H, 2))
    base, lift = lt.load_protograph(os.path.join(CODES, "tanner_155_64.proto"))
    out.append(("tanner_155_64", "Tanner (155,64)",
                lt.create_qc_code(base, lift=lift, max_iterations=5).H, 3))
    return out


def main(out_path=DEFAULT_OUT, verbose=True):
    """Every code's profile; writes the report to ``out_path`` and returns
    it."""
    results = {key: profile(title, H, restarts=restarts, verbose=verbose)
               for key, title, H, restarts in codes()}
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    if verbose:
        print(f"results -> {out_path}", flush=True)
    return results


if __name__ == "__main__":
    main()
