"""The error floor of the QC PBRL rate-1/3 code by importance sampling of
its absorbing-set classes (twin of ``experiments/floor_is.py``).

For each of two arms, the random variant (``create_pbrl_qc_protograph(
k=1032, rate=1/3)``, n = 3096) and the precoded one (``precode=True``:
n = 3182, the precode column's 86 bits punctured, so its IS channel
zeroes their LLRs as the measured system does), with plain RCQ bc=4 on
the 6-11-16 @ gamma 1.3 CN ladder and the uniform bv=8 V2C ladder 4-8-12,
layered T=10:

1. ``design.find_trapping_sets`` (a <= 8, b <= 3, 3 restarts, at most
   10000 sets; host numpy) and the class choice: absorbing classes first,
   then by (b, a), the first ``--classes``; a class with absorbing
   members keeps only those as exemplars, and its multiplicity is its
   absorbing count (else its unique count);
2. at each of ``--snrs`` dB, for up to ``--exemplars`` exemplars a class,
   ``sim.importance.estimate_trapping_floor`` with the mean shift
   ``--shift`` on the exemplar's variables, ``--samples`` samples in
   batches of 2^11: the probability that the decoder fails with every
   wrong bit inside the exemplar. The seed of (arm, a, b, exemplar) is
   ``SeedSequence([20260818, arm, a, b, exemplar])``'s first 64-bit word,
   in place of the JAX program's ``fold_in`` of the same numbers into
   ``PRNGKey(20260818)``;
3. the union-bound floor: the sum over classes of multiplicity times the
   mean of the exemplars' probabilities.

On the card the decoder is the whole-decode layered kernel (K1,
``csrc/fused_layered.cu``) in bf16, as the JAX program takes its fused
kernel on a TPU; on the CPU it is the layered QC engine in float32, as
the JAX program runs off the TPU. The report goes to ``--out`` (default
``floor_is_torch.json`` in the working directory) with the program's
keys.

    python -m ldpc_tpu_torch.cli.floor_is [--samples 32768]
        [--exemplars 3] [--shift 1.6] [--classes 4] [--snrs 3.2 3.6 4.0]
        [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.design import find_trapping_sets
from ldpc_tpu_torch.sim import estimate_trapping_floor

__all__ = ["QP", "VQP8", "K", "RATE", "T", "BATCH", "SEED", "SEARCH",
           "ARMS", "DEFAULT_OUT", "Arm", "protograph", "fused_options",
           "make_decoder", "choose_classes", "arm", "exemplar_seed",
           "estimate_arm", "main", "cli"]

QP = ((6.0, 1.3), (11.0, 1.3), (16.0, 1.3))
VQP8 = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
K, RATE, T, BATCH, SEED = 1032, 1 / 3, 10, 2 ** 11, 20260818
# find_trapping_sets' arguments (floor_is.py:78-79)
SEARCH = dict(a_max=8, b_max=3, restarts=3, max_sets=10000)
ARMS = (("random", False), ("precoded", True))
DEFAULT_OUT = "floor_is_torch.json"


@dataclasses.dataclass
class Arm:
    """One arm's decoder, punctured positions and chosen classes:
    ``chosen[(a, b)]`` its exemplars, ``mult[(a, b)]`` its multiplicity;
    ``search_s`` the host seconds of the trapping-set search."""

    name: str
    decoder: object
    punctured: tuple | None
    classes: list
    chosen: dict
    mult: dict
    search_s: float


def protograph(precode: bool):
    """(base, lift, punctured bit positions or None)
    (``floor_is.py:56-66``)."""
    if not precode:
        return (*lt.create_pbrl_qc_protograph(k=K, rate=RATE), None)
    base, lift, cols = lt.create_pbrl_qc_protograph(k=K, rate=RATE,
                                                    precode=True)
    return base, lift, tuple(range(lift * cols[0], lift * (cols[0] + 1)))


def fused_options(device):
    """K1 in bf16 on the card; the layered QC engine (no options) on the
    CPU (``floor_is.py:69-71``)."""
    if torch.device(device).type == "cpu":
        return None
    return dict(fused=True, dtype=torch.bfloat16)


def make_decoder(base, lift, device="cuda"):
    """Plain RCQ bc=4, layered T=10 (``floor_is.py:67-75``)."""
    code = lt.create_qc_code(base, lift=lift, max_iterations=T)
    return lt.make_decoder(
        code, kind="rcq", bc=4, bv=8, quantizer_params=QP,
        v2c_quantizer_params=VQP8, max_iterations=T,
        qc=lt.build_qc_graph(base, lift), layered=True,
        qc_options=fused_options(device), device=device)


def choose_classes(H, n_classes: int = 4):
    """The trapping-set search on ``H`` and the class choice
    (``floor_is.py:78-97``): ``(classes, chosen, mult)``."""
    rep = find_trapping_sets(H, **SEARCH)
    chosen = {}
    for ts in rep.sets:
        chosen.setdefault((ts.a, ts.b), []).append(ts)
    # absorbing classes first (min-sum cannot leave them; a degree-1
    # (1, 1) singleton is benign), then by (b, a)
    cc = rep.class_counts()
    classes = sorted(chosen, key=lambda ab: (cc[ab]["absorbing"] == 0,
                                             ab[1], ab[0]))[:n_classes]
    for ab in classes:
        absb = [t for t in chosen[ab] if t.absorbing]
        if absb:
            chosen[ab] = absb
    # p is measured on absorbing exemplars where the class has any, so
    # the multiplicity is that subpopulation's
    mult = {ab: cc[ab]["absorbing"] or cc[ab]["unique"] for ab in classes}
    return classes, chosen, mult


def arm(name: str, precode: bool, n_classes: int = 4, device="cuda") -> Arm:
    """One arm built and its classes chosen."""
    base, lift, punct = protograph(precode)
    dec = make_decoder(base, lift, device)
    t0 = time.perf_counter()
    classes, chosen, mult = choose_classes(dec.code.H, n_classes)
    return Arm(name, dec, punct, classes, chosen, mult,
               time.perf_counter() - t0)


def exemplar_seed(arm_i: int, ab, i: int) -> int:
    """The IS seed of exemplar ``i`` of class ``ab`` in arm ``arm_i``."""
    return int(np.random.SeedSequence([SEED, arm_i, ab[0], ab[1], i])
               .generate_state(1, np.uint64)[0])


def estimate_arm(a: Arm, arm_i: int, snrs, samples: int = 2 ** 15,
                 exemplars: int = 3, shift: float = 1.6,
                 verbose: bool = True) -> dict:
    """``{"classes": {snr: {"a,b": ...}}, "floor": {snr: ...}}`` of one
    arm (``floor_is.py:98-126``)."""
    out = {"classes": {}}
    for snr in snrs:
        per_class = {}
        for ab in a.classes:
            ps = []
            for i, ts in enumerate(a.chosen[ab][:exemplars]):
                est = estimate_trapping_floor(
                    a.decoder, [((ts.a, ts.b), 1, ts.variables)], snr_db=snr,
                    shift=shift, n_samples=samples, batch=BATCH,
                    seed=exemplar_seed(arm_i, ab, i), punctured=a.punctured)
                _, p, rel = est.per_class[ab]
                ps.append((p, rel))
            pbar = float(np.mean([p for p, _ in ps]))
            mult = a.mult[ab]
            per_class[f"{ab[0]},{ab[1]}"] = dict(
                multiplicity=int(mult), p_mean=pbar,
                exemplars=[[float(p), float(r)] for p, r in ps],
                contribution=mult * pbar)
            if verbose:
                print(f"{a.name} @ {snr} dB class {ab} x{mult}: "
                      f"p~{pbar:.3e} -> {mult * pbar:.3e}", flush=True)
        total = sum(v["contribution"] for v in per_class.values())
        out["classes"][str(snr)] = per_class
        out.setdefault("floor", {})[str(snr)] = total
        if verbose:
            print(f"{a.name} @ {snr} dB union-bound floor ~ {total:.3e}",
                  flush=True)
    return out


def main(samples=2 ** 15, exemplars=3, shift=1.6, snrs=(3.2, 3.6, 4.0),
         n_classes=4, out_path=DEFAULT_OUT, device="cuda", verbose=True):
    """Both arms; writes the report to ``out_path`` and returns it."""
    results = {}
    for arm_i, (name, precode) in enumerate(ARMS):
        results[name] = estimate_arm(arm(name, precode, n_classes, device),
                                     arm_i, snrs, samples, exemplars, shift,
                                     verbose=verbose)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"results -> {out_path}", flush=True)
    return results


def cli(argv=None):
    """The command line of ``floor_is.py`` plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=2 ** 15)
    ap.add_argument("--exemplars", type=int, default=3)
    ap.add_argument("--shift", type=float, default=1.6)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--snrs", type=float, nargs="+",
                    default=[3.2, 3.6, 4.0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    main(samples=args.samples, exemplars=args.exemplars, shift=args.shift,
         n_classes=args.classes, snrs=tuple(args.snrs), out_path=args.out,
         device=args.device)


if __name__ == "__main__":
    cli()
