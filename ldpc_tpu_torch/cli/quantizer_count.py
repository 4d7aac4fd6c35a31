"""The quantizer-count rule: two CN quantizer pairs against three (twin of
``experiments/quantizer_count.py``).

The arms differ only in how many (C, gamma) pairs ``phase_schedule(T,
Q)`` cycles through. With Q = 2 it gives iteration t the first pair for
t < T // 3 and the second after (``quantizer.py``'s thirds rule): at T=6
iterations 0-1 and 2-5, at T=10 0-2 and 3-9. Four phases:

- ``--phase design`` (:func:`design`, host numpy): a 2-pair CN ladder
  for the bench protograph by ``iterate_refine`` (bc=3, bv=8 with the
  uniform V2C ladder 4-8-12, layered T=6, seeded with the DDE ladder's
  outer pairs, at most 4 passes), written to
  ``quantizer_count_design_torch.json`` in the working directory;
- ``--phase design13`` (:func:`design13`, host numpy): the same for the
  precoded PBRL rate-1/3 protograph (``create_pbrl_qc_protograph(k=1032,
  rate=1/3, lift=43, precode=True, core_rate=8/9)``: a 49x73 base, n =
  3139, base column 0 punctured) at bc=4, T=10, at most 6 passes, grid
  1/8, written to ``quantizer_count_design13_torch.json``;
- ``--phase deep`` (:func:`deep`): the bench code (lift 256), RCQ bc=3,
  layered T=6, the arms ``rcq-q2`` (the best pass of ``--design``, by
  default the committed ``experiments/quantizer_count_design.json``, read
  only) and ``rcq-q3`` (the DDE ladder 2.6474-3.0869-5.3767 @ 1.3),
  through the whole-decode layered kernel (K1, ``csrc/fused_layered.cu``)
  with the lean output: from 6.0 dB in 0.2 dB steps to 7.8 dB under the
  {3, 6} two-checkpoint compaction (waves of 32768, survivor budget 4096)
  until ``--errors`` frame errors once 65,536 frames ran, or ``--frames``
  frames; results in ``quantizer_count_torch.json``;
- ``--phase deep13`` (:func:`deep13`): the precoded PBRL code at lift 43,
  RCQ bc=4, bv=8, layered T=10, with the full output; the arms ``p2``
  (``experiments/quantizer_count_design13_polish.json``) and ``p3``
  (``experiments/pbrl_rates_design_13_polish.json``), from 1.4 dB to 3.6
  dB under {5, 10} (waves of 98304, budget 4096), the 43 bits of base
  column 0 punctured; results in ``quantizer_count13_torch.json``.

K1 runs in bf16 on the card (on the CPU its plain version in float32).
Each deep phase writes its file after every point, resumes from it, and
stops an arm at its first point with no error, one read from the file
included. Everything is written in the working directory, never under
``experiments/``.

    python -m ldpc_tpu_torch.cli.quantizer_count --phase
        design|design13|deep|deep13 [--errors 50] [--frames 1000000000]
        [--arms p2 p3] [--design PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import ldpc_tpu_torch as lt
from ldpc_tpu_torch import design as dsg
from ldpc_tpu_torch.cli import deep_fer
from ldpc_tpu_torch.cli.generate_images import EXPERIMENTS
from ldpc_tpu_torch.cli.ladder_bc4 import fused_options

__all__ = ["T", "BC", "BV", "LIFT", "Q3_CN", "VQP", "DESIGN_PATH",
           "DESIGN_RECORD", "CK_DIR", "OUT", "PBRL_DESIGN", "OUT13",
           "PBRL_T", "PBRL_BC", "PBRL_BV", "POLISH13", "bench_base",
           "design", "_mk", "_pbrl13", "design13", "_mk13",
           "deep13_config", "deep13", "deep_config", "deep", "main"]

T, BC, BV = 6, 3, 8
LIFT = 256
Q3_CN = ((2.6474, 1.3), (3.0869, 1.3), (5.3767, 1.3))  # bench DDE ladder
VQP = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
DESIGN_PATH = "quantizer_count_design_torch.json"
DESIGN_RECORD = str(EXPERIMENTS / "quantizer_count_design.json")
CK_DIR = "quantizer_count_torch_ck"
OUT = "quantizer_count_torch.json"
PBRL_DESIGN = "quantizer_count_design13_torch.json"
OUT13 = "quantizer_count13_torch.json"
PBRL_T, PBRL_BC, PBRL_BV = 10, 4, 8
# the arms' floor-polished ladders (quantizer_count.py:171-179)
POLISH13 = {"p3": str(EXPERIMENTS / "pbrl_rates_design_13_polish.json"),
            "p2": str(EXPERIMENTS / "quantizer_count_design13_polish.json")}


def bench_base():
    return deep_fer.bench_base(LIFT)


def design(max_passes: int = 4, verbose: bool = True):
    """Host: the 2-pair CN ladder for the bench protograph, seeded with
    the DDE ladder's outer pairs (``quantizer_count.py:70-92``); writes
    DESIGN_PATH and returns its dict."""
    hist = dsg.iterate_refine(
        bench_base(), ((2.6474, 1.3), (5.3767, 1.3)), VQP, bc=BC, bv=BV,
        max_iterations=T, snr_db=None, schedule="layered",
        max_passes=max_passes, min_gain_db=0.01, grid_step=1 / 32,
        sweep=(0.6, 0.8, 0.9, 1.1, 1.25, 1.6), verbose=verbose)
    out = hist.to_dict()
    with open(DESIGN_PATH, "w") as f:
        json.dump(out, f, indent=2)
    print(f"q2 design: best pass {hist.best.index} "
          f"thr {hist.best.threshold_db:.3f} ({hist.stopped_by})",
          flush=True)
    return out


def _mk(arm, device="cuda", design_path: str = DESIGN_RECORD):
    """(decoder, code) of a bench arm; ``rcq-q2``'s ladder is the best
    pass of the design file ``design_path``."""
    if arm == "rcq-q3":
        qp = Q3_CN
    elif arm == "rcq-q2":
        with open(design_path) as f:
            d = json.load(f)
        qp = tuple(tuple(x) for x in d["passes"][d["best_index"]]["cn"])
    else:
        raise ValueError(arm)
    base = bench_base()
    code = lt.create_qc_code(base, lift=LIFT, max_iterations=T)
    return lt.make_decoder(
        code, kind="rcq", bc=BC, bv=BV, quantizer_params=qp,
        v2c_quantizer_params=VQP, max_iterations=T,
        qc=lt.build_qc_graph(base, LIFT), layered=True,
        qc_options=fused_options(device, lean=True), device=device), code


def _pbrl13():
    """(base, lift, punctured base columns) of the precoded rate-1/3
    code at lift 43."""
    return lt.create_pbrl_qc_protograph(k=1032, rate=1 / 3, lift=43,
                                        precode=True, core_rate=8 / 9)


def design13(max_passes: int = 6, verbose: bool = True):
    """Host: the 2-pair CN ladder for the precoded PBRL rate-1/3 graph,
    with the floor-aware refine of the 3-pair arm, seeded with its outer
    pairs (``quantizer_count.py:122-148``); writes PBRL_DESIGN and returns
    its dict."""
    base, lift, punct = _pbrl13()
    hist = dsg.iterate_refine(
        base, ((6.797, 1.3), (6.5867, 1.3)), VQP, bc=PBRL_BC, bv=PBRL_BV,
        max_iterations=PBRL_T, snr_db=None, schedule="layered",
        punctured_cols=punct, max_passes=max_passes, min_gain_db=0.01,
        grid_step=1 / 8, sweep=(0.5, 0.7, 0.9, 1.1, 1.4, 2.0),
        verbose=verbose)
    out = hist.to_dict()
    with open(PBRL_DESIGN, "w") as f:
        json.dump(out, f, indent=2)
    b = hist.best
    print(f"pbrl13 2-pair design: best pass {b.index} thr "
          f"{b.threshold_db:.3f} floor {b.de_floor} ({hist.stopped_by})",
          flush=True)
    return out


def _mk13(arm, device="cuda"):
    """(decoder, punctured bit positions) of a PBRL arm: base column 0's
    43 bits."""
    base, lift, punct = _pbrl13()
    code = lt.create_qc_code(base, lift=lift, max_iterations=PBRL_T)
    punct_bits = tuple(range(lift * punct[0], lift * (punct[0] + 1)))
    if arm not in POLISH13:
        raise ValueError(arm)
    with open(POLISH13[arm]) as f:
        p = json.load(f)
    qp = tuple(tuple(x) for x in p["cn"])
    dec = lt.make_decoder(
        code, kind="rcq", bc=PBRL_BC, bv=PBRL_BV, quantizer_params=qp,
        v2c_quantizer_params=VQP, max_iterations=PBRL_T,
        qc=lt.build_qc_graph(base, lift), layered=True,
        qc_options=fused_options(device), device=device)
    return dec, punct_bits


def deep13_config(snr: float, punct_bits, errors: int = 100,
                  frames: int = 5 * 10 ** 7,
                  device="cuda") -> lt.SimulationConfig:
    """One PBRL point's Monte-Carlo (``quantizer_count.py:200-205``)."""
    return lt.SimulationConfig(
        snr_range=(snr, snr), max_frames=frames, max_errors=errors,
        min_frames=65536, wave_size=98304, early_exit_iters=5,
        survivor_budget=4096, punctured_positions=punct_bits,
        save_results=False, device=device)


def _sweep(arms, mk, config, out_path, snr_lo, snr_hi, snr_step, label,
           verbose):
    """Each arm's points from ``snr_lo``, resumed from and written to
    ``out_path``, until ``snr_hi`` or the first point with no error (one
    read from the file included)."""
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    for arm in arms:
        dec, extra = mk(arm)
        pts = results.setdefault(arm, {})
        snr = snr_lo
        while snr <= snr_hi + 1e-9:
            key = f"{snr:.1f}"
            if key not in pts:
                fer, ber, it, nf, ne = lt.simulate_single_snr(
                    dec, snr, config(snr, extra))
                pts[key] = {"fer": fer, "frames": nf, "errors": ne}
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=2)
                if verbose:
                    print(f"{label}{arm} @ {snr:.1f}: FER {fer:.3e} "
                          f"({ne}/{nf})", flush=True)
            if pts[key]["errors"] == 0:
                break
            snr = round(snr + snr_step, 10)
    return results


def deep13(arms=("p2", "p3"), snr_lo=1.4, snr_hi=3.6, snr_step=0.2,
           errors=100, frames=5 * 10 ** 7, verbose=True, device="cuda"):
    """The deep points of the PBRL arms in OUT13; returns {arm: {SNR:
    {"fer", "frames", "errors"}}}."""
    return _sweep(arms, lambda arm: _mk13(arm, device),
                  lambda snr, punct: deep13_config(snr, punct, errors,
                                                   frames, device),
                  OUT13, snr_lo, snr_hi, snr_step, "pbrl13/", verbose)


def deep_config(snr: float, errors: int = 50, frames: int = 10 ** 9,
                device="cuda") -> lt.SimulationConfig:
    """One bench point's Monte-Carlo (``quantizer_count.py:236-240``)."""
    return lt.SimulationConfig(
        snr_range=(snr, snr), max_frames=frames, max_errors=errors,
        min_frames=65536, wave_size=32768, early_exit_iters=3,
        survivor_budget=4096, save_results=False, device=device)


def deep(arms=("rcq-q2", "rcq-q3"), snr_lo=6.0, snr_hi=7.8,
         snr_step=0.2, errors=50, frames=10 ** 9, verbose=True,
         device="cuda", design: str = DESIGN_RECORD):
    """The deep points of the bench arms in OUT (``rcq-q2`` from the
    design file ``design``); returns {arm: {SNR: {"fer", "frames",
    "errors"}}}."""
    os.makedirs(CK_DIR, exist_ok=True)
    return _sweep(arms, lambda arm: _mk(arm, device, design),
                  lambda snr, _: deep_config(snr, errors, frames, device),
                  OUT, snr_lo, snr_hi, snr_step, "", verbose)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=["design", "deep", "design13",
                                        "deep13"], required=True)
    ap.add_argument("--errors", type=int, default=50)
    ap.add_argument("--frames", type=int, default=10 ** 9)
    ap.add_argument("--arms", nargs="+", default=None,
                    help="deep13 arms (default: p2 p3)")
    ap.add_argument("--design", default=DESIGN_RECORD,
                    help="the design file of rcq-q2's ladder (deep)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.phase in ("design", "design13"):
        design() if args.phase == "design" else design13()
    else:
        # the simulator's heartbeat lines
        logging.basicConfig(level=logging.INFO, force=True)
        if args.phase == "deep":
            deep(errors=args.errors, frames=args.frames, device=args.device,
                 design=args.design)
        else:
            deep13(arms=tuple(args.arms or ("p2", "p3")),
                   errors=args.errors,
                   frames=min(args.frames, 5 * 10 ** 7), device=args.device)


if __name__ == "__main__":
    main()
