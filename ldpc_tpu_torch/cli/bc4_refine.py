"""bc=4 against bc=3 on the bench code, with the iterated refine's design
(twin of ``experiments/bc4_refine.py``).

Three phases:

- ``--phase design`` (:func:`design`, host numpy): ``iterate_refine`` at
  bc=4 from the bench's bc=3 DDE ladder 2.6474-3.0869-5.3767 @ gamma 1.3
  (the uniform bv=8 V2C ladder 4-8-12, layered T=6, the design SNR
  estimated, at most 5 passes, gain 0.01 dB, grid 1/32, C sweep 0.6-1.6
  and the default gamma sweep), written to ``bc4_refine_design_torch.json``
  in the working directory;
- ``--phase deep`` (:func:`deep`): the arms ``bc4`` (the CN ladder of the
  committed ``experiments/bc4_floor_polish.json``, read-only: the
  floor-polished 1.2708 @ 2.2, 6.7912 @ 2.2, 6.6537 @ 1.5) and ``bc3``
  (the DDE ladder), and ``bc4-seed`` (bc=4 on the DDE ladder) when asked
  for. Each is RCQ, bv=8, layered T=6 through the whole-decode layered
  kernel (K1, ``csrc/fused_layered.cu``) with the lean output, bf16 on
  the card (on the CPU the kernel's plain version in float32). From 6.0
  dB in 0.2 dB steps to 7.6 dB, each point under the {3, 6}
  two-checkpoint compaction (waves of 32768 frames, survivor budget 4096)
  until ``--errors`` frame errors once 65,536 frames ran, or ``--frames``
  frames; an arm stops at the first point it measures with no error.
  After every point the results go to ``bc4_refine_torch.json`` in the
  working directory, and a rerun resumes from it (a point there is not
  measured again);
- ``--phase report`` (:func:`report`): prints those points.

    python -m ldpc_tpu_torch.cli.bc4_refine --phase design|deep|report
        [--errors 100] [--frames 200000000] [--device cpu]
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

__all__ = ["T", "BV", "LIFT", "BC3_CN", "VQP", "DESIGN_PATH", "OUT",
           "POLISH", "bench_base", "design", "ladder",
           "_mk", "deep_config", "deep", "report", "main"]

T, BV = 6, 8
LIFT = 256
BC3_CN = ((2.6474, 1.3), (3.0869, 1.3), (5.3767, 1.3))  # bench DDE ladder
VQP = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
DESIGN_PATH = "bc4_refine_design_torch.json"
OUT = "bc4_refine_torch.json"
POLISH = str(EXPERIMENTS / "bc4_floor_polish.json")


def bench_base():
    return deep_fer.bench_base(LIFT)


def design(max_passes: int = 5, verbose: bool = True):
    """Host: the bc=4 CN ladder by iterated refine (C and gamma sweeps),
    seeded from the bc=3 DDE ladder (``bc4_refine.py:45-63``); writes
    DESIGN_PATH and returns its dict."""
    hist = dsg.iterate_refine(
        bench_base(), BC3_CN, VQP, bc=4, bv=BV, max_iterations=T,
        snr_db=None, schedule="layered", max_passes=max_passes,
        min_gain_db=0.01, grid_step=1 / 32,
        sweep=(0.6, 0.8, 0.9, 1.1, 1.25, 1.6), verbose=verbose)
    out = hist.to_dict()
    with open(DESIGN_PATH, "w") as f:
        json.dump(out, f, indent=2)
    print(f"bc4 design: best pass {hist.best.index} "
          f"thr {hist.best.threshold_db:.3f} ({hist.stopped_by})",
          flush=True)
    return out


def ladder(arm: str):
    """(bc, CN ladder) of ``arm`` (``bc4_refine.py:81-94``)."""
    if arm == "bc3":
        return 3, BC3_CN
    if arm == "bc4":
        with open(POLISH) as f:
            d = json.load(f)
        return 4, tuple(tuple(x) for x in d["cn"])
    if arm == "bc4-seed":   # the unpolished arm, for the A/B record
        return 4, BC3_CN
    raise ValueError(arm)


def _mk(arm, device="cuda"):
    """(decoder, code) of ``arm``."""
    bc, qp = ladder(arm)
    base = bench_base()
    code = lt.create_qc_code(base, lift=LIFT, max_iterations=T)
    return lt.make_decoder(
        code, kind="rcq", bc=bc, bv=BV, quantizer_params=qp,
        v2c_quantizer_params=VQP, max_iterations=T,
        qc=lt.build_qc_graph(base, LIFT), layered=True,
        qc_options=fused_options(device, lean=True), device=device), code


def deep_config(snr: float, errors: int = 100, frames: int = 2 * 10 ** 8,
                device="cuda") -> lt.SimulationConfig:
    """One point's Monte-Carlo (``bc4_refine.py:111-115``)."""
    return lt.SimulationConfig(
        snr_range=(snr, snr), max_frames=frames, max_errors=errors,
        min_frames=65536, wave_size=32768, early_exit_iters=3,
        survivor_budget=4096, save_results=False, device=device)


def deep(arms=("bc4", "bc3"), snr_lo=6.0, snr_hi=7.6, snr_step=0.2,
         errors=100, frames=2 * 10 ** 8, verbose=True, device="cuda"):
    """The deep points of ``arms``, resumed from and written to OUT;
    returns {arm: {SNR to 0.1 dB: {"fer", "frames", "errors"}}}."""
    results = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            results = json.load(f)
    for arm in arms:
        dec, code = _mk(arm, device)
        pts = results.setdefault(arm, {})
        snr = snr_lo
        while snr <= snr_hi + 1e-9:
            key = f"{snr:.1f}"
            if key not in pts:
                cfg = deep_config(snr, errors, frames, device)
                fer, ber, it, nf, ne = lt.simulate_single_snr(dec, snr, cfg)
                pts[key] = {"fer": fer, "frames": nf, "errors": ne}
                with open(OUT, "w") as f:
                    json.dump(results, f, indent=2)
                if verbose:
                    print(f"{arm} @ {snr:.1f}: FER {fer:.3e} ({ne}/{nf})",
                          flush=True)
                if ne == 0:
                    break
            snr = round(snr + snr_step, 10)
    return results


def report():
    with open(OUT) as f:
        results = json.load(f)
    for arm, pts in results.items():
        for s in sorted(pts, key=float):
            p = pts[s]
            print(f"{arm} @ {s}: {p['fer']:.3e} ({p['errors']}/"
                  f"{p['frames']})")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=["design", "deep", "report"],
                    required=True)
    ap.add_argument("--errors", type=int, default=100)
    ap.add_argument("--frames", type=int, default=2 * 10 ** 8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.phase == "design":
        design()
    elif args.phase == "deep":
        # the simulator's heartbeat lines
        logging.basicConfig(level=logging.INFO, force=True)
        deep(errors=args.errors, frames=args.frames, device=args.device)
    else:
        report()


if __name__ == "__main__":
    main()
