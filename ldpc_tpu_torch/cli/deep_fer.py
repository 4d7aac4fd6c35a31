"""Deep-FER campaign on the bench code down to FER 1e-7 (twin of
``experiments/deep_fer.py``).

On the QC code of ``bench.py`` (``default_rng(0)``'s 5x37 base, lift
256), with the 2-4-6 @ gamma 1.3 ladder and the uniform bv=8 V2C
quantizer on 4-8-12, in bf16 with the full output:

- three layered T=6 decoders through the whole-decode layered kernel
  (K1, ``csrc/fused_layered.cu``): RCQ bc=3, RCQ bc=4 and float min-sum,
  under the {3, 6} two-checkpoint compaction;
- the trained flooding T=10 W-OMS-RCQ (sharing type 2) through the
  flooding kernel (K4, ``csrc/fused_flooding.cu``) under {5, 10}. Its
  weights come from ``--weights``: a zoo entry (default
  ``worcq_bc3_qc9472``, whose tables equal the JAX program's
  ``experiments/orcq_bc3_ck`` element for element) or a directory written
  by ``save_checkpoint`` (``ldpc_tpu_torch.cli.accuracy_bc3`` writes
  ``orcq_bc3_torch_ck/``); ``--weights ''`` leaves the decoder out, and a
  path that is neither raises.

``LDPCSimulator`` runs waves of 32768 frames with a survivor budget of
``max(64, wave // 16)`` = 2048: stage 1 decodes every frame at T1, the
survivors are decoded at T, and a wave with more survivors than the
budget falls back to decoding all of it at both depths
(``sim/montecarlo.py``). Each SNR point of 6.4-6.7 dB (0.1 dB steps) runs
until 100 frame errors once ``min(4 * wave, frames)`` frames ran, or
``frames`` frames. After every point a decoder's curve is written to
``deep_fer_torch_ck/<decoder>.json`` in the working directory; rerunning
resumes after the points done (when the SNR list is the same). The JAX
package's checkpoints in ``experiments/deep_fer_ck/`` are never read or
written. The report, with each curve's floor verdict (the slope of
log10 FER per dB at the tail against the head), goes to ``--out``
(default ``deep_fer_torch.json`` in the working directory).

    python -m ldpc_tpu_torch.cli.deep_fer [--frames 50000000]
        [--errors 100] [--wave 32768] [--snr-lo 6.4] [--snr-hi 6.7]
        [--snr-step 0.1] [--weights ENTRY_OR_DIR] [--out PATH]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.utils.checkpoint import load_checkpoint

__all__ = ["QP", "VQP", "FUSED", "T1_LAYERED", "T1_FLOODING",
           "DEFAULT_WEIGHTS", "DEFAULT_OUT", "CHECKPOINTS", "bench_base",
           "load_weights", "qc_decoder", "layered_decoders",
           "trained_flooding_decoder", "campaign_config", "sweep",
           "floor_verdict", "run", "main"]

QP = ((2.0, 1.3), (4.0, 1.3), (6.0, 1.3))     # the selected ladder
VQP = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))   # uniform bv=8
FUSED = dict(fused=True, batch_tile=64, dtype=torch.bfloat16)
T1_LAYERED, T1_FLOODING = 3, 5
DEFAULT_WEIGHTS = "worcq_bc3_qc9472"
DEFAULT_OUT = "deep_fer_torch.json"
CHECKPOINTS = "deep_fer_torch_ck"


def bench_base(lift: int = 256) -> np.ndarray:
    """The bench protograph: ``default_rng(0)``'s 5x37 shifts mod lift."""
    return np.random.default_rng(0).integers(0, lift, size=(5, 37))


def load_weights(path: str):
    """The weight tables at ``path``: a directory written by
    ``save_checkpoint``, else a zoo entry (a directory with ``spec.json``,
    or an entry name of the zoo)."""
    if os.path.isdir(path) and \
            not os.path.exists(os.path.join(path, "spec.json")):
        return load_checkpoint(path)
    return lt.load_pretrained(path, device="cpu").weights


def qc_decoder(lift, T, device, **kw):
    """A fused decoder on the bench code at ``lift``, T iterations."""
    base = bench_base(lift)
    return lt.make_decoder(lt.create_qc_code(base, lift=lift,
                                             max_iterations=T),
                           max_iterations=T, qc=lt.build_qc_graph(base, lift),
                           qc_options=FUSED, device=device, **kw)


def layered_decoders(lift: int = 256, device="cuda"):
    """The three layered T=6 decoders (``experiments/deep_fer.py:67-79``)."""
    rcq = dict(kind="rcq", bv=8, quantizer_params=QP,
               v2c_quantizer_params=VQP, layered=True)
    return {
        "RCQ-bc3-L6": qc_decoder(lift, 6, device, bc=3, **rcq),
        "RCQ-bc4-L6": qc_decoder(lift, 6, device, bc=4, **rcq),
        "float-MS-L6": qc_decoder(lift, 6, device, kind="ms",
                                  layered=True),
    }


def trained_flooding_decoder(weights: str = DEFAULT_WEIGHTS,
                             lift: int = 256, device="cuda"):
    """The flooding T=10 W-OMS-RCQ with the tables at ``weights``
    (``experiments/deep_fer.py:80-91``)."""
    dec = qc_decoder(lift, 10, device, kind="orcq", bc=3, bv=8,
                     sharing_type=2, quantizer_params=QP,
                     v2c_quantizer_params=VQP)
    return dec.replace_weights(load_weights(weights))


def campaign_config(t1: int, frames: int = 5 * 10 ** 7, errors: int = 100,
                    wave: int = 32768, snr_lo: float = 6.4,
                    snr_hi: float = 6.7, snr_step: float = 0.1,
                    device="cuda") -> lt.SimulationConfig:
    """The campaign's Monte-Carlo under the {t1, T} compaction
    (``experiments/deep_fer.py:92-98``)."""
    return lt.SimulationConfig(
        snr_range=(snr_lo, snr_hi), snr_step=snr_step, max_frames=frames,
        max_errors=errors, min_frames=min(wave * 4, frames),
        wave_size=wave, early_exit_iters=t1,
        survivor_budget=max(64, wave // 16), stage1_batch_tile=64,
        save_results=False, device=device)


def sweep(decoders, config: lt.SimulationConfig, checkpoints=CHECKPOINTS,
          verbose=True):
    """Each decoder's curve under ``config``, resumable from
    ``<checkpoints>/<name>.json`` (no files when ``checkpoints`` is
    None); returns ({name: SimulationResult}, the simulator, whose
    ``wave_kinds`` say which waves were compacted)."""
    if checkpoints:
        os.makedirs(checkpoints, exist_ok=True)
    sim = lt.LDPCSimulator(config)
    results = {}
    for name, dec in decoders.items():
        ck = os.path.join(checkpoints, f"{name}.json") if checkpoints \
            else None
        results[name] = sim.simulate_decoder(dec, name, verbose=verbose,
                                             checkpoint=ck)
    return results, sim


def floor_verdict(result) -> dict:
    """The error-floor verdict of ``experiments/deep_fer.py:115-128``: a
    floor shows as the slope of log10(FER) per dB collapsing toward 0 at
    the tail."""
    fer = np.asarray(result.frame_error_rates, float)
    snr = np.asarray(result.snr_values, float)
    ok = fer > 0
    verdict = "insufficient data"
    if ok.sum() >= 3:
        s = np.diff(np.log10(fer[ok])) / np.diff(snr[ok])
        verdict = ("floor suspected" if len(s) >= 2 and
                   abs(s[-1]) < 0.3 * abs(s[0]) else "no floor observed")
    return {"verdict": verdict,
            "min_fer_measured": float(fer[ok].min()) if ok.any() else None}


def run(frames: int = 5 * 10 ** 7, errors: int = 100, lift: int = 256,
        wave: int = 32768, snr_lo: float = 6.4, snr_hi: float = 6.7,
        snr_step: float = 0.1, weights: str | None = DEFAULT_WEIGHTS,
        out_path: str = DEFAULT_OUT, device="cuda", verbose: bool = True):
    """The campaign; writes the report to ``out_path`` and returns it."""
    zoo6 = layered_decoders(lift, device)
    zoo10 = {}
    if weights:
        zoo10["W-OMS-RCQ-bc3-trained"] = trained_flooding_decoder(
            weights, lift, device)
        if verbose:
            print(f"loaded trained weights from {weights}", flush=True)
    span = dict(frames=frames, errors=errors, wave=wave, snr_lo=snr_lo,
                snr_hi=snr_hi, snr_step=snr_step, device=device)
    results = {}
    for t1, zoo in ((T1_LAYERED, zoo6), (T1_FLOODING, zoo10)):
        results.update(sweep(zoo, campaign_config(t1, **span),
                             verbose=verbose)[0])
    code = zoo6["RCQ-bc3-L6"].code
    report = {
        "code": f"QC({code.n},{code.k}) lift={lift}; layered T=6 (trained "
                "decoder: flooding T=10), {3,6} ({5,10} flooding) "
                "two-checkpoint compaction, uniform bv=8, ladder 2-4-6@1.3",
        "frames_cap": frames, "errors_target": errors,
        "curves": {k: r.to_dict() for k, r in results.items()},
        "floor_verdicts": {},
    }
    for name, r in results.items():
        v = report["floor_verdicts"][name] = floor_verdict(r)
        if verbose:
            print(f"{name}: {v['verdict']} (min FER "
                  f"{v['min_fer_measured']})", flush=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"results -> {out_path}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=5 * 10 ** 7)
    ap.add_argument("--errors", type=int, default=100)
    ap.add_argument("--wave", type=int, default=32768)
    ap.add_argument("--snr-lo", type=float, default=6.4)
    ap.add_argument("--snr-hi", type=float, default=6.7)
    ap.add_argument("--snr-step", type=float, default=0.1)
    ap.add_argument("--weights", default=DEFAULT_WEIGHTS)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the simulator's per-point and heartbeat lines
    logging.basicConfig(level=logging.INFO, force=True)
    run(args.frames, args.errors, wave=args.wave, snr_lo=args.snr_lo,
        snr_hi=args.snr_hi, snr_step=args.snr_step, weights=args.weights,
        out_path=args.out, device=args.device)


if __name__ == "__main__":
    main()
