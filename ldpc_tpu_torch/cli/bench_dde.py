"""Deep FER of the shipped bench ladder, and a W-OMS-RCQ decoder trained
on it (twin of ``experiments/bench_dde.py``).

The bench code (``default_rng(0)``'s 5x37 base, lift 256), layered T=6,
the DDE-designed CN ladder 2.6474-3.0869-5.3767 @ gamma 1.3 that
``bench.py`` ships, the uniform bv=8 V2C quantizer on 4-8-12, every
decode through the whole-decode kernel (K1, ``csrc/fused_layered.cu``) in
bf16 with the full output:

- ``--phase train`` (:func:`train`, ``bench_dde.py:62-80``): W-OMS-RCQ
  (sharing type 2) on that ladder, trained by ``PosteriorJointTrainer``
  (batch 128, 30 epochs of 2048 frames, learning rate 2e-3, cosine with
  8 warm-up updates and decay over every update, SNR 5.5-7.5 dB, no
  accuracy early stop, seed 0; a fused decoder trains through the
  engines, as in ``ldpc_tpu``), saved with ``save_pretrained`` to
  ``worcq_bc3_layered_t6_dde_torch/`` in the working directory (never to
  ``zoo/``);
- ``--phase deep`` (:func:`deep`, ``:83-124``): RCQ-dde-L6 (the bench
  decoder) and W-ORCQ-dde-L6, whose weights come from
  ``worcq_bc3_layered_t6_dde_torch/`` where that directory exists in the
  working directory, else from the zoo entry ``worcq_bc3_layered_t6_dde``
  (the JAX program's trained decoder); the source is printed. Each runs
  6.4-6.7 dB in 0.1 dB steps under the {3, 6} two-checkpoint compaction
  of ``LDPCSimulator``: waves of 32768 frames, survivor budget 4096 (a
  wave with more survivors is decoded whole at both depths), until 100
  frame errors once 131,072 frames ran, or ``--frames`` frames. Each
  curve is written after every point to ``bench_dde_torch_ck/<decoder>.json``
  in the working directory (a rerun resumes; ``experiments/bench_dde_ck/``
  is never read or written), and the report to ``bench_dde_torch.json``
  in the working directory, with the program's keys.

    python -m ldpc_tpu_torch.cli.bench_dde [--phase train|deep|all]
        [--frames 50000000] [--epochs 30] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import deep_fer

__all__ = ["QP_DDE", "VQP", "T", "T1", "LIFT", "WAVE", "BUDGET",
           "MIN_FRAMES", "ERRORS", "SNR_LO", "SNR_HI", "SNR_STEP",
           "ZOO_ENTRY", "TRAINED_DIR", "CHECKPOINTS", "DEFAULT_OUT",
           "NUM_SAMPLES", "META", "make",
           "training_config", "train", "trained_source", "arms",
           "deep_config", "deep", "main"]

QP_DDE = ((2.6474, 1.3), (3.0869, 1.3), (5.3767, 1.3))
VQP = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
T, T1, LIFT = 6, 3, 256
WAVE, BUDGET, MIN_FRAMES, ERRORS = 32768, 4096, 131072, 100
SNR_LO, SNR_HI, SNR_STEP = 6.4, 6.7, 0.1
ZOO_ENTRY = "worcq_bc3_layered_t6_dde"
TRAINED_DIR = "worcq_bc3_layered_t6_dde_torch"
CHECKPOINTS = "bench_dde_torch_ck"
DEFAULT_OUT = "bench_dde_torch.json"
NUM_SAMPLES = 2048
META = {"trained": "ldpc_tpu_torch.cli.bench_dde --phase train",
        "protocol": "cosine 30ep B=128 snr 5.5-7.5 joint",
        "ladder": "DDE-designed 2.65-3.09-5.38@1.3 (RESULTS 23)"}


def make(kind: str, device="cuda"):
    """A layered T=6 decoder of ``kind`` (``"rcq"``, or ``"orcq"`` with
    sharing type 2) on the DDE ladder, fused, bf16, at lift LIFT
    (``bench_dde.py:52-57``)."""
    kw = {} if kind == "rcq" else dict(sharing_type=2)
    return deep_fer.qc_decoder(LIFT, T, device, kind=kind, bc=3, bv=8,
                               quantizer_params=QP_DDE,
                               v2c_quantizer_params=VQP, layered=True, **kw)


def training_config(epochs: int) -> lt.TrainingConfig:
    """The training of ``bench_dde.py:66-71`` (and
    ``train_layered_short.py:85-90``): the cosine decays over the updates
    of ``epochs`` of the programs' epochs (2048 frames in batches of
    128)."""
    return lt.TrainingConfig(
        batch_size=128, num_epochs=epochs, learning_rate=2e-3,
        snr_range=(5.5, 7.5), lr_schedule="cosine", warmup_steps=8,
        decay_steps=epochs * (2048 // 128), early_stop_accuracy=2.0, seed=0)


def train(epochs: int = 30, num_samples: int = NUM_SAMPLES, device="cuda",
          verbose: bool = True):
    """Train W-OMS-RCQ on the DDE ladder, ``epochs`` epochs of
    ``num_samples`` frames, and save it to TRAINED_DIR; returns (the
    decoder, the trainer's history)."""
    dec = make("orcq", device)
    hist = lt.PosteriorJointTrainer(dec, training_config(epochs)).train(
        num_samples=num_samples, verbose=verbose)
    lt.save_pretrained(TRAINED_DIR, dec, meta=META)
    print(f"trained: loss {hist['training_losses'][-1]:.5f} -> "
          f"{TRAINED_DIR}", flush=True)
    return dec, hist


def trained_source() -> str:
    """Where W-ORCQ-dde-L6's weights come from: TRAINED_DIR when it holds
    an entry in the working directory, else the zoo's ZOO_ENTRY."""
    return (TRAINED_DIR if os.path.exists(os.path.join(TRAINED_DIR,
                                                       "spec.json"))
            else ZOO_ENTRY)


def arms(device="cuda"):
    """``{"RCQ-dde-L6", "W-ORCQ-dde-L6"}`` (``bench_dde.py:91-98``), the
    trained decoder loaded from :func:`trained_source` with the campaign's
    options (fused, bf16, full output)."""
    src = trained_source()
    print(f"W-ORCQ-dde-L6 weights from {src}", flush=True)
    return {"RCQ-dde-L6": make("rcq", device),
            "W-ORCQ-dde-L6": lt.load_pretrained(
                src, qc_options=dict(deep_fer.FUSED), device=device)}


def deep_config(frames: int = 5 * 10 ** 7, snr_lo: float = SNR_LO,
                snr_hi: float = SNR_HI, device="cuda") -> lt.SimulationConfig:
    """The campaign's Monte-Carlo (``bench_dde.py:103-107``) from
    ``snr_lo`` to ``snr_hi`` dB."""
    return lt.SimulationConfig(
        snr_range=(snr_lo, snr_hi), snr_step=SNR_STEP, max_frames=frames,
        max_errors=ERRORS, min_frames=MIN_FRAMES, wave_size=WAVE,
        early_exit_iters=T1, survivor_budget=BUDGET, save_results=False,
        device=device)


def deep(frames: int = 5 * 10 ** 7, out_path: str = DEFAULT_OUT,
         device="cuda", verbose: bool = True):
    """The deep-FER campaign of :func:`arms` from SNR_LO to SNR_HI dB;
    writes the report to ``out_path`` and returns it."""
    curves = deep_fer.sweep(arms(device), deep_config(
        frames, SNR_LO, SNR_HI, device), CHECKPOINTS, verbose)[0]
    report = {
        "code": "QC(9472,8192) lift=256, layered T=6, DDE ladder "
                "2.65-3.09-5.38@1.3, uniform bv=8",
        "curves": {k: r.to_dict() for k, r in curves.items()},
    }
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"results -> {out_path}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=["train", "deep", "all"],
                    default="all")
    ap.add_argument("--frames", type=int, default=5 * 10 ** 7)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the trainer's epoch lines and the simulator's per-point lines
    logging.basicConfig(level=logging.INFO, force=True)
    if args.phase in ("train", "all"):
        train(args.epochs, device=args.device)
    if args.phase in ("deep", "all"):
        deep(frames=args.frames, device=args.device)


if __name__ == "__main__":
    main()
