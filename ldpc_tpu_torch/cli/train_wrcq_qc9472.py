"""W-RCQ on the (9472, 8192)-class QC code: posterior-joint training through
the quantizer, then Monte-Carlo FER (twin of
``experiments/train_wrcq_qc9472.py``).

The bench protograph (``default_rng(0)``'s 5x37 base) at ``--lift``
(256: QC(9472, 8192)), T=10, flooding through the QC engine (torch ops,
no kernel: the ``qc_options`` are the engine's ``check_every=10``, bf16
and ``unroll``): W-RCQ bc=4, sharing type 2, the 3-5-7 @ gamma 1.3
ladder, weights drawn around the NMS point by the port's generator (seed
0). A copy of the untrained weights is kept; ``PosteriorJointTrainer``
trains the decoder (batch 128, ``--epochs`` epochs of 1024 frames,
learning rate 2e-3, SNR 5.5-7.5 dB, seed 0, the trainer's accuracy early
stop at 0.99; a training call decodes through the engine in f32). Then
``LDPCSimulator`` runs float min-sum, W-RCQ-bc4-untrained and
W-RCQ-bc4-trained at 6.0-7.0 dB in 0.5 dB steps, waves of 4096, each
point until ``max(200, frames // 32)`` frame errors once ``min(4096,
frames)`` frames ran, or ``frames`` frames.

The report goes to ``--out`` (default ``train_wrcq_qc9472_torch.json`` in
the working directory; ``experiments/train_wrcq_qc9472_results.json``
holds the JAX package's results and is not written), with the program's
keys, ``params`` (the weight count) included.

    python -m ldpc_tpu_torch.cli.train_wrcq_qc9472 [--lift 256]
        [--frames 16384] [--epochs 8] [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging

import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import deep_fer

__all__ = ["QP", "T", "PERF", "BATCH", "LEARNING_RATE", "TRAIN_SNR",
           "NUM_SAMPLES", "SNR_RANGE", "SNR_STEP", "WAVE", "DEFAULT_OUT",
           "make_code", "make_wrcq", "make_ms", "training_config",
           "sim_config", "run", "main"]

QP = ((3.0, 1.3), (5.0, 1.3), (7.0, 1.3))
T = 10
# the QC engine's options (train_wrcq_qc9472.py:40)
PERF = dict(check_every=10, dtype=torch.bfloat16, unroll=True)
BATCH, LEARNING_RATE, TRAIN_SNR, NUM_SAMPLES = 128, 2e-3, (5.5, 7.5), 1024
SNR_RANGE, SNR_STEP, WAVE = (6.0, 7.0), 0.5, 4096
DEFAULT_OUT = "train_wrcq_qc9472_torch.json"


def make_code(lift: int = 256):
    """(code, QC graph) of the bench protograph at ``lift``, T=10
    (``train_wrcq_qc9472.py:36-39``)."""
    base = deep_fer.bench_base(lift)
    return (lt.create_qc_code(base, lift=lift, max_iterations=T),
            lt.build_qc_graph(base, lift))


def make_wrcq(code, qc, device="cuda"):
    """W-RCQ bc=4, sharing type 2 on the QC engine
    (``train_wrcq_qc9472.py:42-44``)."""
    return lt.make_decoder(code, kind="wrcq", bc=4, sharing_type=2,
                           quantizer_params=QP, max_iterations=T, qc=qc,
                           init="nms", seed=0, qc_options=dict(PERF),
                           device=device)


def make_ms(code, qc, device="cuda"):
    """Float min-sum on the QC engine (``train_wrcq_qc9472.py:58-60``)."""
    return lt.make_decoder(code, kind="ms", qc=qc, max_iterations=T,
                           qc_options=dict(PERF), device=device)


def training_config(epochs: int) -> lt.TrainingConfig:
    """``train_wrcq_qc9472.py:47-50``."""
    return lt.TrainingConfig(batch_size=BATCH, num_epochs=epochs,
                             learning_rate=LEARNING_RATE,
                             snr_range=TRAIN_SNR, seed=0)


def sim_config(frames: int, device="cuda") -> lt.SimulationConfig:
    """``train_wrcq_qc9472.py:53-55``."""
    return lt.SimulationConfig(
        snr_range=SNR_RANGE, snr_step=SNR_STEP, max_frames=frames,
        max_errors=max(200, frames // 32), min_frames=min(4096, frames),
        wave_size=WAVE, device=device)


def run(lift: int = 256, frames: int = 16384, epochs: int = 8,
        out_path: str | None = DEFAULT_OUT, verbose: bool = True,
        device="cuda"):
    """Train, simulate the three arms; writes the report to ``out_path``
    (when given) and returns it."""
    code, qc = make_code(lift)
    wrcq = make_wrcq(code, qc, device)
    untrained = {k: None if v is None else v.clone()
                 for k, v in wrcq.weights.items()}
    hist = lt.PosteriorJointTrainer(wrcq, training_config(epochs)).train(
        num_samples=NUM_SAMPLES, verbose=verbose)

    sim = lt.LDPCSimulator(sim_config(frames, device))
    results = sim.simulate_multiple_decoders({
        "float-MS": make_ms(code, qc, device),
        "W-RCQ-bc4-untrained": wrcq.replace_weights(untrained),
        "W-RCQ-bc4-trained": wrcq,
    }, verbose=verbose)

    report = {
        "code": f"QC({code.n},{code.k}) lift={lift}, 10 iters, bc=4",
        "params": wrcq.param_count(),
        "train_epochs": len(hist["training_losses"]),
        "final_train_loss": hist["training_losses"][-1],
        "curves": {k: r.to_dict() for k, r in results.items()},
    }
    if verbose:
        for name, r in results.items():
            fers = ", ".join(f"{f:.4f}" for f in r.frame_error_rates)
            print(f"{name:22s} FER = [{fers}]")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
        print(f"results -> {out_path}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lift", type=int, default=256)
    ap.add_argument("--frames", type=int, default=16384)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    run(args.lift, args.frames, args.epochs, args.out, device=args.device)


if __name__ == "__main__":
    main()
