"""Train 3-bit W-RCQ through the quantizer and measure the FER payoff (twin
of ``experiments/train_wrcq.py``).

On PEG(256, 128) with dv=3 and T=10 (flooding, the general engine; no
kernel): W-RCQ bc=3, sharing type 2 (beta per check degree, alpha per
variable degree), the 3-5-7 @ gamma 1.3 ladder, its weights drawn by the
port's generator around the NMS point (``init="nms"``, seed 0). A copy of
those untrained weights is kept; ``PosteriorJointTrainer`` then trains
the decoder through the straight-through quantizers (batch 256,
``--epochs`` epochs of 4096 frames, learning rate 3e-3, SNR 1.5-3.5 dB,
the posterior-joint loss, seed 0). ``LDPCSimulator`` runs three arms,
float min-sum (factor 0.7), W-RCQ-t2-untrained and W-RCQ-t2-trained, at
1.5-3.5 dB in 0.5 dB steps in waves of 4096: each point until
``max(200, frames // 64)`` frame errors once ``min(4096, frames)``
frames ran, or ``frames`` frames.

The report goes to ``--out`` (default ``train_wrcq_torch.json`` in the
working directory; ``experiments/train_wrcq_results.json`` holds the JAX
package's results and is not written), with the program's keys.

    python -m ldpc_tpu_torch.cli.train_wrcq [--frames 32768] [--epochs 12]
        [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging

import ldpc_tpu_torch as lt

__all__ = ["QP", "T", "MS_FACTOR", "BATCH", "LEARNING_RATE", "TRAIN_SNR",
           "NUM_SAMPLES", "SNR_RANGE", "SNR_STEP", "WAVE", "DEFAULT_OUT",
           "make_code", "make_wrcq", "training_config", "sim_config",
           "run", "main"]

QP = ((3.0, 1.3), (5.0, 1.3), (7.0, 1.3))
T = 10
MS_FACTOR = 0.7
BATCH, LEARNING_RATE, TRAIN_SNR, NUM_SAMPLES = 256, 3e-3, (1.5, 3.5), 4096
SNR_RANGE, SNR_STEP, WAVE = (1.5, 3.5), 0.5, 4096
DEFAULT_OUT = "train_wrcq_torch.json"


def make_code() -> lt.LDPCCode:
    """PEG(256, 128), dv=3, seed 0, T=10 (``train_wrcq.py:32-33``)."""
    return lt.create_peg_code(n=256, m=128, dv=3, seed=0, max_iterations=T)


def make_wrcq(code, device="cuda"):
    """W-RCQ bc=3, sharing type 2, its weights drawn around the NMS point
    by the port's generator seeded 0 (``train_wrcq.py:34-39``)."""
    return lt.weighted_rcq(code, bc=3, weight_sharing_type=2,
                           quantizer_params=QP, max_iterations=T, init="nms",
                           seed=0, device=device)


def training_config(epochs: int) -> lt.TrainingConfig:
    """``train_wrcq.py:41-44``."""
    return lt.TrainingConfig(batch_size=BATCH, num_epochs=epochs,
                             learning_rate=LEARNING_RATE,
                             snr_range=TRAIN_SNR,
                             use_posterior_training=True, seed=0)


def sim_config(frames: int, device="cuda") -> lt.SimulationConfig:
    """``train_wrcq.py:53-55``."""
    return lt.SimulationConfig(
        snr_range=SNR_RANGE, snr_step=SNR_STEP, max_frames=frames,
        max_errors=max(200, frames // 64), min_frames=min(4096, frames),
        wave_size=WAVE, device=device)


def run(frames: int = 32768, epochs: int = 12,
        out_path: str | None = DEFAULT_OUT, verbose: bool = True,
        device="cuda"):
    """Train, simulate the three arms; writes the report to ``out_path``
    (when given) and returns it."""
    code = make_code()
    wrcq = make_wrcq(code, device)
    untrained = {k: None if v is None else v.clone()
                 for k, v in wrcq.weights.items()}
    hist = lt.PosteriorJointTrainer(wrcq, training_config(epochs)).train(
        num_samples=NUM_SAMPLES, verbose=verbose)

    decoders = {
        "float-MS": lt.basic_min_sum(code, factor=MS_FACTOR,
                                     max_iterations=T, device=device),
        "W-RCQ-t2-untrained": wrcq.replace_weights(untrained),
        "W-RCQ-t2-trained": wrcq,
    }
    sim = lt.LDPCSimulator(sim_config(frames, device))
    results = sim.simulate_multiple_decoders(decoders, verbose=verbose)

    report = {
        "code": f"PEG({code.n},{code.k}) dv=3, 10 iters, bc=3",
        "train_epochs": len(hist["training_losses"]),
        "final_train_loss": hist["training_losses"][-1],
        "final_train_accuracy": hist["training_accuracies"][-1],
        "curves": {k: r.to_dict() for k, r in results.items()},
    }
    if verbose:
        for name, r in results.items():
            fers = ", ".join(f"{f:.4f}" for f in r.frame_error_rates)
            print(f"{name:20s} FER = [{fers}]")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
        print(f"results -> {out_path}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=32768)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the trainer's epoch lines and the simulator's per-point lines
    logging.basicConfig(level=logging.INFO, force=True)
    run(args.frames, args.epochs, args.out, device=args.device)


if __name__ == "__main__":
    main()
