"""Rate-specific W-RCQ training across a PBRL code family (twin of
``experiments/rate_specific.py``).

The protocol of the paper's section VII-C at reduced scale: for each rate
of ``create_pbrl_family(k, rates=(1/3, 1/2, 2/3))``, in ascending order,
the code is rebuilt with T=10; W-RCQ bc=4 (sharing type 2, the 3-5-7 @
gamma 1.3 ladder, weights drawn around the NMS point by the port's
generator, seed 0) is trained by ``PosteriorJointTrainer`` on that rate
alone (batch 256, ``--epochs`` epochs of 2048 frames, learning rate 3e-3,
SNR from ``mid - 1`` to ``mid + 1.5`` dB, seed 0), where ``mid`` is
:data:`SNR_MID` at the family's rate key (2.0 dB for a rate it lacks); then
``LDPCSimulator`` runs min-sum against the trained decoder from ``mid -
0.5`` to ``mid + 1.5`` dB in 0.5 dB steps, waves of 2048, each point until
``max(200, frames // 32)`` frame errors once ``min(2048, frames)`` frames
ran, or ``frames`` frames. Every decode runs the general engine (no
kernel).

The report goes to ``--out`` (default ``rate_specific_torch.json`` in the
working directory; ``experiments/rate_specific_results.json`` holds the
JAX package's results and is not written), with the program's keys:
``{"k", "rates": {"0.333": {"n", "final_train_loss", "curves"}, ...}}``.

    python -m ldpc_tpu_torch.cli.rate_specific [--k 96] [--frames 16384]
        [--epochs 10] [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging

import ldpc_tpu_torch as lt

__all__ = ["QP", "T", "RATES", "SNR_MID", "BATCH",
           "LEARNING_RATE", "NUM_SAMPLES", "WAVE", "DEFAULT_OUT", "family",
           "rate_code", "snr_mid", "make_wrcq", "training_config",
           "sim_config", "run", "main"]

QP = ((3.0, 1.3), (5.0, 1.3), (7.0, 1.3))
T = 10
RATES = (1 / 3, 1 / 2, 2 / 3)
# each rate's operating point, looked up with the family's float keys
SNR_MID = {1 / 3: 1.0, 1 / 2: 2.0, 2 / 3: 3.0}
BATCH, LEARNING_RATE, NUM_SAMPLES, WAVE = 256, 3e-3, 2048, 2048
DEFAULT_OUT = "rate_specific_torch.json"


def family(k: int) -> dict:
    """``{rate: LDPCCode}`` of the PBRL family at ``k``
    (``rate_specific.py:34``)."""
    return lt.create_pbrl_family(k=k, rates=RATES)


def rate_code(code) -> lt.LDPCCode:
    """``code`` rebuilt with T=10 (``rate_specific.py:39-40``)."""
    return lt.LDPCCode(n=code.n, k=code.k, H=code.H, max_iterations=T)


def snr_mid(rate: float) -> float:
    """The rate's operating point (``rate_specific.py:43``)."""
    return SNR_MID.get(rate, 2.0)


def make_wrcq(code, device="cuda"):
    """W-RCQ bc=4, sharing type 2 (``rate_specific.py:41-42``)."""
    return lt.weighted_rcq(code, bc=4, weight_sharing_type=2,
                           quantizer_params=QP, max_iterations=T, init="nms",
                           seed=0, device=device)


def training_config(epochs: int, mid: float) -> lt.TrainingConfig:
    """``rate_specific.py:44-48``."""
    return lt.TrainingConfig(batch_size=BATCH, num_epochs=epochs,
                             learning_rate=LEARNING_RATE,
                             snr_range=(mid - 1.0, mid + 1.5), seed=0)


def sim_config(frames: int, mid: float, device="cuda") -> lt.SimulationConfig:
    """``rate_specific.py:51-54``."""
    return lt.SimulationConfig(
        snr_range=(mid - 0.5, mid + 1.5), snr_step=0.5, max_frames=frames,
        max_errors=max(200, frames // 32), min_frames=min(2048, frames),
        wave_size=WAVE, device=device)


def run(k: int = 96, frames: int = 16384, epochs: int = 10,
        out_path: str | None = DEFAULT_OUT, verbose: bool = True,
        device="cuda"):
    """Train and simulate each rate; writes the report to ``out_path``
    (when given) and returns it."""
    report = {"k": k, "rates": {}}
    for rate, code in sorted(family(k).items()):
        code = rate_code(code)
        wrcq = make_wrcq(code, device)
        mid = snr_mid(rate)
        hist = lt.PosteriorJointTrainer(
            wrcq, training_config(epochs, mid)).train(
                num_samples=NUM_SAMPLES, verbose=False)
        sim = lt.LDPCSimulator(sim_config(frames, mid, device))
        results = sim.simulate_multiple_decoders({
            "MS": lt.basic_min_sum(code, max_iterations=T, device=device),
            "W-RCQ-trained": wrcq,
        }, verbose=False)
        report["rates"][f"{rate:.3f}"] = {
            "n": code.n,
            "final_train_loss": hist["training_losses"][-1],
            "curves": {kk: r.to_dict() for kk, r in results.items()},
        }
        if verbose:
            ms = results["MS"].frame_error_rates
            wr = results["W-RCQ-trained"].frame_error_rates
            print(f"rate {rate:.3f} (n={code.n}): MS FER={ms}  "
                  f"W-RCQ(bc=4,trained) FER={wr}", flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
        print(f"results -> {out_path}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=96)
    ap.add_argument("--frames", type=int, default=16384)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    run(args.k, args.frames, args.epochs, args.out, device=args.device)


if __name__ == "__main__":
    main()
