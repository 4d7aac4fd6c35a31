"""Train on the matched ladder: does trained W-OMS-RCQ at least match the
plain designed decoder it starts near? (twin of
``experiments/train_matched.py``).

For W-OMS-RCQ the all-zero weight table is the plain designed RCQ
decoder, so training should never end worse than it started unless the
protocol (initialisation, learning rate, regularisation) is at fault.
Every arm is W-OMS-RCQ sharing type 2, bc=4, bv=8, layered T=10 on
``pbrl_wrcq``'s ``ref2`` ladder (CN and refined V2C) on the precoded
PBRL code (k=1032, rate 1/3, lift 86, n = 3182, base column 0's 86 bits
punctured, their LLRs 0 in training and simulation):

- ``base``: learning rate 2e-3 cosine, the decoder's initial tables;
- ``lowlr``: learning rate 3e-4;
- ``zinit``: every table set to zero (the design point), 3e-4;
- ``wd``: 2e-3 and ``weight_decay`` 1e-3 toward zero.

Each arm trains 30 epochs (``--epochs``) of 2048 frames in batches of 128
(cosine schedule with 8 warm-up updates, 1.5-3.5 dB) unless its
checkpoint ``train_matched_torch_ck/<arm>`` exists (or
``--skip-train``); then :func:`dev` runs the plain designed decoder
(``designed``) and each arm at 2.0 dB to ``--errors`` frame errors
under the {5, 10} two-checkpoint compaction (waves of 32768, survivor
budget 4096, 65,536 frames at least), resuming from and writing to
``train_matched_torch.json``. Decoding runs through the whole-decode
layered kernel (K1) in bf16 on the card, its plain version in float32 on
the CPU; training on the engines. Everything is written in the working
directory, never under ``experiments/``.

    python -m ldpc_tpu_torch.cli.train_matched [--errors 300] [--epochs 30]
        [--arms base lowlr zinit wd] [--skip-train] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import pbrl_wrcq as pw
from ldpc_tpu_torch.cli.pbrl_precode import K, RATE, fused_options
from ldpc_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["CK_DIR", "OUT", "ARMS", "BATCH", "NUM_SAMPLES", "WAVE",
           "MIN_FRAMES", "BUDGET", "_setup", "train_arm", "dev", "main"]

CK_DIR = "train_matched_torch_ck"
OUT = "train_matched_torch.json"
ARMS = {
    "base": dict(learning_rate=2e-3, zinit=False, weight_decay=0.0),
    "lowlr": dict(learning_rate=3e-4, zinit=False, weight_decay=0.0),
    "zinit": dict(learning_rate=3e-4, zinit=True, weight_decay=0.0),
    "wd": dict(learning_rate=2e-3, zinit=False, weight_decay=1e-3),
}
# a training epoch (pbrl_wrcq's; the cosine schedule keeps the program's
# 16 updates an epoch whatever NUM_SAMPLES is); dev's wave, frames before
# the error target counts and survivor budget (read at call time)
BATCH, NUM_SAMPLES = 128, 2048
WAVE, MIN_FRAMES, BUDGET = 32768, 65536, 4096


def _setup(device="cuda"):
    """(``mk(kind, weights=None)`` -> decoder, punctured bit positions) on
    the precoded code with ``pbrl_wrcq``'s ``ref2`` ladder
    (``train_matched.py:49-80``)."""
    base, lift, punct_cols = lt.create_pbrl_qc_protograph(
        k=K, rate=RATE, precode=True)
    qc = lt.build_qc_graph(base, lift)
    code = lt.create_qc_code(base, lift=lift, max_iterations=pw.T)
    qp, vqp = pw._ladder("ref2")

    def mk(kind, weights=None):
        dec = lt.make_decoder(
            code, kind=kind, bc=4, bv=8, quantizer_params=qp,
            v2c_quantizer_params=vqp, max_iterations=pw.T, qc=qc,
            layered=True, qc_options=fused_options(device), device=device,
            **({} if kind == "rcq" else dict(sharing_type=2)))
        if weights is not None:
            dec = dec.replace_weights(weights)
        return dec

    return mk, pw.punctured_bits(lift, punct_cols)


def train_arm(name, spec, epochs=30, verbose=True, device="cuda"):
    """Train one arm and save its tables to ``CK_DIR/<name>``; returns the
    final training loss (``train_matched.py:83-108``)."""
    mk, punct_bits = _setup(device)
    dec = mk("orcq")
    if spec["zinit"]:
        dec = dec.replace_weights({k: torch.zeros_like(v)
                                   for k, v in dec.weights.items()
                                   if v is not None})
    steps = epochs * (2048 // 128)
    tr = lt.PosteriorJointTrainer(dec, lt.TrainingConfig(
        batch_size=BATCH, num_epochs=epochs,
        learning_rate=spec["learning_rate"], snr_range=(1.5, 3.5),
        lr_schedule="cosine", warmup_steps=8, decay_steps=steps,
        early_stop_accuracy=2.0, seed=0, punctured_positions=punct_bits,
        weight_decay=spec["weight_decay"]))
    h = tr.train(num_samples=NUM_SAMPLES, verbose=verbose)
    os.makedirs(CK_DIR, exist_ok=True)
    save_checkpoint(os.path.join(CK_DIR, name),
                    {k: v for k, v in dec.weights.items() if v is not None})
    print(f"trained {name}: loss {h['training_losses'][-1]:.5f}",
          flush=True)
    return h["training_losses"][-1]


def dev(arms, errors=300, frames=5 * 10 ** 8, snr=2.0, verbose=True,
        device="cuda"):
    """The designed decoder and each trained arm at ``snr`` dB, skipping
    the names ``OUT`` already holds and writing it after each
    (``train_matched.py:111-139``); returns its dict."""
    mk, punct_bits = _setup(device)
    results = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            results = json.load(f)
    cfg = lt.SimulationConfig(
        snr_range=(snr, snr), max_frames=frames, max_errors=errors,
        min_frames=MIN_FRAMES, wave_size=WAVE, early_exit_iters=5,
        survivor_budget=BUDGET, punctured_positions=punct_bits,
        save_results=False, device=device)
    for name in ("designed",) + tuple(arms):
        if name in results:
            continue
        dec = (mk("rcq") if name == "designed"
               else mk("orcq", load_checkpoint(os.path.join(CK_DIR, name))))
        fer, ber, avg_it, nf, ne = lt.simulate_single_snr(dec, snr, cfg)
        results[name] = {"fer": fer, "frames": nf, "errors": ne,
                         "snr": snr}
        with open(OUT, "w") as f:
            json.dump(results, f, indent=2)
        if verbose:
            print(f"{name:9s} @ {snr} dB: FER {fer:.3e} ({ne}/{nf})",
                  flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--errors", type=int, default=300)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--arms", nargs="+", default=list(ARMS))
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the trainer's epoch lines and the simulator's heartbeat lines
    logging.basicConfig(level=logging.INFO, force=True)

    if not args.skip_train:
        for name in args.arms:
            if not os.path.exists(os.path.join(CK_DIR, name)):
                train_arm(name, ARMS[name], epochs=args.epochs,
                          device=args.device)
    dev(args.arms, errors=args.errors, device=args.device)


if __name__ == "__main__":
    main()
