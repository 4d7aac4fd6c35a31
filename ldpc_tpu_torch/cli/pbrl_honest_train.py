"""Honest W-RCQ training on the precoded PBRL code, after the
decision-bias fix (twin of ``experiments/pbrl_honest_train.py``).

The best designed 4-bit CN ladder (refine pass 1, ``CN_REF3``:
8.5-12.1-12.1 @ 1.3) trails the 6-bit OMS anchor at 2.0 dB; the paper's
mechanism for closing that gap is trained degree-shared weights. Every
arm is bc=4, layered T=10 on ``CN_REF3`` on the precoded PBRL code
(k=1032, rate 1/3, lift 86, n = 3182, base column 0's 86 bits punctured,
their LLRs 0 in training and simulation), sharing type 2:

- ``worcq``: W-OMS-RCQ, learning rate 2e-3 cosine;
- ``worcq-low``: W-OMS-RCQ from the design point (zero tables), 3e-4;
- ``worcq-wd``: W-OMS-RCQ, 2e-3 and ``weight_decay`` 1e-3 toward zero;
- ``wrcq``: W-RCQ (multiplicative beta), 2e-3;
- ``worcq-pl``: W-OMS-RCQ with per-layer tables, 2e-3.

Training runs with ``bv=None`` (no V2C quantizer: in the layered schedule
the bv quantizer is decode-neutral, and the loss sees full-resolution
posteriors), so it takes the engines; :func:`dev` decodes the same tables
with bv=8 and the uniform 4-8-12 V2C ladder through the whole-decode
layered kernel (K1), in bf16 on the card (its plain version in float32 on
the CPU). Each arm trains 30 epochs (``--epochs``) of 2048 frames in
batches of 128 (cosine schedule with 8 warm-up updates, 1.5-3.5 dB)
unless its checkpoint ``pbrl_honest_train_torch_ck/<arm>`` exists (or
``--skip-train``); then :func:`dev` runs ``oms6`` (OMS, tables pinned to
beta = 0.5, alpha = 0; the program's bv=6 is ignored for ``oms``),
``rcq-ref3`` (the plain designed decoder) and each arm at 2.0 and 2.4 dB
to ``--errors`` frame errors under the {5, 10} two-checkpoint compaction
(waves of 32768, survivor budget 8192, 65,536 frames at least),
resuming from and writing to ``pbrl_honest_train_torch.json``.
Everything is written in the working directory, never under
``experiments/``.

    python -m ldpc_tpu_torch.cli.pbrl_honest_train [--epochs 30]
        [--errors 100] [--arms worcq worcq-low worcq-wd wrcq worcq-pl]
        [--skip-train] [--device cpu]
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

__all__ = ["CK_DIR", "OUT", "CN_REF3", "VQP8", "VQP6", "T", "ARMS",
           "BATCH", "NUM_SAMPLES", "WAVE", "MIN_FRAMES", "BUDGET", "_setup",
           "train_arm", "dev", "main"]

CK_DIR = "pbrl_honest_train_torch_ck"
OUT = "pbrl_honest_train_torch.json"
CN_REF3 = ((8.4963, 1.3), (12.108, 1.3), (12.108, 1.3))
VQP8 = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
VQP6 = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
T = 10
ARMS = {
    "worcq": dict(kind="orcq", lr=2e-3, zinit=False, wd=0.0,
                  per_layer=False),
    "worcq-low": dict(kind="orcq", lr=3e-4, zinit=True, wd=0.0,
                      per_layer=False),
    "worcq-wd": dict(kind="orcq", lr=2e-3, zinit=False, wd=1e-3,
                     per_layer=False),
    "wrcq": dict(kind="wrcq", lr=2e-3, zinit=False, wd=0.0,
                 per_layer=False),
    "worcq-pl": dict(kind="orcq", lr=2e-3, zinit=False, wd=0.0,
                     per_layer=True),
}
# a training epoch (the cosine schedule keeps the program's 16 updates an
# epoch whatever NUM_SAMPLES is); dev's wave, frames before the error
# target counts and survivor budget (read at call time)
BATCH, NUM_SAMPLES = 128, 2048
WAVE, MIN_FRAMES, BUDGET = 32768, 65536, 8192


def _setup(device="cuda"):
    """(``mk(kind, *, bv, vqp, per_layer, weights)`` ->
    decoder, punctured bit positions) on the precoded code
    (``pbrl_honest_train.py:58-95``); ``bv=None`` builds the decoder
    without a V2C quantizer."""
    base, lift, punct_cols = lt.create_pbrl_qc_protograph(
        k=K, rate=RATE, precode=True)
    qc = lt.build_qc_graph(base, lift)
    code = lt.create_qc_code(base, lift=lift, max_iterations=T)

    def mk(kind, *, bv=8, vqp=VQP8, per_layer=False, weights=None):
        common = dict(max_iterations=T, qc=qc, layered=True,
                      qc_options=fused_options(device), device=device)
        if kind == "oms6":
            dec = lt.make_decoder(code, kind="oms", sharing_type=2, bv=6,
                                  v2c_quantizer_params=VQP6, **common)
            return dec.replace_weights({
                "beta": torch.full_like(dec.weights["beta"], 0.5),
                "alpha": torch.zeros_like(dec.weights["alpha"])})
        kw = {} if kind == "rcq" else dict(sharing_type=2,
                                           per_layer=per_layer)
        dec = lt.make_decoder(
            code, kind=kind, bc=4, bv=bv, quantizer_params=CN_REF3,
            v2c_quantizer_params=vqp if bv else None, **common, **kw)
        if weights is not None:
            dec = dec.replace_weights(weights)
        return dec

    return mk, pw.punctured_bits(lift, punct_cols)


def train_arm(name, spec, epochs=30, verbose=True, device="cuda"):
    """Train one arm with bv=None and save its tables to
    ``CK_DIR/<name>``; returns the final training loss
    (``pbrl_honest_train.py:98-124``)."""
    mk, punct_bits = _setup(device)
    dec = mk(spec["kind"], bv=None, per_layer=spec["per_layer"])
    if spec["zinit"]:
        # the orcq design point: zero offsets are the plain decoder
        dec = dec.replace_weights({k: torch.zeros_like(v)
                                   for k, v in dec.weights.items()
                                   if v is not None})
    steps = epochs * (2048 // 128)
    tr = lt.PosteriorJointTrainer(dec, lt.TrainingConfig(
        batch_size=BATCH, num_epochs=epochs, learning_rate=spec["lr"],
        snr_range=(1.5, 3.5), lr_schedule="cosine", warmup_steps=8,
        decay_steps=steps, early_stop_accuracy=2.0, seed=0,
        punctured_positions=punct_bits, weight_decay=spec["wd"]))
    h = tr.train(num_samples=NUM_SAMPLES, verbose=verbose)
    os.makedirs(CK_DIR, exist_ok=True)
    save_checkpoint(os.path.join(CK_DIR, name),
                    {k: v for k, v in dec.weights.items() if v is not None})
    print(f"trained {name}: loss {h['training_losses'][-1]:.5f}",
          flush=True)
    return h["training_losses"][-1]


def dev(arms, errors=100, frames=5 * 10 ** 7, snrs=(2.0, 2.4),
        verbose=True, device="cuda"):
    """``oms6``, ``rcq-ref3`` and each trained arm at ``snrs`` with bv=8,
    skipping the names ``OUT`` already holds and writing it after each
    (``pbrl_honest_train.py:127-160``); returns its dict."""
    mk, punct_bits = _setup(device)
    results = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            results = json.load(f)
    for name in ("oms6", "rcq-ref3") + tuple(arms):
        if name in results:
            continue
        if name == "oms6":
            dec = mk("oms6")
        elif name == "rcq-ref3":
            dec = mk("rcq")
        else:
            spec = ARMS[name]
            dec = mk(spec["kind"], per_layer=spec["per_layer"],
                     weights=load_checkpoint(os.path.join(CK_DIR, name)))
        results[name] = {}
        for snr in snrs:
            cfg = lt.SimulationConfig(
                snr_range=(snr, snr), max_frames=frames,
                max_errors=errors, min_frames=MIN_FRAMES, wave_size=WAVE,
                early_exit_iters=5, survivor_budget=BUDGET,
                punctured_positions=punct_bits, save_results=False,
                device=device)
            fer, ber, avg_it, nf, ne = lt.simulate_single_snr(dec, snr, cfg)
            results[name][str(snr)] = {"fer": fer, "frames": nf,
                                       "errors": ne}
            if verbose:
                print(f"{name:10s} @ {snr} dB: FER {fer:.3e} "
                      f"({ne}/{nf})", flush=True)
        with open(OUT, "w") as f:
            json.dump(results, f, indent=2)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--errors", type=int, default=100)
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
