"""Layered W-OMS-RCQ trained at the short schedules T=5 and T=4, with
degree-shared and per-layer weights (twin of
``experiments/train_layered_short.py``).

On the bench code (``default_rng(0)``'s 5x37 base, lift 256), the 2-4-6 @
gamma 1.3 ladder and the uniform bv=8 V2C quantizer on 4-8-12:

1. :func:`train_candidates`: at each T of ``--schedules`` (5 and 4), two
   W-OMS-RCQ decoders (sharing type 2): degree-shared weights ([T, 1]
   tables) and per-layer weights (``per_layer=True``: one bucket per base
   row, [T, 5] tables), each trained by ``PosteriorJointTrainer`` with
   :func:`ldpc_tpu_torch.cli.bench_dde.training_config` (batch 128,
   ``--epochs`` epochs of 2048 frames, learning rate 2e-3, cosine with 8
   warm-up updates, SNR 5.5-7.5 dB, seed 0; a fused decoder trains
   through the engines) and saved with ``save_checkpoint`` to
   ``orcq_layered_t<T>[_pl]_torch_ck/`` in the working directory (never
   ``experiments/orcq_layered_*_ck``);
2. :func:`fer_table`: the bench's old decoder RCQ-L6, RCQ-L5 and the four
   trained decoders, each through the whole-decode layered kernel (K1,
   ``csrc/fused_layered.cu``) in bf16 with the full output and no early
   exit, by ``simulate_single_snr`` at 6.25 and 6.5 dB, ``--frames``
   frames a point in waves of 16384 from a generator seeded 11;
3. :func:`verdicts`: a candidate replaces the bench decoder when its FER
   is at or below RCQ-L6's at both points (``train_layered_short.py:
   123-129``).

The report goes to ``--out`` (default ``train_layered_short_torch.json``
in the working directory; ``experiments/train_layered_short_results.json``
holds the JAX package's results and is not written), with the program's
keys.

    python -m ldpc_tpu_torch.cli.train_layered_short [--epochs 24]
        [--schedules 5 4] [--frames 65536] [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import bench_dde, deep_fer
from ldpc_tpu_torch.utils.checkpoint import save_checkpoint

__all__ = ["QP", "VQP", "LIFT", "POINTS", "WAVE", "SEED", "BENCH",
           "DEFAULT_OUT",
           "make", "candidate_name", "checkpoint_dir", "train_candidates",
           "fer_config", "fer_table", "verdicts", "run", "main"]

QP = deep_fer.QP
VQP = deep_fer.VQP
LIFT = 256
POINTS = (6.25, 6.5)
WAVE, SEED = 16384, 11
BENCH = "RCQ-L6 (bench)"
DEFAULT_OUT = "train_layered_short_torch.json"


def make(T: int, kind: str, device="cuda", per_layer: bool = False):
    """A layered decoder of ``kind`` at T iterations on the bench code at
    lift LIFT, fused, bf16 (``train_layered_short.py:59-70``): ``"rcq"``,
    or ``"orcq"`` with sharing type 2 and, when ``per_layer``, one weight
    bucket per base row."""
    kw = {} if kind == "rcq" else dict(sharing_type=2, per_layer=per_layer)
    return deep_fer.qc_decoder(LIFT, T, device, kind=kind, bc=3, bv=8,
                               quantizer_params=QP, v2c_quantizer_params=VQP,
                               layered=True, **kw)


def candidate_name(T: int, per_layer: bool) -> str:
    return f"W-OMS-RCQ-L{T}" + ("+perlayer" if per_layer else "")


def checkpoint_dir(T: int, per_layer: bool) -> str:
    return f"orcq_layered_t{T}" + ("_pl" if per_layer else "") + "_torch_ck"


def train_candidates(schedules=(5, 4), epochs: int = 24, device="cuda",
                     num_samples: int = bench_dde.NUM_SAMPLES,
                     verbose: bool = True):
    """Train the degree-shared and the per-layer W-OMS-RCQ at each T of
    ``schedules`` on ``num_samples`` frames an epoch, saving each to
    :func:`checkpoint_dir`; returns ``{name: decoder}``
    (``train_layered_short.py:78-98``)."""
    candidates = {}
    for T in schedules:
        for pl in (False, True):
            dec = make(T, "orcq", device, per_layer=pl)
            hist = lt.PosteriorJointTrainer(
                dec, bench_dde.training_config(epochs)).train(
                    num_samples=num_samples, verbose=verbose)
            name = candidate_name(T, pl)
            if verbose:
                print(f"{name}: final loss {hist['training_losses'][-1]:.5f}",
                      flush=True)
            save_checkpoint(checkpoint_dir(T, pl), dec.weights)
            candidates[name] = dec
    return candidates


def fer_config(frames: int = 65536, device="cuda") -> lt.SimulationConfig:
    """``train_layered_short.py:108-111``: ``frames`` frames a point, no
    error target."""
    return lt.SimulationConfig(snr_range=(0, 0), max_frames=frames,
                               max_errors=10 ** 9, min_frames=0,
                               wave_size=WAVE, seed=SEED, device=device)


def fer_table(decoders, frames: int = 65536, device="cuda",
              verbose: bool = True):
    """``{name: {str(snr): FER}}`` of each decoder at POINTS."""
    cfg = fer_config(frames, device)
    fers = {}
    for name, dec in decoders.items():
        fers[name] = {}
        for snr in POINTS:
            fers[name][str(snr)] = lt.simulate_single_snr(dec, snr, cfg)[0]
            if verbose:
                print(f"{name:18s} @ {snr} dB: FER "
                      f"{fers[name][str(snr)]:.3e}", flush=True)
    return fers


def verdicts(fers: dict, candidates) -> dict:
    """The decision rule: a candidate replaces the bench decoder when its
    FER is at or below BENCH's at every point of its table."""
    bench = fers[BENCH]
    return {name: ("REPLACES bench (FER <= layered-T6 RCQ at both points)"
                   if all(fers[name][s] <= bench[s] for s in bench)
                   else "keeps T=6 bench")
            for name in candidates}


def run(epochs: int = 24, frames: int = 65536, schedules=(5, 4),
        out_path: str = DEFAULT_OUT, device="cuda", verbose: bool = True):
    """Train, tabulate and judge; writes the report to ``out_path`` and
    returns it."""
    candidates = train_candidates(schedules, epochs, device, verbose=verbose)
    decoders = {BENCH: make(6, "rcq", device),
                "RCQ-L5": make(5, "rcq", device), **candidates}
    fers = fer_table(decoders, frames, device, verbose)
    verdict = verdicts(fers, candidates)
    if verbose:
        for name, v in verdict.items():
            print(f"{name}: {v}", flush=True)
    report = {
        "code": f"QC(9472,8192) lift={LIFT}, layered, bc=3 bv=8, "
                f"ladder 2-4-6@1.3 uniform bv",
        "frames_per_point": frames,
        "fers": fers,
        "verdicts": verdict,
    }
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"results -> {out_path}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--schedules", type=int, nargs="+", default=[5, 4])
    ap.add_argument("--frames", type=int, default=65536)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the trainer's epoch lines
    logging.basicConfig(level=logging.INFO, force=True)
    run(args.epochs, args.frames, tuple(args.schedules), args.out,
        args.device)


if __name__ == "__main__":
    main()
