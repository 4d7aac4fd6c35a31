"""The bc=3 accuracy study on the bench code: trained W-OMS-RCQ(3,8) and
W-RCQ(3,8) against float min-sum (twin of ``experiments/accuracy_bc3.py``).

On the QC code of ``bench.py`` (``default_rng(0)``'s 5x37 base, lift 256,
T=10), every decode runs the whole-decode flooding kernel (K4,
``csrc/fused_flooding.cu``) in bf16 with the full output:

1. :func:`dev_sweep`: the five quantizer ladders of the JAX program, RCQ
   bc=3 bv=8, 16,384 frames at 6.4 dB in waves of 4096 (seed 7); the
   ladder with the lowest dev FER is selected;
2. :func:`train_pair`: W-OMS-RCQ (``init="reference"``) and W-RCQ
   (``init="nms"``), sharing type 2, the V2C quantizer uniform at 2C,
   trained by ``PosteriorJointTrainer`` (batch 128, learning rate 2e-3,
   SNR 5.5-7.5 dB, no accuracy early stop, seed 0, 2048 frames an
   epoch); a fused decoder trains through the engines, as in ``ldpc_tpu``.
   The trained W-OMS-RCQ weights are saved with ``save_checkpoint`` into
   ``orcq_bc3_torch_ck/`` in the working directory (never
   ``experiments/orcq_bc3_ck``), which ``ldpc_tpu_torch.cli.deep_fer
   --weights`` reads;
3. :func:`waterfall`: float min-sum, RCQ bc=3 bv=8 (power-law V2C
   quantizer), RCQ bc=3 bv=8 uniform and the two trained decoders over
   5.75-7.25 dB in 0.25 dB steps, waves of 8192, up to 2000 frame errors;
4. each decoder's gap to float min-sum at FER 1e-2
   (``fer_parity.snr_at_fer``).

The results go to ``--out`` (default ``accuracy_bc3_torch.json`` in the
working directory; ``experiments/accuracy_bc3_results.json`` holds the
JAX package's TPU results and is not written), with the JAX program's
keys.

    python -m ldpc_tpu_torch.cli.accuracy_bc3 [--frames 131072]
        [--epochs 24] [--lift 256] [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli.fer_parity import gaps_report
from ldpc_tpu_torch.utils.checkpoint import save_checkpoint

__all__ = ["LADDERS", "PERF", "DEFAULT_OUT", "CHECKPOINT", "bench_code",
           "make", "dev_config", "dev_sweep", "uniform_v2c",
           "training_config", "untrained_pair", "train_pair",
           "waterfall_decoders", "waterfall_config", "waterfall", "run",
           "main"]

T = 10
DEFAULT_OUT = "accuracy_bc3_torch.json"
CHECKPOINT = "orcq_bc3_torch_ck"
# every evaluation decodes through the whole-decode flooding kernel
PERF = dict(fused=True, batch_tile=64, dtype=torch.bfloat16)
LADDERS = {
    "3-5-7@1.3": ((3.0, 1.3), (5.0, 1.3), (7.0, 1.3)),
    "2-4-6@1.3": ((2.0, 1.3), (4.0, 1.3), (6.0, 1.3)),
    "4-6-8@1.3": ((4.0, 1.3), (6.0, 1.3), (8.0, 1.3)),
    "3-5-7@1.0": ((3.0, 1.0), (5.0, 1.0), (7.0, 1.0)),
    "3-5-7@1.6": ((3.0, 1.6), (5.0, 1.6), (7.0, 1.6)),
}
TRAINED = (("orcq", "W-OMS-RCQ"), ("wrcq", "W-RCQ"))


def bench_code(lift: int = 256):
    """(code at T=10, QC graph) of the bench protograph at ``lift``."""
    base = np.random.default_rng(0).integers(0, lift, size=(5, 37))
    return (lt.create_qc_code(base, lift=lift, max_iterations=T),
            lt.build_qc_graph(base, lift))


def make(code, qc, kind, qparams, device="cuda", **kw):
    """A bc=3, bv=8 decoder of ``kind`` on the ladder ``qparams``, T=10,
    fused (``experiments/accuracy_bc3.py:56-59``)."""
    return lt.make_decoder(code, kind=kind, bc=3, bv=8,
                           quantizer_params=qparams, max_iterations=T, qc=qc,
                           qc_options=PERF, device=device, **kw)


def dev_config(device="cuda") -> lt.SimulationConfig:
    """The ladder selection's Monte-Carlo (``accuracy_bc3.py:62-64``)."""
    return lt.SimulationConfig(snr_range=(6.4, 6.4), snr_step=1.0,
                               max_frames=16384, max_errors=10 ** 9,
                               min_frames=0, wave_size=4096, seed=7,
                               device=device)


def dev_sweep(code, qc, device="cuda", verbose=True):
    """RCQ bc=3 bv=8 on each of LADDERS at 6.4 dB; returns (the name of
    the ladder with the lowest dev FER, {name: dev FER})."""
    cfg = dev_config(device)
    dev = {}
    for name, qp in LADDERS.items():
        dev[name] = lt.simulate_single_snr(make(code, qc, "rcq", qp, device),
                                           6.4, cfg)[0]
        if verbose:
            print(f"ladder {name:11s} dev FER @6.4 dB = {dev[name]:.4f}",
                  flush=True)
    best = min(dev, key=dev.get)
    if verbose:
        print(f"selected ladder: {best}", flush=True)
    return best, dev


def uniform_v2c(qparams):
    """The uniform bv=8 V2C ladder at twice each phase's C."""
    return tuple((2.0 * C, 1.0) for C, _ in qparams)


def training_config(epochs: int) -> lt.TrainingConfig:
    """``accuracy_bc3.py:96-103``: at this operating point the bit
    accuracy exceeds 0.99 from the first epoch, so the accuracy early
    stop is off."""
    return lt.TrainingConfig(batch_size=128, num_epochs=epochs,
                             learning_rate=2e-3, snr_range=(5.5, 7.5),
                             early_stop_accuracy=2.0, seed=0)


def untrained_pair(code, qc, qparams, device="cuda"):
    """W-OMS-RCQ and W-RCQ before training (``accuracy_bc3.py:90-95``):
    sharing type 2 and the uniform V2C quantizer, the deployed form, so
    training and deployment decode alike."""
    return {name: make(code, qc, kind, qparams, device, sharing_type=2,
                       v2c_quantizer_params=uniform_v2c(qparams),
                       init=("nms" if kind == "wrcq" else "reference"),
                       seed=0)
            for kind, name in TRAINED}


def train_pair(code, qc, qparams, device="cuda", epochs: int = 24,
               num_samples: int = 2048, verbose=True):
    """Train :func:`untrained_pair`; returns {"W-OMS-RCQ": (decoder,
    final loss), "W-RCQ": (...)}."""
    trained = {}
    for name, dec in untrained_pair(code, qc, qparams, device).items():
        hist = lt.PosteriorJointTrainer(dec, training_config(epochs)).train(
            num_samples=num_samples, verbose=verbose)
        trained[name] = (dec, hist["training_losses"][-1])
        if verbose:
            print(f"{name}: {len(hist['training_losses'])} epochs, final "
                  f"loss {hist['training_losses'][-1]:.5f}", flush=True)
    return trained


def waterfall_decoders(code, qc, qparams, trained, device="cuda"):
    """The waterfall's five decoders (``accuracy_bc3.py:119-131``);
    ``trained`` is :func:`train_pair`'s result."""
    return {
        "float-MS": lt.make_decoder(code, kind="ms", qc=qc,
                                    max_iterations=T, qc_options=PERF,
                                    device=device),
        "RCQ-bc3-bv8": make(code, qc, "rcq", qparams, device),
        # the uniform (gamma=1) V2C quantizer, the deployed form
        "RCQ-bc3-bv8uni": make(code, qc, "rcq", qparams, device,
                               v2c_quantizer_params=uniform_v2c(qparams)),
        "W-OMS-RCQ-bc3-trained": trained["W-OMS-RCQ"][0],
        "W-RCQ-bc3-trained": trained["W-RCQ"][0],
    }


def waterfall_config(frames: int, device="cuda") -> lt.SimulationConfig:
    """``accuracy_bc3.py:116-118`` at ``frames`` a point."""
    return lt.SimulationConfig(snr_range=(5.75, 7.25), snr_step=0.25,
                               max_frames=frames, max_errors=2000,
                               min_frames=min(16384, frames),
                               wave_size=8192, device=device)


def waterfall(decoders, frames: int, device="cuda", verbose=True):
    """Each decoder's FER curve; returns ``{name: SimulationResult}``
    (a decoder that fails is dropped, as ``LDPCSimulator`` does)."""
    sim = lt.LDPCSimulator(waterfall_config(frames, device))
    return sim.simulate_multiple_decoders(decoders, verbose=verbose)


def run(frames: int = 131072, epochs: int = 24, lift: int = 256,
        out_path: str | None = DEFAULT_OUT, device="cuda",
        verbose: bool = True):
    """The whole study; writes the report to ``out_path`` (unless None)
    and returns it."""
    code, qc = bench_code(lift)
    best, dev = dev_sweep(code, qc, device, verbose=verbose)
    qparams = LADDERS[best]
    trained = train_pair(code, qc, qparams, device, epochs, verbose=verbose)
    save_checkpoint(CHECKPOINT, trained["W-OMS-RCQ"][0].weights)
    results = waterfall(waterfall_decoders(code, qc, qparams, trained,
                                           device), frames, device, verbose)
    target = 1e-2
    base_snr, gaps = gaps_report(results, target, verbose)
    report = {
        "code": f"QC({code.n},{code.k}) lift={lift}, 10 iters, bc=3 bv=8",
        "quantizer_ladder": {"selected": best, "dev_fers": dev},
        "frames_per_point": frames,
        "target_fer": target,
        "float_ms_snr_at_target": base_snr,
        "gaps_db": gaps,
        "curves": {k: r.to_dict() for k, r in results.items()},
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
        print(f"results -> {out_path}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=131072)
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--lift", type=int, default=256)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.frames, args.epochs, args.lift, args.out, args.device)


if __name__ == "__main__":
    main()
