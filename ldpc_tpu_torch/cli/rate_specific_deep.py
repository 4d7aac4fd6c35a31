"""The paper's section VII-C at depth: 4-bit W-NMS-RCQ and W-OMS-RCQ against
a "6-bit" OMS on the QC PBRL (3096, 1032) code, measured into the
deep-FER regime (twin of ``experiments/rate_specific_deep.py``).

The code is ``create_pbrl_qc_protograph(k=1032, rate=1/3)``: a 24x36
base (check degrees 4 and 5; variable degrees 1, 2 and 4-8, its degree-1
incremental-redundancy columns transmitted) at lift 86. Three layered
T=10 decoders, sharing type 2 (beta per check degree, alpha per variable
degree: ``[10, 2]`` and ``[10, 7]`` tables), each through the
whole-decode layered kernel (K1, ``csrc/fused_layered.cu``) with the full
output, in bf16 on the card (on the CPU the kernel's plain version in
float32, as the JAX program switches to f32 off the TPU):

- **OMS-6bit**: offset min-sum with its tables pinned to beta = 0.5 and
  alpha = 0. The program passes ``bv=6`` and a 6-bit V2C ladder, which
  ``make_decoder`` ignores for ``oms`` (it quantizes only ``rcq``,
  ``wrcq`` and ``orcq``), so this arm is a float OMS, as in the JAX
  record;
- **W-NMS-RCQ-4bit-trained**: ``wrcq`` bc=4 on the 6-11-16 @ gamma 1.3
  ladder and the uniform bv=8 V2C ladder 4-8-12, weights drawn around
  the NMS point by the port's generator (seed 0);
- **W-OMS-RCQ-4bit-trained**: ``orcq`` on the same ladders, its tables
  started at the OMS constants.

Both candidates are trained by ``PosteriorJointTrainer`` (batch 128,
``--epochs`` epochs of 2048 frames, learning rate 1e-3, SNR 2.8-3.8 dB,
no accuracy early stop, seed 0; a fused decoder trains through the
engines, as in ``ldpc_tpu``) and saved with ``save_checkpoint`` to
``wnmsrcq_pbrl_qc_torch_ck/`` and ``worcqrcq_pbrl_qc_torch_ck/`` in the
working directory. The campaign runs ``LDPCSimulator`` from ``--snr-lo`` to
``--snr-hi`` dB in ``--snr-step`` steps under the {3, 10} two-checkpoint
compaction: waves of 32768 frames, survivor budget 4096 (a wave with more
survivors is decoded whole at both depths), each point until ``--errors``
frame errors once ``min(65536, frames)`` frames ran, or ``--frames``
frames. Each curve is written after every point to
``rsd_torch_ck/<decoder>.json`` in the working directory, and a rerun
resumes after the points done (``experiments/rsd_ck/`` and the JAX
package's checkpoints are never read or written). The report, with each
candidate's gain over OMS-6bit at FER 1e-4, 1e-5 and 1e-6 (:func:`gain_db`),
goes to ``--out`` (default ``rate_specific_deep_torch.json`` in the working
directory) with the program's keys.

    python -m ldpc_tpu_torch.cli.rate_specific_deep [--frames 20000000]
        [--errors 100] [--epochs 24] [--snr-lo 2.6] [--snr-hi 4.0]
        [--snr-step 0.2] [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import deep_fer
from ldpc_tpu_torch.utils.checkpoint import save_checkpoint

__all__ = ["QP4", "VQP8", "VQP6", "K", "RATE", "T", "T1", "BATCH",
           "LEARNING_RATE", "TRAIN_SNR", "NUM_SAMPLES", "WAVE", "BUDGET",
           "MIN_FRAMES", "TARGETS", "OMS", "CANDIDATES", "CHECKPOINTS",
           "DEFAULT_OUT", "protograph", "fused_options", "decoders",
           "training_config", "checkpoint_dir", "train", "campaign_config",
           "snr_at", "gain_db", "run", "main"]

# the CN ladder of the on-code sweep (rate_specific_deep.py:49-52), the
# uniform bv=8 V2C ladder and the 6-bit one the OMS arm names
QP4 = ((6.0, 1.3), (11.0, 1.3), (16.0, 1.3))
VQP8 = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
VQP6 = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
K, RATE, T, T1 = 1032, 1 / 3, 10, 3
BATCH, LEARNING_RATE, TRAIN_SNR, NUM_SAMPLES = 128, 1e-3, (2.8, 3.8), 2048
WAVE, BUDGET, MIN_FRAMES = 32768, 4096, 65536
TARGETS = (1e-4, 1e-5, 1e-6)
OMS = "OMS-6bit"
# (tag of the checkpoint, decoder name) of each trained candidate
CANDIDATES = (("wnms", "W-NMS-RCQ-4bit-trained"),
              ("worcq", "W-OMS-RCQ-4bit-trained"))
CHECKPOINTS = "rsd_torch_ck"
DEFAULT_OUT = "rate_specific_deep_torch.json"


def protograph():
    """(base, lift) of the QC PBRL rate-1/3 code
    (``rate_specific_deep.py:70``)."""
    return lt.create_pbrl_qc_protograph(k=K, rate=RATE)


def fused_options(device) -> dict:
    """The fused decoders' options: bf16 on the card, float32 on the CPU
    (``rate_specific_deep.py:74-76``)."""
    dtype = (torch.float32 if torch.device(device).type == "cpu"
             else torch.bfloat16)
    return dict(fused=True, dtype=dtype)


def decoders(device="cuda") -> dict:
    """``{OMS-6bit, W-NMS-RCQ-4bit-trained, W-OMS-RCQ-4bit-trained}``
    before training (``rate_specific_deep.py:71-101``)."""
    base, lift = protograph()
    qc = lt.build_qc_graph(base, lift)
    code = lt.create_qc_code(base, lift=lift, max_iterations=T)
    kw = dict(sharing_type=2, max_iterations=T, qc=qc, layered=True,
              device=device)
    rcq = dict(bc=4, bv=8, quantizer_params=QP4, v2c_quantizer_params=VQP8)

    def pinned(dec):  # the classic OMS constants beta = 0.5, alpha = 0
        return dec.replace_weights({
            "beta": torch.full_like(dec.weights["beta"], 0.5),
            "alpha": torch.zeros_like(dec.weights["alpha"])})

    return {
        OMS: pinned(lt.make_decoder(code, kind="oms", bv=6,
                                    v2c_quantizer_params=VQP6,
                                    qc_options=fused_options(device), **kw)),
        CANDIDATES[0][1]: lt.make_decoder(
            code, kind="wrcq", init="nms", qc_options=fused_options(device),
            **rcq, **kw),
        CANDIDATES[1][1]: pinned(lt.make_decoder(
            code, kind="orcq", qc_options=fused_options(device), **rcq,
            **kw)),
    }


def training_config(epochs: int) -> lt.TrainingConfig:
    """``rate_specific_deep.py:104-107``."""
    return lt.TrainingConfig(batch_size=BATCH, num_epochs=epochs,
                             learning_rate=LEARNING_RATE,
                             snr_range=TRAIN_SNR, early_stop_accuracy=2.0,
                             seed=0)


def checkpoint_dir(tag: str) -> str:
    return f"{tag}rcq_pbrl_qc_torch_ck"


def train(decs: dict, epochs: int = 24, verbose: bool = True) -> dict:
    """Train each candidate of ``decs`` in place for ``epochs`` epochs of
    NUM_SAMPLES frames and save its tables to :func:`checkpoint_dir`;
    returns ``{tag: the trainer's history}``
    (``rate_specific_deep.py:103-111``)."""
    hists = {}
    for tag, name in CANDIDATES:
        cand = decs[name]
        hists[tag] = lt.PosteriorJointTrainer(
            cand, training_config(epochs)).train(num_samples=NUM_SAMPLES,
                                                 verbose=verbose)
        save_checkpoint(checkpoint_dir(tag),
                        {k: v for k, v in cand.weights.items()
                         if v is not None})
    return hists


def campaign_config(frames: int = 2 * 10 ** 7, errors: int = 100,
                    snr_lo: float = 2.6, snr_hi: float = 4.0,
                    snr_step: float = 0.2,
                    device="cuda") -> lt.SimulationConfig:
    """The campaign's Monte-Carlo under the {T1, T} compaction
    (``rate_specific_deep.py:113-118``)."""
    return lt.SimulationConfig(
        snr_range=(snr_lo, snr_hi), snr_step=snr_step, max_frames=frames,
        max_errors=errors, min_frames=min(MIN_FRAMES, frames),
        wave_size=WAVE, early_exit_iters=T1, survivor_budget=BUDGET,
        save_results=False, device=device)


def snr_at(curve, fer_target):
    """The SNR where ``curve`` (a ``SimulationResult``) crosses
    ``fer_target``, interpolated linearly in log10 FER between its two
    bracketing points that have errors; None when fewer than two points
    have errors or the target lies outside them
    (``rate_specific_deep.py:136-147``)."""
    snr = np.asarray(curve.snr_values, float)
    fer = np.asarray(curve.frame_error_rates, float)
    ok = fer > 0
    snr, fer = snr[ok], fer[ok]
    if len(fer) < 2 or fer.min() > fer_target or fer.max() < fer_target:
        return None
    lf = np.log10(fer)
    i = int(np.searchsorted(-lf, -np.log10(fer_target)))
    i = max(1, min(i, len(fer) - 1))
    t = (np.log10(fer_target) - lf[i - 1]) / (lf[i] - lf[i - 1])
    return float(snr[i - 1] + t * (snr[i] - snr[i - 1]))


def gain_db(curves: dict, verbose: bool = True) -> dict:
    """``{candidate: {"0.0001": dB, "1e-05": ..., "1e-06": ...}}``: OMS-6bit's SNR at each target
    less the candidate's, rounded to 1e-4 dB, None where either curve does
    not cross the target (``rate_specific_deep.py:149-160``)."""
    gains = {}
    for _, cand in CANDIDATES:
        for target in TARGETS:
            a = snr_at(curves[OMS], target)
            b = snr_at(curves[cand], target)
            gain = None if a is None or b is None else round(a - b, 4)
            gains.setdefault(cand, {})[f"{target:g}"] = gain
            if verbose:
                print(f"FER {target:g}: {OMS} @ {a} dB, {cand} @ {b} dB, "
                      f"gain {gain} dB", flush=True)
    return gains


def run(frames: int = 2 * 10 ** 7, errors: int = 100, epochs: int = 24,
        snr_lo: float = 2.6, snr_hi: float = 4.0, snr_step: float = 0.2,
        out_path: str = DEFAULT_OUT, verbose: bool = True, device="cuda"):
    """Train both candidates, run the campaign; writes the report to
    ``out_path`` and returns it."""
    decs = decoders(device)
    hist = train(decs, epochs, verbose)["wnms"]
    cfg = campaign_config(frames, errors, snr_lo, snr_hi, snr_step, device)
    curves = deep_fer.sweep(decs, cfg, CHECKPOINTS, verbose)[0]
    code = decs[OMS].code
    report = {
        "code": f"QC PBRL ({code.n}, {code.k}), lift {decs[OMS].qc.lift}, "
                f"layered T=10",
        "final_train_loss": float(hist["training_losses"][-1]),
        "curves": {k: r.to_dict() for k, r in curves.items()},
        "gain_db": gain_db(curves, verbose),
    }
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"results -> {out_path}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=2 * 10 ** 7)
    ap.add_argument("--errors", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the trainer's epoch lines and the simulator's per-point lines
    logging.basicConfig(level=logging.INFO, force=True)
    run(args.frames, args.errors, args.epochs, out_path=args.out,
        device=args.device)


if __name__ == "__main__":
    main()
