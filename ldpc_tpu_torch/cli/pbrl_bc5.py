"""Does a 5th C2V bit, or a longer schedule, lift the deep-FER floor of the
QC PBRL (3096, 1032) code? (twin of ``experiments/pbrl_bc5.py``).

The code is ``create_pbrl_qc_protograph(k=1032, rate=1/3)``: a 24x36 base
at lift 86 whose degree-1 incremental-redundancy columns are transmitted.
Four plain RCQ decoders (no trained weights, so the quantizer alone
differs), layered, on the 6-11-16 @ gamma 1.3 CN ladder and the uniform
bv=8 V2C ladder 4-8-12, each through the whole-decode layered kernel (K1,
``csrc/fused_layered.cu``) in bf16 on the card (on the CPU the kernel's
plain version in float32, as the JAX program switches to f32 off the
TPU):

- **RCQ-bc4-T10**, **RCQ-bc4-T20**: bc=4 (8 magnitude levels) on the
  exact staircase quantizer;
- **RCQ-bc5-T10**, **RCQ-bc5-T20**: bc=5 (16 levels) with ``closed_qdq``,
  which puts the CN quantizer on the closed-form power law (the V2C
  ladder, 128 levels, is on the uniform closed form in every arm).

``LDPCSimulator`` runs each from ``--snr-lo`` to ``--snr-hi`` dB in
``--snr-step`` steps under the {5, T} two-checkpoint compaction: waves of
32768 frames, survivor budget 4096 (a wave with more survivors is decoded
whole at both depths), each point until ``--errors`` frame errors once
``min(2 * wave, frames)`` frames ran, or ``--frames`` frames. A decoder's
curve is written after every point to ``pbrl_bc5_torch_ck/<decoder>.json``
in the working directory and a rerun resumes after the points done
(``experiments/pbrl_bc5_ck/`` is never read or written). The report goes
to ``--out`` (default ``pbrl_bc5_torch.json`` in the working directory)
with the program's keys.

    python -m ldpc_tpu_torch.cli.pbrl_bc5 [--frames 20000000]
        [--errors 100] [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging

import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import deep_fer

__all__ = ["QP", "VQP8", "K", "RATE", "T1", "ARMS", "CHECKPOINTS",
           "DEFAULT_OUT", "protograph", "fused_options", "make",
           "decoders", "campaign_config", "run", "main"]

QP = ((6.0, 1.3), (11.0, 1.3), (16.0, 1.3))   # the on-code CN ladder
VQP8 = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
K, RATE, T1 = 1032, 1 / 3, 5
# (name, bc, T) of each arm, in the program's order
ARMS = (("RCQ-bc4-T10", 4, 10), ("RCQ-bc5-T10", 5, 10),
        ("RCQ-bc4-T20", 4, 20), ("RCQ-bc5-T20", 5, 20))
CHECKPOINTS = "pbrl_bc5_torch_ck"
DEFAULT_OUT = "pbrl_bc5_torch.json"


def protograph():
    """(base, lift) of the QC PBRL rate-1/3 code (``pbrl_bc5.py:58``)."""
    return lt.create_pbrl_qc_protograph(k=K, rate=RATE)


def fused_options(device, bc: int) -> dict:
    """K1's options: bf16 on the card, float32 on the CPU, the closed-form
    quantizer at bc >= 5 (``pbrl_bc5.py:63-67``)."""
    dtype = (torch.float32 if torch.device(device).type == "cpu"
             else torch.bfloat16)
    return dict(fused=True, dtype=dtype, closed_qdq=bc >= 5)


def make(base, lift, bc: int, T: int, device="cuda"):
    """Plain RCQ at ``bc`` bits, layered T (``pbrl_bc5.py:61-71``)."""
    code = lt.create_qc_code(base, lift=lift, max_iterations=T)
    return lt.make_decoder(
        code, kind="rcq", bc=bc, bv=8, quantizer_params=QP,
        v2c_quantizer_params=VQP8, max_iterations=T,
        qc=lt.build_qc_graph(base, lift), layered=True,
        qc_options=fused_options(device, bc), device=device)


def decoders(device="cuda") -> dict:
    """The four arms (``pbrl_bc5.py:73-78``)."""
    base, lift = protograph()
    return {name: make(base, lift, bc, T, device) for name, bc, T in ARMS}


def campaign_config(frames: int = 2 * 10 ** 7, errors: int = 100,
                    snr_lo: float = 2.6, snr_hi: float = 4.0,
                    snr_step: float = 0.2, wave_size: int = 32768,
                    survivor_budget: int = 4096,
                    device="cuda") -> lt.SimulationConfig:
    """``pbrl_bc5.py:80-86``."""
    return lt.SimulationConfig(
        snr_range=(snr_lo, snr_hi), snr_step=snr_step, max_frames=frames,
        max_errors=errors, min_frames=min(2 * wave_size, frames),
        wave_size=wave_size, early_exit_iters=T1,
        survivor_budget=survivor_budget, stage1_batch_tile=None,
        save_results=False, device=device)


def run(frames: int = 2 * 10 ** 7, errors: int = 100,
        snr_lo: float = 2.6, snr_hi: float = 4.0, snr_step: float = 0.2,
        wave_size: int = 32768, survivor_budget: int = 4096,
        out_path: str = DEFAULT_OUT, verbose: bool = True, device="cuda"):
    """The campaign; writes the report to ``out_path`` and returns it."""
    decs = decoders(device)
    cfg = campaign_config(frames, errors, snr_lo, snr_hi, snr_step,
                          wave_size, survivor_budget, device)
    curves = deep_fer.sweep(decs, cfg, CHECKPOINTS, verbose)[0]
    lift = next(iter(decs.values())).qc.lift
    report = {
        "code": f"QC PBRL (3096, 1032), lift {lift}, layered, ladder "
                f"6-11-16@1.3, plain RCQ",
        "curves": {k: r.to_dict() for k, r in curves.items()},
    }
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    if verbose:
        for name, r in curves.items():
            fer = ", ".join(f"{s:g}dB:{f:.2e}" for s, f in
                            zip(r.snr_values, r.frame_error_rates))
            print(f"{name}: {fer}", flush=True)
    print(f"results -> {out_path}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=2 * 10 ** 7)
    ap.add_argument("--errors", type=int, default=100)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the simulator's per-point and heartbeat lines
    logging.basicConfig(level=logging.INFO, force=True)
    run(frames=args.frames, errors=args.errors, out_path=args.out,
        device=args.device)


if __name__ == "__main__":
    main()
