"""bc=4 CN-ladder selection on the bench code by dev FER, then the
winner's deep points (twin of ``experiments/ladder_bc4.py``).

The bench code (``default_rng(0)``'s 5x37 base, lift 256), RCQ bc=4 with
the uniform bv=8 V2C ladder 4-8-12, layered T=6, every decode through the
whole-decode layered kernel (K1, ``csrc/fused_layered.cu``) with the full
output, in bf16 on the card (on the CPU the kernel's plain version in
float32):

- the dev sweep: each of the six (C1, C2, C3) @ gamma CN ladders of
  :data:`LADDERS` at ``dev_snr`` dB, ``frames`` frames in waves of
  ``min(16384, frames)``, seed 7, no early exit; the ladder with the least
  FER is selected;
- the deep points of the selected ladder at 6.5 and 6.6 dB under the
  {2, 6} two-checkpoint compaction: waves of 32768 frames, survivor
  budget 2048, seed 13, until 100 frame errors or ``--deep-frames``
  frames (``stage1_batch_tile``, a TPU tiling knob, is kept in the
  configuration and ignored).

The report goes to ``--out`` (default ``ladder_bc4_torch.json`` in the
working directory, never under ``experiments/``) with the program's keys.

    python -m ldpc_tpu_torch.cli.ladder_bc4 [--frames 131072]
        [--deep-frames 20000000] [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging

import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import deep_fer

__all__ = ["VQP", "LADDERS", "T", "DEFAULT_OUT", "fused_options", "make",
           "dev_config", "deep_config", "run", "main"]

VQP = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))  # uniform bv=8
LADDERS = {
    "2-4-6@1.3": ((2.0, 1.3), (4.0, 1.3), (6.0, 1.3)),
    "3-5-7@1.3": ((3.0, 1.3), (5.0, 1.3), (7.0, 1.3)),
    "3-6-9@1.3": ((3.0, 1.3), (6.0, 1.3), (9.0, 1.3)),
    "4-7-10@1.3": ((4.0, 1.3), (7.0, 1.3), (10.0, 1.3)),
    "2-4-6@1.0": ((2.0, 1.0), (4.0, 1.0), (6.0, 1.0)),
    "3-6-9@1.0": ((3.0, 1.0), (6.0, 1.0), (9.0, 1.0)),
}
T = 6
DEFAULT_OUT = "ladder_bc4_torch.json"


def fused_options(device, **extra) -> dict:
    """K1's options in the bench-code design studies, whose programs
    switch to float32 off the TPU (``ladder_bc4.py:60-62``,
    ``bc4_refine.py:77-80``): bf16 on the card, float32 on the CPU (the
    kernel's plain version), with ``extra`` (``lean``); the TPU tiling and
    layout keys are left out."""
    dtype = (torch.float32 if torch.device(device).type == "cpu"
             else torch.bfloat16)
    return dict(fused=True, dtype=dtype, **extra)


def make(qp, lift: int = 256, device="cuda"):
    """RCQ bc=4, bv=8, layered T=6 on the bench code at ``lift`` with the
    CN ladder ``qp`` (``ladder_bc4.py:65-69``)."""
    base = deep_fer.bench_base(lift)
    return lt.make_decoder(
        lt.create_qc_code(base, lift=lift, max_iterations=T), kind="rcq",
        bc=4, bv=8, quantizer_params=qp, v2c_quantizer_params=VQP,
        max_iterations=T, qc=lt.build_qc_graph(base, lift), layered=True,
        qc_options=fused_options(device), device=device)


def dev_config(frames: int = 131072, device="cuda") -> lt.SimulationConfig:
    """The dev sweep's Monte-Carlo (``ladder_bc4.py:71-73``)."""
    return lt.SimulationConfig(snr_range=(0, 0), max_frames=frames,
                               max_errors=10 ** 9, min_frames=0,
                               wave_size=min(16384, frames), seed=7,
                               device=device)


def deep_config(deep_frames: int = 2 * 10 ** 7,
                device="cuda") -> lt.SimulationConfig:
    """The deep points' Monte-Carlo (``ladder_bc4.py:86-89``)."""
    return lt.SimulationConfig(
        snr_range=(0, 0), max_frames=deep_frames, max_errors=100,
        min_frames=0, wave_size=32768, early_exit_iters=2,
        survivor_budget=2048, stage1_batch_tile=64, seed=13, device=device)


def run(frames: int = 131072, lift: int = 256, dev_snr: float = 6.4,
        deep_snrs=(6.5, 6.6), deep_frames: int = 2 * 10 ** 7,
        out_path: str = DEFAULT_OUT, verbose: bool = True, device="cuda"):
    """The sweep and the deep points; writes the report to ``out_path``
    and returns it."""
    cfg = dev_config(frames, device)
    dev = {}
    for name, qp in LADDERS.items():
        fer = lt.simulate_single_snr(make(qp, lift, device), dev_snr, cfg)[0]
        dev[name] = fer
        if verbose:
            print(f"ladder {name:10s} dev FER @{dev_snr} dB = {fer:.4e}",
                  flush=True)
    best = min(dev, key=dev.get)
    if verbose:
        print(f"selected bc=4 ladder: {best}", flush=True)

    deep_cfg = deep_config(deep_frames, device)
    deep = {}
    dec = make(LADDERS[best], lift, device)
    for snr in deep_snrs:
        fer, _, _, nf = lt.simulate_single_snr(dec, snr, deep_cfg)[:4]
        deep[str(snr)] = {"fer": float(fer), "frames": int(nf)}
        if verbose:
            print(f"bc=4 {best} @ {snr} dB: FER {fer:.3e} ({nf} frames)",
                  flush=True)

    report = {
        "code": f"QC({dec.code.n},{dec.code.k}) lift={lift}, layered T=6, "
                "bv=8 uniform",
        "dev_fers_bc4": dev, "selected": best, "deep": deep,
    }
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"results -> {out_path}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=131072)
    ap.add_argument("--deep-frames", type=int, default=2 * 10 ** 7)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the simulator's heartbeat lines
    logging.basicConfig(level=logging.INFO, force=True)
    run(frames=args.frames, deep_frames=args.deep_frames,
        out_path=args.out, device=args.device)


if __name__ == "__main__":
    main()
