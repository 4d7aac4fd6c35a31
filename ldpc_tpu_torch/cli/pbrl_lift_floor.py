"""The PBRL deep floor against the lift (twin of
``experiments/pbrl_lift_floor.py``).

Protograph density evolution puts the ensemble floor of the bc=4
6-11-16 @ gamma 1.3 decoder on the QC PBRL rate-1/3 code near 1e-7, while
the lift-86 code floors near 1e-4; if the floor comes from the finite
graph, lifting the same base shape three times deeper moves it down. Two
arms, the same decoder on each: plain RCQ bc=4 on that ladder, the
uniform bv=8 V2C ladder 4-8-12, layered T=10, through the whole-decode
layered kernel (K1, ``csrc/fused_layered.cu``) in bf16 on the card (on
the CPU the kernel's plain version in float32):

- **lift86_n3096**: ``create_pbrl_qc_protograph(k=1032, rate=1/3)``, the
  24x36 base at lift 86 (n = 3096);
- **lift258_n9288**: ``k=3096, lift=258``, the same base shape at lift 258
  (n = 9288).

``simulate_single_snr`` runs each arm at each of 2.8, 3.2, 3.6 and 4.0 dB
(by SNR, then by arm) under the {2, 10} two-checkpoint compaction: waves
of 32768 frames, survivor budget 4096, seed 11, until ``--errors`` frame
errors or ``--frames`` frames. The report goes to ``--out`` (default
``pbrl_lift_floor_torch.json`` in the working directory) with the
program's keys.

    python -m ldpc_tpu_torch.cli.pbrl_lift_floor [--frames 20000000]
        [--errors 100] [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

import ldpc_tpu_torch as lt

__all__ = ["QP", "VQP", "RATE", "T", "T1", "ARMS", "SNRS", "DEFAULT_OUT",
           "protograph", "fused_options", "decoders", "sim_config", "run",
           "main"]

QP = ((6.0, 1.3), (11.0, 1.3), (16.0, 1.3))
VQP = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
RATE, T, T1 = 1 / 3, 10, 2
# (name, k, lift) of each arm (pbrl_lift_floor.py:48-49)
ARMS = (("lift86_n3096", 1032, 86), ("lift258_n9288", 3096, 258))
SNRS = (2.8, 3.2, 3.6, 4.0)
DEFAULT_OUT = "pbrl_lift_floor_torch.json"


def protograph(k: int, lift: int):
    """(base, lift) of the QC PBRL rate-1/3 code with ``k`` information
    bits at ``lift``."""
    return lt.create_pbrl_qc_protograph(k=k, rate=RATE, lift=lift)


def fused_options(device) -> dict:
    """K1's options: bf16 on the card, float32 on the CPU
    (``pbrl_lift_floor.py:53-55``)."""
    dtype = (torch.float32 if torch.device(device).type == "cpu"
             else torch.bfloat16)
    return dict(fused=True, dtype=dtype)


def decoders(device="cuda", verbose: bool = False) -> dict:
    """``{arm: decoder}`` (``pbrl_lift_floor.py:47-62``)."""
    arms = {}
    for name, k, lift in ARMS:
        base, L = protograph(k, lift)
        code = lt.create_qc_code(base, lift=L, max_iterations=T)
        arms[name] = lt.make_decoder(
            code, kind="rcq", bc=4, bv=8, quantizer_params=QP,
            v2c_quantizer_params=VQP, max_iterations=T,
            qc=lt.build_qc_graph(base, L), layered=True,
            qc_options=fused_options(device), device=device)
        if verbose:
            print(f"{name}: ({code.n}, {code.k}), base {base.shape}, "
                  f"lift {L}", flush=True)
    return arms


def sim_config(frames: int = 2 * 10 ** 7, errors: int = 100,
               device="cuda") -> lt.SimulationConfig:
    """``pbrl_lift_floor.py:64-66``."""
    return lt.SimulationConfig(
        snr_range=(0, 0), max_frames=frames, max_errors=errors,
        min_frames=0, wave_size=32768, early_exit_iters=T1,
        survivor_budget=4096, stage1_batch_tile=None, seed=11,
        device=device)


def run(frames: int = 2 * 10 ** 7, errors: int = 100, snrs=SNRS,
        out_path: str = DEFAULT_OUT, verbose: bool = True, device="cuda"):
    """Both arms at every SNR; writes the report to ``out_path`` and
    returns it."""
    arms = decoders(device, verbose)
    cfg = sim_config(frames, errors, device)
    results = {}
    for snr in snrs:
        for name, dec in arms.items():
            fer, _, _, nf = lt.simulate_single_snr(dec, snr, cfg)[:4]
            results[f"{name}@{snr}"] = {"fer": float(fer), "frames": int(nf)}
            if verbose:
                print(f"{name} @ {snr} dB: FER {fer:.3e} ({nf} frames)",
                      flush=True)
    report = {"config": "bc=4 6-11-16@1.3, bv=8 uniform, layered T=10, "
                        "fused + two-checkpoint", "results": results}
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"results -> {out_path}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=2 * 10 ** 7)
    ap.add_argument("--errors", type=int, default=100)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(frames=args.frames, errors=args.errors, out_path=args.out,
        device=args.device)


if __name__ == "__main__":
    main()
