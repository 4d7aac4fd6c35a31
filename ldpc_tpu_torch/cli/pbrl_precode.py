"""The precoded PBRL code against its random variant: does a punctured
high-degree precode node lift the deep-FER floor? (twin of
``experiments/pbrl_precode.py``).

``create_pbrl_qc_protograph(k=1032, rate=1/3, precode=True)`` adds to the
random variant's IRA core and incremental-redundancy rows one precode
column, tapped by every row and never transmitted: a 25x37 base at lift
86, n = 3182 coded bits of which the 86 of base column 0 are punctured,
so both codes send 3096 symbols for 1032 information bits and compare at
equal per-symbol SNR. Three arms, each layered T=10 through the
whole-decode layered kernel (K1, ``csrc/fused_layered.cu``) in bf16 on the
card (on the CPU the kernel's plain version in float32):

- **random-bc4-T10**: plain RCQ bc=4 on the 6-11-16 @ gamma 1.3 CN ladder
  and the uniform bv=8 V2C ladder 4-8-12, on the random variant;
- **precoded-bc4-T10**: the same decoder on the precoded code, the precode
  column's bits punctured (``punctured_positions``: their channel LLRs
  are zero);
- **precoded-oms6-T10**: offset min-sum, sharing type 2, its tables set to
  beta = 0.5 and alpha = 0 after it is built. The program passes ``bv=6``
  and a 6-bit V2C ladder, which ``make_decoder`` ignores for ``oms`` (it
  quantizes only ``rcq``, ``wrcq`` and ``orcq``), so this arm is a float
  OMS, as in the JAX record.

Each arm gets its own ``LDPCSimulator`` from ``--snr-lo`` to ``--snr-hi``
dB in ``--snr-step`` steps under the {5, 10} two-checkpoint compaction:
waves of 32768 frames, survivor budget 4096, each point until
``--errors`` frame errors once ``min(2 * wave, frames)`` frames ran, or
``--frames`` frames. A curve is written after every point to
``pbrl_precode_torch_ck/<arm>.json`` in the working directory and a rerun
resumes after the points done (``experiments/pbrl_precode_ck/`` is never
read or written). The report goes to ``--out`` (default
``pbrl_precode_torch.json`` in the working directory) with the program's
keys.

    python -m ldpc_tpu_torch.cli.pbrl_precode [--frames 20000000]
        [--errors 100] [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging

import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import deep_fer

__all__ = ["QP", "VQP8", "VQP6", "K", "RATE", "T", "T1", "CHECKPOINTS",
           "DEFAULT_OUT", "protographs", "fused_options", "decoder_for",
           "arms", "campaign_config", "run", "main"]

QP = ((6.0, 1.3), (11.0, 1.3), (16.0, 1.3))
VQP8 = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
VQP6 = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
K, RATE, T, T1 = 1032, 1 / 3, 10, 5
CHECKPOINTS = "pbrl_precode_torch_ck"
DEFAULT_OUT = "pbrl_precode_torch.json"


def protographs():
    """``((base, lift), (base, lift, punctured bit positions))`` of the
    random and the precoded code: the precode column's lifted bits
    (``pbrl_precode.py:88-92``)."""
    random = lt.create_pbrl_qc_protograph(k=K, rate=RATE)
    base, lift, cols = lt.create_pbrl_qc_protograph(k=K, rate=RATE,
                                                    precode=True)
    punct = tuple(range(lift * cols[0], lift * (cols[0] + 1)))
    return random, (base, lift, punct)


def fused_options(device) -> dict:
    """K1's options: bf16 on the card, float32 on the CPU
    (``pbrl_precode.py:69-71``)."""
    dtype = (torch.float32 if torch.device(device).type == "cpu"
             else torch.bfloat16)
    return dict(fused=True, dtype=dtype)


def decoder_for(base, lift, kind: str, device="cuda"):
    """RCQ bc=4 (``kind="rcq"``) or the pinned OMS (``"oms"``) on the code
    of ``base`` at ``lift`` (``pbrl_precode.py:65-85``)."""
    code = lt.create_qc_code(base, lift=lift, max_iterations=T)
    kw = dict(max_iterations=T, qc=lt.build_qc_graph(base, lift),
              layered=True, qc_options=fused_options(device), device=device)
    if kind == "rcq":
        return lt.make_decoder(code, kind="rcq", bc=4, bv=8,
                               quantizer_params=QP,
                               v2c_quantizer_params=VQP8, **kw)
    dec = lt.make_decoder(code, kind="oms", sharing_type=2, bv=6,
                          v2c_quantizer_params=VQP6, **kw)
    return dec.replace_weights({
        "beta": torch.full_like(dec.weights["beta"], 0.5),
        "alpha": torch.zeros_like(dec.weights["alpha"])})


def arms(device="cuda"):
    """``[(name, decoder, punctured positions or None)]`` in the program's
    order (``pbrl_precode.py:94-98``)."""
    (b_rand, l_rand), (b_pre, l_pre, punct) = protographs()
    return [
        ("random-bc4-T10", decoder_for(b_rand, l_rand, "rcq", device), None),
        ("precoded-bc4-T10", decoder_for(b_pre, l_pre, "rcq", device),
         punct),
        ("precoded-oms6-T10", decoder_for(b_pre, l_pre, "oms", device),
         punct),
    ]


def campaign_config(punctured=None, frames: int = 2 * 10 ** 7,
                    errors: int = 100, snr_lo: float = 2.6,
                    snr_hi: float = 4.0, snr_step: float = 0.2,
                    wave_size: int = 32768, survivor_budget: int = 4096,
                    device="cuda") -> lt.SimulationConfig:
    """One arm's simulation (``pbrl_precode.py:103-108``)."""
    return lt.SimulationConfig(
        snr_range=(snr_lo, snr_hi), snr_step=snr_step, max_frames=frames,
        max_errors=errors, min_frames=min(2 * wave_size, frames),
        wave_size=wave_size, early_exit_iters=T1,
        survivor_budget=survivor_budget, stage1_batch_tile=None,
        punctured_positions=punctured, save_results=False, device=device)


def run(frames: int = 2 * 10 ** 7, errors: int = 100,
        snr_lo: float = 2.6, snr_hi: float = 4.0, snr_step: float = 0.2,
        wave_size: int = 32768, survivor_budget: int = 4096,
        out_path: str = DEFAULT_OUT, verbose: bool = True, device="cuda"):
    """The campaign; writes the report to ``out_path`` and returns it."""
    curves = {}
    for name, dec, punct in arms(device):
        cfg = campaign_config(punct, frames, errors, snr_lo, snr_hi,
                              snr_step, wave_size, survivor_budget, device)
        curves.update(deep_fer.sweep({name: dec}, cfg, CHECKPOINTS,
                                     verbose)[0])
    report = {
        "codes": "QC PBRL rate-1/3 k=1032 lift 86: random (3096 tx bits) "
                 "vs precoded (3182 coded, 3096 transmitted, precode col "
                 "punctured)",
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
