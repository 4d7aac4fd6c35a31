"""Free V2C bits: bv=10/12 uniform V2C ladders on the precoded PBRL graph
(twin of ``experiments/pbrl_bv10.py``).

The code is ``create_pbrl_qc_protograph(k=1032, rate=1/3, precode=True)``:
a 25x37 base at lift 86, n = 3182, base column 0 (86 bits) punctured.
Every arm is RCQ on the refined CN ladder ``CN_REF3`` (8.5-12.1-12.1 @
1.3) and the uniform V2C ladder ``VQP_REF3`` (183-315-394), layered T=10
through the whole-decode layered kernel (K1, ``csrc/fused_layered.cu``)
in bf16 on the card (on the CPU the kernel's plain version in float32,
as the JAX program switches to f32 off the TPU):

- ``bc4_bv10`` and ``bc4_bv12``: bc=4 with a 10- and a 12-bit V2C
  quantizer (511 and 2047 levels a side, K2's closed uniform form);
- ``bc5_bv10``: bc=5 (K2's closed power form, ``closed_qdq``) with the
  10-bit V2C quantizer.

In the layered schedule only the posterior passes through the V2C
quantizer, so its ladder and width do not change a hard decision:
``bc4_bv10`` and ``bc4_bv12`` decode as ``pbrl_wrcq``'s ``rcq-ref3``.

:func:`main` runs each arm at ``snrs`` to ``errors`` frame errors or
``frames`` frames under the {5, 10} two-checkpoint compaction (waves of
32768, survivor budget 4096, 65,536 frames at least; ``pbrl_wrcq``'s
``dev_config``) and writes ``{arm: {snr: {fer, frames, errors}}}`` to
``out_path`` (``pbrl_bv10_torch.json`` in the working directory, never
under ``experiments/``).

    python -m ldpc_tpu_torch.cli.pbrl_bv10 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import pbrl_wrcq as pw

__all__ = ["CN_REF3", "VQP_REF3", "DEFAULT_OUT", "build_arms", "sweep",
           "main", "cli"]

CN_REF3 = ((8.4963, 1.3), (12.108, 1.3), (12.108, 1.3))
VQP_REF3 = ((182.5928, 1.0), (315.3076, 1.0), (394.1345, 1.0))
DEFAULT_OUT = "pbrl_bv10_torch.json"


def build_arms(device="cuda"):
    """({arm: decoder}, punctured bit positions) (``pbrl_bv10.py:54-64``)."""
    mk, punct, _ = pw._mk_setup(device)
    arm = lambda bv, bc=4: mk("rcq", CN_REF3, vqp=VQP_REF3, bc=bc, bv=bv)
    return {"bc4_bv10": arm(10), "bc4_bv12": arm(12),
            "bc5_bv10": arm(10, bc=5)}, punct


def sweep(arms, punct, frames, errors, snrs, out_path, line,
          device="cuda"):
    """Each arm at each SNR of ``snrs`` through ``simulate_single_snr``
    with ``pbrl_wrcq.dev_config``; prints ``line(name, snr, fer, errors,
    frames)`` a point and writes ``{arm: {snr: {fer, frames, errors}}}``
    to ``out_path``, as the probe programs do. Returns that dict."""
    results = {}
    for name, dec in arms.items():
        results[name] = {}
        for snr in snrs:
            cfg = pw.dev_config(snr, frames, errors, punct, device)
            fer, ber, avg_it, nf, ne = lt.simulate_single_snr(dec, snr, cfg)
            results[name][str(snr)] = {"fer": fer, "frames": nf,
                                       "errors": ne}
            print(line(name, snr, fer, ne, nf), flush=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    return results


def main(frames=2 * 10 ** 7, errors=100, snrs=(2.0, 2.4),
         out_path=DEFAULT_OUT, device="cuda"):
    """The program's sweep (``pbrl_bv10.py:29-84``)."""
    logging.basicConfig(level=logging.INFO, force=True)
    arms, punct = build_arms(device)
    results = sweep(arms, punct, frames, errors, snrs, out_path,
                    lambda name, snr, fer, ne, nf: (
                        f"{name:10s} @ {snr} dB: FER {fer:.3e} "
                        f"({ne} errs / {nf} frames)"), device)
    print(f"results -> {out_path}", flush=True)
    return results


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return main(device=args.device)


if __name__ == "__main__":
    cli()
