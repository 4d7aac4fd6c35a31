"""Power-law V2C ladders on the precoded PBRL graph: reach and
resolution at once (twin of ``experiments/pbrl_vqp_gamma.py``).

The code and decode are ``pbrl_bv10``'s: the precoded PBRL code (25x37
at lift 86, n = 3182, base column 0's 86 bits punctured), RCQ bc=4 on
the refined CN ladder ``CN_REF3``, bv=8, layered T=10 through K1 in bf16
on the card (float32 on the CPU). The arms' V2C ladders are power laws
(``tau_j = C (j / 127)^gamma``, K2's 128-entry level table):

- ``bc4_g1.5_C300``: C = 200, 300, 360 at gamma 1.5;
- ``bc4_g2.0_C300``: the same reaches at gamma 2.0;
- ``bc4_g1.5_ref3C``: ``VQP_REF3``'s reaches (182.6, 315.3, 394.1) at
  gamma 1.5.

In the layered schedule only the posterior passes through the V2C
quantizer, so all three decode as ``pbrl_wrcq``'s ``rcq-ref3``.

:func:`main` runs each arm at ``snrs`` as ``pbrl_bv10.main`` does and
writes ``pbrl_vqp_gamma_torch.json`` in the working directory.

    python -m ldpc_tpu_torch.cli.pbrl_vqp_gamma [--device cpu]
"""

from __future__ import annotations

import argparse
import logging

from ldpc_tpu_torch.cli import pbrl_wrcq as pw
from ldpc_tpu_torch.cli.pbrl_bv10 import CN_REF3, VQP_REF3, sweep

__all__ = ["CN_REF3", "VQP_REF3", "LADDERS", "DEFAULT_OUT", "build_arms",
           "main", "cli"]

# arm -> its power-law V2C ladder (pbrl_vqp_gamma.py:59-65)
LADDERS = {
    "bc4_g1.5_C300": ((200.0, 1.5), (300.0, 1.5), (360.0, 1.5)),
    "bc4_g2.0_C300": ((200.0, 2.0), (300.0, 2.0), (360.0, 2.0)),
    "bc4_g1.5_ref3C": ((182.6, 1.5), (315.3, 1.5), (394.1, 1.5)),
}
DEFAULT_OUT = "pbrl_vqp_gamma_torch.json"


def build_arms(device="cuda"):
    """({arm: decoder}, punctured bit positions)
    (``pbrl_vqp_gamma.py:53-65``)."""
    mk, punct, _ = pw._mk_setup(device)
    return {name: mk("rcq", CN_REF3, vqp=vqp)
            for name, vqp in LADDERS.items()}, punct


def main(frames=2 * 10 ** 7, errors=100, snrs=(2.0, 2.4),
         out_path=DEFAULT_OUT, device="cuda"):
    """The program's sweep (``pbrl_vqp_gamma.py:28-85``)."""
    logging.basicConfig(level=logging.INFO, force=True)
    arms, punct = build_arms(device)
    results = sweep(arms, punct, frames, errors, snrs, out_path,
                    lambda name, snr, fer, ne, nf: (
                        f"{name:16s} @ {snr} dB: FER {fer:.3e} "
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
