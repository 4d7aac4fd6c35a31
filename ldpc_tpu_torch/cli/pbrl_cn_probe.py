"""Three CN ladders around the refined one on the precoded PBRL graph
(twin of ``experiments/pbrl_cn_probe.py``).

The code and decode are ``pbrl_bv10``'s: the precoded PBRL code (25x37
at lift 86, n = 3182, base column 0's 86 bits punctured), RCQ bc=4,
bv=8 on the uniform V2C ladder ``VREF3`` (183-315-394), layered T=10
through K1 in bf16 on the card (float32 on the CPU; the JAX program
has no CPU switch). The arms move the CN ladder (gamma 1.3):

- ``cn_8.5-16-16``: 8.4963, 16.0, 16.0;
- ``cn_6-12-12``: 6.0, 12.108, 12.108;
- ``cn_8.5-12-16``: 8.4963, 12.108, 16.0.

The JAX program runs at import, from the repo root, and writes
``experiments/pbrl_cn_probe_results.json``; the twin runs in
:func:`main`, from the working directory, and writes
``pbrl_cn_probe_torch.json`` there.

    python -m ldpc_tpu_torch.cli.pbrl_cn_probe [--device cpu]
"""

from __future__ import annotations

import argparse
import logging

from ldpc_tpu_torch.cli import pbrl_wrcq as pw
from ldpc_tpu_torch.cli.pbrl_bv10 import sweep

__all__ = ["VREF3", "LADDERS", "DEFAULT_OUT", "build_arms", "main", "cli"]

VREF3 = ((182.5928, 1.0), (315.3076, 1.0), (394.1345, 1.0))
# arm -> its CN ladder (pbrl_cn_probe.py:21-25)
LADDERS = {
    "cn_8.5-16-16": ((8.4963, 1.3), (16.0, 1.3), (16.0, 1.3)),
    "cn_6-12-12": ((6.0, 1.3), (12.108, 1.3), (12.108, 1.3)),
    "cn_8.5-12-16": ((8.4963, 1.3), (12.108, 1.3), (16.0, 1.3)),
}
DEFAULT_OUT = "pbrl_cn_probe_torch.json"


def build_arms(device="cuda"):
    """({arm: decoder}, punctured bit positions)
    (``pbrl_cn_probe.py:11-25``)."""
    mk, punct, _ = pw._mk_setup(device)
    return {name: mk("rcq", cn, vqp=VREF3)
            for name, cn in LADDERS.items()}, punct


def main(frames=2 * 10 ** 7, errors=100, snrs=(2.0, 2.4),
         out_path=DEFAULT_OUT, device="cuda"):
    """The program's sweep (``pbrl_cn_probe.py:26-38``)."""
    logging.basicConfig(level=logging.WARNING, force=True)
    arms, punct = build_arms(device)
    results = sweep(arms, punct, frames, errors, snrs, out_path,
                    lambda name, snr, fer, ne, nf: (
                        f"{name:14s} @ {snr}: FER {fer:.3e} ({ne}/{nf})"),
                    device)
    print("done", flush=True)
    return results


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return main(device=args.device)


if __name__ == "__main__":
    cli()
