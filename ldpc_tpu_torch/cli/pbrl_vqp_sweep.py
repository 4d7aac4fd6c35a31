"""V2C-ladder reach against resolution on the precoded PBRL graph (twin
of ``experiments/pbrl_vqp_sweep.py``).

The code and decode are ``pbrl_bv10``'s: the precoded PBRL code (25x37
at lift 86, n = 3182, base column 0's 86 bits punctured), RCQ on the
refined CN ladder ``CN_REF3``, bv=8, layered T=10 through K1 in bf16 on
the card (float32 on the CPU). The arms walk the uniform V2C ladder's
reach with the CN ladder held:

- ``bc4_vr48``, ``bc4_vr96``, ``bc4_vr192``: bc=4 on
  :func:`ladder` (reach/3, 2 reach/3, reach) at reach 48, 96 and 192;
- ``bc4_vref3``: bc=4 on the designed ``VQP_REF3`` (183-315-394);
- ``bc5_vr96``: bc=5 in its closed form on the reach-96 ladder.

In the layered schedule only the posterior passes through the V2C
quantizer, so the four bc=4 arms decode as ``pbrl_wrcq``'s ``rcq-ref3``
and ``bc5_vr96`` as ``pbrl_bv10``'s ``bc5_bv10``.

:func:`main` runs each arm at ``snrs`` as ``pbrl_bv10.main`` does and
writes ``pbrl_vqp_sweep_torch.json`` in the working directory.

    python -m ldpc_tpu_torch.cli.pbrl_vqp_sweep [--device cpu]
"""

from __future__ import annotations

import argparse
import logging

from ldpc_tpu_torch.cli import pbrl_wrcq as pw
from ldpc_tpu_torch.cli.pbrl_bv10 import CN_REF3, VQP_REF3, sweep

__all__ = ["CN_REF3", "VQP_REF3", "DEFAULT_OUT", "ladder", "build_arms",
           "main", "cli"]

DEFAULT_OUT = "pbrl_vqp_sweep_torch.json"


def ladder(rmax):
    """The uniform 3-step V2C ladder of reach ``rmax``."""
    return ((rmax / 3, 1.0), (2 * rmax / 3, 1.0), (rmax, 1.0))


def build_arms(device="cuda"):
    """({arm: decoder}, punctured bit positions)
    (``pbrl_vqp_sweep.py:54-65``)."""
    mk, punct, _ = pw._mk_setup(device)
    arm = lambda bc, vqp: mk("rcq", CN_REF3, vqp=vqp, bc=bc)
    arms = {f"bc4_vr{r}": arm(4, ladder(r)) for r in (48, 96, 192)}
    arms["bc4_vref3"] = arm(4, VQP_REF3)
    arms["bc5_vr96"] = arm(5, ladder(96))
    return arms, punct


def main(frames=2 * 10 ** 7, errors=100, snrs=(2.0, 2.4),
         out_path=DEFAULT_OUT, device="cuda"):
    """The program's sweep (``pbrl_vqp_sweep.py:29-85``)."""
    logging.basicConfig(level=logging.INFO, force=True)
    arms, punct = build_arms(device)
    results = sweep(arms, punct, frames, errors, snrs, out_path,
                    lambda name, snr, fer, ne, nf: (
                        f"{name:12s} @ {snr} dB: FER {fer:.3e} "
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
