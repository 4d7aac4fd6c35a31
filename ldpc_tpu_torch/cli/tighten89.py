"""The rate-8/9 section VII-C verdict points re-measured to about 500
errors (twin of ``experiments/tighten89.py``).

The arms ``oms6``, ``rcq-pol`` and ``wrcq-89`` of
``ldpc_tpu_torch.cli.pbrl_rates._mk_setup("89")`` (the precoded PBRL
code at rate 8/9, lift 43: a 4x28 base, n = 1204, base column 0's 43
bits punctured; layered T=10 through K1, ``csrc/fused_layered.cu``, in
bf16 on the card, on the CPU the kernel's plain version in float32), each
at 9.0 and 9.2 dB under the {5, 10} two-checkpoint compaction (survivor
budget 4096, waves of 262,144 frames), seed 99, until 500 frame errors
once 65,536 frames ran, or 2.5e8 frames. The points are written after
each to ``tighten89_torch.json`` in the working directory (never
``experiments/tighten89_results.json``) and a rerun resumes after them.
``wrcq-89``'s tables are the JAX program's (``pbrl_rates.install_tables``
writes them to ``pbrl_rates_torch_ck/`` where they are missing).

    python -m ldpc_tpu_torch.cli.tighten89 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import pbrl_rates

__all__ = ["OUT", "ARMS", "SNRS", "MAX_FRAMES", "MAX_ERRORS", "SEED",
           "main"]

OUT = "tighten89_torch.json"
ARMS = ("oms6", "rcq-pol", "wrcq-89")
SNRS = (9.0, 9.2)
MAX_FRAMES, MAX_ERRORS, SEED = 250_000_000, 500, 99


def main(device="cuda"):
    """Each arm's points at SNRS (``tighten89.py:21-60``); returns {arm:
    {SNR: {"fer", "frames", "errors"}}}."""
    mk, punct_bits, code = pbrl_rates._mk_setup("89", device)
    res = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            res = json.load(f)
    wave = pbrl_rates.wave_size(code.n)
    for arm in ARMS:
        dec = mk(arm)
        pts = res.setdefault(arm, {})
        for snr in SNRS:
            key = f"{snr:.1f}"
            if key in pts:
                continue
            cfg = lt.SimulationConfig(
                snr_range=(snr, snr), max_frames=MAX_FRAMES,
                max_errors=MAX_ERRORS, min_frames=pbrl_rates.MIN_FRAMES,
                wave_size=wave, early_exit_iters=pbrl_rates.EARLY_EXIT,
                survivor_budget=pbrl_rates.BUDGET,
                punctured_positions=punct_bits, save_results=False,
                seed=SEED, device=device)
            fer, ber, it, nf, ne = lt.simulate_single_snr(dec, snr, cfg)
            pts[key] = {"fer": fer, "frames": nf, "errors": ne}
            with open(OUT, "w") as f:
                json.dump(res, f, indent=2)
            print(f"89/{arm} @ {snr}: FER {fer:.4e} ({ne}/{nf})",
                  flush=True)
    return res


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the simulator's heartbeat lines
    logging.basicConfig(level=logging.INFO, force=True)
    return main(args.device)


if __name__ == "__main__":
    cli()
