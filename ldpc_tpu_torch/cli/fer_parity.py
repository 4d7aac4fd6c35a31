"""FER parity of the RCQ decoders against float min-sum (twin of
``experiments/fer_parity.py``).

The PEG (256, 128) dv=3 code at T=20 and the JAX program's four decoders:
float min-sum (factor 0.7), RCQ bc=3, RCQ bc=3 with the 8-bit V2C
quantizer and RCQ bc=4, each on the 3-5-7 @ gamma 1.3 ladder. The code
has no QC structure, so they decode on the general flooding engine (no
kernel lies on this path). ``LDPCSimulator`` sweeps 1.0-4.0 dB in 0.5 dB
steps with waves of 4096 frames, ``frames`` a point at most, stopping at
``max(200, frames // 64)`` frame errors once ``min(8192, frames)`` frames
ran. :func:`snr_at_fer` interpolates each curve's SNR at FER 1e-2 (1e-3
from 100,000 frames a point up), and the report gives each decoder's gap
to float min-sum there.

The results go to ``--out`` (default ``fer_parity_torch.json`` in the
working directory; ``experiments/fer_parity_results.json`` holds the JAX
package's TPU results and is not written), with the JAX program's keys.

    python -m ldpc_tpu_torch.cli.fer_parity [--frames 65536] [--out PATH]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

import ldpc_tpu_torch as lt

__all__ = ["snr_at_fer", "parity_decoders", "parity_config",
           "gaps_report", "run", "main", "DEFAULT_OUT"]

DEFAULT_OUT = "fer_parity_torch.json"
QP = ((3.0, 1.3), (5.0, 1.3), (7.0, 1.3))


def snr_at_fer(snrs, fers, target):
    """Interpolate the SNR where the FER curve crosses ``target``
    (log-linear in FER); None when the curve does not cross it."""
    snrs = np.asarray(snrs, float)
    fers = np.asarray(fers, float)
    ok = fers > 0
    snrs, fers = snrs[ok], fers[ok]
    if len(snrs) < 2 or fers.min() > target or fers.max() < target:
        return None
    lf = np.log10(fers)
    # FER decreases with SNR: walk to the crossing segment
    for i in range(len(snrs) - 1):
        if fers[i] >= target >= fers[i + 1]:
            t = (np.log10(target) - lf[i]) / (lf[i + 1] - lf[i])
            return float(snrs[i] + t * (snrs[i + 1] - snrs[i]))
    return None


def parity_decoders(device="cuda"):
    """The JAX program's four decoders on the PEG (256, 128) code
    (``experiments/fer_parity.py:50-64``)."""
    code = lt.create_peg_code(n=256, m=128, dv=3, seed=0, max_iterations=20)
    kw = dict(quantizer_params=QP, max_iterations=20, device=device)
    return {
        "float-MS": lt.basic_min_sum(code, factor=0.7, max_iterations=20,
                                     device=device),
        "RCQ-bc3": lt.rcq_min_sum(code, bc=3, **kw),
        "RCQ-bc3-bv8": lt.rcq_min_sum(code, bc=3, bv=8, **kw),
        "RCQ-bc4": lt.rcq_min_sum(code, bc=4, **kw),
    }


def parity_config(frames: int, device="cuda") -> lt.SimulationConfig:
    """The sweep of ``experiments/fer_parity.py:65-67`` at ``frames`` a
    point."""
    return lt.SimulationConfig(
        snr_range=(1.0, 4.0), snr_step=0.5, max_frames=frames,
        max_errors=max(200, frames // 64), min_frames=min(8192, frames),
        wave_size=4096, device=device)


def gaps_report(results, target, verbose=True):
    """(float min-sum's SNR at ``target``, {decoder: its gap in dB or
    None}); ``results`` must hold "float-MS"."""
    base = results["float-MS"]
    base_snr = snr_at_fer(base.snr_values, base.frame_error_rates, target)
    gaps = {}
    for name, r in results.items():
        s = snr_at_fer(r.snr_values, r.frame_error_rates, target)
        gap = None if (s is None or base_snr is None) else s - base_snr
        gaps[name] = gap
        if verbose:
            print(f"{name:24s} SNR@FER{target:g} = "
                  f"{'n/a' if s is None else f'{s:.3f} dB'}"
                  f" (gap {'n/a' if gap is None else f'{gap:+.3f} dB'})",
                  flush=True)
    return base_snr, gaps


def run(frames: int = 65536, out_path: str = DEFAULT_OUT, device="cuda",
        verbose: bool = True):
    """Sweep the four decoders, write the report to ``out_path`` and
    return it."""
    decoders = parity_decoders(device)
    code = decoders["float-MS"].code
    sim = lt.LDPCSimulator(parity_config(frames, device))
    results = sim.simulate_multiple_decoders(decoders, verbose=verbose)
    target = 1e-2 if frames < 100000 else 1e-3
    base_snr, gaps = gaps_report(results, target, verbose)
    report = {"code": f"PEG({code.n},{code.k}) dv=3, 20 iters",
              "frames_per_point": frames, "target_fer": target,
              "float_ms_snr_at_target": base_snr, "gaps_db": gaps,
              "curves": {k: r.to_dict() for k, r in results.items()}}
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"results -> {out_path}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=65536)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.frames, args.out, args.device)


if __name__ == "__main__":
    main()
