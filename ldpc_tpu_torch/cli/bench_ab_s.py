"""The survivor budget S of the bench wave (twin of
``experiments/bench_ab_s.py``).

Stage 2 of the {3, 6} two-checkpoint decode re-decodes a fixed batch of
S rows at full depth, so its work scales with S, not with the survivor
count (about 15-20 of 32768 frames at 7.0 dB). The bench decoder
(:func:`~ldpc_tpu_torch.cli.bench.bench_decoder`: the DDE ladder, bv=8
uniform, layered T=6 through the whole-decode kernel K1 in bf16 with the
lean output) runs under S = 512, 256 and 128 on two B=32768 LLR sets at
7.0 dB drawn once from a generator seeded 0 on the device. Each budget
first decodes both sets, its survivor count held to S on every wave
(``bench_ab_s.py:54-60``); then 4 trials, interleaved over the budgets, of
10 waves each, each wave's bits summed on the device and timed by
:func:`ldpc_tpu_torch.cli.bench.measure` (every timed wave's survivors
held to S too). The best rate of each budget goes to ``--out`` (default
``bench_ab_s_torch.json`` in the working directory;
``experiments/bench_ab_s_results.json`` holds the JAX package's TPU
results and is not written), under the JAX program's keys ``"512"``,
``"256"``, ``"128"``.

    python -m ldpc_tpu_torch.cli.bench_ab_s [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli import bench

__all__ = ["BUDGETS", "T1", "SETS", "TRIALS", "DEFAULT_OUT",
           "budget_decoders", "run", "main"]

BUDGETS = (512, 256, 128)
T1, SETS, TRIALS = 3, 2, 4
DEFAULT_OUT = "bench_ab_s_torch.json"


def budget_decoders(dec):
    """{S: the {T1, T} two-checkpoint decode of ``dec`` with budget S} for
    each S of BUDGETS."""
    return {S: lt.make_two_checkpoint_decoder(dec, t1=T1, survivor_budget=S)
            for S in BUDGETS}


def run(device="cuda", out_path: str = DEFAULT_OUT, verbose: bool = True):
    """Warm up and time each budget; returns ``{str(S): best cw/s}`` and
    writes it to ``out_path``."""
    dec = bench.bench_decoder(device)
    if verbose:
        print(f"device: {bench.device_line(dec.device)}", flush=True)
    fns = budget_decoders(dec)
    llrs = bench.make_llrs(bench.B, dec.code.n, bench.SNR_DB,
                           torch.Generator(device=dec.device).manual_seed(0),
                           sets=SETS)
    for S, fn in fns.items():
        counts = bench.warm_up(fn, llrs, S, waves=SETS)
        if verbose:
            print(f"warm S={S}: survivors {counts}", flush=True)
    best = {S: 0.0 for S in fns}
    for trial in range(TRIALS):
        for S, fn in fns.items():
            rate = bench.measure(fn, llrs, S, bench.REPS, trials=1)[0]
            best[S] = max(best[S], rate)
            if verbose:
                print(f"trial {trial} S={S}: {rate:,.0f} cw/s", flush=True)
    out = {str(S): round(v, 1) for S, v in best.items()}
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.device, args.out)


if __name__ == "__main__":
    main()
