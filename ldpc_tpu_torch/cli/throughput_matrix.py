"""Decode throughput of the PyTorch port on every code family the repo
ships (twin of ``experiments/throughput_matrix.py``).

The same seven entries, names, batches, SNRs and ladders (RCQ bc=3 on
2-4-6 @ gamma 1.3, bv=8 uniform on 4-8-12):

1. the bench QC code (5x37 base, lift 256): fused layered T=6 (K1) and
   fused flooding T=10 (K4), B=8192 at 7.0 dB;
2. the DVB-S2-structure (16200, 7200) IRA protograph
   (``codes/dvbs2_like_16200_7200.proto``, lift 360, row degrees 5 and 6):
   fused layered T=6, B=4096 at 1.6 dB;
3. Tanner (155, 64) (``codes/tanner_155_64.proto``, lift 31): fused
   layered T=6, B=16384 at 4.0 dB;
4. the QC-lifted PBRL (3096, 1032) (lift 86): fused layered T=10, B=8192
   at 1.2 dB;
5. the PBRL-like (3096, 1032) code without a QC structure through the
   general and the degree-bucketed engines, B=2048 at 1.2 dB, and their
   ratio ``bucketed_speedup``.

The fused entries store messages in bf16 with the full output (not lean).
Each entry's LLRs come from a ``torch.Generator`` seeded 0 on the device
(:func:`make_llr`). Timing (:func:`time_decoder`), as the JAX program's:
two warm-up decodes whose posteriors are summed, then the best of 3
trials of ``reps`` decodes whose iteration counts are summed on the
device, timed by ``measure_throughput`` (the card synchronised before the
clock starts and after the last decode). The general and bucketed
entries take ``max(3, reps // 3)`` decodes a trial.

The results go to ``--out`` (default ``throughput_matrix_torch.json`` in
the working directory; ``experiments/throughput_matrix.json`` holds the
JAX package's TPU results and is not written).

    python -m ldpc_tpu_torch.cli.throughput_matrix [--reps N] [--out PATH]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

import ldpc_tpu_torch as lt
from ldpc_tpu_torch.cli.bench import device_line
from ldpc_tpu_torch.utils.profiling import measure_throughput

__all__ = ["matrix_decoders", "make_llr", "time_decoder", "run", "main",
           "DEFAULT_OUT", "ENGINE_ENTRIES"]

QP = ((2.0, 1.3), (4.0, 1.3), (6.0, 1.3))
VQP = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
DEFAULT_OUT = "throughput_matrix_torch.json"
CODES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "codes")
# the engine entries: no kernel on their path, fewer decodes a trial
ENGINE_ENTRIES = ("pbrl3096_general", "pbrl3096_bucketed")


def matrix_decoders(device="cuda"):
    """``{name: (decoder, B, snr_db)}`` of the JAX program's entries, in its
    order (``experiments/throughput_matrix.py:87-157``)."""
    fused = dict(fused=True, batch_tile=64, dtype=torch.bfloat16)
    rcq = dict(kind="rcq", bc=3, bv=8, quantizer_params=QP,
               v2c_quantizer_params=VQP, device=device)

    def qc_decoder(base, lift, T, options, **kw):
        code = lt.create_qc_code(base, lift=lift, max_iterations=T)
        return lt.make_decoder(code, max_iterations=T,
                               qc=lt.build_qc_graph(base, lift),
                               qc_options=options, **rcq, **kw)

    out = {}
    base = np.random.default_rng(0).integers(0, 256, size=(5, 37))
    out["bench_qc9472_layered6_fused"] = (
        qc_decoder(base, 256, 6, fused, layered=True), 8192, 7.0)
    out["bench_qc9472_flooding10_fused"] = (
        qc_decoder(base, 256, 10, fused), 8192, 7.0)
    b2, lift2 = lt.load_protograph(
        os.path.join(CODES, "dvbs2_like_16200_7200.proto"))
    out["dvbs2_16200_layered6_fused"] = (
        qc_decoder(b2, lift2, 6, dict(fused, batch_tile=None),
                   layered=True), 4096, 1.6)
    b3, lift3 = lt.load_protograph(os.path.join(CODES,
                                                "tanner_155_64.proto"))
    out["tanner155_layered6_fused"] = (
        qc_decoder(b3, lift3, 6, dict(fused, batch_tile=512),
                   layered=True), 16384, 4.0)
    b5, lift5 = lt.create_pbrl_qc_protograph(k=1032, rate=1 / 3)
    out["pbrl3096_qc_layered10_fused"] = (
        qc_decoder(b5, lift5, 10, dict(fused, batch_tile=None),
                   layered=True), 8192, 1.2)
    c4 = lt.create_pbrl_like_code(k=1032, rate=1 / 3, max_iterations=10)
    for name, kw in zip(ENGINE_ENTRIES, ({}, {"bucketed": True})):
        out[name] = (lt.make_decoder(c4, max_iterations=10, **rcq, **kw),
                     2048, 1.2)
    return out


def make_llr(dec, B: int, snr_db: float):
    """The entry's LLRs: B all-zero frames at ``snr_db`` from a generator
    seeded 0 on the decoder's device."""
    gen = torch.Generator(device=dec.device).manual_seed(0)
    return lt.awgn_llr(gen, torch.zeros((B, dec.code.n), device=dec.device),
                       snr_db)


def time_decoder(dec, llr, reps: int) -> float:
    """Seconds of the fastest of 3 runs of ``reps`` decodes of ``llr``,
    after two warm-up decodes (``throughput_matrix.py:37-55``)."""
    for _ in range(2):
        dec(llr).posterior.sum().item()
    best = float("inf")
    for _ in range(3):
        acc = torch.zeros((), dtype=torch.int64, device=llr.device)

        def step():
            acc.add_(dec(llr).iterations.sum())

        best = min(best, reps / measure_throughput(step, reps=reps,
                                                   warmup=0))
        int(acc)
    return best


def run(reps: int = 10, out_path: str = DEFAULT_OUT, verbose: bool = True,
        device="cuda", entries=None):
    """Time every entry of ``entries`` (default: :func:`matrix_decoders`
    on ``device``) and write the results to ``out_path``; returns them."""
    if entries is None:
        entries = matrix_decoders(device)
    if verbose:
        print(f"device: {device_line(device)}", flush=True)
    results = {}
    for name, (dec, B, snr) in entries.items():
        r = max(3, reps // 3) if name in ENGINE_ENTRIES else reps
        llr = make_llr(dec, B, snr)
        cws = r * B / time_decoder(dec, llr, r)
        del llr
        results[name] = {"cw_per_sec": round(cws, 1), "batch": B,
                         "n": dec.code.n, "snr_db": snr,
                         "info_bits_per_sec": round(cws * dec.code.k, 1)}
        if verbose:
            print(f"{name}: {cws:,.0f} cw/s  (n={dec.code.n}, B={B})",
                  flush=True)
    if all(name in results for name in ENGINE_ENTRIES):
        general, bucketed = (results[k]["cw_per_sec"] for k in ENGINE_ENTRIES)
        results["bucketed_speedup"] = round(bucketed / general, 2)
        if verbose:
            print(f"bucketed speedup: {results['bucketed_speedup']}x",
                  flush=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"results -> {out_path}", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(reps=args.reps, out_path=args.out, device=args.device)


if __name__ == "__main__":
    main()
