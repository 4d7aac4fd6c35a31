"""Comprehensive decoder comparison of the PyTorch port (twin of the root
``comprehensive_test.py``, the reference's integration test).

Decode one batch through every decoder of ``create_test_decoders`` at
2 dB with timing and parameter counts, the parameter-reduction summary,
the weight-pattern analysis and the quantizer round-trip golden vector.
Failures raise.

    python -m ldpc_tpu_torch.cli.comprehensive [--code peg|test]
        [--batch N] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import ldpc_tpu_torch as lt


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_all_decoders(code=None, batch: int = 256, snr_db: float = 2.0,
                     device="cuda"):
    """One timed batched decode through every decoder of
    ``create_test_decoders`` (the reference decodes 1 frame; this decodes
    a batch and reports per-codeword throughput too). The time is of a
    second call, after ``torch.cuda.synchronize`` on the card."""
    if code is None:
        code = lt.create_test_ldpc_code()
    zoo = lt.create_test_decoders(code, max_iterations=10, device=device)
    llr = lt.awgn_llr(torch.Generator(device=device).manual_seed(0),
                      torch.zeros((batch, code.n), device=device), snr_db)
    results = {}
    for name, dec in zoo.items():
        dec(llr)  # warm-up (tables to the device)
        _sync(device)
        t0 = time.perf_counter()
        out = dec(llr)
        _sync(device)
        dt = time.perf_counter() - t0
        fer = out.bits.ne(0).any(dim=1).float().mean().item()
        results[name] = {
            "params": dec.param_count(),
            "success_rate": out.success.float().mean().item(),
            "fer": fer,
            "avg_iterations": out.iterations.float().mean().item(),
            "time_per_codeword": dt / batch,
            "codewords_per_sec": batch / dt,
        }
        print(f"  {name:14s} params={results[name]['params']:4d} "
              f"FER={fer:.3f} iters={results[name]['avg_iterations']:5.2f} "
              f"{results[name]['codewords_per_sec']:10.0f} cw/s")
    return results


def analyze_results(results):
    """Summary table + parameter-reduction ratios
    (reference ``comprehensive_test.py:187-229``)."""
    base = results["N-NMS"]["params"]
    print(f"\n  parameter reduction vs N-NMS ({base} params):")
    for name, r in results.items():
        red = 100.0 * (1 - r["params"] / base) if base else 0.0
        print(f"  {name:14s} {r['params']:4d} params ({red:5.1f}% reduction)")
    # the reference's golden counts on (7,4)@10 iters (SURVEY §2a)
    if base == 130:
        got = [results[f"N-2D-NMS-T{t}"]["params"] for t in (1, 2, 3, 4)]
        if got != [40, 40, 20, 20]:
            raise AssertionError(f"N-2D-NMS parameter counts {got}")
        print("  golden parameter counts OK (130/40/40/20/20)")


def check_weight_patterns(device="cuda"):
    """Reference ``comprehensive_test.py:231-250``."""
    from ldpc_tpu_torch.report import analyze_weight_patterns

    code = lt.create_test_ldpc_code()
    dec = lt.neural_min_sum(code, max_iterations=10, device=device)
    an = analyze_weight_patterns(dec)
    if an["total_parameters"] != 130 or \
            set(an["mean_weight_by_check_degree"]) != {3, 4}:
        raise AssertionError(f"N-NMS weight analysis {an}")
    means = {k: round(v, 3)
             for k, v in an["mean_weight_by_check_degree"].items()}
    print(f"  N-NMS weight stats: mean-by-dc={means}")


def check_quantization():
    """Golden round-trip vector (reference ``comprehensive_test.py:252-268``,
    input from ``rcq_decoder.py:609``)."""
    q = lt.NonUniformQuantizer(bc=3, C=5.0, gamma=1.5)
    codes = q.quantize(torch.tensor([-3.2, -1.1, 0.5, 2.8, 4.1])).numpy()
    np.testing.assert_array_equal(codes, [6, 5, 0, 2, 2])
    recon = q.dequantize(torch.as_tensor(codes)).numpy()
    thr = q.thresholds
    np.testing.assert_allclose(
        recon, [-thr[2], -thr[1], 0.0, thr[2], thr[2]], rtol=1e-6)
    print(f"  quantizer golden vector OK: {np.round(recon, 3).tolist()}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--code", choices=["test", "peg"], default="test")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    code = (lt.create_test_ldpc_code() if args.code == "test" else
            lt.create_peg_code(n=128, m=64, dv=3, seed=0, max_iterations=10))
    print(f"[1/4] all decoders on ({code.n},{code.k}), batch={args.batch}")
    results = run_all_decoders(code, batch=args.batch, device=args.device)
    print("[2/4] parameter analysis")
    analyze_results(results)
    print("[3/4] weight patterns")
    check_weight_patterns(args.device)
    print("[4/4] quantization")
    check_quantization()
    print("\nALL COMPREHENSIVE TESTS PASSED")


if __name__ == "__main__":
    main()
