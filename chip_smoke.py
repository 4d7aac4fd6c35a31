#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ldpc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises and exits non-zero:

1. device: requires a CUDA card (there is no CPU path) and prints
   ``nvidia-smi``'s name and power limit;
2. build: compiles the kernels from ``ldpc_tpu_torch/csrc`` with nvcc;
3. kernel vs plain: the fused layered kernel against its plain PyTorch
   version on the card, for every variant kind on a small code (f32 and
   bf16, lean and full, B=37) and on the bench code (5x37, lift 256);
   f32 must agree exactly in the hard outputs and to rtol 1e-6 / atol 1e-5
   in the posteriors, bf16 to >= 99.99% of bits and 99.9% of frames;
4. main path: the bench decoder (3-bit RCQ with the DDE ladder, 8-bit
   uniform V2C quantizer, layered, T=6, bf16, lean) under the {3, 6}
   two-checkpoint early exit with survivor budget 128, on B=32768 all-zero
   frames at 7.0 dB: 2 warm-up and 6 timed waves, the survivor budget and
   the FER checked on every wave, exactly 2 kernel launches per wave, and
   the first 64 frames checked against the plain path on the CPU.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Weights are not needed (the bench
decoder has none) and the channel LLRs come from a seeded CUDA generator.
"""

import dataclasses
import json
import subprocess
import sys
import time

sys.modules["jax"] = None  # the port must not need JAX; fail loudly if it does

import numpy as np
import torch

T, T1, S = 6, 3, 128
B_MAIN, SNR_DB = 32768, 7.0
BENCH_KW = dict(
    kind="rcq", bc=3, bv=8,
    quantizer_params=((2.6474, 1.3), (3.0869, 1.3), (5.3767, 1.3)),
    v2c_quantizer_params=((4.0, 1.0), (8.0, 1.0), (12.0, 1.0)),
    max_iterations=T, layered=True)
SMALL_KINDS = [
    ("ms", dict(kind="ms", factor=0.7)),
    ("rcq_bc3_bv8", dict(kind="rcq", bc=3, bv=8)),
    ("nms_t2", dict(kind="nms", sharing_type=2, init="nms", seed=1)),
    ("oms_t2", dict(kind="oms", sharing_type=2, seed=5)),
    ("wrcq_t2", dict(kind="wrcq", bc=3, sharing_type=2, init="nms", seed=6)),
    ("orcq_t2", dict(kind="orcq", bc=3, sharing_type=2, seed=7)),
    ("rcq_bc5_closed", dict(kind="rcq", bc=5, bv=8, closed_qdq=True)),
]


def small_base(mb=3, nb=8, lift=16, density=0.8, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, lift, size=(mb, nb))
    base = np.where(rng.random((mb, nb)) < 1.0 - density, -1, base)
    for i in range(mb):
        if (base[i] >= 0).sum() == 0:
            base[i, rng.integers(nb)] = rng.integers(lift)
    for j in range(nb):
        if (base[:, j] >= 0).sum() == 0:
            base[rng.integers(mb), j] = rng.integers(lift)
    return base


def plain_on(x, dec, T_, lean):
    """The plain PyTorch version of the fused decode on ``x``'s device."""
    from ldpc_tpu_torch.decode.fused import _fused_layered_plain
    return _fused_layered_plain(x, dec.weights, qc=dec.qc, spec=dec.spec,
                                max_iterations=T_, dtype=x.dtype, lean=lean)


def compare(name, dec, llr, dtype, lean):
    """Kernel vs plain on the card; returns the max abs posterior diff."""
    import ldpc_tpu_torch as lt
    x = llr.to(dtype)
    out = lt.qc_fused_decode_batch_layered(
        x, dec.weights, qc=dec.qc, spec=dec.spec,
        max_iterations=dec.max_iterations, dtype=dtype, lean=lean)
    ref = plain_on(x, dec, dec.max_iterations, lean)
    torch.cuda.synchronize()
    if not (torch.equal(out.iterations, ref.iterations) and
            out.bits.dtype == ref.bits.dtype):
        raise AssertionError(f"{name}: iterations or bit type differ")
    err = 0.0
    if dtype == torch.float32:
        if not (torch.equal(out.bits, ref.bits) and
                torch.equal(out.success, ref.success)):
            raise AssertionError(f"{name}: f32 hard outputs differ")
        if not lean:
            torch.testing.assert_close(out.posterior, ref.posterior,
                                       rtol=1e-6, atol=1e-5)
            err = (out.posterior - ref.posterior).abs().max().item()
        agree = frames = 1.0
    else:
        agree = (out.bits == ref.bits).float().mean().item()
        frames = (out.success == ref.success).float().mean().item()
        if agree < 0.9999 or frames < 0.999:
            raise AssertionError(f"{name}: bf16 agreement {agree} bits, "
                                 f"{frames} frames")
    print(f"  {name:16s} {str(dtype)[6:]:8s} {'lean' if lean else 'full'}"
          f"  B={llr.shape[0]}  bits agree {agree:.6f}  frames agree "
          f"{frames:.4f}  max|dpost| {err:g}  success "
          f"{out.success.float().mean().item():.3f}")
    return err


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "run only on an NVIDIA GPU")
    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.decode import _build, fused

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"[1 device] {card}  (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")

    t0 = time.perf_counter()
    fresh = not _build.library_path().exists()
    _build.load_library()
    print(f"[2 build] {time.perf_counter() - t0:.1f} s "
          f"({'built' if fresh else 'cached'}) {_build.library_path().name}")
    log = _build.library_path().with_suffix(".log")
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- 3: kernel vs plain version on the card
    print("[3 kernel vs plain]")
    base = small_base()
    code = lt.create_qc_code(base, lift=16, max_iterations=5)
    qc = lt.build_qc_graph(base, 16)
    gen = torch.Generator(device=dev).manual_seed(1)
    llr = lt.awgn_llr(gen, torch.zeros((37, code.n), device=dev), 2.5)
    for name, kw in SMALL_KINDS:
        dec = lt.make_decoder(code, max_iterations=5, qc=qc, **kw)
        for dtype in (torch.float32, torch.bfloat16):
            for lean in (False, True):
                compare(name, dec, llr, dtype, lean)

    bench_base = np.random.default_rng(0).integers(0, 256, size=(5, 37))
    bcode = lt.create_qc_code(bench_base, lift=256, max_iterations=T)
    bqc = lt.build_qc_graph(bench_base, 256)
    dec = lt.make_decoder(bcode, qc=bqc, qc_options=dict(
        fused=True, dtype=torch.bfloat16, lean=True), **BENCH_KW)
    llr256 = lt.awgn_llr(gen, torch.zeros((256, bcode.n), device=dev), 6.25)
    max_err = compare("bench", dec, llr256, torch.float32, False)
    compare("bench", dec, llr256, torch.bfloat16, True)

    # kernel vs plain times at the main path's shapes (bf16, lean)
    times = {}
    for B_, T_ in ((256, T), (128, T)):
        x = llr256[:B_].to(torch.bfloat16)
        kern = lambda: lt.qc_fused_decode_batch_layered(
            x, dec.weights, qc=bqc, spec=dec.spec, max_iterations=T_,
            dtype=torch.bfloat16, lean=True)
        plain = lambda: plain_on(x, dec, T_, True)
        k_ms, p_ms = time_ms(kern, 20), time_ms(plain, 2)
        k2_ms, p2_ms = time_ms(kern, 20), time_ms(plain, 2)
        times[B_] = (k_ms, p_ms, k2_ms, p2_ms)
        print(f"  time B={B_} T={T_}: kernel {k_ms:.4f} / {k2_ms:.4f} ms, "
              f"plain {p_ms:.2f} / {p2_ms:.2f} ms  [{card}]")

    # ---- 4: the main path at full width
    two_ck = lt.make_two_checkpoint_decoder(dec, t1=T1, survivor_budget=S)
    cw = torch.zeros((B_MAIN, bcode.n), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    llrs = [lt.awgn_llr(gen, cw, SNR_DB) for _ in range(3)]
    del cw
    torch.cuda.synchronize()

    n_warm, n_timed = 2, 6
    fused.KERNEL_LAUNCHES = 0
    survivors, errors = [], []

    def wave(i):
        out, n = two_ck(llrs[i % len(llrs)])
        survivors.append(n)
        errors.append(out.bits.any(dim=1).sum())
        return out

    for i in range(n_warm):
        wave(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_timed):
        out = wave(n_warm + i)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = fused.KERNEL_LAUNCHES
    n_waves = n_warm + n_timed

    surv = [int(n) for n in survivors]
    errs = [int(e) for e in errors]
    if launches != 2 * n_waves:
        raise AssertionError(f"{launches} kernel launches in {n_waves} waves")
    if max(surv) > S:
        raise AssertionError(f"survivor budget overflow: {surv}")
    fer = sum(errs) / (B_MAIN * n_waves)
    if not fer < 1e-2:
        raise AssertionError(f"FER {fer} vs the all-zero codeword")
    if out.bits.shape != (B_MAIN, bcode.n) or out.bits.dtype != torch.int8:
        raise AssertionError(f"bad output {out.bits.shape} {out.bits.dtype}")
    rate = n_timed * B_MAIN / secs
    print(f"[4 main path] B={B_MAIN} at {SNR_DB} dB, {n_waves} waves "
          f"({n_warm} warm-up): survivors {surv}, frame errors {errs}, "
          f"FER {fer:.3g}, kernel launches {launches}  [{card}]")
    print(f"  {rate:.1f} codewords/s over {n_timed} timed waves "
          f"({1e3 * secs / n_timed:.3f} ms/wave)  [{card}]")

    # the same path on the CPU (plain version) for the first 64 frames
    sub = llrs[0][:64]
    g_out, g_n = two_ck(sub)
    c_out, c_n = two_ck(sub.cpu())
    agree = (g_out.bits.cpu() == c_out.bits).float().mean().item()
    if int(g_n) != int(c_n) or agree < 0.9999 or not torch.equal(
            g_out.success.cpu(), c_out.success):
        raise AssertionError(f"main path vs plain on the CPU: survivors "
                             f"{int(g_n)} vs {int(c_n)}, bits {agree}")
    print(f"  first 64 frames vs the CPU plain path: survivors {int(g_n)}, "
          f"bits agree {agree:.6f}, success equal")

    # where a wave's time goes: the two kernel launches alone
    x1 = llrs[0].to(torch.bfloat16)
    s1 = dataclasses.replace(dec, qc_options=None).truncated(T1)
    st1 = time_ms(lambda: lt.qc_fused_decode_batch_layered(
        x1, s1.weights, qc=bqc, spec=s1.spec, max_iterations=T1,
        dtype=torch.bfloat16, lean=True), 3)
    st2 = times[128][0]
    print(f"  stage-1 kernel (B={B_MAIN}, T={T1}) {st1:.3f} ms, stage-2 "
          f"kernel (B={S}, T={T}) {st2:.4f} ms, wave {1e3 * secs / n_timed:.3f}"
          f" ms  [{card}]")

    print(card)
    print(json.dumps({"kernels": [{
        "name": "fused_layered",
        "route": "cuda",
        "source": "ldpc_tpu_torch/csrc/fused_layered.cu",
        "replaces": "ldpc_tpu/decode/pallas_fused.py:467",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times[256][0],
        "plain_ms": times[256][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
