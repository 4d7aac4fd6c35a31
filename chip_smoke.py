#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ldpc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises and exits non-zero:

1. device: requires a CUDA card (there is no CPU path) and prints
   ``nvidia-smi``'s name and power limit;
2. build: compiles the kernels from ``ldpc_tpu_torch/csrc`` with nvcc (one
   nvcc per source, all at once, linked into one library);
3. K1 vs plain: the fused layered kernel against its plain PyTorch
   version on the card, for every variant kind on a small code (f32 and
   bf16, lean and full, B=37), on the bench code (5x37, lift 256) and on
   the zoo's trained layered decoder ``worcq_bc3_layered_t6`` (W-OMS-RCQ,
   sharing type 2, on the bench code) at B=256, bit for bit in both
   types: bits, success and the posteriors' bit patterns (NaN where the
   plain version has NaN); the zoo decoder timed at B=32768, T=6, and
   K1's registers, spills, shared memory and resident CTAs per SM;
4. bench path: the bench decoder (3-bit RCQ with the DDE ladder, 8-bit
   uniform V2C quantizer, layered, T=6, bf16, lean) under the {3, 6}
   two-checkpoint early exit with survivor budget 128, on B=32768 all-zero
   frames at 7.0 dB: 2 warm-up and 6 timed waves, the survivor budget and
   the FER checked on every wave, exactly 2 K1 launches per wave, and the
   first 64 frames checked against the plain path on the CPU;
5. K4 vs plain: the fused flooding kernel against its plain version with
   the rules of phase 3, on the small code and on the zoo's
   ``worcq_bc3_qc9472`` decoder (5x37, lift 256, trained W-OMS-RCQ,
   flooding T=10) at B=256, and both timed at the simulator's shapes;
6. simulator path: that zoo decoder (bf16, lean) through ``LDPCSimulator``
   at 6.0, 6.25 and 6.5 dB with 32768-frame compacting waves ({6, 10}
   checkpoints, survivor budget 8192): both the overflow fallback and the
   compacted wave must run, only K4 may launch, and the FER must fall in
   bands around the JAX package's curve for this decoder
   (``experiments/accuracy_bc3_results.json``); the first wave's first 64
   frames are checked against the plain path on the CPU;
7. K5/K6 vs plain: the row and column kernels against their plain
   versions, bit for bit, single launches on every row and column of the
   small code (all kinds, f32 and bf16) and on the zoo's row 0 and column
   0 (B=256), the whole row/column decode against its plain driver, and
   one launch of each timed at B=32768 (bf16);
8. row/column path: the zoo decoder through ``qc_pallas_decode_batch`` at
   B=32768, bf16, T=10, ``check_every=1``, 6.25 dB, timed twice after a
   warm-up at full size: exactly T*mb = 50 K5 and T*nb = 370 K6 launches
   in each decode and no K1 or K4, FER in the 6.25 dB band;
   the same LLRs through the engine route (``load_pretrained(...,
   qc_options={"dtype": bf16})``), held to it statistically (the two round
   at different points in bf16); the first 64 frames against the CPU
   plain path;
9. non-fused compaction: one 32768-frame wave at 6.5 dB of the zoo
   decoder with ``check_every=5`` through ``LDPCSimulator``
   (``early_exit_iters=5``, ``stage1_fused``, survivor budget 16384): it
   must be compacted, launch K4 once, and count 0-20 frame errors;
10. general, layered and bucketed engines: PBRL (3096, 1032) with RCQ
   bc=3, bv=8, T=10 at 1.2 dB (``experiments/throughput_matrix.py``) on
   four routes (general flooding f32, bucketed f32 and bf16, general
   layered f32): each on the card equal to the CPU on 256 numpy frames
   (bits, success, iterations; posteriors bit for bit), general equal to
   bucketed in f32 and bf16 within 1% of bits and 0.5% of successes of
   f32 at B=2048, each timed at B=2048 and 32768 with its CUDA kernel
   launches per decode (torch.profiler); the ten decoders of
   ``create_test_decoders`` at B=2048, their first 64 frames equal to the
   CPU's; the bucketed bf16 decoder through ``LDPCSimulator`` (32768-frame
   compacting waves, ``early_exit_iters=5``, ``check_every=5``) with its
   FER in a binomial band around the JAX package's; no K1, K4, K5 or K6
   launch in the phase;
11. training at full width: the zoo's two operating decoders
   (``worcq_bc3_qc9472``, flooding T=10, and ``worcq_bc3_layered_t6``,
   layered T=6: W-OMS-RCQ, sharing type 2, on QC(9472, 8192)) rebuilt from
   their recipes with the port's initial weights, trained through
   ``PosteriorJointTrainer`` with the configurations of
   ``experiments/accuracy_bc3.py`` (B=128, 8 steps, one ``train_epoch``)
   and ``experiments/train_layered_short.py`` (cosine with 8 warmup
   updates: 4 steps, the first at learning rate 0, so its weights stay);
   each step's loss, CUDA-event time and peak memory, the CUDA launches of
   one step (torch.profiler); one B=16 batch stepped twice on the card and
   on a CPU copy of the flooding decoder, held to float tolerance; the
   gradient analyzer (``torch.func.vmap``) on 32 frames at 6.5 dB, four
   of its norms recomputed one frame at a time; no K1, K4, K5 or K6
   launch while training (the training route is the engines'); then each
   trained decoder's weights in its fused bf16 twin, K4 (flooding) and K1
   (layered) held to their plain versions bit for bit on 256 frames.
12. design, encoder and error floor at full width, only K1 launching:
   (a) ``design_rcq_ladders`` on the bench profile
   (``experiments/dde_ladders.py:52-66``'s call; host numpy, run in a
   worker process from the script's start beside phases 1-11) equal to
   the JAX package's ladders and DE threshold
   (``experiments/design_reference.py``), ``analyze_decoder`` of the
   layered T=6 decoder on that ladder equal to its trajectory (rtol 1e-12,
   or 1e-15 absolute: numpy builds round the FFTs apart), and one B=32768
   wave at 6.5 dB through K1;
   (b) ``make_encoder`` on the bench code (k_eff 8196), B=32768 random
   messages encoded on the card (CUDA-event times of the encode and
   ``syndrome_ok``), every codeword passing ``syndrome_ok``, the first 64
   equal to the CPU encoder's, decoded at 6.25 dB by the bench decoder
   (no early exit) with the FER inside a 4-sigma two-proportion band of
   the all-zero FER and every correct frame giving back its message;
   (c) ``experiments/floor_is.py``'s two arms at 3.6 dB (PBRL QC rate 1/3,
   lift 86, random and precoded; RCQ bc=4 6-11-16, bv=8, layered T=10,
   fused bf16): its trapping-set search and class choice, the
   multiplicities equal to ``experiments/floor_is_results.json``'s, K1 held
   to its plain version bit for bit in f32 and bf16 on 256 biased frames
   of each arm, up to 3 exemplars a class (shift 1.6, 2^15 samples,
   batch 2^11), each p within 4 combined standard errors of the JSON's in
   log where both relative errors are below 0.5, the precoded arm's
   punctured LLRs zero in every batch; (d) ``analyze_weight_patterns`` on
   ``zoo/worcq_bc3_qc9472`` on the card equal to the CPU's,
   ``measure_throughput`` and ``ThroughputCounter`` over IS batches,
   ``trace()`` around one IS batch with its K1 event counted, and a
   ``save_checkpoint``/``load_checkpoint`` round trip of the ladders and
   the estimates.
13. parallel and the CLIs: (a) a world of one over NCCL in this process:
   the bench program over the mesh (``make_spmd_two_checkpoint_stats_fn``
   on phase 4's decoder and first B=32768 LLR set at 7.0 dB) with its five
   pooled stats equal to the single-device two-checkpoint decode and
   exactly 2 K1 launches, timed in turns against the same program without
   a process group and the decode alone (phase 4's wave printed beside); ``LDPCSimulator(mesh=)`` on ``zoo/worcq_bc3_qc9472`` at
   6.5 dB with 32768-frame waves, the plain SPMD wave through K4 and phase
   9's compaction with stage 1 on K4, each equal to the single-device
   simulator's counts; one data-parallel step of the zoo's flooding recipe
   (B=128, T=10) leaving weights equal to the step without a mesh. (b) Two
   ranks sharing the card over gloo (``parallel.spawn``): a K4 SPMD wave of
   2x4096 frames equal to the sum of the two ranks' waves drawn here with
   their generators; the bench program at B=2x16384 (S=128 a rank) equal
   to the single-device decode; two data-parallel steps within rtol 1e-5
   of one process's. (c) The CLI twins on the card, each timed:
   ``examples`` (every scenario, in a process beside (b)),
   ``comprehensive --code peg``,
   ``graft_entry`` (``entry()`` and ``dryrun_multichip(1)`` over NCCL), and
   ``generate_images``' comparison at 1024 frames and its DE figure (the DE
   curves are host numpy, computed in the worker process beside phases
   1-12; without matplotlib the figures' data is checked and not drawn).

Each kernel's ``bound_ms`` is the larger of its compulsory bytes (inputs
read once, outputs written once) over 3.35 TB/s, the H100 SXM's published
rate, and its float32 operations (counted from the function the kernel
computes, a transcendental as one, the quantizers' per-iteration
constants not per edge, and each check's c2v transform and quantizer once
per value the function must compute: per edge, or four times per check
on a row whose blocks share (beta, alpha) at the iteration) over 33.5e12
per second: the kernels build with ``-fmad=false``, so every add,
multiply, compare and select is its own instruction, and the card issues
at most one per FP32 lane per clock (132 SMs x 128 lanes x 1.98 GHz; the
published 67 TFLOP/s counts an FMA as two). Phases 3, 5 and 7 print each
kernel's registers and spills (the build's ptxas report) and its
resident CTAs per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
through the library).
No single PyTorch call computes an LDPC decode or one of its row or
column updates, so ``library_ms`` is null.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. The bench decoder has no weights, the
zoo decoder's come from ``zoo/``; the channel LLRs come from seeded CUDA
generators.
"""

import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time

sys.modules["jax"] = None  # the port must not need JAX; fail loudly if it does

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
# separately rounded float32 operations per second: the kernels build with
# -fmad=false, so each add, multiply, compare or select is one instruction,
# one per FP32 lane per clock: 132 SMs x 128 lanes x 1.98 GHz
F32_OPS_PER_S = 33.5e12

T, T1, S = 6, 3, 128
B_MAIN, SNR_DB = 32768, 7.0
BENCH_KW = dict(
    kind="rcq", bc=3, bv=8,
    quantizer_params=((2.6474, 1.3), (3.0869, 1.3), (5.3767, 1.3)),
    v2c_quantizer_params=((4.0, 1.0), (8.0, 1.0), (12.0, 1.0)),
    max_iterations=T, layered=True)
# phase 6: the simulator on the zoo's flooding decoder. early exit at 6:
# at 5 the 6.5 dB waves overflow the budget too (the survivor probe below
# prints the count for 5..8), and the compacted wave must run there
ZOO_ENTRY, SIM_T1, SIM_WAVE, SIM_BUDGET = "worcq_bc3_qc9472", 6, 32768, 8192
# phase 3: the zoo's trained layered decoder on the bench code
ZOO_LAYERED = "worcq_bc3_layered_t6"
SIM_CONFIG = dict(snr_range=(6.0, 6.5), snr_step=0.25, max_frames=131072,
                  max_errors=2000, min_frames=16384, wave_size=SIM_WAVE,
                  early_exit_iters=SIM_T1, survivor_budget=SIM_BUDGET,
                  seed=0, save_results=False)
# the JAX package's FER for this decoder (experiments/
# accuracy_bc3_results.json, "W-OMS-RCQ-bc3-trained": bf16, fused, T=10):
# 0.822 at 6.0 dB, 0.0983 at 6.25 dB, 28 errors in 131072 frames at 6.5 dB
FER_BANDS = {6.0: (0.772, 0.872), 6.25: (0.074, 0.123)}
ERRORS_65 = (8, 60)
# phases 7-9: the row/column path (K5, K6) and the engine route on the
# same zoo decoder. Phase 8: B=32768 frames at 6.25 dB through K5/K6, T=10,
# check_every=1, FER in the 6.25 dB band. Phase 9: one compacting wave of
# the non-fused decoder (check_every=5) with stage 1 on K4; the JAX curve
# expects about 7 frame errors in 32768 at 6.5 dB
RC_B, RC_SNR, RC_T = 32768, 6.25, 10
NF_CONFIG = dict(snr_range=(6.5, 6.5), snr_step=0.25, max_frames=32768,
                 max_errors=10 ** 9, min_frames=0, wave_size=32768,
                 early_exit_iters=5, survivor_budget=16384,
                 stage1_fused=True, seed=0, save_results=False)
NF_ERRORS = (0, 20)
# the K5/K6 path vs the engine route on the same LLRs (bf16): least shares
# of equal bits and of equal success flags. The two round at different
# points (K6 keeps f32 sums), so marginal frames go either way: 99.948% /
# 98.596% on the card; ldpc_tpu's own two routes on this decoder, 256
# frames on the CPU: 99.957% / 253 of 256 (tests/test_torch_qc_rowcol.py).
# Their frame errors must also pass a paired (McNemar) test: the frames
# only one route fails split evenly
RC_AGREE = (0.999, 0.98)
# phase 10: the general, layered and bucketed engines at the full width of
# PBRL (3096, 1032), the configuration of experiments/throughput_matrix.py
# (RCQ bc=3, bv=8, T=10, 1.2 dB, B=2048), each route on the card against
# the CPU (256 numpy frames), timed at B=2048 and 32768, the reference's
# ten comparison decoders, and the bucketed bf16 decoder through the
# simulator against the JAX package's FER (experiments/
# pbrl_fer_reference.py, same decoder, the JAX package's sim on the CPU)
PB_KW = dict(kind="rcq", bc=3, bv=8,
             quantizer_params=((2.0, 1.3), (4.0, 1.3), (6.0, 1.3)),
             v2c_quantizer_params=((4.0, 1.0), (8.0, 1.0), (12.0, 1.0)),
             max_iterations=10)
PB_T, PB_SNR, PB_B, PB_BIG, PB_CPU = 10, 1.2, 2048, 32768, 256
PB_ROUTES = {
    "general": (dict(), {}),
    "bucketed_f32": (dict(bucketed=True), {}),
    "bucketed_bf16": (dict(bucketed=True), {"dtype": torch.bfloat16}),
    "layered": (dict(layered=True), {}),
}
# At 1.2 dB this decoder leaves (almost) every frame unconverged after 5
# iterations (JAX: 2 of 65536 converged there), so the survivor budget is
# the whole wave: the wave is compacted, and stage 2 decodes every frame
PB_SIM = dict(snr_range=(PB_SNR, PB_SNR), snr_step=0.25, max_frames=65536,
              max_errors=10 ** 9, min_frames=0, wave_size=32768,
              early_exit_iters=5, survivor_budget=32768, seed=0,
              save_results=False)
# experiments/pbrl_fer_reference.py --frames 65536 (the JAX package's sim on
# XLA:CPU)
PB_REF_FER, PB_REF_FRAMES = 54307 / 65536, 65536
# phase 11: training at full width on the zoo's two operating recipes
# (zoo/<entry>/spec.json), with fresh weights from the port's generator.
# Flooding: experiments/accuracy_bc3.py:96-103's configuration, 8 steps.
# Layered: experiments/train_layered_short.py:85-90's, 4 steps; its
# decay_steps is the run the zoo entry came from (32 epochs x 2048 // 128
# batches = 512; the 4 steps taken here are inside the 8-step warmup)
TR_CFG = dict(batch_size=128, learning_rate=2e-3, snr_range=(5.5, 7.5),
              early_stop_accuracy=2.0, seed=0)
TR_LAYERED_CFG = dict(TR_CFG, lr_schedule="cosine", warmup_steps=8,
                      decay_steps=512)
TR_STEPS, TR_LAYERED_STEPS, TR_CPU_B = 8, 4, 16
TR_ANALYZE = dict(num_samples=32, snr_db=6.5)
# card vs CPU, one step: the loss (a mean) and the accuracy to a few
# roundings, the gradient norm to the gradients' tolerance (the backward
# of a gather adds with atomics on the card), the Adam-updated weights
# to 1e-6; the analyzer's vmap norms against single frames likewise
TR_TOL = dict(loss=2e-5, acc=1e-6, gnorm=1e-4, weights=1e-6, norms=1e-4)
# phase 12: the design tools, the encoder and the error floor at full
# width. (a) experiments/dde_ladders.py:52-66's designer call on the bench
# profile, and the layered T=6 decoder on the designed ladder; the JAX
# package's results on the CPU (experiments/design_reference.py):
DESIGN_CALL = dict(bc=3, bv=8, max_iterations=10, snr_db=6.3, phases=3)
DESIGN_QP = ((2.4067, 1.3), (3.0869, 1.3), (4.3991, 1.3))
DESIGN_VQP = ((40.9447, 1.0), (5.5726, 1.0), (83.1553, 1.0))
DESIGN_THRESHOLD = 6.1359375
DESIGN_TRAJECTORY = (0.008283842221786703, 0.0015349381231453455,
                     2.202010972286454e-06, 4.379827513906225e-09,
                     1.3914436965524548e-13, 1.176746931498284e-13)
# (b) encoded frames through the bench decoder (no early exit: at 6.25 dB
# S=128 would overflow), against all-zero frames (bench.py:11: FER ~0.06)
ENC_B, ENC_SNR, ENC_K = 32768, 6.25, 8196
# (c) experiments/floor_is.py's two arms at 3.6 dB: its decoder, its
# trapping-set search and class choice, its IS settings; the JAX results
# are experiments/floor_is_results.json
FLOOR_KW = dict(kind="rcq", bc=4, bv=8,
                quantizer_params=((6.0, 1.3), (11.0, 1.3), (16.0, 1.3)),
                v2c_quantizer_params=((4.0, 1.0), (8.0, 1.0), (12.0, 1.0)),
                max_iterations=10, layered=True)
FLOOR_SNR, FLOOR_SHIFT, FLOOR_SAMPLES, FLOOR_BATCH = 3.6, 1.6, 2 ** 15, 2 ** 11
FLOOR_EXEMPLARS, FLOOR_CLASSES, FLOOR_SEED = 3, 4, 20260818
# phase 13: the mesh paths. (a) phase 9's wave without early exit through
# the zoo's fused decoder (K4), and phase 9's compaction; (b) two gloo
# ranks on the card: a K4 wave of 2x4096 frames at 6.5 dB, the bench
# program at B=2x16384 with S=128 a rank (phase 4 keeps < 128 survivors in
# 32768 frames at 7.0 dB), two steps of the flooding recipe
P13_WAVE = dict(NF_CONFIG, early_exit_iters=None, survivor_budget=None,
                stage1_fused=False)
P13_GLOO_WAVE, P13_GLOO_B, P13_SEED = 2 * 4096, 2 * 16384, 13
P13_STEP_RTOL = 1e-5
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


def kernel_on(x, dec, T_, lean, flooding=False):
    """The fused decode's wrapper (the CUDA kernel for a CUDA tensor)."""
    import ldpc_tpu_torch as lt
    fn = (lt.qc_fused_decode_batch if flooding
          else lt.qc_fused_decode_batch_layered)
    return fn(x, dec.weights, qc=dec.qc, spec=dec.spec, max_iterations=T_,
              dtype=x.dtype, lean=lean)


def plain_on(x, dec, T_, lean, flooding=False):
    """The plain PyTorch version of the fused decode on ``x``'s device."""
    from ldpc_tpu_torch.decode import fused
    fn = (fused._fused_flooding_plain if flooding
          else fused._fused_layered_plain)
    return fn(x, dec.weights, qc=dec.qc, spec=dec.spec, max_iterations=T_,
              dtype=x.dtype, lean=lean)


def compare(name, dec, llr, dtype, lean, flooding=False):
    """Kernel vs plain on the card; returns the max abs posterior diff."""
    x = llr.to(dtype)
    out = kernel_on(x, dec, dec.max_iterations, lean, flooding)
    ref = plain_on(x, dec, dec.max_iterations, lean, flooding)
    return agree(name, out, ref, dtype, lean)


def same_bits(name, got, want):
    """Hold ``got`` to ``want`` bit for bit: the same dtype and shape, NaN
    exactly where ``want`` is NaN, and the other values equal as int32
    (f32) or int16 (bf16) bit patterns. Returns the max abs diff of the
    values that are not NaN, measured before the check."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    nan = torch.isnan(want)
    ok = torch.isnan(got) & nan
    diff = (got.float() - want.float()).abs().masked_fill(ok, 0.0)
    err = diff.max().item() if diff.numel() else 0.0
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[
        want.dtype]
    if not (torch.equal(torch.isnan(got), nan) and
            torch.equal(got[~nan].view(ints), want[~nan].view(ints))):
        raise AssertionError(f"{name}: not bit for bit, max |d| {err:g}")
    return err


def agree(name, out, ref, dtype, lean=False):
    """Hold a decode's result to its reference bit for bit: iterations,
    bits and success equal, and the posterior (full) by
    :func:`same_bits`. Returns the max abs posterior diff (0 when
    lean)."""
    torch.cuda.synchronize()
    if not (out.bits.dtype == ref.bits.dtype and
            torch.equal(out.iterations, ref.iterations) and
            torch.equal(out.bits, ref.bits) and
            torch.equal(out.success, ref.success)):
        raise AssertionError(f"{name} {dtype}: iterations, bits or success "
                             f"differ")
    err = 0.0 if lean else same_bits(name, out.posterior, ref.posterior)
    print(f"  {name:16s} {str(dtype)[6:]:8s} {'lean' if lean else 'full'}"
          f"  B={out.bits.shape[0]}  bit for bit, max|dpost| "
          f"{'(no posterior)' if lean else f'{err:g}'}  success "
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


def qdq_ops(mode, levels):
    """float32 operations of one quantize-dequantize call, counting only
    what depends on the value: the quantizer's constants of an iteration
    (M / C, C / M, 1 / gamma, the staircase's steps, the power law's
    levels) are computed once per iteration, not per edge, and are not
    counted. A transcendental counts as one.

    - staircase: |x|, (levels-1) x (compare, select, add), the floor's
      compare and select, the sign's compare and select;
    - uniform: 17, the count of common.cuh's uniform qdq (19) less its
      two divisions M / C and C / M, which depend only on the iteration;
    - power: 16, the uniform count with the division mag / C and one powf
      added (+2) and its three multiplies idx * step replaced by reads of
      the iteration's levels C * (i / M)^gamma (-3)."""
    return {"staircase": 5 + 3 * (levels - 1), "uniform": 17,
            "power": 16}[mode]


def edge_ops(spec, flooding):
    """float32 operations of the layered (K1) or flooding (K4) decode
    function per iteration: (per edge, per c2v computed). A transcendental
    counts as one, per-iteration constants are not counted
    (:func:`qdq_ops`). The c2v transform, CN quantizer and rounding are
    counted once per c2v the function must compute (:func:`c2v_computed`):
    a check of a row whose blocks share (beta, alpha) sends at most four
    distinct values. What a kernel's design adds (K4's second c2v from its
    compressed state, the TPU layered kernel's second v2c per edge for
    its sign) is not counted."""
    from ldpc_tpu_torch.decode.engine import qdq_mode

    def q_ops(qparams, levels):
        return qdq_ops(qdq_mode(qparams, levels, spec.closed_qdq), levels)

    quantized = spec.kind in ("rcq", "wrcq", "orcq")
    transform = {"nms": 2, "oms": 3, "rcq": 1, "wrcq": 2, "orcq": 3}[
        spec.kind] + int(spec.alpha_in_cn)
    cn_q = q_ops(spec.qparams, spec.q_levels) if quantized else 0
    with_v = (spec.v2c_qparams is not None or
              spec.v2c_thresholds is not None)
    v_q = q_ops(spec.v2c_qparams, spec.v2c_levels) if with_v else 0
    min_tree, leave_one_out = 8, 5  # |x|, compares, selects, count; sign
    send = transform + cn_q + 1
    if flooding:
        # CN: min tree, leave-one-out; VN: column sum, extrinsic and v2c
        # (each with its rounding), bv qdq, round
        return min_tree + leave_one_out + 2 + 2 + 2 + v_q + 1, send
    # layered pass 1: extrinsic, v2c, min tree; pass 2: leave-one-out,
    # column sum
    return 2 + 2 + min_tree + leave_one_out + 2, send


def c2v_computed(dec, T_, rows=None):
    """c2v values per lifted check the decode function must compute,
    summed over iterations 0..T_-1 and the base rows (all, or ``rows``):
    min(4, dc) on a row whose blocks share (beta, alpha) at the iteration
    bit for bit (c2v(+-1, min1 or min2)), dc on any other."""
    from ldpc_tpu_torch.decode import engine
    qc = dec.qc
    tabs = engine._tables(dec.weights, dec.spec, dec.max_iterations,
                          qc.num_blocks, dec.device)
    beta, alpha = tabs["beta"].cpu(), tabs["alpha"].cpu()
    total = 0
    for t in range(T_):
        for i in (range(qc.mb) if rows is None else rows):
            idx = [int(b) for b in qc.row_blocks[i]]
            shared = all(len(torch.unique(w[t, idx].view(torch.int32))) == 1
                         for w in (beta, alpha))
            total += min(4, len(idx)) if shared else len(idx)
    return total


def bound(dec, B, T_, flooding, lean=True, elt=2):
    """(bound_ms, bound_by) of one fused decode of B frames, T_ iterations:
    LLRs in and bits (lean) or posterior out once, success flags out."""
    n, L = dec.code.n, dec.qc.lift
    E = dec.qc.num_blocks * L
    nbytes = B * n * (elt + (1 if lean else elt)) + B
    per_edge, send = edge_ops(dec.spec, flooding)
    ops = B * (E * T_ * per_edge + L * c2v_computed(dec, T_) * send)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def rowcol_ops(spec):
    """float32 operations of the functions csrc/qc_cn.cu (K5) and
    csrc/qc_vn.cu (K6) compute, with their quantizer routing (staircase up
    to 16 levels, power law above) and :func:`qdq_ops`'s counts: K5 per
    edge and per c2v computed (:func:`c2v_computed`), K6 per edge and per
    variable. A transcendental (powf) counts as one, though it costs tens
    of instructions, so K6's count is a lower bound; its bound is its
    bytes."""
    def q_ops(levels):
        return qdq_ops("staircase" if levels <= 16 else "power", levels)

    quantized = spec.kind in ("rcq", "wrcq", "orcq")
    transform = {"nms": 2, "oms": 3, "rcq": 1, "wrcq": 2, "orcq": 3}[
        spec.kind] + int(spec.alpha_in_cn)
    with_v = (spec.v2c_qparams is not None or
              spec.v2c_thresholds is not None)
    v_q = q_ops(spec.v2c_levels) if with_v else 0
    # K5: min tree, leave-one-out per edge; transform, qdq, round per c2v
    cn_send = transform + (q_ops(spec.q_levels) if quantized else 0) + 1
    # K6 per edge: column-sum add, extrinsic, v2c (alpha multiply unless
    # OMS), qdq, round; per variable: posterior add, qdq, round
    vn_edge = 1 + 1 + (1 if spec.alpha_in_cn else 2) + v_q + 1
    return 8 + 5, cn_send, vn_edge, 1 + v_q + 1


def rowcol_bounds(dec, B, elt=2):
    """(bound_ms, bound_by) of one K5 launch on base row 0 and of one K6
    launch on base column 0 at iteration 0, at B frames of elt-byte
    storage: each input message read once and each output written once,
    and the operations of :func:`rowcol_ops`."""
    qc, L = dec.qc, dec.qc.lift
    dc, dv = len(qc.row_blocks[0]), len(qc.col_blocks[0])
    cn_edge, cn_send, vn_edge, vn_var = rowcol_ops(dec.spec)
    cn = cn_edge * dc + cn_send * c2v_computed(dec, 1, rows=[0])
    out = []
    for nbytes, ops in ((2 * dc * L * B * elt, cn * L * B),
                        ((2 * dv + 2) * L * B * elt,
                         (vn_edge * dv + vn_var) * L * B)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        out.append((1e3 * max(t_bytes, t_ops),
                    "bytes" if t_bytes > t_ops else "operations"))
    return out


class RowColState:
    """The inputs and outputs of single K5/K6 launches at iteration t: the
    channel LLRs as storage tiles, the first v2c state, and c2v after the
    plain K5 on every row (the input of K6)."""

    def __init__(self, dec, llr, dtype):
        from ldpc_tpu_torch.decode import engine, qc_engine, qc_rowcol
        self.dec, self.rc = dec, qc_rowcol
        qc = dec.qc
        self.llr_T = qc_engine._storage(llr, qc, dtype)
        self.tabs = engine._tables(dec.weights, dec.spec, dec.max_iterations,
                                   qc.num_blocks, llr.device)
        self.v2c = self.llr_T.index_select(
            0, qc_engine._graph_tables(qc, llr.device)["block_col"])
        self.c2v = torch.empty_like(self.v2c)
        for i in range(qc.mb):
            qc_rowcol._cn_row_plain(self.v2c, self.c2v, self.tabs, qc,
                                    dec.spec, i, 0)

    def cn(self, row, t, plain, out=None):
        """K5 (or its plain version) on ``row`` into ``out`` (new zeros by
        default)."""
        f = self.rc._cn_row_plain if plain else self.rc.cn_row
        out = torch.zeros_like(self.v2c) if out is None else out
        f(self.v2c, out, self.tabs, self.dec.qc, self.dec.spec, row, t)
        return out

    def vn(self, col, t, plain, out=None):
        """K6 (or its plain version) on ``col`` into ``out`` = (v2c, post)
        (new zeros by default)."""
        f = self.rc._vn_col_plain if plain else self.rc.vn_col
        v2c, post = ((torch.zeros_like(self.v2c), torch.zeros_like(self.llr_T))
                     if out is None else out)
        f(self.c2v, self.llr_T, v2c, post, self.tabs, self.dec.qc,
          self.dec.spec, col, t)
        return v2c, post


def close(name, got, want, dtype):
    """One launch's outputs against the plain version's, bit for bit
    (:func:`same_bits`). Returns the max abs diff."""
    torch.cuda.synchronize()
    if want.dtype != dtype:
        raise AssertionError(f"{name}: {want.dtype}, not {dtype}")
    return same_bits(name, got, want)


def rowcol_launches(name, dec, llr, dtype, rows, cols):
    """K5 on ``rows`` and K6 on ``cols`` at the first and last iteration,
    each against its plain version; returns the max abs diffs."""
    st = RowColState(dec, llr, dtype)
    qc, e5, e6 = dec.qc, 0.0, 0.0
    for t in (0, dec.max_iterations - 1):
        for i in rows:
            blocks = list(qc.row_blocks[i])
            e5 = max(e5, close(f"{name} K5 row {i}", st.cn(i, t, False)[blocks],
                               st.cn(i, t, True)[blocks], dtype))
        for j in cols:
            blocks = list(qc.col_blocks[j])
            (kv, kp), (pv, pp) = st.vn(j, t, False), st.vn(j, t, True)
            e6 = max(e6, close(f"{name} K6 col {j}", kv[blocks], pv[blocks],
                               dtype), close(f"{name} K6 post {j}", kp[j],
                                             pp[j], dtype))
    print(f"  {name:16s} {str(dtype)[6:]:8s} K5 rows {list(rows)}, K6 cols "
          f"{list(cols)}, t=0 and {dec.max_iterations - 1}: max|d| "
          f"{e5:g} / {e6:g}")
    return e5, e6


def phase7(code, qc, zdec, gen, dev, card):
    """K5 and K6 against their plain versions on the card, and timed."""
    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.decode import _build, fused, qc_rowcol

    print("[7 K5/K6 vs plain]")
    e5 = e6 = 0.0
    llr = lt.awgn_llr(gen, torch.zeros((256, code.n), device=dev), 2.5)
    for name, kw in SMALL_KINDS:
        sdec = lt.make_decoder(code, max_iterations=5, qc=qc, **kw)
        for dtype in (torch.float32, torch.bfloat16):
            a, b = rowcol_launches(name, sdec, llr, dtype, range(qc.mb),
                                   range(qc.nb))
            e5, e6 = max(e5, a), max(e6, b)
    zllr = lt.awgn_llr(gen, torch.zeros((256, zdec.code.n), device=dev),
                       RC_SNR)
    for dtype in (torch.float32, torch.bfloat16):
        a, b = rowcol_launches("zoo", zdec, zllr, dtype, [0], [0])
        e5, e6 = max(e5, a), max(e6, b)
    # the whole decode against its plain driver (the same plain K5/K6)
    for dtype in (torch.float32, torch.bfloat16):
        args = dict(qc=zdec.qc, spec=zdec.spec, max_iterations=RC_T,
                    check_every=1, dtype=dtype)
        agree("zoo decode", lt.qc_pallas_decode_batch(
            zllr, zdec.weights, **args), qc_rowcol._qc_pallas_plain(
            zllr, zdec.weights, **args), dtype)

    # one launch each at the main path's shapes: B=32768, bf16
    st = RowColState(zdec, lt.awgn_llr(
        gen, torch.zeros((RC_B, zdec.code.n), device=dev), RC_SNR),
        torch.bfloat16)
    bounds = rowcol_bounds(zdec, RC_B)
    o5 = torch.empty_like(st.v2c)
    o6 = (torch.empty_like(st.v2c), torch.empty_like(st.llr_T))
    times = {}
    for key, fn, bnd in (
            ("qc_cn", lambda plain: st.cn(0, 0, plain, o5), bounds[0]),
            ("qc_vn", lambda plain: st.vn(0, 0, plain, o6), bounds[1])):
        k_ms, p_ms = time_ms(lambda: fn(False), 20), time_ms(lambda: fn(True), 2)
        k2_ms, p2_ms = time_ms(lambda: fn(False), 20), time_ms(lambda: fn(True), 2)
        times[key] = (k_ms, p_ms, bnd[0], bnd[1])
        print(f"  time {key} B={RC_B} bf16 (one launch, zoo row/column 0): "
              f"kernel {k_ms:.4f} / {k2_ms:.4f} ms, plain {p_ms:.2f} / "
              f"{p2_ms:.2f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})  [{card}]")
    del st, o5, o6
    torch.cuda.empty_cache()
    lib = _build.load_library()
    qc0, spec = zdec.qc, zdec.spec
    print(kernel_facts("qc_cn", lib.ldpc_qc_cn_occupancy(
        len(qc0.row_blocks[0]), 1, fused._KINDS[spec.kind],
        spec.q_levels)) + f"  [{card}]")
    print(kernel_facts("qc_vn", lib.ldpc_qc_vn_occupancy(
        len(qc0.col_blocks[0]), zdec.spec.v2c_levels, 1)) + f"  [{card}]")
    return dict(qc_cn=times["qc_cn"] + (e5,), qc_vn=times["qc_vn"] + (e6,))


def ptxas_stats(log):
    """{kernel instance: {"registers": n, "spills": (stores, loads)}} from
    the build's ptxas report."""
    import re
    out, name = {}, None
    for line in (log.read_text().splitlines() if log.exists() else []):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.setdefault(name, {})["spills"] = (int(m.group(1)),
                                                 int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def kernel_facts(key, ctas):
    """One line on the bf16 instance of a kernel that the main path runs:
    its registers and spills (ptxas) and its resident CTAs per SM."""
    from ldpc_tpu_torch.decode import _build
    inst = {"fused_layered":
                "fused_layered_kernelI13__nv_bfloat16Li2ELi768ELb1E",
            "fused_flooding":
                "fused_flooding_kernelI13__nv_bfloat16Li4ELi768E",
            "qc_cn": "qc_cn_kernelI13__nv_bfloat16Li4ELb1E",
            "qc_vn": "qc_vn_kernelI13__nv_bfloat16Li5E"}[key]
    stats = ptxas_stats(_build.library_path().with_suffix(".log"))
    st = next((v for k, v in stats.items() if inst in k), {})
    what = {"qc_vn": ", dv=5", "fused_flooding": ", orcq, L <= 768",
            "fused_layered": ", rcq, L <= 768, state on chip",
            "qc_cn": ", orcq, dc <= 64"}.get(key, "")
    return (f"  {key} (bf16{what}): "
            f"{st.get('registers')} registers, spill stores/loads "
            f"{st.get('spills')} B, {ctas} resident CTAs per SM")


def k1_facts(dec, card):
    """K1's registers and spills (bf16 instance of the decoder's kind),
    shared memory per CTA and resident CTAs per SM at ``dec``'s shape, as
    the library lays it out."""
    from ldpc_tpu_torch.decode import _build, fused
    from ldpc_tpu_torch.decode.engine import qdq_mode
    qc, spec = dec.qc, dec.spec
    lib = _build.load_library()
    sizes = (qc.nb, qc.mb, qc.num_blocks, qc.lift,
             max(len(r) for r in qc.row_blocks), 1)
    modes = (fused._QMODES[qdq_mode(spec.qparams, spec.q_levels)],
             spec.q_levels,
             fused._QMODES[qdq_mode(spec.v2c_qparams, spec.v2c_levels)],
             spec.v2c_levels)
    ctas = lib.ldpc_fused_layered_occupancy(*sizes, fused._KINDS[spec.kind],
                                            *modes, 1)
    return (kernel_facts("fused_layered", ctas) +
            f", {lib.ldpc_fused_layered_smem(*sizes, *modes, 1)} B of "
            f"shared memory per CTA  [{card}]")


def reset_counts():
    from ldpc_tpu_torch.decode import fused, qc_rowcol
    fused.LAYERED_LAUNCHES = fused.FLOODING_LAUNCHES = 0
    qc_rowcol.CN_LAUNCHES = qc_rowcol.VN_LAUNCHES = 0


def read_counts():
    from ldpc_tpu_torch.decode import fused, qc_rowcol
    return dict(K1=fused.LAYERED_LAUNCHES, K4=fused.FLOODING_LAUNCHES,
                K5=qc_rowcol.CN_LAUNCHES, K6=qc_rowcol.VN_LAUNCHES)


def phase8(zdec, dev, card):
    """The zoo decoder at full width through K5/K6, and the same LLRs
    through the engine route."""
    import ldpc_tpu_torch as lt

    gen = torch.Generator(device=dev).manual_seed(8)
    llr = lt.awgn_llr(gen, torch.zeros((RC_B, zdec.code.n), device=dev),
                      RC_SNR)
    args = dict(qc=zdec.qc, spec=zdec.spec, max_iterations=RC_T,
                check_every=1, dtype=torch.bfloat16, batch_tile=128)
    # warm-up at full size (the allocator's blocks and the tables), then
    # two timed decodes: one host-clock sample varied by a third
    lt.qc_pallas_decode_batch(llr, zdec.weights, **args)
    torch.cuda.synchronize()
    times, runs = [], []
    for _ in range(2):
        reset_counts()
        t0 = time.perf_counter()
        out = lt.qc_pallas_decode_batch(llr, zdec.weights, **args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        runs.append(read_counts())
    counts = runs[-1]
    fe = int(out.bits.any(dim=1).sum())
    fer = fe / RC_B
    print(f"[8 row/column path] {ZOO_ENTRY} B={RC_B} bf16 T={RC_T} "
          f"check_every=1 at {RC_SNR} dB: {fe} frame errors, FER {fer:.6g}, "
          f"avg iterations {out.iterations.float().mean().item():.4f}, "
          f"launches {counts}")
    print(f"  K5/K6 route: {' / '.join(f'{1e3 * s:.1f}' for s in times)} "
          f"ms, {' / '.join(f'{RC_B / s:.1f}' for s in times)} "
          f"codewords/s  [{card}]")
    if any(c != dict(K1=0, K4=0, K5=RC_T * zdec.qc.mb, K6=RC_T * zdec.qc.nb)
           for c in runs):
        raise AssertionError(f"row/column path launches {runs}")
    lo, hi = FER_BANDS[RC_SNR]
    if not (lo < fer < hi and out.bits.shape == (RC_B, zdec.code.n)):
        raise AssertionError(f"FER {fer} off the JAX package's curve "
                             f"({lo}, {hi})")

    edec = lt.load_pretrained(ZOO_ENTRY, qc_options=dict(
        dtype=torch.bfloat16))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eout = edec(llr)
    torch.cuda.synchronize()
    esecs = time.perf_counter() - t0
    if read_counts() != counts:
        raise AssertionError("the engine route launched a kernel")
    bits = (eout.bits == out.bits).float().mean().item()
    frames = (eout.success == out.success).float().mean().item()
    err_rc, err_en = out.bits.any(dim=1), eout.bits.any(dim=1)
    only_rc = int((err_rc & ~err_en).sum())
    only_en = int((err_en & ~err_rc).sum())
    print(f"  engine route: {1e3 * esecs:.1f} ms, {RC_B / esecs:.1f} "
          f"codewords/s  [{card}]; vs K5/K6: bits agree {bits:.6f}, success "
          f"agrees {frames:.6f}, engine FER {int(err_en.sum()) / RC_B:.6g}; "
          f"frame errors of one route only: K5/K6 {only_rc}, engine "
          f"{only_en}")
    if bits < RC_AGREE[0] or frames < RC_AGREE[1] or \
            abs(only_rc - only_en) > 4 * (only_rc + only_en) ** 0.5 + 1:
        raise AssertionError("the K5/K6 path and the engine route disagree")
    del eout

    # the first 64 frames against the plain path on the CPU
    cpu = lt.qc_pallas_decode_batch(llr[:64].cpu(), zdec.weights,
                                    **dict(args, batch_tile=64))
    agree_cpu = (out.bits[:64].cpu() == cpu.bits).float().mean().item()
    if agree_cpu < 0.9999 or not torch.equal(out.success[:64].cpu(),
                                             cpu.success):
        raise AssertionError(f"K5/K6 path vs plain on the CPU: bits "
                             f"{agree_cpu}")
    print(f"  first 64 frames vs the CPU plain path: bits agree "
          f"{agree_cpu:.6f}, success equal")
    return counts


def phase9(dev, card):
    """One compacting wave of the non-fused zoo decoder, stage 1 on K4."""
    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.sim import point_generator

    dec = lt.load_pretrained(ZOO_ENTRY, qc_options=dict(
        dtype=torch.bfloat16, check_every=5))
    cfg = lt.SimulationConfig(**NF_CONFIG)
    sim = lt.LDPCSimulator(cfg)
    reset_counts()
    t0 = time.perf_counter()
    res = sim.simulate_decoder(dec, ZOO_ENTRY, verbose=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, kinds = read_counts(), sim.wave_kinds[ZOO_ENTRY]
    # the wave's survivors after stage 1 (an extra K4 launch, not counted)
    t1 = cfg.early_exit_iters
    short = dataclasses.replace(dec.truncated(t1), qc_options=dict(
        fused=True, dtype=torch.bfloat16))
    llr = lt.awgn_llr(point_generator(cfg.seed, 0, dev),
                      torch.zeros((cfg.wave_size, dec.code.n), device=dev),
                      torch.tensor(6.5, device=dev))
    surv = int((~short(llr).success).sum())
    errors = res.total_errors[0]
    print(f"[9 non-fused compaction] {ZOO_ENTRY} check_every=5, "
          f"early_exit_iters={t1}, stage1_fused, budget "
          f"{cfg.survivor_budget}: {res.total_frames[0]} frames at 6.5 dB, "
          f"survivors {surv}, {errors} frame errors, FER "
          f"{res.frame_error_rates[0]:.6g}, avg iterations "
          f"{res.average_iterations[0]:.4f}, waves {kinds[0]}, launches "
          f"{counts}, {res.total_frames[0] / secs:.1f} codewords/s  [{card}]")
    if kinds != [{"compacted": 1}] or counts != dict(K1=0, K4=1, K5=0,
                                                     K6=0):
        raise AssertionError("the wave was not compacted with stage 1 on K4")
    if not NF_ERRORS[0] <= errors <= NF_ERRORS[1]:
        raise AssertionError(f"{errors} frame errors at 6.5 dB")


def pbrl_decoder(code, dev, route, **opts):
    """Phase 10's decoder on ``route`` (``PB_ROUTES``), extra qc_options
    ``opts``."""
    import ldpc_tpu_torch as lt
    args, base_opts = PB_ROUTES[route]
    return lt.make_decoder(code, device=dev, qc_options={**base_opts, **opts}
                           or None, **PB_KW, **args)


def numpy_llr(B, n, snr_db, seed):
    """BPSK all-zero codewords over AWGN as float32 LLRs made with numpy
    (the CPU tests' channel_llr)."""
    rng = np.random.default_rng(seed)
    sigma2 = 10.0 ** (-snr_db / 10.0)
    r = 1.0 + np.sqrt(sigma2) * rng.standard_normal((B, n))
    return torch.from_numpy((2.0 * r / sigma2).astype(np.float32))


def cuda_launches(fn, cpu=True):
    """CUDA kernels launched by one call of ``fn``, from torch.profiler, or
    None where the profiler sees no device activity. ``cpu=False`` traces
    the device alone (fewer events for a call of ~10^5 launches)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU] * cpu +
                 [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and
               not e.name.startswith(("Memcpy", "Memset"))]
    return len(kernels) or None


def hard_equal(name, out, ref, frames=None):
    """Bits, success and iterations of ``out`` (its first ``frames``)
    equal ``ref``'s."""
    for k in ("bits", "success", "iterations"):
        if not torch.equal(getattr(out, k)[:frames].cpu(),
                           getattr(ref, k).cpu()):
            raise AssertionError(f"{name}: {k} differ")


def phase10(dev, card):
    """The general, layered and bucketed engines on PBRL (3096, 1032)."""
    import ldpc_tpu_torch as lt

    t_phase = time.perf_counter()
    reset_counts()
    code = lt.create_pbrl_like_code(k=1032, rate=1 / 3,
                                    max_iterations=PB_T)
    g = lt.build_graph(code)
    print(f"[10 general/bucketed engines] PBRL ({code.n}, {code.k}): m="
          f"{g.m}, E={g.num_edges}, check degrees {g.unique_dc[0]}-"
          f"{g.unique_dc[-1]}, variable degrees {g.unique_dv[0]}-"
          f"{g.unique_dv[-1]}; RCQ bc=3 bv=8, T={PB_T}, {PB_SNR} dB")
    decs = {r: pbrl_decoder(code, dev, r) for r in PB_ROUTES}

    # each route on the card against the same route on the CPU
    x = numpy_llr(PB_CPU, code.n, PB_SNR, seed=10)
    for r, d in decs.items():
        out, ref = d(x.to(dev)), d(x)
        hard_equal(r, out, ref)
        err = same_bits(f"{r} posterior", out.posterior.cpu(), ref.posterior)
        print(f"  card vs CPU {r:14s} B={PB_CPU}: bits, success, iterations "
              f"equal, posterior bit for bit (max|d| {err:g}), success "
              f"{ref.success.float().mean().item():.4f}")

    # general against bucketed (f32), bf16 against f32 (bucketed)
    gen = torch.Generator(device=dev).manual_seed(10)
    llr = lt.awgn_llr(gen, torch.zeros((PB_B, code.n), device=dev), PB_SNR)
    outs = {r: d(llr) for r, d in decs.items()}
    gen_, b32, b16 = (outs[k] for k in ("general", "bucketed_f32",
                                        "bucketed_bf16"))
    hard_equal("general vs bucketed", gen_, b32)
    agree = (b16.bits == b32.bits).float().mean().item()
    d_ok = abs(int(b16.success.sum()) - int(b32.success.sum()))
    print(f"  B={PB_B} on the card: general == bucketed f32 (bits, success, "
          f"iterations); bucketed bf16 vs f32: bits agree {agree:.6f}, "
          f"successes {int(b16.success.sum())} vs {int(b32.success.sum())}; "
          f"layered success {outs['layered'].success.float().mean():.4f}")
    if agree < 0.99 or d_ok > 0.005 * PB_B:
        raise AssertionError("bucketed bf16 strays from f32")
    del outs, gen_, b32, b16

    # times at B=2048 and B=32768 (CUDA events, after a warm-up), and the
    # kernels one decode launches
    big = lt.awgn_llr(gen, torch.zeros((PB_BIG, code.n), device=dev), PB_SNR)
    for r, d in decs.items():
        line = []
        for B_, x_ in ((PB_B, llr), (PB_BIG, big)):
            ms = time_ms(lambda: d(x_), 3 if B_ == PB_B else 2)
            line.append(f"B={B_} {ms:.2f} ms, {B_ / ms * 1e3:.1f} cw/s")
        n_k = cuda_launches(lambda: d(llr))
        print(f"  time {r:14s}: {'; '.join(line)}; "
              f"{n_k if n_k else 'not measured'} CUDA kernel launches per "
              f"decode (torch.profiler)  [{card}]")
    del big
    torch.cuda.empty_cache()

    # the reference's comparison set: each decoder on the card, its first
    # 64 frames against the CPU
    for name, d in lt.create_test_decoders(code, max_iterations=PB_T,
                                           device=dev).items():
        out = d(llr)
        ref = d(llr[:64].cpu())
        hard_equal(name, out, ref, 64)
        diff = (out.posterior[:64].cpu() - ref.posterior).abs()
        print(f"  {name:14s} B={PB_B}: FER {out.bits.any(1).float().mean():.4f}"
              f", first 64 frames = CPU (posterior max|d| "
              f"{diff.max().item():g})")

    # the FER of the bucketed bf16 decoder through the simulator
    dec = pbrl_decoder(code, dev, "bucketed_bf16", check_every=5)
    sim = lt.LDPCSimulator(lt.SimulationConfig(**PB_SIM))
    t0 = time.perf_counter()
    res = sim.simulate_decoder(dec, "pbrl_bucketed_bf16", verbose=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    kinds = sim.wave_kinds["pbrl_bucketed_bf16"][0]
    fer, frames = res.frame_error_rates[0], res.total_frames[0]
    p, n_ref = PB_REF_FER, PB_REF_FRAMES
    half = 4.0 * (p * (1 - p) * (1 / frames + 1 / n_ref)) ** 0.5
    print(f"  simulator {PB_SNR} dB, bucketed bf16, check_every=5, "
          f"early_exit_iters=5: {frames} frames, {res.total_errors[0]} "
          f"frame errors, FER {fer:.6g} (JAX {p:.6g} of {n_ref}; band "
          f"{p - half:.6g}-{p + half:.6g}), waves {kinds}, "
          f"{frames / secs:.1f} codewords/s  [{card}]")
    if not kinds.get("compacted"):
        raise AssertionError(f"no compacted wave: {kinds}")
    if abs(fer - p) > half:
        raise AssertionError(f"FER {fer} off the JAX package's {p}")
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"phase 10 launched a fused or row/column "
                             f"kernel: {counts}")
    print(f"  K1/K4/K5/K6 launches in phase 10: {counts}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")


def recipe_decoder(entry, dev):
    """The zoo entry's decoder rebuilt from its recipe on ``dev``, with
    the port's initial weights (not the entry's trained ones)."""
    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.codes import load_protograph
    from ldpc_tpu_torch.zoo import DEFAULT_ZOO_DIR
    path = os.path.join(DEFAULT_ZOO_DIR, entry)
    with open(os.path.join(path, "spec.json")) as f:
        recipe = dict(json.load(f)["recipe"])
    for k in ("quantizer_params", "v2c_quantizer_params"):
        recipe[k] = [tuple(q) for q in recipe[k]]
    base, lift = load_protograph(os.path.join(path, "protograph.txt"))
    code = lt.create_qc_code(base, lift=lift,
                             max_iterations=recipe["max_iterations"])
    return lt.make_decoder(code, qc=lt.build_qc_graph(base, lift),
                           device=dev, **recipe)


def timed_epoch(trainer, steps):
    """One ``train_epoch`` of ``steps`` batches with each step timed by
    CUDA events (sampling excluded) and its peak memory read. Returns per
    step (loss, accuracy, gradient norm, ms, peak bytes) and the weights
    after the first step."""
    rec, first = [], {}
    step = trainer.train_step

    def timed(llr, targets):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(llr, targets)
        end.record()
        torch.cuda.synchronize()
        rec.append(tuple(float(v) for v in out) + (
            start.elapsed_time(end), torch.cuda.max_memory_allocated()))
        if len(rec) == 1:
            first.update({k: v.clone() for k, v in
                          trainer.decoder.weights.items()})
        return out

    trainer.train_step = timed
    try:
        trainer.train_epoch(None, steps)
    finally:
        del trainer.train_step
    return rec, first


def step_line(name, rec, launches, card):
    losses = ", ".join(f"{r[0]:.6g}" for r in rec)
    ms = [r[3] for r in rec[1:]]  # after the first (warm-up) step
    return (f"  {name}: losses per step [{losses}]; accuracy "
            f"{rec[-1][1]:.6f}, |grad| {rec[-1][2]:.4g}; step time "
            f"{min(ms):.1f} / {np.median(ms):.1f} / {max(ms):.1f} ms (min / "
            f"median / max of steps 2-{len(rec)}), peak memory "
            f"{max(r[4] for r in rec) / 2 ** 30:.3f} GiB, "
            f"{launches if launches else 'not measured'} CUDA launches per "
            f"step (torch.profiler)  [{card}]")


def phase11(dev, card):
    """Training at full width: both recipes, card = CPU, the analyzer, and
    the trained weights through K4 and K1."""
    import ldpc_tpu_torch as lt

    t_phase = time.perf_counter()
    reset_counts()
    out = {}
    decs = {}
    for name, entry, cfg, steps in (
            ("flooding", ZOO_ENTRY, TR_CFG, TR_STEPS),
            ("layered", ZOO_LAYERED, TR_LAYERED_CFG, TR_LAYERED_STEPS)):
        dec = recipe_decoder(entry, dev)
        w0 = {k: v.clone() for k, v in dec.weights.items()}
        tr = lt.PosteriorJointTrainer(dec, lt.TrainingConfig(**cfg))
        t0 = time.perf_counter()
        rec, first = timed_epoch(tr, steps)
        t1 = time.perf_counter()
        batch = tr.sample()
        launches = cuda_launches(lambda: tr.train_step(*batch), cpu=False)
        t2 = time.perf_counter()
        if name == "layered" and not all(torch.equal(first[k], w0[k])
                                         for k in w0):
            raise AssertionError("the warmup's first update moved weights")
        if not all(np.isfinite(r[:3]).all() for r in rec) or not all(
                torch.isfinite(w).all() for w in dec.weights.values()):
            raise AssertionError(f"{name}: a loss, norm or weight is not "
                                 "finite")
        print(("[11 training] " if name == "flooding" else "") +
              f"{entry} ({dec.code.n}, {dec.code.k}) {name} T="
              f"{dec.max_iterations}, B={cfg['batch_size']}, {steps} steps "
              f"(one train_epoch), {lt.param_count(dec.weights)} weights, "
              f"config {cfg}" + ("; weights after step 1 equal the initial "
                                 "ones (learning rate 0)"
                                 if name == "layered" else ""))
        print(step_line(name, rec, launches, card) + f"; epoch {t1 - t0:.1f}"
              f" s, the profiled step {t2 - t1:.1f} s")
        decs[name], out[name] = dec, (rec, launches)

    # card = CPU: one numpy batch, two steps of the flooding recipe
    fresh = recipe_decoder(ZOO_ENTRY, dev)
    pair = [lt.PosteriorJointTrainer(d, lt.TrainingConfig(**TR_CFG)) for d in
            (fresh, fresh.to("cpu"))]
    x = numpy_llr(TR_CPU_B, fresh.code.n, 6.5, seed=11)
    worst = dict(loss=0.0, acc=0.0, gnorm=0.0, weights=0.0)
    t0 = time.perf_counter()
    for i in range(2):
        (lg, ag, gg), (lc, ac, gc) = [
            tuple(float(v) for v in tr.train_step(x.to(tr.device),
                                                  torch.zeros_like(x).to(
                                                      tr.device)))
            for tr in pair]
        for key, a, b in (("loss", lg, lc), ("acc", ag, ac),
                          ("gnorm", gg, gc)):
            worst[key] = max(worst[key], abs(a - b) / abs(b))
        worst["weights"] = max(worst["weights"], max(
            (w.cpu() - pair[1].decoder.weights[k]).abs().max().item()
            for k, w in pair[0].decoder.weights.items()))
    print(f"  card vs CPU, {ZOO_ENTRY} recipe, B={TR_CPU_B} numpy batch, 2 "
          f"steps: relative |d| loss {worst['loss']:.3g}, accuracy "
          f"{worst['acc']:.3g}, gradient norm {worst['gnorm']:.3g}; weights "
          f"max |d| {worst['weights']:.3g} (tolerances {TR_TOL}); "
          f"{time.perf_counter() - t0:.1f} s")
    if any(worst[k] > TR_TOL[k] for k in worst):
        raise AssertionError(f"card and CPU steps disagree: {worst}")
    del pair, fresh

    # the gradient analyzer through torch.func.vmap, on the trained flooding
    # decoder; four norms recomputed one frame at a time
    an = lt.GradientExplosionAnalyzer(decs["flooding"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = an.analyze(**TR_ANALYZE)
    torch.cuda.synchronize()
    a_secs = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(0)  # analyze()'s draw
    llr = lt.awgn_llr(gen, torch.zeros((TR_ANALYZE["num_samples"],
                                        decs["flooding"].code.n),
                                       device=dev), TR_ANALYZE["snr_db"])
    joint = np.asarray(res["posterior_joint"]["norms"])
    final = np.asarray(res["final_only"]["norms"])
    single = []
    t0 = time.perf_counter()
    for i in range(4):
        w = {k: v.clone().requires_grad_(True)
             for k, v in decs["flooding"].weights.items()}
        loss, _ = lt.posterior_joint_loss(
            w, llr[i:i + 1], torch.zeros_like(llr[i:i + 1]),
            decoder=decs["flooding"], joint=True)
        gs = torch.autograd.grad(loss, list(w.values()))
        single.append(float(torch.sqrt(sum((g ** 2).sum() for g in gs))))
    rel = np.abs(joint[:4] - single) / np.abs(single)
    print(f"  analyzer (vmap) {TR_ANALYZE}: {a_secs:.2f} s (joint and "
          f"final-only); joint mean {res['posterior_joint']['mean']:.4g}, "
          f"max {res['posterior_joint']['max']:.4g}; final-only mean "
          f"{res['final_only']['mean']:.4g}, max "
          f"{res['final_only']['max']:.4g}; frames 0-3 one at a time "
          f"({time.perf_counter() - t0:.1f} s): relative |d| "
          f"{rel.max():.3g}  [{card}]")
    if not (np.isfinite(joint).all() and np.isfinite(final).all()
            and len(joint) == TR_ANALYZE["num_samples"]
            and rel.max() <= TR_TOL["norms"]):
        raise AssertionError("analyzer norms are not finite or disagree "
                             "with single frames")
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"training launched a kernel: {counts}")
    print(f"  K1/K4/K5/K6 launches while training: {counts}")

    # the trained weights through the kernels: K4 and K1 vs their plain
    # versions on 256 frames at 6.5 dB (comparison launches, not counted)
    errs = {}
    t0 = time.perf_counter()
    for name, flooding in (("flooding", True), ("layered", False)):
        twin = dataclasses.replace(decs[name], qc_options=dict(
            fused=True, dtype=torch.bfloat16))
        x = lt.awgn_llr(gen, torch.zeros((256, twin.code.n), device=dev),
                        6.5)
        errs[name] = compare(f"trained {name}", twin, x, torch.bfloat16,
                             False, flooding=flooding)
    print(f"  K4 and K1 on the trained weights: "
          f"{time.perf_counter() - t0:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return out


def set_counts(counts):
    from ldpc_tpu_torch.decode import fused, qc_rowcol
    fused.LAYERED_LAUNCHES = counts["K1"]
    fused.FLOODING_LAUNCHES = counts["K4"]
    qc_rowcol.CN_LAUNCHES = counts["K5"]
    qc_rowcol.VN_LAUNCHES = counts["K6"]


def uncounted(fn):
    """``fn()`` with the launch counts as they were before it: a kernel
    held to its plain version is not the path's launch."""
    saved = read_counts()
    try:
        return fn()
    finally:
        set_counts(saved)


def bench_design(bench_base):
    """The designer on the bench profile: (CN ladder, V2C ladder, DE
    threshold, host seconds). Runs in a worker process."""
    from ldpc_tpu_torch.design import (degree_profile_from_base,
                                       design_rcq_ladders)
    t0 = time.perf_counter()
    qp, vqp, res = design_rcq_ladders(degree_profile_from_base(bench_base),
                                      **DESIGN_CALL)
    return qp, vqp, res.threshold_db, time.perf_counter() - t0


def phase12_design(dev, card, bench_base, design):
    """(a) The designer's result on the bench profile, the decoder on its
    ladder, its protograph DE, and one all-zero wave through K1."""
    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.design import analyze_decoder
    t0 = time.perf_counter()
    qp, vqp, thr, t_design = design.get()
    print(f"[12 design, encoder, error floor] (a) design_rcq_ladders "
          f"{DESIGN_CALL} on the bench profile: CN {qp}, V2C {vqp}, DE "
          f"threshold {thr!r} dB; {t_design:.1f} s on the host in a worker "
          f"process beside phases 1-11, waited "
          f"{time.perf_counter() - t0:.1f} s for it here")
    if (qp, vqp) != (DESIGN_QP, DESIGN_VQP) or \
            abs(thr - DESIGN_THRESHOLD) > 1e-9:
        raise AssertionError("the designed ladder differs from the JAX "
                             "package's")
    code = lt.create_qc_code(bench_base, lift=256, max_iterations=6)
    dec = lt.make_decoder(
        code, qc=lt.build_qc_graph(bench_base, 256), kind="rcq", bc=3, bv=8,
        quantizer_params=qp, v2c_quantizer_params=vqp, max_iterations=6,
        layered=True, qc_options=dict(fused=True, dtype=torch.bfloat16,
                                      lean=True), device=dev)
    t0 = time.perf_counter()
    traj = analyze_decoder(dec, snr_db=6.5).error_prob
    t_an = time.perf_counter() - t0
    # the DE is float64 pmf arithmetic (FFT convolutions) on probability
    # mass 1: another numpy build rounds it differently by ~1e-17, which
    # is a large relative difference on the ~1e-13 tail (numpy 2.3.5
    # against 2.0.2: 9.5e-5 relative, 1.1e-17 absolute), so each value is
    # held to rtol 1e-12 or to atol 1e-15
    ref = np.asarray(DESIGN_TRAJECTORY)
    diff = np.abs(traj - ref)
    print(f"  analyze_decoder (layered T=6, 6.5 dB): "
          f"{[float(e) for e in traj]}; vs the JAX package's: max relative "
          f"|d| {(diff / ref).max():.3g}, max |d| {diff.max():.3g} (numpy "
          f"{np.__version__}); {t_an:.2f} s")
    if not np.all((diff <= 1e-12 * ref) | (diff <= 1e-15)):
        raise AssertionError("the designed decoder's DE trajectory differs")
    gen = torch.Generator(device=dev).manual_seed(12)
    llr = lt.awgn_llr(gen, torch.zeros((ENC_B, code.n), device=dev), 6.5)
    out = dec(llr)
    fe = int(out.bits.any(dim=1).sum())
    if out.bits.shape != (ENC_B, code.n) or out.bits.dtype != torch.int8:
        raise AssertionError(f"bad output {out.bits.shape} {out.bits.dtype}")
    print(f"  the designed ladder through K1 (bf16, lean), B={ENC_B} at 6.5 "
          f"dB: {fe} frame errors, FER {fe / ENC_B:.6g}")
    return qp, vqp, thr


def phase12_encode(dev, card, bench_base):
    """(b) Encoded frames through the bench decoder against all-zero
    frames."""
    import ldpc_tpu_torch as lt
    code = lt.create_qc_code(bench_base, lift=256, max_iterations=T)
    dec = lt.make_decoder(code, qc=lt.build_qc_graph(bench_base, 256),
                          qc_options=dict(fused=True, dtype=torch.bfloat16,
                                          lean=True), device=dev, **BENCH_KW)
    t0 = time.perf_counter()
    enc = lt.make_encoder(code)
    t_make = time.perf_counter() - t0
    if enc.k_eff != ENC_K:
        raise AssertionError(f"k_eff {enc.k_eff}")
    gen = torch.Generator(device=dev).manual_seed(121)
    msgs = torch.randint(0, 2, (ENC_B, enc.k_eff), generator=gen,
                         device=dev, dtype=torch.int32)
    cw = enc(msgs)
    n_ok = int(enc.syndrome_ok(cw).sum())
    enc_ms = time_ms(lambda: enc(msgs), 3)
    syn_ms = time_ms(lambda: enc.syndrome_ok(cw), 3)
    same64 = torch.equal(cw[:64].cpu(), enc(msgs[:64].cpu()))
    print(f"  (b) make_encoder on the bench code: k_eff {enc.k_eff}, "
          f"{t_make:.2f} s on the host; encode B={ENC_B} {enc_ms:.3f} ms, "
          f"syndrome_ok {syn_ms:.3f} ms (CUDA events, float32 matmuls)  "
          f"[{card}]; {n_ok} of {ENC_B} codewords pass syndrome_ok; first 64 "
          f"equal the CPU encoder's: {same64}")
    if n_ok != ENC_B or not same64:
        raise AssertionError("encoded frames fail their parity checks or "
                             "differ from the CPU's")
    out = dec(lt.awgn_llr(gen, cw, ENC_SNR))
    wrong = (out.bits.to(torch.int32) != cw).any(dim=1)
    rec = out.bits[:, torch.from_numpy(enc.info_positions).to(dev)]
    good = ~wrong
    if not torch.equal(rec[good].to(torch.int32), msgs[good]):
        raise AssertionError("a decoded codeword gave another message")
    undetected = int((out.success & wrong).sum())
    out0 = dec(lt.awgn_llr(gen, torch.zeros_like(cw, dtype=torch.float32),
                           ENC_SNR))
    fe, fe0 = int(wrong.sum()), int(out0.bits.any(dim=1).sum())
    p = (fe + fe0) / (2 * ENC_B)
    half = 4.0 * (p * (1 - p) * 2 / ENC_B) ** 0.5
    print(f"  encoded frames at {ENC_SNR} dB through K1 (bench decoder, no "
          f"early exit): FER {fe / ENC_B:.6g} ({fe} frames), all-zero FER "
          f"{fe0 / ENC_B:.6g} ({fe0}); band +-{half:.6g}; messages recovered "
          f"on all {ENC_B - fe} correct frames; undetected errors "
          f"{undetected}")
    if abs(fe - fe0) / ENC_B > half:
        raise AssertionError("encoded frames decode unlike all-zero ones")


class CheckedDecoder:
    """The floor decoder, checking that every batch it decodes has its
    punctured LLRs at zero."""

    def __init__(self, dec, punct):
        self.dec, self.code, self.device = dec, dec.code, dec.device
        self.punct = (None if punct is None else
                      torch.as_tensor(punct, device=dec.device))
        self.batches = 0

    def __call__(self, llr):
        if self.punct is not None and bool((llr[:, self.punct] != 0).any()):
            raise AssertionError("a punctured LLR is not zero")
        self.batches += 1
        return self.dec(llr)


def floor_arm(dev, precode):
    """``experiments/floor_is.py``'s decoder, trapping-set search and class
    choice for one arm."""
    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.design import find_trapping_sets
    B, L, *pc = lt.create_pbrl_qc_protograph(k=1032, rate=1 / 3,
                                             precode=precode)
    punct = tuple(range(L * pc[0][0], L * (pc[0][0] + 1))) if precode \
        else None
    code = lt.create_qc_code(B, lift=L, max_iterations=10)
    dec = lt.make_decoder(code, qc=lt.build_qc_graph(B, L),
                          qc_options=dict(fused=True, dtype=torch.bfloat16),
                          device=dev, **FLOOR_KW)
    t0 = time.perf_counter()
    rep = find_trapping_sets(code.H, a_max=8, b_max=3, restarts=3,
                             max_sets=10000)
    t_ts = time.perf_counter() - t0
    chosen = {}
    for ts in rep.sets:
        chosen.setdefault((ts.a, ts.b), []).append(ts)
    cc = rep.class_counts()
    classes = sorted(chosen, key=lambda ab: (cc[ab]["absorbing"] == 0,
                                             ab[1], ab[0]))[:FLOOR_CLASSES]
    for ab in classes:
        absb = [t for t in chosen[ab] if t.absorbing]
        if absb:
            chosen[ab] = absb
    mult = {ab: cc[ab]["absorbing"] or cc[ab]["unique"] for ab in classes}
    return dec, punct, classes, chosen, mult, t_ts


def phase12_floor(dev, card):
    """(c) Both arms of the importance-sampled floor at 3.6 dB through K1;
    returns the random arm's decoder, an exemplar and the estimates."""
    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.sim import biased_awgn_llr, estimate_trapping_floor

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "experiments", "floor_is_results.json")) as f:
        ref = json.load(f)
    snr = str(FLOOR_SNR)
    estimates, keep, batches, k1_err = {}, None, 0, 0.0
    for arm_i, (arm, precode) in enumerate((("random", False),
                                            ("precoded", True))):
        dec, punct, classes, chosen, mult, t_ts = floor_arm(dev, precode)
        jref = ref[arm]["classes"][snr]
        print(f"  (c) {arm} arm: PBRL QC ({dec.code.n}, {dec.qc.lift}-lift "
              f"{dec.qc.mb}x{dec.qc.nb} base), RCQ bc=4 6-11-16, layered "
              f"T=10, K1 bf16; trapping sets {t_ts:.1f} s on the host; "
              f"classes {[(ab, mult[ab]) for ab in classes]}")
        if [f"{a},{b}" for a, b in classes] != list(jref) or any(
                mult[ab] != jref[f"{ab[0]},{ab[1]}"]["multiplicity"]
                for ab in classes):
            raise AssertionError(f"{arm}: classes or multiplicities differ "
                                 "from floor_is_results.json")
        # K1 on this decoder against its plain version first
        ts0 = chosen[classes[0]][0]
        x, _ = biased_awgn_llr(torch.Generator(device=dev).manual_seed(
            arm_i), 256, dec.code.n, FLOOR_SNR, ts0.variables, FLOOR_SHIFT,
            punctured=punct)
        errs = uncounted(lambda: [compare(f"floor {arm}", dec, x, dtype,
                                          False)
                                  for dtype in (torch.float32,
                                                torch.bfloat16)])
        k1_err = max([k1_err] + errs)
        if arm == "random":
            print(k1_facts(dec, card))
            # K1 against its plain version at an IS batch's shape (bf16)
            xb, _ = biased_awgn_llr(torch.Generator(device=dev).manual_seed(
                9), FLOOR_BATCH, dec.code.n, FLOOR_SNR, ts0.variables,
                FLOOR_SHIFT)
            xb = xb.to(torch.bfloat16)
            k_ms = uncounted(lambda: [time_ms(lambda: kernel_on(
                xb, dec, 10, False), 20) for _ in range(2)])
            p_ms = time_ms(lambda: plain_on(xb, dec, 10, False), 1)
            b_ms, b_by = bound(dec, FLOOR_BATCH, 10, flooding=False,
                               lean=False)
            print(f"  K1 on this decoder, B={FLOOR_BATCH} T=10 bf16: "
                  f"{k_ms[0]:.4f} / {k_ms[1]:.4f} ms, plain {p_ms:.2f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by})  [{card}]")
        checked = CheckedDecoder(dec, punct)
        t0 = time.perf_counter()
        floor = 0.0
        for ab in classes:
            ps = []
            for i, ts in enumerate(chosen[ab][:FLOOR_EXEMPLARS]):
                seed = int(np.random.SeedSequence(
                    [FLOOR_SEED, arm_i, ab[0], ab[1], i]).generate_state(
                        1, np.uint64)[0])
                est = estimate_trapping_floor(
                    checked, [(ab, 1, ts.variables)], snr_db=FLOOR_SNR,
                    shift=FLOOR_SHIFT, n_samples=FLOOR_SAMPLES,
                    batch=FLOOR_BATCH, seed=seed, punctured=punct)
                _, p, rel = est.per_class[ab]
                pj, relj = jref[f"{ab[0]},{ab[1]}"]["exemplars"][i]
                held = rel < 0.5 and relj < 0.5
                if held and abs(np.log(p / pj)) > 4 * np.hypot(rel, relj):
                    raise AssertionError(f"{arm} {ab} exemplar {i}: p {p:.3e}"
                                         f" (rel {rel:.2f}) vs the JAX "
                                         f"package's {pj:.3e} ({relj:.2f})")
                ps.append(p)
                print(f"    {ab} exemplar {i}: p {p:.4g} (rel_std {rel:.3g})"
                      f", JAX {pj:.4g} ({relj:.3g}) "
                      f"{'held' if held else 'printed only'}")
                estimates[f"{arm} {ab[0]},{ab[1]} {i}"] = (p, rel)
                if keep is None:
                    keep = (dec, ts, punct)
            floor += mult[ab] * float(np.mean(ps))
        secs = time.perf_counter() - t0
        batches += checked.batches
        punct_note = ("punctured LLRs zero in every batch" if punct else
                      "no puncturing")
        print(f"  {arm} arm at {FLOOR_SNR} dB: union-bound floor "
              f"{floor:.4g} (floor_is_results.json "
              f"{ref[arm]['floor'][snr]:.4g}); {checked.batches} IS batches "
              f"of {FLOOR_BATCH} ({punct_note}), {secs:.1f} s, "
              f"{checked.batches * FLOOR_BATCH / secs:.1f} frames/s  "
              f"[{card}]; K1 vs plain max|dpost| {max(errs):g}")
    return keep, estimates, batches, k1_err


def phase12(dev, card, design):
    """The design tools, the encoder, the importance-sampled floor, the
    reports and the profiling tools at full width; only K1 launches.
    Returns K1's launches in the phase and the largest posterior
    difference of K1 from its plain version on the floor decoders."""
    import tempfile

    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.report import analyze_weight_patterns
    from ldpc_tpu_torch.sim import biased_awgn_llr
    from ldpc_tpu_torch.utils import (ThroughputCounter, load_checkpoint,
                                      measure_throughput, save_checkpoint,
                                      trace)

    t_phase = time.perf_counter()
    reset_counts()
    bench_base = np.random.default_rng(0).integers(0, 256, size=(5, 37))
    qp, vqp, thr = phase12_design(dev, card, bench_base, design)
    phase12_encode(dev, card, bench_base)
    torch.cuda.empty_cache()
    (fdec, ts, _), estimates, batches, k1_err = phase12_floor(dev, card)
    expected = 3 + batches

    # (d) reports and tools
    zoo = analyze_weight_patterns(lt.load_pretrained(ZOO_ENTRY))
    if zoo != analyze_weight_patterns(lt.load_pretrained(ZOO_ENTRY,
                                                          device="cpu")):
        raise AssertionError("analyze_weight_patterns differs on the card")
    gen = torch.Generator(device=dev).manual_seed(122)

    def is_batch():
        llr, _ = biased_awgn_llr(gen, FLOOR_BATCH, fdec.code.n, FLOOR_SNR,
                                 ts.variables, FLOOR_SHIFT)
        return fdec(llr)

    rate = measure_throughput(is_batch, reps=8) * FLOOR_BATCH
    tc = ThroughputCounter()
    for _ in range(8):
        tc.start()
        is_batch()
        tc.stop(FLOOR_BATCH)
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        with trace(os.path.join(tmp, "trace")) as prof:
            is_batch()
        k1_events = sum(1 for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and "fused_layered" in e.name)
        trace_bytes = os.path.getsize(os.path.join(tmp, "trace",
                                                   "trace.json"))
        tree = {"cn": qp, "v2c": vqp, "threshold_db": thr,
                "estimates": {k: np.asarray(v) for k, v in estimates.items()}}
        back = load_checkpoint(save_checkpoint(os.path.join(tmp, "ck"), tree),
                               item=tree)
    expected += 1 + 8 + 8 + 1
    same = (back["cn"], back["v2c"], back["threshold_db"]) == (qp, vqp, thr) \
        and all(np.array_equal(back["estimates"][k], v)
                for k, v in tree["estimates"].items())
    print(f"  (d) analyze_weight_patterns({ZOO_ENTRY}) on the card = CPU: "
          f"mean beta by check degree {zoo['mean_weight_by_check_degree']}; "
          f"IS batches (B={FLOOR_BATCH}, T=10) measure_throughput "
          f"{rate:.1f} cw/s, ThroughputCounter {tc.codewords_per_sec:.1f} "
          f"cw/s  [{card}]; trace(): {trace_bytes} B Chrome trace, "
          f"{k1_events} K1 kernel events in one IS batch; checkpoint "
          f"round trip of the ladders and {len(estimates)} estimates: "
          f"{same}")
    if not same or k1_events != 1:
        raise AssertionError("checkpoint round trip or trace failed")
    counts = read_counts()
    print(f"  launches in phase 12: {counts} (K1 expected {expected}); "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    if counts != dict(K1=expected, K4=0, K5=0, K6=0):
        raise AssertionError("phase 12 launched another kernel, or K1 an "
                             "unexpected number of times")
    return counts["K1"], k1_err


def stats_of(out, n_surv):
    """The bench program's five stats of a two-checkpoint decode."""
    from ldpc_tpu_torch.sim.montecarlo import _counts
    return _counts(out.bits, out.iterations, out.success).tolist() + [
        int(n_surv)]


def de_data():
    """``generate_images``' DE curves and their host seconds. Runs in a
    worker process."""
    from ldpc_tpu_torch.cli.generate_images import de_curves
    t0 = time.perf_counter()
    return de_curves(), time.perf_counter() - t0


def same_results(name, got, want):
    """Two simulation results equal but for their wall-clock times."""
    a, b = (dict(r.to_dict(), simulation_times=None) for r in (got, want))
    if a != b:
        raise AssertionError(f"{name}: mesh {a} != single device {b}")


def phase13_nccl(dev, card, dec, wave_ms):
    """(a) A world of one over NCCL in this process: the bench program,
    the simulator's two mesh waves, a data-parallel step. Returns the
    launches of the mesh path."""
    import tempfile

    import torch.distributed as dist

    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.parallel import (Mesh, distributed_init, make_mesh,
                                         make_spmd_two_checkpoint_stats_fn)

    with tempfile.TemporaryDirectory() as tmp:
        distributed_init(f"file://{os.path.join(tmp, 'store')}", 1, 0,
                         backend="nccl" if dev.type == "cuda" else "gloo")
        try:
            mesh = make_mesh(devices=dev)
            print(f"[13 parallel, CLIs] (a) NCCL world of one: rank "
                  f"{mesh.rank} of {mesh.size} on {mesh.device}, backend "
                  f"{mesh.backend}")
            gen = torch.Generator(device=dev).manual_seed(0)  # phase 4's
            llr = lt.awgn_llr(gen, torch.zeros((B_MAIN, dec.code.n),
                                               device=dev), SNR_DB)
            two_ck = lt.make_two_checkpoint_decoder(dec, t1=T1,
                                                    survivor_budget=S)
            fn, alone = (make_spmd_two_checkpoint_stats_fn(
                dec, t1=T1, survivor_budget=S, mesh=m)
                for m in (mesh, Mesh(1, 0, dev)))
            reset_counts()
            pooled = fn(llr).tolist()
            bench = read_counts()
            single = uncounted(lambda: stats_of(*two_ck(llr)))
            # in turns: the NCCL mesh, the same program without a group
            # (its all_reduce is the identity), and the decode alone
            ms = uncounted(lambda: [time_ms(lambda: f(llr), 6) for f in (
                fn, alone, lambda x: two_ck(x), lambda x: two_ck(x), alone,
                fn)])
            print(f"  bench program B={B_MAIN} at {SNR_DB} dB: pooled "
                  f"(frame errors, bit errors, iterations, successes, "
                  f"survivors) {pooled} == single device {single}; K1 "
                  f"launches {bench['K1']} a call; ms a call (CUDA events, "
                  f"6 calls each, in turns): NCCL mesh {ms[0]:.3f} / "
                  f"{ms[5]:.3f}, without a group {ms[1]:.3f} / {ms[4]:.3f}, "
                  f"the two-checkpoint decode alone {ms[2]:.3f} / "
                  f"{ms[3]:.3f}; phase 4's wave {wave_ms:.3f} ms  [{card}]")
            if pooled != single or bench != dict(K1=2, K4=0, K5=0, K6=0):
                raise AssertionError("the bench program over the mesh")
            del llr

            zdec = lt.load_pretrained(ZOO_ENTRY, qc_options=dict(
                fused=True, dtype=torch.bfloat16, lean=True))
            nfdec = lt.load_pretrained(ZOO_ENTRY, qc_options=dict(
                dtype=torch.bfloat16, check_every=5))
            for name, d, cfg in (("plain SPMD wave (K4)", zdec, P13_WAVE),
                                 ("phase 9's compaction (stage 1 K4)", nfdec,
                                  NF_CONFIG)):
                c = lt.SimulationConfig(**cfg)
                t0 = time.perf_counter()
                res = lt.LDPCSimulator(c, mesh=mesh).simulate_decoder(
                    d, ZOO_ENTRY, verbose=False)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                want = uncounted(lambda: lt.LDPCSimulator(c).simulate_decoder(
                    d, ZOO_ENTRY, verbose=False))
                torch.cuda.synchronize()
                same_results(name, res, want)
                print(f"  LDPCSimulator(mesh=) {ZOO_ENTRY} {name}: "
                      f"{res.total_frames[0]} frames at 6.5 dB, "
                      f"{res.total_errors[0]} frame errors, BER "
                      f"{res.bit_error_rates[0]:.6g}, avg iterations "
                      f"{res.average_iterations[0]:.4f} == single device; "
                      f"{t1 - t0:.2f} s mesh, {time.perf_counter() - t1:.2f}"
                      f" s single  [{card}]")
            sim = read_counts()

            fresh = recipe_decoder(ZOO_ENTRY, dev)
            trs = [lt.PosteriorJointTrainer(dataclasses.replace(fresh),
                                            lt.TrainingConfig(**TR_CFG),
                                            mesh=m) for m in (None, mesh)]
            batch = trs[0].sample()
            secs = []
            for tr in trs:  # the first step also warms the allocator up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.train_step(*batch)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            same = all(torch.equal(w, trs[0].decoder.weights[k])
                       for k, w in trs[1].decoder.weights.items())
            print(f"  data-parallel step, {ZOO_ENTRY} recipe B="
                  f"{TR_CFG['batch_size']}: weights equal to the step "
                  f"without a mesh: {same}; {secs[0]:.2f} s without (the "
                  f"first, with the warm-up), {secs[1]:.2f} s mesh  [{card}]")
            counts = read_counts()
            if not same or counts != dict(K1=2, K4=2, K5=0, K6=0) or \
                    sim != counts:
                raise AssertionError(f"mesh path launches {counts}, the "
                                     "training step's weights")
            return counts
        finally:
            dist.destroy_process_group()


def phase13_gloo(dev, card, dec):
    """(b) Two gloo ranks sharing the card: a K4 wave, the bench program,
    two data-parallel steps, each against this process."""
    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.parallel import launch, spawn
    from ldpc_tpu_torch.sim.montecarlo import _Wave, point_generator

    zdec = lt.load_pretrained(ZOO_ENTRY, qc_options=dict(
        fused=True, dtype=torch.bfloat16, lean=True))
    fresh = recipe_decoder(ZOO_ENTRY, dev)
    xs = [numpy_llr(TR_CFG["batch_size"], fresh.code.n, 6.5,
                    seed=130 + i).numpy() for i in range(2)]
    batches = [(x, np.zeros_like(x)) for x in xs]
    calls = [(launch.wave, (zdec.to("cpu"), P13_GLOO_WAVE, 6.5, P13_SEED)),
             (launch.two_checkpoint_stats, (dec.to("cpu"), P13_GLOO_B, SNR_DB,
                                            P13_SEED, T1, S)),
             (launch.train_steps, (fresh.to("cpu"),
                                   lt.TrainingConfig(**TR_CFG), batches))]
    t0 = time.perf_counter()
    r0, r1 = spawn(launch.run_all, 2, "gloo", dev, calls)
    t_spawn = time.perf_counter() - t0

    per = P13_GLOO_WAVE // 2
    local = [uncounted(lambda: _Wave(zdec, per, dev)(
        point_generator(P13_SEED, 0, dev, r, 2), 6.5)) for r in range(2)]
    wave_sum = [a + b for a, b in zip(*local)]
    llr = launch.global_llr(P13_GLOO_B, dec.code.n, SNR_DB, P13_SEED, dev)
    single = uncounted(lambda: stats_of(*lt.make_two_checkpoint_decoder(
        dec, t1=T1, survivor_budget=P13_GLOO_B)(llr)))
    del llr
    tr = lt.PosteriorJointTrainer(dataclasses.replace(fresh),
                                  lt.TrainingConfig(**TR_CFG))
    for x, y in batches:
        tr.train_step(torch.as_tensor(x, device=dev),
                      torch.as_tensor(y, device=dev))
    rel = max(float(np.max(np.abs(w - tr.decoder.weights[k].cpu().numpy()) /
                           np.abs(tr.decoder.weights[k].cpu().numpy())))
              for k, w in r0[2]["weights"].items())
    print(f"  (b) two gloo ranks on one card, {t_spawn:.1f} s for the spawn "
          f"and its three jobs: K4 wave of 2x{per} frames at 6.5 dB pooled "
          f"{r0[0]} == the ranks' sum {wave_sum}; bench program "
          f"B=2x{P13_GLOO_B // 2}, S={S} a rank: pooled {r0[1]} == single "
          f"device {single}; two data-parallel steps: weights max relative "
          f"|d| {rel:.3g} from one process's (tolerance {P13_STEP_RTOL})  "
          f"[{card}]")
    if r0[:2] != r1[:2] or r0[0] != wave_sum or r0[1] != single or \
            rel > P13_STEP_RTOL or r0[2]["stats"] != r1[2]["stats"]:
        raise AssertionError("two gloo ranks disagree with one process")


def phase13_cli(dev, card, de, tmp):
    """(c) The CLI twins other than ``examples``, on the card in this
    process, each timed; a failure raises. They write under ``tmp``."""
    import contextlib
    import importlib.util
    import io

    from ldpc_tpu_torch.cli import comprehensive, generate_images, graft_entry

    for mod, argv, want in (
            (comprehensive, ["--code", "peg"],
             "ALL COMPREHENSIVE TESTS PASSED"),
            (graft_entry, [], "dryrun_multichip ok")):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            mod.main(argv + ["--device", dev.type])
        lines = out.getvalue().strip().splitlines()
        print(f"  (c) {mod.__name__.split('.')[-1]} {' '.join(argv)}: "
              f"{time.perf_counter() - t0:.1f} s, {len(lines)} lines, "
              f"last {lines[-1] if lines else ''!r}")
        if want not in out.getvalue():
            raise AssertionError(f"{mod.__name__}:\n{out.getvalue()}")
    t0 = time.perf_counter()
    drawn = importlib.util.find_spec("matplotlib") is not None
    if drawn:
        paths = generate_images.generate_all_images(
            tmp, 1024, verbose=False, device=dev)
    else:  # the figures' data: the simulation, saved as JSON
        generate_images.comparison_results(tmp, 1024, verbose=False,
                                           device=dev)
        paths = []
    with open(os.path.join(tmp, "mc_results.json")) as f:
        fer = {k: r["frame_error_rates"] for k, r in json.load(f).items()}
    t_img = time.perf_counter() - t0
    curves, t_de = de.get()
    # DE iterations to 1e-5 on the bench base; the PBRL ladders' error
    # at 4 dB (the bc=4 ladders remove the bc=3 plateau)
    reach = {s: 1 + int(np.argmax(np.asarray(curves[s]) < 1e-5))
             for s in ("flooding", "layered")}
    pbrl = {k: v[-1] for k, v in curves["pbrl"].items()}
    if drawn:
        paths.append(generate_images.generate_de_figure(tmp, False,
                                                        curves))
    print(f"  (c) generate_images at 1024 frames: {t_img:.1f} s, "
          + (f"{len(paths)} figures drawn" if drawn else
             "matplotlib is not installed: the figures' data checked, "
             "not drawn") +
          f"; FER at 0..5 dB by decoder {fer}; DE curves {t_de:.1f} s "
          f"on the host (worker): below 1e-5 at iteration {reach} on "
          f"the bench base, PBRL at 4 dB {pbrl}  [{card}]")
    bc3, *bc4 = pbrl.values()
    if not all(os.path.getsize(p) > 1000 for p in paths) or \
            not reach["layered"] < reach["flooding"] or \
            not bc3 > max(bc4) or \
            len(fer) != 10 or not all(len(f) == 6 and
                                      0 <= f[-1] <= f[0] <= 1
                                      for f in fer.values()):
        raise AssertionError(f"generate_images: {paths}, FER {fer}")


def phase13(dev, card, dec, wave_ms, de):
    """Parallel and the CLI twins; returns the mesh path's launches. The
    ``examples`` process runs beside (b), which times nothing it claims."""
    import re
    import tempfile

    t_phase = time.perf_counter()
    counts = phase13_nccl(dev, card, dec, wave_ms)
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        t0 = time.perf_counter()
        ex = subprocess.Popen(
            [sys.executable, "-m", "ldpc_tpu_torch.cli.examples",
             "--device", dev.type], cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=root))
        try:
            phase13_gloo(dev, card, dec)
            out = ex.communicate(timeout=900)[0]
        finally:
            if ex.poll() is None:
                ex.kill()
                ex.wait()
        done = dict(re.findall(r"^\[(\w+)\] done in ([\d.]+)s", out, re.M))
        print(f"  (c) python -m ldpc_tpu_torch.cli.examples (every "
              f"scenario, beside (b)): rc {ex.returncode}, "
              f"{time.perf_counter() - t0:.1f} s; seconds by scenario "
              f"{done}")
        if ex.returncode != 0 or len(done) != 16:
            raise AssertionError(f"examples failed:\n{out[-4000:]}")
        torch.cuda.empty_cache()
        phase13_cli(dev, card, de, tmp)
    print(f"  launches of the mesh path in (a): {counts}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts


def run(design, de):
    """Phases 1-13; ``design`` and ``de`` are the result handles of
    :func:`bench_design` and :func:`de_data` running in a worker
    process."""
    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.decode import _build, two_checkpoint_stages
    from ldpc_tpu_torch.sim import point_generator

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
    for name, st in ptxas_stats(
            _build.library_path().with_suffix(".log")).items():
        print(f"  ptxas: {name}: {st.get('registers')} registers, spill "
              f"stores/loads {st.get('spills')} B")

    # ---- 3: K1 vs its plain version on the card
    print("[3 K1 vs plain]")
    base = small_base()
    code = lt.create_qc_code(base, lift=16, max_iterations=5)
    qc = lt.build_qc_graph(base, 16)
    gen = torch.Generator(device=dev).manual_seed(1)
    llr = lt.awgn_llr(gen, torch.zeros((37, code.n), device=dev), 2.5)
    max_err = 0.0
    for name, kw in SMALL_KINDS:
        dec = lt.make_decoder(code, max_iterations=5, qc=qc, **kw)
        for dtype in (torch.float32, torch.bfloat16):
            for lean in (False, True):
                max_err = max(max_err, compare(name, dec, llr, dtype, lean))

    bench_base = np.random.default_rng(0).integers(0, 256, size=(5, 37))
    bcode = lt.create_qc_code(bench_base, lift=256, max_iterations=T)
    bqc = lt.build_qc_graph(bench_base, 256)
    dec = lt.make_decoder(bcode, qc=bqc, qc_options=dict(
        fused=True, dtype=torch.bfloat16, lean=True), **BENCH_KW)
    llr256 = lt.awgn_llr(gen, torch.zeros((256, bcode.n), device=dev), 6.25)
    for dtype in (torch.float32, torch.bfloat16):
        max_err = max(max_err, compare("bench", dec, llr256, dtype, False))
    compare("bench", dec, llr256, torch.bfloat16, True)
    ldec = lt.load_pretrained(ZOO_LAYERED)
    lllr = lt.awgn_llr(gen, torch.zeros((256, ldec.code.n), device=dev),
                       6.25)
    for dtype in (torch.float32, torch.bfloat16):
        max_err = max(max_err, compare("zoo layered", ldec, lllr, dtype,
                                       False))
    compare("zoo layered", ldec, lllr, torch.bfloat16, True)

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
    # the zoo decoder at full width, T=6 (bf16, lean)
    xz = lt.awgn_llr(gen, torch.zeros((B_MAIN, ldec.code.n), device=dev),
                     6.25).to(torch.bfloat16)
    zl = [time_ms(lambda: kernel_on(xz, ldec, ldec.max_iterations, True), 3)
          for _ in range(2)]
    zb = bound(ldec, B_MAIN, ldec.max_iterations, flooding=False)
    print(f"  time {ZOO_LAYERED} B={B_MAIN} T={ldec.max_iterations}: kernel "
          f"{zl[0]:.3f} / {zl[1]:.3f} ms, bound {zb[0]:.3f} ms ({zb[1]})  "
          f"[{card}]")
    del xz
    print(k1_facts(dec, card))

    # ---- 4: the main path at full width
    two_ck = lt.make_two_checkpoint_decoder(dec, t1=T1, survivor_budget=S)
    cw = torch.zeros((B_MAIN, bcode.n), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    llrs = [lt.awgn_llr(gen, cw, SNR_DB) for _ in range(3)]
    del cw
    torch.cuda.synchronize()

    n_warm, n_timed = 2, 6
    reset_counts()
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
    counts = read_counts()
    launches = counts["K1"]
    n_waves = n_warm + n_timed
    if counts["K4"] or counts["K5"] or counts["K6"]:
        raise AssertionError(f"the layered bench path launched {counts}")

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
    print(f"[4 bench path] B={B_MAIN} at {SNR_DB} dB, {n_waves} waves "
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
    b1 = bound(dec, B_MAIN, T1, flooding=False)
    print(f"  stage-1 kernel (B={B_MAIN}, T={T1}) {st1:.3f} ms (bound "
          f"{b1[0]:.3f} ms, {b1[1]}), stage-2 kernel (B={S}, T={T}) "
          f"{st2:.4f} ms, wave {1e3 * secs / n_timed:.3f} ms  [{card}]")

    del llrs, x1
    k1_bound = bound(dec, 256, T, flooding=False)

    # ---- 5: K4 vs its plain version on the card
    print("[5 K4 vs plain]")
    k4_err = 0.0
    for name, kw in SMALL_KINDS:
        sdec = lt.make_decoder(code, max_iterations=5, qc=qc, **kw)
        for dtype in (torch.float32, torch.bfloat16):
            for lean in (False, True):
                k4_err = max(k4_err, compare(name, sdec, llr, dtype, lean,
                                             flooding=True))
    zdec = lt.load_pretrained(ZOO_ENTRY, qc_options=dict(
        fused=True, dtype=torch.bfloat16, lean=True))
    zllr = lt.awgn_llr(gen, torch.zeros((256, zdec.code.n), device=dev),
                       6.25)
    for dtype in (torch.float32, torch.bfloat16):
        k4_err = max(k4_err, compare("zoo", zdec, zllr, dtype, False,
                                     flooding=True))
    compare("zoo", zdec, zllr, torch.bfloat16, True, flooding=True)

    # kernel vs plain at the simulator's shapes (bf16, lean): stage 1 of a
    # wave and its stage 2 (a full survivor budget)
    cw = torch.zeros((SIM_WAVE, zdec.code.n), device=dev)
    xs = lt.awgn_llr(gen, cw, 6.25).to(torch.bfloat16)
    del cw
    k4_times = {}
    for B_, T_ in ((SIM_WAVE, SIM_T1), (SIM_BUDGET, zdec.max_iterations)):
        x = xs[:B_]
        kern = lambda: kernel_on(x, zdec, T_, True, flooding=True)
        plain = lambda: plain_on(x, zdec, T_, True, flooding=True)
        k_ms, p_ms = time_ms(kern, 10), time_ms(plain, 1)
        k2_ms, p2_ms = time_ms(kern, 10), time_ms(plain, 1)
        b_ms, b_by = bound(zdec, B_, T_, flooding=True)
        k4_times[B_] = (k_ms, p_ms, b_ms, b_by)
        print(f"  time B={B_} T={T_}: kernel {k_ms:.3f} / {k2_ms:.3f} ms, "
              f"plain {p_ms:.1f} / {p2_ms:.1f} ms, bound {b_ms:.3f} ms "
              f"({b_by})  [{card}]")
    del xs, x
    torch.cuda.empty_cache()
    from ldpc_tpu_torch.decode import fused
    from ldpc_tpu_torch.decode.engine import qdq_mode
    spec, zqc = zdec.spec, zdec.qc
    lib = _build.load_library()
    sizes = (zqc.nb, zqc.mb, zqc.num_blocks, zqc.lift, 1)
    modes = (fused._QMODES[qdq_mode(spec.qparams, spec.q_levels)],
             spec.q_levels,
             fused._QMODES[qdq_mode(spec.v2c_qparams, spec.v2c_levels)],
             spec.v2c_levels)
    ctas = lib.ldpc_fused_flooding_occupancy(
        *sizes, fused._KINDS[spec.kind], *modes)
    print(kernel_facts("fused_flooding", ctas) +
          f", {lib.ldpc_fused_flooding_smem(*sizes, *modes)} B of shared "
          f"memory per CTA  [{card}]")

    # ---- 6: the simulator at full width on the zoo decoder
    cfg = lt.SimulationConfig(**SIM_CONFIG)
    snrs = [float(s) for s in cfg.snr_points()]
    # survivors of the first 6.5 dB wave after t1 iterations, t1 = 5..8
    probe = lt.awgn_llr(point_generator(cfg.seed, snrs.index(6.5), dev),
                        torch.zeros((SIM_WAVE, zdec.code.n), device=dev),
                        torch.tensor(6.5, device=dev))
    surv = {t1: int((~two_checkpoint_stages(zdec, t1)[0](
        probe, zdec.weights).success).sum()) for t1 in range(5, 9)}
    del probe
    print(f"[6 simulator] {ZOO_ENTRY}: survivors of the first 6.5 dB wave "
          f"after t1 iterations {surv} (budget {SIM_BUDGET}); "
          f"early_exit_iters={SIM_T1}")
    sim = lt.LDPCSimulator(cfg)
    reset_counts()
    res = sim.simulate_decoder(zdec, ZOO_ENTRY, verbose=False)
    torch.cuda.synchronize()
    counts = read_counts()
    k4_launches, k1_in_sim = counts["K4"], counts["K1"]
    kinds = sim.wave_kinds[ZOO_ENTRY]
    for i, snr in enumerate(snrs):
        frames, errors = res.total_frames[i], res.total_errors[i]
        print(f"  {snr:.2f} dB: {frames} frames, {errors} frame errors, "
              f"FER {res.frame_error_rates[i]:.6g}, BER "
              f"{res.bit_error_rates[i]:.6g}, avg iterations "
              f"{res.average_iterations[i]:.4f}, waves {kinds[i]}, "
              f"{frames / res.simulation_times[i]:.1f} codewords/s  [{card}]")
    n_comp = sum(k.get("compacted", 0) for k in kinds)
    n_fall = sum(k.get("fallback", 0) for k in kinds)
    print(f"  K4 launches {k4_launches}, K1 launches {k1_in_sim}, "
          f"compacted waves {n_comp}, fallback waves {n_fall}")
    if k1_in_sim or counts["K5"] or counts["K6"] or \
            k4_launches != 2 * n_comp + 4 * n_fall:
        raise AssertionError("the simulator did not run through K4 alone")
    if not (n_comp and n_fall):
        raise AssertionError(f"both wave kinds must run: {kinds}")
    for i, snr in enumerate(snrs):
        fer = res.frame_error_rates[i]
        if snr in FER_BANDS:
            lo, hi = FER_BANDS[snr]
            ok = lo <= fer <= hi
        else:
            ok = (res.total_frames[i] == cfg.max_frames and
                  ERRORS_65[0] <= res.total_errors[i] <= ERRORS_65[1])
        if not ok:
            raise AssertionError(f"FER {fer} ({res.total_errors[i]} of "
                                 f"{res.total_frames[i]}) at {snr} dB is "
                                 "off the JAX package's curve")

    # the first wave's first 64 frames against the plain path on the CPU
    sub = lt.awgn_llr(point_generator(cfg.seed, 0, dev),
                      torch.zeros((SIM_WAVE, zdec.code.n), device=dev),
                      torch.tensor(snrs[0], device=dev))[:64]
    two = lt.make_two_checkpoint_decoder(zdec, t1=SIM_T1,
                                         survivor_budget=SIM_BUDGET)
    g_out, g_n = two(sub)
    c_out, c_n = two(sub.cpu())
    agree = (g_out.bits.cpu() == c_out.bits).float().mean().item()
    if int(g_n) != int(c_n) or agree < 0.9999 or not torch.equal(
            g_out.success.cpu(), c_out.success):
        raise AssertionError(f"simulator wave vs plain on the CPU: survivors "
                             f"{int(g_n)} vs {int(c_n)}, bits {agree}")
    print(f"  first 64 frames of the first wave vs the CPU plain path: "
          f"survivors {int(g_n)}, bits agree {agree:.6f}, success equal")

    del sub, g_out, c_out
    torch.cuda.empty_cache()
    rc = phase7(code, qc, dataclasses.replace(
        zdec, qc_options=None), gen, dev, card)
    rc_counts = phase8(zdec, dev, card)
    torch.cuda.empty_cache()
    phase9(dev, card)
    torch.cuda.empty_cache()
    phase10(dev, card)
    torch.cuda.empty_cache()
    phase11(dev, card)
    torch.cuda.empty_cache()
    p12_launches, p12_err = phase12(dev, card, design)
    torch.cuda.empty_cache()
    p13 = phase13(dev, card, dec, 1e3 * secs / n_timed, de)

    print(card)
    k4 = k4_times[SIM_WAVE]
    print(json.dumps({"kernels": [{
        "name": "fused_layered",
        "route": "cuda",
        "source": "ldpc_tpu_torch/csrc/fused_layered.cu",
        "replaces": "ldpc_tpu/decode/pallas_fused.py:467",
        "launches": launches + p12_launches + p13["K1"],
        "max_abs_err": max(max_err, p12_err),
        "ms": times[256][0],
        "plain_ms": times[256][1],
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": None,
    }, {
        "name": "fused_flooding",
        "route": "cuda",
        "source": "ldpc_tpu_torch/csrc/fused_flooding.cu",
        "replaces": "ldpc_tpu/decode/pallas_fused.py:195",
        "launches": k4_launches + p13["K4"],
        "max_abs_err": k4_err,
        "ms": k4[0],
        "plain_ms": k4[1],
        "bound_ms": k4[2],
        "bound_by": k4[3],
        "library_ms": None,
    }] + [{
        "name": key,
        "route": "cuda",
        "source": f"ldpc_tpu_torch/csrc/{key}.cu",
        "replaces": f"ldpc_tpu/decode/pallas_qc.py:{line}",
        "launches": rc_counts[kid],
        "max_abs_err": rc[key][4],
        "ms": rc[key][0],
        "plain_ms": rc[key][1],
        "bound_ms": rc[key][2],
        "bound_by": rc[key][3],
        "library_ms": None,
    } for key, line, kid in (("qc_cn", 76, "K5"), ("qc_vn", 142, "K6"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))

def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "run only on an NVIDIA GPU")
    # phase 12's design and phase 13's DE curves are host numpy for a
    # minute or two each: they run in a worker process from the start,
    # beside phases 1-11 (leaving the pool terminates the worker)
    base = np.random.default_rng(0).integers(0, 256, size=(5, 37))
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        run(pool.apply_async(bench_design, (base,)),
            pool.apply_async(de_data))


if __name__ == "__main__":
    main()
