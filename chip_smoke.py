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
   (``experiments/accuracy_bc3_results.json``); the first wave's first 8
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
   ``experiments/accuracy_bc3.py`` (B=128, 2 steps, one ``train_epoch``)
   and ``experiments/train_layered_short.py`` (cosine with 8 warmup
   updates: 2 steps, the first at learning rate 0, so its weights stay);
   each step's loss, CUDA-event time and peak memory, the CUDA launches of
   one layered step (torch.profiler, in a worker beside phase 13); one
   B=8 batch stepped twice on the card and on a CPU copy of the flooding
   decoder, held to float tolerance; the gradient analyzer
   (``torch.func.vmap``) on 4 frames at 6.5 dB, one
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
   (c) ``experiments/floor_is.py``'s two arms at 3.6 dB through its twin
   ``ldpc_tpu_torch/cli/floor_is.py`` (PBRL QC rate 1/3, lift 86, random
   and precoded; RCQ bc=4 6-11-16, bv=8, layered T=10, fused bf16): its
   trapping-set search, class choice and estimates, the
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
   ``examples`` (every scenario, in a process beside (b) and the other
   CLIs), ``comprehensive --code peg``,
   ``graft_entry`` (``entry()`` and ``dryrun_multichip(1)`` over NCCL), and
   ``generate_images``' comparison at 1024 frames and its DE figure (the DE
   curves are host numpy, computed in the worker process beside phases
   1-12; without matplotlib the figures' data is checked and not drawn).
   The examples process runs from the phase's start; run() puts phase
   21's cut trainings and phase 11's traced layered step in a worker
   process beside (b), (c) and the examples (none of which times what it
   claims there).
14. the throughput programs' twins (``ldpc_tpu_torch/cli/``): (a)
   ``python -m ldpc_tpu_torch.cli.bench`` in a process of its own, its last
   line ``bench.py``'s metric line (the name read from ``bench.py``, a rate
   above 0), no frame error and every wave's survivors within 128; (b)
   the matrix twin (``throughput_matrix.run``) at the JAX program's
   batches and ``--reps 10``, one entry a call: each fused entry (the bench
   code layered T=6 and flooding T=10 at B=8192, DVB-S2-structure (16200,
   7200) at B=4096, Tanner (155, 64) at B=16384, QC PBRL (3096, 1032) T=10
   at B=8192) launching K1 or K4 exactly once a decode, its first 64
   frames through the kernel held to the plain version bit for bit in f32
   and bf16 with the rules of phase 3, its kernel timed alone against the
   plain version and the bound, with its registers, spills, shared memory,
   check-state placement and CTAs per SM; the general and bucketed engines
   on PBRL (3096, 1032) at B=2048 with no kernel launch, and their ratio;
   each entry's rate, frame errors, LLR bytes and peak memory; (c) the
   batch study (``ee_batch.run``) at B = 16384, 32768 and 65536 with no
   overflow and 2 K1 launches a wave.
15. the FER campaign programs' twins (``ldpc_tpu_torch/cli/``) at their
   full width (the bench code, lift 256; the programs' waves, budgets and
   error targets; only SNR points and frame caps cut, each cut printed):
   first K1 at the four layered T=6 specs (RCQ bc=3, RCQ bc=4, float
   min-sum, the zoo's trained W-OMS-RCQ) and K4 at the trained flooding
   T=10 spec held to their plain versions bit for bit at both depths of
   their compaction (64 frames at 6.5 dB, bf16, full output) and timed at
   the campaign's shapes against their bounds; (a) ``deep_fer``'s
   decoders through ``sweep`` (32768-frame waves, budget 2048, 100
   errors, a 2^22-frame cap): RCQ-bc3-L6 at 6.4, 6.5 and 6.6 dB, RCQ-bc4-L6
   at 6.5, float-MS-L6 at 6.4 ({3, 6}, K1) and the trained flooding
   decoder at 6.4 and 6.5 ({5, 10}, K4); (b) ``deep_fer_trained_l6`` at 6.4
   and 6.5 dB ({2, 6}, K1), each point's frames/s and wave kinds printed
   and the launches checked against the waves (2 a compacted wave, 4 a
   fallback); (c) ``accuracy_bc3``: the full dev sweep (K4), ``train_pair``
   cut to one epoch of 128 frames (no launch) and the waterfall on the
   JAX run's 2-4-6@1.3 at 16,384 frames a point (K4, once a wave); (d)
   ``fer_parity`` at 16,384 frames a point (the general engine, no
   launch). Every requested decoder must have its curve, and every point
   whose JAX record (``experiments/*_results.json``, read as data) has
   at least 20 errors and 20 successes must pass Fisher's exact test
   against it at p >= 1e-3 (the trained decoders of (c), cut-trained,
   are printed, not tested).
16. the bench-knob and short-schedule programs' twins
   (``ldpc_tpu_torch/cli/``) at their full width (the bench code, lift
   256; the programs' batches, budgets and waves; only SNR points, frame
   caps and training steps cut, each cut printed), only K1 launching,
   held first to its plain version bit for bit at each new spec (stage 1
   at t1=2 of the trained L6, 2-4-6 and DDE decoders, lean, B=8192; stage
   2 at S=1024 and at bench_dde's budget B=4096; the zoo's T=5 and T=4
   tables and the cut-trained per-layer [T, 5] tables at B=8192), each
   timed against its bound: (a) ``bench_ab_s`` at B=32768: every wave's
   survivors within S, the same bits under S = 512, 256 and 128, the three
   rates; (b) ``ee_trained`` at B=8192: the six survivor counts beside the
   JAX record (the three at t1=2 Fisher-tested), the arms the counts
   select and their rates; (c) ``bench_dde``: ``train`` cut to one step
   (no launch), then ``deep`` on the zoo's ``worcq_bc3_layered_t6_dde``
   and the bench decoder (32768-frame waves, budget 4096, 100 errors;
   RCQ-dde-L6 at 6.4-6.6 dB, the last capped at 2^21 frames, W-ORCQ-dde-L6
   at 6.4 and 6.5 dB), each point's frames/s and wave kinds; (d)
   ``train_layered_short``: the four arms cut to one step each (no launch),
   the FER table at 65,536 frames a point, RCQ-L6 and RCQ-L5
   Fisher-tested, the zoo's T=5 and T=4 entries beside their recorded
   FER. Points as in phase 15: p >= 1e-3 where the JAX record has at
   least 20 errors and 20 successes.
17. the W-RCQ training and rate-specific programs' twins
   (``ldpc_tpu_torch/cli/``) at the programs' code sizes, batches, waves
   and budgets (only SNR points, frame caps, epochs and ``num_samples``
   cut, each cut printed): (a) ``train_wrcq`` whole (PEG(256, 128), 12
   epochs of 4096, 32,768 frames a point; the general engine, no
   launch), float-MS Fisher-tested at every point, the trained arm below
   the untrained at 3.0 and 3.5 dB; (b) ``rate_specific`` whole (the PBRL
   family at k=96, three rates; no launch), MS Fisher-tested at all 15
   points; (c) ``train_wrcq_qc9472`` at lift 256 (the QC engine, no
   launch), training cut to 2 steps an epoch, the simulation to 4,096
   frames a point (the program's 16,384), float-MS at 6.0 dB
   Fisher-tested; (d) ``rate_specific_deep`` at lift
   86: K1 held to its plain version bit for bit at stage 1 (T=3,
   B=32768), stage 2 (T=10, B=4096) and the fallback's whole decode
   (T=10, B=32768) for W-NMS-RCQ on its initial tables, then for
   OMS-6bit and both candidates after their training (one step of 128
   frames each, no launch; every row of the RCQ decoders on K1's
   per-block route), each timed against its bound with K1's registers,
   shared memory, check-state placement and CTAs per SM; the campaign
   ({3, 10}, 32768-frame waves, budget 4096, 100 errors): OMS-6bit at
   2.6 and 2.8 dB Fisher-tested, the cut-trained candidates at 3.2 dB
   printed, K1's launches equal to 2 a compacted wave and 4 a fallback.
   The trained and untrained W-RCQ arms are printed beside the JAX
   records, not tested (their weights come from the port's generator);
   no K4, K5 or K6 launch in the phase, which must end within 180 s.
18. the PBRL floor programs' twins (``ldpc_tpu_torch/cli/``) at the
   programs' codes, waves, budgets and error targets (only SNR points and
   frame caps cut, each cut printed), only K1 launching, held first to
   its plain version bit for bit at every (decoder, iterations, batch)
   the campaigns launch, each timed against its bound with K1's
   registers, shared memory, check-state placement and CTAs per SM:
   ``pbrl_bc5``'s four arms (RCQ bc=4 and bc=5 with the closed-form
   quantizer, T=10 and 20) at stage 1 (T=5, B=32768), stage 2 (B=4096)
   and, at T=20, the fallback's whole decode (B=32768);
   ``pbrl_lift_floor``'s two arms (n = 3096 and 9288) at stage 1 (T=2,
   B=32768), stage 2 (T=10, B=4096) and the fallback; ``pbrl_precode``'s
   random RCQ decoder and its precoded RCQ and OMS decoders (n = 3182, 86
   bits punctured) at stage 1 and stage 2, on LLRs punctured as the
   simulator's mask does; an arm checked without the fallback's whole
   decode fails the phase if one of its waves falls back. (a)
   ``pbrl_bc5`` at 2.6 dB ({5, T}, 32768-frame waves, budget 4096, 100
   errors); (b) the ``pbrl_lift_floor`` twin's ``run`` at 2.8 and 3.2 dB
   (``simulate_single_snr``, {2, 10}, seed 11); (c) ``pbrl_precode``'s
   random and precoded RCQ arms at 2.6 dB and its OMS arm there capped at
   2^21 frames (printed), every K1 launch on the precoded code checked
   for zeros at the punctured positions as it reaches the kernel; (d)
   ``trapping_spectrum`` whole (five codes, host numpy, in the worker
   process beside phases 1-11), its spectra and min-b fingerprints equal
   to ``experiments/trapping_spectrum_results.json``. K1's launches equal
   2 a compacted wave and 4 a fallback; every point whose JAX record has
   at least 20 errors and 20 successes passes Fisher's exact test at
   p >= 1e-3; no K4, K5 or K6 launch; the phase must end within 150 s.
19. the bench-code design studies' twins (``ldpc_tpu_torch/cli/``) at the
   programs' codes, widths, waves, budgets and seeds (only SNR points and
   frame caps cut, each cut printed), only K1 launching, held first to
   its plain version bit for bit at every shape the studies launch, each
   timed against its bound with K1's registers, shared memory,
   check-state placement and CTAs per SM: ``ladder_bc4``'s 3-6-9@1.0
   whole (B=16384) and 2-4-6@1.3 at stage 1 (T=2, B=32768), stage 2
   (B=2048) and the fallback's whole decode (B=32768);
   ``bc4_refine``'s mixed-gamma bc=4 ladder (2.2, 2.2, 1.5) and
   ``quantizer_count``'s two-pair ``rcq-q2``, lean, at stage 1 (T=3,
   B=32768), stage 2 (B=4096) and the fallback (B=32768), their bc3 arm
   (the bench decoder) at stage 2 and the fallback; ``quantizer_count``'s
   ``p2`` and ``p3`` on the precoded rate-1/3 PBRL code at lift 43
   (49x73 base, n = 3139, base column 0's
   43 bits punctured) at stage 1 (T=5, B=98304), stage 2 (T=10, B=4096)
   and the fallback's whole decode (B=98304); ``dde_ladders``' bc4_dde
   whole at B=16384, full and lean. Then the two-pair tables on the card
   (row t of K1's [T, 2] and [T, L] tables is pair ``phase_schedule(T,
   2)[t]``, T=6 and 10), and K1 on each bc's dde and dde_cn_only decoders
   (one CN ladder, V2C ladders apart), full and lean: equal bits, success
   and iterations. (a) ``ladder_bc4`` whole (six ladders at 6.4 dB,
   131,072 frames each; the selected one at 6.5 and 6.6 dB, {2, 6},
   32768-frame waves, budget 2048, capped at 2^21 frames); (b)
   ``bc4_refine``'s deep phase, arms bc4 and bc3 at 6.0-6.6 dB ({3, 6},
   budget 4096, 100 errors, capped at 2^21 frames); (c)
   ``quantizer_count``'s deep phase (rcq-q2 from the committed design,
   rcq-q3) at 6.0-6.6 dB (50 errors, capped at 2^21), rcq-q3 (the same
   decoder and seeded stream as (b)'s bc3, with an error target of 50,
   not 100) equal to bc3 wave by wave over the waves both ran at each
   point, and deep13's p2 at 1.4-2.4 dB ({5,
   10}, 98304-frame waves, budget 4096) and p3 at 2.0 dB capped at 2^21
   frames (printed: no record), every K1 launch on the lift-43 code
   checked for zeros at the punctured positions; (d) ``dde_ladders`` at
   6.4 dB (262,144 frames an arm, ten arms), its four designer calls held
   to the program's and answered by phase 12 (a)'s bc=3 design and the
   JAX package's results for the others (host numpy for minutes:
   ``tests/jax_reference_dde_ladders.py``), the dde and dde_cn_only arms
   of each bc with equal frame errors. Points as in phase 15 (Fisher p >=
   1e-3 where the record has at least 20 errors and 20 successes):
   ``ladder_bc4``'s dev ladders (its deep points when the twin selects
   the record's ladder), every point of (b), (c)'s deep and p2, and
   ``dde_ladders``' hand arms; no K4, K5 or K6 launch; the phase must end
   within 240 s.
20. the section VII-C rate-family programs' twins
   (``ldpc_tpu_torch/cli/pbrl_rates.py``, ``tighten89.py``) at the
   programs' codes (the precoded PBRL family, k=1032, lift 43: rates 8/9,
   2/3, 1/2 and 1/3, n = 1204, 1591, 2107 and 3139, base column 0's 43
   bits punctured), waves (262,144, 196,608, 131,072 and 98,304 frames),
   budgets and seeds (only SNR points, frame caps and training steps cut,
   each cut printed), only K1 launching, held first to its plain version
   bit for bit in bf16 at every (rate, iterations, batch) the campaigns
   launch (stage 1 T=5 at the full wave, stage 2 T=10 at B=4096, the
   fallback's whole decode T=10 at the full wave) and at each table kind:
   ``oms6``, the 3-pair ``rcq-pol``, the 4-pair ``rcq-q4`` and 5-pair
   ``rcq-q5`` (``phase_schedule``'s even spread), the trained type-2
   ``wrcq-89`` and ``wrcq-89-q4`` and the per-layer ``wrcq-13pl`` (beta
   [10, 147], alpha [10, 588]), whose tables must equal the JAX
   program's (``cli/pbrl_rates_tables.npz``), each timed against its bound
   with K1's registers, shared memory, check-state placement and CTAs per
   SM: (a) ``tighten89`` at 9.0 dB, each arm capped at 2^24 frames,
   Fisher-tested against ``experiments/tighten89_results.json``; (b)
   ``pbrl_rates``' deep scan (rate 8/9: ``oms6``, ``rcq-pol``,
   ``wrcq-89-q4``; 2/3 ``rcq-q5``; 1/2 ``rcq-q4``; 1/3 ``wrcq-13pl``)
   from each record's first point with the program's walk, every point
   capped at 2^18 frames, each point beside
   ``experiments/pbrl_rates_ck/<tag>_<arm>.json``; every K1 launch of (a)
   and (b) checked for zeros at the punctured positions as it reaches the
   kernel; (c) ``train`` at rate 8/9 cut to 1 step (the engines, no
   launch), each step timed, its checkpoint through ``mk("wrcq-89")`` and
   one wave at 9.0 dB; (d) ``report`` on (b)'s scans, printed. Points as
   in phase 15, Fisher-tested where both the record and this run hold at
   least 20 errors and 20 successes; no K4, K5 or K6 launch; the phase
   must end within 200 s.
21. the precoded-PBRL training programs' twins
   (``ldpc_tpu_torch/cli/pbrl_wrcq.py``, ``train_matched.py``,
   ``pbrl_honest_train.py``) at the programs' code (the precoded PBRL code,
   k=1032, rate 1/3, 25x37 base at lift 86, n = 3182, base column 0's 86
   bits punctured), waves (32768), budgets (4096; pbrl_honest_train's
   8192) and error targets (only SNR points, frame caps, training steps
   and validation frames cut, each cut printed), only K1 launching: (a)
   K1 held to its plain version bit for bit in bf16 with the full output
   at every (decoder, iterations, batch) of ``P21_CHECKS``: the 10-pair
   DDE ladder ``rcq-dde``, ``rcq-ref2`` (``train_matched``'s designed
   decoder) and ``rcq-ref4`` (V2C reach 1408.4) at stage 1
   (T=5, B=32768), stage 2 (T=10, B=4096) and the fallback's whole decode
   (T=10, B=32768), ``wrcq-ref3`` and ``wrcq-ref3pl`` (the JAX program's
   trained type-2 [10, 2] / [10, 9] and per-layer [10, 50] / [10, 225]
   tables, ``cli/pbrl_wrcq_tables.npz``, every row on the per-block
   route), and ``pbrl_honest_train``'s cut-trained ``worcq``, ``wrcq``
   (multiplicative), ``worcq-pl`` and its ``rcq-ref3`` at stage 2's
   B=8192, ``wrcq`` at stage 1 too, each timed against its bound with
   K1's registers, shared memory, check-state placement and CTAs per SM;
   (b) on one set of punctured LLRs at stage 2's shape, W-OMS-RCQ with
   every table zero equal to the plain designed RCQ decoder bit for bit,
   and ``rcq-ref3`` under design3's V2C ladder equal to it under the
   uniform one in bits, success and iterations; (c) ``pbrl_wrcq``'s
   ``dev_fer`` at 2.0 dB for rcq-hand, rcq-ref3it and rcq-ref4 (100
   errors) and oms6 (capped at 2^22 frames), against
   ``experiments/pbrl_honest_dev.json``; (d) ``pbrl_honest_train``'s five
   arms cut to one training step each (the engines, no launch; tables
   finite, of the decoder's shapes), then its ``dev`` for oms6 and
   rcq-ref3 at 2.0 dB (budget 8192, capped at 2^22 frames), against
   ``experiments/pbrl_honest_train_results.json``; (e) ``train_matched``'s
   four arms cut to one step each (``zinit`` from zero tables), then its
   ``dev`` for the designed ref2 decoder at 2.0 dB (300 errors), against
   the honest record's rcq-ref2. Every K1 launch of (c)-(e) is checked
   for zeros at the punctured positions as it reaches the kernel, and an
   arm whose waves fall back must have had its whole decode checked.
   Points as in phase 20; no K4, K5 or K6 launch; the phase must end
   within 150 s.
22. the PBRL V2C/CN probe programs' twins
   (``ldpc_tpu_torch/cli/pbrl_bv10.py``, ``pbrl_cn_probe.py``,
   ``pbrl_vqp_sweep.py``, ``pbrl_vqp_gamma.py``) at the programs' code
   (phase 21's precoded PBRL code), waves (32768), budget (4096) and error
   target (100; only SNR points and frame caps cut, each cut printed),
   only K1 launching: (a) K1 held to its plain version bit for bit in
   bf16 with the full output at every (arm, iterations, batch) of
   ``P22_CHECKS``: the uniform bv=12 V2C quantizer (M = 2047), the power
   law at gamma 2.0 and 1.5 (the 128-entry level table) and bc=5's closed
   form with CN_REF3 at stage 1 (T=5, B=32768), stage 2 (T=10, B=4096)
   and the fallback's whole decode (T=10, B=32768), the three CN ladders
   at stage 2, each timed against its bound with K1's registers, shared
   memory, check-state placement and CTAs per SM; (b) on one stage-1 and
   one stage-2 wave, the nine bc=4 CN_REF3 arms equal to ``pbrl_wrcq``'s
   rcq-ref3 and bc5_vr96 equal to bc5_bv10 in bits, success and
   iterations (only the posterior passes through the V2C quantizer; the
   posterior values apart printed); (c) each twin's ``main`` at 2.0 dB
   (one arm of the rcq-ref3 class at 2.4 dB too), every point capped at
   2^21 frames: the rcq-ref3 class Fisher-tested against
   ``experiments/pbrl_honest_dev.json``'s rcq-ref3, the other four
   decoders against ``ldpc_tpu_torch/cli/pbrl_probe_reference.json``
   (the JAX package's counts on the CPU,
   ``tests/jax_reference_probes.py``); the programs' committed records
   predate the decision-bias fix and are printed beside, marked
   retracted, never tested. Every K1 launch of (c) is checked for zeros
   at the punctured positions; an arm whose waves fall back must have had
   its whole decode checked; all 15 points tested at p >= 1e-3; no K4,
   K5 or K6 launch; the phase must end within 120 s.

Order: phase 10 launches none of the library's kernels, so it runs on the
card while nvcc builds (phase 2), and its engines' times are taken beside
the build's host load. Phases 14-22 run in three processes:
15, 19 and then 20 in the script's own, 14, 16 and 17 in one worker
process and 18, 21 and 22 in another (``LANES``); phase 20, the one
nearest its limit when all three run, starts when the lanes are about
done. The workers' output is printed after phase 20's, and a phase
failing in a worker fails the script. So the times printed in phases
14-22 are taken beside the other lanes' work on the same card and the
same host; the kernels' ``ms`` in the JSON record come from phases 3, 5
and 7, which run alone.

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

import concurrent.futures
import contextlib
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

T_START = time.perf_counter()
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
# phase 6's frames held to the plain path on the CPU (≈ 1.4 s a frame of
# host time for the zoo's flooding decoder at lift 256, T=10)
SIM_CPU = 8
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
# Flooding: experiments/accuracy_bc3.py:96-103's configuration, 2 steps
# (the program trains for epochs; cut for the script's time limit); the
# analyzer on 4 frames, TR_SINGLE of them recomputed one at a time.
# Layered: experiments/train_layered_short.py:85-90's, 2 steps (cut for
# the time limit); its decay_steps is the run the zoo entry came from (32
# epochs x 2048 // 128 batches = 512; the steps taken here are inside the
# 8-step warmup)
TR_CFG = dict(batch_size=128, learning_rate=2e-3, snr_range=(5.5, 7.5),
              early_stop_accuracy=2.0, seed=0)
TR_LAYERED_CFG = dict(TR_CFG, lr_schedule="cosine", warmup_steps=8,
                      decay_steps=512)
TR_STEPS, TR_LAYERED_STEPS, TR_CPU_B = 2, 2, 8
TR_ANALYZE = dict(num_samples=4, snr_db=6.5)
TR_SINGLE = 1
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
# (c) experiments/floor_is.py's two arms at 3.6 dB through its twin
# (ldpc_tpu_torch/cli/floor_is.py: its decoder, trapping-set search, class
# choice, seeds and batches of 2^11) at the program's shift and samples;
# the JAX results are experiments/floor_is_results.json
FLOOR_SNR, FLOOR_SHIFT, FLOOR_SAMPLES = 3.6, 1.6, 2 ** 15
# phase 13: the mesh paths. (a) phase 9's wave without early exit through
# the zoo's fused decoder (K4), and phase 9's compaction; (b) two gloo
# ranks on the card: a K4 wave of 2x4096 frames at 6.5 dB, the bench
# program at B=2x16384 with S=128 a rank (phase 4 keeps < 128 survivors in
# 32768 frames at 7.0 dB), two steps of the flooding recipe
P13_WAVE = dict(NF_CONFIG, early_exit_iters=None, survivor_budget=None,
                stage1_fused=False)
P13_GLOO_WAVE, P13_GLOO_B, P13_SEED = 2 * 4096, 2 * 16384, 13
P13_STEP_RTOL = 1e-5
# phase 14: the throughput programs' twins (ldpc_tpu_torch/cli/): the
# matrix at the JAX program's --reps default, each fused entry's first
# P14_FRAMES frames held to the plain version
P14_REPS, P14_FRAMES = 10, 64
# phase 15: the FER campaign programs' twins (ldpc_tpu_torch/cli/) at their
# full width (lift 256, their waves, budgets and error targets); only SNR
# points and frame caps are cut. The deep-FER points (decoder, SNRs); the
# frame cap is deep_fer.py's 5e7 cut to 2^22: it binds only at RCQ-bc3-L6's
# 6.6 dB, where the JAX record's FER 1.85e-6 (100 errors in 54,034,432
# frames) expects about 8 errors
P15_DEEP = (("RCQ-bc3-L6", (6.4, 6.5, 6.6)), ("RCQ-bc4-L6", (6.5,)),
            ("float-MS-L6", (6.4,)), ("W-OMS-RCQ-bc3-trained", (6.4, 6.5)))
P15_L6_SNRS, P15_CAP = (6.4, 6.5), 2 ** 22
P15_LIFT, P15_WAVE = 256, 32768
# accuracy_bc3: the full dev sweep, train_pair cut to one epoch of 128
# frames (one step a decoder: the trained decoders are printed, not
# tested), the waterfall on the JAX run's
# ladder; fer_parity and the waterfall at 16,384 frames a point
P15_LADDER, P15_TRAIN, P15_FRAMES = "2-4-6@1.3", dict(epochs=1,
                                                      num_samples=128), 16384
# a point is held to the JAX record's by the two-sided p of Fisher's exact
# test where the record has at least P15_MIN errors and P15_MIN successes.
# K1 and K4 are first held to their plain versions at the campaign's
# shapes: stage 2 on the survivor budget's frames at every spec, stage 1 on
# the whole wave at the P15_WAVE_CHECK specs (one a kernel; P14_FRAMES
# frames at the others)
P15_MIN, P15_P, P15_CHECK_SNR = 20, 1e-3, 6.5
P15_WAVE_CHECK = ("RCQ-bc3-L6", "W-OMS-RCQ-bc3-trained")
# phase 16: the bench-knob and short-schedule programs' twins
# (ldpc_tpu_torch/cli/) at their full width: lift 256, the programs'
# batches, budgets and waves; only SNR points, frame caps and training
# steps are cut. bench_dde's deep points (decoder, SNRs, frame cap): its
# 5e7 cap cut to 2^21 at 6.6 dB (the JAX record's FER 1.56e-6 expects
# about 3 errors there); every
# training cut to one epoch of 128
# frames (one step: the cosine schedule
# keeps the program's 16 updates an epoch). K1 is held to its plain
# version first at every (decoder,
# iterations, batch) the part launches: each stage 1 and whole decode at
# the part's batch, each stage 2 at its budget
P16_DEEP = (("RCQ-dde-L6", (6.4, 6.5), 5 * 10 ** 7),
            ("RCQ-dde-L6", (6.6,), 2 ** 21),
            ("W-ORCQ-dde-L6", (6.4, 6.5), 5 * 10 ** 7))
P16_TRAIN, P16_CHECK_SNR = dict(epochs=1, num_samples=128), 6.5
# train_layered_short's FER table: the program's frames a point
P16_FRAMES = 65536
# ee_trained's survivor counts Fisher-tested against the JAX record's
P16_EE_TESTED = ("survivors_plain_t1=2_B8192",
                 "survivors_trained_t1=2_B8192", "survivors_dde_t1=2_B8192")
# phase 17: the W-RCQ training and rate-specific programs' twins
# (ldpc_tpu_torch/cli/) at the programs' code sizes (PEG 256, PBRL k=96,
# lift 256, lift 86), batches, waves and budgets; only SNR points, frame
# caps, epochs and num_samples are cut, each cut printed. train_wrcq and
# rate_specific run whole (the programs' defaults); train_wrcq_qc9472's
# simulation cut to 4,096 frames a point (the program's 16,384: the
# 6.0 dB point stops at its errors
# first, the cut shortens the 6.5 and 7.0 dB points), its
# training cut to 2 steps an epoch (256 of the
# program's 1024 frames) for at most 2 epochs (the trainer's accuracy
# early stop at 0.99 ends it after the first: the JAX record's
# "train_epochs": 1); rate_specific_deep's training cut to one step of
# 128 frames a candidate, its campaign to P17_DEEP's points at the
# program's 2e7-frame cap and 100 errors. K1 is first held to its plain
# version at every (decoder, iterations, batch) the campaign launches (and
# W-NMS-RCQ on its initial tables), on LLRs drawn at P17_CHECK_SNR
P17_TQ, P17_TQ_SAMPLES = dict(lift=256, frames=4096, epochs=2), 256
P17_RSD_EPOCHS, P17_RSD_SAMPLES = 1, 128
P17_DEEP = (("OMS-6bit", (2.6, 2.8)), ("W-NMS-RCQ-4bit-trained", (3.2,)),
            ("W-OMS-RCQ-4bit-trained", (3.2,)))
P17_CHECK_SNR, P17_LIMIT = 3.2, 180
# phase 18: the PBRL floor programs' twins (ldpc_tpu_torch/cli/) at the
# programs' codes, waves, budgets and error targets; only SNR points and
# frame caps are cut, each cut printed: (a) pbrl_bc5's four arms at 2.6 dB;
# (b) pbrl_lift_floor's two arms at 2.8 and 3.2 dB; (c) pbrl_precode's
# RCQ arms at 2.6 dB, its OMS arm there capped at 2^21 frames and printed
# only (the JAX record: 7 errors in 20,021,248 frames); (d)
# trapping_spectrum whole, in the worker process beside phases 1-11. K1
# is first held to its plain version at every (decoder, iterations,
# batch) the campaigns launch, on LLRs drawn at P18_CHECK_SNR; the whole
# decode of a fallback wave only on the arms that fall back
P18_BC5_SNRS, P18_LIFT_SNRS, P18_PRECODE_SNRS = (2.6,), (2.8, 3.2), (2.6,)
# oms6 capped at P18_OMS_CAP frames (the program's 2e7; the point is
# printed, not tested)
P18_OMS_CAP, P18_CHECK_SNR, P18_LIMIT = 2 ** 21, 2.8, 150
# the three programs' wave and survivor budget
P18_WAVE, P18_BUDGET = 32768, 4096
# phase 19: the bench-code design studies' twins (ldpc_tpu_torch/cli/) at
# the programs' codes, widths, waves, budgets and seeds; only SNR points
# and frame caps are cut, each cut printed: (a) ladder_bc4 whole, its 6.6
# dB deep point capped at P19_CAP frames (the program's 2e7); (b)
# bc4_refine's deep phase at 6.0-6.6 dB, (c) quantizer_count's deep phase
# at 6.0-6.6 dB, each capped at P19_CAP frames (the programs' 2e8 and
# 1e9), deep13's p2 at 1.4-2.4 dB and p3 at P19_P3's point and cap
# (printed only: no record); (d) dde_ladders' arms at P19_DDE_SNRS (6.5
# dB cut) at the program's 262,144 frames. K1 is first held to its plain
# version at the P19 checks' shapes on LLRs drawn at the part's check SNR.
P19_CAP, P19_DDE_SNRS, P19_LIMIT = 2 ** 21, (6.4,), 240
P19_P3 = (2.0, 2 ** 21)
P19_CHECK_SNR, P19_CHECK13_SNR = 6.4, 2.0
# dde_ladders' designer calls other than the bc=3 design (phase 12 (a)'s
# call, held to DESIGN_QP / DESIGN_VQP): minutes of host numpy each, so the
# phase puts in their place the JAX package's results for the same calls,
# made once on a CPU with ldpc_tpu.design by
# ``JAX_PLATFORMS=cpu python tests/jax_reference_dde_ladders.py`` (its
# ``--port`` option makes the same calls through the port's design tools
# and compares: equal in every ladder and threshold). Each is (CN ladder,
# V2C ladder, DE threshold in dB); both refines return their input
# ladders, at a threshold of their own
P19_DESIGN_BC4 = (((6.9657, 1.3), (4.8879, 1.3), (8.4285, 1.3)),
                  ((40.9447, 1.0), (31.6042, 1.0), (33.1652, 1.0)),
                  6.112500000000001)
P19_REFINED = {3: (DESIGN_QP, DESIGN_VQP, 6.112500000000001),
               4: P19_DESIGN_BC4}
# phase 20: the section VII-C rate-family programs' twins
# (ldpc_tpu_torch/cli/pbrl_rates.py, tighten89.py) at the programs' codes
# (the precoded PBRL family at lift 43, rates 1/3-8/9), widths, waves,
# budgets and seeds; only SNR points, frame caps and training steps are
# cut, each cut printed: (a) tighten89's three arms at 9.0 dB capped at
# P20_T89_CAP frames (the program's 2.5e8 and 500 errors; the record's FER
# 2e-6 expects about 34 errors), 9.2 dB cut; (b) pbrl_rates' deep scan of
# P20_DEEP's arms from each record's first point, every point capped at
# P20_DEEP_CAP frames (the program's 5e7; the walk's 2e6 cap of its coarse
# points binds only above it); (c) train at rate 8/9 cut to
# P20_TRAIN_SAMPLES frames (1 step of 128; the program's 30 epochs of
# 2048); (d) report on (b)'s scans. K1 is first held to its plain version
# at every (rate, iterations, batch) the campaigns launch on one arm and at
# each table kind (P20_CHECKS: stage 1 T=5 at the rate's full wave, stage
# 2 T=10 at the budget, the fallback's whole decode T=10 at the full
# wave), on LLRs drawn at the rate's P20_CHECK_SNR with base column 0's 43
# bits punctured
P20_CHECKS = (("89", "oms6", ((5, 262144), (10, 4096), (10, 262144))),
              ("89", "rcq-pol", ((5, 262144),)),
              ("89", "wrcq-89-q4", ((5, 262144), (10, 4096))),
              ("89", "wrcq-89", ((10, 4096),)),
              ("23", "rcq-q5", ((5, 196608), (10, 4096), (10, 196608))),
              ("12", "rcq-q4", ((5, 131072), (10, 4096), (10, 131072))),
              ("13", "wrcq-13pl", ((5, 98304), (10, 4096), (10, 98304))))
P20_CHECK_SNR = {"89": 7.2, "23": 5.6, "12": 3.9, "13": 1.4}
P20_T89_SNR, P20_T89_CAP = 9.0, 2 ** 24
P20_DEEP = (("89", ("oms6", "rcq-pol", "wrcq-89-q4")), ("23", ("rcq-q5",)),
            ("12", ("rcq-q4",)), ("13", ("wrcq-13pl",)))
P20_DEEP_CAP, P20_TRAIN_SAMPLES, P20_LIMIT = 2 ** 18, 128, 200
# phase 21: the precoded-PBRL training programs' twins (ldpc_tpu_torch/cli/
# pbrl_wrcq.py, train_matched.py, pbrl_honest_train.py) at the programs'
# code (the precoded PBRL code, k=1032, rate 1/3, 25x37 base at lift 86, n
# = 3182, base column 0's 86 bits punctured), waves (32768), survivor
# budgets (4096; pbrl_honest_train's 8192) and error targets; only frame
# caps, training steps and validation frames are cut, each cut printed. K1
# is first held to its plain version at every (arm, iterations, batch) of
# P21_CHECKS, on LLRs drawn at P21_SNR with the 86 bits punctured: stage 1
# (T=5, B=32768), stage 2 (T=10, the budget) and the fallback's whole
# decode (T=10, B=32768); pbrl_honest_train's arms (ht/...) after their
# cut training, decoded with bv=8. (b) the two identities the programs
# rest on, at stage 2's shape; (c) pbrl_wrcq's P21_DEV arms at 2.0 dB to
# 100 errors and oms6 capped at P21_OMS_CAP frames (the program's 2e7),
# Fisher-tested against experiments/pbrl_honest_dev.json (the
# post-decision-bias-fix record; the pbrl_wrcq_dev*.json records are
# retracted); (d) pbrl_honest_train's five arms cut-trained, then its dev
# for oms6 and rcq-ref3 at 2.0 dB capped at P21_OMS_CAP frames (the
# program's 5e7; rcq-ref3 stops at its 100 errors first), against
# experiments/pbrl_honest_train_results.json; (e) train_matched's four
# arms cut-trained, then its dev for the designed (ref2) decoder at 2.0 dB
# against the honest record's rcq-ref2
P21_CHECKS = (("rcq-dde", ((5, 32768), (10, 4096), (10, 32768))),
              ("rcq-ref2", ((5, 32768), (10, 4096), (10, 32768))),
              ("rcq-ref4", ((5, 32768), (10, 4096), (10, 32768))),
              ("wrcq-ref3", ((5, 32768), (10, 4096))),
              ("wrcq-ref3pl", ((5, 32768), (10, 4096), (10, 32768))),
              ("ht/worcq", ((10, 8192),)),
              ("ht/wrcq", ((5, 32768), (10, 8192))),
              ("ht/worcq-pl", ((10, 8192),)),
              ("ht/rcq-ref3", ((10, 8192),)))
P21_DEV, P21_SNR = ("rcq-hand", "rcq-ref3it", "rcq-ref4"), 2.0
P21_OMS_CAP, P21_LIMIT = 2 ** 22, 150
# phase 22: the PBRL V2C/CN probe programs' twins (ldpc_tpu_torch/cli/
# pbrl_bv10.py, pbrl_cn_probe.py, pbrl_vqp_sweep.py, pbrl_vqp_gamma.py) on
# phase 21's code, waves (32768), budget (4096) and error target (100);
# only SNR points and frame caps are cut, each cut printed. K1 is first
# held to its plain version at every (arm, iterations, batch) of
# P22_CHECKS, on LLRs drawn at P22_SNR with the 86 bits punctured: the new
# V2C quantizers (uniform bv=12, M = 2047; power law gamma 2.0 and 1.5,
# the 128-entry table) and bc=5's closed form with CN_REF3 at stage 1 (T=5,
# B=32768), stage 2 (T=10, B=4096) and the fallback's whole decode (T=10,
# B=32768), the three CN ladders at stage 2. (b) the V2C-neutral
# identities on one stage-1 and one stage-2 wave: P22_REF3_CLASS's nine
# bc=4 CN_REF3 arms decode as pbrl_wrcq's rcq-ref3, bc5_vr96 as bc5_bv10.
# (c) each twin's main at P22_SNR capped at P22_CAP frames (the programs'
# 2e7), 2.4 dB kept for one arm of the rcq-ref3 class (P22_BOTH): the
# rcq-ref3 class Fisher-tested against experiments/pbrl_honest_dev.json's
# rcq-ref3, the four other decoders against
# ldpc_tpu_torch/cli/pbrl_probe_reference.json (tests/
# jax_reference_probes.py, the JAX package on the CPU); the programs'
# committed records predate the decision-bias fix and are printed, marked
# retracted, never tested
P22_CHECKS = (("pbrl_bv10/bc4_bv12", ((5, 32768), (10, 4096), (10, 32768))),
              ("pbrl_bv10/bc5_bv10", ((5, 32768), (10, 4096), (10, 32768))),
              ("pbrl_vqp_gamma/bc4_g2.0_C300",
               ((5, 32768), (10, 4096), (10, 32768))),
              ("pbrl_vqp_gamma/bc4_g1.5_ref3C",
               ((5, 32768), (10, 4096), (10, 32768))),
              ("pbrl_cn_probe/cn_8.5-16-16", ((10, 4096),)),
              ("pbrl_cn_probe/cn_6-12-12", ((10, 4096),)),
              ("pbrl_cn_probe/cn_8.5-12-16", ((10, 4096),)))
P22_REF3_CLASS = ("pbrl_bv10/bc4_bv10", "pbrl_bv10/bc4_bv12",
                  "pbrl_vqp_sweep/bc4_vr48", "pbrl_vqp_sweep/bc4_vr96",
                  "pbrl_vqp_sweep/bc4_vr192", "pbrl_vqp_sweep/bc4_vref3",
                  "pbrl_vqp_gamma/bc4_g1.5_C300",
                  "pbrl_vqp_gamma/bc4_g2.0_C300",
                  "pbrl_vqp_gamma/bc4_g1.5_ref3C")
P22_BC5_CLASS = ("pbrl_bv10/bc5_bv10", "pbrl_vqp_sweep/bc5_vr96")
P22_BOTH, P22_SNR, P22_HI = "pbrl_bv10/bc4_bv12", 2.0, 2.4
P22_CAP, P22_LIMIT = 2 ** 21, 120
P22_WAVE, P22_BUDGET = 32768, 4096
P22_WAVES = ((5, P22_WAVE), (10, P22_BUDGET))   # (b)'s two waves
P22_REFERENCE = "ldpc_tpu_torch/cli/pbrl_probe_reference.json"
# a cut-trained arm: one step of P21_SAMPLES frames (the programs' 30
# epochs of 2048); every cut training's validation set cut to P_VAL frames
# (the trainer's 640), in phases 15, 16, 17 and 20 too
P21_SAMPLES, P_VAL = 128, 128
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


def closed_of(dec):
    """Whether ``dec``'s quantizers take their closed form wherever the
    ladder has (C, gamma) parameters: its spec's ``closed_qdq`` or its
    fused options' (``experiments/pbrl_bc5.py:65`` sets the option)."""
    return bool(dec.spec.closed_qdq or
                (dec.qc_options or {}).get("closed_qdq"))


def kernel_on(x, dec, T_, lean, flooding=False):
    """The fused decode's wrapper (the CUDA kernel for a CUDA tensor), with
    the decoder's ``closed_qdq``."""
    import ldpc_tpu_torch as lt
    fn = (lt.qc_fused_decode_batch if flooding
          else lt.qc_fused_decode_batch_layered)
    return fn(x, dec.weights, qc=dec.qc, spec=dec.spec, max_iterations=T_,
              dtype=x.dtype, lean=lean, closed_qdq=closed_of(dec))


def plain_on(x, dec, T_, lean, flooding=False):
    """The plain PyTorch version of the fused decode on ``x``'s device."""
    from ldpc_tpu_torch.decode import fused
    fn = (fused._fused_flooding_plain if flooding
          else fused._fused_layered_plain)
    return fn(x, dec.weights, qc=dec.qc, spec=dec.spec, max_iterations=T_,
              dtype=x.dtype, lean=lean, closed_qdq=closed_of(dec))


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


def edge_ops(spec, flooding, closed=False):
    """float32 operations of the layered (K1) or flooding (K4) decode
    function per iteration: (per edge, per c2v computed), the quantizers
    in the form ``closed`` (the ``closed_qdq`` option) routes them to. A
    transcendental counts as one, per-iteration constants are not counted
    (:func:`qdq_ops`). The c2v transform, CN quantizer and rounding are
    counted once per c2v the function must compute (:func:`c2v_computed`):
    a check of a row whose blocks share (beta, alpha) sends at most four
    distinct values. What a kernel's design adds (K4's second c2v from its
    compressed state, the TPU layered kernel's second v2c per edge for
    its sign) is not counted."""
    from ldpc_tpu_torch.decode.engine import qdq_mode

    def q_ops(qparams, levels):
        return qdq_ops(qdq_mode(qparams, levels, closed or spec.closed_qdq),
                       levels)

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


def shared_pairs(dec):
    """{(iteration, base row): whether the row's blocks share (beta, alpha)
    bit for bit at that iteration}: where they do, K1 and K5 send each
    check's c2v from min1 or min2 (four values); elsewhere they take the
    per-block route and compute each c2v."""
    from ldpc_tpu_torch.decode import engine
    qc = dec.qc
    tabs = engine._tables(dec.weights, dec.spec, dec.max_iterations,
                          qc.num_blocks, dec.device)
    beta, alpha = tabs["beta"].cpu(), tabs["alpha"].cpu()
    return {(t, i): all(len(torch.unique(w[t, [int(b) for b in blocks]]
                                         .view(torch.int32))) == 1
                        for w in (beta, alpha))
            for t in range(dec.max_iterations)
            for i, blocks in enumerate(qc.row_blocks)}


def c2v_computed(dec, T_, rows=None):
    """c2v values per lifted check the decode function must compute,
    summed over iterations 0..T_-1 and the base rows (all, or ``rows``):
    min(4, dc) on a row whose blocks share (beta, alpha) at the iteration
    bit for bit (c2v(+-1, min1 or min2)), dc on any other."""
    qc = dec.qc
    shared = shared_pairs(dec)
    total = 0
    for t in range(T_):
        for i in (range(qc.mb) if rows is None else rows):
            dc = len(qc.row_blocks[i])
            total += min(4, dc) if shared[t, i] else dc
    return total


def bound(dec, B, T_, flooding, lean=True, elt=2):
    """(bound_ms, bound_by) of one fused decode of B frames, T_ iterations:
    LLRs in and bits (lean) or posterior out once, success flags out."""
    n, L = dec.code.n, dec.qc.lift
    E = dec.qc.num_blocks * L
    nbytes = B * n * (elt + (1 if lean else elt)) + B
    per_edge, send = edge_ops(dec.spec, flooding, closed_of(dec))
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


def instance_facts(label, inst, ctas):
    """One line on a kernel instance (a prefix of its mangled name): its
    registers and spills (the build's ptxas report) and its resident CTAs
    per SM."""
    from ldpc_tpu_torch.decode import _build
    stats = ptxas_stats(_build.library_path().with_suffix(".log"))
    st = next((v for k, v in stats.items() if inst in k), {})
    return (f"  {label}: {st.get('registers')} registers, spill "
            f"stores/loads {st.get('spills')} B, {ctas} resident CTAs per SM")


def kernel_facts(key, ctas):
    """One line on the bf16 instance of a row/column kernel that the main
    path runs."""
    inst = {"qc_cn": "qc_cn_kernelI13__nv_bfloat16Li4ELb1E",
            "qc_vn": "qc_vn_kernelI13__nv_bfloat16Li5E"}[key]
    what = {"qc_vn": ", dv=5", "qc_cn": ", orcq, dc <= 64"}[key]
    return instance_facts(f"{key} (bf16{what})", inst, ctas)


def k1_facts(dec, card):
    """K1's registers and spills (the bf16 instance of the decoder's kind,
    lift class and check-state placement), shared memory per CTA and
    resident CTAs per SM at ``dec``'s shape, with the placement the
    wrapper takes: the check state on chip where it fits the card's
    shared memory, else in the per-frame device scratch."""
    from ldpc_tpu_torch.decode import _build, fused
    from ldpc_tpu_torch.decode.engine import qdq_mode
    qc, spec = dec.qc, dec.spec
    lib = _build.load_library()
    sizes = (qc.nb, qc.mb, qc.num_blocks, qc.lift,
             max(len(r) for r in qc.row_blocks), 1)
    closed = closed_of(dec)
    modes = (fused._QMODES[qdq_mode(spec.qparams, spec.q_levels, closed)],
             spec.q_levels,
             fused._QMODES[qdq_mode(spec.v2c_qparams, spec.v2c_levels,
                                    closed)],
             spec.v2c_levels)
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    onchip = int(lib.ldpc_fused_layered_smem(*sizes, *modes, 1) <= limit)
    ctas = lib.ldpc_fused_layered_occupancy(*sizes, fused._KINDS[spec.kind],
                                            *modes, onchip)
    kind, L = fused._KINDS[spec.kind], qc.lift
    maxt = 768 if L <= 768 else 1024
    inst = (f"fused_layered_kernelI13__nv_bfloat16Li{kind}ELi{maxt}"
            f"ELb{onchip}ELb{int(L > 1024)}E")
    return (instance_facts(
        f"fused_layered (bf16, {spec.kind}, L={L}, MAXT={maxt}, state "
        f"{'on chip' if onchip else 'in device scratch'})", inst, ctas) +
        f", {lib.ldpc_fused_layered_smem(*sizes, *modes, onchip)} B of "
        f"shared memory per CTA, {min(L, 1024)} threads per CTA  [{card}]")


def k4_facts(dec, card):
    """K4's registers and spills (the bf16 instance of the decoder's kind
    and lift class), shared memory per CTA and resident CTAs per SM at
    ``dec``'s shape."""
    from ldpc_tpu_torch.decode import _build, fused
    from ldpc_tpu_torch.decode.engine import qdq_mode
    spec, qc = dec.spec, dec.qc
    lib = _build.load_library()
    sizes = (qc.nb, qc.mb, qc.num_blocks, qc.lift, 1)
    modes = (fused._QMODES[qdq_mode(spec.qparams, spec.q_levels)],
             spec.q_levels,
             fused._QMODES[qdq_mode(spec.v2c_qparams, spec.v2c_levels)],
             spec.v2c_levels)
    kind, L = fused._KINDS[spec.kind], qc.lift
    ctas = lib.ldpc_fused_flooding_occupancy(*sizes, kind, *modes)
    maxt = 768 if L <= 768 else 1024
    inst = (f"fused_flooding_kernelI13__nv_bfloat16Li{kind}ELi{maxt}"
            f"ELb{int(L > 1024)}E")
    return (instance_facts(f"fused_flooding (bf16, {spec.kind}, L={L}, "
                           f"MAXT={maxt})", inst, ctas) +
            f", {lib.ldpc_fused_flooding_smem(*sizes, *modes)} B of shared "
            f"memory per CTA  [{card}]")


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
            # one timed decode at B=32768 (cut for the time limit)
            ms = time_ms(lambda: d(x_), 3 if B_ == PB_B else 1)
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
        # torch.profiler counts the launches of a layered step in a worker
        # process beside phase 13 (:func:`layered_step_launches`, a count
        # its neighbours there do not change); tracing the flooding step's
        # ~270,600 launches took ~50 s of the script's time on an H100
        launches = "(counted beside phase 13)" if name == "layered" \
            else None
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
              f" s")
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
    # decoder; TR_SINGLE norms recomputed one frame at a time
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
    for i in range(TR_SINGLE):
        w = {k: v.clone().requires_grad_(True)
             for k, v in decs["flooding"].weights.items()}
        loss, _ = lt.posterior_joint_loss(
            w, llr[i:i + 1], torch.zeros_like(llr[i:i + 1]),
            decoder=decs["flooding"], joint=True)
        gs = torch.autograd.grad(loss, list(w.values()))
        single.append(float(torch.sqrt(sum((g ** 2).sum() for g in gs))))
    rel = np.abs(joint[:TR_SINGLE] - single) / np.abs(single)
    print(f"  analyzer (vmap) {TR_ANALYZE}: {a_secs:.2f} s (joint and "
          f"final-only); joint mean {res['posterior_joint']['mean']:.4g}, "
          f"max {res['posterior_joint']['max']:.4g}; final-only mean "
          f"{res['final_only']['mean']:.4g}, max "
          f"{res['final_only']['max']:.4g}; frames 0-{TR_SINGLE - 1} one at "
          f"a time "
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


@contextlib.contextmanager
def val_cut(frames=P_VAL):
    """``PosteriorJointTrainer.train`` with at most ``frames`` validation
    frames while open (the trainer's default 640; the programs pass none):
    a depth cut, printed by the caller."""
    import ldpc_tpu_torch as lt
    real = lt.PosteriorJointTrainer.train

    def train(self, num_samples=3200, val_samples=640, verbose=True):
        return real(self, num_samples, min(val_samples, frames), verbose)

    lt.PosteriorJointTrainer.train = train
    try:
        yield
    finally:
        lt.PosteriorJointTrainer.train = real


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


def phase12_floor(dev, card):
    """(c) Both arms of the importance-sampled floor at 3.6 dB through K1,
    by ``cli/floor_is``: its arms, trapping-set search, class choice and
    estimates; returns the random arm's decoder, an exemplar, the
    estimates, the IS batches and K1's largest posterior difference."""
    from ldpc_tpu_torch.cli import floor_is
    from ldpc_tpu_torch.sim import biased_awgn_llr

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "experiments", "floor_is_results.json")) as f:
        ref = json.load(f)
    snr = str(FLOOR_SNR)
    estimates, keep, batches, k1_err = {}, None, 0, 0.0
    for arm_i, (name, precode) in enumerate(floor_is.ARMS):
        arm = floor_is.arm(name, precode, device=dev)
        dec, punct, classes = arm.decoder, arm.punctured, arm.classes
        jref = ref[name]["classes"][snr]
        print(f"  (c) floor_is {name} arm: PBRL QC ({dec.code.n}, "
              f"{dec.qc.lift}-lift {dec.qc.mb}x{dec.qc.nb} base), RCQ bc=4 "
              f"6-11-16, layered T=10, K1 bf16; trapping sets "
              f"{arm.search_s:.1f} s on the host; classes "
              f"{[(ab, arm.mult[ab]) for ab in classes]}")
        if [f"{a},{b}" for a, b in classes] != list(jref) or any(
                arm.mult[ab] != jref[f"{ab[0]},{ab[1]}"]["multiplicity"]
                for ab in classes):
            raise AssertionError(f"{name}: classes or multiplicities differ "
                                 "from floor_is_results.json")
        # K1 on this decoder against its plain version first
        ts0 = arm.chosen[classes[0]][0]
        x, _ = biased_awgn_llr(torch.Generator(device=dev).manual_seed(
            arm_i), 256, dec.code.n, FLOOR_SNR, ts0.variables, FLOOR_SHIFT,
            punctured=punct)
        errs = uncounted(lambda: [compare(f"floor {name}", dec, x, dtype,
                                          False)
                                  for dtype in (torch.float32,
                                                torch.bfloat16)])
        k1_err = max([k1_err] + errs)
        if name == "random":
            print(k1_facts(dec, card))
            # K1 against its plain version at an IS batch's shape (bf16)
            xb, _ = biased_awgn_llr(torch.Generator(device=dev).manual_seed(
                9), floor_is.BATCH, dec.code.n, FLOOR_SNR, ts0.variables,
                FLOOR_SHIFT)
            xb = xb.to(torch.bfloat16)
            k_ms = uncounted(lambda: [time_ms(lambda: kernel_on(
                xb, dec, 10, False), 20) for _ in range(2)])
            p_ms = time_ms(lambda: plain_on(xb, dec, 10, False), 1)
            b_ms, b_by = bound(dec, floor_is.BATCH, 10, flooding=False,
                               lean=False)
            print(f"  K1 on this decoder, B={floor_is.BATCH} T=10 bf16: "
                  f"{k_ms[0]:.4f} / {k_ms[1]:.4f} ms, plain {p_ms:.2f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by})  [{card}]")
        checked = CheckedDecoder(dec, punct)
        t0 = time.perf_counter()
        got = floor_is.estimate_arm(
            dataclasses.replace(arm, decoder=checked), arm_i, (FLOOR_SNR,),
            FLOOR_SAMPLES, shift=FLOOR_SHIFT, verbose=False)
        secs = time.perf_counter() - t0
        for ab in classes:
            key = f"{ab[0]},{ab[1]}"
            for i, ((p, rel), (pj, relj)) in enumerate(zip(
                    got["classes"][snr][key]["exemplars"],
                    jref[key]["exemplars"])):
                held = rel < 0.5 and relj < 0.5
                if held and abs(np.log(p / pj)) > 4 * np.hypot(rel, relj):
                    raise AssertionError(f"{name} {ab} exemplar {i}: p "
                                         f"{p:.3e} (rel {rel:.2f}) vs the "
                                         f"JAX package's {pj:.3e} "
                                         f"({relj:.2f})")
                print(f"    {ab} exemplar {i}: p {p:.4g} (rel_std {rel:.3g})"
                      f", JAX {pj:.4g} ({relj:.3g}) "
                      f"{'held' if held else 'printed only'}")
                estimates[f"{name} {key} {i}"] = (p, rel)
            if keep is None:
                keep = (dec, arm.chosen[ab][0], punct)
        batches += checked.batches
        punct_note = ("punctured LLRs zero in every batch" if punct else
                      "no puncturing")
        print(f"  {name} arm at {FLOOR_SNR} dB: union-bound floor "
              f"{got['floor'][snr]:.4g} (floor_is_results.json "
              f"{ref[name]['floor'][snr]:.4g}); {checked.batches} IS batches "
              f"of {floor_is.BATCH} ({punct_note}), {secs:.1f} s, "
              f"{checked.batches * floor_is.BATCH / secs:.1f} frames/s  "
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
    from ldpc_tpu_torch.cli.floor_is import BATCH
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
        llr, _ = biased_awgn_llr(gen, BATCH, fdec.code.n, FLOOR_SNR,
                                 ts.variables, FLOOR_SHIFT)
        return fdec(llr)

    rate = measure_throughput(is_batch, reps=8) * BATCH
    tc = ThroughputCounter()
    for _ in range(8):
        tc.start()
        is_batch()
        tc.stop(BATCH)
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
          f"IS batches (B={BATCH}, T=10) measure_throughput "
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


def spectrum_data():
    """``cli/trapping_spectrum``'s report, whole, and its host seconds.
    Runs in a worker process."""
    import tempfile

    from ldpc_tpu_torch.cli import trapping_spectrum
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        rep = trapping_spectrum.main(os.path.join(tmp, "spectrum.json"),
                                     verbose=False)
    return rep, time.perf_counter() - t0


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
    process beside the ``examples`` process, each timed; a failure raises.
    They write under ``tmp``."""
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


def phase13(dev, card, dec, wave_ms, de, beside):
    """Parallel and the CLI twins; returns the mesh path's launches. The
    ``examples`` process runs from the phase's start; ``beside()`` is
    called once (a), the phase's timed part, is done, to start other work
    beside (b) and (c), which time nothing they claim."""
    import re
    import tempfile

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        # the examples from the phase's start, beside (a) too: its ≈ 43 s
        # design scenario is host numpy, and (a) times its three programs
        # in turns
        t0 = time.perf_counter()
        ex = subprocess.Popen(
            [sys.executable, "-m", "ldpc_tpu_torch.cli.examples",
             "--device", dev.type], cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=root))
        try:
            counts = phase13_nccl(dev, card, dec, wave_ms)
            torch.cuda.empty_cache()
            beside()
            phase13_gloo(dev, card, dec)
            torch.cuda.empty_cache()
            # the other CLIs beside the examples' last ≈ 25 s (its design
            # scenario is ≈ 43 s of host numpy): they time nothing they
            # claim
            with tempfile.TemporaryDirectory(dir=root) as tmp_cli:
                phase13_cli(dev, card, de, tmp_cli)
            out = ex.communicate(timeout=900)[0]
        finally:
            if ex.poll() is None:
                ex.kill()
                ex.wait()
        done = dict(re.findall(r"^\[(\w+)\] done in ([\d.]+)s", out, re.M))
        print(f"  (c) python -m ldpc_tpu_torch.cli.examples (every "
              f"scenario, beside (a), (b) and the other CLIs): rc "
              f"{ex.returncode}, {time.perf_counter() - t0:.1f} s; seconds "
              f"by scenario {done}")
        if ex.returncode != 0 or len(done) != 16:
            raise AssertionError(f"examples failed:\n{out[-4000:]}")
    print(f"  launches of the mesh path in (a): {counts}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts


def phase14_bench(card, root):
    """(a) The bench twin as users run it, in a process of its own: its
    last line is ``bench.py``'s metric line (the metric name read from
    ``bench.py``), with a rate above 0, no frame error on phase 4's three
    LLR sets and every wave's survivors within the budget."""
    import re
    with open(os.path.join(root, "bench.py")) as f:
        metric = re.search(r'"metric": "(\w+)"', f.read()).group(1)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "ldpc_tpu_torch.cli.bench"],
                       cwd=root, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, PYTHONPATH=root))
    lines = r.stdout.strip().splitlines()
    if r.returncode != 0 or len(lines) < 3:
        raise AssertionError(f"the bench twin failed (rc {r.returncode}):\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    line, stats = json.loads(lines[-1]), json.loads(lines[-2])
    if set(line) != {"metric", "value", "unit", "vs_baseline"} or \
            line["metric"] != metric or \
            line["unit"] != "codewords/sec/chip" or not line["value"] > 0:
        raise AssertionError(f"the bench twin's last line: {lines[-1]}")
    if any(stats["frame_errors_per_set"]) or stats["max_survivors"] > S:
        raise AssertionError(f"the bench twin's waves: {lines[-2]}")
    print(f"  (a) python -m ldpc_tpu_torch.cli.bench: rc 0, "
          f"{time.perf_counter() - t0:.1f} s; {lines[-3]}; {lines[-2]}")
    print(f"  (a) its last line: {lines[-1]}  [{card}]")


def phase14_matrix(dev, card, tmp):
    """(b) The matrix twin at the JAX program's batches, one entry a call
    of its ``run`` (the two engine entries in one, for their ratio): each
    fused entry launches its kernel exactly once a decode, its first
    P14_FRAMES frames go through the kernel and the plain version bit for
    bit in f32 and bf16, and its kernel is timed alone against the plain
    version and the bound. Returns the launches and the largest posterior
    differences measured before the checks."""
    from ldpc_tpu_torch.cli import throughput_matrix as tm

    entries = tm.matrix_decoders(dev)
    engines = {k: entries.pop(k) for k in tm.ENGINE_ENTRIES}
    out = dict(K1=0, K4=0, k1_err=0.0, k4_err=0.0)
    want = 2 + 3 * P14_REPS
    for name, entry in list(entries.items()) + [("engines", engines)]:
        group = engines if name == "engines" else {name: entry}
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        res = tm.run(reps=P14_REPS, out_path=os.path.join(
            tmp, f"{name}.json"), verbose=False, device=dev, entries=group)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for key, (dec, B, snr) in group.items():
            llr = tm.make_llr(dec, B, snr)
            wrong = uncounted(lambda: dec(llr).bits.ne(0))
            fe, ber = int(wrong.any(dim=1).sum()), wrong.float().mean().item()
            raw = (llr < 0).float().mean().item()
            del wrong
            cw = res[key]["cw_per_sec"]
            print(f"  (b) {key}: {cw:.1f} cw/s, a decode "
                  f"{1e3 * B / cw:.3f} ms (B={B}, n={dec.code.n}, {snr} dB, "
                  f"LLRs {llr.numel() * 4 / 1e6:.1f} MB, peak "
                  f"{peak:.3f} GiB), frame errors {fe} of {B}, BER "
                  f"{ber:.3g} (channel {raw:.3g})  [{card}]")
            if not ber < raw:
                raise AssertionError(f"{key}: the decode leaves BER {ber} "
                                     f"of the channel's {raw}")
            if name == "engines":
                continue
            flooding = not dec.layered
            kid = "K4" if flooding else "K1"
            if counts[kid] != want or sum(counts.values()) != want:
                raise AssertionError(f"{key}: launches {counts}, want {want} "
                                     f"of {kid}")
            out[kid] += counts[kid]
            err = uncounted(lambda: max(
                compare(key, dec, llr[:P14_FRAMES], dt, False, flooding)
                for dt in (torch.float32, torch.bfloat16)))
            out[f"{kid.lower()}_err"] = max(out[f"{kid.lower()}_err"], err)
            x = llr.to(torch.bfloat16)
            T_ = dec.max_iterations
            kern = lambda: kernel_on(x, dec, T_, False, flooding)
            plain = lambda: plain_on(x, dec, T_, False, flooding)
            k_ms, p_ms, k2_ms = uncounted(lambda: (
                time_ms(kern, 5), time_ms(plain, 1), time_ms(kern, 5)))
            b_ms, b_by = bound(dec, B, T_, flooding, lean=False)
            print(f"  (b) {key}: {kid} {counts[kid]} launches; kernel alone "
                  f"(bf16, full) {k_ms:.3f} / {k2_ms:.3f} ms, plain "
                  f"{p_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by}), "
                  f"{100 * b_ms / min(k_ms, k2_ms):.1f}% of the bound  "
                  f"[{card}]")
            print(k4_facts(dec, card) if flooding else k1_facts(dec, card))
            del x
        if name == "engines":
            if sum(counts.values()):
                raise AssertionError(f"the engine entries launched {counts}")
            print(f"  (b) bucketed speedup {res['bucketed_speedup']}x  "
                  f"[{card}]")
        del llr
        torch.cuda.empty_cache()
    return out


def phase14_ee(dev, card, tmp):
    """(c) The batch study: each (B, S) point timed with 2 K1 launches a
    wave and no overflow at 7.0 dB. Returns K1's launches."""
    from ldpc_tpu_torch.cli import bench, ee_batch

    reset_counts()
    t0 = time.perf_counter()
    res = ee_batch.run(dev, ee_batch.POINTS,
                       out_path=os.path.join(tmp, "ee_batch.json"))
    counts = read_counts()
    waves = len(ee_batch.POINTS) * (bench.WARMUP + bench.TRIALS * bench.REPS)
    if len(res) != len(ee_batch.POINTS) or counts["K1"] != 2 * waves or \
            counts["K4"] or counts["K5"] or counts["K6"]:
        raise AssertionError(f"the batch study: {res}, launches {counts}")
    print(f"  (c) the batch study: {len(res)} points, "
          f"{time.perf_counter() - t0:.1f} s, K1 launches {counts['K1']}; "
          + ", ".join(f"{k} {v:.1f} cw/s" for k, v in res.items())
          + f"  [{card}]")
    return counts["K1"]


def phase14(dev, card):
    """The throughput programs' twins; returns their K1 and K4 launches
    in this process and the largest posterior differences."""
    import tempfile

    print("[14 throughput twins]")
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    phase14_bench(card, root)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        out = phase14_matrix(dev, card, tmp)
        torch.cuda.empty_cache()
        out["K1"] += phase14_ee(dev, card, tmp)
    print(f"  launches in phase 14: K1 {out['K1']}, K4 {out['K4']}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return out


def jax_points(curve):
    """{SNR to 0.01 dB: (frame errors, frames)} of a committed JAX curve."""
    return {round(s, 2): (e, f) for s, e, f in zip(
        curve["snr_values"], curve["total_errors"], curve["total_frames"])}


def fisher_p(errors, frames, ref_errors, ref_frames):
    """Two-sided p of Fisher's exact test that two FER points (frame
    errors in frames) share one FER: the probability, under the
    hypergeometric law of the 2x2 table's margins, of every table no more
    likely than this one (relative tolerance 1e-7), as
    ``scipy.stats.fisher_exact`` computes it, in numpy alone: scipy's
    array-API layer trips over this script's ``jax`` sentinel."""
    a, n1, n2 = errors, frames, ref_frames
    k = errors + ref_errors
    lo, hi = max(0, k - n2), min(k, n1)
    x = np.arange(lo, hi, dtype=np.float64)
    # log P(x + 1) - log P(x), summed from the lowest table up
    step = (np.log((k - x) * (n1 - x)) -
            np.log((x + 1) * (n2 - k + x + 1)))
    logp = np.concatenate([[0.0], np.cumsum(step)])
    p = np.exp(logp - logp.max())
    p /= p.sum()
    return float(min(1.0, p[p <= p[a - lo] * (1 + 1e-7)].sum()))


class FisherBook:
    """Each SNR point of the port against the JAX record's: the lines,
    and the points whose two-sided Fisher p falls below P15_P."""

    def __init__(self, card):
        self.card, self.failed, self.tested = card, [], 0

    def curves(self, tag, results, record, test=True, extra=None,
               why="cut-trained here"):
        """Print every point of ``results`` ({name: SimulationResult})
        beside ``record`` ({name: JAX curve dict}); Fisher-test them when
        ``test``, else say ``why`` not. ``extra(name, i)`` adds to a
        point's line."""
        for name, r in results.items():
            ref = jax_points(record[name])
            for i, snr in enumerate(r.snr_values):
                e, f = r.total_errors[i], r.total_frames[i]
                je, jf = ref.get(round(snr, 2), (None, None))
                line = (f"  ({tag}) {name} @ {snr:.2f} dB: {e}/{f} "
                        f"(FER {e / f:.4g}), JAX {je}/{jf}")
                if je is None:
                    raise AssertionError(f"no JAX point for {name} @ {snr}")
                if test and min(je, jf - je) >= P15_MIN:
                    p = fisher_p(e, f, je, jf)
                    self.tested += 1
                    line += f", Fisher p {p:.3g}"
                    if p < P15_P:
                        self.failed.append(f"{name} @ {snr:.2f} dB: p {p:.3g}")
                else:
                    line += (f", not tested ({why})" if not test
                             else f", not tested (JAX {je} errors)")
                if extra is not None:
                    line += extra(name, i)
                print(line + f"  [{self.card}]")


def phase15_kernels(dev, card, decs):
    """K1 and K4 against their plain versions at each deep-FER spec and
    both depths of its compaction ({t1, T}) at P15_CHECK_SNR in bf16 with
    the full output (comparison launches, not counted): stage 2 on the
    2048-frame survivor budget, stage 1 on the 32768-frame wave at the
    P15_WAVE_CHECK specs and on P14_FRAMES frames at the others. Each
    depth is timed at the campaign's shape against its bound. Returns the
    largest posterior differences and {(name, T): kernel ms}."""
    import ldpc_tpu_torch as lt

    gen = torch.Generator(device=dev).manual_seed(15)
    wave, budget = P15_WAVE, max(64, P15_WAVE // 16)
    errs, times = dict(K1=0.0, K4=0.0), {}
    for name, (dec, t1) in decs.items():
        flooding = not dec.layered
        kid = "K4" if flooding else "K1"
        x = lt.awgn_llr(gen, torch.zeros((wave, dec.code.n), device=dev),
                        P15_CHECK_SNR).to(torch.bfloat16)
        short = dataclasses.replace(dec, qc_options=None).truncated(t1)
        for d, B_ in ((short, wave), (dec, budget)):
            T_ = d.max_iterations
            xb = x[:B_]
            xc = xb if d is dec or name in P15_WAVE_CHECK else \
                x[:P14_FRAMES]
            out = uncounted(lambda: kernel_on(xc, d, T_, False, flooding))
            ref = plain_on(xc, d, T_, False, flooding)
            errs[kid] = max(errs[kid], agree(f"{name} T={T_}", out, ref,
                                             torch.bfloat16))
            del out, ref
            torch.cuda.empty_cache()
            k_ms = uncounted(lambda: time_ms(
                lambda: kernel_on(xb, d, T_, False, flooding), 5))
            b_ms, b_by = bound(d, B_, T_, flooding, lean=False)
            times[(name, T_)] = k_ms
            print(f"  {kid} {name} B={B_} T={T_} (bf16, full): {k_ms:.3f} "
                  f"ms, bound {b_ms:.3f} ms ({b_by}), "
                  f"{100 * b_ms / k_ms:.1f}% of the bound  [{card}]")
        print(k4_facts(dec, card) if flooding else k1_facts(dec, card))
        del x, xb, xc
    return errs, times


def phase15_deep(dev, card, book, record, zoo, times):
    """(a), (b): each deep-FER decoder of ``zoo`` ({name: (decoder, t1,
    SNRs, program)}) swept over its SNRs by the twin's ``sweep`` under the
    campaign's configuration, only the kernels launching; returns the
    launches."""
    from ldpc_tpu_torch.cli import deep_fer

    print(f"  (a, b) cut: SNRs {dict((k, v[2]) for k, v in zoo.items())} "
          f"of 6.4-6.7 dB; frame cap {P15_CAP:,} (the programs' "
          f"50,000,000); waves {P15_WAVE}, budget "
          f"{max(64, P15_WAVE // 16)}, 100 errors")
    t0 = time.perf_counter()
    reset_counts()
    deep, kinds, want = {}, {}, dict(K1=0, K4=0, K5=0, K6=0)
    for name, (dec, t1, snrs, _) in zoo.items():
        cfg = deep_fer.campaign_config(t1, P15_CAP, wave=P15_WAVE,
                                       snr_lo=min(snrs), snr_hi=max(snrs),
                                       device=dev)
        res, sim = deep_fer.sweep({name: dec}, cfg, checkpoints=None,
                                  verbose=False)
        if list(res) != [name] or [round(x, 2) for x in
                                   res[name].snr_values] != list(snrs):
            raise AssertionError(f"{name}: curves {res}")
        deep[name], kinds[name] = res[name], sim.wave_kinds[name]
        # a compacted wave launches stage 1 and stage 2, a fallback both
        # again on the whole wave
        want["K1" if dec.layered else "K4"] += sum(
            2 * k.get("compacted", 0) + 4 * k.get("fallback", 0)
            for k in kinds[name])
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != want or not (want["K1"] and want["K4"]):
        raise AssertionError(f"deep-FER launches {counts}, want {want}")

    def rate(name, i):
        r = deep[name]
        return (f", {r.total_frames[i] / r.simulation_times[i]:.1f} "
                f"frames/s ({r.simulation_times[i]:.2f} s), avg iterations "
                f"{r.average_iterations[i]:.4f}, waves {kinds[name][i]}")

    for name, (_, _, _, prog) in zoo.items():
        curves = record[prog].get("curves") or {name: record[prog]["curve"]}
        book.curves("a" if prog == "deep_fer" else "b", {name: deep[name]},
                    curves, extra=rate)
    print(f"  (a) RCQ-bc3-L6 floor verdict over 6.4-6.6 dB: "
          f"{deep_fer.floor_verdict(deep['RCQ-bc3-L6'])}")
    n_comp = sum(k.get("compacted", 0) for v in kinds.values() for k in v)
    n_fall = sum(k.get("fallback", 0) for v in kinds.values() for k in v)
    print(f"  (a, b) {time.perf_counter() - t0:.1f} s; launches K1 "
          f"{counts['K1']}, K4 {counts['K4']}; waves compacted {n_comp}, "
          f"fallback {n_fall}")
    # where a compacted wave's time goes at 6.6 dB
    r, k = deep["RCQ-bc3-L6"], kinds["RCQ-bc3-L6"][-1]
    if set(k) == {"compacted"}:
        per = 1e3 * r.simulation_times[-1] / k["compacted"]
        st = [times[("RCQ-bc3-L6", T_)] for T_ in (3, 6)]
        print(f"  (a) RCQ-bc3-L6 @ {r.snr_values[-1]:.2f} dB: a compacted "
              f"wave {per:.3f} ms; K1 stage 1 {st[0]:.3f} ms + stage 2 "
              f"{st[1]:.3f} ms alone, the rest {per - sum(st):.3f} ms  "
              f"[{card}]")
    return counts


def phase15_accuracy(dev, card, book, record):
    """(c): the full dev sweep, ``train_pair`` cut to P15_TRAIN and the
    waterfall on P15_LADDER at P15_FRAMES frames a point, K4 launching
    once a wave and never while training; returns K4's launches."""
    from ldpc_tpu_torch.cli import accuracy_bc3 as acc
    from ldpc_tpu_torch.cli.fer_parity import gaps_report

    t0 = time.perf_counter()
    code, qc = acc.bench_code(P15_LIFT)
    reset_counts()
    best, dev_fers = acc.dev_sweep(code, qc, dev, verbose=False)
    c_dev = read_counts()
    jdev = record["accuracy_bc3"]["quantizer_ladder"]
    print("  (c) dev sweep at 6.4 dB, 16384 frames a ladder: " +
          ", ".join(f"{k} {v:.5f}" for k, v in dev_fers.items()) +
          f"; selected {best} (JAX {jdev['selected']}: " +
          ", ".join(f"{k} {v:.5f}" for k, v in jdev["dev_fers"].items()) +
          f"); the waterfall pins the JAX run's {P15_LADDER}")
    qp = acc.LADDERS[P15_LADDER]
    reset_counts()
    t1 = time.perf_counter()
    with val_cut():
        trained = acc.train_pair(code, qc, qp, dev, verbose=False,
                                 **P15_TRAIN)
    c_tr = read_counts()
    print(f"  (c) train_pair cut to {P15_TRAIN}, validation to {P_VAL} "
          f"frames (the trainer's 640): final losses " +
          ", ".join(f"{k} {v[1]:.5f}" for k, v in trained.items()) +
          f", {time.perf_counter() - t1:.1f} s  [{card}]")
    decs = acc.waterfall_decoders(code, qc, qp, trained, dev)
    reset_counts()
    fall = acc.waterfall(decs, P15_FRAMES, dev, verbose=False)
    c_fall = read_counts()
    if set(fall) != set(decs) or set(dev_fers) != set(acc.LADDERS):
        raise AssertionError(f"curves {list(fall)} of {list(decs)}, dev "
                             f"sweep {dev_fers}")
    waves = dict(K1=0, K4=sum(f // acc.waterfall_config(
        P15_FRAMES).wave_size for r in fall.values()
        for f in r.total_frames), K5=0, K6=0)
    cfg = acc.dev_config()
    if c_dev != dict(waves, K4=len(acc.LADDERS) * cfg.max_frames //
                     cfg.wave_size) or sum(c_tr.values()) or c_fall != waves:
        raise AssertionError(f"accuracy launches: dev sweep {c_dev}, "
                             f"training {c_tr}, waterfall {c_fall} "
                             f"({waves['K4']} waves)")
    jc = record["accuracy_bc3"]["curves"]
    untrained = {k: v for k, v in fall.items() if "trained" not in k}
    book.curves("c", untrained, jc)
    book.curves("c", {k: v for k, v in fall.items() if k not in untrained},
                jc, test=False)
    _, gaps = gaps_report(fall, 1e-2, verbose=False)
    print(f"  (c) gaps at FER 1e-2 {gaps} (JAX "
          f"{record['accuracy_bc3']['gaps_db']}); "
          f"{time.perf_counter() - t0:.1f} s, K4 launches "
          f"{c_dev['K4'] + c_fall['K4']}")
    return c_dev["K4"] + c_fall["K4"]


def phase15_parity(dev, book, record, tmp):
    """(d): the fer_parity twin at P15_FRAMES frames a point on the
    general engine, no kernel launching."""
    from ldpc_tpu_torch.cli import fer_parity
    from ldpc_tpu_torch.sim import SimulationResult

    t0 = time.perf_counter()
    reset_counts()
    rep = fer_parity.run(P15_FRAMES, os.path.join(tmp, "fer_parity.json"),
                         dev, verbose=False)
    counts = read_counts()
    jc = record["fer_parity"]["curves"]
    if sum(counts.values()) or set(rep["curves"]) != set(jc):
        raise AssertionError(f"fer_parity: launches {counts}, curves "
                             f"{list(rep['curves'])}")
    book.curves("d", {k: SimulationResult.from_dict(v)
                      for k, v in rep["curves"].items()}, jc)
    print(f"  (d) gaps at FER 1e-2 {rep['gaps_db']} (JAX "
          f"{record['fer_parity']['gaps_db']}); "
          f"{time.perf_counter() - t0:.1f} s")


def phase15(dev, card):
    """The FER campaign programs' twins at full width; returns their K1
    and K4 launches and the largest posterior differences."""
    import tempfile

    from ldpc_tpu_torch.cli import deep_fer
    from ldpc_tpu_torch.cli import deep_fer_trained_l6 as l6

    print("[15 FER campaign twins]")
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    record = {}
    for prog in ("deep_fer", "deep_fer_trained_l6", "accuracy_bc3",
                 "fer_parity"):
        with open(os.path.join(root, "experiments",
                               f"{prog}_results.json")) as f:
            record[prog] = json.load(f)
    decs = dict(deep_fer.layered_decoders(P15_LIFT, dev))
    decs["W-OMS-RCQ-bc3-trained"] = deep_fer.trained_flooding_decoder(
        lift=P15_LIFT, device=dev)
    zoo = {name: (decs[name], deep_fer.T1_LAYERED if decs[name].layered
                  else deep_fer.T1_FLOODING, snrs, "deep_fer")
           for name, snrs in P15_DEEP}
    zoo[l6.NAME] = (l6.trained_layered_decoder(lift=P15_LIFT, device=dev),
                    l6.T1, P15_L6_SNRS, "deep_fer_trained_l6")
    errs, times = phase15_kernels(dev, card, {
        name: (dec, t1) for name, (dec, t1, _, _) in zoo.items()})
    torch.cuda.empty_cache()
    book = FisherBook(card)
    counts = phase15_deep(dev, card, book, record, zoo, times)
    del zoo, decs
    torch.cuda.empty_cache()
    k4 = counts["K4"] + phase15_accuracy(dev, card, book, record)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        phase15_parity(dev, book, record, tmp)
    print(f"  {book.tested} points Fisher-tested against the JAX records; "
          f"launches in phase 15: K1 {counts['K1']}, K4 {k4}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if book.failed:
        raise AssertionError(f"points off the JAX records (p < {P15_P}): "
                             f"{book.failed}")
    return dict(K1=counts["K1"], K4=k4, k1_err=errs["K1"],
                k4_err=errs["K4"])


def stage_of(dec, T_):
    """``dec`` cut to ``T_`` iterations as the simulator's stage 1 cuts it
    (its options kept), or ``dec`` itself at its own depth."""
    if T_ == dec.max_iterations:
        return dec
    return dataclasses.replace(dataclasses.replace(
        dec, qc_options=None).truncated(T_), qc_options=dec.qc_options)


def phase16_check(dev, card, name, dec, T_, B_, lean, gen,
                  snr=P16_CHECK_SNR, punct=None):
    """K1 against its plain version at one spec phase 16 launches (not
    counted): ``dec`` truncated to ``T_`` iterations (a stage 1, its
    options kept) or whole, on ``B_`` frames at ``snr`` dB in bf16 (the
    ``punct`` positions' LLRs multiplied by zero, as the simulator's mask
    does), bit for bit (bits, success, iterations, the posterior's bit
    patterns where it is full); then the kernel timed at that shape
    against its bound, beside the plain version's one call. Returns (max
    |d posterior|, kernel ms)."""
    import ldpc_tpu_torch as lt

    d = stage_of(dec, T_)
    x = lt.awgn_llr(gen, torch.zeros((B_, dec.code.n), device=dev), snr)
    if punct is not None:
        x = lt.puncture_llr(x, punct)
    x = x.to(torch.bfloat16)
    out = uncounted(lambda: kernel_on(x, d, T_, lean))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain_on(x, d, T_, lean)
    torch.cuda.synchronize()
    p_ms = 1e3 * (time.perf_counter() - t0)
    err = agree(f"{name} T={T_}", out, ref, torch.bfloat16, lean)
    del out, ref
    k_ms = uncounted(lambda: time_ms(lambda: kernel_on(x, d, T_, lean), 5))
    b_ms, b_by = bound(d, B_, T_, flooding=False, lean=lean)
    print(f"  K1 {name} B={B_} T={T_} (bf16, {'lean' if lean else 'full'}): "
          f"{k_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
          f"{100 * b_ms / k_ms:.1f}% of the bound, plain {p_ms:.1f} ms (one "
          f"call)  [{card}]")
    return err, k_ms


def phase16_checks(dev, card, specs, gen, snr=P16_CHECK_SNR, punct=None):
    """:func:`phase16_check` at each ``(name, decoder, iterations, batch,
    lean)`` of ``specs``; returns (max |d posterior|, {(name, iterations,
    batch): kernel ms})."""
    err, ms = 0.0, {}
    for name, dec, T_, B_, lean in specs:
        e, ms[name, T_, B_] = phase16_check(dev, card, name, dec, T_, B_,
                                            lean, gen, snr, punct)
        err = max(err, e)
    return err, ms


def only_k1(what, counts, lo, hi=None):
    """Fail unless ``counts`` has no K4, K5 or K6 launch and K1's launches
    are ``lo`` (to ``hi`` where given)."""
    hi = lo if hi is None else hi
    if counts["K4"] or counts["K5"] or counts["K6"] or \
            not lo <= counts["K1"] <= hi:
        raise AssertionError(f"{what}: launches {counts}, want K1 in "
                             f"[{lo}, {hi}] and nothing else")


def phase16_ab_s(dev, card, tmp):
    """(a): K1 against its plain version at the bench wave's stage 1 and
    each budget's stage 2, the three budgets on the same two LLR sets
    (survivors within each budget, the same bits under each), then the
    twin's timed run; returns (K1's launches, max |d posterior|)."""
    from ldpc_tpu_torch.cli import bench, bench_ab_s

    t0 = time.perf_counter()
    dec = bench.bench_decoder(dev)
    fns = bench_ab_s.budget_decoders(dec)
    gen = torch.Generator(device=dev).manual_seed(15)
    err = phase16_checks(dev, card, [("bench", dec, bench_ab_s.T1, bench.B,
                                      True)] + [
        ("bench", dec, bench.T, S, True) for S in fns], gen)[0]
    llrs = bench.make_llrs(bench.B, dec.code.n, bench.SNR_DB,
                           torch.Generator(device=dev).manual_seed(0),
                           sets=bench_ab_s.SETS)
    reset_counts()
    surv = {S: [] for S in fns}
    for i, llr in enumerate(llrs):
        ref = None
        for S, fn in fns.items():
            out, n = fn(llr)
            surv[S].append(int(n))
            if ref is None:
                ref = out.bits
            elif not torch.equal(out.bits, ref):
                raise AssertionError(f"(a) set {i}: S={S} changes the bits")
        del ref, out
    if any(max(v) > S for S, v in surv.items()):
        raise AssertionError(f"(a) survivors {surv} overflow a budget")
    del llrs
    torch.cuda.empty_cache()
    rates = bench_ab_s.run(dev, os.path.join(tmp, "bench_ab_s.json"),
                           verbose=False)
    torch.cuda.synchronize()
    counts = read_counts()
    waves = len(fns) * bench_ab_s.SETS * 2 + \
        bench_ab_s.TRIALS * len(fns) * bench.REPS
    only_k1("(a)", counts, 2 * waves)
    print(f"  (a) bench_ab_s: B={bench.B} at {bench.SNR_DB} dB, t1="
          f"{bench_ab_s.T1}; survivors per set {surv}, every wave within "
          f"its budget; S = {', '.join(map(str, fns))} give the same bits "
          f"on both sets; best cw/s {rates}  [{card}]")
    print(f"  (a) {time.perf_counter() - t0:.1f} s, {waves} waves, K1 "
          f"launches {counts['K1']}")
    return counts["K1"], err


def phase16_ee(dev, card, tmp, record, book):
    """(b): K1 against its plain version at every shape the survey and
    the arms may launch, then the twin's run: the six survivor counts
    beside the JAX record (the t1=2 ones Fisher-tested), the arms the
    counts select and their rates, K1's launches held to the survey's and
    the arms' waves; returns (K1's launches, max |d posterior|)."""
    from ldpc_tpu_torch.cli import bench
    from ldpc_tpu_torch.cli import ee_trained as ee

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(16)
    decs = ee.decoders(dev)
    T_ = decs["plain"].max_iterations
    # the survey: each decoder's stage 1 at each t1 and stage 2 on the
    # survey budget's rows; every arm the rule can select (all of them
    # at zero counts): stage 1 at the arm's t1 and batch, stage 2 at its
    # budget
    survey = [f"survivors_{key}_t1={t1}_B8192" for key in decs
              for t1 in ee.T1S]
    specs = {(key, t1, ee.B) for key in decs for t1 in ee.T1S} | \
        {(key, T_, ee.SURVEY_BUDGET) for key in decs}
    for _, key, t1, S, B_ in ee.arms(dict.fromkeys(survey, 0)):
        specs |= {(key, t1, B_), (key, T_, S)}
    err = phase16_checks(dev, card, [(f"ee {key}", decs[key], t, B_, True)
                                     for key, t, B_ in sorted(specs)],
                         gen)[0]
    del decs
    torch.cuda.empty_cache()
    reset_counts()
    t1 = time.perf_counter()
    res = ee.run(dev, os.path.join(tmp, "ee_trained.json"), verbose=False)
    torch.cuda.synchronize()
    counts = read_counts()
    # two launches a wave: the survey's one wave at each t1 of each
    # decoder, each arm's warm-up and timed waves (an arm that overflowed
    # stopped after 1 to all of them)
    arms = ee.arms(res)
    per_arm = bench.WARMUP + bench.TRIALS * bench.REPS
    lo = hi = 2 * len(survey)
    for name, *_ in arms:
        lo += 2 * (1 if res[name]["cw_per_sec"] is None else per_arm)
        hi += 2 * per_arm
    only_k1("(b)", counts, lo, hi)
    jrec, jb = record["ee_trained"], 8192  # the record's batch
    for key in (k for k in jrec if k.startswith("survivors_")):
        got, want = res[key], jrec[key]
        line = f"  (b) {key}: {got}/{ee.B}, JAX {want}/{jb}"
        if key in P16_EE_TESTED:
            p = fisher_p(got, ee.B, want, jb)
            book.tested += 1
            line += f", Fisher p {p:.3g}"
            if p < P15_P:
                book.failed.append(f"{key}: p {p:.3g}")
        else:
            line += ", printed only"
        print(line + f"  [{card}]")
    print(f"  (b) the rule (t1=2 at S=1024 when <= {ee.T1_2_MAX}, t1=3 at "
          f"S=128 when <= {ee.T1_3_MAX}) selects {[a[0] for a in arms]} "
          f"(JAX: {[k for k in jrec if not k.startswith('survivors_')]})")
    for name, *_ in arms:
        r = res[name]
        rate = "OVERFLOW" if r["cw_per_sec"] is None else \
            f"{r['cw_per_sec']:.1f} cw/s"
        print(f"  (b) {name}: {rate}, largest survivor count "
              f"{r['max_survivors']}  [{card}]")
    print(f"  (b) {time.perf_counter() - t0:.1f} s (run "
          f"{time.perf_counter() - t1:.1f} s), K1 launches {counts['K1']}")
    return counts["K1"], err


def phase16_dde(dev, card, root, record, book):
    """(c): ``train`` cut to P16_TRAIN in one temporary directory (no
    launch), then ``deep``'s arms in another (so the zoo's entry): K1 held
    to its plain version at each arm's stage 1 and whole decode on a wave
    and stage 2 on the budget, and the P16_DEEP points; returns (K1's
    launches, max |d posterior|)."""
    import tempfile

    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.cli import bench_dde, deep_fer

    t0 = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        os.chdir(tmp)
        try:
            reset_counts()
            with val_cut():
                dec, hist = bench_dde.train(device=dev, verbose=False,
                                            **P16_TRAIN)
            c_tr = read_counts()
            saved = lt.load_pretrained(bench_dde.TRAINED_DIR, device=dev)
        finally:
            os.chdir(cwd)
    if sum(c_tr.values()) or not all(
            torch.equal(saved.weights[k], dec.weights[k])
            for k in ("beta", "alpha")):
        raise AssertionError(f"(c) training launched {c_tr}, or the saved "
                             f"entry differs")
    print(f"  (c) bench_dde train cut to {P16_TRAIN} (the program's 30 "
          f"epochs of 2048), validation to {P_VAL} frames (the trainer's "
          f"640): loss {hist['training_losses'][-1]:.5f}, the "
          f"entry reloads equal, no launch, {time.perf_counter() - t0:.1f} "
          f"s  [{card}]")
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        os.chdir(tmp)
        try:
            src = bench_dde.trained_source()
            arms = bench_dde.arms(dev)
        finally:
            os.chdir(cwd)
    if src != bench_dde.ZOO_ENTRY:
        raise AssertionError(f"(c) deep read {src}, not the zoo")
    gen = torch.Generator(device=dev).manual_seed(17)
    # a compacted wave: stage 1 on the wave, stage 2 on the budget; a
    # fallback wave decodes the wave whole besides
    err, k_ms = phase16_checks(dev, card, [
        (name, dec, T_, B_, False) for name, dec in arms.items()
        for T_, B_ in ((bench_dde.T1, bench_dde.WAVE),
                       (bench_dde.T, bench_dde.BUDGET),
                       (bench_dde.T, bench_dde.WAVE))], gen)
    torch.cuda.empty_cache()
    print(f"  (c) deep cut: {[(n, s, f'{c:,}') for n, s, c in P16_DEEP]} "
          f"(the program: 6.4-6.7 dB, 5e7 frames); waves {bench_dde.WAVE}, "
          f"budget {bench_dde.BUDGET}, 100 errors, min frames "
          f"{bench_dde.MIN_FRAMES}")
    t1 = time.perf_counter()
    reset_counts()
    want, runs = 0, []
    for name, snrs, cap in P16_DEEP:
        cfg = bench_dde.deep_config(cap, min(snrs), max(snrs), dev)
        res, sim = deep_fer.sweep({name: arms[name]}, cfg, checkpoints=None,
                                  verbose=False)
        if list(res) != [name] or [round(s, 2) for s in
                                   res[name].snr_values] != list(snrs):
            raise AssertionError(f"(c) {name}: curves {res}")
        kinds = sim.wave_kinds[name]
        want += sum(2 * k.get("compacted", 0) + 4 * k.get("fallback", 0)
                    for k in kinds)
        runs.append((name, res[name], kinds))
    torch.cuda.synchronize()
    counts = read_counts()
    only_k1("(c) deep", counts, want)
    if {name for name, _, _ in runs} != set(arms):
        raise AssertionError(f"(c) curves of {[r[0] for r in runs]}")
    for name, r, kinds in runs:
        def extra(_, i, r=r, kinds=kinds):
            return (f", {r.total_frames[i] / r.simulation_times[i]:.1f} "
                    f"frames/s ({r.simulation_times[i]:.2f} s), avg "
                    f"iterations {r.average_iterations[i]:.4f}, waves "
                    f"{kinds[i]}")
        book.curves("c", {name: r}, record["bench_dde"]["curves"],
                    extra=extra)
    name, r, kinds = runs[1]
    if set(kinds[-1]) == {"compacted"}:
        per = 1e3 * r.simulation_times[-1] / kinds[-1]["compacted"]
        stage1 = k_ms[name, bench_dde.T1, bench_dde.WAVE]
        st2 = k_ms[name, bench_dde.T, bench_dde.BUDGET]
        print(f"  (c) {name} @ {r.snr_values[-1]:.2f} dB: a compacted wave "
              f"{per:.3f} ms; K1 stage 1 (B={bench_dde.WAVE}, T="
              f"{bench_dde.T1}) {stage1:.3f} ms + stage 2 (B="
              f"{bench_dde.BUDGET}, T={bench_dde.T}) {st2:.3f} ms alone, the "
              f"rest {per - stage1 - st2:.3f} ms  [{card}]")
    print(f"  (c) {time.perf_counter() - t0:.1f} s (deep "
          f"{time.perf_counter() - t1:.1f} s), K1 launches {counts['K1']}")
    return counts["K1"], err


def phase16_short(dev, card, root, record, book):
    """(d): the four arms trained for P16_TRAIN (no launch), K1 held to
    its plain version on a wave at every spec of the table (RCQ-L6,
    RCQ-L5, the zoo's degree-shared T=5 and T=4 tables, the cut-trained
    per-layer ones), the FER table at the program's frames with RCQ-L6
    and RCQ-L5 Fisher-tested, the zoo's t5 and t4 beside their recorded
    FER; returns (K1's launches, max |d posterior|)."""
    import tempfile

    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.cli import deep_fer
    from ldpc_tpu_torch.cli import train_layered_short as short

    t0 = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        os.chdir(tmp)
        try:
            reset_counts()
            with val_cut():
                cands = short.train_candidates(device=dev, verbose=False,
                                               **P16_TRAIN)
            c_tr = read_counts()
            saved = sorted(os.listdir(tmp))
        finally:
            os.chdir(cwd)
    if sum(c_tr.values()) or saved != sorted(
            short.checkpoint_dir(T, pl) for T in (5, 4) for pl in (0, 1)):
        raise AssertionError(f"(d) training launched {c_tr}, saved {saved}")
    print(f"  (d) the four arms trained for {P16_TRAIN} (the program's 24 "
          f"epochs of 2048), validation cut to {P_VAL} frames (the "
          f"trainer's 640): tables " + ", ".join(
              f"{k} {tuple(d.weights['beta'].shape)}"
              for k, d in cands.items()) +
          f"; no launch; {time.perf_counter() - t0:.1f} s  [{card}]")
    zoo = {T: lt.load_pretrained(f"worcq_bc3_layered_t{T}",
                                 qc_options=dict(deep_fer.FUSED), device=dev)
           for T in (5, 4)}
    decs = {short.BENCH: short.make(6, "rcq", device=dev),
            "RCQ-L5": short.make(5, "rcq", device=dev), **cands}
    # every spec of the table whole on a wave: the degree-shared
    # candidates' spec with the zoo's tables, the per-layer ones with
    # their own
    gen = torch.Generator(device=dev).manual_seed(18)
    err = phase16_checks(dev, card, [
        (name, dec, dec.max_iterations, short.WAVE, False)
        for name, dec in ((short.BENCH, decs[short.BENCH]),
                          ("RCQ-L5", decs["RCQ-L5"]), ("zoo t5", zoo[5]),
                          ("zoo t4", zoo[4])) +
        tuple((n, cands[n]) for n in ("W-OMS-RCQ-L5+perlayer",
                                      "W-OMS-RCQ-L4+perlayer"))], gen)[0]
    torch.cuda.empty_cache()
    frames = P16_FRAMES
    t1 = time.perf_counter()
    reset_counts()
    fers = short.fer_table(decs, frames, dev, verbose=False)
    zfers = short.fer_table({f"worcq_bc3_layered_t{T}": d
                             for T, d in zoo.items()}, frames, dev,
                            verbose=False)
    torch.cuda.synchronize()
    counts = read_counts()
    want = (len(decs) + len(zoo)) * len(short.POINTS) * (frames // short.WAVE)
    only_k1("(d)", counts, want)
    if set(fers) != set(record["train_layered_short"]["fers"]):
        raise AssertionError(f"(d) FERs of {list(fers)}")
    jf = record["train_layered_short"]["fers"]
    jn = record["train_layered_short"]["frames_per_point"]
    for name, row in fers.items():
        for snr, fer in row.items():
            e, je = round(fer * frames), round(jf[name][snr] * jn)
            line = (f"  (d) {name} @ {snr} dB: {e}/{frames} (FER {fer:.4g}), "
                    f"JAX {je}/{jn}")
            if name not in cands and min(je, jn - je) >= P15_MIN:
                p = fisher_p(e, frames, je, jn)
                book.tested += 1
                line += f", Fisher p {p:.3g}"
                if p < P15_P:
                    book.failed.append(f"{name} @ {snr} dB: p {p:.3g}")
            else:
                line += (", not tested (cut-trained here)" if name in cands
                         else f", not tested (JAX {je} errors)")
            print(line + f"  [{card}]")
    for name, row in zfers.items():
        meta = lt.list_pretrained()
        mfer = next(s["meta"]["fer"] for p, s in meta
                    if os.path.basename(p) == name)
        print(f"  (d) {name} (zoo) FER " + ", ".join(
            f"{fer:.4g} @ {snr} dB (meta {mfer[snr]})"
            for snr, fer in row.items()) + f"  [{card}]")
    verdict = short.verdicts(fers, cands)
    print(f"  (d) verdicts (cut-trained; printed, not tested): {verdict}; "
          f"JAX: {record['train_layered_short']['verdicts']}")
    print(f"  (d) {time.perf_counter() - t0:.1f} s (FER table "
          f"{time.perf_counter() - t1:.1f} s), K1 launches {counts['K1']}")
    return counts["K1"], err


def phase16(dev, card):
    """The bench-knob and short-schedule programs' twins at full width;
    returns K1's launches and the largest posterior difference."""
    import tempfile

    print("[16 bench-knob and short-schedule twins]")
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    record = {}
    for prog in ("ee_trained", "bench_dde", "train_layered_short"):
        with open(os.path.join(root, "experiments",
                               f"{prog}_results.json")) as f:
            record[prog] = json.load(f)
    book = FisherBook(card)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        k1, err_a = phase16_ab_s(dev, card, tmp)
        torch.cuda.empty_cache()
        k_b, err_b = phase16_ee(dev, card, tmp, record, book)
    torch.cuda.empty_cache()
    k_c, err_c = phase16_dde(dev, card, root, record, book)
    torch.cuda.empty_cache()
    k_d, err_d = phase16_short(dev, card, root, record, book)
    k1 += k_b + k_c + k_d
    print(f"  {book.tested} points Fisher-tested against the JAX records; "
          f"K1 launches in phase 16 {k1} (a {k1 - k_b - k_c - k_d}, b {k_b}, "
          f"c {k_c}, d {k_d}), no K4, K5 or K6; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    if book.failed:
        raise AssertionError(f"points off the JAX records (p < {P15_P}): "
                             f"{book.failed}")
    return dict(K1=k1, k1_err=max(err_a, err_b, err_c, err_d))


def curves_of(report):
    """{name: SimulationResult} of a twin's report."""
    from ldpc_tpu_torch.sim import SimulationResult
    return {k: SimulationResult.from_dict(v)
            for k, v in report["curves"].items()}


def phase17_train_wrcq(dev, card, tmp, record, book):
    """(a): the train_wrcq twin with its defaults, no launch; float-MS
    Fisher-tested at every point, the two W-RCQ arms beside the record;
    the trained arm below the untrained at 3.0 and 3.5 dB."""
    from ldpc_tpu_torch.cli import train_wrcq as tw

    t0 = time.perf_counter()
    reset_counts()
    rep = tw.run(out_path=os.path.join(tmp, "train_wrcq.json"),
                 verbose=False, device=dev)
    torch.cuda.synchronize()
    only_k1("(a)", read_counts(), 0)
    res = curves_of(rep)
    jrec = record["train_wrcq"]
    if list(res) != list(jrec["curves"]):
        raise AssertionError(f"(a) curves {list(res)}")
    book.curves("a", {"float-MS": res["float-MS"]}, jrec["curves"])
    book.curves("a", {k: v for k, v in res.items() if k != "float-MS"},
                jrec["curves"], test=False,
                why="W-RCQ weights drawn by the port's generator")
    un, tr = (res[k] for k in ("W-RCQ-t2-untrained", "W-RCQ-t2-trained"))
    for snr in (3.0, 3.5):
        i = [round(s, 2) for s in tr.snr_values].index(snr)
        fu, ft = un.frame_error_rates[i], tr.frame_error_rates[i]
        print(f"  (a) @ {snr} dB: trained FER {ft:.4g} against untrained "
              f"{fu:.4g} (JAX {jrec['curves']['W-RCQ-t2-trained']['frame_error_rates'][i]:.4g} "
              f"against {jrec['curves']['W-RCQ-t2-untrained']['frame_error_rates'][i]:.4g})"
              f"  [{card}]")
        if not ft < fu:
            raise AssertionError(f"(a) training did not pay at {snr} dB")
    print("  (a) train_wrcq whole: "
          f"{rep['train_epochs']} epochs (the JAX record "
          f"{jrec['train_epochs']}), final loss "
          f"{rep['final_train_loss']:.5f} (JAX "
          f"{jrec['final_train_loss']:.5f}), accuracy "
          f"{rep['final_train_accuracy']:.4f}; no launch; "
          f"{time.perf_counter() - t0:.1f} s  [{card}]")


def phase17_rate_specific(dev, card, tmp, record, book):
    """(b): the rate_specific twin with its defaults, no launch; MS
    Fisher-tested at all 15 points, the trained arms beside the record."""
    from ldpc_tpu_torch.cli import rate_specific as rs

    t0 = time.perf_counter()
    reset_counts()
    rep = rs.run(out_path=os.path.join(tmp, "rate_specific.json"),
                 verbose=False, device=dev)
    torch.cuda.synchronize()
    only_k1("(b)", read_counts(), 0)
    jrec = record["rate_specific"]["rates"]
    if list(rep["rates"]) != list(jrec):
        raise AssertionError(f"(b) rates {list(rep['rates'])}")
    for r, v in rep["rates"].items():
        res = curves_of(v)
        if list(res) != list(jrec[r]["curves"]) or v["n"] != jrec[r]["n"]:
            raise AssertionError(f"(b) rate {r}: curves {list(res)}")
        book.curves(f"b {r}", {"MS": res["MS"]}, jrec[r]["curves"])
        book.curves(f"b {r}", {"W-RCQ-trained": res["W-RCQ-trained"]},
                    jrec[r]["curves"], test=False,
                    why="W-RCQ weights drawn by the port's generator")
        print(f"  (b) rate {r} (n={v['n']}): final loss "
              f"{v['final_train_loss']:.5f} (JAX "
              f"{jrec[r]['final_train_loss']:.5f})")
    print(f"  (b) rate_specific whole (k={rep['k']}); "
          f"no launch; {time.perf_counter() - t0:.1f} s  [{card}]")


def phase17_qc9472(dev, card, tmp, record, book):
    """(c): the train_wrcq_qc9472 twin at lift 256 with its training cut
    to P17_TQ_SAMPLES frames an epoch, no launch (the QC engine route);
    float-MS at 6.0 dB Fisher-tested, the rest beside the record."""
    from ldpc_tpu_torch.cli import train_wrcq_qc9472 as tq

    t0 = time.perf_counter()
    reset_counts()
    full = tq.NUM_SAMPLES
    tq.NUM_SAMPLES = P17_TQ_SAMPLES
    try:
        rep = tq.run(out_path=os.path.join(tmp, "train_wrcq_qc9472.json"),
                     verbose=False, device=dev, **P17_TQ)
    finally:
        tq.NUM_SAMPLES = full
    torch.cuda.synchronize()
    only_k1("(c)", read_counts(), 0)
    res = curves_of(rep)
    jrec = record["train_wrcq_qc9472"]
    if list(res) != list(jrec["curves"]) or rep["params"] != jrec["params"]:
        raise AssertionError(f"(c) curves {list(res)}, params "
                             f"{rep['params']}")
    book.curves("c", {"float-MS": res["float-MS"]}, jrec["curves"])
    book.curves("c", {k: v for k, v in res.items() if k != "float-MS"},
                jrec["curves"], test=False,
                why="cut-trained, weights drawn by the port's generator")
    print(f"  (c) train_wrcq_qc9472 at lift {P17_TQ['lift']}: training cut "
          f"to {P17_TQ_SAMPLES} frames an epoch ({P17_TQ_SAMPLES // tq.BATCH}"
          f" steps of the program's {full // tq.BATCH}), at most "
          f"{P17_TQ['epochs']} epochs of the program's 8; ran "
          f"{rep['train_epochs']} (the JAX record {jrec['train_epochs']}: "
          f"the accuracy early stop), final loss "
          f"{rep['final_train_loss']:.5f} (JAX "
          f"{jrec['final_train_loss']:.5f}); params {rep['params']} (JAX "
          f"{jrec['params']}); simulation at {P17_TQ['frames']} "
          f"frames a point (the program's 16384); no launch; "
          f"{time.perf_counter() - t0:.1f} s  [{card}]")


def phase17_deep(dev, card, root, record, book):
    """(d): rate_specific_deep's decoders at lift 86; K1 held to its
    plain version at each campaign shape (W-NMS-RCQ on its initial tables
    first), both candidates trained for one step (no launch) and saved,
    then the campaign at P17_DEEP's points, K1's launches counted against
    the waves; returns (K1's launches, max |d posterior|)."""
    import tempfile

    from ldpc_tpu_torch.cli import deep_fer
    from ldpc_tpu_torch.cli import rate_specific_deep as rsd
    from ldpc_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    decs = rsd.decoders(dev)
    nms, orcq = (name for _, name in rsd.CANDIDATES)
    shapes = ((rsd.T1, rsd.WAVE), (rsd.T, rsd.BUDGET), (rsd.T, rsd.WAVE))
    gen = torch.Generator(device=dev).manual_seed(17)
    n_pb = sum(not v for v in shared_pairs(decs[nms]).values())
    if n_pb != rsd.T * decs[nms].qc.mb:
        raise AssertionError(f"(d) {nms}'s initial tables share (beta, "
                             f"alpha) on {rsd.T * decs[nms].qc.mb - n_pb} "
                             f"(iteration, row) pairs")
    err, _ = phase16_checks(dev, card, [
        (f"{nms} (initial)", decs[nms], T_, B_, False) for T_, B_ in shapes],
        gen, P17_CHECK_SNR)
    torch.cuda.empty_cache()
    cwd = os.getcwd()
    full = rsd.NUM_SAMPLES
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        os.chdir(tmp)
        rsd.NUM_SAMPLES = P17_RSD_SAMPLES
        try:
            reset_counts()
            t1 = time.perf_counter()
            with val_cut():
                hists = rsd.train(decs, P17_RSD_EPOCHS, verbose=False)
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t1
            c_tr = read_counts()
            saved = {name: load_checkpoint(rsd.checkpoint_dir(tag))
                     for tag, name in rsd.CANDIDATES}
        finally:
            rsd.NUM_SAMPLES = full
            os.chdir(cwd)
    only_k1("(d) training", c_tr, 0)
    for name, w in saved.items():
        if not all(torch.equal(w[k], decs[name].weights[k].cpu())
                   for k in ("beta", "alpha")):
            raise AssertionError(f"(d) {name}: the saved tables differ")
    steps = len(rsd.CANDIDATES) * P17_RSD_EPOCHS * max(
        1, P17_RSD_SAMPLES // rsd.BATCH)
    print(f"  (d) training cut to {P17_RSD_EPOCHS} epoch of "
          f"{P17_RSD_SAMPLES} frames a candidate (the program's 24 epochs "
          f"of {full}): final losses " + ", ".join(
              f"{t} {h['training_losses'][-1]:.5f}" for t, h in hists.items())
          + f"; {steps} steps and {len(rsd.CANDIDATES) * P17_RSD_EPOCHS} "
          f"{P_VAL}-frame validations (the trainer's 640) in "
          f"{t_train:.1f} s "
          f"({t_train / steps:.1f} s a step with its validation); tables "
          f"saved and reloaded equal; no launch  [{card}]")
    print("  (d) (iteration, base row) pairs on K1's per-block route: " +
          ", ".join(f"{name} {sum(not v for v in shared_pairs(dec).values())}"
                    f" of {rsd.T * dec.qc.mb}" for name, dec in decs.items()))
    e2, k_ms = phase16_checks(dev, card, [
        (name, dec, T_, B_, False) for name, dec in decs.items()
        for T_, B_ in shapes], gen, P17_CHECK_SNR)
    err = max(err, e2)
    for dec in decs.values():
        print(k1_facts(dec, card))
    torch.cuda.empty_cache()
    print(f"  (d) campaign cut: {[(n, s) for n, s in P17_DEEP]} (the "
          f"program: 2.6-4.0 dB in 0.2 dB steps); waves {rsd.WAVE}, budget "
          f"{rsd.BUDGET}, 100 errors, min frames {rsd.MIN_FRAMES}, frame cap "
          f"2e7")
    t2 = time.perf_counter()
    reset_counts()
    want, curves, kinds = 0, {}, {}
    for name, snrs in P17_DEEP:
        cfg = rsd.campaign_config(snr_lo=min(snrs), snr_hi=max(snrs),
                                  device=dev)
        res, sim = deep_fer.sweep({name: decs[name]}, cfg, checkpoints=None,
                                  verbose=False)
        if list(res) != [name] or [round(s, 2) for s in
                                   res[name].snr_values] != list(snrs):
            raise AssertionError(f"(d) {name}: curves {res}")
        curves[name], kinds[name] = res[name], sim.wave_kinds[name]
        want += sum(2 * k.get("compacted", 0) + 4 * k.get("fallback", 0)
                    for k in kinds[name])
    torch.cuda.synchronize()
    counts = read_counts()
    only_k1("(d) campaign", counts, want)
    if set(curves) != set(decs):
        raise AssertionError(f"(d) curves of {list(curves)}")

    def rate(name, i):
        r = curves[name]
        return (f", {r.total_frames[i] / r.simulation_times[i]:.1f} "
                f"frames/s ({r.simulation_times[i]:.2f} s), avg iterations "
                f"{r.average_iterations[i]:.4f}, waves {kinds[name][i]}")

    jc = record["rate_specific_deep"]["curves"]
    book.curves("d", {rsd.OMS: curves[rsd.OMS]}, jc, extra=rate)
    book.curves("d", {k: curves[k] for k in (nms, orcq)}, jc, test=False,
                extra=rate)
    r, k = curves[rsd.OMS], kinds[rsd.OMS][-1]
    if set(k) == {"compacted"}:
        per = 1e3 * r.simulation_times[-1] / k["compacted"]
        st1 = k_ms[rsd.OMS, rsd.T1, rsd.WAVE]
        st2 = k_ms[rsd.OMS, rsd.T, rsd.BUDGET]
        print(f"  (d) {rsd.OMS} @ {r.snr_values[-1]:.2f} dB: a compacted "
              f"wave {per:.3f} ms; K1 stage 1 (B={rsd.WAVE}, T={rsd.T1}) "
              f"{st1:.3f} ms + stage 2 (B={rsd.BUDGET}, T={rsd.T}) "
              f"{st2:.3f} ms alone, the rest {per - st1 - st2:.3f} ms  "
              f"[{card}]")
    print(f"  (d) {time.perf_counter() - t0:.1f} s (campaign "
          f"{time.perf_counter() - t2:.1f} s), K1 launches {counts['K1']} "
          f"(the {(len(decs) + 1) * len(shapes)} checks' not counted)")
    return counts["K1"], err


def phase17(dev, card):
    """The W-RCQ training and rate-specific programs' twins at the
    programs' widths; returns K1's launches and the largest posterior
    difference."""
    import tempfile

    print("[17 W-RCQ training and rate-specific twins]")
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    record = {}
    for prog in ("train_wrcq", "rate_specific", "train_wrcq_qc9472",
                 "rate_specific_deep"):
        with open(os.path.join(root, "experiments",
                               f"{prog}_results.json")) as f:
            record[prog] = json.load(f)
    book = FisherBook(card)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        phase17_train_wrcq(dev, card, tmp, record, book)
        torch.cuda.empty_cache()
        phase17_rate_specific(dev, card, tmp, record, book)
        torch.cuda.empty_cache()
        phase17_qc9472(dev, card, tmp, record, book)
    torch.cuda.empty_cache()
    k1, err = phase17_deep(dev, card, root, record, book)
    secs = time.perf_counter() - t_phase
    print(f"  {book.tested} points Fisher-tested against the JAX records; "
          f"K1 launches in phase 17 {k1} (all in (d)), no K4, K5 or K6; "
          f"phase {secs:.1f} s (limit {P17_LIMIT} s)")
    if book.failed:
        raise AssertionError(f"points off the JAX records (p < {P15_P}): "
                             f"{book.failed}")
    if secs > P17_LIMIT:
        raise AssertionError(f"phase 17 took {secs:.1f} s, over "
                             f"{P17_LIMIT} s")
    return dict(K1=k1, k1_err=err)


def launches_of(kinds):
    """K1 launches of a fused compacting sweep: 2 a compacted wave, 4 a
    fallback."""
    return sum(2 * k.get("compacted", 0) + 4 * k.get("fallback", 0)
               for k in kinds)


class SimWatch:
    """``lt.simulate_single_snr`` watched while the context is open:
    ``calls`` holds each call's (decoder, SNR, config, wave kinds,
    seconds, result, each wave's counts)."""

    def __enter__(self):
        import ldpc_tpu_torch as lt
        from ldpc_tpu_torch.sim.montecarlo import _build_wave
        self.calls, self.real = [], lt.simulate_single_snr

        def watched(dec, snr, cfg, *args, **kw):
            wave, counts = _build_wave(dec, cfg), []

            def one(gen, snr_t):
                counts.append(tuple(wave(gen, snr_t)))
                return counts[-1]

            t0 = time.perf_counter()
            out = self.real(dec, snr, cfg, *args, wave_fn=one, **kw)
            self.calls.append((dec, snr, cfg, dict(wave.kinds),
                               time.perf_counter() - t0, out, counts))
            return out

        lt.simulate_single_snr = watched
        return self

    def __exit__(self, *exc):
        import ldpc_tpu_torch as lt
        lt.simulate_single_snr = self.real

    def launches(self):
        """K1 launches the waves account for: 1 a plain wave, 2 a
        compacted one, 4 a fallback."""
        kinds = [c[3] for c in self.calls]
        return sum(k.get("plain", 0) for k in kinds) + launches_of(kinds)


def book_point(book, tag, name, call, ref=None, why=None):
    """One watched point beside the record's (errors, frames) ``ref``,
    Fisher-tested unless ``why`` says why not; without ``ref``, printed
    with ``why``."""
    from ldpc_tpu_torch.sim import SimulationResult
    _, snr, _, kinds, secs, (fer, ber, it, nf, ne) = call[:6]
    extra = (f", {nf / secs:.1f} frames/s ({secs:.2f} s), avg iterations "
             f"{it:.4f}, waves {kinds}")
    if ref is None:
        print(f"  ({tag}) {name} @ {snr:.2f} dB: {ne}/{nf} (FER "
              f"{ne / nf:.4g}), no JAX record ({why}){extra}  [{book.card}]")
        return
    r = SimulationResult(name, [snr])
    r.add_result(0, fer, ber, it, secs, nf, ne)
    book.curves(tag, {name: r}, {name: dict(
        snr_values=[snr], total_errors=[ref[0]], total_frames=[ref[1]])},
        test=why is None, extra=lambda *_: extra, why=why)


def phase18_checks(dev, card, decs):
    """K1 against its plain version at every (decoder, iterations, batch)
    phase 18's campaigns launch (``decs``: {name: (decoder, t1, budget,
    wave, punctured, fallback expected)}), bit for bit in bf16 with the
    full output, each timed against its bound, and each decoder's K1
    facts. Returns (max |d posterior|, {(name, T, B): kernel ms})."""
    gen = torch.Generator(device=dev).manual_seed(18)
    err, ms = 0.0, {}
    for name, (dec, t1, budget, wave, punct, fallback) in decs.items():
        shapes = [(t1, wave), (dec.max_iterations, budget)] + (
            [(dec.max_iterations, wave)] if fallback else [])
        e, m = phase16_checks(dev, card, [
            (name, dec, T_, B_, False) for T_, B_ in shapes], gen,
            P18_CHECK_SNR, punct)
        err, ms = max(err, e), {**ms, **m}
        print(k1_facts(dec, card))
        torch.cuda.empty_cache()
    return err, ms


def phase18_compacted(tag, checks, kinds):
    """Fails when a wave of an arm checked without the fallback's whole
    decode (``checks[name]``'s last field False) fell back; ``kinds``:
    {name: [wave kinds of each point]}."""
    fell = {k: v for k, v in kinds.items()
            if not checks[k][5] and any(p.get("fallback") for p in v)}
    if fell:
        raise AssertionError(f"({tag}) waves fell back on arms whose whole "
                             f"decode was not checked: {fell}")


def phase18_sweeps(tag, arms, snrs, book, record, why=None):
    """Each of ``arms`` ({name: (decoder, SimulationConfig)}) swept by
    ``deep_fer.sweep`` with its own simulator, which must run ``snrs``;
    the points beside ``record`` (Fisher-tested unless ``why`` says why
    not). Returns (K1 launches the waves account for, {name:
    (SimulationResult, wave kinds)})."""
    from ldpc_tpu_torch.cli import deep_fer
    want, out = 0, {}
    for name, (dec, cfg) in arms.items():
        res, sim = deep_fer.sweep({name: dec}, cfg, checkpoints=None,
                                  verbose=False)
        if [round(s, 2) for s in res[name].snr_values] != list(snrs):
            raise AssertionError(f"({tag}) {name}: SNRs "
                                 f"{res[name].snr_values}")
        out[name] = (res[name], sim.wave_kinds[name])
        want += launches_of(sim.wave_kinds[name])

    def rate(name, i):
        r, kinds = out[name]
        return (f", {r.total_frames[i] / r.simulation_times[i]:.1f} "
                f"frames/s ({r.simulation_times[i]:.2f} s), avg iterations "
                f"{r.average_iterations[i]:.4f}, waves {kinds[i]}")

    book.curves(tag, {k: v[0] for k, v in out.items()}, record,
                test=why is None, extra=rate, why=why)
    return want, out


def phase18_lift(dev, root, book, record):
    """(b): the twin's ``run`` at P18_LIFT_SNRS, each of its
    ``simulate_single_snr`` calls watched for its wave kinds and seconds,
    each point Fisher-tested against the JAX record's FER and frames.
    Returns K1's launches the waves account for and {arm: [wave kinds of
    each point]}."""
    import tempfile

    from ldpc_tpu_torch.cli import pbrl_lift_floor as lf

    with SimWatch() as w, tempfile.TemporaryDirectory(dir=root) as tmp:
        rep = lf.run(snrs=P18_LIFT_SNRS, out_path=os.path.join(
            tmp, "lift.json"), verbose=False, device=dev)
    kinds = {}
    for key, call in zip(rep["results"], w.calls, strict=True):
        name = key.split("@")[0]
        kinds.setdefault(name, []).append(call[3])
        jp = record[key]
        book_point(book, "b", name, call,
                   (int(round(jp["fer"] * jp["frames"])), jp["frames"]))
    return w.launches(), kinds


def phase18_spectrum(card, spectrum, root):
    """(d): the worker's trapping-set spectra against the JAX record;
    ``spectrum`` is (report, host seconds, seconds run() waited for it),
    and None computes them here."""
    if spectrum is None:
        t0 = time.perf_counter()
        rep, secs = spectrum_data()
        waited = time.perf_counter() - t0
    else:
        rep, secs, waited = spectrum
    with open(os.path.join(root, "experiments",
                           "trapping_spectrum_results.json")) as f:
        ref = json.load(f)
    got = json.loads(json.dumps(rep))
    for key, v in got.items():
        print(f"  (d) {key}: {len(v['spectrum'])} classes with b <= 4, "
              f"min-b fingerprint {v['min_b_fingerprint']}; equal to the "
              f"JAX record: {v == ref.get(key)}")
    where = ("here" if spectrum is None else
             "in the worker process beside phases 1-11")
    print(f"  (d) trapping_spectrum whole: {secs:.1f} s of host numpy "
          f"{where}, waited {waited:.1f} s for it  [{card}]")
    if got != ref:
        raise AssertionError("the trapping-set spectra differ from "
                             "trapping_spectrum_results.json")


def phase18(dev, card, spectrum=None):
    """The PBRL floor programs' twins at the programs' widths; returns K1's
    launches and the largest posterior difference. ``spectrum`` is
    :func:`spectrum_data`'s result from the worker process and the
    seconds run() waited for it; None runs it here, after the campaigns
    (phase 18 alone)."""
    from ldpc_tpu_torch.cli import pbrl_bc5 as bc5
    from ldpc_tpu_torch.cli import pbrl_lift_floor as lf
    from ldpc_tpu_torch.cli import pbrl_precode as pc
    from ldpc_tpu_torch.decode import fused

    print("[18 PBRL floor twins]")
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    record = {}
    for prog in ("pbrl_bc5", "pbrl_lift_floor", "pbrl_precode"):
        with open(os.path.join(root, "experiments",
                               f"{prog}_results.json")) as f:
            record[prog] = json.load(f)
    book = FisherBook(card)
    a = bc5.decoders(dev)
    b = lf.decoders(dev)
    c = {name: (dec, punct) for name, dec, punct in pc.arms(dev)}
    wave, budget = P18_WAVE, P18_BUDGET
    checks = {name: (a[name], bc5.T1, budget, wave, None,
                     a[name].max_iterations == 20) for name in a}
    for name in b:
        checks[name] = (b[name], lf.T1, budget, wave, None, True)
    for name in c:
        checks[name] = (c[name][0], pc.T1, budget, wave, c[name][1], False)
    err, k_ms = phase18_checks(dev, card, checks)
    for stage in ((bc5.T1, wave), (10, budget)):
        r = [k_ms[f"RCQ-bc{q}-T10", stage[0], stage[1]] for q in (5, 4)]
        print(f"  K1 at B={stage[1]}, T={stage[0]}: bc=5 closed form "
              f"(power) {r[0]:.3f} ms against bc=4 (staircase) {r[1]:.3f} "
              f"ms, {r[0] / r[1]:.3f}x  [{card}]")
    print(f"  K1 checks {time.perf_counter() - t_phase:.1f} s")

    # (a) pbrl_bc5
    t0 = time.perf_counter()
    reset_counts()
    cfg = bc5.campaign_config(snr_lo=min(P18_BC5_SNRS),
                              snr_hi=max(P18_BC5_SNRS), device=dev)
    want, got = phase18_sweeps("a", {k: (d, cfg) for k, d in a.items()},
                               P18_BC5_SNRS, book,
                               record["pbrl_bc5"]["curves"])
    only_k1("(a)", read_counts(), want)
    phase18_compacted("a", checks, {k: v[1] for k, v in got.items()})
    print(f"  (a) pbrl_bc5 cut: {P18_BC5_SNRS} dB of 2.6-4.0; waves {wave}, "
          f"budget {budget}, 100 errors, frame cap 2e7; K1 launches {want}; "
          f"{time.perf_counter() - t0:.1f} s")
    k1 = want

    # (b) pbrl_lift_floor
    t0 = time.perf_counter()
    reset_counts()
    want, kinds = phase18_lift(dev, root, book,
                               record["pbrl_lift_floor"]["results"])
    only_k1("(b)", read_counts(), want)
    phase18_compacted("b", checks, kinds)
    print(f"  (b) pbrl_lift_floor cut: {P18_LIFT_SNRS} dB of 2.8-4.0; K1 "
          f"launches {want}; {time.perf_counter() - t0:.1f} s")
    k1 += want

    # (c) pbrl_precode, every precoded K1 launch checked for zeros at the
    # punctured positions as it reaches the kernel (bf16)
    t0 = time.perf_counter()
    reset_counts()
    punct = c["precoded-bc4-T10"][1]
    lo, hi = punct[0], punct[-1] + 1
    seen = dict(calls=0, nonzero=torch.zeros((), dtype=torch.int64,
                                             device=dev))
    real = fused._launch

    def spy(flooding, llr, *args):
        if llr.shape[1] == c["precoded-bc4-T10"][0].code.n:
            seen["calls"] += 1
            seen["nonzero"] += (llr[:, lo:hi] != 0).sum()
        return real(flooding, llr, *args)

    arms = {k: (d, pc.campaign_config(
        p, P18_OMS_CAP if "oms" in k else 2 * 10 ** 7,
        snr_lo=min(P18_PRECODE_SNRS), snr_hi=max(P18_PRECODE_SNRS),
        device=dev)) for k, (d, p) in c.items()}
    fused._launch = spy
    try:
        w1, got = phase18_sweeps(
            "c", {k: v for k, v in arms.items() if "oms" not in k},
            P18_PRECODE_SNRS, book, record["pbrl_precode"]["curves"])
        w2, oms = phase18_sweeps(
            "c", {k: v for k, v in arms.items() if "oms" in k},
            P18_PRECODE_SNRS, book, record["pbrl_precode"]["curves"],
            why=f"capped at {P18_OMS_CAP:,} frames")
    finally:
        fused._launch = real
    only_k1("(c)", read_counts(), w1 + w2)
    phase18_compacted("c", checks, {k: v[1] for k, v in {**got,
                                                         **oms}.items()})
    pre = launches_of(got["precoded-bc4-T10"][1]) + w2
    nonzero = int(seen["nonzero"])
    print(f"  (c) pbrl_precode cut: {P18_PRECODE_SNRS} dB of 2.6-4.0, the "
          f"OMS arm capped at {P18_OMS_CAP:,} frames (the program's 2e7); "
          f"K1 launches {w1 + w2}, of which {seen['calls']} on the precoded "
          f"code ({pre} its waves account for), {nonzero} nonzero LLRs at "
          f"the {hi - lo} punctured positions there; "
          f"{time.perf_counter() - t0:.1f} s")
    if nonzero or seen["calls"] != pre:
        raise AssertionError("a punctured LLR reached K1 nonzero, or a "
                             "precoded launch went uncounted")
    k1 += w1 + w2

    phase18_spectrum(card, spectrum, root)
    secs = time.perf_counter() - t_phase
    print(f"  {book.tested} points Fisher-tested against the JAX records; "
          f"K1 launches in phase 18 {k1}, no K4, K5 or K6; phase "
          f"{secs:.1f} s (limit {P18_LIMIT} s)")
    if book.failed:
        raise AssertionError(f"points off the JAX records (p < {P15_P}): "
                             f"{book.failed}")
    if secs > P18_LIMIT:
        raise AssertionError(f"phase 18 took {secs:.1f} s, over "
                             f"{P18_LIMIT} s")
    return dict(K1=k1, k1_err=err)


def phase19_checks(dev, card, dde):
    """K1 against its plain version at the shapes the studies launch,
    bit for bit in bf16 (:func:`phase16_check`), each timed against its
    bound, and each decoder's K1 facts: ladder_bc4's 3-6-9@1.0 whole at
    B=16384 and 2-4-6@1.3 at stage 1 (T=2, B=32768), stage 2 (B=2048) and
    the fallback's whole decode (B=32768); bc4_refine's polished bc4 and
    quantizer_count's rcq-q2, lean, at stage 1 (T=3, B=32768), stage 2
    (B=4096) and the fallback (B=32768), and their bc3 / rcq-q3 at stage 2
    and the fallback; p2 and p3 at lift 43 on LLRs
    punctured as the simulator's mask does, at stage 1 (T=5, B=98304),
    stage 2 (B=4096) and the fallback's whole decode (B=98304);
    dde_ladders' bc4_dde whole at B=16384, full and lean. Returns (max
    |d posterior|, {name: decoder})."""
    from ldpc_tpu_torch.cli import bc4_refine as br
    from ldpc_tpu_torch.cli import ladder_bc4 as lb
    from ldpc_tpu_torch.cli import quantizer_count as qcn

    gen = torch.Generator(device=dev).manual_seed(19)
    specs = [
        ("3-6-9@1.0", lb.make(lb.LADDERS["3-6-9@1.0"], device=dev),
         ((6, 16384, False),), None, P19_CHECK_SNR),
        ("2-4-6@1.3", lb.make(lb.LADDERS["2-4-6@1.3"], device=dev),
         ((2, 32768, False), (6, 2048, False), (6, 32768, False)), None,
         P19_CHECK_SNR),
        ("bc4 polished", br._mk("bc4", dev)[0],
         ((3, 32768, True), (6, 4096, True), (6, 32768, True)), None,
         P19_CHECK_SNR),
        ("rcq-q2", qcn._mk("rcq-q2", dev)[0],
         ((3, 32768, True), (6, 4096, True), (6, 32768, True)), None,
         P19_CHECK_SNR),
        # bc4_refine's bc3 and quantizer_count's rcq-q3: the bench decoder,
        # whose stage 1 (T=3, B=32768, lean) phase 16 (a) holds
        ("bc3", br._mk("bc3", dev)[0], ((6, 4096, True), (6, 32768, True)),
         None, P19_CHECK_SNR),
        ("bc4_dde", dde["bc4_dde"], ((6, 16384, False), (6, 16384, True)),
         None, P19_CHECK_SNR)]
    for arm in ("p2", "p3"):
        dec, punct = qcn._mk13(arm, dev)
        specs.append((arm, dec, ((5, 98304, False), (10, 4096, False),
                                 (10, 98304, False)), punct,
                      P19_CHECK13_SNR))
    err = 0.0
    for name, dec, shapes, punct, snr in specs:
        err = max(err, phase16_checks(dev, card, [
            (name, dec, T_, B_, lean) for T_, B_, lean in shapes], gen, snr,
            punct)[0])
        print(k1_facts(dec, card))
        torch.cuda.empty_cache()
    return err, {name: dec for name, dec, *_ in specs}


def phase19_tables(card, decs):
    """The two-pair decoders' (``decs``: {name: (decoder, ladder)})
    per-iteration tables on the card: row t of the [T, 2] (C, gamma) and
    [T, L] threshold tables K1 indexes is pair ``phase_schedule(T, 2)[t]``
    (the first pair for t < T // 3)."""
    from ldpc_tpu_torch.decode import engine
    from ldpc_tpu_torch.quantizer import phase_schedule, power_thresholds

    for name, (dec, ladder) in decs.items():
        T_, dev = dec.max_iterations, dec.device
        sched = phase_schedule(T_, 2)
        bc = int(np.log2(dec.spec.q_levels)) + 1
        tabs = engine._tables(dec.weights, dec.spec, T_, dec.qc.num_blocks,
                              dev)
        qp = torch.from_numpy(np.asarray(ladder, np.float32)[sched])
        thr = torch.from_numpy(np.stack([power_thresholds(bc, c, g)
                                         for c, g in ladder])[sched])
        ok = (torch.equal(tabs["qp"].cpu(), qp) and
              torch.equal(tabs["thr"].cpu(), thr))
        print(f"  {name}: phase_schedule({T_}, 2) = {sched.tolist()}; K1's "
              f"tables qp {tuple(tabs['qp'].shape)} and thr "
              f"{tuple(tabs['thr'].shape)} on the card are the pairs' rows "
              f"in that order: {ok}  [{card}]")
        if not ok:
            raise AssertionError(f"{name}: two-pair tables")


def phase19_neutral(dev, card, dde):
    """K1 on dde_ladders' ``bc{3,4}_dde`` and ``_dde_cn_only`` (one CN
    ladder, V2C ladders apart), full and lean, on one B=16384 wave at
    P19_CHECK_SNR (comparison launches, not counted): equal bits, success
    and iterations, since the layered schedule's V2C quantizer touches
    only the final posterior and keeps its signs."""
    import ldpc_tpu_torch as lt

    gen = torch.Generator(device=dev).manual_seed(191)
    for bc in (3, 4):
        a, b = dde[f"bc{bc}_dde"], dde[f"bc{bc}_dde_cn_only"]
        x = lt.awgn_llr(gen, torch.zeros((16384, a.code.n), device=dev),
                        P19_CHECK_SNR).to(torch.bfloat16)
        outs = [uncounted(lambda d=d, lean=lean: kernel_on(x, d, 6, lean))
                for d in (a, b) for lean in (False, True)]
        torch.cuda.synchronize()
        ref = outs[0]
        same = all(torch.equal(o.bits.to(torch.int8),
                               ref.bits.to(torch.int8)) and
                   torch.equal(o.success, ref.success) and
                   torch.equal(o.iterations, ref.iterations)
                   for o in outs[1:])
        differ = not torch.equal(outs[0].posterior.view(torch.int16),
                                 outs[2].posterior.view(torch.int16))
        va, vb = (d.spec.v2c_qparams[-1].tolist() for d in (a, b))
        print(f"  bc{bc}_dde and bc{bc}_dde_cn_only (V2C {va} and {vb} at "
              f"the last iteration), "
              f"full and lean, B=16384 at {P19_CHECK_SNR} dB: bits, success "
              f"and iterations equal {same}, posteriors differ {differ}, "
              f"success {ref.success.float().mean().item():.4f}  [{card}]")
        if not same:
            raise AssertionError(f"bc={bc}: the V2C ladder changed a decode")
        del x, outs, ref


def phase19_ladder(dev, card, tmp, book, record):
    """(a): ``ladder_bc4.run`` whole, the deep points capped at P19_CAP
    frames; the dev ladders Fisher-tested, the deep points where the twin
    selects the record's ladder. Returns K1's launches."""
    from ldpc_tpu_torch.cli import ladder_bc4 as lb

    t0 = time.perf_counter()
    reset_counts()
    with SimWatch() as w:
        rep = lb.run(deep_frames=P19_CAP, out_path=os.path.join(
            tmp, "ladder_bc4.json"), verbose=False, device=dev)
    torch.cuda.synchronize()
    k1 = w.launches()
    only_k1("(a)", read_counts(), k1)
    calls, sel = w.calls, rep["selected"]
    if len(calls) != 8 or [c[1] for c in calls[6:]] != [6.5, 6.6] or \
            calls[6][2] != lb.deep_config(P19_CAP, dev):
        raise AssertionError(f"(a) calls {[c[1] for c in calls]}")
    print(f"  (a) ladder_bc4 cut: deep frame cap {P19_CAP:,} (the "
          f"program's 20,000,000; it binds at 6.6 dB, where the record "
          f"needed 7,766,016 frames for 100 errors); dev sweep whole")
    for (name, fer), call in zip(record["dev_fers_bc4"].items(), calls):
        book_point(book, "a", f"dev {name}", call,
                   (round(fer * 131072), 131072))
    why = (None if sel == record["selected"] else
           f"selected {sel}, the record {record['selected']}")
    for call in calls[6:]:
        jp = record["deep"][str(call[1])]
        book_point(book, "a", f"deep {sel}", call,
                   (round(jp["fer"] * jp["frames"]), jp["frames"]), why=why)
    print(f"  (a) selected {sel} (the record {record['selected']}); K1 "
          f"launches {k1}; {time.perf_counter() - t0:.1f} s")
    return k1


def p19_deep(tag, book, calls, res, record, arms, why=None):
    """The watched deep points of ``arms`` in ``res`` ({arm: {key:
    point}}, measured in that order) beside ``record``'s; returns {(arm,
    key): call}."""
    keys = [(arm, key) for arm in arms for key in res[arm]]
    if len(keys) != len(calls):
        raise AssertionError(f"({tag}) {len(calls)} calls for {keys}")
    for (arm, key), call in zip(keys, calls):
        jp = record.get(arm, {}).get(key)
        book_point(book, tag, arm, call,
                   jp and (jp["errors"], jp["frames"]), why=why)
    return dict(zip(keys, calls))


def phase19_refine(dev, card, tmp, book, record):
    """(b): ``bc4_refine.deep`` (arms bc4 and bc3) from 6.0 to 6.6 dB, each
    point capped at P19_CAP frames, every point Fisher-tested. Returns
    (K1's launches, {(arm, SNR key): watched call})."""
    from ldpc_tpu_torch.cli import bc4_refine as br

    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        reset_counts()
        with SimWatch() as w:
            res = br.deep(snr_hi=6.6, frames=P19_CAP, verbose=False,
                          device=dev)
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    k1 = w.launches()
    only_k1("(b)", read_counts(), k1)
    print(f"  (b) bc4_refine deep cut: 6.0-6.6 dB of 6.0-7.6, frame cap "
          f"{P19_CAP:,} (the program's 200,000,000; it binds at 6.6 dB, "
          f"where the record needed 30.8M and 56.8M frames for 100 "
          f"errors); waves 32768, budget 4096, min frames 65536")
    calls = p19_deep("b", book, w.calls, res, record, ("bc4", "bc3"))
    print(f"  (b) K1 launches {k1}; {time.perf_counter() - t0:.1f} s")
    return k1, calls


def phase19_count(dev, card, tmp, book, record, record13, refine):
    """(c): ``quantizer_count.deep`` (rcq-q2 from the committed design,
    rcq-q3) from 6.0 to 6.6 dB capped at P19_CAP frames, rcq-q3 held to
    (b)'s bc3, the same decoder on the same seeded stream (``refine``:
    (b)'s watched calls): at each point the waves both ran count the same
    wave by wave, so their totals are equal where both stop after the same
    waves (their error targets, 50 and 100, part them when the first
    65,536 frames hold 50-99 errors); ``deep13``'s p2 from 1.4 to
    2.4 dB and p3 at P19_P3's point and cap (printed), every K1 launch on
    the lift-43 code checked for zeros at the punctured positions as it
    reaches the kernel. Returns K1's launches."""
    from ldpc_tpu_torch.cli import quantizer_count as qcn
    from ldpc_tpu_torch.decode import fused

    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        reset_counts()
        with SimWatch() as w:
            res = qcn.deep(snr_hi=6.6, frames=P19_CAP, verbose=False,
                           device=dev)
        torch.cuda.synchronize()
        k1 = w.launches()
        only_k1("(c) deep", read_counts(), k1)
        print(f"  (c) quantizer_count deep cut: 6.0-6.6 dB of 6.0-7.8, "
              f"frame cap {P19_CAP:,} (the program's 1,000,000,000); "
              f"rcq-q2 from {qcn.DESIGN_RECORD.split('/')[-1]}")
        calls = p19_deep("c", book, w.calls, res, record,
                         ("rcq-q2", "rcq-q3"))
        for k in ("6.0", "6.2", "6.4", "6.6"):
            q, b = calls.get(("rcq-q3", k)), refine.get(("bc3", k))
            if q is None or b is None:
                # an arm stops at its first point without an error
                if k != "6.6":
                    raise AssertionError(f"(c) no rcq-q3 or bc3 point at "
                                         f"{k} dB")
                continue
            qw, bw = q[6], b[6]
            n = min(len(qw), len(bw))
            prefix = qw[:n] == bw[:n]
            print(f"  (c) rcq-q3 against (b)'s bc3 @ {k} dB: {q[5][4]}/"
                  f"{q[5][3]} in {len(qw)} waves and {b[5][4]}/{b[5][3]} in "
                  f"{len(bw)}; the {n} waves both ran equal wave by wave "
                  f"{prefix}; totals equal {q[5][3:] == b[5][3:]}")
            if not prefix or (len(qw) == len(bw) and q[5][3:] != b[5][3:]):
                raise AssertionError(f"(c) rcq-q3 and bc3 differ at {k} dB")

        dec13, punct = qcn._mk13("p2", dev)
        n13, lo, hi = dec13.code.n, punct[0], punct[-1] + 1
        del dec13
        seen = dict(calls=0, nonzero=torch.zeros((), dtype=torch.int64,
                                                 device=dev))
        real = fused._launch

        def spy(flooding, llr, *args):
            if llr.shape[1] == n13:
                seen["calls"] += 1
                seen["nonzero"] += (llr[:, lo:hi] != 0).sum()
            return real(flooding, llr, *args)

        t1 = time.perf_counter()
        reset_counts()
        fused._launch = spy
        try:
            with SimWatch() as w13:
                r2 = qcn.deep13(arms=("p2",), snr_hi=2.4, verbose=False,
                                device=dev)
                r3 = qcn.deep13(arms=("p3",), snr_lo=P19_P3[0],
                                snr_hi=P19_P3[0], frames=P19_P3[1],
                                verbose=False, device=dev)
        finally:
            fused._launch = real
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    k13 = w13.launches()
    only_k1("(c) deep13", read_counts(), k13)
    nonzero = int(seen["nonzero"])
    print(f"  (c) deep13 cut: p2 at 1.4-2.4 dB of 1.4-3.6 (the program's "
          f"50,000,000-frame cap, 100 errors), p3 at {P19_P3[0]} dB capped "
          f"at {P19_P3[1]:,} frames; waves 98304, budget 4096, min frames "
          f"65536; {seen['calls']} K1 launches on the lift-43 code, "
          f"{nonzero} nonzero LLRs at its {hi - lo} punctured positions")
    p19_deep("c", book, w13.calls[:len(r2["p2"])], r2, record13, ("p2",))
    p19_deep("c", book, w13.calls[len(r2["p2"]):], {"p3": r3["p3"]}, {},
             ("p3",), why="the program's p3 arm has no record")
    if nonzero or seen["calls"] != k13:
        raise AssertionError("(c) a punctured LLR reached K1 nonzero, or a "
                             "launch went uncounted")
    print(f"  (c) K1 launches {k1 + k13} (deep13 {k13}); deep "
          f"{t1 - t0:.1f} s, deep13 {time.perf_counter() - t1:.1f} s")
    return k1 + k13


def phase19_dde(dev, card, tmp, book, record, bc3):
    """(d): ``dde_ladders.run`` at P19_DDE_SNRS, its designer calls
    answered by ``bc3`` (phase 12 (a)'s bc=3 design: CN, V2C, threshold)
    and the JAX package's results (P19_DESIGN_BC4, P19_REFINED) after each
    call is held to the program's; the dde and dde_cn_only arms of each bc
    (and dde_refined where its CN ladder is dde's) count equal frame
    errors; the hand arms Fisher-tested, the others printed (the record's
    designs predate the decision-bias fix). Returns K1's launches."""
    import types

    from ldpc_tpu_torch import design as dsg
    from ldpc_tpu_torch.cli import dde_ladders as dl
    from ldpc_tpu_torch.cli import deep_fer

    t0 = time.perf_counter()
    base = deep_fer.bench_base(256)
    profile = dsg.degree_profile_from_base(base)
    answers = {3: tuple(bc3), 4: P19_DESIGN_BC4}
    made = []

    def design_rcq_ladders(prof, **kw):
        bc = kw.get("bc")
        made.append(("design_rcq_ladders", bc))
        if prof != profile or kw != dict(DESIGN_CALL, bc=bc):
            raise AssertionError(f"(d) design_rcq_ladders({kw})")
        qp, vqp, thr = answers[bc]
        return qp, vqp, types.SimpleNamespace(threshold_db=thr)

    def refine(b, qp, vqp, **kw):
        bc = kw.get("bc")
        made.append(("refine_ladders_protograph", bc))
        if not np.array_equal(b, base) or (qp, vqp) != answers[bc][:2] or \
                kw != dict(bc=bc, bv=8, max_iterations=6, snr_db=6.3,
                           schedule="layered"):
            raise AssertionError(f"(d) refine_ladders_protograph({kw})")
        return P19_REFINED[bc]

    real = dsg.design_rcq_ladders, dsg.refine_ladders_protograph
    dsg.design_rcq_ladders, dsg.refine_ladders_protograph = \
        design_rcq_ladders, refine
    reset_counts()
    try:
        with SimWatch() as w:
            rep = dl.run(dev_snrs=P19_DDE_SNRS, out_path=os.path.join(
                tmp, "dde_ladders.json"), verbose=False, device=dev)
    finally:
        dsg.design_rcq_ladders, dsg.refine_ladders_protograph = real
    torch.cuda.synchronize()
    k1 = w.launches()
    only_k1("(d)", read_counts(), k1)
    if made != [(c, bc) for bc in (3, 4) for c in (
            "design_rcq_ladders", "refine_ladders_protograph")]:
        raise AssertionError(f"(d) designer calls {made}")
    d3 = rep["designs"]["3"]
    if (d3["cn"], d3["v2c"]) != (DESIGN_QP, DESIGN_VQP):
        raise AssertionError(f"(d) bc=3 design {d3}")
    print(f"  (d) dde_ladders cut: {P19_DDE_SNRS} dB of (6.4, 6.5), "
          f"262,144 frames an arm; the program's four designer calls made "
          f"(bc=3 design: phase 12 (a)'s, equal to DESIGN_QP / DESIGN_VQP; "
          f"the bc=4 design and both refines: the JAX package's results, "
          f"P19_DESIGN_BC4 and P19_REFINED): designs "
          f"{rep['designs']}, refined {rep['refined']}")
    counts = {}
    for key, call in zip(rep["fers"], w.calls, strict=True):
        name = key.split("@")[0]
        counts[name] = call[5][4]
        jf = record["fers"].get(key)
        hand = name.endswith("_hand")
        book_point(book, "d", name, call, (round(jf * 262144), 262144),
                   why=None if hand else "its record, 2026-08-19, predates "
                   "the decision-bias fix a34eb06")
    for bc in (3, 4):
        pairs = [(f"bc{bc}_dde", f"bc{bc}_dde_cn_only")]
        if rep["refined"][str(bc)]["cn"] == rep["designs"][str(bc)]["cn"]:
            pairs.append((f"bc{bc}_dde", f"bc{bc}_dde_refined"))
        for a, b in pairs:
            print(f"  (d) {a} {counts[a]} and {b} {counts[b]} frame errors: "
                  f"equal {counts[a] == counts[b]}")
            if counts[a] != counts[b]:
                raise AssertionError(f"(d) {a} and {b} differ")
    print(f"  (d) K1 launches {k1}; {time.perf_counter() - t0:.1f} s")
    return k1


def phase19(dev, card, bc3=None):
    """The bench-code design studies' twins at the programs' widths;
    returns K1's launches and the largest posterior difference. ``bc3``
    is phase 12 (a)'s bc=3 design (CN, V2C, threshold); None takes the
    JAX package's (DESIGN_QP, DESIGN_VQP, DESIGN_THRESHOLD), which phase
    12 holds it to (phase 19 alone)."""
    import tempfile

    from ldpc_tpu_torch.cli import dde_ladders as dl

    print("[19 bench-code design-study twins]")
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    record = {}
    for prog in ("ladder_bc4", "bc4_refine", "quantizer_count",
                 "quantizer_count13", "dde_ladders"):
        with open(os.path.join(root, "experiments",
                               f"{prog}_results.json")) as f:
            record[prog] = json.load(f)
    bc3 = bc3 or (DESIGN_QP, DESIGN_VQP, DESIGN_THRESHOLD)
    dde = dl.arms({3: bc3[:2], 4: P19_DESIGN_BC4[:2]},
                  {bc: P19_REFINED[bc][:2] for bc in (3, 4)}, device=dev)
    err, decs = phase19_checks(dev, card, dde)
    with open(os.path.join(root, "experiments",
                           "quantizer_count_design.json")) as f:
        d = json.load(f)
    with open(os.path.join(root, "experiments",
                           "quantizer_count_design13_polish.json")) as f:
        p2 = json.load(f)["cn"]
    phase19_tables(card, {"rcq-q2": (decs["rcq-q2"], [tuple(p) for p in d[
        "passes"][d["best_index"]]["cn"]]), "p2": (decs["p2"], [
            tuple(p) for p in p2])})
    phase19_neutral(dev, card, dde)
    del dde, decs
    torch.cuda.empty_cache()
    print(f"  K1 checks {time.perf_counter() - t_phase:.1f} s")
    book = FisherBook(card)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        k_a = phase19_ladder(dev, card, tmp, book, record["ladder_bc4"])
        torch.cuda.empty_cache()
        k_b, refine = phase19_refine(dev, card, tmp, book,
                                     record["bc4_refine"])
        torch.cuda.empty_cache()
        k_c = phase19_count(dev, card, tmp, book, record["quantizer_count"],
                            record["quantizer_count13"], refine)
        torch.cuda.empty_cache()
        k_d = phase19_dde(dev, card, tmp, book, record["dde_ladders"], bc3)
    k1 = k_a + k_b + k_c + k_d
    secs = time.perf_counter() - t_phase
    print(f"  {book.tested} points Fisher-tested against the JAX records; "
          f"K1 launches in phase 19 {k1} (a {k_a}, b {k_b}, c {k_c}, d "
          f"{k_d}), no K4, K5 or K6; phase {secs:.1f} s (limit {P19_LIMIT} "
          f"s)")
    if book.failed:
        raise AssertionError(f"points off the JAX records (p < {P15_P}): "
                             f"{book.failed}")
    if secs > P19_LIMIT:
        raise AssertionError(f"phase 19 took {secs:.1f} s, over "
                             f"{P19_LIMIT} s")
    return dict(K1=k1, k1_err=err)


def p20_tables(name, dec):
    """Whether a ``wrcq`` arm decodes with exactly the JAX program's
    trained tables (``cli/pbrl_rates_tables.npz``); printed."""
    from ldpc_tpu_torch.cli import pbrl_rates as pr
    ck = "orcq_" + name.split("/")[1][5:].replace("-", "_")
    with np.load(pr.TABLES) as f:
        same = all(torch.equal(dec.weights[k].cpu(),
                               torch.from_numpy(f[f"{ck}/{k}"]))
                   for k in ("beta", "alpha"))
    shapes = {k: tuple(v.shape) for k, v in dec.weights.items()}
    print(f"  {name}: tables {shapes} equal to {ck} of "
          f"pbrl_rates_tables.npz: {same}")
    if not same:
        raise AssertionError(f"{name} does not decode with {ck}'s tables")


def phase20_checks(dev, card):
    """K1 against its plain version at each of P20_CHECKS' (arm, T, B), bit
    for bit in bf16 with the full output on LLRs punctured as the
    simulator's mask does (:func:`phase16_check`), each timed against its
    bound, with each decoder's K1 facts; the ``wrcq`` arms' tables held to
    the JAX program's. Run in the phase's working directory (the arms
    install their tables there). Returns (max |d posterior|, {(name, T,
    B): kernel ms})."""
    from ldpc_tpu_torch.cli import pbrl_rates as pr

    gen = torch.Generator(device=dev).manual_seed(20)
    err, ms, setups = 0.0, {}, {}
    for tag, arm, shapes in P20_CHECKS:
        if tag not in setups:
            setups[tag] = pr._mk_setup(tag, dev)
        mk, punct, code = setups[tag]
        name = f"{tag}/{arm}"
        dec = mk(arm)
        if arm.startswith("wrcq-"):
            p20_tables(name, dec)
        e, m = phase16_checks(dev, card, [
            (name, dec, T_, B_, False) for T_, B_ in shapes], gen,
            P20_CHECK_SNR[tag], punct)
        err, ms = max(err, e), {**ms, **m}
        print(k1_facts(dec, card) + f"; n = {code.n}, {dec.qc.mb}x"
              f"{dec.qc.nb} base, {dec.qc.num_blocks} blocks, rows of "
              f"degree up to {max(len(r) for r in dec.qc.row_blocks)}, "
              f"{max(B_ for _, B_ in shapes) * code.n:,} LLRs at the "
              f"largest batch")
        del dec
        torch.cuda.empty_cache()
    return err, ms


def p20_point(book, tag, name, call, ref, why=None):
    """A watched point beside the record's (errors, frames) ``ref``:
    Fisher-tested where both the record and this run hold at least P15_MIN
    errors and P15_MIN successes."""
    nf, ne = call[5][3], call[5][4]
    if ref is not None and why is None and min(ne, nf - ne) < P15_MIN:
        why = f"{ne} errors here"
    book_point(book, tag, name, call, ref, why=why)


def p20_punctured(dev, ns):
    """A spy on ``fused._launch`` counting, for each launch on a code of
    length n in ``ns`` ({n: punctured bit positions}), its LLRs at the
    punctured positions that are not zero; returns (the spy's state, the
    real function)."""
    from ldpc_tpu_torch.decode import fused
    seen = dict(calls=0, nonzero=torch.zeros((), dtype=torch.int64,
                                             device=dev))
    real = fused._launch

    def spy(flooding, llr, *args):
        punct = ns.get(llr.shape[1])
        if punct is not None:
            seen["calls"] += 1
            seen["nonzero"] += (llr[:, punct[0]:punct[-1] + 1] != 0).sum()
        return real(flooding, llr, *args)

    fused._launch = spy
    return seen, real


def phase20_tighten(dev, card, book, record):
    """(a): ``tighten89.main`` at P20_T89_SNR, each arm capped at
    P20_T89_CAP frames, Fisher-tested against
    ``experiments/tighten89_results.json``. Returns K1's launches."""
    from ldpc_tpu_torch.cli import tighten89 as t89

    t0 = time.perf_counter()
    saved = t89.SNRS, t89.MAX_FRAMES
    t89.SNRS, t89.MAX_FRAMES = (P20_T89_SNR,), P20_T89_CAP
    reset_counts()
    try:
        with SimWatch() as w:
            res = t89.main(device=dev)
    finally:
        t89.SNRS, t89.MAX_FRAMES = saved
    torch.cuda.synchronize()
    k1 = w.launches()
    only_k1("(a)", read_counts(), k1)
    print(f"  (a) tighten89 cut: {P20_T89_SNR} dB of (9.0, 9.2), frame cap "
          f"{P20_T89_CAP:,} (the program's 250,000,000 and 500 errors); "
          f"waves 262144, budget 4096, seed 99")
    key = f"{P20_T89_SNR:.1f}"
    for arm, call in zip(t89.ARMS, w.calls, strict=True):
        jp = record[arm][key]
        p20_point(book, "a", f"89/{arm}", call, (jp["errors"], jp["frames"]))
        if res[arm][key]["frames"] != call[5][3]:
            raise AssertionError(f"(a) {arm}: the file and the call differ")
    print(f"  (a) K1 launches {k1}; {time.perf_counter() - t0:.1f} s")
    return k1


def phase20_deep(dev, card, book, records):
    """(b): ``pbrl_rates.deep`` of P20_DEEP's arms from each record's first
    point, every point capped at P20_DEEP_CAP frames; each point beside
    the record's ``experiments/pbrl_rates_ck/<tag>_<arm>.json``. Returns
    K1's launches."""
    from ldpc_tpu_torch.cli import pbrl_rates as pr

    t0 = time.perf_counter()
    reset_counts()
    with SimWatch() as w:
        for tag, arms in P20_DEEP:
            start = min(float(k) for k in records[tag, arms[0]]["points"])
            pr.deep(tag, arms, snr_start=start, frames=P20_DEEP_CAP,
                    verbose=False, device=dev)
    torch.cuda.synchronize()
    k1 = w.launches()
    only_k1("(b)", read_counts(), k1)
    print(f"  (b) pbrl_rates deep cut: every point capped at "
          f"{P20_DEEP_CAP:,} frames (the program's 50,000,000), 100 errors; "
          f"{{5, 10}}, budget 4096, the rate's wave; from each record's "
          f"first point")
    calls = iter(w.calls)
    for tag, arms in P20_DEEP:
        for arm in arms:
            with open(os.path.join(pr.CK_DIR, f"{tag}_{arm}.json")) as f:
                pts = json.load(f)["points"]
            kinds = []
            for key in pts:
                call = next(calls)
                kinds.append(call[3])
                jp = records[tag, arm]["points"].get(key)
                p20_point(book, "b", f"{tag}/{arm}", call,
                          jp and (jp["errors"], jp["frames"]),
                          None if jp else "no record point")
            print(f"  (b) {tag}/{arm}: {len(pts)} points, waves "
                  f"{sum(k.get('compacted', 0) for k in kinds)} compacted, "
                  f"{sum(k.get('fallback', 0) for k in kinds)} fallback")
    if next(calls, None) is not None:
        raise AssertionError("(b) a call without a point")
    print(f"  (b) K1 launches {k1}; {time.perf_counter() - t0:.1f} s")
    return k1


def phase20_train(dev, card):
    """(c): ``pbrl_rates.train("89")`` cut to P20_TRAIN_SAMPLES frames (the
    engines: no launch), each step timed; its checkpoint through
    ``mk("wrcq-89")`` and one wave at P20_T89_SNR. Returns K1's
    launches."""
    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.cli import pbrl_rates as pr
    from ldpc_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    steps, real = [], lt.PosteriorJointTrainer.train_step

    def timed(self, *args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(self, *args, **kw)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t)
        return out

    saved = pr.NUM_SAMPLES
    pr.NUM_SAMPLES = P20_TRAIN_SAMPLES
    lt.PosteriorJointTrainer.train_step = timed
    reset_counts()
    try:
        with val_cut():
            h = pr.train("89", epochs=1, verbose=False, device=dev)
    finally:
        pr.NUM_SAMPLES = saved
        lt.PosteriorJointTrainer.train_step = real
    torch.cuda.synchronize()
    only_k1("(c) training", read_counts(), 0)
    t_train = time.perf_counter() - t0
    mk, punct, code = pr._mk_setup("89", dev)
    dec = mk("wrcq-89")
    saved_w = load_checkpoint(os.path.join(pr.CK_DIR, "orcq_89"))
    if not all(torch.equal(dec.weights[k].cpu(), saved_w[k])
               for k in ("beta", "alpha")):
        raise AssertionError("(c) wrcq-89 did not load the trained tables")
    cfg = lt.SimulationConfig(
        snr_range=(P20_T89_SNR,) * 2, max_frames=pr.wave_size(code.n),
        max_errors=10 ** 9, min_frames=0, wave_size=pr.wave_size(code.n),
        early_exit_iters=pr.EARLY_EXIT, survivor_budget=pr.BUDGET,
        punctured_positions=punct, save_results=False, device=dev)
    reset_counts()
    t1 = time.perf_counter()
    fer, ber, it, nf, ne = lt.simulate_single_snr(dec, P20_T89_SNR, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    k1 = read_counts()["K1"]
    only_k1("(c) wave", read_counts(), 2, 4)
    print(f"  (c) train cut: rate 8/9, {len(steps)} steps of "
          f"{pr.BATCH} ({P20_TRAIN_SAMPLES} frames, one epoch; the "
          f"program's 30 epochs of 2048), loss "
          f"{h['training_losses'][-1]:.5f}; step times "
          f"{[round(1e3 * s, 1) for s in steps]} ms (the first with the "
          f"warm-up); {t_train:.1f} s with validation (cut to {P_VAL} "
          f"frames, the trainer's 640)  [{card}]")
    print(f"  (c) wrcq-89 on the trained tables: one wave of {nf:,} frames "
          f"at {P20_T89_SNR} dB, {ne} frame errors, avg iterations "
          f"{it:.4f}, {secs:.2f} s, K1 launches {k1}  [{card}]")
    if len(steps) != P20_TRAIN_SAMPLES // pr.BATCH:
        raise AssertionError(f"(c) {len(steps)} training steps")
    return k1


def phase20(dev, card):
    """The section VII-C rate-family twins at the programs' widths;
    returns K1's launches and the largest posterior difference."""
    import tempfile

    from ldpc_tpu_torch.cli import pbrl_rates as pr
    from ldpc_tpu_torch.decode import fused

    print("[20 section VII-C rate-family twins]")
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "experiments",
                           "tighten89_results.json")) as f:
        t89_record = json.load(f)
    records = {}
    for tag, arms in P20_DEEP:
        for arm in arms:
            with open(os.path.join(root, "experiments", "pbrl_rates_ck",
                                   f"{tag}_{arm}.json")) as f:
                records[tag, arm] = json.load(f)
    ns = {}
    for tag in pr.RATES:
        base, lift, punct = pr.family(tag)
        ns[base.shape[1] * lift] = range(lift * punct[0],
                                         lift * (punct[0] + 1))
    cwd = os.getcwd()
    book = FisherBook(card)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        os.chdir(tmp)
        try:
            err, _ = phase20_checks(dev, card)
            print(f"  K1 checks {time.perf_counter() - t_phase:.1f} s")
            seen, real = p20_punctured(dev, ns)
            try:
                k_a = phase20_tighten(dev, card, book, t89_record)
                torch.cuda.empty_cache()
                k_b = phase20_deep(dev, card, book, records)
            finally:
                fused._launch = real
            nonzero = int(seen["nonzero"])
            print(f"  (a, b) {seen['calls']} K1 launches on the four codes, "
                  f"{nonzero} nonzero LLRs at their punctured positions")
            if nonzero or seen["calls"] != k_a + k_b:
                raise AssertionError("a punctured LLR reached K1 nonzero, "
                                     "or a launch went uncounted")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            rep = pr.report()
            print(f"  (d) report on (b)'s scans: rates "
                  f"{sorted(rep, key=float)}, {time.perf_counter() - t0:.2f}"
                  f" s (printed, not held: the cut scans stop short of "
                  f"FER 1e-6)")
        finally:
            os.chdir(cwd)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        os.chdir(tmp)
        try:
            k_c = phase20_train(dev, card)
        finally:
            os.chdir(cwd)
    k1 = k_a + k_b + k_c
    secs = time.perf_counter() - t_phase
    print(f"  {book.tested} points Fisher-tested against the JAX records; "
          f"K1 launches in phase 20 {k1} (a {k_a}, b {k_b}, c {k_c}), no "
          f"K4, K5 or K6; phase {secs:.1f} s (limit {P20_LIMIT} s)")
    if book.failed:
        raise AssertionError(f"points off the JAX records (p < {P15_P}): "
                             f"{book.failed}")
    if secs > P20_LIMIT:
        raise AssertionError(f"phase 20 took {secs:.1f} s, over "
                             f"{P20_LIMIT} s")
    return dict(K1=k1, k1_err=err)


def p21_check(dev, card, gen, name, dec, shapes):
    """K1 against its plain version at ``shapes`` ((iterations, batch)) of
    one phase 21 arm (:func:`phase16_checks`, the 86 punctured LLRs
    zero), with the decoder's K1 facts and its (iteration, base row)
    pairs on the per-block route. Returns (max |d posterior|, {(name, T,
    B): kernel ms})."""
    e, m = phase16_checks(dev, card, [
        (name, dec, T_, B_, False) for T_, B_ in shapes], gen, P21_SNR,
        tuple(range(dec.qc.lift)))
    pb = sum(not v for v in shared_pairs(dec).values())
    shapes = {k: tuple(v.shape) for k, v in dec.weights.items()
              if v is not None}
    print(k1_facts(dec, card) + f"; {name}: {dec.spec.kind}, tables "
          f"{shapes}, {pb} of {dec.max_iterations * dec.qc.mb} (iteration, "
          f"base row) pairs on the per-block route")
    torch.cuda.empty_cache()
    return e, m


def phase21_identities(dev, card):
    """(b): on the same B=4096 punctured LLRs at stage 2's T=10 through K1
    (full output) in f32 and bf16: ``train_matched``'s W-OMS-RCQ with
    every table zero against its plain designed (ref2) RCQ decoder, and
    ``pbrl_wrcq``'s ``rcq-ref3`` (design3's refined V2C ladder) against
    ``pbrl_honest_train``'s (the uniform 4-8-12). Each pair must agree in
    bits, success and iterations; the zero tables in f32 also in the
    posteriors' bit patterns. In bf16 the offset kinds round each v2c to
    bf16 before the check update where RCQ keeps it in f32, as the JAX
    kernel does, so there the posteriors may part (counted, printed); the
    V2C ladder sets the stored posterior's levels, so those part in both
    types. Not counted as the path's launches."""
    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.cli import pbrl_honest_train as ht
    from ldpc_tpu_torch.cli import pbrl_wrcq as pw
    from ldpc_tpu_torch.cli import train_matched as tm

    mk, punct = tm._setup(dev)
    rcq, zero = mk("rcq"), mk("orcq")
    zero = zero.replace_weights({k: torch.zeros_like(v)
                                 for k, v in zero.weights.items()})
    ref3 = pw.build_arms(("rcq-ref3",), dev)[0]["rcq-ref3"]
    uni = ht._setup(dev)[0]("rcq")
    gen = torch.Generator(device=dev).manual_seed(212)
    x32 = lt.puncture_llr(lt.awgn_llr(gen, torch.zeros(
        (pw.BUDGET, rcq.code.n), device=dev), P21_SNR), punct)
    for what, a, b in (("zero W-OMS-RCQ tables = RCQ ref2", zero, rcq),
                       ("rcq-ref3, design3's V2C ladder = the uniform "
                        "4-8-12", ref3, uni)):
        for x in (x32, x32.to(torch.bfloat16)):
            p = uncounted(lambda: kernel_on(x, a, pw.T, False))
            q = uncounted(lambda: kernel_on(x, b, pw.T, False))
            torch.cuda.synchronize()
            if not (torch.equal(p.bits, q.bits) and
                    torch.equal(p.success, q.success) and
                    torch.equal(p.iterations, q.iterations)):
                raise AssertionError(f"(b) {what} ({x.dtype}): bits, "
                                     f"success or iterations differ")
            moved = int((p.posterior != q.posterior).sum())
            if a is zero and x.dtype == torch.float32:
                same_bits(f"(b) {what}", p.posterior, q.posterior)
            print(f"  (b) {what}, {str(x.dtype)[6:]}: bits, success and "
                  f"iterations equal on B={x.shape[0]} (success "
                  f"{p.success.float().mean().item():.4f}); {moved:,} "
                  f"posterior values differ  [{card}]")


class P21Steps:
    """While open: each ``PosteriorJointTrainer``'s initial tables and its
    steps' seconds, and the trainer's validation cut to P_VAL frames."""

    def __enter__(self):
        import ldpc_tpu_torch as lt
        cls = lt.PosteriorJointTrainer
        self.real = cls.__init__, cls.train_step
        self.initial, self.steps = [], []
        self.cut = val_cut()
        init, step = self.real
        outer = self

        def watched_init(tr, decoder, *args, **kw):
            outer.initial.append({k: v.detach().cpu() for k, v in
                                  decoder.weights.items() if v is not None})
            outer.steps.append([])
            init(tr, decoder, *args, **kw)

        def timed(tr, *args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(tr, *args, **kw)
            torch.cuda.synchronize()
            outer.steps[-1].append(time.perf_counter() - t)
            return out

        cls.__init__, cls.train_step = watched_init, timed
        self.cut.__enter__()
        return self

    def __exit__(self, *exc):
        import ldpc_tpu_torch as lt
        self.cut.__exit__(*exc)
        lt.PosteriorJointTrainer.__init__, \
            lt.PosteriorJointTrainer.train_step = self.real


def p21_train(dev, card, mod, tag):
    """``mod.train_arm`` of every arm of ``mod.ARMS`` cut to one step of
    P21_SAMPLES frames (no launch), the validation to P_VAL frames; the
    saved tables finite with the shapes of the decoder's. Returns ({arm:
    (saved tables, initial tables)}, the line to print)."""
    from ldpc_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    full, out = mod.NUM_SAMPLES, {}
    mod.NUM_SAMPLES = P21_SAMPLES
    reset_counts()
    try:
        with P21Steps() as w:
            losses = {n: mod.train_arm(n, spec, epochs=1, verbose=False,
                                       device=dev)
                      for n, spec in mod.ARMS.items()}
    finally:
        mod.NUM_SAMPLES = full
    torch.cuda.synchronize()
    only_k1(f"({tag}) training", read_counts(), 0)
    for (name, spec), init, steps in zip(mod.ARMS.items(), w.initial,
                                         w.steps, strict=True):
        saved = load_checkpoint(os.path.join(mod.CK_DIR, name))
        if len(steps) != 1 or saved.keys() != init.keys() or not all(
                saved[k].shape == init[k].shape and
                bool(torch.isfinite(saved[k]).all()) for k in saved):
            raise AssertionError(f"({tag}) {name}: {len(steps)} steps, "
                                 f"tables {saved}")
        out[name] = (saved, init)
    return out, (
        f"  ({tag}) {mod.__name__.split('.')[-1]} train cut: each arm one "
        f"step of {P21_SAMPLES} frames (the program's 30 epochs of 2048), "
        f"validation {P_VAL} frames (the trainer's 640), on the engines "
        f"(no launch): " + ", ".join(
            f"{n} loss {losses[n]:.5f} in {1e3 * s[0]:.0f} ms, tables "
            + str({k: tuple(v.shape) for k, v in out[n][0].items()})
            for n, s in zip(mod.ARMS, w.steps)) +
        f"; {time.perf_counter() - t0:.1f} s  [{card}]")


def layered_step_launches():
    """CUDA launches of one training step of the zoo's layered recipe
    (``ZOO_LAYERED``, phase 11's trainer and configuration) on the card,
    from torch.profiler (device events only), and the traced step's
    seconds."""
    import ldpc_tpu_torch as lt
    dec = recipe_decoder(ZOO_LAYERED, torch.device("cuda"))
    tr = lt.PosteriorJointTrainer(dec, lt.TrainingConfig(**TR_LAYERED_CFG))
    batch = tr.sample()
    tr.train_step(*batch)   # the warm-up
    t0 = time.perf_counter()
    n = cuda_launches(lambda: tr.train_step(*batch), cpu=False)
    return n, time.perf_counter() - t0


def beside_phase13(card):
    """The work that run() puts in a worker process beside phase 13's (b)
    and (c), which time nothing they claim: phase 21's cut trainings
    (:func:`p21_train_all`) and phase 11's launch count of a layered
    training step (:func:`layered_step_launches`). Returns (the trainings,
    (launches, seconds))."""
    return p21_train_all(card), layered_step_launches()


# phases 14-22 run in three processes (run()): these two lanes in worker
# processes, phases 15, 19 and then 20 in the script's own (19 takes the
# design of the worker that runs from the start, 18 its spectra)
LANES = (("phase14", "phase16", "phase17"),
         ("phase18", "phase21", "phase22"))
LANE_TIMEOUT = 900


def lane_phases(names):
    return [n[len("phase"):] for n in names]


def seconds_of(fn):
    """Seconds that ``fn()`` takes."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def lane(card, jobs, log):
    """Phases run in a worker process beside the script's own: ``jobs``
    holds (phase function's name, extra arguments), each called as
    ``phase(dev, card, *extra)`` on the card, one after another. The
    process's standard output goes to the file ``log`` meanwhile, for
    run() to print after. Returns ({name: the phase's result}, seconds,
    peak device memory reserved in GiB)."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    sys.stdout.flush()
    keep = os.dup(1)
    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 1)
    os.close(fd)
    try:
        out = {}
        for name, extra in jobs:
            out[name] = globals()[name](dev, card, *extra)
            torch.cuda.empty_cache()
        return (out, time.perf_counter() - t0,
                torch.cuda.max_memory_reserved() / 2 ** 30)
    finally:
        sys.stdout.flush()
        os.dup2(keep, 1)
        os.close(keep)


def phase11_traced(card, traced):
    """Phase 11's launch count of a layered step, ``(launches, seconds)``
    from :func:`layered_step_launches`."""
    n, secs = traced
    print(f"  (phase 11) layered: {n} CUDA launches per step "
          f"(torch.profiler, device events; traced in a worker process "
          f"beside phase 13), the traced step {secs:.1f} s  [{card}]")
    if not n:
        raise AssertionError("the profiler saw no launch of the layered "
                             "step")


def p21_train_all(card, dev="cuda"):
    """Phase 21's cut trainings, (d) ``pbrl_honest_train``'s five arms and
    (e) ``train_matched``'s four, on the card in a working directory of
    their own. Returns {tag: ({arm: (saved tables, initial tables)},
    line)}."""
    import tempfile

    from ldpc_tpu_torch.cli import pbrl_honest_train as ht
    from ldpc_tpu_torch.cli import train_matched as tm

    root = os.path.dirname(os.path.abspath(__file__))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        os.chdir(tmp)
        try:
            return {tag: p21_train(torch.device(dev), card, mod, tag)
                    for tag, mod in (("d", ht), ("e", tm))}
        finally:
            os.chdir(cwd)


def p21_sims(tag, book, calls, names, refs, checks):
    """Each watched call of (c)-(e) beside its record point ``refs[name]``
    ((errors, frames)): Fisher-tested where both hold at least P15_MIN
    errors and successes. Fails when a wave of an arm whose whole decode
    was not checked (``checks``: {name: shapes}) fell back."""
    for name, call in zip(names, calls, strict=True):
        p20_point(book, tag, name, call, refs[name])
        whole = (call[0].max_iterations, call[2].wave_size) in checks.get(
            name, ())
        if call[3].get("fallback") and not whole:
            raise AssertionError(f"({tag}) {name} fell back unchecked: "
                                 f"{call[3]}")


def phase21(dev, card, trained):
    """The precoded-PBRL training twins at the programs' widths; returns
    K1's launches and the largest posterior difference. ``trained`` is
    :func:`p21_train_all`'s result (the script runs it beside phase
    13)."""
    import tempfile

    from ldpc_tpu_torch.cli import pbrl_honest_train as ht
    from ldpc_tpu_torch.cli import pbrl_wrcq as pw
    from ldpc_tpu_torch.cli import train_matched as tm
    from ldpc_tpu_torch.decode import fused

    print("[21 precoded-PBRL training twins]")
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    recs = {}
    for prog in ("pbrl_honest_dev", "pbrl_honest_train_results"):
        with open(os.path.join(root, "experiments", f"{prog}.json")) as f:
            recs[prog] = {k: (v["2.0"]["errors"], v["2.0"]["frames"])
                          for k, v in json.load(f).items()}
    checks = dict(P21_CHECKS)
    book, err = FisherBook(card), 0.0
    gen = torch.Generator(device=dev).manual_seed(21)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        os.chdir(tmp)
        try:
            # (a) the pbrl_wrcq arms; the trained ones install the JAX
            # program's tables (pbrl_wrcq_tables.npz) into the working
            # directory
            arms, punct = pw.build_arms(
                tuple(n for n, _ in P21_CHECKS if "/" not in n), dev)
            with np.load(pw.TABLES) as f:
                for name in ("wrcq-ref3", "wrcq-ref3pl"):
                    ck = f"orcq_{name[5:]}"
                    if not all(torch.equal(arms[name].weights[k].cpu(),
                                           torch.from_numpy(f[f"{ck}/{k}"]))
                               for k in ("beta", "alpha")):
                        raise AssertionError(f"(a) {name} does not decode "
                                             f"with {ck}'s tables")
            print(f"  (a) wrcq-ref3 and wrcq-ref3pl decode with the JAX "
                  f"program's orcq_ref3 and orcq_ref3pl tables "
                  f"(pbrl_wrcq_tables.npz); rcq-dde's CN ladder (one pair "
                  f"an iteration) {pw._ladder('dde')[0]}; rcq-ref4's V2C "
                  f"ladder {pw._ladder('ref4')[1]}")
            for name, dec in arms.items():
                e, _ = p21_check(dev, card, gen, name, dec, checks[name])
                err = max(err, e)
            del arms
            phase21_identities(dev, card)
            print(f"  (a, b) {time.perf_counter() - t_phase:.1f} s")
            # (d) training first: its arms' K1 checks need the tables
            (ht_tabs, line_d), (tm_tabs, line_e) = trained["d"], trained["e"]
            print(line_d)
            print(line_e)
            if any(v.any() for v in tm_tabs["zinit"][1].values()) or any(
                    v.any() for v in ht_tabs["worcq-low"][1].values()):
                raise AssertionError("(e) zinit / (d) worcq-low did not "
                                     "start from zero tables")
            print("  (d, e) zinit and worcq-low start from all-zero tables")
            mk, _ = ht._setup(dev)
            for name, shapes in P21_CHECKS:
                if name.startswith("ht/"):
                    arm = name[3:]
                    if arm == "rcq-ref3":
                        dec = mk("rcq")
                    else:
                        spec = ht.ARMS[arm]
                        dec = mk(spec["kind"], per_layer=spec["per_layer"],
                                 weights=ht_tabs[arm][0])
                    e, _ = p21_check(dev, card, gen, name, dec, shapes)
                    err = max(err, e)
            print(f"  K1 checks and training "
                  f"{time.perf_counter() - t_phase:.1f} s")
            seen, real = p20_punctured(dev, {mk("rcq").code.n: punct})
            try:
                t0 = time.perf_counter()
                reset_counts()
                with SimWatch() as w:
                    pw.dev_fer(snrs=(P21_SNR,), which=P21_DEV,
                               out_path="dev.json", verbose=False, device=dev)
                    pw.dev_fer(frames=P21_OMS_CAP, snrs=(P21_SNR,),
                               which=("oms6",), out_path="dev_oms6.json",
                               verbose=False, device=dev)
                torch.cuda.synchronize()
                k_c = w.launches()
                only_k1("(c)", read_counts(), k_c)
                print(f"  (c) pbrl_wrcq dev cut: {P21_SNR} dB of (2.0, 2.4); "
                      f"oms6 capped at {P21_OMS_CAP:,} frames (the program's "
                      f"20,000,000); waves {pw.WAVE}, budget {pw.BUDGET}, 100 "
                      f"errors; K1 launches {k_c}; "
                      f"{time.perf_counter() - t0:.1f} s")
                p21_sims("c", book, w.calls, P21_DEV + ("oms6",),
                         recs["pbrl_honest_dev"], checks)
                t0 = time.perf_counter()
                reset_counts()
                with SimWatch() as w:
                    ht.dev((), frames=P21_OMS_CAP, snrs=(P21_SNR,),
                           verbose=False, device=dev)
                torch.cuda.synchronize()
                k_d = w.launches()
                only_k1("(d)", read_counts(), k_d)
                print(f"  (d) pbrl_honest_train dev cut: {P21_SNR} dB of "
                      f"(2.0, 2.4), the trained arms left out, every point "
                      f"capped at {P21_OMS_CAP:,} frames (the program's "
                      f"50,000,000); waves {ht.WAVE}, budget {ht.BUDGET}, "
                      f"100 errors; K1 launches {k_d}; "
                      f"{time.perf_counter() - t0:.1f} s")
                p21_sims("d", book, w.calls, ("oms6", "ht/rcq-ref3"), {
                    "oms6": recs["pbrl_honest_train_results"]["oms6"],
                    "ht/rcq-ref3": recs["pbrl_honest_train_results"][
                        "rcq-ref3"]}, checks)
                t0 = time.perf_counter()
                reset_counts()
                with SimWatch() as w:
                    res = tm.dev((), verbose=False, device=dev)
                torch.cuda.synchronize()
                k_e = w.launches()
                only_k1("(e)", read_counts(), k_e)
                print(f"  (e) train_matched dev: the designed decoder (rcq-"
                      f"ref2) at {P21_SNR} dB, the trained arms left out; "
                      f"{tm.MIN_FRAMES} frames at least, 300 errors; K1 "
                      f"launches {k_e}; {time.perf_counter() - t0:.1f} s")
                p21_sims("e", book, w.calls, ("designed",), {
                    "designed": recs["pbrl_honest_dev"]["rcq-ref2"]},
                    checks)
                if list(res) != ["designed"]:
                    raise AssertionError(f"(e) {list(res)}")
            finally:
                fused._launch = real
        finally:
            os.chdir(cwd)
    nonzero, k1 = int(seen["nonzero"]), k_c + k_d + k_e
    print(f"  (c-e) {seen['calls']} K1 launches on the precoded code, "
          f"{nonzero} nonzero LLRs at its 86 punctured positions")
    if nonzero or seen["calls"] != k1:
        raise AssertionError("a punctured LLR reached K1 nonzero, or a "
                             "launch went uncounted")
    secs = time.perf_counter() - t_phase
    print(f"  {book.tested} points Fisher-tested against the JAX records; "
          f"K1 launches in phase 21 {k1} (c {k_c}, d {k_d}, e {k_e}), no "
          f"K4, K5 or K6; phase {secs:.1f} s (limit {P21_LIMIT} s)")
    if book.failed:
        raise AssertionError(f"points off the JAX records (p < {P15_P}): "
                             f"{book.failed}")
    if secs > P21_LIMIT:
        raise AssertionError(f"phase 21 took {secs:.1f} s, over "
                             f"{P21_LIMIT} s")
    return dict(K1=k1, k1_err=err)


P22_PROGRAMS = ("pbrl_bv10", "pbrl_cn_probe", "pbrl_vqp_sweep",
                "pbrl_vqp_gamma")
# (c): (program, its arms kept, SNR points) a main call
P22_RUNS = (("pbrl_bv10", (P22_BOTH.split("/")[1],), (P22_SNR, P22_HI)),
            ("pbrl_bv10", ("bc4_bv10", "bc5_bv10"), (P22_SNR,)),
            ("pbrl_vqp_sweep", None, (P22_SNR,)),
            ("pbrl_vqp_gamma", None, (P22_SNR,)),
            ("pbrl_cn_probe", None, (P22_SNR,)))


def p22_arms(dev):
    """({"program/arm": decoder} of the four probe twins' ``build_arms``,
    the punctured bit positions)."""
    import importlib
    arms = {}
    for prog in P22_PROGRAMS:
        got, punct = importlib.import_module(
            f"ldpc_tpu_torch.cli.{prog}").build_arms(dev)
        arms.update({f"{prog}/{k}": v for k, v in got.items()})
    return arms, punct


def phase22_identities(dev, card, arms, ref3, punct):
    """(b): on one stage-1 (T=5, B=32768) and one stage-2 (T=10, B=4096)
    wave of punctured bf16 LLRs through K1 (full output), each arm of
    P22_REF3_CLASS against ``pbrl_wrcq``'s rcq-ref3 (``ref3``) and
    bc5_vr96 against bc5_bv10: bits, success and iterations equal. Only
    the posterior passes through the V2C quantizer, so the posteriors'
    levels part; the values apart are printed. Not counted as the path's
    launches."""
    import ldpc_tpu_torch as lt
    gen = torch.Generator(device=dev).manual_seed(222)
    n = ref3.code.n
    for T_, B_ in P22_WAVES:
        x = lt.puncture_llr(lt.awgn_llr(gen, torch.zeros(
            (B_, n), device=dev), P22_SNR), punct).to(torch.bfloat16)
        for ref_name, ref, members in (
                ("pbrl_wrcq/rcq-ref3", ref3, P22_REF3_CLASS),
                (P22_BC5_CLASS[0], arms[P22_BC5_CLASS[0]],
                 P22_BC5_CLASS[1:])):
            want = uncounted(lambda: kernel_on(x, stage_of(ref, T_), T_,
                                               False))
            parts = []
            for name in members:
                got = uncounted(lambda: kernel_on(
                    x, stage_of(arms[name], T_), T_, False))
                torch.cuda.synchronize()
                if not (torch.equal(got.bits, want.bits) and
                        torch.equal(got.success, want.success) and
                        torch.equal(got.iterations, want.iterations)):
                    raise AssertionError(f"(b) {name} does not decode as "
                                         f"{ref_name} at T={T_}, B={B_}")
                parts.append(f"{name.split('/')[1]} "
                             f"{int((got.posterior != want.posterior).sum()):,}")
                del got
            print(f"  (b) T={T_}, B={B_}: {len(members)} arms decode as "
                  f"{ref_name} (bits, success and iterations equal; "
                  f"success {want.success.float().mean().item():.4f}); "
                  f"posterior values apart of {want.posterior.numel():,}: "
                  + ", ".join(parts) + f"  [{card}]")
            del want
        del x
        torch.cuda.empty_cache()


def p22_refs(root):
    """{"program/arm": {SNR: (errors, frames)}} of the honest references
    (pbrl_honest_dev.json's rcq-ref3 for P22_REF3_CLASS; for the others
    the entry of P22_REFERENCE that counts or names the arm), and the
    retracted records."""
    with open(os.path.join(root, "experiments", "pbrl_honest_dev.json")) as f:
        ref3 = {float(s): (v["errors"], v["frames"])
                for s, v in json.load(f)["rcq-ref3"].items()}
    refs = dict.fromkeys(P22_REF3_CLASS, ref3)
    with open(os.path.join(root, P22_REFERENCE)) as f:
        for e in json.load(f).values():
            if e["apart"] or e["frames"] < 262144:
                raise AssertionError(f"reference {e}")
            for arm in [e["counted_as"]] + e["same_decode"]:
                refs[arm] = {e["snr"]: (e["errors"], e["frames"])}
    retracted = {}
    for prog in P22_PROGRAMS:
        with open(os.path.join(root, "experiments",
                               f"{prog}_results.json")) as f:
            for arm, pts in json.load(f).items():
                retracted[f"{prog}/{arm}"] = {
                    float(s): (v["errors"], v["frames"])
                    for s, v in pts.items()}
    if set(refs) != set(retracted):
        raise AssertionError(f"arms without a reference: "
                             f"{set(retracted) ^ set(refs)}")
    return refs, retracted


def phase22_sweeps(dev, card, book, refs, retracted, checked):
    """(c): P22_RUNS through each twin's ``main`` (arms cut by wrapping its
    ``build_arms``), every point capped at P22_CAP frames; each point
    beside its honest reference (Fisher-tested, :func:`p20_point`) and
    its retracted record (printed). Fails when a wave of an arm whose
    whole decode is not in ``checked`` fell back. Returns K1's
    launches."""
    import importlib
    import logging
    level = logging.getLogger().level
    reset_counts()
    t0 = time.perf_counter()
    with SimWatch() as w:
        names = []
        for i, (prog, keep, snrs) in enumerate(P22_RUNS):
            mod = importlib.import_module(f"ldpc_tpu_torch.cli.{prog}")
            real = mod.build_arms

            def cut(device="cuda", real=real, keep=keep):
                arms, punct = real(device)
                return ({k: v for k, v in arms.items()
                         if keep is None or k in keep}, punct)
            mod.build_arms = cut
            try:
                res = mod.main(frames=P22_CAP, snrs=snrs,
                               out_path=f"{prog}_{i}.json", device=dev)
            finally:
                mod.build_arms = real
                logging.getLogger().setLevel(level)
            names += [f"{prog}/{arm}" for arm in res for _ in snrs]
    torch.cuda.synchronize()
    k1 = w.launches()
    only_k1("(c)", read_counts(), k1)
    print(f"  (c) the twins' main cut: {len(names)} points of 28, each "
          f"capped at {P22_CAP:,} frames (the programs' 20,000,000); "
          f"{P22_HI} dB kept for {P22_BOTH} alone; waves {P22_WAVE}, "
          f"budget {P22_BUDGET}, 100 errors; K1 launches {k1}; "
          f"{time.perf_counter() - t0:.1f} s")
    for name, call in zip(names, w.calls, strict=True):
        snr = round(call[1], 2)
        ref = refs[name].get(snr)
        p20_point(book, "c", name, call, ref,
                  why=None if ref else "no honest reference at this SNR")
        e, f = retracted[name][snr]
        print(f"  (c) {name} @ {snr:.2f} dB: retracted record {e}/{f} "
              f"(FER {e / f:.4g}; experiments/{name.split('/')[0]}"
              f"_results.json, before the decision-bias fix), not tested")
        if call[3].get("fallback") and name not in checked:
            raise AssertionError(f"(c) {name} fell back unchecked: "
                                 f"{call[3]}")
    return k1


def phase22(dev, card):
    """The PBRL V2C/CN probe twins at the programs' widths; returns K1's
    launches and the largest posterior difference."""
    import tempfile

    from ldpc_tpu_torch.cli import pbrl_wrcq as pw
    from ldpc_tpu_torch.decode import fused

    print("[22 PBRL V2C/CN probe twins]")
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    refs, retracted = p22_refs(root)
    arms, punct = p22_arms(dev)
    book, err = FisherBook(card), 0.0
    gen = torch.Generator(device=dev).manual_seed(22)
    checked = set()
    for name, shapes in P22_CHECKS:
        dec = arms[name]
        e, _ = phase16_checks(dev, card, [
            (name, dec, T_, B_, False) for T_, B_ in shapes], gen, P22_SNR,
            punct)
        err = max(err, e)
        if (10, P22_WAVE) in shapes:
            checked.add(name)
        spec = dec.spec
        print(k1_facts(dec, card) + f"; {name}: {spec.q_levels}-level C2V "
              f"and {spec.v2c_levels}-level V2C quantizers, closed form "
              f"{closed_of(dec)}")
        torch.cuda.empty_cache()
    print(f"  (a) {time.perf_counter() - t_phase:.1f} s")
    ref3 = pw.build_arms(("rcq-ref3",), dev)[0]["rcq-ref3"]
    phase22_identities(dev, card, arms, ref3, punct)
    n = ref3.code.n
    del arms, ref3
    torch.cuda.empty_cache()
    print(f"  (a, b) {time.perf_counter() - t_phase:.1f} s")
    cwd = os.getcwd()
    seen, real = p20_punctured(dev, {n: punct})
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        os.chdir(tmp)
        try:
            k1 = phase22_sweeps(dev, card, book, refs, retracted, checked)
        finally:
            fused._launch = real
            os.chdir(cwd)
    nonzero = int(seen["nonzero"])
    print(f"  (c) {seen['calls']} K1 launches on the precoded code, "
          f"{nonzero} nonzero LLRs at its 86 punctured positions")
    if nonzero or seen["calls"] != k1:
        raise AssertionError("a punctured LLR reached K1 nonzero, or a "
                             "launch went uncounted")
    secs = time.perf_counter() - t_phase
    print(f"  {book.tested} points Fisher-tested against the honest "
          f"references; K1 launches in phase 22 {k1}, no K4, K5 or K6; "
          f"phase {secs:.1f} s (limit {P22_LIMIT} s)")
    if book.failed:
        raise AssertionError(f"points off the honest references (p < "
                             f"{P15_P}): {book.failed}")
    if book.tested != 15:
        raise AssertionError(f"{book.tested} points tested, want 15")
    if secs > P22_LIMIT:
        raise AssertionError(f"phase 22 took {secs:.1f} s, over "
                             f"{P22_LIMIT} s")
    return dict(K1=k1, k1_err=err)


def run(design, de, spectrum):
    """Phases 1-22; ``design``, ``de`` and ``spectrum`` are the result
    handles of :func:`bench_design`, :func:`de_data` and
    :func:`spectrum_data` running in a worker process."""
    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.cli.bench import device_line
    from ldpc_tpu_torch.decode import _build, two_checkpoint_stages
    from ldpc_tpu_torch.sim import point_generator

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = device_line(dev)
    print(f"[1 device] {card}  (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")

    # phase 10 runs on the card while nvcc builds the library in a thread:
    # it launches no kernel of the library (and fails if it does)
    t0 = time.perf_counter()
    fresh = not _build.library_path().exists()
    with concurrent.futures.ThreadPoolExecutor(1) as nvcc:
        built = nvcc.submit(seconds_of, _build.load_library)
        phase10(dev, card)
        torch.cuda.empty_cache()
    print(f"[2 build] {built.result():.1f} s "
          f"({'built' if fresh else 'cached'}) {_build.library_path().name}"
          f", beside phase 10 ({time.perf_counter() - t0:.1f} s for both)")
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
    print(k4_facts(zdec, card))

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

    # the first wave's first SIM_CPU frames against the plain path on the
    # CPU
    sub = lt.awgn_llr(point_generator(cfg.seed, 0, dev),
                      torch.zeros((SIM_WAVE, zdec.code.n), device=dev),
                      torch.tensor(snrs[0], device=dev))[:SIM_CPU]
    two = lt.make_two_checkpoint_decoder(zdec, t1=SIM_T1,
                                         survivor_budget=SIM_BUDGET)
    g_out, g_n = two(sub)
    c_out, c_n = two(sub.cpu())
    agree = (g_out.bits.cpu() == c_out.bits).float().mean().item()
    if int(g_n) != int(c_n) or agree < 0.9999 or not torch.equal(
            g_out.success.cpu(), c_out.success):
        raise AssertionError(f"simulator wave vs plain on the CPU: survivors "
                             f"{int(g_n)} vs {int(c_n)}, bits {agree}")
    print(f"  first {SIM_CPU} frames of the first wave vs the CPU plain "
          f"path: "
          f"survivors {int(g_n)}, bits agree {agree:.6f}, success equal")

    del sub, g_out, c_out
    torch.cuda.empty_cache()
    rc = phase7(code, qc, dataclasses.replace(
        zdec, qc_options=None), gen, dev, card)
    rc_counts = phase8(zdec, dev, card)
    torch.cuda.empty_cache()
    phase9(dev, card)
    torch.cuda.empty_cache()
    phase11(dev, card)
    torch.cuda.empty_cache()
    p12_launches, p12_err = phase12(dev, card, design)
    torch.cuda.empty_cache()
    # phase 21's cut trainings and phase 11's traced layered step run in a
    # worker process beside phase 13's untimed (b) and (c); leaving the
    # pool frees the worker's share of the card
    with multiprocessing.get_context("spawn").Pool(1) as side:
        work = []
        p13 = phase13(dev, card, dec, 1e3 * secs / n_timed, de, lambda: (
            work.append(side.apply_async(beside_phase13, (card,)))))
        t0 = time.perf_counter()
        p21_trained, traced = work[0].get(timeout=900)
    print(f"  phase 21's nine cut trainings and phase 11's traced layered "
          f"step ran in a worker process beside phase 13's (b) and (c); "
          f"waited {time.perf_counter() - t0:.1f} s for them after phase "
          f"13")
    phase11_traced(card, traced)
    torch.cuda.empty_cache()

    # phases 14-22 in three processes: 15, 19 and then 20 here, each of
    # LANES in a worker process of its own; phase 18 there takes the
    # spectra of the worker that runs from the start. A lane's output is
    # printed after phase 20, and a phase failing there fails the script
    # as here
    import tempfile
    t0 = time.perf_counter()
    spectra = (*spectrum.get(), time.perf_counter() - t0)
    extra = dict(phase18=(spectra,), phase21=(p21_trained,))
    root = os.path.dirname(os.path.abspath(__file__))
    each = " and ".join(", ".join(lane_phases(names)) for names in LANES)
    print(f"[lanes] phases {each}, each lane in a worker process of its "
          f"own, beside phases 15, 19 and then 20 here; their output "
          f"follows phase 20's")
    t_lanes = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root) as logs, \
            multiprocessing.get_context("spawn").Pool(len(LANES)) as pool:
        paths = [os.path.join(logs, f"lane{i}.txt")
                 for i in range(len(LANES))]
        jobs = [pool.apply_async(lane, (card, [(n, extra.get(n, ()))
                                               for n in names], path))
                for names, path in zip(LANES, paths)]
        try:
            p15 = phase15(dev, card)
            torch.cuda.empty_cache()
            p19 = phase19(dev, card, design.get()[:3])
            torch.cuda.empty_cache()
            p20 = phase20(dev, card)
            torch.cuda.empty_cache()
            here = time.perf_counter() - t_lanes
            t0 = time.perf_counter()
            done = [job.get(timeout=LANE_TIMEOUT) for job in jobs]
        finally:
            for names, path in zip(LANES, paths):
                print(f"[lane] phases {', '.join(lane_phases(names))}, in a "
                      f"worker process:")
                if os.path.exists(path):
                    with open(path) as f:
                        print(f.read(), end="", flush=True)
    results = {}
    for names, (res, secs_lane, peak) in zip(LANES, done):
        results.update(res)
        print(f"  lane {', '.join(lane_phases(names))}: {secs_lane:.1f} s, "
              f"peak memory reserved {peak:.2f} GiB  [{card}]")
    print(f"  phases 15, 19 and 20 here {here:.1f} s, then waited "
          f"{time.perf_counter() - t0:.1f} s for the lanes; phases 14-22 "
          f"{time.perf_counter() - t_lanes:.1f} s")
    p14, p16, p17, p18, p21, p22 = (results[f"phase{i}"]
                                    for i in (14, 16, 17, 18, 21, 22))

    print(f"[script] {time.perf_counter() - T_START:.1f} s from the start")
    print(card)
    k4 = k4_times[SIM_WAVE]
    print(json.dumps({"kernels": [{
        "name": "fused_layered",
        "route": "cuda",
        "source": "ldpc_tpu_torch/csrc/fused_layered.cu",
        "replaces": "ldpc_tpu/decode/pallas_fused.py:467",
        "launches": (launches + p12_launches + p13["K1"] + p14["K1"] +
                     p15["K1"] + p16["K1"] + p17["K1"] + p18["K1"] +
                     p19["K1"] + p20["K1"] + p21["K1"] + p22["K1"]),
        "max_abs_err": max(max_err, p12_err, p14["k1_err"], p15["k1_err"],
                           p16["k1_err"], p17["k1_err"], p18["k1_err"],
                           p19["k1_err"], p20["k1_err"], p21["k1_err"],
                           p22["k1_err"]),
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
        "launches": k4_launches + p13["K4"] + p14["K4"] + p15["K4"],
        "max_abs_err": max(k4_err, p14["k4_err"], p15["k4_err"]),
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
    # phase 12's design, phase 13's DE curves and phase 18's trapping-set
    # spectra are host numpy for minutes together: they run one after
    # another in a worker process from the start, beside phases 1-11
    # (leaving the pool terminates the worker)
    base = np.random.default_rng(0).integers(0, 256, size=(5, 37))
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        run(pool.apply_async(bench_design, (base,)),
            pool.apply_async(de_data), pool.apply_async(spectrum_data))


if __name__ == "__main__":
    main()
