"""Example scenarios of the PyTorch port (twin of the root ``examples.py``).

The same scenario names and printouts as the JAX package's demo CLI:
decode demos for every decoder family, training, Monte-Carlo simulation,
weight-pattern and gradient analysis, the quantizer round trip,
checkpoints, the zoo, ladder design, the encoder and the error floor.

    python -m ldpc_tpu_torch.cli.examples quick [--device cpu]
    python -m ldpc_tpu_torch.cli.examples [--device cpu]         # all
    python -m ldpc_tpu_torch.cli.examples <name> [--device cpu]  # one

Every scenario runs on ``--device`` (the card by default). The figure of
'simulation' needs matplotlib and is skipped where it is not installed.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
import tempfile
import time

import numpy as np
import torch

import ldpc_tpu_torch as lt


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _fer(out) -> float:
    return out.bits.ne(0).any(dim=1).float().mean().item()


def example_basic_decoding(device="cuda"):
    """Fixed-factor min-sum on the (7,4) test code (reference example 1)."""
    code = lt.create_test_ldpc_code()
    dec = lt.basic_min_sum(code, factor=0.7, device=device)
    llr = lt.simulate_awgn_channel(
        _gen(0, device), torch.zeros(code.n, device=device), 4.0)
    bits, success, iters = dec.decode(llr)
    print(f"  (7,4) decode @4dB: success={bool(success)} iters={int(iters)} "
          f"bits={bits.tolist()}")


def example_neural_decoders(device="cuda"):
    """N-NMS / N-OMS forward passes + parameter counts (reference ex. 2-3)."""
    code = lt.create_test_ldpc_code()
    llr = lt.simulate_awgn_channel(
        _gen(1, device), torch.zeros(code.n, device=device), 2.0)
    for make in (lt.neural_min_sum, lt.neural_offset_min_sum):
        dec = make(code, max_iterations=10, device=device)
        out = dec(llr)
        print(f"  {dec.name}: params={dec.param_count()} "
              f"success={bool(out.success)} iters={int(out.iterations)}")


def example_2d_weight_sharing(device="cuda"):
    """N-2D-NMS/-OMS types 1-4 and their parameter counts (reference ex. 4)."""
    code = lt.create_test_ldpc_code()
    for t in (1, 2, 3, 4):
        nms = lt.neural_2d_min_sum(code, weight_sharing_type=t,
                                   max_iterations=10, device=device)
        oms = lt.neural_2d_offset_min_sum(code, weight_sharing_type=t,
                                          max_iterations=10, device=device)
        print(f"  type {t}: N-2D-NMS params={nms.param_count()}  "
              f"N-2D-OMS params={oms.param_count()}")


def example_rcq_decoding(device="cuda"):
    """RCQ / W-RCQ with the quantizer schedule (reference ex. 5-6)."""
    q = lt.NonUniformQuantizer(bc=3, C=5.0, gamma=1.5)
    x = torch.tensor([-3.2, -1.1, 0.5, 2.8, 4.1])
    codes = q.quantize(x)
    back = q.dequantize(codes)
    print(f"  quantizer round-trip: {x.tolist()} -> {codes.tolist()} -> "
          f"{np.round(back.numpy(), 3).tolist()}")

    code = lt.create_peg_code(n=128, m=64, dv=3, seed=0, max_iterations=12)
    llr = lt.awgn_llr(_gen(2, device),
                      torch.zeros((64, code.n), device=device), 3.0)
    for dec in (lt.rcq_min_sum(code, bc=3, bv=8, device=device),
                lt.weighted_rcq(code, bc=3, weight_sharing_type=2,
                                device=device)):
        out = dec(llr)
        note = ("  (untrained: W-RCQ weights need training — "
                "see examples 'training' / experiments/train_wrcq.py)"
                if dec.name.startswith("W-RCQ") else "")
        print(f"  {dec.name}: FER@3dB={_fer(out):.3f} "
              f"avg_iters={out.iterations.float().mean().item():.1f}{note}")


def example_oms_rcq(device="cuda"):
    """W-OMS-RCQ — the paper's FPGA headline decoder (§VII-B, Table III),
    absent from the reference implementation."""
    code = lt.create_peg_code(n=128, m=64, dv=3, seed=0, max_iterations=12)
    llr = lt.awgn_llr(_gen(9, device),
                      torch.zeros((64, code.n), device=device), 3.0)
    dec = lt.weighted_oms_rcq(code, bc=3, bv=8, weight_sharing_type=2,
                              max_iterations=12, device=device)
    out = dec(llr)
    print(f"  {dec.name}: params={dec.param_count()} "
          f"FER@3dB={_fer(out):.3f}")
    print("  c2v = qdq(sign * (relu(mag - beta) - alpha)); train via the "
          "'training' scenario machinery (STE through quantizer + offset)")


def example_published_codes(device="cuda"):
    """Published closed-form QC codes: Tanner (155, 64, 20) and Fan array
    codes, decoded through the QC roll engine."""
    code = lt.create_tanner_155(max_iterations=20)
    qc = lt.build_qc_graph(lt.tanner_155_base(), 31)
    dec = lt.make_decoder(code, kind="ms", max_iterations=20, qc=qc,
                          device=device)
    print(f"  Tanner(155,64): rate={code.rate:.3f} "
          f"(3,5)-regular, girth 8, d_min 20")
    for snr in (2.0, 3.0, 4.0):
        llr = lt.awgn_llr(_gen(int(snr * 10), device),
                          torch.zeros((512, code.n), device=device), snr)
        print(f"    FER@{snr:.0f}dB = {_fer(dec(llr)):.4f}")
    arr = lt.create_array_code(13, 3, 5)
    print(f"  array(p=13,3,5): ({arr.n},{arr.k}) rate={arr.rate:.3f}")


def example_layered_decoding(device="cuda"):
    """Layered-schedule RCQ (the reference's broken `_decode_layered`,
    implemented correctly — SURVEY §8.3)."""
    code = lt.create_peg_code(n=128, m=64, dv=3, seed=0, max_iterations=8)
    llr = lt.awgn_llr(_gen(3, device),
                      torch.zeros((64, code.n), device=device), 3.0)
    flood = lt.rcq_min_sum(code, bc=4, max_iterations=8, device=device)
    layer = lt.rcq_min_sum(code, bc=4, max_iterations=8, layered=True,
                           device=device)
    for dec in (flood, layer):
        out = dec(llr)
        sched = "layered" if dec.layered else "flooding"
        print(f"  {sched}: FER={_fer(out):.3f} "
              f"avg_iters={out.iterations.float().mean().item():.2f}")


def example_training(device="cuda"):
    """Posterior-joint training of N-2D-NMS type 2 (reference ex. 7)."""
    code = lt.create_peg_code(n=128, m=64, dv=3, seed=0, max_iterations=8)
    dec = lt.neural_2d_min_sum(code, weight_sharing_type=2, max_iterations=8,
                               device=device)
    tr = lt.PosteriorJointTrainer(
        dec, lt.TrainingConfig(batch_size=128, num_epochs=5,
                               learning_rate=5e-3, snr_range=(1, 4)))
    hist = tr.train(num_samples=1024, verbose=False)
    print(f"  loss {hist['training_losses'][0]:.4f} -> "
          f"{hist['training_losses'][-1]:.4f}, "
          f"acc {hist['training_accuracies'][-1]:.4f}, "
          f"{hist['train_time']:.1f}s")


def example_gradient_analysis(device="cuda"):
    """Gradient-explosion analysis (reference ex. 8)."""
    code = lt.create_test_ldpc_code()
    dec = lt.neural_min_sum(code, max_iterations=10, device=device)
    res = lt.GradientExplosionAnalyzer(dec).analyze(num_samples=32)
    for mode, st in res.items():
        print(f"  {mode}: mean={st['mean']:.3e} max={st['max']:.3e}")


def example_simulation(device="cuda"):
    """Monte-Carlo FER/BER sweep + plots (reference ex. 9-10)."""
    code = lt.create_peg_code(n=128, m=64, dv=3, seed=0, max_iterations=12)
    cfg = lt.SimulationConfig(
        snr_range=(1.0, 4.0), snr_step=1.0, max_frames=2048,
        max_errors=200, min_frames=512, wave_size=512, device=device)
    sim = lt.LDPCSimulator(cfg)
    decs = {
        "MS(0.7)": lt.basic_min_sum(code, max_iterations=12, device=device),
        "RCQ(3,8)": lt.rcq_min_sum(code, bc=3, bv=8, max_iterations=12,
                                   device=device),
    }
    results = sim.simulate_multiple_decoders(decs, verbose=False)
    for name, r in results.items():
        fers = ", ".join(f"{f:.3f}" for f in r.frame_error_rates)
        print(f"  {name}: FER = [{fers}]")
    sim.save_results(filename="example_results.json")
    if importlib.util.find_spec("matplotlib") is None:
        print("  plots skipped: matplotlib is not installed")
        return
    from ldpc_tpu_torch.report import plot_comparison_grid
    path = plot_comparison_grid(results, "simulation_results/comparison.png")
    print(f"  plots -> {path}")


def example_weight_analysis(device="cuda"):
    """Weight-pattern analysis (reference weight-pattern test)."""
    from ldpc_tpu_torch.report import (analyze_weight_patterns,
                                       parameter_reduction_report)

    code = lt.create_test_ldpc_code()
    zoo = lt.create_test_decoders(code, device=device)
    an = analyze_weight_patterns(zoo["N-NMS"])
    means = {k: round(v, 3)
             for k, v in an["mean_weight_by_check_degree"].items()}
    print(f"  N-NMS params={an['total_parameters']}, mean-by-dc={means}")
    rep = parameter_reduction_report(zoo, baseline="N-NMS")
    for name, d in rep["decoders"].items():
        print(f"  {name}: {d['params']} params "
              f"({d['reduction_pct']:.1f}% reduction)")


def example_checkpointing(device="cuda"):
    """Save/restore trained weights (new capability, SURVEY §5)."""
    from ldpc_tpu_torch.utils import (load_trainer_checkpoint,
                                      save_trainer_checkpoint)

    code = lt.create_test_ldpc_code()
    dec = lt.neural_min_sum(code, max_iterations=5, device=device)
    tr = lt.PosteriorJointTrainer(
        dec, lt.TrainingConfig(batch_size=64, num_epochs=2))
    tr.train(num_samples=256, verbose=False)
    with tempfile.TemporaryDirectory() as d:
        path = save_trainer_checkpoint(f"{d}/ckpt", tr, epoch=2)
        dec2 = lt.neural_min_sum(code, max_iterations=5, seed=99,
                                 device=device)
        tr2 = lt.PosteriorJointTrainer(
            dec2, lt.TrainingConfig(batch_size=64, num_epochs=2))
        epoch = load_trainer_checkpoint(path, tr2)
        same = torch.allclose(dec.weights["beta"], dec2.weights["beta"])
        print(f"  restored epoch={epoch}, weights match: {same}")


def example_zoo(device="cuda"):
    """Load the shipped pretrained decoder and decode with it."""
    entries = lt.list_pretrained()
    for path, spec in entries:
        print(f"  zoo entry: {spec['name']} at {path}")
    if not entries:
        print("  (no zoo entries found)")
        return
    # a reduced schedule keeps this demo fast (weight tables are
    # [:T]-sliced); the first entry is trained at T=4, and no entry can
    # be extended beyond its trained T
    path, spec = entries[0]
    T = min(5, spec["recipe"]["max_iterations"])
    dec = lt.load_pretrained(path, max_iterations=T, device=device)
    llr = lt.awgn_llr(_gen(0, device),
                      torch.zeros((16, dec.code.n), device=device), 6.75)
    out = dec(llr)
    print(f"  decoded 16 frames of n={dec.code.n}: "
          f"{int(out.success.sum())}/16 converged at T={T}")


def example_design(device="cuda"):
    """Quantizer-ladder design by density evolution (ldpc_tpu_torch.design)."""
    from ldpc_tpu_torch.design import (analyze_decoder,
                                       degree_profile_from_base,
                                       design_rcq_ladders)

    rng = np.random.default_rng(0)
    base = rng.integers(0, 64, size=(4, 16))
    prof = degree_profile_from_base(base)
    qp, vqp, res = design_rcq_ladders(prof, bc=3, bv=8, max_iterations=8,
                                      snr_db=5.0, phases=3, passes=0)
    print(f"  designed CN ladder {[c for c, _ in qp]} @gamma 1.3, "
          f"V2C {[c for c, _ in vqp]}; DE threshold "
          f"{res.threshold_db:.2f} dB")

    code = lt.create_qc_code(base, lift=64, max_iterations=8)
    dec = lt.make_decoder(code, kind="rcq", bc=3, bv=8, quantizer_params=qp,
                          v2c_quantizer_params=vqp, max_iterations=8,
                          qc=lt.build_qc_graph(base, 64), layered=True,
                          device=device)
    r = analyze_decoder(dec, snr_db=5.0)
    print(f"  layered DE trajectory of the built decoder: "
          f"{[float(f'{e:.2g}') for e in r.error_prob]}")


def example_encode_end_to_end(device="cuda"):
    """Systematic GF(2) encode -> AWGN -> decode -> message recovery: the
    full transmit path on random (non-zero) messages. Every Monte-Carlo
    scenario uses the all-zero codeword (valid by linearity,
    ``simulation_framework.py:107``); this demo shows the encoder closing
    the loop on real data, including the BPSK sign mapping."""
    code = lt.create_peg_code(n=256, m=128, dv=3, seed=0, max_iterations=25)
    enc = lt.make_encoder(code)
    dec = lt.basic_min_sum(code, device=device)
    gen = _gen(42, device)
    msg = torch.randint(0, 2, (64, enc.k_eff), generator=gen,
                        device=device, dtype=torch.int32)
    cw = enc(msg)                                    # [64, n] GF(2) codewords
    if not bool(enc.syndrome_ok(cw).all()):
        raise AssertionError("an encoded word fails the parity checks")
    # BPSK: bit 0 -> +1, bit 1 -> -1; awgn_llr takes the bit tensor
    llr = lt.awgn_llr(gen, cw.to(torch.float32), 5.0)
    out = dec(llr)
    info = torch.as_tensor(enc.info_positions, device=device)
    ok = (out.bits[:, info] == msg).all(dim=1)     # systematic extraction
    print(f"  encode->AWGN@5dB->decode on 64 random messages "
          f"(k_eff={enc.k_eff}): {int(ok.sum())}/64 recovered, "
          f"decoder success on {int(out.success.sum())}/64")


def example_floor_diagnosis(device="cuda"):
    """Finite-graph floor diagnosis: trapping-set spectrum + an
    importance-sampled failure probability (design/trapping_sets.py,
    sim/importance.py — RESULTS §19/§21 machinery in miniature)."""
    from ldpc_tpu_torch.design import find_trapping_sets
    from ldpc_tpu_torch.sim import estimate_trapping_floor

    code = lt.create_peg_code(n=96, m=48, dv=3, seed=1, max_iterations=15)
    rep = find_trapping_sets(code.H, a_max=6, b_max=3, restarts=2)
    print("  " + rep.summary().replace("\n", "\n  "))
    if rep.sets:
        ts = rep.dominant(1)[0]
        dec = lt.basic_min_sum(code, device=device)
        est = estimate_trapping_floor(
            dec, [((ts.a, ts.b), rep.class_counts()[(ts.a, ts.b)]["unique"],
                   ts.variables)],
            snr_db=4.0, shift=1.5, n_samples=4096, batch=1024)
        print("  " + est.summary().replace("\n", "\n  "))


SCENARIOS = {
    "basic": example_basic_decoding,
    "neural": example_neural_decoders,
    "2d": example_2d_weight_sharing,
    "rcq": example_rcq_decoding,
    "oms_rcq": example_oms_rcq,
    "codes": example_published_codes,
    "layered": example_layered_decoding,
    "training": example_training,
    "gradients": example_gradient_analysis,
    "simulation": example_simulation,
    "weights": example_weight_analysis,
    "checkpoint": example_checkpointing,
    "zoo": example_zoo,
    "design": example_design,
    "encode": example_encode_end_to_end,
    "floor": example_floor_diagnosis,
}


def run_quick_test(device="cuda"):
    """Minimal smoke (reference ``examples.py:427-461``)."""
    t0 = time.time()
    example_basic_decoding(device)
    example_neural_decoders(device)
    print(f"quick test OK in {time.time() - t0:.1f}s")


def run_all_examples(device="cuda"):
    for name, fn in SCENARIOS.items():
        print(f"[{name}] {fn.__doc__.splitlines()[0]}")
        t0 = time.time()
        fn(device)
        print(f"[{name}] done in {time.time() - t0:.1f}s\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenario", nargs="?",
                    help="quick, or one of: " + ", ".join(SCENARIOS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.scenario == "quick":
        run_quick_test(args.device)
    elif args.scenario in SCENARIOS:
        SCENARIOS[args.scenario](args.device)
    elif args.scenario is None:
        run_all_examples(args.device)
    else:
        print(f"unknown scenario {args.scenario!r}; one of: quick, "
              + ", ".join(SCENARIOS))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
