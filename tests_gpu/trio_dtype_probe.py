"""The precoded PBRL code's plain RCQ arms at 2.0 dB on the card, through
K1 in bf16 and in float32 and through the port's layered QC engine, with
the channel noise drawn four ways, each point beside
``experiments/pbrl_honest_dev.json`` with the two-sided p of Fisher's
exact test (``chip_smoke.fisher_p``).

The arms are ``pbrl_wrcq``'s ``rcq-<tag>`` decoders (RCQ bc=4, bv=8,
layered T=10, the precoded code at lift 86, base column 0's 86 bits
punctured). ``--kinds`` picks the routes: ``bf16`` and ``f32`` set K1's
storage type; ``engine`` decodes with the layered QC engine in float32
(plain torch ops), which checks the syndrome after every iteration and
so stops a frame at its first pass, not at the {5, 10} checkpoints.
``--noise`` picks the channel's Gaussian draws (the simulator's
``awgn_llr`` swapped): ``port`` (the port's channel: ``jax.random.normal``'s
float32 transform, ``channel.standard_normal``), ``randn``
(``torch.randn`` in float32 on the card), ``randn64`` (``torch.randn`` in
float64 on the card, rounded to float32) and ``cpu`` (``torch.randn`` on
the host, seeded from the point's generator). Each
point runs the program's simulation ({5, 10}, waves of 32768, survivor
budget 4096, 65,536 frames at least) to ``--errors`` frame errors or
``--frames`` frames. ``--dump FILE`` writes the first wave's first 512
frames of LLRs (the port's channel) with K1's float32 posteriors at T=5 and
T=10 to an ``.npz``, for ``tests/jax_reference_trio.py --card FILE`` to
hold on the CPU. Needs a CUDA card:

    python3 tests_gpu/trio_dtype_probe.py [--tags hand ref2 ref3]
        [--kinds bf16 f32 engine] [--noise port randn randn64 cpu]
        [--errors 300] [--frames 16777216] [--dump FILE]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (blocks jax; its fisher_p is numpy only)
import torch  # noqa: E402

from ldpc_tpu_torch.channel import standard_normal  # noqa: E402

DUMP_FRAMES = 512


def noise_awgn(kind):
    """``channel.awgn_llr`` with its Gaussian draws made the ``kind`` way
    (the same BPSK mapping, SNR convention and LLR scale)."""
    host = {}

    def draw(gen, shape, dev):
        if kind == "port":
            return standard_normal(gen, shape, dev)
        if kind == "randn":
            return torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=dev)
        if kind == "randn64":
            return torch.randn(shape, generator=gen, dtype=torch.float64,
                               device=dev).to(torch.float32)
        if "gen" not in host:   # seeded once from the point's generator
            seed = int(torch.randint(2 ** 62, (1,), generator=gen,
                                     device=dev))
            host["gen"] = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=host["gen"],
                           dtype=torch.float32).to(dev)

    def awgn_llr(gen, codewords, snr_db, dtype=torch.float32):
        dev = codewords.device
        snr = torch.as_tensor(snr_db, dtype=torch.float32, device=dev)
        noise_power = 10.0 ** (-snr / 10.0)
        symbols = 1.0 - 2.0 * codewords.to(torch.float32)
        received = symbols + torch.sqrt(noise_power) * draw(
            gen, codewords.shape, dev)
        return (2.0 * received / noise_power).to(dtype)
    return awgn_llr


def dump(path, dec, punct):
    """The first wave's first DUMP_FRAMES frames' LLRs (the simulator's
    draw, punctured) and K1's float32 posteriors at T=5 and T=10."""
    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.decode import two_checkpoint_stages

    d = dataclasses.replace(dec, qc_options=dict(dec.qc_options,
                                                 dtype=torch.float32))
    gen = torch.Generator(device="cuda").manual_seed(0)   # the point's
    llr = lt.puncture_llr(lt.awgn_llr(gen, torch.zeros(
        (32768, d.code.n), device="cuda"), 2.0), punct)[:DUMP_FRAMES]
    s1, s2 = two_checkpoint_stages(d, 5)
    np.savez_compressed(path, llr=llr.cpu().numpy(),
                        post5=s1(llr, d.weights).posterior.cpu().numpy(),
                        post10=s2(llr, d.weights).posterior.cpu().numpy())
    print(f"{path}: {DUMP_FRAMES} frames' LLRs and K1's float32 posteriors "
          f"at T=5 and T=10", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tags", nargs="+", default=["hand", "ref2", "ref3"])
    ap.add_argument("--kinds", nargs="+", choices=["bf16", "f32", "engine"],
                    default=["bf16", "f32"])
    ap.add_argument("--noise", nargs="+",
                    choices=["port", "randn", "randn64", "cpu"],
                    default=["port"])
    ap.add_argument("--errors", type=int, default=300)
    ap.add_argument("--frames", type=int, default=2 ** 24)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trio_dtype_probe: no CUDA card")
    import ldpc_tpu_torch as lt
    from ldpc_tpu_torch.cli import pbrl_wrcq as pw
    from ldpc_tpu_torch.cli.bench import device_line
    from ldpc_tpu_torch.sim import montecarlo

    card = device_line(torch.device("cuda"))
    with open(os.path.join(ROOT, "experiments",
                           "pbrl_honest_dev.json")) as f:
        record = json.load(f)
    arms, punct = pw.build_arms(tuple(f"rcq-{t}" for t in args.tags),
                                "cuda")
    if args.dump:
        dump(args.dump, next(iter(arms.values())), punct)
    real = montecarlo.awgn_llr
    for name, dec in arms.items():
        ref = record[name]["2.0"]
        for noise in args.noise:
            montecarlo.awgn_llr = noise_awgn(noise)
            try:
                for kind in args.kinds:
                    d = dataclasses.replace(dec, qc_options=(
                        dict(check_every=5) if kind == "engine" else dict(
                            dec.qc_options,
                            dtype={"bf16": torch.bfloat16,
                                   "f32": torch.float32}[kind])))
                    cfg = pw.dev_config(2.0, args.frames, args.errors,
                                        punct, "cuda")
                    t0 = time.perf_counter()
                    fer, ber, it, nf, ne = lt.simulate_single_snr(d, 2.0,
                                                                  cfg)
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                    p = chip_smoke.fisher_p(ne, nf, ref["errors"],
                                            ref["frames"])
                    print(f"{name} {kind:6s} noise {noise:6s} @ 2.0 dB: "
                          f"{ne}/{nf} (FER {fer:.4g}), JAX {ref['errors']}/"
                          f"{ref['frames']} (FER {ref['fer']:.4g}), Fisher p "
                          f"{p:.3g}, avg iterations {it:.4f}, "
                          f"{nf / secs:.1f} frames/s  [{card}]", flush=True)
            finally:
                montecarlo.awgn_llr = real


if __name__ == "__main__":
    main()
