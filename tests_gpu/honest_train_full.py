"""One full-length training of ``pbrl_honest_train``'s arms on the card,
then their dev FER beside the JAX record.

Each arm (default ``worcq`` and ``wrcq``) is trained by the twin's
``pbrl_honest_train.train_arm`` at the program's settings (30 epochs of
2048 frames in batches of 128, cosine from the arm's learning rate with 8
warm-up updates, 1.5-3.5 dB, the 86 punctured bits' LLRs 0, bv=None on
the engines), then ``dev`` runs ``oms6``, ``rcq-ref3`` and the trained
arms at 2.0 dB to 100 frame errors, each point capped at ``--frames``
frames (2^23), through K1 in bf16 under {5, 10} with survivor budget
8192. Every point is printed beside
``experiments/pbrl_honest_train_results.json`` with the two-sided p of
Fisher's exact test (``chip_smoke.fisher_p``), each arm's final training
loss beside the JAX run's. The twin's outputs (its checkpoints and
``pbrl_honest_train_torch.json``) and a summary
``honest_train_full.json`` go to ``--out`` (default
``honest_train_full/`` in the working directory). Needs a CUDA card:

    python3 tests_gpu/honest_train_full.py [--arms worcq wrcq]
        [--epochs 30] [--frames 8388608] [--out DIR]
"""

import argparse
import json
import logging
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (blocks jax; its fisher_p is numpy only)
import torch  # noqa: E402

# the JAX run's final training losses (RESULTS section 33b)
JAX_LOSS = {"worcq": 0.0096, "wrcq": 0.073}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arms", nargs="+", default=["worcq", "wrcq"])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--frames", type=int, default=2 ** 23)
    ap.add_argument("--out", default="honest_train_full")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("honest_train_full: no CUDA card")
    from ldpc_tpu_torch.cli import pbrl_honest_train as ht
    from ldpc_tpu_torch.cli.bench import device_line

    card = device_line(torch.device("cuda"))
    print(card, flush=True)
    logging.basicConfig(level=logging.INFO, force=True)
    with open(os.path.join(ROOT, "experiments",
                           "pbrl_honest_train_results.json")) as f:
        record = json.load(f)
    os.makedirs(args.out, exist_ok=True)
    os.chdir(args.out)
    summary = {"card": card, "epochs": args.epochs, "arms": {}}
    for name in args.arms:
        t0 = time.perf_counter()
        loss = ht.train_arm(name, ht.ARMS[name], epochs=args.epochs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        summary["arms"][name] = {"final_loss": loss, "train_s": secs,
                                 "jax_final_loss": JAX_LOSS.get(name)}
        print(f"{name}: final loss {loss:.5f} (JAX {JAX_LOSS.get(name)}), "
              f"{secs:.1f} s of training  [{card}]", flush=True)
    t0 = time.perf_counter()
    res = ht.dev(tuple(args.arms), frames=args.frames, snrs=(2.0,))
    print(f"dev {time.perf_counter() - t0:.1f} s", flush=True)
    for name, pts in res.items():
        p, ref = pts["2.0"], record.get(name, {}).get("2.0")
        line = f"{name:10s} @ 2.0 dB: {p['errors']}/{p['frames']}"
        if ref is not None:
            fp = chip_smoke.fisher_p(p["errors"], p["frames"],
                                     ref["errors"], ref["frames"])
            line += (f", JAX {ref['errors']}/{ref['frames']}, Fisher p "
                     f"{fp:.3g}")
            p["jax"], p["fisher_p"] = ref, fp
        summary.setdefault("dev", {})[name] = p
        print(line + f"  [{card}]", flush=True)
    with open("honest_train_full.json", "w") as f:
        json.dump(summary, f, indent=2)


if __name__ == "__main__":
    main()
