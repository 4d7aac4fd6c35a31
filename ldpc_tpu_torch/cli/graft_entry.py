"""Entry points of the PyTorch port: a single-device forward step and a
multi-rank dry run (twin of the root ``__graft_entry__.py``).

``entry()`` returns a forward step on the flagship model — W-RCQ
(degree-shared neural weights + 3-bit RCQ message quantization, the
paper's headline decoder) on a QC-lifted code of the (9472, 8192)
family's structure, lift 64 — and its arguments, on the device.

``dryrun_multichip(n)`` starts an ``n``-rank process group
(``parallel.spawn``) and runs on every rank: one data-parallel training
step, one SPMD Monte-Carlo wave, one compacting SPMD wave, one SPMD wave
of the fused flooding kernel (iterations == T per frame), and the
two-checkpoint bench program, pooled equal to the single-device decode of
the same batch.

    python -m ldpc_tpu_torch.cli.graft_entry [--device cpu] [--ranks N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import ldpc_tpu_torch as lt


def _flagship(lift: int = 64, max_iterations: int = 10, device="cuda"):
    rng = np.random.default_rng(0)
    base = rng.integers(0, lift, size=(4, 24))  # rate-5/6 QC protograph
    code = lt.create_qc_code(base, lift=lift, max_iterations=max_iterations)
    dec = lt.weighted_rcq(
        code, bc=3, bv=8, weight_sharing_type=2,
        quantizer_params=((3.0, 1.3), (5.0, 1.3), (7.0, 1.3)),
        max_iterations=max_iterations, seed=0, device=device)
    return code, dec


def entry(device="cuda"):
    """(forward, example_args): the flagship forward step on ``device``,
    ``forward(llr, weights) -> (bits, posterior, iterations)`` on 256
    frames at 3 dB."""
    from ldpc_tpu_torch.decode.engine import decode_batch

    code, dec = _flagship(lift=64, max_iterations=10, device=device)
    graph, spec, T = dec.graph, dec.spec, dec.max_iterations

    def forward(llr, weights):
        out = decode_batch(llr, weights, graph=graph, spec=spec,
                           max_iterations=T)
        return out.bits, out.posterior, out.iterations

    llr = lt.awgn_llr(torch.Generator(device=dec.device).manual_seed(0),
                      torch.zeros((256, code.n), device=dec.device), 3.0)
    return forward, (llr, dec.weights)


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def dryrun_rank(mesh) -> dict:
    """One rank of :func:`dryrun_multichip` (tiny shapes); returns what
    it measured."""
    from ldpc_tpu_torch.decode.early_exit import make_two_checkpoint_decoder
    from ldpc_tpu_torch.parallel import (make_spmd_two_checkpoint_stats_fn,
                                         make_spmd_wave_fn)
    from ldpc_tpu_torch.parallel.launch import global_llr
    from ldpc_tpu_torch.sim.montecarlo import _counts, point_generator

    n, dev = mesh.size, mesh.device
    code = lt.create_peg_code(n=64, m=32, dv=3, seed=0, max_iterations=4)
    dec = lt.weighted_rcq(code, bc=3, bv=8, weight_sharing_type=2,
                          max_iterations=4, seed=0, device=dev)

    # one data-parallel training step: each rank decodes its rows of the
    # global batch, the gradients are summed over ranks
    trainer = lt.PosteriorJointTrainer(dec, lt.TrainingConfig(
        batch_size=4 * n, num_epochs=1, snr_range=(1.0, 4.0)), mesh=mesh)
    loss, acc, gnorm = trainer.train_epoch(None, batches_per_epoch=1)
    _check(np.isfinite(loss) and np.isfinite(gnorm), "training step")

    # one SPMD wave with pooled counts, and one with per-rank compaction
    wave = dict(snr_range=(3.0, 3.0), snr_step=1.0, max_frames=8 * n,
                max_errors=10 ** 9, min_frames=0, wave_size=8 * n,
                save_results=False, device=str(dev))
    frames = []
    for extra in ({}, dict(early_exit_iters=2, survivor_budget=4 * n)):
        res = lt.LDPCSimulator(lt.SimulationConfig(**wave, **extra),
                               mesh=mesh).simulate_decoder(dec, verbose=False)
        frames.append(res.total_frames[0])
    _check(frames == [8 * n, 8 * n], f"mesh waves' frames {frames}")

    # the fused flooding kernel under the mesh: iterations == T per frame
    base = np.random.default_rng(1).integers(0, 16, size=(2, 6))
    qc_code = lt.create_qc_code(base, lift=16, max_iterations=4)
    qc = lt.build_qc_graph(base, 16)
    qdec = lt.make_decoder(qc_code, kind="rcq", bc=3, bv=8, max_iterations=4,
                           qc=qc, qc_options=dict(fused=True,
                                                  dtype=torch.float32),
                           device=dev)
    fused = make_spmd_wave_fn(qdec, 8 * n, mesh)(
        point_generator(2, 0, dev, mesh.rank, n), 4.0)
    _check(fused[2] == 4 * 8 * n, f"fused wave iterations {fused[2]}")

    # the bench program: layered fused (lean) kernel under the {t1, T}
    # two-checkpoint compaction per rank, pooled = single device
    ldec = lt.make_decoder(
        qc_code, kind="rcq", bc=3, bv=8,
        quantizer_params=((2.6, 1.3), (3.1, 1.3), (5.4, 1.3)),
        v2c_quantizer_params=((4.0, 1.0), (8.0, 1.0), (12.0, 1.0)),
        max_iterations=4, qc=qc, layered=True,
        qc_options=dict(fused=True, dtype=torch.float32, lean=True),
        device=dev)
    B = 8 * n
    llr = global_llr(B, qc_code.n, 1.5, 3, dev)
    pooled = make_spmd_two_checkpoint_stats_fn(
        ldec, t1=2, survivor_budget=8, mesh=mesh)(llr).tolist()
    out, n_surv = make_two_checkpoint_decoder(ldec, t1=2,
                                              survivor_budget=B)(llr)
    single = _counts(out.bits, out.iterations, out.success).tolist() + [
        int(n_surv)]
    _check(pooled == single, f"bench program {pooled} != {single}")
    return dict(loss=loss, gnorm=gnorm, frames=frames, fused=fused,
                pooled=pooled)


def dryrun_multichip(n_devices: int, backend: str = "nccl",
                     device=None) -> list:
    """:func:`dryrun_rank` on each rank of an ``n_devices``-rank group on
    ``backend`` (NCCL: one card a rank; name ``"gloo"`` and a device for
    ranks on the CPU or on one card); returns each rank's result."""
    from ldpc_tpu_torch.cli import graft_entry  # by name, also from __main__
    from ldpc_tpu_torch.parallel import spawn
    return spawn(graft_entry.dryrun_rank, n_devices, backend, device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the dry run (default: the cards, or 1 "
                         "on the CPU)")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    print("entry ok:", [tuple(o.shape) for o in fn(*fargs)])
    on_cpu = torch.device(args.device).type == "cpu"
    ranks = args.ranks or (1 if on_cpu else torch.cuda.device_count())
    dryrun_multichip(ranks, "gloo" if on_cpu else "nccl",
                     "cpu" if on_cpu else None)
    print("dryrun_multichip ok")


if __name__ == "__main__":
    main()
