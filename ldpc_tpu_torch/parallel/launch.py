"""Run a function on every rank of a new process group, and the jobs
such a rank runs.

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``
(the spawn method, so a parent that has touched CUDA can start them),
joins them in a process group over a ``file://`` store in a temporary
directory (no port is needed), builds each rank's :class:`~.mesh.Mesh`,
calls ``fn(mesh, *args)`` and returns every rank's result, passed back
through a file. ``fn`` is a function of an importable module: a spawned
child imports it by name. The kernels a child runs come from the library
the parent built (``decode/_build.py`` names it by the sources' hash).

The jobs below are such functions. Each takes decoders and data that
pickle small (decoders on the CPU, numpy batches, seeds) and returns
plain Python or numpy values.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ldpc_tpu_torch.parallel.mesh import Mesh, distributed_init, make_mesh

__all__ = ["spawn", "run_all", "global_llr", "wave", "simulate",
           "two_checkpoint_stats", "train_steps"]


def _rank_main(rank, fn, world, backend, device, tmp, args):
    distributed_init(f"file://{os.path.join(tmp, 'store')}", world, rank,
                     backend=backend)
    try:
        result = fn(make_mesh(world, devices=device), *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str, device, *args) -> list:
    """``[fn(mesh, *args) for each rank]`` over a new ``world``-rank group
    on ``backend`` (``"nccl"`` or ``"gloo"``). ``device`` is every rank's
    device, or None for each rank's own card. The children inherit the
    environment (``OMP_NUM_THREADS`` sets their torch threads). A child's
    exception raises here."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, world, backend, device, tmp, args),
            nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def run_all(mesh: Mesh, calls: Sequence[Tuple]) -> list:
    """Run the jobs ``calls`` = [(fn, args), ...] one after another on this
    rank (one spawn for many jobs); returns their results in order."""
    return [fn(mesh, *a) for fn, a in calls]


def global_llr(batch: int, n: int, snr_db: float, seed: int,
               device) -> torch.Tensor:
    """``batch`` all-zero frames through AWGN from a generator seeded
    ``seed`` on ``device``: the same global batch on every rank of a
    device type."""
    from ldpc_tpu_torch.channel import awgn_llr
    gen = torch.Generator(device=device).manual_seed(seed)
    return awgn_llr(gen, torch.zeros((batch, n), device=device), snr_db)


def wave(mesh: Mesh, decoder, wave_size: int, snr_db: float, seed: int = 0,
         snr_idx: int = 0, early_iters: Optional[int] = None,
         survivor_budget: Optional[int] = None, stage1_fused: bool = False,
         punctured=None) -> List[int]:
    """One SPMD wave (compacting with ``early_iters``) of ``wave_size``
    frames from each rank's generator of SNR point ``snr_idx``; returns
    the pooled counts."""
    from ldpc_tpu_torch.parallel.montecarlo import (
        make_spmd_compacting_wave_fn, make_spmd_wave_fn)
    from ldpc_tpu_torch.sim.montecarlo import point_generator
    decoder = decoder.to(mesh.device)
    if early_iters is None:
        fn = make_spmd_wave_fn(decoder, wave_size, mesh, punctured=punctured)
    else:
        fn = make_spmd_compacting_wave_fn(
            decoder, wave_size, early_iters, survivor_budget, mesh,
            stage1_fused=stage1_fused, punctured=punctured)
    gen = point_generator(seed, snr_idx, mesh.device, mesh.rank, mesh.size)
    return fn(gen, snr_db)


def simulate(mesh: Mesh, decoder, config) -> Tuple[dict, list]:
    """``LDPCSimulator(config, mesh).simulate_decoder`` on ``decoder``:
    the pooled result as a dict and this rank's wave kinds."""
    from ldpc_tpu_torch.sim.montecarlo import LDPCSimulator
    sim = LDPCSimulator(config, mesh=mesh)
    res = sim.simulate_decoder(decoder.to(mesh.device), "mesh",
                               verbose=False)
    return res.to_dict(), sim.wave_kinds["mesh"]


def two_checkpoint_stats(mesh: Mesh, decoder, batch: int, snr_db: float,
                         seed: int, t1: int, survivor_budget: int
                         ) -> List[int]:
    """The bench program over the mesh on the global batch
    :func:`global_llr` ``(batch, n, snr_db, seed)``; returns the pooled
    five stats."""
    from ldpc_tpu_torch.parallel.montecarlo import \
        make_spmd_two_checkpoint_stats_fn
    decoder = decoder.to(mesh.device)
    llr = global_llr(batch, decoder.code.n, snr_db, seed, mesh.device)
    fn = make_spmd_two_checkpoint_stats_fn(
        decoder, t1=t1, survivor_budget=survivor_budget, mesh=mesh)
    return fn(llr).tolist()


def train_steps(mesh: Mesh, decoder, config, batches) -> Dict:
    """``PosteriorJointTrainer(decoder, config, mesh).train_step`` on each
    global numpy batch ``(llr, targets)``; returns the weights after the
    last step (numpy) and each step's (loss, accuracy, gradient norm)."""
    from ldpc_tpu_torch.train.trainer import PosteriorJointTrainer
    tr = PosteriorJointTrainer(decoder.to(mesh.device), config, mesh=mesh)
    stats = [tuple(float(v) for v in tr.train_step(
        torch.as_tensor(x, device=mesh.device),
        torch.as_tensor(y, device=mesh.device))) for x, y in batches]
    return dict(weights={k: v.cpu().numpy()
                         for k, v in tr.decoder.weights.items()
                         if v is not None}, stats=stats)
