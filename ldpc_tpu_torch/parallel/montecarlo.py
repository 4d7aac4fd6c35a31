"""SPMD Monte-Carlo over a batch mesh (counterpart of
``ldpc_tpu/parallel/montecarlo.py``).

Every rank draws its own noise from its own generator
(``sim.point_generator`` of its rank: no random numbers cross ranks),
decodes its shard of the wave through ``Decoder.__call__`` (so a fused
decoder runs its kernel per rank), and the error counts cross ranks as one
``all_reduce`` of an int64 tensor on the rank's device, before the wave's
host read. Weight tables stay replicated. A world of one gives the
single-device simulator's waves bit for bit.
"""

from __future__ import annotations

from typing import Callable

import torch

from ldpc_tpu_torch.decode.early_exit import make_two_checkpoint_decoder
from ldpc_tpu_torch.decode.variants import Decoder
from ldpc_tpu_torch.parallel.mesh import Mesh, batch_sharding
from ldpc_tpu_torch.sim.montecarlo import (_counts, _EngineCompactingWave,
                                           _Wave)

__all__ = ["make_spmd_wave_fn", "make_spmd_compacting_wave_fn",
           "make_spmd_two_checkpoint_stats_fn"]


def _check_axis(mesh: Mesh, axis_name: str):
    if axis_name not in mesh.axis_names:
        raise ValueError(f"axis {axis_name!r} is not in {mesh.axis_names}")


def make_spmd_wave_fn(decoder: Decoder, wave_size: int, mesh: Mesh,
                      axis_name: str = "batch", punctured=None) -> _Wave:
    """This rank's wave: ``wave(gen, snr_db, weights=None)`` draws
    ``wave_size // mesh.size`` all-zero frames from ``gen`` (this rank's
    generator) on the mesh's device, decodes them and returns the pooled
    (frame errors, bit errors, iteration sum, successes) of the GLOBAL
    wave, the same on every rank."""
    _check_axis(mesh, axis_name)
    if wave_size % mesh.size:
        raise ValueError(f"wave_size {wave_size} not divisible by "
                         f"{mesh.size} ranks")
    return _Wave(decoder, wave_size // mesh.size, mesh.device, punctured,
                 reduce=mesh.all_reduce)


def make_spmd_compacting_wave_fn(decoder: Decoder, wave_size: int,
                                 early_iters: int, survivor_budget: int,
                                 mesh: Mesh, axis_name: str = "batch",
                                 stage1_fused: bool = False,
                                 stage1_batch_tile: int = 64,
                                 punctured=None) -> _EngineCompactingWave:
    """SPMD early-termination compaction: every rank compacts its own
    shard with ``survivor_budget // mesh.size`` slots (the single-device
    compacting wave of an engine decoder on the local frames: the decoder
    truncated to ``early_iters``, or with ``stage1_fused`` the fused
    flooding kernel checking once there, then the decoder itself on the
    survivors). A rank whose survivors overflow its slots decodes its
    whole shard at full depth; only the counts cross ranks. A fused
    parent is refused (it cannot be truncated). ``stage1_batch_tile`` is a
    TPU tiling knob, kept for parity and ignored."""
    _check_axis(mesh, axis_name)
    n = mesh.size
    if wave_size % n or survivor_budget % n:
        raise ValueError(
            f"wave_size {wave_size} and survivor_budget {survivor_budget} "
            f"must be divisible by {n} ranks")
    ce = (decoder.qc_options or {}).get("check_every")
    if ce and early_iters % ce:
        raise ValueError(
            f"early_iters={early_iters} must be a multiple of the "
            f"decoder's check_every={ce} (freezing equivalence)")
    return _EngineCompactingWave(decoder, wave_size // n, mesh.device,
                                 early_iters, max(1, survivor_budget // n),
                                 stage1_fused, punctured,
                                 reduce=mesh.all_reduce)


def make_spmd_two_checkpoint_stats_fn(decoder: Decoder, *, t1: int,
                                      survivor_budget: int, mesh: Mesh,
                                      axis_name: str = "batch") -> Callable:
    """The bench program over ranks: each rank takes its rows of a
    GLOBAL ``[B, n]`` LLR tensor (:func:`~.mesh.batch_sharding`) and runs
    the {t1, T} two-checkpoint decode of a fused decoder
    (``decode.early_exit.make_two_checkpoint_decoder``) with
    ``survivor_budget`` slots PER RANK. Returns ``fn(llr, weights=None)
    -> int64 tensor [5]`` on the mesh's device: (frame errors, bit errors,
    iteration sum, successes, survivors) summed over ranks, equal to the
    single-device two-checkpoint decode of the same LLRs when no rank
    overflows its budget."""
    shard = batch_sharding(mesh, axis_name)
    two_ck = make_two_checkpoint_decoder(decoder, t1=t1,
                                         survivor_budget=survivor_budget)

    def fn(llr: torch.Tensor, weights=None) -> torch.Tensor:
        out, n_surv = two_ck(shard(llr), weights)
        stats = torch.cat([_counts(out.bits, out.iterations, out.success),
                           n_surv.view(1).to(torch.int64)])
        return mesh.all_reduce(stats)

    return fn
