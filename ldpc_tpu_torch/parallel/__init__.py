"""Batch-parallel execution on ``torch.distributed`` (counterpart of
``ldpc_tpu/parallel/``): the mesh, SPMD Monte-Carlo waves, the bench
program over ranks, and a launcher for a process group of ranks."""

from ldpc_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    distributed_init,
    make_mesh,
    replicated,
)
from ldpc_tpu_torch.parallel.montecarlo import (
    make_spmd_compacting_wave_fn,
    make_spmd_two_checkpoint_stats_fn,
    make_spmd_wave_fn,
)
from ldpc_tpu_torch.parallel.launch import spawn
