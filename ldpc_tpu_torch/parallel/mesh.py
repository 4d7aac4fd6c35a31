"""The batch mesh on ``torch.distributed`` (counterpart of
``ldpc_tpu/parallel/mesh.py``).

The framework's one parallel axis is the codeword batch: frames are
independent, and the weight tables and quantizer ladders are tiny and
replicated. In PyTorch a mesh is a process group of one rank per process
(one card each, or, over gloo, several ranks on one card or on the CPU):
each rank decodes its own rows, and error statistics and gradients cross
ranks as one ``all_reduce`` each.

Backends: NCCL for ranks on CUDA cards (the default), gloo for the CPU.
gloo with CUDA tensors runs only when the caller names it (NCCL refuses two
ranks on one card); its reductions go through the host. Nothing switches
backend or device on its own: a missing NCCL raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ldpc_tpu_torch.decode.variants import resolve_device

__all__ = ["Mesh", "make_mesh", "batch_sharding", "replicated",
           "distributed_init"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place on a 1-D batch mesh: ``size`` ranks, this one
    ``rank``, decoding on ``device``. ``group`` is the process group
    (None for a world of one without one), ``backend`` its backend."""

    size: int
    rank: int
    device: torch.device
    group: Optional[object] = None
    axis_names: Tuple[str, ...] = ("batch",)
    backend: Optional[str] = None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the mesh's ranks, in place; returns ``t``."""
        if self.group is None:
            return t
        if self.backend == "gloo" and t.is_cuda:
            host = t.cpu()
            dist.all_reduce(host, group=self.group)
            return t.copy_(host)
        dist.all_reduce(t, group=self.group)
        return t


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def _rank_device(devices, rank: int) -> torch.device:
    """This rank's device: ``devices`` is None (the card of this rank's
    local index), one device for every rank, or one per rank."""
    if devices is None:
        resolve_device("cuda")
        return torch.device("cuda",
                            _local_rank(rank) % torch.cuda.device_count())
    if isinstance(devices, (str, torch.device)):
        return resolve_device(devices)
    return resolve_device(devices[rank])


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "batch",
              devices: Optional[Sequence] = None) -> Mesh:
    """This process's mesh over the first ``n_devices`` ranks of the
    process group (all of them by default). Without an initialised group
    (:func:`distributed_init` no-ops in a single process) the world is this
    one process. ``devices``: see :func:`_rank_device`; the card by
    default."""
    grouped = dist.is_available() and dist.is_initialized()
    world, rank = ((dist.get_world_size(), dist.get_rank()) if grouped
                   else (1, 0))
    n = world if n_devices is None else int(n_devices)
    if not 0 < n <= world:
        raise ValueError(f"requested {n_devices} ranks, only {world} in the "
                         "process group (call distributed_init first)")
    group = backend = None
    if grouped:
        group = (dist.group.WORLD if n == world
                 else dist.new_group(list(range(n))))
        if rank >= n:
            raise ValueError(f"rank {rank} is outside the mesh of the first "
                             f"{n} ranks")
        backend = dist.get_backend(group)
    device = _rank_device(devices, rank)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL reduces CUDA tensors only, not {device}; "
                         "initialise with backend='gloo' for the CPU")
    return Mesh(n, rank, device, group, (axis_name,), backend)


def batch_sharding(mesh: Mesh, axis_name: str = "batch"
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A function giving this rank's rows of a ``[B, ...]`` tensor: the
    ``mesh.rank``-th of ``mesh.size`` equal blocks, in rank order. B must
    divide evenly."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"axis {axis_name!r} is not in {mesh.axis_names}")

    def shard(x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        if B % mesh.size:
            raise ValueError(f"batch {B} is not divisible by the mesh's "
                             f"{mesh.size} ranks")
        per = B // mesh.size
        return x[mesh.rank * per:(mesh.rank + 1) * per]

    return shard


def replicated(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """Every rank holds the whole tensor (weight tables, LUTs, scalars)."""

    def replicate(x: torch.Tensor) -> torch.Tensor:
        return x

    return replicate


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Initialise the default process group (one call per process, before
    :func:`make_mesh`); a no-op in a single process, so one entry point
    runs on one card or on many.

    ``coordinator_address`` is an init method (``tcp://host:port``,
    ``file:///path``; a bare ``host:port`` means tcp), else torchrun's
    ``MASTER_ADDR``/``MASTER_PORT`` are read; ``num_processes`` and
    ``process_id`` default to ``WORLD_SIZE`` and ``RANK``. ``backend``
    defaults to NCCL, which must be there: name ``"gloo"`` for ranks on
    the CPU or for several ranks on one card."""
    if num_processes in (None, 1) and coordinator_address is None and \
            int(os.environ.get("WORLD_SIZE", "1")) == 1 and \
            "MASTER_ADDR" not in os.environ:
        return  # single process
    backend = backend or "nccl"
    init = coordinator_address or "env://"
    if "://" not in init:
        init = f"tcp://{init}"
    rank = int(os.environ.get("RANK", 0)) if process_id is None \
        else process_id
    world = int(os.environ.get("WORLD_SIZE", 1)) if num_processes is None \
        else num_processes
    if backend == "nccl":
        if not (dist.is_nccl_available() and torch.cuda.is_available()):
            raise RuntimeError("backend 'nccl' needs CUDA cards and a NCCL "
                               "build of torch; pass backend='gloo' to run "
                               "the ranks on the CPU")
        torch.cuda.set_device(_local_rank(rank) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
