"""Profiling and throughput counters (counterpart of
``ldpc_tpu/utils/profiling.py``).

``trace`` captures a ``torch.profiler`` timeline (host and, when a card is
visible, CUDA activity) and writes it as a Chrome trace;
``measure_throughput`` and ``ThroughputCounter`` count decoded codewords
per second, synchronising the card before a clock is read.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch

__all__ = ["trace", "measure_throughput", "ThroughputCounter"]


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str = "ldpc_torch_trace"):
    """Capture a profiler trace around a block and write it to
    ``<log_dir>/trace.json`` (Chrome trace format; open it in Perfetto
    or ``chrome://tracing``). Yields the profiler, whose
    ``key_averages()`` and ``events()`` are readable after the block. On
    the card the trace starts with eight tiny fill kernels, which take the
    device records a profiler session can lose at its start:

    >>> with trace("t") as prof:
    ...     decoder(llr)
    """
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    card = torch.cuda.is_available()
    if card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if card:
            # a session that follows a long one (10^5 launches) loses its
            # first one or two device records (torch 2.11 on the H100):
            # tiny fills take the loss instead of the block's kernels
            primer = torch.empty(8, device="cuda")
            for i in range(8):
                primer[i:].fill_(0.0)
            torch.cuda.synchronize()
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def measure_throughput(fn: Callable, *args, reps: int = 5,
                       warmup: int = 1) -> float:
    """Calls of ``fn(*args)`` per second, the card synchronised after the
    warm-up and after the timed calls. Multiply by the per-call batch for
    codewords/sec."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    _sync()
    return reps / (time.perf_counter() - t0)


class ThroughputCounter:
    """Running decoded-codewords/sec across Monte-Carlo waves; ``stop``
    synchronises the card before it reads the clock."""

    def __init__(self):
        self.codewords = 0
        self.seconds = 0.0
        self._t0: Optional[float] = None

    def start(self):
        _sync()
        self._t0 = time.perf_counter()

    def stop(self, codewords: int):
        if self._t0 is None:
            raise RuntimeError("start() not called")
        _sync()
        self.seconds += time.perf_counter() - self._t0
        self.codewords += codewords
        self._t0 = None

    @property
    def codewords_per_sec(self) -> float:
        return self.codewords / self.seconds if self.seconds else 0.0
