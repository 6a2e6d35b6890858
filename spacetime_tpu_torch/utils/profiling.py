"""Per-phase timers.

On a CUDA device a phase is timed with CUDA events recorded on the current
stream and read after a synchronise, so the time is the device's and not
the host's enqueue time. On the CPU it is the host clock.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulating timer: ``with timer("solve"): ...``."""

    def __init__(self, device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.seconds = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                end.synchronize()
                self.seconds[phase] += start.elapsed_time(end) / 1e3
                self.counts[phase] += 1
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[phase] += time.perf_counter() - t0
                self.counts[phase] += 1

    def summary(self) -> dict:
        return {k: round(v, 4) for k, v in sorted(self.seconds.items())}


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` runs.

    Each run is bracketed by CUDA events on the current stream, behind a
    spin kernel of about a millisecond: the host enqueues the events and
    ``fn``'s launches while the card spins, so the events time the device
    work alone and not the host's launch gaps."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
