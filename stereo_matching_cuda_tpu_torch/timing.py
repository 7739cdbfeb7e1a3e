"""Device timing for ``bench.py``, ``chip_smoke.py`` and the measurement
scripts."""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

# steady_ms: two windows in a row within TOL of each other, at most
# MAX_WINDOWS windows.
TOL = 0.02
MAX_WINDOWS = 20


class Clock:
    """Marks on the device's timeline: CUDA events on the card,
    ``time.perf_counter`` on the CPU (whose ops run synchronously)."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()


CUDA_CLOCK = Clock()


def window_ms(fn, iters, clock: Clock = CUDA_CLOCK):
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls,
    between two marks of ``clock`` (CUDA events by default)."""
    clock.sync()
    start = clock.mark()
    for _ in range(iters):
        fn()
    end = clock.mark()
    clock.sync()
    return clock.ms(start, end) / iters


class Steady(NamedTuple):
    ms: float         # mean ms per call in the last window
    windows: int      # windows timed, the last included
    settled: bool     # False when MAX_WINDOWS ran out first


def steady_ms(fn, iters, timer=window_ms) -> Steady:
    """Mean ms per call of ``fn`` once it is steady: windows of ``iters``
    calls are timed (``timer(fn, iters)``, CUDA events by default) until
    two windows in a row agree within ``TOL`` of the earlier one.  A fixed
    warm-up count can end before the first calls at a size (the kernels'
    build, the caching allocator, K2's shared-memory limit) are over;
    this one waits for them.  Stops after ``MAX_WINDOWS`` with
    ``settled`` False."""
    prev = timer(fn, iters)
    for windows in range(2, MAX_WINDOWS + 1):
        cur = timer(fn, iters)
        if abs(cur - prev) <= TOL * prev:
            return Steady(cur, windows, True)
        prev = cur
    return Steady(prev, MAX_WINDOWS, False)


def cuda_ms(fn, iters):
    """Mean ms per call of ``fn`` on the card, CUDA events over windows of
    ``iters`` calls once steady (``steady_ms``)."""
    return steady_ms(fn, iters).ms
