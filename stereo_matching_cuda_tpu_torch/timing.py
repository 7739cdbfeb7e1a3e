"""Device timing for ``chip_smoke.py`` and the measurement scripts."""

from __future__ import annotations

import torch


def cuda_ms(fn, iters, warmup=3):
    """Mean ms per call of ``fn`` on the card, CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
