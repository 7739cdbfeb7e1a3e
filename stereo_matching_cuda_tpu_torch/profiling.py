"""Per-stage timing and tracing (counterpart of
``stereo_matching_cuda_tpu/profiling.py``).

  * ``stage_table(left, right, cfg, device, n)`` — per-frame ms of each
    stage of the route the pipeline takes on ``device`` (row names as
    ``STAGES_UNFUSED`` / ``STAGES_FUSED`` / ``STAGES_DUAL``, the post pair
    replaced by ``POST_FUSED`` where kernel K2 runs).  Each stage is
    timed directly: its inputs are made once, by the stage before it,
    and its call runs ``n`` times back to back between two CUDA events
    after warm-up (``time.perf_counter`` on the CPU).  ``TOTAL`` is the
    sum of the stage rows, so no row is a difference and none can be
    negative.  ``batch_stage_table`` does the same for a (B,H,W,C) batch
    in ``stereo_pipeline_batch``'s structure, per frame.
  * ``trace(logdir)`` — a torch.profiler context that writes a Chrome
    trace.
  * ``profile_path`` — device time per frame by kernel (K1-K5, the rest
    "other") and the device's idle share, from torch.profiler.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from . import ops
from .config import StereoConfig, DEFAULT_CONFIG
from .ops.fused_guided import guided_wta_fused, guided_wta_fused_dual
from .ops.fused_post import lr_fill_fused
from .pipeline import use_dual_view, use_fused_path, use_fused_post
from .timing import Clock, window_ms

STAGES_UNFUSED = ("rgb_to_grayscale x2", "cost_volume x2", "guided_filter+WTA x2",
                  "detect_occlusion", "fill_occlusion")
STAGES_FUSED = ("rgb_to_grayscale x2", "fused cost+guided+WTA L",
                "fused cost+guided+WTA R", "detect_occlusion", "fill_occlusion")
STAGES_DUAL = ("rgb_to_grayscale x2", "fused dual-view cost+guided+WTA",
               "detect_occlusion", "fill_occlusion")
# One kernel computes the occlusion map and the fill: one post row.
POST_FUSED = "fused LR+fill (K2)"

# Calls of each stage before its timed window: the first makes the next
# stage's inputs, the rest warm up.  A stage table of n frames thus
# launches each kernel of its route WARMUP + n times per stage.
WARMUP = 3

# Kernel function names, as the profiler reports them, by kernel.
KERNEL_NAMES = {"guided_wta_stream_kernel": "K1", "lr_fill_kernel": "K2",
                "guided_wta_kernel": "K3", "guided_wta_dual_kernel": "K4",
                "guided_wta_dual_stream_kernel": "K5"}
COUNT_NAMES = ("K1", "K2", "K3", "K4", "K5")


def launch_counts() -> dict:
    """{K1..K5: launches so far}, read from the kernel wrappers' counters
    (each adds one where it launches its kernel)."""
    return dict(zip(COUNT_NAMES, (
        guided_wta_fused.k1_launches, lr_fill_fused.launches, guided_wta_fused.k3_launches,
        guided_wta_fused_dual.k4_launches, guided_wta_fused_dual.k5_launches)))


def stage_frames(h: int, w: int) -> int:
    """Timed frames per stage when the caller gives none: 50 below
    500,000 px, where a stage is tens of microseconds, else 10."""
    return 50 if h * w < 500_000 else 10


def stage_names(cfg: StereoConfig, device: torch.device | str) -> list[str]:
    """The stage rows of the route ``cfg`` takes on ``device``
    (``pipeline.use_fused_path`` / ``use_dual_view`` / ``use_fused_post``;
    decided without the kernel library)."""
    if not use_fused_path(cfg, device):
        stages = STAGES_UNFUSED
    else:
        stages = STAGES_DUAL if use_dual_view(cfg) else STAGES_FUSED
    if use_fused_post(cfg, device):
        stages = stages[:-2] + (POST_FUSED,)
    return list(stages)


def _each(fn, batched: bool):
    """``fn`` of two images, over the frames of a leading batch axis
    when ``batched`` (the plain path runs a batch frame by frame)."""
    if not batched:
        return fn
    return lambda a, b: torch.stack([fn(x, y) for x, y in zip(a, b)])


def _stage_fns(cfg: StereoConfig, device, batched: bool) -> list:
    """The route's stages in order (``stage_names``), each a function of
    the output of the stage before it; the first takes the RGB pair."""
    def gray(rgb):
        return ops.rgb_to_grayscale(rgb[0], cfg), ops.rgb_to_grayscale(rgb[1], cfg)

    fns = [gray]
    if use_fused_path(cfg, device):
        if use_dual_view(cfg):
            fns.append(lambda g: guided_wta_fused_dual(*g, cfg)[1::2])
        else:
            fns += [lambda g: (*g, guided_wta_fused(g[0], g[1], cfg.d_min, cfg)[1]),
                    lambda s: (s[2], guided_wta_fused(s[1], s[0], cfg.d_min_right, cfg)[1])]
    else:
        cost_l = _each(lambda a, b: ops.cost_volume(a, b, cfg.d_min, cfg), batched)
        cost_r = _each(lambda a, b: ops.cost_volume(a, b, cfg.d_min_right, cfg), batched)
        wta_l = _each(lambda g, c: ops.guided_filter_wta(g, c, cfg.d_min, cfg)[1], batched)
        wta_r = _each(lambda g, c: ops.guided_filter_wta(g, c, cfg.d_min_right, cfg)[1],
                      batched)
        fns += [lambda g: (*g, cost_l(g[0], g[1]), cost_r(g[1], g[0])),
                lambda s: (wta_l(s[0], s[2]), wta_r(s[1], s[3]))]
    if use_fused_post(cfg, device):
        fns.append(lambda d: lr_fill_fused(*d, cfg))
    else:
        fns += [lambda d: ops.detect_occlusion(*d, cfg.d_occlusion, cfg),
                lambda occ: ops.fill_occlusion(occ, cfg.v_min, cfg)]
    return fns


def _stage_ms(call, device: torch.device, n: int):
    """(ms per call over ``n`` back-to-back calls after ``WARMUP``, the
    first call's output).  A fixed warm-up, not ``timing.steady_ms``: a
    stage table's launches are ``WARMUP + n`` per stage whatever the
    times."""
    out = call()
    for _ in range(WARMUP - 1):
        call()
    return window_ms(call, n, Clock(device.type == "cuda")), out


@torch.no_grad()
def _rows(left, right, cfg: StereoConfig, device, n: int) -> list[dict]:
    """The stage rows, per frame of a (B,H,W,C) batch or of one (H,W,C)
    frame."""
    if n < 1:
        raise ValueError(f"stage tables need n >= 1 timed frames, got {n}")
    device = torch.device(device)
    batched = left.ndim == 4
    frames = left.shape[0] if batched else 1
    x = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (left, right))
    rows = []
    for name, fn in zip(stage_names(cfg, device), _stage_fns(cfg, device, batched)):
        ms, x = _stage_ms(lambda fn=fn, x=x: fn(x), device, n)
        rows.append({"stage": name, "ms": ms / frames})
    return rows


def stage_table(left, right, cfg: StereoConfig = DEFAULT_CONFIG,
                device: torch.device | str = "cuda", n: int | None = None) -> list[dict]:
    """[{stage, ms}]: per-frame ms of each stage of the route the
    pipeline takes for uint8 (H,W,C) ``left``/``right`` on ``device``,
    then ``TOTAL``, the sum of the stage rows.  ``n`` timed frames per
    stage (default ``stage_frames``)."""
    if n is None:
        n = stage_frames(*left.shape[:2])
    rows = _rows(left, right, cfg, device, n)
    return rows + [{"stage": "TOTAL", "ms": sum(r["ms"] for r in rows)}]


def batch_stage_table(left, right, cfg: StereoConfig = DEFAULT_CONFIG,
                      device: torch.device | str = "cuda", n: int = 10) -> list[dict]:
    """Per-frame ms of each stage inside ``stereo_pipeline_batch``'s
    structure for uint8 (B,H,W,C) batches: on the kernel path each
    kernel runs once over the batch; on the plain path the matching runs
    frame by frame.  A stage whose per-frame time matches the
    single-frame table is per-frame work that batching cannot amortize."""
    if left.ndim != 4:
        raise ValueError(f"batch_stage_table needs (B,H,W,C), got {left.shape}")
    b = left.shape[0]
    rows = _rows(left, right, cfg, device, n)
    return rows + [{"stage": f"TOTAL (per frame, B={b})", "ms": sum(r["ms"] for r in rows)}]


def print_stage_table(rows: list[dict], file=None) -> None:
    width = max(len(r["stage"]) for r in rows)
    for r in rows:
        print(f"{r['stage']:<{width}}  {r['ms']:>10.3f} ms", file=file)


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler context (host and, where there is a card, device
    activity); writes ``logdir/trace.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def kernel_layer(kname: str) -> str:
    """The layer of a device activity: the kernel whose full function name
    the profiler's name (demangled or not) contains, else "other".  No
    kernel's name is a part of another's, so at most one matches."""
    found = [layer for name, layer in KERNEL_NAMES.items() if name in kname]
    assert len(found) <= 1, kname
    return found[0] if found else "other"


def profile_path(name, call, frames, per_call=1, warmup=5) -> dict:
    """Device time per frame by layer (K1-K5, the rest) and the device's
    idle share over ``frames`` calls of ``call`` (each of ``per_call``
    frames), from torch.profiler: idle share = 1 - (union of
    device-activity intervals) / (first start to last end).  Prints one
    ``profile`` line and returns {"window_ms", "idle_share", layer: ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            call()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError(f"{name}: the profiler saw no device activity")
    layers = dict.fromkeys((*COUNT_NAMES, "other"), 0.0)
    busy, cur_start, cur_end = 0.0, *spans[0][:2]
    for start, end, kname in spans:
        layers[kernel_layer(kname)] += end - start
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = spans[-1][1] - spans[0][0]
    n = frames * per_call
    per_frame = {k: v / n / 1e3 for k, v in layers.items() if v or k == "other"}
    idle = 1 - busy / window
    print(f"profile {name}: device window {window / n / 1e3:.4f} ms/frame, "
          + ", ".join(f"{k} {v:.4f} ms/frame" for k, v in per_frame.items())
          + f", {len(spans) / n:.1f} device activities/frame, "
          f"device idle share {idle:.4f}")
    return {"window_ms": window / n / 1e3, "idle_share": idle, **per_frame}
