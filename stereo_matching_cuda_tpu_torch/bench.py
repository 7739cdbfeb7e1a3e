"""Benchmark of the PyTorch/CUDA port on one NVIDIA GPU: one JSON line on
stdout, the log on stderr.

    python -m stereo_matching_cuda_tpu_torch.bench

The counterpart of the JAX package's ``bench.py`` at the repository root,
with its rows, inputs, definitions and JSON line, measured on the card.
It needs a CUDA device and exits 1 without one; it never times the CPU
path in its place.

Headline, ``tsukuba_full_pipeline_fps``: the full pipeline (both views,
16 disparities, ``DEFAULT_CONFIG``) on device-resident uint8 frames of
Tsukuba's size: the JAX bench's seeded noise pair, its input when the
reference's PNGs are missing (they are not in this repository), flagged
``synthetic_input``.
Frames are chained: frame i+1's left input is frame i's left plus the
low bit of its filled map, so no frame can start before the one before
it ends.  A chain is timed with CUDA events from before its first frame
to after its last; per frame = (t(145) - t(49)) / 96, each side the min
of 5 chains, which cancels the chain's fixed costs.

``extra`` carries the JAX bench's rows under its keys: a B=8 sequence
through ``stereo_pipeline_batch`` (``sequence_batch8_*``: (t(9) - t(3)) /
6 / 8, min of 3), the 6 MP layered scene (``six_mp_*``, against the
reference's 7,715 ms), 5.9 MP at 128 disparities (``wide_d_*``) and 3 MP
(``three_mp_*``), each (t(n) - t(1)) / (n - 1), min of 2.  The port runs
a whole frame where the JAX package staged it.  It adds rows for its own
routes at 8 disparities (the dual route K4 / K5 on "auto" against one
kernel per view, K3 x2; at 288x384 with the headline's chains) and the
6 MP frame with ``stream=True`` (K1 x2).

Before its chains, each row runs one first call (its wall time is logged
apart: it includes the kernels' nvcc build when ``_build/`` is cold,
K2's shared-memory limit and the allocator's first blocks), then windows
of chain steps until two in a row agree within 2% (``timing.steady_ms``).
Each row's log line gives the median and p90 of the per-frame times of
its fastest long chain, the warm-up windows, the peak device memory, the
kernel launches per call and the card's name and power limit.

Switches, as in the JAX bench: STEREO_BENCH_SKIP_BATCH, STEREO_BENCH_SKIP_BIG
(every 6 MP row), STEREO_BENCH_SKIP_WIDED and STEREO_BENCH_SKIP_3MP leave
their rows out.  A row that raises leaves ``<row>_error`` in ``extra``
and the process exits 1 after printing the line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import functools
import subprocess
import sys
import time
import traceback
from typing import NamedTuple

import numpy as np
import torch

from .config import DEFAULT_CONFIG, StereoConfig
from .pipeline import stereo_pipeline, stereo_pipeline_batch
from .profiling import launch_counts
from .timing import Clock, steady_ms, window_ms
from .utils.synth import make_scene

# The reference CUDA repository's own numbers on a GTX 1080 (BASELINE.md):
# kernels + memcpy of one Tsukuba frame, and one 6 MP frame.
BASELINE_TSUKUBA_FPS = 1000.0 / (124.55 + 58.81)   # 5.45 fps
BASELINE_BIKE_MS = 7715.0

SCENE_SEED = 7
CFG8 = StereoConfig(d_min=-7, d_max=0)
SKIP_BIG = "STEREO_BENCH_SKIP_BIG"


@dataclasses.dataclass(frozen=True)
class Row:
    key: str                           # prefix of the row's keys in ``extra``
    cfg: StereoConfig
    size: tuple[int, int] | None       # layered scene (h, w); None: Tsukuba
    n_small: int                       # frames of the short and the long chain
    n_big: int
    repeats: int                       # each chain's time: the min of this many
    batch: int = 1                     # frames per call (stereo_pipeline_batch)
    skip: str | None = None            # the switch that leaves it out


HEADLINE = Row("tsukuba", DEFAULT_CONFIG, None, 49, 145, 5)
EXTRA_ROWS = (
    Row("sequence_batch8", DEFAULT_CONFIG, None, 3, 9, 3, batch=8,
        skip="STEREO_BENCH_SKIP_BATCH"),
    Row("six_mp", DEFAULT_CONFIG, (1992, 3008), 1, 9, 2, skip=SKIP_BIG),
    Row("wide_d", StereoConfig(d_min=-127, d_max=0), (1988, 2948), 1, 4, 2,
        skip="STEREO_BENCH_SKIP_WIDED"),
    Row("three_mp", DEFAULT_CONFIG, (1504, 2048), 1, 9, 2, skip="STEREO_BENCH_SKIP_3MP"),
    # Tsukuba-size frames take the headline's chains: at 1 and 9 frames the
    # host's jitter swapped these two rows' order between two processes.
    Row("d8_288x384_auto", CFG8, (288, 384), 49, 145, 5),
    Row("d8_288x384_single", dataclasses.replace(CFG8, dual_view=False), (288, 384), 49, 145,
        5),
    Row("d8_six_mp_auto", CFG8, (1992, 3008), 1, 9, 2, skip=SKIP_BIG),
    Row("d8_six_mp_single", dataclasses.replace(CFG8, dual_view=False), (1992, 3008), 1, 9, 2,
        skip=SKIP_BIG),
    Row("six_mp_stream", dataclasses.replace(DEFAULT_CONFIG, stream=True), (1992, 3008), 1, 9,
        2, skip=SKIP_BIG),
)


def _rate(ms):
    return 1e3 / ms if ms > 0 else float("inf")


# The JAX bench's keys beside ``<row>_ms_per_frame``.
_MORE_KEYS = {
    "sequence_batch8": lambda ms: {"sequence_batch8_fps": _rate(ms)},
    "six_mp": lambda ms: {"six_mp_fps": _rate(ms), "six_mp_vs_baseline": BASELINE_BIKE_MS / ms},
    "wide_d": lambda ms: {"wide_d_config": "5.9MP_128disp"},
}


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def noise_pair():
    """(left, right): the JAX bench's seeded noise pair at Tsukuba's size,
    the right a 16-column shift of the left."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, size=(288, 384 + 16, 3), dtype=np.uint8)
    return base[:, 16:], base[:, :-16]


def perturb(left: torch.Tensor, filled: torch.Tensor) -> torch.Tensor:
    """Frame i+1's left input: ``left`` plus the low bit of frame i's
    filled map, as the JAX bench's ``l + (out[..., None].astype(uint8) &
    1)``.  JAX's float-to-uint8 cast saturates (labels below 0, the -115
    sentinel among them, give 0); torch's wraps on the CPU and is
    undefined on CUDA for negative values, so the map is clamped to
    [0, 255] first.  The uint8 add wraps in both."""
    return left + (filled.clamp(0, 255).to(torch.uint8) & 1)[..., None]


def step(call, left: torch.Tensor) -> torch.Tensor:
    """One chain step: ``call`` (left -> the pipeline's output dict) on
    ``left``, and the next frame's left input."""
    return perturb(left, call(left)["occlusion_filled"])


class Chain(NamedTuple):
    ms: float               # first frame's start to last frame's end
    frame_ms: list          # each frame's time, its perturbation included
    left: torch.Tensor      # the left input the next frame would take


def chain(call, left: torch.Tensor, n: int, clock: Clock) -> Chain:
    """``n`` frames of ``call`` (left -> the pipeline's output dict), each
    frame's left input perturbed by the frame before it."""
    marks = [clock.mark()]
    for _ in range(n):
        left = step(call, left)
        marks.append(clock.mark())
    clock.sync()
    return Chain(clock.ms(marks[0], marks[-1]),
                 [clock.ms(a, b) for a, b in zip(marks, marks[1:])], left)


@dataclasses.dataclass
class RowResult:
    ms: float                # per frame
    t_small: float           # ms of the short and the long chain (min of repeats)
    t_big: float
    frame_ms: list           # ms per frame of each call of the fastest long chain
    first_s: float           # the first call's wall seconds
    warm_windows: int
    settled: bool
    peak_bytes: int | None   # max_memory_allocated over the row (card only)
    calls: int               # pipeline calls the row made
    launches: dict           # kernel launches over the row (K1..K5)
    first: dict              # numpy maps of the first call (the unperturbed frame)
    inputs: dict             # numpy left, right, and gt where the scene has one


class Result(NamedTuple):
    summary: dict            # the JSON line
    rows: dict               # row key -> RowResult


def _card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def _run_row(row: Row, inputs: dict, device: torch.device, n_small: int, n_big: int,
             repeats: int, clock: Clock) -> RowResult:
    frame = stereo_pipeline if row.batch == 1 else stereo_pipeline_batch
    left, right = (torch.from_numpy(inputs[k]).to(device) for k in ("left", "right"))

    def call(l):
        return frame(l, right, row.cfg)

    if clock.cuda:
        torch.cuda.reset_peak_memory_stats(device)
    before = launch_counts()
    t0 = time.perf_counter()
    first = {k: v.cpu().numpy() for k, v in call(left).items()}
    first_s = time.perf_counter() - t0
    warm = steady_ms(lambda: step(call, left), n_small,
                     timer=functools.partial(window_ms, clock=clock))
    small = min((chain(call, left, n_small, clock) for _ in range(repeats)), key=lambda c: c.ms)
    big = min((chain(call, left, n_big, clock) for _ in range(repeats)), key=lambda c: c.ms)
    after = launch_counts()
    return RowResult(
        ms=(big.ms - small.ms) / (n_big - n_small) / row.batch,
        t_small=small.ms, t_big=big.ms, frame_ms=[t / row.batch for t in big.frame_ms],
        first_s=first_s,
        warm_windows=warm.windows, settled=warm.settled,
        peak_bytes=torch.cuda.max_memory_allocated(device) if clock.cuda else None,
        calls=1 + warm.windows * n_small + repeats * (n_small + n_big),
        launches={k: after[k] - before[k] for k in after}, first=first, inputs=inputs)


def _describe(row: Row, res: RowResult, n_small: int, n_big: int, repeats: int,
              card: str) -> str:
    med, p90 = np.percentile(res.frame_ms, [50, 90])
    per_call = {k: v / res.calls for k, v in res.launches.items() if v}
    mem = "n/a" if res.peak_bytes is None else f"{res.peak_bytes / 2**20:.1f} MiB"
    return (f"{res.ms:.4f} ms/frame chained (t{n_small}={res.t_small:.4f} ms, "
            f"t{n_big}={res.t_big:.4f} ms, min of {repeats}) -> {_rate(res.ms):.2f} frames/s; "
            f"per-frame median {med:.4f} p90 {p90:.4f} ms (n={len(res.frame_ms)}"
            f"{f' calls of {row.batch} frames' if row.batch > 1 else ''}); "
            f"first call {res.first_s:.3f} s; warm-up {res.warm_windows} windows of {n_small}"
            f"{'' if res.settled else ' (NOT steady)'}; peak memory {mem}; "
            f"launches per call {per_call}; {card}")


def _row_inputs(row: Row, size, tsukuba, scenes: dict) -> dict:
    if row.size is None:
        left, right = tsukuba
        if row.batch == 1:
            return {"left": left, "right": right, "gt": None}
        return {"left": np.stack([np.roll(left, i, axis=1) for i in range(row.batch)]),
                "right": np.stack([np.roll(right, i, axis=1) for i in range(row.batch)]),
                "gt": None}
    key = (*(size or row.size), row.cfg.size_d)
    if key not in scenes:
        scenes[key] = make_scene(*key, seed=SCENE_SEED)
    return scenes[key]


def run(device, rows=EXTRA_ROWS, n_small=None, n_big=None, repeats=None, size=None,
        scenes=None) -> Result:
    """The headline and ``rows`` on ``device``.  ``n_small``, ``n_big`` and
    ``repeats``, where given, replace every row's; ``size`` (h, w)
    replaces every frame's (the Tsukuba pair is cropped to it).
    ``scenes`` maps (h, w, ndisp) to layered scenes already made with
    seed 7; the rest are made once each and reused across rows.  A row of
    ``rows`` that raises leaves ``<key>_error`` in ``extra``; the headline
    raises."""
    device = torch.device(device)
    clock = Clock(device.type == "cuda")
    card = _card(device)
    scenes = dict(scenes or {})
    _log(f"device: {torch.cuda.get_device_name(device) if clock.cuda else 'cpu'} ({card})")
    left, right = noise_pair()
    _log("timing SYNTHETIC Tsukuba-size frames (the JAX bench's noise pair)")
    if size is not None:
        left, right = left[:size[0], :size[1]], right[:size[0], :size[1]]
    left, right = np.ascontiguousarray(left), np.ascontiguousarray(right)
    extra, results = {}, {}
    for row in (HEADLINE, *rows):
        counts = (n_small or row.n_small, n_big or row.n_big, repeats or row.repeats)
        try:
            inputs = _row_inputs(row, size, (left, right), scenes)
            h, w = inputs["left"].shape[-3:-1]
            name = f"{row.key} {h}x{w} D={row.cfg.size_d}"
            res = _run_row(row, inputs, device, *counts, clock)
        except Exception as e:
            if row is HEADLINE:
                raise
            _log(f"{row.key} bench failed:\n{traceback.format_exc()}")
            extra[f"{row.key}_error"] = repr(e)
            continue
        _log(f"{name}: {_describe(row, res, *counts, card)}")
        results[row.key] = res
        extra[f"{row.key}_ms_per_frame"] = res.ms
        extra.update(_MORE_KEYS.get(row.key, lambda ms: {})(res.ms))
        if row is HEADLINE:
            extra["synthetic_input"] = True
    fps = _rate(results[HEADLINE.key].ms)
    return Result({"metric": "tsukuba_full_pipeline_fps", "value": fps, "unit": "frames/s",
                   "vs_baseline": fps / BASELINE_TSUKUBA_FPS, "extra": extra}, results)


def rows_from_env(environ=os.environ) -> tuple:
    """The extra rows that no set switch leaves out."""
    return tuple(row for row in EXTRA_ROWS if not (row.skip and environ.get(row.skip)))


def emit(summary: dict) -> int:
    """Prints the JSON line; the exit code: 1 if a row failed, else 0."""
    print(json.dumps(summary), flush=True)
    failed = [k for k in summary["extra"] if k.endswith("_error")]
    if failed:
        _log(f"bench: rows failed: {failed}")
        return 1
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        _log("bench: no CUDA device (torch.cuda.is_available() is false); the bench "
             "measures the card only")
        return 1
    return emit(run("cuda", rows_from_env()).summary)


if __name__ == "__main__":
    sys.exit(main())
