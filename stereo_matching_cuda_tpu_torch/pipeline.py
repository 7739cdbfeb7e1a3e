"""End-to-end stereo pipeline on PyTorch tensors (counterpart of
``stereo_matching_cuda_tpu/pipeline.py``).

Grayscale both views → matching (cost + guided aggregation + WTA, left
d∈[D_MIN,D_MAX], right d∈[-D_MAX,-D_MIN]) → LR check on the left map →
occlusion fill (main.cu:37-214).  On CUDA tensors the matching runs
one kernel per view (K3 tiled, K1 row walk), or both views in one pass
(K4 tiled, K5 row walk) on the dual-view route (``use_dual_view``,
``use_stream``), and the post stage runs kernel K2; the plain op-by-op
path serves the CPU, parity mode and ``full_outputs``.  A (B,H,W,C)
batch (``stereo_pipeline_batch``) runs each kernel once over the batch.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import StereoConfig, DEFAULT_CONFIG
from . import ops
from .ops import _kernels
from .ops.fused_guided import guided_wta_fused, guided_wta_fused_dual
from .ops.fused_post import lr_fill_fused


def use_fused_path(cfg: StereoConfig, device: torch.device | str,
                   full_outputs: bool = False) -> bool:
    """Whether the matching stage runs a kernel (K1, K3, K4 or K5): tensors
    on CUDA, ``fused`` not False, parity mode off and no intermediates
    requested.
    ``fused=True`` off CUDA raises: the kernel path has no CPU form."""
    on_cuda = torch.device(device).type == "cuda"
    if cfg.fused is True and not on_cuda:
        raise ValueError(f"fused=True needs CUDA tensors, got device {device}")
    return (on_cuda and not full_outputs
            and (cfg.fused is True or (cfg.fused == "auto"
                                       and not cfg.exact_integral)))


def use_fused_post(cfg: StereoConfig, device: torch.device | str,
                   full_outputs: bool = False) -> bool:
    """Whether the post stage runs kernel K2.  Follows the matching path
    unless ``post_fused`` forces it; bit-identical either way."""
    if cfg.post_fused is None:
        return use_fused_path(cfg, device, full_outputs)
    if cfg.post_fused and torch.device(device).type != "cuda":
        raise ValueError(f"post_fused=True needs CUDA tensors, got device {device}")
    return cfg.post_fused


# Frame area from which the dual route takes K5 when ``cfg.stream`` is
# None: the JAX package's _STREAM_PIXELS (pipeline.py:174,241-243).
STREAM_PIXELS = 200_000

# Largest disparity count the dual route takes when ``dual_view`` is
# "auto".
DUAL_MAX_D = 8


def use_dual_view(cfg: StereoConfig) -> bool:
    """Whether the kernel path computes both views in one pass (K4/K5)
    instead of one kernel per view (K3/K1): ``dual_view`` True, or "auto" and
    size_d <= 8.  This is the JAX package's rule as it resolves with its
    strategy knobs on auto: ``use_dual_view`` compares size_d with
    ``unroll_max`` (pipeline.py:54-61), and the strategy tables set
    unroll_max=8 wherever dual_view is "auto" and size_d <= 32
    (pipeline.py:146,186,223-240).  Where a user forces ``fused=True``
    or sets ``stream`` below 200,000 px, JAX leaves its tables off and
    takes its dual kernel up to 32 slices; the port has no unroll knob
    and keeps one kernel per view there (same function, same bound)."""
    return cfg.dual_view is True or (cfg.dual_view == "auto"
                                     and cfg.size_d <= DUAL_MAX_D)


def use_stream(cfg: StereoConfig, h: int, w: int, dual: bool = True) -> bool:
    """Whether (h, w) frames take the row-walk kernel of their route.

    Dual route: K5 (True) or K4 (False): ``cfg.stream`` when set, else
    from STREAM_PIXELS on, the JAX rule on every dual route (its
    _SMALL_STRATEGY needs size_d > 8 there, pipeline.py:229-240).  Like
    JAX's stream_fits net (pipeline.py:277-287), an auto choice falls back
    to K4 when K5 does not fit one block's shared memory; an explicit
    ``stream=True`` that does not fit raises at launch.

    Single-view route: K1 (True) only when ``cfg.stream`` is True, K3
    (tiled) when it is False or None.  This deviates from the JAX rule,
    which streams below 200,000 px when 8 < size_d <= 32 and from 200,000
    px when the stream fits (pipeline.py:223-287): on the H100 the
    single-view row walk K1 measured slower than the tiles K3 at every
    size (K1/K3 1.84x at 288x384, 1.18x at 6 MP, 1.89x at 64 and 1.34x
    at 128 disparities; PERF.md, Findings: the port and what it taught;
    the redesigned K1 still 1.2x at 6 MP), so the port's default single
    view keeps its tiled kernel until a benchmark gives an H100 routing
    table.  The rule needs no kernel library, so it is decided on the CPU
    too."""
    if not dual:
        return cfg.stream is True
    if cfg.stream is not None:
        return cfg.stream
    return h * w >= STREAM_PIXELS and _kernels.dual_stream_fits(
        cfg.radius, _kernels.dual_reach(cfg.d_min, cfg.size_d))


def _post(dmap_l, dmap_r, cfg: StereoConfig, full_outputs: bool = False):
    """(occlusion map, filled map): kernel K2 or the plain ops."""
    if use_fused_post(cfg, dmap_l.device, full_outputs):
        return lr_fill_fused(dmap_l, dmap_r, cfg)
    occ = ops.detect_occlusion(dmap_l, dmap_r, cfg.d_occlusion, cfg)
    return occ, ops.fill_occlusion(occ, cfg.v_min, cfg)


def _match(gl, gr, cfg: StereoConfig, full_outputs: bool):
    """Both views' (best, dmap), plus (mean_l, mean_r, cost0_l, cost0_r)
    when ``full_outputs`` (None otherwise)."""
    if use_fused_path(cfg, gl.device, full_outputs):
        if use_dual_view(cfg):
            return (*guided_wta_fused_dual(gl, gr, cfg), None, None, None, None)
        best_l, dmap_l = guided_wta_fused(gl, gr, cfg.d_min, cfg)
        best_r, dmap_r = guided_wta_fused(gr, gl, cfg.d_min_right, cfg)
        return best_l, dmap_l, best_r, dmap_r, None, None, None, None
    cost_l = ops.cost_volume(gl, gr, cfg.d_min, cfg)
    cost_r = ops.cost_volume(gr, gl, cfg.d_min_right, cfg)
    best_l, dmap_l, mean_l = ops.guided_filter_wta(gl, cost_l, cfg.d_min, cfg)
    best_r, dmap_r, mean_r = ops.guided_filter_wta(gr, cost_r, cfg.d_min_right, cfg)
    if not full_outputs:
        return best_l, dmap_l, best_r, dmap_r, None, None, None, None
    return best_l, dmap_l, best_r, dmap_r, mean_l, mean_r, cost_l[0], cost_r[0]


def stereo_pipeline(
    rgb_left: torch.Tensor,
    rgb_right: torch.Tensor,
    cfg: StereoConfig = DEFAULT_CONFIG,
    full_outputs: bool = False,
) -> dict:
    """uint8 (H,W,C) ×2 → dict of tensors on the inputs' device.

    Always returns disparity_left/right, occlusion, occlusion_filled;
    with ``full_outputs`` also the intermediates the reference writes as
    PNGs (gray, mean, best_cost, cost slice 0) — main.cu:162-181.
    """
    gl = ops.rgb_to_grayscale(rgb_left, cfg)
    gr = ops.rgb_to_grayscale(rgb_right, cfg)
    best_l, dmap_l, best_r, dmap_r, mean_l, mean_r, c0_l, c0_r = _match(
        gl, gr, cfg, full_outputs)
    occ, filled = _post(dmap_l, dmap_r, cfg, full_outputs)
    out = {
        "disparity_left": dmap_l,
        "disparity_right": dmap_r,
        "occlusion": occ,
        "occlusion_filled": filled,
    }
    if full_outputs:
        out.update(
            gray_left=gl, gray_right=gr,
            mean_left=mean_l, mean_right=mean_r,
            best_cost_left=best_l, best_cost_right=best_r,
            cost_left_s0=c0_l, cost_right_s0=c0_r,
        )
    return out


def stereo_pipeline_batch(
    rgb_left: torch.Tensor,
    rgb_right: torch.Tensor,
    cfg: StereoConfig = DEFAULT_CONFIG,
) -> dict:
    """uint8 (B,H,W,C) pairs → dict of (B,H,W) float32 tensors on the
    inputs' device (the four maps of ``stereo_pipeline``).

    On the kernel path each view's batch goes through one launch of the
    route's matching kernel (K3 or K1 per view, K4 or K5 for both) and
    K2 runs once over the batch; each kernel's tile or band does not
    depend on B, so every frame equals a lone ``stereo_pipeline`` call
    bit for bit.  Otherwise the plain path runs frame by frame (the JAX
    package's vmap; its lax.map of the kernel path is a launch per
    frame)."""
    if rgb_left.ndim != 4 or rgb_left.shape != rgb_right.shape:
        raise ValueError(f"expected two (B, H, W, C) batches of one shape, got "
                         f"{tuple(rgb_left.shape)} and {tuple(rgb_right.shape)}")
    if not use_fused_path(cfg, rgb_left.device):
        frames = [stereo_pipeline(l, r, cfg) for l, r in zip(rgb_left, rgb_right)]
        return {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
    gl = ops.rgb_to_grayscale(rgb_left, cfg)
    gr = ops.rgb_to_grayscale(rgb_right, cfg)
    _, dmap_l, _, dmap_r, *_ = _match(gl, gr, cfg, False)
    occ, filled = _post(dmap_l, dmap_r, cfg)
    return {
        "disparity_left": dmap_l,
        "disparity_right": dmap_r,
        "occlusion": occ,
        "occlusion_filled": filled,
    }


def _to_device(rgb: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(rgb)).to(device)


def compute_disparity(
    rgb_left: np.ndarray,
    rgb_right: np.ndarray,
    cfg: StereoConfig,
    device: torch.device | str,
    full_outputs: bool = False,
    keys: tuple | None = None,
) -> dict:
    """Host entry: numpy uint8 (H,W,C) ×2 in, dict of numpy arrays out,
    computed on ``device``.  ``keys`` limits which outputs are copied
    back to the host."""
    out = stereo_pipeline(_to_device(rgb_left, device), _to_device(rgb_right, device),
                          cfg, full_outputs)
    if keys is not None:
        missing = [k for k in keys if k not in out]
        if missing:
            raise ValueError(
                f"unknown output keys {missing}; available: {sorted(out)} "
                f"(full_outputs={full_outputs})")
        out = {k: out[k] for k in keys}
    return {k: v.cpu().numpy() for k, v in out.items()}


# Outputs whose every value is an integer label or the d_occlusion
# sentinel: the only keys ``compact`` may cast to int16.
INTEGER_KEYS = ("disparity_left", "disparity_right", "occlusion", "occlusion_filled")


def compute_disparity_stacked(
    rgb_left: np.ndarray,
    rgb_right: np.ndarray,
    cfg: StereoConfig,
    device: torch.device | str,
    keys: tuple = ("occlusion_filled", "occlusion"),
    compact: bool = False,
) -> dict:
    """``compute_disparity(keys=...)`` with ONE device-to-host copy: the
    requested (H, W) float32 maps are stacked on ``device`` and fetched
    together.

    ``compact`` casts the stack to int16 on the device and back to
    float32 on the host, halving the bytes copied.  It is exact only for
    integer-valued maps, so it takes only ``INTEGER_KEYS`` and raises for
    any other key; where a label or the sentinel leaves the int16 range
    the stack is copied as float32."""
    if compact:
        bad = [k for k in keys if k not in INTEGER_KEYS]
        if bad:
            raise ValueError(f"compact=True casts to int16 and takes only the "
                             f"integer-valued keys {INTEGER_KEYS}, got {bad}")
    out = stereo_pipeline(_to_device(rgb_left, device), _to_device(rgb_right, device),
                          cfg)
    missing = [k for k in keys if k not in out]
    if missing:
        raise ValueError(f"unknown output keys {missing}; available: {sorted(out)}")
    stacked = torch.stack([out[k] for k in keys])
    arr = labels_to_host(stacked, cfg) if compact else stacked.cpu().numpy()
    return {k: arr[i] for i, k in enumerate(keys)}


def labels_to_host(stacked: torch.Tensor, cfg: StereoConfig) -> np.ndarray:
    """float32 numpy copy of integer-valued maps (``INTEGER_KEYS``),
    copied from the device as int16 where every label and the sentinel
    fit its range (exact, half the bytes), else as float32."""
    if cfg.d_occlusion >= -32768 and cfg.d_max <= 32767:
        return stacked.to(torch.int16).cpu().numpy().astype(np.float32)
    return stacked.cpu().numpy()
