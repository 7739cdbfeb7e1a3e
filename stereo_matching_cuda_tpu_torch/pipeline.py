"""End-to-end stereo pipeline on PyTorch tensors (counterpart of
``stereo_matching_cuda_tpu/pipeline.py``).

Grayscale both views → matching (cost + guided aggregation + WTA, left
d∈[D_MIN,D_MAX], right d∈[-D_MAX,-D_MIN]) → LR check on the left map →
occlusion fill (main.cu:37-214).  On CUDA tensors the matching runs
kernel K1 once per view and the post stage kernel K2; the plain op-by-op
path serves the CPU, parity mode and ``full_outputs``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import StereoConfig, DEFAULT_CONFIG
from . import ops
from .ops.fused_guided import guided_wta_fused
from .ops.fused_post import lr_fill_fused


def use_fused_path(cfg: StereoConfig, device: torch.device | str,
                   full_outputs: bool = False) -> bool:
    """Whether the matching stage runs kernel K1: tensors on CUDA,
    ``fused`` not False, parity mode off and no intermediates requested.
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
    left = torch.from_numpy(np.ascontiguousarray(rgb_left)).to(device)
    right = torch.from_numpy(np.ascontiguousarray(rgb_right)).to(device)
    out = stereo_pipeline(left, right, cfg, full_outputs)
    if keys is not None:
        missing = [k for k in keys if k not in out]
        if missing:
            raise ValueError(
                f"unknown output keys {missing}; available: {sorted(out)} "
                f"(full_outputs={full_outputs})")
        out = {k: out[k] for k in keys}
    return {k: v.cpu().numpy() for k, v in out.items()}
