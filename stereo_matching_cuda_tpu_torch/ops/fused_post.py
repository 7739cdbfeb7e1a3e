"""Fused post stage: LR consistency check + occlusion fill (counterpart
of ``stereo_matching_cuda_tpu/ops/pallas_post.py``).

``lr_fill_fused`` maps two float32 (H,W) or (B,H,W) disparity maps to
(occlusion map, filled map) of the same shape.  On CUDA tensors it launches kernel K2
(``csrc/lr_fill.cu``) and counts the launch in
``lr_fill_fused.launches``; on CPU tensors it runs the plain version,
``lr_fill_reference``.  The stage is integer compares and selects only,
so the kernel is bit-identical to the plain version.
"""

from __future__ import annotations

import torch

from ..config import StereoConfig, DEFAULT_CONFIG
from . import _kernels
from .occlusion import detect_occlusion, fill_occlusion


def lr_fill_reference(dmap_l: torch.Tensor, dmap_r: torch.Tensor,
                      cfg: StereoConfig = DEFAULT_CONFIG):
    """Plain PyTorch version of K2: ``detect_occlusion`` then
    ``fill_occlusion`` (both row-wise over any leading axes)."""
    occ = detect_occlusion(dmap_l, dmap_r, cfg.d_occlusion, cfg)
    return occ, fill_occlusion(occ, cfg.v_min, cfg)


def lr_fill_fused(dmap_l: torch.Tensor, dmap_r: torch.Tensor,
                  cfg: StereoConfig = DEFAULT_CONFIG):
    """(occlusion map, filled map) of the left view.  A batch is one
    launch over its B·H rows."""
    if dmap_l.device.type == "cpu" and dmap_r.device.type == "cpu":
        return lr_fill_reference(dmap_l, dmap_r, cfg)
    if dmap_l.device.type != "cuda" or dmap_r.device != dmap_l.device:
        raise ValueError(f"lr_fill_fused takes two tensors on one CUDA "
                         f"device or on the CPU, got {dmap_l.device} and "
                         f"{dmap_r.device}")
    if dmap_l.dtype != torch.float32 or dmap_r.dtype != torch.float32:
        raise TypeError(f"expected float32 maps, got {dmap_l.dtype}, {dmap_r.dtype}")
    if dmap_l.ndim not in (2, 3) or dmap_l.shape != dmap_r.shape:
        raise ValueError(f"expected two (H, W) or (B, H, W) maps of one shape, got "
                         f"{tuple(dmap_l.shape)} and {tuple(dmap_r.shape)}")
    w = dmap_l.shape[-1]
    if w * cfg.size_d >= 2 ** 31:
        raise ValueError(f"W*D = {w * cfg.size_d} overflows the int32 fill keys")
    dmap_l, dmap_r = dmap_l.contiguous(), dmap_r.contiguous()
    occ = torch.empty_like(dmap_l)
    filled = torch.empty_like(dmap_l)
    with torch.cuda.device(dmap_l.device):
        _kernels.lr_fill(dmap_l, dmap_r, occ, filled, cfg.d_min, cfg.size_d,
                         cfg.d_lr, cfg.d_occlusion, cfg.v_min)
    lr_fill_fused.launches += 1
    return occ, filled


lr_fill_fused.launches = 0
