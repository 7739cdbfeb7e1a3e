"""Fused cost + guided aggregation + WTA for one view (counterpart of
``stereo_matching_cuda_tpu/ops/pallas_guided.py``).

``guided_wta_fused`` keeps the JAX entry's contract
(pallas_guided.py:555-566): uint8 (H,W) ×2 in, (best_cost, disparity)
float32 (H,W) out, labels ``dmin + s``.  On CUDA tensors it launches
kernel K1 (``csrc/guided_wta.cu``) and counts the launch in
``guided_wta_fused.launches``; on CPU tensors it runs the plain version,
``guided_wta_fused_reference``.  The kernel never materializes the cost
volume and is held to the fused fast-path bound against the plain
version (near-tie label flips only).
"""

from __future__ import annotations

import torch

from ..config import StereoConfig, DEFAULT_CONFIG
from . import _kernels
from .cost import cost_constants, cost_volume
from .guided import guided_filter_wta


def guided_wta_fused_reference(gray1: torch.Tensor, gray2: torch.Tensor,
                               dmin: int, cfg: StereoConfig = DEFAULT_CONFIG):
    """Plain PyTorch version of K1: ``cost_volume`` then
    ``guided_filter_wta``."""
    cost = cost_volume(gray1, gray2, dmin, cfg)
    best, dmap, _ = guided_filter_wta(gray1, cost, dmin, cfg)
    return best, dmap


def guided_wta_fused(gray1: torch.Tensor, gray2: torch.Tensor, dmin: int,
                     cfg: StereoConfig = DEFAULT_CONFIG):
    """uint8 (H,W) ×2 → (best_cost f32 (H,W), disparity f32 (H,W)): cost
    vs ``gray2``, aggregation guided by ``gray1``, streaming WTA with
    labels dmin+s."""
    if gray1.device.type == "cpu" and gray2.device.type == "cpu":
        return guided_wta_fused_reference(gray1, gray2, dmin, cfg)
    if gray1.device.type != "cuda" or gray2.device != gray1.device:
        raise ValueError(f"guided_wta_fused takes two tensors on one CUDA "
                         f"device or on the CPU, got {gray1.device} and "
                         f"{gray2.device}")
    if gray1.dtype != torch.uint8 or gray2.dtype != torch.uint8:
        raise TypeError(f"expected uint8 images, got {gray1.dtype}, {gray2.dtype}")
    if gray1.ndim != 2 or gray1.shape != gray2.shape:
        raise ValueError(f"expected two (H, W) images of one shape, got "
                         f"{tuple(gray1.shape)} and {tuple(gray2.shape)}")
    gray1, gray2 = gray1.contiguous(), gray2.contiguous()
    best = torch.empty(gray1.shape, dtype=torch.float32, device=gray1.device)
    dmap = torch.empty_like(best)
    with torch.cuda.device(gray1.device):
        _kernels.guided_wta(gray1, gray2, best, dmap, dmin, cfg.size_d,
                            cfg.radius, cost_constants(cfg), cfg.eps)
    guided_wta_fused.launches += 1
    return best, dmap


guided_wta_fused.launches = 0
