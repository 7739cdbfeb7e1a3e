"""Matching cost volume, all disparities at once (counterpart of
``stereo_matching_cuda_tpu/ops/cost.py``).

Reference kernel costVolumOnGPU2 (costVolume.cu:163-221):

  cost[d,y,x] = (1-α)·min(|I1[x] - I2[x+d]|, TH_color)
              + α·min(|∇1[x] - ∇2[x+d]|, TH_grad)          (f32; :187)
  out-of-range x+d ⇒ (1-α)·TH_color + α·TH_grad (= 2.5)    (:184)

Layout (D, H, W), slice s ↔ d = dmin + s.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import StereoConfig, DEFAULT_CONFIG
from .boxfilter import strict_mul
from .image import x_derivative
from .shifts import shift_cols


def cost_constants(cfg: StereoConfig):
    """(1-α, α, TH_color, TH_grad, out-of-range cost), each rounded to
    float32 the way the reference's float expressions round them."""
    alpha = np.float32(cfg.alpha)
    th_color = np.float32(cfg.th_color)
    th_grad = np.float32(cfg.th_grad)
    one_m_alpha = np.float32(1) - alpha
    oob = one_m_alpha * th_color + alpha * th_grad
    return tuple(float(v) for v in (one_m_alpha, alpha, th_color, th_grad, oob))


def cost_volume(
    i1: torch.Tensor,
    i2: torch.Tensor,
    dmin: int,
    cfg: StereoConfig = DEFAULT_CONFIG,
    der1: torch.Tensor | None = None,
    der2: torch.Tensor | None = None,
) -> torch.Tensor:
    """uint8 (H,W) ×2 → float32 (D, H, W) truncated AD + gradient cost."""
    if der1 is None:
        der1 = x_derivative(i1)
    if der2 is None:
        der2 = x_derivative(i2)
    g1 = i1.to(torch.int32)
    g2 = i2.to(torch.int32)
    one_m_alpha, alpha, th_color, th_grad, oob = cost_constants(cfg)
    w = i1.shape[-1]
    x = torch.arange(w, device=i1.device)

    slices = []
    for d in cfg.disparities(dmin):
        valid = (x + d >= 0) & (x + d < w)
        diff = (g1 - shift_cols(g2, d)).abs().to(torch.float32)
        grad = (der1 - shift_cols(der2, d)).abs()
        c = (strict_mul(torch.clamp(diff, max=th_color), one_m_alpha)
             + strict_mul(torch.clamp(grad, max=th_grad), alpha))
        slices.append(torch.where(valid, c, oob))
    return torch.stack(slices, dim=0)
