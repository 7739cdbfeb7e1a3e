"""Image-plane ops: grayscale conversion, float→uint8, x-derivative
(counterpart of ``stereo_matching_cuda_tpu/ops/image.py``).

Reference kernels: sumArraysOnGPU (rgb_to_grayscale.cu:14-23),
flToChOnGPU (guidedFilter.cu:451-458), x_derivativeOnGPU
(costVolume.cu:358-381).
"""

from __future__ import annotations

import torch

from ..config import StereoConfig, DEFAULT_CONFIG


def rgb_to_grayscale(rgb: torch.Tensor,
                     cfg: StereoConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """uint8 (..., H, W, C) → uint8 (..., H, W), alpha ignored.

    The reference's own formula, ``(r_w*r + g_w*g) + b_w*b`` in float64
    with a truncating cast (reference.py:41-45), in the same association
    order and with no fused multiply-add, so it is bit-exact in every
    mode.  The JAX package's integer correction tables exist only
    because its device lacks fast float64."""
    r = rgb[..., 0].to(torch.float64)
    g = rgb[..., 1].to(torch.float64)
    b = rgb[..., 2].to(torch.float64)
    val = (cfg.r_w * r + cfg.g_w * g) + cfg.b_w * b
    return val.to(torch.uint8)   # values are in [0, 256): trunc toward zero


def fl_to_ch(img: torch.Tensor) -> torch.Tensor:
    """float32 → uint8: C-style trunc-toward-zero int cast, clamp > 255
    to 255, then (unsigned char) wraparound for negatives."""
    c = img.to(torch.int32)
    c = torch.where(c > 255, 255, c)
    return (c & 0xFF).to(torch.uint8)


def x_derivative(gray: torch.Tensor) -> torch.Tensor:
    """uint8 (..., H, W) → float32, negated central difference
    (I[x-1] - I[x+1]) / 2 with one-sided (still ÷2) borders
    (costVolume.cu:362-378).  Half-integers: exact in float32."""
    g = gray.to(torch.int32)
    c1 = torch.cat([g[..., 1:], g[..., -1:]], dim=-1)   # in[id+1]; edge in[id]
    c2 = torch.cat([g[..., :1], g[..., :-1]], dim=-1)   # in[id-1]; edge in[id]
    return (c2 - c1).to(torch.float32) * 0.5
