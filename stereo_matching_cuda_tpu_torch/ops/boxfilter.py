"""Integral image + clamped-window box mean, batched over leading axes
(counterpart of ``stereo_matching_cuda_tpu/ops/boxfilter.py``).

Window semantics (guidedFilter.cu:305-318):
  ymin = max(-1, y-R-1), ymax = min(h-1, y+R)   (ditto x)
  sum  = S[ymax,xmax] - S[ymax,xmin] - S[ymin,xmax] + S[ymin,xmin]
         (terms with index -1 are 0)
  mean = sum / ((xmax-xmin) * (ymax-ymin))      ← *clamped* area

With Sp the zero-top-left-padded integral edge-padded by R on every
side, the four clamped taps become static slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def strict_mul(a: torch.Tensor, b) -> torch.Tensor:
    """a*b rounded to float32 before any following add.  Eager PyTorch
    rounds after every op and never contracts into an FMA, so this is a
    plain product; it names the places where the reference's rounding
    order matters (the JAX package needs a guard there)."""
    return torch.mul(a, b)


def _seq_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Strictly sequential (left-to-right) float32 cumsum: the
    reference's serial rowSum/colSum association (integral.cu:78-131).
    ``torch.cumsum`` accumulates float32 in float64 on the CPU and runs a
    parallel scan on CUDA, so neither matches it."""
    xs = x.movedim(dim, 0)
    out = torch.empty_like(xs)
    carry = torch.zeros_like(xs[0])
    for i in range(xs.shape[0]):
        carry = carry + xs[i]
        out[i] = carry
    return out.movedim(0, dim)


def integral_image(img: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """(..., H, W) → inclusive 2-D prefix sum over the last two axes
    (rowSum then colSum).  ``exact`` takes the reference's sequential
    float32 association (parity mode).  Otherwise the integral is float64
    (``torch.cumsum``): a float32 integral of I² reaches ~4e11 at 6 MP,
    and its rounding would swamp the guided filter's covariance terms."""
    if exact:
        return _seq_cumsum(_seq_cumsum(img, -1), -2)
    return torch.cumsum(torch.cumsum(img, dim=-1, dtype=torch.float64), dim=-2)


def window_area(h: int, w: int, radius: int,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """float32 (H, W) clamped window area (xmax-xmin)(ymax-ymin)
    (guidedFilter.cu:314-317).  Interior value (2R+1)²."""
    y = torch.arange(h, dtype=torch.int32, device=device)
    x = torch.arange(w, dtype=torch.int32, device=device)
    ay = torch.clamp(y + radius, max=h - 1) - torch.clamp(y - radius - 1, min=-1)
    ax = torch.clamp(x + radius, max=w - 1) - torch.clamp(x - radius - 1, min=-1)
    return (ay[:, None] * ax[None, :]).to(torch.float32)


def box_sum(img: torch.Tensor, radius: int, exact: bool = False) -> torch.Tensor:
    """Clamped-window box *sum* over the last two axes, from the four
    taps of ``integral_image`` (float64 unless ``exact``), each window
    sum rounded to ``img``'s dtype once."""
    h, w = img.shape[-2:]
    r = radius
    s = integral_image(img, exact=exact)
    lead = s.shape[:-2]
    # zero pad on top/left (the "-1 index reads 0" rule), then edge pad
    # by R on every side (the clamping rule)
    sp = F.pad(s.reshape(-1, h, w), (1, 0, 1, 0))
    b = F.pad(sp[:, None], (r, r, r, r), mode="replicate")[:, 0]
    b = b.reshape(*lead, h + 1 + 2 * r, w + 1 + 2 * r)
    k = 2 * r + 1

    def sl(y0, x0):
        return b[..., y0: y0 + h, x0: x0 + w]

    return (sl(k, k) - sl(k, 0) - sl(0, k) + sl(0, 0)).to(img.dtype)


def box_mean(img: torch.Tensor, radius: int,
             area: torch.Tensor | None = None,
             exact: bool = False) -> torch.Tensor:
    """Clamped-window box mean (computeMeanOnGPU, guidedFilter.cu:305-318).
    ``area`` may be passed in to share the (H, W) normalizer."""
    if area is None:
        area = window_area(img.shape[-2], img.shape[-1], radius, img.device)
    return box_sum(img, radius, exact=exact) / area
