"""Guided-filter cost aggregation + winner-take-all, batched over D
(counterpart of ``stereo_matching_cuda_tpu/ops/guided.py``).

  I       = float(gray)
  mean_I  = box(I);  var = box(I·I) - mean_I²          (guidedFilter.cu:62-121)
  c       = fl32(1.0 / (f64(var) + f64(EPS)))           (guidedFilter.cu:350)
  ∀d:  mean_p = box(p);  mean_Ip = box(I·p)
       a = (mean_Ip - mean_I·mean_p)·c;  b = mean_p - mean_I·a   (:345-354)
       q = box(a)·I + box(b)                                      (:363-369)
  WTA: streaming `if best >= q` with ascending d         (:403-411)
       ⇒ final d = LARGEST d attaining min_d q
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import StereoConfig, DEFAULT_CONFIG
from .boxfilter import box_mean, strict_mul, window_area
from .image import fl_to_ch

# memset(best_cost, 9999999.0f, ...) fills bytes 0x7F: 3.3961514e38
# (main.cu:112-115).  Any real q is smaller, so the first compare fires.
BEST_COST_INIT = float(np.frombuffer(b"\x7f\x7f\x7f\x7f", dtype="<f4")[0])


def recip_var_eps(var: torch.Tensor, eps: float) -> torch.Tensor:
    """fl32(1.0 / (var + eps)) evaluated in float64, as the reference's
    double EPS literal promotes it (reference.py:203)."""
    return torch.reciprocal(var.to(torch.float64) + float(eps)).to(torch.float32)


def _chunk_filter(I, mean_i, c, area, cost_chunk, radius, exact=False):
    """Filter a (Dc, H, W) chunk of cost slices → q (Dc, H, W)."""
    def bm(x):
        return box_mean(x, radius, area, exact=exact)

    mean_p = bm(cost_chunk)
    mean_ip = bm(strict_mul(I, cost_chunk))
    a = (mean_ip - strict_mul(mean_i, mean_p)) * c
    b = mean_p - strict_mul(mean_i, a)
    return strict_mul(bm(a), I) + bm(b)


def streaming_wta(q: torch.Tensor):
    """(Dc,H,W) → (best, sidx): running min with LAST-wins ties
    (ascending-d streaming with `>=`).  ``torch.argmin`` returns the
    first minimum, so it runs over the reversed slice axis."""
    dc = q.shape[0]
    best = torch.amin(q, dim=0)
    sidx = (dc - 1) - torch.argmin(torch.flip(q, dims=(0,)), dim=0)
    return best, sidx


def guided_filter_wta(
    gray: torch.Tensor,
    cost: torch.Tensor,
    dmin: int,
    cfg: StereoConfig = DEFAULT_CONFIG,
):
    """Returns (best_cost f32, disparity f32, mean uint8) for one view.
    ``cost`` is the (D, H, W) volume; ``dmin`` the label of slice 0."""
    r = cfg.radius
    h, w = gray.shape
    area = window_area(h, w, r, gray.device)
    exact = cfg.exact_integral
    I = gray.to(torch.float32)
    mean_i = box_mean(I, r, area, exact=exact)
    mean_u8 = fl_to_ch(mean_i)
    var = (box_mean(strict_mul(I, I), r, area, exact=exact)
           - strict_mul(mean_i, mean_i))
    c = recip_var_eps(var, cfg.eps)

    size_d = cost.shape[0]
    dc = cfg.d_chunk or size_d
    if size_d % dc != 0:
        raise ValueError(f"d_chunk {dc} must divide size_d {size_d}")

    def chunk_q(chunk):
        return _chunk_filter(I, mean_i, c, area, chunk, r, exact)

    if dc == size_d:
        best, sidx = streaming_wta(chunk_q(cost))
        return best, (dmin + sidx).to(torch.float32), mean_u8
    best, dmap = chunked_wta_scan(cost, dc, dmin, chunk_q)
    return best, dmap, mean_u8


def chunked_wta_scan(cost: torch.Tensor, dc: int, dmin: int,
                     chunk_q: Callable[[torch.Tensor], torch.Tensor]):
    """Ascending d-chunk streaming WTA: aggregate each chunk of ``dc``
    slices with ``chunk_q(chunk) -> q`` and carry (best, dmap) under the
    ascending ``best >= q`` rule (largest d wins ties)."""
    size_d, h, w = cost.shape
    best = torch.full((h, w), BEST_COST_INIT, dtype=torch.float32,
                      device=cost.device)
    dmap = torch.zeros((h, w), dtype=torch.float32, device=cost.device)
    for start in range(0, size_d, dc):
        bestc, sidx = streaming_wta(chunk_q(cost[start: start + dc]))
        upd = best >= bestc
        best = torch.where(upd, bestc, best)
        dmap = torch.where(upd, (dmin + start + sidx).to(torch.float32), dmap)
    return best, dmap
