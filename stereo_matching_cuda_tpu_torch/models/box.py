"""Plain box-mean cost aggregation (classic SAD+box baseline;
counterpart of ``stereo_matching_cuda_tpu/models/box.py``).

Aggregation is q = box_mean(cost slice); everything around it (cost
volume, the ascending `best >= q` WTA, LR check, occlusion fill) is
shared with the guided model.  The JAX package computes it with XLA ops,
so it has no matching kernel here either; its post stage goes through
``pipeline._post`` (kernel K2 on CUDA, bit-identical to the plain ops).
"""

from __future__ import annotations

import torch

from .. import ops
from ..config import StereoConfig, DEFAULT_CONFIG
from ..ops.boxfilter import box_mean, window_area
from ..ops.guided import chunked_wta_scan, streaming_wta
from ..pipeline import _post
from .base import StereoMatcher


def box_stereo_pipeline(rgb_left: torch.Tensor, rgb_right: torch.Tensor,
                        cfg: StereoConfig = DEFAULT_CONFIG) -> dict:
    """uint8 (H,W,C) ×2 → dict of tensors on the inputs' device:
    disparity_left/right, best_cost_left/right, occlusion,
    occlusion_filled."""
    gl = ops.rgb_to_grayscale(rgb_left, cfg)
    gr = ops.rgb_to_grayscale(rgb_right, cfg)
    h, w = gl.shape
    area = window_area(h, w, cfg.radius, gl.device)

    def box_q(chunk):
        return box_mean(chunk, cfg.radius, area, exact=cfg.exact_integral)

    def view(g1, g2, dmin):
        cost = ops.cost_volume(g1, g2, dmin, cfg)
        dc = cfg.d_chunk or cfg.size_d   # divides size_d (config validation)
        if dc == cfg.size_d:
            best, sidx = streaming_wta(box_q(cost))
            return best, (dmin + sidx).to(torch.float32)
        # d-chunk streaming through the shared ascending `best >= q` carry
        return chunked_wta_scan(cost, dc, dmin, box_q)

    best_l, dmap_l = view(gl, gr, cfg.d_min)
    best_r, dmap_r = view(gr, gl, cfg.d_min_right)
    occ, filled = _post(dmap_l, dmap_r, cfg)
    return {
        "disparity_left": dmap_l,
        "disparity_right": dmap_r,
        "best_cost_left": best_l,
        "best_cost_right": best_r,
        "occlusion": occ,
        "occlusion_filled": filled,
    }


class BoxStereoMatcher(StereoMatcher):
    """Box-mean aggregation: cheaper and softer than the guided filter
    (no edge-preserving coefficients)."""

    def _forward(self, left, right) -> dict:
        return box_stereo_pipeline(left, right, self.cfg)
