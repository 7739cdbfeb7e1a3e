"""Stereo evaluation metrics and run statistics, NumPy only: bad-N
pixel rate, EPE and the occlusion count.

A copy of ``stereo_matching_cuda_tpu/metrics.py:14-58``: importing the
JAX package imports JAX, which the port's machines need not have.
"""

from __future__ import annotations

import numpy as np


def bad_pixel_rate(
    disp: np.ndarray,
    gt: np.ndarray,
    threshold: float = 2.0,
    invalid_below: float | None = None,
    gt_invalid: float = 0.0,
) -> float:
    """Fraction (%) of pixels whose |disp - gt| exceeds ``threshold``.

    ``invalid_below``: disparities below this (e.g. the occlusion
    sentinel −115) are counted as bad unless the GT is also invalid.
    ``gt_invalid``: GT pixels equal to this value are excluded (the
    Middlebury/KITTI convention of 0 = no ground truth).
    """
    disp = np.asarray(disp, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    valid_gt = gt != gt_invalid
    if not valid_gt.any():
        return 0.0
    err = np.abs(disp - gt)
    bad = err > threshold
    if invalid_below is not None:
        bad |= disp < invalid_below
    return 100.0 * float(bad[valid_gt].sum()) / float(valid_gt.sum())


def end_point_error(disp: np.ndarray, gt: np.ndarray, gt_invalid: float = 0.0) -> float:
    """Mean absolute disparity error over valid-GT pixels."""
    disp = np.asarray(disp, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    valid = gt != gt_invalid
    if not valid.any():
        return 0.0
    return float(np.abs(disp - gt)[valid].mean())



def occlusion_stats(occlusion_map: np.ndarray, v_min: float) -> dict:
    """Occluded-pixel count/fraction, mirroring detect_occlusionOnCPU's
    printed count (occlusion.cu:106)."""
    occ = np.asarray(occlusion_map)
    n_occl = int((occ.astype(np.int32) < v_min).sum())
    return {
        "occluded_pixels": n_occl,
        "occluded_pct": round(100.0 * n_occl / occ.size, 2),
    }
