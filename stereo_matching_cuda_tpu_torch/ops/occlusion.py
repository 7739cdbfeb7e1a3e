"""Left-right consistency check and occlusion filling (counterpart of
``stereo_matching_cuda_tpu/ops/occlusion.py``).

Reference: detect_occlusionOnGPU (occlusion.cu:3-15) and
fill_occlusionOnGPU1 (occlusion.cu:134-176).  The reference's fill
kernel races on its own buffer; this framework defines the
deterministic semantics: every occluded pixel receives
``max(nearest valid value to its left, nearest valid value to its
right)`` from the ORIGINAL map, with ``v_min`` where a side has none.
"""

from __future__ import annotations

import torch

from ..config import StereoConfig, DEFAULT_CONFIG


def detect_occlusion(
    disp_left: torch.Tensor,
    disp_right: torch.Tensor,
    d_occlusion: int,
    cfg: StereoConfig = DEFAULT_CONFIG,
    dmin: int | None = None,
) -> torch.Tensor:
    """Write ``d_occlusion`` into LR-inconsistent left-map pixels.

    d = (int)dispL[x] (trunc); occluded iff x+d ∉ [0,w) or
    |d + dispR[x+d]| > D_LR (occlusion.cu:8-12).  Label-set semantics of
    the JAX op: dispR[x+d] is read only when d is one of
    ``cfg.disparities(dmin)``; any other d reads dprime = 0."""
    w = disp_left.shape[-1]
    lo = cfg.d_min if dmin is None else dmin
    d = disp_left.to(torch.int32)   # trunc toward zero
    x = torch.arange(w, dtype=torch.int32, device=disp_left.device)
    xs = x + d
    in_range = (xs >= 0) & (xs < w)
    gathered = torch.gather(disp_right, -1, xs.clamp(0, w - 1).to(torch.int64))
    in_set = (d >= lo) & (d < lo + cfg.size_d)
    dprime = torch.where(in_set, gathered, 0.0)
    bad = (d.to(torch.float32) + dprime).abs() > float(cfg.d_lr)
    occl = (~in_range) | bad
    return torch.where(occl, float(d_occlusion), disp_left)


def _last_valid_packed(disp: torch.Tensor, valid: torch.Tensor,
                       d_min: int, n_labels: int, reverse: bool):
    """Per row: label of the nearest valid pixel at <= x (>= x when
    ``reverse``), and whether there is one.  Packs (position, label
    code) into one key so nearest-valid is a single running max."""
    w = disp.shape[-1]
    x = torch.arange(w, dtype=torch.int64, device=disp.device)
    # clamp: a value outside the label set would otherwise spill into a
    # neighbour's key range (ops/occlusion.py:94)
    code = (disp.to(torch.int64) - d_min).clamp(0, n_labels - 1)
    pos = (w - 1 - x) if reverse else x
    key = torch.where(valid, pos * n_labels + code, -1)
    if reverse:
        m = torch.cummax(key.flip(-1), dim=-1).values.flip(-1)
    else:
        m = torch.cummax(key, dim=-1).values
    val = (m.clamp(min=0) % n_labels + d_min).to(torch.float32)
    return val, m >= 0


def fill_occlusion(disp: torch.Tensor, v_min: float,
                   cfg: StereoConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Fill occluded pixels (trunc(disp) < v_min, occlusion.cu:140-142)
    with max(nearest-valid-left, nearest-valid-right); a side with no
    valid pixel contributes v_min (occlusion.cu:147,161).  Valid values
    are integer labels in [cfg.d_min, cfg.d_max], as the WTA emits."""
    vminf = float(v_min)
    occl = disp.to(torch.int32) < v_min
    valid = disp >= vminf   # float compare, occlusion.cu:152,167
    lv, lf = _last_valid_packed(disp, valid, cfg.d_min, cfg.size_d, False)
    rv, rf = _last_valid_packed(disp, valid, cfg.d_min, cfg.size_d, True)
    dleft = torch.where(lf, lv, vminf)
    dright = torch.where(rf, rv, vminf)
    return torch.where(occl, torch.maximum(dleft, dright), disp)
