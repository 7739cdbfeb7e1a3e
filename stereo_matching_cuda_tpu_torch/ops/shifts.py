"""Column shifts with edge replication (counterpart of
``stereo_matching_cuda_tpu/ops/shifts.py``)."""

from __future__ import annotations

import torch


def shift_cols(arr: torch.Tensor, d: int) -> torch.Tensor:
    """out[..., x] = arr[..., x+d] with edge replication (consumers mask
    out-of-range columns via validity/coordinate tests)."""
    if d == 0:
        return arr
    w = arr.shape[-1]
    if d >= w or -d >= w:
        edge = arr[..., -1:] if d > 0 else arr[..., :1]
        return edge.expand(arr.shape).contiguous()
    if d > 0:
        edge = arr[..., -1:].expand(*arr.shape[:-1], d)
        return torch.cat([arr[..., d:], edge], dim=-1)
    edge = arr[..., :1].expand(*arr.shape[:-1], -d)
    return torch.cat([edge, arr[..., : w + d]], dim=-1)
