"""Fused cost + guided aggregation + WTA (counterpart of
``stereo_matching_cuda_tpu/ops/pallas_guided.py``).

Two entries, each keeping its JAX entry's contract:

- ``guided_wta_fused`` (pallas_guided.py:555-568), one view: uint8 (H,W)
  or (B,H,W) ×2 in, (best_cost, disparity) float32 of the input shape
  out, labels ``dmin + s``.  On CUDA tensors it launches kernel K1
  (``csrc/guided_wta_stream.cu``, a row walk down a band) when
  ``cfg.stream`` is True and kernel K3 (``csrc/guided_wta.cu``, tiled)
  otherwise (``pipeline.use_stream``), counting each in
  ``guided_wta_fused.k1_launches`` or ``.k3_launches``.
- ``guided_wta_fused_dual`` (pallas_guided.py:1733-1810), both views in
  one pass: uint8 (H,W) or (B,H,W) ×2 in, (best_l, dmap_l, best_r,
  dmap_r) float32 out.  On CUDA tensors it launches kernel K5
  (``csrc/guided_wta_dual_stream.cu``, a row walk down a band) when
  ``pipeline.use_stream`` holds and kernel K4 (``csrc/guided_wta_dual.cu``,
  tiled) otherwise, counting each in ``guided_wta_fused_dual.k5_launches``
  or ``.k4_launches``.

On CPU tensors each runs its plain version (``guided_wta_fused_reference``,
``guided_wta_fused_dual_reference``); on any other device it raises.  The
kernels never materialize the cost volume and are held to the fused
fast-path bound against the plain versions (near-tie label flips only).
"""

from __future__ import annotations

import torch

from ..config import StereoConfig, DEFAULT_CONFIG
from . import _kernels
from .cost import cost_constants, cost_volume
from .guided import guided_filter_wta


def _per_frame(fn, a, b, *args):
    """``fn`` over the frames of a leading batch axis, outputs stacked."""
    frames = [fn(x, y, *args) for x, y in zip(a, b)]
    return tuple(torch.stack(t) for t in zip(*frames))


def guided_wta_fused_reference(gray1: torch.Tensor, gray2: torch.Tensor,
                               dmin: int, cfg: StereoConfig = DEFAULT_CONFIG):
    """Plain PyTorch version of K1 and K3: ``cost_volume`` then
    ``guided_filter_wta``, frame by frame over a leading batch axis."""
    if gray1.ndim == 3:
        return _per_frame(guided_wta_fused_reference, gray1, gray2, dmin, cfg)
    cost = cost_volume(gray1, gray2, dmin, cfg)
    best, dmap, _ = guided_filter_wta(gray1, cost, dmin, cfg)
    return best, dmap


def guided_wta_fused_dual_reference(gray_l: torch.Tensor, gray_r: torch.Tensor,
                                    cfg: StereoConfig = DEFAULT_CONFIG):
    """Plain PyTorch version of K4 and K5: the two single-view plain calls
    (left labels d_min.., right labels d_min_right..), frame by frame
    over a leading batch axis."""
    if gray_l.ndim == 3:
        return _per_frame(guided_wta_fused_dual_reference, gray_l, gray_r, cfg)
    best_l, dmap_l = guided_wta_fused_reference(gray_l, gray_r, cfg.d_min, cfg)
    best_r, dmap_r = guided_wta_fused_reference(gray_r, gray_l, cfg.d_min_right, cfg)
    return best_l, dmap_l, best_r, dmap_r


def _check_cuda_pair(name, gray1, gray2, ndims) -> None:
    if gray1.device.type != "cuda" or gray2.device != gray1.device:
        raise ValueError(f"{name} takes two tensors on one CUDA device or on "
                         f"the CPU, got {gray1.device} and {gray2.device}")
    if gray1.dtype != torch.uint8 or gray2.dtype != torch.uint8:
        raise TypeError(f"expected uint8 images, got {gray1.dtype}, {gray2.dtype}")
    if gray1.ndim not in ndims or gray1.shape != gray2.shape:
        raise ValueError(f"expected two images of one shape with "
                         f"{' or '.join(map(str, ndims))} dimensions, got "
                         f"{tuple(gray1.shape)} and {tuple(gray2.shape)}")


def guided_wta_fused(gray1: torch.Tensor, gray2: torch.Tensor, dmin: int,
                     cfg: StereoConfig = DEFAULT_CONFIG):
    """uint8 (H,W) or (B,H,W) ×2 → (best_cost, disparity), f32 of the
    input shape: cost vs ``gray2``, aggregation guided by ``gray1``,
    streaming WTA with labels dmin+s.  A batch is one launch."""
    if gray1.device.type == "cpu" and gray2.device.type == "cpu":
        return guided_wta_fused_reference(gray1, gray2, dmin, cfg)
    _check_cuda_pair("guided_wta_fused", gray1, gray2, (2, 3))
    from ..pipeline import use_stream   # here: the pipeline imports this module

    h, w = gray1.shape[-2:]
    g1 = gray1.contiguous().reshape(-1, h, w)
    g2 = gray2.contiguous().reshape(-1, h, w)
    best = torch.empty(gray1.shape, dtype=torch.float32, device=gray1.device)
    dmap = torch.empty_like(best)
    stream = use_stream(cfg, h, w, dual=False)
    launch = _kernels.guided_wta_stream if stream else _kernels.guided_wta
    with torch.cuda.device(gray1.device):
        launch(g1, g2, best.view(-1, h, w), dmap.view(-1, h, w), dmin,
               cfg.size_d, cfg.radius, cost_constants(cfg), cfg.eps)
    if stream:
        guided_wta_fused.k1_launches += 1
    else:
        guided_wta_fused.k3_launches += 1
    return best, dmap


guided_wta_fused.k1_launches = 0
guided_wta_fused.k3_launches = 0


def guided_wta_fused_dual(gray_l: torch.Tensor, gray_r: torch.Tensor,
                          cfg: StereoConfig = DEFAULT_CONFIG):
    """uint8 (H,W) or (B,H,W) ×2 → (best_l, dmap_l, best_r, dmap_r), f32
    of the input shape: both views' matching in one kernel pass (left
    labels d_min + s, right labels d_min_right + s)."""
    if gray_l.device.type == "cpu" and gray_r.device.type == "cpu":
        return guided_wta_fused_dual_reference(gray_l, gray_r, cfg)
    _check_cuda_pair("guided_wta_fused_dual", gray_l, gray_r, (2, 3))
    from ..pipeline import use_stream   # here: the pipeline imports this module

    h, w = gray_l.shape[-2:]
    gl = gray_l.contiguous().reshape(-1, h, w)
    gr = gray_r.contiguous().reshape(-1, h, w)
    outs = [torch.empty(gray_l.shape, dtype=torch.float32, device=gray_l.device)
            for _ in range(4)]
    stream = use_stream(cfg, h, w, dual=True)
    launch = _kernels.guided_wta_dual_stream if stream else _kernels.guided_wta_dual
    with torch.cuda.device(gray_l.device):
        launch(gl, gr, outs, cfg.d_min, cfg.size_d, cfg.radius,
               cost_constants(cfg), cfg.eps)
    if stream:
        guided_wta_fused_dual.k5_launches += 1
    else:
        guided_wta_fused_dual.k4_launches += 1
    return tuple(outs)


guided_wta_fused_dual.k4_launches = 0
guided_wta_fused_dual.k5_launches = 0
