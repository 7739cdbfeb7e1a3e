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

- ``guided_wta_fused_local`` (pallas_guided.py:1813-1911), one view of
  one tile of the sharded path (``parallel/sharded.py``): uint8 (H_e, W_e)
  or (B, H_e, W_e) tiles extended by a halo on each side (real neighbour
  pixels, zeros beyond the global image), the global origin of the
  interior and the global image size in; (best, dmap) float32 of the
  (tile_h, tile_w) interior out.  On CUDA tensors it launches K3, or K1
  where ``pipeline.use_stream`` holds, with the tile's origin, counted
  in the same counters.

On CPU tensors each runs its plain version (``guided_wta_fused_reference``,
``guided_wta_fused_dual_reference``, ``guided_wta_fused_local_reference``);
on any other device it raises.  The kernels never materialize the cost
volume and are held to the fused fast-path bound against the plain
versions (near-tie label flips only).
"""

from __future__ import annotations

import torch

from ..config import StereoConfig, DEFAULT_CONFIG
from . import _kernels
from .boxfilter import box_sum, strict_mul
from .cost import cost_constants, cost_volume
from .guided import guided_filter_wta, recip_var_eps, streaming_wta
from .shifts import shift_cols


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


def _launch_single(gray1, gray2, dmin: int, size_d: int, cfg: StereoConfig,
                   tile: _kernels.Tile):
    """K1 or K3 (``pipeline.use_stream`` of the interior) on uint8 (H_b,
    W_b) or (B, H_b, W_b) CUDA buffers placed by ``tile``: (best, dmap)
    float32 of the interior, counted in ``guided_wta_fused``'s counters."""
    from ..pipeline import use_stream   # here: the pipeline imports this module

    hb, wb = gray1.shape[-2:]
    g1 = gray1.contiguous().reshape(-1, hb, wb)
    g2 = gray2.contiguous().reshape(-1, hb, wb)
    out_shape = (*gray1.shape[:-2], tile.th, tile.tw)
    best = torch.empty(out_shape, dtype=torch.float32, device=gray1.device)
    dmap = torch.empty_like(best)
    stream = use_stream(cfg, tile.th, tile.tw, dual=False)
    launch = _kernels.guided_wta_stream if stream else _kernels.guided_wta
    with torch.cuda.device(gray1.device):
        launch(g1, g2, best.view(-1, tile.th, tile.tw), dmap.view(-1, tile.th, tile.tw),
               dmin, size_d, cfg.radius, cost_constants(cfg), cfg.eps, tile=tile)
    if stream:
        guided_wta_fused.k1_launches += 1
    else:
        guided_wta_fused.k3_launches += 1
    return best, dmap


def guided_wta_fused(gray1: torch.Tensor, gray2: torch.Tensor, dmin: int,
                     cfg: StereoConfig = DEFAULT_CONFIG):
    """uint8 (H,W) or (B,H,W) ×2 → (best_cost, disparity), f32 of the
    input shape: cost vs ``gray2``, aggregation guided by ``gray1``,
    streaming WTA with labels dmin+s.  A batch is one launch."""
    if gray1.device.type == "cpu" and gray2.device.type == "cpu":
        return guided_wta_fused_reference(gray1, gray2, dmin, cfg)
    _check_cuda_pair("guided_wta_fused", gray1, gray2, (2, 3))
    return _launch_single(gray1, gray2, dmin, cfg.size_d, cfg,
                          _kernels.Tile.whole(*gray1.shape[-2:]))


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


# --- one tile of the sharded path ----------------------------------------
# The plain version is the JAX sharded path's own per-frame path
# (stereo_matching_cuda_tpu/parallel/sharded.py:50-138): every field is
# computed over the extended tile in global coordinates, zero outside the
# global image, and cropped to the interior.


def global_area(gy: torch.Tensor, gx: torch.Tensor, h: int, w: int, r: int) -> torch.Tensor:
    """Clamped window area at global rows ``gy`` and columns ``gx``
    (guidedFilter.cu:314-317), float32 (len(gy), len(gx))."""
    ay = torch.clamp(gy + r, max=h - 1) - torch.clamp(gy - r - 1, min=-1)
    ax = torch.clamp(gx + r, max=w - 1) - torch.clamp(gx - r - 1, min=-1)
    return (ay[:, None] * ax[None, :]).to(torch.float32)


def _x_derivative_global(g: torch.Tensor, gx: torch.Tensor, w: int) -> torch.Tensor:
    """Negated central difference with one-sided borders at the global
    image's edges (costVolume.cu:362-378), on an extended tile."""
    gi = g.to(torch.int32)
    c1 = torch.where(gx[None, :] < w - 1, shift_cols(gi, 1), gi)    # in[id+1]
    c2 = torch.where(gx[None, :] > 0, shift_cols(gi, -1), gi)       # in[id-1]
    return (c2 - c1).to(torch.float32) * 0.5


def _local_cost_volume(g1, der1, g2, der2, gx, dmin, size_d, w, cfg, in_image):
    """(H_e, W_e) extended tiles → (size_d, H_e, W_e) cost, zero outside
    the image.  ``dmin`` is a Python int on every mesh, so one form serves
    the JAX package's static and traced (disparity-sharded) volumes: an
    edge-padded dynamic slice is ``shift_cols``."""
    one_m_alpha, alpha, th_color, th_grad, oob = cost_constants(cfg)
    g1i = g1.to(torch.int32)
    g2i = g2.to(torch.int32)
    slices = []
    for d in range(dmin, dmin + size_d):
        valid = ((gx + d >= 0) & (gx + d < w))[None, :]
        diff = (g1i - shift_cols(g2i, d)).abs().to(torch.float32)
        grad = (der1 - shift_cols(der2, d)).abs()
        c = (strict_mul(torch.clamp(diff, max=th_color), one_m_alpha)
             + strict_mul(torch.clamp(grad, max=th_grad), alpha))
        c = torch.where(valid, c, oob)
        slices.append(torch.where(in_image, c, 0.0))
    return torch.stack(slices, dim=0)


def _local_guided_q(g_ext, cost, area, in_image, cfg) -> torch.Tensor:
    """Extended-tile guided filter: the uncropped filtered costs q
    (D, H_e, W_e); a and b are zero outside the image."""
    r = cfg.radius
    I = g_ext.to(torch.float32)     # zeros outside the image (zero halos)
    mean_i = box_sum(I, r) / area
    var = box_sum(strict_mul(I, I), r) / area - strict_mul(mean_i, mean_i)
    c = recip_var_eps(var, cfg.eps)
    mean_p = box_sum(cost, r) / area
    mean_ip = box_sum(strict_mul(I, cost), r) / area
    a = (mean_ip - strict_mul(mean_i, mean_p)) * c
    b = mean_p - strict_mul(mean_i, a)
    a = torch.where(in_image, a, 0.0)
    b = torch.where(in_image, b, 0.0)
    return strict_mul(box_sum(a, r) / area, I) + box_sum(b, r) / area


def tile_halo(he: int, we: int, tile_h: int, tile_w: int) -> tuple[int, int]:
    """(halo_y, halo_x) of an (he, we) tile extended symmetrically around a
    (tile_h, tile_w) interior."""
    if he < tile_h or we < tile_w or (he - tile_h) % 2 or (we - tile_w) % 2:
        raise ValueError(f"a {he}x{we} tile is not a {tile_h}x{tile_w} interior "
                         f"with a halo of equal width on each side")
    return (he - tile_h) // 2, (we - tile_w) // 2


def local_grid(he, we, origin_y, origin_x, tile_h, tile_w, global_h, global_w, device):
    """Global rows and columns of an (he, we) extended tile around the
    (tile_h, tile_w) interior at global (origin_y, origin_x), and the mask
    of its pixels inside the image."""
    hy, hx = tile_halo(he, we, tile_h, tile_w)
    gy = origin_y - hy + torch.arange(he, dtype=torch.int32, device=device)
    gx = origin_x - hx + torch.arange(we, dtype=torch.int32, device=device)
    in_image = (((gy >= 0) & (gy < global_h))[:, None]
                & ((gx >= 0) & (gx < global_w))[None, :])
    return gy, gx, in_image


def guided_wta_fused_local_reference(gray1_ext, gray2_ext, origin_y: int, origin_x: int,
                                     dmin: int, cfg: StereoConfig, global_h: int,
                                     global_w: int, tile_h: int, tile_w: int,
                                     n_slices: int | None = None):
    """Plain PyTorch version of ``guided_wta_fused_local``: the JAX
    sharded path's per-frame path, frame by frame over a leading batch
    axis; the WTA keeps the largest d on ties."""
    args = (origin_y, origin_x, dmin, cfg, global_h, global_w, tile_h, tile_w, n_slices)
    if gray1_ext.ndim == 3:
        return _per_frame(guided_wta_fused_local_reference, gray1_ext, gray2_ext, *args)
    he, we = gray1_ext.shape
    hy, hx = tile_halo(he, we, tile_h, tile_w)
    gy, gx, in_image = local_grid(he, we, origin_y, origin_x, tile_h, tile_w,
                                  global_h, global_w, gray1_ext.device)
    area = global_area(gy, gx, global_h, global_w, cfg.radius)
    der1 = _x_derivative_global(gray1_ext, gx, global_w)
    der2 = _x_derivative_global(gray2_ext, gx, global_w)
    cost = _local_cost_volume(gray1_ext, der1, gray2_ext, der2, gx, dmin,
                              n_slices or cfg.size_d, global_w, cfg, in_image)
    q = _local_guided_q(gray1_ext, cost, area, in_image, cfg)
    best, sidx = streaming_wta(q[:, hy:hy + tile_h, hx:hx + tile_w])
    return best, (dmin + sidx).to(torch.float32)


def guided_wta_fused_local(gray1_ext: torch.Tensor, gray2_ext: torch.Tensor,
                           origin_y: int, origin_x: int, dmin: int, cfg: StereoConfig,
                           global_h: int, global_w: int, tile_h: int, tile_w: int,
                           n_slices: int | None = None):
    """uint8 (H_e, W_e) or (B, H_e, W_e) extended tiles ×2 → (best, dmap)
    float32 of the (tile_h, tile_w) interior, whose (0, 0) is global
    (origin_y, origin_x) in a (global_h, global_w) image.  The halo is
    (H_e - tile_h) / 2 rows and (W_e - tile_w) / 2 columns on each side;
    it must cover the matching's reach (``_kernels.check_tile``: 2R rows,
    2R + 1 + max |d| columns), else ValueError.  Labels are dmin + s for
    s < ``n_slices`` (default ``cfg.size_d``).  A batch is one launch."""
    size_d = n_slices or cfg.size_d
    he, we = gray1_ext.shape[-2:]
    hy, hx = tile_halo(he, we, tile_h, tile_w)
    tile = _kernels.Tile(global_h, global_w, origin_y - hy, origin_x - hx, hy, hx,
                         tile_h, tile_w)
    _kernels.check_tile(tile, he, we, cfg.radius, dmin, size_d)
    if gray1_ext.device.type == "cpu" and gray2_ext.device.type == "cpu":
        return guided_wta_fused_local_reference(gray1_ext, gray2_ext, origin_y, origin_x,
                                                dmin, cfg, global_h, global_w, tile_h,
                                                tile_w, n_slices)
    _check_cuda_pair("guided_wta_fused_local", gray1_ext, gray2_ext, (2, 3))
    return _launch_single(gray1_ext, gray2_ext, dmin, size_d, cfg, tile)
