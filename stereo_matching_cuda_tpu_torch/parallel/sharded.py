"""Sharded stereo pipeline over a ('b','d','y','x') device mesh
(counterpart of ``stereo_matching_cuda_tpu/parallel/sharded.py``).

Each rank runs the pipeline on its block of the global batch:

  * 'b'  — frames (data parallel, no communication)
  * 'y','x' — a spatial tile grid with ONE halo exchange of the grayscale
    images per view (halo = disparity shift + derivative + 2 chained
    box-filter radii, ``mesh.pipeline_halo``), after which the whole
    cost + guided filter + WTA chain is tile-local: kernel K3 (or K1 with
    ``stream=True``) through ``ops.fused_guided.guided_wta_fused_local``
    on CUDA, its plain version otherwise
  * 'd'  — ranges of disparities, combined over an all_gather with the
    ascending ``best >= q`` rule
  * LR check — a second, shift-wide halo exchange of the right map; where
    'x' is not split the rows are whole and K2 runs instead
  * occlusion fill — a two-level scan: tile-local scans + an all_gather
    of per-row tile summaries along 'x'

Border math: out-of-mesh halos arrive as ZEROS and every field is masked
to zero outside the global image, so a window sum over the extended tile
equals the reference's border-clamped one; the normalizer is the
global-coordinate clamped area (guidedFilter.cu:305-318).  Tile results
are exact up to the float association of the window sums, which can flip
exact WTA ties: the tests bound the mismatch count against the one-device
result.  Every rank returns the six global maps (all_gather over the mesh).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import StereoConfig, DEFAULT_CONFIG
from ..ops.boxfilter import box_sum
from ..ops.fused_guided import (
    global_area, guided_wta_fused_local, guided_wta_fused_local_reference, local_grid)
from ..ops.fused_post import lr_fill_fused
from ..ops.image import fl_to_ch, rgb_to_grayscale
from ..ops.occlusion import _last_valid_packed
from ..pipeline import use_fused_path, use_fused_post
from .halo import halo_exchange
from .mesh import AXES, axis_sizes, pipeline_halo
from .multihost import HostFrames

OUTPUT_KEYS = ("disparity_left", "disparity_right", "occlusion", "occlusion_filled",
               "best_cost_left", "mean_left")


def combine_d_ranges(bests, dmaps):
    """The per-range winners of ascending disparity ranges merged with the
    reference's streaming ``best >= q`` rule (guidedFilter.cu:403-411):
    a later range wins ties, so the largest d does."""
    best, dmap = bests[0], dmaps[0]
    for b, m in zip(bests[1:], dmaps[1:]):
        upd = best >= b
        best = torch.where(upd, b, best)
        dmap = torch.where(upd, m, dmap)
    return best, dmap


def _combine_d_shards(best, dmap, mesh: DeviceMesh):
    """Cross-rank WTA over the 'd' axis: all_gather every range's
    (best, dmap) and merge them in ascending range order."""
    nd = mesh.size(AXES.index("d"))
    pair = torch.stack([best, dmap])
    gathered = [torch.empty_like(pair) for _ in range(nd)]
    dist.all_gather(gathered, pair, group=mesh.get_group("d"))
    return combine_d_ranges([g[0] for g in gathered], [g[1] for g in gathered])


def _segmented_fill(occ, cfg: StereoConfig, mesh: DeviceMesh):
    """Occlusion fill along rows split over the 'x' axis (occlusion.cu:134-176
    semantics, the race-free scan of ``ops.occlusion.fill_occlusion``).
    Local scans use the packed running max; each tile's last and first
    (label, found) per row are all_gathered along 'x' and carried across
    the tiles."""
    vminf = float(cfg.v_min)
    occl = occ.to(torch.int32) < cfg.v_min
    valid = occ >= vminf
    lv, lf = _last_valid_packed(occ, valid, cfg.d_min, cfg.size_d, reverse=False)
    rv, rf = _last_valid_packed(occ, valid, cfg.d_min, cfg.size_d, reverse=True)
    tx = mesh.size(AXES.index("x"))
    if tx > 1:
        me = mesh.get_local_rank("x")
        ends = torch.stack([lv[..., -1], lf[..., -1].to(lv.dtype),
                            rv[..., 0], rf[..., 0].to(rv.dtype)])
        gathered = [torch.empty_like(ends) for _ in range(tx)]
        dist.all_gather(gathered, ends, group=mesh.get_group("x"))
        # forward carry: the nearest tile to my left with a valid pixel
        cv, cf = torch.zeros_like(lv[..., 0]), torch.zeros_like(lf[..., 0])
        for k in range(me):
            take = gathered[k][1] > 0
            cv = torch.where(take, gathered[k][0], cv)
            cf = cf | take
        lv = torch.where(lf, lv, cv[..., None])
        lf = lf | cf[..., None]
        # backward carry: the nearest tile to my right
        cv, cf = torch.zeros_like(rv[..., 0]), torch.zeros_like(rf[..., 0])
        for k in range(tx - 1, me, -1):
            take = gathered[k][3] > 0
            cv = torch.where(take, gathered[k][2], cv)
            cf = cf | take
        rv = torch.where(rf, rv, cv[..., None])
        rf = rf | cf[..., None]
    dleft = torch.where(lf, lv, vminf)
    dright = torch.where(rf, rv, vminf)
    return torch.where(occl, torch.maximum(dleft, dright), occ)


def _lr_check(dmap_l, dmap_r, x0: int, w: int, cfg: StereoConfig, mesh: DeviceMesh):
    """The LR consistency check of a tile (occlusion.cu:3-15): a
    ``shift``-wide x-halo of the right map covers every label's reach,
    so each label reads a static slice of it (the label-set semantics of
    ``ops.detect_occlusion``)."""
    shift = -min(cfg.d_min, cfg.d_min_right)
    dre = halo_exchange(dmap_r, shift, mesh, "x", dim=2)
    wl = dmap_l.shape[-1]
    gx = x0 + torch.arange(wl, dtype=torch.int32, device=dmap_l.device)
    d = dmap_l.to(torch.int32)
    xs = gx + d
    in_range = (xs >= 0) & (xs < w)
    dprime = torch.zeros_like(dmap_l)
    for lab in cfg.disparities():
        dprime = torch.where(d == lab, dre[..., shift + lab: shift + lab + wl], dprime)
    bad = (d.to(torch.float32) + dprime).abs() > float(cfg.d_lr)
    return torch.where((~in_range) | bad, float(cfg.d_occlusion), dmap_l)


def _rank_frames(rgb, nb: int, b: int):
    """(this rank's frames, global batch size) of a global (B, H, W, C)
    batch, or of ``HostFrames``."""
    if isinstance(rgb, HostFrames):
        if rgb.frames.shape[0] * nb != rgb.batch:
            raise ValueError(f"{rgb.frames.shape[0]} frames a rank, {nb} ranks along b: "
                             f"not a batch of {rgb.batch}")
        return rgb.frames, rgb.batch
    n = rgb.shape[0]
    if n % nb:
        return rgb, n          # the shape check below raises
    per = n // nb
    return rgb[b * per:(b + 1) * per], n


def _to_device(block, device) -> torch.Tensor:
    if not isinstance(block, torch.Tensor):
        block = torch.from_numpy(np.array(block))     # a copy: inputs may be read-only views
    return block.to(device).contiguous()


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def sharded_stereo_pipeline(rgb_left, rgb_right, mesh: DeviceMesh,
                            cfg: StereoConfig = DEFAULT_CONFIG) -> dict:
    """Global uint8 (B, H, W, C) pair (numpy or tensors, as every rank
    sees it; or ``HostFrames``) → dict of the global (B, H, W) maps on
    every rank, on the mesh's device: disparity_left/right, occlusion,
    occlusion_filled, best_cost_left (float32) and mean_left (uint8).
    Every rank of the mesh calls it together."""
    size = axis_sizes(mesh)
    nb, nd, ty, tx = (size[a] for a in AXES)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    left, B = _rank_frames(rgb_left, nb, coord["b"])
    right, _ = _rank_frames(rgb_right, nb, coord["b"])
    H, W = left.shape[1:3]
    if B % nb or H % ty or W % tx:
        raise ValueError(f"shape {(B, H, W)} not divisible by mesh {(nb, ty, tx)}")
    if cfg.exact_integral:
        raise ValueError(
            "exact_integral is the single-device parity mode; sharded tiles "
            "sum their windows from per-tile origins and are tolerance-level "
            "by design (see tests/test_torch_parallel.py)")
    hl, wl = H // ty, W // tx
    halo_y, halo_x = pipeline_halo(cfg)
    if hl < halo_y or wl < halo_x:
        raise ValueError(
            f"tile {hl}x{wl} smaller than pipeline halo {halo_y}x{halo_x}; "
            f"use fewer tiles along that axis (halo exchange is single-hop)")
    if cfg.size_d % nd:
        raise ValueError(f"size_d {cfg.size_d} not divisible by d-axis size {nd}")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh has {mesh.size()} ranks, the world {dist.get_world_size()}")
    d_per = cfg.size_d // nd
    device = _mesh_device(mesh)
    y0, x0 = coord["y"] * hl, coord["x"] * wl

    def block(rgb):
        return rgb_to_grayscale(_to_device(rgb[:, y0:y0 + hl, x0:x0 + wl], device), cfg)

    def extend(g):
        return halo_exchange(halo_exchange(g, halo_y, mesh, "y", dim=1), halo_x, mesh,
                             "x", dim=2)

    gle, gre = extend(block(left)), extend(block(right))
    match = (guided_wta_fused_local if use_fused_path(cfg, device)
             else guided_wta_fused_local_reference)

    def view(g1e, g2e, dmin):
        best, dmap = match(g1e, g2e, y0, x0, dmin + coord["d"] * d_per, cfg, H, W, hl, wl,
                           n_slices=d_per)
        return _combine_d_shards(best, dmap, mesh) if nd > 1 else (best, dmap)

    best_l, dmap_l = view(gle, gre, cfg.d_min)
    _, dmap_r = view(gre, gle, cfg.d_min_right)
    # mean_left for output parity: one box mean of the extended guide
    gy, gx, _ = local_grid(*gle.shape[-2:], y0, x0, hl, wl, H, W, device)
    mean_i = box_sum(gle.to(torch.float32), cfg.radius) / global_area(gy, gx, H, W, cfg.radius)
    mean_l = fl_to_ch(mean_i[..., halo_y:halo_y + hl, halo_x:halo_x + wl])

    bl = dmap_l.shape[0]
    if tx == 1 and use_fused_post(cfg, device):
        # whole rows on every rank, and K2 is row-local: the local batch
        # folds into the row axis (the plain path below computes the same
        # bits)
        occ, filled = (t.reshape(bl, hl, wl) for t in lr_fill_fused(
            dmap_l.reshape(bl * hl, wl), dmap_r.reshape(bl * hl, wl), cfg))
    else:
        occ = _lr_check(dmap_l, dmap_r, x0, W, cfg, mesh)
        filled = _segmented_fill(occ, cfg, mesh)

    maps = torch.stack([dmap_l, dmap_r, occ, filled, best_l, mean_l.to(torch.float32)])
    gathered = [torch.empty_like(maps) for _ in range(mesh.size())]
    dist.all_gather(gathered, maps)
    out = torch.empty((len(OUTPUT_KEYS), B, H, W), dtype=torch.float32, device=device)
    ranks = mesh.mesh          # global rank at each (b, d, y, x)
    for b in range(nb):
        for y in range(ty):
            for x in range(tx):
                out[:, b * bl:(b + 1) * bl, y * hl:(y + 1) * hl, x * wl:(x + 1) * wl] = \
                    gathered[int(ranks[b, 0, y, x])]
    result = dict(zip(OUTPUT_KEYS, out))
    result["mean_left"] = result["mean_left"].to(torch.uint8)
    return result
