"""Kernels K1-K5 on a CUDA GPU against their plain versions on the same
card, their batches against per-frame launches, and the launch counts of
the kernel routes.  Skipped without a GPU; on a machine with one (and no
JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from stereo_matching_cuda_tpu_torch import (
    DEFAULT_CONFIG, BoxStereoMatcher, StereoConfig, bench, compute_disparity,
    stereo_pipeline, stereo_pipeline_batch)
from stereo_matching_cuda_tpu_torch.ops.fused_guided import (
    guided_wta_fused, guided_wta_fused_dual, guided_wta_fused_dual_reference,
    guided_wta_fused_reference)
from stereo_matching_cuda_tpu_torch.ops.fused_post import lr_fill_fused, lr_fill_reference
from stereo_matching_cuda_tpu_torch.timing import steady_ms
from stereo_matching_cuda_tpu_torch.utils.synth import make_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return "cuda"


def _pair(h, w, seed, dev):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(h, w + 32)).astype(np.float32)
    base = ((base + np.roll(base, 1, 1) + np.roll(base, -1, 1)
             + np.roll(base, 1, 0)) / 4).astype(np.uint8)
    return (torch.from_numpy(np.ascontiguousarray(base[:, 16:16 + w])).to(dev),
            torch.from_numpy(np.ascontiguousarray(base[:, 10:10 + w])).to(dev))


@pytest.mark.parametrize("stream", [False, True], ids=["K3", "K1"])
@pytest.mark.parametrize("h,w,d_min,d_max,dmin", [
    (64, 96, -15, 0, -15), (64, 96, -15, 0, 0), (33, 130, -15, 0, -15),
    (8, 40, -15, 0, -15), (48, 160, -63, 0, -63), (40, 70, -8, 8, -8),
    (40, 200, -127, 0, -127)])
def test_k1_matches_plain(dev, stream, h, w, d_min, d_max, dmin):
    """The fused fast-path bound (tests/test_pallas_fused.py:55-57); the
    stream flag picks the kernel."""
    cfg = StereoConfig(d_min=d_min, d_max=d_max, stream=stream)
    g1, g2 = _pair(h, w, h + w, dev)
    guided_wta_fused.k1_launches = guided_wta_fused.k3_launches = 0
    best, dmap = guided_wta_fused(g1, g2, dmin, cfg)
    assert (guided_wta_fused.k1_launches,
            guided_wta_fused.k3_launches) == ((1, 0) if stream else (0, 1))
    best_p, dmap_p = guided_wta_fused_reference(g1, g2, dmin, cfg)
    mism = int((dmap != dmap_p).sum())
    assert mism <= max(4, 2e-3 * h * w), mism
    torch.testing.assert_close(best, best_p, atol=2e-3, rtol=1e-4)


@pytest.mark.parametrize("stream", [False, True], ids=["K3", "K1"])
@pytest.mark.parametrize("radius", [1, 4, 14, 20, 23])
def test_k1_other_radii(dev, stream, radius):
    """Radii 20 and 23 take K3's 16- and 8-row tiles and K1's lower bands
    (shared memory)."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, radius=radius, stream=stream)
    g1, g2 = _pair(70, 100, radius, dev)
    best, dmap = guided_wta_fused(g1, g2, cfg.d_min, cfg)
    best_p, dmap_p = guided_wta_fused_reference(g1, g2, cfg.d_min, cfg)
    assert int((dmap != dmap_p).sum()) <= max(4, 2e-3 * dmap.numel())
    torch.testing.assert_close(best, best_p, atol=2e-3, rtol=1e-4)


@pytest.mark.parametrize("d_min,h,w", [(-15, 288, 384), (-127, 40, 300), (-15, 7, 1000)])
def test_k2_bit_identical(dev, d_min, h, w):
    cfg = StereoConfig(d_min=d_min, d_max=0)
    rng = np.random.default_rng(h)
    dl = torch.from_numpy(rng.integers(cfg.d_min, 1, (h, w)).astype(np.float32)).to(dev)
    dr = torch.from_numpy(rng.integers(0, -cfg.d_min + 1, (h, w)).astype(np.float32)).to(dev)
    dr[1:3] = 500.0
    occ, filled = lr_fill_fused(dl, dr, cfg)
    occ_p, filled_p = lr_fill_reference(dl, dr, cfg)
    assert torch.equal(occ, occ_p) and torch.equal(filled, filled_p)


def _label_maps(cfg, shape, seed, dev):
    """Random left and right label maps of ``cfg``'s range, with a few
    values outside the label set and rows with no LR-consistent pixel."""
    rng = np.random.default_rng(seed)
    dl = rng.integers(cfg.d_min, cfg.d_max + 1, shape).astype(np.float32)
    dr = rng.integers(-cfg.d_max, -cfg.d_min + 1, shape).astype(np.float32)
    dl.reshape(-1)[::7] += 0.5
    dl.reshape(-1)[::11] = -200.0
    if shape[-2] > 3:
        dr[..., 1:3, :] = 500.0
    return torch.from_numpy(dl).to(dev), torch.from_numpy(dr).to(dev)


@pytest.mark.parametrize("d_min,d_max", [(-15, 0), (0, 15)])
@pytest.mark.parametrize("shape", [(5, 1), (5, 3), (5, 5), (6, 33), (4, 257), (7, 383),
                                   (3, 3008), (3, 4, 383), (3, 20000)])
def test_k2_row_widths(dev, d_min, d_max, shape):
    """Widths that stress K2's row staging (16-byte vectors with a scalar
    head and tail; rows of a width not a multiple of 4 start at every
    alignment), a (B, H, W) batch, and rows too wide for two a CTA (one
    row of 256 threads), bit for bit, for labels of either sign."""
    cfg = StereoConfig(d_min=d_min, d_max=d_max)
    dl, dr = _label_maps(cfg, shape, sum(shape), dev)
    occ, filled = lr_fill_fused(dl, dr, cfg)
    occ_p, filled_p = lr_fill_reference(dl, dr, cfg)
    assert torch.equal(occ, occ_p) and torch.equal(filled, filled_p)


@pytest.mark.parametrize("w", [31, 384])
def test_k2_unaligned_maps(dev, w):
    """Maps that start 4 bytes past a 16-byte boundary take K2's
    one-float path, bit for bit."""
    cfg = DEFAULT_CONFIG
    dl, dr = _label_maps(cfg, (9, w), w, dev)
    views = []
    for m in (dl, dr):
        buf = torch.empty(m.numel() + 1, dtype=torch.float32, device=dev)
        view = buf[1:].view(m.shape)
        view.copy_(m)
        views.append(view)
    assert views[0].data_ptr() % 16 == 4 and views[0].is_contiguous()
    occ, filled = lr_fill_fused(*views, cfg)
    occ_p, filled_p = lr_fill_reference(dl, dr, cfg)
    assert torch.equal(occ, occ_p) and torch.equal(filled, filled_p)


@pytest.mark.parametrize("stream", [False, True], ids=["K3", "K1"])
def test_single_view_batch_equals_per_frame(dev, stream):
    cfg = StereoConfig(stream=stream)
    pairs = [_pair(50, 90, s, dev) for s in (1, 2, 3)]
    outs = guided_wta_fused(torch.stack([p[0] for p in pairs]),
                            torch.stack([p[1] for p in pairs]), cfg.d_min, cfg)
    for i, (a, b) in enumerate(pairs):
        for j, t in enumerate(guided_wta_fused(a, b, cfg.d_min, cfg)):
            assert torch.equal(outs[j][i], t), (i, j)


def test_k2_batch_equals_per_frame(dev):
    cfg = DEFAULT_CONFIG
    rng = np.random.default_rng(7)
    dl = torch.from_numpy(rng.integers(-15, 1, (3, 20, 64)).astype(np.float32)).to(dev)
    dr = torch.from_numpy(rng.integers(0, 16, (3, 20, 64)).astype(np.float32)).to(dev)
    occ, filled = lr_fill_fused(dl, dr, cfg)
    for i in range(3):
        o, f = lr_fill_fused(dl[i], dr[i], cfg)
        assert torch.equal(occ[i], o) and torch.equal(filled[i], f), i


@pytest.mark.parametrize("kw", [{}, {"stream": True}, {"d_min": -7}])
def test_pipeline_batch_equals_per_frame(dev, kw):
    """One launch per kernel for the batch (K3 twice, K1 twice, or K4
    once; K2 once), each frame bit-identical to a lone frame."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, **kw)
    scenes = [make_scene(64, 96, ndisp=16, seed=s) for s in (1, 2, 3)]
    left = torch.from_numpy(np.stack([sc["left"] for sc in scenes])).to(dev)
    right = torch.from_numpy(np.stack([sc["right"] for sc in scenes])).to(dev)
    guided_wta_fused.k1_launches = guided_wta_fused.k3_launches = 0
    guided_wta_fused_dual.k4_launches = lr_fill_fused.launches = 0
    out = stereo_pipeline_batch(left, right, cfg)
    assert (guided_wta_fused.k1_launches + guided_wta_fused.k3_launches
            + guided_wta_fused_dual.k4_launches, lr_fill_fused.launches) == (
        (1 if kw.get("d_min") else 2), 1)
    for i in range(3):
        one = stereo_pipeline(left[i], right[i], cfg)
        for k, v in one.items():
            assert torch.equal(out[k][i], v), (i, k)


def test_box_matcher_runs_only_k2(dev):
    guided_wta_fused.k1_launches = guided_wta_fused.k3_launches = 0
    guided_wta_fused_dual.k4_launches = guided_wta_fused_dual.k5_launches = 0
    lr_fill_fused.launches = 0
    sc = make_scene(64, 96, ndisp=16)
    out = BoxStereoMatcher(DEFAULT_CONFIG, device=dev).compute(sc["left"], sc["right"])
    plain = BoxStereoMatcher(dataclasses.replace(DEFAULT_CONFIG, post_fused=False),
                             device=dev).compute(sc["left"], sc["right"])
    assert (guided_wta_fused.k1_launches, guided_wta_fused.k3_launches,
            guided_wta_fused_dual.k4_launches, guided_wta_fused_dual.k5_launches,
            lr_fill_fused.launches) == (0, 0, 0, 0, 1)
    for k, v in plain.items():
        np.testing.assert_array_equal(out[k], v, err_msg=k)


def test_main_path_launches_each_kernel(dev):
    guided_wta_fused.k3_launches = lr_fill_fused.launches = 0
    sc = make_scene(96, 160, ndisp=16)
    out = compute_disparity(sc["left"], sc["right"], DEFAULT_CONFIG, dev)
    assert (guided_wta_fused.k3_launches, lr_fill_fused.launches) == (2, 1)
    assert np.isfinite(out["occlusion_filled"]).all()


@pytest.mark.parametrize("stream", [False, True], ids=["K4", "K5"])
@pytest.mark.parametrize("h,w,d_min,d_max", [
    (64, 96, -15, 0), (33, 130, -7, 0), (40, 70, -8, 8), (48, 160, -63, 0)])
def test_dual_matches_plain(dev, stream, h, w, d_min, d_max):
    """Each view within K1's bound; the stream flag picks the kernel."""
    cfg = StereoConfig(d_min=d_min, d_max=d_max, stream=stream)
    g1, g2 = _pair(h, w, h + w, dev)
    guided_wta_fused_dual.k4_launches = guided_wta_fused_dual.k5_launches = 0
    outs = guided_wta_fused_dual(g1, g2, cfg)
    ref = guided_wta_fused_dual_reference(g1, g2, cfg)
    assert (guided_wta_fused_dual.k4_launches,
            guided_wta_fused_dual.k5_launches) == ((0, 1) if stream else (1, 0))
    for v in (0, 2):
        assert int((outs[v + 1] != ref[v + 1]).sum()) <= max(4, 2e-3 * h * w)
        torch.testing.assert_close(outs[v], ref[v], atol=2e-3, rtol=1e-4)


@pytest.mark.parametrize("stream", [False, True], ids=["K4", "K5"])
def test_dual_batch_equals_per_frame(dev, stream):
    cfg = StereoConfig(stream=stream)
    pairs = [_pair(50, 90, s, dev) for s in (1, 2, 3)]
    outs = guided_wta_fused_dual(torch.stack([p[0] for p in pairs]),
                                 torch.stack([p[1] for p in pairs]), cfg)
    for i, (a, b) in enumerate(pairs):
        for j, t in enumerate(guided_wta_fused_dual(a, b, cfg)):
            assert torch.equal(outs[j][i], t), (i, j)


@pytest.mark.parametrize("kw,counts", [
    ({"dual_view": True}, (0, 1, 0, 1)),
    ({"d_min": -7}, (0, 1, 0, 1)),
    ({"dual_view": True, "stream": True}, (0, 0, 1, 1)),
    ({"d_min": -7, "dual_view": False}, (2, 0, 0, 1))])
def test_dual_route_launch_counts(dev, kw, counts):
    """(K3, K4, K5, K2) launches of one 96x160 frame."""
    guided_wta_fused.k3_launches = lr_fill_fused.launches = 0
    guided_wta_fused_dual.k4_launches = guided_wta_fused_dual.k5_launches = 0
    sc = make_scene(96, 160, ndisp=16)
    out = compute_disparity(sc["left"], sc["right"],
                            dataclasses.replace(DEFAULT_CONFIG, **kw), dev)
    assert (guided_wta_fused.k3_launches, guided_wta_fused_dual.k4_launches,
            guided_wta_fused_dual.k5_launches, lr_fill_fused.launches) == counts
    assert np.isfinite(out["occlusion_filled"]).all()


def _k3_at(g1, g2, dmin, cfg, th):
    """K3 at tile height ``th`` (block height 16 for 16 and 32 rows, 8 for
    8): uint8 (H, W) x2 -> (best, dmap)."""
    from stereo_matching_cuda_tpu_torch.ops import _kernels
    from stereo_matching_cuda_tpu_torch.ops.cost import cost_constants

    best = torch.empty((1, *g1.shape), dtype=torch.float32, device=g1.device)
    dmap = torch.empty_like(best)
    _kernels.guided_wta(g1[None], g2[None], best, dmap, dmin, cfg.size_d, cfg.radius,
                        cost_constants(cfg), cfg.eps, tile_rows=th)
    return best[0], dmap[0]


def _k3_tiles(cfg):
    """The tile heights whose shared memory fits one block."""
    from stereo_matching_cuda_tpu_torch.ops import _kernels

    lib = _kernels.build()["lib"]
    return [th for th in (32, 16, 8)
            if lib.guided_wta_smem_bytes(cfg.radius, th, cfg.size_d) <= _kernels._SMEM_LIMIT]


def _assert_k3_bound(g1, g2, dmin, cfg, tiles):
    best_p, dmap_p = guided_wta_fused_reference(g1, g2, dmin, cfg)
    for th in tiles:
        best, dmap = _k3_at(g1, g2, dmin, cfg, th)
        mism = int((dmap != dmap_p).sum())
        assert mism <= max(4, 2e-3 * dmap.numel()), (th, mism)
        torch.testing.assert_close(best, best_p, atol=2e-3, rtol=1e-4, msg=f"tile {th}")


@pytest.mark.parametrize("h,w", [(1, 40), (17, 31), (33, 33), (64, 65), (40, 97)])
def test_k3_tile_edges(dev, h, w):
    """Frames that straddle the tile (32 columns; 32, 16, 8 rows) and the
    window runs, at every tile height; the wrapper takes 32 rows at R=9."""
    from stereo_matching_cuda_tpu_torch.ops import _kernels

    assert _kernels.guided_wta_tile_rows(DEFAULT_CONFIG.radius, DEFAULT_CONFIG.size_d) == 32
    g1, g2 = _pair(h, w, h * w, dev)
    _assert_k3_bound(g1, g2, DEFAULT_CONFIG.d_min, DEFAULT_CONFIG, (32, 16, 8))


@pytest.mark.parametrize("dmin", [0, -5])
def test_k3_one_disparity(dev, dmin):
    cfg = StereoConfig(d_min=dmin, d_max=dmin)
    g1, g2 = _pair(40, 97, 11, dev)
    _assert_k3_bound(g1, g2, dmin, cfg, (32, 16, 8))
    best, dmap = guided_wta_fused(g1, g2, dmin, cfg)
    assert bool((dmap == dmin).all())


@pytest.mark.parametrize("radius", [1, 23])
def test_k3_radius_extremes(dev, radius):
    """R=1 at every tile height, the wrapper taking 32 rows; R=23 fits
    only the 8-row tile (256 threads), which the wrapper then picks."""
    from stereo_matching_cuda_tpu_torch.ops import _kernels

    cfg = dataclasses.replace(DEFAULT_CONFIG, radius=radius)
    tiles = _k3_tiles(cfg)
    assert tiles == ([32, 16, 8] if radius == 1 else [8]), tiles
    g1, g2 = _pair(70, 100, radius, dev)
    _assert_k3_bound(g1, g2, cfg.d_min, cfg, tiles)
    assert _kernels.guided_wta_tile_rows(radius, cfg.size_d) == tiles[0]


def test_k3_batch_equals_per_frame_on_16_row_tiles(dev):
    """At R=20 only 16 and 8 rows fit, one CTA per SM each: the wrapper
    takes 16 (512-thread blocks), and a B=3 batch equals per-frame
    launches bit for bit."""
    from stereo_matching_cuda_tpu_torch.ops import _kernels

    cfg = dataclasses.replace(DEFAULT_CONFIG, radius=20)
    assert _kernels.guided_wta_tile_rows(cfg.radius, cfg.size_d) == 16
    pairs = [_pair(70, 100, s, dev) for s in (4, 5, 6)]
    outs = guided_wta_fused(torch.stack([p[0] for p in pairs]),
                            torch.stack([p[1] for p in pairs]), cfg.d_min, cfg)
    for i, (a, b) in enumerate(pairs):
        for j, t in enumerate(guided_wta_fused(a, b, cfg.d_min, cfg)):
            assert torch.equal(outs[j][i], t), (i, j)


def _dual_at(g1, g2, cfg, **shape):
    """K4 (``tile_rows``) or K5 (``band``, ``step``) at one
    launch shape: uint8 (H, W) or (B, H, W) x2 -> (best_l, dmap_l, best_r,
    dmap_r)."""
    from stereo_matching_cuda_tpu_torch.ops import _kernels
    from stereo_matching_cuda_tpu_torch.ops.cost import cost_constants

    a, b = (g.reshape(-1, *g.shape[-2:]) for g in (g1, g2))
    outs = [torch.empty(a.shape, dtype=torch.float32, device=a.device) for _ in range(4)]
    launch = _kernels.guided_wta_dual if "tile_rows" in shape else _kernels.guided_wta_dual_stream
    launch(a, b, outs, cfg.d_min, cfg.size_d, cfg.radius, cost_constants(cfg), cfg.eps,
           **shape)
    return tuple(o.reshape(g1.shape) for o in outs)


def _assert_dual_bound(g1, g2, cfg, shapes):
    ref = guided_wta_fused_dual_reference(g1, g2, cfg)
    for shape in shapes:
        outs = _dual_at(g1, g2, cfg, **shape)
        for v in (0, 2):
            mism = int((outs[v + 1] != ref[v + 1]).sum())
            assert mism <= max(4, 2e-3 * g1.numel()), (shape, v, mism)
            torch.testing.assert_close(outs[v], ref[v], atol=2e-3, rtol=1e-4,
                                       msg=f"{shape} view {v}")


def _k4_tiles(cfg):
    """K4's tile heights whose shared memory fits one block."""
    from stereo_matching_cuda_tpu_torch.ops import _kernels

    lib = _kernels.build()["lib"]
    reach = _kernels.dual_reach(cfg.d_min, cfg.size_d)
    return [th for th in (32, 16, 8)
            if lib.guided_wta_dual_smem_bytes(cfg.radius, th, reach) <= _kernels._SMEM_LIMIT]


K5_STEPS = (16, 8)


@pytest.mark.parametrize("h,w", [(1, 40), (17, 31), (33, 33), (64, 65), (40, 97)])
def test_k4_tile_edges(dev, h, w):
    """Frames that straddle the tile (32 columns; 32, 16, 8 rows) and the
    window runs, at every tile height (512-thread blocks for 32 and 16)."""
    g1, g2 = _pair(h, w, h * w + 1, dev)
    _assert_dual_bound(g1, g2, DEFAULT_CONFIG, [{"tile_rows": th} for th in (32, 16, 8)])


@pytest.mark.parametrize("h,band", [(37, 8), (53, 24), (61, 16), (101, 40), (29, 112)])
def test_k5_band_edges(dev, h, band):
    """Heights that are a multiple of neither the step nor the band, at
    every step."""
    g1, g2 = _pair(h, 70, h + band, dev)
    _assert_dual_bound(g1, g2, DEFAULT_CONFIG,
                       [{"band": band, "step": step} for step in K5_STEPS])


@pytest.mark.parametrize("radius", [1, "largest"])
def test_dual_radius_extremes(dev, radius):
    """R=1, and the largest radius whose smallest tile (K4) or band (K5)
    fits one block, at every tile height and K5 step that fits."""
    from stereo_matching_cuda_tpu_torch.ops import _kernels

    lib = _kernels.build()["lib"]
    reach = _kernels.dual_reach(DEFAULT_CONFIG.d_min, DEFAULT_CONFIG.size_d)
    k4_max = max(r for r in range(1, 40)
                 if lib.guided_wta_dual_smem_bytes(r, 8, reach) <= _kernels._SMEM_LIMIT)
    for step in K5_STEPS:
        r5 = radius if radius == 1 else max(
            r for r in range(1, 40)
            if lib.guided_wta_dual_stream_smem_bytes(r, 8, reach, step) <= _kernels._SMEM_LIMIT)
        cfg = dataclasses.replace(DEFAULT_CONFIG, radius=r5)
        g1, g2 = _pair(50, 90, r5 + 16 + step, dev)
        _assert_dual_bound(g1, g2, cfg, [{"band": 8, "step": step}])
    cfg = dataclasses.replace(DEFAULT_CONFIG, radius=1 if radius == 1 else k4_max)
    tiles = _k4_tiles(cfg)
    assert tiles == ([32, 16, 8] if radius == 1 else [8]), tiles
    g1, g2 = _pair(50, 90, cfg.radius, dev)
    _assert_dual_bound(g1, g2, cfg, [{"tile_rows": th} for th in tiles])


@pytest.mark.parametrize("shape", [{"tile_rows": 32}, {"tile_rows": 16},
                                   {"band": 24, "step": 16}, {"band": 24, "step": 8}],
                         ids=["K4-32", "K4-16", "K5-step16", "K5-step8"])
def test_dual_batch_equals_per_frame_at_each_block(dev, shape):
    """A B=3 batch at 512-thread blocks (K4's 16- and 32-row tiles, K5 at
    each step) equals per-frame launches bit for bit."""
    pairs = [_pair(70, 100, s, dev) for s in (7, 8, 9)]
    batch = _dual_at(torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs]),
                     DEFAULT_CONFIG, **shape)
    for i, (a, b) in enumerate(pairs):
        for j, t in enumerate(_dual_at(a, b, DEFAULT_CONFIG, **shape)):
            assert torch.equal(batch[j][i], t), (shape, i, j)


def _k1_at(g1, g2, dmin, cfg, **shape):
    """K1 at one launch shape (``band``, ``step``): uint8 (H, W) or
    (B, H, W) x2 -> (best, dmap)."""
    from stereo_matching_cuda_tpu_torch.ops import _kernels
    from stereo_matching_cuda_tpu_torch.ops.cost import cost_constants

    a, b = (g.reshape(-1, *g.shape[-2:]) for g in (g1, g2))
    best = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    dmap = torch.empty_like(best)
    _kernels.guided_wta_stream(a, b, best, dmap, dmin, cfg.size_d, cfg.radius,
                               cost_constants(cfg), cfg.eps, **shape)
    return best.reshape(g1.shape), dmap.reshape(g1.shape)


def _assert_k1_bound(g1, g2, dmin, cfg, shapes):
    best_p, dmap_p = guided_wta_fused_reference(g1, g2, dmin, cfg)
    for shape in shapes:
        best, dmap = _k1_at(g1, g2, dmin, cfg, **shape)
        mism = int((dmap != dmap_p).sum())
        assert mism <= max(4, 2e-3 * dmap.numel()), (shape, mism)
        torch.testing.assert_close(best, best_p, atol=2e-3, rtol=1e-4, msg=f"{shape}")


@pytest.mark.parametrize("h,band", [(37, 8), (53, 24), (61, 16), (101, 40), (29, 96),
                                    (1, 8)])
def test_k1_band_edges(dev, h, band):
    """Heights that are a multiple of neither the step nor the band, at
    every step."""
    g1, g2 = _pair(h, 70, h + band + 1, dev)
    _assert_k1_bound(g1, g2, DEFAULT_CONFIG.d_min, DEFAULT_CONFIG,
                     [{"band": band, "step": step} for step in K5_STEPS])


def test_k1_step_fallback_at_the_largest_radius(dev):
    """16-row steps up to the largest radius whose lowest band fits one
    block with them; above it 8-row steps, up to the largest radius that
    fits at all; both within the bound there."""
    from stereo_matching_cuda_tpu_torch.ops import _kernels

    d = DEFAULT_CONFIG.size_d
    r16 = max(r for r in range(1, 60) if _kernels.guided_wta_stream_step(r, d) == 16)
    r8 = max(r for r in range(1, 60) if _kernels.guided_wta_stream_step(r, d) is not None)
    print(f"K1: 16-row steps up to R={r16}, 8-row steps up to R={r8}")
    assert r16 >= 23 and r8 > r16
    assert _kernels.guided_wta_stream_step(r16 + 1, d) == 8
    assert _kernels.guided_wta_stream_step(r8 + 1, d) is None
    for radius, step in ((r16, 16), (r8, 8)):
        cfg = dataclasses.replace(DEFAULT_CONFIG, radius=radius, stream=True)
        g1, g2 = _pair(50, 90, radius, dev)
        _assert_k1_bound(g1, g2, cfg.d_min, cfg, [{}])
        assert _kernels.guided_wta_stream_step(radius, d) == step


@pytest.mark.parametrize("dmin", [0, -5])
def test_k1_one_disparity(dev, dmin):
    cfg = StereoConfig(d_min=dmin, d_max=dmin, stream=True)
    g1, g2 = _pair(40, 97, 12, dev)
    _assert_k1_bound(g1, g2, dmin, cfg, [{"step": step} for step in K5_STEPS])
    best, dmap = guided_wta_fused(g1, g2, dmin, cfg)
    assert bool((dmap == dmin).all())


@pytest.mark.parametrize("step", K5_STEPS)
def test_k1_batch_equals_per_frame_at_each_step(dev, step):
    """A B=3 batch equals per-frame launches bit for bit at each step."""
    pairs = [_pair(70, 100, s, dev) for s in (10, 11, 12)]
    shape = {"band": 24, "step": step}
    batch = _k1_at(torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs]),
                   DEFAULT_CONFIG.d_min, DEFAULT_CONFIG, **shape)
    for i, (a, b) in enumerate(pairs):
        for j, t in enumerate(_k1_at(a, b, DEFAULT_CONFIG.d_min, DEFAULT_CONFIG, **shape)):
            assert torch.equal(batch[j][i], t), (step, i, j)


# ---------------------------------------------------------------- entries

def _scene_pngs(tmp_path, h, w, seed):
    from stereo_matching_cuda_tpu_torch.utils.io import write_png

    sc = make_scene(h, w, ndisp=16, seed=seed)
    paths = [str(tmp_path / f) for f in ("l.png", "r.png")]
    write_png(paths[0], sc["left"])
    write_png(paths[1], sc["right"])
    return sc, paths


@pytest.mark.parametrize("flags,cfg,expect", [
    ([], DEFAULT_CONFIG, (0, 1, 2, 0, 0)),
    (["--stream", "on"], dataclasses.replace(DEFAULT_CONFIG, stream=True), (2, 1, 0, 0, 0)),
    (["--dual-view", "on"], dataclasses.replace(DEFAULT_CONFIG, dual_view=True),
     (0, 1, 0, 1, 0)),
], ids=["K3", "K1", "K4"])
def test_cli_on_the_card_equals_compute_disparity(dev, tmp_path, flags, cfg, expect):
    """The CLI's PNGs on the card (the default device) equal
    write_mat_normalize of compute_disparity on the card, bit for bit,
    and the run launches the route's kernels."""
    from stereo_matching_cuda_tpu_torch import cli
    from stereo_matching_cuda_tpu_torch.utils.io import read_png, write_mat_normalize

    sc, paths = _scene_pngs(tmp_path, 72, 120, 3)
    guided_wta_fused.k1_launches = guided_wta_fused.k3_launches = 0
    guided_wta_fused_dual.k4_launches = guided_wta_fused_dual.k5_launches = 0
    lr_fill_fused.launches = 0
    assert cli.main([*paths, "-o", str(tmp_path / "out"), "--json", *flags]) == 0
    assert (guided_wta_fused.k1_launches, lr_fill_fused.launches,
            guided_wta_fused.k3_launches, guided_wta_fused_dual.k4_launches,
            guided_wta_fused_dual.k5_launches) == expect
    want = compute_disparity(sc["left"], sc["right"], cfg, dev)
    for png, key in (("disparity_mapl.png", "disparity_left"),
                     ("disparity_mapr.png", "disparity_right"),
                     ("occlu_mapl.png", "occlusion"),
                     ("occlu_mapl_filled.png", "occlusion_filled")):
        np.testing.assert_array_equal(read_png(str(tmp_path / "out" / png)),
                                      write_mat_normalize(want[key]), err_msg=png)


def test_serve_burst_of_4_equals_lone_frames(dev):
    """Four concurrent requests to a server on the card (a coalesce window
    so they meet in one group) each get the lone frame's map."""
    import base64
    import json
    import os
    import tempfile
    import threading
    import urllib.request

    from stereo_matching_cuda_tpu_torch.serve import make_server
    from stereo_matching_cuda_tpu_torch.utils.io import write_png
    from stereo_matching_cuda_tpu_torch.utils.pnm import read_pfm

    def b64(img, tmp):
        path = os.path.join(tmp, "x.png")
        write_png(path, img)
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode()

    scenes = [make_scene(64, 96, ndisp=16, seed=s) for s in range(4)]
    srv = make_server("127.0.0.1", 0, DEFAULT_CONFIG, batch_window_s=0.2, device=dev)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    results = [None] * len(scenes)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            bodies = [json.dumps({"left": b64(sc["left"], tmp),
                                  "right": b64(sc["right"], tmp)}).encode()
                      for sc in scenes]

            def client(i):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.server_address[1]}/disparity", data=bodies[i],
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    results[i] = json.loads(r.read())

            clients = [threading.Thread(target=client, args=(i,)) for i in range(len(scenes))]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=120)
            assert not any(c.is_alive() for c in clients)
            assert max(rep["batched_n"] for rep in results) > 1
            for sc, rep in zip(scenes, results):
                path = os.path.join(tmp, "x.pfm")
                with open(path, "wb") as f:
                    f.write(base64.b64decode(rep["disparity_pfm"]))
                want = compute_disparity(sc["left"], sc["right"], DEFAULT_CONFIG, dev)
                np.testing.assert_array_equal(read_pfm(path), want["occlusion_filled"])
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)


@pytest.mark.parametrize("kw", [{}, {"stream": True}, {"dual_view": True},
                                {"fused": False, "post_fused": True}],
                         ids=["K3", "K1", "K4", "plain+K2"])
def test_stage_table_on_the_card_has_the_route_rows(dev, kw):
    from stereo_matching_cuda_tpu_torch import profiling

    cfg = dataclasses.replace(DEFAULT_CONFIG, **kw)
    sc = make_scene(64, 96, ndisp=16)
    rows = profiling.stage_table(sc["left"], sc["right"], cfg, dev, n=3)
    assert [r["stage"] for r in rows] == profiling.stage_names(cfg, dev) + ["TOTAL"]
    assert all(r["ms"] > 0 for r in rows)
    assert rows[-1]["ms"] == sum(r["ms"] for r in rows[:-1])


def _extend(g, oy, ox, th, tw, hy, hx):
    """The (th + 2hy, tw + 2hx) tile of a (..., H, W) image around the
    interior at (oy, ox), zeros beyond the image."""
    padded = torch.nn.functional.pad(g, (hx, hx, hy, hy))
    return padded[..., oy:oy + th + 2 * hy, ox:ox + tw + 2 * hx].contiguous()


@pytest.mark.parametrize("stream", [False, True], ids=["K3", "K1"])
@pytest.mark.parametrize("oy,ox,th,tw,view,n_slices", [
    (0, 0, 48, 128, "left", None), (48, 128, 48, 128, "left", None),
    (0, 128, 48, 128, "right", None), (24, 64, 40, 96, "left", None),
    (48, 0, 48, 256, "right", 8), (0, 96, 96, 160, "left", 8)],
    ids=["corner", "corner-far", "top-right", "inside", "bottom-d8", "cols-d8"])
def test_shard_entry_matches_plain(dev, stream, oy, ox, th, tw, view, n_slices):
    """K3 and K1 through guided_wta_fused_local at origins inside, at the
    edges and in the corners of a 96x256 frame, against its plain version
    on the card (the fused bound), one launch each."""
    from stereo_matching_cuda_tpu_torch.ops.fused_guided import (
        guided_wta_fused_local, guided_wta_fused_local_reference)
    from stereo_matching_cuda_tpu_torch.parallel import pipeline_halo

    cfg = dataclasses.replace(DEFAULT_CONFIG, stream=stream)
    g1, g2 = _pair(96, 256, 7, dev)
    dmin = cfg.d_min
    if view == "right":
        g1, g2, dmin = g2, g1, cfg.d_min_right
    if n_slices:
        dmin += n_slices
    hy, hx = pipeline_halo(cfg)
    e1, e2 = (_extend(g, oy, ox, th, tw, hy, hx) for g in (g1, g2))
    guided_wta_fused.k1_launches = guided_wta_fused.k3_launches = 0
    best, dmap = guided_wta_fused_local(e1, e2, oy, ox, dmin, cfg, 96, 256, th, tw, n_slices)
    assert (guided_wta_fused.k1_launches,
            guided_wta_fused.k3_launches) == ((1, 0) if stream else (0, 1))
    best_p, dmap_p = guided_wta_fused_local_reference(e1, e2, oy, ox, dmin, cfg, 96, 256,
                                                      th, tw, n_slices)
    assert best.shape == (th, tw)
    assert int((dmap != dmap_p).sum()) <= max(4, 2e-3 * th * tw)
    torch.testing.assert_close(best, best_p, atol=2e-3, rtol=1e-4)


@pytest.mark.parametrize("stream", [False, True], ids=["K3", "K1"])
def test_shard_entry_whole_frame_is_the_frame_launch(dev, stream):
    """Origin 0 with a zero halo around the whole frame: the same CTAs and
    band as guided_wta_fused, so the same bits; a batch is one launch."""
    from stereo_matching_cuda_tpu_torch.ops.fused_guided import guided_wta_fused_local
    from stereo_matching_cuda_tpu_torch.parallel import pipeline_halo

    cfg = dataclasses.replace(DEFAULT_CONFIG, stream=stream)
    pairs = [_pair(70, 200, s, dev) for s in (1, 2)]
    hy, hx = pipeline_halo(cfg)
    e1, e2 = (torch.nn.functional.pad(torch.stack([p[i] for p in pairs]), (hx, hx, hy, hy))
              for i in (0, 1))
    best, dmap = guided_wta_fused_local(e1, e2, 0, 0, cfg.d_min, cfg, 70, 200, 70, 200)
    for i, (g1, g2) in enumerate(pairs):
        b, d = guided_wta_fused(g1, g2, cfg.d_min, cfg)
        assert torch.equal(best[i], b) and torch.equal(dmap[i], d), i


def test_shard_entry_k3_x_split_and_d_split_are_the_frame(dev):
    """An x split at a multiple of K3's 32-column CTA tile covers the same
    global pixels CTA by CTA, and a d split combined with the ascending
    rule is the 16-slice WTA: both stitch to the frame's maps bit for
    bit."""
    from stereo_matching_cuda_tpu_torch.ops.fused_guided import guided_wta_fused_local
    from stereo_matching_cuda_tpu_torch.parallel import pipeline_halo
    from stereo_matching_cuda_tpu_torch.parallel.sharded import combine_d_ranges

    cfg = DEFAULT_CONFIG
    g1, g2 = _pair(80, 256, 9, dev)
    hy, hx = pipeline_halo(cfg)
    best, dmap = guided_wta_fused(g1, g2, cfg.d_min, cfg)
    parts = [guided_wta_fused_local(_extend(g1, 0, x, 80, 128, hy, hx),
                                    _extend(g2, 0, x, 80, 128, hy, hx), 0, x, cfg.d_min,
                                    cfg, 80, 256, 80, 128) for x in (0, 128)]
    assert torch.equal(torch.cat([p[0] for p in parts], 1), best)
    assert torch.equal(torch.cat([p[1] for p in parts], 1), dmap)
    e1, e2 = (_extend(g, 0, 0, 80, 256, hy, hx) for g in (g1, g2))
    ranges = [guided_wta_fused_local(e1, e2, 0, 0, cfg.d_min + k * 8, cfg, 80, 256, 80, 256,
                                     n_slices=8) for k in (0, 1)]
    b, d = combine_d_ranges([r[0] for r in ranges], [r[1] for r in ranges])
    assert torch.equal(b, best) and torch.equal(d, dmap)


@pytest.mark.parametrize("stream", [False, True], ids=["K3", "K1"])
def test_shard_entry_refuses_a_short_halo(dev, stream):
    from stereo_matching_cuda_tpu_torch.ops.fused_guided import guided_wta_fused_local

    cfg = dataclasses.replace(DEFAULT_CONFIG, stream=stream)
    g = torch.zeros((64 + 2 * 18, 64 + 2 * 30), dtype=torch.uint8, device=dev)
    guided_wta_fused.k1_launches = guided_wta_fused.k3_launches = 0
    with pytest.raises(ValueError, match="short"):    # 30 < 2R + 1 + 15 columns
        guided_wta_fused_local(g, g, 64, 64, cfg.d_min, cfg, 192, 192, 64, 64)
    assert guided_wta_fused.k1_launches == guided_wta_fused.k3_launches == 0


def test_bench_run_on_the_card(dev):
    """Every row of the port's bench at 288x384 with short chains: every
    key, no error; each row's first output is its pipeline on the same
    frame, bit for bit; the row's launches are counted; the warm-up took
    at least two windows."""
    res = bench.run(dev, n_small=1, n_big=4, repeats=2, size=(288, 384))
    extra = res.summary["extra"]
    assert not [k for k in extra if k.endswith("_error")], extra
    for row in (bench.HEADLINE, *bench.EXTRA_ROWS):
        assert extra[f"{row.key}_ms_per_frame"] > 0, row.key
        r = res.rows[row.key]
        left, right = (torch.from_numpy(r.inputs[k]).to(dev) for k in ("left", "right"))
        frame = stereo_pipeline if row.batch == 1 else stereo_pipeline_batch
        for k, v in frame(left, right, row.cfg).items():
            assert np.array_equal(r.first[k], v.cpu().numpy()), (row.key, k)
        assert r.warm_windows >= 2 and r.peak_bytes > 0 and sum(r.launches.values()) > 0
    for key in ("sequence_batch8_fps", "six_mp_fps", "six_mp_vs_baseline", "wide_d_config"):
        assert key in extra
    left, right = (torch.from_numpy(make_scene(288, 384)[k]).to(dev) for k in ("left", "right"))
    s = steady_ms(lambda: stereo_pipeline(left, right), 5)
    assert s.windows >= 2 and s.ms > 0
