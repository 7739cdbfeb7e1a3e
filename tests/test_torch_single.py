"""The port's single-view matching (``guided_wta_fused``: kernel K3 tiled,
K1 row walk on CUDA) on the CPU, where it runs its plain version, against
the JAX package's tiled Pallas kernel (_make_kernel, ``stream=False``) and
its strip-carry kernel (_make_stream_kernel) in interpret mode, at the
fused fast-path bound; its (B,H,W) form; and its routing by ``stream``."""

import dataclasses

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matching_cuda_tpu.config import DEFAULT_CONFIG as JCFG
from stereo_matching_cuda_tpu.config import StereoConfig as JStereoConfig
from stereo_matching_cuda_tpu_torch import DEFAULT_CONFIG
from stereo_matching_cuda_tpu_torch import pipeline as P
from stereo_matching_cuda_tpu_torch.config import config_from_jax
from stereo_matching_cuda_tpu_torch.ops import _kernels
from stereo_matching_cuda_tpu_torch.ops.fused_guided import guided_wta_fused

JK3 = dataclasses.replace(JCFG, stream=False)


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    if jax.default_backend() != "tpu":
        orig = pl.pallas_call

        def interp(*a, **k):
            k.setdefault("interpret", True)
            return orig(*a, **k)

        monkeypatch.setattr(pl, "pallas_call", interp)
    yield


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(h, w, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(h, w + 32)).astype(np.float32)
    base = ((base + np.roll(base, 1, 1) + np.roll(base, -1, 1)
             + np.roll(base, 1, 0)) / 4).astype(np.uint8)
    return base[:, 16:16 + w], base[:, 10:10 + w]


def _within_bound(best, dmap, jb, jd):
    """The fused fast-path bound (tests/test_pallas_fused.py:55-57)."""
    n = dmap.numel()
    mism = int((dmap.numpy() != np.asarray(jd)).sum())
    assert mism <= max(4, n * 2e-3), f"{mism}/{n} disparity mismatches"
    np.testing.assert_allclose(best.numpy(), np.asarray(jb), atol=2e-3, rtol=1e-4)


def _jax_fused(g1, g2, dmin, jcfg):
    from stereo_matching_cuda_tpu.ops.pallas_guided import guided_wta_fused as jfused

    return jfused(jnp.asarray(g1), jnp.asarray(g2), dmin, jcfg)


@pytest.mark.parametrize("shape", [(64, 96), (40, 384), (33, 130)])
@pytest.mark.parametrize("view", ["left", "right"])
def test_k3_route_matches_tiled_kernel(shape, view):
    g1, g2 = _pair(*shape, seed=sum(shape))
    dmin = JK3.d_min
    if view == "right":
        g1, g2, dmin = g2, g1, JK3.d_min_right
    jb, jd = _jax_fused(g1, g2, dmin, JK3)
    best, dmap = guided_wta_fused(t(g1), t(g2), dmin, config_from_jax(JK3))
    assert best.dtype == dmap.dtype == torch.float32
    assert best.shape == dmap.shape == shape
    _within_bound(best, dmap, jb, jd)


@pytest.mark.parametrize("d_min,d_max,dmin", [
    (-63, 0, -63),    # 64 slices: the tiled kernel's fori branch
    (-8, 8, -8),      # a range straddling zero
])
def test_k3_route_other_ranges(d_min, d_max, dmin):
    jcfg = JStereoConfig(d_min=d_min, d_max=d_max, stream=False)
    g1, g2 = _pair(48, 160, seed=5)
    jb, jd = _jax_fused(g1, g2, dmin, jcfg)
    best, dmap = guided_wta_fused(t(g1), t(g2), dmin, config_from_jax(jcfg))
    _within_bound(best, dmap, jb, jd)


@pytest.mark.parametrize("stream", [False, True], ids=["K3", "K1"])
def test_batch_equals_per_frame_and_jax_batch(stream):
    """(B,H,W) in: each frame equals the port's lone call exactly, and
    the JAX package's batched grid (K3's ``nxy`` mode, K1's batch) within
    the bound."""
    jcfg = dataclasses.replace(JCFG, stream=stream)
    cfg = config_from_jax(jcfg)
    pairs = [_pair(24, 70, seed=s) for s in (4, 5)]
    g1 = np.stack([p[0] for p in pairs])
    g2 = np.stack([p[1] for p in pairs])
    best, dmap = guided_wta_fused(t(g1), t(g2), cfg.d_min, cfg)
    assert best.shape == dmap.shape == (2, 24, 70)
    jb, jd = _jax_fused(g1, g2, jcfg.d_min, jcfg)
    for i, (a, b) in enumerate(pairs):
        one = guided_wta_fused(t(a), t(b), cfg.d_min, cfg)
        assert torch.equal(best[i], one[0]) and torch.equal(dmap[i], one[1]), i
        _within_bound(best[i], dmap[i], jb[i], jd[i])


SMALL, BIG = (288, 384), (1992, 3008)


@pytest.mark.parametrize("kw,k1", [
    ({"stream": True}, True), ({"stream": False}, False), ({}, False),
    ({"d_min": -63}, False), ({"d_min": -127, "stream": True}, True)])
def test_single_view_route_follows_stream(monkeypatch, kw, k1):
    """True → K1 (row walk), False/None → K3 (tiled), at every frame size,
    decided without the kernel library; the dual rule is unchanged."""
    def no_build():
        raise AssertionError("the single-view route must not build the kernels")

    monkeypatch.setattr(_kernels, "build", no_build)
    cfg = dataclasses.replace(DEFAULT_CONFIG, **kw)
    for hw in (SMALL, BIG):
        assert P.use_stream(cfg, *hw, dual=False) is k1
    if cfg.stream is not None:
        assert P.use_stream(cfg, *BIG) is cfg.stream
