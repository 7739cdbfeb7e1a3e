"""The port's plain ops against the JAX package's ops and the NumPy
oracle, on the same seeded inputs.

Parity mode (``exact_integral``) must be BIT-IDENTICAL to both.  Fast
mode differs from the JAX op only by the JAX op's float32 integral
(ulp-scale box sums) and hence by WTA near-ties."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matching_cuda_tpu import ops as J
from stereo_matching_cuda_tpu import reference as R
from stereo_matching_cuda_tpu.config import DEFAULT_CONFIG as JCFG
from stereo_matching_cuda_tpu_torch import ops as T
from stereo_matching_cuda_tpu_torch.config import config_from_jax
from stereo_matching_cuda_tpu_torch.ops.boxfilter import strict_mul
from stereo_matching_cuda_tpu_torch.ops.shifts import shift_cols

JEXACT = dataclasses.replace(JCFG, exact_integral=True)
EXACT = config_from_jax(JEXACT)
FAST = config_from_jax(JCFG)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair(h, w, seed):
    """Smoothed random gray pair, the second a 6-column shift."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(h, w + 32)).astype(np.float32)
    base = ((base + np.roll(base, 1, 1) + np.roll(base, -1, 1)
             + np.roll(base, 1, 0)) / 4).astype(np.uint8)
    return base[:, 16:16 + w], base[:, 10:10 + w]


def _eq(port, *wants):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    for want in wants:
        want = np.asarray(want)
        assert port.dtype == want.dtype and port.shape == want.shape
        np.testing.assert_array_equal(port, want)


@pytest.mark.parametrize("d", [-40, -15, -1, 0, 3, 39, 40])
def test_shift_cols(d):
    x = np.random.default_rng(d + 50).random((3, 40)).astype(np.float32)
    _eq(shift_cols(t(x), d), J.shifts.shift_cols(jnp.asarray(x), d))


@pytest.mark.parametrize("seed", [0, 1])
def test_grayscale_random(seed):
    rgb = np.random.default_rng(seed).integers(0, 256, (37, 53, 4), dtype=np.uint8)
    _eq(T.rgb_to_grayscale(t(rgb), FAST), R.rgb_to_grayscale(rgb, JCFG),
        J.rgb_to_grayscale(jnp.asarray(rgb), JEXACT))


def test_grayscale_exact_integer_triples():
    """Every (r,g,b) whose rational value is an exact integer — where
    float64 rounding decides the truncation — matches the oracle in the
    port's only (fast) mode."""
    r, g, b = np.meshgrid(np.arange(256), np.arange(256), np.arange(256),
                          indexing="ij")
    hit = (2990 * r + 5870 * g + 721 * b) % 10000 == 0
    rgb = np.stack([r[hit], g[hit], b[hit]], -1).astype(np.uint8)[None]
    assert rgb.shape[1] > 1000
    _eq(T.rgb_to_grayscale(t(rgb), FAST), R.rgb_to_grayscale(rgb, JCFG),
        J.rgb_to_grayscale(jnp.asarray(rgb), JEXACT))


def test_fl_to_ch():
    x = np.random.default_rng(2).uniform(-600, 600, (20, 30)).astype(np.float32)
    x[0, :4] = [255.9, 256.0, -0.5, -1.0]
    _eq(T.fl_to_ch(t(x)), J.fl_to_ch(jnp.asarray(x)), R._fl_to_ch(x))


def test_x_derivative():
    g, _ = _pair(20, 33, 3)
    _eq(T.x_derivative(t(g)), J.x_derivative(jnp.asarray(g)), R.x_derivative(g))


@pytest.mark.parametrize("dmin", [JCFG.d_min, JCFG.d_min_right, -8])
def test_cost_volume(dmin):
    g1, g2 = _pair(24, 40, 4)
    _eq(T.cost_volume(t(g1), t(g2), dmin, FAST),
        jax.jit(J.cost_volume, static_argnums=(2, 3))(
            jnp.asarray(g1), jnp.asarray(g2), dmin, JCFG),
        R.cost_volume(g1, g2, dmin, JCFG))


@pytest.mark.parametrize("scale", [2.5, 255.0, 65025.0])
def test_box_mean_exact(scale):
    x = (np.random.default_rng(5).random((24, 40)) * scale).astype(np.float32)
    _eq(T.box_mean(t(x), 9, exact=True),
        J.box_mean(jnp.asarray(x), 9, exact=True), R.box_mean(x, 9))


@pytest.mark.parametrize("scale", [2.5, 255.0, 65025.0])
def test_box_mean_fast(scale):
    """Fast mode: the port sums windows in float64 and rounds once, so it
    is within 2 ulp of the float64 box mean; the JAX op's float32
    integral puts it within 4·eps·max|S|/area of the port (four integral
    taps, each off by about one ulp of the largest prefix sum S)."""
    h, w = 48, 64
    x = (np.random.default_rng(6).random((3, h, w)) * scale).astype(np.float32)
    port = T.box_mean(t(x), 9).numpy()
    exact64 = T.box_mean(t(x).double(), 9).numpy()
    assert (np.abs(port - exact64) <= 2 * np.spacing(np.abs(port))).all()
    s_max = np.cumsum(np.cumsum(x.astype(np.float64), -1), -2).max()
    area = T.window_area(h, w, 9).numpy()
    tol = 4 * np.finfo(np.float32).eps * s_max / area
    jax_fast = np.asarray(J.box_mean(jnp.asarray(x), 9))
    assert (np.abs(port - jax_fast) <= tol).all()


def test_window_area():
    _eq(T.window_area(17, 23, 5), J.window_area(17, 23, 5))


@pytest.mark.parametrize("dmin", [JCFG.d_min, JCFG.d_min_right])
def test_guided_filter_wta_exact(dmin):
    g1, g2 = _pair(24, 40, 7)
    cost = R.cost_volume(g1, g2, dmin, JCFG)
    port = T.guided_filter_wta(t(g1), t(cost), dmin, EXACT)
    jx = J.guided_filter_wta(jnp.asarray(g1), jnp.asarray(cost), dmin, JEXACT)
    orc = R.guided_filter_wta(g1, cost, dmin, JCFG)
    for p, j, o in zip(port, jx, orc):
        _eq(p, j, o)


def test_guided_filter_wta_exact_d_chunk():
    """The chunked ascending scan keeps the streaming tie rule."""
    g1, g2 = _pair(24, 40, 8)
    cost = R.cost_volume(g1, g2, JCFG.d_min, JCFG)
    jcfg = dataclasses.replace(JEXACT, d_chunk=4)
    port = T.guided_filter_wta(t(g1), t(cost), JCFG.d_min, config_from_jax(jcfg))
    jx = J.guided_filter_wta(jnp.asarray(g1), jnp.asarray(cost), JCFG.d_min, jcfg)
    orc = R.guided_filter_wta(g1, cost, JCFG.d_min, JCFG)
    for p, j, o in zip(port, jx, orc):
        _eq(p, j, o)


@pytest.mark.parametrize("dmin", [JCFG.d_min, JCFG.d_min_right])
def test_guided_filter_wta_fast(dmin):
    """Fast mode vs the JAX op: near-tie flips only (the fused fast-path
    bound, tests/test_pallas_fused.py:55-57)."""
    g1, g2 = _pair(48, 64, 9)
    cost = R.cost_volume(g1, g2, dmin, JCFG)
    best, dmap, mean = T.guided_filter_wta(t(g1), t(cost), dmin, FAST)
    jb, jd, jm = J.guided_filter_wta(jnp.asarray(g1), jnp.asarray(cost), dmin, JCFG)
    mism = int((dmap.numpy() != np.asarray(jd)).sum())
    assert mism <= max(4, 2e-3 * dmap.numel()), mism
    np.testing.assert_allclose(best.numpy(), np.asarray(jb), atol=2e-3, rtol=1e-4)


def test_streaming_wta_largest_d_wins_ties():
    q = torch.tensor([[[1.0, 2.0]], [[0.5, 2.0]], [[0.5, 3.0]]])
    best, sidx = T.streaming_wta(q)
    jb, js = J.streaming_wta(jnp.asarray(q.numpy()))
    _eq(best, jb)
    _eq(sidx.to(torch.int32), np.asarray(js).astype(np.int32))
    assert sidx.tolist() == [[2, 1]]


def test_strict_mul_rounds_each_product():
    a = torch.tensor([1.0 + 2 ** -12], dtype=torch.float32)
    assert (strict_mul(a, a) - 1.0).item() == float(np.float32((1 + 2 ** -12) ** 2) - 1)


def _label_maps(cfg, h, w, seed):
    rng = np.random.default_rng(seed)
    dl = rng.integers(cfg.d_min, cfg.d_max + 1, size=(h, w)).astype(np.float32)
    dr = rng.integers(-cfg.d_max, -cfg.d_min + 1, size=(h, w)).astype(np.float32)
    return dl, dr


@pytest.mark.parametrize("dmin,dmax", [(-15, 0), (-63, 0), (-11, 4)])
def test_detect_and_fill_occlusion(dmin, dmax):
    jcfg = dataclasses.replace(JCFG, d_min=dmin, d_max=dmax)
    cfg = config_from_jax(jcfg)
    dl, dr = _label_maps(jcfg, 30, 70, abs(dmin))
    occ = T.detect_occlusion(t(dl), t(dr), cfg.d_occlusion, cfg)
    j_occ = jax.jit(J.detect_occlusion, static_argnums=(2, 3))(
        jnp.asarray(dl), jnp.asarray(dr), jcfg.d_occlusion, jcfg)
    _eq(occ, j_occ, R.detect_occlusion(dl, dr, jcfg.d_occlusion, jcfg))
    occ_np = occ.numpy()
    _eq(T.fill_occlusion(occ, cfg.v_min, cfg),
        jax.jit(J.fill_occlusion, static_argnums=(1, 2))(
            jnp.asarray(occ_np), jcfg.v_min, jcfg),
        R.fill_occlusion(occ_np, jcfg.v_min))
