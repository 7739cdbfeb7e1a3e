"""The port's end-to-end pipeline against the JAX package's pipeline and
the NumPy oracle on the CPU (the plain path; the kernel path needs CUDA).

Parity mode is BIT-IDENTICAL on every output and intermediate; the
default (fast) mode differs only by WTA near-ties; on the committed
synthetic ground-truth scene both frameworks score the same bad-2.0."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matching_cuda_tpu import pipeline as JP
from stereo_matching_cuda_tpu import reference as R
from stereo_matching_cuda_tpu.config import DEFAULT_CONFIG as JCFG
from stereo_matching_cuda_tpu_torch import DEFAULT_CONFIG, compute_disparity
from stereo_matching_cuda_tpu_torch.config import config_from_jax
from stereo_matching_cuda_tpu_torch.metrics import bad_pixel_rate, end_point_error
from stereo_matching_cuda_tpu_torch.pipeline import stereo_pipeline

JEXACT = dataclasses.replace(JCFG, exact_integral=True)
SCENE0 = os.path.join(os.path.dirname(__file__), "data", "synthgt", "scene0")
ORACLE_KEYS = {"cost_left_s0": ("cost_left", 0), "cost_right_s0": ("cost_right", 0)}


def _pair(h, w, seed):
    """Random RGB pair with correlated structure (a shifted copy plus
    noise), as tests/conftest.py's small_pair."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(h, w + 24, 3), dtype=np.uint8)
    left = base[:, 12:12 + w]
    right = np.clip(base[:, 8:8 + w].astype(np.int32)
                    + rng.integers(-6, 7, size=(h, w, 3)), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(left), right


def _port(left, right, cfg, full_outputs=False):
    out = stereo_pipeline(torch.from_numpy(left), torch.from_numpy(right), cfg,
                          full_outputs)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("seed", [99, 5])
def test_exact_pipeline_bit_identical(seed):
    left, right = _pair(48, 64, seed)
    port = _port(left, right, config_from_jax(JEXACT), full_outputs=True)
    jax_out = JP.stereo_pipeline(jnp.asarray(left), jnp.asarray(right), JEXACT,
                                 full_outputs=True)
    oracle = R.run_pipeline(left, right, JEXACT)
    assert set(port) == set(jax_out)
    for k, v in port.items():
        want = np.asarray(jax_out[k])
        assert v.dtype == want.dtype and v.shape == want.shape, k
        np.testing.assert_array_equal(v, want, err_msg=f"vs JAX: {k}")
        ok, idx = ORACLE_KEYS.get(k, (k, None))
        want = oracle[ok] if idx is None else oracle[ok][idx]
        np.testing.assert_array_equal(v, want, err_msg=f"vs oracle: {k}")


@pytest.mark.parametrize("shape", [(48, 64), (40, 130)])
def test_default_pipeline_near_parity(shape):
    """Default config: disparities within the fused fast-path bound of
    the JAX pipeline; the filled map within max(8, 5e-3·n), since each
    near-tie flip can move one LR verdict and one fill run."""
    left, right = _pair(*shape, seed=sum(shape))
    port = _port(left, right, DEFAULT_CONFIG)
    jax_out = JP.stereo_pipeline(jnp.asarray(left), jnp.asarray(right), JCFG)
    n = left.shape[0] * left.shape[1]
    for k in ("disparity_left", "disparity_right"):
        mism = int((port[k] != np.asarray(jax_out[k])).sum())
        assert mism <= max(4, 2e-3 * n), f"{k}: {mism}/{n}"
    mism = int((port["occlusion_filled"] != np.asarray(jax_out["occlusion_filled"])).sum())
    assert mism <= max(8, 5e-3 * n), f"occlusion_filled: {mism}/{n}"


def test_default_pipeline_scene_288x384():
    """The default frame size on a structured scene: the port's plain fast
    path sums box windows from a float64 integral, the JAX fast path from
    a float32 one.  The labels may differ only by near-ties (0 left and 1
    right flip were seen), held to the same bounds as above."""
    from stereo_matching_cuda_tpu_torch.utils.synth import make_scene

    sc = make_scene(288, 384, ndisp=16)
    port = _port(sc["left"], sc["right"], DEFAULT_CONFIG)
    jax_out = JP.stereo_pipeline(jnp.asarray(sc["left"]), jnp.asarray(sc["right"]), JCFG)
    n = 288 * 384
    for k in ("disparity_left", "disparity_right"):
        mism = int((port[k] != np.asarray(jax_out[k])).sum())
        assert mism <= max(4, 2e-3 * n), f"{k}: {mism}/{n}"
    mism = int((port["occlusion_filled"] != np.asarray(jax_out["occlusion_filled"])).sum())
    assert mism <= max(8, 5e-3 * n), f"occlusion_filled: {mism}/{n}"


def test_synthetic_gt_scene_bad2_matches_jax():
    """tests/data/synthgt/scene0 (read with the JAX package's codecs): the
    port's bad-2.0 within 0.05 points of the JAX pipeline's (≈0.567)."""
    from stereo_matching_cuda_tpu.utils.io import read_png
    from stereo_matching_cuda_tpu.utils.pnm import read_pfm

    left = read_png(os.path.join(SCENE0, "im0.png"))
    right = read_png(os.path.join(SCENE0, "im1.png"))
    gt = read_pfm(os.path.join(SCENE0, "disp0.pfm"))
    port = compute_disparity(left, right, DEFAULT_CONFIG, "cpu")
    jax_out = JP.compute_disparity(left, right, JCFG)
    bad_port = bad_pixel_rate(np.abs(port["occlusion_filled"]), gt, 2.0)
    bad_jax = bad_pixel_rate(np.abs(np.asarray(jax_out["occlusion_filled"])), gt, 2.0)
    assert abs(bad_port - bad_jax) <= 0.05, (bad_port, bad_jax)
    assert bad_port < 2.0
    assert end_point_error(np.abs(port["occlusion_filled"]), gt) < 0.2


def test_compute_disparity_keys():
    left, right = _pair(24, 40, 3)
    out = compute_disparity(left, right, DEFAULT_CONFIG, "cpu",
                            keys=("occlusion_filled",))
    assert list(out) == ["occlusion_filled"]
    assert isinstance(out["occlusion_filled"], np.ndarray)
    assert out["occlusion_filled"].shape == (24, 40)
    with pytest.raises(ValueError, match="unknown output keys"):
        compute_disparity(left, right, DEFAULT_CONFIG, "cpu", keys=("gray_left",))
