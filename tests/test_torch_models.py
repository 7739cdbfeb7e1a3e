"""The port's model family (``GuidedStereoMatcher``, ``BoxStereoMatcher``,
``box_stereo_pipeline``) on the CPU against the NumPy box oracle, the
reference pipeline and the JAX package's models."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matching_cuda_tpu import reference as R
from stereo_matching_cuda_tpu.config import DEFAULT_CONFIG as JCFG
from stereo_matching_cuda_tpu.models.box import box_stereo_pipeline as jbox
from stereo_matching_cuda_tpu_torch import (
    DEFAULT_CONFIG, BoxStereoMatcher, GuidedStereoMatcher, StereoMatcher)
from stereo_matching_cuda_tpu_torch.config import config_from_jax
from stereo_matching_cuda_tpu_torch.models import box_stereo_pipeline
from stereo_matching_cuda_tpu_torch.pipeline import stereo_pipeline

JEXACT = dataclasses.replace(JCFG, exact_integral=True)
EXACT = config_from_jax(JEXACT)


def _box_oracle(left, right, cfg):
    """NumPy oracle for the box-aggregation family: q = box_mean(cost),
    same WTA / LR / fill as the guided oracle (tests/test_models.py)."""
    gl = R.rgb_to_grayscale(left, cfg)
    gr = R.rgb_to_grayscale(right, cfg)

    def view(g1, g2, dmin):
        cost = R.cost_volume(g1, g2, dmin, cfg)
        best = np.full(g1.shape, R.BEST_COST_INIT, dtype=np.float32)
        dmap = np.zeros(g1.shape, dtype=np.float32)
        for s in range(cost.shape[0]):
            q = R.box_mean(cost[s], cfg.radius)
            upd = best >= q
            dmap[upd] = np.float32(dmin + s)
            best[upd] = q[upd]
        return best, dmap

    _, dl = view(gl, gr, cfg.d_min)
    _, dr = view(gr, gl, cfg.d_min_right)
    occ = R.detect_occlusion(dl, dr, cfg.d_occlusion, cfg)
    return dl, dr, occ, R.fill_occlusion(occ, cfg.v_min)


def test_box_matcher_matches_its_oracle_and_jax(small_pair):
    left, right = small_pair
    dl, dr, occ, filled = _box_oracle(left, right, JCFG)
    out = BoxStereoMatcher(EXACT, device="cpu").compute(left, right)
    np.testing.assert_array_equal(out["disparity_left"], dl)
    np.testing.assert_array_equal(out["disparity_right"], dr)
    np.testing.assert_array_equal(out["occlusion"], occ)
    np.testing.assert_array_equal(out["occlusion_filled"], filled)
    want = jbox(jnp.asarray(left), jnp.asarray(right), JEXACT)
    assert set(out) == set(want)
    for k, v in out.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("cfg", [DEFAULT_CONFIG, EXACT], ids=["fast", "exact"])
def test_box_d_chunk_matches_unchunked(small_pair, cfg):
    """cfg.d_chunk bounds peak memory: the chunked ascending `best >= q`
    scan reproduces the unchunked WTA bit for bit."""
    left, right = (torch.from_numpy(np.ascontiguousarray(a)) for a in small_pair)
    base = box_stereo_pipeline(left, right, cfg)
    got = box_stereo_pipeline(left, right, dataclasses.replace(cfg, d_chunk=4))
    for k in base:
        assert torch.equal(base[k], got[k]), k


def test_guided_matcher_matches_pipeline_and_oracle(small_pair):
    left, right = small_pair
    for cfg in (DEFAULT_CONFIG, EXACT):
        out = GuidedStereoMatcher(cfg, device="cpu").compute(left, right)
        want = stereo_pipeline(torch.from_numpy(np.ascontiguousarray(left)),
                               torch.from_numpy(np.ascontiguousarray(right)), cfg)
        for k, v in want.items():
            np.testing.assert_array_equal(out[k], v.numpy(), err_msg=k)
    oracle = R.run_pipeline(left, right, JCFG)
    np.testing.assert_array_equal(out["disparity_left"], oracle["disparity_left"])
    np.testing.assert_array_equal(out["occlusion_filled"], oracle["occlusion_filled"])


def test_models_share_interface(small_pair):
    left, right = small_pair
    for cls in (GuidedStereoMatcher, BoxStereoMatcher):
        m = cls(DEFAULT_CONFIG, device="cpu")
        assert isinstance(m, StereoMatcher) and isinstance(m, torch.nn.Module)
        assert m.device == torch.device("cpu")
        out = m.compute(left, right)
        assert out["disparity_left"].shape == left.shape[:2]
        assert out["occlusion_filled"].dtype == np.float32
        t = m(torch.from_numpy(np.ascontiguousarray(left)),
              torch.from_numpy(np.ascontiguousarray(right)))
        assert t["occlusion_filled"].device.type == "cpu"
        np.testing.assert_array_equal(t["occlusion_filled"].numpy(), out["occlusion_filled"])


def test_matchers_default_to_the_card():
    assert GuidedStereoMatcher().device.type == "cuda"
    assert BoxStereoMatcher().device.type == "cuda"
