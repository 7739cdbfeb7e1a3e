"""The port's batch and stacked entries (``stereo_pipeline_batch``,
``compute_disparity_stacked``) on the CPU against the JAX package's and
the NumPy oracle: exact mode bit-identical, fast mode within the per-key
bounds; ``compact`` only on the integer-valued keys."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matching_cuda_tpu import pipeline as JP
from stereo_matching_cuda_tpu import reference as R
from stereo_matching_cuda_tpu.config import DEFAULT_CONFIG as JCFG
from stereo_matching_cuda_tpu_torch import (
    DEFAULT_CONFIG, compute_disparity, compute_disparity_stacked,
    stereo_pipeline, stereo_pipeline_batch)
from stereo_matching_cuda_tpu_torch.config import config_from_jax
from stereo_matching_cuda_tpu_torch.ops.fused_post import lr_fill_fused

JEXACT = dataclasses.replace(JCFG, exact_integral=True)
KEYS = ("disparity_left", "disparity_right", "occlusion", "occlusion_filled")


def _batch(b, h, w, seed):
    """(B,H,W,3) pairs with correlated structure (a shifted copy plus
    noise), as tests/conftest.py's small_pair."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(b, h, w + 24, 3), dtype=np.uint8)
    left = np.ascontiguousarray(base[:, :, 12:12 + w])
    right = np.clip(base[:, :, 8:8 + w].astype(np.int32)
                    + rng.integers(-6, 7, size=(b, h, w, 3)), 0, 255).astype(np.uint8)
    return left, right


def test_exact_batch_bit_identical_to_jax_and_oracle():
    left, right = _batch(2, 32, 48, seed=11)
    out = stereo_pipeline_batch(torch.from_numpy(left), torch.from_numpy(right),
                                config_from_jax(JEXACT))
    want = JP.stereo_pipeline_batch(jnp.asarray(left), jnp.asarray(right), JEXACT)
    assert set(out) == set(KEYS)
    for k in KEYS:
        assert out[k].shape == (2, 32, 48) and out[k].dtype == torch.float32, k
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(want[k]), err_msg=k)
    for i in range(2):
        oracle = R.run_pipeline(left[i], right[i], JEXACT)
        for k in KEYS:
            np.testing.assert_array_equal(out[k][i].numpy(), oracle[k], err_msg=f"{i} {k}")


def test_fast_batch_within_bounds_of_jax():
    left, right = _batch(3, 40, 64, seed=12)
    out = stereo_pipeline_batch(torch.from_numpy(left), torch.from_numpy(right),
                                DEFAULT_CONFIG)
    want = JP.stereo_pipeline_batch(jnp.asarray(left), jnp.asarray(right), JCFG)
    n = 40 * 64
    for i in range(3):
        for k in KEYS:
            mism = int((out[k][i].numpy() != np.asarray(want[k][i])).sum())
            # each near-tie label flip can move one LR verdict and one fill run
            bound = max(4, 2e-3 * n) if k.startswith("disparity") else max(8, 5e-3 * n)
            assert mism <= bound, f"frame {i} {k}: {mism}/{n}"


def test_batch_rejects_mismatched_shapes():
    a = torch.zeros((2, 8, 16, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="batches"):
        stereo_pipeline_batch(a, a[:1])
    with pytest.raises(ValueError, match="batches"):
        stereo_pipeline_batch(a[0], a[0])


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("keys", [("occlusion_filled", "occlusion"), KEYS,
                                  ("disparity_right",)])
def test_stacked_equals_jax(small_pair, compact, keys):
    left, right = small_pair
    got = compute_disparity_stacked(left, right, config_from_jax(JEXACT), "cpu",
                                    keys=keys, compact=compact)
    want = JP.compute_disparity_stacked(left, right, JEXACT, keys=keys, compact=compact)
    assert list(got) == list(keys)
    for k in keys:
        assert got[k].dtype == np.float32 and isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    per_key = compute_disparity(left, right, config_from_jax(JEXACT), "cpu", keys=keys)
    for k in keys:
        np.testing.assert_array_equal(got[k], per_key[k], err_msg=k)


def test_stacked_unknown_keys_raise(small_pair):
    left, right = small_pair
    with pytest.raises(ValueError, match="unknown output keys"):
        compute_disparity_stacked(left, right, DEFAULT_CONFIG, "cpu",
                                  keys=("occlusion", "gray_left"))


def test_stacked_compact_takes_only_integer_keys(small_pair):
    """compact casts to int16: a float-valued map such as a best cost
    would be truncated silently, so it is refused before any work."""
    left, right = small_pair
    with pytest.raises(ValueError, match="integer-valued"):
        compute_disparity_stacked(left, right, DEFAULT_CONFIG, "cpu",
                                  keys=("occlusion", "best_cost_left"), compact=True)


def test_stacked_compact_keeps_float_where_int16_overflows(small_pair):
    left, right = small_pair
    cfg = dataclasses.replace(DEFAULT_CONFIG, d_min=-32700, d_max=-32685)
    assert cfg.d_occlusion < -32768
    got = compute_disparity_stacked(left, right, cfg, "cpu", keys=("occlusion",),
                                    compact=True)
    plain = compute_disparity(left, right, cfg, "cpu", keys=("occlusion",))
    np.testing.assert_array_equal(got["occlusion"], plain["occlusion"])
    assert (got["occlusion"] == cfg.d_occlusion).any()


def test_batch_equals_per_frame_pipeline():
    left, right = _batch(2, 24, 40, seed=13)
    out = stereo_pipeline_batch(torch.from_numpy(left), torch.from_numpy(right),
                                DEFAULT_CONFIG)
    for i in range(2):
        one = stereo_pipeline(torch.from_numpy(left[i]), torch.from_numpy(right[i]),
                              DEFAULT_CONFIG)
        for k, v in one.items():
            assert torch.equal(out[k][i], v), (i, k)


def test_post_batch_equals_per_frame():
    """lr_fill_fused takes (B,H,W) as B·H independent rows (its plain
    version here), equal to per-frame calls."""
    rng = np.random.default_rng(14)
    dl = torch.from_numpy(rng.integers(-15, 1, (3, 12, 50)).astype(np.float32))
    dr = torch.from_numpy(rng.integers(0, 16, (3, 12, 50)).astype(np.float32))
    occ, filled = lr_fill_fused(dl, dr, DEFAULT_CONFIG)
    for i in range(3):
        o, f = lr_fill_fused(dl[i], dr[i], DEFAULT_CONFIG)
        assert torch.equal(occ[i], o) and torch.equal(filled[i], f), i
