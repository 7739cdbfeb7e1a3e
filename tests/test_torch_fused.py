"""The port's ``guided_wta_fused`` on the CPU (its plain version:
cost_volume + guided_filter_wta) against the JAX package's streaming
Pallas kernel (_make_stream_kernel) run in interpret mode, at the fused
fast-path bound."""

import dataclasses

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matching_cuda_tpu.config import DEFAULT_CONFIG as JCFG
from stereo_matching_cuda_tpu_torch.config import config_from_jax
from stereo_matching_cuda_tpu_torch.ops.fused_guided import guided_wta_fused

JSTREAM = dataclasses.replace(JCFG, stream=True)


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


@pytest.mark.parametrize("shape", [(64, 96), (40, 384), (33, 130)])
@pytest.mark.parametrize("view", ["left", "right"])
def test_guided_wta_fused_matches_stream_kernel(shape, view):
    from stereo_matching_cuda_tpu.ops.pallas_guided import guided_wta_fused as jfused

    g1, g2 = _pair(*shape)
    dmin = JCFG.d_min
    if view == "right":
        g1, g2, dmin = g2, g1, JCFG.d_min_right
    jb, jd = jfused(jnp.asarray(g1), jnp.asarray(g2), dmin, JSTREAM)
    best, dmap = guided_wta_fused(t(g1), t(g2), dmin, config_from_jax(JSTREAM))
    assert best.dtype == dmap.dtype == torch.float32
    assert best.shape == dmap.shape == shape
    n = dmap.numel()
    mism = int((dmap.numpy() != np.asarray(jd)).sum())
    assert mism <= max(4, n * 2e-3), f"{mism}/{n} disparity mismatches"
    np.testing.assert_allclose(best.numpy(), np.asarray(jb), atol=2e-3, rtol=1e-4)
