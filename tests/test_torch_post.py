"""The port's ``lr_fill_fused`` on the CPU (its plain version:
detect_occlusion + fill_occlusion) against the JAX package's Pallas post
kernel (_post_kernel) run in interpret mode: BIT-IDENTICAL, as kernel K2
must be to its plain version."""

import dataclasses

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matching_cuda_tpu import ops as J
from stereo_matching_cuda_tpu.config import DEFAULT_CONFIG as JCFG
from stereo_matching_cuda_tpu_torch.config import config_from_jax
from stereo_matching_cuda_tpu_torch.ops.fused_post import lr_fill_fused


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


def _maps(cfg, h, w, seed):
    rng = np.random.default_rng(seed)
    dl = rng.integers(cfg.d_min, cfg.d_max + 1, size=(h, w)).astype(np.float32)
    dr = rng.integers(-cfg.d_max, -cfg.d_min + 1, size=(h, w)).astype(np.float32)
    return dl, dr


def _assert_post_parity(jcfg, dl, dr):
    from stereo_matching_cuda_tpu.ops.pallas_post import lr_fill_fused as jpost

    j_occ, j_fill = jpost(jnp.asarray(dl), jnp.asarray(dr), jcfg)
    occ, filled = lr_fill_fused(t(dl), t(dr), config_from_jax(jcfg))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(j_occ))
    np.testing.assert_array_equal(filled.numpy(), np.asarray(j_fill))


@pytest.mark.parametrize("dmin,h,w", [(-15, 24, 130), (-127, 16, 300)])
def test_lr_fill_fused_matches_post_kernel(dmin, h, w):
    jcfg = dataclasses.replace(JCFG, d_min=dmin, d_max=0)
    _assert_post_parity(jcfg, *_maps(jcfg, h, w, seed=abs(dmin)))


def test_lr_fill_fused_fully_occluded_rows():
    """Rows with no LR-consistent pixel fill with v_min on both sides."""
    dl, dr = _maps(JCFG, 12, 130, seed=9)
    dr[3:6] = -JCFG.d_min + 50
    _assert_post_parity(JCFG, dl, dr)


def test_out_of_set_labels_follow_the_xla_ops():
    """Pinned clamp semantics: a left value outside the label set reads
    dprime = 0 in the LR check, and a valid value above d_max packs with
    its code clamped (ops/occlusion.py:94).  The port follows the JAX
    package's XLA ops here, not the Pallas post kernel's unclamped
    packing.  d_lr = 4 lets out-of-set values 2 and 3 pass the check."""
    jcfg = dataclasses.replace(JCFG, d_lr=4)
    dl, dr = _maps(jcfg, 6, 40, seed=4)
    dl[0, :5] = 99.0                  # x+d leaves the row: occluded
    dl[1, 10:16] = [3.0, 99.0, 99.0, 2.5, 99.0, -2.0]
    dl[2, :] = jcfg.d_max + 2         # a whole row of out-of-set values
    j_occ = jax.jit(J.detect_occlusion, static_argnums=(2, 3))(
        jnp.asarray(dl), jnp.asarray(dr), jcfg.d_occlusion, jcfg)
    j_fill = jax.jit(J.fill_occlusion, static_argnums=(1, 2))(
        j_occ, jcfg.v_min, jcfg)
    occ, filled = lr_fill_fused(t(dl), t(dr), config_from_jax(jcfg))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(j_occ))
    np.testing.assert_array_equal(filled.numpy(), np.asarray(j_fill))
    occ, filled = occ.numpy(), filled.numpy()
    assert (occ[0, :5] == jcfg.d_occlusion).all()
    # 3.0 and 2.5 survive the check; the holes between them fill with the
    # clamped code's label (d_max = 0), not with 3
    np.testing.assert_array_equal(occ[1, 10:14], [3.0, -115.0, -115.0, 2.5])
    np.testing.assert_array_equal(filled[1, 11:13], [0.0, 0.0])
