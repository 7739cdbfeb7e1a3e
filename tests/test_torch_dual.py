"""The port's dual-view matching (``guided_wta_fused_dual``, kernels K4
and K5 on CUDA) on the CPU, where it runs its plain version, against the
JAX package's dual-view Pallas kernels (_make_dual_kernel and
_make_dual_stream_kernel) in interpret mode, per view at the fused
fast-path bound; the port's dual/stream routing against the JAX
package's; and the dual-view pipeline against the JAX one."""

import dataclasses

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matching_cuda_tpu import pipeline as JP
from stereo_matching_cuda_tpu.config import DEFAULT_CONFIG as JCFG
from stereo_matching_cuda_tpu_torch import DEFAULT_CONFIG
from stereo_matching_cuda_tpu_torch import pipeline as P
from stereo_matching_cuda_tpu_torch.config import config_from_jax
from stereo_matching_cuda_tpu_torch.ops import _kernels
from stereo_matching_cuda_tpu_torch.ops.fused_guided import guided_wta_fused_dual
from stereo_matching_cuda_tpu_torch.utils.synth import make_scene


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


@pytest.mark.parametrize("shape,d_min,d_max", [
    ((48, 130), -15, 0), ((48, 130), -7, 0), ((33, 130), -15, 0),
    ((48, 130), -8, 8)])
@pytest.mark.parametrize("stream", [False, True], ids=["K4", "K5"])
def test_dual_matches_jax_dual_kernels(shape, d_min, d_max, stream):
    from stereo_matching_cuda_tpu.ops.pallas_guided import guided_wta_fused_dual as jdual

    jcfg = dataclasses.replace(JCFG, d_min=d_min, d_max=d_max, dual_view=True,
                               stream=stream)
    gl, gr = _pair(*shape, seed=sum(shape) - d_min)
    want = [np.asarray(x) for x in jdual(jnp.asarray(gl), jnp.asarray(gr), jcfg)]
    got = guided_wta_fused_dual(t(gl), t(gr), config_from_jax(jcfg))
    n = gl.size
    for view, (best, dmap, jb, jd) in {"left": (*got[:2], *want[:2]),
                                       "right": (*got[2:], *want[2:])}.items():
        assert best.dtype == dmap.dtype == torch.float32
        assert best.shape == dmap.shape == shape
        mism = int((dmap.numpy() != jd).sum())
        assert mism <= max(4, n * 2e-3), f"{view}: {mism}/{n} disparity mismatches"
        np.testing.assert_allclose(best.numpy(), jb, atol=2e-3, rtol=1e-4,
                                   err_msg=view)


def test_dual_batch_equals_per_frame():
    pairs = [_pair(24, 70, seed=s) for s in (4, 5)]
    gl = t(np.stack([p[0] for p in pairs]))
    gr = t(np.stack([p[1] for p in pairs]))
    outs = guided_wta_fused_dual(gl, gr, DEFAULT_CONFIG)
    for i, (a, b) in enumerate(pairs):
        ref = guided_wta_fused_dual(t(a), t(b), DEFAULT_CONFIG)
        for j in range(4):
            assert outs[j].shape == (2, 24, 70)
            assert torch.equal(outs[j][i], ref[j]), f"frame {i} out {j}"


SMALL, BIG = (288, 384), (1992, 3008)


@pytest.mark.parametrize("kw,hw", [
    # the Motivation table of the dual-view port: config x frame size
    ({}, SMALL), ({}, BIG),
    ({"dual_view": True}, SMALL), ({"dual_view": True}, BIG),
    ({"d_min": -7}, SMALL), ({"d_min": -7}, BIG),
    ({"d_min": -63}, SMALL),
    # stream and dual_view set explicitly
    ({"dual_view": True, "stream": True}, SMALL),
    ({"dual_view": True, "stream": False}, BIG),
    ({"d_min": -7, "stream": True}, SMALL),
    ({"d_min": -7, "stream": False}, BIG),
    ({"stream": True}, BIG),
    ({"dual_view": False, "d_min": -7}, SMALL),
    ({"dual_view": False, "d_min": -7}, BIG),
])
def test_routing_matches_jax(monkeypatch, kw, hw):
    """(dual, dual and stream): the single-view route, K4 or K5.  K5 fits
    one block at these configs; the fit is the card's, so it is stubbed
    here (the CPU has no kernel library)."""
    monkeypatch.setattr(_kernels, "dual_stream_fits", lambda radius, reach: True)
    from stereo_matching_cuda_tpu.ops.pallas_guided import use_stream as juse_stream

    jcfg = JP.effective_config(dataclasses.replace(JCFG, **kw), *hw)
    jdual = JP.use_dual_view(jcfg)
    cfg = dataclasses.replace(DEFAULT_CONFIG, **kw)
    dual = P.use_dual_view(cfg)
    assert (dual, dual and P.use_stream(cfg, *hw)) == (jdual, jdual and juse_stream(jcfg))


def test_stream_falls_back_to_k4_when_k5_does_not_fit(monkeypatch):
    monkeypatch.setattr(_kernels, "dual_stream_fits", lambda radius, reach: False)
    cfg = dataclasses.replace(DEFAULT_CONFIG, dual_view=True)
    assert not P.use_stream(cfg, *BIG)
    # an explicit choice is kept (and raises at launch if it does not fit)
    assert P.use_stream(dataclasses.replace(cfg, stream=True), *BIG)


def test_cpu_dual_runs_plain_path_and_counts_no_launch():
    guided_wta_fused_dual.k4_launches = guided_wta_fused_dual.k5_launches = 0
    g1, g2 = (t(a) for a in _pair(16, 40))
    for stream in (None, True, False):
        guided_wta_fused_dual(g1, g2, dataclasses.replace(DEFAULT_CONFIG, stream=stream))
    assert (guided_wta_fused_dual.k4_launches, guided_wta_fused_dual.k5_launches) == (0, 0)
    m = torch.zeros((8, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        guided_wta_fused_dual(m, m, DEFAULT_CONFIG)


def test_dual_pipeline_matches_jax(monkeypatch):
    """The slice as a whole: the port's pipeline with dual_view=True on the
    CPU against the JAX pipeline's dual-view kernel path (interpret mode),
    within the per-key bounds chip_smoke.py holds the kernel path to."""
    monkeypatch.setattr(JP, "use_fused_path",
                        lambda cfg, full_outputs=False: not full_outputs
                        and cfg.fused is True)
    sc = make_scene(40, 96, ndisp=16)
    jcfg = dataclasses.replace(JCFG, fused=True, dual_view=True)
    want = JP.stereo_pipeline(jnp.asarray(sc["left"]), jnp.asarray(sc["right"]), jcfg)
    cfg = dataclasses.replace(DEFAULT_CONFIG, dual_view=True)
    got = P.stereo_pipeline(t(sc["left"]), t(sc["right"]), cfg)
    assert set(got) == set(want)
    n = sc["gt"].size
    for key, v in got.items():
        w = np.asarray(want[key])
        assert v.shape == w.shape and v.dtype == torch.float32, key
        mism = int((v.numpy() != w).sum())
        # each near-tie label flip can move one LR verdict and one fill run
        bound = (max(4, int(2e-3 * n)) if key.startswith("disparity")
                 else max(8, int(5e-3 * n)))
        assert mism <= bound, f"{key}: {mism}/{n}"
