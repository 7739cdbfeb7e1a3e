"""The port's StereoConfig against the JAX package's, the port's import
boundary (no JAX), and its device routing on the CPU."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stereo_matching_cuda_tpu import config as jax_config
from stereo_matching_cuda_tpu_torch import DEFAULT_CONFIG, StereoConfig
from stereo_matching_cuda_tpu_torch.config import config_from_jax
from stereo_matching_cuda_tpu_torch.ops.fused_guided import guided_wta_fused
from stereo_matching_cuda_tpu_torch.ops.fused_post import lr_fill_fused
from stereo_matching_cuda_tpu_torch.pipeline import (
    stereo_pipeline, use_fused_path, use_fused_post)

FIELDS = [f.name for f in dataclasses.fields(StereoConfig)]
PROPS = ["size_d", "d_min_right", "d_occlusion", "v_min", "window", "shift_max"]
TPU_KNOBS = ["staged", "unroll_max", "y_sum", "slice_group",
             "vmem_mb", "sw_pipeline", "dma_buffer"]


def _same(port, jax_cfg):
    for name in FIELDS:
        assert getattr(port, name) == getattr(jax_cfg, name), name
    for name in PROPS:
        assert getattr(port, name) == getattr(jax_cfg, name), name
    assert port.disparities() == jax_cfg.disparities()
    assert port.disparities(port.d_min_right) == jax_cfg.disparities(jax_cfg.d_min_right)


def test_defaults_equal_jax_defaults():
    _same(DEFAULT_CONFIG, jax_config.DEFAULT_CONFIG)


def test_fields_are_the_jax_fields_minus_tpu_knobs():
    jax_fields = [f.name for f in dataclasses.fields(jax_config.StereoConfig)]
    assert FIELDS == [f for f in jax_fields if f not in TPU_KNOBS]


@pytest.mark.parametrize("kw", [
    {},
    {"d_min": -63, "d_max": 0, "radius": 5, "eps": 1.5},
    {"d_min": -8, "d_max": 8, "d_lr": 1, "alpha": 0.5, "th_color": 9.0},
    {"exact_integral": True, "fused": False, "d_chunk": 4},
    {"post_fused": True, "r_w": 0.25, "g_w": 0.5, "b_w": 0.25},
    {"stream": True, "unroll_max": 8, "vmem_mb": 32, "th_grad": 3.0},
    {"dual_view": True, "stream": False},
])
def test_config_from_jax_round_trips(kw):
    jax_cfg = jax_config.StereoConfig(**kw)
    port = config_from_jax(jax_cfg)
    _same(port, jax_cfg)
    assert config_from_jax(port) == port
    assert hash(port) == hash(config_from_jax(jax_cfg))


@pytest.mark.parametrize("kw", [
    {"d_min": 0, "d_max": -1},
    {"radius": 0},
    {"eps": 0.0},
    {"th_color": -1.0},
    {"d_chunk": 5},
    {"fused": "yes"},
    {"post_fused": "auto"},
    {"fused": True, "exact_integral": True},
    {"dual_view": "yes"},
    {"stream": "on"},
])
def test_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        jax_config.StereoConfig(**kw)
    with pytest.raises(ValueError):
        StereoConfig(**kw)


def test_import_never_loads_jax():
    """Every module of the port (the entries, the codecs and the
    multi-device layer named, the rest walked) and chip_smoke.py import
    without JAX or the JAX package, which the child blocks outright."""
    code = (
        "import pkgutil, importlib, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'jax' or name.startswith(('jax.', 'stereo_matching_cuda_tpu.'))\\\n"
        "                or name == 'stereo_matching_cuda_tpu':\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import stereo_matching_cuda_tpu_torch as p\n"
        "import stereo_matching_cuda_tpu_torch.models\n"
        "from stereo_matching_cuda_tpu_torch import cli, evaluate, profiling, serve\n"
        "from stereo_matching_cuda_tpu_torch.utils import (\n"
        "    imagefmt, io, jpeg, legacyfmt, parse, png, pnm, synth)\n"
        "import stereo_matching_cuda_tpu_torch.parallel\n"
        "from stereo_matching_cuda_tpu_torch.parallel import halo, mesh, multihost, sharded\n"
        "import chip_smoke\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if m.name != p.__name__ + '.__main__':   # runs the CLI\n"
        "        importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k.startswith('stereo_matching_cuda_tpu.')\n"
        "             or k == 'stereo_matching_cuda_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=repo)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _reset():
    guided_wta_fused.k1_launches = guided_wta_fused.k3_launches = 0
    lr_fill_fused.launches = 0


def _rgb(seed=0, h=24, w=40):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)))


@pytest.mark.parametrize("kw", [{"fused": True}, {"post_fused": True}])
def test_forcing_a_kernel_on_cpu_raises(kw):
    _reset()
    left, right = _rgb()
    with pytest.raises(ValueError, match="CUDA"):
        stereo_pipeline(left, right, dataclasses.replace(DEFAULT_CONFIG, **kw))
    assert (guided_wta_fused.k1_launches, guided_wta_fused.k3_launches,
            lr_fill_fused.launches) == (0, 0, 0)


def test_cpu_runs_plain_path_and_counts_no_launch():
    _reset()
    left, right = _rgb(1)
    out = stereo_pipeline(left, right, DEFAULT_CONFIG)
    assert set(out) == {"disparity_left", "disparity_right", "occlusion",
                        "occlusion_filled"}
    g = left[..., 0].contiguous()
    guided_wta_fused(g, g, DEFAULT_CONFIG.d_min, DEFAULT_CONFIG)
    lr_fill_fused(out["disparity_left"], out["disparity_right"], DEFAULT_CONFIG)
    assert (guided_wta_fused.k1_launches, guided_wta_fused.k3_launches,
            lr_fill_fused.launches) == (0, 0, 0)


def test_routing_rule():
    cfg = DEFAULT_CONFIG
    assert not use_fused_path(cfg, "cpu")
    assert use_fused_path(cfg, "cuda")
    assert not use_fused_path(cfg, "cuda", full_outputs=True)
    assert not use_fused_path(dataclasses.replace(cfg, fused=False), "cuda")
    assert not use_fused_path(dataclasses.replace(cfg, exact_integral=True), "cuda")
    assert use_fused_post(cfg, "cuda")
    assert not use_fused_post(dataclasses.replace(cfg, post_fused=False), "cuda")
    assert use_fused_post(dataclasses.replace(cfg, fused=False, post_fused=True), "cuda")
    assert not use_fused_post(dataclasses.replace(cfg, post_fused=False), "cpu")


def test_wrappers_refuse_other_devices():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    neither the CPU nor CUDA never reaches the plain version."""
    g = torch.zeros((8, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        guided_wta_fused(g, g, -15, DEFAULT_CONFIG)
    d = torch.zeros((8, 16), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        lr_fill_fused(d, d, DEFAULT_CONFIG)
