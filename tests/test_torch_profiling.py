"""The port's profiling module on the CPU: stage rows per route named as
the JAX package's, each stage timed directly (no negative row, TOTAL the
sum of the rows), the table's format, the batch table, the Chrome trace
and the profiler's kernel names."""

import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from stereo_matching_cuda_tpu import profiling as jax_profiling
from stereo_matching_cuda_tpu_torch import DEFAULT_CONFIG as CFG, StereoConfig, profiling


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path on one intra-op thread: the suite runs its files in
    parallel processes, and timing tests elsewhere share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(h=24, w=48, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(h, w + 16, 3), dtype=np.uint8)
    return base[:, 16:], base[:, :-16]


def _jax_names(stages):
    return tuple(name for name, _ in stages)


def test_stage_names_are_the_jax_names():
    assert profiling.STAGES_UNFUSED == _jax_names(jax_profiling.STAGES_UNFUSED)
    assert profiling.STAGES_FUSED == _jax_names(jax_profiling.STAGES_FUSED)
    assert profiling.STAGES_DUAL == _jax_names(jax_profiling.STAGES_DUAL)


K2 = profiling.POST_FUSED


@pytest.mark.parametrize("kw,device,want", [
    ({}, "cpu", profiling.STAGES_UNFUSED),
    ({"exact_integral": True}, "cuda", profiling.STAGES_UNFUSED),
    ({}, "cuda", profiling.STAGES_FUSED[:3] + (K2,)),
    ({"stream": True}, "cuda", profiling.STAGES_FUSED[:3] + (K2,)),
    ({"dual_view": True}, "cuda", profiling.STAGES_DUAL[:2] + (K2,)),
    ({"d_min": -7}, "cuda", profiling.STAGES_DUAL[:2] + (K2,)),
    ({"d_min": -7, "dual_view": False}, "cuda", profiling.STAGES_FUSED[:3] + (K2,)),
    ({"fused": False}, "cuda", profiling.STAGES_UNFUSED),
    ({"fused": False, "post_fused": True}, "cuda", profiling.STAGES_UNFUSED[:3] + (K2,)),
    ({"post_fused": False}, "cuda", profiling.STAGES_FUSED),
], ids=["cpu", "exact", "K3", "K1", "K4/K5", "auto-dual", "d8-single", "plain", "plain+K2",
        "kernels+plain-post"])
def test_stage_names_per_route(kw, device, want):
    assert profiling.stage_names(StereoConfig(**kw), device) == list(want)


def test_stage_table_on_the_cpu_has_the_jax_rows():
    left, right = _pair()
    rows = profiling.stage_table(left, right, CFG, "cpu", n=2)
    # the rows the JAX package's table gives on the CPU
    # (tests/test_profiling.py::test_stage_table_structure_and_totals)
    assert [r["stage"] for r in rows] == [*_jax_names(jax_profiling.STAGES_UNFUSED), "TOTAL"]
    for r in rows:
        assert isinstance(r["ms"], float) and np.isfinite(r["ms"]) and r["ms"] > 0
    assert rows[-1]["ms"] == sum(r["ms"] for r in rows[:-1])


@pytest.mark.parametrize("kw", [{"d_chunk": 4}, {"exact_integral": True}],
                         ids=["d_chunk", "exact"])
def test_stage_table_other_plain_routes(kw):
    left, right = _pair(20, 40, 3)
    cfg = dataclasses.replace(CFG, **kw)
    rows = profiling.stage_table(left, right, cfg, "cpu", n=1)
    assert [r["stage"] for r in rows] == profiling.stage_names(cfg, "cpu") + ["TOTAL"]
    assert min(r["ms"] for r in rows) > 0


def test_stage_table_default_frames():
    assert profiling.stage_frames(288, 384) == 50
    assert profiling.stage_frames(1992, 3008) == 10
    with pytest.raises(ValueError):
        profiling.stage_table(*_pair(), CFG, "cpu", n=0)


def test_batch_stage_table_structure():
    left, right = _pair()
    bl, br = np.stack([left] * 3), np.stack([right] * 3)
    rows = profiling.batch_stage_table(bl, br, CFG, "cpu", n=2)
    # the rows the JAX package's batch table gives on the CPU
    # (tests/test_profiling.py::test_batch_stage_table_structure)
    assert [r["stage"] for r in rows] == [*_jax_names(jax_profiling.STAGES_UNFUSED),
                                          "TOTAL (per frame, B=3)"]
    assert all(r["ms"] > 0 for r in rows)
    assert rows[-1]["ms"] == sum(r["ms"] for r in rows[:-1])
    with pytest.raises(ValueError):
        profiling.batch_stage_table(left, right, CFG, "cpu")


def test_print_stage_table_formatting_equals_jax():
    rows = [{"stage": "gray", "ms": 1.234}, {"stage": "fused LR+fill (K2)", "ms": 0.0456},
            {"stage": "TOTAL", "ms": 5.0}]
    ours, theirs = io.StringIO(), io.StringIO()
    profiling.print_stage_table(rows, file=ours)
    jax_profiling.print_stage_table(rows, file=theirs)
    assert ours.getvalue() == theirs.getvalue()
    out = ours.getvalue().splitlines()
    assert len(out) == 3 and out[0].startswith("gray") and "1.234 ms" in out[0]
    assert out[2].startswith("TOTAL") and "5.000 ms" in out[2]


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        (torch.arange(64.0) * 2).sum()
    with open(os.path.join(logdir, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


@pytest.mark.parametrize("name,layer", [
    ("guided_wta_kernel<32>(unsigned char const*, ...)", "K3"),
    ("void guided_wta_stream_kernel<16>(...)", "K1"),
    ("guided_wta_dual_kernel", "K4"),
    ("_Z29guided_wta_dual_stream_kernelILi16EEvPKhS1_", "K5"),
    ("lr_fill_kernel(float const*, ...)", "K2"),
    ("void at::native::elementwise_kernel<128, 2>(...)", "other"),
])
def test_kernel_layer(name, layer):
    assert profiling.kernel_layer(name) == layer
