"""The port's benchmark on the CPU at tiny sizes: its JSON line carries the
JAX bench's keys and the port's, a failing row leaves its error key and a
non-zero exit, the chain's perturbation is the JAX bench's, a chain is
the pipeline called frame by frame, the noise pair is the JAX bench's
Tsukuba fallback, the switches, and ``timing.steady_ms`` on a fake timer."""

import contextlib
import importlib.util
import io
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_matching_cuda_tpu_torch import (
    StereoConfig, bench, stereo_pipeline, stereo_pipeline_batch)
from stereo_matching_cuda_tpu_torch.timing import MAX_WINDOWS, Clock, steady_ms
from stereo_matching_cuda_tpu_torch.utils.synth import make_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (24, 40)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path on one intra-op thread: the suite runs its files in
    parallel processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def result(_one_torch_thread):
    """Every row at 24x40."""
    return bench.run("cpu", n_small=1, n_big=2, repeats=1, size=SIZE)


def _root_bench():
    """The JAX package's bench.py at the repository root, as a module."""
    spec = importlib.util.spec_from_file_location("root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _root_bench_keys():
    """The ``extra`` keys root bench.py writes on a full run that raises
    nowhere."""
    with open(os.path.join(REPO, "bench.py")) as f:
        src = f.read()
    keys = set(re.findall(r'extra\["(\w+)"\]', src)) | set(re.findall(r'extra = \{"(\w+)"', src))
    return {k for k in keys if not k.endswith("_error")}


PORT_KEYS = {"d8_288x384_auto_ms_per_frame", "d8_288x384_single_ms_per_frame",
             "d8_six_mp_auto_ms_per_frame", "d8_six_mp_single_ms_per_frame",
             "six_mp_stream_ms_per_frame"}


def test_json_line_has_the_jax_bench_keys_and_the_ports(result):
    summary = result.summary
    assert summary["metric"] == "tsukuba_full_pipeline_fps"
    assert summary["unit"] == "frames/s"
    assert summary["value"] == pytest.approx(1e3 / summary["extra"]["tsukuba_ms_per_frame"])
    assert summary["vs_baseline"] == pytest.approx(summary["value"] / bench.BASELINE_TSUKUBA_FPS)
    root_keys = _root_bench_keys()
    assert {"tsukuba_ms_per_frame", "six_mp_vs_baseline", "wide_d_config"} <= root_keys
    assert set(summary["extra"]) == root_keys | PORT_KEYS
    assert summary["extra"]["synthetic_input"] is True
    assert summary["extra"]["wide_d_config"] == "5.9MP_128disp"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench.emit(summary) == 0
    assert json.loads(out.getvalue().splitlines()[-1]) == json.loads(json.dumps(summary))


def test_rows_ran_their_routes_at_their_sizes(result):
    """Each row's first frame is its pipeline on its unperturbed input;
    every frame is the override size; counts follow n_small, n_big and
    repeats; no kernel launched on the CPU."""
    assert set(result.rows) == {r.key for r in (bench.HEADLINE, *bench.EXTRA_ROWS)}
    for row in (bench.HEADLINE, *bench.EXTRA_ROWS):
        r = result.rows[row.key]
        left, right = (torch.from_numpy(r.inputs[k]) for k in ("left", "right"))
        assert left.shape[-3:-1] == SIZE
        if row.batch == 1:
            want = stereo_pipeline(left, right, row.cfg)
        else:
            assert left.shape[0] == row.batch
            want = stereo_pipeline_batch(left, right, row.cfg)
        for k, v in want.items():
            np.testing.assert_array_equal(r.first[k], v.numpy(), err_msg=f"{row.key} {k}")
        if row.size is not None:
            assert r.inputs is not None and r.inputs["gt"].shape == SIZE
        assert r.calls == 1 + r.warm_windows + 3
        np.testing.assert_allclose(np.sum(r.frame_ms) * row.batch, r.t_big, rtol=1e-9)
        assert len(r.frame_ms) == 2 and r.peak_bytes is None
        assert not any(r.launches.values())


def test_a_raising_row_leaves_its_error_key_and_a_nonzero_exit(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("batch path down")

    monkeypatch.setattr(bench, "stereo_pipeline_batch", broken)
    rows = tuple(r for r in bench.EXTRA_ROWS if r.key in ("sequence_batch8", "three_mp"))
    res = bench.run("cpu", rows, n_small=1, n_big=2, repeats=1, size=SIZE)
    extra = res.summary["extra"]
    assert extra["sequence_batch8_error"] == repr(RuntimeError("batch path down"))
    assert "sequence_batch8_ms_per_frame" not in extra and "three_mp_ms_per_frame" in extra
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert bench.emit(res.summary) == 1
    assert "sequence_batch8_error" in json.loads(out.getvalue().splitlines()[-1])["extra"]


def test_the_headline_raises(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("pipeline down")

    monkeypatch.setattr(bench, "stereo_pipeline", broken)
    with pytest.raises(RuntimeError, match="pipeline down"):
        bench.run("cpu", (), n_small=1, n_big=2, repeats=1, size=SIZE)


@pytest.mark.parametrize("shape", [(6, 9), (3, 5, 7)])
def test_perturbation_is_the_jax_benchs(shape):
    """``l + (out[..., None].astype(jnp.uint8) & 1)`` of the JAX bench,
    over float labels -128..300, fractions and the -115 sentinel."""
    rng = np.random.default_rng(len(shape))
    left = rng.integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    left.flat[:4] = 255                        # the uint8 add wraps
    labels = np.concatenate([np.arange(-128, 301), [-115, -0.5, 0.5, 1.5, 254.5, 255.5]])
    filled = rng.choice(labels, size=shape).astype(np.float32)
    filled.flat[:4] = (1, 3, 255, 301)
    want = np.asarray(jnp.asarray(left) + (jnp.asarray(filled)[..., None].astype(jnp.uint8) & 1))
    got = bench.perturb(torch.from_numpy(left), torch.from_numpy(filled))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != left).any() and (want == 0).any()


def test_chain_is_the_pipeline_frame_by_frame():
    """A 3-frame chain equals three stereo_pipeline calls with the
    perturbation applied by hand in numpy.  Labels 0..15 (positive) so
    that the perturbation moves pixels."""
    cfg = StereoConfig(d_min=0, d_max=15)
    sc = make_scene(*SIZE, ndisp=16)
    right = torch.from_numpy(sc["right"])
    res = bench.chain(lambda l: stereo_pipeline(l, right, cfg), torch.from_numpy(sc["left"]), 3,
                      Clock(cuda=False))
    left = sc["left"]
    for _ in range(3):
        filled = stereo_pipeline(torch.from_numpy(left), right, cfg)["occlusion_filled"].numpy()
        left = left + (np.clip(filled, 0, 255).astype(np.uint8) & 1)[..., None]
    np.testing.assert_array_equal(res.left.numpy(), left)
    assert (left != sc["left"]).any()
    assert len(res.frame_ms) == 3 and res.ms == pytest.approx(sum(res.frame_ms))


def test_tsukuba_fallback_is_the_jax_benchs_pair(monkeypatch):
    root = _root_bench()
    import stereo_matching_cuda_tpu.utils.io as jax_io

    def missing(path):
        raise OSError(path)

    monkeypatch.setattr(jax_io, "read_png", missing)
    l_jax, r_jax, synth_jax = root._load_tsukuba()
    l, r = bench.noise_pair()
    assert synth_jax
    assert l.dtype == l_jax.dtype == np.uint8 and l.shape == l_jax.shape == (288, 384, 3)
    assert l.tobytes() == l_jax.tobytes() and r.tobytes() == r_jax.tobytes()
    assert bench.BASELINE_TSUKUBA_FPS == root.BASELINE_TSUKUBA_FPS
    assert bench.BASELINE_BIKE_MS == root.BASELINE_BIKE_MS


@pytest.mark.parametrize("switch,gone", [
    ("STEREO_BENCH_SKIP_BATCH", {"sequence_batch8"}),
    ("STEREO_BENCH_SKIP_BIG", {"six_mp", "d8_six_mp_auto", "d8_six_mp_single", "six_mp_stream"}),
    ("STEREO_BENCH_SKIP_WIDED", {"wide_d"}),
    ("STEREO_BENCH_SKIP_3MP", {"three_mp"})])
def test_switches_leave_their_rows_out(switch, gone):
    every = {r.key for r in bench.EXTRA_ROWS}
    assert {r.key for r in bench.rows_from_env({})} == every
    assert {r.key for r in bench.rows_from_env({switch: "1"})} == every - gone
    assert {r.key for r in bench.rows_from_env({switch: ""})} == every


def test_main_without_a_card_exits_1_and_prints_no_numbers(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() == 1
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


def _fake_timer(times):
    stream = iter(times)
    seen = []

    def timer(fn, iters):
        seen.append(iters)
        return next(stream)

    return timer, seen


@pytest.mark.parametrize("k", [1, 2, 5, 9])
def test_steady_ms_returns_k_plus_1_windows_once_settled(k):
    """Windows 1..k move by more than 2% from one to the next; window
    k + 1 is within 2% of window k."""
    times = [10.0 * 0.5 ** i for i in range(k)]
    times += [times[-1] * 1.019, 99.0]
    timer, seen = _fake_timer(times)
    s = steady_ms(lambda: None, 7, timer=timer)
    assert (s.windows, s.settled) == (k + 1, True)
    assert s.ms == times[k]
    assert seen == [7] * (k + 1)


def test_steady_ms_stops_at_max_windows_and_says_so():
    timer, seen = _fake_timer([1.0, 2.0] * (MAX_WINDOWS // 2) + [2.0])
    s = steady_ms(lambda: None, 3, timer=timer)
    assert (s.windows, s.settled) == (MAX_WINDOWS, False)
    assert s.ms == 2.0 and len(seen) == MAX_WINDOWS
