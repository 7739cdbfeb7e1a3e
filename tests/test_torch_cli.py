"""The port's CLI (``python -m stereo_matching_cuda_tpu_torch``) on the CPU
against the JAX package's CLI on the same inputs: --exact
--dump-intermediates writes the same 12 PNGs, the default mode the same
maps up to WTA near-ties, --oracle the same PNGs and stats, --eval the
same scores; and every error exit."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stereo_matching_cuda_tpu import cli as jax_cli
from stereo_matching_cuda_tpu.evaluate import evaluate_dataset as jax_evaluate_dataset
from stereo_matching_cuda_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT
from stereo_matching_cuda_tpu.utils.io import read_png
from stereo_matching_cuda_tpu_torch import DEFAULT_CONFIG, StereoConfig, cli, compute_disparity
from stereo_matching_cuda_tpu_torch.evaluate import scene_config
from stereo_matching_cuda_tpu_torch.utils.io import write_mat_normalize, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHGT = os.path.join(REPO, "tests", "data", "synthgt")
PNGS = ("disparity_mapl", "disparity_mapr", "occlu_mapl", "occlu_mapl_filled",
        "image_left", "image_right", "image_mean_left", "image_mean_right",
        "best_costl", "best_costr", "cost_lminus15", "cost_rminus15")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path on one intra-op thread: the suite runs its files in
    parallel processes, and timing tests elsewhere share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A 64x96 pair (the right a 4-column shift of the left) as PNGs."""
    d = tmp_path_factory.mktemp("pair")
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (64, 96 + 16, 3), dtype=np.uint8)
    base = ((base.astype(np.uint16) + np.roll(base, 1, 1)) // 2).astype(np.uint8)
    paths = [str(d / "l.png"), str(d / "r.png")]
    write_png(paths[0], base[:, 8:8 + 96])
    write_png(paths[1], base[:, 4:4 + 96])
    return paths


def _both(tmp_path, args, port_args=("--device", "cpu")):
    """The port's CLI and the JAX CLI on the same arguments, in this
    process, in that order: (port output dir, JAX output dir)."""
    outs = {}
    for name, main, extra in (("port", cli.main, list(port_args)), ("jax", jax_cli.main, [])):
        out = str(tmp_path / name)
        assert main([*args, "-o", out, *extra]) == 0, name
        outs[name] = out
    return outs["port"], outs["jax"]


def _png(d, name):
    return read_png(os.path.join(d, f"{name}.png"))


def test_exact_dump_intermediates_equals_jax(tmp_path, pair):
    port, theirs = _both(tmp_path, [*pair, "--exact", "--dump-intermediates"])
    assert sorted(os.listdir(port)) == sorted(f"{n}.png" for n in PNGS)
    for name in PNGS:
        np.testing.assert_array_equal(_png(port, name), _png(theirs, name), err_msg=name)


def test_oracle_equals_jax_oracle(tmp_path, pair, capsys):
    port, theirs = _both(tmp_path, [*pair, "--oracle", "--dump-intermediates", "--json"],
                         port_args=())
    lines = capsys.readouterr().out.strip().splitlines()
    ours, jax_stats = json.loads(lines[0]), json.loads(lines[1])
    assert ours["backend"] == jax_stats["backend"] == "oracle"
    for key in ("height", "width", "disparities", "occluded_pixels", "occluded_pct"):
        assert ours[key] == jax_stats[key], key
    for name in PNGS:
        np.testing.assert_array_equal(_png(port, name), _png(theirs, name), err_msg=name)


def test_default_mode_within_the_tie_bound_of_jax(tmp_path, pair, capsys):
    port, theirs = _both(tmp_path, [*pair, "--json"])
    ours, jax_stats = (json.loads(line) for line in capsys.readouterr().out.strip().splitlines())
    assert ours["backend"] == "cpu" and ours["disparities"] == jax_stats["disparities"] == 16
    n = 64 * 96
    for name in PNGS[:4]:
        mism = int((_png(port, name) != _png(theirs, name)).sum())
        assert mism <= max(4, 2e-3 * n), (name, mism)


def test_outputs_are_the_normalized_pipeline_maps(tmp_path, pair):
    from stereo_matching_cuda_tpu_torch.utils.io import read_image

    out = str(tmp_path / "out")
    assert cli.main([*pair, "-o", out, "--device", "cpu"]) == 0
    want = compute_disparity(read_image(pair[0]), read_image(pair[1]), DEFAULT_CONFIG, "cpu")
    for name, key in zip(PNGS[:4], ("disparity_left", "disparity_right", "occlusion",
                                    "occlusion_filled")):
        np.testing.assert_array_equal(_png(out, name), write_mat_normalize(want[key]))


def test_eval_synthgt_equals_jax(capsys):
    assert cli.main([SYNTHGT, "--eval", "--json", "--device", "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    theirs = jax_evaluate_dataset(SYNTHGT, JAX_DEFAULT)
    assert set(ours["scenes"]) == set(theirs["scenes"]) == {"scene0", "scene1_wide"}
    for name, s in ours["scenes"].items():
        t = theirs["scenes"][name]
        assert s["ndisp"] == t["ndisp"]
        assert abs(s["bad_2_0_pct"] - t["bad_2_0_pct"]) <= 0.1, (name, s, t)
    assert ours["aggregate"]["scored"] == 2


@pytest.mark.parametrize("ndisp,kw,want", [
    (64, {"dual_view": True}, {"dual_view": "auto"}),
    (8, {"dual_view": True}, {"dual_view": True}),
    (64, {"d_chunk": 16}, {"d_chunk": 16}),
    (64, {"d_chunk": 3, "d_min": -2}, {"d_chunk": None}),
])
def test_eval_scene_config_drops_what_the_range_breaks(ndisp, kw, want):
    cfg = scene_config(StereoConfig(**kw), ndisp)
    assert (cfg.d_min, cfg.d_max) == (-(ndisp - 1), 0)
    for k, v in want.items():
        assert getattr(cfg, k) == v


def test_sequence_equals_compute_disparity(tmp_path):
    rng = np.random.default_rng(5)
    for side in ("L", "R"):
        (tmp_path / side).mkdir()
    frames = []
    for i in range(2):
        base = rng.integers(0, 256, (40, 72, 3), dtype=np.uint8)
        frames.append((base[:, 6:], base[:, :-6]))
        write_png(str(tmp_path / "L" / f"f{i}.png"), frames[-1][0])
        write_png(str(tmp_path / "R" / f"f{i}.png"), frames[-1][1])
    out = str(tmp_path / "out")
    assert cli.main([str(tmp_path / "L"), str(tmp_path / "R"), "--sequence", "-o", out,
                     "--device", "cpu"]) == 0
    for i, (left, right) in enumerate(frames):
        want = compute_disparity(left, right, DEFAULT_CONFIG, "cpu")["occlusion_filled"]
        np.testing.assert_array_equal(_png(out, f"f{i}_disparity"), write_mat_normalize(want))


@pytest.mark.parametrize("extra", [["--aggregation", "box"], ["--gt", "GT"], ["--profile"],
                                   ["--stream", "on", "--dual-view", "on"]],
                         ids=["box", "gt", "profile", "stream-dual"])
def test_other_modes_run_on_the_cpu(tmp_path, pair, capsys, monkeypatch, extra):
    from stereo_matching_cuda_tpu_torch import profiling

    # one timed frame per stage: the CPU's plain stages take milliseconds
    monkeypatch.setattr(profiling, "stage_frames", lambda h, w: 1)
    if extra == ["--gt", "GT"]:
        gt = str(tmp_path / "gt.png")
        write_png(gt, np.full((64, 96), 4 * 16, np.uint16))
        extra = ["--gt", gt, "--gt-scale", "16"]
    assert cli.main([*pair, "-o", str(tmp_path / "o"), "--json", "--device", "cpu",
                     *extra]) == 0
    out = capsys.readouterr()
    stats = json.loads(out.out.strip().splitlines()[-1])
    assert os.path.exists(tmp_path / "o" / "occlu_mapl_filled.png")
    if "--gt" in extra:
        assert "bad_2_0_pct" in stats and "epe" in stats
    if "--profile" in extra:
        assert out.err.strip().splitlines()[-1].startswith("TOTAL")


def _cuda_missing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    return []


# (arguments after the image pair, or "no-cuda" for none on a machine with
# no card; text in stderr)
ERRORS = [
    (["--fused", "on", "--exact"], "incompatible"),
    (["--fused", "on", "--device", "cpu"], "--fused on needs --device cuda"),
    (["--mesh", "1,1,2", "--device", "cpu"], "need"),
    (["--mesh", "1,1,2", "--exact"], "does not support --exact"),
    (["--mesh", "1,1,1", "--aggregation", "box"], "only supports --aggregation guided"),
    (["--mesh", "1,x,1", "--device", "cpu"], "--mesh wants"),
    (["--mesh", "1,1,1", "--device", "cpu", "--profile"], "--profile covers"),
    (["--oracle", "--aggregation", "box"], "--oracle implements"),
    (["--device", "tpu"], "bad --device"),
    (["--d-min", "0", "--d-max", "-1", "--device", "cpu"], "d_max"),
    (["--radius", "0", "--device", "cpu"], "radius"),
    (["--device", "cpu", "--oracle", "--profile"], "--profile covers"),
    ("no-cuda", "no CUDA device"),
]


@pytest.mark.parametrize("extra,msg", ERRORS, ids=[e[1] for e in ERRORS])
def test_errors_exit_2(tmp_path, pair, capsys, extra, msg):
    if extra == "no-cuda":
        extra = _cuda_missing()
    rc = cli.main([*pair, "-o", str(tmp_path), *extra])
    err = capsys.readouterr().err
    assert rc == 2 and "error:" in err and msg in err, err


def test_mesh_1_1_1_equals_unsharded(tmp_path, pair, capsys):
    """--mesh 1,1,1 on the CPU: a one-rank gloo group of its own (gone
    after the run), and the PNGs of the one-device run within the sharded
    bound (tests/test_torch_parallel.py); --dump-intermediates prints the
    JAX CLI's note."""
    import torch.distributed as dist

    mesh, lone = str(tmp_path / "mesh"), str(tmp_path / "lone")
    assert cli.main([*pair, "-o", mesh, "--device", "cpu", "--mesh", "1,1,1",
                     "--dump-intermediates"]) == 0
    assert not dist.is_initialized()
    assert "--mesh returns final maps only" in capsys.readouterr().err
    assert cli.main([*pair, "-o", lone, "--device", "cpu"]) == 0
    assert sorted(os.listdir(mesh)) == sorted(f"{n}.png" for n in PNGS[:4])
    for name in PNGS[:4]:
        mism = int((_png(mesh, name) != _png(lone, name)).sum())
        assert mism <= 2e-3 * 64 * 96, (name, mism)


def test_input_errors_exit_2(tmp_path, pair, capsys):
    crop = str(tmp_path / "crop.png")
    write_png(crop, read_png(pair[0])[:32, :32])
    gray = str(tmp_path / "gray.png")
    write_png(gray, read_png(pair[0])[..., 0])
    deep = str(tmp_path / "deep.png")
    write_png(deep, np.zeros((8, 8), np.uint16))
    cases = [([crop, pair[1]], "shapes differ"), ([gray, gray], "color images"),
             ([str(tmp_path / "none.png"), pair[1]], "No such file"),
             ([pair[0]], "right image is required"), ([], "left image is required")]
    for args, msg in cases:
        assert cli.main([*args, "-o", str(tmp_path), "--device", "cpu"]) == 2, args
        err = capsys.readouterr().err
        assert "error:" in err and msg in err, (args, err)


@pytest.mark.parametrize("argv", [
    ["L", "R", "--sequence", "--oracle"],
    ["L", "R", "--sequence", "--profile"],
    ["L", "R", "--sequence", "--dump-intermediates"],
    ["L", "R", "--sequence", "--mesh", "1,1,1"],
    ["ROOT", "--eval", "--mesh", "1,1,1"],
    ["--serve", "0", "--mesh", "1,1,1"],
    ["ROOT", "--eval", "--aggregation", "box"],
    ["ROOT", "--eval", "--profile"],
    ["ROOT", "R", "--eval"],
    ["--serve", "0", "--eval"],
    ["left.png", "right.png", "--serve", "0"],
    ["--serve", "0", "--serve-warmup", "nonsense"],
    ["--serve", "0", "--serve-ranges", "1:2:3"],
    ["--serve", "0", "--serve-batch", "0"],
    ["EMPTY", "EMPTY", "--sequence"],
], ids=lambda a: " ".join(a))
def test_mode_combinations_exit_2(tmp_path, capsys, argv):
    (tmp_path / "EMPTY").mkdir()
    paths = {"L": SYNTHGT, "R": SYNTHGT, "ROOT": SYNTHGT, "EMPTY": str(tmp_path / "EMPTY")}
    rc = cli.main([paths.get(a, a) for a in argv] + ["--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 2 and "error:" in err and "Traceback" not in err, err


def test_module_entry_runs(tmp_path, pair):
    """``python -m stereo_matching_cuda_tpu_torch`` is the CLI."""
    r = subprocess.run([sys.executable, "-m", "stereo_matching_cuda_tpu_torch", *pair, "-o",
                        str(tmp_path / "m"), "--json", "--device", "cpu"],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1])["backend"] == "cpu"
    assert (tmp_path / "m" / "disparity_mapl.png").exists()
