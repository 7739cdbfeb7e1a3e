"""The port's HTTP server (``stereo_matching_cuda_tpu_torch.serve``) on the
CPU: every case of the JAX package's tests/test_serve.py but the
power-of-two batch cap (the port pads no batch), its responses held to
the port's pipeline and to the JAX package's, and a worker that outlives
a request or a group that raises."""

import base64
import json
import os
import tempfile
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from stereo_matching_cuda_tpu import reference as R
from stereo_matching_cuda_tpu.config import StereoConfig as JaxConfig
from stereo_matching_cuda_tpu.pipeline import compute_disparity as jax_compute_disparity
from stereo_matching_cuda_tpu_torch import StereoConfig, compute_disparity
from stereo_matching_cuda_tpu_torch.serve import BatchExecutor, make_server
from stereo_matching_cuda_tpu_torch.utils.png import read_png, write_png
from stereo_matching_cuda_tpu_torch.utils.pnm import read_pfm

CFG = StereoConfig(d_min=-7, d_max=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path on one intra-op thread: the suite runs its files in
    parallel processes, and timing tests elsewhere share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _b64_png(img):
    fd, path = tempfile.mkstemp(suffix=".png")
    os.close(fd)
    try:
        write_png(path, img)
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode()
    finally:
        os.unlink(path)


def _decode(b64, read, suffix):
    fd, path = tempfile.mkstemp(suffix=suffix)
    os.close(fd)
    try:
        with open(path, "wb") as f:
            f.write(base64.b64decode(b64))
        return read(path)
    finally:
        os.unlink(path)


def _start(**kw):
    srv = make_server("127.0.0.1", 0, kw.pop("cfg", CFG), device="cpu", **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(srv):
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def server():
    srv = _start()
    yield srv
    _stop(srv)


def _post(server, payload, timeout=600):
    url = f"http://127.0.0.1:{server.server_address[1]}/disparity"
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _health(server):
    url = f"http://127.0.0.1:{server.server_address[1]}/healthz"
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _pair(h=40, w=72, shift=6, seed=9):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w + shift + 2, 3), dtype=np.uint8)
    return base[:, shift:-2], base[:, : -shift - 2]


def test_healthz(server):
    rep = _health(server)
    assert rep["status"] == "ok"
    assert rep["backend"] == "cpu" and rep["device"] == "cpu"
    assert rep["frames_served"] >= 0


def test_disparity_matches_pipeline(server):
    left, right = _pair()
    rep = _post(server, {"left": _b64_png(left), "right": _b64_png(right)})
    assert rep["height"] == 40 and rep["width"] == 72
    assert rep["seconds"] > 0
    served = _decode(rep["disparity_pfm"], read_pfm, ".pfm")
    want = compute_disparity(left, right, server.cfg, "cpu")["occlusion_filled"]
    np.testing.assert_array_equal(served, want)
    # the JAX package's pipeline on the same pair, up to WTA near-ties
    theirs = jax_compute_disparity(left, right, JaxConfig(d_min=-7, d_max=0))
    assert int((served != np.asarray(theirs["occlusion_filled"])).sum()) <= max(8, 5e-3 * 40 * 72)
    # the PNG artifact is the write_mat-normalized map
    png = _decode(rep["disparity_png"], read_png, ".png")
    np.testing.assert_array_equal(png, R.write_mat_normalize(want))
    occ = compute_disparity(left, right, server.cfg, "cpu")["occlusion"]
    assert rep["occluded_pixels"] == int((occ < server.cfg.v_min).sum())


def test_disparity_range_override(server):
    left, right = _pair()
    rep = _post(server, {"left": _b64_png(left), "right": _b64_png(right),
                         "d_min": -3, "d_max": 0})
    assert rep["height"] == 40
    want = compute_disparity(left, right, StereoConfig(d_min=-3, d_max=0), "cpu")
    np.testing.assert_array_equal(_decode(rep["disparity_pfm"], read_pfm, ".pfm"),
                                  want["occlusion_filled"])


def test_repeat_requests_count(server):
    left, right = _pair()
    before = _health(server)["frames_served"]
    _post(server, {"left": _b64_png(left), "right": _b64_png(right)})
    assert _health(server)["frames_served"] == before + 1


@pytest.mark.parametrize("payload,msg", [
    ({"right": "aGk="}, "missing field"),               # no left
    ({"left": "aGk=", "right": "aGk="}, "bad request"),  # not an image
])
def test_bad_requests_rejected(server, payload, msg):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, payload)
    assert e.value.code == 400
    assert msg.split()[0] in json.loads(e.value.read())["error"]


def test_shape_mismatch_rejected(server):
    left, _ = _pair()
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"left": _b64_png(left), "right": _b64_png(np.zeros((8, 8, 3), np.uint8))})
    assert e.value.code == 400


def test_null_range_rejected_400(server):
    left, right = _pair()
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"left": _b64_png(left), "right": _b64_png(right), "d_min": None})
    assert e.value.code == 400
    assert "must be integers" in json.loads(e.value.read())["error"]


def test_oversized_body_413(server):
    url = f"http://127.0.0.1:{server.server_address[1]}/disparity"
    req = urllib.request.Request(url, data=b"{}", headers={"Content-Type": "application/json"})
    req.add_unredirected_header("Content-Length", str(1 << 30))
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 413


def test_range_allowlist_403():
    srv = _start(allowed_d_ranges=[(-7, 0), (-3, 0)])
    try:
        left, right = _pair()
        rep = _post(srv, {"left": _b64_png(left), "right": _b64_png(right),
                          "d_min": -3, "d_max": 0})
        assert rep["height"] == 40
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv, {"left": _b64_png(left), "right": _b64_png(right),
                        "d_min": -5, "d_max": 0})
        assert e.value.code == 403
        assert "allowlist" in json.loads(e.value.read())["error"]
    finally:
        _stop(srv)


def test_unknown_path_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}/nope", timeout=60)
    assert e.value.code == 404


def test_cli_serve_flag_validation():
    from stereo_matching_cuda_tpu_torch.cli import main

    assert main(["--serve", "0", "--eval", "--device", "cpu"]) == 2
    assert main(["left.png", "right.png", "--serve", "0", "--device", "cpu"]) == 2


def test_warmup_runs_and_counts_nothing():
    """serve.warmup runs a frame and a batch without a server; the CLI
    flag parses HxW and rejects junk."""
    from stereo_matching_cuda_tpu_torch import cli
    from stereo_matching_cuda_tpu_torch.serve import warmup

    assert warmup(StereoConfig(d_min=-3, d_max=0), 24, 40, max_batch=3, device="cpu") > 0
    args = cli.build_parser().parse_args(["--serve", "0", "--serve-warmup", "288x384"])
    assert args.serve_warmup == "288x384"
    assert cli.main(["--serve", "0", "--serve-warmup", "nonsense", "--device", "cpu"]) == 2


def test_serving_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_server("127.0.0.1", 0, CFG)


def _burst(srv, pairs):
    results = [None] * len(pairs)

    def client(i):
        left, right = pairs[i]
        results[i] = _post(srv, {"left": _b64_png(left), "right": _b64_png(right)})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(pairs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    assert not any(th.is_alive() for th in threads)
    return results


@pytest.mark.parametrize("max_batch", [8, 6, 1])
def test_concurrent_requests_microbatch(max_batch):
    """N concurrent same-shape clients coalesce into groups of up to
    max_batch (not rounded to a power of two): all succeed, and every
    served map equals the single-frame pipeline output exactly."""
    srv = _start(batch_window_s=0.5, max_batch=max_batch)
    try:
        assert srv.executor.max_batch == max_batch
        rng = np.random.default_rng(21)
        pairs = []
        for _ in range(7):
            base = rng.integers(0, 256, (40, 80, 3), dtype=np.uint8)
            pairs.append((base[:, 8:], base[:, :-8]))
        results = _burst(srv, pairs)
        sizes = [r["batched_n"] for r in results]
        assert max(sizes) <= max_batch
        if max_batch > 1:
            assert max(sizes) >= 2, sizes
        for (left, right), rep in zip(pairs, results):
            want = compute_disparity(left, right, CFG, "cpu")["occlusion_filled"]
            np.testing.assert_array_equal(_decode(rep["disparity_pfm"], read_pfm, ".pfm"), want)
    finally:
        _stop(srv)


class _NoShape:
    """A queued item whose frame has no shape: grouping it raises."""
    shape = property(lambda self: 1 / 0)


@pytest.mark.parametrize("bad", ["grouping", "group"])
def test_worker_outlives_a_failure(bad):
    """A request whose grouping raises (outside the group run) and one
    whose group run raises each get the error, and the worker serves the
    next request."""
    ex = BatchExecutor(max_batch=4, device="cpu")
    left, right = _pair()
    if bad == "grouping":
        args = (_NoShape(), right, CFG)
    else:
        args = (left[..., :2], right[..., :2], CFG)   # two channels: grayscale raises
    got = {}

    def submit(name, a):
        got[name] = ex.submit(*a)

    for name, a in (("bad", args), ("good", (left, right, CFG))):
        th = threading.Thread(target=submit, args=(name, a))
        th.start()
        th.join(timeout=120)
        assert not th.is_alive(), f"{name} request never answered"
    assert got["bad"].error is not None and got["bad"].result is None
    assert got["good"].error is None
    np.testing.assert_array_equal(
        got["good"].result["occlusion_filled"],
        compute_disparity(left, right, CFG, "cpu")["occlusion_filled"])
