"""The port's multi-device path (``stereo_matching_cuda_tpu_torch.parallel``)
on the CPU over gloo, against the port's one-device path, the NumPy
oracle and the JAX package's sharded pipeline on the same inputs.

Ranks: this file's ``__main__`` block is the gloo worker.  The module
fixture starts 8 of them as subprocesses (one interpreter each, never
importing JAX), which run every 8-rank mesh in turn on the same synthetic
pairs and write rank 0's maps and every rank's unit checks to a
directory; the parametrised tests read them.  A worker that hangs is
killed at the timeout and fails the tests.  The 1-rank mesh runs in this
process, in a gloo group of its own that is destroyed after it.

Tolerances.  Tiles sum their windows from their own origins, which can
flip exact WTA near-ties (tests/test_sharded.py): at most 2e-3 of the
pixels may differ on disparity_left/right, occlusion and
occlusion_filled; mean_left within 1 on at most 64 pixels
(tests/test_sharded.py:56-59); the frames of a batch identical.  The
shard entry's plain version is held to the JAX per-frame pieces at the
fused fast-path bound: at most max(4, 2e-3 n) label flips, best within
atol 2e-3 / rtol 1e-4.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:       # the worker runs this file as a script
    sys.path.insert(0, REPO)

from stereo_matching_cuda_tpu_torch import DEFAULT_CONFIG, StereoConfig, compute_disparity
from stereo_matching_cuda_tpu_torch.ops import fill_occlusion, rgb_to_grayscale
from stereo_matching_cuda_tpu_torch.ops.fused_guided import (
    guided_wta_fused_local, guided_wta_fused_local_reference)
from stereo_matching_cuda_tpu_torch.parallel import (
    from_host_batches, halo_exchange, initialize, make_mesh, pipeline_halo, pod_mesh,
    sharded_stereo_pipeline)
from stereo_matching_cuda_tpu_torch.parallel import multihost
from stereo_matching_cuda_tpu_torch.parallel.sharded import _segmented_fill, combine_d_ranges
from stereo_matching_cuda_tpu_torch.utils.synth import make_scene

WORLD = 8
# The 8-rank meshes of tests/test_sharded.py, as make_mesh keywords.
MESHES = [dict(y=2, x=4), dict(x=8), dict(b=2, y=2, x=2), dict(y=4, x=2), dict(d=8),
          dict(d=4, x=2), dict(d=2, y=2, x=2), dict(b=2, d=2, x=2)]
MESH_IDS = [",".join(f"{k}={v}" for k, v in kw.items()) for kw in MESHES]
# The two meshes also run through the JAX package's sharded pipeline.
JAX_MESHES = [0, 6]
MAP_KEYS = ("disparity_left", "disparity_right", "occlusion", "occlusion_filled")
WORKER_TIMEOUT_S = 300


def synthetic_pair(h=96, w=320):
    """tests/test_sharded.py's pair: (1, h, w, 3) uint8 ×2, smoothed
    noise, the right a 6-column shift of the left.  Pure noise is full of
    exact WTA ties (the JAX package's own one-device fast path differs
    from its oracle on 4e-3 of the filled map here), so it serves the
    per-tile pieces; the meshes run ``scene_pair``."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, size=(h, w + 32, 3), dtype=np.uint8)
    sm = base.astype(np.float32)
    sm = (sm + np.roll(sm, 1, 1) + np.roll(sm, -1, 1)) / 3
    base = sm.astype(np.uint8)
    return base[:, 16:16 + w][None], base[:, 10:10 + w][None]


def scene_pair(h=96, w=320):
    """A layered synthetic scene (utils/synth.make_scene, 16 disparities):
    (1, h, w, 3) uint8 ×2."""
    sc = make_scene(h, w, ndisp=16, seed=3)
    return sc["left"][None], sc["right"][None]


def batch_of(kw):
    """The global batch a mesh runs: the pair once for each rank along b
    (tests/test_sharded.py)."""
    left, right = scene_pair()
    b = kw.get("b", 1)
    return np.concatenate([left] * b), np.concatenate([right] * b)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path on one intra-op thread, as in the workers: the suite
    runs its files in parallel processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the gloo worker -------------------------------------------------------

def _halo_check(mesh, axis, dim, coord):
    """halo_exchange of a tensor holding each element's global index
    along ``dim``: the halo must hold the neighbours' indices, zeros
    beyond the mesh.  Returns the count of wrong elements."""
    n, size, halo = mesh.size(mesh.mesh_dim_names.index(axis)), 5, 3
    shape = [2, 4, 4]
    shape[dim] = size
    idx = torch.arange(size, dtype=torch.float32) + 1 + coord * size
    view = [1, 1, 1]
    view[dim] = size
    t = idx.reshape(view).expand(shape).contiguous()
    got = halo_exchange(t, halo, mesh, axis, dim)
    want_idx = torch.arange(-halo, size + halo, dtype=torch.float32) + 1 + coord * size
    want_idx[(want_idx < 1) | (want_idx > n * size)] = 0
    view[dim] = size + 2 * halo
    return int((got != want_idx.reshape(view)).sum())


def _raises(fn, match):
    try:
        fn()
    except ValueError as e:
        return match in str(e)
    return False


def _worker(rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    units = {}
    try:
        for i, kw in enumerate(MESHES):
            mesh = make_mesh(**kw, device_type="cpu")
            out = sharded_stereo_pipeline(*batch_of(kw), mesh, DEFAULT_CONFIG)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"mesh{i}.npz"),
                         **{k: v.numpy() for k, v in out.items()})
        mesh = make_mesh(x=8, device_type="cpu")
        units["halo x"] = _halo_check(mesh, "x", 2, mesh.get_local_rank("x"))
        # every row holds occluded runs that cross tile borders, and rows
        # 2-3 hold no valid pixel at all
        rng = np.random.default_rng(3)
        occ = rng.integers(DEFAULT_CONFIG.d_min, 1, (2, 5, 8 * 12)).astype(np.float32)
        occ[rng.random(occ.shape) < 0.6] = DEFAULT_CONFIG.d_occlusion
        occ[:, 2:4] = DEFAULT_CONFIG.d_occlusion
        occ = torch.from_numpy(occ)
        x = mesh.get_local_rank("x")
        mine = _segmented_fill(occ[..., x * 12:(x + 1) * 12].contiguous(), DEFAULT_CONFIG, mesh)
        want = fill_occlusion(occ, DEFAULT_CONFIG.v_min, DEFAULT_CONFIG)[..., x * 12:(x + 1) * 12]
        units["segmented fill"] = int((mine != want).sum())
        left, right = scene_pair(64, 192)
        units["tile smaller than halo"] = _raises(
            lambda: sharded_stereo_pipeline(left, right, mesh, DEFAULT_CONFIG), "halo")
        mesh = make_mesh(y=4, x=2, device_type="cpu")
        units["halo y"] = _halo_check(mesh, "y", 1, mesh.get_local_rank("y"))
        units["world mismatch"] = _raises(lambda: make_mesh(x=4, device_type="cpu"),
                                          "need 4 devices, have 8")
        mesh = make_mesh(d=8, device_type="cpu")
        units["size_d % d"] = _raises(lambda: sharded_stereo_pipeline(
            left, right, mesh, StereoConfig(d_min=-11, d_max=0)), "not divisible by d-axis")
        mesh = pod_mesh(frames_per_host=2, x=2, d=2, device_type="cpu")
        left, right = batch_of(dict(b=2))
        gl, gr = from_host_batches(mesh, np.concatenate([left[:1]] * 2),
                                   np.concatenate([right[:1]] * 2))
        out = sharded_stereo_pipeline(gl, gr, mesh, DEFAULT_CONFIG)
        units["host batches"] = all(torch.equal(v[0], v[1]) for v in out.values())
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"units{rank}.json"), "w") as f:
        json.dump(units, f)


@pytest.fixture(scope="module")
def ranks():
    """Run the 8 gloo workers once; the directory of their results."""
    with tempfile.TemporaryDirectory() as out_dir:
        port = multihost.free_port()
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="1")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                                   str(WORLD), str(port), out_dir],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for r in range(WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            pytest.fail(f"gloo workers did not finish in {WORKER_TIMEOUT_S} s")
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} failed:\n{log}"
        yield out_dir


@pytest.fixture(scope="module")
def unsharded():
    """The port's one-device CPU maps of every batch's frames, by frame
    bytes."""
    frames = {}
    for kw in MESHES:
        for left, right in zip(*batch_of(kw)):
            key = left.tobytes()
            if key not in frames:
                frames[key] = compute_disparity(left, right, DEFAULT_CONFIG, "cpu",
                                                full_outputs=True)
    return frames


def _mesh_maps(ranks, i):
    with np.load(os.path.join(ranks, f"mesh{i}.npz")) as z:
        return {k: z[k] for k in z.files}


def _assert_within(got, want, what):
    n = want["disparity_left"].size
    for key in MAP_KEYS:
        mism = int((got[key] != want[key]).sum())
        assert mism <= 2e-3 * n, f"{what} {key}: {mism}/{n} mismatches"


def _assert_mean(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d != 0).sum() <= 64


@pytest.mark.parametrize("i", range(len(MESHES)), ids=MESH_IDS)
def test_mesh_matches_unsharded(ranks, unsharded, i):
    out = _mesh_maps(ranks, i)
    left, _ = batch_of(MESHES[i])
    assert out["disparity_left"].shape == left.shape[:3]
    assert out["mean_left"].dtype == np.uint8
    for f, frame in enumerate(left):
        want = unsharded[frame.tobytes()]
        _assert_within({k: v[f] for k, v in out.items()}, want, MESH_IDS[i])
        _assert_mean(out["mean_left"][f], want["mean_left"])
        np.testing.assert_allclose(out["best_cost_left"][f], want["best_cost_left"],
                                   atol=2e-3, rtol=1e-4)


@pytest.mark.parametrize("i", range(len(MESHES)), ids=MESH_IDS)
def test_mesh_matches_numpy_oracle(ranks, i):
    from stereo_matching_cuda_tpu import reference as R
    from stereo_matching_cuda_tpu.config import DEFAULT_CONFIG as JAX_CFG

    out = _mesh_maps(ranks, i)
    for f, (left, right) in enumerate(zip(*batch_of(MESHES[i]))):
        oracle = R.run_pipeline(left, right, JAX_CFG)
        _assert_within({k: v[f] for k, v in out.items()}, oracle, MESH_IDS[i])
        _assert_mean(out["mean_left"][f], oracle["mean_left"])


@pytest.mark.parametrize("i", JAX_MESHES, ids=[MESH_IDS[i] for i in JAX_MESHES])
def test_mesh_matches_jax_sharded(ranks, i):
    """The JAX package's sharded pipeline on the 8 virtual CPU devices of
    tests/conftest.py, on the same mesh and inputs."""
    import jax

    from stereo_matching_cuda_tpu.config import DEFAULT_CONFIG as JAX_CFG
    from stereo_matching_cuda_tpu.parallel import make_mesh as jax_make_mesh
    from stereo_matching_cuda_tpu.parallel import sharded_stereo_pipeline as jax_sharded

    if len(jax.devices()) < WORLD:
        pytest.skip("needs 8 JAX devices")
    left, right = batch_of(MESHES[i])
    theirs = {k: np.asarray(v) for k, v in
              jax_sharded(left, right, jax_make_mesh(**MESHES[i]), JAX_CFG).items()}
    out = _mesh_maps(ranks, i)
    for f in range(left.shape[0]):
        _assert_within({k: v[f] for k, v in out.items()}, {k: v[f] for k, v in theirs.items()},
                       MESH_IDS[i])
        _assert_mean(out["mean_left"][f], theirs["mean_left"][f])


@pytest.mark.parametrize("i", [i for i, kw in enumerate(MESHES) if kw.get("b", 1) > 1],
                         ids=[MESH_IDS[i] for i, kw in enumerate(MESHES) if kw.get("b", 1) > 1])
def test_mesh_batch_frames_identical(ranks, i):
    """The same frame on two ranks along b gives the same maps, bit for
    bit."""
    out = _mesh_maps(ranks, i)
    for k, v in out.items():
        np.testing.assert_array_equal(v[0], v[1], err_msg=k)


UNITS = ["halo x", "halo y", "segmented fill", "tile smaller than halo", "world mismatch",
         "size_d % d", "host batches"]


@pytest.mark.parametrize("name", UNITS)
def test_worker_units(ranks, name):
    """Checks the workers made on every rank: halo_exchange strips and
    zeros (x over 8 ranks, y over 4), the cross-tile fill against
    fill_occlusion on whole rows, the refusals, and from_host_batches on a
    pod_mesh (two equal frames give equal maps)."""
    for r in range(WORLD):
        with open(os.path.join(ranks, f"units{r}.json")) as f:
            got = json.load(f)[name]
        assert got in (0, True) and got is not False, f"rank {r}: {name} -> {got}"


# --- one rank, in this process --------------------------------------------

@pytest.fixture
def one_rank():
    """A 1-rank gloo group, destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{multihost.free_port()}",
                            world_size=1, rank=0)
    try:
        yield make_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("pair", [scene_pair, synthetic_pair])
def test_single_rank_mesh_equals_unsharded(one_rank, pair):
    """At (1,1,1) the tile is the frame with a zero halo: the same window
    sums, so the same bits even on the noise pair."""
    left, right = pair()
    out = {k: v.numpy() for k, v in sharded_stereo_pipeline(left, right, one_rank).items()}
    want = compute_disparity(left[0], right[0], DEFAULT_CONFIG, "cpu", full_outputs=True)
    _assert_within({k: v[0] for k, v in out.items()}, want, "1,1,1")
    for k in (*MAP_KEYS, "mean_left", "best_cost_left"):
        np.testing.assert_array_equal(out[k][0], want[k], err_msg=k)


def test_single_rank_refuses_exact_integral(one_rank):
    left, right = scene_pair(64, 192)
    with pytest.raises(ValueError, match="exact_integral"):
        sharded_stereo_pipeline(left, right, one_rank,
                                dataclasses.replace(DEFAULT_CONFIG, exact_integral=True))


def test_halo_exchange_one_rank_pads_zeros(one_rank):
    t = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) + 1
    got = halo_exchange(t, 2, one_rank, "x", dim=2)
    assert got.shape == (2, 3, 8) and torch.equal(got[..., 2:6], t)
    assert not got[..., :2].any() and not got[..., 6:].any()
    assert halo_exchange(t, 0, one_rank, "x", dim=2) is t
    with pytest.raises(ValueError, match="smaller than halo"):
        halo_exchange(t, 5, one_rank, "x", dim=2)


def test_make_mesh_needs_the_world():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="need 1 devices, have 0"):
        make_mesh(device_type="cpu")


def test_combine_d_ranges_ties_go_to_the_larger_d():
    bests = [torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.0, 1.5, 4.0]),
             torch.tensor([1.0, 2.5, 3.0])]
    dmaps = [torch.tensor([0.0, 0.0, 0.0]), torch.tensor([1.0, 1.0, 1.0]),
             torch.tensor([2.0, 2.0, 2.0])]
    best, dmap = combine_d_ranges(bests, dmaps)
    assert best.tolist() == [1.0, 1.5, 3.0] and dmap.tolist() == [2.0, 1.0, 2.0]


def test_segmented_fill_whole_rows_equals_fill_occlusion(one_rank):
    rng = np.random.default_rng(11)
    occ = rng.integers(-15, 1, (3, 7, 40)).astype(np.float32)
    occ[rng.random(occ.shape) < 0.5] = DEFAULT_CONFIG.d_occlusion
    occ[:, 3] = DEFAULT_CONFIG.d_occlusion
    occ = torch.from_numpy(occ)
    assert torch.equal(_segmented_fill(occ, DEFAULT_CONFIG, one_rank),
                       fill_occlusion(occ, DEFAULT_CONFIG.v_min, DEFAULT_CONFIG))


@pytest.mark.parametrize("kw", [{}, {"radius": 4, "d_min": -40, "d_max": 3}])
def test_pipeline_halo_equals_jax(kw):
    from stereo_matching_cuda_tpu.config import StereoConfig as JaxConfig
    from stereo_matching_cuda_tpu.parallel import pipeline_halo as jax_pipeline_halo

    assert pipeline_halo(StereoConfig(**kw)) == jax_pipeline_halo(JaxConfig(**kw))
    if not kw:
        assert pipeline_halo(DEFAULT_CONFIG) == (20, 36)


def test_initialize_one_process_is_a_noop():
    initialize(num_processes=1)
    assert not dist.is_initialized()


def test_initialize_explicit_args_propagate_errors():
    """With explicit arguments a failed init raises; nothing is swallowed
    (the JAX package's tests/test_multiprocess.py:75-85 checks the same)."""
    src = inspect.getsource(multihost.initialize)
    assert "except Exception" not in src


# --- the shard entry's plain version against the JAX per-frame pieces -----

GLOBAL_HW = (96, 320)
TILE_HW = (32, 96)


def _extended(gray, oy, ox, hy, hx, th, tw):
    """The (th + 2hy, tw + 2hx) tile of ``gray`` around the interior at
    (oy, ox), zeros beyond the image."""
    padded = np.pad(gray, ((hy, hy), (hx, hx)))
    return np.ascontiguousarray(padded[oy:oy + th + 2 * hy, ox:ox + tw + 2 * hx])


def _jax_local(g1e, g2e, oy, ox, dmin, n, hy, hx, dyn):
    """stereo_matching_cuda_tpu/parallel/sharded.py's per-frame path on
    one extended tile (the XLA path of its local_fn)."""
    import jax.numpy as jnp

    from stereo_matching_cuda_tpu.config import DEFAULT_CONFIG as JAX_CFG
    from stereo_matching_cuda_tpu.ops.guided import _chunk_wta
    from stereo_matching_cuda_tpu.parallel import sharded as S

    (H, W), (th, tw) = GLOBAL_HW, TILE_HW
    gy = oy - hy + jnp.arange(th + 2 * hy, dtype=jnp.int32)
    gx = ox - hx + jnp.arange(tw + 2 * hx, dtype=jnp.int32)
    in_image = ((gy >= 0) & (gy < H))[:, None] & ((gx >= 0) & (gx < W))[None, :]
    area = S._global_area(gy, gx, H, W, JAX_CFG.radius)
    g1, g2 = jnp.asarray(g1e), jnp.asarray(g2e)
    der1 = S._x_derivative_global(g1, gx, W)
    der2 = S._x_derivative_global(g2, gx, W)
    if dyn:
        cost = S._local_cost_volume_dyn(g1, der1, g2, der2, gx, jnp.int32(dmin), n,
                                        JAX_CFG.shift_max, W, JAX_CFG, in_image)
    else:
        cost = S._local_cost_volume(g1, der1, g2, der2, gx, dmin, n, W, JAX_CFG, in_image)
    q, _ = S._local_guided_wta(g1, cost, area, in_image, JAX_CFG)
    best, sidx = _chunk_wta(q[:, hy:hy + th, hx:hx + tw])
    return np.asarray(best), np.asarray(dmin + sidx).astype(np.float32)


@pytest.mark.parametrize("oy,ox,view,n_slices", [
    (0, 0, "left", None), (0, 224, "right", None), (64, 0, "left", None),
    (64, 224, "left", None), (32, 112, "left", None), (0, 112, "right", None),
    (32, 224, "left", 8), (64, 96, "right", 8)],
    ids=["corner-tl", "corner-tr", "corner-bl", "corner-br", "inside", "edge-top",
         "edge-right-d8", "edge-bottom-d8"])
def test_local_reference_matches_jax_pieces(oy, ox, view, n_slices):
    left, right = synthetic_pair(*GLOBAL_HW)
    g = [rgb_to_grayscale(torch.from_numpy(v[0])).numpy() for v in (left, right)]
    hy, hx = pipeline_halo(DEFAULT_CONFIG)
    (th, tw), (H, W) = TILE_HW, GLOBAL_HW
    g1, g2 = (_extended(v, oy, ox, hy, hx, th, tw) for v in g)
    dmin = DEFAULT_CONFIG.d_min
    if view == "right":
        g1, g2, dmin = g2, g1, DEFAULT_CONFIG.d_min_right
    n = n_slices or DEFAULT_CONFIG.size_d
    if n_slices:                   # the second of two disparity ranges
        dmin += n
    best, dmap = guided_wta_fused_local_reference(
        torch.from_numpy(g1), torch.from_numpy(g2), oy, ox, dmin, DEFAULT_CONFIG, H, W, th, tw,
        n_slices=n_slices)
    best_j, dmap_j = _jax_local(g1, g2, oy, ox, dmin, n, hy, hx, dyn=bool(n_slices))
    mism = int((dmap.numpy() != dmap_j).sum())
    assert mism <= max(4, 2e-3 * th * tw), mism
    np.testing.assert_allclose(best.numpy(), best_j, atol=2e-3, rtol=1e-4)
    # the entry runs the plain version on CPU tensors, a batch frame by frame
    b2, d2 = guided_wta_fused_local(torch.from_numpy(np.stack([g1, g1])),
                                    torch.from_numpy(np.stack([g2, g2])), oy, ox, dmin,
                                    DEFAULT_CONFIG, H, W, th, tw, n_slices=n_slices)
    assert torch.equal(b2[1], best) and torch.equal(d2[0], dmap)


def test_local_entry_refuses_a_short_halo_and_other_devices():
    hy, hx = pipeline_halo(DEFAULT_CONFIG)
    g = torch.zeros((32 + 2 * hy, 96 + 2 * hx), dtype=torch.uint8)
    # a tile inside the image needs 2R + 1 + max|d| = 34 columns of halo
    short = torch.zeros((32 + 2 * hy, 96 + 2 * 30), dtype=torch.uint8)
    with pytest.raises(ValueError, match="short"):
        guided_wta_fused_local(short, short, 32, 112, -15, DEFAULT_CONFIG, 96, 320, 32, 96)
    # at the image's corner the missing columns are beyond the image
    guided_wta_fused_local(short[:, :96 + 60], short[:, :96 + 60], 0, 0, -15,
                           DEFAULT_CONFIG, 32, 96, 32, 96)
    meta = g.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        guided_wta_fused_local(meta, meta, 32, 112, -15, DEFAULT_CONFIG, 96, 320, 32, 96)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
