"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU, ``nvcc`` and
``nvidia-smi``.  It builds the hand-written kernels from ``csrc/`` and
checks each against its plain PyTorch version on the card: the
single-view kernels K3 (tiled) and K1 (row walk), the dual-view kernels
K4 and K5 and the post kernel K2, on textured pairs and on the frames of
every path, and their B=3 batches against per-frame launches.  It then
drives the kernel paths of the port's entry points with their launch
counts asserted: ``compute_disparity`` on the default path (K3 + K2) of a
288x384 and a 1992x3008 (6 MP) scene, with ``stream=True`` (K1 + K2), on
the wide-range frames (288x384 at 64 disparities, 1988x2948 at 128:
K3 + K2), on the dual-view path (``dual_view=True`` and the automatic
rule at 8 disparities: K4 at 288x384, K5 at 6 MP, + K2),
``stereo_pipeline_batch`` on eight 288x384 frames (one K3 per view and
one K2 for the batch) and the box matcher (K2 only).  The shard entry
``guided_wta_fused_local`` runs K3 and K1 on the 6 MP frame cut into
extended tiles as a mesh would cut it (x into 2, a 2x2 grid, the 16
disparities into 2x8), each tile held to its plain version and the
stitched maps to the whole frame's (bit for bit where the CTAs cover the
same pixels).  The sharded path runs ``sharded_stereo_pipeline`` over
NCCL, one rank per card (this process is rank 0; the others are
spawned), on a (1, 1, world) mesh at 288x384 and 6 MP.  Then the user's
entries, each with its launch counts asserted: the CLI
(``cli.main`` in this process on PNG pairs at 288x384 and 6 MP, with
``--profile``, at 6 MP on the dual route and with ``--mesh 1,1,1``: its
PNGs equal to ``compute_disparity``'s, bit for bit), ``--eval`` on the committed
synthetic-GT scenes (bad-2.0 against the JAX package's recorded scores)
and the HTTP server (bursts of eight concurrent 288x384 requests and one
6 MP request, each response equal to a lone frame, micro-batching seen).
Then the port's benchmark, ``bench.run`` at the JAX bench's sizes and
counts in this process: each row's launches its route's, its first frame
held to the plain path, its JSON line printed as ``bench {...}``, its
6 MP frame within 15% of the ``timing`` line's.  Then the benchmark's
cells (``BENCHMARK.json``), each once at its full size on the runner's
own inputs, launches asserted, held to the benchmark's correctness check
against its own float64 reference (``benchmark/check.py``), and the
check's controls (that reference with a known fault) refused.  It holds
every path's outputs to the plain path's, times kernels, paths and plain versions
with CUDA events once steady (``timing.steady_ms``; the sharded frame,
whose ranks must make the same calls, after a fixed warm-up), splits
each path's device time by kernel and reads the device's idle share with torch.profiler, and prints
two JSON lines last: the per-kernel record (with each kernel's bound),
then ``{"ok": true, "device": ...}``.  Any failure raises and exits
non-zero; with no CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from benchmark import run as benchmark_run
from benchmark.roofline import bound
from stereo_matching_cuda_tpu_torch import (
    DEFAULT_CONFIG, BoxStereoMatcher, StereoConfig, bench, cli, compute_disparity, profiling,
    stereo_pipeline_batch)
from stereo_matching_cuda_tpu_torch.metrics import bad_pixel_rate
from stereo_matching_cuda_tpu_torch.models import box_stereo_pipeline
from stereo_matching_cuda_tpu_torch.ops import _kernels, rgb_to_grayscale
from stereo_matching_cuda_tpu_torch.ops.fused_guided import (
    guided_wta_fused, guided_wta_fused_dual, guided_wta_fused_dual_reference,
    guided_wta_fused_local, guided_wta_fused_local_reference, guided_wta_fused_reference)
from stereo_matching_cuda_tpu_torch.ops.fused_post import lr_fill_fused, lr_fill_reference
from stereo_matching_cuda_tpu_torch.parallel import (
    make_mesh, pipeline_halo, sharded_stereo_pipeline)
from stereo_matching_cuda_tpu_torch.parallel.multihost import free_port
from stereo_matching_cuda_tpu_torch.parallel.sharded import combine_d_ranges
from stereo_matching_cuda_tpu_torch.pipeline import stereo_pipeline
from stereo_matching_cuda_tpu_torch.profiling import COUNT_NAMES, launch_counts, profile_path
from stereo_matching_cuda_tpu_torch.serve import make_server
from stereo_matching_cuda_tpu_torch.timing import cuda_ms, steady_ms, window_ms
from stereo_matching_cuda_tpu_torch.utils.io import (
    native_available, read_png, write_mat_normalize, write_png)
from stereo_matching_cuda_tpu_torch.utils.pnm import read_pfm
from stereo_matching_cuda_tpu_torch.utils.synth import make_scene

DEV = "cuda"
PLAIN = dataclasses.replace(DEFAULT_CONFIG, fused=False, post_fused=False)
CFG64 = StereoConfig(d_min=-63, d_max=0)
CFG128 = StereoConfig(d_min=-127, d_max=0)       # the bench.py:193 wide range
CFG8 = StereoConfig(d_min=-7, d_max=0)           # 8 disparities: the auto dual route
STRADDLE = StereoConfig(d_min=-8, d_max=8)
DUAL16 = dataclasses.replace(DEFAULT_CONFIG, dual_view=True)
STREAM16 = dataclasses.replace(DEFAULT_CONFIG, stream=True)
STREAM8 = dataclasses.replace(CFG8, stream=True)
REPO = os.path.dirname(os.path.abspath(__file__))
# bad-2.0 (%) of the JAX package's --eval on tests/data/synthgt, as the
# repository's verification notes record them.
SYNTHGT_BAD2 = {"scene0": 0.567, "scene1_wide": 2.34}
# The matching kernels' bound: the fused fast-path class of the JAX
# kernels (tests/test_pallas_fused.py:55-57) — near-tie label flips only.
K1_ATOL, K1_RTOL = 2e-3, 1e-4
# Slices per chunk of the plain version above 32 disparities: unchunked,
# its float64 box sums over a (128, H, W) volume take tens of GB.  The
# chunked scan keeps the ascending tie rule (tests/test_models.py:64 pins
# chunked = unchunked), so the results are the same.
PLAIN_CHUNK = 16

def k1_max_mismatch(n: int) -> int:
    return max(4, int(2e-3 * n))


def chunked(cfg):
    """``cfg`` with its plain version's slices chunked (PLAIN_CHUNK)."""
    return dataclasses.replace(cfg, d_chunk=PLAIN_CHUNK) if cfg.size_d > 2 * PLAIN_CHUNK else cfg


def textured_pair(h, w, seed):
    """Smoothed random gray pair, the right a 6-column shift of the left."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(h, w + 32)).astype(np.float32)
    base = ((base + np.roll(base, 1, 1) + np.roll(base, -1, 1)
             + np.roll(base, 1, 0)) / 4).astype(np.uint8)
    return (torch.from_numpy(np.ascontiguousarray(base[:, 16:16 + w])).to(DEV),
            torch.from_numpy(np.ascontiguousarray(base[:, 10:10 + w])).to(DEV))


def check_single(grays):
    """K3 (stream=False) and K1 (stream=True) against
    guided_wta_fused_reference on the card: textured pairs at 16 and 64
    disparities and straddling zero, and both views of each scene frame
    (``grays``: name -> (cfg, gray pair)); then B=3 batches against
    per-frame launches, bit for bit.  Returns each kernel's max |Δbest|
    and its (cfg, dmap_l, dmap_r) of every scene frame for K2."""
    cases = [("textured", (288, 384), -15, DEFAULT_CONFIG),
             ("textured", (288, 384), 0, DEFAULT_CONFIG),
             ("textured", (33, 130), -15, DEFAULT_CONFIG),
             ("textured", (33, 130), 0, DEFAULT_CONFIG),
             ("textured", (200, 400), -63, CFG64),
             ("textured", (64, 160), -8, STRADDLE)]
    for name, (cfg, _) in grays.items():
        cases += [(name, None, cfg.d_min, cfg), (name, None, cfg.d_min_right, cfg)]
    worst = {"K1": 0.0, "K3": 0.0}
    maps = {kernel: {name: {} for name in grays} for kernel in worst}
    for name, shape, dmin, cfg in cases:
        g1, g2 = grays[name][1] if shape is None else textured_pair(*shape, seed=sum(shape))
        if dmin == cfg.d_min_right != cfg.d_min:
            g1, g2 = g2, g1
        h, w = g1.shape
        best_p, dmap_p = guided_wta_fused_reference(g1, g2, dmin, chunked(cfg))
        for kernel, stream in (("K3", False), ("K1", True)):
            best, dmap = guided_wta_fused(g1, g2, dmin, dataclasses.replace(cfg, stream=stream))
            torch.cuda.synchronize()
            mism = int((dmap != dmap_p).sum())
            err = float((best - best_p).abs().max())
            print(f"{kernel} {name} {h}x{w} dmin={dmin} D={cfg.size_d}: {mism} label "
                  f"mismatches (bound {k1_max_mismatch(h * w)}), max |best-plain| {err:.3g}")
            assert mism <= k1_max_mismatch(h * w), f"{kernel} disagrees with its plain version"
            torch.testing.assert_close(best, best_p, atol=K1_ATOL, rtol=K1_RTOL)
            worst[kernel] = max(worst[kernel], err)
            if shape is None:
                maps[kernel][name][dmin] = dmap
        del best_p, dmap_p
    pairs = [textured_pair(96, 200, seed=s) for s in (1, 2, 3)]
    for kernel, stream in (("K3", False), ("K1", True)):
        cfg = dataclasses.replace(DEFAULT_CONFIG, stream=stream)
        batch = guided_wta_fused(torch.stack([p[0] for p in pairs]),
                                 torch.stack([p[1] for p in pairs]), cfg.d_min, cfg)
        for i, (g1, g2) in enumerate(pairs):
            for j, t in enumerate(guided_wta_fused(g1, g2, cfg.d_min, cfg)):
                assert torch.equal(batch[j][i], t), f"{kernel} batch frame {i} output {j}"
        print(f"{kernel} B=3 batch of 96x200: equal to per-frame launches, bit for bit")
    return worst, {kernel: [(grays[name][0], m[grays[name][0].d_min],
                             m[grays[name][0].d_min_right]) for name, m in by_name.items()]
                   for kernel, by_name in maps.items()}


def extend(g, oy, ox, th, tw, hy, hx):
    """The (th + 2hy, tw + 2hx) tile of an (H, W) image around the interior
    at (oy, ox), zeros beyond the image: what the halo exchanges give a
    rank."""
    padded = torch.nn.functional.pad(g, (hx, hx, hy, hy))
    return padded[oy:oy + th + 2 * hy, ox:ox + tw + 2 * hx].contiguous()


def check_shard_entry(cfg, gl, gr):
    """K3 and K1 through the shard entry ``guided_wta_fused_local`` on the
    frame (``gl``, ``gr``) cut into extended tiles as a mesh cuts it: x
    into 2, a 2x2 grid, and the disparities into 2 ranges of 8 (the whole
    frame as the tile), both views.  Each tile is held to
    guided_wta_fused_local_reference at the fused bound; the stitched maps
    to the whole-frame launch of the same kernel: K3 bit for bit on the x
    split (at column 1,504, a multiple of 8: its runs start where the
    whole frame's start, whatever the tile) and on the d split
    (combined with the ascending rule), within the bound on the grid
    (off K3's row grid) and for K1 (bands picked per tile).  Launch
    counts asserted.  Returns each kernel's max |best - plain|."""
    h, w = gl.shape
    hy, hx = pipeline_halo(cfg)
    d_half = cfg.size_d // 2
    cuts = {"x split into 2": [(0, x, h, w // 2, 0, None) for x in (0, w // 2)],
            "2x2 grid": [(y, x, h // 2, w // 2, 0, None) for y in (0, h // 2)
                         for x in (0, w // 2)],
            f"d split into 2x{d_half}": [(0, 0, h, w, k * d_half, d_half) for k in (0, 1)]}
    kernels = {"K3": dataclasses.replace(cfg, stream=False),
               "K1": dataclasses.replace(cfg, stream=True)}
    worst = {kernel: 0.0 for kernel in kernels}
    bound = k1_max_mismatch(h * w)
    reset_counts()
    for view, (g1, g2, dmin) in {"left": (gl, gr, cfg.d_min),
                                 "right": (gr, gl, cfg.d_min_right)}.items():
        whole = {kernel: guided_wta_fused(g1, g2, dmin, c) for kernel, c in kernels.items()}
        for cut, tiles in cuts.items():
            parts = {kernel: [] for kernel in kernels}
            for oy, ox, th, tw, dk, n in tiles:
                e1, e2 = extend(g1, oy, ox, th, tw, hy, hx), extend(g2, oy, ox, th, tw, hy, hx)
                args = (oy, ox, dmin + dk, cfg, h, w, th, tw, n)
                best_p, dmap_p = guided_wta_fused_local_reference(e1, e2, *args)
                for kernel, c in kernels.items():
                    best, dmap = guided_wta_fused_local(e1, e2, oy, ox, dmin + dk, c, h, w,
                                                        th, tw, n)
                    torch.cuda.synchronize()
                    mism = int((dmap != dmap_p).sum())
                    assert mism <= k1_max_mismatch(th * tw), \
                        f"shard entry {kernel} {view} {cut} tile ({oy}, {ox}): {mism} flips"
                    torch.testing.assert_close(best, best_p, atol=K1_ATOL, rtol=K1_RTOL)
                    worst[kernel] = max(worst[kernel], float((best - best_p).abs().max()))
                    parts[kernel].append((best, dmap))
                del best_p, dmap_p
            for kernel, outs in parts.items():
                if cut.startswith("d split"):
                    best, dmap = combine_d_ranges(*zip(*outs))
                else:
                    best, dmap = torch.empty_like(whole[kernel][0]), torch.empty_like(whole[kernel][1])
                    for (oy, ox, th, tw, _, _), (b, m) in zip(tiles, outs):
                        best[oy:oy + th, ox:ox + tw] = b
                        dmap[oy:oy + th, ox:ox + tw] = m
                mism = int((dmap != whole[kernel][1]).sum())
                exact = kernel == "K3" and cut != "2x2 grid"
                print(f"shard entry {kernel} {view} {h}x{w} {cut}: stitched maps against the "
                      f"whole-frame launch: {mism} label mismatches, max |best| difference "
                      f"{float((best - whole[kernel][0]).abs().max()):.3g} "
                      f"({'must be 0' if exact else f'bound {bound}'})")
                if exact:
                    assert torch.equal(best, whole[kernel][0]) and torch.equal(dmap, whole[kernel][1]), \
                        f"shard entry {kernel} {view} {cut}: not the whole frame's bits"
                else:
                    assert mism <= bound, f"shard entry {kernel} {view} {cut}: {mism} flips"
                    torch.testing.assert_close(best, whole[kernel][0], atol=K1_ATOL, rtol=K1_RTOL)
    tiles = sum(len(t) for t in cuts.values())
    got = counts()
    want = (2 * (1 + tiles), 0, 2 * (1 + tiles), 0, 0)
    print(f"shard entry: launches (K1, K2, K3, K4, K5) {got}, expected {want}")
    assert got == want, "shard entry launch counts"
    return worst


def sharded_runs(mesh, scenes, world):
    """The sharded path's calls, the same on every rank: (name, call,
    expected launches in this process) of sharded_stereo_pipeline on each
    scene's global (1, H, W, 3) batch, default (K3) and stream=True (K1);
    K2 runs where x is not split (world 1)."""
    runs = []
    for name, sc in scenes.items():
        batch = (sc["left"][None], sc["right"][None])
        for label, cfg, kernel in (("default", DEFAULT_CONFIG, "k3"), ("stream=True", STREAM16, "k1")):
            runs.append((f"{name} {label}",
                         lambda b=batch, c=cfg: sharded_stereo_pipeline(*b, mesh, c),
                         launches(**{kernel: 2, "k2": 1 if world == 1 else 0})))
    return runs


def run_sharded(scenes, world, lead, iters):
    """The sharded path on a (1, 1, world) mesh, called by every rank of
    an initialized NCCL group; ``lead`` (rank 0) asserts the launch counts
    and times, the others make the same collective calls.  Returns (the
    calls' outputs, their counts, the timings) on rank 0."""
    mesh = make_mesh(1, 1, world)
    runs = sharded_runs(mesh, scenes, world)
    if lead:
        outs, total = drive_path(f"sharded path (NCCL, world size {world})", runs)
    else:
        outs, total = [call() for _, call, _ in runs], None
    left, right = on_card(scenes["1992x3008"])

    def frame():
        return sharded_stereo_pipeline(left[None], right[None], mesh, DEFAULT_CONFIG)

    # Every rank makes the same collective calls, so the sharded frame gets
    # a fixed warm-up: steady_ms's window count could differ by rank.
    for _ in range(3):
        frame()
    t = {"sharded_frame_ms": window_ms(frame, iters)}
    if lead:
        t["frame_ms"] = cuda_ms(lambda: stereo_pipeline(left, right, DEFAULT_CONFIG), iters)
    top_kernels(f"sharded 1992x3008 (1,1,{world}) frame", frame, iters)
    return outs, total, t


def top_kernels(name, call, frames, warmup=3, n=12):
    """The ``n`` device functions that take the most time per call of
    ``call``, from torch.profiler over ``frames`` calls after warm-up
    (where the sharded frame's time goes beyond the kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            call()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    total = sum(by_name.values())
    print(f"top kernels {name}: device busy {total / frames / 1e3:.4f} ms/call; " + "; ".join(
        f"{k[:70]} {v / frames / 1e3:.4f}" for k, v in
        sorted(by_name.items(), key=lambda kv: -kv[1])[:n]))


def sharded_rank(i, world, port, iters):
    """Rank i + 1 of the sharded path, on card i + 1 (spawned)."""
    torch.cuda.set_device(i + 1)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=i + 1)
    try:
        scenes = {name: make_scene(*hw, ndisp=16) for name, hw in
                  (("288x384", (288, 384)), ("1992x3008", (1992, 3008)))}
        run_sharded(scenes, world, False, iters)
    finally:
        dist.destroy_process_group()


def drive_sharded(scenes, iters=10):
    """The sharded path over NCCL with one rank per card: this process is
    rank 0 on card 0, the others are spawned.  At world size 1 the four
    maps equal compute_disparity's bit for bit (origin 0: the same CTAs;
    whole rows: K2); above it they are held within 2e-3 of the pixels.
    Returns the path's counts and timings."""
    world = torch.cuda.device_count()
    port = free_port()
    print(f"sharded path: NCCL, one rank per card, world size {world}")
    ctx = (mp.start_processes(sharded_rank, args=(world, port, iters), nprocs=world - 1,
                              join=False, start_method="spawn") if world > 1 else None)
    try:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=0)
        try:
            outs, total, t = run_sharded(scenes, world, True, iters)
        finally:
            dist.destroy_process_group()
        if ctx is not None:
            deadline = time.monotonic() + 600
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise AssertionError("a sharded rank did not finish in 600 s")
    finally:
        if ctx is not None:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
    keys = ("disparity_left", "disparity_right", "occlusion", "occlusion_filled")
    for (name, _, _), out in zip(sharded_runs(None, scenes, world), outs):
        sc = scenes[name.split()[0]]
        cfg = STREAM16 if "stream" in name else DEFAULT_CONFIG
        want = compute_disparity(sc["left"], sc["right"], cfg, DEV)
        n = want["disparity_left"].size
        mism = {k: int((out[k][0].cpu().numpy() != want[k]).sum()) for k in keys}
        print(f"sharded {name}: mismatches against compute_disparity {mism} "
              f"({'must be 0' if world == 1 else f'bound {int(2e-3 * n)}'})")
        for k in keys:
            assert mism[k] == 0 if world == 1 else mism[k] <= 2e-3 * n, (name, k, mism[k])
        assert out["mean_left"].dtype == torch.uint8 and out["best_cost_left"].isfinite().all()
    print(f"timing sharded 1992x3008 (1,1,{world}): " + ", ".join(
        f"{k} {v:.4f}" for k, v in t.items())
        + f"; sharded/frame {t['sharded_frame_ms'] / t['frame_ms']:.4f}")
    return total, t


def drive_cli_mesh(tmp, sc):
    """``--mesh 1,1,1`` at 6 MP on the PNG pair drive_cli wrote: the CLI
    forms its own one-rank NCCL group (2 K3 + 1 K2); its four PNGs equal
    write_mat_normalize of compute_disparity on the card, bit for bit."""
    d = os.path.join(tmp, "1992x3008")
    out_dir = os.path.join(d, "mesh")
    ((stdout, _, wall),), total = drive_path("cli --mesh path", [(
        "--mesh 1,1,1 1992x3008",
        lambda: run_cli([os.path.join(d, "left.png"), os.path.join(d, "right.png"), "-o",
                         out_dir, "--json", "--mesh", "1,1,1"]),
        launches(k3=2, k2=1))])
    assert not dist.is_initialized(), "the CLI left its process group open"
    want = compute_disparity(sc["left"], sc["right"], DEFAULT_CONFIG, DEV)
    for png, key in (("disparity_mapl.png", "disparity_left"),
                     ("disparity_mapr.png", "disparity_right"),
                     ("occlu_mapl.png", "occlusion"),
                     ("occlu_mapl_filled.png", "occlusion_filled")):
        assert np.array_equal(read_png(os.path.join(out_dir, png)),
                              write_mat_normalize(want[key])), f"cli --mesh: {png}"
    stats = json.loads(stdout.splitlines()[-1])
    print(f"cli --mesh 1,1,1 1992x3008: wall {wall:.4f} s incl. PNG I/O and the group's "
          f"set-up, pipeline {stats['seconds']} s; 4 PNGs equal to compute_disparity on the "
          f"card")
    return total


def label_maps(cfg, h, w, seed):
    rng = np.random.default_rng(seed)
    dl = rng.integers(cfg.d_min, cfg.d_max + 1, size=(h, w)).astype(np.float32)
    dr = rng.integers(-cfg.d_max, -cfg.d_min + 1, size=(h, w)).astype(np.float32)
    return torch.from_numpy(dl).to(DEV), torch.from_numpy(dr).to(DEV)


def check_k2(kernel_maps):
    """K2 against lr_fill_reference on the card: bit-identical on random
    label maps and on the label maps every matching kernel gave each
    scene frame (``kernel_maps``: list of (cfg, left, right)), and a B=3
    batch equal to per-frame launches; returns the largest |difference|
    seen (0.0 when it holds)."""
    cfg128 = StereoConfig(d_min=-127, d_max=0)
    cases = [(DEFAULT_CONFIG, *label_maps(DEFAULT_CONFIG, 288, 384, 0)),
             (cfg128, *label_maps(cfg128, 40, 300, 1))]
    dl, dr = label_maps(DEFAULT_CONFIG, 24, 256, 2)
    dr[3:6] = -DEFAULT_CONFIG.d_min + 50      # rows with no LR-consistent pixel
    cases.append((DEFAULT_CONFIG, dl, dr))
    # a width that is not a multiple of 4 (rows at every alignment), and
    # the same maps 4 bytes past a 16-byte boundary (K2's one-float path)
    dl, dr = label_maps(DEFAULT_CONFIG, 7, 383, 6)
    cases.append((DEFAULT_CONFIG, dl, dr))
    cases.append((DEFAULT_CONFIG, *(torch.cat([m.new_zeros(1), m.reshape(-1)])[1:].view(m.shape)
                                    for m in (dl, dr))))
    cases += kernel_maps
    worst = 0.0
    for cfg, dl, dr in cases:
        occ, filled = lr_fill_fused(dl, dr, cfg)
        occ_p, filled_p = lr_fill_reference(dl, dr, cfg)
        torch.cuda.synchronize()
        n_occ = int((occ != occ_p).sum())
        n_fill = int((filled != filled_p).sum())
        print(f"K2 {tuple(dl.shape)} D={cfg.size_d}: {n_occ} occlusion and "
              f"{n_fill} fill mismatches (must be 0)")
        assert n_occ == 0 and n_fill == 0, "K2 is not bit-identical to its plain version"
        worst = max(worst, float((occ - occ_p).abs().max()),
                    float((filled - filled_p).abs().max()))
    frames = [label_maps(DEFAULT_CONFIG, 96, 200, s) for s in (3, 4, 5)]
    occ, filled = lr_fill_fused(torch.stack([f[0] for f in frames]),
                                torch.stack([f[1] for f in frames]), DEFAULT_CONFIG)
    for i, (dl, dr) in enumerate(frames):
        o, f = lr_fill_fused(dl, dr, DEFAULT_CONFIG)
        assert torch.equal(occ[i], o) and torch.equal(filled[i], f), f"K2 batch frame {i}"
    print("K2 B=3 batch of 96x200: equal to per-frame launches, bit for bit")
    return worst


def check_dual(kernel, grays):
    """K4 (``kernel`` "K4", stream=False) or K5 ("K5", stream=True)
    against guided_wta_fused_dual_reference on the card, per view at the
    matching kernels' bound: textured pairs at 16 and 8 disparities, a
    range straddling zero, 64 disparities (K5 only where it fits one
    block; otherwise a forced launch must raise), a B=3 batch against
    per-frame launches (bit for bit), and both views of each main-path
    frame (``grays``: name -> (cfg, gray pair)).  Returns max |Δbest| and
    the frames' (cfg, dmap_l, dmap_r) for K2."""
    stream = kernel == "K5"
    cases = [("textured", (288, 384), DEFAULT_CONFIG), ("textured", (288, 384), CFG8),
             ("textured", (33, 130), DEFAULT_CONFIG), ("textured", (64, 160), STRADDLE)]
    if stream and not _kernels.dual_stream_fits(
            CFG64.radius, _kernels.dual_reach(CFG64.d_min, CFG64.size_d)):
        g1, g2 = textured_pair(200, 400, seed=600)
        try:
            guided_wta_fused_dual(g1, g2, dataclasses.replace(CFG64, stream=True))
        except ValueError as e:
            print(f"K5 200x400 D=64: does not fit one block, forced launch raised ({e})")
        else:
            raise AssertionError("K5 at D=64 does not fit yet launched")
    else:
        cases.append(("textured", (200, 400), CFG64))
    cases += [(name, None, cfg) for name, (cfg, _) in grays.items()]
    worst, maps = 0.0, []
    for name, shape, cfg in cases:
        cfg = dataclasses.replace(cfg, stream=stream)
        g1, g2 = grays[name][1] if shape is None else textured_pair(*shape, seed=sum(shape))
        h, w = g1.shape
        outs = guided_wta_fused_dual(g1, g2, cfg)
        ref = guided_wta_fused_dual_reference(g1, g2, cfg)
        torch.cuda.synchronize()
        for view, v in (("left", 0), ("right", 2)):
            mism = int((outs[v + 1] != ref[v + 1]).sum())
            err = float((outs[v] - ref[v]).abs().max())
            print(f"{kernel} {name} {h}x{w} d=[{cfg.d_min},{cfg.d_max}] {view}: {mism} "
                  f"label mismatches (bound {k1_max_mismatch(h * w)}), "
                  f"max |best-plain| {err:.3g}")
            assert mism <= k1_max_mismatch(h * w), f"{kernel} disagrees with its plain version"
            torch.testing.assert_close(outs[v], ref[v], atol=K1_ATOL, rtol=K1_RTOL)
            worst = max(worst, err)
        if shape is None:
            maps.append((cfg, outs[1], outs[3]))
    cfg = dataclasses.replace(DEFAULT_CONFIG, stream=stream)
    pairs = [textured_pair(96, 200, seed=s) for s in (1, 2, 3)]
    batch = guided_wta_fused_dual(torch.stack([p[0] for p in pairs]),
                                  torch.stack([p[1] for p in pairs]), cfg)
    for i, (g1, g2) in enumerate(pairs):
        for j, t in enumerate(guided_wta_fused_dual(g1, g2, cfg)):
            assert torch.equal(batch[j][i], t), f"{kernel} batch frame {i} output {j}"
    print(f"{kernel} B=3 batch of 96x200: equal to per-frame launches, bit for bit")
    return worst, maps


def reset_counts():
    guided_wta_fused.k1_launches = 0
    guided_wta_fused.k3_launches = 0
    lr_fill_fused.launches = 0
    guided_wta_fused_dual.k4_launches = 0
    guided_wta_fused_dual.k5_launches = 0


def counts():
    return tuple(launch_counts().values())


def launches(k1=0, k2=0, k3=0, k4=0, k5=0):
    return dict(zip(COUNT_NAMES, (k1, k2, k3, k4, k5)))


def drive_path(path, runs):
    """Each (name, call, expected launches per kernel) of one path, with
    every count set to 0 just before the path and read just after; an
    expectation may be a function of the call's output.  Returns the
    calls' outputs and the path's counts."""
    reset_counts()
    outs = []
    for name, call, expect in runs:
        before = counts()
        outs.append(call())
        delta = dict(zip(COUNT_NAMES, (a - b for a, b in zip(counts(), before))))
        if callable(expect):
            expect = expect(outs[-1])
        print(f"{path} {name}: launches " + ", ".join(f"{k} {v}" for k, v in delta.items()))
        assert delta == expect, f"{path} {name}: expected launches {expect}, got {delta}"
    total = dict(zip(COUNT_NAMES, counts()))
    print(f"{path}: launches in this path's run {total}")
    return outs, total


def drive_frames(path, runs):
    """``drive_path`` over compute_disparity on each (name, scene, cfg,
    expected launches) of ``runs``; then each frame is held to the plain
    path (``check_outputs``).  Returns the path's counts."""
    outs, total = drive_path(path, [
        (name, lambda sc=sc, cfg=cfg: compute_disparity(sc["left"], sc["right"], cfg, DEV),
         expect) for name, sc, cfg, expect in runs])
    for (name, sc, cfg, _), out in zip(runs, outs):
        check_outputs(name, sc, out, cfg)
    return total


def check_outputs(name, sc, out, cfg=DEFAULT_CONFIG):
    """Shapes, finiteness and agreement with the plain path on the card;
    bad-2.0 too where the scene has ground truth (``sc["gt"]``)."""
    plain = compute_disparity(
        sc["left"], sc["right"],
        chunked(dataclasses.replace(cfg, fused=False, post_fused=False)), DEV)
    h, w = sc["left"].shape[:2]
    n = h * w
    for key, v in out.items():
        assert v.shape == (h, w) and v.dtype == np.float32, (key, v.shape, v.dtype)
        assert np.isfinite(v).all(), key
    mism = {k: int((out[k] != plain[k]).sum()) for k in out}
    if sc["gt"] is None:
        print(f"{name}: no ground truth; mismatches vs plain {mism}")
    else:
        bad_k = bad_pixel_rate(np.abs(out["occlusion_filled"]), sc["gt"], 2.0)
        bad_p = bad_pixel_rate(np.abs(plain["occlusion_filled"]), sc["gt"], 2.0)
        print(f"{name}: bad-2.0 kernel {bad_k:.4f}%  plain {bad_p:.4f}%  "
              f"mismatches vs plain {mism}")
        assert bad_k <= bad_p + 0.5, f"{name}: bad-2.0 {bad_k} vs plain {bad_p}"
    for k in ("disparity_left", "disparity_right"):
        assert mism[k] <= k1_max_mismatch(n), f"{name} {k}: {mism[k]}"
    # each near-tie flip can move one LR verdict and one fill run
    assert mism["occlusion_filled"] <= max(8, int(5e-3 * n)), mism


def check_batch(scenes, out):
    """Each frame of the batch path equals a lone kernel-path frame bit
    for bit and meets the plain path's bounds."""
    for i, sc in enumerate(scenes):
        lone = stereo_pipeline(torch.from_numpy(sc["left"]).to(DEV),
                               torch.from_numpy(sc["right"]).to(DEV), DEFAULT_CONFIG)
        for k, v in lone.items():
            assert torch.equal(out[k][i], v), f"batch frame {i} {k} differs from a lone frame"
        check_outputs(f"batch frame {i}", sc, {k: v[i].cpu().numpy() for k, v in out.items()})
    print(f"batch: {len(scenes)} frames equal to lone frames, bit for bit")


def check_box(sc, out):
    """The box matcher's kernel path (K2) against its plain post stage,
    bit for bit."""
    plain = BoxStereoMatcher(dataclasses.replace(DEFAULT_CONFIG, post_fused=False),
                             device=DEV).compute(sc["left"], sc["right"])
    for k, v in plain.items():
        assert np.array_equal(out[k], v), f"box {k} differs from its plain path"
    bad = bad_pixel_rate(np.abs(out["occlusion_filled"]), sc["gt"], 2.0)
    print(f"box 288x384: equal to its plain path on every key, bad-2.0 {bad:.4f}%")


def k3_shape(h, w, cfg):
    """K3's output tile (columns, rows) on one (h, w) frame."""
    return _kernels.guided_wta_tile(cfg.radius, cfg.size_d, h, w,
                                    _kernels._n_sm(torch.device(DEV)))


def k3_tile(h, w, cfg):
    """K3's launch shape on one (h, w) frame: its tile (columns x rows),
    the grid's CTAs, and the CTAs per SM (the fewer of those its shared
    memory allows and those its block is built for)."""
    tw, th = k3_shape(h, w, cfg)
    smem = _kernels.build()["lib"].guided_wta_smem_bytes(cfg.radius, tw, th, cfg.size_d)
    built = _kernels._K3_WAVE.get((tw, th), (_kernels._K3_CTAS_PER_SM, None))[0]
    return (f"; k3 tile {tw}x{th}, {-(-w // tw) * -(-h // th)} CTAs, "
            f"{min(built, _kernels.smem_ctas_per_sm(smem))} CTAs/SM")


def k1_walk(h, w, cfg):
    """K1's launch shape on one (h, w) frame: step, band and the grid's
    CTAs."""
    step = _kernels.guided_wta_stream_step(cfg.radius, cfg.size_d)
    band = _kernels.guided_wta_stream_band_rows(cfg.radius, cfg.size_d, h, w,
                                                _kernels._n_sm(torch.device(DEV)), step)
    return (f"; k1 step {step} rows, band {band} rows, "
            f"{-(-w // _kernels._K1_TILE_W) * -(-h // band)} CTAs")


def on_card(sc):
    return (torch.from_numpy(sc["left"]).to(DEV), torch.from_numpy(sc["right"]).to(DEV))


def time_scene(name, sc, sc8, iters):
    """ms per frame (default, stream=True, dual D=16 and auto D=8 kernel
    paths, the plain path) and per kernel launch (K3 and K1 on the left
    view, K4 and K5 forced at D=16 and at D=8, K3 and K1 on the left view
    at D=8, K2) with their plain versions, for one frame size."""
    left, right = on_card(sc)
    left8, right8 = on_card(sc8)
    cfg = DEFAULT_CONFIG
    gl = rgb_to_grayscale(left, cfg)
    gr = rgb_to_grayscale(right, cfg)
    gl8 = rgb_to_grayscale(left8, CFG8)
    gr8 = rgb_to_grayscale(right8, CFG8)
    dl = guided_wta_fused(gl, gr, cfg.d_min, cfg)[1]
    dr = guided_wta_fused(gr, gl, cfg.d_min_right, cfg)[1]
    k4, k5 = (dataclasses.replace(cfg, stream=s) for s in (False, True))
    k4_d8, k5_d8 = (dataclasses.replace(CFG8, stream=s) for s in (False, True))
    few = max(2, iters // 4)
    t = {
        "frame_ms": cuda_ms(lambda: stereo_pipeline(left, right, cfg), iters),
        "stream_frame_ms": cuda_ms(lambda: stereo_pipeline(left, right, STREAM16), iters),
        "dual_frame_ms": cuda_ms(lambda: stereo_pipeline(left, right, DUAL16), iters),
        "d8_frame_ms": cuda_ms(lambda: stereo_pipeline(left8, right8, CFG8), iters),
        "frame_plain_ms": cuda_ms(lambda: stereo_pipeline(left, right, PLAIN), few),
        "k3_ms": cuda_ms(lambda: guided_wta_fused(gl, gr, cfg.d_min, cfg), iters),
        "k1_ms": cuda_ms(lambda: guided_wta_fused(gl, gr, cfg.d_min, STREAM16), iters),
        "single_plain_ms": cuda_ms(
            lambda: guided_wta_fused_reference(gl, gr, cfg.d_min, cfg), few),
        "k4_ms": cuda_ms(lambda: guided_wta_fused_dual(gl, gr, k4), iters),
        "k5_ms": cuda_ms(lambda: guided_wta_fused_dual(gl, gr, k5), iters),
        "k4_d8_ms": cuda_ms(lambda: guided_wta_fused_dual(gl8, gr8, k4_d8), iters),
        "k5_d8_ms": cuda_ms(lambda: guided_wta_fused_dual(gl8, gr8, k5_d8), iters),
        # one view each: the single-view routes at D=8 run them twice
        "k3_d8_ms": cuda_ms(lambda: guided_wta_fused(gl8, gr8, CFG8.d_min, CFG8), iters),
        "k1_d8_ms": cuda_ms(lambda: guided_wta_fused(gl8, gr8, CFG8.d_min, STREAM8), iters),
        "dual_plain_ms": cuda_ms(lambda: guided_wta_fused_dual_reference(gl, gr, cfg), few),
        "k2_ms": cuda_ms(lambda: lr_fill_fused(dl, dr, cfg), iters),
        "k2_plain_ms": cuda_ms(lambda: lr_fill_reference(dl, dr, cfg), iters),
    }
    print(f"timing {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
          + k3_tile(*gl.shape, cfg) + k1_walk(*gl.shape, cfg))
    return t


def time_wide(name, sc, cfg, iters):
    """ms per frame of the wide-range kernel path (K3) and per launch of
    K3 and K1 on the left view, with the plain single view (chunked),
    each once steady (``steady_ms``: windows of ``iters`` calls, one for
    the plain version, until two agree within 2%)."""
    left, right = on_card(sc)
    gl = rgb_to_grayscale(left, cfg)
    gr = rgb_to_grayscale(right, cfg)
    stream = dataclasses.replace(cfg, stream=True)
    steady = {
        "frame_ms": steady_ms(lambda: stereo_pipeline(left, right, cfg), iters),
        "k3_ms": steady_ms(lambda: guided_wta_fused(gl, gr, cfg.d_min, cfg), iters),
        "k1_ms": steady_ms(lambda: guided_wta_fused(gl, gr, cfg.d_min, stream), iters),
        "single_plain_ms": steady_ms(
            lambda: guided_wta_fused_reference(gl, gr, cfg.d_min, chunked(cfg)), 1),
    }
    t = {k: s.ms for k, s in steady.items()}
    print(f"timing {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
          + k3_tile(*gl.shape, cfg) + "; steady after windows "
          + ", ".join(f"{k} {s.windows}{'' if s.settled else ' (not settled)'}"
                      for k, s in steady.items()))
    return t


def time_batch_and_box(batch, sc, lone_frame_ms, iters):
    """ms per frame of stereo_pipeline_batch (B frames in one call)
    against the lone frame's, and of the box matcher's kernel and plain
    paths, at 288x384."""
    left, right = on_card(sc)
    b = batch[0].shape[0]
    box_plain = dataclasses.replace(DEFAULT_CONFIG, fused=False, post_fused=False)
    t = {
        "batch_frame_ms": cuda_ms(lambda: stereo_pipeline_batch(*batch, DEFAULT_CONFIG),
                                  iters) / b,
        "lone_frame_ms": lone_frame_ms,
        "box_frame_ms": cuda_ms(lambda: box_stereo_pipeline(left, right, DEFAULT_CONFIG),
                                iters),
        "box_plain_frame_ms": cuda_ms(lambda: box_stereo_pipeline(left, right, box_plain),
                                      iters),
    }
    print("timing 288x384 batch and box: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    return t


def run_cli(argv):
    """``cli.main(argv)`` in this process: (stdout, stderr, wall seconds).
    Fails unless it returns 0."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    assert rc == 0, f"cli {argv}: exit {rc}\n{err.getvalue()}"
    return out.getvalue(), err.getvalue(), wall


def drive_cli(tmp, scenes):
    """The CLI on PNG pairs of each scene (name -> scene at D=16): the
    default route (2 K3 + 1 K2 a frame), with --profile (its stage table
    runs each stage profiling.WARMUP + n times: 2 K3 + 1 K2 per frame),
    and at 6 MP on the dual route (--dual-view on --d-min -7: 1 K5 +
    1 K2).  Each run's disparity_mapl.png and occlu_mapl_filled.png equal
    write_mat_normalize of compute_disparity on the card, bit for bit.
    Returns the path's counts and the stage table TOTAL (ms) by scene."""
    dual = StereoConfig(d_min=-7, d_max=0, dual_view=True)
    runs, checks = [], []
    for name, sc in scenes.items():
        d = os.path.join(tmp, name)
        os.makedirs(d)
        pair = [os.path.join(d, f) for f in ("left.png", "right.png")]
        write_png(pair[0], sc["left"])
        write_png(pair[1], sc["right"])
        frames = 1 + profiling.WARMUP + profiling.stage_frames(*sc["gt"].shape)
        todo = [(name, [], DEFAULT_CONFIG, launches(k3=2, k2=1)),
                (f"{name} --profile", ["--profile"], DEFAULT_CONFIG,
                 launches(k3=2 * frames, k2=frames))]
        if name == "1992x3008":
            todo.append((f"{name} --dual-view on --d-min -7",
                         ["--dual-view", "on", "--d-min", "-7"], dual, launches(k5=1, k2=1)))
        for i, (label, flags, cfg, expect) in enumerate(todo):
            out_dir = os.path.join(d, f"out{i}")
            runs.append((label, lambda a=[*pair, "-o", out_dir, "--json", *flags]: run_cli(a),
                         expect))
            checks.append((label, sc, cfg, out_dir))
    outs, total = drive_path("cli path", runs)
    totals = {}
    for (label, sc, cfg, out_dir), (stdout, stderr, wall) in zip(checks, outs):
        stats = json.loads(stdout.splitlines()[-1])
        want = compute_disparity(sc["left"], sc["right"], cfg, DEV)
        for png, key in (("disparity_mapl.png", "disparity_left"),
                         ("occlu_mapl_filled.png", "occlusion_filled")):
            assert np.array_equal(read_png(os.path.join(out_dir, png)),
                                  write_mat_normalize(want[key])), f"cli {label}: {png}"
        print(f"cli {label}: wall {wall:.4f} s incl. PNG I/O, pipeline {stats['seconds']} s, "
              f"PNG I/O {stats['io_seconds']} s ({stats['io_seconds'] / wall:.1%} of wall); "
              f"PNGs equal to compute_disparity on the card")
        if "--profile" in label:
            print(f"cli {label} stage table:\n{stderr.rstrip()}")
            totals[label.split()[0]] = float(stderr.splitlines()[-1].split()[-2])
    return total, totals


def drive_eval():
    """``--eval`` on tests/data/synthgt: 2 K3 + 1 K2 per scene, each
    scene's bad-2.0 within 0.5 points of the JAX package's."""
    root = os.path.join(REPO, "tests", "data", "synthgt")
    ((stdout, _, wall),), total = drive_path("eval path", [
        ("--eval tests/data/synthgt", lambda: run_cli([root, "--eval", "--json"]),
         launches(k3=4, k2=2))])
    scenes = json.loads(stdout.splitlines()[-1])["scenes"]
    for name, ndisp in (("scene0", 16), ("scene1_wide", 64)):
        got = scenes[name]
        print(f"eval {name}: {got['height']}x{got['width']} ndisp {got['ndisp']}, bad-2.0 "
              f"{got['bad_2_0_pct']}% (JAX {SYNTHGT_BAD2[name]}%), epe {got['epe']}")
        assert got["ndisp"] == ndisp, got
        assert abs(got["bad_2_0_pct"] - SYNTHGT_BAD2[name]) <= 0.5, got
    print(f"eval: wall {wall:.4f} s for {len(scenes)} scenes")
    return total


def b64_png(img, tmp):
    path = os.path.join(tmp, "request.png")
    write_png(path, img)
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode()


def post(port, body):
    """(response, client seconds) of one POST /disparity."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/disparity", data=body,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        rep = json.loads(resp.read())
    return rep, time.perf_counter() - t0


def burst(port, bodies):
    """All ``bodies`` POSTed at once from their own threads: (responses
    with client seconds, wall seconds of the burst)."""
    results = [None] * len(bodies)
    start = threading.Barrier(len(bodies) + 1)

    def client(i):
        start.wait()
        results[i] = post(port, bodies[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    assert all(r is not None for r in results), "a serve client got no response"
    return results, wall


def groups_launched(burst_out):
    """Launches of the groups the server ran for a burst (``burst``'s
    output): one K3 per view and one K2 per group (a group of n answers n
    requests)."""
    n = round(sum(1 / rep["batched_n"] for rep, _ in burst_out[0]))
    return launches(k3=2 * n, k2=n)


def drive_serve(tmp, scenes, big):
    """The HTTP server on the card: a burst of eight concurrent 288x384
    requests as ``--serve`` runs them (no coalesce window), one 6 MP
    request, and the burst again with a 0.1 s coalesce window after the
    first dequeue.  Every response's PFM equals the lone
    compute_disparity occlusion_filled bit for bit; each burst's launches
    are its groups'; the second micro-batches (some batched_n > 1, fewer
    than 8 K3 launches per view and 8 K2 launches)."""
    srv = make_server("127.0.0.1", 0, DEFAULT_CONFIG, device=DEV)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        print(f"serve healthz: {health}")
        assert health["backend"] == DEV and health["device"] == torch.cuda.get_device_name(0)

        def body(sc):
            return json.dumps({"left": b64_png(sc["left"], tmp),
                               "right": b64_png(sc["right"], tmp)}).encode()

        bodies = [body(sc) for sc in scenes]

        def coalesced_burst():
            srv.executor.window_s = 0.1
            return burst(port, bodies)

        outs, total = drive_path("serve path", [
            (f"burst of {len(scenes)} 288x384", lambda: burst(port, bodies), groups_launched),
            ("one 1992x3008", lambda: ([post(port, body(big))], None), launches(k3=2, k2=1)),
            (f"burst of {len(scenes)} 288x384, 0.1 s coalesce window", coalesced_burst,
             groups_launched)])
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    for (results, wall), label, frames in zip(
            outs, ("burst, no window", "1992x3008", "burst, 0.1 s window"),
            (scenes, [big], scenes)):
        for (rep, _), sc in zip(results, frames):
            path = os.path.join(tmp, "response.pfm")
            with open(path, "wb") as f:
                f.write(base64.b64decode(rep["disparity_pfm"]))
            want = compute_disparity(sc["left"], sc["right"], DEFAULT_CONFIG, DEV,
                                     keys=("occlusion_filled",))["occlusion_filled"]
            assert np.array_equal(read_pfm(path), want), f"serve {label}: response differs"
        lat = sorted(sec for _, sec in results)
        rate = f", {len(results) / wall:.2f} requests/s" if wall else ""
        print(f"serve {label}: {len(results)} responses equal to lone frames{rate}, latency "
              f"s min {lat[0]:.4f} median {lat[len(lat) // 2]:.4f} max {lat[-1]:.4f}, server "
              f"seconds {[rep['seconds'] for rep, _ in results]}, batched_n "
              f"{[rep['batched_n'] for rep, _ in results]}")
    assert max(rep["batched_n"] for rep, _ in outs[2][0]) > 1, "the server did not micro-batch"
    launched = groups_launched(outs[2])
    assert launched["K3"] < 2 * len(scenes) and launched["K2"] < len(scenes), launched
    return total


def drive_bench(scenes):
    """``bench.run`` in this process at the JAX bench's sizes and counts,
    on the layered scenes already made (``scenes``: (h, w, ndisp) ->
    scene, seed 7).  Each row's launches must be its route's per call
    times its calls, and each row's first (unperturbed) frame is held to
    the plain path (``check_outputs``; frame by frame for the batch).
    Prints the bench's JSON line and the headline chain's device-busy
    share.  Returns the path's counts and the bench's summary."""
    routes = {"tsukuba": launches(k3=2, k2=1), "sequence_batch8": launches(k3=2, k2=1),
              "six_mp": launches(k3=2, k2=1), "wide_d": launches(k3=2, k2=1),
              "three_mp": launches(k3=2, k2=1), "d8_288x384_auto": launches(k4=1, k2=1),
              "d8_288x384_single": launches(k3=2, k2=1), "d8_six_mp_auto": launches(k5=1, k2=1),
              "d8_six_mp_single": launches(k3=2, k2=1), "six_mp_stream": launches(k1=2, k2=1)}
    ((result,), total) = drive_path("bench path", [(
        "bench.run", lambda: bench.run(DEV, bench.EXTRA_ROWS, scenes=scenes),
        lambda res: {k: sum(r.launches[k] for r in res.rows.values()) for k in COUNT_NAMES})])
    print("bench " + json.dumps(result.summary))
    extra = result.summary["extra"]
    assert not [k for k in extra if k.endswith("_error")], "a bench row failed"
    assert set(result.rows) == set(routes), sorted(result.rows)
    for row in (bench.HEADLINE, *bench.EXTRA_ROWS):
        r = result.rows[row.key]
        want = {k: v * r.calls for k, v in routes[row.key].items()}
        print(f"bench {row.key}: launches {r.launches} over {r.calls} calls "
              f"(route per call {routes[row.key]})")
        assert r.launches == want, f"bench {row.key}: expected launches {want}"
        frames = ([(r.inputs, r.first)] if row.batch == 1 else [
            ({"left": r.inputs["left"][i], "right": r.inputs["right"][i], "gt": None},
             {k: v[i] for k, v in r.first.items()}) for i in range(row.batch)])
        for i, (sc, out) in enumerate(frames):
            check_outputs(f"bench {row.key} first frame{f' {i}' if row.batch > 1 else ''}",
                          sc, out, row.cfg)
    left, right = on_card(result.rows["tsukuba"].inputs)
    prof = profile_path("bench tsukuba chain",
                        lambda: bench.step(lambda l: stereo_pipeline(l, right, DEFAULT_CONFIG), left),
                        bench.HEADLINE.n_big)
    print(f"bench tsukuba chain: device busy share {1 - prof['idle_share']:.4f} "
          f"(tsukuba_ms_per_frame {extra['tsukuba_ms_per_frame']:.4f})")
    return total, result.summary


def drive_benchmark():
    """The benchmark's cells (``BENCHMARK.json``), each once at its full
    size on the runner's own inputs (its seed): one call of the cell's
    entry, its launches the cell's route, held to the benchmark's
    correctness check (``benchmark/check.py``: each view within the flip
    limit of the benchmark's float64 reference, the post maps bit-identical
    to the reference's post on the same matching maps, bad-2.0 within the
    slack of the reference's), and each of the check's controls refused.
    No timing.  Returns the path's counts."""
    routes = {"tsukuba": launches(k3=2, k2=1), "tsukuba_batch8": launches(k3=2, k2=1),
              "six_mp": launches(k3=2, k2=1), "wide_d": launches(k3=2, k2=1),
              "six_mp_d8": launches(k5=1, k2=1), "six_mp_stream": launches(k1=2, k2=1)}
    cells = benchmark_run.load_cells()
    assert [c.name for c in cells] == list(routes), [c.name for c in cells]
    with open(benchmark_run.BENCHMARK_JSON) as f:
        seed = json.load(f)["seed"]
    total = dict.fromkeys(COUNT_NAMES, 0)
    for cell in cells:
        inputs = benchmark_run.cell_inputs(cell, seed)
        left, right = (torch.from_numpy(inputs[k]).to(DEV) for k in ("left", "right"))
        call = benchmark_run.entry(cell, right)
        (out,), counted = drive_path("benchmark path", [(
            f"{cell.name} {cell.height}x{cell.width} D={cell.cfg.size_d} B={cell.batch}",
            lambda: call(left), routes[cell.name])])
        for i, v in enumerate(benchmark_run.check_call(cell, left, right, out, inputs["gt"])):
            print(f"benchmark {cell.name} frame {i}: flips {v['flips']} (bound "
                  f"{v['flip_bound']}), post mismatches {v['post_mismatches']} (must be 0), "
                  f"bad-2.0 {v['bad2']:.4f}% (reference {v['bad2_ref']:.4f}%)")
            assert v["ok"], f"benchmark {cell.name} frame {i}: not correct {v}"
        control = benchmark_run.controls(cell, left, right, inputs["gt"])
        print(f"benchmark {cell.name} controls: {json.dumps(control)}")
        assert all(c["refused"] for c in control.values()), f"{cell.name}: a control passed"
        total = {k: total[k] + counted[k] for k in COUNT_NAMES}
        del inputs, left, right, out
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    info = _kernels.build()
    print(f"build: {info['seconds']:.2f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if any(key in line for key in ("entry function", "registers", "spill", "error")):
            print(f"  ptxas: {line.strip()}")

    sizes = {"288x384": (288, 384), "1992x3008": (1992, 3008)}
    scenes16 = {name: make_scene(*hw, ndisp=16) for name, hw in sizes.items()}
    scenes8 = {name: make_scene(*hw, ndisp=8) for name, hw in sizes.items()}
    wide = {"288x384 D=64": (make_scene(288, 384, ndisp=64), CFG64),
            "1988x2948 D=128": (make_scene(1988, 2948, ndisp=128), CFG128)}
    batch_scenes = [make_scene(288, 384, ndisp=16, seed=s) for s in range(1, 9)]

    def grays(sc, cfg=DEFAULT_CONFIG):
        return tuple(rgb_to_grayscale(torch.from_numpy(sc[k]).to(DEV), cfg)
                     for k in ("left", "right"))

    single_grays = {f"{name} D=16": (DEFAULT_CONFIG, grays(sc)) for name, sc in scenes16.items()}
    single_grays.update({name: (cfg, grays(sc, cfg)) for name, (sc, cfg) in wide.items()})
    single_err, single_maps = check_single(single_grays)
    dual_grays = {}
    for name in sizes:
        dual_grays[f"{name} D=16"] = single_grays[f"{name} D=16"]
        dual_grays[f"{name} D=8"] = (CFG8, grays(scenes8[name]))
    k4_err, k4_maps = check_dual("K4", dual_grays)
    k5_err, k5_maps = check_dual("K5", dual_grays)
    k2_err = check_k2(single_maps["K3"] + single_maps["K1"] + k4_maps + k5_maps)
    shard_err = check_shard_entry(DEFAULT_CONFIG, *single_grays["1992x3008 D=16"][1])
    single_err = {k: max(single_err[k], shard_err[k]) for k in single_err}
    del single_grays, dual_grays, single_maps, k4_maps, k5_maps

    path_counts = [
        drive_frames("default path", [(name, scenes16[name], DEFAULT_CONFIG,
                                       launches(k3=2, k2=1)) for name in sizes]),
        drive_frames("stream path", [(f"{name} stream=True", scenes16[name], STREAM16,
                                      launches(k1=2, k2=1)) for name in sizes]),
        drive_frames("wide-range path", [(f"{name} auto", sc, cfg, launches(k3=2, k2=1))
                                         for name, (sc, cfg) in wide.items()])]
    dual_runs = []
    for name in sizes:
        # K4 below 200,000 px, K5 from there on (pipeline.use_stream)
        expect = launches(k2=1, k4=1) if name == "288x384" else launches(k2=1, k5=1)
        dual_runs += [(f"{name} D=16 dual_view=True", scenes16[name], DUAL16, expect),
                      (f"{name} D=8 auto", scenes8[name], CFG8, expect)]
    path_counts.append(drive_frames("dual-view path", dual_runs))
    batch = tuple(torch.from_numpy(np.stack([sc[k] for sc in batch_scenes])).to(DEV)
                  for k in ("left", "right"))
    (batch_out,), batch_counts = drive_path("batch path", [(
        f"stereo_pipeline_batch B={len(batch_scenes)} 288x384",
        lambda: stereo_pipeline_batch(*batch, DEFAULT_CONFIG), launches(k3=2, k2=1))])
    check_batch(batch_scenes, batch_out)
    del batch_out
    box_matcher = BoxStereoMatcher(DEFAULT_CONFIG, device=DEV)
    sc_small = scenes16["288x384"]
    (box_out,), box_counts = drive_path("box path", [(
        "BoxStereoMatcher 288x384", lambda: box_matcher.compute(sc_small["left"], sc_small["right"]),
        launches(k2=1))])
    check_box(sc_small, box_out)
    sharded_counts, sharded_times = drive_sharded(scenes16)
    path_counts += [batch_counts, box_counts, sharded_counts]
    print("image codec: " + ("native libstereoio" if native_available()
                             else "pure-Python (native/build/libstereoio.so not built)"))
    with tempfile.TemporaryDirectory() as tmp:
        cli_counts, stage_totals = drive_cli(tmp, scenes16)
        path_counts += [cli_counts, drive_cli_mesh(tmp, scenes16["1992x3008"]), drive_eval(),
                        drive_serve(tmp, batch_scenes, scenes16["1992x3008"])]
    bench_counts, bench_summary = drive_bench({
        (1992, 3008, 16): scenes16["1992x3008"], (1992, 3008, 8): scenes8["1992x3008"],
        (288, 384, 8): scenes8["288x384"], (1988, 2948, 128): wide["1988x2948 D=128"][0]})
    path_counts += [bench_counts, drive_benchmark()]

    times = {name: time_scene(name, scenes16[name], scenes8[name], iters)
             for name, iters in zip(sizes, (50, 10))}
    wide_times = {name: time_wide(name, sc, cfg, iters)
                  for (name, (sc, cfg)), iters in zip(wide.items(), (20, 3))}
    extra = time_batch_and_box(batch, sc_small, times["288x384"]["frame_ms"], 20)
    for name in sizes:
        ratio = stage_totals[name] / times[name]["frame_ms"]
        print(f"cli {name} stage table TOTAL {stage_totals[name]:.4f} ms against frame_ms "
              f"{times[name]['frame_ms']:.4f}: ratio {ratio:.4f}")
    assert 0.85 <= stage_totals["1992x3008"] / times["1992x3008"]["frame_ms"] <= 1.15, \
        "the 6 MP stage table's TOTAL is not within 15% of the frame's time"
    bench_6mp = bench_summary["extra"]["six_mp_ms_per_frame"]
    ratio = bench_6mp / times["1992x3008"]["frame_ms"]
    print(f"bench six_mp_ms_per_frame {bench_6mp:.4f} ms against timing 1992x3008 frame_ms "
          f"{times['1992x3008']['frame_ms']:.4f}: ratio {ratio:.4f}")
    assert 0.85 <= ratio <= 1.15, "the bench's 6 MP frame is not within 15% of frame_ms"
    for name, frames in zip(sizes, (50, 10)):
        sc = scenes16[name]
        left, right = on_card(sc)
        left8, right8 = on_card(scenes8[name])
        for label, cfg in (("default", DEFAULT_CONFIG), ("stream=True", STREAM16),
                           ("D=16 dual_view=True", DUAL16)):
            profile_path(f"{name} {label}", lambda: stereo_pipeline(left, right, cfg), frames)
        profile_path(f"{name} D=8 auto", lambda: stereo_pipeline(left8, right8, CFG8), frames)
    for (name, (sc, cfg)), frames in zip(wide.items(), (20, 3)):
        left, right = on_card(sc)
        profile_path(f"{name} auto", lambda: stereo_pipeline(left, right, cfg), frames,
                     warmup=2)
    profile_path(f"288x384 stereo_pipeline_batch B={len(batch_scenes)}",
                 lambda: stereo_pipeline_batch(*batch, DEFAULT_CONFIG), 10,
                 per_call=len(batch_scenes))
    left, right = on_card(sc_small)
    profile_path("288x384 box", lambda: box_stereo_pipeline(left, right, DEFAULT_CONFIG), 20)

    shapes = {"288x384": (288, 384, 16, COUNT_NAMES), "1992x3008": (1992, 3008, 16, COUNT_NAMES),
              "288x384 D=8": (288, 384, 8, ("K1", "K3", "K4", "K5")),
              "1992x3008 D=8": (1992, 3008, 8, ("K1", "K3", "K4", "K5")),
              "288x384 D=64": (288, 384, 64, ("K1", "K3")),
              "1988x2948 D=128": (1988, 2948, 128, ("K1", "K3"))}
    for kernel in COUNT_NAMES:
        for name, (h, w, d, kernels) in shapes.items():
            if kernel in kernels:
                ms, by = bound(h, w, d, kernel)
                print(f"bound {kernel} {name}: {ms:.5f} ms ({by})")

    big = times["1992x3008"]
    total = {k: sum(c[k] for c in path_counts) for k in COUNT_NAMES}
    pallas = "stereo_matching_cuda_tpu/ops/"
    csrc = "stereo_matching_cuda_tpu_torch/csrc/"
    rows = [("guided_wta_stream (K1)", "K1", "guided_wta_stream.cu", "pallas_guided.py:848",
             single_err["K1"], "k1_ms", "single_plain_ms"),
            ("lr_fill (K2)", "K2", "lr_fill.cu", "pallas_post.py:69", k2_err, "k2_ms",
             "k2_plain_ms"),
            ("guided_wta (K3)", "K3", "guided_wta.cu", "pallas_guided.py:315",
             single_err["K3"], "k3_ms", "single_plain_ms"),
            ("guided_wta_dual (K4)", "K4", "guided_wta_dual.cu", "pallas_guided.py:1322",
             k4_err, "k4_ms", "dual_plain_ms"),
            ("guided_wta_dual_stream (K5)", "K5", "guided_wta_dual_stream.cu",
             "pallas_guided.py:1116", k5_err, "k5_ms", "dual_plain_ms")]
    # K3's ms per launch (left view) at each frame it was timed on, with its tile
    k3_frames = {f"{name} D={d}": (times[name][key], cfg, sizes[name])
                 for name in sizes for d, key, cfg in ((16, "k3_ms", DEFAULT_CONFIG),
                                                       (8, "k3_d8_ms", CFG8))}
    k3_frames.update({name: (wide_times[name]["k3_ms"], cfg, sc["left"].shape[:2])
                      for name, (sc, cfg) in wide.items()})
    k3_by_frame = {name: {"ms": ms, "tile": "{}x{}".format(*k3_shape(*hw, cfg))}
                   for name, (ms, cfg, hw) in k3_frames.items()}
    print(f"k3 by frame {json.dumps(k3_by_frame)}")
    record = {"kernels": []}
    for name, kernel, src, replaces, err, ms_key, plain_key in rows:
        bound_ms, bound_by = bound(1992, 3008, DEFAULT_CONFIG.size_d, kernel)
        record["kernels"].append({
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": pallas + replaces, "launches": total[kernel], "max_abs_err": err,
            "ms": big[ms_key], "plain_ms": big[plain_key], "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no single PyTorch call computes the guided WTA or the LR check + fill
            "library_ms": None})
        if kernel == "K3":
            record["kernels"][-1]["by_frame"] = k3_by_frame
    print(f"wide-range timings {json.dumps(wide_times)}; batch and box {json.dumps(extra)}; "
          f"sharded {json.dumps(sharded_times)}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
