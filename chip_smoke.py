"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU, ``nvcc`` and
``nvidia-smi``.  It builds the hand-written kernels from ``csrc/``,
checks each against its plain PyTorch version on the card, drives the
main path (``compute_disparity``) on a 288x384 scene and a 1992x3008
(6 MP) scene, checks the launch counts and the results, times kernel and
plain paths with CUDA events, splits the kernel path's device time by
layer and reads the device's idle share with torch.profiler, and prints
two JSON lines last: the
per-kernel record, then ``{"ok": true, "device": ...}``.  Any failure
raises and exits non-zero; with no CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

from stereo_matching_cuda_tpu_torch import DEFAULT_CONFIG, StereoConfig, compute_disparity
from stereo_matching_cuda_tpu_torch.metrics import bad_pixel_rate
from stereo_matching_cuda_tpu_torch.ops import _kernels, rgb_to_grayscale
from stereo_matching_cuda_tpu_torch.ops.fused_guided import (
    guided_wta_fused, guided_wta_fused_reference)
from stereo_matching_cuda_tpu_torch.ops.fused_post import lr_fill_fused, lr_fill_reference
from stereo_matching_cuda_tpu_torch.pipeline import stereo_pipeline
from stereo_matching_cuda_tpu_torch.utils.synth import make_scene

DEV = "cuda"
PLAIN = dataclasses.replace(DEFAULT_CONFIG, fused=False, post_fused=False)
CFG64 = StereoConfig(d_min=-63, d_max=0)
# K1's bound: the fused fast-path class of the JAX kernels
# (tests/test_pallas_fused.py:55-57) — near-tie label flips only.
K1_ATOL, K1_RTOL = 2e-3, 1e-4


def k1_max_mismatch(n: int) -> int:
    return max(4, int(2e-3 * n))


def textured_pair(h, w, seed):
    """Smoothed random gray pair, the right a 6-column shift of the left."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(h, w + 32)).astype(np.float32)
    base = ((base + np.roll(base, 1, 1) + np.roll(base, -1, 1)
             + np.roll(base, 1, 0)) / 4).astype(np.uint8)
    return (torch.from_numpy(np.ascontiguousarray(base[:, 16:16 + w])).to(DEV),
            torch.from_numpy(np.ascontiguousarray(base[:, 10:10 + w])).to(DEV))


def check_k1(grays):
    """K1 against guided_wta_fused_reference on the card, on textured
    pairs and on both views of each main-path frame (``grays``: name ->
    gray pair).  Returns max |Δbest| and each frame's K1 label maps."""
    worst = 0.0
    cases = [("textured", (288, 384), -15, DEFAULT_CONFIG),
             ("textured", (288, 384), 0, DEFAULT_CONFIG),
             ("textured", (33, 130), -15, DEFAULT_CONFIG),
             ("textured", (33, 130), 0, DEFAULT_CONFIG),
             ("textured", (200, 400), -63, CFG64)]
    for name in grays:
        cases += [(name, None, DEFAULT_CONFIG.d_min, DEFAULT_CONFIG),
                  (name, None, DEFAULT_CONFIG.d_min_right, DEFAULT_CONFIG)]
    maps = {name: {} for name in grays}
    for name, shape, dmin, cfg in cases:
        if shape is None:
            g1, g2 = grays[name]
        else:
            g1, g2 = textured_pair(*shape, seed=sum(shape))
        if dmin == cfg.d_min_right:
            g1, g2 = g2, g1
        h, w = g1.shape
        best, dmap = guided_wta_fused(g1, g2, dmin, cfg)
        best_p, dmap_p = guided_wta_fused_reference(g1, g2, dmin, cfg)
        torch.cuda.synchronize()
        mism = int((dmap != dmap_p).sum())
        err = float((best - best_p).abs().max())
        print(f"K1 {name} {h}x{w} dmin={dmin} D={cfg.size_d}: {mism} label "
              f"mismatches (bound {k1_max_mismatch(h * w)}), max |best-plain| {err:.3g}")
        assert mism <= k1_max_mismatch(h * w), "K1 disagrees with its plain version"
        torch.testing.assert_close(best, best_p, atol=K1_ATOL, rtol=K1_RTOL)
        worst = max(worst, err)
        if shape is None:
            maps[name][dmin] = dmap
    return worst, {name: (m[DEFAULT_CONFIG.d_min], m[DEFAULT_CONFIG.d_min_right])
                   for name, m in maps.items()}


def label_maps(cfg, h, w, seed):
    rng = np.random.default_rng(seed)
    dl = rng.integers(cfg.d_min, cfg.d_max + 1, size=(h, w)).astype(np.float32)
    dr = rng.integers(-cfg.d_max, -cfg.d_min + 1, size=(h, w)).astype(np.float32)
    return torch.from_numpy(dl).to(DEV), torch.from_numpy(dr).to(DEV)


def check_k2(k1_maps):
    """K2 against lr_fill_reference on the card: bit-identical on random
    label maps and on each main-path frame's K1 maps (``k1_maps``: name
    -> (left, right)); returns the largest |difference| seen (0.0 when
    it holds)."""
    cfg128 = StereoConfig(d_min=-127, d_max=0)
    cases = [(DEFAULT_CONFIG, *label_maps(DEFAULT_CONFIG, 288, 384, 0)),
             (cfg128, *label_maps(cfg128, 40, 300, 1))]
    dl, dr = label_maps(DEFAULT_CONFIG, 24, 256, 2)
    dr[3:6] = -DEFAULT_CONFIG.d_min + 50      # rows with no LR-consistent pixel
    cases.append((DEFAULT_CONFIG, dl, dr))
    cases += [(DEFAULT_CONFIG, dl, dr) for dl, dr in k1_maps.values()]
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
    return worst


def reset_counts():
    guided_wta_fused.launches = 0
    lr_fill_fused.launches = 0


def counts():
    return guided_wta_fused.launches, lr_fill_fused.launches


def drive_main_path(scenes):
    """compute_disparity on each scene with the default config; each frame
    must launch K1 twice and K2 once.  Returns outputs and total counts."""
    reset_counts()
    outs = []
    for name, sc in scenes:
        before = counts()
        outs.append(compute_disparity(sc["left"], sc["right"], DEFAULT_CONFIG, DEV))
        after = counts()
        delta = (after[0] - before[0], after[1] - before[1])
        print(f"main path {name}: K1 launches {delta[0]}, K2 launches {delta[1]}")
        assert delta == (2, 1), f"{name}: expected 2 K1 and 1 K2 launches, got {delta}"
    return outs, counts()


def check_outputs(name, sc, out):
    """Shapes, finiteness and agreement with the plain path on the card."""
    plain = compute_disparity(sc["left"], sc["right"], PLAIN, DEV)
    h, w = sc["gt"].shape
    n = h * w
    for key, v in out.items():
        assert v.shape == (h, w) and v.dtype == np.float32, (key, v.shape, v.dtype)
        assert np.isfinite(v).all(), key
    bad_k = bad_pixel_rate(np.abs(out["occlusion_filled"]), sc["gt"], 2.0)
    bad_p = bad_pixel_rate(np.abs(plain["occlusion_filled"]), sc["gt"], 2.0)
    mism = {k: int((out[k] != plain[k]).sum()) for k in out}
    print(f"{name}: bad-2.0 kernel {bad_k:.4f}%  plain {bad_p:.4f}%  "
          f"mismatches vs plain {mism}")
    for k in ("disparity_left", "disparity_right"):
        assert mism[k] <= k1_max_mismatch(n), f"{name} {k}: {mism[k]}"
    # each near-tie flip can move one LR verdict and one fill run
    assert mism["occlusion_filled"] <= max(8, int(5e-3 * n)), mism
    assert bad_k <= bad_p + 0.5, f"{name}: bad-2.0 {bad_k} vs plain {bad_p}"
    return bad_k, bad_p


def cuda_ms(fn, iters, warmup=3):
    """Mean ms per call of ``fn`` on the card, CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_scene(name, sc, iters):
    """ms per frame (kernel and plain paths) and per kernel for one scene."""
    left = torch.from_numpy(sc["left"]).to(DEV)
    right = torch.from_numpy(sc["right"]).to(DEV)
    cfg = DEFAULT_CONFIG
    gl = rgb_to_grayscale(left, cfg)
    gr = rgb_to_grayscale(right, cfg)
    dl = guided_wta_fused(gl, gr, cfg.d_min, cfg)[1]
    dr = guided_wta_fused(gr, gl, cfg.d_min_right, cfg)[1]
    t = {
        "frame_ms": cuda_ms(lambda: stereo_pipeline(left, right, cfg), iters),
        "frame_plain_ms": cuda_ms(lambda: stereo_pipeline(left, right, PLAIN),
                                  max(2, iters // 4)),
        "k1_ms": cuda_ms(lambda: guided_wta_fused(gl, gr, cfg.d_min, cfg), iters),
        "k1_plain_ms": cuda_ms(
            lambda: guided_wta_fused_reference(gl, gr, cfg.d_min, cfg),
            max(2, iters // 4)),
        "k2_ms": cuda_ms(lambda: lr_fill_fused(dl, dr, cfg), iters),
        "k2_plain_ms": cuda_ms(lambda: lr_fill_reference(dl, dr, cfg), iters),
    }
    print(f"timing {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    return t


def profile_scene(name, sc, frames, warmup=5):
    """Device time per frame by layer (K1, K2, the rest) and the device's
    idle share over ``frames`` frames of the kernel path, from
    torch.profiler: idle share = 1 - (union of device-activity intervals)
    / (first start to last end)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    left = torch.from_numpy(sc["left"]).to(DEV)
    right = torch.from_numpy(sc["right"]).to(DEV)
    for _ in range(warmup):
        stereo_pipeline(left, right, DEFAULT_CONFIG)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            stereo_pipeline(left, right, DEFAULT_CONFIG)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    assert spans, f"{name}: the profiler saw no device activity"
    layers = {"K1": 0.0, "K2": 0.0, "other": 0.0}
    busy, cur_start, cur_end = 0.0, *spans[0][:2]
    for start, end, kname in spans:
        layer = ("K1" if "guided_wta" in kname
                 else "K2" if "lr_fill" in kname else "other")
        layers[layer] += end - start
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = spans[-1][1] - spans[0][0]
    per_frame = {k: v / frames / 1e3 for k, v in layers.items()}
    print(f"profile {name}: device window {window / frames / 1e3:.4f} ms/frame, "
          + ", ".join(f"{k} {v:.4f} ms/frame" for k, v in per_frame.items())
          + f", {len(spans) / frames:.1f} device activities/frame, "
          f"device idle share {1 - busy / window:.4f}")


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
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas: {line.strip()}")

    scenes = [("288x384", make_scene(288, 384, ndisp=16)),
              ("1992x3008", make_scene(1992, 3008, ndisp=16))]
    grays = {name: tuple(rgb_to_grayscale(torch.from_numpy(sc[k]).to(DEV), DEFAULT_CONFIG)
                         for k in ("left", "right"))
             for name, sc in scenes}
    k1_err, k1_maps = check_k1(grays)
    k2_err = check_k2(k1_maps)

    outs, (k1_launches, k2_launches) = drive_main_path(scenes)
    for (name, sc), out in zip(scenes, outs):
        check_outputs(name, sc, out)

    times = {name: time_scene(name, sc, iters)
             for (name, sc), iters in zip(scenes, (50, 10))}
    for (name, sc), frames in zip(scenes, (50, 10)):
        profile_scene(name, sc, frames)
    big = times["1992x3008"]
    record = {"kernels": [
        {"name": "guided_wta (K1)", "route": "cuda",
         "source": "stereo_matching_cuda_tpu_torch/csrc/guided_wta.cu",
         "replaces": "stereo_matching_cuda_tpu/ops/pallas_guided.py:848",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": big["k1_ms"], "plain_ms": big["k1_plain_ms"]},
        {"name": "lr_fill (K2)", "route": "cuda",
         "source": "stereo_matching_cuda_tpu_torch/csrc/lr_fill.cu",
         "replaces": "stereo_matching_cuda_tpu/ops/pallas_post.py:69",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": big["k2_ms"], "plain_ms": big["k2_plain_ms"]},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
