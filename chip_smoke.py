"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU, ``nvcc`` and
``nvidia-smi``.  It builds the hand-written kernels from ``csrc/``,
checks each (K1, K2, K4, K5) against its plain PyTorch version on the
card, drives the kernel paths of ``compute_disparity`` on a 288x384
scene and a 1992x3008 (6 MP) scene: the default single-view path (K1 +
K2), the dual-view path forced with ``dual_view=True`` and the one the
automatic rule takes at 8 disparities (K4 at 288x384, K5 at 6 MP, + K2),
checks the launch counts and the results, times kernel and plain paths
with CUDA events, splits each path's device time by kernel and reads
the device's idle share with torch.profiler, and prints two JSON lines
last: the per-kernel record, then ``{"ok": true, "device": ...}``.  Any
failure raises and exits non-zero; with no CUDA device it exits
non-zero at once.
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
    guided_wta_fused, guided_wta_fused_dual, guided_wta_fused_dual_reference,
    guided_wta_fused_reference)
from stereo_matching_cuda_tpu_torch.ops.fused_post import lr_fill_fused, lr_fill_reference
from stereo_matching_cuda_tpu_torch.pipeline import stereo_pipeline
from stereo_matching_cuda_tpu_torch.utils.synth import make_scene

DEV = "cuda"
PLAIN = dataclasses.replace(DEFAULT_CONFIG, fused=False, post_fused=False)
CFG64 = StereoConfig(d_min=-63, d_max=0)
CFG8 = StereoConfig(d_min=-7, d_max=0)           # 8 disparities: the auto dual route
DUAL16 = dataclasses.replace(DEFAULT_CONFIG, dual_view=True)
# Kernel function names, as the profiler reports them, by layer.
KERNEL_NAMES = {"guided_wta_kernel": "K1", "lr_fill_kernel": "K2",
                "guided_wta_dual_kernel": "K4",
                "guided_wta_dual_stream_kernel": "K5"}
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


def check_k2(kernel_maps):
    """K2 against lr_fill_reference on the card: bit-identical on random
    label maps and on the label maps K1, K4 and K5 gave each main-path
    frame (``kernel_maps``: list of (cfg, left, right)); returns the
    largest |difference| seen (0.0 when it holds)."""
    cfg128 = StereoConfig(d_min=-127, d_max=0)
    cases = [(DEFAULT_CONFIG, *label_maps(DEFAULT_CONFIG, 288, 384, 0)),
             (cfg128, *label_maps(cfg128, 40, 300, 1))]
    dl, dr = label_maps(DEFAULT_CONFIG, 24, 256, 2)
    dr[3:6] = -DEFAULT_CONFIG.d_min + 50      # rows with no LR-consistent pixel
    cases.append((DEFAULT_CONFIG, dl, dr))
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
    return worst


def check_dual(kernel, grays):
    """K4 (``kernel`` "K4", stream=False) or K5 ("K5", stream=True)
    against guided_wta_fused_dual_reference on the card, per view at K1's
    bound: textured pairs at 16 and 8 disparities, a range straddling
    zero, 64 disparities (K5 only where it fits one block; otherwise a
    forced launch must raise), a B=3 batch against per-frame launches
    (bit for bit), and both views of each main-path frame (``grays``:
    name -> (cfg, gray pair)).  Returns max |Δbest| and the frames'
    (cfg, dmap_l, dmap_r) for K2."""
    stream = kernel == "K5"
    straddle = StereoConfig(d_min=-8, d_max=8)
    cases = [("textured", (288, 384), DEFAULT_CONFIG), ("textured", (288, 384), CFG8),
             ("textured", (33, 130), DEFAULT_CONFIG), ("textured", (64, 160), straddle)]
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


COUNT_NAMES = ("K1", "K2", "K4", "K5")


def reset_counts():
    guided_wta_fused.launches = 0
    lr_fill_fused.launches = 0
    guided_wta_fused_dual.k4_launches = 0
    guided_wta_fused_dual.k5_launches = 0


def counts():
    return (guided_wta_fused.launches, lr_fill_fused.launches,
            guided_wta_fused_dual.k4_launches, guided_wta_fused_dual.k5_launches)


def drive_path(path, runs):
    """compute_disparity on each (name, scene, cfg, expected launches per
    kernel) of one kernel path, with every count set to 0 just before and
    read just after.  Returns the outputs and the path's counts."""
    reset_counts()
    outs = []
    for name, sc, cfg, expect in runs:
        before = counts()
        outs.append(compute_disparity(sc["left"], sc["right"], cfg, DEV))
        delta = dict(zip(COUNT_NAMES, (a - b for a, b in zip(counts(), before))))
        print(f"{path} {name}: launches " + ", ".join(f"{k} {v}" for k, v in delta.items()))
        assert delta == expect, f"{path} {name}: expected launches {expect}, got {delta}"
    total = dict(zip(COUNT_NAMES, counts()))
    print(f"{path}: launches in this path's run {total}")
    return outs, total


def launches(k1=0, k2=0, k4=0, k5=0):
    return {"K1": k1, "K2": k2, "K4": k4, "K5": k5}


def check_outputs(name, sc, out, cfg=DEFAULT_CONFIG):
    """Shapes, finiteness and agreement with the plain path on the card."""
    plain = compute_disparity(
        sc["left"], sc["right"],
        dataclasses.replace(cfg, fused=False, post_fused=False), DEV)
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


def time_scene(name, sc, sc8, iters):
    """ms per frame (default, dual D=16 and auto D=8 kernel paths, the
    plain path) and per kernel launch (K4 and K5 forced at D=16, each
    against two K1 launches) for one frame size."""
    left = torch.from_numpy(sc["left"]).to(DEV)
    right = torch.from_numpy(sc["right"]).to(DEV)
    left8 = torch.from_numpy(sc8["left"]).to(DEV)
    right8 = torch.from_numpy(sc8["right"]).to(DEV)
    cfg = DEFAULT_CONFIG
    gl = rgb_to_grayscale(left, cfg)
    gr = rgb_to_grayscale(right, cfg)
    dl = guided_wta_fused(gl, gr, cfg.d_min, cfg)[1]
    dr = guided_wta_fused(gr, gl, cfg.d_min_right, cfg)[1]
    k4, k5 = (dataclasses.replace(cfg, stream=s) for s in (False, True))
    few = max(2, iters // 4)
    t = {
        "frame_ms": cuda_ms(lambda: stereo_pipeline(left, right, cfg), iters),
        "dual_frame_ms": cuda_ms(lambda: stereo_pipeline(left, right, DUAL16), iters),
        "d8_frame_ms": cuda_ms(lambda: stereo_pipeline(left8, right8, CFG8), iters),
        "frame_plain_ms": cuda_ms(lambda: stereo_pipeline(left, right, PLAIN), few),
        "k1_ms": cuda_ms(lambda: guided_wta_fused(gl, gr, cfg.d_min, cfg), iters),
        "k1_plain_ms": cuda_ms(
            lambda: guided_wta_fused_reference(gl, gr, cfg.d_min, cfg), few),
        "k4_ms": cuda_ms(lambda: guided_wta_fused_dual(gl, gr, k4), iters),
        "k5_ms": cuda_ms(lambda: guided_wta_fused_dual(gl, gr, k5), iters),
        "dual_plain_ms": cuda_ms(lambda: guided_wta_fused_dual_reference(gl, gr, cfg), few),
        "k2_ms": cuda_ms(lambda: lr_fill_fused(dl, dr, cfg), iters),
        "k2_plain_ms": cuda_ms(lambda: lr_fill_reference(dl, dr, cfg), iters),
    }
    print(f"timing {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    return t


def kernel_layer(kname):
    """The layer of a device activity: the kernel whose full function name
    the profiler's name (demangled or not) contains, else "other".  No
    kernel's name is a part of another's, so at most one matches."""
    found = [layer for name, layer in KERNEL_NAMES.items() if name in kname]
    assert len(found) <= 1, kname
    return found[0] if found else "other"


def profile_scene(name, sc, cfg, frames, warmup=5):
    """Device time per frame by layer (K1, K2, K4, K5, the rest) and the
    device's idle share over ``frames`` frames of the kernel path under
    ``cfg``, from torch.profiler: idle share = 1 - (union of
    device-activity intervals) / (first start to last end)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    left = torch.from_numpy(sc["left"]).to(DEV)
    right = torch.from_numpy(sc["right"]).to(DEV)
    for _ in range(warmup):
        stereo_pipeline(left, right, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            stereo_pipeline(left, right, cfg)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    assert spans, f"{name}: the profiler saw no device activity"
    layers = {"K1": 0.0, "K2": 0.0, "K4": 0.0, "K5": 0.0, "other": 0.0}
    busy, cur_start, cur_end = 0.0, *spans[0][:2]
    for start, end, kname in spans:
        layers[kernel_layer(kname)] += end - start
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

    sizes = {"288x384": (288, 384), "1992x3008": (1992, 3008)}
    scenes16 = {name: make_scene(*hw, ndisp=16) for name, hw in sizes.items()}
    scenes8 = {name: make_scene(*hw, ndisp=8) for name, hw in sizes.items()}

    def grays(sc):
        return tuple(rgb_to_grayscale(torch.from_numpy(sc[k]).to(DEV), DEFAULT_CONFIG)
                     for k in ("left", "right"))

    grays16 = {name: grays(sc) for name, sc in scenes16.items()}
    k1_err, k1_maps = check_k1(grays16)
    dual_grays = {}
    for name in sizes:
        dual_grays[f"{name} D=16"] = (DEFAULT_CONFIG, grays16[name])
        dual_grays[f"{name} D=8"] = (CFG8, grays(scenes8[name]))
    k4_err, k4_maps = check_dual("K4", dual_grays)
    k5_err, k5_maps = check_dual("K5", dual_grays)
    k2_err = check_k2([(DEFAULT_CONFIG, dl, dr) for dl, dr in k1_maps.values()]
                      + k4_maps + k5_maps)

    default_runs = [(name, scenes16[name], DEFAULT_CONFIG, launches(k1=2, k2=1))
                    for name in sizes]
    default_outs, default_counts = drive_path("default path", default_runs)
    dual_runs = []
    for name in sizes:
        # K4 below 200,000 px, K5 from there on (pipeline.use_stream)
        expect = launches(k2=1, k4=1) if name == "288x384" else launches(k2=1, k5=1)
        dual_runs += [(f"{name} D=16 dual_view=True", scenes16[name], DUAL16, expect),
                      (f"{name} D=8 auto", scenes8[name], CFG8, expect)]
    dual_outs, dual_counts = drive_path("dual-view path", dual_runs)
    for (name, sc, cfg, _), out in zip(default_runs + dual_runs, default_outs + dual_outs):
        check_outputs(name, sc, out, cfg)

    times = {name: time_scene(name, scenes16[name], scenes8[name], iters)
             for name, iters in zip(sizes, (50, 10))}
    for name, frames in zip(sizes, (50, 10)):
        profile_scene(f"{name} default", scenes16[name], DEFAULT_CONFIG, frames)
        profile_scene(f"{name} D=16 dual_view=True", scenes16[name], DUAL16, frames)
        profile_scene(f"{name} D=8 auto", scenes8[name], CFG8, frames)
    big = times["1992x3008"]
    pallas = "stereo_matching_cuda_tpu/ops/"
    csrc = "stereo_matching_cuda_tpu_torch/csrc/"
    record = {"kernels": [
        {"name": "guided_wta (K1)", "route": "cuda", "source": csrc + "guided_wta.cu",
         "replaces": pallas + "pallas_guided.py:848",
         "launches": default_counts["K1"], "max_abs_err": k1_err,
         "ms": big["k1_ms"], "plain_ms": big["k1_plain_ms"]},
        {"name": "lr_fill (K2)", "route": "cuda", "source": csrc + "lr_fill.cu",
         "replaces": pallas + "pallas_post.py:69",
         "launches": default_counts["K2"] + dual_counts["K2"], "max_abs_err": k2_err,
         "ms": big["k2_ms"], "plain_ms": big["k2_plain_ms"]},
        {"name": "guided_wta_dual (K4)", "route": "cuda",
         "source": csrc + "guided_wta_dual.cu",
         "replaces": pallas + "pallas_guided.py:1322",
         "launches": dual_counts["K4"], "max_abs_err": k4_err,
         "ms": big["k4_ms"], "plain_ms": big["dual_plain_ms"]},
        {"name": "guided_wta_dual_stream (K5)", "route": "cuda",
         "source": csrc + "guided_wta_dual_stream.cu",
         "replaces": pallas + "pallas_guided.py:1116",
         "launches": dual_counts["K5"], "max_abs_err": k5_err,
         "ms": big["k5_ms"], "plain_ms": big["dual_plain_ms"]},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
