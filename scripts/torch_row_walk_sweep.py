"""The single-view row-walk kernel K1 (``csrc/guided_wta_stream.cu``) per
launch shape beside the tiled kernel K3, and the post kernel K2
(``csrc/lr_fill.cu``), on one NVIDIA GPU.

    python3 scripts/torch_row_walk_sweep.py [--root DIR] [--wrappers-only]

Run from the repository root on a machine with a CUDA GPU and ``nvcc``.
It prints the card's name and power limit, the registers and spills of
K1 and K2 as ptxas reports them, and for 288x384 and 1992x3008 frames at
16 and 8 disparities (random frames): ms per launch through the wrappers
(K1 and K3 through ``guided_wta_fused``, one view; K2 through
``lr_fill_fused`` on random label maps, at 16 disparities, checked bit
for bit against its plain version), by CUDA events and as the kernel's
own device time from torch.profiler (the events also count the host's
launch gaps, which dominate K2 at 288x384).  Then K1 at each step (16, 8 rows)
and band whose shared memory fits two CTAs per SM, each step first
checked against the plain version on the frame (the fused bound), with
the shape the wrapper picks marked.  K1's tile is 64 columns; the 32-
and 64-column tiles were compared with a build that had both (PERF.md,
Findings: K2 and K1 redesigned).  CUDA events after warm-up, in one
process.

``--root DIR`` imports the package from another checkout (for example
the parent commit unpacked with ``git archive``); with
``--wrappers-only`` only the wrapper times are taken, which any checkout
from the row-walk port on gives.  Run the two checkouts in turns (old,
new, new, old) to compare them on one card.  Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from torch_k3_tiles import ptxas_lines

SHAPES = ((288, 384, 16, 50), (1992, 3008, 16, 10), (288, 384, 8, 50),
          (1992, 3008, 8, 10))
KERNELS = {"K1": "guided_wta_stream_kernel", "K2": "lr_fill_kernel", "K3": "guided_wta_kernel"}


def device_ms(call, iters, kernel):
    """Mean device time per call of the kernel functions whose name
    contains ``kernel``, from torch.profiler after warm-up (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name)
    return us / iters / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--wrappers-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.root)
    from stereo_matching_cuda_tpu_torch import StereoConfig
    from stereo_matching_cuda_tpu_torch.ops import _kernels
    from stereo_matching_cuda_tpu_torch.ops.cost import cost_constants
    from stereo_matching_cuda_tpu_torch.ops.fused_guided import (
        guided_wta_fused, guided_wta_fused_reference)
    from stereo_matching_cuda_tpu_torch.ops.fused_post import lr_fill_fused, lr_fill_reference
    from stereo_matching_cuda_tpu_torch.timing import cuda_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"package {_kernels.__file__}")
    info = _kernels.build()
    if not args.wrappers_only:
        for kernel in ("guided_wta_stream_kernel", "lr_fill_kernel"):
            for line in ptxas_lines(info["log"], kernel):
                print(f"ptxas {line}")
    lib = info["lib"]
    n_sm = _kernels._n_sm(torch.device("cuda"))
    rng = np.random.default_rng(0)
    for h, w, d, iters in SHAPES:
        cfg = StereoConfig(d_min=-(d - 1), d_max=0)
        stream = dataclasses.replace(cfg, stream=True)
        g1, g2 = (torch.from_numpy(rng.integers(0, 256, (1, h, w), dtype=np.uint8)).cuda()
                  for _ in range(2))
        tag = f"{h}x{w} D={d}"
        calls = {"K1": lambda: guided_wta_fused(g1[0], g2[0], cfg.d_min, stream),
                 "K3": lambda: guided_wta_fused(g1[0], g2[0], cfg.d_min, cfg)}
        if d == 16:
            dl = torch.from_numpy(rng.integers(cfg.d_min, 1, (h, w)).astype(np.float32)).cuda()
            dr = torch.from_numpy(rng.integers(0, d, (h, w)).astype(np.float32)).cuda()
            for got, want in zip(lr_fill_fused(dl, dr, cfg), lr_fill_reference(dl, dr, cfg)):
                assert torch.equal(got, want), "K2 is not bit-identical to its plain version"
            calls["K2"] = lambda: lr_fill_fused(dl, dr, cfg)
        for name, call in calls.items():
            n = iters * (20 if name == "K2" else 1)
            print(f"{tag}: wrapper {name} {cuda_ms(call, n):.4f} ms, device "
                  f"{device_ms(call, n, KERNELS[name]):.4f} ms")
        if args.wrappers_only:
            continue

        best_p, dmap_p = guided_wta_fused_reference(g1, g2, cfg.d_min, cfg)
        best = torch.empty((1, h, w), dtype=torch.float32, device="cuda")
        dmap = torch.empty_like(best)
        launch = (cfg.d_min, d, cfg.radius, cost_constants(cfg), cfg.eps)

        def k1(**shape):
            _kernels.guided_wta_stream(g1, g2, best, dmap, *launch, **shape)

        for step in _kernels._STEPS:
            pick = _kernels.guided_wta_stream_band_rows(cfg.radius, d, h, w, n_sm, step)
            k1(band=pick, step=step)
            mism = int((dmap != dmap_p).sum())
            err = float((best - best_p).abs().max())
            print(f"{tag}: K1 check step {step} band {pick}: {mism} flips (bound "
                  f"{max(4, int(2e-3 * h * w))}), max |best-plain| {err:.3g}")
            assert mism <= max(4, 2e-3 * h * w)
            torch.testing.assert_close(best, best_p, atol=2e-3, rtol=1e-4)
            for band in _kernels._WALK_BANDS:
                smem = lib.guided_wta_stream_smem_bytes(cfg.radius, band, d, step)
                per_sm = _kernels.smem_ctas_per_sm(smem)
                if smem > _kernels._SMEM_LIMIT or per_sm < 2:
                    continue
                ms = cuda_ms(lambda: k1(band=band, step=step), iters)
                ctas = -(-w // _kernels._K1_TILE_W) * -(-h // band)
                print(f"{tag}: K1 step {step} band {band}, {ctas} CTAs, smem {smem} B "
                      f"({per_sm} CTAs/SM by smem): {ms:.4f} ms"
                      + ("  (picked)" if band == pick else ""))
        del g1, g2, best, dmap
    return 0


if __name__ == "__main__":
    sys.exit(main())
