"""The dual-view kernels K4 (``csrc/guided_wta_dual.cu``) and K5
(``csrc/guided_wta_dual_stream.cu``) per launch shape, beside K3, on one
NVIDIA GPU.

    python3 scripts/torch_dual_tiles.py [--root DIR] [--wrappers-only]

Run from the repository root on a machine with a CUDA GPU and ``nvcc``.
It prints the card's name and power limit, the registers and spills of
K4 and K5 as ptxas reports them, and for 288x384 and 1992x3008 frames at
16 and 8 disparities (random frames): ms per launch through the wrappers
(K4 and K5 through ``guided_wta_fused_dual``, both views; K3 through
``guided_wta_fused``, one view), then K4 at each tile height of 32, 16
and 8 rows and K5 at each step (16, 8) and band whose shared memory fits
at least two CTAs per SM, with the shapes the wrappers pick marked.  CUDA events after warm-up, in one process.

``--root DIR`` imports the package from another checkout (for example
the parent commit unpacked with ``git archive``); with
``--wrappers-only`` only the wrapper times are taken, which any checkout
from the dual-view port on gives.  Run the two checkouts in turns (old,
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
        guided_wta_fused, guided_wta_fused_dual)
    from stereo_matching_cuda_tpu_torch.timing import cuda_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"package {_kernels.__file__}")
    info = _kernels.build()
    for kernel in ("guided_wta_dual_kernel", "guided_wta_dual_stream_kernel"):
        for line in ptxas_lines(info["log"], kernel):
            print(f"ptxas {line}")
    lib = info["lib"]
    n_sm = _kernels._n_sm(torch.device("cuda"))
    rng = np.random.default_rng(0)
    for h, w, d, iters in SHAPES:
        cfg = StereoConfig(d_min=-(d - 1), d_max=0)
        g1, g2 = (torch.from_numpy(rng.integers(0, 256, (1, h, w), dtype=np.uint8)).cuda()
                  for _ in range(2))
        tag = f"{h}x{w} D={d}"
        k4, k5 = (dataclasses.replace(cfg, stream=s) for s in (False, True))
        for name, call in (
                ("K4", lambda: guided_wta_fused_dual(g1[0], g2[0], k4)),
                ("K5", lambda: guided_wta_fused_dual(g1[0], g2[0], k5)),
                ("K3 (one view)", lambda: guided_wta_fused(g1[0], g2[0], cfg.d_min, cfg))):
            print(f"{tag}: wrapper {name} {cuda_ms(call, iters):.4f} ms")
        if args.wrappers_only:
            continue

        reach = _kernels.dual_reach(cfg.d_min, d)
        outs = [torch.empty((1, h, w), dtype=torch.float32, device="cuda")
                for _ in range(4)]
        launch = (cfg.d_min, d, cfg.radius, cost_constants(cfg), cfg.eps)
        pick = _kernels.guided_wta_dual_tile_rows(cfg.radius, reach)
        step_pick = _kernels.guided_wta_dual_stream_step(cfg.radius, reach)
        pick5 = (step_pick, _kernels.guided_wta_dual_stream_band_rows(
            cfg.radius, reach, h, w, n_sm, step_pick))
        for th in (32, 16, 8):
            smem = lib.guided_wta_dual_smem_bytes(cfg.radius, th, reach)
            if smem > _kernels._SMEM_LIMIT:
                continue
            ms = cuda_ms(lambda: _kernels.guided_wta_dual(g1, g2, outs, *launch,
                                                          tile_rows=th), iters)
            print(f"{tag}: K4 tile {th} rows, {-(-w // 32) * -(-h // th)} CTAs, smem {smem} B "
                  f"({_kernels.smem_ctas_per_sm(smem)} CTAs/SM by smem): {ms:.4f} ms"
                  + ("  (picked)" if th == pick else ""))
        for step in _kernels._STEPS:
            for band in _kernels._BANDS:
                smem = lib.guided_wta_dual_stream_smem_bytes(cfg.radius, band, reach, step)
                per_sm = _kernels.smem_ctas_per_sm(smem)
                if smem > _kernels._SMEM_LIMIT or per_sm < 2:
                    continue
                ms = cuda_ms(lambda: _kernels.guided_wta_dual_stream(
                    g1, g2, outs, *launch, band=band, step=step), iters)
                print(f"{tag}: K5 step {step} band {band}, "
                      f"{-(-w // 32) * -(-h // band)} CTAs, smem {smem} B "
                      f"({per_sm} CTAs/SM by smem): {ms:.4f} ms"
                      + ("  (picked)" if (step, band) == pick5 else ""))
        del g1, g2, outs
    return 0


if __name__ == "__main__":
    sys.exit(main())
