"""A SHA-256 of each matching and post kernel's outputs on chip_smoke.py's
scene frames, on one NVIDIA GPU.

    python3 scripts/torch_kernel_hashes.py [--root DIR]

Run from the repository root on a machine with a CUDA GPU and ``nvcc``.
For the 288x384 and 1992x3008 scenes (``utils.synth.make_scene``, seed 7)
at 16 disparities and at 8 (d in -7..0), it launches K1 on both views
(``stream=True``), K3 on both views, K4 and K5 (both views in one pass)
and K2 on K1's maps, and prints one line per kernel and frame: the hash
of the outputs' bytes, in order.  ``--root DIR`` imports the package from
another checkout (the parent commit unpacked with ``git archive`` into
the gitignored ``_scratch/``): two checkouts whose lines agree computed
the same bits.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import sys
from pathlib import Path

import torch


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:32]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.root)
    from stereo_matching_cuda_tpu_torch import DEFAULT_CONFIG, StereoConfig
    from stereo_matching_cuda_tpu_torch.ops import rgb_to_grayscale
    from stereo_matching_cuda_tpu_torch.ops.fused_guided import (
        guided_wta_fused, guided_wta_fused_dual)
    from stereo_matching_cuda_tpu_torch.ops.fused_post import lr_fill_fused
    from stereo_matching_cuda_tpu_torch.utils.synth import make_scene

    for (h, w), (d, cfg) in ((hw, dc) for hw in ((288, 384), (1992, 3008))
                             for dc in ((16, DEFAULT_CONFIG),
                                        (8, StereoConfig(d_min=-7, d_max=0)))):
        sc = make_scene(h, w, ndisp=d)
        gl, gr = (rgb_to_grayscale(torch.from_numpy(sc[k]).cuda(), cfg)
                  for k in ("left", "right"))
        tag = f"{h}x{w} D={d}"
        for kernel, stream in (("K1", True), ("K3", False)):
            c = dataclasses.replace(cfg, stream=stream)
            left = guided_wta_fused(gl, gr, cfg.d_min, c)
            right = guided_wta_fused(gr, gl, cfg.d_min_right, c)
            print(f"{tag} {kernel}: {digest(*left, *right)}")
            if kernel == "K1":
                print(f"{tag} K2 on K1's maps: "
                      f"{digest(*lr_fill_fused(left[1], right[1], cfg))}")
        for kernel, stream in (("K4", False), ("K5", True)):
            outs = guided_wta_fused_dual(gl, gr, dataclasses.replace(cfg, stream=stream))
            print(f"{tag} {kernel}: {digest(*outs)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
