"""Shape sweep of the port's single-view row-walk kernel K1
(``stereo_matching_cuda_tpu_torch/csrc/guided_wta_stream.cu``) beside the
tiled kernel K3 on one NVIDIA GPU.

    python3 scripts/torch_row_walk_sweep.py

Run from the repository root on a machine with a CUDA GPU and ``nvcc``.
For 288x384 and 1992x3008 frames at 16 disparities it prints the card's
name and power limit, K3's ms per launch, and K1's ms per launch at each
tile width (32, 64 columns) and band height whose shared memory fits one
block, with the band the wrapper picks; CUDA events after warm-up, all
in one process.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from stereo_matching_cuda_tpu_torch import DEFAULT_CONFIG  # noqa: E402
from stereo_matching_cuda_tpu_torch.ops import _kernels  # noqa: E402
from stereo_matching_cuda_tpu_torch.ops.cost import cost_constants  # noqa: E402
from stereo_matching_cuda_tpu_torch.timing import cuda_ms  # noqa: E402

BANDS = (8, 16, 24, 32, 48, 64, 96, 128)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    lib = _kernels.build()["lib"]
    cfg = DEFAULT_CONFIG
    args = (cfg.d_min, cfg.size_d, cfg.radius, cost_constants(cfg), cfg.eps)
    n_sm = _kernels._n_sm(torch.device("cuda"))
    rng = np.random.default_rng(0)
    for h, w, iters in ((288, 384, 50), (1992, 3008, 5)):
        g1, g2 = (torch.from_numpy(rng.integers(0, 256, (1, h, w), dtype=np.uint8)).cuda()
                  for _ in range(2))
        best = torch.empty((1, h, w), dtype=torch.float32, device="cuda")
        dmap = torch.empty_like(best)
        k3 = cuda_ms(lambda: _kernels.guided_wta(g1, g2, best, dmap, *args), iters)
        print(f"{h}x{w} D={cfg.size_d}: K3 {k3:.4f} ms")
        for tw in (32, 64):
            pick = _kernels.guided_wta_stream_band_rows(cfg.radius, cfg.size_d, h, w,
                                                        n_sm, tw)
            for band in BANDS:
                smem = lib.guided_wta_stream_smem_bytes(tw, cfg.radius, band, cfg.size_d)
                if smem > _kernels._SMEM_LIMIT:
                    continue
                ms = cuda_ms(lambda: _kernels.guided_wta_stream(
                    g1, g2, best, dmap, *args, band=band, tile_w=tw), iters)
                mark = "  (picked)" if band == pick else ""
                print(f"{h}x{w} D={cfg.size_d}: K1 tile {tw} band {band} smem {smem} B: "
                      f"{ms:.4f} ms{mark}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
