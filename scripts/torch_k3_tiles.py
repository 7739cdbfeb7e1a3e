"""K3 (``stereo_matching_cuda_tpu_torch/csrc/guided_wta.cu``) per tile
height and through its wrapper, on one NVIDIA GPU.

    python3 scripts/torch_k3_tiles.py [--root DIR]

Run from the repository root on a machine with a CUDA GPU and ``nvcc``.
It prints the card's name and power limit, K3's registers and spills as
ptxas reports them, and for 288x384 at 16 and 64 disparities, 1992x3008
at 16 and 1988x2948 at 128 (random frames): ms per launch through
``guided_wta_fused`` (the wrapper's own tile) and through
``_kernels.guided_wta`` at each tile height of 32, 16 and 8 whose shared
memory fits one block; CUDA events after warm-up, in one process.

``--root DIR`` imports the package from another checkout (for example
an older commit unpacked with ``git archive``) whose ``guided_wta``
takes ``tile_rows``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SHAPES = ((288, 384, 16, 50), (1992, 3008, 16, 10), (288, 384, 64, 20),
          (1988, 2948, 128, 3))


def ptxas_lines(log: str, kernel: str = "guided_wta_kernel") -> list[str]:
    """ptxas's register, shared-memory and spill lines of each kernel
    function whose (mangled) name contains ``kernel``."""
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
        elif fn and ("registers" in line or "spill" in line):
            out.append(f"{fn}: {re.sub(r'^ptxas\s+info\s*:\s*', '', line.strip())}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.root)
    from stereo_matching_cuda_tpu_torch import StereoConfig
    from stereo_matching_cuda_tpu_torch.ops import _kernels
    from stereo_matching_cuda_tpu_torch.ops.cost import cost_constants
    from stereo_matching_cuda_tpu_torch.ops.fused_guided import guided_wta_fused
    from stereo_matching_cuda_tpu_torch.timing import cuda_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"package {_kernels.__file__}")
    info = _kernels.build()
    for line in ptxas_lines(info["log"]):
        print(f"ptxas {line}")
    lib = info["lib"]
    rng = np.random.default_rng(0)
    for h, w, d, iters in SHAPES:
        cfg = StereoConfig(d_min=-(d - 1), d_max=0)
        g1, g2 = (torch.from_numpy(rng.integers(0, 256, (1, h, w), dtype=np.uint8)).cuda()
                  for _ in range(2))
        best = torch.empty((1, h, w), dtype=torch.float32, device="cuda")
        dmap = torch.empty_like(best)
        tag = f"{h}x{w} D={d}"
        ms = cuda_ms(lambda: guided_wta_fused(g1[0], g2[0], cfg.d_min, cfg), iters)
        print(f"{tag}: wrapper {ms:.4f} ms")

        def direct(th):
            _kernels.guided_wta(g1, g2, best, dmap, cfg.d_min, d, cfg.radius,
                                cost_constants(cfg), cfg.eps, tile_rows=th)

        for th in (32, 16, 8):
            smem = lib.guided_wta_smem_bytes(cfg.radius, th, d)
            if smem > _kernels._SMEM_LIMIT:
                continue
            ctas = -(-w // 32) * -(-h // th)
            print(f"{tag}: tile {th} rows, {ctas} CTAs, smem {smem} B "
                  f"({_kernels.smem_ctas_per_sm(smem)} CTAs/SM by smem): "
                  f"{cuda_ms(lambda: direct(th), iters):.4f} ms")
        del g1, g2, best, dmap
    return 0


if __name__ == "__main__":
    sys.exit(main())
