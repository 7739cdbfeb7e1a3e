"""K3 (``stereo_matching_cuda_tpu_torch/csrc/guided_wta.cu``) per output
tile and through its wrapper, on one NVIDIA GPU.

    python3 scripts/torch_k3_tiles.py [--root DIR] [--wrappers-only]

Run from the repository root on a machine with a CUDA GPU and ``nvcc``.
It prints the card's name and power limit, K3's registers and spills as
ptxas reports them, and for each frame of ``FRAMES`` (smoothed random
pairs, the right a 6-column shift of the left): ms per launch through
``guided_wta_fused`` (the wrapper's own tile, named), then through
``_kernels.guided_wta`` at every tile of ``TILES`` whose shared memory
fits one block, with its CTAs and the CTAs per SM its shared memory
allows.  Every tile's maps must equal the wrapper's bit for bit (K3's
bits do not depend on the tile), and the wrapper's are held to the plain
version (``guided_wta_fused_reference``, on the card) at the fused bound
on the frames of at most 32 disparities.  CUDA events after warm-up
(``timing.cuda_ms``), in one process.

``--root DIR`` imports the package from another checkout (for example
the parent commit unpacked with ``git archive`` into the gitignored
``_scratch/``); ``--wrappers-only`` times the wrapper alone, which every
checkout of the port has.  To compare two checkouts, run old, new, new,
old in one call.  ``--write-divisions DIR`` writes a copy of this
checkout's package into DIR whose K3 divides by the window area (twice in
the a/b pass, twice in q) where it multiplies by its reciprocal, and
exits; ``--root DIR`` then times that variant, the measure of the
reciprocal's effect.  Exits non-zero without a CUDA device, and after the
last frame if any tile's bits differed.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# (h, w, disparities, launches a window)
FRAMES = ((288, 384, 16, 50), (576, 768, 16, 30), (864, 1152, 16, 20),
          (1504, 2048, 16, 10), (1992, 3008, 16, 10), (288, 384, 64, 20),
          (1988, 2948, 128, 3))
TILES = ((64, 64), (64, 56), (64, 48), (32, 32), (32, 16), (32, 8))


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


# The reciprocal of the window area in csrc/guided_wta.cu, and the
# divisions that take its place in --write-divisions' variant.
DIVISIONS = (
    ("guided_ab_recip(s1, s2, recip_area(gy, gx, H, W, R, rk),",
     "guided_ab(s1, s2, window_area(gy, gx, H, W, R),"),
    ("rq[i] = recip_area(y0 + yq + i, x0 + cq, H, W, R, rk);",
     "rq[i] = window_area(y0 + yq + i, x0 + cq, H, W, R);"),
    ("__fmul_rn(__fmaf_rn(sa, (float)iq[i * g.I1C], sb), rq[i]);",
     "(sa / rq[i]) * (float)iq[i * g.I1C] + sb / rq[i];"))


def write_divisions(root: Path, out: Path) -> None:
    """A copy of ``root``'s package in ``out`` with K3's DIVISIONS made."""
    pkg = out / "stereo_matching_cuda_tpu_torch"
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(root / "stereo_matching_cuda_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = pkg / "csrc" / "guided_wta.cu"
    text = src.read_text()
    for old, new in DIVISIONS:
        if old not in text:
            raise SystemExit(f"not in {src}: {old}")
        text = text.replace(old, new)
    src.write_text(text)


def textured_pair(h, w, seed):
    """Smoothed random gray pair on the card, the right a 6-column shift
    of the left (chip_smoke.py's)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(h, w + 32)).astype(np.float32)
    base = ((base + np.roll(base, 1, 1) + np.roll(base, -1, 1)
             + np.roll(base, 1, 0)) / 4).astype(np.uint8)
    return tuple(torch.from_numpy(np.ascontiguousarray(base[None, :, x:x + w])).cuda()
                 for x in (16, 10))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--wrappers-only", action="store_true")
    ap.add_argument("--write-divisions", metavar="DIR")
    args = ap.parse_args()
    if args.write_divisions:
        write_divisions(Path(args.root), Path(args.write_divisions))
        return 0
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.root)
    from stereo_matching_cuda_tpu_torch import StereoConfig
    from stereo_matching_cuda_tpu_torch.ops import _kernels
    from stereo_matching_cuda_tpu_torch.ops.cost import cost_constants
    from stereo_matching_cuda_tpu_torch.ops.fused_guided import (
        guided_wta_fused, guided_wta_fused_reference)
    from stereo_matching_cuda_tpu_torch.timing import cuda_ms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"package {_kernels.__file__}")
    info = _kernels.build()
    for line in ptxas_lines(info["log"]):
        print(f"ptxas {line}")
    lib = info["lib"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    differ = []
    for h, w, d, iters in FRAMES:
        cfg = StereoConfig(d_min=-(d - 1), d_max=0)
        g1, g2 = textured_pair(h, w, h + d)
        tag = f"{h}x{w} D={d}"
        ms = cuda_ms(lambda: guided_wta_fused(g1, g2, cfg.d_min, cfg), iters)
        if args.wrappers_only:
            print(f"{tag}: wrapper {ms:.4f} ms")
            continue
        tw, th = _kernels.guided_wta_tile(cfg.radius, d, h, w, n_sm)
        best_w, dmap_w = guided_wta_fused(g1, g2, cfg.d_min, cfg)
        note = ""
        if d <= 32:
            best_p, dmap_p = guided_wta_fused_reference(g1, g2, cfg.d_min, cfg)
            flips = int((dmap_w != dmap_p).sum())
            err = float((best_w - best_p).abs().max())
            assert flips <= max(4, 2e-3 * h * w), (tag, flips)
            torch.testing.assert_close(best_w, best_p, atol=2e-3, rtol=1e-4)
            del best_p, dmap_p
            note = f"; {flips} flips, max |best - plain| {err:.3g} against the plain version"
        print(f"{tag}: wrapper {ms:.4f} ms, tile {tw}x{th}{note}")
        best = torch.empty((1, h, w), dtype=torch.float32, device="cuda")
        dmap = torch.empty_like(best)
        for tw, th in TILES:
            smem = lib.guided_wta_smem_bytes(cfg.radius, tw, th, d)
            if smem > _kernels._SMEM_LIMIT:
                continue

            def direct():
                _kernels.guided_wta(g1, g2, best, dmap, cfg.d_min, d, cfg.radius,
                                    cost_constants(cfg), cfg.eps, tile_rows=th, tile_cols=tw)

            direct()
            same = torch.equal(best, best_w) and torch.equal(dmap, dmap_w)
            ctas = -(-w // tw) * -(-h // th)
            print(f"{tag}: tile {tw}x{th}, {ctas} CTAs ({ctas / n_sm:.2f} a SM), smem {smem} B "
                  f"({_kernels.smem_ctas_per_sm(smem)} CTAs/SM by smem): "
                  f"{cuda_ms(direct, iters):.4f} ms; bits equal to the wrapper's: {same}")
            if not same:
                differ.append(f"{tag} tile {tw}x{th}")
        del g1, g2, best, dmap
    if differ:
        print(f"bits differ from the wrapper's tile: {differ}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
