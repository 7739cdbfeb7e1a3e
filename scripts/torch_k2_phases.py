"""Cycles per CTA in each phase of the post kernel K2 (``csrc/lr_fill.cu``)
on one NVIDIA GPU.

    python3 scripts/torch_k2_phases.py ROOT [--dry-run]

ROOT is a checkout whose ``lr_fill.cu`` this script knows how to mark:
this repository's K2 from its row-staging redesign on, or the one-CTA-a-
row K2 before it (for example the parent commit unpacked with ``git
archive``).  The script copies ROOT's package into a temporary directory,
inserts ``clock64()`` marks at the kernel's phase boundaries (thread 0 of
each CTA adds each phase's cycles to a device array), builds the copy,
launches it 200 times after warm-up on random 288x384 and 1992x3008
label maps at 16 disparities, and prints the mean cycles per CTA of each
phase.  The marks add a few instructions a phase; compare phases, not
totals, with unmarked builds.  ``--dry-run`` only marks the copy and
prints the number of marks.  Exits non-zero without a CUDA device.

Phases (staging kernel): 0 entry, 1 rows staged and first barrier, 2 LR
check and run scan, 3 warp scans and second barrier, 4 occlusion store
and fill, 5 third barrier, 6 filled-row store.  (One-CTA-a-row kernel):
0 entry, 2 LR check with its loads and stores, 3 scans and barriers, 6
fill.
"""

from __future__ import annotations

import ctypes
import shutil
import sys
import tempfile
from pathlib import Path

PROFILE = '''
__device__ unsigned long long g_prof[16];
__device__ inline void mark(int i, long long& t0, bool lead) {
  if (lead) {
    const long long t = clock64();
    atomicAdd(&g_prof[i], (unsigned long long)(t - t0));
    t0 = t;
  }
}
'''
READERS = '''
extern "C" int k2_prof_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
extern "C" int k2_prof_reset() {
  unsigned long long z[16] = {};
  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
'''
END = "  mark(6, t0, lead);\n  if (lead) atomicAdd(&g_prof[15], 1ull);\n}"
# (anchor, marked) pairs of each kernel version, in source order.
STAGING = [
    ("  const int W = p.W;\n  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;",
     "  const int W = p.W;\n  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  long long t0 = clock64();\n  const bool lead = tid == 0;\n  mark(0, t0, lead);"),
    ("  if (live) stage_rows<TPR>(a, dl + off, b, dr + off, W, head, t);\n  __syncthreads();\n",
     "  if (live) stage_rows<TPR>(a, dl + off, b, dr + off, W, head, t);\n  __syncthreads();\n"
     "  mark(1, t0, lead);\n"),
    ("  // The last valid pixel before the run and the first one after it: a",
     "  mark(2, t0, lead);\n  // The last valid pixel before the run and the first one after it: a"),
    ("  if (live) store_row<TPR>(occ_out + off, a, W, head, t);\n",
     "  mark(3, t0, lead);\n  if (live) store_row<TPR>(occ_out + off, a, W, head, t);\n"),
    ("  __syncthreads();\n\n  if (live) store_row<TPR>(fill_out + off, b, W, head, t);\n}",
     "  mark(4, t0, lead);\n  __syncthreads();\n  mark(5, t0, lead);\n"
     "  if (live) store_row<TPR>(fill_out + off, b, W, head, t);\n" + END),
]
ONE_ROW = [
    ("  const int W = p.W;\n  const size_t row = (size_t)blockIdx.x * W;",
     "  const int W = p.W;\n  const size_t row = (size_t)blockIdx.x * W;\n"
     "  long long t0 = clock64();\n  const bool lead = threadIdx.x == 0;\n  mark(0, t0, lead);"),
    ("  // Inclusive warp scans: prefix max forward, suffix max backward.",
     "  mark(2, t0, lead);\n  // Inclusive warp scans: prefix max forward, suffix max backward."),
    ("  // Exclusive carries into this thread's run.",
     "  mark(3, t0, lead);\n  // Exclusive carries into this thread's run."),
    ("    fill_out[row + x] = occluded ? fmaxf(unpack(fwd_s[x], p), unpack(m_b, p)) : o;\n  }\n}",
     "    fill_out[row + x] = occluded ? fmaxf(unpack(fwd_s[x], p), unpack(m_b, p)) : o;\n  }\n"
     + END),
]


def marked_copy(root: Path, dest: Path) -> int:
    """Copy root's package to dest with K2 marked; returns the marks."""
    pkg = dest / "stereo_matching_cuda_tpu_torch"
    shutil.copytree(root / "stereo_matching_cuda_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = pkg / "csrc" / "lr_fill.cu"
    text = src.read_text()
    pairs = STAGING if "stage_rows" in text else ONE_ROW
    for anchor, marked in pairs:
        if anchor not in text:
            raise SystemExit(f"{src}: not a K2 this script knows (no {anchor.strip()[:40]!r})")
        text = text.replace(anchor, marked)
    text = text.replace("namespace {\n", "namespace {\n" + PROFILE, 1)
    text = text.replace("// Dynamic shared memory of one row (bytes).",
                        READERS + "\n// Dynamic shared memory of one row (bytes).")
    src.write_text(text)
    kernels = pkg / "ops" / "_kernels.py"
    kernels.write_text(kernels.read_text().replace(
        "_SIGNATURES = {",
        '_SIGNATURES = {\n    "k2_prof_read": (_I, [_P]),\n    "k2_prof_reset": (_I, []),', 1))
    return text.count("mark(") - 1


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        marks = marked_copy(root, Path(tmp))
        if "--dry-run" in sys.argv:
            print(f"{root}: {marks} marks")
            return 0
        import numpy as np
        import torch
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        sys.path.insert(0, tmp)
        from stereo_matching_cuda_tpu_torch import StereoConfig
        from stereo_matching_cuda_tpu_torch.ops import _kernels

        lib = _kernels.build()["lib"]
        cfg = StereoConfig()
        rng = np.random.default_rng(0)
        for h, w in ((288, 384), (1992, 3008)):
            dl = torch.from_numpy(rng.integers(cfg.d_min, 1, (h, w)).astype(np.float32)).cuda()
            dr = torch.from_numpy(rng.integers(0, 16, (h, w)).astype(np.float32)).cuda()
            occ, filled = torch.empty_like(dl), torch.empty_like(dl)

            def call():
                _kernels.lr_fill(dl, dr, occ, filled, cfg.d_min, cfg.size_d, cfg.d_lr,
                                 cfg.d_occlusion, cfg.v_min)

            for _ in range(5):
                call()
            torch.cuda.synchronize()
            lib.k2_prof_reset()
            for _ in range(200):
                call()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            lib.k2_prof_read(ctypes.byref(buf))
            n = buf[15]
            print(f"{root} {h}x{w}: CTAs counted {n}; mean cycles per CTA by phase: "
                  + ", ".join(f"{i}:{buf[i] / n:.0f}" for i in range(7) if buf[i]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
