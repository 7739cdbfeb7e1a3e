"""Build and bind the hand-written CUDA kernels in ``csrc/``.

The sources have a plain C interface.  At first use they are compiled by
``nvcc`` for ``sm_90a`` into one shared library under ``_build/``, named
by a hash of the sources and flags (a changed source builds anew), and
loaded with ``ctypes``.  Nothing here runs at import time: the CPU tests
import every module on machines with no CUDA toolkit.

Each C entry point returns the launch's ``cudaGetLastError()``; a
non-zero code raises ``RuntimeError``.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "guided_wta_launch": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _F, _F, _F, _F, _F, ctypes.c_double, _P]),
    "guided_wta_smem_bytes": (ctypes.c_longlong, [_I, _I, _I]),
    "lr_fill_launch": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "lr_fill_smem_bytes": (ctypes.c_longlong, [_I]),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


@functools.lru_cache(maxsize=None)
def build() -> dict:
    """Compile ``csrc/*.cu`` (once per source hash) and load the library.
    Returns {"lib": CDLL, "path": str, "seconds": build time (0 when the
    library was already built), "log": nvcc's output}."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libstereo_kernels_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)],
            capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return {"lib": lib, "path": str(so), "seconds": seconds, "log": log}


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# Largest dynamic shared memory one block may use on sm_90 (bytes).
_SMEM_LIMIT = 232_448


def guided_wta_tile_rows(radius: int, size_d: int) -> int:
    """K1's output tile height: the tallest of 32, 16, 8 whose shared
    memory fits one block (a taller tile recomputes less halo)."""
    lib = build()["lib"]
    for th in (32, 16, 8):
        if lib.guided_wta_smem_bytes(radius, th, size_d) <= _SMEM_LIMIT:
            return th
    raise ValueError(f"radius {radius} with {size_d} disparities needs more "
                     "shared memory than one block has")


def guided_wta(gray1, gray2, best, dmap, dmin, size_d, radius, constants,
               eps) -> None:
    """Launch K1 (csrc/guided_wta.cu) on the current stream."""
    lib = build()["lib"]
    h, w = gray1.shape
    th = guided_wta_tile_rows(radius, size_d)
    err = lib.guided_wta_launch(
        gray1.data_ptr(), gray2.data_ptr(), best.data_ptr(), dmap.data_ptr(),
        h, w, dmin, size_d, radius, th, *constants, float(eps),
        _stream(gray1))
    _check(err, "guided_wta_launch")


def lr_fill(dl, dr, occ, filled, dmin, size_d, d_lr, d_occlusion,
            v_min) -> None:
    """Launch K2 (csrc/lr_fill.cu) on the current stream."""
    lib = build()["lib"]
    h, w = dl.shape
    if lib.lr_fill_smem_bytes(w) > _SMEM_LIMIT:
        raise ValueError(f"row width {w} exceeds the post kernel's shared memory")
    err = lib.lr_fill_launch(
        dl.data_ptr(), dr.data_ptr(), occ.data_ptr(), filled.data_ptr(),
        h, w, dmin, size_d, d_lr, d_occlusion, v_min, _stream(dl))
    _check(err, "lr_fill_launch")
