"""Build and bind the hand-written CUDA kernels in ``csrc/``.

  K1 guided_wta_stream.cu       one view, row walk down a band
                                (guided_wta_stream): K5's blocks, steps
                                and bands, 64-column tiles
  K2 lr_fill.cu                 LR check + occlusion fill (lr_fill), rows
                                staged in shared memory, two a CTA
  K3 guided_wta.cu              one view, tiled (guided_wta): 32-column
                                tiles of 32, 16 or 8 rows, the tallest
                                of those that fit the most CTAs per SM
                                (guided_wta_tile_rows); 512-thread
                                blocks, 256 for 8 rows
  K4 guided_wta_dual.cu         both views in one pass, tiled
                                (guided_wta_dual): K3's tiles, blocks and
                                tile rule (guided_wta_dual_tile_rows)
  K5 guided_wta_dual_stream.cu  both views, row walk down a band
                                (guided_wta_dual_stream): 512-thread
                                blocks at two CTAs per SM, 16-row steps
                                where they fit (8 else), bands of at
                                most 96 rows

The sources have a plain C interface.  At first use each is compiled by
its own ``nvcc`` for ``sm_90a`` (all started together), and the objects
are linked into one shared library under ``_build/``, named by a hash of
the sources, headers and flags (a changed file builds anew), and loaded
with ``ctypes``.  Nothing here runs at import time: the CPU tests import
every module on machines with no CUDA toolkit.

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
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# N, H, W, dmin, D, R, tile or band rows; the cost constants; eps; stream.
_LAUNCH_ARGS = [_I] * 7 + [_F] * 5 + [ctypes.c_double, _P]
# The same with a tile (K1, K3): N, H, W, Hb, Wb, oy, ox, hy, hx, Hi, Wi,
# dmin, D, R, tile or band rows (and K1's step); the rest as above.
_TILE_LAUNCH_ARGS = [_I] * 15 + [_F] * 5 + [ctypes.c_double, _P]
_SIGNATURES = {
    "guided_wta_launch": (_I, [_P] * 4 + _TILE_LAUNCH_ARGS),
    "guided_wta_smem_bytes": (ctypes.c_longlong, [_I, _I, _I]),
    "guided_wta_stream_launch": (_I, [_P] * 5 + [_I] * 16 + [_F] * 5
                                 + [ctypes.c_double, _P]),
    "guided_wta_stream_smem_bytes": (ctypes.c_longlong, [_I] * 4),
    "guided_wta_stream_scratch_bytes": (ctypes.c_longlong, [_I] * 5),
    "lr_fill_launch": (_I, [_P, _P, _P, _P] + [_I] * 7 + [_P]),
    "lr_fill_smem_bytes": (ctypes.c_longlong, [_I]),
    "guided_wta_dual_launch": (_I, [_P] * 7 + _LAUNCH_ARGS),
    "guided_wta_dual_smem_bytes": (ctypes.c_longlong, [_I, _I, _I]),
    "guided_wta_dual_scratch_bytes": (ctypes.c_longlong, [_I] * 5),
    "guided_wta_dual_stream_launch": (_I, [_P] * 7 + [_I] * 8 + [_F] * 5
                                      + [ctypes.c_double, _P]),
    "guided_wta_dual_stream_smem_bytes": (ctypes.c_longlong, [_I] * 4),
    "guided_wta_dual_stream_scratch_bytes": (ctypes.c_longlong, [_I] * 5),
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
    """Compile ``csrc/*.cu`` (once per hash of the sources and headers)
    and load the library.
    Returns {"lib": CDLL, "path": str, "seconds": build time (0 when the
    library was already built), "log": nvcc's output}."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"libstereo_kernels_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
                     for src, obj in zip(sources, objs)]
            logs = [proc.communicate()[0] for proc in procs]
            log = "".join(logs)
            failed = [src.name for src, proc in zip(sources, procs) if proc.returncode]
            if failed:
                raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
            lib_tmp = str(Path(tmp) / so.name)
            proc = subprocess.run([nvcc, "-shared", "-o", lib_tmp, *objs],
                                  capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
            os.replace(lib_tmp, so)
        seconds = time.perf_counter() - t0
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


def dual_reach(dmin: int, size_d: int) -> int:
    """Column reach of the dual kernels' shared raw slice:
    max(0, d_max) + max(0, -d_min) (the JAX package's dual_geometry)."""
    return max(0, dmin + size_d - 1) + max(0, -dmin)


# Shared memory of one SM on sm_90, and what the system reserves of it
# for each resident block (bytes).
_SMEM_PER_SM = 233_472
_SMEM_RESERVED_PER_BLOCK = 1_024

# CTAs per SM each kernel's tile or band is sized for: occupancy first,
# then height (PERF.md, Findings: K3, K4 and K5 redesigned).  The
# 512-thread blocks of K1, K3, K4 and K5 are built for two
# (``__launch_bounds__(512, 2)``: at most 64 registers a thread), and so
# are K3's and K4's 256-thread blocks of 8-row tiles.
_K1_CTAS_PER_SM = 2
_K3_CTAS_PER_SM = 2
_K4_CTAS_PER_SM = 2
_K5_CTAS_PER_SM = 2


def smem_ctas_per_sm(smem: int) -> int:
    """CTAs of ``smem`` bytes of dynamic shared memory that fit one SM."""
    return _SMEM_PER_SM // (smem + _SMEM_RESERVED_PER_BLOCK)


def _fullest_rows(smem_by_rows: dict, per_sm: int) -> list:
    """Of {rows: shared-memory bytes}, in the table's order, the heights
    that fit the most CTAs on one SM (counting up to ``per_sm``); empty if
    none fits one block."""
    occ = {r: min(per_sm, smem_ctas_per_sm(b))
           for r, b in smem_by_rows.items() if b <= _SMEM_LIMIT}
    return [r for r in occ if occ[r] == max(occ.values())]


def _pick_rows(smem_by_rows: dict, per_sm: int, h: int, w: int,
               n_sm: int, tile_w: int = 32) -> int | None:
    """Of {rows: shared-memory bytes}, tallest first: among the heights
    that fit the most CTAs on one SM (counting up to ``per_sm``), the
    tallest that still gives a (h, w) frame as many CTAs
    (ceil(w/tile_w) x ceil(h/rows)) as the card has SMs, else the lowest.
    None if none fits one block.  The batch size does not enter, so a
    batch computes each frame as a lone call does, bit for bit."""
    rows = _fullest_rows(smem_by_rows, per_sm)
    if not rows:
        return None
    strips = -(-w // tile_w)
    return next((r for r in rows if strips * -(-h // r) >= n_sm), rows[-1])


@functools.lru_cache(maxsize=None)
def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _tallest_fullest(smem_by_rows: dict, per_sm: int, what: str) -> int:
    """Of {rows: shared-memory bytes}, tallest first: occupancy first (up
    to ``per_sm`` CTAs per SM), then the tallest; ``what`` names the
    launch in the error raised when none fits one block."""
    rows = _fullest_rows(smem_by_rows, per_sm)
    if not rows:
        raise ValueError(f"{what} needs more shared memory than one block has")
    return rows[0]


@functools.lru_cache(maxsize=None)
def guided_wta_tile_rows(radius: int, size_d: int) -> int:
    """K3's output tile height, of 32, 16 and 8: occupancy first (up to
    ``_K3_CTAS_PER_SM``), then the tallest.  Neither the frame nor the
    batch enters: with 16 warps a block, a 32-row tile's smaller halo
    beat 16-row tiles that fill every SM (PERF.md, Findings: K3, K4 and
    K5 redesigned)."""
    lib = build()["lib"]
    return _tallest_fullest({th: lib.guided_wta_smem_bytes(radius, th, size_d)
                             for th in (32, 16, 8)}, _K3_CTAS_PER_SM,
                            f"radius {radius} with {size_d} disparities")


class Tile(NamedTuple):
    """Where the input buffers and the outputs of a K1 or K3 launch lie in
    the global image.  The buffers are tiles of the image extended by a
    halo (zeros beyond the image), the outputs their interior."""

    h: int       # the global image's height
    w: int       # and width
    oy: int      # global row of the buffer's (0, 0)
    ox: int      # and its column
    hy: int      # the interior's offset in the buffer: rows
    hx: int      # and columns
    th: int      # the interior's height
    tw: int      # and width

    @classmethod
    def whole(cls, h: int, w: int) -> "Tile":
        """A whole frame: origin 0, buffer = interior = image."""
        return cls(h, w, 0, 0, 0, 0, h, w)


def check_tile(tile: Tile, hb: int, wb: int, radius: int, dmin: int, size_d: int) -> None:
    """Raise ValueError unless the (hb, wb) buffer holds the interior and
    every pixel of the image that the kernel reads for it: 2R rows and
    2R + 1 + max |d| columns (d in dmin .. dmin + size_d - 1) on each side,
    as far as the image reaches.  The kernels read such pixels from the
    buffer and nothing else of the image, so a short halo would change the
    result; it is refused here."""
    iy, ix = tile.oy + tile.hy, tile.ox + tile.hx
    if not (0 <= tile.hy and tile.hy + tile.th <= hb and 0 <= tile.hx
            and tile.hx + tile.tw <= wb and 0 <= iy and iy + tile.th <= tile.h
            and 0 <= ix and ix + tile.tw <= tile.w and tile.th > 0 and tile.tw > 0):
        raise ValueError(f"{tile} does not fit a {hb}x{wb} buffer inside the image")
    ry = 2 * radius
    rx = 2 * radius + 1 + max(abs(dmin), abs(dmin + size_d - 1))
    if (tile.oy > max(0, iy - ry) or tile.oy + hb < min(tile.h, iy + tile.th + ry)
            or tile.ox > max(0, ix - rx) or tile.ox + wb < min(tile.w, ix + tile.tw + rx)):
        raise ValueError(
            f"the halo of {tile} in a {hb}x{wb} buffer is short of the kernel's "
            f"reach ({ry} rows, {rx} columns for d in {dmin}..{dmin + size_d - 1})")


def _tile_args(gray, outs, tile, radius, dmin, size_d) -> tuple:
    """The launch's N, H, W, Hb, Wb, oy, ox, hy, hx, Hi, Wi for input
    buffers ``gray`` (N, Hb, Wb) and ``outs`` (N, Hi, Wi), after
    ``check_tile`` (``tile`` None: a whole frame)."""
    n, hb, wb = gray.shape
    tile = tile or Tile.whole(hb, wb)
    check_tile(tile, hb, wb, radius, dmin, size_d)
    for out in outs:
        if tuple(out.shape) != (n, tile.th, tile.tw):
            raise ValueError(f"expected outputs of shape {(n, tile.th, tile.tw)}, "
                             f"got {tuple(out.shape)}")
    return (n, tile.h, tile.w, hb, wb, tile.oy, tile.ox, tile.hy, tile.hx, tile.th, tile.tw)


def guided_wta(gray1, gray2, best, dmap, dmin, size_d, radius, constants,
               eps, tile_rows=None, tile=None) -> None:
    """Launch K3 (csrc/guided_wta.cu) on the current stream.
    gray1/gray2: uint8 (N, Hb, Wb); best/dmap: float32 (N, Hi, Wi).
    ``tile`` (``Tile``) places the buffers and the outputs in the global
    image; None is a whole frame (Hi, Wi = Hb, Wb).  ``tile_rows`` (32, 16
    or 8) defaults to ``guided_wta_tile_rows``; it is set only to test or
    measure the other tile heights."""
    lib = build()["lib"]
    dims = _tile_args(gray1, (best, dmap), tile, radius, dmin, size_d)
    th = tile_rows or guided_wta_tile_rows(radius, size_d)
    err = lib.guided_wta_launch(
        gray1.data_ptr(), gray2.data_ptr(), best.data_ptr(), dmap.data_ptr(),
        *dims, dmin, size_d, radius, th, *constants, float(eps), _stream(gray1))
    _check(err, "guided_wta_launch")


@functools.lru_cache(maxsize=None)
def guided_wta_dual_tile_rows(radius: int, reach: int) -> int:
    """K4's output tile height, of 32, 16 and 8, by K3's rule: occupancy
    first (up to ``_K4_CTAS_PER_SM``), then the tallest, whatever the
    frame.  With 512-thread blocks the 32-row tile beat the 16-row one
    at 288x384 too, though its 108 CTAs leave SMs idle (PERF.md,
    Findings: K3, K4 and K5 redesigned)."""
    lib = build()["lib"]
    return _tallest_fullest({th: lib.guided_wta_dual_smem_bytes(radius, th, reach)
                             for th in (32, 16, 8)}, _K4_CTAS_PER_SM,
                            f"radius {radius} with column reach {reach} (dual-view kernel)")


# K1 and K5 band heights, tallest first (a taller band pays its 4R
# y-halo over more output rows).
_BANDS = tuple(range(128, 0, -8))

# The steps of the row walks K1 and K5 (rows the walk adds at a time),
# tried in this order, and their bands.  16-row steps on 512-thread blocks
# ran 20% faster at 6 MP than K5's earlier 8-row steps on 256 threads;
# above 96 rows the bands ran ~4% slower (PERF.md, Findings: K3, K4 and
# K5 redesigned).  8-row steps take less shared memory, so larger radii
# still fit.
_STEPS = (16, 8)
_WALK_BANDS = tuple(b for b in _BANDS if b <= 96)

# K1's tile width (output columns per CTA, csrc/guided_wta_stream.cu
# kTW): with the guide statistics in L2, 64 columns at band 96 beat 32
# columns by 22% at 6 MP (PERF.md, Findings: K2 and K1 redesigned).
_K1_TILE_W = 64


@functools.lru_cache(maxsize=None)
def guided_wta_stream_step(radius: int, size_d: int) -> int | None:
    """K1's step: the first of ``_STEPS`` whose lowest band fits one
    block's shared memory; None if none does."""
    lib = build()["lib"]
    return next((step for step in _STEPS
                 if lib.guided_wta_stream_smem_bytes(radius, _WALK_BANDS[-1], size_d, step)
                 <= _SMEM_LIMIT), None)


@functools.lru_cache(maxsize=None)
def guided_wta_stream_band_rows(radius: int, size_d: int, h: int, w: int,
                                n_sm: int, step: int) -> int:
    """K1's band height, of 96, 88, .., 8 (``_pick_rows``), for steps of
    ``step`` rows."""
    lib = build()["lib"]
    band = _pick_rows({b: lib.guided_wta_stream_smem_bytes(radius, b, size_d, step)
                       for b in _WALK_BANDS}, _K1_CTAS_PER_SM, h, w, n_sm, _K1_TILE_W)
    if band is None:
        raise ValueError(f"radius {radius} with {size_d} disparities needs more "
                         "shared memory than one block has (row-walk kernel)")
    return band


def guided_wta_stream(gray1, gray2, best, dmap, dmin, size_d, radius,
                      constants, eps, band=None, step=None, tile=None) -> None:
    """Launch K1 (csrc/guided_wta_stream.cu) on the current stream;
    arguments as guided_wta.  ``step`` (16 or 8) defaults to
    ``guided_wta_stream_step`` and ``band`` (output rows per CTA) to
    ``guided_wta_stream_band_rows`` of the interior; they are set only to
    test or measure other shapes of the kernel."""
    dims = _tile_args(gray1, (best, dmap), tile, radius, dmin, size_d)
    step = step or guided_wta_stream_step(radius, size_d) or _STEPS[-1]
    if band is None:
        band = guided_wta_stream_band_rows(radius, size_d, dims[-2], dims[-1],
                                           _n_sm(gray1.device), step)
    _launch_with_scratch("guided_wta_stream", (band, step), gray1, gray2, (best, dmap), dmin,
                         size_d, radius, constants, eps, dims)


@functools.lru_cache(maxsize=None)
def guided_wta_dual_stream_step(radius: int, reach: int) -> int | None:
    """K5's step: the first of ``_STEPS`` whose lowest band fits one
    block's shared memory; None if none does."""
    lib = build()["lib"]
    return next((step for step in _STEPS
                 if lib.guided_wta_dual_stream_smem_bytes(radius, _WALK_BANDS[-1], reach, step)
                 <= _SMEM_LIMIT), None)


def dual_stream_fits(radius: int, reach: int) -> bool:
    """Whether K5 fits one block's shared memory at its lowest band."""
    return guided_wta_dual_stream_step(radius, reach) is not None


@functools.lru_cache(maxsize=None)
def guided_wta_dual_stream_band_rows(radius: int, reach: int, h: int, w: int,
                                     n_sm: int, step: int) -> int:
    """K5's band height, of 96, 88, .., 8 (``_pick_rows``), for steps of
    ``step`` rows."""
    lib = build()["lib"]
    band = _pick_rows({b: lib.guided_wta_dual_stream_smem_bytes(radius, b, reach, step)
                       for b in _WALK_BANDS}, _K5_CTAS_PER_SM, h, w, n_sm)
    if band is None:
        raise ValueError(f"radius {radius} with column reach {reach} needs "
                         "more shared memory than one block has (dual-view "
                         "row-walk kernel)")
    return band


def _launch_with_scratch(name, shape, gray_l, gray_r, outs, dmin, size_d, radius,
                         constants, eps, dims=None) -> None:
    """Launch `name`_launch (K1, K4, K5) with a scratch of
    `name`_scratch_bytes (the CTAs' guide statistics, which stay in L2).
    ``shape``: the launch shape's ints, tile or band rows first.  ``dims``:
    K1's ``_tile_args`` (None: N, H, W of ``gray_l``).  The scratch is freed on
    return while the kernel may still run: the caching allocator hands
    it out again only to work queued after it on the same stream."""
    lib = build()["lib"]
    dims = dims or tuple(gray_l.shape)
    n, h, w = dims[0], dims[-2], dims[-1]     # the outputs' frames
    scratch = torch.empty(getattr(lib, f"{name}_scratch_bytes")(radius, shape[0], n, h, w),
                          dtype=torch.uint8, device=gray_l.device)
    err = getattr(lib, f"{name}_launch")(
        gray_l.data_ptr(), gray_r.data_ptr(), *(o.data_ptr() for o in outs),
        scratch.data_ptr(), *dims, dmin, size_d, radius, *shape, *constants,
        float(eps), _stream(gray_l))
    _check(err, f"{name}_launch")


def guided_wta_dual(gray_l, gray_r, outs, dmin, size_d, radius, constants,
                    eps, tile_rows=None) -> None:
    """Launch K4 (csrc/guided_wta_dual.cu) on the current stream.
    gray_l/gray_r: uint8 (N, H, W); outs: best_l, dmap_l, best_r, dmap_r
    float32 (N, H, W).  ``tile_rows`` (32, 16 or 8) defaults to
    ``guided_wta_dual_tile_rows``; it is set only to test or measure the
    other tile heights."""
    th = tile_rows or guided_wta_dual_tile_rows(radius, dual_reach(dmin, size_d))
    _launch_with_scratch("guided_wta_dual", (th,), gray_l, gray_r, outs, dmin, size_d,
                         radius, constants, eps)


def guided_wta_dual_stream(gray_l, gray_r, outs, dmin, size_d, radius,
                           constants, eps, band=None, step=None) -> None:
    """Launch K5 (csrc/guided_wta_dual_stream.cu) on the current stream;
    arguments as guided_wta_dual.  ``step`` (8 or 16) defaults to
    ``guided_wta_dual_stream_step`` and ``band`` to
    ``guided_wta_dual_stream_band_rows``; they are set only to test or
    measure other shapes of the kernel."""
    _, h, w = gray_l.shape
    reach = dual_reach(dmin, size_d)
    step = step or guided_wta_dual_stream_step(radius, reach) or _STEPS[-1]
    if band is None:
        band = guided_wta_dual_stream_band_rows(radius, reach, h, w,
                                                _n_sm(gray_l.device), step)
    _launch_with_scratch("guided_wta_dual_stream", (band, step), gray_l, gray_r,
                         outs, dmin, size_d, radius, constants, eps)


def lr_fill(dl, dr, occ, filled, dmin, size_d, d_lr, d_occlusion,
            v_min) -> None:
    """Launch K2 (csrc/lr_fill.cu) on the current stream.  dl/dr/occ/filled:
    float32 (..., W), contiguous; every row is independent, so a (N, H, W)
    batch is N*H rows of one launch, bit-identical to per-frame launches."""
    lib = build()["lib"]
    w = dl.shape[-1]
    h = dl.numel() // w
    if lib.lr_fill_smem_bytes(w) > _SMEM_LIMIT:
        raise ValueError(f"row width {w} exceeds the post kernel's shared memory")
    err = lib.lr_fill_launch(
        dl.data_ptr(), dr.data_ptr(), occ.data_ptr(), filled.data_ptr(),
        h, w, dmin, size_d, d_lr, d_occlusion, v_min, _stream(dl))
    _check(err, "lr_fill_launch")
