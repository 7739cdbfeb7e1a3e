"""Image I/O front end: native C++ codec with pure-Python fallback.

A copy of ``stereo_matching_cuda_tpu/utils/io.py``, names and behaviour
kept (importing the JAX package imports JAX, which the port's machines
need not have), with its own NumPy ``write_mat`` normalizer in place of
the JAX package's ``reference.write_mat_normalize``.

The native library (``native/stereoio``, built via ``make -C native``)
sits outside both packages; this module loads the same
``native/build/libstereoio.so``.  If the .so is missing it is built on
first use when a toolchain exists; otherwise the pure-Python codec in
``utils.png`` serves every call (``native_available`` says which).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from . import png as _pypng

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SO_PATH = os.path.join(_REPO_ROOT, "native", "build", "libstereoio.so")
_lock = threading.Lock()
_lib = None
_lib_tried = False


def _load_native():
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        src = os.path.join(_REPO_ROOT, "native", "stereoio", "stereoio.cpp")
        stale = (
            os.path.exists(_SO_PATH)
            and os.path.exists(src)
            and os.path.getmtime(src) > os.path.getmtime(_SO_PATH)
        )
        if not os.path.exists(_SO_PATH) or stale:
            makefile = os.path.join(_REPO_ROOT, "native", "Makefile")
            if os.path.exists(makefile):
                try:
                    subprocess.run(
                        ["make", "-C", os.path.dirname(makefile)],
                        check=True, capture_output=True, timeout=120,
                    )
                except Exception:
                    return None
        if not os.path.exists(_SO_PATH):
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        lib.sio_read_png.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.sio_read_png.restype = ctypes.c_int
        lib.sio_write_png.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.sio_write_png.restype = ctypes.c_int
        lib.sio_write_png16.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int, ctypes.c_int,
        ]
        lib.sio_write_png16.restype = ctypes.c_int
        lib.sio_free.argtypes = [ctypes.c_void_p]
        lib.sio_write_mat_normalize.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_longlong,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_native() is not None


def read_png(path: str) -> np.ndarray:
    """uint8 (H,W) or (H,W,C); uint16 for 16-bit PNGs (ground-truth
    disparity files).  Native codec when available."""
    lib = _load_native()
    if lib is None:
        return _pypng.read_png(path)
    data = ctypes.POINTER(ctypes.c_ubyte)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    ch = ctypes.c_int()
    depth = ctypes.c_int()
    rc = lib.sio_read_png(path.encode(), ctypes.byref(data), ctypes.byref(w),
                          ctypes.byref(h), ctypes.byref(ch), ctypes.byref(depth))
    if rc != 0:
        # fall back for formats the native codec rejects
        return _pypng.read_png(path)
    try:
        n = h.value * w.value * ch.value * (depth.value // 8)
        arr = np.ctypeslib.as_array(data, shape=(n,)).copy()
    finally:
        lib.sio_free(data)
    if depth.value == 16:
        arr = arr.view(np.uint16)
    arr = arr.reshape(h.value, w.value, ch.value)
    return arr[..., 0] if ch.value == 1 else arr


def write_png(path: str, img: np.ndarray) -> None:
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(
            f"write_png needs uint8 or uint16 input, got {img.dtype} "
            "(normalize/convert explicitly — silent modulo-256 wrapping "
            "corrupts float maps)")
    if img.dtype == np.uint16:
        lib = _load_native()
        if lib is not None and img.ndim == 2:
            img = np.ascontiguousarray(img)
            rc = lib.sio_write_png16(
                path.encode(),
                img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                img.shape[1], img.shape[0])
            if rc != 0:
                raise OSError(f"sio_write_png16 failed with code {rc} for {path}")
            return
        _pypng.write_png(path, img)
        return
    img = np.ascontiguousarray(img, dtype=np.uint8)
    lib = _load_native()
    if lib is None:
        _pypng.write_png(path, img)
        return
    if img.ndim == 2:
        h, w, ch = img.shape[0], img.shape[1], 1
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        h, w, ch = img.shape
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    rc = lib.sio_write_png(
        path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), w, h, ch)
    if rc != 0:
        raise OSError(f"sio_write_png failed with code {rc} for {path}")


def read_image(path: str) -> np.ndarray:
    """Format-dispatching reader (magic bytes): the full stb_image
    surface — PNG, JPEG (baseline), PGM/PPM (P5/P6), PFM (Pf/PF float —
    Middlebury ground-truth disparities), BMP, GIF, PSD, Radiance HDR,
    Softimage PIC, and TGA (no magic — dispatched by .tga extension,
    as stb does)."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x89P":
        return read_png(path)
    if magic == b"\xff\xd8":
        from . import jpeg

        return jpeg.read_jpeg(path)
    if magic in (b"P5", b"P6"):
        from . import pnm

        return pnm.read_pnm(path)
    if magic in (b"Pf", b"PF"):
        from . import pnm

        return pnm.read_pfm(path)
    if magic == b"BM":
        from . import imagefmt

        return imagefmt.read_bmp(path)
    if magic == b"#?":
        from . import imagefmt

        return imagefmt.read_hdr(path)
    if magic == b"GI":
        from . import legacyfmt

        return legacyfmt.read_gif(path)
    if magic == b"8B":
        from . import legacyfmt

        return legacyfmt.read_psd(path)
    if magic == b"\x53\x80":
        from . import legacyfmt

        return legacyfmt.read_pic(path)
    if path.lower().endswith(".tga"):
        from . import imagefmt

        return imagefmt.read_tga(path)
    raise ValueError(f"{path}: unrecognized image format (magic {magic!r})")


def _write_mat_normalize_numpy(mat: np.ndarray) -> np.ndarray:
    """NumPy copy of ``stereo_matching_cuda_tpu/reference.py:296-330``:
    write_mat's quirky min/max scan and uint8 conversion (main.cu:13-35).

    The scan uses ``if (v > max) ... else if (v <= min) ...`` — an element
    that raises the running max never updates the min (main.cu:18-26).
    The final min is therefore the minimum over elements that did *not*
    break the running max (or the 1.5e8 init if none qualify).
    ``int c = (v - min) * 255.0f / (max - min)`` truncates toward zero and
    wraps through ``(unsigned char)`` (main.cu:28-30).
    """
    flat = mat.reshape(-1).astype(np.float32)
    init_max = np.float32(-150000000.0)
    init_min = np.float32(150000000.0)
    runmax = np.maximum.accumulate(np.concatenate([[init_max], flat[:-1]]).astype(np.float32))
    breaking = flat > runmax
    nonbreak = flat[~breaking]
    mx = np.float32(np.max(flat)) if np.any(flat > init_max) else init_max
    mn = np.float32(np.min(nonbreak)) if nonbreak.size and np.min(nonbreak) <= init_min else init_min
    if mx == mn:
        # constant input: the reference's expression divides by zero
        # and casts NaN to int (UB in C).  Both implementations
        # produce 0 here; the native codec guards identically.
        return np.zeros(mat.shape, np.uint8)
    with np.errstate(over="ignore", invalid="ignore"):
        # extreme inputs overflow f32 and produce NaN→0 casts exactly as
        # the C expression does — intentional, matches main.cu:28-30
        c = ((flat - mn) * np.float32(255.0)) / (mx - mn)
        ci = np.trunc(c).astype(np.int64)
    return (ci & 0xFF).astype(np.uint8).reshape(mat.shape)


def write_mat_normalize(mat: np.ndarray) -> np.ndarray:
    """Native write_mat min-max normalizer (main.cu:13-35); falls back
    to the NumPy implementation."""
    lib = _load_native()
    if lib is None:
        return _write_mat_normalize_numpy(mat)
    flat = np.ascontiguousarray(mat, dtype=np.float32).reshape(-1)
    out = np.empty(flat.shape, dtype=np.uint8)
    lib.sio_write_mat_normalize(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        flat.size,
    )
    return out.reshape(mat.shape)
