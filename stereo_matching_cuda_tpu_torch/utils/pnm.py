"""Netpbm (PGM/PPM) and PFM codecs.

A copy of ``stereo_matching_cuda_tpu/utils/pnm.py``, names and behaviour
kept: importing the JAX package imports JAX, which the port's machines
need not have.

The reference's stb_image.h reads PNM alongside PNG (stb_image.h's
pnm path); Middlebury distributes full-resolution ground-truth
disparities as PFM float maps — both matter for the --gt workflow.

Supported: binary P5 (gray) / P6 (RGB) at maxval <= 255 (uint8) or
<= 65535 (uint16, big-endian per spec); PFM 'Pf' (gray) / 'PF' (RGB)
float32, either endianness, bottom-up row order per spec.
"""

from __future__ import annotations

import numpy as np

from .parse import codec_errors


def _read_token(f) -> bytes:
    """Next whitespace-delimited token, skipping '#' comments."""
    tok = b""
    while True:
        c = f.read(1)
        if not c:
            break
        if c == b"#":
            f.readline()
            continue
        if c.isspace():
            if tok:
                if c == b"\r":
                    # CRLF-written headers: consume the LF too, or it
                    # becomes the first payload byte and shifts every
                    # float by one
                    nxt = f.read(1)
                    if nxt and nxt != b"\n":
                        f.seek(-1, 1)
                break
            continue
        tok += c
    return tok


@codec_errors("PNM")
def read_pnm(path: str) -> np.ndarray:
    """uint8/uint16 (H,W) for P5 or (H,W,3) for P6."""
    with open(path, "rb") as f:
        magic = _read_token(f)
        if magic not in (b"P5", b"P6"):
            raise ValueError(f"{path}: unsupported PNM magic {magic!r}")
        w = int(_read_token(f))
        h = int(_read_token(f))
        maxval = int(_read_token(f))
        if not (0 < maxval < 65536):
            raise ValueError(f"{path}: bad maxval {maxval}")
        ch = 3 if magic == b"P6" else 1
        dtype = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
        data = f.read(w * h * ch * dtype.itemsize)
    arr = np.frombuffer(data, dtype=dtype, count=w * h * ch)
    # astype/copy: frombuffer views are read-only; every reader in the
    # package returns writable arrays
    arr = arr.astype(np.uint16) if maxval > 255 else arr.copy()
    arr = arr.reshape(h, w, ch)
    return arr[..., 0] if ch == 1 else arr


def write_pnm(path: str, img: np.ndarray) -> None:
    """uint8/uint16 (H,W) → P5, (H,W,3) → P6."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNM wants uint8/uint16, got {img.dtype}")
    if img.ndim == 2:
        magic, ch = b"P5", 1
    elif img.ndim == 3 and img.shape[2] == 3:
        magic, ch = b"P6", 3
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    maxval = 255 if img.dtype == np.uint8 else 65535
    payload = (img.astype(">u2") if maxval > 255 else img).tobytes()
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n%d\n" % (img.shape[1], img.shape[0], maxval))
        f.write(payload)


@codec_errors("PFM")
def read_pfm(path: str) -> np.ndarray:
    """float32 (H,W) for 'Pf' or (H,W,3) for 'PF'; rows are stored
    bottom-up per the PFM spec, returned top-down; the scale line's
    sign gives endianness."""
    with open(path, "rb") as f:
        magic = _read_token(f)
        if magic not in (b"Pf", b"PF"):
            raise ValueError(f"{path}: unsupported PFM magic {magic!r}")
        w = int(_read_token(f))
        h = int(_read_token(f))
        scale = float(_read_token(f))
        ch = 3 if magic == b"PF" else 1
        dtype = np.dtype("<f4") if scale < 0 else np.dtype(">f4")
        data = f.read(w * h * ch * 4)
    arr = np.frombuffer(data, dtype=dtype, count=w * h * ch).astype(np.float32)
    arr = arr.reshape(h, w, ch)[::-1]  # bottom-up → top-down
    return np.ascontiguousarray(arr[..., 0] if ch == 1 else arr)


def write_pfm(path: str, arr: np.ndarray) -> None:
    """float32 (H,W) → 'Pf', (H,W,3) → 'PF' (little-endian, scale -1)."""
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 2:
        magic = b"Pf"
    elif arr.ndim == 3 and arr.shape[2] == 3:
        magic = b"PF"
    else:
        raise ValueError(f"unsupported shape {arr.shape}")
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n-1.0\n" % (arr.shape[1], arr.shape[0]))
        f.write(arr[::-1].astype("<f4").tobytes())
