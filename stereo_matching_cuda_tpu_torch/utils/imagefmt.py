"""Minimal BMP, TGA and Radiance HDR codecs (dependency-free NumPy).

A copy of ``stereo_matching_cuda_tpu/utils/imagefmt.py``, names and
behaviour kept: importing the JAX package imports JAX, which the port's
machines need not have.

The reference's stb_image.h reads BMP/TGA/HDR alongside PNG (enabled
via SystemIncludes.h:3-5), and stb_image_write.h writes BMP/TGA/HDR,
though the pipeline itself only ever loads and stores PNGs
(main.cu:57-58,162-181).  These codecs cover the commonly produced
subsets:

  BMP:  BITMAPINFOHEADER (or larger) uncompressed BI_RGB, 8-bit
        paletted / 24-bit BGR / 32-bit BGRA, bottom-up or top-down.
  TGA:  types 2/10 (truecolor, raw/RLE) at 24/32 bpp and types 3/11
        (grayscale, raw/RLE), bottom-up or top-down origin.
  HDR:  Radiance 32-bit_rle_rgbe, flat or adaptive-RLE scanlines;
        decode uses stb's c·2^(e−136) convention, write emits RLE
        scanlines like stb_image_write.

Both decode to the same uint8 (H, W[, C]) RGB-order arrays the PNG
codecs return (HDR decodes to float32 RGB); writers emit 24-bit
BMP / TGA (and 8-bit gray TGA) for round-trip tests and interchange.
"""

from __future__ import annotations

import struct

import numpy as np

from .parse import codec_errors


# ----------------------------------------------------------------- BMP

@codec_errors("BMP")
def read_bmp(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    (pix_off,) = struct.unpack_from("<I", data, 10)
    (hdr_size,) = struct.unpack_from("<I", data, 14)
    if hdr_size < 40:
        raise NotImplementedError(f"{path}: BITMAPCOREHEADER unsupported")
    w, h_signed = struct.unpack_from("<ii", data, 18)
    planes, bpp = struct.unpack_from("<HH", data, 26)
    (compression,) = struct.unpack_from("<I", data, 30)
    if compression != 0:
        raise NotImplementedError(
            f"{path}: compressed BMP (method {compression}) unsupported")
    if bpp not in (8, 24, 32):
        raise NotImplementedError(f"{path}: {bpp}-bpp BMP unsupported")
    if w <= 0 or h_signed == 0:
        raise ValueError(f"{path}: bad BMP dimensions {w}x{h_signed}")
    h = abs(h_signed)
    bottom_up = h_signed > 0

    palette = None
    if bpp == 8:
        (n_colors,) = struct.unpack_from("<I", data, 46)
        n_colors = n_colors or 256
        po = 14 + hdr_size
        quads = np.frombuffer(data, np.uint8, n_colors * 4, po)
        palette = quads.reshape(-1, 4)[:, [2, 1, 0]].copy()   # BGRA → RGB

    nbytes = bpp // 8
    stride = (w * nbytes + 3) & ~3
    if pix_off + stride * h > len(data):
        raise ValueError(f"{path}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * h, pix_off)
    rows = rows.reshape(h, stride)[:, : w * nbytes]
    if bottom_up:
        rows = rows[::-1]
    if bpp == 8:
        idx = rows.reshape(h, w)
        if idx.max() >= len(palette):
            raise ValueError(f"{path}: palette index out of range")
        rgb = palette[idx]
        if (rgb[..., 0] == rgb[..., 1]).all() and (rgb[..., 1] == rgb[..., 2]).all():
            return rgb[..., 0].copy()          # grayscale palette → (H, W)
        return rgb
    px = rows.reshape(h, w, nbytes)
    if bpp == 24:
        return px[..., [2, 1, 0]].copy()       # BGR → RGB
    return px[..., [2, 1, 0, 3]].copy()        # BGRA → RGBA


def write_bmp(path: str, img: np.ndarray) -> None:
    """uint8 (H, W) gray or (H, W, 3) RGB → 24-bit bottom-up BMP."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"BMP writer needs uint8, got {img.dtype}")
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"BMP writer needs (H,W) or (H,W,3), got {img.shape}")
    h, w = img.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = img[::-1, :, [2, 1, 0]].reshape(h, w * 3)
    pix = rows.tobytes()
    header = struct.pack("<2sIHHI", b"BM", 54 + len(pix), 0, 0, 54)
    dib = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(pix),
                      2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(header + dib + pix)


# ----------------------------------------------------------------- TGA

@codec_errors("TGA")
def read_tga(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 18:
        raise ValueError(f"{path}: truncated TGA header")
    idlen, cmap_type, img_type = data[0], data[1], data[2]
    w, h = struct.unpack_from("<HH", data, 12)
    bpp, desc = data[16], data[17]
    if cmap_type != 0:
        raise NotImplementedError(f"{path}: color-mapped TGA unsupported")
    if img_type not in (2, 3, 10, 11):
        raise NotImplementedError(f"{path}: TGA type {img_type} unsupported")
    gray = img_type in (3, 11)
    if gray and bpp != 8:
        raise NotImplementedError(f"{path}: {bpp}-bpp grayscale TGA")
    if not gray and bpp not in (24, 32):
        raise NotImplementedError(f"{path}: {bpp}-bpp truecolor TGA")
    if w == 0 or h == 0:
        raise ValueError(f"{path}: bad TGA dimensions {w}x{h}")
    nbytes = bpp // 8
    pos = 18 + idlen
    n_px = w * h

    if img_type in (2, 3):                      # raw
        need = n_px * nbytes
        if pos + need > len(data):
            raise ValueError(f"{path}: truncated TGA pixel data")
        px = np.frombuffer(data, np.uint8, need, pos).reshape(n_px, nbytes)
    else:                                       # RLE packets
        px = np.empty((n_px, nbytes), np.uint8)
        filled = 0
        while filled < n_px:
            if pos >= len(data):
                raise ValueError(f"{path}: truncated TGA RLE stream")
            hdr = data[pos]
            pos += 1
            count = (hdr & 0x7F) + 1
            if filled + count > n_px:
                raise ValueError(f"{path}: TGA RLE overruns the image")
            if hdr & 0x80:                      # run: one pixel repeated
                val = np.frombuffer(data, np.uint8, nbytes, pos)
                pos += nbytes
                px[filled : filled + count] = val
            else:                               # literal pixels
                lit = np.frombuffer(data, np.uint8, count * nbytes, pos)
                pos += count * nbytes
                px[filled : filled + count] = lit.reshape(count, nbytes)
            filled += count

    img = px.reshape(h, w, nbytes)
    if not (desc & 0x20):                       # bit 5 clear = bottom-up
        img = img[::-1]
    if gray:
        return img[..., 0].copy()
    if nbytes == 3:
        return img[..., [2, 1, 0]].copy()       # BGR → RGB
    return img[..., [2, 1, 0, 3]].copy()        # BGRA → RGBA


def write_tga(path: str, img: np.ndarray) -> None:
    """uint8 (H, W) gray (type 3) or (H, W, 3) RGB (type 2), top-down."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"TGA writer needs uint8, got {img.dtype}")
    if img.ndim == 2:
        img_type, bpp, payload = 3, 8, img.tobytes()
    elif img.ndim == 3 and img.shape[2] == 3:
        img_type, bpp, payload = 2, 24, img[:, :, [2, 1, 0]].tobytes()
    else:
        raise ValueError(f"TGA writer needs (H,W) or (H,W,3), got {img.shape}")
    h, w = img.shape[:2]
    header = struct.pack("<BBBHHBHHHHBB", 0, 0, img_type, 0, 0, 0, 0, 0,
                         w, h, bpp, 0x20)       # bit 5 = top-down
    with open(path, "wb") as f:
        f.write(header + payload)

# ----------------------------------------------------------------- HDR

@codec_errors("HDR")
def read_hdr(path: str) -> np.ndarray:
    """Radiance .hdr → float32 (H, W, 3) linear RGB.

    Accepts flat scanlines and the adaptive-RLE encoding (scanlines
    opening with (2, 2, w>>8, w&0xFF)); component value is
    c · 2^(e−136) — the stb_image convention (zero when e == 0)."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = 0
    fmt_ok = False
    while True:                                   # header: until blank line
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
        if line.startswith(b"FORMAT="):
            fmt_ok = line == b"FORMAT=32-bit_rle_rgbe"
    if not fmt_ok:
        raise NotImplementedError(f"{path}: HDR format is not 32-bit_rle_rgbe")
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise NotImplementedError(
            f"{path}: unsupported HDR orientation {b' '.join(res)!r}")
    h, w = int(res[1]), int(res[3])
    rgbe = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        if pos + 4 > len(data):
            raise ValueError(f"{path}: truncated HDR pixel data")
        if (8 <= w < 32768 and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8) + data[pos + 3] == w):
            pos += 4                               # adaptive RLE scanline
            for c in range(4):
                x = 0
                while x < w:
                    if pos >= len(data):
                        raise ValueError(f"{path}: truncated HDR RLE stream")
                    n = data[pos]
                    pos += 1
                    if n > 128:                    # run of (n-128) copies
                        n -= 128
                        if x + n > w or pos >= len(data):
                            raise ValueError(f"{path}: HDR RLE overrun")
                        rgbe[y, x : x + n, c] = data[pos]
                        pos += 1
                    else:                          # n literals
                        if x + n > w or pos + n > len(data):
                            raise ValueError(f"{path}: HDR RLE overrun")
                        rgbe[y, x : x + n, c] = np.frombuffer(
                            data, np.uint8, n, pos)
                        pos += n
                    x += n
        else:                                      # flat scanline
            need = w * 4
            if pos + need > len(data):
                raise ValueError(f"{path}: truncated HDR pixel data")
            rgbe[y] = np.frombuffer(data, np.uint8, need, pos).reshape(w, 4)
            pos += need
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136), np.float32(0))
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]).astype(
        np.float32)


def write_hdr(path: str, img: np.ndarray) -> None:
    """float32 (H, W, 3) (or (H, W) gray, replicated) → Radiance .hdr
    with adaptive-RLE scanlines (flat when the width disallows RLE)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"HDR writer needs (H,W) or (H,W,3), got {img.shape}")
    h, w = img.shape[:2]
    maxc = img.max(axis=2)
    m, e = np.frexp(maxc)                          # maxc = m * 2^e, m in [.5,1)
    factor = np.where(maxc >= 1e-32, m * 256.0 / np.maximum(maxc, 1e-38), 0.0)
    rgbe = np.empty((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * factor[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc >= 1e-32,
                            np.clip(e + 128, 0, 255), 0).astype(np.uint8)
    out = [b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n",
           f"-Y {h} +X {w}\n".encode()]
    if not (8 <= w < 32768):
        out.append(rgbe.tobytes())
    else:
        for y in range(h):
            out.append(bytes((2, 2, w >> 8, w & 0xFF)))
            for c in range(4):
                comp = rgbe[y, :, c]
                x = 0
                while x < w:
                    # find a run of >= 4 identical bytes
                    run = x
                    while run + 3 < w and not (
                            comp[run] == comp[run + 1] == comp[run + 2]
                            == comp[run + 3]):
                        run += 1
                    if run + 3 >= w:
                        run = w
                    while x < run:                 # literals up to the run
                        n = min(128, run - x)
                        out.append(bytes([n]) + comp[x : x + n].tobytes())
                        x += n
                    if x < w:                      # emit the run
                        n = x + 4
                        while n < w and comp[n] == comp[x] and n - x < 127:
                            n += 1
                        out.append(bytes([128 + (n - x), comp[x]]))
                        x = n
    with open(path, "wb") as f:
        f.write(b"".join(out))
