"""GIF, PSD and Softimage PIC readers (dependency-free NumPy).

A copy of ``stereo_matching_cuda_tpu/utils/legacyfmt.py``, names and
behaviour kept: importing the JAX package imports JAX, which the port's
machines need not have.

Completes the vendored-stb read surface (SURVEY.md §2.2 #12):
stb_image.h decodes GIF/PSD/PIC alongside PNG/JPEG/BMP/TGA/HDR/PNM —
the reference enables the whole zoo via SystemIncludes.h:3-5 even
though main.cu only ever loads PNGs.  Scope mirrors stb's common
paths:

  GIF:  87a/89a static decode (first frame on the logical canvas),
        global/local palettes, interlacing, GCE transparency → RGBA.
  PSD:  version-1 composite image, RGB/grayscale, 8-bit (raw or
        PackBits RLE) and 16-bit (raw), returned like the PNG codecs
        (uint8, or uint16 for 16-bit data).
  PIC:  Softimage, uncompressed and mixed-RLE channel packets → RGB(A).

All decode to the (H, W[, C]) RGB-order arrays the other codecs return.
"""

from __future__ import annotations

import struct

import numpy as np

from .parse import codec_errors


# ----------------------------------------------------------------- GIF

def _lzw_decode(min_code: int, data: bytes, n_out: int, path: str) -> bytes:
    """GIF-variant LZW → index stream (codes are LSB-first)."""
    clear = 1 << min_code
    end = clear + 1
    table: list[bytes] = [bytes([i]) for i in range(clear)] + [b"", b""]
    code_len = min_code + 1
    out = bytearray()
    prev: bytes | None = None
    acc = nbits = 0
    pos = 0
    while len(out) < n_out:
        while nbits < code_len:
            if pos >= len(data):
                raise ValueError(f"{path}: truncated GIF LZW stream")
            acc |= data[pos] << nbits
            nbits += 8
            pos += 1
        code = acc & ((1 << code_len) - 1)
        acc >>= code_len
        nbits -= code_len
        if code == clear:
            table = table[: clear + 2]
            code_len = min_code + 1
            prev = None
            continue
        if code == end:
            break
        if prev is None:
            if code >= len(table):
                raise ValueError(f"{path}: bad first GIF LZW code")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table) and len(table) < 4096:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f"{path}: GIF LZW code out of range")
        out += entry
        prev = entry
        if len(table) == (1 << code_len) and code_len < 12:
            code_len += 1
    return bytes(out[:n_out])


@codec_errors("GIF")
def read_gif(path: str) -> np.ndarray:
    """First frame of a GIF, composited on the logical canvas.
    Returns (H, W, 3) uint8, or (H, W, 4) when the frame's graphic
    control extension marks a transparent index."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF file")
    W, H = struct.unpack_from("<HH", data, 6)
    flags, bg_idx = data[10], data[11]
    pos = 13
    gct = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        gct = np.frombuffer(data, np.uint8, n * 3, pos).reshape(n, 3)
        pos += n * 3
    transparent = None
    while True:
        if pos >= len(data):
            raise ValueError(f"{path}: truncated GIF (no image descriptor)")
        tag = data[pos]
        pos += 1
        if tag == 0x3B:                           # trailer before any image
            raise ValueError(f"{path}: GIF contains no image data")
        if tag == 0x21:                           # extension
            label = data[pos]
            pos += 1
            if label == 0xF9 and data[pos] >= 4:  # graphic control
                if data[pos + 1] & 1:
                    transparent = data[pos + 4]
            while data[pos]:                      # skip sub-blocks
                pos += 1 + data[pos]
            pos += 1
            continue
        if tag != 0x2C:
            raise ValueError(f"{path}: unknown GIF block 0x{tag:02x}")
        break
    x0, y0, fw, fh = struct.unpack_from("<HHHH", data, pos)
    iflags = data[pos + 8]
    pos += 9
    pal = gct
    if iflags & 0x80:                             # local color table
        n = 2 << (iflags & 7)
        pal = np.frombuffer(data, np.uint8, n * 3, pos).reshape(n, 3)
        pos += n * 3
    if pal is None:
        raise ValueError(f"{path}: GIF frame has no color table")
    min_code = data[pos]
    pos += 1
    chunks = []
    while data[pos]:
        n = data[pos]
        chunks.append(data[pos + 1 : pos + 1 + n])
        pos += 1 + n
    idx = np.frombuffer(
        _lzw_decode(min_code, b"".join(chunks), fw * fh, path), np.uint8)
    if idx.max(initial=0) >= len(pal):
        raise ValueError(f"{path}: GIF palette index out of range")
    frame = idx.reshape(fh, fw)
    if iflags & 0x40:                             # 4-pass interlace
        de = np.empty_like(frame)
        rows = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                               np.arange(2, fh, 4), np.arange(1, fh, 2)])
        de[rows] = frame
        frame = de
    nc = 4 if transparent is not None else 3
    canvas = np.zeros((H, W, nc), np.uint8)
    if transparent is None and gct is not None and bg_idx < len(gct):
        canvas[:] = np.concatenate([gct[bg_idx], [255] * (nc - 3)]).astype(
            np.uint8)
    fe_h = min(fh, H - y0)
    fe_w = min(fw, W - x0)
    rgb = pal[frame[:fe_h, :fe_w]]
    if transparent is not None:
        alpha = np.where(frame[:fe_h, :fe_w] == transparent, 0, 255)
        canvas[y0 : y0 + fe_h, x0 : x0 + fe_w, :3] = rgb
        canvas[y0 : y0 + fe_h, x0 : x0 + fe_w, 3] = alpha
    else:
        canvas[y0 : y0 + fe_h, x0 : x0 + fe_w] = rgb
    return canvas


# ----------------------------------------------------------------- PSD

@codec_errors("PSD")
def read_psd(path: str) -> np.ndarray:
    """Photoshop composite image: 8-bit raw/RLE and 16-bit raw, RGB or
    grayscale (+alpha).  Returns uint8 (uint16 for 16-bit files)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"8BPS":
        raise ValueError(f"{path}: not a PSD file")
    (version,) = struct.unpack_from(">H", data, 4)
    if version != 1:
        raise NotImplementedError(f"{path}: PSD version {version} (PSB?)")
    channels, h, w, depth, mode = struct.unpack_from(">HIIHH", data, 12)
    if depth not in (8, 16):
        raise NotImplementedError(f"{path}: {depth}-bit PSD unsupported")
    if mode not in (1, 3):
        raise NotImplementedError(
            f"{path}: PSD color mode {mode} (only grayscale/RGB)")
    if channels < 1 or channels > 16:
        raise ValueError(f"{path}: bad PSD channel count {channels}")
    pos = 26
    for _ in range(3):                            # color data/resources/layers
        (ln,) = struct.unpack_from(">I", data, pos)
        pos += 4 + ln
    (compression,) = struct.unpack_from(">H", data, pos)
    pos += 2
    n_px = h * w
    planes = np.empty((channels, n_px), np.uint16 if depth == 16 else np.uint8)
    if compression == 0:                          # raw planar
        dt = ">u2" if depth == 16 else np.uint8
        need = n_px * channels * (depth // 8)
        if pos + need > len(data):
            raise ValueError(f"{path}: truncated PSD pixel data")
        raw = np.frombuffer(data, dt, n_px * channels, pos)
        planes[:] = raw.reshape(channels, n_px)
    elif compression == 1:                        # PackBits RLE (8-bit)
        if depth != 8:
            raise NotImplementedError(f"{path}: RLE 16-bit PSD unsupported")
        pos += 2 * h * channels                   # per-row byte counts table
        for c in range(channels):
            filled = 0
            while filled < n_px:
                if pos >= len(data):
                    raise ValueError(f"{path}: truncated PSD RLE stream")
                n = data[pos]
                pos += 1
                if n < 128:                       # n+1 literals
                    cnt = n + 1
                    if filled + cnt > n_px or pos + cnt > len(data):
                        raise ValueError(f"{path}: PSD RLE overrun")
                    planes[c, filled : filled + cnt] = np.frombuffer(
                        data, np.uint8, cnt, pos)
                    pos += cnt
                elif n > 128:                     # 257-n copies
                    cnt = 257 - n
                    if filled + cnt > n_px or pos >= len(data):
                        raise ValueError(f"{path}: PSD RLE overrun")
                    planes[c, filled : filled + cnt] = data[pos]
                    pos += 1
                else:                             # 128 = no-op
                    continue
                filled += cnt
    else:
        raise NotImplementedError(
            f"{path}: PSD compression {compression} unsupported")
    img = planes.reshape(channels, h, w).transpose(1, 2, 0)
    if mode == 1:                                 # grayscale (+alpha)
        return img[..., 0].copy() if channels == 1 else img[..., :2].copy()
    if channels == 3:
        return img.copy()
    return img[..., :4].copy()                    # RGBA (extra channels drop)


# ----------------------------------------------------------------- PIC

@codec_errors("PIC")
def read_pic(path: str) -> np.ndarray:
    """Softimage PIC: uncompressed (type 0) and mixed-RLE (type 2)
    channel packets at 8 bits/channel → uint8 RGB(A)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"\x53\x80\xf6\x34" or data[88:92] != b"PICT":
        raise ValueError(f"{path}: not a Softimage PIC file")
    w, h = struct.unpack_from(">HH", data, 92)
    if w == 0 or h == 0:
        raise ValueError(f"{path}: bad PIC dimensions {w}x{h}")
    pos = 92 + 4 + 4 + 2 + 2                      # w,h + ratio + fields + pad
    packets = []                                  # (type, channel-list)
    while True:
        if pos + 4 > len(data):
            raise ValueError(f"{path}: truncated PIC channel packets")
        chained, size, ptype, mask = data[pos : pos + 4]
        pos += 4
        if size != 8:
            raise NotImplementedError(f"{path}: {size}-bit PIC channels")
        if ptype & 0x3 not in (0, 2):
            raise NotImplementedError(f"{path}: PIC packet type {ptype}")
        chans = [i for i, bit in enumerate((0x80, 0x40, 0x20, 0x10))
                 if mask & bit]                   # R,G,B,A positions
        packets.append((ptype & 0x3, chans))
        if not chained:
            break
    n_chan = 4 if any(3 in ch for _, ch in packets) else 3
    img = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        for ptype, chans in packets:
            nc = len(chans)
            if ptype == 0:                        # uncompressed
                need = w * nc
                if pos + need > len(data):
                    raise ValueError(f"{path}: truncated PIC scanline")
                row = np.frombuffer(data, np.uint8, need, pos).reshape(w, nc)
                pos += need
                img[y, :, chans] = row.T
            else:                                 # mixed RLE
                x = 0
                while x < w:
                    if pos >= len(data):
                        raise ValueError(f"{path}: truncated PIC RLE")
                    c = data[pos]
                    pos += 1
                    if c >= 128:
                        if c == 128:
                            (count,) = struct.unpack_from(">H", data, pos)
                            pos += 2
                        else:
                            count = c - 127
                        if x + count > w or pos + nc > len(data):
                            raise ValueError(f"{path}: PIC RLE overrun")
                        img[y, x : x + count, chans] = np.frombuffer(
                            data, np.uint8, nc, pos)[:, None]
                        pos += nc
                        x += count
                    else:
                        count = c + 1
                        need = count * nc
                        if x + count > w or pos + need > len(data):
                            raise ValueError(f"{path}: PIC RLE overrun")
                        img[y, x : x + count, chans] = np.frombuffer(
                            data, np.uint8, need, pos).reshape(count, nc).T
                        pos += need
                        x += count
    return img[..., :n_chan].copy()
