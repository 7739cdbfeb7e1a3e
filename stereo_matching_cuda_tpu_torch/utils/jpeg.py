"""JPEG decoder (pure Python + NumPy, no dependencies).

A copy of ``stereo_matching_cuda_tpu/utils/jpeg.py``, names and behaviour
kept: importing the JAX package imports JAX, which the port's machines
need not have.

Completes the vendored-stb read surface (SURVEY.md §2.2 #12:
stb_image.h decodes JPEG alongside PNG/BMP/TGA/PNM — the reference
enables it via SystemIncludes.h:3-5 even though main.cu only ever
loads PNGs).  Scope mirrors stb's: baseline sequential DCT
(SOF0/SOF1) AND progressive DCT (SOF2, spectral selection +
successive approximation per ITU T.81 §G — DC first/refine,
AC first/refine with EOB runs), 8-bit samples, grayscale or YCbCr
with any h/v sampling factors up to 2 (4:4:4, 4:2:2, 4:2:0, 4:1:1),
restart markers.  Arithmetic coding and hierarchical/lossless SOFs
raise NotImplementedError (stb rejects those too).

Decoding choices match libjpeg's defaults closely but not bitwise
(the JPEG spec does not mandate an exact IDCT): float orthonormal
IDCT and triangle ("fancy") chroma upsampling — measured within ±2
of PIL/libjpeg-turbo on photographic content (tests/test_jpeg.py).
"""

from __future__ import annotations

import struct

import numpy as np

from .parse import codec_errors

# natural order index for each zigzag position
_ZIGZAG = np.array([
    0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63], np.int32)

# orthonormal 8-point DCT-II basis: B[k, n] = c(k) cos((2n+1)kπ/16)
_B = np.array([[np.cos((2 * n + 1) * k * np.pi / 16)
                * (np.sqrt(0.125) if k == 0 else 0.5)
                for n in range(8)] for k in range(8)])


class _Huff:
    """Canonical JPEG Huffman table → (length, code) → symbol map."""

    def __init__(self, counts, symbols):
        self.map = {}
        code = 0
        it = iter(symbols)
        for ln in range(1, 17):
            for _ in range(counts[ln - 1]):
                self.map[(ln, code)] = next(it)
                code += 1
            code <<= 1
        self.max_len = max((l for l, _ in self.map), default=0)


class _Bits:
    """MSB-first bit reader over a stuffing-stripped entropy segment."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.pos = 0

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        if p + n > len(self.bits):
            raise ValueError("JPEG entropy stream truncated")
        self.pos = p + n
        v = 0
        for b in self.bits[p : p + n]:
            v = (v << 1) | int(b)
        return v

    def huff(self, table: _Huff) -> int:
        code = 0
        p = self.pos
        bits = self.bits
        n = len(bits)
        for ln in range(1, table.max_len + 1):
            if p >= n:
                raise ValueError("JPEG entropy stream truncated")
            code = (code << 1) | int(bits[p])
            p += 1
            sym = table.map.get((ln, code))
            if sym is not None:
                self.pos = p
                return sym
        raise ValueError("invalid JPEG Huffman code")


def _extend(v: int, s: int) -> int:
    return v - ((1 << s) - 1) if s and v < (1 << (s - 1)) else v


def _upsample_triangle(c: np.ndarray, fh: int, fv: int,
                       h: int, w: int) -> np.ndarray:
    """libjpeg's "fancy" (triangle-filter) upsampling for factor-2 axes
    (out[2i] = (3·c[i] + c[i-1] + 2) >> 2, edges replicated); other
    factors use sample replication like stb."""
    def up2(a, axis):
        a = np.moveaxis(a, axis, 0).astype(np.int32)
        prev = np.concatenate([a[:1], a[:-1]], 0)
        nxt = np.concatenate([a[1:], a[-1:]], 0)
        even = (3 * a + prev + 2) >> 2
        odd = (3 * a + nxt + 1) >> 2
        out = np.empty((2 * a.shape[0],) + a.shape[1:], np.int32)
        out[0::2] = even
        out[1::2] = odd
        return np.moveaxis(out, 0, axis)

    out = c.astype(np.int32)
    f = fv
    while f > 1:
        out = up2(out, 0) if f % 2 == 0 else np.repeat(out, f, 0)
        f = f // 2 if f % 2 == 0 else 1
    f = fh
    while f > 1:
        out = up2(out, 1) if f % 2 == 0 else np.repeat(out, f, 1)
        f = f // 2 if f % 2 == 0 else 1
    return out[:h, :w]


def _finish_components(out, path):
    """Gray passthrough or JFIF YCbCr→RGB — shared by the baseline and
    progressive reconstruction paths."""
    if len(out) == 1:
        return out[0].astype(np.uint8)
    if len(out) != 3:
        raise NotImplementedError(
            f"{path}: {len(out)}-component JPEG unsupported")
    y, cb, cr = (o.astype(np.float64) for o in out)
    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136286 * (cb - 128.0) - 0.714136286 * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    return np.clip(np.round(np.stack([r, g, b], -1)), 0, 255).astype(np.uint8)


@codec_errors("JPEG")
def read_jpeg(path: str) -> np.ndarray:
    """Decode a baseline or progressive JPEG → uint8 (H, W) grayscale
    or (H, W, 3) RGB (JFIF YCbCr conversion)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG (no SOI marker)")

    qt: dict[int, np.ndarray] = {}
    huff_dc: dict[int, _Huff] = {}
    huff_ac: dict[int, _Huff] = {}
    frame = None
    progressive = False
    coefs = None      # progressive: per-component zigzag coefficients
    restart = 0
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: bad JPEG marker sync at {pos}")
        # T.81 B.1.1.2: any number of 0xFF fill bytes may precede a marker.
        while pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1
        if pos + 1 >= len(data):
            raise ValueError(f"{path}: truncated JPEG (fill bytes at EOF)")
        marker = data[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:   # EOI
            break
        (seg_len,) = struct.unpack(">H", data[pos : pos + 2])
        seg = data[pos + 2 : pos + seg_len]
        if marker == 0xDB:   # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                p += 1
                if pq:
                    vals = np.frombuffer(seg, ">u2", 64, p).astype(np.int32)
                    p += 128
                else:
                    vals = np.frombuffer(seg, np.uint8, 64, p).astype(np.int32)
                    p += 64
                q = np.zeros(64, np.int32)
                q[_ZIGZAG] = vals
                qt[tq] = q.reshape(8, 8)
        elif marker in (0xC0, 0xC1, 0xC2):   # SOF0/1 baseline, SOF2 prog
            prec, h, w, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise NotImplementedError(f"{path}: {prec}-bit JPEG")
            comps = []
            for i in range(nc):
                cid, hv, tq = seg[6 + 3 * i : 9 + 3 * i]
                comps.append((cid, hv >> 4, hv & 15, tq))
            frame = (h, w, comps)
            progressive = marker == 0xC2
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                        0xCD, 0xCE, 0xCF):
            raise NotImplementedError(
                f"{path}: JPEG SOF{marker - 0xC0} coding unsupported")
        elif marker == 0xC4:   # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = list(seg[p + 1 : p + 17])
                n = sum(counts)
                table = _Huff(counts, list(seg[p + 17 : p + 17 + n]))
                (huff_ac if tc else huff_dc)[th] = table
                p += 17 + n
        elif marker == 0xDD:   # DRI
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xDA:   # SOS → entropy-coded data follows
            if frame is None:
                raise ValueError(f"{path}: JPEG SOS before SOF")
            ns = seg[0]
            scan = []
            for i in range(ns):
                cs, tt = seg[1 + 2 * i : 3 + 2 * i]
                scan.append((cs, tt >> 4, tt & 15))
            ecs_start = pos + seg_len
            if not progressive:
                if ns < len(frame[2]):
                    # multi-scan (non-interleaved) baseline: each scan
                    # carries a component subset; decoding only the
                    # first would silently return a partial image.
                    # Rare — reject cleanly until the
                    # scan-accumulation path covers baseline too.
                    raise NotImplementedError(
                        f"{path}: non-interleaved multi-scan baseline "
                        f"JPEG ({ns} of {len(frame[2])} components in "
                        f"the first scan)")
                return _decode_scan(path, data, ecs_start, frame, scan,
                                    qt, huff_dc, huff_ac, restart)
            ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
            ahal = seg[3 + 2 * ns]
            if coefs is None:
                mcu_geom, geom = _prog_geom(frame)
                coefs = {cid: np.zeros((g[5], g[6], 64), np.int32)
                         for cid, g in geom.items()}
            pos = _decode_prog_scan(
                path, data, ecs_start, mcu_geom, geom, coefs, scan,
                ss, se, ahal >> 4, ahal & 15, huff_dc, huff_ac, restart)
            continue
        pos += seg_len
    if progressive and coefs is not None:
        return _reconstruct_prog(path, frame, geom, coefs, qt)
    raise ValueError(f"{path}: JPEG has no scan data")


def _entropy_segments(data, pos):
    """Split an entropy-coded stream starting at ``pos`` into restart
    segments (0xFF00 stuffing stripped, RSTn markers as boundaries).
    Returns (segments, end) where ``end`` points at the 0xFF of the
    first non-RST marker after the stream (or len(data))."""
    segments = []
    seg = bytearray()
    i = pos
    while i < len(data):
        b = data[i]
        if b == 0xFF:
            nxt = data[i + 1] if i + 1 < len(data) else 0xD9
            if nxt == 0x00:
                seg.append(0xFF)
                i += 2
                continue
            if 0xD0 <= nxt <= 0xD7:   # RSTn
                segments.append(bytes(seg))
                seg = bytearray()
                i += 2
                continue
            break                     # EOI or next marker
        seg.append(b)
        i += 1
    segments.append(bytes(seg))
    return segments, i


def _decode_scan(path, data, pos, frame, scan, qt, huff_dc, huff_ac,
                 restart):
    H, W, comps = frame
    if H == 0 or W == 0:
        raise ValueError(f"{path}: bad JPEG dimensions {W}x{H}")
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux = (W + 8 * hmax - 1) // (8 * hmax)
    mcuy = (H + 8 * vmax - 1) // (8 * vmax)
    n_mcu = mcux * mcuy

    segments, _ = _entropy_segments(data, pos)

    by_id = {c[0]: c for c in comps}
    scan_comps = []
    for cs, td, ta in scan:
        if cs not in by_id:
            raise ValueError(f"{path}: scan references unknown component {cs}")
        _, fh, fv, tq = by_id[cs]
        if td not in huff_dc or ta not in huff_ac or tq not in qt:
            raise ValueError(f"{path}: missing JPEG table")
        scan_comps.append((cs, fh, fv, qt[tq], huff_dc[td], huff_ac[ta]))

    # coefficient planes per component, in blocks
    planes = {cs: np.zeros((mcuy * fv * 8, mcux * fh * 8), np.float64)
              for cs, fh, fv, _, _, _ in scan_comps}

    interval = restart if restart else n_mcu
    mcu = 0
    for seg_bytes in segments:
        if mcu >= n_mcu:
            break
        bits = _Bits(seg_bytes)
        preds = {cs: 0 for cs, *_ in scan_comps}
        for _ in range(min(interval, n_mcu - mcu)):
            my, mx = divmod(mcu, mcux)
            for cs, fh, fv, q, hdc, hac in scan_comps:
                for by in range(fv):
                    for bx in range(fh):
                        coef = np.zeros(64, np.int32)
                        s = bits.huff(hdc)
                        preds[cs] += _extend(bits.get(s), s)
                        coef[0] = preds[cs]
                        k = 1
                        while k < 64:
                            rs = bits.huff(hac)
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r != 15:
                                    break
                                k += 16
                                continue
                            k += r
                            if k > 63:
                                raise ValueError(
                                    f"{path}: JPEG AC index overflow")
                            coef[_ZIGZAG[k]] = _extend(bits.get(s), s)
                            k += 1
                        block = coef.reshape(8, 8) * q
                        spatial = _B.T @ block @ _B + 128.0
                        y0 = (my * fv + by) * 8
                        x0 = (mx * fh + bx) * 8
                        planes[cs][y0 : y0 + 8, x0 : x0 + 8] = spatial
            mcu += 1
    if mcu < n_mcu:
        raise ValueError(f"{path}: JPEG truncated at MCU {mcu}/{n_mcu}")

    out = []
    for cs, fh, fv, _, _, _ in scan_comps:
        p = np.clip(np.round(planes[cs]), 0, 255)
        out.append(_upsample_triangle(p, hmax // fh, vmax // fv, H, W))
    return _finish_components(out, path)


# ------------------------------------------------- progressive (SOF2)


def _prog_geom(frame):
    """((hmax, vmax, mcux, mcuy), {cid: (fh, fv, tq, bwc, bhc, pbh,
    pbw)}): bwc/bhc are the component's REAL block counts (ceil of its
    sample dims / 8 — non-interleaved scans walk exactly these, T.81
    §A.2.2), pbh/pbw the MCU-padded block-grid dims interleaved DC
    scans cover."""
    H, W, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux = (W + 8 * hmax - 1) // (8 * hmax)
    mcuy = (H + 8 * vmax - 1) // (8 * vmax)
    geom = {}
    for cid, fh, fv, tq in comps:
        wc = (W * fh + hmax - 1) // hmax
        hc = (H * fv + vmax - 1) // vmax
        geom[cid] = ((fh, fv, tq, (wc + 7) // 8, (hc + 7) // 8,
                      mcuy * fv, mcux * fh))
    return (hmax, vmax, mcux, mcuy), geom


def _refine_nonzero(bits, zz, k, p1):
    """Read the correction bit for the nonzero-history coefficient
    zz[k] (T.81 §G.1.2.3; two's-complement & works for both signs)."""
    if bits.get(1) and (int(zz[k]) & p1) == 0:
        zz[k] += p1 if zz[k] > 0 else -p1


def _ac_first_block(bits, hac, zz, ss, se, al, eobrun):
    """AC spectral-selection first pass (Ah == 0) for one block."""
    if eobrun > 0:
        return eobrun - 1
    k = ss
    while k <= se:
        rs = bits.huff(hac)
        r, s = rs >> 4, rs & 15
        if s == 0:
            if r != 15:
                eobrun = (1 << r) - 1
                if r:
                    eobrun += bits.get(r)
                break
            k += 16
            continue
        k += r
        if k > se:
            raise ValueError("JPEG progressive AC index overflow")
        zz[k] = _extend(bits.get(s), s) << al
        k += 1
    return eobrun


def _ac_refine_block(bits, hac, zz, ss, se, al, eobrun):
    """AC successive-approximation refinement (Ah == Al + 1) for one
    block — the T.81 §G.1.2.3 / libjpeg decode_mcu_AC_refine logic:
    new coefficients arrive as ±(1<<Al); every nonzero-history
    coefficient passed on the way carries one correction bit."""
    p1 = 1 << al
    k = ss
    if eobrun == 0:
        while k <= se:
            rs = bits.huff(hac)
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += bits.get(r)
                    break
                val = 0          # ZRL: skip 16 zero-history positions
            else:
                if s != 1:
                    raise ValueError(
                        "bad JPEG AC refinement magnitude")
                val = p1 if bits.get(1) else -p1
            while k <= se:
                if zz[k]:
                    _refine_nonzero(bits, zz, k, p1)
                else:
                    if r == 0:
                        break
                    r -= 1
                k += 1
            if val and k <= se:
                zz[k] = val
            k += 1
    if eobrun > 0:
        while k <= se:
            if zz[k]:
                _refine_nonzero(bits, zz, k, p1)
            k += 1
        eobrun -= 1
    return eobrun


def _decode_prog_scan(path, data, pos, mcu_geom, geom, coefs, scan,
                      ss, se, ah, al, huff_dc, huff_ac, restart):
    """Decode ONE progressive scan into the persistent coefficient
    store; returns the stream position after its entropy data.

    Scan kinds (T.81 §G.1): DC first (Ss=0, Ah=0; interleaved over the
    MCU grid when ns > 1), DC refine (Ss=0, Ah>0; one raw bit per
    block, no Huffman table), AC first / AC refine (Ss>0; exactly one
    component, walking its real block grid in raster order).  Restart
    markers reset the DC predictors and the EOB run."""
    hmax, vmax, mcux, mcuy = mcu_geom
    segments, end = _entropy_segments(data, pos)

    if ss == 0:   # DC scan
        units = []   # (cid, zz-plane, by, bx) walk order
        if len(scan) > 1:
            for m in range(mcux * mcuy):
                my, mx = divmod(m, mcux)
                for cs, td, _ in scan:
                    fh, fv = geom[cs][0], geom[cs][1]
                    for by in range(fv):
                        for bx in range(fh):
                            units.append((cs, my * fv + by, mx * fh + bx))
            # restart intervals count MCUs in the interleaved case
            mcu_units = sum(geom[cs][0] * geom[cs][1] for cs, *_ in scan)
        else:
            cs = scan[0][0]
            _, _, _, bwc, bhc, _, _ = geom[cs]
            units = [(cs, by, bx) for by in range(bhc) for bx in range(bwc)]
            mcu_units = 1
        if ah == 0:
            for cs, td, _ in scan:
                if td not in huff_dc:
                    raise ValueError(f"{path}: missing JPEG DC table {td}")
        hdc = {cs: huff_dc.get(td) for cs, td, _ in scan}
        interval = (restart if restart else len(units)) * (
            mcu_units if len(scan) > 1 else 1)
        u = 0
        for seg_bytes in segments:
            if u >= len(units):
                break
            bits = _Bits(seg_bytes)
            preds = {cs: 0 for cs, *_ in scan}
            for _ in range(min(interval, len(units) - u)):
                cs, by, bx = units[u]
                zz = coefs[cs][by, bx]
                if ah == 0:
                    s = bits.huff(hdc[cs])
                    preds[cs] += _extend(bits.get(s), s)
                    zz[0] = preds[cs] << al
                else:
                    if bits.get(1):
                        zz[0] = int(zz[0]) | (1 << al)
                u += 1
        if u < len(units):
            raise ValueError(f"{path}: progressive DC scan truncated "
                             f"at {u}/{len(units)}")
        return end

    # AC scan: exactly one component (T.81 §G.1.1.1.1)
    if len(scan) != 1:
        raise ValueError(f"{path}: progressive AC scan with "
                         f"{len(scan)} components")
    cs, _, ta = scan[0]
    if ta not in huff_ac:
        raise ValueError(f"{path}: missing JPEG AC table {ta}")
    hac = huff_ac[ta]
    _, _, _, bwc, bhc, _, _ = geom[cs]
    n_blocks = bwc * bhc
    interval = restart if restart else n_blocks
    plane = coefs[cs]
    u = 0
    for seg_bytes in segments:
        if u >= n_blocks:
            break
        bits = _Bits(seg_bytes)
        eobrun = 0
        for _ in range(min(interval, n_blocks - u)):
            by, bx = divmod(u, bwc)
            zz = plane[by, bx]
            if ah == 0:
                eobrun = _ac_first_block(bits, hac, zz, ss, se, al, eobrun)
            else:
                eobrun = _ac_refine_block(bits, hac, zz, ss, se, al, eobrun)
            u += 1
    if u < n_blocks:
        raise ValueError(f"{path}: progressive AC scan truncated "
                         f"at {u}/{n_blocks}")
    return end


def _reconstruct_prog(path, frame, geom, coefs, qt):
    """Dequantize + IDCT the accumulated progressive coefficients and
    finish exactly like the baseline path (clip, fancy upsample, JFIF
    color convert)."""
    H, W, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    out = []
    for cid, fh, fv, tq in comps:
        if tq not in qt:
            raise ValueError(f"{path}: missing JPEG quant table {tq}")
        zz = coefs[cid]                      # (pbh, pbw, 64) zigzag
        nat = np.zeros_like(zz)
        nat[..., _ZIGZAG] = zz               # → natural order
        blocks = nat.reshape(*zz.shape[:2], 8, 8) * qt[tq]
        spatial = np.einsum("kn,yxkl,lm->yxnm", _B, blocks, _B) + 128.0
        pbh, pbw = zz.shape[:2]
        plane = spatial.transpose(0, 2, 1, 3).reshape(pbh * 8, pbw * 8)
        p = np.clip(np.round(plane), 0, 255)
        out.append(_upsample_triangle(p, hmax // fh, vmax // fv, H, W))
    return _finish_components(out, path)


# ------------------------------------------------------------- encoder

# Annex K base quantization tables (natural order, K.1/K.2)
_QT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int32)
_QT_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], np.int32)

# Annex K standard Huffman tables: (BITS counts[1..16], HUFFVAL)
_HT_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
               list(range(12)))
_HT_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
                 list(range(12)))
_HT_AC_LUMA = (
    [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
    [0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
     0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
     0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
     0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
     0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
     0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
     0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
     0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
     0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
     0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
     0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
     0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
     0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
     0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_HT_AC_CHROMA = (
    [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
    [0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
     0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
     0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15,
     0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17,
     0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37,
     0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A,
     0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65,
     0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
     0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A,
     0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
     0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5,
     0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
     0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9,
     0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
     0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def _enc_codes(table):
    """Canonical (counts, symbols) → {symbol: (code, length)}."""
    counts, symbols = table
    out = {}
    code = 0
    it = iter(symbols)
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            out[next(it)] = (code, ln)
            code += 1
        code <<= 1
    return out


class _BitWriter:
    """MSB-first bit accumulator with 0xFF byte stuffing."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            byte = (self.acc >> (self.nbits - 8)) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0x00)
            self.nbits -= 8
        self.acc &= (1 << self.nbits) - 1

    def flush(self) -> bytes:
        if self.nbits:
            self.put(0xFF >> (8 - (8 - self.nbits) % 8), (8 - self.nbits) % 8)
        return bytes(self.out)


def _mag(v: int) -> tuple[int, int]:
    """JPEG magnitude coding: value → (size, size-bit code)."""
    if v == 0:
        return 0, 0
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _quality_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    q = min(100, max(1, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    lt = np.clip((_QT_LUMA * scale + 50) // 100, 1, 255)
    ct = np.clip((_QT_CHROMA * scale + 50) // 100, 1, 255)
    return lt, ct


def write_jpeg(path: str, img: np.ndarray, quality: int = 90) -> None:
    """Baseline sequential JPEG writer (stb_image_write surface):
    uint8 (H, W) grayscale or (H, W, 3) RGB, 4:4:4 (no subsampling),
    Annex K standard Huffman tables, libjpeg quality scaling."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"JPEG writer needs uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"JPEG writer needs (H,W) or (H,W,3), got {img.shape}")
    H, W = img.shape[:2]
    gray = img.ndim == 2
    lt, ct = _quality_tables(quality)

    if gray:
        planes = [img.astype(np.float64)]
    else:
        r, g, b = (img[..., i].astype(np.float64) for i in range(3))
        yy = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
        cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
        planes = [yy, cb, cr]
    ph = (H + 7) & ~7
    pw = (W + 7) & ~7
    planes = [np.pad(p, ((0, ph - H), (0, pw - W)), mode="edge")
              for p in planes]

    out = bytearray(b"\xff\xd8")                       # SOI
    out += b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00\x01\x01\x00" \
        + struct.pack(">HH", 1, 1) + b"\x00\x00"       # APP0
    for tid, qt in ([(0, lt)] if gray else [(0, lt), (1, ct)]):
        out += b"\xff\xdb" + struct.pack(">HB", 67, tid) \
            + bytes(int(qt[z]) for z in _ZIGZAG)       # DQT (zigzag order)
    ncomp = 1 if gray else 3
    out += b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * ncomp, 8, H, W, ncomp)
    for cid in range(1, ncomp + 1):
        out += struct.pack("BBB", cid, 0x11, 0 if cid == 1 else 1)
    hts = [(0x00, _HT_DC_LUMA), (0x10, _HT_AC_LUMA)]
    if not gray:
        hts += [(0x01, _HT_DC_CHROMA), (0x11, _HT_AC_CHROMA)]
    for tid, (counts, symbols) in hts:
        out += b"\xff\xc4" + struct.pack(">HB", 3 + 16 + len(symbols), tid) \
            + bytes(counts) + bytes(symbols)
    out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * ncomp, ncomp)
    for cid in range(1, ncomp + 1):
        out += struct.pack("BB", cid, 0x00 if cid == 1 else 0x11)
    out += b"\x00\x3f\x00"

    bw = _BitWriter()
    dc_l, ac_l = _enc_codes(_HT_DC_LUMA), _enc_codes(_HT_AC_LUMA)
    dc_c, ac_c = _enc_codes(_HT_DC_CHROMA), _enc_codes(_HT_AC_CHROMA)
    # 4:4:4 non-interleaved would need one scan per component; with
    # h=v=1 for every component the interleaved MCU is one block per
    # component in component order
    preds = [0, 0, 0]
    qts = [lt.astype(np.float64)] + [ct.astype(np.float64)] * 2
    codes = [(dc_l, ac_l), (dc_c, ac_c), (dc_c, ac_c)]
    zz = _ZIGZAG
    for y0 in range(0, ph, 8):
        for x0 in range(0, pw, 8):
            for ci, p in enumerate(planes):
                block = p[y0 : y0 + 8, x0 : x0 + 8] - 128.0
                coef = _B @ block @ _B.T
                qc = np.round(coef.reshape(64) / qts[ci]).astype(np.int32)
                zigzag = qc[zz]
                s, bits = _mag(int(zigzag[0]) - preds[ci])
                preds[ci] = int(zigzag[0])
                dc_codes, ac_codes = codes[ci]
                code, ln = dc_codes[s]
                bw.put(code, ln)
                if s:
                    bw.put(bits, s)
                nz = np.nonzero(zigzag[1:])[0]
                prev = 0
                for idx in nz:
                    run = idx - prev
                    while run >= 16:
                        code, ln = ac_codes[0xF0]
                        bw.put(code, ln)
                        run -= 16
                    s, bits = _mag(int(zigzag[1 + idx]))
                    code, ln = ac_codes[(run << 4) | s]
                    bw.put(code, ln)
                    bw.put(bits, s)
                    prev = idx + 1
                if prev < 63:
                    code, ln = ac_codes[0x00]
                    bw.put(code, ln)
    out += bw.flush()
    out += b"\xff\xd9"                                 # EOI
    with open(path, "wb") as f:
        f.write(bytes(out))
