"""Image files without Pillow: JPEG and PNG, read and written with numpy.

The port's counterpart of the JAX package's ``Image.open(path).convert("RGB")``
(``scene/builder.py``) and ``Image.save(path, quality=100)``
(``render/film.py``).  Host code, run once per texture read or image write.

The JPEG decoder takes baseline (SOF0), extended 8-bit Huffman (SOF1) and
progressive (SOF2) files of 1 or 3 components, sampling factors 1 or 2 and
restart intervals.  It follows libjpeg's algorithms so that it computes the
texels that Pillow's libjpeg computes: the integer "islow" inverse DCT
(jidctint.c), fancy triangle upsampling (jdsample.c) and the fixed-point
YCbCr->RGB tables (jdcolor.c).  The encoder writes what libjpeg writes under
Pillow's defaults: baseline with a JFIF segment, 4:2:0, the IJG tables scaled
to the quality, Annex K's Huffman tables, the integer forward DCT
(jfdctint.c) and h2v2 downsampling with its alternating bias (jcsample.c).
Huffman decoding runs in Python on 16-bit lookup tables; the transforms,
resampling, colour conversion and Huffman encoding are vectorised over all
blocks.  The PNG reader takes the 8-bit RGB filter-0 files that the PNG
writer writes.  What either reader does not take raises ``ValueError``.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def read_image(path: str) -> np.ndarray:
    """u8[H, W, 3] of a ``.jpg``/``.jpeg`` or ``.png`` file."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        return read_jpeg(path)
    if ext == ".png":
        return read_png(path)
    raise ValueError(f"unsupported image extension {ext!r} of {path!r} (use .jpg, .jpeg or .png)")


def write_image(path: str, img: np.ndarray) -> None:
    """Write u8[H, W, 3]: JPEG at quality 100 for ``.jpg``/``.jpeg``, PNG for ``.png``."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        write_jpeg(path, img)
    elif ext == ".png":
        write_png(path, img)
    else:
        raise ValueError(f"unsupported image extension {ext!r} of {path!r} (use .jpg, .jpeg or .png)")


def _rgb_u8(img) -> np.ndarray:
    arr = np.ascontiguousarray(img, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3 or arr.shape[0] < 1 or arr.shape[1] < 1:
        raise ValueError(f"expected an image u8[H, W, 3], got shape {arr.shape}")
    return arr


# --------------------------------------------------------------------- PNG


def png_bytes(img) -> bytes:
    """8-bit RGB PNG: IHDR, one zlib IDAT of filter-0 rows, IEND."""
    arr = _rgb_u8(img)
    h, w, _ = arr.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b"")
    )


def write_png(path: str, img) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))


_PNG_FILTERS = {1: "Sub", 2: "Up", 3: "Average", 4: "Paeth"}


def read_png(src) -> np.ndarray:
    """Decode the 8-bit RGB, non-interlaced, filter-0 PNG that
    :func:`write_png` writes to u8[H, W, 3]; any other form raises
    ``ValueError`` naming it."""
    data = _read_bytes(src)
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file (bad signature)")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype != 2 or interlace:
        raise ValueError(
            f"PNG of bit depth {depth}, colour type {ctype}, interlace {interlace} is not supported "
            "(8-bit RGB, colour type 2, not interlaced)"
        )
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (3 * w + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8)[: h * (3 * w + 1)].reshape(h, 3 * w + 1)
    bad = rows[:, 0][rows[:, 0] != 0]
    if bad.size:
        f = int(bad[0])
        raise ValueError(f"PNG row filter {f} ({_PNG_FILTERS.get(f, 'undefined')}) is not supported (filter 0 only)")
    return rows[:, 1:].reshape(h, w, 3).copy()


def _read_bytes(src) -> bytes:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src)
    with open(src, "rb") as f:
        return f.read()


# ----------------------------------------------------------- JPEG: shared


def _zigzag() -> np.ndarray:
    cells = [(r + c, r if (r + c) % 2 else c, r * 8 + c) for r in range(8) for c in range(8)]
    return np.array([n for _, _, n in sorted(cells)], dtype=np.int64)


ZIGZAG = _zigzag()  # ZIGZAG[k]: row-major index in the 8x8 block of zigzag position k

# jidctint.c / jfdctint.c: CONST_BITS 13, PASS1_BITS 2, FIX(x) = round(x * 2^13)
_CB, _P1 = 13, 2
_F0298, _F0390, _F0541, _F0765, _F0899, _F1175 = 2446, 3196, 4433, 6270, 7373, 9633
_F1501, _F1847, _F1961, _F2053, _F2562, _F3072 = 12299, 15137, 16069, 16819, 20995, 25172


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _odd_part(a7, a5, a3, a1):
    """The shared odd half of jidctint.c and jfdctint.c (inputs tmp0-3 of the
    inverse, tmp4-7 of the forward transform); returns the four sums."""
    z1, z2, z3, z4 = a7 + a1, a5 + a3, a7 + a3, a5 + a1
    z5 = (z3 + z4) * _F1175
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    return a7 * _F0298 + z1 + z3, a5 * _F2053 + z2 + z4, a3 * _F3072 + z2 + z3, a1 * _F1501 + z1 + z4


def _idct_1d(x):
    """One pass of jpeg_idct_islow over eight int64 arrays; outputs before descaling."""
    z1 = (x[2] + x[6]) * _F0541
    t2, t3 = z1 - x[6] * _F1847, z1 + x[2] * _F0765
    t0, t1 = (x[0] + x[4]) << _CB, (x[0] - x[4]) << _CB
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    o0, o1, o2, o3 = _odd_part(x[7], x[5], x[3], x[1])
    return [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3]


def _idct_islow(blocks: np.ndarray) -> np.ndarray:
    """Dequantized int64[..., 8, 8] (row-major) -> u8 samples, as jidctint.c
    with its post-IDCT range-limit table (values wrap mod 1024 first)."""
    ws = np.stack([_descale(v, _CB - _P1) for v in _idct_1d([blocks[..., k, :] for k in range(8)])], -2)
    out = np.stack([_descale(v, _CB + _P1 + 3) for v in _idct_1d([ws[..., k] for k in range(8)])], -1)
    out = ((out + 512) & 1023) - 512
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _fdct_1d(d, first_pass: bool):
    """One pass of jpeg_fdct_islow over eight int64 arrays, descaled."""
    t0, t7, t1, t6 = d[0] + d[7], d[0] - d[7], d[1] + d[6], d[1] - d[6]
    t2, t5, t3, t4 = d[2] + d[5], d[2] - d[5], d[3] + d[4], d[3] - d[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    z1 = (t12 + t13) * _F0541
    o4, o5, o6, o7 = _odd_part(t4, t5, t6, t7)
    n = _CB - _P1 if first_pass else _CB + _P1
    if first_pass:
        e0, e4 = (t10 + t11) << _P1, (t10 - t11) << _P1
    else:
        e0, e4 = _descale(t10 + t11, _P1), _descale(t10 - t11, _P1)
    out = [e0, o7, z1 + t13 * _F0765, o6, e4, o5, z1 - t12 * _F1847, o4]
    return [v if i in (0, 4) else _descale(v, n) for i, v in enumerate(out)]


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """Level-shifted int64[..., 8, 8] samples -> DCT coefficients scaled by 8."""
    ws = np.stack(_fdct_1d([blocks[..., k] for k in range(8)], True), -1)
    return np.stack(_fdct_1d([ws[..., k, :] for k in range(8)], False), -2)


# -------------------------------------------------------- JPEG: decoding

_SOF_NAMES = {
    0xC3: "SOF3 (lossless)",
    0xC5: "SOF5 (differential sequential, hierarchical)",
    0xC6: "SOF6 (differential progressive, hierarchical)",
    0xC7: "SOF7 (differential lossless, hierarchical)",
    0xC9: "SOF9 (arithmetic-coded sequential)",
    0xCA: "SOF10 (arithmetic-coded progressive)",
    0xCB: "SOF11 (arithmetic-coded lossless)",
    0xCD: "SOF13 (differential arithmetic-coded sequential, hierarchical)",
    0xCE: "SOF14 (differential arithmetic-coded progressive, hierarchical)",
    0xCF: "SOF15 (differential arithmetic-coded lossless, hierarchical)",
}
_BAD_HUFFMAN = "corrupt JPEG data: no Huffman code matches the bits"


def _huffman_lut(counts, symbols) -> list:
    """16-bit lookup table: entry = symbol << 5 | code length, 0 for no code."""
    lut = np.zeros(1 << 16, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError("corrupt JPEG data: bad Huffman table")
            lo = code << (16 - length)
            lut[lo : lo + (1 << (16 - length))] = (symbols[k] << 5) | length
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _bit_words(seg: bytes) -> list:
    """w[i] = bytes i..i+3 big-endian: the bits at position p are in
    ``w[p >> 3]``; zero bytes past the end, as libjpeg pads a segment."""
    a = np.frombuffer(seg + bytes(8), np.uint8).astype(np.int64)
    return ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8) | a[3:]).tolist()


def _decode_sequential(w, blocks, preds) -> None:
    """Baseline/extended Huffman blocks of one restart segment (jdhuff.c)."""
    p = 0
    for coef, off, dc, ac, ci in blocks:
        look = dc[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        if not look & 31:
            raise ValueError(_BAD_HUFFMAN)
        p += look & 31
        s = look >> 5
        if s:
            if s > 16:
                raise ValueError(f"corrupt JPEG data: DC magnitude category {s}")
            v = (w[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
            p += s
            if v < 1 << (s - 1):
                v -= (1 << s) - 1
            preds[ci] += v
        coef[off] = preds[ci]
        k = 1
        while k < 64:
            look = ac[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if not look & 31:
                raise ValueError(_BAD_HUFFMAN)
            p += look & 31
            rs = look >> 5
            s = rs & 15
            if s:
                k += rs >> 4
                v = (w[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                coef[off + (k if k < 64 else 63)] = v
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break


def _decode_dc_first(w, blocks, preds, al: int) -> None:
    p = 0
    for coef, off, dc, _, ci in blocks:
        look = dc[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        if not look & 31:
            raise ValueError(_BAD_HUFFMAN)
        p += look & 31
        s = look >> 5
        if s:
            if s > 16:
                raise ValueError(f"corrupt JPEG data: DC magnitude category {s}")
            v = (w[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
            p += s
            if v < 1 << (s - 1):
                v -= (1 << s) - 1
            preds[ci] += v
        coef[off] = preds[ci] << al


def _decode_dc_refine(w, blocks, al: int) -> None:
    p = 0
    for coef, off, _, _, _ in blocks:
        if (w[p >> 3] >> (31 - (p & 7))) & 1:
            coef[off] |= 1 << al
        p += 1


def _decode_ac_first(w, blocks, ss: int, se: int, al: int) -> None:
    p = eobrun = 0
    for coef, off, _, ac, _ in blocks:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            look = ac[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if not look & 31:
                raise ValueError(_BAD_HUFFMAN)
            p += look & 31
            rs = look >> 5
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                v = (w[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                coef[off + (k if k < 64 else 63)] = v << al
            elif r == 15:
                k += 15
            else:
                eobrun = 1 << r
                if r:
                    eobrun += (w[p >> 3] >> (32 - r - (p & 7))) & ((1 << r) - 1)
                    p += r
                eobrun -= 1
                break
            k += 1


def _decode_ac_refine(w, blocks, ss: int, se: int, al: int) -> None:
    """Successive approximation of AC bands (jdphuff.c decode_mcu_AC_refine)."""
    p1, m1 = 1 << al, -1 << al
    p = eobrun = 0
    for coef, off, _, ac, _ in blocks:
        k = ss
        if not eobrun:
            while k <= se:
                look = ac[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not look & 31:
                    raise ValueError(_BAD_HUFFMAN)
                p += look & 31
                rs = look >> 5
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if (w[p >> 3] >> (31 - (p & 7))) & 1 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (w[p >> 3] >> (32 - r - (p & 7))) & ((1 << r) - 1)
                        p += r
                    break
                while k <= se:  # refine nonzero coefficients up to the r-th zero
                    c = coef[off + k]
                    if c:
                        bit = (w[p >> 3] >> (31 - (p & 7))) & 1
                        p += 1
                        if bit and not c & p1:
                            coef[off + k] = c + (p1 if c >= 0 else m1)
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    coef[off + (k if k < 64 else 63)] = s
                k += 1
        if eobrun:
            while k <= se:  # refine what is left of the band after an end-of-band
                c = coef[off + k]
                if c:
                    bit = (w[p >> 3] >> (31 - (p & 7))) & 1
                    p += 1
                    if bit and not c & p1:
                        coef[off + k] = c + (p1 if c >= 0 else m1)
                k += 1
            eobrun -= 1


def _scan_segments(data: bytes, pos: int):
    """The entropy-coded data from ``pos``, split at RSTn markers and
    unstuffed -> (segments, position of the marker that ends the scan)."""
    segs, start = [], pos
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            segs.append(data[start:].replace(b"\xff\x00", b"\xff"))
            return segs, len(data)
        nxt = data[i + 1]
        if nxt == 0x00 or nxt == 0xFF:
            pos = i + 1 if nxt == 0xFF else i + 2
        elif 0xD0 <= nxt <= 0xD7:
            segs.append(data[start:i].replace(b"\xff\x00", b"\xff"))
            start = pos = i + 2
        else:
            segs.append(data[start:i].replace(b"\xff\x00", b"\xff"))
            return segs, i


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """libjpeg's upsampling of a component plane by integer factors: fancy
    (triangle) for h2v1, h2v2 when the plane is more than 2 samples wide and
    h1v2; replication otherwise (jdsample.c)."""
    x = plane.astype(np.int64)
    hh, ww = x.shape
    fancy_h = fh == 2 and ww > 2
    if fv == 2 and (fancy_h or fh == 1):
        up, dn = x[np.r_[0, : hh - 1]], x[np.r_[1:hh, hh - 1]]
        if fh == 1:  # h1v2
            out = np.empty((2 * hh, ww), np.int64)
            out[0::2] = (3 * x + up + 1) >> 2
            out[1::2] = (3 * x + dn + 2) >> 2
            return out
        rows = np.empty((2 * hh, ww), np.int64)  # h2v2: column sums first
        rows[0::2] = 3 * x + up
        rows[1::2] = 3 * x + dn
        left, right = rows[:, np.r_[0, : ww - 1]], rows[:, np.r_[1:ww, ww - 1]]
        out = np.empty((2 * hh, 2 * ww), np.int64)
        out[:, 0::2] = (3 * rows + left + 8) >> 4
        out[:, 1::2] = (3 * rows + right + 7) >> 4
        return out
    if fv == 1 and fancy_h:  # h2v1
        left, right = x[:, np.r_[0, : ww - 1]], x[:, np.r_[1:ww, ww - 1]]
        out = np.empty((hh, 2 * ww), np.int64)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
        return out
    return np.repeat(np.repeat(x, fv, axis=0), fh, axis=1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: 16-bit fixed-point tables, clamped."""
    def fix(v):
        return int(v * 65536 + 0.5)

    half = 1 << 15
    cb, cr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * cr + half) >> 16)
    g = y + ((-fix(0.34414) * cb + half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def read_jpeg(src) -> np.ndarray:
    """Decode a JPEG file (a path or its bytes) to u8[H, W, 3]; a grayscale
    file is replicated to RGB, as Pillow's ``convert("RGB")`` does."""
    data = _read_bytes(src)
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qts: dict = {}
    huff: dict = {}
    restart = 0
    frame = None
    adobe_transform = None
    jfif = False
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            pos = data.find(b"\xff", pos)  # skip garbage between segments
            if pos < 0:
                break
            continue
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker in (0x01, 0x00):
            continue
        (length,) = struct.unpack(">H", data[pos : pos + 2])
        seg = data[pos + 2 : pos + length]
        pos += length
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(seg[i + 1 : i + 1 + n], ">u2" if pq else np.uint8).astype(np.int64)
                table = np.empty(64, np.int64)
                table[ZIGZAG] = vals
                qts[tq] = table
                i += 1 + n
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1 : i + 17])
                n = sum(counts)
                huff[(tc, th)] = _huffman_lut(counts, list(seg[i + 17 : i + 17 + n]))
                i += 17 + n
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker in (0xC0, 0xC1, 0xC2):
            frame = _parse_sof(marker, seg)
        elif marker in _SOF_NAMES:
            raise ValueError(f"JPEG {_SOF_NAMES[marker]} is not supported")
        elif marker == 0xCC:
            raise ValueError("JPEG DAC marker: arithmetic coding is not supported")
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG SOS before any SOF marker")
            segs, pos = _scan_segments(data, pos)
            _decode_scan(frame, seg, segs, qts, huff, restart)
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        # other APPn, COM, DNL: skipped
    if frame is None or not frame["scanned"]:
        raise ValueError("JPEG file without image data")
    return _frame_pixels(frame, jfif, adobe_transform)


def _parse_sof(marker: int, seg: bytes) -> dict:
    precision, height, width, ncomp = struct.unpack(">BHHB", seg[:6])
    name = f"SOF{marker - 0xC0}"
    if precision != 8:
        raise ValueError(f"JPEG of {precision}-bit precision ({name}) is not supported: only 8-bit")
    if ncomp not in (1, 3):
        raise ValueError(f"JPEG of {ncomp} components (CMYK/YCCK) is not supported: only 1 or 3")
    if height == 0 or width == 0:
        raise ValueError("JPEG of height 0 (DNL marker) is not supported")
    comps = []
    for i in range(ncomp):
        cid, hv, tq = seg[6 + 3 * i : 9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if h not in (1, 2) or v not in (1, 2):
            raise ValueError(f"JPEG sampling factors {h}x{v} are not supported: only 1 or 2")
        comps.append({"id": cid, "h": h, "v": v, "tq": tq})
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    for c in comps:
        c["cw"] = -(-width * c["h"] // hmax)  # the component's samples (downsampled_width)
        c["ch"] = -(-height * c["v"] // vmax)
        c["bw"], c["bh"] = -(-c["cw"] // 8), -(-c["ch"] // 8)
        c["pbw"], c["pbh"] = mcux * c["h"], mcuy * c["v"]  # blocks of the padded plane
        c["coef"] = [0] * (c["pbw"] * c["pbh"] * 64)  # zigzag order, block after block
        c["q"] = None
    return {"marker": marker, "width": width, "height": height, "comps": comps, "hmax": hmax,
            "vmax": vmax, "mcux": mcux, "mcuy": mcuy, "scanned": False}


def _decode_scan(frame, seg, segs, qts, huff, restart) -> None:
    ns = seg[0]
    by_id = {c["id"]: c for c in frame["comps"]}
    scomps = []
    for i in range(ns):
        cid, tables = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in by_id:
            raise ValueError(f"JPEG scan names component {cid}, which the frame does not have")
        scomps.append((by_id[cid], tables >> 4, tables & 15))
    ss, se, ahl = seg[1 + 2 * ns : 4 + 2 * ns]
    ah, al = ahl >> 4, ahl & 15
    progressive = frame["marker"] == 0xC2
    if not progressive:
        ss, se, ah, al = 0, 63, 0, 0
    elif ss > se or se > 63 or (ss == 0 and se != 0) or (ss > 0 and ns != 1):
        raise ValueError(f"invalid progressive JPEG scan (Ss {ss}, Se {se}, {ns} components)")
    for c, _, _ in scomps:
        if c["q"] is None:  # latched at the component's first scan, as libjpeg does
            if c["tq"] not in qts:
                raise ValueError(f"JPEG quantization table {c['tq']} is not defined")
            c["q"] = qts[c["tq"]]

    def table(tc, th):
        if (tc, th) not in huff:
            raise ValueError(f"JPEG Huffman table {'AC' if tc else 'DC'} {th} is not defined")
        return huff[(tc, th)]

    needs_dc = ss == 0 and ah == 0
    needs_ac = se > 0
    blocks = []  # (coefficient list, offset, DC table, AC table, index of the DC predictor)
    if ns == 1:
        c, td, ta = scomps[0]
        dc = table(0, td) if needs_dc else None
        ac = table(1, ta) if needs_ac else None
        offs = ((np.arange(c["bh"])[:, None] * c["pbw"] + np.arange(c["bw"])[None, :]) * 64).ravel()
        blocks = [(c["coef"], o, dc, ac, 0) for o in offs.tolist()]
        per_mcu = 1
    else:
        per_comp = []
        for i, (c, td, ta) in enumerate(scomps):
            dc = table(0, td) if needs_dc else None
            ac = table(1, ta) if needs_ac else None
            my, mx, v, h = np.meshgrid(np.arange(frame["mcuy"]), np.arange(frame["mcux"]),
                                       np.arange(c["v"]), np.arange(c["h"]), indexing="ij")
            offs = ((my * c["v"] + v) * c["pbw"] + mx * c["h"] + h) * 64
            per_comp.append([(c["coef"], o, dc, ac, i) for o in offs.reshape(-1, c["v"] * c["h"]).ravel().tolist()])
        per_mcu = sum(c["h"] * c["v"] for c, _, _ in scomps)
        sizes = [c["h"] * c["v"] for c, _, _ in scomps]
        for m in range(frame["mcux"] * frame["mcuy"]):
            for lst, n in zip(per_comp, sizes):
                blocks.extend(lst[m * n : (m + 1) * n])
    n_mcu = len(blocks) // per_mcu
    interval = restart if restart else n_mcu
    n_segs = -(-n_mcu // interval)
    if len(segs) < n_segs:
        raise ValueError(f"JPEG scan is truncated: {len(segs)} of {n_segs} restart intervals")
    for i in range(n_segs):
        part = blocks[i * interval * per_mcu : (i + 1) * interval * per_mcu]
        w = _bit_words(segs[i])
        preds = [0] * len(scomps)
        try:
            if ss == 0 and not progressive:
                _decode_sequential(w, part, preds)
            elif ss == 0:
                _decode_dc_first(w, part, preds, al) if ah == 0 else _decode_dc_refine(w, part, al)
            elif ah == 0:
                _decode_ac_first(w, part, ss, se, al)
            else:
                _decode_ac_refine(w, part, ss, se, al)
        except IndexError as e:
            raise ValueError("corrupt JPEG data: the scan runs past its end") from e
    frame["scanned"] = True


def _frame_pixels(frame, jfif: bool, adobe_transform) -> np.ndarray:
    planes = []
    for c in frame["comps"]:
        zz = np.array(c["coef"], dtype=np.int64).reshape(c["pbh"], c["pbw"], 64)
        nat = np.empty_like(zz)
        nat[..., ZIGZAG] = zz
        q = c["q"] if c["q"] is not None else np.zeros(64, np.int64)
        samples = _idct_islow((nat * q).reshape(c["pbh"], c["pbw"], 8, 8))
        plane = samples.transpose(0, 2, 1, 3).reshape(c["pbh"] * 8, c["pbw"] * 8)[: c["ch"], : c["cw"]]
        up = _upsample(plane, frame["hmax"] // c["h"], frame["vmax"] // c["v"])
        planes.append(up[: frame["height"], : frame["width"]])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2)
    ids = tuple(c["id"] for c in frame["comps"])
    rgb = (not jfif) and (adobe_transform == 0 if adobe_transform is not None else ids == (82, 71, 66))
    if rgb:
        return np.stack(planes, -1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


# -------------------------------------------------------- JPEG: encoding

# IJG's tables (the JPEG standard's Annex K.1), row-major
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)
_Q_CHROMA = np.full(64, 99, np.int64)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# Annex K.3's Huffman tables: (code counts by length 1-16, symbols)
_HUFF_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12)))
_HUFF_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12)))
_HUFF_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_HUFF_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def _quant_tables(quality: int):
    """jpeg_set_quality with force_baseline: the IJG tables scaled, clamped to 1..255."""
    if not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality must be in 1..100, got {quality}")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [np.clip((t * scale + 50) // 100, 1, 255) for t in (_Q_LUMA, _Q_CHROMA)]


def _huffman_codes(spec):
    """(code, length) of every symbol of a (counts, symbols) table (Annex C)."""
    counts, symbols = spec
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _rgb_to_ycc(arr: np.ndarray):
    """jccolor.c's rgb_ycc_convert: 16-bit fixed point, Cb/Cr rounded by 0.5-epsilon."""
    def fix(v):
        return int(v * 65536 + 0.5)

    r, g, b = (arr[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + offset + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + offset + half - 1) >> 16
    return y, cb, cr


def _blocks_of(plane: np.ndarray) -> np.ndarray:
    hh, ww = plane.shape
    return plane.reshape(hh // 8, 8, ww // 8, 8).transpose(0, 2, 1, 3)


def _quantize(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Samples -> quantized coefficients int64[bh, bw, 64] (row-major in the block),
    rounding half away from zero by divisors q << 3 (jcdctmgr.c)."""
    coef = _fdct_islow(_blocks_of(plane) - 128).reshape(plane.shape[0] // 8, plane.shape[1] // 8, 64)
    d = q << 3
    return np.sign(coef) * ((np.abs(coef) + (d >> 1)) // d)


def _bit_length(v: np.ndarray) -> np.ndarray:
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    while True:
        more = a >> n > 0
        if not more.any():
            return n
        n += more


def _pack_bits(words: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate each word's low ``length`` bits MSB first, pad with 1 bits
    to a byte, stuff a 0 after every 0xFF."""
    chunks = []
    step = 1 << 18
    for i in range(0, len(words), step):
        wd, ln = words[i : i + step], lengths[i : i + step]
        ends = np.cumsum(ln)
        pos = np.arange(int(ends[-1])) if len(ends) else np.zeros(0, np.int64)
        shift = np.repeat(ends, ln) - 1 - pos
        chunks.append(((np.repeat(wd, ln) >> shift) & 1).astype(np.uint8))
    bits = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.uint8)])
    packed = np.packbits(bits)
    return np.insert(packed, np.nonzero(packed == 0xFF)[0] + 1, 0).tobytes()


def _entropy_code(zz: np.ndarray, chroma: np.ndarray) -> bytes:
    """Huffman-code blocks int64[N, 64] (zigzag order, DC already a
    difference) in coding order; ``chroma[n]`` picks block n's tables."""
    dc_codes = [_huffman_codes(s) for s in (_HUFF_DC_LUMA, _HUFF_DC_CHROMA)]
    ac_codes = [_huffman_codes(s) for s in (_HUFF_AC_LUMA, _HUFF_AC_CHROMA)]
    n = len(zz)
    tab = chroma.astype(np.int64)

    def lookup(codes, t, sym):
        code = np.where(t == 1, codes[1][0][sym], codes[0][0][sym])
        length = np.where(t == 1, codes[1][1][sym], codes[0][1][sym])
        return code, length

    def value_bits(v, size):
        return np.where(v < 0, v + (1 << size) - 1, v)

    keys, words, lens = [], [], []

    def emit(key, code, length, value, size):
        keys.append(key)
        words.append((code << size) | value)
        lens.append(length + size)

    blk = np.arange(n)
    dc = zz[:, 0]
    size = _bit_length(dc)
    code, length = lookup(dc_codes, tab, size)
    emit(blk * 260, code, length, value_bits(dc, size), size)

    b, k = np.nonzero(zz[:, 1:])
    v = zz[b, k + 1]
    first = np.r_[True, b[1:] != b[:-1]] if len(b) else np.zeros(0, bool)
    prev = np.where(first, -1, np.r_[-1, k[:-1]])
    run = k - prev - 1
    size = _bit_length(v)
    code, length = lookup(ac_codes, tab[b], ((run & 15) << 4) | size)
    emit((b * 65 + k + 1) * 4 + 3, code, length, value_bits(v, size), size)
    nzrl = run >> 4
    for j in range(3):  # runs of 16 zeros before a coefficient (at most 3 in 63)
        m = nzrl > j
        code, length = lookup(ac_codes, tab[b[m]], np.full(m.sum(), 0xF0))
        emit((b[m] * 65 + k[m] + 1) * 4 + j, code, length, np.zeros(m.sum(), np.int64), np.zeros(m.sum(), np.int64))
    last = np.full(n, -1)
    last[b] = k  # k ascends within a block, so the last write is the block's last nonzero
    m = last < 62
    code, length = lookup(ac_codes, tab[m], np.zeros(m.sum(), np.int64))
    emit(blk[m] * 260 + 256, code, length, np.zeros(m.sum(), np.int64), np.zeros(m.sum(), np.int64))

    order = np.argsort(np.concatenate(keys), kind="stable")
    return _pack_bits(np.concatenate(words)[order], np.concatenate(lens)[order])


def jpeg_bytes(img, quality: int = 100) -> bytes:
    """Encode u8[H, W, 3] as libjpeg does under Pillow's defaults at ``quality``."""
    arr = _rgb_u8(img)
    h, w, _ = arr.shape
    q_luma, q_chroma = _quant_tables(quality)
    y, cb, cr = _rgb_to_ycc(arr)
    mcux, mcuy = -(-w // 16), -(-h // 16)
    bw, bh = -(-w // 8), -(-h // 8)

    # luma: blocks of the image edge-replicated to whole MCUs; those past
    # the image's blocks become libjpeg's dummy blocks below
    yq = _quantize(np.pad(y, ((0, 16 * mcuy - h), (0, 16 * mcux - w)), mode="edge"), q_luma)
    if bw % 2:  # right dummy column: no AC, the DC of its left neighbour
        yq[:, bw, 1:] = 0
        yq[:, bw, 0] = yq[:, bw - 1, 0]
    if bh % 2:  # bottom dummy row: no AC, the DC of the MCU's last block above
        yq[bh, :, 1:] = 0
        yq[bh, :, 0] = np.repeat(yq[bh - 1, 1::2, 0], 2)
    # chroma: rows padded to even, columns to 2 * 8 * blocks, h2v2 box sums
    # with the bias 1, 2, 1, 2, ... then edge rows to whole blocks (jcsample.c)
    ch, cw = -(-h // 2), -(-w // 2)
    chroma_q = []
    for plane in (cb, cr):
        full = np.pad(plane, ((0, 2 * ch - h), (0, 16 * mcux - w)), mode="edge")
        sums = full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2] + full[1::2, 1::2]
        bias = np.tile([1, 2], sums.shape[1] // 2)
        down = (sums + bias) >> 2
        chroma_q.append(_quantize(np.pad(down, ((0, 8 * mcuy - ch), (0, 0)), mode="edge"), q_chroma))

    # coding order: per MCU the four luma blocks, then Cb, then Cr
    my, mx = np.meshgrid(np.arange(mcuy), np.arange(mcux), indexing="ij")
    my, mx = my.ravel(), mx.ravel()
    parts = [yq[2 * my + dy, 2 * mx + dx] for dy in (0, 1) for dx in (0, 1)]
    parts += [c[my, mx] for c in chroma_q]
    blocks = np.stack(parts, 1)  # (MCUs, 6, 64)
    luma = blocks[:, :4].reshape(-1, 64)
    dcs = [luma[:, 0], blocks[:, 4, 0], blocks[:, 5, 0]]
    diffs = [d - np.r_[0, d[:-1]] for d in dcs]
    blocks[:, :4, 0] = diffs[0].reshape(-1, 4)
    blocks[:, 4, 0], blocks[:, 5, 0] = diffs[1], diffs[2]
    zz = blocks[..., ZIGZAG].reshape(-1, 64)
    chroma = np.tile(np.array([0, 0, 0, 0, 1, 1]), len(my))
    scan = _entropy_code(zz, chroma)

    def segment(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    dqt = b"".join(bytes([i]) + t[ZIGZAG].astype(np.uint8).tobytes() for i, t in enumerate((q_luma, q_chroma)))
    sof = struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = b"".join(
        bytes([cls << 4 | i]) + bytes(spec[0]) + spec[1]
        for cls, i, spec in ((0, 0, _HUFF_DC_LUMA), (1, 0, _HUFF_AC_LUMA),
                             (0, 1, _HUFF_DC_CHROMA), (1, 1, _HUFF_AC_CHROMA))
    )
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return (
        b"\xff\xd8" + segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
        + segment(0xDB, dqt) + segment(0xC0, sof) + segment(0xC4, dht) + segment(0xDA, sos)
        + scan + b"\xff\xd9"
    )


def write_jpeg(path: str, img, quality: int = 100) -> None:
    """Write u8[H, W, 3] as a baseline 4:2:0 JFIF file (see :func:`jpeg_bytes`)."""
    data = jpeg_bytes(img, quality)
    with open(path, "wb") as f:
        f.write(data)
