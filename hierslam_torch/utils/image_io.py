"""Image and YAML file I/O in numpy and ``zlib`` alone.

The JAX package reads frames with ``imageio`` (Pillow's libjpeg-turbo and
zlib underneath) and camera configs with PyYAML; this module reads the
same files without either, so the port needs no image or YAML package:

* ``read_png`` / ``write_png``: 8- and 16-bit grey, grey+alpha, RGB and
  RGBA, non-interlaced, all five filter types;
* ``read_jpeg``: baseline (and extended 8-bit) sequential Huffman JPEG,
  grey or three components at 4:4:4, 4:2:2 (h2v1) or 4:2:0 (h2v2), restart
  markers, JFIF or Adobe headers.  It reproduces libjpeg's default decode,
  the one Pillow makes: the ISLOW integer IDCT (``jidctint.c``), "fancy"
  triangular chroma upsampling (``jdsample.c``) and the fixed-point
  YCbCr->RGB of ``jdcolor.c``, so its output is Pillow's to the bit;
* ``write_jpeg``: baseline 4:2:0 with the Annex K quantization tables
  scaled by quality as libjpeg scales them and the Annex K Huffman tables
  (used to lay out test sequences where no encoder is installed);
* ``load_yaml``: the subset of YAML the camera configs use.

Huffman decoding is the one sequential step: a Python walk over the
entropy-coded bits finds where each block's tokens start, looking up each
token's length and zero run in a 65536-entry table keyed by the next 16
bits.  The tokens' values, dequantization, the IDCT, upsampling and
colour conversion run vectorized over all blocks.
"""
from __future__ import annotations

import array
import re
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# PNG

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, ft: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG row filters: ``raw`` [H, row bytes] uint8, ``ft`` [H] filter
    types, ``bpp`` bytes per pixel -> [H, row bytes] uint8."""
    H, n = raw.shape
    if np.all(ft <= 2):       # None / Sub / Up: one vector operation a row
        out = np.empty_like(raw)
        prev = np.zeros(n, np.uint8)
        for r in range(H):
            row = raw[r]
            if ft[r] == 1:
                row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
            elif ft[r] == 2:
                row = row + prev
            out[r] = row
            prev = out[r]
        return out
    # Average and Paeth take the byte to the left, so a row is sequential;
    # a pixel needs only its left, upper and upper-left neighbours, so all
    # pixels on one anti-diagonal s = row + pixel are decoded together.  In
    # the skewed layout z[s + 2, row + 1] a diagonal is one contiguous row,
    # its left neighbours the row before (z[s + 1, row + 1]), the upper ones
    # z[s + 1, row] and the upper-left ones z[s, row]; zeros pad the edges.
    wp = n // bpp
    steps = H + wp - 1
    r_idx, i_idx = np.meshgrid(np.arange(H), np.arange(wp), indexing="ij")
    rawz = np.zeros((steps, H, bpp), np.int32)
    rawz[r_idx + i_idx, r_idx] = raw.reshape(H, wp, bpp)
    z = np.zeros((steps + 2, H + 1, bpp), np.int32)
    m = [(ft == t).astype(np.int32)[:, None] for t in range(5)]
    for s in range(steps):
        r0, r1 = max(0, s - wp + 1), min(H, s + 1)
        a, b, c = z[s + 1, r0 + 1:r1 + 1], z[s + 1, r0:r1], z[s, r0:r1]
        pred = (a * m[1][r0:r1] + b * m[2][r0:r1] + ((a + b) >> 1) * m[3][r0:r1]
                + _paeth(a, b, c) * m[4][r0:r1])
        z[s + 2, r0 + 1:r1 + 1] = (rawz[s, r0:r1] + pred) & 255
    return z[r_idx + i_idx + 2, r_idx + 1].reshape(H, n).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """PNG file -> uint8 or uint16 array, [H, W] for grey, else [H, W, C]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = hdr
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} (palette) is not supported")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if depth not in (8, 16):
        raise ValueError(f"{path}: PNG bit depth {depth} is not supported (8 or 16)")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, 1 + W * bpp)
    if np.any(rows[:, 0] > 4):
        raise ValueError(f"{path}: bad PNG filter type")
    px = _unfilter(rows[:, 1:], rows[:, 0], bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    px = px.reshape(H, W, ch)
    return px[..., 0] if ch == 1 else px


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 or uint16 array ([H, W] grey or [H, W, 2/3/4]) -> PNG file
    (each row filtered with "Up")."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError("write_png takes uint8 or uint16")
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    H, W = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    b = img.astype(">u2" if depth == 16 else np.uint8).reshape(H, -1).view(np.uint8)
    up = b.copy()
    up[1:] = b[1:] - b[:-1]
    rows = np.concatenate([np.full((H, 1), 2, np.uint8), up], 1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# JPEG: shared tables

ZIGZAG = np.array(sorted(range(64), key=lambda n: (n // 8 + n % 8,
                                                   n // 8 if (n // 8 + n % 8) % 2 else -(n // 8))))

# Annex K.1 quantization tables (natural order), quality 50
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.full(64, 99)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]


def _ac_values(first: List[int]) -> List[int]:
    """Annex K.3 AC symbol order: ``first`` as listed, then every other
    baseline symbol (run 0-15, size 1-10) in increasing order."""
    every = [r * 16 + s for r in range(16) for s in range(1, 11)] + [0x00, 0xF0]
    return first + sorted(set(every) - set(first))


# Annex K.3 Huffman tables: (codes of each length 1..16, symbols)
STD_HUFFMAN = {
    ("dc", 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    ("dc", 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    ("ac", 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], _ac_values(
        [1, 2, 3, 0, 4, 17, 5, 18, 33, 49, 65, 6, 19, 81, 97, 7, 34, 113, 20, 50, 129, 145,
         161, 8, 35, 66, 177, 193, 21, 82, 209, 240, 36, 51, 98, 114, 130])),
    ("ac", 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], _ac_values(
        [0, 1, 2, 3, 17, 4, 5, 33, 49, 6, 18, 65, 81, 7, 97, 113, 19, 34, 50, 129, 8, 20, 66,
         145, 161, 177, 193, 9, 35, 51, 82, 240, 21, 98, 114, 209, 10, 22, 36, 52, 225, 37,
         241])),
}


def _canonical_codes(counts: List[int], symbols: List[int]) -> Dict[int, Tuple[int, int]]:
    """Annex C: symbol -> (code, length)."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """libjpeg's ``jpeg_quality_scaling`` of the Annex K tables (baseline:
    entries clamped to 1..255), natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (_Q_LUMA, _Q_CHROMA))


# ---------------------------------------------------------------------------
# JPEG decode

_SOF_UNSUPPORTED = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical",
                    0xC6: "hierarchical", 0xC7: "hierarchical"}


class _Huffman:
    """A decoding table keyed by the next 16 bits of the stream: the
    code's length and symbol, and for the walk the token's whole length
    (code + extra bits) and the slot advance (AC: zero run, 64 at EOB)."""

    def __init__(self, counts: List[int], symbols: List[int], ac: bool):
        code_len = np.zeros(65536, np.int64)      # 0: no code has this prefix
        sym = np.zeros(65536, np.int64)
        for s, (code, length) in _canonical_codes(counts, symbols).items():
            lo = code << (16 - length)
            code_len[lo:lo + (1 << (16 - length))] = length
            sym[lo:lo + (1 << (16 - length))] = s
        size = sym & 15
        self.code_len, self.size = code_len, size
        self.total = (code_len + size).astype(np.uint8).tobytes()
        if ac:
            run = (sym >> 4) + 1                  # slots the token moves past
            run[(sym == 0) & (code_len > 0)] = 64 # EOB
            self.step_np = run
            self.step = run.astype(np.uint8).tobytes()


def _extend(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """F.2.2.1 EXTEND: ``s``-bit magnitude ``v`` -> signed value."""
    half = np.where(s > 0, 1 << np.maximum(s - 1, 0), 0)
    return np.where(v < half, v - (1 << s) + 1, v) * (s > 0)


def _bits_at(buf: np.ndarray, pos: np.ndarray, n: int) -> np.ndarray:
    """The ``n`` (<= 32) bits of ``buf`` starting at each bit position."""
    b = pos >> 3
    w = np.zeros(len(pos), np.int64)
    for j in range(5):
        w = (w << 8) | buf[b + j]
    return (w >> (40 - n - (pos & 7))) & ((1 << n) - 1)


def _scan_segments(data: bytes, start: int) -> Tuple[np.ndarray, List[int], int]:
    """The entropy-coded data of the scan at ``start``: byte-unstuffed,
    split at its restart markers.  -> (bytes padded with zeros, start bit
    of each restart interval, offset of the marker that ends the scan)."""
    arr = np.frombuffer(data, np.uint8, offset=start)
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    ends = ff[(nxt != 0x00) & ((nxt < 0xD0) | (nxt > 0xD7)) & (nxt != 0xFF)]
    end = int(ends[0]) if len(ends) else len(arr)
    keep = ff < end
    ff, nxt = ff[keep], nxt[keep]
    rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    bounds = [0] + [int(r) for r in rst] + [end]
    pieces, starts, nbytes = [], [], 0
    for i in range(len(bounds) - 1):
        lo = bounds[i] + (2 if i else 0)
        seg = arr[lo:bounds[i + 1]]
        sff = np.flatnonzero(seg[:-1] == 0xFF)
        seg = np.delete(seg, sff[seg[sff + 1] == 0] + 1)
        starts.append(nbytes * 8)
        pieces.append(seg)
        nbytes += len(seg)
    pieces.append(np.zeros(8, np.uint8))
    return np.concatenate(pieces).astype(np.int64), starts, start + end


def _windows16(buf: np.ndarray) -> np.ndarray:
    """The 16 bits of ``buf`` starting at every bit position (uint16)."""
    n = len(buf) - 3
    w24 = (buf[:n] << 16) | (buf[1:n + 1] << 8) | buf[2:n + 2]
    out = np.empty((n, 8), np.uint16)
    for off in range(8):
        out[:, off] = (w24 >> (8 - off)) & 0xFFFF
    return out.reshape(-1)


def _walk(buf: np.ndarray, starts: List[int], interval: int, block_tabs: List[int],
          mcu_blocks: int, tables: List[Tuple[_Huffman, _Huffman]]):
    """Follow the Huffman tokens of a scan: per block (in scan order) its
    DC token's bit position, and every AC token's position and block slot
    (zigzag index + 64 * block).  ``block_tabs`` gives each block's table
    pair; a restart interval holds ``interval`` MCUs of ``mcu_blocks``.

    The sequential walk finds only where each block's AC tokens start;
    the tokens of all blocks are then stepped through together."""
    w16_np = _windows16(buf)
    w16 = array.array("H", w16_np.tobytes())
    walk = [(t[0].total, t[1].total, t[1].step) for t in tables]
    dc_pos, ac_start = [], []
    per_interval = interval * mcu_blocks if interval else len(block_tabs)
    try:
        _walk_blocks(w16, starts, per_interval, block_tabs, walk, dc_pos, ac_start)
    except IndexError:
        raise ValueError("truncated or corrupt JPEG data") from None
    tab = np.array(block_tabs, np.int64)
    step = np.stack([t[1].step_np for t in tables])
    total = np.stack([t[1].code_len + t[1].size for t in tables])
    blk = np.arange(len(block_tabs))
    cur, k = np.array(ac_start, np.int64), np.zeros(len(block_tabs), np.int64)
    pos, slot = [], []
    while len(blk):
        w = w16_np[cur]
        k = k + step[tab[blk], w]
        coef = k <= 63                 # not an EOB (its step is 64)
        pos.append(cur[coef])
        slot.append(blk[coef] * 64 + k[coef])
        cur = cur + total[tab[blk], w]
        more = k < 63
        blk, cur, k = blk[more], cur[more], k[more]
    return np.array(dc_pos, np.int64), np.concatenate(pos), np.concatenate(slot)


def _walk_blocks(w16, starts, per_interval, block_tabs, walk, dc_pos, ac_start):
    p = 0
    for blk, tab in enumerate(block_tabs):
        if blk % per_interval == 0:
            p = starts[blk // per_interval]
        dc_total, ac_total, ac_step = walk[tab]
        dc_pos.append(p)
        p += dc_total[w16[p]]
        ac_start.append(p)
        k = 0
        while k < 63:          # ends after the coefficient at 63 or an EOB (k >= 64)
            w = w16[p]
            k += ac_step[w]
            p += ac_total[w]


def _token_values(buf, pos, tab_of_token, tables, ac: bool):
    """Signed values of the tokens at ``pos`` (each decoded with table
    ``tab_of_token``)."""
    w16 = _bits_at(buf, pos, 16)
    cl = np.zeros(len(pos), np.int64)
    size = np.zeros(len(pos), np.int64)
    for i, t in enumerate(tables):
        h = t[1] if ac else t[0]
        sel = tab_of_token == i
        cl[sel] = h.code_len[w16[sel]]
        size[sel] = h.size[w16[sel]]
    if np.any(cl == 0):
        raise ValueError("corrupt JPEG data: no Huffman code matches")
    v = _bits_at(buf, pos + cl, 16) >> (16 - size)
    return _extend(v, size)


# jidctint.c constants (CONST_BITS = 13)
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633,
          f1501=12299, f1847=15137, f1961=16069, f2053=16819, f2562=20995, f3072=25172)


def _butterfly(s) -> List:
    """The ISLOW IDCT's butterfly on the 8 rows of ``s`` (integer arrays),
    before its final rounding shift: 8 outputs."""
    f = _F
    z2, z3 = s[2], s[6]
    z1 = (z2 + z3) * f["f0541"]
    tmp2 = z1 - z3 * f["f1847"]
    tmp3 = z1 + z2 * f["f0765"]
    tmp0 = (s[0] + s[4]) * 8192                     # << CONST_BITS
    tmp1 = (s[0] - s[4]) * 8192
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * f["f1175"]
    o0, o1, o2, o3 = o0 * f["f0298"], o1 * f["f2053"], o2 * f["f3072"], o3 * f["f1501"]
    z1, z2 = z1 * -f["f0899"], z2 * -f["f2562"]
    z3, z4 = z3 * -f["f1961"] + z5, z4 * -f["f0390"] + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    return [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3]


# Before its rounding shift a pass of the butterfly is linear with integer
# weights: this matrix.  An int64 product with it gives the butterfly's
# sums exactly (they stay below 2^48 for 11-bit coefficients and 16-bit
# quantization entries) on one thread, where a float64 product would wake
# the BLAS threads beside a busy main thread.
_IDCT_M = np.stack(_butterfly(np.eye(8, dtype=np.int64)))


def _idct_pass(x: np.ndarray, descale: int) -> np.ndarray:
    """One ISLOW pass over the last axis of ``x`` [..., 8] (int64)."""
    return (x @ _IDCT_M.T + (1 << (descale - 1))) >> descale


def _range_limit() -> np.ndarray:
    """libjpeg's post-IDCT table, indexed by ``value & 1023``."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """``jpeg_idct_islow``: zigzag coefficients [N, 64] and the natural-order
    quantization table -> [N, 8, 8] uint8 samples."""
    nat = np.zeros((len(coef), 64), np.int64)
    nat[:, ZIGZAG] = coef
    blk = (nat * qt.astype(np.int64)[None]).reshape(-1, 8, 8)
    ws = _idct_pass(blk.transpose(0, 2, 1), 13 - 2)       # columns: CONST_BITS - PASS1_BITS
    out = _idct_pass(ws.transpose(0, 2, 1), 13 + 2 + 3)   # rows: + PASS1_BITS + 3
    return _range_limit()[out & 1023]


def _fancy_h2v1(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.int32)
    left = np.concatenate([c[:, :1], c[:, :-1]], 1)
    right = np.concatenate([c[:, 1:], c[:, -1:]], 1)
    even = (3 * c + left + 1) >> 2
    odd = (3 * c + right + 2) >> 2
    even[:, 0], odd[:, -1] = c[:, 0], c[:, -1]
    return np.stack([even, odd], 2).reshape(c.shape[0], -1)


def _fancy_h2v2(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.int32)
    up = np.concatenate([c[:1], c[:-1]], 0)
    down = np.concatenate([c[1:], c[-1:]], 0)
    out = []
    for near in (up, down):        # output rows 2i (row above) and 2i+1 (below)
        cs = 3 * c + near
        left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
        even = (3 * cs + left + 8) >> 4
        odd = (3 * cs + right + 7) >> 4
        even[:, 0] = (4 * cs[:, 0] + 8) >> 4
        odd[:, -1] = (4 * cs[:, -1] + 7) >> 4
        out.append(np.stack([even, odd], 2).reshape(c.shape[0], -1))
    return np.stack(out, 1).reshape(2 * c.shape[0], -1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """``jdcolor.c`` ycc_rgb_convert (SCALEBITS = 16)."""
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * 65536 + 0.5)

    half = 1 << 15
    cr_r = ((fix(1.40200) * x + half) >> 16).astype(np.int16)
    cb_b = ((fix(1.77200) * x + half) >> 16).astype(np.int16)
    g_off = ((-fix(0.34414) * x[:, None] + half - fix(0.71414) * x[None, :]) >> 16).astype(
        np.int16)                                       # [cb, cr]
    y = y.astype(np.int16)
    out = np.empty(y.shape + (3,), np.int16)
    out[..., 0] = y + cr_r[cr]
    out[..., 1] = y + g_off[cb, cr]
    out[..., 2] = y + cb_b[cb]
    return np.clip(out, 0, 255).astype(np.uint8)


def read_jpeg(path: str) -> np.ndarray:
    """Baseline sequential JPEG file -> uint8 [H, W, 3] (or [H, W] grey)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    qts: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], Tuple[List[int], List[int]]] = {}
    frame = None
    adobe: Optional[int] = None
    interval = 0
    coefs: Dict[int, np.ndarray] = {}
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: corrupt JPEG marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xD9:
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        seg = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDB:
            i = 0
            while i < len(seg):
                prec, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if prec else 64
                vals = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if prec else np.uint8)
                nat = np.zeros(64, np.int64)
                nat[ZIGZAG] = vals
                qts[tq] = nat
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                n = sum(counts)
                huff[(tc, th)] = (counts, list(seg[i + 17:i + 17 + n]))
                i += 17 + n
        elif marker in (0xC0, 0xC1):
            prec, H, W, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise ValueError(f"{path}: {prec}-bit JPEG is not supported")
            if H == 0:
                raise ValueError(f"{path}: JPEG with a DNL marker is not supported")
            comps = [(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15, seg[8 + 3 * i])
                     for i in range(nc)]
            frame = (H, W, comps)
        elif marker in _SOF_UNSUPPORTED or 0xC9 <= marker <= 0xCF and marker != 0xCC:
            kind = _SOF_UNSUPPORTED.get(marker, "arithmetic-coded")
            raise ValueError(f"{path}: {kind} JPEG is not supported (baseline only)")
        elif marker == 0xDD:
            (interval,) = struct.unpack(">H", seg[:2])
        elif marker == 0xEE and seg[:5] == b"Adobe":
            adobe = seg[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame header")
            pos = _decode_scan(data, pos, seg, frame, huff, interval, coefs)
    if frame is None:
        raise ValueError(f"{path}: no JPEG frame header")
    H, W, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    planes = []
    for cid, hs, vs, tq in comps:
        if cid not in coefs:
            raise ValueError(f"{path}: JPEG component {cid} has no scan")
        grid = coefs[cid]
        by, bx = grid.shape[:2]
        px = idct_islow(grid.reshape(-1, 64), qts[tq]).reshape(by, bx, 8, 8)
        px = px.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        ch, cw = -(-H * vs // vmax), -(-W * hs // hmax)
        px = px[:ch, :cw]
        if (hs, vs) != (hmax, vmax):
            if (hmax // hs, vmax // vs) == (2, 2):
                px = _fancy_h2v2(px)
            elif (hmax // hs, vmax // vs) == (2, 1):
                px = _fancy_h2v1(px)
            else:
                raise ValueError(f"{path}: JPEG sampling {hmax // hs}x{vmax // vs} is not "
                                 "supported (4:4:4, 4:2:2 or 4:2:0)")
        planes.append(px[:H, :W])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    if len(planes) != 3:
        raise ValueError(f"{path}: {len(planes)}-component JPEG is not supported")
    rgb_ids = tuple(c[0] for c in comps) == (82, 71, 66)
    if adobe == 0 or (adobe is None and rgb_ids):
        return np.stack(planes, -1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


def _decode_scan(data: bytes, pos: int, seg: bytes, frame, huff, interval: int,
                 coefs: Dict[int, np.ndarray]) -> int:
    """Decode one scan's coefficients into ``coefs`` (component id ->
    [blocks y, blocks x, 64] zigzag); returns the offset after the scan."""
    H, W, comps = frame
    ns = seg[0]
    sel = [(seg[1 + 2 * i], seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15) for i in range(ns)]
    ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
    if (ss, se) != (0, 63):
        raise ValueError("JPEG scan with spectral selection (progressive) is not supported")
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    info = {c[0]: c for c in comps}
    tables, tab_index = [], {}
    for cid, td, ta in sel:
        if (td, ta) not in tab_index:
            if (0, td) not in huff or (1, ta) not in huff:
                raise ValueError("JPEG scan refers to an undefined Huffman table")
            tab_index[(td, ta)] = len(tables)
            tables.append((_Huffman(*huff[(0, td)], ac=False), _Huffman(*huff[(1, ta)], ac=True)))
        _, hs, vs, _ = info[cid]
        coefs.setdefault(cid, np.zeros((my * vs, mx * hs, 64), np.int64))
    # block order, as (scan component, block y, block x) per block:
    # interleaved MCUs, or the raster order of one component's blocks
    if ns == 1:
        cid = sel[0][0]
        _, hs, vs, _ = info[cid]
        bw = -(-(-(-W * hs // hmax)) // 8)          # ceil(ceil(W * hs / hmax) / 8)
        bh = -(-(-(-H * vs // vmax)) // 8)
        yy, xx = np.meshgrid(np.arange(bh), np.arange(bw), indexing="ij")
        order = [np.full(bh * bw, 0), yy.reshape(-1), xx.reshape(-1)]
        mcu_blocks = 1
        blk_tab = [tab_index[(sel[0][1], sel[0][2])]] * (bh * bw)
    else:
        per_mcu = []
        for si, (cid, td, ta) in enumerate(sel):
            _, hs, vs, _ = info[cid]
            per_mcu += [(si, v, h, hs, vs, tab_index[(td, ta)]) for v in range(vs)
                        for h in range(hs)]
        mcu_blocks = len(per_mcu)
        n = mx * my
        m = np.arange(n)
        mrow, mcol = m // mx, m % mx
        comp_i = np.array([b[0] for b in per_mcu])
        by = mrow[:, None] * np.array([b[4] for b in per_mcu]) + np.array([b[1] for b in per_mcu])
        bx = mcol[:, None] * np.array([b[3] for b in per_mcu]) + np.array([b[2] for b in per_mcu])
        order = [np.tile(comp_i, n), by.reshape(-1), bx.reshape(-1)]
        blk_tab = [b[5] for b in per_mcu] * n
    buf, starts, end = _scan_segments(data, pos)
    dc_pos, ac_pos, ac_slot = _walk(buf, starts, interval, blk_tab, mcu_blocks, tables)
    tab_arr = np.array(blk_tab, np.int64)
    dc = _token_values(buf, dc_pos, tab_arr, tables, ac=False)
    ac = _token_values(buf, ac_pos, tab_arr[ac_slot // 64], tables, ac=True)
    nblk = len(blk_tab)
    flat = np.zeros((nblk, 64), np.int64)
    flat.reshape(-1)[ac_slot] = ac
    # DC prediction per component, restarted with each restart interval
    per_interval = interval * mcu_blocks if interval else nblk
    comp_of = order[0]
    restart = np.arange(nblk) // per_interval
    for si in range(ns):
        idx = np.flatnonzero(comp_of == si)
        d = dc[idx]
        cs = np.cumsum(d)
        r = restart[idx]
        first = np.flatnonzero(np.r_[True, r[1:] != r[:-1]])
        base = np.repeat(np.r_[0, cs[first[1:] - 1]], np.diff(np.r_[first, len(idx)]))
        flat[idx, 0] = cs - base
    for si, (cid, _, _) in enumerate(sel):
        idx = np.flatnonzero(comp_of == si)
        coefs[cid][order[1][idx], order[2][idx]] = flat[idx]
    return end


# ---------------------------------------------------------------------------
# JPEG encode


def _fdct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))[:, None]
    return c * np.cos((2 * k[None] + 1) * k[:, None] * np.pi / 16)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[h, w] (multiples of 8) -> [h/8, w/8, 64] natural order."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(h // 8, w // 8, 64)


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 95) -> None:
    """uint8 [H, W, 3] -> baseline JFIF JPEG, 4:2:0, Annex K tables scaled
    to ``quality``."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("write_jpeg takes uint8 [H, W, 3]")
    H, W = rgb.shape[:2]
    Hp, Wp = -(-H // 16) * 16, -(-W // 16) * 16
    img = np.pad(rgb.astype(np.float64), ((0, Hp - H), (0, Wp - W), (0, 0)), mode="edge")
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128

    def half(c):
        return c.reshape(Hp // 2, 2, Wp // 2, 2).mean((1, 3))

    qy, qc = quality_tables(quality)
    D = _fdct_matrix()
    planes = []
    for plane, q in ((y, qy), (half(cb), qc), (half(cr), qc)):
        blk = _blocks(np.round(plane) - 128).reshape(-1, 8, 8)
        coef = (D @ blk @ D.T).reshape(-1, 64)
        quant = np.round(coef / q).astype(np.int64)[:, ZIGZAG]
        h8, w8 = plane.shape[0] // 8, plane.shape[1] // 8
        planes.append(quant.reshape(h8, w8, 64))
    # scan order: per 16x16 MCU, four Y blocks then Cb, Cr
    my, mx = Hp // 16, Wp // 16
    Y = planes[0].reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, 4, 64)
    mcu = np.concatenate([Y, planes[1].reshape(-1, 1, 64), planes[2].reshape(-1, 1, 64)], 1)
    blocks = mcu.reshape(-1, 64)
    tab = np.tile([0, 0, 0, 0, 1, 1], my * mx)
    comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
    dc = blocks[:, 0].copy()
    for c in range(3):
        idx = np.flatnonzero(comp == c)
        dc[idx] = np.diff(blocks[idx, 0], prepend=0)
    data = _pack_tokens(blocks, dc, tab)

    def marker(m, body):
        return bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) + body

    out = [b"\xff\xd8", marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, q in enumerate((qy, qc)):
        out.append(marker(0xDB, bytes([i]) + bytes(q[ZIGZAG].astype(np.uint8).tolist())))
    out.append(marker(0xC0, struct.pack(">BHHB", 8, H, W, 3)
                      + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for (kind, t), (counts, syms) in STD_HUFFMAN.items():
        out.append(marker(0xC4, bytes([(kind == "ac") << 4 | t]) + bytes(counts) + bytes(syms)))
    out.append(marker(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out += [data, b"\xff\xd9"]
    with open(path, "wb") as f:
        f.write(b"".join(out))


def _pack_tokens(blocks: np.ndarray, dc_diff: np.ndarray, tab: np.ndarray) -> bytes:
    """Huffman-code the zigzag coefficients [N, 64] of a scan's blocks (DC
    already differenced; ``tab`` 0 luma, 1 chroma) -> byte-stuffed data."""
    codes = {key: _canonical_codes(*v) for key, v in STD_HUFFMAN.items()}
    lut = {}
    for key, cmap in codes.items():
        c = np.zeros(256, np.int64)
        n = np.zeros(256, np.int64)
        for s, (code, length) in cmap.items():
            c[s], n[s] = code, length
        lut[key] = (c, n)

    def size_of(v):
        a = np.abs(v)
        return np.where(a > 0, np.floor(np.log2(np.maximum(a, 1))).astype(np.int64) + 1, 0)

    def bits(v, s):
        return np.where(v >= 0, v, v - 1 + (1 << s)) & ((1 << s) - 1)

    def pick(kind, sym, t):
        c = np.where(t == 0, lut[(kind, 0)][0][sym], lut[(kind, 1)][0][sym])
        n = np.where(t == 0, lut[(kind, 0)][1][sym], lut[(kind, 1)][1][sym])
        return c, n

    nb = len(blocks)
    keys, vals, lens = [], [], []
    # DC: one token a block
    s = size_of(dc_diff)
    c, n = pick("dc", s, tab)
    keys.append(np.arange(nb) * 256)
    vals.append((c << s) | bits(dc_diff, s))
    lens.append(n + s)
    # AC: per nonzero coefficient, ZRLs for each run of 16 zeros before it,
    # then (run, size) and its bits; EOB unless the block ends at 63
    b, k = np.nonzero(blocks[:, 1:])
    k = k + 1
    v = blocks[b, k]
    prev = np.r_[0, k[:-1]]
    prev[np.r_[True, b[1:] != b[:-1]]] = 0
    run = k - prev - 1
    nz = run // 16
    zc, zn = pick("ac", np.full(len(b), 0xF0), tab[b])
    zrl = nz > 0
    zval = np.zeros(len(b), np.int64)
    for j in range(1, 4):
        zval = np.where(nz >= j, (zval << zn) | zc, zval)
    keys.append(b[zrl] * 256 + 2 * k[zrl] - 1)
    vals.append(zval[zrl])
    lens.append((nz * zn)[zrl])
    s = size_of(v)
    c, n = pick("ac", (run % 16) * 16 + s, tab[b])
    keys.append(b * 256 + 2 * k)
    vals.append((c << s) | bits(v, s))
    lens.append(n + s)
    last = np.zeros(nb, np.int64)
    np.maximum.at(last, b, k)
    eob = np.flatnonzero(last < 63)
    c, n = pick("ac", np.zeros(len(eob), np.int64), tab[eob])
    keys.append(eob * 256 + 255)
    vals.append(c)
    lens.append(n)
    order = np.argsort(np.concatenate(keys), kind="stable")
    vals = np.concatenate(vals)[order]
    lens = np.concatenate(lens)[order]
    total = int(lens.sum())
    start = np.cumsum(lens) - lens
    tok = np.repeat(np.arange(len(lens)), lens)
    off = np.arange(total) - start[tok]
    bitarr = ((vals[tok] >> (lens[tok] - 1 - off)) & 1).astype(np.uint8)
    pad = (-total) % 8
    bitarr = np.concatenate([bitarr, np.ones(pad, np.uint8)])
    out = np.packbits(bitarr)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


# ---------------------------------------------------------------------------
# YAML subset

_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_SPECIAL = {"null": None, "Null": None, "NULL": None, "~": None, "": None,
            ".inf": float("inf"), "+.inf": float("inf"), "-.inf": float("-inf"),
            ".nan": float("nan")}
_BOOL = {w: True for w in ("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON")}
_BOOL.update({w: False for w in ("false", "False", "FALSE", "no", "No", "NO", "off", "Off",
                                 "OFF")})


def _scalar(text: str):
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "\"'":
        return t[1:-1]
    if t in _SPECIAL:
        return _SPECIAL[t]
    if t in _BOOL:
        return _BOOL[t]
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t) and t not in (".", "+.", "-."):
        return float(t.replace("_", ""))
    if t.startswith("["):
        if not t.endswith("]"):
            raise ValueError(f"unterminated flow list: {t}")
        inner = t[1:-1].strip()
        return [_scalar(x) for x in inner.split(",")] if inner else []
    return t


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> Dict:
    """Block mappings nested by indentation whose values are scalars
    (quoted or plain strings, ints, floats, bools, null) or flow lists of
    scalars: what ``configs/data/*.yaml`` hold."""
    root: Dict = {}
    stack = [(-1, root)]
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body.startswith("- ") or ":" not in body:
            raise ValueError(f"line {n}: only block mappings are supported: {raw!r}")
        key, _, value = body.partition(":")
        key = _scalar(key)
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if value.strip():
            parent[key] = _scalar(value)
        else:
            parent[key] = {}
            stack.append((indent, parent[key]))
    # an empty nested block is null, as PyYAML reads ``key:``
    def fix(d):
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = fix(v) if v else None
        return d

    return fix(root)


def load_yaml(path: str) -> Dict:
    with open(path, "r") as f:
        return parse_yaml(f.read())


def read_image(path: str) -> np.ndarray:
    """A PNG or JPEG file (told apart by its first bytes) -> its pixels."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _PNG_SIG:
        return read_png(path)
    if head[:2] == b"\xff\xd8":
        return read_jpeg(path)
    raise ValueError(f"{path}: neither PNG nor JPEG")
