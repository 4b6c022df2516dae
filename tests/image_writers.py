"""Image writers for fixtures PIL cannot write: a small baseline JPEG encoder
for any component count, sampling factors and Adobe transform flag (4:1:1,
4:4:0, 3 x 1, YCCK ...), and a PNG writer with Adam7 interlacing, 16-bit
samples and every row filter.  Test helpers only: the decoders under test
are the package's, the oracle is PIL's reading of these files."""

from __future__ import annotations

import struct
import zlib

import numpy as np

# ITU T.81 Annex K.1: the example quantization tables (natural order)
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99])
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# Annex K.3: the typical Huffman tables (counts per length, symbols)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
              bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def _codes(table):
    """Canonical Huffman codes: symbol -> (code, length)."""
    counts, symbols = table
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _quant(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling of a base table."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _dct_matrix() -> np.ndarray:
    c = np.array([[np.sqrt(0.125 if u == 0 else 0.25)
                   * np.cos((2 * x + 1) * u * np.pi / 16)
                   for x in range(8)] for u in range(8)])
    return c


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int) -> None:
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self) -> None:
        while self.n:
            self.put(1, 1)


def _category(v: int) -> int:
    return int(abs(v)).bit_length()


def _magnitude(v: int, size: int) -> int:
    return v if v >= 0 else v + (1 << size) - 1


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def encode_jpeg(planes: np.ndarray, sampling, quality: int = 85,
                jfif: bool = True, adobe_transform: int | None = None,
                restart_interval: int = 0) -> bytes:
    """A baseline JPEG of ``planes`` ``(H, W, C)`` uint8, given in the
    file's own colour space (YCbCr, YCCK, CMYK, grey ...): component ``i``
    box-downsampled by ``max / sampling[i]``, one interleaved scan (or a
    single-component one for ``C == 1``), the Annex K tables, an APP0 JFIF
    marker when ``jfif``, an Adobe APP14 marker with ``adobe_transform``
    when it is not None, and a restart marker every ``restart_interval``
    MCUs."""
    planes = np.asarray(planes, np.uint8)
    H, W, C = planes.shape
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    if C == 1:
        mcux, mcuy = -(-W // 8), -(-H // 8)
        sampling = [(1, 1)]
        hmax = vmax = 1
    dct = _dct_matrix()
    qt = [_quant(_Q_LUMA, quality), _quant(_Q_CHROMA, quality)]
    comps = []
    for i in range(C):
        h, v = sampling[i]
        rh, rv = hmax // h, vmax // v
        bw, bh = mcux * h, mcuy * v
        full = np.pad(planes[..., i].astype(np.float64),
                      ((0, bh * 8 * rv - H), (0, bw * 8 * rh - W)),
                      mode="edge")
        small = full.reshape(bh * 8, rv, bw * 8, rh).mean(axis=(1, 3))
        # the real samples' edge replicated over the padding, as libjpeg's
        # encoder expands the edge
        cw, ch = -(-W * h // hmax), -(-H * v // vmax)
        small = np.pad(small[:ch, :cw], ((0, bh * 8 - ch), (0, bw * 8 - cw)),
                       mode="edge")
        blocks = small.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128.0
        coef = np.einsum("ux,abxy,vy->abuv", dct, blocks, dct)
        q = qt[0 if i == 0 else 1].reshape(8, 8)
        comps.append(np.round(coef / q).astype(np.int64).reshape(
            bh, bw, 64)[..., _ZIGZAG])
    dc_codes = [_codes(_DC_LUMA), _codes(_DC_CHROMA)]
    ac_codes = [_codes(_AC_LUMA), _codes(_AC_CHROMA)]
    bits, pred = _Bits(), [0] * C
    data = bytearray()
    n_mcu, rst = 0, 0

    def block(i, zz):
        t = 0 if i == 0 else 1
        diff = int(zz[0]) - pred[i]
        pred[i] = int(zz[0])
        s = _category(diff)
        bits.put(*dc_codes[t][s])
        bits.put(_magnitude(diff, s), s)
        run = 0
        last = max((k for k in range(1, 64) if zz[k]), default=0)
        for k in range(1, last + 1):
            if zz[k] == 0:
                run += 1
                continue
            while run > 15:
                bits.put(*ac_codes[t][0xF0])
                run -= 16
            s = _category(int(zz[k]))
            bits.put(*ac_codes[t][(run << 4) | s])
            bits.put(_magnitude(int(zz[k]), s), s)
            run = 0
        if last < 63:
            bits.put(*ac_codes[t][0x00])

    for my in range(mcuy):
        for mx in range(mcux):
            if restart_interval and n_mcu and n_mcu % restart_interval == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                pred = [0] * C
            for i in range(C):
                h, v = sampling[i]
                for by in range(v):
                    for bx in range(h):
                        block(i, comps[i][my * v + by, mx * h + bx])
            n_mcu += 1
    bits.flush()
    data = bytes(bits.out)

    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe_transform is not None:
        out += _segment(0xFFEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                       adobe_transform))
    for t in range(2 if C > 1 else 1):
        out += _segment(0xFFDB, bytes([t]) + bytes(
            int(x) for x in qt[t][_ZIGZAG]))
    sof = struct.pack(">BHHB", 8, H, W, C)
    for i in range(C):
        h, v = sampling[i]
        sof += bytes([i + 1, (h << 4) | v, 0 if i == 0 else 1])
    out += _segment(0xFFC0, sof)
    for cls, tables in ((0, (_DC_LUMA, _DC_CHROMA)), (1, (_AC_LUMA,
                                                          _AC_CHROMA))):
        for t in range(2 if C > 1 else 1):
            counts, symbols = tables[t]
            out += _segment(0xFFC4, bytes([(cls << 4) | t]) + bytes(counts)
                            + bytes(symbols))
    if restart_interval:
        out += _segment(0xFFDD, struct.pack(">H", restart_interval))
    sos = bytes([C]) + b"".join(
        bytes([i + 1, 0x00 if i == 0 else 0x11]) for i in range(C))
    out += _segment(0xFFDA, sos + bytes([0, 63, 0]))
    out += data + b"\xff\xd9"
    return bytes(out)


def patch_frame(jpeg: bytes, marker: int | None = None,
                precision: int | None = None) -> bytes:
    """``jpeg`` with its SOF0 marker replaced by ``marker`` (e.g. 0xC3
    lossless, 0xC5 hierarchical, 0xC9 arithmetic) and / or its sample
    precision set: a header of a kind the encoder cannot make."""
    i = jpeg.index(b"\xff\xc0")
    out = bytearray(jpeg)
    if marker is not None:
        out[i + 1] = marker & 0xFF
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


# ---- PNG ------------------------------------------------------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pack_rows(px: np.ndarray, depth: int) -> np.ndarray:
    """``(h, w, c)`` samples -> ``(h, rowbytes)`` bytes (big-endian at 16
    bits, MSB-first packed below 8)."""
    h, w, c = px.shape
    if depth == 16:
        return px.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return px.astype(np.uint8).reshape(h, w * c)
    bits = ((px[..., 0, None] >> np.arange(depth - 1, -1, -1)) & 1).astype(
        np.uint8).reshape(h, w * depth)
    return np.packbits(bits, axis=1)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter(rows: np.ndarray, bpp: int, first: int) -> bytes:
    """Each row with a filter byte, the types cycling 0-4 from ``first``."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        ft = (first + y) % 5
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = [0, left, prev, (left + prev) // 2,
                _paeth(left, prev, upleft)][ft]
        out.append(ft)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(px: np.ndarray, color_type: int, depth: int,
               palette: np.ndarray | None = None,
               interlace: bool = False) -> bytes:
    """A PNG of ``px`` ``(H, W, channels)`` samples (palette indices for
    colour type 3), plain or Adam7-interlaced, every filter type used, the
    image data split over two IDAT chunks."""
    px = np.asarray(px)
    if px.ndim == 2:
        px = px[..., None]
    h, w, c = px.shape
    assert c == _CHANNELS[color_type]
    bpp = max(1, c * depth // 8)
    raw = bytearray()
    if interlace:
        for k, (x0, y0, dx, dy) in enumerate(ADAM7):
            sub = px[y0::dy, x0::dx]
            if sub.shape[0] and sub.shape[1]:
                raw += _filter(_pack_rows(sub, depth), bpp, k)
    else:
        raw += _filter(_pack_rows(px, depth), bpp, 0)
    z = zlib.compress(bytes(raw), 9)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    half = len(z) // 2
    out += _chunk(b"IDAT", z[:half]) + _chunk(b"IDAT", z[half:])
    return out + _chunk(b"IEND", b"")
