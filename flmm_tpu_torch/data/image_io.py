"""Image files -> ``(H, W, 3)`` uint8 RGB arrays without PIL: the pixels of
``np.asarray(Image.open(path).convert("RGB"))`` in the JAX package's
readers (flmm_tpu/data/io.py:37-38).

The format is decided by the file's first bytes, not by its suffix.
JPEG goes through the host library's baseline decoder (runtime/
image_decode.cpp, libjpeg-turbo's default arithmetic); PNG is inflated with
``zlib`` and unfiltered there too.  PNG kinds: grey (L, 1 / 2 / 4 / 8 / 16
bits), grey + alpha (LA), RGB and RGBA (8 / 16 bits) and palette (P, 1 / 2
/ 4 / 8 bits), plain or Adam7-interlaced; as ``convert("RGB")`` does, grey
is replicated, alpha dropped and the palette looked up (16-bit samples as
PIL opens them: see :func:`decode_png`).  Any other kind raises an error
that names the file and what it lacks.

``write_png`` is the writer the demos save through: 8-bit grey or RGB,
filter type 0, one ``zlib`` stream.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from flmm_tpu_torch import runtime

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8\xff"
# PNG colour type -> (name, channels)
_PNG_KINDS = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2),
              6: ("RGBA", 4)}


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An image file's bytes -> ``(H, W, 3)`` uint8 RGB."""
    if data.startswith(PNG_MAGIC):
        return decode_png(data, name)
    if data.startswith(JPEG_MAGIC):
        return runtime.jpeg_decode(data, name)
    raise ValueError(f"{name}: neither a PNG nor a JPEG file (starts with "
                     f"{data[:8]!r})")


def open_image(path: str) -> np.ndarray:
    """The image at ``path`` (a local path or a URL ``data.io`` opens) as
    ``(H, W, 3)`` uint8 RGB."""
    from flmm_tpu_torch.data import io

    return decode_image(io.read_bytes(path), str(path))


# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_DEPTHS = {"L": (1, 2, 4, 8, 16), "RGB": (8, 16), "P": (1, 2, 4, 8),
           "LA": (8, 16), "RGBA": (8, 16)}


def _samples(rows: np.ndarray, w: int, depth: int,
             channels: int) -> np.ndarray:
    """Unfiltered rows ``(h, rowbytes)`` -> ``(h, w, channels)`` samples
    (uint16 at depth 16, else uint8; sub-byte samples unpacked)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(h, w, channels).astype(np.uint16)
    if depth == 8:
        return rows.reshape(h, w, channels)
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def _pass_samples(raw: np.ndarray, w: int, h: int, depth: int,
                  channels: int, interlace: int, name: str) -> np.ndarray:
    """All samples of the image, ``(h, w, channels)``: one unfiltered pass,
    or the seven Adam7 passes, each filtered on its own, put in place."""
    bpp = max(1, channels * depth // 8)

    def rows_of(buf, pw, ph):
        rowbytes = (pw * channels * depth + 7) // 8
        need = ph * (rowbytes + 1)
        if len(buf) < need:
            raise ValueError(f"{name}: PNG image data ends early")
        rows = runtime.png_unfilter(buf[:need], ph, rowbytes, bpp, name)
        return _samples(rows, pw, depth, channels), need

    if not interlace:
        return rows_of(raw, w, h)[0]
    out = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        px, used = rows_of(raw[pos:], pw, ph)
        out[y0::dy, x0::dx] = px
        pos += used
    return out


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A PNG's bytes -> ``(H, W, 3)`` uint8, as PIL's ``convert("RGB")``
    gives it: grey (1, 2, 4, 8 or 16 bits), grey + alpha, RGB and RGBA (8
    or 16 bits), palette (1, 2, 4 or 8 bits), plain or Adam7-interlaced.
    Sixteen-bit samples become their high byte, as PIL's ``;16B`` raw modes
    take them, except grey, which PIL opens as ``I;16`` and converts by
    clipping at 255; 1-, 2- and 4-bit grey is scaled to 0..255 (PIL's
    ``1``, ``L;2`` and ``L;4``)."""
    pos, idat, palette, header = len(PNG_MAGIC), [], None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{name}: PNG chunk {kind!r} ends early")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{name}: PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _PNG_KINDS:
        raise ValueError(f"{name}: PNG colour type {ctype} is not supported")
    kind, channels = _PNG_KINDS[ctype]
    if interlace not in (0, 1):
        raise ValueError(f"{name}: PNG interlace method {interlace} is not "
                         "supported")
    if depth not in _DEPTHS[kind]:
        raise ValueError(f"{name}: {depth}-bit {kind} PNG is not supported")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _pass_samples(raw, w, h, depth, channels, interlace, name)
    if kind == "P":
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        # indices past the palette read as black, as PIL's lookup gives them
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[px[..., 0]]
    if depth == 16:
        px = (np.minimum(px, 255) if kind == "L" else px >> 8).astype(
            np.uint8)
    elif depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))
    if kind in ("L", "LA"):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path, array: np.ndarray) -> None:
    """Write an ``(H, W)`` grey or ``(H, W, 3)`` RGB uint8 array as a PNG
    file."""
    a = np.asarray(array)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3
                                                   and a.shape[2] == 3)):
        raise ValueError(f"write_png: {path}: an (H, W) or (H, W, 3) uint8 "
                         f"array, not {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if a.ndim == 2 else 2, 0, 0,
                         0)
    data = (PNG_MAGIC + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
