"""Image files -> ``(H, W, 3)`` uint8 RGB arrays without PIL: the pixels of
``np.asarray(Image.open(path).convert("RGB"))`` in the JAX package's
readers (flmm_tpu/data/io.py:37-38).

The format is decided by the file's first bytes, not by its suffix.
JPEG goes through the host library's baseline decoder (runtime/
image_decode.cpp, libjpeg-turbo's default arithmetic); PNG is inflated with
``zlib`` and unfiltered there too.  PNG kinds: 8-bit grey (L), grey + alpha
(LA), RGB, RGBA and palette (P, 1 / 2 / 4 / 8 bits), non-interlaced; as
``convert("RGB")`` does, grey is replicated, alpha dropped and the palette
looked up.  Any other kind raises an error that names the file and what it
lacks.

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


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
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
    if interlace:
        raise ValueError(f"{name}: interlaced PNG is not supported")
    if depth != 8 and not (kind == "P" and depth in (1, 2, 4)):
        raise ValueError(f"{name}: {depth}-bit {kind} PNG is not supported")
    rowbytes = (w * channels * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = runtime.png_unfilter(raw, h, rowbytes, channels * depth // 8,
                                name)
    if kind == "P":
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        idx = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(
            h, w, depth) if depth < 8 else rows[..., None]
        if depth < 8:
            idx = (idx * (1 << np.arange(depth - 1, -1, -1))).sum(-1)
        idx = idx.reshape(h, w)
        # indices past the palette read as black, as PIL's lookup gives them
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[idx]
    px = rows.reshape(h, w, channels)
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
