"""Native host helpers of the data pipeline (flmm_tpu/runtime/__init__.py):
the mask ops of ``maskops.cpp`` (this package's own copy) and the image
decoding of ``image_decode.cpp`` (a baseline JPEG decoder with
libjpeg-turbo's arithmetic, the PNG row filters).

Both sources are compiled at first use with ``g++`` into one shared library,
cached under ``build/`` at the root of the checkout by a digest of the
sources and flags, and loaded with ``ctypes``.  Nothing is built at import
time.  Unlike the JAX package, nothing falls back to numpy or PIL: without a
compiler every call raises, since PIL's polygon fill and image decoders would
give other pixels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

SOURCES = ("maskops.cpp", "image_decode.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
HERE = pathlib.Path(__file__).resolve().parent
BUILD = HERE.parents[1] / "build" / "flmm_tpu_torch" / "host"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "rgb2id": ((_P, _P, _L), None),
    "segment_union": ((_P, _L, _P, _I, _P), None),
    "rle_decode": ((_P, _I, _I, _I, _P), None),
    "polygon_fill": ((_P, _I, _I, _I, _P), None),
    "nearest_resize_u8": ((_P, _I, _I, _P, _I, _I), None),
    "flmm_jpeg_info": ((_P, _L, _P, ctypes.c_char_p, _I), _I),
    "flmm_jpeg_decode": ((_P, _L, _P, ctypes.c_char_p, _I), _I),
    "flmm_png_unfilter": ((_P, _I, _I, _I, _P, ctypes.c_char_p, _I), _I),
}


@functools.cache
def lib() -> ctypes.CDLL:
    """The compiled helper library, built on the first call."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode() + (HERE / name).read_bytes())
    so = BUILD / f"libflmm_host_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(
                "g++ not found: the host helpers (mask ops, JPEG and PNG "
                "decoding) cannot be built, and nothing replaces them")
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, *(str(HERE / s) for s in SOURCES), "-o",
             str(tmp)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed with code {proc.returncode}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)
    so_lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(so_lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return so_lib


def _c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def rgb2id(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) int32 panoptic segment ids."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim < 1 or rgb.shape[-1] != 3:
        raise ValueError(f"rgb2id takes (..., 3) colours, got {rgb.shape}")
    out = np.empty(rgb.shape[:-1], np.int32)
    lib().rgb2id(_c(rgb), _c(out), out.size)
    return out


def segment_union(ids: np.ndarray, wanted) -> np.ndarray:
    """uint8 mask of the pixels whose id is one of ``wanted``."""
    ids = np.ascontiguousarray(ids, np.int32)
    wanted = np.ascontiguousarray(np.asarray(wanted, np.int32))
    out = np.empty(ids.shape, np.uint8)
    lib().segment_union(_c(ids), ids.size, _c(wanted), len(wanted), _c(out))
    return out


def rle_decode(counts, h: int, w: int) -> np.ndarray:
    """COCO uncompressed RLE (column-major run lengths) -> (h, w) uint8."""
    counts = np.ascontiguousarray(np.asarray(counts, np.int32))
    if (counts < 0).any() or int(counts.astype(np.int64).sum()) > h * w:
        raise ValueError(f"RLE counts do not fit a {h} x {w} mask")
    out = np.empty((h, w), np.uint8)
    lib().rle_decode(_c(counts), len(counts), h, w, _c(out))
    return out


def polygons_fill(polygons, h: int, w: int) -> np.ndarray:
    """Even-odd scanline fill over pixel centres; ORs several polygons."""
    out = np.zeros((h, w), np.uint8)
    library = lib()
    for poly in polygons:
        xy = np.ascontiguousarray(np.asarray(poly, np.float64))
        library.polygon_fill(_c(xy), len(xy) // 2, h, w, _c(out))
    return out


def nearest_resize(mask: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Nearest resize of a uint8 mask with torch's index rule
    ``floor(i * in / out)``."""
    mask = np.ascontiguousarray(mask, np.uint8)
    out = np.empty((oh, ow), np.uint8)
    lib().nearest_resize_u8(_c(mask), mask.shape[0], mask.shape[1], _c(out),
                            oh, ow)
    return out


def _check(code: int, err, what: str) -> None:
    if code != 0:
        raise ValueError(f"{what}: {err.value.decode(errors='replace')}")


def jpeg_decode(data: bytes, what: str = "JPEG") -> np.ndarray:
    """A baseline JPEG's bytes -> (H, W, 3) uint8 RGB, grey replicated, as
    PIL's ``convert("RGB")`` over libjpeg-turbo's default decode gives it.
    ``what`` names the file in errors."""
    library = lib()
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(256)
    hwc = np.zeros(3, np.int32)
    _check(library.flmm_jpeg_info(_c(buf), buf.size, _c(hwc), err, 256),
           err, what)
    out = np.empty((int(hwc[0]), int(hwc[1]), 3), np.uint8)
    _check(library.flmm_jpeg_decode(_c(buf), buf.size, _c(out), err, 256),
           err, what)
    return out


def png_unfilter(raw: np.ndarray, rows: int, rowbytes: int, bpp: int,
                 what: str = "PNG") -> np.ndarray:
    """Undo the PNG row filters of ``rows`` rows (each a filter-type byte and
    ``rowbytes`` bytes) -> (rows, rowbytes) uint8."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size < rows * (rowbytes + 1):
        raise ValueError(f"{what}: image data ends early ({raw.size} bytes "
                         f"for {rows} rows of {rowbytes})")
    out = np.empty((rows, rowbytes), np.uint8)
    err = ctypes.create_string_buffer(256)
    _check(lib().flmm_png_unfilter(_c(raw), rows, rowbytes, max(bpp, 1),
                                   _c(out), err, 256), err, what)
    return out
