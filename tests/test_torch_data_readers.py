"""The port's host data pipeline against the JAX package's and PIL on the
CPU: the mask ops (flmm_tpu_torch.runtime) against flmm_tpu.runtime, the
PIL-free image decoding (data/image_io.py) against PIL's
``convert("RGB")``, the RefCOCO / PNG readers (data/refcoco.py, png.py,
panoptic.py) against flmm_tpu's on the fixture roots of tests/cli_fixtures.py
and on the committed tests/data tree, and the sampler and prefetch loader
(data/loader.py).  Everything is exact: the mask ops share their C++
arithmetic with the JAX package, the JPEG decoder reproduces libjpeg-turbo's
integer arithmetic, and PNG decoding is lossless.
"""

import hashlib
import io
import json
import pathlib
import pickle
import random
import struct
import zlib

import transformers  # noqa: F401  (before any test stubs torchvision)
from transformers import AutoTokenizer

import numpy as np
import pytest
from PIL import Image

from flmm_tpu import runtime as jruntime
from flmm_tpu.data import loader as jloader
from flmm_tpu.data import png as jpng
from flmm_tpu.data import refcoco as jrefcoco
from flmm_tpu.data import tokenization as jtok
from flmm_tpu_torch import registry, runtime
from flmm_tpu_torch.data import image_io, loader, panoptic, png, refcoco
from flmm_tpu_torch.data import tokenization as tok
from tests import cli_fixtures as fx
from tests import image_writers as iw

DATA = pathlib.Path(__file__).resolve().parent / "data"


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _image(h, w, seed=0):
    """Gradients, edges and noise: what a photo gives the codecs."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255.0 / w, y * 255.0 / h,
                    128 + 90 * np.sin((x + 2 * y) / 17.0)], -1)
    img[(x // 41 + y // 29) % 2 == 0] += 50
    img += rng.normal(0, 10, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# --- mask ops ------------------------------------------------------------

def test_mask_ops_match_the_jax_runtime():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (37, 53, 3), np.uint8)
    np.testing.assert_array_equal(runtime.rgb2id(rgb), jruntime.rgb2id(rgb))
    ids = np.array([[1, 2], [3, 2]], np.int32)
    np.testing.assert_array_equal(runtime.segment_union(ids, [2, 3]),
                                  jruntime.segment_union(ids, [2, 3]))
    ids = rng.integers(0, 9, (40, 30)).astype(np.int32)
    np.testing.assert_array_equal(runtime.segment_union(ids, [1, 5, 8]),
                                  jruntime.segment_union(ids, [1, 5, 8]))
    for counts, h, w in (([3, 4, 10, 2, 16], 5, 7),   # odd count
                         ([0, 6, 20, 9], 5, 7),       # starts with ones
                         ([35], 5, 7)):
        np.testing.assert_array_equal(runtime.rle_decode(counts, h, w),
                                      jruntime.rle_decode(counts, h, w))
    with pytest.raises(ValueError):
        runtime.rle_decode([30, 10], 5, 7)
    m = (rng.random((33, 47)) > 0.5).astype(np.uint8)
    for oh, ow in ((64, 64), (10, 90), (33, 47)):
        np.testing.assert_array_equal(runtime.nearest_resize(m, oh, ow),
                                      jruntime.nearest_resize(m, oh, ow))


@pytest.mark.parametrize("polys", [
    [[2.0, 2.0, 18.0, 2.0, 18.0, 14.0, 2.0, 14.0]],             # box
    [[1.5, 1.5, 20.0, 1.5, 20.0, 6.0, 6.0, 6.0, 6.0, 18.0, 1.5, 18.0]],
    [[2.0, 2.0, 12.0, 10.0, 22.0, 2.0, 22.0, 18.0, 12.0, 10.0,   # touches
      2.0, 18.0]],                                                # itself
    [[3.3, 1.2, 9.9, 17.4, 0.4, 6.6, 17.1, 6.1, 1.0, 17.0],     # star
     [15.0, 12.0, 23.5, 12.5, 19.0, 19.9]],                      # and more
    [[4.0, 4.0, 8.0, 4.0]],                                     # degenerate
])
def test_polygon_fill_matches_the_jax_runtime(polys):
    np.testing.assert_array_equal(runtime.polygons_fill(polys, 20, 24),
                                  jruntime.polygons_fill(polys, 20, 24))


# --- PNG -----------------------------------------------------------------

def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xffffffff))


def _filtered_png(px: np.ndarray, ctype: int, filters) -> bytes:
    """An 8-bit PNG whose row ``y`` uses filter ``filters[y % 5]``."""
    h, w = px.shape[:2]
    bpp = px.shape[2] if px.ndim == 3 else 1
    rows = px.reshape(h, -1).astype(np.int32)
    out = []
    for y in range(h):
        ft = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([ft]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (image_io.PNG_MAGIC + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(b"".join(out)))
            + _png_chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P2", "P4",
                                  "P16", "P256"])
def test_png_modes_match_pil(mode):
    """Files written by PIL (PIL packs small palettes into 1 / 2 / 4 bits)."""
    px = _image(37, 53)
    rng = np.random.default_rng(1)
    if mode.startswith("P"):
        n = int(mode[1:])
        im = Image.fromarray((px[..., 0].astype(np.int64) % n).astype(
            np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 3 * n).tolist())
    else:
        arr = {"L": px[..., 0], "LA": px[..., :2], "RGB": px,
               "RGBA": np.concatenate([px, px[..., :1]], -1)}[mode]
        im = Image.fromarray(arr, mode)
    buf = io.BytesIO()
    im.save(buf, "PNG")
    data = buf.getvalue()
    got = image_io.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, _pil_rgb(data))


@pytest.mark.parametrize("ctype, channels", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_png_all_five_filters_match_pil(ctype, channels):
    px = _image(23, 31, seed=ctype)
    px = np.concatenate([px, px[..., :1]], -1)[..., :channels]
    data = _filtered_png(px if channels > 1 else px[..., 0], ctype,
                         (0, 1, 2, 3, 4))
    np.testing.assert_array_equal(image_io.decode_image(data), _pil_rgb(data))


def _adam7_png(px: np.ndarray) -> bytes:
    """An interlaced (Adam7) 8-bit RGB PNG, each pass unfiltered."""
    passes = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
              (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
    raw = b""
    for y0, x0, dy, dx in passes:
        sub = px[y0::dy, x0::dx]
        if sub.size:
            raw += b"".join(b"\x00" + row.tobytes() for row in sub)
    h, w = px.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1)
    return (image_io.PNG_MAGIC + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw))
            + _png_chunk(b"IEND", b""))


# --- JPEG ----------------------------------------------------------------

@pytest.mark.parametrize("hw", [(427, 640), (333, 500)])
@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4", "grey"])
@pytest.mark.parametrize("quality", [50, 95])
def test_jpeg_matches_pil(hw, sub, quality):
    px = _image(*hw, seed=quality)
    buf = io.BytesIO()
    if sub == "grey":
        Image.fromarray(px[..., 1], "L").save(buf, "JPEG", quality=quality)
    else:
        Image.fromarray(px).save(buf, "JPEG", quality=quality,
                                 subsampling=sub)
    data = buf.getvalue()
    np.testing.assert_array_equal(image_io.decode_image(data),
                                  _pil_rgb(data))


@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4"])
def test_jpeg_restart_markers_and_small_sizes_match_pil(sub):
    """Restart intervals of 1 and 3 MCUs and one MCU row, and every size
    from 1 to 19 pixels a side (the edge columns and rows of the
    upsamplers, components 1 and 2 samples wide)."""
    px = _image(240, 333, seed=3)
    for opts in ({"restart_marker_blocks": 1},
                 {"restart_marker_blocks": 3},
                 {"restart_marker_rows": 1}):
        buf = io.BytesIO()
        Image.fromarray(px).save(buf, "JPEG", quality=85, subsampling=sub,
                                 **opts)
        data = buf.getvalue()
        assert b"\xff\xdd" in data  # a DRI marker
        np.testing.assert_array_equal(image_io.decode_image(data),
                                      _pil_rgb(data))
    rng = np.random.default_rng(4)
    for h in range(1, 20, 3):
        for w in range(1, 20):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
                buf, "JPEG", quality=90, subsampling=sub)
            data = buf.getvalue()
            np.testing.assert_array_equal(image_io.decode_image(data),
                                          _pil_rgb(data), err_msg=f"{h}x{w}")


def test_unsupported_files_raise_naming_the_file(tmp_path):
    """The kinds still refused, each by name: arithmetic-coded, lossless,
    hierarchical and 12-bit JPEGs (headers patched into a baseline file),
    a 16-bit palette PNG, an unknown PNG interlace method, and a file that
    is neither.  (Progressive and CMYK JPEGs, interlaced and 16-bit PNGs
    were refused here until they were ported: see the tests below.)"""
    base = iw.encode_jpeg(_ycc(_image(40, 56)), [(2, 2), (1, 1), (1, 1)])
    cases = {
        "arith.jpg": (iw.patch_frame(base, 0xC9), "arithmetic-coded"),
        "lossless.jpg": (iw.patch_frame(base, 0xC3), "lossless"),
        "hier.jpg": (iw.patch_frame(base, 0xC5), "hierarchical"),
        "twelve.jpg": (iw.patch_frame(base, 0xC1, precision=12), "12-bit"),
        "pal16.png": (_patch_png(iw.encode_png(np.zeros((4, 4, 1), int), 0,
                                               16), depth=16, ctype=3),
                      "16-bit P"),
        "adam9.png": (_patch_png(iw.encode_png(np.zeros((4, 4, 3), int), 2,
                                               8), interlace=2),
                      "interlace method 2"),
        "text.jpg": (b"hello", "neither a PNG nor a JPEG")}
    for name, (data, feature) in cases.items():
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(ValueError, match=feature) as err:
            image_io.open_image(str(path))
        assert str(path) in str(err.value)


def _patch_png(data: bytes, **fields) -> bytes:
    """``data`` with IHDR fields replaced (``depth``, ``ctype``,
    ``interlace``) and its CRC redone."""
    w, h, depth, ctype, c, f, interlace = struct.unpack(">IIBBBBB",
                                                        data[16:29])
    ihdr = struct.pack(">IIBBBBB", w, h, fields.get("depth", depth),
                       fields.get("ctype", ctype), c, f,
                       fields.get("interlace", interlace))
    return data[:8] + _png_chunk(b"IHDR", ihdr) + data[33:]


def _ycc(px: np.ndarray) -> np.ndarray:
    return np.asarray(Image.fromarray(px).convert("YCbCr"))


def test_hierarchical_and_12bit_jpegs_are_refused_by_pil_too():
    """The kinds this PIL refuses as well: on the same hand-built headers
    PIL raises, and so does the decoder, naming the kind."""
    base = iw.encode_jpeg(_ycc(_image(24, 40)), [(1, 1)] * 3)
    np.testing.assert_array_equal(image_io.decode_image(base),
                                  _pil_rgb(base))
    for data, kind in ((iw.patch_frame(base, 0xC5), "hierarchical"),
                       (iw.patch_frame(base, 0xC1, precision=12), "12-bit")):
        with pytest.raises(Exception):
            _pil_rgb(data)
        with pytest.raises(ValueError, match=kind):
            image_io.decode_image(data)


@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4", "grey"])
@pytest.mark.parametrize("quality", [50, 95])
def test_progressive_jpeg_matches_pil(sub, quality):
    """PIL's progressive files (libjpeg's scan script: DC first and
    refinement, AC first and refinement scans with end-of-band runs), at a
    COCO size, with restart markers, and at every size from 1 to 19 px."""
    px = _image(333, 500, seed=quality)

    def save(img, **opts):
        buf = io.BytesIO()
        if sub == "grey":
            Image.fromarray(img[..., 1], "L").save(
                buf, "JPEG", quality=quality, progressive=True, **opts)
        else:
            Image.fromarray(img).save(buf, "JPEG", quality=quality,
                                      subsampling=sub, progressive=True,
                                      **opts)
        return buf.getvalue()

    for opts in ({}, {"restart_marker_blocks": 3}, {"optimize": True}):
        data = save(px, **opts)
        assert b"\xff\xc2" in data
        np.testing.assert_array_equal(image_io.decode_image(data),
                                      _pil_rgb(data), err_msg=str(opts))
    rng = np.random.default_rng(quality)
    for h in range(1, 20, 6):
        for w in range(1, 20, 2):
            data = save(rng.integers(0, 256, (h, w, 3), np.uint8))
            np.testing.assert_array_equal(image_io.decode_image(data),
                                          _pil_rgb(data), err_msg=f"{h}x{w}")


@pytest.mark.parametrize("kind", ["pil_cmyk", "pil_cmyk_progressive",
                                  "ycck", "cmyk_adobe0", "cmyk_no_adobe",
                                  "adobe_transform_1", "ycck_420"])
def test_four_component_jpeg_matches_pil(kind):
    """CMYK and YCCK: the Adobe marker's transform flag as libjpeg reads
    it, PIL's inverted-CMYK raw mode, then its CMYK -> RGB."""
    px = _image(45, 61, seed=5)
    cmyk = np.concatenate([px, 255 - px[..., :1]], -1)
    if kind.startswith("pil"):
        buf = io.BytesIO()
        Image.fromarray(cmyk, "CMYK").save(
            buf, "JPEG", quality=85, progressive=kind.endswith("progressive"))
        data = buf.getvalue()
    else:
        transform = {"ycck": 2, "cmyk_adobe0": 0, "cmyk_no_adobe": None,
                     "adobe_transform_1": 1, "ycck_420": 2}[kind]
        sampling = ([(2, 2), (1, 1), (1, 1), (2, 2)] if kind == "ycck_420"
                    else [(1, 1)] * 4)
        data = iw.encode_jpeg(cmyk, sampling, 85, jfif=False,
                              adobe_transform=transform)
    np.testing.assert_array_equal(image_io.decode_image(data),
                                  _pil_rgb(data))


@pytest.mark.parametrize("sampling", [
    (4, 1), (1, 2), (3, 1), (4, 2), (2, 4), (1, 4), (1, 3), (2, 1), (2, 2)],
    ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg_samplings_match_pil(sampling):
    """Every integral luma sampling libjpeg-turbo takes against chroma 1x1
    (4:1:1 is 4x1, 4:4:0 is 1x2; plain replication where jdsample.c has no
    fancy method), chroma at 2x1 and 1x2 under a 2x2 luma, and sizes whose edge
    components are 1 or 2 samples wide, with restart markers."""
    rng = np.random.default_rng(sum(sampling))
    for h, w in ((61, 83), (8, 5), (17, 3), (1, 1), (33, 40)):
        px = _image(h, w, seed=h) if h > 8 else rng.integers(
            0, 256, (h, w, 3), np.uint8)
        for chroma, rst in (((1, 1), 0), ((1, 1), 2)):
            data = iw.encode_jpeg(_ycc(px), [sampling, chroma, chroma], 80,
                                  restart_interval=rst)
            np.testing.assert_array_equal(image_io.decode_image(data),
                                          _pil_rgb(data),
                                          err_msg=f"{h}x{w} rst {rst}")
    if sampling == (2, 2):  # chroma 2x1 and 1x2 under it: h1v2, h2v1
        data = iw.encode_jpeg(_ycc(_image(50, 70)), [(2, 2), (2, 1), (1, 2)])
        np.testing.assert_array_equal(image_io.decode_image(data),
                                      _pil_rgb(data))
    if sampling == (4, 2):  # 12 blocks an MCU: libjpeg and PIL refuse it
        data = iw.encode_jpeg(_ycc(_image(50, 70)), [(4, 2), (2, 1), (2, 1)])
        with pytest.raises(Exception):
            _pil_rgb(data)
        with pytest.raises(ValueError, match="12 blocks in an MCU"):
            image_io.decode_image(data)


@pytest.mark.parametrize("ctype, depth", [
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
    (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)])
@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
def test_png_depths_and_adam7_match_pil(ctype, depth, interlace):
    """Every colour type at every depth PNG allows, plain and Adam7
    (passes of every size, every filter type), at sizes from 1 px."""
    rng = np.random.default_rng(ctype * 100 + depth)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    palette = (rng.integers(0, 256, (1 << depth, 3)) if ctype == 3
               else None)
    for h, w in ((23, 31), (1, 1), (3, 10), (9, 2)):
        px = rng.integers(0, 1 << depth, (h, w, channels))
        if ctype == 0 and depth == 16:
            px[0] = rng.integers(0, 256, (w, 1))  # below PIL's clip too
        data = iw.encode_png(px, ctype, depth, palette, interlace)
        np.testing.assert_array_equal(image_io.decode_image(data),
                                      _pil_rgb(data), err_msg=f"{h}x{w}")


def test_pil_written_16bit_grey_png_matches_pil():
    """PIL's own 16-bit grey file (I;16): PIL's convert clips at 255."""
    a = np.random.default_rng(6).integers(0, 65536, (19, 27)).astype(
        np.uint16)
    a[0, :5] = [0, 1, 255, 256, 65535]
    buf = io.BytesIO()
    Image.fromarray(a, "I;16").save(buf, "PNG")
    data = buf.getvalue()
    got = image_io.decode_image(data)
    np.testing.assert_array_equal(got, _pil_rgb(data))
    assert got[0, :5, 0].tolist() == [0, 1, 255, 255, 255]
    old = _adam7_png(_image(40, 56))
    np.testing.assert_array_equal(image_io.decode_image(old), _pil_rgb(old))


@pytest.mark.parametrize("counts", [
    {0: 3},  # three codes of length 1: the third would start at 512
    {1: 4},  # four of length 2: the last is all ones
    {0: 1, 1: 1, 8: 200},  # length 9 runs past 511
])
def test_corrupt_huffman_table_raises_naming_the_file(tmp_path, counts):
    """A DHT segment whose codes do not fit their lengths is refused, as
    libjpeg refuses it, when a scan uses the table: written as AC table 0
    just before SOS, PIL and the decoder both raise; written as AC table 3,
    which no scan uses, both decode the same pixels."""
    buf = io.BytesIO()
    Image.fromarray(_image(40, 56)).save(buf, "JPEG", quality=90)
    data = buf.getvalue()
    sos = 2
    while data[sos + 1] != 0xDA:  # the segments before the scan
        sos += 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    bits = bytes(counts.get(i, 0) for i in range(16))
    for table, raises in ((0x10, True), (0x13, False)):
        body = bytes([table]) + bits + bytes(range(sum(bits)))
        dht = b"\xff\xc4" + (2 + len(body)).to_bytes(2, "big") + body
        path = tmp_path / f"dht_{table:x}.jpg"
        path.write_bytes(data[:sos] + dht + data[sos:])
        if not raises:
            np.testing.assert_array_equal(image_io.open_image(str(path)),
                                          _pil_rgb(path.read_bytes()))
            continue
        with pytest.raises(OSError):
            Image.open(path).load()
        with pytest.raises(ValueError, match="bad Huffman table") as err:
            image_io.open_image(str(path))
        assert str(path) in str(err.value)


def test_committed_fixture_manifest():
    """The manifest's hashes are PIL's decode of the committed files, and
    the PIL-free decoder gives the same pixels: the 9 dataset images and
    the files of every other kind under ``kinds/``."""
    manifest = json.loads((DATA / "manifest.json").read_text())
    files = sorted(str(p.relative_to(DATA)) for p in DATA.rglob("*")
                   if p.suffix in (".jpg", ".png"))
    assert sorted([*manifest["images"], *manifest["kinds"]]) == files
    assert len(manifest["images"]) == 9 and len(manifest["kinds"]) == 18
    total = sum(p.stat().st_size for p in DATA.rglob("*") if p.is_file())
    assert total < 1.5e6
    for name, want in {**manifest["images"], **manifest["kinds"]}.items():
        pil = np.asarray(Image.open(DATA / name).convert("RGB"))
        got = image_io.open_image(str(DATA / name))
        for px in (pil, got):
            assert list(px.shape) == want["shape"], name
            assert hashlib.sha256(px.tobytes()).hexdigest() == \
                want["sha256"], name


# --- datasets ------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("readers")
    return {"tokenizer": AutoTokenizer.from_pretrained(
                str(fx.make_tokenizer(root / "tok"))),
            "refcoco": fx.make_refcoco_root(root / "coco"),
            "png": fx.make_png_root(root / "png"), "root": root}


def _prompt(tokenizer, mod):
    """The deepseek family prompt of the tiny preset (64 image tokens)."""
    return mod.encode_multimodal_prompt(
        tokenizer, mod.TEMPLATES["deepseek"],
        registry.FAMILY_PROMPTS["deepseek_vl"], "<image_placeholder>", 64)


def _assert_samples_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if k == "image":
            want_px = np.asarray(want[k].convert("RGB"))
            assert got[k].dtype == np.uint8
            np.testing.assert_array_equal(got[k], want_px)
        elif isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k


def _refcoco_roots(world):
    yield world["refcoco"], ("refcoco", "refs(unc).p", "val")
    for name, split_file, split in (("refcoco", "refs(unc).p", "testB"),
                                    ("refcoco+", "refs(unc).p", "val"),
                                    ("refcocog", "refs(umd).p", "test")):
        yield DATA / "refcoco", (name, split_file, split)


@pytest.mark.parametrize("concat", [False, True])
def test_refcoco_readers_match_jax(world, concat):
    t = world["tokenizer"]
    for root, (name, split_file, split) in _refcoco_roots(world):
        kw = dict(ann_file=str(root / name / "instances.json"),
                  split_file=str(root / name / split_file),
                  image_path=str(root / "train2014"), split=split)
        ds, jds = refcoco.RefCocoDataset(**kw), jrefcoco.RefCocoDataset(**kw)
        assert len(ds) == len(jds) >= 1
        for i in range(len(ds)):
            item, jitem = ds[i], jds[i]
            _assert_samples_equal(item, jitem)
            for max_expr in (None, 2):
                got = refcoco.refcoco_to_sample(
                    item, t, _prompt(t, tok), concat=concat,
                    max_expressions=max_expr)
                want = jrefcoco.refcoco_to_sample(
                    jitem, t, _prompt(t, jtok), concat=concat,
                    max_expressions=max_expr)
                assert len(got) == len(want) >= 1
                for a, b in zip(got, want):
                    _assert_samples_equal(a, b)
    # the training-time subsample draws the same expressions
    item, jitem = ds[0], jds[0]
    got = refcoco.refcoco_to_sample(
        item, t, _prompt(t, tok), concat=concat, max_expressions=1,
        subsample=True, rng=np.random.default_rng(5))
    want = jrefcoco.refcoco_to_sample(
        jitem, t, _prompt(t, jtok), concat=concat, max_expressions=1,
        subsample=True, rng=np.random.default_rng(5))
    for a, b in zip(got, want, strict=True):
        _assert_samples_equal(a, b)


def _png_kwargs(root, tokenizer, mod):
    return dict(
        json_file=str(root / "annotations/png_coco_val2017.json"),
        panoptic_json_file=str(root / "annotations/panoptic_val2017.json"),
        panoptic_png_path=str(root / "annotations/panoptic_val2017"),
        image_path=str(root / "val2017"), tokenizer=tokenizer,
        prompt_spec=_prompt(tokenizer, mod))


def test_png_readers_match_jax(world):
    t = world["tokenizer"]
    for root in (world["png"], DATA / "png"):
        ds = png.PNGDataset(**_png_kwargs(root, t, tok))
        jds = jpng.PNGDataset(**_png_kwargs(root, t, jtok))
        assert len(ds) == len(jds) >= 1
        for i in range(len(ds)):
            _assert_samples_equal(ds[i], jds[i])
    infos = [info for i in range(len(ds)) for info in ds[i]["mask_infos"]]
    assert {(i["plural"], i["isthing"]) for i in infos} == {
        (False, True), (False, False), (True, True)}
    segm = panoptic.load_segment_map(
        str(DATA / "png/annotations/panoptic_val2017/000000000139.png"))
    assert set(np.unique(segm)) == {1000, 1500, 2000, 3000, 4000}
    np.testing.assert_array_equal(panoptic.id2rgb(segm.astype(np.uint32)),
                                  image_io.open_image(str(
                                      DATA / "png/annotations/"
                                      "panoptic_val2017/000000000139.png")))


def test_png_resample_of_a_narrative_without_masks(world):
    """A narrative without a mask is replaced by an index drawn from Python's
    ``random``, the same draw on both sides."""
    root = world["root"] / "png_empty"
    src = world["png"]
    for sub in ("annotations/panoptic_val2017", "val2017"):
        (root / sub).mkdir(parents=True)
        for f in (src / sub).iterdir():
            (root / sub / f.name).write_bytes(f.read_bytes())
    (root / "annotations/panoptic_val2017.json").write_bytes(
        (src / "annotations/panoptic_val2017.json").read_bytes())
    narr = json.loads((src / "annotations/png_coco_val2017.json")
                      .read_text())
    empty = {"image_id": "1", "segments": [
        {"utterance": "sits near", "segment_ids": [], "plural": False}]}
    (root / "annotations/png_coco_val2017.json").write_text(
        json.dumps([empty] * 3 + narr))
    t = world["tokenizer"]
    ds = png.PNGDataset(**_png_kwargs(root, t, tok))
    jds = jpng.PNGDataset(**_png_kwargs(root, t, jtok))
    for seed in range(4):
        random.seed(seed)
        got = ds[0]
        random.seed(seed)
        want = jds[0]
        _assert_samples_equal(got, want)
        assert len(got["masks"]) == 2


# --- loader --------------------------------------------------------------

@pytest.mark.parametrize("shuffle, shards", [(True, 1), (True, 3),
                                             (False, 2)])
def test_sampler_and_prefetch_loader_match_jax(shuffle, shards):
    for shard in range(shards):
        kw = dict(n=23, seed=4, shuffle=shuffle, num_shards=shards,
                  shard_id=shard)
        s, js = loader.EpochSampler(**kw), jloader.EpochSampler(**kw)
        for epoch in range(3):
            assert s.epoch(epoch) == js.epoch(epoch)

        def sample(i):
            return {"i": i}

        def collate(samples):
            return [x["i"] for x in samples]

        got = list(loader.PrefetchLoader(sample, collate, s, 3,
                                         num_workers=4)(2))
        want = list(jloader.PrefetchLoader(sample, collate, js, 3,
                                           num_workers=4)(2))
        assert got == want and len(got) == 2 * (len(s.epoch(0)) // 3)


def test_prefetch_loader_raises_a_worker_error():
    def sample(i):
        if i == 5:
            raise KeyError("sample 5")
        return i

    dl = loader.PrefetchLoader(sample, list, loader.EpochSampler(
        12, shuffle=False), 2, num_workers=2)
    with pytest.raises(KeyError, match="sample 5"):
        list(dl.epoch(0))


def test_refcoco_pickle_fixture_covers_every_split():
    for name, split_file, splits in (
            ("refcoco", "refs(unc).p", {"val", "testA", "testB"}),
            ("refcoco+", "refs(unc).p", {"val", "testA", "testB"}),
            ("refcocog", "refs(umd).p", {"val", "test"})):
        refs = pickle.loads((DATA / "refcoco" / name / split_file)
                            .read_bytes())
        assert {r["split"] for r in refs} == splits
        inst = json.loads((DATA / "refcoco" / name / "instances.json")
                          .read_text())
        kinds = {type(a["segmentation"]).__name__
                 for a in inst["annotations"]}
        assert kinds == {"list", "dict"}
