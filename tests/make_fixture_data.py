"""Writes the committed dataset fixture under tests/data/ (needs PIL):

    python -m tests.make_fixture_data

* ``tests/data/refcoco/``: the ``eval_refcoco`` ``--data-root`` layout:
  ``train2014/`` with five synthetic JPEGs at COCO sizes (640 x 480 4:2:0,
  480 x 640 4:2:2, 500 x 375 4:4:4, 427 x 640 grey, 640 x 427 4:2:0 with a
  restart marker every MCU row), and ``refcoco`` / ``refcoco+`` /
  ``refcocog`` each with ``instances.json`` (polygon, multi-polygon,
  concave and uncompressed-RLE segmentations) and the ``refs(unc).p`` /
  ``refs(umd).p`` pickles over all 8 eval splits, 16 expressions each;
* ``tests/data/png/``: the ``eval_png`` layout: ``val2017/`` with two JPEGs
  (640 x 480 4:2:0, 480 x 640 4:4:4), ``annotations/panoptic_val2017/``
  with their 8-bit RGB panoptic PNGs, ``panoptic_val2017.json`` and
  ``png_coco_val2017.json`` (16 narratives of singular and plural
  phrases over thing and stuff segments, every narrative with at least
  one mask);
* ``tests/data/kinds/``: one small file of each JPEG and PNG kind beyond
  the datasets' own: progressive JPEGs (4:2:0, 4:4:4 with restart markers,
  grey, CMYK), a baseline CMYK JPEG (all written by PIL), YCCK and the
  4:1:1, 4:4:0, 3 x 1 and 4 x 2 samplings (hand-built by
  ``tests/image_writers.py``, as PIL cannot write them), a 16-bit grey PNG
  (PIL), 16-bit grey + alpha, RGB and RGBA PNGs and Adam7-interlaced PNGs
  (hand-built);
* ``tests/data/orbax/step_0/``: the tiny DeepSeek-VL preset's trainable tree
  (the JAX init at seed 0; leaves of 4096 elements or more in bf16, the
  rest f32, which keeps the directory near 0.5 MB) with a step counter,
  written by ``flmm_tpu.train.checkpoint.save`` (OCDBT, zstd, zarr v2 as
  orbax writes them; many leaves above the 1024-byte inline limit);
* ``tests/data/manifest.json``: for every image file, the shape and the
  sha256 of the pixels PIL decodes (``Image.open(f).convert("RGB")``), which
  the PIL-free decoder must reproduce (the dataset images under ``images``,
  the kinds under ``kinds`` with what each is); the number of expressions a
  RefCOCO split has and of masks the PNG narratives have; and under
  ``orbax`` the state's directory, preset and, for every trainable leaf,
  its shape, dtype and the sha256 of its bytes.

The images are gradients, edges and noise (not flat colour), so the JPEG
decoder's IDCT, upsampling and colour conversion all show in the pixels.
"""

from __future__ import annotations

import hashlib
import io
import json
import pathlib
import pickle

import numpy as np

DATA = pathlib.Path(__file__).resolve().parent / "data"

# (file, (h, w), PIL save kwargs): the RefCOCO images
REFCOCO_IMAGES = (
    ("COCO_train2014_000000000009.jpg", (480, 640),
     {"quality": 80, "subsampling": 2}),
    ("COCO_train2014_000000000025.jpg", (640, 480),
     {"quality": 85, "subsampling": 1}),
    ("COCO_train2014_000000000030.jpg", (375, 500),
     {"quality": 75, "subsampling": 0}),
    ("COCO_train2014_000000000034.jpg", (640, 427),
     {"quality": 85, "grey": True}),
    ("COCO_train2014_000000000036.jpg", (427, 640),
     {"quality": 80, "subsampling": 2, "restart_marker_rows": 1}),
)
PNG_IMAGES = (
    ("000000000139.jpg", (480, 640), {"quality": 85, "subsampling": 2}),
    ("000000000285.jpg", (640, 480), {"quality": 80, "subsampling": 0}),
)
SPLITS = (("refcoco", "refs(unc).p", ("val", "testA", "testB")),
          ("refcoco+", "refs(unc).p", ("val", "testA", "testB")),
          ("refcocog", "refs(umd).p", ("val", "test")))
# two full batches of the CLIs' default batch size (8) a RefCOCO split and
# for the PNG narratives, so that no measured forward is mostly padding
EXPRESSIONS = 16
NARRATIVES = 16
SENTENCES = ("the dog on the left", "a cat near the lake",
             "the object on the right", "what is in this image",
             "the left dog", "a dog near the cat",
             "the first object that might help", "the whole region")


def synthetic_image(h: int, w: int, seed: int, grey: bool = False):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([255 * x / w, 255 * y / h,
                    128 + 100 * np.sin((x + 2 * y) / 23.0)], -1)
    for _ in range(6):  # filled discs and boxes: sharp edges
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        r = rng.uniform(20, 90)
        col = rng.uniform(0, 255, 3)
        if rng.random() < 0.5:
            sel = (y - cy) ** 2 + (x - cx) ** 2 < r * r
        else:
            sel = (np.abs(y - cy) < r) & (np.abs(x - cx) < 0.7 * r)
        img[sel] = 0.3 * img[sel] + 0.7 * col
    img += rng.normal(0, 6, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 1] if grey else img


def _jpeg(path: pathlib.Path, hw, seed: int, opts: dict) -> None:
    from PIL import Image

    opts = dict(opts)
    grey = opts.pop("grey", False)
    img = synthetic_image(*hw, seed, grey)
    Image.fromarray(img, "L" if grey else "RGB").save(path, "JPEG", **opts)


def decoded_sha256(path: pathlib.Path) -> tuple:
    from PIL import Image

    px = np.asarray(Image.open(path).convert("RGB"))
    return list(px.shape), hashlib.sha256(px.tobytes()).hexdigest()


def _rle(mask: np.ndarray) -> dict:
    """Uncompressed COCO RLE: column-major run lengths, zeros first."""
    flat = mask.T.reshape(-1)
    change = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat[0]:
        counts = [0] + counts
    return {"counts": counts, "size": list(mask.shape)}


def _annotations(images: list) -> list:
    """Two or three objects an image: a box polygon, a concave polygon
    (an L), a two-part polygon, or an ellipse as uncompressed RLE."""
    anns, aid = [], 100
    for img in images:
        h, w = img["height"], img["width"]
        rng = np.random.default_rng(img["id"])
        x0, y0 = rng.uniform(0.05, 0.3) * w, rng.uniform(0.05, 0.3) * h
        x1, y1 = x0 + 0.35 * w, y0 + 0.4 * h
        segs = [[[x0, y0, x1, y0, x1, y1, x0, y1]]]
        cx, cy = 0.6 * w, 0.55 * h
        segs.append([[cx, cy, cx + 0.3 * w, cy, cx + 0.3 * w, cy + 0.1 * h,
                      cx + 0.1 * w, cy + 0.1 * h, cx + 0.1 * w,
                      cy + 0.4 * h, cx, cy + 0.4 * h]])
        if img["id"] % 2:
            yy, xx = np.mgrid[0:h, 0:w]
            ell = (((yy - 0.3 * h) / (0.2 * h)) ** 2
                   + ((xx - 0.7 * w) / (0.15 * w)) ** 2) < 1
            segs.append(_rle(ell.astype(np.uint8)))
        else:
            segs.append([[5.5, 5.5, 60.2, 8.0, 30.0, 50.7],
                         [w - 80.0, h - 70.0, w - 10.0, h - 60.0,
                          w - 40.0, h - 5.0]])
        for seg in segs:
            anns.append({"id": aid, "image_id": img["id"],
                         "segmentation": seg,
                         "category_id": 1 + aid % 3})
            aid += 1
    return anns


def make_refcoco(root: pathlib.Path) -> dict:
    (root / "train2014").mkdir(parents=True, exist_ok=True)
    images = []
    for i, (name, hw, opts) in enumerate(REFCOCO_IMAGES):
        _jpeg(root / "train2014" / name, hw, i, opts)
        images.append({"id": int(name[-10:-4]), "file_name": name,
                       "height": hw[0], "width": hw[1]})
    anns = _annotations(images)
    by_image = {img["id"]: [a["id"] for a in anns
                            if a["image_id"] == img["id"]] for img in images}
    counts, ref_id = {}, 0
    for d, (name, split_file, splits) in enumerate(SPLITS):
        (root / name).mkdir(parents=True, exist_ok=True)
        (root / name / "instances.json").write_text(json.dumps(
            {"images": images, "annotations": anns}))
        refs = []
        for s, split in enumerate(splits):
            n_expr, k = 0, 0
            # EXPRESSIONS a split over every image, one to three sentences
            # a ref
            while n_expr < EXPRESSIONS:
                img = images[(s + d + k) % len(images)]
                ann_ids = by_image[img["id"]]
                ann = ann_ids[(k + s) % len(ann_ids)]
                n_sents = min(1 + (ref_id + d) % 3, EXPRESSIONS - n_expr)
                sents = [{"sent": SENTENCES[(ref_id + j) % len(SENTENCES)]}
                         for j in range(n_sents)]
                refs.append({"ref_id": ref_id, "image_id": img["id"],
                             "ann_id": ann, "split": split,
                             "sentences": sents})
                ref_id += 1
                k += 1
                n_expr += n_sents
            counts[f"{name}/{split}"] = n_expr
        (root / name / split_file).write_bytes(pickle.dumps(refs))
    return counts


def make_png(root: pathlib.Path) -> int:
    from PIL import Image

    from flmm_tpu_torch.data.panoptic import id2rgb

    ann_dir = root / "annotations"
    (ann_dir / "panoptic_val2017").mkdir(parents=True, exist_ok=True)
    (root / "val2017").mkdir(parents=True, exist_ok=True)
    images, pan_anns, narratives, n_masks = [], [], [], 0
    categories = [{"id": 1, "name": "dog", "isthing": 1},
                  {"id": 2, "name": "cat", "isthing": 1},
                  {"id": 3, "name": "grass", "isthing": 0},
                  {"id": 4, "name": "sky", "isthing": 0}]
    for i, (name, (h, w), opts) in enumerate(PNG_IMAGES):
        _jpeg(root / "val2017" / name, (h, w), 10 + i, opts)
        image_id = int(name[:-4])
        images.append({"id": image_id, "file_name": name, "height": h,
                       "width": w})
        yy, xx = np.mgrid[0:h, 0:w]
        segm = np.full((h, w), 4000 + i, np.uint32)  # sky
        segm[yy > 0.6 * h] = 3000 + i  # grass
        segm[((yy - 0.5 * h) / (0.15 * h)) ** 2
             + ((xx - 0.3 * w) / (0.12 * w)) ** 2 < 1] = 1000 + i
        segm[(np.abs(yy - 0.65 * h) < 0.1 * h)
             & (np.abs(xx - 0.7 * w) < 0.1 * w)] = 2000 + i
        segm[(np.abs(yy - 0.25 * h) < 0.05 * h)
             & (np.abs(xx - 0.75 * w) < 0.08 * w)] = 1500 + i  # a 2nd dog
        png_name = name.replace(".jpg", ".png")
        Image.fromarray(id2rgb(segm)).save(
            ann_dir / "panoptic_val2017" / png_name)
        infos = [{"id": 1000 + i, "category_id": 1},
                 {"id": 1500 + i, "category_id": 1},
                 {"id": 2000 + i, "category_id": 2},
                 {"id": 3000 + i, "category_id": 3},
                 {"id": 4000 + i, "category_id": 4}]
        pan_anns.append({"image_id": image_id, "file_name": png_name,
                         "segments_info": infos})
        # the panoptic ids of each phrase (none for a phrase without a
        # mask); plural when it names more than one
        phrases = (("a dog", [1000]), ("sits near", []), ("a cat", [2000]),
                   ("on the grass", [3000]), ("and two dogs", [1000, 1500]),
                   ("under the sky", [4000]), ("the other dog", [1500]),
                   ("and the animals", [1000, 1500, 2000]))
        for k in range(NARRATIVES // len(PNG_IMAGES)):
            # a rotating run of four to six phrases: at most one of them
            # without a mask
            picks = [phrases[(k + j) % len(phrases)]
                     for j in range(4 + k % 3)]
            segments = [{"utterance": text,
                         "segment_ids": [str(sid + i) for sid in ids],
                         "plural": len(ids) > 1} for text, ids in picks]
            narratives.append({"image_id": str(image_id),
                               "segments": segments})
            n_masks += sum(1 for seg in segments if seg["segment_ids"])
    (ann_dir / "panoptic_val2017.json").write_text(json.dumps(
        {"images": images, "annotations": pan_anns,
         "categories": categories}))
    (ann_dir / "png_coco_val2017.json").write_text(json.dumps(narratives))
    return n_masks


def _ycc(img: np.ndarray) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(img).convert("YCbCr"))


def make_kinds(root: pathlib.Path) -> dict:
    """The files of ``tests/data/kinds/``; ``name -> what it is``."""
    from PIL import Image

    from tests import image_writers as iw

    root.mkdir(parents=True, exist_ok=True)
    rgb = synthetic_image(75, 101, 40)
    cmyk = np.concatenate([rgb, rgb[..., :1] // 3], -1)
    small = rgb[:33, :47]  # the PNGs: 16-bit noise does not compress
    kinds = {}

    def pil_jpeg(name, img, mode, what, **opts):
        Image.fromarray(img, mode).save(root / name, "JPEG", **opts)
        kinds[name] = what

    def raw(name, data, what):
        (root / name).write_bytes(data)
        kinds[name] = what

    pil_jpeg("progressive_420.jpg", rgb, "RGB", "progressive JPEG, 4:2:0",
             progressive=True, quality=80, subsampling=2)
    pil_jpeg("progressive_444_rst.jpg", rgb, "RGB",
             "progressive JPEG, 4:4:4, a restart marker every MCU row",
             progressive=True, quality=90, subsampling=0,
             restart_marker_rows=1)
    pil_jpeg("progressive_grey.jpg", rgb[..., 1], "L",
             "progressive JPEG, grey", progressive=True, quality=75)
    pil_jpeg("progressive_cmyk.jpg", cmyk, "CMYK",
             "progressive JPEG, CMYK (Adobe transform 0)", progressive=True,
             quality=85)
    pil_jpeg("cmyk.jpg", cmyk, "CMYK", "baseline JPEG, CMYK (Adobe "
             "transform 0)", quality=85)
    raw("ycck.jpg", iw.encode_jpeg(cmyk, [(2, 2), (1, 1), (1, 1), (2, 2)],
                                   85, jfif=False, adobe_transform=2),
        "baseline JPEG, YCCK (Adobe transform 2), 2x2 Y and K")
    for name, sampling, what in (
            ("sampling_411.jpg", (4, 1), "4:1:1 (Y 4x1)"),
            ("sampling_440.jpg", (1, 2), "4:4:0 (Y 1x2)"),
            ("sampling_3x1.jpg", (3, 1), "Y 3x1"),
            ("sampling_4x2.jpg", (4, 2), "Y 4x2")):
        raw(name, iw.encode_jpeg(_ycc(rgb), [sampling, (1, 1), (1, 1)], 85,
                                 restart_interval=3),
            f"baseline JPEG, {what}, restart interval 3")
    rng = np.random.default_rng(41)
    rgb = small
    grey16 = (rgb[..., 0].astype(np.uint16) * 257
              + rng.integers(0, 257, rgb.shape[:2])).astype(np.uint16)
    grey16[:8] //= 300  # values below 256 too: PIL's clip shows both sides
    Image.fromarray(grey16, "I;16").save(root / "grey16.png")
    kinds["grey16.png"] = "16-bit grey PNG (PIL's I;16)"
    rgb16 = rgb.astype(np.uint16) * 257 + rng.integers(0, 257, rgb.shape)
    alpha16 = rng.integers(0, 65536, rgb.shape[:2] + (1,))
    raw("grey_alpha16.png", iw.encode_png(np.concatenate(
        [grey16[..., None], alpha16], -1), 4, 16), "16-bit grey + alpha PNG")
    raw("rgb16.png", iw.encode_png(rgb16, 2, 16), "16-bit RGB PNG")
    raw("rgba16_adam7.png", iw.encode_png(np.concatenate(
        [rgb16, alpha16], -1), 6, 16, interlace=True),
        "16-bit RGBA PNG, Adam7-interlaced")
    raw("rgb8_adam7.png", iw.encode_png(rgb, 2, 8, interlace=True),
        "8-bit RGB PNG, Adam7-interlaced")
    raw("grey16_adam7.png", iw.encode_png(grey16, 0, 16, interlace=True),
        "16-bit grey PNG, Adam7-interlaced")
    palette = rng.integers(0, 256, (16, 3))
    raw("palette4_adam7.png", iw.encode_png(
        rng.integers(0, 16, rgb.shape[:2]), 3, 4, palette, interlace=True),
        "4-bit palette PNG, Adam7-interlaced")
    raw("grey2_adam7.png", iw.encode_png(
        rng.integers(0, 4, rgb.shape[:2]), 0, 2, interlace=True),
        "2-bit grey PNG, Adam7-interlaced")
    return kinds


def make_orbax(root: pathlib.Path) -> dict:
    """The tiny preset's trainable tree and a step counter, through the JAX
    package's own checkpoint writer; the manifest's ``orbax`` entry."""
    import shutil

    import jax

    from flmm_tpu.configs.deepseek_vl import tiny
    from flmm_tpu.models.frozen import grounding
    from flmm_tpu.train import checkpoint

    cfg = tiny()
    trainable = jax.device_get(jax.jit(
        lambda k: grounding.init_params(cfg, k))(jax.random.key(0))[
            "trainable"])
    trainable = jax.tree.map(
        lambda a: a.astype(jax.numpy.bfloat16) if a.size >= 4096 else a,
        trainable)
    if root.exists():
        shutil.rmtree(root)
    root.parent.mkdir(parents=True, exist_ok=True)
    checkpoint.save(root, {"step": np.zeros((), np.int32),
                           "params": trainable})
    leaves = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(trainable)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        a = np.asarray(leaf)
        leaves[name] = {"shape": list(a.shape), "dtype": str(a.dtype),
                        "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return {"path": str(root.relative_to(DATA)), "preset": "tiny",
            "seed": 0, "leaves": leaves}


def main() -> None:
    counts = make_refcoco(DATA / "refcoco")
    n_masks = make_png(DATA / "png")
    kinds = make_kinds(DATA / "kinds")
    files = sorted(p for p in DATA.rglob("*")
                   if p.suffix in (".jpg", ".png")
                   and p.parent.name != "kinds")
    manifest = {"images": {}, "refcoco_expressions": counts,
                "png_masks": n_masks, "kinds": {}}
    for p in files:
        shape, digest = decoded_sha256(p)
        manifest["images"][str(p.relative_to(DATA))] = {
            "shape": shape, "sha256": digest}
    for name, what in sorted(kinds.items()):
        p = DATA / "kinds" / name
        shape, digest = decoded_sha256(p)
        manifest["kinds"][str(p.relative_to(DATA))] = {
            "shape": shape, "sha256": digest, "kind": what}
    manifest["orbax"] = make_orbax(DATA / "orbax" / "step_0")
    (DATA / "manifest.json").write_text(json.dumps(manifest, indent=1)
                                        + "\n")
    total = sum(p.stat().st_size for p in DATA.rglob("*") if p.is_file())
    print(f"wrote {len(files)} images, {total} bytes under {DATA}")


if __name__ == "__main__":
    main()
