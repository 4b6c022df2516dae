"""A training data root (the layout ``python -m flmm_tpu_torch.train`` and
scripts/train.py read under ``--data-root``) assembled from the committed
eval fixtures in tests/data, which hold no train split:

* ``train2014/`` links the RefCOCO images; each ``refcoco{,+,g}/`` links
  ``instances.json`` and holds its refs pickle rewritten with every ref in
  the split ``train``;
* ``annotations/png_coco_train2017.json``, ``panoptic_train2017.json`` and
  ``panoptic_train2017/`` link the PNG val files, ``train2017/`` the val
  images.

The joint index space then holds the 16 PNG narratives and 5 images of
each referring set (31 samples), of 5 to 12 expressions an image.  With
``png_repeat`` > 1 the narratives are listed that many times over
(``joint_samples(png_repeat)`` samples), so that an epoch holds enough
batches to time steps inside one.
"""

from __future__ import annotations

import json
import pathlib
import pickle

from flmm_tpu_torch.train.streams import REFCOCO_SETS

FIXTURE = pathlib.Path(__file__).resolve().parent / "data"
PNG_SAMPLES, REFCOCO_SAMPLES = 16, 15
MOST_EXPRESSIONS = 12  # of one image, over the three referring sets


def joint_samples(png_repeat: int = 1) -> int:
    """The joint index space's size in a layout with ``png_repeat``."""
    return PNG_SAMPLES * png_repeat + REFCOCO_SAMPLES


JOINT_SAMPLES = joint_samples()


def make_train_root(root: pathlib.Path, png_repeat: int = 1) -> pathlib.Path:
    """The train layout under ``root`` (created), its PNG narratives
    listed ``png_repeat`` times; returns ``root``."""
    root.mkdir(parents=True, exist_ok=True)
    ref = FIXTURE / "refcoco"
    (root / "train2014").symlink_to(ref / "train2014")
    for name, split_file in REFCOCO_SETS:
        d = root / name
        d.mkdir()
        (d / "instances.json").symlink_to(ref / name / "instances.json")
        refs = pickle.loads((ref / name / split_file).read_bytes())
        (d / split_file).write_bytes(pickle.dumps(
            [{**r, "split": "train"} for r in refs]))
    png = FIXTURE / "png"
    ann = root / "annotations"
    ann.mkdir()
    narratives = png / "annotations" / "png_coco_val2017.json"
    if png_repeat == 1:
        (ann / "png_coco_train2017.json").symlink_to(narratives)
    else:
        (ann / "png_coco_train2017.json").write_text(json.dumps(
            json.loads(narratives.read_text()) * png_repeat))
    for val, train in (("panoptic_val2017.json", "panoptic_train2017.json"),
                       ("panoptic_val2017", "panoptic_train2017")):
        (ann / train).symlink_to(png / "annotations" / val)
    (root / "train2017").symlink_to(png / "val2017")
    return root
