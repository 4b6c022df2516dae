"""The port's SAM extras and the ops they share with flmm_tpu, against the
JAX package on the CPU at the tiny DeepSeek-VL SAM config.

* ``ops.masks.merge_attention`` (mean and max) and ``merge_text_embeds``
  within 1e-6, ``ops.resize.resize_nearest_torch`` exact;
* ``prompt_encoder.embed_points`` (pad on and off, labels -1 / 0 / 1)
  within 1e-6;
* ``SamPredictor``: low-res logits and IoU predictions within 1e-4 of the
  JAX predictor's (fed the same pixels as a PIL image) for point, box and
  box + mask prompts; the masks at the image's size agree on >= 99.9% of
  pixels;
* the AMG helpers exact; the decode stage's logits and IoUs within 1e-4 of
  the JAX ``_decode`` on the same embedding; the
  records in the image's frame (the port) where the JAX generator's are
  in the decoder's low-res frame, and equal to a numpy recomputation of
  the reference's order from the JAX low-res logits;
* export: a round trip within 1e-6 of eager, the exported tiny decoder
  within 1e-6 of the eager one and 1e-4 of the JAX exported one;
* ``data.image_io.write_png``: PIL and ``decode_png`` read the input back.

Same weights on both sides: the port's seeded init as numpy, as JAX arrays
and carried into the port by convert/from_jax.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from flmm_tpu.configs.deepseek_vl import tiny as jtiny
from flmm_tpu.convert import export as jexport
from flmm_tpu.data.refcoco import rle_to_mask
from flmm_tpu.evalsuite.runner import resize_prob_map as jresize_prob_map
from flmm_tpu.models.sam import amg as jamg
from flmm_tpu.models.sam import prompt_encoder as jspe
from flmm_tpu.models.sam.predictor import SamPredictor as JSamPredictor
from flmm_tpu.ops import masks as jmasks
from flmm_tpu.ops import resize as jresize
from flmm_tpu_torch.configs.deepseek_vl import tiny
from flmm_tpu_torch.convert import export
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data.image_io import decode_png, write_png
from flmm_tpu_torch.models.sam import amg
from flmm_tpu_torch.models.sam import image_encoder as sam_encoder
from flmm_tpu_torch.models.sam import mask_decoder as smd
from flmm_tpu_torch.models.sam import prompt_encoder as spe
from flmm_tpu_torch.models.sam.predictor import SamPredictor
from flmm_tpu_torch.ops import masks
from flmm_tpu_torch.ops import resize

OP_TOL, SAM_TOL = 1e-6, 1e-4
H, W = 50, 70  # the image: the SAM frame pads it, the masks come back at it


def _np(t):
    return t.detach().cpu().numpy()


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return _np(tree)


@pytest.fixture(scope="module")
def sam():
    """Tiny SAM params on both sides, the configs and an image."""
    cfg = tiny().sam
    g = torch.Generator().manual_seed(0)
    params = _numpy_tree({
        "encoder": sam_encoder.init_params(cfg.encoder, g, "cpu"),
        "prompt": spe.init_params(cfg.prompt, g, "cpu"),
        "decoder": smd.init_params(cfg.decoder, g, "cpu")})
    image = np.random.default_rng(0).integers(0, 255, (H, W, 3), np.uint8)
    return {"cfg": cfg, "jcfg": jtiny().sam, "port": from_jax(params),
            "jax": jax.tree.map(jnp.asarray, params), "image": image}


# -- ops ---------------------------------------------------------------------


@pytest.mark.parametrize("merge", ["mean", "max"])
def test_merge_attention_matches_jax(merge):
    rng = np.random.default_rng(1)
    attn = rng.standard_normal((2, 3, 9, 20)).astype(np.float32)
    # mask 3 matches no token, some tokens belong to no mask
    ids = np.array([0, 0, 1, -1, 2, 2, 2, -1, 1], np.int32)
    got = masks.merge_attention(torch.as_tensor(attn), torch.as_tensor(ids),
                                4, merge)
    want = jmasks.merge_attention(jnp.asarray(attn), jnp.asarray(ids), 4,
                                  merge)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=OP_TOL,
                               rtol=OP_TOL)
    assert (_np(got)[..., 3, :] == 0).all()
    with pytest.raises(ValueError, match="unknown merge"):
        masks.merge_attention(torch.as_tensor(attn), torch.as_tensor(ids), 4,
                              "sum")


def test_merge_text_embeds_matches_jax():
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((12, 8)).astype(np.float32)
    index = rng.integers(0, 12, (3, 5)).astype(np.int32)
    got = masks.merge_text_embeds(torch.as_tensor(hidden),
                                  torch.as_tensor(index))
    want = jmasks.merge_text_embeds(jnp.asarray(hidden), jnp.asarray(index))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=OP_TOL,
                               rtol=OP_TOL)


@pytest.mark.parametrize("in_hw, out_hw", [((7, 5), (13, 11)),
                                           ((64, 48), (20, 30)),
                                           ((3, 1000), (7, 333)),
                                           ((10, 10), (10, 10))])
def test_resize_nearest_torch_matches_jax_exactly(in_hw, out_hw):
    x = np.random.default_rng(3).standard_normal((2, *in_hw)).astype(
        np.float32)
    got = resize.resize_nearest_torch(torch.as_tensor(x), out_hw)
    want = jresize.resize_nearest_torch(jnp.asarray(x), out_hw)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    ref = torch.nn.functional.interpolate(torch.as_tensor(x)[None], out_hw,
                                          mode="nearest")[0]
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("pad", [False, True])
def test_embed_points_matches_jax(sam, pad):
    rng = np.random.default_rng(4)
    coords = (rng.random((3, 4, 2)) * 128).astype(np.float32)
    labels = np.array([[1, 0, -1, 1], [0, 0, 1, -1], [1, 1, 1, 1]], np.int32)
    got = spe.embed_points(sam["port"]["prompt"], sam["cfg"].prompt,
                           torch.as_tensor(coords), torch.as_tensor(labels),
                           pad=pad)
    want = jspe.embed_points(sam["jax"]["prompt"], sam["jcfg"].prompt,
                             jnp.asarray(coords), jnp.asarray(labels),
                             pad=pad)
    assert got.shape == (3, 4 + pad, sam["cfg"].prompt.embed_dim)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=OP_TOL,
                               rtol=OP_TOL)


# -- predictor ---------------------------------------------------------------


@pytest.fixture(scope="module")
def predictors(sam):
    port = SamPredictor(sam["port"], sam["cfg"], device="cpu")
    port.set_image(sam["image"])
    jpred = JSamPredictor(sam["jax"], sam["jcfg"])
    jpred.set_image(Image.fromarray(sam["image"]))
    return port, jpred


PROMPTS = {
    "point": dict(point_coords=np.array([[30, 25]]),
                  point_labels=np.array([1]), multimask_output=True),
    "points": dict(point_coords=np.array([[30, 25], [10, 40], [60, 5]]),
                   point_labels=np.array([1, 0, 1]), multimask_output=True),
    "box": dict(box=np.array([5, 5, 60, 40]), multimask_output=False),
    "point_box": dict(point_coords=np.array([[30, 25]]),
                      point_labels=np.array([1]),
                      box=np.array([5, 5, 60, 40]), multimask_output=False),
}


@pytest.mark.parametrize("prompt", [*PROMPTS, "box_mask"])
def test_predictor_matches_jax(sam, predictors, prompt):
    port, jpred = predictors
    np.testing.assert_allclose(_np(port.embed), np.asarray(jpred._embed),
                               atol=SAM_TOL, rtol=SAM_TOL)
    if prompt == "box_mask":
        # the mask prompt is the box prompt's own low-res output
        low = jpred.predict(**PROMPTS["box"])[2]
        kw = dict(PROMPTS["box"], mask_input=low[:1])
    else:
        kw = PROMPTS[prompt]
    got = port.predict(**kw)
    want = jpred.predict(**kw)
    n = 3 if kw["multimask_output"] else 1
    P = sam["cfg"].prompt_size
    assert got[0].shape == (n, H, W) and got[0].dtype == bool
    assert got[1].shape == (n,) and got[2].shape == (n, P, P)
    np.testing.assert_allclose(got[2], want[2], atol=SAM_TOL, rtol=SAM_TOL)
    np.testing.assert_allclose(got[1], want[1], atol=SAM_TOL, rtol=SAM_TOL)
    assert (got[0] == want[0]).mean() >= 0.999


def test_predictor_refuses_predict_before_set_image(sam):
    with pytest.raises(RuntimeError, match="set_image"):
        SamPredictor(sam["port"], sam["cfg"], device="cpu").predict(
            box=np.array([0, 0, 4, 4]))


# -- automatic mask generator ------------------------------------------------


def test_amg_helpers_match_jax_exactly():
    for n in (1, 4, 7, 32):
        np.testing.assert_array_equal(amg.build_point_grid(n),
                                      jamg.build_point_grid(n))
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((6, 13, 17)) * 3).astype(np.float32)
    np.testing.assert_array_equal(amg.stability_score(logits),
                                  jamg.stability_score(logits))
    np.testing.assert_array_equal(amg.stability_score(logits, 0.5, 2.0),
                                  jamg.stability_score(logits, 0.5, 2.0))
    for m in logits > 0.5:
        assert amg.mask_to_rle(m) == jamg.mask_to_rle(m)
        np.testing.assert_array_equal(rle_to_mask(amg.mask_to_rle(m)), m)
        np.testing.assert_array_equal(amg.mask_box(m), jamg.mask_box(m))
    empty = np.zeros((5, 4), bool)
    assert amg.mask_to_rle(empty) == jamg.mask_to_rle(empty)
    np.testing.assert_array_equal(amg.mask_box(empty), jamg.mask_box(empty))
    full = np.ones((3, 2), bool)
    assert amg.mask_to_rle(full) == jamg.mask_to_rle(full)
    xy = rng.random((40, 2)) * 50
    boxes = np.concatenate([xy, xy + rng.random((40, 2)) * 30 + 1], 1)
    scores = rng.random(40)
    for thresh in (0.0, 0.3, 0.7, 1.0):
        assert amg.box_nms(boxes, scores, thresh) == jamg.box_nms(
            boxes, scores, thresh)


PASS_ALL = dict(points_per_side=4, pred_iou_thresh=-10.0,
                stability_score_thresh=0.0)


@pytest.fixture(scope="module")
def amg_pair(sam, predictors):
    """Both generators at the pass-all thresholds and the decode stage of
    each on the JAX embedding."""
    port = amg.AutomaticMaskGenerator(sam["port"], sam["cfg"], device="cpu",
                                      **PASS_ALL)
    jgen = jamg.AutomaticMaskGenerator(sam["jax"], sam["jcfg"], **PASS_ALL)
    _, jpred = predictors
    nh, nw = jpred.input_size
    pts = jgen.grid * np.array([nw, nh], np.float32)
    want = jgen._make_decode()(sam["jax"], jpred._embed,
                               jnp.asarray(pts[:, None, :]))
    embed = torch.as_tensor(np.array(jpred._embed))
    got = port.decode(embed, port.grid_points((nh, nw)))
    return {"port": port, "jax": jgen, "got": got,
            "want": [np.asarray(w) for w in want], "embed": embed,
            "input_size": (nh, nw)}


def test_amg_decode_matches_jax(amg_pair):
    got, want = amg_pair["got"], amg_pair["want"]
    assert got[0].shape == want[0].shape == (16, 3, 32, 32)
    np.testing.assert_allclose(_np(got[0]), want[0], atol=SAM_TOL,
                               rtol=SAM_TOL)
    np.testing.assert_allclose(_np(got[1]), want[1], atol=SAM_TOL,
                               rtol=SAM_TOL)


def _reference_records(low_res, ious, input_size, cfg, thresholds):
    """The reference's order in numpy on JAX's low-res logits: keep by IoU,
    bring the logits to the image's size with flmm_tpu's resize, score
    stability and threshold there, then boxes, NMS, RLEs."""
    iou_t, stab_t, nms_t = thresholds
    keep = ious > iou_t
    low_res, ious = low_res[keep], ious[keep]
    nh, nw = input_size
    P, img = cfg.prompt_size, cfg.encoder.img_size
    rh, rw = max(1, round(nh * P / img)), max(1, round(nw * P / img))
    up = np.stack([jresize_prob_map(m[:rh, :rw], (H, W)) for m in low_res])
    keep = jamg.stability_score(up) > stab_t
    up, ious = up[keep], ious[keep]
    binary = up > 0.0
    boxes = np.stack([jamg.mask_box(m) for m in binary])
    ok = boxes[:, 2] > boxes[:, 0]
    binary, boxes, ious = binary[ok], boxes[ok], ious[ok]
    return [{"segmentation": jamg.mask_to_rle(binary[i]),
             "bbox": boxes[i].tolist(), "predicted_iou": float(ious[i]),
             "area": int(binary[i].sum())}
            for i in jamg.box_nms(boxes, ious, nms_t)]


@pytest.mark.parametrize("thresholds", [(-10.0, 0.0, 0.7), (0.0, 5e-4, 0.5)])
def test_amg_records_in_the_image_frame(sam, amg_pair, thresholds):
    """Fed JAX's decoded logits, the port's postprocess gives the records of
    the reference's order recomputed in numpy: the same masks in the same
    order, boxes and IoUs equal, masks >= 99.9% equal (two bilinear
    resizes, PIL's and PyTorch's, that agree to float rounding)."""
    port = amg.AutomaticMaskGenerator(sam["port"], sam["cfg"], device="cpu")
    (port.pred_iou_thresh, port.stability_score_thresh,
     port.box_nms_thresh) = thresholds
    low = amg_pair["want"][0].reshape(-1, 32, 32)
    ious = amg_pair["want"][1].reshape(-1)
    got = port.postprocess(torch.as_tensor(low), torch.as_tensor(ious),
                           amg_pair["input_size"], (H, W))
    want = _reference_records(low, ious, amg_pair["input_size"], sam["cfg"],
                              thresholds)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["segmentation"]["size"] == [H, W]
        assert g["bbox"] == w["bbox"]
        assert g["predicted_iou"] == w["predicted_iou"]
        gm = rle_to_mask(g["segmentation"])
        assert gm.sum() == g["area"]
        assert (gm == rle_to_mask(w["segmentation"])).mean() >= 0.999


def test_amg_generate_at_the_image_size_where_jax_gives_low_res(sam):
    """The whole ``generate``: every port record is an ``(H, W)`` mask whose
    RLE decodes to its area and lies inside its box; flmm_tpu's records of
    the same image are the decoder's padded 32 x 32 frame (its fault)."""
    port = amg.AutomaticMaskGenerator(sam["port"], sam["cfg"], device="cpu",
                                      **PASS_ALL)
    jgen = jamg.AutomaticMaskGenerator(sam["jax"], sam["jcfg"], **PASS_ALL)
    got = port.generate(sam["image"])
    want = jgen.generate(Image.fromarray(sam["image"]))
    assert got and want
    assert {tuple(r["segmentation"]["size"]) for r in want} == {(32, 32)}
    for r in got:
        assert set(r) == {"segmentation", "bbox", "predicted_iou", "area"}
        m = rle_to_mask(r["segmentation"])
        assert m.shape == (H, W) and m.sum() == r["area"] > 0
        x0, y0, x1, y1 = map(int, r["bbox"])
        assert m[y0:y1, x0:x1].sum() == r["area"]


def test_amg_default_thresholds_may_keep_nothing(sam):
    port = amg.AutomaticMaskGenerator(sam["port"], sam["cfg"], device="cpu",
                                      points_per_side=2,
                                      pred_iou_thresh=1e9)
    assert port.generate(sam["image"]) == []


# -- export ------------------------------------------------------------------


def test_export_roundtrip(tmp_path):
    def f(x, p):
        return x @ p["w"] + p["b"][0]

    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((4, 8)).astype(np.float32))
    p = {"w": torch.as_tensor(rng.standard_normal((8, 3)).astype(np.float32)),
         "b": [torch.ones(3)]}
    export.export_fn(f, (x, p), tmp_path / "f.pt2")
    g = export.load_fn(tmp_path / "f.pt2")
    x2 = x * 2.0  # other values than the example's, same shapes
    torch.testing.assert_close(g(x2, p), f(x2, p), atol=1e-6, rtol=1e-6)


def _decoder_inputs(cfg, max_text, seed=7):
    rng = np.random.default_rng(seed)
    s, d, P = (cfg.prompt.image_embedding_size, cfg.prompt.embed_dim,
               cfg.prompt_size)
    tvalid = np.zeros((1, max_text), bool)
    tvalid[0, :3] = True
    return (rng.standard_normal((s, s, d)).astype(np.float32),
            np.array([[10.0, 20.0, 90.0, 70.0]], np.float32),
            rng.standard_normal((1, P, P)).astype(np.float32),
            rng.standard_normal((1, max_text, d)).astype(np.float32),
            tvalid)


def test_export_sam_decoder_matches_eager_and_jax(sam, tmp_path):
    cfg, max_text = sam["cfg"], 4
    dec_params = {k: sam["port"][k] for k in ("prompt", "decoder")}
    export.export_sam_decoder(dec_params, cfg, tmp_path / "dec.pt2",
                              max_text=max_text)
    program = export.load_fn(tmp_path / "dec.pt2")
    args = _decoder_inputs(cfg, max_text)
    targs = [torch.as_tensor(a) for a in args]
    got = program(dec_params, *targs)
    # the eager decoder on the same inputs
    emb, box, pm, text, tvalid = targs
    p = dec_params
    sparse = torch.cat([spe.embed_boxes(p["prompt"], cfg.prompt, box), text],
                       dim=1)
    valid = torch.cat([torch.ones((1, 2), dtype=torch.bool), tvalid], dim=1)
    eager = smd.forward(p["decoder"], cfg.decoder, emb,
                        spe.dense_pe(p["prompt"], cfg.prompt), sparse,
                        spe.embed_masks(p["prompt"], cfg.prompt, pm[..., None]),
                        sparse_valid=valid)
    P = cfg.prompt_size
    assert got[0].shape == (1, 4, P, P) and got[1].shape == (1, 4)
    for a, b in zip(got, eager):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    jdec = {k: sam["jax"][k] for k in ("prompt", "decoder")}
    jexport.export_sam_decoder(jdec, sam["jcfg"], tmp_path / "dec.shlo",
                               max_text=max_text)
    want = jexport.load_fn(tmp_path / "dec.shlo")(
        jdec, *[jnp.asarray(a) for a in args])
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=SAM_TOL,
                                   rtol=SAM_TOL)


# -- the PNG writer ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (4, 33), (1, 1, 3),
                                   (5, 7, 3), (9, 13, 3)])
def test_write_png_reads_back_through_pil_and_decode_png(tmp_path, shape):
    a = np.random.default_rng(8).integers(0, 256, shape, np.uint8)
    path = tmp_path / "a.png"
    write_png(path, a)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), a)
    rgb = a if a.ndim == 3 else np.repeat(a[..., None], 3, axis=2)
    np.testing.assert_array_equal(decode_png(path.read_bytes()), rgb)


@pytest.mark.parametrize("bad", [np.zeros((2, 3), np.float32),
                                 np.zeros((2, 3, 4), np.uint8),
                                 np.zeros((2,), np.uint8)])
def test_write_png_refuses_other_arrays(tmp_path, bad):
    with pytest.raises(ValueError, match="uint8"):
        write_png(tmp_path / "a.png", bad)
