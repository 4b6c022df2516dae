"""The port's checkpoint loaders (flmm_tpu_torch.convert.{hf_weights,
sam_weights,load}, registry.get_loader, train.checkpoint.restore_trainable)
against the JAX package's on the CPU.

State dicts come from the port's seeded init at the tiny presets, every
leaf made random (so a swapped key cannot hide behind a constant), through
the inverse writers of tests/checkpoint_writers.py.  Each converter's tree
must equal ``from_jax`` of the JAX converter's tree on the same state dict
bit for bit (dtype, shape, values), with f32 and bf16 checkpoints and f32
and bf16 targets; the loaders must give back the tree the checkpoint was
written from.  The SAM resamples to a reduced resolution agree with the
JAX ones within 1e-6 on tables of std 0.1, the order of a trained SAM's
pos-embed and rel-pos entries (the port resamples the pos-embed with
``F.interpolate``, the JAX package with its own separable taps: a few f32
steps apart).
"""

import dataclasses
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu.configs import deepseek_vl as jds
from flmm_tpu.configs import hpt as jhpt
from flmm_tpu.configs import llava as jllava
from flmm_tpu.configs import llava_next as jllava_next
from flmm_tpu.convert import hf_weights as jhf
from flmm_tpu.convert import load as jload
from flmm_tpu.convert import sam_weights as jsam
from flmm_tpu_torch import registry
from flmm_tpu_torch.configs import deepseek_vl as tds
from flmm_tpu_torch.configs import hpt as thpt
from flmm_tpu_torch.configs import llava as tllava
from flmm_tpu_torch.configs import llava_next as tllava_next
from flmm_tpu_torch.convert import hf_weights, load, sam_weights
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.models.frozen import grounding
from flmm_tpu_torch.models.frozen import llava_next as tmln
from flmm_tpu_torch.train import checkpoint as ckpt
from tests import checkpoint_writers as cw

RESIZE_TOL = 1e-6
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _random_tree(tree, g):
    if isinstance(tree, dict):
        return {k: _random_tree(v, g) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_random_tree(v, g) for v in tree]
    return torch.randn(tree.shape, generator=g).to(tree.dtype)


def _params(init, cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    return _random_tree(init(cfg, g, "cpu"), g)


def _jax(tree):
    """A JAX converter's tree as port tensors."""
    return from_jax(jax.device_get(tree))


def assert_trees_equal(got, want, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            assert_trees_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_trees_equal(a, b, f"{where}/{i}")
    else:
        assert isinstance(got, torch.Tensor), where
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (where, got.dtype, want.dtype, got.shape, want.shape)
        assert torch.equal(got, want.to(got.device)), where


@pytest.fixture(scope="module")
def deepseek():
    cfg = tds.tiny()
    return cfg, jds.tiny(), _params(grounding.init_params, cfg)


# --- hf_weights / sam_weights, one converter at a time ------------------

@pytest.mark.parametrize("ckpt_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("target", [torch.float32, torch.bfloat16])
def test_hf_converters_match_jax(deepseek, ckpt_dtype, target):
    cfg, jcfg, params = deepseek
    fro = params["frozen"]
    cases = [
        (hf_weights.llama_decoder_params, jhf.llama_decoder_params,
         cw.llama_state_dict(fro["llm"], dtype=ckpt_dtype), cfg.llm,
         jcfg.llm, {}),
        (hf_weights.timm_siglip_vit_params, jhf.timm_siglip_vit_params,
         cw.timm_siglip_state_dict(fro["vision"], ckpt_dtype), cfg.vision,
         jcfg.vision, {}),
    ]
    lcfg, jlcfg = tllava.tiny_llava(), jllava.tiny_llava()
    lvis = _params(grounding.init_params, lcfg, 1)["frozen"]["vision"]
    sd = cw.hf_tower_state_dict(lvis, dtype=ckpt_dtype)
    cases.append((hf_weights.clip_vit_params, jhf.clip_vit_params, sd,
                  lcfg.vision, jlcfg.vision, {}))
    siglip = {k: v for k, v in sd.items()
              if "class_embedding" not in k and "pre_layrnorm" not in k}
    siglip["vision_model.embeddings.patch_embedding.bias"] = \
        torch.randn(lcfg.vision.hidden_size).to(ckpt_dtype)
    cases.append((hf_weights.siglip_vit_params, jhf.siglip_vit_params,
                  siglip, lcfg.vision, jlcfg.vision, {}))
    for port, ref, sd, tcfg, jc, kw in cases:
        got = port(sd, tcfg, dtype=target, **kw)
        want = _jax(ref(sd, jc, dtype=JDT[target], **kw))
        assert_trees_equal(got, want, port.__name__)
    # with the defaults: the config's dtype, the llm's head kept
    got = hf_weights.llama_decoder_params(
        cw.llama_state_dict(fro["llm"], dtype=ckpt_dtype), cfg.llm)
    assert "lm_head" in got and got["embed"].dtype == cfg.llm.dtype


@pytest.mark.parametrize("ckpt_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("target", [torch.float32, torch.bfloat16])
def test_sam_converters_match_jax(deepseek, ckpt_dtype, target):
    cfg, jcfg, params = deepseek
    enc = params["frozen"]["sam_encoder"]
    tra = params["trainable"]["sam"]
    sd = {**cw.sam_encoder_state_dict(enc, dtype=ckpt_dtype),
          **cw.prompt_encoder_state_dict(tra["prompt"], dtype=ckpt_dtype),
          **cw.mask_decoder_state_dict(tra["decoder"], dtype=ckpt_dtype)}
    for port, ref, tcfg, jc in (
            (sam_weights.encoder_params, jsam.encoder_params,
             cfg.sam.encoder, jcfg.sam.encoder),
            (sam_weights.prompt_encoder_params, jsam.prompt_encoder_params,
             cfg.sam.prompt, jcfg.sam.prompt),
            (sam_weights.mask_decoder_params, jsam.mask_decoder_params,
             cfg.sam.decoder, jcfg.sam.decoder)):
        got = port(sd, tcfg, dtype=target)
        want = _jax(ref(sd, jc, dtype=JDT[target]))
        assert_trees_equal(got, want, port.__name__)
    # f32 at the tree's own size: the writers and loaders are inverses
    if ckpt_dtype == target == torch.float32:
        assert_trees_equal(sam_weights.encoder_params(sd, cfg.sam.encoder),
                           enc)
        assert_trees_equal(sam_weights.mask_decoder_params(
            sd, cfg.sam.decoder), tra["decoder"])
        assert_trees_equal(sam_weights.prompt_encoder_params(
            sd, cfg.sam.prompt), tra["prompt"])
    w = torch.randn(8, 4, 2, 2)
    np.testing.assert_array_equal(
        sam_weights._conv_transpose_kernel(w).numpy(),
        jsam._conv_transpose_kernel(w.numpy()))


@pytest.mark.parametrize("sam_size", [768, 448])
def test_sam_resamples_match_jax(sam_size):
    """A 1024 checkpoint's global rel-pos table (127 rows) and 64 x 64
    pos-embed at SAM-768 / 448, and the whole encoder tree there."""
    rng = np.random.default_rng(sam_size)
    grid = sam_size // 16
    table = 0.1 * rng.standard_normal((127, 64)).astype(np.float32)
    got = sam_weights.resize_rel_pos(torch.from_numpy(table), 2 * grid - 1)
    want = jsam.resize_rel_pos(table, 2 * grid - 1)
    assert got.shape == want.shape == (2 * grid - 1, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESIZE_TOL)
    pos = 0.1 * rng.standard_normal((64, 64, 32)).astype(np.float32)
    got = sam_weights.resize_pos_embed_2d(torch.from_numpy(pos), grid)
    want = jsam.resize_pos_embed_2d(pos, grid)
    assert got.shape == want.shape == (grid, grid, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESIZE_TOL)

    # tiny encoder written at its native 80 px, read at 48 px
    cfg, jcfg = tds.tiny(), jds.tiny()
    enc = _params(grounding.init_params, cfg)["frozen"]["sam_encoder"]
    enc["pos_embed"] *= 0.1
    for bp in enc["blocks"]:
        bp["rel_pos_h"] *= 0.1
        bp["rel_pos_w"] *= 0.1
    sd = cw.sam_encoder_state_dict(enc)
    small = registry.with_sam_size(cfg, 48).sam.encoder
    jsmall = dataclasses.replace(jcfg.sam.encoder, img_size=48)
    got = sam_weights.encoder_params(sd, small)
    want = _jax(jsam.encoder_params(sd, jsmall))
    for key in ("pos_embed",):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=0, atol=RESIZE_TOL)
    for gb, wb in zip(got["blocks"], want["blocks"]):
        for key in ("rel_pos_h", "rel_pos_w"):
            assert gb[key].shape == wb[key].shape
            np.testing.assert_allclose(gb[key].numpy(), wb[key].numpy(),
                                       rtol=0, atol=RESIZE_TOL)
        assert_trees_equal(gb["mlp"], wb["mlp"])


# --- family loaders ------------------------------------------------------

def _sam_pth(tmp_path, enc, dtype=torch.float32):
    path = tmp_path / "sam.pth"
    torch.save(cw.sam_encoder_state_dict(enc, dtype=dtype), path)
    return str(path)


@pytest.mark.parametrize("ckpt_dtype", [torch.float32, torch.bfloat16])
def test_deepseek_vl_frozen_matches_jax(deepseek, tmp_path, ckpt_dtype):
    cfg, jcfg, params = deepseek
    fro = params["frozen"]
    (tmp_path / "ckpt").mkdir()
    torch.save(cw.deepseek_vl_state_dict(fro, ckpt_dtype),
               tmp_path / "ckpt" / "pytorch_model.bin")
    sam = _sam_pth(tmp_path, fro["sam_encoder"], ckpt_dtype)
    got = registry.get_loader("deepseek_vl")(str(tmp_path / "ckpt"), cfg,
                                            sam)
    want = _jax(jload.deepseek_vl_frozen(str(tmp_path / "ckpt"), jcfg, sam))
    assert_trees_equal(got, want)
    if ckpt_dtype == torch.float32:
        assert_trees_equal(got, fro)


@pytest.mark.parametrize("next_variant", [False, True])
def test_llava_frozen_matches_jax(tmp_path, next_variant):
    if next_variant:
        cfg, jcfg = tllava_next.tiny_llava_next(), \
            jllava_next.tiny_llava_next()
        fro = _params(tmln.init_params, cfg)["frozen"]
    else:
        cfg, jcfg = tllava.tiny_llava(), jllava.tiny_llava()
        fro = _params(grounding.init_params, cfg)["frozen"]
    torch.save(cw.llava_state_dict(fro), tmp_path / "pytorch_model.bin")
    sam = _sam_pth(tmp_path, fro["sam_encoder"])
    family = "llava_next" if next_variant else "llava"
    got = registry.get_loader(family)(str(tmp_path), cfg, sam)
    want = _jax(jload.llava_frozen(str(tmp_path), jcfg, sam,
                                   next_variant=next_variant))
    assert_trees_equal(got, want)
    assert_trees_equal(got, fro)
    assert ("image_newline" in got) == next_variant


@pytest.mark.parametrize("siglip", [False, True])
def test_hpt_frozen_matches_jax(tmp_path, siglip):
    cfg, jcfg = thpt.tiny_hpt(), jhpt.tiny_hpt()
    fro = _params(grounding.init_params, cfg)["frozen"]
    if siglip:  # the SigLIP tower has no class token, no pre-norm
        vis = dict(fro["vision"])
        for k in ("cls_token", "pre_ln_w", "pre_ln_b"):
            vis.pop(k)
        vis["patch_bias"] = torch.randn(cfg.vision.hidden_size)
        fro = {**fro, "vision": vis}
    cw.hpt_checkpoint(tmp_path / "hpt", fro, siglip)
    sam = _sam_pth(tmp_path, fro["sam_encoder"])
    got = registry.get_loader("hpt")(str(tmp_path / "hpt"), cfg, sam)
    want = _jax(jload.hpt_frozen(str(tmp_path / "hpt"), jcfg, sam))
    assert_trees_equal(got, want)
    assert_trees_equal(got, fro)


def test_get_loader_refuses_mgm_and_unported_families():
    """An unknown family raises by name; mgm, ported since, has its
    three-checkpoint loader (tests/test_torch_mgm_io.py holds it to
    JAX's)."""
    import inspect

    params = inspect.signature(registry.get_loader("mgm")).parameters
    assert list(params) == ["checkpoint_dir", "cfg", "sam_checkpoint",
                            "clip_checkpoint", "aux_checkpoint", "device"]
    with pytest.raises(NotImplementedError, match="not ported"):
        registry.get_loader("nope")


@pytest.mark.parametrize("ckpt_dtype", [torch.float32, torch.bfloat16])
def test_trainable_loaders_match_jax(deepseek, tmp_path, ckpt_dtype):
    """sam_trainable, unet_params and reference_trained."""
    cfg, jcfg, params = deepseek
    tra = params["trainable"]
    sam_sd = {**cw.prompt_encoder_state_dict(tra["sam"]["prompt"],
                                             dtype=ckpt_dtype),
              **cw.mask_decoder_state_dict(tra["sam"]["decoder"],
                                           dtype=ckpt_dtype)}
    torch.save(sam_sd, tmp_path / "sam.pth")
    got = load.sam_trainable(str(tmp_path / "sam.pth"), cfg.sam)
    want = _jax(jload.sam_trainable(str(tmp_path / "sam.pth"), jcfg.sam))
    assert_trees_equal(got, want)

    sd = cw.released_trained_state_dict(tra, ckpt_dtype)
    assert not any(k.endswith(".conv.bias") for k in
                   cw.unet_state_dict(_zero_conv_bias(tra["unet"])))
    assert_trees_equal(load.unet_params(sd, cfg.unet),
                       _jax(jload.unet_params(sd, jcfg.unet)))
    torch.save({"state_dict": sd}, tmp_path / "trained.pth")
    got = load.reference_trained(str(tmp_path / "trained.pth"), cfg)
    want = _jax(jload.reference_trained(str(tmp_path / "trained.pth"),
                                        jcfg))
    assert_trees_equal(got, want)
    if ckpt_dtype == torch.float32:
        assert_trees_equal(got, tra)
    # a U-Net in mmcv's bias='auto' layout (no conv bias before the norm)
    zero = _zero_conv_bias(tra["unet"])
    sd = cw.unet_state_dict(zero)
    assert_trees_equal(load.unet_params(sd, cfg.unet), zero)


def _zero_conv_bias(tree):
    if isinstance(tree, dict):
        return {k: (torch.zeros_like(v) if k == "b" else _zero_conv_bias(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zero_conv_bias(v) for v in tree]
    return tree


# --- formats -------------------------------------------------------------

def test_bin_safetensors_and_shards_give_equal_trees(deepseek, tmp_path):
    """The same bf16 checkpoint as one .bin, one .safetensors file (read
    alone and as a directory) and two shards; the port's reader against the
    safetensors package's."""
    from safetensors.torch import load_file

    cfg, _, params = deepseek
    sd = cw.deepseek_vl_state_dict(params["frozen"], torch.bfloat16)
    dirs = {n: tmp_path / n for n in ("bin", "one", "two")}
    for d in dirs.values():
        d.mkdir()
    torch.save(sd, dirs["bin"] / "pytorch_model.bin")
    cw.write_safetensors(dirs["one"] / "model.safetensors", sd)
    cw.write_shards(dirs["two"], sd, 2)
    assert len(list(dirs["two"].glob("*.safetensors"))) == 2
    want = load.read_safetensors(dirs["one"] / "model.safetensors")
    ref = load_file(str(dirs["one"] / "model.safetensors"))
    assert set(want) == set(ref) == set(sd)
    for k in sd:
        assert want[k].dtype == torch.bfloat16
        assert torch.equal(want[k], ref[k]) and torch.equal(want[k], sd[k])
    assert_trees_equal(load.load_state_dict(dirs["two"]), sd)
    assert_trees_equal(load.load_state_dict(dirs["one"] /
                                            "model.safetensors"), sd)
    trees = [load.deepseek_vl_frozen(str(d), cfg) for d in dirs.values()]
    for t in trees[1:]:
        assert_trees_equal(t, trees[0])
    assert trees[0]["llm"]["embed"].dtype == cfg.llm.dtype
    with pytest.raises(FileNotFoundError):
        load.load_state_dict(tmp_path / "bin" / "..")


# --- restore_trainable ---------------------------------------------------

def test_restore_trainable(deepseek, tmp_path):
    cfg, _, params = deepseek
    tra = params["trainable"]
    fresh = _params(grounding.init_params, cfg, 7)["trainable"]
    path = tmp_path / "released.pth"
    torch.save({"state_dict": cw.released_trained_state_dict(tra)}, path)
    assert_trees_equal(ckpt.restore_trainable(path, cfg, fresh), tra)
    # the port's own step_<n> checkpoint
    ckpt.save(tmp_path / "step_3", {"step": 3, "params": tra,
                                    "opt_state": {"count": 3}})
    fresh = _params(grounding.init_params, cfg, 8)["trainable"]
    got = ckpt.restore_trainable(tmp_path / "step_3", cfg, fresh)
    assert got["text_proj"]["w"] is fresh["text_proj"]["w"]  # in place
    assert_trees_equal(got, tra)
    # an Orbax train state of the JAX trainer
    orbax = tmp_path / "step_5"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="Orbax"):
        ckpt.restore_trainable(orbax, cfg, fresh)


# --- the inverse writers, read by the JAX loaders -------------------------

def test_writers_read_back_by_the_jax_loaders(deepseek, tmp_path):
    cfg, jcfg, params = deepseek
    fro, tra = params["frozen"], params["trainable"]
    (tmp_path / "ckpt").mkdir()
    cw.write_safetensors(tmp_path / "ckpt" / "model.safetensors",
                         cw.deepseek_vl_state_dict(fro))
    sam = _sam_pth(tmp_path, fro["sam_encoder"])
    got = _jax(jload.deepseek_vl_frozen(str(tmp_path / "ckpt"), jcfg, sam))
    assert_trees_equal(got, fro)
    torch.save(cw.released_trained_state_dict(tra), tmp_path / "t.pth")
    got = _jax(jload.reference_trained(str(tmp_path / "t.pth"), jcfg))
    assert_trees_equal(got, tra)
