"""K5, the flash-capture kernel, on the CPU: its plain version against the
JAX package's Pallas kernel in interpret mode (as
tests/test_flash_attention.py runs it), and the port decoder's flash path
against JAX ``forward_capture`` with that kernel, in f32, inputs from a
seeded numpy generator.

The CUDA kernel (csrc/flash_capture_sm90.cu) runs only on the card, where
chip_smoke.py holds it to this plain version at the LLaVA-NeXT shapes.
Under sequence sharding K5 takes one rank's query rows (``q_offset``): the
plain twin's row blocks, outputs concatenated and captures summed, are
held to the Pallas kernel on the whole sequence.

Tolerances: the Pallas kernel rounds the merge matrix and the probability
rows to bf16 before its merged product (flash_attention.py:171-176), so the
merged capture agrees to atol 2e-3 (tests/test_flash_attention.py:90); the
attention output is f32 on both sides, atol 2e-5.  The decoder's hidden
states agree to 1e-4 (f32, other summation orders through three layers).
"""

import dataclasses
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu.configs import llava_next as jax_configs
from flmm_tpu.models.llm import decoder as jdecoder
from flmm_tpu.ops import flash_attention as jfa
from flmm_tpu.ops import masks as jmasks
from flmm_tpu_torch.configs import llava_next as torch_configs
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.models.llm import decoder
from flmm_tpu_torch.ops import flash_attention as fa
from flmm_tpu_torch.ops import masks

MERGED_ATOL, OUT_ATOL, HIDDEN_TOL = 2e-3, 2e-5, 1e-4
B, S, IMG_START, N_IMG, M = 2, 384, 128, 100, 3


def _key_valid(rng):
    """Holes in the middle of the sequence (alignment pads before the image
    block, image-pad slots inside it), trailing padding, and in sample 1 no
    valid key before position 3, so its first rows see no key at all."""
    valid = rng.random((B, S)) > 0.15
    valid[:, 0] = True
    valid[:, 100:IMG_START] = False
    valid[0, IMG_START + 70:IMG_START + 90] = False
    valid[1, S - 50:] = False
    valid[1, :3] = False
    return valid


def _mask_ids(n_masks=M):
    """Masks 0-2 over caption rows; masks 3 up one row each from 331."""
    ids = np.full((B, S), -1, np.int32)
    ids[0, 300:310], ids[0, 312:330], ids[1, 290:300] = 0, 1, 2
    ids[1, 240:244] = 0
    ids[:, 331:331 + n_masks - M] = np.arange(M, n_masks)
    return ids


@pytest.mark.parametrize("kv_heads, n_masks", [(2, M), (1, M), (2, 37),
                                               (1, 37)],
                         ids=["mha", "gqa", "mha-m37", "gqa-m37"])
def test_plain_matches_pallas_interpret(kv_heads, n_masks):
    """H = 2 query heads over 2 (MHA) or 1 (GQA) kv heads; the JAX kernel
    takes the head-repeated k / v, the port the kv heads themselves.  37
    masks: more than the 32 one block of the CUDA kernel's merged pass
    takes (the JAX kernel pads them to 40)."""
    rng = np.random.default_rng(0)
    H, hd = 2, 32
    q = rng.standard_normal((B, H, S, hd)).astype(np.float32) * 0.3
    k = rng.standard_normal((B, kv_heads, S, hd)).astype(np.float32) * 0.3
    v = rng.standard_normal((B, kv_heads, S, hd)).astype(np.float32) * 0.3
    valid = _key_valid(rng)
    mm = np.array(jax.vmap(lambda i: jmasks.mean_merge_matrix(i, n_masks))(
        jnp.asarray(_mask_ids(n_masks))))
    assert (mm != 0).any(axis=(0, 1)).all()  # every mask has a caption row
    rep = H // kv_heads
    want_out, want_merged = jfa.flash_attention_with_merged_capture(
        jnp.asarray(q), jnp.asarray(np.repeat(k, rep, 1)),
        jnp.asarray(np.repeat(v, rep, 1)), jnp.asarray(valid),
        jnp.asarray(mm), IMG_START, N_IMG, interpret=True)
    out, merged = fa.flash_attention_with_merged_capture_plain(
        *map(torch.from_numpy, (q, k, v, valid, mm)), IMG_START, N_IMG)
    assert tuple(merged.shape) == (B, H, n_masks, N_IMG)
    np.testing.assert_allclose(merged.numpy(), np.asarray(want_merged),
                               atol=MERGED_ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=OUT_ATOL)
    # rows that see no key give 0, not a uniform average (the kernels' guard)
    assert not out[1, :, :3].any()


@pytest.mark.parametrize("split", [128, 256])
def test_plain_halves_with_q_offset_match_pallas_interpret(split):
    """K5's plain twin on the query rows ``[0, split)`` and ``[split, S)``
    (``q_offset`` 0 and ``split``, all keys on both): the outputs
    concatenated and the captures summed, against the Pallas kernel on the
    whole S, and against the plain twin's own whole at 1e-6."""
    rng = np.random.default_rng(split)
    H, hd, kv_heads = 2, 32, 1
    q = rng.standard_normal((B, H, S, hd)).astype(np.float32) * 0.3
    k = rng.standard_normal((B, kv_heads, S, hd)).astype(np.float32) * 0.3
    v = rng.standard_normal((B, kv_heads, S, hd)).astype(np.float32) * 0.3
    valid = _key_valid(rng)
    ids = _mask_ids()
    ids[0, 120:140] = 2  # a mask across the split at 128
    mm = np.array(jax.vmap(lambda i: jmasks.mean_merge_matrix(i, M))(
        jnp.asarray(ids)))
    want_out, want_merged = jfa.flash_attention_with_merged_capture(
        jnp.asarray(q), jnp.asarray(np.repeat(k, H, 1)),
        jnp.asarray(np.repeat(v, H, 1)), jnp.asarray(valid),
        jnp.asarray(mm), IMG_START, N_IMG, interpret=True)
    kt, vt, valid_t = map(torch.from_numpy, (k, v, valid))
    outs, merged = [], 0
    for lo, hi in ((0, split), (split, S)):
        o, m = fa.flash_attention_with_merged_capture(
            torch.from_numpy(q[:, :, lo:hi]), kt, vt, valid_t,
            torch.from_numpy(mm[:, lo:hi]), IMG_START, N_IMG, q_offset=lo)
        assert tuple(o.shape) == (B, H, hi - lo, hd)
        outs.append(o)
        merged = merged + m
    out = torch.cat(outs, dim=2)
    np.testing.assert_allclose(merged.numpy(), np.asarray(want_merged),
                               atol=MERGED_ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=OUT_ATOL)
    whole_out, whole_merged = fa.flash_attention_with_merged_capture_plain(
        *map(torch.from_numpy, (q, k, v, valid, mm)), IMG_START, N_IMG)
    torch.testing.assert_close(out, whole_out, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(merged, whole_merged, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("q_offset, S_loc", [(64, 128), (128, 192),
                                             (256, 256)],
                         ids=["offset", "rows", "past"])
def test_wrapper_refuses_unaligned_query_rows(q_offset, S_loc):
    k = torch.zeros((1, 2, S, 16))
    q = torch.zeros((1, 2, S_loc, 16))
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_with_merged_capture(
            q, k, k, torch.ones((1, S), dtype=torch.bool),
            torch.zeros((1, S_loc, 2)), IMG_START, N_IMG, q_offset=q_offset)


@pytest.mark.parametrize("S_, img_start, n_img", [
    (320, 128, 100),  # S not a multiple of 128
    (384, 64, 100),   # image block not 128-aligned
    (384, 256, 200),  # padded image block runs past S
], ids=["seq", "align", "fit"])
def test_wrapper_refuses_what_the_kernel_does_not_take(S_, img_start, n_img):
    q = torch.zeros((1, 2, S_, 16))
    valid = torch.ones((1, S_), dtype=torch.bool)
    mm = torch.zeros((1, S_, 2))
    with pytest.raises(ValueError):
        fa.flash_attention_with_merged_capture(q, q, q, valid, mm, img_start,
                                               n_img)


@pytest.fixture(scope="module")
def tiny_llm():
    """The tiny LLaVA-NeXT decoder (4 query heads over 2 kv heads) with the
    flash-capture gate on, JAX weights on both sides, and a batch with
    mid-sequence key holes."""
    jcfg = dataclasses.replace(jax_configs.tiny_llava_next().base.llm,
                               use_flash_capture=True)
    tcfg = dataclasses.replace(torch_configs.tiny_llava_next().base.llm,
                               use_flash_capture=True)
    jparams = jax.device_get(jdecoder.init_params(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(1)
    S_ = 256
    emb = rng.standard_normal((B, S_, jcfg.hidden_size)).astype(np.float32)
    valid = np.ones((B, S_), bool)
    valid[:, 5:IMG_START] = False  # alignment pads
    valid[0, IMG_START + 60:IMG_START + 88] = False  # image-pad slots
    valid[1, S_ - 9:] = False
    positions = np.maximum(np.cumsum(valid, axis=1) - 1, 0).astype(np.int32)
    ids = np.full((B, S_), -1, np.int32)
    ids[:, 220:224], ids[:, 226:230] = 0, 1
    ids[0, 232] = 2
    lw = rng.standard_normal(jcfg.num_layers).astype(np.float32)
    return jcfg, tcfg, jparams, emb, valid, positions, ids, lw


def _torch_capture(tcfg, tiny_llm):
    _, _, jparams, emb, valid, positions, ids, lw = tiny_llm
    return decoder.forward_capture(
        from_jax(jparams), tcfg, torch.from_numpy(emb),
        torch.from_numpy(valid), img_start=IMG_START, n_img=88,
        merge_matrix=masks.mean_merge_matrix(torch.from_numpy(ids), M),
        merge="mean", layer_weights=torch.softmax(torch.from_numpy(lw), 0),
        position_ids=torch.from_numpy(positions))


def test_decoder_flash_path_matches_jax(tiny_llm):
    """Port flash path (K5's plain version on the CPU) against JAX
    ``forward_capture`` with K5 in interpret mode."""
    jcfg, tcfg, jparams, emb, valid, positions, ids, lw = tiny_llm
    assert decoder.flash_capture_ok(tcfg, True, "mean", 256, IMG_START, 88)
    jmm = jax.vmap(lambda i: jmasks.mean_merge_matrix(i, M))(jnp.asarray(ids))
    orig = jfa.flash_attention_with_merged_capture
    with mock.patch.object(jfa, "flash_attention_with_merged_capture",
                           lambda *a, **k: orig(*a, **k, interpret=True)):
        want = jdecoder.forward_capture(
            jax.tree.map(jnp.asarray, jparams), jcfg, jnp.asarray(emb),
            jnp.asarray(valid), img_start=IMG_START, n_img=88,
            merge_matrix=jmm, merge="mean",
            layer_weights=jax.nn.softmax(jnp.asarray(lw)),
            position_ids=jnp.asarray(positions))
    launches = fa.flash_attention_with_merged_capture.launches
    got = _torch_capture(tcfg, tiny_llm)
    assert fa.flash_attention_with_merged_capture.launches == launches
    assert tuple(got["attn"].shape) == (B, 3, 4, M, 88)
    np.testing.assert_allclose(got["attn"].numpy(), np.asarray(want["attn"]),
                               atol=MERGED_ATOL)
    for key in ("hidden", "last_hidden"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=HIDDEN_TOL, rtol=HIDDEN_TOL)


def test_decoder_flash_path_matches_eager_path(tiny_llm):
    """With no fully masked rows, the flash gate changes nothing but the
    route: the eager path (finfo-min bias, f32 softmax) gives the same
    capture and hidden states."""
    tcfg = tiny_llm[1]
    eager = _torch_capture(dataclasses.replace(tcfg, use_flash_capture=False),
                           tiny_llm)
    flash = _torch_capture(tcfg, tiny_llm)
    for key in ("attn", "hidden", "last_hidden"):
        torch.testing.assert_close(flash[key], eager[key], atol=1e-5,
                                   rtol=1e-5)


def test_capture_aux_builds_no_bias_for_the_flash_path():
    cfg = torch_configs.tiny_llava_next().base.llm
    mask = torch.ones((1, 256), dtype=torch.bool)
    flash = decoder.capture_aux(cfg, mask, None, 256, None, with_bias=False)
    eager = decoder.capture_aux(cfg, mask, None, 256, None)
    assert "bias" not in flash and flash["valid"].dtype == torch.bool
    assert eager["bias"].shape == (1, 1, 256, 256)
