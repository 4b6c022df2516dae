"""K9, the raw capture (causal attention plus the probabilities of every
query row over the image keys), on the CPU: its plain version against the
JAX package's Pallas kernel in interpret mode at the shapes of
tests/test_flash_attention.py, in f32, inputs from a seeded numpy generator.

The CUDA kernel (csrc/flash_capture_sm90.cu, ``flmm_flash_capture_raw``) runs
only on the card, where chip_smoke.py holds it to this plain version.

Tolerance: both sides are f32 with other summation orders (the Pallas kernel
rescales its strip with a running max), atol 2e-5 as
tests/test_flash_attention.py:38-44, on the rows below each sample's valid
length (the JAX package leaves the rest unspecified).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu.ops import flash_attention as jfa
from flmm_tpu_torch.ops import flash_attention as fa
from flmm_tpu_torch.ops import masks

ATOL = 2e-5


def _qkv(seed, shape, scale=0.3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) * scale
            for _ in range(3)]


@pytest.mark.parametrize("lengths, img_start, n_img", [
    ([512, 384], 128, 200),  # tests/test_flash_attention.py:24-44
    ([512, 200], 128, 200),  # the shortest sample ends inside the image block
], ids=["reference_shape", "ends_in_image_block"])
def test_plain_matches_pallas_interpret(lengths, img_start, n_img):
    B, H, S, hd = 2, 3, 512, 64
    q, k, v = _qkv(0, (B, H, S, hd))
    want_out, want_img = jfa.flash_attention_with_capture(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths, jnp.int32), img_start, n_img, interpret=True)
    out, img = fa.flash_attention_with_capture_plain(
        *map(torch.from_numpy, (q, k, v)), torch.tensor(lengths), img_start,
        n_img)
    assert tuple(out.shape) == (B, H, S, hd)
    assert tuple(img.shape) == (B, H, S, n_img) and img.dtype == torch.float32
    for b, L in enumerate(lengths):
        np.testing.assert_allclose(out.numpy()[b, :, :L],
                                   np.asarray(want_out)[b, :, :L], atol=ATOL)
        np.testing.assert_allclose(img.numpy()[b, :, :L],
                                   np.asarray(want_img)[b, :, :L], atol=ATOL)
        # keys at or beyond the valid length get no probability
        assert not img[b, :, :, max(0, L - img_start):].any()
    # rows before the image block see none of it
    assert not img[:, :, :img_start].any()


def test_captured_rows_are_probabilities():
    """tests/test_flash_attention.py:47-62: nonnegative, and rows after a
    fully visible image block sum to at most 1."""
    q, k, v = _qkv(1, (1, 2, 256, 32), scale=1.0)
    _, img = fa.flash_attention_with_capture_plain(
        *map(torch.from_numpy, (q, k, v)), torch.tensor([256]), 0, 128)
    _, want = jfa.flash_attention_with_capture(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray([256], jnp.int32), 0, 128, interpret=True)
    np.testing.assert_allclose(img.numpy(), np.asarray(want), atol=ATOL)
    assert (img >= 0).all()
    assert (img[0, :, 200:].sum(-1) <= 1.0 + 1e-5).all()


def test_raw_rows_merge_to_the_merged_capture():
    """K9's rows contracted with a mean-merge matrix are K5's merged output
    (both plain versions, f32: 1e-6), on one key mask."""
    B, H, S, hd, M = 2, 2, 384, 32, 3
    img_start, n_img = 128, 100
    lengths = torch.tensor([384, 320])
    q, k, v = map(torch.from_numpy, _qkv(2, (B, H, S, hd)))
    ids = torch.full((B, S), -1, dtype=torch.int32)
    ids[0, 300:310], ids[0, 312:330], ids[1, 290:300] = 0, 1, 2
    mm = masks.mean_merge_matrix(ids, M)
    out9, img = fa.flash_attention_with_capture_plain(q, k, v, lengths,
                                                      img_start, n_img)
    key_valid = torch.arange(S)[None, :] < lengths[:, None]
    out5, merged = fa.flash_attention_with_merged_capture_plain(
        q, k, v, key_valid, mm, img_start, n_img)
    torch.testing.assert_close(
        torch.einsum("bhsn,bsm->bhmn", img, mm.float()), merged, atol=1e-6,
        rtol=0)
    assert torch.equal(out9, out5)


def test_a_sample_without_a_valid_key_gives_zeros():
    q, k, v = map(torch.from_numpy, _qkv(3, (2, 1, 128, 16)))
    out, img = fa.flash_attention_with_capture(q, k, v, torch.tensor([0, 128]),
                                               0, 64)
    assert not out[0].any() and not img[0].any()
    assert torch.isfinite(out).all() and torch.isfinite(img).all()
    assert img[1].any()


def test_gqa_kv_heads_equal_the_repeated_heads():
    B, H, KV, S, hd = 1, 4, 2, 256, 16
    q, _, _ = map(torch.from_numpy, _qkv(4, (B, H, S, hd)))
    _, k, v = map(torch.from_numpy, _qkv(5, (B, KV, S, hd)))
    lengths = torch.tensor([250])
    got = fa.flash_attention_with_capture(q, k, v, lengths, 128, 100)
    want = fa.flash_attention_with_capture(
        q, k.repeat_interleave(2, 1), v.repeat_interleave(2, 1), lengths, 128,
        100)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S, img_start, n_img", [
    (320, 128, 100),  # S not a multiple of 128
    (384, 64, 100),   # image block not 128-aligned
    (384, 256, 200),  # padded image block runs past S
], ids=["seq", "align", "fit"])
def test_wrapper_refuses_what_the_kernel_does_not_take(S, img_start, n_img):
    q = torch.zeros((1, 2, S, 16))
    with pytest.raises(ValueError):
        fa.flash_attention_with_capture(q, q, q, torch.tensor([S]), img_start,
                                        n_img)
