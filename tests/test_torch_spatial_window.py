"""K12 v10, the window attention over spatial head-major qkv, on the CPU:
its plain version and ``qkv_head_major_perm`` against the JAX package's
Pallas kernel in interpret mode at the shape of
tests/test_sam_flash.py::test_sam_flash_v10_spatial_parity_interpret (a
ragged edge: 12 -> 14), in f32, inputs from a seeded numpy generator; and on
an unpadded grid against the port's plain K6 route, which computes the same
function there.

The CUDA kernel (csrc/window_attention_sm90.cu, its ``SPATIAL_LOG2`` mode)
runs only on the card, where chip_smoke.py holds it to this plain version.

Tolerance: f32 on both sides; the Pallas kernel folds the bias into one
augmented product in base 2, the plain version adds it in natural base:
2e-4 as tests/test_sam_flash.py:342, on the valid region (the JAX kernel
leaves the pad region unspecified; the port writes 0 there).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu.ops import sam_flash_experiments as jsfx
from flmm_tpu_torch.ops import sam_flash
from flmm_tpu_torch.ops import sam_flash_experiments as sfx

ATOL = 2e-4


def _inputs(seed, B, Hp, grid_hw, side, nh, hd):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, Hp, Hp, 3 * nh * hd)).astype(np.float32) * .3
    inside = np.arange(Hp) < grid_hw
    qkv *= (inside[:, None] & inside[None, :])[None, :, :, None]
    rph, rpw = (rng.standard_normal((2 * side - 1, hd)).astype(np.float32)
                * 0.1 for _ in range(2))
    return qkv, rph, rpw, inside


@pytest.mark.parametrize("nh, hd", [(4, 16), (1, 8), (3, 64)])
def test_head_major_perm_equals_jax(nh, hd):
    perm = sfx.qkv_head_major_perm(nh, hd)
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(
        perm.numpy(), np.asarray(jsfx.qkv_head_major_perm(nh, hd)))


@pytest.mark.parametrize("grid_hw", [12, 14], ids=["ragged", "full"])
def test_plain_matches_pallas_interpret(grid_hw):
    side, hd, nh, B = 7, 16, 4, 2
    Hp = -(-grid_hw // side) * side
    qkv, rph, rpw, inside = _inputs(11, B, Hp, grid_hw, side, nh, hd)
    perm = sfx.qkv_head_major_perm(nh, hd).numpy()
    want = jsfx.sam_window_attention_v10(
        jnp.asarray(qkv[..., perm]), jnp.asarray(rph), jnp.asarray(rpw), side,
        grid_hw, interpret=True, head_group=2)
    got = sfx.sam_window_attention_v10(  # CPU tensors: the plain version
        torch.from_numpy(qkv[..., perm]), torch.from_numpy(rph),
        torch.from_numpy(rpw), side, grid_hw)
    assert tuple(got.shape) == (B, Hp, Hp, nh * hd)
    valid = (inside[:, None] & inside[None, :])[None, :, :, None]
    diff = np.where(valid, got.numpy() - np.asarray(want), 0.0)
    assert np.abs(diff).max() < ATOL
    assert not got.numpy()[~np.broadcast_to(valid, got.shape)].any()
    assert np.abs(got.numpy()).max() > 1e-3


def test_unpadded_grid_equals_the_plain_k6_route():
    """Without pad no key is masked: v10 on the head-major qkv is K6 on the
    windowised heads of the standard qkv, bit for bit (one plain core)."""
    side, hd, nh, B, Hp = 4, 8, 2, 2, 8
    qkv, rph, rpw, _ = _inputs(5, B, Hp, Hp, side, nh, hd)
    C, T, nw = nh * hd, side * side, Hp // side
    qkv_t, rph_t, rpw_t = map(torch.from_numpy, (qkv, rph, rpw))
    got = sfx.sam_window_attention_v10_plain(
        qkv_t[..., sfx.qkv_head_major_perm(nh, hd)], rph_t, rpw_t, side, Hp)
    qkvw = qkv_t.reshape(B, nw, side, nw, side, 3 * C).permute(
        0, 1, 3, 2, 4, 5).reshape(-1, T, 3 * C)
    heads = [qkvw[..., i * C:(i + 1) * C].reshape(-1, T, nh, hd).transpose(
        1, 2) for i in range(3)]
    want = sam_flash.sam_window_attention_v9_plain(*heads, rph_t, rpw_t, side)
    want = want.transpose(1, 2).reshape(B, nw, nw, side, side, C).permute(
        0, 1, 3, 2, 4, 5).reshape(B, Hp, Hp, C)
    assert torch.equal(got, want)


def test_a_window_without_a_valid_key_gives_zeros():
    """A grid padded by more than one window: its outer windows hold no
    valid key and no valid token."""
    side, hd, nh = 2, 8, 1
    qkv, rph, rpw, _ = _inputs(2, 1, 6, 3, side, nh, hd)
    out = sfx.sam_window_attention_v10_plain(
        *map(torch.from_numpy, (qkv, rph, rpw)), side, 3)
    assert torch.isfinite(out).all()
    assert not out[:, 4:].any() and not out[:, :, 4:].any()
    assert out[:, :3, :3].any()


@pytest.mark.parametrize("shape, side, grid_hw", [
    ((1, 7, 8, 48), 4, 7),   # Hp not a multiple of side
    ((1, 8, 8, 48), 4, 9),   # grid_hw beyond the tensor
    ((1, 10, 10, 24), 5, 10),  # 2 * side > head_dim
    ((8, 8, 48), 4, 8),      # not (B, Hp, Wp, C3)
], ids=["hp", "grid", "side", "rank"])
def test_wrapper_refuses_what_the_kernel_does_not_take(shape, side, grid_hw):
    hd = 8
    with pytest.raises(ValueError):
        sfx.sam_window_attention_v10(
            torch.zeros(shape), torch.zeros((2 * side - 1, hd)),
            torch.zeros((2 * side - 1, hd)), side, grid_hw)
