"""K11, the window-major <-> spatial relayout, on the CPU: the port's plain
pair against the JAX package's Pallas kernels in interpret mode and against
the JAX encoder's own relayout, on the same numpy inputs.  A relayout copies
values, so every comparison is exact.

The CUDA kernels (csrc/boundary.cu) run only on the card, where
chip_smoke.py holds them bit for bit to this plain pair.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu.models.sam import image_encoder as jenc
from flmm_tpu.ops import boundary as jbnd
from flmm_tpu_torch.models.sam import image_encoder as enc
from flmm_tpu_torch.ops import boundary as bnd

# (shape, ws): a grid that pads (12 -> 14), one that does not, and a
# non-square one that pads one axis only
CASES = [((2, 12, 12, 64), 7), ((2, 8, 8, 32), 4), ((1, 6, 9, 16), 3)]
IDS = ["padded", "unpadded", "one_axis"]


def _x(shape):
    return np.random.default_rng(0).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape, ws", CASES, ids=IDS)
def test_windowize_plain_equals_pallas_interpret_and_jax_encoder(shape, ws):
    x = _x(shape)
    got, geom = bnd.windowize_plain(torch.from_numpy(x), ws)
    want, want_geom = jbnd.windowize(jnp.asarray(x), ws, interpret=True)
    enc_want, enc_geom = jenc._windowize(jnp.asarray(x), ws)
    assert geom == tuple(want_geom) == tuple(enc_geom)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(enc_want))


@pytest.mark.parametrize("shape, ws", CASES, ids=IDS)
def test_dewindowize_plain_equals_pallas_interpret_and_jax_encoder(shape, ws):
    B, H, W, C = shape
    Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
    geom = (B, H, W, Hp, Wp)
    xw = _x((B * (Hp // ws) * (Wp // ws), ws * ws, C))
    got = bnd.dewindowize_plain(torch.from_numpy(xw), geom, ws)
    want = jbnd.dewindowize(jnp.asarray(xw), geom, ws, interpret=True)
    enc_want = jenc._dewindowize(jnp.asarray(xw), geom, ws)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(enc_want))


@pytest.mark.parametrize("shape, ws", CASES, ids=IDS)
def test_round_trip_is_the_identity_and_pads_are_zero(shape, ws):
    x = torch.from_numpy(_x(shape))
    xw, geom = bnd.windowize(x, ws)  # CPU tensor: the plain version
    assert torch.equal(bnd.dewindowize(xw, geom, ws), x)
    B, H, W, Hp, Wp = geom
    assert xw.shape == (B * (Hp // ws) * (Wp // ws), ws * ws, shape[-1])
    # what is not a copied value is a zero pad slot
    assert int((xw != 0).sum()) == int((x != 0).sum())


def test_the_encoder_shares_the_plain_pair():
    assert enc._windowize is bnd.windowize_plain
    assert enc._dewindowize is bnd.dewindowize_plain
