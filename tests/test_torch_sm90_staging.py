"""The plain twins of what the wgmma + TMA kernels stage, against the JAX
package, on the CPU.

- ``sam_flash.table_bias_rows``: csrc/relpos_attention_sm90.cu forms the
  decomposed rel-pos bias rows itself, as the product of the unscaled q
  with each ``(2*side - 1, hd)`` table gathered at ``y - k + side - 1``.
  Held in f32 to ``global_bias_rows`` and to the bias columns of the JAX
  ``_global_augmented_operands`` at 1e-5 (the same products summed in
  another order).
- ``fused_block.staged_tail_plain``: csrc/block_tail.cu keeps the residual
  base x in f32, writes LN(x) and the hidden in bf16 and rounds the output
  once.  Held in bf16 to the JAX ``fused_proj_ln_mlp`` and ``fused_ln_mlp``
  run through the Pallas interpreter (as tests/test_torch_kernels.py runs
  them), which round at the same points, at the widths the GEMM core takes
  (C = 768, 1024, 1280) with every activation.  The two sides sum their f32
  products in different orders, so a bf16 rounding of LN(x) or of the
  hidden can land on the neighbouring value; the output is held to 1e-2 of
  its largest magnitude (about two bf16 steps) and its mean difference to
  2e-4 of its mean magnitude (the twin sits near 1e-5; the plain tail,
  which rounds x to bf16 before the LayerNorm, near 3e-3).
- The wrappers take those widths on the CPU (their plain versions) and
  refuse, on the kernel path, widths the kernels do not take.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu.ops import fused_block as jfb
from flmm_tpu.ops import sam_flash as jsf
from flmm_tpu_torch.ops import fused_block, sam_flash

WIDTHS = (768, 1024, 1280)
N_ROWS, F_HIDDEN = 96, 512


def _r(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _bias_inputs(side, G=3, hd=16, seed=0):
    rng = np.random.default_rng(seed + side)
    q = _r(rng, G, side * side, hd)
    rph, rpw = _r(rng, 2 * side - 1, hd), _r(rng, 2 * side - 1, hd)
    return q, rph, rpw


@pytest.mark.parametrize("side", [8, 10, 14])
def test_table_bias_rows_match_global_bias_rows(side):
    q, rph, rpw = _bias_inputs(side)
    got = sam_flash.table_bias_rows(*map(torch.from_numpy, (q, rph, rpw)),
                                    side)
    want = sam_flash.global_bias_rows(*map(torch.from_numpy, (q, rph, rpw)),
                                      side)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("side", [8, 10, 14])
def test_table_bias_rows_match_jax_augmented_operands(side):
    q, rph, rpw = _bias_inputs(side, seed=1)
    hd = q.shape[-1]
    a, _, _ = jsf._global_augmented_operands(
        *map(jnp.asarray, (q, q, q, rph, rpw)), side, log2_domain=True)
    want = np.asarray(a)[..., hd:hd + 2 * side]
    got = sam_flash.table_bias_rows(*map(torch.from_numpy, (q, rph, rpw)),
                                    side)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def _tail_inputs(C, seed):
    rng = np.random.default_rng(seed)
    F = F_HIDDEN
    return dict(
        s=_r(rng, N_ROWS, C), a=_r(rng, N_ROWS, C),
        wo=_r(rng, C, C, scale=C ** -0.5), bo=_r(rng, C, scale=0.1),
        lw=_r(rng, C, scale=0.1, shift=1.0), lb=_r(rng, C, scale=0.1),
        w1=_r(rng, C, F, scale=C ** -0.5), b1=_r(rng, F, scale=0.1),
        w2=_r(rng, F, C, scale=F ** -0.5), b2=_r(rng, C, scale=0.1))


def _bf16(arrays):
    """The same bf16 values for both frameworks."""
    t = {k: torch.from_numpy(v).bfloat16() for k, v in arrays.items()}
    j = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
         for k, v in t.items()}
    return t, j


def _close_bf16(got, want):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    diff = np.abs(got - want)
    assert diff.max() <= 1e-2 * np.abs(want).max(), diff.max()
    assert diff.mean() <= 2e-4 * np.abs(want).mean(), diff.mean()


@pytest.mark.parametrize("act", fused_block.ACTS)
@pytest.mark.parametrize("C", WIDTHS)
def test_staged_tail_matches_pallas_proj_ln_mlp(C, act):
    t, j = _bf16(_tail_inputs(C, seed=C))
    names = ("s", "a", "wo", "bo", "lw", "lb", "w1", "b1", "w2", "b2")
    want = jfb.fused_proj_ln_mlp(*(j[n] for n in names), block_n=N_ROWS,
                                 block_f=256, act=act, interpret=True)
    got = fused_block.staged_tail_plain(*(t[n] for n in names), act=act)
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want)


@pytest.mark.parametrize("act", fused_block.ACTS)
@pytest.mark.parametrize("C", WIDTHS)
def test_staged_tail_matches_pallas_ln_mlp(C, act):
    t, j = _bf16(_tail_inputs(C, seed=C + 1))
    names = ("s", "lw", "lb", "w1", "b1", "w2", "b2")
    want = jfb.fused_ln_mlp(*(j[n] for n in names), block_n=N_ROWS,
                            block_f=256, act=act, interpret=True)
    got = fused_block.staged_tail_plain(
        t["s"], None, None, None, *(t[n] for n in names[1:]), act=act)
    _close_bf16(got, want)


@pytest.mark.parametrize("C", WIDTHS)
def test_block_wrappers_take_the_widths_on_cpu(C):
    t = {k: torch.from_numpy(v) for k, v in _tail_inputs(C, seed=7).items()}
    wqkv = t["wo"].repeat(1, 3)
    bqkv = t["bo"].repeat(3)
    before = (fused_block.fused_ln_qkv.launches,
              fused_block.fused_proj_ln_mlp.launches,
              fused_block.fused_ln_mlp.launches)
    qkv = fused_block.fused_ln_qkv(t["s"], t["lw"], t["lb"], wqkv, bqkv)
    torch.testing.assert_close(qkv, fused_block.fused_ln_qkv_plain(
        t["s"], t["lw"], t["lb"], wqkv, bqkv))
    args = (t["s"], t["a"], t["wo"], t["bo"], t["lw"], t["lb"], t["w1"],
            t["b1"], t["w2"], t["b2"])
    torch.testing.assert_close(fused_block.fused_proj_ln_mlp(*args),
                               fused_block.fused_proj_ln_mlp_plain(*args))
    args8 = (t["s"], t["lw"], t["lb"], t["w1"], t["b1"], t["w2"], t["b2"])
    torch.testing.assert_close(fused_block.fused_ln_mlp(*args8),
                               fused_block.fused_ln_mlp_plain(*args8))
    assert (fused_block.fused_ln_qkv.launches,
            fused_block.fused_proj_ln_mlp.launches,
            fused_block.fused_ln_mlp.launches) == before
    # in f32 the staging's roundings are no-ops: the twin is the plain tail
    torch.testing.assert_close(fused_block.staged_tail_plain(*args),
                               fused_block.fused_proj_ln_mlp_plain(*args),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("C, F", [(768, 3072), (1024, 4096), (1280, 5120),
                                  (1024, 512)])
def test_kernel_widths_taken(C, F):
    fused_block._check_widths("block_tail", C, F)


@pytest.mark.parametrize("C, F", [(1000, 4096), (1024, 4000), (64, 256),
                                  (1152, 4304)])
def test_kernel_widths_refused(C, F):
    with pytest.raises(ValueError, match="multiples of 128"):
        fused_block._check_widths("block_tail", C, F)
