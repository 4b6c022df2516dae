"""A pure-torch model of the tiling of csrc/flash_capture_sm90.cu (K5 and
K9 on wgmma + TMA), against the JAX package's Pallas kernels in interpret
mode, on the CPU.

- Pass 1: 128-row query blocks of two warpgroups of 64 rows, 128-key tiles
  up to the block's diagonal tile, causality masked by index in the
  diagonal tile only and the key holes only in a tile that has one (the
  flag the producer sets), the online softmax in base 2 with a row that
  has seen no valid key keeping p = 0 and a rescale of 0, p rounded to
  bf16 for P V; out and the row log-sum-exp in base 2.  bf16 inputs on
  both sides (the JAX kernel rounds p to bf16 too, over 128-key blocks):
  2e-2 of the largest output, chip_smoke.py's bound for the kernel against
  its plain version.  The lse against a float64 log-sum-exp at 1e-5; rows
  without a visible key give out = 0 and lse = -inf.
- Pass 2a: the query blocks flagged by their merge rows, walked from the
  block of the first image key in order; S^T = K Q^T, p^T from the lse, the
  product with mm as bf16 hi + lo pairs in three products; above 32 masks
  one walk a chunk of 32 (the flags shared, the partial last chunk's
  columns past M zero).  Against the JAX
  kernel at atol 2e-3 (it rounds mm and p to bf16,
  tests/test_flash_attention.py:90), against the f32 plain version at a max
  rel err of 1e-4 (what chip_smoke.py asks of the kernel), and with the
  skip against the walk over every query block bit for bit (a skipped block
  adds exact zeros).
- One rank's query rows (``q_off``, sequence sharding): pass 1 on each
  rank's rows gives the whole walk's rows bit for bit, pass 2a's local
  flags are the whole's sliced and the ranks' captures sum to the whole's.
- Pass 2b: per 64-row block the key tiles at or below its diagonal (a
  prefix), the rest zeros without a product, columns past n_img neither
  written nor read; against the JAX raw-capture kernel at 2e-5 on the valid
  rows (f32 on both sides, as tests/test_torch_raw_capture.py).
- The layouts: pass 2b's staged f32 tile is the 128-byte swizzle of TMA's
  32-column boxes, and pass 2a's mm^T staging (a chunk's columns of mm
  read at row stride M) that of a K-major bf16 tile, the layout wgmma's
  descriptor reads.

Shapes: GQA 4 / 2 at head_dim 128 (the kernel's), S = 256 and 384,
img_start 128, n_img 100 and 128, M in {1, 8, 32, 40}.
"""

import itertools
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from flmm_tpu.ops import flash_attention as jfa
from flmm_tpu.ops import masks as jmasks
from flmm_tpu_torch.ops import flash_attention as fa

B, H, KV, HD, IMG_START = 2, 4, 2, 128, 128
LOOP_TOL, LSE_TOL, MERGED_ATOL, MERGED_REL, RAW_ATOL = (2e-2, 1e-5, 2e-3,
                                                        1e-4, 2e-5)
ALPHA = math.log2(math.e) / math.sqrt(HD)
NEG = float("-inf")
CASES = [(256, 100, 1), (384, 128, 8), (384, 100, 32),
         (384, 100, 40)]  # S, n_img, M
CHUNK = 32  # the widest instantiation of the merged pass, N = 32


def _inputs(seed, S, M):
    """bf16 q (B, H, S, HD) and k / v over KV heads, key holes (alignment
    pads before the image block, image-pad slots inside it, in sample 1 no
    valid key before position 3) and a mean-merge matrix over caption rows
    near the end of the sequence."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, S, HD)).astype(
        np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((B, KV, S, HD)).astype(
        np.float32)).bfloat16() for _ in range(2))
    valid = rng.random((B, S)) > 0.1
    valid[:, 0] = True
    valid[:, 100:IMG_START] = False
    valid[0, IMG_START + 40:IMG_START + 70] = False
    valid[1, :3] = False
    ids = np.full((B, S), -1, np.int32)
    for m in range(M):
        start = S - 6 - 4 * M + 4 * m
        ids[:, start:start + 3] = m
    ids[1, 150:153] = 0  # a caption row inside an earlier query block
    mm = np.array(jax.vmap(lambda i: jmasks.mean_merge_matrix(i, M))(
        jnp.asarray(ids)))
    return q, k, v, torch.from_numpy(valid), torch.from_numpy(mm)


def _heads(t):
    """kv heads repeated to the query heads, f32."""
    return t.repeat_interleave(H // t.shape[1], dim=1).float()


def pass1(q, k, v, valid, q_off=0):
    """(out f32, lse (B, H, S_q) base 2) as the kernel's tile walk gives
    them; q holds the rows ``[q_off, q_off + S_q)``, k and v all keys."""
    S = q.shape[2]
    kf, vf = _heads(k), _heads(v)
    out = torch.zeros(B, H, S, HD)
    lse = torch.empty(B, H, S)
    for q0 in range(0, S, 128):
        # the last key tile is the one on the block's global diagonal
        KT = (q0 + q_off) // 128 + 1
        for wg in range(2):
            r0 = q0 + 64 * wg
            rows = torch.arange(r0, r0 + 64) + q_off  # global, for causality
            qt = q[:, :, r0:r0 + 64].float()
            m = torch.full((B, H, 64), NEG)
            ell = torch.zeros(B, H, 64)
            o = torch.zeros(B, H, 64, HD)
            for t in range(KT):
                keys = torch.arange(128 * t, 128 * t + 128)
                s = qt @ kf[:, :, keys].transpose(-1, -2)
                ok = valid[:, None, None, keys].expand(B, 1, 64, 128)
                whole = valid[:, keys].all(-1)  # the producer's flag
                if t == KT - 1:
                    ok = ok & (keys[None, :] <= rows[:, None])
                else:
                    ok = ok | whole[:, None, None, None]
                s = s.masked_fill(~ok, NEG)
                mn = torch.maximum(m, s.amax(-1) * ALPHA)
                mb = torch.where(mn == NEG, 0.0, mn)
                r = torch.exp2(m - mb)
                p = torch.exp2(s * ALPHA - mb[..., None])
                ell = ell * r + p.sum(-1)
                o = o * r[..., None] + p.bfloat16().float() @ vf[:, :, keys]
                m = mn
            out[:, :, r0:r0 + 64] = o / ell.clamp_min(1e-30)[..., None]
            lse[:, :, r0:r0 + 64] = m + torch.log2(ell)
    return out, lse


def merge_flags(mm):
    """(B, S / 64): a query block merges where one of its rows is not 0."""
    return (mm != 0).any(-1).reshape(B, -1, 64).any(-1)


def _split(x):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def mask_chunks(M):
    """The merged pass's blocks over the masks of one key block: ``(m0, w,
    mp)`` a chunk, its first mask, its width and its width padded to the
    instantiation's N (8, 16 or 32; chunks of 32 above 32 masks)."""
    mp = 8 if M <= 8 else 16 if M <= 16 else CHUNK
    return [(m0, min(mp, M - m0), mp) for m0 in range(0, M, mp)]


def pass2a(q, k, lse, valid, mm, n_img, skip=True, q_off=0):
    """merged (B, H, M, n_img) f32 as the capture pass accumulates it; q,
    lse and mm hold the rows ``[q_off, q_off + S_q)`` (local query block i
    is global block i + q_off / 64), the sum over those rows only.  Each
    chunk of masks walks the same flagged blocks in the same order and
    writes its own rows of merged."""
    S, M = q.shape[2], mm.shape[-1]
    kf = _heads(k)
    flags = merge_flags(mm)
    merged = torch.full((B, H, M, n_img), float("nan"))
    for b, kb, (m0, w, mp) in itertools.product(
            range(B), range(-(-n_img // 64)), mask_chunks(M)):
        key0 = IMG_START + 64 * kb
        keys = torch.arange(key0, key0 + 64)
        order = [i for i in range(max(0, key0 // 64 - q_off // 64), S // 64)
                 if flags[b, i] or not skip]
        acc = torch.zeros(H, 64, mp)
        for i in order:
            qi = torch.arange(64 * i, 64 * i + 64)
            st = kf[b, :, keys] @ q[b, :, qi].float().transpose(-1, -2)
            ok = valid[b, keys][:, None] & (
                keys[:, None] <= qi[None, :] + q_off)
            pt = torch.where(ok, torch.exp2(st * ALPHA
                                            - lse[b, :, None, qi]), 0.0)
            phi, plo = _split(pt)
            # the chunk's columns; those past w staged as zeros
            chunk = torch.zeros(64, mp)
            chunk[:, :w] = mm[b, qi, m0:m0 + w].float()
            mhi, mlo = _split(chunk)
            acc = acc + phi @ mhi
            acc = acc + plo @ mhi
            acc = acc + phi @ mlo
        assert not acc[..., w:].any()
        cols = min(64, n_img - 64 * kb)
        assert merged[b, :, m0:m0 + w, 64 * kb:64 * kb + cols].isnan().all()
        merged[b, :, m0:m0 + w, 64 * kb:64 * kb + cols] = acc[
            :, :cols, :w].transpose(1, 2)
    assert not merged.isnan().any()
    return merged


def pass2b(q, k, lse, valid, n_img):
    """probs (B, H, S, n_img) f32 as the raw capture pass writes it; every
    element written once (NaN marks one never written)."""
    S = q.shape[2]
    kf = _heads(k)
    n_kt = -(-n_img // 64)
    probs = torch.full((B, H, S, n_img), float("nan"))
    for q0 in range(0, S, 64):
        rows = torch.arange(q0, q0 + 64)
        need = 0 if q0 < IMG_START else min(n_kt, (q0 - IMG_START) // 64 + 1)
        for t in range(need):
            keys = torch.arange(IMG_START + 64 * t, IMG_START + 64 * t + 64)
            s = q[:, :, rows].float() @ kf[:, :, keys].transpose(-1, -2)
            ok = valid[:, None, None, keys] & (keys[None, :] <= rows[:, None])
            p = torch.where(ok, torch.exp2(s * ALPHA - lse[:, :, rows, None]),
                            0.0)
            cols = min(64, n_img - 64 * t)
            assert probs[:, :, rows, 64 * t:64 * t + cols].isnan().all()
            probs[:, :, rows, 64 * t:64 * t + cols] = p[..., :cols]
        assert probs[:, :, rows, 64 * need:].isnan().all()
        probs[:, :, rows, 64 * need:] = 0.0
    assert not probs.isnan().any()
    return probs


def _jax_merged(q, k, v, valid, mm, n_img):
    rep = H // KV
    return jfa.flash_attention_with_merged_capture(
        jnp.asarray(q.float().numpy(), jnp.bfloat16),
        jnp.asarray(np.repeat(k.float().numpy(), rep, 1), jnp.bfloat16),
        jnp.asarray(np.repeat(v.float().numpy(), rep, 1), jnp.bfloat16),
        jnp.asarray(valid.numpy()), jnp.asarray(mm.numpy()), IMG_START,
        n_img, interpret=True)


@pytest.mark.parametrize("S, n_img, M", CASES)
def test_pass1_tile_walk_matches_pallas_interpret(S, n_img, M):
    q, k, v, valid, mm = _inputs(S + M, S, M)
    out, lse = pass1(q, k, v, valid)
    want_out, _ = _jax_merged(q, k, v, valid, mm, n_img)
    want_out = np.asarray(want_out.astype(jnp.float32))
    err = np.abs(out.numpy() - want_out).max() / np.abs(want_out).max()
    assert err <= LOOP_TOL, err
    # the lse in base 2 of the scaled scores, against float64
    s = (q.double() @ _heads(k).double().transpose(-1, -2)) * ALPHA
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    s = s.masked_fill(~(causal & valid[:, None, None, :]), NEG)
    want_lse = torch.logsumexp(s * math.log(2), -1) / math.log(2)
    seen = torch.isfinite(want_lse)
    np.testing.assert_allclose(lse[seen].numpy(), want_lse[seen].numpy(),
                               atol=LSE_TOL, rtol=LSE_TOL)
    # sample 1 has no valid key before position 3: out 0, lse -inf
    assert (~seen).sum() == H * 3 and bool((lse[~seen] == NEG).all())
    assert not out[1, :, :3].any()


@pytest.mark.parametrize("S, n_img, M", CASES)
def test_pass2a_skip_and_fixed_order_match_pallas_interpret(S, n_img, M):
    q, k, v, valid, mm = _inputs(S + M, S, M)
    _, lse = pass1(q, k, v, valid)
    merged = pass2a(q, k, lse, valid, mm, n_img)
    # the flagged blocks: the caption rows' blocks, the one at 150 in
    # sample 1; the others add exact zeros
    flags = merge_flags(mm)
    assert flags[0].sum() < S // 64 and bool(flags[1, 2])
    assert torch.equal(merged, pass2a(q, k, lse, valid, mm, n_img,
                                      skip=False))
    _, want = _jax_merged(q, k, v, valid, mm, n_img)
    np.testing.assert_allclose(merged.numpy(), np.asarray(want),
                               atol=MERGED_ATOL)
    _, plain = fa.flash_attention_with_merged_capture_plain(
        q.float(), k.float(), v.float(), valid, mm, IMG_START, n_img)
    rel = (merged - plain).abs().max() / plain.abs().max()
    assert rel <= MERGED_REL, rel.item()


@pytest.mark.parametrize("S, split", [(256, 128), (384, 128), (384, 256)])
def test_tile_walk_over_one_ranks_query_rows(S, split):
    """Sequence sharding: each rank's rows ``[lo, hi)`` at ``q_off = lo``.
    Pass 1 walks ``(q0 + q_off) / 128 + 1`` key tiles a local block and
    gives each rank's rows of the whole walk bit for bit; pass 2a flags the
    ``(hi - lo) / 64`` local blocks (the whole's flags, sliced) and the
    ranks' merged captures sum to the whole's at 1e-4 (another order of
    the same f32 sums), and to the plain twin's halves."""
    n_img, M = 100, 8
    q, k, v, valid, mm = _inputs(S + split, S, M)
    out, lse = pass1(q, k, v, valid)
    merged = pass2a(q, k, lse, valid, mm, n_img)
    total = torch.zeros_like(merged)
    plain = torch.zeros_like(merged)
    for lo, hi in ((0, split), (split, S)):
        o, ls = pass1(q[:, :, lo:hi], k, v, valid, q_off=lo)
        assert torch.equal(o, out[:, :, lo:hi])
        assert torch.equal(ls, lse[:, :, lo:hi])
        flags = merge_flags(mm[:, lo:hi])
        assert flags.shape == (B, (hi - lo) // 64)
        assert torch.equal(flags, merge_flags(mm)[:, lo // 64:hi // 64])
        total += pass2a(q[:, :, lo:hi], k, ls, valid, mm[:, lo:hi], n_img,
                        q_off=lo)
        plain += fa.flash_attention_with_merged_capture_plain(
            q[:, :, lo:hi].float(), k.float(), v.float(), valid,
            mm[:, lo:hi], IMG_START, n_img, q_offset=lo)[1]
    rel = (total - merged).abs().max() / merged.abs().max()
    assert rel <= MERGED_REL, rel.item()
    rel = (total - plain).abs().max() / plain.abs().max()
    assert rel <= MERGED_REL, rel.item()


@pytest.mark.parametrize("n_img", [100, 128])
def test_pass2b_tile_writes_match_pallas_interpret(n_img):
    S = 384
    rng = np.random.default_rng(n_img)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (B, h, S, HD)).astype(np.float32) * 0.3).bfloat16()
        for h in (H, KV, KV))
    lengths = [S, 300]
    valid = torch.arange(S)[None, :] < torch.tensor(lengths)[:, None]
    _, lse = pass1(q, k, v, valid)
    probs = pass2b(q, k, lse, valid, n_img)
    _, want = jfa.flash_attention_with_capture(
        *(jnp.asarray(_heads(t).numpy()) for t in (q, k, v)),
        jnp.asarray(lengths, jnp.int32), IMG_START, n_img, interpret=True)
    want = np.asarray(want)
    for b, L in enumerate(lengths):
        np.testing.assert_allclose(probs[b, :, :L].numpy(), want[b, :, :L],
                                   atol=RAW_ATOL)
    assert not probs[:, :, :IMG_START].any()


def test_raw_staged_tile_is_the_tma_swizzle_of_32_column_boxes():
    """The staged 64 x 64 f32 tile of pass 2b, element (r, c) at byte
    (c / 32) * 8192 + r * 128 + (((c % 32) / 4) ^ (r % 8)) * 16 + (c % 4) * 4,
    is what a TMA store of two 32-column boxes in the 128-byte swizzle
    reads: 16-byte chunk i of row r of box x at chunk i ^ (r % 8); and each
    thread's column pair (c even) stays inside one chunk."""
    rng = np.random.default_rng(0)
    tile = rng.standard_normal((64, 64)).astype(np.float32)
    smem = np.full(64 * 64, np.nan, np.float32)
    for r in range(64):
        for c in range(64):
            at = ((c // 32) * 8192 + r * 128 + ((((c % 32) // 4) ^ (r % 8))
                                                << 4) + (c % 4) * 4)
            assert at % 4 == 0 and np.isnan(smem[at // 4])
            smem[at // 4] = tile[r, c]
            if c % 2 == 0:
                assert (at + 4) // 16 == at // 16
    want = np.zeros((2, 64, 8, 4), np.float32)
    for x in range(2):
        for r in range(64):
            for i in range(8):
                want[x, r, i ^ (r % 8)] = tile[r, 32 * x + 4 * i:32 * x + 4 * i
                                                + 4]
    assert np.array_equal(smem.reshape(2, 64, 8, 4), want)


@pytest.mark.parametrize("M, m0", [(8, 0), (16, 0), (32, 0), (40, 0),
                                   (40, 32)],
                         ids=["8", "16", "32", "40-chunk0", "40-chunk1"])
def test_merge_matrix_staging_is_the_tma_swizzle(M, m0):
    """A chunk's mm^T (mp mask rows x 64 queries), read from the flat
    ``(64, M)`` rows of mm as the kernel's loop reads them (element i of
    the chunk's ``64 * w``: row i / w, column m0 + i % w, at row stride M)
    and written at c * 64 + ((r / 8) ^ (c % 8)) * 8 + r % 8, is the layout
    TMA's 128-byte swizzle gives a K-major tile: 16-byte chunk i of row c at
    chunk i ^ (c % 8); the rows past the chunk's width w stay zero."""
    (m0_, w, mp), = [c for c in mask_chunks(M) if c[0] == m0]
    rng = np.random.default_rng(M + m0)
    mm = rng.standard_normal((64, M)).astype(np.float32)
    flat = mm.reshape(-1)
    smem = np.zeros(mp * 64, np.float32)
    for i in range(64 * w):
        r, c = i // w, i % w
        smem[c * 64 + (((r >> 3) ^ (c & 7)) << 3) + (r & 7)] = flat[
            r * M + m0 + c]
    mt = np.zeros((mp, 64), np.float32)
    mt[:w] = mm[:, m0:m0 + w].T
    want = np.zeros((mp, 8, 8), np.float32)
    for c in range(mp):
        for i in range(8):
            want[c, i ^ (c % 8)] = mt[c, 8 * i:8 * i + 8]
    assert np.array_equal(smem.reshape(mp, 8, 8), want)
