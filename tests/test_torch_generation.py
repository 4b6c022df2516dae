"""The port's generation slice below the grounder API against the JAX package
on the CPU: KV-cache prefill / decode (flmm_tpu_torch.generation.decode vs
flmm_tpu.generation.decode), the decoder's ``logits``, prompt tokenisation,
noun chunks and the numpy anyres processor.

Same weights on both sides: JAX ``init_params`` -> numpy (norms and
attention biases perturbed, so that both are exercised) ->
``convert.from_jax``.  In f32 the prefill / decode captures and hidden
states agree within 1e-4, tokens and validity flags exactly (on the valid
prefix: the port ends its loop after a stop token); in bf16 within 2e-2 of
each tensor's largest magnitude (attention rows 5e-2), on the prefix of
equal tokens.  Ids, spans and
the anyres pixels are bit for bit.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from flmm_tpu.data import llava_next as jdata
from flmm_tpu.data import tokenization as jtok
from flmm_tpu.generation import decode as jdec
from flmm_tpu.generation import noun_chunks as jnc
from flmm_tpu.models.llm import decoder as jdecoder
from flmm_tpu_torch.configs import llava_next as torch_llava_next
from flmm_tpu_torch.convert.from_jax import from_jax
from flmm_tpu_torch.data import llava_next as data
from flmm_tpu_torch.data import tokenization as tok
from flmm_tpu_torch.generation import decode as dec
from flmm_tpu_torch.generation import noun_chunks as nc
from flmm_tpu_torch.models.llm import decoder
from tests.test_data import FakeTokenizer

TOL = 1e-4
BF16_TOL = 2e-2
# attention rows carry their logits' bf16 error through exp: a score of 8
# holds to about 0.03, which moves its probability by about 3%
BF16_ATTN_TOL = 5e-2
IMG_START, N_IMG = 2, 5
BASE = dict(vocab_size=64, hidden_size=32, num_layers=3, num_heads=4,
            num_kv_heads=4, head_dim=8, intermediate_size=64)
# decoder variants: multi-head, GQA (the tiny DeepSeek preset's 4 / 2),
# GQA 4 / 1 with q / k / v biases, Gemma's embedding scale, (1 + w)
# norms, tanh-GELU and tied embeddings, and Mixtral's MoE MLP (4 experts,
# the top 2 a token; tests/test_decode.py pins its decode in JAX)
VARIANTS = {
    "mha": {},
    "gqa": dict(num_kv_heads=2),
    "gqa_bias": dict(num_kv_heads=1, attn_bias=True),
    "gemma": dict(num_kv_heads=1, act="gelu_tanh", embed_scale=True,
                  gemma_norm=True, tie_embeddings=True),
    "moe": dict(num_kv_heads=2, num_experts=4, num_experts_per_tok=2),
}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def _close_bf16(got, want, tol=BF16_TOL):
    """bf16 against bf16: within ``tol`` of each tensor's largest magnitude
    (2e-2 is about 5 bf16 steps there; the JAX CPU compiler rounds some bf16
    intermediates at other points than PyTorch does)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=tol * np.abs(want).max(), rtol=tol)


def _setup(variant: str, seed: int = 1, dtype: str = "float32"):
    """(JAX config, port config, JAX params, port params) in ``dtype``."""
    kw = {**BASE, **VARIANTS[variant]}
    jcfg = jdecoder.DecoderConfig(dtype=getattr(jnp, dtype), **kw)
    tcfg = decoder.DecoderConfig(dtype=getattr(torch, dtype), **kw)
    params = jax.device_get(jdecoder.init_params(jcfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    layers = params["layers"]
    for name in ("ln1", "ln2"):
        layers[name] = (layers[name] + rng.normal(
            0, 0.1, layers[name].shape)).astype(layers[name].dtype)
    params["final_norm"] = (params["final_norm"] + rng.normal(
        0, 0.1, params["final_norm"].shape)).astype(params["final_norm"].dtype)
    for name in ("bq", "bk", "bv"):
        if name in layers:
            layers[name] = rng.normal(0, 0.1, layers[name].shape).astype(
                layers[name].dtype)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, params),
            from_jax(params))


def _masked_prompt(S: int, rng):
    """Anyres-style key mask (pads at 4:7, inside the image block at 2) and
    pad-skipping positions."""
    mask = np.ones((S,), bool)
    mask[4:7] = False
    return mask, np.maximum(np.cumsum(mask) - 1, 0).astype(np.int32)


def _run_both(variant, masked=False, stop=(), T=6, seed=0,
              dtype="float32"):
    jcfg, tcfg, jp, tp = _setup(variant, dtype=dtype)
    rng = np.random.default_rng(seed)
    S = 12
    prompt = rng.integers(0, BASE["vocab_size"], (S,)).astype(np.int32)
    lw = rng.random(BASE["num_layers"]).astype(np.float32)
    lw /= lw.sum()
    extra_j, extra_t = {}, {}
    if masked:
        mask, pos = _masked_prompt(S, rng)
        extra_j = dict(attn_mask=jnp.asarray(mask),
                       position_ids=jnp.asarray(pos))
        extra_t = dict(attn_mask=torch.from_numpy(mask),
                       position_ids=torch.from_numpy(pos))
    jemb = jdecoder.embed_tokens(jp, jcfg, jnp.asarray(prompt))
    jstate = jdec.prefill(jp, jcfg, jemb, IMG_START, N_IMG, T,
                          layer_weights=jnp.asarray(lw), **extra_j)
    jout = jdec.decode(jp, jcfg, jstate,
                       jdec.DecodeConfig(max_new_tokens=T,
                                         stop_token_ids=stop),
                       IMG_START, N_IMG, layer_weights=jnp.asarray(lw))
    with torch.no_grad():
        temb = decoder.embed_tokens(tp, tcfg,
                                    torch.from_numpy(prompt).long())
        tstate = dec.prefill(tp, tcfg, temb, IMG_START, N_IMG, T,
                             layer_weights=torch.from_numpy(lw), **extra_t)
        want_kv = {k: np.asarray(jstate[k]) for k in ("k_cache", "v_cache")}
        got_kv = {k: tstate[k].clone() for k in ("k_cache", "v_cache")}
        tout = dec.decode(tp, tcfg, tstate,
                          dec.DecodeConfig(max_new_tokens=T,
                                           stop_token_ids=stop),
                          IMG_START, N_IMG,
                          layer_weights=torch.from_numpy(lw))
    return (jax.device_get(jstate), jax.device_get(jout), tstate, tout,
            want_kv, got_kv)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked_pad"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_jax(variant, masked):
    jstate, jout, tstate, tout, want_kv, got_kv = _run_both(variant, masked)
    for key in ("attn", "hidden", "last_hidden"):
        assert tuple(tstate[key].shape) == jstate[key].shape, key
        _close(tstate[key], jstate[key])
    for key in ("k_cache", "v_cache"):
        assert tuple(got_kv[key].shape) == want_kv[key].shape
        _close(got_kv[key], want_kv[key])
    assert tstate["prompt_len"] == jstate["prompt_len"]
    assert tstate["next_position"] == int(jstate["next_position"])
    if masked:
        np.testing.assert_array_equal(tstate["key_valid"].numpy(),
                                      jstate["key_valid"])
    np.testing.assert_array_equal(tout["valid"].numpy(), jout["valid"])
    np.testing.assert_array_equal(tout["tokens"].numpy(), jout["tokens"])
    for key in ("attn", "hidden"):
        assert tuple(tout[key].shape) == jout[key].shape, key
        _close(tout[key], jout[key])


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked_pad"])
@pytest.mark.parametrize("variant", ["gqa", "gemma"])
def test_prefill_and_decode_match_jax_bf16(variant, masked):
    """The card's dtype: bf16 weights, activations and KV cache, where the
    rounding of the probabilities before the PV product counts.  Captures,
    hidden states and caches as ``_close_bf16``; tokens and the generated
    rows compared on the prefix where both packages emit the same tokens."""
    jstate, jout, tstate, tout, want_kv, got_kv = _run_both(
        variant, masked, T=8, dtype="bfloat16")
    assert tstate["k_cache"].dtype == torch.bfloat16
    _close_bf16(tstate["attn"], jstate["attn"], BF16_ATTN_TOL)
    for key in ("hidden", "last_hidden"):
        _close_bf16(tstate[key], jstate[key])
    for key in ("k_cache", "v_cache"):
        _close_bf16(got_kv[key], want_kv[key])
    got, want = tout["tokens"].numpy(), np.asarray(jout["tokens"])
    n = int(np.argmin(np.append(got == want, False)))
    assert n >= 1, (got, want)
    np.testing.assert_array_equal(tout["valid"].numpy()[:n],
                                  np.asarray(jout["valid"])[:n])
    _close_bf16(tout["attn"][:n], np.asarray(jout["attn"])[:n],
                BF16_ATTN_TOL)
    _close_bf16(tout["hidden"][:n], np.asarray(jout["hidden"])[:n])


@pytest.mark.parametrize("variant", ["gqa", "gemma", "moe"])
def test_stop_token_validity_matches_jax(variant):
    """The stop token itself is valid and every later step is not; on the
    valid prefix the port gives JAX's tokens, captures and hidden states."""
    *_, jout, _, tout, _, _ = _run_both(variant, T=8)
    toks = np.asarray(jout["tokens"])
    stop = int(toks[2])
    *_, jout, _, tout, _, _ = _run_both(variant, stop=(stop,), T=8)
    valid = np.asarray(jout["valid"])
    np.testing.assert_array_equal(tout["valid"].numpy(), valid)
    first = int(np.argmax(toks == stop))
    assert valid[:first + 1].all() and not valid[first + 1:].any()
    n = int(valid.sum())
    np.testing.assert_array_equal(tout["tokens"].numpy()[:n],
                                  np.asarray(jout["tokens"])[:n])
    for key in ("attn", "hidden"):
        _close(tout[key][:n], np.asarray(jout[key])[:n])
        assert not tout[key][n:].any()


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked_pad"])
def test_decode_matches_full_forward(masked):
    """Each decoded token is the argmax of the port's full forward over the
    grown sequence, and the captured rows are that forward's raw
    attention rows."""
    _decode_vs_full_forward("gqa", masked)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked_pad"])
def test_moe_decode_matches_full_forward(masked):
    """The same with Mixtral's MoE MLP, which the decode step reaches
    through ``mlp_residual`` (tests/test_decode.py pins it in JAX)."""
    _decode_vs_full_forward("moe", masked)


def _decode_vs_full_forward(variant: str, masked: bool) -> None:
    _, cfg, _, params = _setup(variant)
    rng = np.random.default_rng(3)
    S, T = 12, 5
    prompt = rng.integers(0, BASE["vocab_size"], (S,)).tolist()
    mask = np.ones((S,), bool)
    extra = {}
    if masked:
        mask, pos = _masked_prompt(S, rng)
        extra = dict(attn_mask=torch.from_numpy(mask),
                     position_ids=torch.from_numpy(pos))

    def full(seq, m):
        am = torch.as_tensor(m)[None]
        pos = (torch.clamp(am.cumsum(1) - 1, min=0) if masked else None)
        return decoder.forward_capture(
            params, cfg,
            decoder.embed_tokens(params, cfg, torch.tensor(seq))[None], am,
            IMG_START, N_IMG, position_ids=pos)

    with torch.no_grad():
        emb = decoder.embed_tokens(params, cfg, torch.tensor(prompt))
        state = dec.prefill(params, cfg, emb, IMG_START, N_IMG, T, **extra)
        out = dec.decode(params, cfg, state, dec.DecodeConfig(T), IMG_START,
                         N_IMG)
        seq, m = list(prompt), list(mask)
        for t in range(T):
            nxt = int(decoder.logits(params, cfg,
                                     full(seq, m)["last_hidden"])[0, -1]
                      .argmax())
            assert int(out["tokens"][t]) == nxt, (t, out["tokens"], nxt)
            seq.append(nxt)
            m.append(True)
        want = full(seq, m)["attn"][0][:, :, S:]  # (L, H, T, n)
    torch.testing.assert_close(out["attn"].permute(1, 2, 0, 3), want,
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("variant", ["gqa", "gemma"])
def test_logits_match_jax(variant):
    jcfg, tcfg, jp, tp = _setup(variant)
    x = np.random.default_rng(0).normal(size=(3, BASE["hidden_size"])
                                        ).astype(np.float32)
    want = jdecoder.logits(jp, jcfg, jnp.asarray(x))
    _close(decoder.logits(tp, tcfg, torch.from_numpy(x)), want, 1e-5)


# -- tokenisation, noun chunks, anyres pixels --------------------------------

CAPTION = [{"utterance": "a dog", "has_mask": True},
           {"utterance": "runs on", "has_mask": False},
           {"utterance": "green grass", "has_mask": True}]


@pytest.mark.parametrize("template", sorted(jtok.TEMPLATES))
def test_tokenization_matches_jax(template):
    t = FakeTokenizer()
    assert tok.TEMPLATES[template] == jtok.TEMPLATES[template]
    tpl = tok.TEMPLATES[template]
    for system in (None, "be brief"):
        prompt = "<image_placeholder>" * 6 + " describe the image"
        got = tok.PromptSpec(tpl, prompt, system=system)
        want = jtok.PromptSpec(jtok.TEMPLATES[template], prompt,
                               system=system)
        assert got.render() == want.render()
        ids = tok.encode_prompt(t, got)
        assert ids == jtok.encode_prompt(t, want)
        assert tok.find_image_block(ids, 5) == jtok.find_image_block(ids, 5)
    for image_token, image_id in (("<image_placeholder>", None),
                                  ("<image>", None), ("<image>", 0)):
        args = (t, tpl, image_token + " what is it?", image_token, 7,
                image_id)
        got = tok.encode_multimodal_prompt(*args)
        want = jtok.encode_multimodal_prompt(*args)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (tok.caption_stream(t, CAPTION, 4)
            == jtok.caption_stream(t, CAPTION, 4))
    with pytest.raises(ValueError):
        tok.find_image_block([1, 5, 2, 5], 5)


SENTENCES = (
    "A small brown dog is sitting on the red sofa next to two old books.",
    "The image shows a man wearing a blue hat while holding an umbrella.",
    "It is a picture of the left side of a tall building.",
    "",
    "yes",
    "Three cats and a dog, with their owner's bicycle in the background.",
)


class _WordTokenizer:
    """One id per whitespace word; decode joins the words again."""

    def __init__(self, text):
        self.words = text.split()

    def decode(self, ids):
        return " ".join(self.words[i] for i in ids)


@pytest.mark.parametrize("text", SENTENCES)
def test_noun_chunks_match_jax(text):
    got = nc.noun_chunks(text)
    assert got == jnc.noun_chunks(text)
    assert nc._heuristic_chunks(text) == jnc._heuristic_chunks(text)
    t = _WordTokenizer(text)
    ids = list(range(len(t.words)))
    for s, e, phrase in got + [(0, 3, ""), (5, 400, "")]:
        span = nc.char_span_to_token_span(t, ids, (s, e))
        assert span == jnc.char_span_to_token_span(t, ids, (s, e))
        if phrase and span:
            assert phrase in t.decode(ids[span[0]:span[1]])


@pytest.mark.parametrize("spec,hw", [
    ("tiny", (60, 90)), ("tiny", (40, 23)), ("tiny", (64, 64)),
    ("full", (480, 640)), ("full", (333, 500)), ("full", (900, 280)),
])
def test_anyres_process_matches_jax(spec, hw):
    if spec == "tiny":
        tspec = torch_llava_next.tiny_anyres_spec()
        jspec = jdata.AnyresSpec(tile_size=tspec.tile_size,
                                 patch_size=tspec.patch_size,
                                 pinpoints=tspec.pinpoints)
    else:
        tspec, jspec = data.AnyresSpec(), jdata.AnyresSpec()
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), np.uint8)
    got = data.anyres_process(img, tspec)
    want = jdata.anyres_process(Image.fromarray(img), jspec)
    assert set(got) == set(want)
    for key in ("grid", "fine_hw", "fine_pad", "orig_hw"):
        assert tuple(got[key]) == tuple(want[key]), key
    for key in ("base", "tiles"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError):
        data.anyres_process(img.astype(np.float32), tspec)
