"""Greedy KV-cache decoding with per-step attention / hidden capture
(flmm_tpu/generation/decode.py).

``prefill`` runs the prompt through the decoder's plain capture path
(``forward_capture`` without a merge matrix: f32 scores, the raw
``(L, H, S, n_img)`` text->image rows) and fills the first ``S`` rows of a
KV cache pre-allocated to ``S + max_new_tokens``.  ``decode`` then feeds
one token at a time; each step's side outputs are the ``(L, H, n_img)``
image-attention rows of the fed token and its layer-weighted hidden state.

As in the JAX package: masked scores take ``finfo(float32).min`` (a wholly
masked row cannot give NaN), the probabilities are rounded to the model
dtype before the PV product, the last layer's term of the hidden sum is the
post-final-norm state, and the stop token itself is emitted as valid.  Two
choices of this port: a step attends to the ``pos + 1`` filled cache rows
only (the masked rows beyond give exactly 0), and the loop ends after the
step that emits a stop token; the rows after it are marked invalid, with
token 0 and zero capture.  ``decode`` writes its keys and values into the
state's caches in place.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from flmm_tpu_torch.models.llm import decoder as llm
from flmm_tpu_torch.ops._matmul import matmul_f32
from flmm_tpu_torch.ops.quant import dense


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    max_new_tokens: int = 64
    stop_token_ids: tuple = ()


def _default_weights(cfg: llm.DecoderConfig, device) -> torch.Tensor:
    L = cfg.num_layers
    return torch.full((L,), 1.0 / L, dtype=torch.float32, device=device)


def _layer_step(lp: dict, cfg: llm.DecoderConfig, h: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int,
                cos: torch.Tensor, sin: torch.Tensor, img_start: int,
                n_img: int, key_valid: torch.Tensor | None = None):
    """One decoder layer for one new token at cache row ``pos`` (``h``:
    ``(1, 1, D)``; caches ``(S_tot, KV, hd)``); returns ``h`` and the
    ``(H, n_img)`` image-attention rows."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = llm.project_qkv(lp, cfg, h, cos, sin)
    k_cache[pos] = k[0, 0]
    v_cache[pos] = v[0, 0]
    # head j reads kv head j // (H // KV), as the JAX repeat of K and V
    kk, vv = k_cache[:pos + 1], v_cache[:pos + 1]  # (P, KV, hd)
    qg = q[0, 0].reshape(KV, H // KV, hd)
    logits = matmul_f32(qg, kk.permute(1, 2, 0)) / math.sqrt(hd)
    if key_valid is not None:  # anyres: masked pads inside the prompt
        logits = torch.where(key_valid[:pos + 1], logits,
                             torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)  # (KV, H // KV, P) f32
    out = probs.to(h.dtype) @ vv.permute(1, 0, 2)  # (KV, H // KV, hd)
    h = llm.mlp_residual(h + dense(out.reshape(1, 1, H * hd), lp, "wo"), lp,
                         cfg)
    return h, probs.reshape(H, pos + 1)[:, img_start:img_start + n_img]


def prefill(params: dict, cfg: llm.DecoderConfig, embeds: torch.Tensor,
            img_start: int, n_img: int, max_new_tokens: int,
            layer_weights: torch.Tensor | None = None,
            attn_mask: torch.Tensor | None = None,
            position_ids: torch.Tensor | None = None) -> dict:
    """Run the prompt, building the KV cache.

    Args:
      embeds: ``(S, D)`` prompt embeddings.
      attn_mask: optional ``(S,)`` bool; False marks masked pad slots inside
        the packed prompt (the anyres image-block padding), whose keys every
        query skips, here and in ``decode``.
      position_ids: optional ``(S,)`` RoPE positions (pads skipped).

    Returns 'k_cache' / 'v_cache' ``(L, S + max_new, KV, hd)``,
    'last_hidden' ``(D,)`` (post final norm), 'attn' ``(L, H, S, n_img)``
    f32 prompt rows, 'hidden' ``(S, D)`` f32 layer-weighted states,
    'prompt_len', 'next_position' (the RoPE position of the first generated
    token) and, with ``attn_mask``, 'key_valid' ``(S + max_new,)``.
    """
    S, _ = embeds.shape
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    device = embeds.device
    if layer_weights is None:
        layer_weights = _default_weights(cfg, device)
    mask = (torch.ones((S,), dtype=torch.bool, device=device)
            if attn_mask is None else attn_mask.bool())
    k_cache, v_cache = (torch.zeros((L, 1, S + max_new_tokens, KV, hd),
                                    dtype=cfg.dtype, device=device)
                        for _ in range(2))
    out = llm.forward_capture(
        params, cfg, embeds[None], mask[None], img_start, n_img,
        layer_weights=layer_weights,
        position_ids=None if position_ids is None else position_ids[None],
        kv_cache=(k_cache, v_cache))
    state = {
        "k_cache": k_cache[:, 0], "v_cache": v_cache[:, 0],
        "last_hidden": out["last_hidden"][0, -1],
        "attn": out["attn"][0], "hidden": out["hidden"][0],
        "prompt_len": S,
        "next_position": (S if position_ids is None
                          else int(position_ids[-1]) + 1),
    }
    if attn_mask is not None:
        state["key_valid"] = torch.cat([
            mask, torch.ones((max_new_tokens,), dtype=torch.bool,
                             device=device)])
    return state


def decode(params: dict, cfg: llm.DecoderConfig, state: dict,
           dcfg: DecodeConfig, img_start: int, n_img: int,
           layer_weights: torch.Tensor | None = None) -> dict:
    """Greedy decode with per-step capture.

    Returns 'tokens' ``(T,)`` int32, 'valid' ``(T,)`` bool (False after a
    stop token was emitted; the stop token itself is valid), 'attn'
    ``(T, L, H, n_img)`` f32 and 'hidden' ``(T, D)`` f32.
    """
    L, H, D = cfg.num_layers, cfg.num_heads, cfg.hidden_size
    T = dcfg.max_new_tokens
    device = state["last_hidden"].device
    if layer_weights is None:
        layer_weights = _default_weights(cfg, device)
    stop_ids = set(dcfg.stop_token_ids)
    key_valid = state.get("key_valid")
    layers = [{k: v[i] for k, v in params["layers"].items()}
              for i in range(L)]
    positions = state["next_position"] + torch.arange(T, device=device)
    cos_all, sin_all = llm.rope_tables(positions, cfg.head_dim,
                                       cfg.rope_theta)
    scale = (torch.tensor(math.sqrt(D), dtype=cfg.dtype)
             if cfg.embed_scale else None)

    tokens = torch.zeros((T,), dtype=torch.int32, device=device)
    valid = torch.zeros((T,), dtype=torch.bool)
    attn = torch.zeros((T, L, H, n_img), dtype=torch.float32, device=device)
    hidden = torch.zeros((T, D), dtype=torch.float32, device=device)
    token = llm.logits(params, cfg, state["last_hidden"]).argmax()
    for t in range(T):
        pos = state["prompt_len"] + t
        tokens[t] = token
        valid[t] = True
        h = params["embed"][token].reshape(1, 1, D).to(cfg.dtype)
        if scale is not None:
            h = h * scale
        cos, sin = cos_all[t:t + 1], sin_all[t:t + 1]
        acc = torch.zeros((D,), dtype=torch.float32, device=device)
        for i, lp in enumerate(layers):
            h, attn[t, i] = _layer_step(
                lp, cfg, h, state["k_cache"][i], state["v_cache"][i], pos,
                cos, sin, img_start, n_img, key_valid)
            if i < L - 1:
                acc = acc + layer_weights[i] * h[0, 0].float()
        last = llm.rms_norm(h[0, 0], params["final_norm"], cfg.rms_eps,
                            cfg.gemma_norm)
        hidden[t] = acc + layer_weights[L - 1] * last.float()
        if stop_ids and int(token) in stop_ids:
            break
        token = llm.logits(params, cfg, last).argmax()
    return {"tokens": tokens, "valid": valid.to(device), "attn": attn,
            "hidden": hidden}
