"""Llama-family frozen decoder with per-layer text->image attention capture
(flmm_tpu/models/llm/decoder.py), eager path.

Each layer computes its attention probabilities in f32, slices the image-key
columns ``[img_start, img_start + n_img)`` and merges them per mask (mean:
one product with the ``(S, M)`` merge matrix; max: a masked reduction), so
only ``(B, L, H, M, n_img)`` survives.  The layer-weighted hidden sum takes
its last term after the final norm, as the reference's
``hidden_states[-L:]`` does.

When ``flash_capture_ok`` (the JAX gate: mean merge, ``S`` and ``img_start``
multiples of 128), each layer runs the flash-capture kernel K5
(ops/flash_attention.py) instead, and no ``(B, 1, S, S)`` bias or ``S x S``
probabilities exist.

A config with ``num_experts`` runs Mixtral's sparse-MoE MLP as the JAX
package computes it: every expert densely, each token's output the sum of
the experts' weighted by a softmax over the router logits at or above its
k-th largest.

Not ported yet: int8 weights.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from flmm_tpu_torch.ops._matmul import matmul_f32
from flmm_tpu_torch.ops.flash_attention import flash_attention_with_merged_capture


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    act: str = "silu"  # 'silu' | 'gelu_tanh' (gemma)
    embed_scale: bool = False
    gemma_norm: bool = False
    attn_bias: bool = False
    tie_embeddings: bool = False
    num_experts: int = 0
    num_experts_per_tok: int = 2
    use_flash_capture: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def init_params(cfg: DecoderConfig, generator: torch.Generator,
                device) -> dict:
    d, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def norm_init(shape):
        return torch.full(shape, 0.0 if cfg.gemma_norm else 1.0,
                          dtype=cfg.dtype, device=device)

    def w(shape, fan_in):
        # one layer slice at a time bounds the f32 transient
        out = torch.empty(shape, dtype=cfg.dtype, device=device)
        for i in range(shape[0] if len(shape) > 2 else 1):
            sl = out[i] if len(shape) > 2 else out
            sl.copy_(torch.randn(sl.shape, generator=generator,
                                 device=device) / math.sqrt(fan_in))
        return out

    # MoE: a router (L, d, E) and expert stacks (L, E, d, f), (L, E, f, d)
    E = (cfg.num_experts,) if cfg.num_experts else ()
    layers = {
        "ln1": norm_init((L, d)),
        "ln2": norm_init((L, d)),
        "wq": w((L, d, cfg.q_dim), d),
        "wk": w((L, d, cfg.kv_dim), d),
        "wv": w((L, d, cfg.kv_dim), d),
        "wo": w((L, cfg.q_dim, d), cfg.q_dim),
        "w_gate": w((L, *E, d, f), d),
        "w_up": w((L, *E, d, f), d),
        "w_down": w((L, *E, f, d), f),
    }
    if E:
        layers["router"] = w((L, d, *E), d)
    params = {
        "embed": w((cfg.vocab_size, d), d),
        "layers": layers,
        "final_norm": norm_init((d,)),
    }
    if cfg.attn_bias:
        for name, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                        ("bv", cfg.kv_dim)):
            layers[name] = torch.zeros((L, n), dtype=cfg.dtype, device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = w((d, cfg.vocab_size), d)
    return params


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             gemma: bool) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    scale = (1.0 + w.float()) if gemma else w.float()
    return (xf * scale).to(dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin ``(..., S, head_dim)`` f32, HF non-interleaved convention."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, half, dtype=torch.float32, device=positions.device) / half))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: ``(B, S, H, hd)``; cos/sin: ``(B, S, hd)`` or ``(S, hd)``."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return x * cos + rotated * sin


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def project_qkv(lp: dict, cfg: DecoderConfig, h: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor) -> tuple:
    """The attention inputs of one layer from its residual stream ``h``
    ``(B, S, D)``: LN1, the q / k / v products (and biases), RoPE on q and
    k; ``(B, S, H, hd)``, ``(B, S, KV, hd)``, ``(B, S, KV, hd)``."""
    B, S, _ = h.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = rms_norm(h, lp["ln1"], cfg.rms_eps, cfg.gemma_norm)
    q, k, v = x @ lp["wq"], x @ lp["wk"], x @ lp["wv"]
    if cfg.attn_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = apply_rope(q.reshape(B, S, H, hd), cos, sin)
    k = apply_rope(k.reshape(B, S, KV, hd), cos, sin)
    return q, k, v.reshape(B, S, KV, hd)


def moe_gates(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mixtral's router: a softmax over the logits at or above each row's
    k-th largest (f32).  The threshold keeps every expert tied with the
    k-th, as the JAX package does; ``torch.topk`` indices would keep k."""
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.softmax(
        torch.where(logits >= thresh, logits, float("-inf")), dim=-1)


def mlp(x2: torch.Tensor, lp: dict, cfg: DecoderConfig) -> torch.Tensor:
    """The gated MLP of ``x2`` ``(B, S, d)``, or with ``num_experts`` the
    sparse MoE computed densely: every expert over every token, the outputs
    summed with the router's gates (zero past the top k)."""
    if not cfg.num_experts:
        return (_act(x2 @ lp["w_gate"], cfg.act)
                * (x2 @ lp["w_up"])) @ lp["w_down"]
    # the gates in x2's dtype, their weighted sum accumulated in f32 and
    # rounded once, as the JAX einsum over the expert axis
    gates = moe_gates((x2 @ lp["router"]).float(),
                      cfg.num_experts_per_tok).to(x2.dtype).float()
    out = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
    for e in range(cfg.num_experts):
        h = _act(x2 @ lp["w_gate"][e], cfg.act) * (x2 @ lp["w_up"][e])
        out = out + (h @ lp["w_down"][e]).float() * gates[..., e:e + 1]
    return out.to(x2.dtype)


def mlp_residual(h: torch.Tensor, lp: dict, cfg: DecoderConfig
                 ) -> torch.Tensor:
    """``h`` plus the (gated or MoE) MLP of its LN2."""
    x2 = rms_norm(h, lp["ln2"], cfg.rms_eps, cfg.gemma_norm)
    return h + mlp(x2, lp, cfg)


def layer_step(lp: dict, w_l, h: torch.Tensor, acc: torch.Tensor, aux: dict,
               cfg: DecoderConfig, img_start: int, n_img: int, merge: str,
               flash_ok: bool = False, kv: tuple | None = None):
    """One decoder layer with fused attention capture; returns
    ``(h, acc, side)`` where ``side`` is the merged ``(B, H, M, n_img)``
    capture, or the raw ``(B, H, S, n_img)`` one without a merge matrix.
    ``flash_ok`` routes attention and the (mean) capture through K5.
    ``kv``: this layer's ``(B, S_tot, KV, hd)`` key and value caches, whose
    first ``S`` rows take its keys and values (the generation prefill)."""
    B, S, _ = h.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    merge_matrix = aux.get("merge_matrix")

    q, k, v = project_qkv(lp, cfg, h, aux["cos"], aux["sin"])
    if kv is not None:
        kv[0][:, :S] = k
        kv[1][:, :S] = v
    if flash_ok:
        # K5 reads the kv head h // (H // KV) itself: no repeated k / v
        out4, side = flash_attention_with_merged_capture(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            aux["valid"], merge_matrix, img_start, n_img)
        out = out4.transpose(1, 2).reshape(B, S, H * hd).to(cfg.dtype)
    else:
        if KV != H:
            k = k.repeat_interleave(H // KV, dim=2)
            v = v.repeat_interleave(H // KV, dim=2)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        logits = matmul_f32(q, k.transpose(-1, -2)) * scale \
            + aux["bias"]
        probs = torch.softmax(logits, dim=-1)  # f32
        out = (probs.to(cfg.dtype) @ v).transpose(1, 2).reshape(B, S, H * hd)
    h = mlp_residual(h + out @ lp["wo"], lp, cfg)

    # the layer weights' only gradient path (the JAX stop_gradient)
    acc = acc + w_l * h.detach().float()
    if flash_ok:
        return h, acc, side
    img_probs = probs[..., img_start:img_start + n_img]  # (B, H, S, n_img)
    if merge_matrix is None:
        side = img_probs
    elif merge == "mean":
        side = torch.einsum("bhsn,bsm->bhmn", img_probs, merge_matrix.float())
    elif merge == "max":
        big_neg = torch.finfo(torch.float32).min
        member = merge_matrix > 0  # (B, S, M)
        masked = torch.where(member[:, None, :, :, None],
                             img_probs[:, :, :, None, :], big_neg)
        side = masked.amax(dim=2)
        side = torch.where(side <= big_neg / 2, 0.0, side)
    else:
        raise ValueError(merge)
    return h, acc, side


def capture_aux(cfg: DecoderConfig, attention_mask: torch.Tensor,
                position_ids: torch.Tensor | None, seq_len: int,
                merge_matrix: torch.Tensor | None,
                with_bias: bool = True) -> dict:
    """RoPE tables, the ``(B, S)`` bool key validity and (``with_bias``) the
    ``(B, 1, S, S)`` f32 causal + padding bias (finfo min where masked) the
    layers consume; the flash path needs no bias."""
    device = attention_mask.device
    positions = (torch.arange(seq_len, device=device)[None]
                 if position_ids is None else position_ids)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    valid = attention_mask.bool()
    aux = {"cos": cos, "sin": sin, "valid": valid}
    if with_bias:
        causal = torch.ones((seq_len, seq_len), dtype=torch.bool,
                            device=device).tril()
        allow = causal[None] & valid[:, None, :]
        aux["bias"] = torch.where(allow, 0.0,
                                  torch.finfo(torch.float32).min)[:, None]
    if merge_matrix is not None:
        aux["merge_matrix"] = merge_matrix
    return aux


def flash_capture_ok(cfg: DecoderConfig, merge_matrix, merge: str,
                     seq_len: int, img_start: int, n_img: int) -> bool:
    return bool(
        cfg.use_flash_capture and merge_matrix is not None
        and merge == "mean" and seq_len % 128 == 0 and img_start % 128 == 0
        and img_start + ((n_img + 127) // 128) * 128 <= seq_len
    )


def forward_capture(params: dict, cfg: DecoderConfig,
                    inputs_embeds: torch.Tensor,
                    attention_mask: torch.Tensor, img_start: int, n_img: int,
                    merge_matrix: torch.Tensor | None = None,
                    merge: str = "mean",
                    layer_weights: torch.Tensor | None = None,
                    position_ids: torch.Tensor | None = None,
                    kv_cache: tuple | None = None) -> dict:
    """Run the frozen decoder, capturing merged text->image attention.

    Returns ``attn`` (``(B, L, H, M, n_img)`` merged, or raw without a merge
    matrix), ``hidden`` (``(B, S, D)`` f32 layer-weighted sum) and
    ``last_hidden`` (post final norm).  ``kv_cache``: ``(k, v)`` caches
    ``(L, B, S_tot, KV, hd)`` whose first ``S`` rows of each layer take its
    keys and values.
    """
    B, S, D = inputs_embeds.shape
    L = cfg.num_layers
    flash_ok = flash_capture_ok(cfg, merge_matrix, merge, S, img_start, n_img)
    h = inputs_embeds.to(cfg.dtype)
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.hidden_size), dtype=cfg.dtype)
    aux = capture_aux(cfg, attention_mask, position_ids, S, merge_matrix,
                      with_bias=not flash_ok)
    if layer_weights is None:
        layer_weights = torch.zeros((L,), dtype=torch.float32,
                                    device=h.device)
    acc = torch.zeros((B, S, D), dtype=torch.float32, device=h.device)
    sides = []
    for i in range(L):
        lp = {k: v[i] for k, v in params["layers"].items()}
        w_l = layer_weights[i] if i < L - 1 else 0.0
        kv = None if kv_cache is None else (kv_cache[0][i], kv_cache[1][i])
        h, acc, side = layer_step(lp, w_l, h, acc, aux, cfg, img_start,
                                  n_img, merge, flash_ok, kv)
        sides.append(side)
    last_hidden = rms_norm(h, params["final_norm"], cfg.rms_eps,
                           cfg.gemma_norm)
    hidden = acc + layer_weights[L - 1] * last_hidden.detach().float()
    return {"attn": torch.stack(sides, dim=1), "hidden": hidden,
            "last_hidden": last_hidden}


def logits(params: dict, cfg: DecoderConfig,
           last_hidden: torch.Tensor) -> torch.Tensor:
    """Next-token logits of post-final-norm states: the tied embedding's
    transpose, else ``lm_head``."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return last_hidden @ head


def embed_tokens(params: dict, cfg: DecoderConfig,
                 ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][ids]
