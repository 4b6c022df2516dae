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

With ``<name>_q`` / ``<name>_s`` in place of a projection's weight
(:func:`quantize_params`), that product takes the W8A8 int8 path of
ops/quant.py.

``forward_capture(..., seq_axis=...)`` splits the sequence over a mesh axis
(parallel/sequence.py): each rank runs its own rows, the keys and values
are gathered, and K5 runs on the rank's query rows.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from flmm_tpu_torch import trace
from flmm_tpu_torch.ops._matmul import matmul_f32
from flmm_tpu_torch.ops.flash_attention import flash_attention_with_merged_capture
from flmm_tpu_torch.ops.quant import dense, quantize_weight
from flmm_tpu_torch.parallel import frozen as shard
from flmm_tpu_torch.parallel import sequence
from flmm_tpu_torch.parallel.mesh import all_gather_cat, all_reduce

# the layer projections quantize_params turns to int8 where they are 3-D
QUANT_NAMES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


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
    q, k, v = dense(x, lp, "wq"), dense(x, lp, "wk"), dense(x, lp, "wv")
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


def mlp(x2: torch.Tensor, lp: dict, cfg: DecoderConfig,
        tp=None) -> torch.Tensor:
    """The gated MLP of ``x2`` ``(B, S, d)``, or with ``num_experts`` the
    sparse MoE computed densely: every expert over every token, the outputs
    summed with the router's gates (zero past the top k).  ``tp``: the
    model axis of a tensor-parallel layer (this rank's FFN columns, or its
    block of the experts), whose partial sums are summed over it."""
    if not cfg.num_experts:
        h = _act(dense(x2, lp, "w_gate"), cfg.act) * dense(x2, lp, "w_up")
        if tp is not None:
            return shard.row_product(h, lp["w_down"], tp, x2.dtype)
        return dense(h, lp, "w_down")
    # the gates in x2's dtype, their weighted sum accumulated in f32 and
    # rounded once, as the JAX einsum over the expert axis
    gates = moe_gates((x2 @ lp["router"]).float(),
                      cfg.num_experts_per_tok).to(x2.dtype).float()
    n_local = lp["w_gate"].shape[0]
    first = 0 if tp is None else tp.index * n_local
    out = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
    for i in range(n_local):
        e = first + i
        h = _act(x2 @ lp["w_gate"][i], cfg.act) * (x2 @ lp["w_up"][i])
        out = out + (h @ lp["w_down"][i]).float() * gates[..., e:e + 1]
    if tp is not None:
        all_reduce(out, tp.group)
    return out.to(x2.dtype)


def mlp_residual(h: torch.Tensor, lp: dict, cfg: DecoderConfig,
                 tp=None) -> torch.Tensor:
    """``h`` plus the (gated or MoE) MLP of its LN2."""
    x2 = rms_norm(h, lp["ln2"], cfg.rms_eps, cfg.gemma_norm)
    return h + mlp(x2, lp, cfg, tp)


def layer_step(lp: dict, w_l, h: torch.Tensor, acc: torch.Tensor, aux: dict,
               cfg: DecoderConfig, img_start: int, n_img: int, merge: str,
               flash_ok: bool = False, kv: tuple | None = None, tp=None,
               seq: sequence.RowShard | None = None):
    """One decoder layer with fused attention capture; returns
    ``(h, acc, side)`` where ``side`` is the merged ``(B, H, M, n_img)``
    capture, or the raw ``(B, H, S, n_img)`` one without a merge matrix.
    ``flash_ok`` routes attention and the (mean) capture through K5.
    ``kv``: this layer's ``(B, S_tot, KV, hd)`` key and value caches, whose
    first ``S`` rows take its keys and values (the generation prefill).
    ``tp``: the model axis of a tensor-parallel layer; ``cfg`` and ``lp``
    are then this rank's heads and columns (parallel/frozen.py).
    ``seq``: this rank's rows of a sequence split (``h``, ``acc`` and
    ``aux`` hold those rows, ``aux["valid"]`` all keys); the keys and
    values are gathered after RoPE, and ``side`` is this rank's part,
    which ``sequence.finish_capture`` completes: the merged partial sum,
    the masked maximum without the empty mask's 0, or the raw rows."""
    B, S, _ = h.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    merge_matrix = aux.get("merge_matrix")

    q, k, v = project_qkv(lp, cfg, h, aux["cos"], aux["sin"])
    if kv is not None:
        kv[0][:, :S] = k
        kv[1][:, :S] = v
    if seq is not None:
        k, v = sequence.gather_rows(k, 1, seq), sequence.gather_rows(v, 1, seq)
    if flash_ok:
        # K5 reads the kv head h // (H // KV) itself: no repeated k / v
        out4, side = flash_attention_with_merged_capture(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            aux["valid"], merge_matrix, img_start, n_img,
            q_offset=0 if seq is None else seq.start)
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
    proj = (dense(out, lp, "wo") if tp is None
            else shard.row_product(out, lp["wo"], tp, h.dtype))
    h = mlp_residual(h + proj, lp, cfg, tp)

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
        if seq is None:  # else after the ranks' maxima are reduced
            side = torch.where(side <= big_neg / 2, 0.0, side)
    else:
        raise ValueError(merge)
    return h, acc, side


def capture_aux(cfg: DecoderConfig, attention_mask: torch.Tensor,
                position_ids: torch.Tensor | None, seq_len: int,
                merge_matrix: torch.Tensor | None,
                with_bias: bool = True, rows: slice | None = None) -> dict:
    """RoPE tables, the ``(B, S)`` bool key validity and (``with_bias``) the
    ``(B, 1, S, S)`` f32 causal + padding bias (finfo min where masked) the
    layers consume; the flash path needs no bias.  ``rows``: the query
    rows of a sequence split, whose RoPE tables (at their global
    positions), bias rows and merge-matrix rows are kept; the key validity
    stays whole."""
    device = attention_mask.device
    rows = slice(0, seq_len) if rows is None else rows
    positions = (torch.arange(rows.start, rows.stop, device=device)[None]
                 if position_ids is None else position_ids[:, rows])
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    valid = attention_mask.bool()
    aux = {"cos": cos, "sin": sin, "valid": valid}
    if with_bias:
        q_pos = torch.arange(rows.start, rows.stop, device=device)
        causal = q_pos[:, None] >= torch.arange(seq_len, device=device)[None]
        allow = causal[None] & valid[:, None, :]
        aux["bias"] = torch.where(allow, 0.0,
                                  torch.finfo(torch.float32).min)[:, None]
    if merge_matrix is not None:
        aux["merge_matrix"] = merge_matrix[:, rows]
    return aux


def flash_capture_ok(cfg: DecoderConfig, merge_matrix, merge: str,
                     seq_len: int, img_start: int, n_img: int) -> bool:
    return bool(
        cfg.use_flash_capture and merge_matrix is not None
        and merge == "mean" and seq_len % 128 == 0 and img_start % 128 == 0
        and img_start + ((n_img + 127) // 128) * 128 <= seq_len
    )


@trace.spanned("capture")
def forward_capture(params: dict, cfg: DecoderConfig,
                    inputs_embeds: torch.Tensor,
                    attention_mask: torch.Tensor, img_start: int, n_img: int,
                    merge_matrix: torch.Tensor | None = None,
                    merge: str = "mean",
                    layer_weights: torch.Tensor | None = None,
                    position_ids: torch.Tensor | None = None,
                    kv_cache: tuple | None = None,
                    seq_axis=None) -> dict:
    """Run the frozen decoder, capturing merged text->image attention.

    Returns ``attn`` (``(B, L, H, M, n_img)`` merged, or raw without a merge
    matrix), ``hidden`` (``(B, S, D)`` f32 layer-weighted sum) and
    ``last_hidden`` (post final norm).  ``kv_cache``: ``(k, v)`` caches
    ``(L, B, S_tot, KV, hd)`` whose first ``S`` rows of each layer take its
    keys and values.  ``params`` may be a tp or fsdp shard
    (parallel/frozen.py): the capture comes back whole on every rank.
    ``seq_axis``: a mesh axis (``mesh.axis_of``) that splits the sequence
    (parallel/sequence.py): every rank passes the whole inputs, runs its
    rows and gets the whole outputs back.
    """
    B, S, D = inputs_embeds.shape
    L = cfg.num_layers
    tp = shard.tp_axis(params)
    if tp is not None:
        if kv_cache is not None:
            raise NotImplementedError("a KV cache under tensor parallelism")
        cfg = shard.local_decoder_config(cfg, tp)
    flash_ok = flash_capture_ok(cfg, merge_matrix, merge, S, img_start, n_img)
    seq = None
    if seq_axis is not None:
        if tp is not None:
            raise NotImplementedError(
                f"sequence sharding over {seq_axis.size} ranks of a tensor-"
                f"parallel tree (heads split over {tp.size})")
        if kv_cache is not None:
            raise NotImplementedError(
                f"a KV cache under sequence sharding (S = {S} over "
                f"{seq_axis.size} ranks)")
        seq = sequence.split_rows(S, seq_axis)
        if flash_ok and seq.chunk % 128:  # S is a multiple of 128 there
            raise ValueError(
                f"K5 under sequence sharding needs 128-row chunks: S = {S} "
                f"over {seq_axis.size} ranks gives chunks of {seq.chunk} "
                f"(rank {seq_axis.index}: rows {seq.start}-{seq.stop - 1})")
    rows = slice(0, S) if seq is None else seq.rows
    h = inputs_embeds[:, rows].to(cfg.dtype)
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.hidden_size), dtype=cfg.dtype)
    aux = capture_aux(cfg, attention_mask, position_ids, S, merge_matrix,
                      with_bias=not flash_ok, rows=rows)
    if layer_weights is None:
        layer_weights = torch.zeros((L,), dtype=torch.float32,
                                    device=h.device)
    acc = torch.zeros((B, h.shape[1], D), dtype=torch.float32,
                      device=h.device)
    sides = []
    for i, lp in enumerate(shard.decoder_layers(params, L)):
        w_l = layer_weights[i] if i < L - 1 else 0.0
        kv = None if kv_cache is None else (kv_cache[0][i], kv_cache[1][i])
        h, acc, side = layer_step(lp, w_l, h, acc, aux, cfg, img_start,
                                  n_img, merge, flash_ok, kv, tp, seq)
        sides.append(side)
    last_hidden = rms_norm(h, params["final_norm"], cfg.rms_eps,
                           cfg.gemma_norm)
    hidden = acc + layer_weights[L - 1] * last_hidden.detach().float()
    attn = torch.stack(sides, dim=1)
    if tp is not None:  # the heads in rank order
        attn = all_gather_cat(attn, 2, tp)
    if seq is not None:
        form = "raw" if merge_matrix is None else merge
        attn = sequence.finish_capture(attn, form, seq)
        hidden = sequence.gather_rows(hidden, 1, seq)
        last_hidden = sequence.gather_rows(last_hidden, 1, seq)
    return {"attn": attn, "hidden": hidden, "last_hidden": last_hidden}


def logits(params: dict, cfg: DecoderConfig,
           last_hidden: torch.Tensor) -> torch.Tensor:
    """Next-token logits of post-final-norm states: the tied embedding's
    transpose, else ``lm_head``."""
    if shard.sharding_of(params) is not None:
        return shard.head_logits(params, cfg, last_hidden)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return last_hidden @ head


def embed_tokens(params: dict, cfg: DecoderConfig,
                 ids: torch.Tensor) -> torch.Tensor:
    return shard.embed_lookup(params, ids)


def quantize_params(params: dict, consume: bool = False) -> dict:
    """Int8-quantise the frozen decoder's layer projections (W8A8).

    Per-(layer, output-channel) symmetric scales over each stacked ``(L, in,
    out)`` weight (as the jitted JAX function computes them), one layer at
    a time so the f32 transient is one layer's slice: ``<name>_q`` int8 and
    ``<name>_s`` f32 ``(L, out)`` replace ``<name>``.  ``embed`` /
    ``final_norm`` / ``lm_head``, the norms, the biases and the ``(L, E,
    ...)`` MoE expert stacks stay as they are.

    ``consume=False`` leaves ``params`` and its leaves untouched (the JAX
    function donates them anyway).  ``consume=True`` pops each weight out
    of ``params["layers"]`` before it is quantised, so a caller that holds
    no other reference frees it before the next one; the same (mutated)
    dict comes back.
    """
    layers = params["layers"] if consume else dict(params["layers"])
    for name in QUANT_NAMES:
        w = layers.get(name)
        if w is None or w.dim() != 3:  # absent, or an (L, E, ...) MoE stack
            continue
        del layers[name]
        # each layer's (in, out) slice column-major, as torch._int_mm runs
        # it fastest (ops/quant.py)
        q = torch.empty((w.shape[0], w.shape[2], w.shape[1]),
                        dtype=torch.int8, device=w.device).transpose(1, 2)
        s = torch.empty((w.shape[0], w.shape[2]), dtype=torch.float32,
                        device=w.device)
        with torch.no_grad():
            for i in range(w.shape[0]):
                q[i], s[i] = quantize_weight(w[i], jitted=True)
        del w
        layers[name + "_q"] = q
        layers[name + "_s"] = s
    if consume:
        return params
    return {**params, "layers": layers}
