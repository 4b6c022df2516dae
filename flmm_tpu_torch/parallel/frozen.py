"""The frozen tree split over the mesh's ``"model"`` axis: what
``jit_train_step(frozen_mode=...)`` and ``param_shardings`` give in the
JAX package, where XLA partitions the forward; here the forward does it.

:func:`shard_frozen` keeps this rank's block of every leaf the rules of
parallel/mesh.py split and wraps each subtree that holds one (``llm``,
``sam_encoder``) in a :class:`ShardedTree`, which carries the mode and the
axis.  The decoder (models/llm/decoder.py) and the SAM encoder
(models/sam/image_encoder.py) test for it:

* ``tp``, the decoder: ``wq / wk / wv / w_gate / w_up`` (and ``bq / bk /
  bv``) by columns, ``wo / w_down`` by rows; each layer runs its local
  heads ``H / n`` and KV heads ``KV / n`` (K5 among them, on the flash
  path) and sums the row products over the axis in f32 before the residual
  (:func:`row_product`).  A Mixtral MoE splits its experts instead: the
  router stays whole, so the gates and their tie rule are the one-rank
  ones, and each rank's gated sum over its experts is summed over the
  axis.  The capture comes back gathered over heads in rank order, so the
  U-Net's layer-major, head-minor channels are the one-rank ones.
* ``tp``, the SAM encoder: ``w1 / b1`` by columns, ``wo / w2`` by rows.
  The rules split the fused ``wqkv / bqkv`` output axis, but a contiguous
  block of ``[q | k | v]`` is not a set of heads: each rank takes its
  heads' columns within each of q, k and v (:func:`_qkv_heads`).
* ``fsdp``: rank ``r`` holds a contiguous block of the layer stack; each
  layer is broadcast by its owner before it runs, the next layer's
  broadcast in flight while the current one computes
  (:func:`decoder_layers`).  ``embed`` is split by columns and gathered
  after the lookup, ``lm_head`` by columns and the logits gathered.

The trainable tree stays replicated, as in JAX.  Int8 trees are refused.
"""

from __future__ import annotations

import dataclasses

import torch

from flmm_tpu_torch.ops._matmul import matmul_f32
from flmm_tpu_torch.parallel import mesh as mesh_lib

SHARDED_SUBTREES = ("llm", "sam_encoder")


class ShardedTree(dict):
    """A parameter subtree holding this rank's shard of each leaf.
    ``mode``: 'tp' or 'fsdp'; ``axis``: the model axis
    (:class:`mesh.Axis`); ``specs``: the spec of each leaf, same tree."""

    def __init__(self, leaves: dict, mode: str, axis, specs: dict):
        super().__init__(leaves)
        self.mode, self.axis, self.specs = mode, axis, specs


def sharding_of(params) -> ShardedTree | None:
    return params if isinstance(params, ShardedTree) else None


def tp_axis(params):
    """The model axis of a tp-sharded subtree, else None."""
    s = sharding_of(params)
    return s.axis if s is not None and s.mode == "tp" else None


def _qkv_heads(leaf: torch.Tensor, axis) -> torch.Tensor:
    """The fused ``(..., 3C)`` q / k / v columns of this rank's heads:
    block ``index`` of ``size`` within each of q, k and v."""
    return torch.cat([part.chunk(axis.size, dim=-1)[axis.index]
                      for part in leaf.chunk(3, dim=-1)], dim=-1)


def shard_frozen(frozen: dict, mesh, mode: str = "tp") -> dict:
    """The frozen tree with ``llm`` and ``sam_encoder`` cut to this rank's
    shards (:class:`ShardedTree`) where the rules of ``mode`` split a leaf;
    every other subtree as it is.  The whole leaves can then be freed."""
    specs = mesh_lib.param_shardings(mesh, frozen, mode)
    axis = mesh_lib.axis_of(mesh, "model")
    out = dict(frozen)
    for name in SHARDED_SUBTREES:
        if name not in frozen or not _splits(specs[name]):
            continue
        if any(k.endswith("_q") for k, _ in _leaves(frozen[name])):
            raise NotImplementedError(
                f"--n-model: the int8 {name} tree is not sharded")

        def cut(path, leaf, sub=specs[name]):
            spec = _at(sub, path)
            if not spec:
                return leaf
            if mode == "tp" and path[-1] in ("wqkv", "bqkv"):
                return _qkv_heads(leaf, axis).clone()
            return mesh_lib.local_shard(leaf, spec, mesh)

        out[name] = ShardedTree(mesh_lib.tree_map_with_path(cut, frozen[name]),
                                mode, axis, specs[name])
    return out


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield "/".join(map(str, path)), tree


def _splits(specs) -> bool:
    """Whether a spec tree (specs are tuples) splits any leaf."""
    if isinstance(specs, dict):
        return any(_splits(v) for v in specs.values())
    if isinstance(specs, list):
        return any(_splits(v) for v in specs)
    return "model" in specs


def _at(tree, path: tuple):
    for p in path:
        tree = tree[p]
    return tree


def row_product(x: torch.Tensor, w: torch.Tensor, axis,
                dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` of a row-split ``w``: this rank's partial product in f32,
    summed over the axis, rounded to ``dtype`` once (as the one-rank
    product rounds its f32 accumulation once)."""
    return mesh_lib.all_reduce(matmul_f32(x, w), axis.group).to(dtype)


def _divide(what: str, n: int, size: int) -> int:
    if n % size:
        raise ValueError(f"tensor parallelism over {size} ranks: {what} "
                         f"{n} do not divide")
    return n // size


def local_decoder_config(cfg, axis):
    """The decoder config of one rank's heads and FFN columns (or
    experts)."""
    n = axis.size
    over = {"num_heads": _divide("the attention heads", cfg.num_heads, n),
            "num_kv_heads": _divide("the KV heads", cfg.num_kv_heads, n)}
    if cfg.num_experts:
        _divide("the experts", cfg.num_experts, n)
    else:
        over["intermediate_size"] = _divide(
            "the FFN columns", cfg.intermediate_size, n)
    return dataclasses.replace(cfg, **over)


def local_sam_config(cfg, axis):
    """The SAM encoder config of one rank's heads (``embed_dim`` the width
    of its heads: ``head_dim`` stays)."""
    n = axis.size
    _divide("the MLP columns", int(cfg.embed_dim * cfg.mlp_ratio), n)
    return dataclasses.replace(
        cfg, num_heads=_divide("the SAM heads", cfg.num_heads, n),
        embed_dim=cfg.embed_dim // n)


def decoder_layers(params: dict, num_layers: int):
    """Each layer's parameters in turn, ``{name: (…)}`` without the layer
    axis.  Under fsdp the owner of layer ``i`` broadcasts it; the next
    layer's broadcast is started before layer ``i`` is handed out."""
    layers = params["layers"]
    s = sharding_of(params)
    if s is None or s.mode != "fsdp" or "model" not in s.specs["layers"].get(
            "wq", ()):
        for i in range(num_layers):
            yield {k: v[i] for k, v in layers.items()}
        return
    per = num_layers // s.axis.size

    def start(i):
        owner, j = divmod(i, per)
        bufs = {k: (v[j] if owner == s.axis.index else
                    torch.empty_like(v[0])) for k, v in layers.items()}
        works = [mesh_lib.broadcast(b, owner, s.axis.group, async_op=True)
                 for b in bufs.values()]
        return bufs, works

    pending = start(0)
    for i in range(num_layers):
        bufs, works = pending
        for w in works:
            w.wait()
        if i + 1 < num_layers:
            pending = start(i + 1)
        yield bufs


def embed_lookup(params: dict, ids: torch.Tensor) -> torch.Tensor:
    """``embed[ids]``; a column-split ``embed`` is gathered after the
    lookup."""
    out = params["embed"][ids]
    s = sharding_of(params)
    if s is not None and "model" in s.specs.get("embed", ()):
        out = mesh_lib.all_gather_cat(out, -1, s.axis)
    return out


def head_logits(params: dict, cfg, last_hidden: torch.Tensor):
    """Next-token logits through a split ``lm_head`` (columns: gathered)
    or a tied, column-split ``embed`` (a row product)."""
    s = sharding_of(params)
    if cfg.tie_embeddings:
        head = params["embed"].T
        if s is not None and "model" in s.specs.get("embed", ()):
            part = last_hidden.chunk(s.axis.size, dim=-1)[s.axis.index]
            return row_product(part, head, s.axis, last_hidden.dtype)
        return last_hidden @ head
    out = last_hidden @ params["lm_head"]
    if s is not None and "model" in s.specs.get("lm_head", ()):
        out = mesh_lib.all_gather_cat(out, -1, s.axis)
    return out
