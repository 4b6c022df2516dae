"""Pipeline parallelism for the frozen decoder: a GPipe schedule over a mesh
axis (flmm_tpu/parallel/pipeline.py on ``torch.distributed``).

Stage ``s`` of ``n`` holds the layers ``[s * L / n, (s + 1) * L / n)``.  The
batch is split into ``M`` microbatches; stage 0 takes each from the
embeddings, every later stage receives its residual stream ``h`` (model
dtype) and the running layer-weighted sum ``acc`` (f32) from the stage
before, runs its layers and sends both on.  With point-to-point sends no
stage computes bubble ticks: stage ``s`` works on microbatch ``m`` while
stage ``s + 1`` works on ``m - 1``, the GPipe fill and drain.

The captured attention maps stay on the stage that produced them
(:func:`gather_attn` puts the stages' layers back together); the final
residual and sum are broadcast from the last stage, so ``hidden`` and
``last_hidden`` come back on every rank.  The last layer's weight is zeroed
in the stack and added after the final norm, as the one-rank forward does.
The decoder never trains in F-LMM, so the forward is the whole schedule.
"""

from __future__ import annotations

import torch

from flmm_tpu_torch.models.llm import decoder as dec
from flmm_tpu_torch.parallel import mesh as mesh_lib


def pipeline_forward_capture(params: dict, cfg: dec.DecoderConfig,
                             inputs_embeds: torch.Tensor,
                             attention_mask: torch.Tensor, img_start: int,
                             n_img: int, *, mesh, axis: str = "model",
                             n_microbatches: int = 2,
                             merge_matrix: torch.Tensor | None = None,
                             merge: str = "mean",
                             layer_weights: torch.Tensor | None = None,
                             position_ids: torch.Tensor | None = None
                             ) -> dict:
    """``decoder.forward_capture`` as a pipeline over ``axis``.

    ``params`` is the whole decoder tree (each stage reads its block of
    layers); ``cfg.num_layers`` must divide into the stages and the batch
    into ``n_microbatches``.  Returns ``attn`` of this stage's layers,
    ``(B, L / n, H, M, n_img)`` (:func:`gather_attn` for all of them),
    ``hidden`` and ``last_hidden`` on every rank."""
    ax = mesh_lib.axis_of(mesh, axis)
    n, s = ax.size, ax.index
    B, S, D = inputs_embeds.shape
    L, M = cfg.num_layers, n_microbatches
    if L % n:
        raise ValueError(f"{L} layers do not split into {n} stages")
    if B % M:
        raise ValueError(f"a batch of {B} does not split into {M} "
                         "microbatches")
    per, mb = L // n, B // M
    dev = inputs_embeds.device

    h_in = inputs_embeds.to(cfg.dtype)
    if cfg.embed_scale:
        h_in = h_in * torch.tensor(cfg.hidden_size ** 0.5, dtype=cfg.dtype)
    if layer_weights is None:
        layer_weights = torch.zeros((L,), dtype=torch.float32, device=dev)
    stack_w = layer_weights.clone()
    stack_w[L - 1] = 0.0
    stack_w = stack_w[s * per:(s + 1) * per]
    layers = {k: v[s * per:(s + 1) * per]
              for k, v in params["layers"].items()}
    flash_ok = dec.flash_capture_ok(cfg, merge_matrix, merge, S, img_start,
                                    n_img)

    def rows(t, m):
        return None if t is None else t[m * mb:(m + 1) * mb]

    sides, outs = [], []
    for m in range(M):
        aux = dec.capture_aux(cfg, rows(attention_mask, m),
                              rows(position_ids, m), S,
                              rows(merge_matrix, m), with_bias=not flash_ok)
        if s == 0:
            h = rows(h_in, m)
            acc = torch.zeros((mb, S, D), dtype=torch.float32, device=dev)
        else:
            h = mesh_lib.recv(torch.empty((mb, S, D), dtype=cfg.dtype,
                                          device=dev), s - 1, ax.group)
            acc = mesh_lib.recv(torch.empty((mb, S, D), dtype=torch.float32,
                                            device=dev), s - 1, ax.group)
        mb_sides = []
        for j in range(per):
            lp = {k: v[j] for k, v in layers.items()}
            h, acc, side = dec.layer_step(lp, stack_w[j], h, acc, aux, cfg,
                                          img_start, n_img, merge, flash_ok)
            mb_sides.append(side)
        sides.append(torch.stack(mb_sides, dim=1))
        if s < n - 1:
            mesh_lib.send(h, s + 1, ax.group)
            mesh_lib.send(acc, s + 1, ax.group)
        else:
            outs.append((h, acc))

    if s == n - 1:
        h_final = torch.cat([o[0] for o in outs])
        acc = torch.cat([o[1] for o in outs])
    else:
        h_final = torch.empty((B, S, D), dtype=cfg.dtype, device=dev)
        acc = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    mesh_lib.broadcast(h_final, n - 1, ax.group)
    mesh_lib.broadcast(acc, n - 1, ax.group)
    last_hidden = dec.rms_norm(h_final, params["final_norm"], cfg.rms_eps,
                               cfg.gemma_norm)
    hidden = acc + layer_weights[L - 1] * last_hidden.detach().float()
    return {"attn": torch.cat(sides), "hidden": hidden,
            "last_hidden": last_hidden}


def gather_attn(attn: torch.Tensor, mesh, axis: str = "model"
                ) -> torch.Tensor:
    """The stages' captures concatenated over layers in stage order: the
    ``(B, L, H, M, n_img)`` of the one-rank forward."""
    return mesh_lib.all_gather_cat(attn, 1, mesh_lib.axis_of(mesh, axis))
