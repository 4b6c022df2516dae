"""The rank side of tests/test_torch_parallel.py: a pool of gloo ranks on
the CPU that import torch and the port only (never JAX or flmm_tpu) and
run the named tasks below on numpy inputs the test sends them.

``Pool(4)`` spawns the ranks once; ``pool.run(task, **kwargs)`` hands the
same task to every rank and returns their results in rank order.  Each
task derives its mesh from the world of 4: ``2 x 2`` (data x model),
``4 x 1`` or ``1 x 2`` (ranks 2 and 3 outside it, returning None).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import tempfile
import traceback

TIMEOUT_S = 300


class Shape:
    """A leaf of a shape tree: the parameter's shape, no data."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def _serve(rank: int, world: int, store: str, tasks, results) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        while (item := tasks.get()) is not None:
            ticket, name, kwargs = item
            try:
                results.put((ticket, rank, True, globals()[name](**kwargs)))
            except Exception:  # reported to the test, which fails
                results.put((ticket, rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class Pool:
    """``world`` spawned ranks in one gloo group, alive until close()."""

    def __init__(self, world: int = 4):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._dir = tempfile.TemporaryDirectory()
        self.world = world
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(world)]
        self._tickets = 0
        self._early = {}  # results of a later ticket that came first
        self.procs = [ctx.Process(
            target=_serve, args=(r, world, os.path.join(self._dir.name, "s"),
                                 self.tasks[r], self.results), daemon=True)
            for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, task: str, **kwargs) -> list:
        return self.collect(self.submit(task, **kwargs))

    def submit(self, task: str, **kwargs) -> int:
        """Hand ``task`` to every rank; returns the ticket that
        :meth:`collect` waits for."""
        self._tickets += 1
        for q in self.tasks:
            q.put((self._tickets, task, kwargs))
        return self._tickets

    def collect(self, ticket: int) -> list:
        got = self._early.pop(ticket, {})
        while len(got) < self.world:
            try:
                t, rank, ok, out = self.results.get(timeout=TIMEOUT_S)
            except queue.Empty:
                raise TimeoutError(f"ticket {ticket}: ranks {sorted(got)} "
                                   f"of {self.world} answered") from None
            if not ok:
                raise RuntimeError(f"ticket {t} on rank {rank}:\n{out}")
            (got if t == ticket else self._early.setdefault(t, {}))[rank] = out
        return [got[r] for r in range(self.world)]

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
        self._dir.cleanup()


# ---------------------------------------------------------------------------
# Tasks (run on every rank).
# ---------------------------------------------------------------------------

def _mesh(n_data: int, n_model: int):
    from flmm_tpu_torch.parallel import mesh as mesh_lib

    return mesh_lib.make_mesh(n_data, n_model, "cpu")


def _numpy(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree


def _tiny(variant: str):
    """The port's tiny config, or its MoE twin (__graft_entry__.py:112-115)
    or its 4-layer twin (:147-152)."""
    from flmm_tpu_torch.configs.deepseek_vl import tiny

    base = tiny()
    if variant == "moe":
        return dataclasses.replace(base, llm=dataclasses.replace(
            base.llm, num_experts=4, num_experts_per_tok=2))
    if variant == "layers4":
        return dataclasses.replace(
            base, llm=dataclasses.replace(base.llm, num_layers=4),
            unet=dataclasses.replace(base.unet,
                                     in_channels=4 * base.llm.num_heads))
    return base


def specs(trees: dict) -> dict | None:
    """Rank 0: ``param_shardings`` of each shape tree under tp and fsdp at
    a 2 x 2 mesh."""
    import torch

    import torch.distributed as dist

    from flmm_tpu_torch.parallel import mesh as mesh_lib

    mesh = _mesh(2, 2)
    if dist.get_rank():
        return None

    def meta(tree):
        if isinstance(tree, dict):
            return {k: meta(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [meta(v) for v in tree]
        return torch.empty(tree.shape, device="meta")

    batch = {"input_ids": torch.empty((4, 9), device="meta"),
             "geom": {"sam_h": torch.empty((4,), device="meta")}}
    return {"params": {name: {mode: mesh_lib.param_shardings(mesh, meta(t),
                                                              mode)
                              for mode in ("tp", "fsdp")}
                       for name, t in trees.items()},
            "batch": mesh_lib.batch_shardings(mesh, batch),
            "replicated": mesh_lib.replicated(mesh, batch)}


def sharded_eval(params: dict, n_samples: int) -> dict:
    """``run_eval_sharded`` at tiny over the 4 x 1 mesh (RefCOCO and PNG
    scorers) and ``make_sharded_eval_step``'s terms of a bs-4 batch; on
    rank 0 the host path of both and the batch's SAM logits."""
    import torch.distributed as dist

    from flmm_tpu_torch import registry
    from flmm_tpu_torch.convert.from_jax import from_jax
    from flmm_tpu_torch.data.collate import BatchSpec
    from flmm_tpu_torch.data.processors import ProcessorConfig
    from flmm_tpu_torch.data.synthetic import synthetic_samples
    from flmm_tpu_torch.evalsuite import runner, sharded
    from flmm_tpu_torch.evalsuite.metrics import PNGAccumulator, \
        RefSegAccumulator
    from flmm_tpu_torch.models.frozen import grounding as model

    cfg = _tiny("dense")
    params = from_jax(params)
    samples = synthetic_samples(cfg, n_samples, seed=0)
    spec = BatchSpec(
        seq_len=max(len(s["input_ids"]) for s in samples) + 16,
        max_masks=2, text_per_mask=8, coarse_hw=registry.get_coarse_hw(cfg),
        sam_size=cfg.sam.encoder.img_size, prompt_size=cfg.sam.prompt_size,
        processor=ProcessorConfig(size=cfg.input_size))
    mesh = _mesh(4, 1)

    def fwd(p, b):
        return model.forward(p, cfg, b)

    out = {"refcoco": sharded.run_eval_sharded(
               iter(samples), params, fwd, spec, 4, mesh),
           "png": sharded.run_eval_sharded(
               iter(samples), params, fwd, spec, 4, mesh,
               accumulator_factory=PNGAccumulator,
               score_fn=runner.png_score)}
    # the scalar-term step over a bs-4 batch with the loss targets
    from flmm_tpu_torch.data.synthetic import synthetic_batch

    batch = from_jax(synthetic_batch(cfg, batch_size=4, seed=2))
    out["step"] = sharded.finalize(
        sharded.make_sharded_eval_step(fwd, mesh)(params, batch))
    if dist.get_rank() == 0:
        import torch

        with torch.no_grad():
            logits = fwd(params, batch)["sam_logits"]
        out["step_host"] = sharded.finalize(sharded.batch_iou_terms(
            logits, batch["gt_sam"], batch["sam_weight"],
            batch["mask_valid"]))
        out["step_logits"] = logits.numpy()
        predict = lambda b: fwd(params, from_jax(b))["sam_logits"]  # noqa
        out["host_refcoco"] = runner.run_eval(
            iter(samples), predict, spec, 4, RefSegAccumulator,
            runner.refcoco_score).results()
        out["host_png"] = runner.run_eval(
            iter(samples), predict, spec, 4, PNGAccumulator,
            runner.png_score).results()
    return out


def dp_tp_step(params: dict, batch: dict) -> dict:
    """One data-parallel step over the 2 x 2 mesh with the frozen tree
    split over ``"model"`` (tp); the metrics and the updated trainable
    tree."""
    from flmm_tpu_torch.convert.from_jax import from_jax
    from flmm_tpu_torch.models.frozen import grounding as model
    from flmm_tpu_torch.parallel import frozen as shard
    from flmm_tpu_torch.train import loop

    cfg = _tiny("dense")
    mesh = _mesh(2, 2)
    params = from_jax(params)
    frozen = shard.shard_frozen(params["frozen"], mesh, "tp")
    opt = loop.make_optimizer(loop.OptimConfig(lr=1e-3, total_steps=50,
                                               warmup_ratio=0.0))
    state = loop.init_state(params["trainable"], opt)
    step = loop.make_sharded_train_step(
        lambda p, b: model.loss_fn(p, cfg, b), opt, mesh)
    state, metrics = step(state, frozen, from_jax(batch))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "trainable": _numpy(state["params"])}


def model_parallel_forward(params: dict, batch: dict, variant: str,
                           mode: str) -> dict | None:
    """The tiny forward over the 1 x 2 mesh with the frozen tree split in
    ``mode``, and the one-rank forward on the same rank."""
    import torch

    from flmm_tpu_torch.convert.from_jax import from_jax
    from flmm_tpu_torch.models.frozen import grounding as model
    from flmm_tpu_torch.models.llm import decoder
    from flmm_tpu_torch.parallel import frozen as shard
    from flmm_tpu_torch.parallel import mesh as mesh_lib

    cfg = _tiny(variant)
    mesh = _mesh(1, 2)
    if mesh.get_coordinate() is None:
        return None
    params, batch = from_jax(params), from_jax(batch)
    sharded = {**params, "frozen": shard.shard_frozen(params["frozen"],
                                                      mesh, mode)}
    # every split decoder leaf gathers back to the whole one
    llm = sharded["frozen"]["llm"]
    for key, leaf in llm["layers"].items():
        whole = mesh_lib.gather_shard(leaf, llm.specs["layers"][key], mesh)
        assert torch.equal(whole, params["frozen"]["llm"]["layers"][key]), key
    keys = ("coarse_logits", "sam_logits", "iou_pred", "hidden")
    with torch.no_grad():
        got = model.forward(sharded, cfg, batch)
        one = model.forward(params, cfg, batch)
        # next-token logits through lm_head (split by columns in both modes)
        h = got["hidden"][:, -4:]
        got["lm_logits"] = decoder.logits(sharded["frozen"]["llm"], cfg.llm, h)
        one["lm_logits"] = decoder.logits(params["frozen"]["llm"], cfg.llm, h)
    keys += ("lm_logits",)
    return {"sharded": {k: got[k].numpy() for k in keys},
            "one_rank": {k: one[k].numpy() for k in keys},
            "kinds": {k: type(v).__name__
                      for k, v in sharded["frozen"].items()}}


def pipeline(params: dict, inputs: dict, cfg_fields: dict,
             n_microbatches: int) -> dict | None:
    """``pipeline_forward_capture`` over the 1 x 2 mesh's ``"model"`` axis
    (2 stages), the stages' captures gathered."""
    import torch

    from flmm_tpu_torch.convert.from_jax import from_jax
    from flmm_tpu_torch.models.llm.decoder import DecoderConfig
    from flmm_tpu_torch.parallel import pipeline as pp

    cfg = DecoderConfig(**cfg_fields, dtype=torch.float32)
    mesh = _mesh(1, 2)
    if mesh.get_coordinate() is None:
        return None
    params, x = from_jax(params), from_jax(inputs)
    out = pp.pipeline_forward_capture(
        params, cfg, x["embeds"], x["mask"], x["img_start"].item(),
        x["n_img"].item(), mesh=mesh, n_microbatches=n_microbatches,
        merge_matrix=x.get("mm"), layer_weights=x["w"])
    out["attn"] = pp.gather_attn(out["attn"], mesh)
    return {k: v.numpy() for k, v in out.items()}


def sequence_forward(params: dict, inputs: dict, fields: dict, img_start: int,
                     n_img: int, layer_weights, forms: list) -> dict:
    """``decoder.forward_capture`` over the 2 x 2 mesh with the
    ``"model"`` axis splitting the sequence, each data rank on its rows of
    the batch (``inputs``: embeds, mask and the merge matrices), in each
    capture form (``"mean"``, ``"max"``, ``"raw"``); beside it the one-rank
    forward of the same rows, and the ``q_offset`` of every K5 call."""
    import torch

    from flmm_tpu_torch.convert.from_jax import from_jax
    from flmm_tpu_torch.models.llm import decoder
    from flmm_tpu_torch.parallel import mesh as mesh_lib

    cfg = decoder.DecoderConfig(**fields, dtype=torch.float32)
    mesh = _mesh(2, 2)
    params = from_jax(params)
    x = mesh_lib.shard_rows(from_jax(inputs),
                            mesh_lib.axis_of(mesh, "data"))
    seq = mesh_lib.axis_of(mesh, "model")
    # the query offsets K5 (its plain twin on the CPU) is called with
    offsets = []
    k5 = decoder.flash_attention_with_merged_capture

    def record(*a, **kw):
        offsets.append(kw.get("q_offset", 0))
        return k5(*a, **kw)

    decoder.flash_attention_with_merged_capture = record
    out = {"k5_offsets": offsets}
    for form in forms:
        kw = dict(img_start=img_start, n_img=n_img,
                  merge_matrix=None if form == "raw" else x[f"mm_{form}"],
                  merge="mean" if form == "raw" else form,
                  layer_weights=torch.from_numpy(layer_weights))
        with torch.no_grad():
            got = decoder.forward_capture(params, cfg, x["embeds"], x["mask"],
                                          seq_axis=seq, **kw)
            one = decoder.forward_capture(params, cfg, x["embeds"], x["mask"],
                                          **kw)
        out[form] = {"sharded": _numpy(got), "one_rank": _numpy(one)}
    decoder.flash_attention_with_merged_capture = k5
    return out
