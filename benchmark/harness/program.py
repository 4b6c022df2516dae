"""Everything the benchmark takes from the program under test
(``flmm_tpu_torch``): the configuration preset, the parameter tree's
schema, the family's batch builder, the grounding forward, the training
step and the boxes its refiner makes.  Nothing else of the harness imports
the program."""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from flmm_tpu_torch import registry
from flmm_tpu_torch.data.collate import BatchSpec
from flmm_tpu_torch.data.processors import ProcessorConfig
from flmm_tpu_torch.models.mask_head import refiner
from flmm_tpu_torch.train import loop

# the outputs a served request brings back to the host
SERVED = ("coarse_logits", "sam_logits", "iou_pred", "boxes")


def describe(obj):
    """A configuration dataclass as plain JSON values (dtypes by name)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: describe(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [describe(v) for v in obj]
    if isinstance(obj, torch.dtype):
        return str(obj).replace("torch.", "")
    return obj


def config(cfg_file: dict):
    """The program's configuration of a configuration file: its preset with
    the file's arguments, held field by field to the file's ``model``."""
    cfg = registry.get_config(cfg_file["family"], cfg_file["preset"],
                              **cfg_file.get("preset_kwargs", {}))
    got = describe(cfg)
    if got != cfg_file["model"]:
        diff = sorted(_diff(got, cfg_file["model"]))
        raise ValueError(f"configuration {cfg_file['name']}: the program's "
                         f"preset differs from the file at {diff[:8]}")
    return cfg


def _diff(a, b, path=""):
    if isinstance(a, dict) and isinstance(b, dict):
        for k in set(a) | set(b):
            yield from _diff(a.get(k), b.get(k), f"{path}/{k}")
    elif a != b:
        yield path


def base(cfg):
    return cfg.base if hasattr(cfg, "base") else cfg


def model(family: str):
    return registry.get_model(family)


def schema(family: str, cfg) -> dict:
    """The parameter tree's keys, shapes and dtypes, drawn on nothing."""
    return model(family).init_params(cfg, None, "meta")


def batch_spec(family: str, cfg, seq_len: int, max_masks: int,
               text_per_mask: int) -> BatchSpec:
    b = base(cfg)
    align = 128 if b.llm.use_flash_capture else None
    return BatchSpec(
        seq_len=seq_len, max_masks=max_masks, text_per_mask=text_per_mask,
        coarse_hw=registry.get_coarse_hw(cfg), sam_size=b.sam.encoder.img_size,
        prompt_size=b.sam.prompt_size, align_image_block=align,
        expected_img_start=b.img_start,
        processor=ProcessorConfig(size=b.input_size,
                                  size_rule=registry.FAMILY_SIZE_RULES[family]))


def build_batch(family: str, cfg, samples: list, spec: BatchSpec) -> dict:
    """The program's host batch of raw samples (numpy)."""
    batch = registry.get_batch_builder(family, cfg)(samples, spec)
    batch.pop("infos")
    return batch


def forward(family: str, cfg, params: dict, batch: dict) -> dict:
    return model(family).forward(params, cfg, batch)


@contextlib.contextmanager
def boxes_made(out: list):
    """While open, each call of the SAM refiner appends the boxes it made
    (``(masks, 4)``, SAM-frame pixels) to ``out``."""
    orig = refiner.refine

    def refine(*args, **kwargs):
        res = orig(*args, **kwargs)
        out.append(res["boxes"].detach().clone())
        return res

    refiner.refine = refine
    try:
        yield out
    finally:
        refiner.refine = orig


@dataclasses.dataclass
class Trainer:
    """The training step with its model and optimizer state: built once,
    driven through its first steps in set-up and then by the window."""
    family: str
    cfg: object
    frozen: dict
    state: dict
    step_fn: object

    def step(self, batch: dict) -> dict:
        self.state, metrics = self.step_fn(self.state, self.frozen, batch)
        return metrics


def trainer(family: str, cfg, params: dict, opt: dict) -> Trainer:
    """``train/loop.make_train_step`` over the family's loss with AdamW at
    ``opt`` (the keys of ``loop.OptimConfig``)."""
    ocfg = loop.OptimConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in opt.items()})
    optimizer = loop.make_optimizer(ocfg)
    loss_fn = model(family).loss_fn

    def loss(p, batch):
        return loss_fn(p, cfg, batch)

    state = loop.init_state(params["trainable"], optimizer)
    return Trainer(family, cfg, params["frozen"], state,
                   loop.make_train_step(loss, optimizer))


def adam_state(tr: Trainer) -> dict:
    """The optimizer's first moments by leaf path."""
    return tr.state["opt_state"]["mu"]


def leaves(tree):
    return loop.tree_leaves(tree)


def host(batch: dict, pin: bool) -> dict:
    """A numpy batch as host tensors (pinned for the timed copies)."""
    def one(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if pin else t
    return {k: ({kk: one(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else one(v)) for k, v in batch.items()}


def to_device(batch: dict, device) -> dict:
    return {k: ({kk: vv.to(device, non_blocking=True)
                 for kk, vv in v.items()} if isinstance(v, dict)
                else v.to(device, non_blocking=True))
            for k, v in batch.items()}
