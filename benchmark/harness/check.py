"""What decides ``correct``: the program's outputs from the timed window
against the float32 reference, run once the window has closed, the
memory peak has been read and the program's state is freed.

The reference gets the same seed's weights, made anew, and the raw
samples of the requests it checks; it rebuilds their batches itself and
computes the outputs in float32 with TF32 off.

Serve cells: the checked requests are the window's request with the most
phrase tokens and others drawn from the seed among those the window
finished.  The reference prompts SAM with the program's boxes, as a
served model's reference reads the served tokens: a box comes from a
threshold, and a pixel at the threshold flips it in either precision.
For every valid mask: the relative L2 gap of its coarse logits and of its
SAM logits, its IoU prediction's gap against the mean magnitude of the
request's predictions, and its box's gap (``box_gap``: how far, in
logits, the reference's coarse map lies on the wrong side of the
threshold for the program's box); each number is the largest over the
checked masks.

Train cells: the reference follows the first steps from the same start on
the same batches, and prompts SAM with the boxes the program's steps
took, for the same reason.  The loss of each step (relative gap); the
norm of the first gradient as the optimizer got it, read from its first
moments, and the norm of each trained leaf's change over the steps, each
as the gap of the program's norm and the reference's against the larger
of that leaf's reference norm and the median leaf's, by the worst leaf
and by the median leaf; leaves whose reference gradient is under a
thousandth of the median leaf's are left out of both.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from benchmark.harness import program, weights
from benchmark.reference import data as rdata
from benchmark.reference import layers as rnn
from benchmark.reference import model as rmodel
from benchmark.reference import optim as roptim

LEAF_FLOOR = 1e-3  # of the median leaf's first-gradient norm
NO_BOX = 1e9  # the box gap of a box with no pixel in the frame


def _ref_config(cell):
    return rnn.NS(cell.config["model"])


def ref_batch(cell, samples: list) -> dict:
    """The reference's own batch of raw samples (numpy)."""
    c = cell.config
    family = c["family"]
    cfg = _ref_config(cell)
    b = rmodel.base(family, cfg)
    s = cell.spec
    if family == "llava_next":
        coarse = tuple(cfg.coarse_frame)
    else:
        g = b.clip_shape
        up = b.unet.upsample_input
        scale = max(1.0, up / g) if up is not None else 1.0
        coarse = (int(g * scale), int(g * scale))
    spec = rdata.BatchSpec(
        seq_len=s["seq_len"], max_masks=s["max_masks"],
        text_per_mask=s["text_per_mask"], coarse_hw=coarse,
        sam_size=b.sam.encoder.img_size, prompt_size=b.sam.prompt_size,
        align_image_block=128 if b.llm.use_flash_capture else None,
        expected_img_start=b.img_start,
        processor=rdata.ProcessorConfig(
            size=b.image_input_size or b.vision.image_size,
            size_rule=c["size_rule"]))
    if family == "llava_next":
        batch = rdata.build_anyres_batch(samples, spec, rdata.AnyresSpec(
            tile_size=cfg.tile_size, patch_size=b.vision.patch_size,
            pinpoints=tuple(tuple(p) for p in cfg.pinpoints)))
    else:
        batch = rdata.build_batch(samples, spec)
    batch.pop("infos")
    return batch


def _tensors(batch: dict, device) -> dict:
    def one(a):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return t.float() if t.dtype == torch.float64 else t
    return {k: ({kk: one(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else one(v)) for k, v in batch.items()}


def reference_params(run) -> dict:
    """The seed's weights made anew, as float32, leaf by leaf."""
    tree = weights.make(program.schema(run.family, run.cfg), run.seed,
                        run.device)
    return weights.to_float32(tree)


class Float32:
    """TF32 off for the reference's products and convolutions."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def checked_requests(run, n: int) -> list:
    """The longest finished request and ``n - 1`` others from the seed."""
    from benchmark.harness.traffic import caption_tokens
    done = sorted({it["pool"] for it in run.items})
    longest = max(done, key=lambda k: caption_tokens(run.raw[k]))
    rest = [k for k in done if k != longest]
    rng = np.random.default_rng([run.seed, 7])
    pick = list(rng.choice(rest, min(n - 1, len(rest)), replace=False)) \
        if rest else []
    return [longest] + [int(k) for k in pick]


def serve_gaps(got: dict, want: dict, batch: dict) -> dict:
    """The numbers of one request: the relative L2 gap of the hidden states
    over the valid tokens, and of the coarse logits, SAM logits and IoU
    predictions over the valid masks; the largest box gap.  ``want``
    prompted SAM with the program's boxes."""
    mv = batch["mask_valid"].bool().to(got["boxes"].device)
    geom = batch["geom"]
    valid = batch["attn_mask"].bool()
    g, w = got["hidden"].float()[valid], want["hidden"].float()[valid]
    out = {"hidden_gap": float((g - w).norm() / w.norm().clamp_min(1e-12))}
    for name, key in (("coarse_gap", "coarse_logits"),
                      ("sam_gap", "sam_logits"), ("iou_gap", "iou_pred")):
        g, w = got[key].float()[mv], want[key].float()[mv]
        out[name] = float((g - w).norm() / w.norm().clamp_min(1e-12))
    out["box_gap"] = max(
        box_gap(got["boxes"][b, m].float(), want["box_view"][b, m],
                geom["sam_h"][b], geom["sam_w"][b])
        for b, m in zip(*torch.nonzero(mv, as_tuple=True)))
    return out


def box_gap(box, view, sam_h, sam_w) -> float:
    """How far the reference's coarse logits in the box frame ``view``
    ``(bf, bf)`` lie on the wrong side of the threshold for the program's
    box (SAM-frame pixels): the largest logit outside the box (the
    reference would reach further) and, negated, each edge's largest
    logit inside it (the reference would not reach the edge); 0 where the
    box is the reference's own to rounding.  A whole-frame box is also
    read as an empty mask's, whose gap is the largest logit.  A box with
    no pixel in the frame is wrong by any measure: ``NO_BOX``."""
    bf = view.shape[-1]
    scale = torch.stack([sam_w, sam_h, sam_w, sam_h]).float().to(box.device)
    x0, y0, x1, y1 = (int(v) for v in torch.round(box / scale * bf).tolist())
    x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, bf), min(y1, bf)
    if x1 <= x0 or y1 <= y0:
        return NO_BOX
    inside = torch.zeros_like(view, dtype=torch.bool)
    inside[y0:y1, x0:x1] = True
    gaps = [0.0, -float(view[y0, x0:x1].max()),
            -float(view[y1 - 1, x0:x1].max()),
            -float(view[y0:y1, x0].max()), -float(view[y0:y1, x1 - 1].max())]
    if not bool(inside.all()):
        gaps.append(float(view[~inside].max()))
    gap = max(gaps)
    if (x0, y0, x1, y1) == (0, 0, bf, bf):
        gap = min(gap, max(0.0, float(view.max())))
    return gap


def fp8_frozen(run, params: dict) -> dict:
    """The control's weights: the frozen model's, which the configuration
    states in bfloat16, rounded to float8 e4m3 (one scale a tensor, its
    largest magnitude at e4m3's 448); the float32 heads as they are."""

    def one(path, t):
        if not path.startswith("frozen/"):
            return t
        scale = 448.0 / t.abs().max().clamp_min(1e-30)
        return (t * scale).to(torch.float8_e4m3fn).float() / scale

    return weights.map_tree(params, one)


def serve(run, n_requests: int, control: bool = False) -> dict:
    """The numbers of the checked requests, each its largest.  ``control``:
    the reference with float8 weights in the program's place."""
    cfg = _ref_config(run.cell)
    params = reference_params(run)
    low = fp8_frozen(run, params) if control else None
    numbers = {}
    with Float32(), torch.no_grad():
        for k in checked_requests(run, n_requests):
            batch = _tensors(ref_batch(run.cell, run.raw[k]), run.device)
            if control:
                got = rmodel.forward(low, run.family, cfg, batch)
            else:
                got = {n: t.to(run.device) for n, t in
                       run.outputs["bufs"][k].items()}
            want = rmodel.forward(params, run.family, cfg, batch,
                                  boxes=got["boxes"].float())
            for name, v in serve_gaps(got, want, batch).items():
                numbers[name] = max(numbers.get(name, 0.0), v)
            del want, got, batch
    return numbers


def leaf_gaps(got: dict, want: dict, keep) -> list:
    """Each kept leaf's gap of norms, against the larger of the leaf's
    reference norm and the median leaf's."""
    med = float(np.median([want[p] for p in keep]))
    return [abs(got[p] - want[p]) / max(want[p], med, 1e-30) for p in keep]


def follow(run, params: dict, n_steps: int, boxes=None) -> dict:
    """The reference's first training steps from ``params``: each step's
    loss and its coarse and SAM parts, the first gradient's norm by leaf
    and in all (before the clipping), the trained tree before and after,
    and each step's boxes.  ``boxes``: a step's boxes to prompt SAM with,
    as the other side took them."""
    cfg = _ref_config(run.cell)
    trainable = params["trainable"]
    start = {p: t.clone() for p, t in roptim.leaves(trainable)}
    adam = roptim.AdamW(dict(run.cell.spec["optim"]), trainable)
    trained = [(p, t) for p, t in roptim.leaves(trainable)
               if roptim.trained(p)]
    for _, t in trained:
        t.requires_grad_(True)
    losses, first, norm1, took = [], None, None, []
    with Float32():
        for k in range(n_steps):
            batch = _tensors(ref_batch(run.cell, run.raw[k]), run.device)
            parts = rmodel.loss(params, run.family, cfg, batch,
                                None if boxes is None else boxes[k])
            took.append(parts.pop("boxes"))
            grads = torch.autograd.grad(parts["loss"],
                                        [t for _, t in trained],
                                        allow_unused=True)
            grads = {p: (g if g is not None else torch.zeros_like(t))
                     for (p, t), g in zip(trained, grads)}
            if first is None:
                first = {p: float(g.norm()) for p, g in grads.items()}
                norm1 = float(torch.stack([g.square().sum()
                                           for g in grads.values()]).sum()
                              .sqrt())
            adam.step(grads, trainable)
            losses.append({k: float(v.detach()) for k, v in parts.items()})
            del parts, grads, batch
    return {"losses": losses, "first": first, "norm1": norm1, "start": start,
            "after": {p: t.detach() for p, t in roptim.leaves(trainable)},
            "boxes": took}


def program_steps(run) -> dict:
    """The program's first steps as :func:`follow` gives the reference's:
    the first gradient read from the optimizer's first moments, which hold
    (1 - b1) times the clipped gradient (the step's global norm undoes the
    clipping); the loss terms of models/frozen/base.grounding_losses; the
    boxes the refiner made in each step."""
    seen = run.train_seen
    opt = run.cell.spec["optim"]
    b1, clip = opt["betas"][0], opt["max_grad_norm"]
    norm1 = seen["grad_norms"][0]
    unclip = norm1 / clip if norm1 >= clip else 1.0
    return {"losses": [{"loss": s["loss"],
                        "coarse": s["loss_mask"] + s["loss_dice"],
                        "sam": s["sam_loss_mask"] + s["sam_loss_dice"]}
                       for s in seen["losses"]],
            "first": {p: float(m.float().norm()) / (1.0 - b1) * unclip
                      for p, m in seen["mu1"].items()},
            "norm1": norm1, "after": seen["after"], "boxes": seen["boxes"]}


def train(run, n_steps: int, control: bool = False) -> dict:
    """Loss, first-gradient and change numbers of the first steps.
    ``control``: the reference with float8 frozen weights in the program's
    place.  The reference prompts SAM with the boxes of the side judged."""
    got = (follow(run, fp8_frozen(run, reference_params(run)), n_steps)
           if control else program_steps(run))
    want = follow(run, reference_params(run), n_steps, got["boxes"])
    first, start = want["first"], want["start"]
    med = float(np.median(list(first.values())))
    keep = [p for p in first if first[p] >= LEAF_FLOOR * med]
    want_change = {p: float((want["after"][p] - start[p]).norm())
                   for p in keep}
    got_change = {p: float((got["after"][p].float() - start[p]).norm())
                  for p in keep}

    def gap(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    grad = leaf_gaps(got["first"], first, keep)
    change = leaf_gaps(got_change, want_change, keep)
    worst = sorted(zip(grad, keep), reverse=True)[:3]
    print("check: worst first-gradient leaves "
          + ", ".join(f"{p} {g:.4g}" for g, p in worst), file=sys.stderr)
    worst = sorted(zip(change, keep), reverse=True)[:3]
    print("check: worst change leaves "
          + ", ".join(f"{p} {g:.4g}" for g, p in worst), file=sys.stderr)
    pairs = list(zip(got["losses"], want["losses"]))
    return {"loss_gap": max(gap(a["loss"], b["loss"]) for a, b in pairs),
            "loss1_gap": gap(*(x["loss"] for x in pairs[0])),
            "coarse_loss_gap": max(gap(a["coarse"], b["coarse"])
                                   for a, b in pairs),
            "sam_loss1_gap": gap(*(x["sam"] for x in pairs[0])),
            "norm1_gap": gap(got["norm1"], want["norm1"]),
            "grad_gap": max(grad), "grad_gap_median": float(np.median(grad)),
            "change_gap": max(change),
            "change_gap_median": float(np.median(change)),
            "leaves_kept": len(keep), "leaves": len(first)}


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``: every number that has a
    limit, held to it (all the numbers, with no limit, while none is
    set)."""
    held = limits or {n: None for n in numbers
                      if n not in ("leaves_kept", "leaves")}
    shown = {name: {"value": numbers.get(name), "limit": limit}
             for name, limit in held.items()}
    ok = bool(limits) and all(
        numbers.get(name) is not None and numbers[name] <= limit
        for name, limit in limits.items())
    return ok, shown
