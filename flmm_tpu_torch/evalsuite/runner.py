"""Batched eval loop (flmm_tpu/evalsuite/runner.py): samples -> static
batches -> one forward per batch -> per-sample masks at the original
resolution -> host accumulators.

The forward's SAM logits stay on their device for the sigmoid, the crop of
the valid SAM region, the bilinear resize to the original size and the 0.5
threshold (one call for a sample's masks); only the binary masks go to the
host for the numpy metrics.  The JAX package resizes each probability map
with PIL's ``"F"``-mode bilinear filter; ``F.interpolate`` in bilinear mode
with ``antialias=True`` is the same triangle filter, widened by the scale
when it shrinks, and agrees with it to float rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import torch
import torch.nn.functional as F

from flmm_tpu_torch.data.collate import BatchSpec, build_batch
from flmm_tpu_torch.evalsuite.metrics import PNGAccumulator, RefSegAccumulator


def resize_prob_map(prob: torch.Tensor, out_hw: tuple[int, int]
                    ) -> torch.Tensor:
    """``(..., h, w)`` float maps -> ``(..., oh, ow)`` f32: bilinear, the
    filter widened when downscaling (PIL's resample of a float image)."""
    lead = prob.shape[:-2]
    x = prob.float().reshape(-1, 1, *prob.shape[-2:])
    out = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.reshape(*lead, *out.shape[-2:])


def sam_logits_to_masks(low_res_logits, sam_hw: tuple[int, int],
                        orig_hw: tuple[int, int], sam_size: int = 1024,
                        prompt_size: int = 256):
    """``(M, P, P)`` SAM-frame logits (a tensor on any device, or numpy) ->
    ``(M, oh, ow)`` uint8 binary masks on the host: sigmoid, the valid SAM
    region cropped, resized to the original size, thresholded at 0.5."""
    logits = torch.as_tensor(low_res_logits)
    nh, nw = sam_hw
    rh = max(1, int(round(nh * prompt_size / sam_size)))
    rw = max(1, int(round(nw * prompt_size / sam_size)))
    probs = torch.sigmoid(logits.float())[:, :rh, :rw]
    masks = resize_prob_map(probs, orig_hw) > 0.5
    return masks.to(torch.uint8).cpu().numpy()


def run_eval(samples: Iterable[dict], predict_fn: Callable, spec: BatchSpec,
             batch_size: int, accumulator_factory: Callable,
             score_fn: Callable, progress: Callable | None = None,
             seq_len_buckets: tuple | None = None,
             batch_builder: Callable | None = None):
    """The eval loop.

    Args:
      predict_fn: ``batch -> (B, M, P, P)`` low-res SAM logits, a tensor on
        any device (or numpy), from the numpy batch without ``infos``.
      score_fn: ``(acc, sample, pred_masks_orig (K, oh, ow)) -> None``.
      seq_len_buckets: optional ascending sequence-length buckets; each
        batch pads only to the smallest bucket that fits its longest sample
        instead of ``spec.seq_len``.
      batch_builder: the family's batch builder (default
        ``collate.build_batch``).

    The last batch is padded with copies of its last sample, which are not
    scored.
    """
    build = batch_builder or build_batch
    acc = accumulator_factory()
    buf = []

    def flush():
        if not buf:
            return
        pad = buf + [buf[-1]] * (batch_size - len(buf))
        bspec = spec
        if seq_len_buckets:
            need = max(len(s["input_ids"]) for s in pad)
            fits = [b for b in sorted(seq_len_buckets) if b >= need]
            bspec = dataclasses.replace(
                spec, seq_len=fits[0] if fits else max(seq_len_buckets))
        batch = build(pad, bspec)
        infos = batch.pop("infos")
        logits = torch.as_tensor(predict_fn(batch))
        geom = batch["geom"]
        for i, sample in enumerate(buf):
            k = infos[i]["num_masks"]
            masks = sam_logits_to_masks(
                logits[i, :k],
                (int(geom["sam_h"][i]), int(geom["sam_w"][i])),
                tuple(infos[i]["orig_size"]),
                sam_size=spec.sam_size, prompt_size=spec.prompt_size)
            score_fn(acc, sample, masks)
            if progress:
                progress()
        buf.clear()

    for s in samples:
        buf.append(s)
        if len(buf) == batch_size:
            flush()
    flush()
    return acc


def refcoco_score(acc: RefSegAccumulator, sample: dict, pred_masks) -> None:
    for pred, gt in zip(pred_masks, sample["masks"]):
        acc.add(pred, gt)


def png_score(acc: PNGAccumulator, sample: dict, pred_masks) -> None:
    for pred, gt, info in zip(pred_masks, sample["masks"],
                              sample["mask_infos"]):
        acc.add(pred, gt, info)
