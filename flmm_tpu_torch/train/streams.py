"""The trainer's batch streams (scripts/train.py:94-234): the synthetic
stream of every family, and the PNG + RefCOCO/+/g joint stream over the
files under a data root, read by the port's PIL-free readers.

A stream yields numpy batches (``infos`` dropped); the trainer moves them
to its device.  Both start at a given step, so a resumed run trains on the
batches the uninterrupted run would have reached.
"""

from __future__ import annotations

import pathlib
from typing import Iterator

import numpy as np

from flmm_tpu_torch import registry
from flmm_tpu_torch.data.collate import BatchSpec
from flmm_tpu_torch.data.loader import EpochSampler, PrefetchLoader
from flmm_tpu_torch.data.png import PNGDataset
from flmm_tpu_torch.data.processors import ProcessorConfig
from flmm_tpu_torch.data.refcoco import RefCocoDataset, refcoco_to_sample
from flmm_tpu_torch.data.synthetic import synthetic_batch, \
    synthetic_grounding_batch, synthetic_samples

# the families whose synthetic batches come whole from synthetic_batch; the
# others run synthetic samples through their own builders
STANDARD = tuple(f for f, kind in registry.BATCH_BUILDERS.items()
                 if kind == "standard")
# (directory under the data root, split pickle) of the referring sets
REFCOCO_SETS = (("refcoco", "refs(unc).p"), ("refcoco+", "refs(unc).p"),
                ("refcocog", "refs(umd).p"))


def _drop_infos(batch: dict) -> dict:
    return {k: v for k, v in batch.items() if k != "infos"}


def synthetic_stream(family: str, cfg, task: str, batch_size: int,
                     start: int, steps: int) -> Iterator[dict]:
    """Batches ``start .. steps - 1``, batch ``i`` made from seed ``i``:
    ``task`` 'random' (the schema smoke) or 'grounding' (the derivable
    coloured rectangles, standard families only).  For llava_next and mgm,
    ``synthetic_samples`` through the family's builder bound to ``cfg``'s
    processing spec, with scripts/train.py's batch spec (the longest
    sample + 16 tokens, 2 masks of 8 text tokens)."""
    base = cfg.base if hasattr(cfg, "base") else cfg
    if task == "grounding" and family not in STANDARD:
        raise ValueError(f"the grounding task has standard batches only "
                         f"({', '.join(STANDARD)}), not {family}'s")
    for i in range(start, steps):
        if task == "grounding":
            yield synthetic_grounding_batch(base, batch_size=batch_size,
                                            seed=i)
        elif family in STANDARD:
            yield synthetic_batch(base, batch_size=batch_size, seed=i)
        else:
            samples = synthetic_samples(cfg, batch_size, seed=i)
            spec = BatchSpec(
                seq_len=max(len(s["input_ids"]) for s in samples) + 16,
                max_masks=2, text_per_mask=8,
                coarse_hw=registry.get_coarse_hw(cfg),
                sam_size=base.sam.encoder.img_size,
                prompt_size=base.sam.prompt_size,
                processor=ProcessorConfig(size=base.input_size))
            yield _drop_infos(registry.get_batch_builder(family, cfg)(
                samples, spec))


class JointStream:
    """PNG and RefCOCO / RefCOCO+ / RefCOCOg (those present under the data
    root) in one index space (the reference's ``concat_datasets``), shuffled
    each epoch by ``EpochSampler(seed=0)`` and built ahead by a
    ``PrefetchLoader``; the trailing partial batch of an epoch is dropped.

    A RefCOCO image with more than ``max_masks`` expressions keeps a random
    ``max_masks`` of them, drawn from a generator seeded with (epoch,
    index), so a run repeats (scripts/train.py draws unseeded)."""

    def __init__(self, data_root: str, tokenizer, prompt, build,
                 spec: BatchSpec, batch_size: int, num_workers: int = 4):
        root = pathlib.Path(data_root)
        ann = root / "annotations"
        self.datasets = [PNGDataset(
            json_file=str(ann / "png_coco_train2017.json"),
            panoptic_json_file=str(ann / "panoptic_train2017.json"),
            panoptic_png_path=str(ann / "panoptic_train2017"),
            image_path=str(root / "train2017"),
            tokenizer=tokenizer, prompt_spec=prompt)]
        self.datasets += [RefCocoDataset(
            ann_file=str(root / name / "instances.json"),
            split_file=str(root / name / split_file),
            image_path=str(root / "train2014"), split="train")
            for name, split_file in REFCOCO_SETS if (root / name).exists()]
        self.tokenizer, self.prompt = tokenizer, prompt
        self.build, self.spec = build, spec
        self.batch_size, self.num_workers = batch_size, num_workers
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])
        self.sampler = EpochSampler(len(self), seed=0, shuffle=True)

    def __len__(self) -> int:
        return int(self.offsets[-1])

    @property
    def batches_per_epoch(self) -> int:
        return len(self) // self.batch_size

    def sample(self, gidx: int, epoch: int) -> dict:
        """Sample ``gidx`` of the joint index space in ``epoch``."""
        di = int(np.searchsorted(self.offsets, gidx, side="right")) - 1
        item = self.datasets[di][gidx - int(self.offsets[di])]
        if di == 0:
            return item
        return refcoco_to_sample(
            item, self.tokenizer, self.prompt, concat=True,
            rng=np.random.default_rng([epoch, gidx]),
            max_expressions=self.spec.max_masks, subsample=True)[0]

    def batches(self, start: int, steps: int) -> Iterator[dict]:
        """Batches ``start .. steps - 1`` over the epochs: batch ``k`` is
        batch ``k % batches_per_epoch`` of epoch ``k // batches_per_epoch``,
        and the batches before ``start`` are skipped unbuilt."""
        per_epoch = self.batches_per_epoch
        if per_epoch == 0:
            raise ValueError(f"{len(self)} samples under the data root hold "
                             f"no batch of {self.batch_size}")
        epoch, skip = divmod(start, per_epoch)
        done = start
        while done < steps:
            loader = PrefetchLoader(
                lambda i, e=epoch: self.sample(i, e),
                lambda samples: _drop_infos(self.build(samples, self.spec)),
                self.sampler, batch_size=self.batch_size,
                num_workers=self.num_workers)
            for batch in loader.epoch(epoch, start=skip):
                yield batch
                done += 1
                if done >= steps:
                    return
            epoch, skip = epoch + 1, 0
