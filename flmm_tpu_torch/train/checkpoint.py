"""Trainable-only checkpoints (flmm_tpu/train/checkpoint.py): the train
state -- trainable params, optimizer moments and update count (which is the
schedule's position), step and guard counters -- as ``step_<n>/state.pt``
under the work directory, in the port's own format (``torch.save``).  The
frozen weights are re-made at load time, as the reference re-reads them
from the upstream checkpoints.  ``restore_trainable`` also takes a released
F-LMM checkpoint and the JAX trainer's Orbax directories (read by
convert/orbax.py, without orbax, tensorstore or JAX)."""

from __future__ import annotations

import logging
import os
import pathlib
import shutil

import torch

logger = logging.getLogger(__name__)
STATE_FILE = "state.pt"


def save(path: str | pathlib.Path, state: dict) -> None:
    """Write ``state`` to the directory ``path``, replacing it whole."""
    path = pathlib.Path(path)
    if path.exists():
        logger.warning("checkpoint %s exists; overwriting", path)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(state, tmp / STATE_FILE)
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)


def _load_into(template, loaded, where: str):
    if isinstance(template, torch.Tensor):
        if not isinstance(loaded, torch.Tensor) or \
                loaded.shape != template.shape:
            raise ValueError(f"checkpoint leaf {where} does not match the "
                             "train state")
        with torch.no_grad():
            template.copy_(loaded)
        return template
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(template):
            raise ValueError(f"checkpoint keys at {where or '/'} differ from "
                             "the train state")
        return {k: _load_into(template[k], loaded[k], f"{where}/{k}")
                for k in template}
    if isinstance(template, (list, tuple)):
        if len(loaded) != len(template):
            raise ValueError(f"checkpoint list {where} has another length")
        return type(template)(_load_into(t, l_, f"{where}/{i}")
                              for i, (t, l_) in enumerate(zip(template,
                                                              loaded)))
    return loaded


def restore(path: str | pathlib.Path, template: dict) -> dict:
    """Read a checkpoint into the tensors of ``template`` (a train state of
    the same structure), which keep their devices, dtypes and grad flags."""
    loaded = torch.load(pathlib.Path(path) / STATE_FILE, map_location="cpu",
                        weights_only=True)
    return _load_into(template, loaded, "")


def restore_trainable(path: str | pathlib.Path, cfg, trainable: dict) -> dict:
    """The trainable tree from either kind of checkpoint, for ``--trained``.

    A torch-file suffix (``.pth`` / ``.bin`` / ``.pt`` / ``.safetensors``)
    is a released F-LMM checkpoint, converted by
    :func:`flmm_tpu_torch.convert.load.reference_trained` onto the device
    of ``trainable``'s leaves.  A directory that the JAX trainer's Orbax
    checkpointer wrote has its ``params`` read by
    :func:`flmm_tpu_torch.convert.orbax.read_params`; any other directory
    is one of the port's own ``step_<n>`` checkpoints.  Either way the
    trained params are read into the tensors of ``trainable``."""
    p = pathlib.Path(path)
    if str(path).endswith((".pth", ".bin", ".pt", ".safetensors")):
        from flmm_tpu_torch.convert import load as conv
        from flmm_tpu_torch.train.loop import tree_leaves

        device = next(t for _, t in tree_leaves(trainable)).device
        return conv.reference_trained(str(path), cfg, device=device)
    from flmm_tpu_torch.convert import orbax

    if orbax.is_orbax_dir(p) and not (p / STATE_FILE).exists():
        return _load_into(trainable, orbax.read_params(p, trainable),
                          "/params")
    loaded = torch.load(p / STATE_FILE, map_location="cpu",
                        weights_only=True)
    return _load_into(trainable, loaded["params"], "/params")


def latest(dirpath: str | pathlib.Path) -> pathlib.Path | None:
    """The newest ``step_<n>`` checkpoint of a directory (auto-resume)."""
    d = pathlib.Path(dirpath)
    if not d.exists():
        return None
    steps = sorted((p for p in d.iterdir() if p.is_dir()
                    and p.name.startswith("step_")
                    and p.name[5:].isdigit()),
                   key=lambda p: int(p.name[5:]))
    return steps[-1] if steps else None
