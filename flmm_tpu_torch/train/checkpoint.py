"""Trainable-only checkpoints (flmm_tpu/train/checkpoint.py): the train
state -- trainable params, optimizer moments and update count (which is the
schedule's position), step and guard counters -- as ``step_<n>/state.pt``
under the work directory, in the port's own format (``torch.save``).  The
frozen weights are re-made at load time, as the reference re-reads them
from the upstream checkpoints.  Reading the JAX package's Orbax directories
is not ported."""

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
