"""Model export for serving (flmm_tpu/convert/export.py): ``torch.export``
programs in the place of ``jax.export``'s StableHLO artifacts.

The deployment analogue of the reference's ONNX export
(segment_anything/utils/onnx.py: SamOnnxModel, the decoder alone for light
clients): a function and its params are traced to an ``ExportedProgram``
and saved to one file, which ``load_fn`` turns back into a callable that
needs none of the port's model code.
"""

from __future__ import annotations

import pathlib

import torch

from flmm_tpu_torch.models.sam import mask_decoder as smd
from flmm_tpu_torch.models.sam import prompt_encoder as spe


class _Fn(torch.nn.Module):
    """``fn`` as a module, so that every argument, the params included, is
    an input of the exported program."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_fn(fn, example_args, path: str | pathlib.Path) -> None:
    """Trace ``fn(*example_args)`` (tensors and pytrees of tensors, on the
    device they will be called on) with ``torch.export`` and save it."""
    with torch.no_grad():
        exported = torch.export.export(_Fn(fn), tuple(example_args))
    torch.export.save(exported, str(path))


def load_fn(path: str | pathlib.Path):
    """The callable of an exported function, taking the same arguments."""
    return torch.export.load(str(path)).module()


def export_sam_decoder(params: dict, cfg, path: str | pathlib.Path,
                       max_text: int = 16) -> None:
    """Export the SAM prompt + mask decoder (the reference's SamOnnxModel
    scope) for one prompt: inputs are ``params`` ({'prompt', 'decoder'}),
    the image embedding ``(s, s, d)``, a box ``(1, 4)``, the dense prompt
    mask ``(1, P, P)`` and padded text tokens ``(1, max_text, d)`` with
    their validity ``(1, max_text)`` bool; outputs the low-res mask logits
    ``(1, n_tokens, P, P)`` and the IoU predictions ``(1, n_tokens)``.
    ``cfg`` is the ``SamRefinerConfig``; the example inputs are made on the
    params' device."""
    s = cfg.prompt.image_embedding_size
    d = cfg.prompt.embed_dim

    def decode(params, image_embedding, boxes, prompt_masks, text, tvalid):
        sparse = torch.cat([
            spe.embed_boxes(params["prompt"], cfg.prompt, boxes),
            text.to(image_embedding.dtype)], dim=1)
        valid = torch.cat([torch.ones((boxes.shape[0], 2), dtype=torch.bool,
                                      device=tvalid.device), tvalid], dim=1)
        dense = spe.embed_masks(params["prompt"], cfg.prompt,
                                prompt_masks[..., None])
        pe = spe.dense_pe(params["prompt"], cfg.prompt)
        return smd.forward(params["decoder"], cfg.decoder, image_embedding,
                           pe, sparse, dense, sparse_valid=valid)

    dev = params["prompt"]["pe_gaussian"].device
    m = 1
    example = (
        params,
        torch.zeros((s, s, d), device=dev),
        torch.zeros((m, 4), device=dev),
        torch.zeros((m, cfg.prompt_size, cfg.prompt_size), device=dev),
        torch.zeros((m, max_text, d), device=dev),
        torch.zeros((m, max_text), dtype=torch.bool, device=dev),
    )
    export_fn(decode, example, path)
