"""Interactive SAM predictor (flmm_tpu/models/sam/predictor.py; reference
segment_anything/predictor.py): ``set_image`` embeds an image once through
the SAM encoder, then ``predict`` takes point, box and mask prompts in the
image's own pixels and returns masks at the image's size with the IoU
predictions and the low-res logits.

The encoder runs on ``device``, where the params must live: on the card it
launches the encoder's kernels (K1-K4 at SAM-1024), on the CPU their plain
versions.  The prompt encoder and mask decoder are plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from flmm_tpu_torch.data.processors import sam_preprocess
from flmm_tpu_torch.evalsuite.runner import resize_prob_map
from flmm_tpu_torch.models.mask_head.refiner import SamRefinerConfig
from flmm_tpu_torch.models.sam import image_encoder as sam_encoder
from flmm_tpu_torch.models.sam import mask_decoder as sam_decoder
from flmm_tpu_torch.models.sam import prompt_encoder as sam_prompt


def low_res_to_masks(low_res: torch.Tensor, input_size: tuple[int, int],
                     original_size: tuple[int, int], cfg: SamRefinerConfig
                     ) -> torch.Tensor:
    """``(C, P, P)`` low-res logits -> ``(C, H, W)`` logits at the image's
    size: the valid SAM region ``round(n * P / img)`` cropped and resized
    bilinearly (the reference's ``postprocess_masks``), on the logits'
    device."""
    nh, nw = input_size
    P, img = cfg.prompt_size, cfg.encoder.img_size
    rh = max(1, int(round(nh * P / img)))
    rw = max(1, int(round(nw * P / img)))
    return resize_prob_map(low_res[:, :rh, :rw], original_size)


def encode_image(params: dict, cfg: SamRefinerConfig, image: np.ndarray,
                 device) -> tuple[torch.Tensor, tuple[int, int]]:
    """An ``(H, W, 3)`` uint8 image -> its ``(S, S, D)`` SAM embedding on
    ``device`` and its size in the SAM frame."""
    pre = sam_preprocess(image, cfg.encoder.img_size)
    pixels = torch.as_tensor(pre["sam_pixel_values"], device=device)
    with torch.no_grad():
        embed = sam_encoder.forward(params["encoder"], cfg.encoder,
                                    pixels[None])[0]
    return embed, pre["sam_input_size"]


class SamPredictor:
    def __init__(self, params: dict, cfg: SamRefinerConfig, device="cuda"):
        """``params``: the {'encoder', 'prompt', 'decoder'} trees on
        ``device``."""
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device)
        self.embed = None
        self.original_size = None
        self.input_size = None

    def set_image(self, image: np.ndarray) -> None:
        """Embed an ``(H, W, 3)`` uint8 image (reference ``set_image``)."""
        self.embed, self.input_size = encode_image(
            self.params, self.cfg, image, self.device)
        self.original_size = tuple(image.shape[:2])

    def _transform_coords(self, coords: np.ndarray) -> np.ndarray:
        oh, ow = self.original_size
        nh, nw = self.input_size
        out = coords.astype(np.float32).copy()
        out[..., 0] *= nw / ow
        out[..., 1] *= nh / oh
        return out

    @torch.no_grad()
    def predict(self, point_coords: np.ndarray | None = None,
                point_labels: np.ndarray | None = None,
                box: np.ndarray | None = None,
                mask_input: np.ndarray | None = None,
                multimask_output: bool = True) -> tuple:
        """Masks for one prompt set.

        Args mirror the reference: ``point_coords`` ``(N, 2)`` xy in the
        image's pixels with ``point_labels`` 1 / 0, ``box`` ``(4,)`` xyxy,
        ``mask_input`` ``(1, P, P)`` low-res logits.  Returns numpy
        ``(masks (C, H, W) bool, iou_pred (C,), low_res_logits (C, P,
        P))``: C is 3 with ``multimask_output``, else 1.
        """
        if self.embed is None:
            raise RuntimeError("SamPredictor.predict: call set_image first")
        cfg, pcfg, dev = self.cfg, self.cfg.prompt, self.device
        p = self.params["prompt"]
        sparse = [torch.zeros((1, 0, pcfg.embed_dim), dtype=pcfg.dtype,
                              device=dev)]
        if point_coords is not None:
            pts = self._transform_coords(np.asarray(point_coords))[None]
            labs = np.asarray(point_labels, np.int32)[None]
            sparse.append(sam_prompt.embed_points(
                p, pcfg, torch.as_tensor(pts, device=dev),
                torch.as_tensor(labs, device=dev), pad=box is None))
        if box is not None:
            b = self._transform_coords(
                np.asarray(box, np.float32).reshape(2, 2)).reshape(1, 4)
            sparse.append(sam_prompt.embed_boxes(
                p, pcfg, torch.as_tensor(b, device=dev)))
        if mask_input is not None:
            dense = sam_prompt.embed_masks(p, pcfg, torch.as_tensor(
                np.array(mask_input, np.float32), device=dev).reshape(
                    1, cfg.prompt_size, cfg.prompt_size, 1))
        else:
            dense = sam_prompt.no_mask_dense(p, pcfg, 1)
        masks, iou = sam_decoder.forward(
            self.params["decoder"], cfg.decoder, self.embed,
            sam_prompt.dense_pe(p, pcfg), torch.cat(sparse, dim=1), dense)
        sl = slice(1, None) if multimask_output else slice(0, 1)
        low_res = masks[0, sl].float()
        out = low_res_to_masks(low_res, self.input_size, self.original_size,
                               cfg) > 0.0
        return (out.cpu().numpy(), iou[0, sl].float().cpu().numpy(),
                low_res.cpu().numpy())
