"""The mask heads' device ms a request: CUDA events around
``flmm_tpu_torch.models.mask_head.unet.forward`` (one call a request) and
``flmm_tpu_torch.models.mask_head.refiner.refine`` (one call an image: the
prompt encoder and the mask decoder)."""

UNIT = "ms"
WRAPS = {"flmm_tpu_torch.models.mask_head.unet:forward": 1,
         "flmm_tpu_torch.models.mask_head.refiner:refine": "images"}


def read(run):
    return run.span_ms(WRAPS)
