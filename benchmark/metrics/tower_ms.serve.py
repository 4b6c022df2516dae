"""The vision tower's device ms a request: CUDA events around each call of
``flmm_tpu_torch.models.vision.vit.forward`` (the base view and the tiles
in one call on LLaVA-NeXT), one call a request."""

UNIT = "ms"
WRAPS = {"flmm_tpu_torch.models.vision.vit:forward": 1}


def read(run):
    return run.span_ms(WRAPS)
