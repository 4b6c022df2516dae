"""The SAM image encoder's device ms a request: CUDA events around
``flmm_tpu_torch.models.sam.image_encoder.forward``, one call a request
(K1, K2, K3 / K4 inside it)."""

UNIT = "ms"
WRAPS = {"flmm_tpu_torch.models.sam.image_encoder:forward": 1}


def read(run):
    return run.span_ms(WRAPS)
