"""The backward's device ms a step: CUDA events around
``flmm_tpu_torch.train.loop.gradients`` (autograd through the U-Net, the
text projection and the SAM prompt encoder and mask decoder), one call a
step."""

UNIT = "ms"
WRAPS = {"flmm_tpu_torch.train.loop:gradients": 1}


def read(run):
    return run.span_ms(WRAPS)
