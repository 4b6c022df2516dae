"""The optimizer's device ms a step: CUDA events around the ``update`` of
the optimizer ``flmm_tpu_torch.train.loop.make_optimizer`` returns
(global-norm clipping and AdamW over the trained leaves), one call a
step."""

UNIT = "ms"
WRAPS = {"flmm_tpu_torch.train.loop:make_optimizer().update": 1}


def read(run):
    return run.span_ms(WRAPS)
