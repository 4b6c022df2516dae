"""The frozen decoder with the per-mask capture, device ms a request: CUDA
events around ``flmm_tpu_torch.models.llm.decoder.forward_capture`` (eager
on DeepSeek-VL, K5 on LLaVA-NeXT), one call a request."""

UNIT = "ms"
WRAPS = {"flmm_tpu_torch.models.llm.decoder:forward_capture": 1}


def read(run):
    return run.span_ms(WRAPS)
