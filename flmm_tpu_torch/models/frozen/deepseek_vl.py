"""Frozen DeepSeek-VL grounding family (flmm_tpu/models/frozen/deepseek_vl.py):
an alias onto the contiguous-image-block grounding core; the DeepSeek
specifics live in configs/deepseek_vl.py."""

from flmm_tpu_torch.models.frozen.grounding import (  # noqa: F401
    GroundingConfig as DeepseekVLGroundingConfig,
    forward,
    init_params,
    loss_fn,
)
