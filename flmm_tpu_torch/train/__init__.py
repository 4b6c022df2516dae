"""Training of the grounding heads on the port (flmm_tpu/train): the
optimizer and train step (``loop``), diagnostics, checkpoints, and the
trainer entry point ``python -m flmm_tpu_torch.train``."""
