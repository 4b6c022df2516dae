"""Plain float32 reference of the grounding stack the benchmark measures.

A frozen copy, in plain PyTorch, of the unfused path of the port's
DeepSeek-VL and LLaVA-NeXT grounding models (towers, aligner or anyres
packing, frozen decoder with per-mask capture, U-Net, text projection, SAM
encoder, prompt encoder, mask decoder), of their host batch builders, of
the training loss and of the optimizer.  Everything runs in float32 with
TF32 off; it imports nothing of the program and reads its configuration
from the benchmark's own configuration files.
"""
