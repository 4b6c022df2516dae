"""flmm_tpu_torch: the PyTorch + CUDA port of flmm_tpu for NVIDIA Hopper.

Plain tensor code is PyTorch; every Pallas kernel of flmm_tpu that the
ported path runs has a hand-written CUDA kernel in ``csrc/``, built for
``sm_90a`` at first use and bound with ctypes (``ops/_cuda.py``).  Layouts
follow the JAX package: NHWC images, ``(B, S, D)`` tokens, window-major
``(NW, T, C)``, ``(in, out)`` linear weights and HWIO conv kernels, with
the same parameter-tree keys, so ``convert.from_jax`` carries a flmm_tpu
tree over leaf by leaf.  The package never imports JAX.
"""
