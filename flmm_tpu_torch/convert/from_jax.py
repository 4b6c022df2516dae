"""Weight bridge: a numpy copy of a flmm_tpu parameter tree -> port params.

The port keeps the JAX layouts (linear weights ``(in, out)`` applied as
``x @ w``, HWIO conv kernels, stacked ``(L, ...)`` layer weights), so the
bridge only converts leaves: each array becomes a tensor of the same shape
and dtype on ``device``.  That covers the MGM tree as it is: the ConvNeXt
``aux_tower`` (HWIO kernels, which its forward turns to OIHW), the f32
``uni_*`` resampler projections and a MoE decoder's ``router`` ``(L, d,
E)`` and expert stacks ``(L, E, d, f)``.  bf16 arrays (``ml_dtypes.bfloat16`` when they come
from JAX) go through their bit pattern, since numpy has no bf16.
"""

from __future__ import annotations

import numpy as np
import torch

# the leaf types of parameter trees and batches
_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
    "bool": torch.bool,
}


def to_tensor(a, device="cpu") -> torch.Tensor:
    """One numpy array (or scalar) -> tensor of the same shape and dtype."""
    a = np.asarray(a)
    name = str(a.dtype)
    if name not in _DTYPES:
        raise TypeError(f"unsupported dtype {name}")
    if name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .astype(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def from_jax(tree, device="cpu"):
    """Map a nested dict/list tree of numpy arrays (e.g.
    ``jax.device_get(params)``) to the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax(v, device) for v in tree)
    return to_tensor(tree, device)
