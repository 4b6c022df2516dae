"""Sequence sharding of the frozen decoder (the ``P('data', 'model', None)``
layout that flmm_tpu/models/llm/decoder.py's ``shard_constraint`` puts on
the residual stream, on ``torch.distributed``).

A mesh axis splits the sequence by rows in GSPMD's layout: ``chunk =
ceil(S / n)`` and rank ``r`` holds the rows ``[r * chunk, min(S, (r + 1) *
chunk))``, so S = 99 over 2 ranks is 50 + 49.  Each rank runs the
projections, the MLP and the layer-weighted sum on its own rows; only the
keys and values cross ranks (:func:`gather_rows`, after RoPE), and the
capture is finished once over the stacked layers:

* mean merge: each rank's rows of the global, pre-normalised merge matrix
  give a partial sum; the partials are summed in f32, never renormalised;
* max merge: each rank's masked maximum, reduced with MAX, then the empty
  mask's 0;
* raw capture: the rows gathered along S

(:func:`finish_capture`).  ``hidden`` and ``last_hidden`` are gathered
along S at the end, so every rank returns the whole outputs.

The decoder's own entry is ``decoder.forward_capture(..., seq_axis=...)``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from flmm_tpu_torch.parallel.mesh import Axis, all_gather_cat


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's rows ``[start, stop)`` of ``S`` over ``axis``."""
    axis: Axis
    S: int
    chunk: int
    start: int
    stop: int

    @property
    def rows(self) -> slice:
        return slice(self.start, self.stop)


def split_rows(S: int, axis: Axis) -> RowShard:
    """GSPMD's split of ``S`` rows over ``axis``; refuses a layout that
    leaves a rank without rows."""
    chunk = -(-S // axis.size)
    if chunk * (axis.size - 1) >= S:
        raise ValueError(f"S = {S} over {axis.size} ranks in chunks of "
                         f"{chunk} leaves the last rank no rows")
    start = axis.index * chunk
    return RowShard(axis, S, chunk, start, min(S, start + chunk))


def gather_rows(x: torch.Tensor, dim: int, shard: RowShard) -> torch.Tensor:
    """Every rank's rows of ``x`` along ``dim``, in order: each part padded
    to ``chunk`` rows, gathered through ``mesh.all_gather_cat``, the pads
    cut (only the last rank is short)."""
    if shard.axis.size == 1:
        return x
    pad = shard.chunk - x.shape[dim]
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    return all_gather_cat(x, dim, shard.axis).narrow(dim, 0, shard.S)


def finish_capture(attn: torch.Tensor, form: str,
                   shard: RowShard) -> torch.Tensor:
    """The whole capture from this rank's ``(B, L, H, ...)`` part: ``'mean'``
    partial sums added, ``'max'`` masked maxima (finfo min where a mask has
    no row here) reduced and a mask without rows set to 0, ``'raw'`` the
    ``(B, L, H, S_loc, n_img)`` rows gathered along S."""
    if form == "raw":
        return gather_rows(attn, 3, shard)
    if form not in ("mean", "max"):
        raise ValueError(form)
    side = attn.float().contiguous()
    if shard.axis.size > 1:
        op = dist.ReduceOp.SUM if form == "mean" else dist.ReduceOp.MAX
        dist.all_reduce(side, op=op, group=shard.axis.group)
    if form == "max":
        big_neg = torch.finfo(torch.float32).min
        side = torch.where(side <= big_neg / 2, 0.0, side)
    return side
