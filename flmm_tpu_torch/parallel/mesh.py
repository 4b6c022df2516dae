"""Process groups, the ``("data", "model")`` mesh and the sharding rules
(flmm_tpu/parallel/mesh.py on ``torch.distributed``).

* :func:`process_group` starts the default group from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``): nccl on ``cuda:LOCAL_RANK``, gloo when the caller asks
  for the CPU.  Without that environment it makes a group of one over a
  ``FileStore`` in a temporary directory, so no TCP port is needed.
* :func:`make_mesh` lays the ranks out as a ``DeviceMesh`` with dims
  ``("data", "model")``: batches split over ``"data"``, the frozen decoder
  and SAM encoder over ``"model"``.
* The rule tables are the JAX package's, kept as the port's own copy: a
  spec is a tuple with one entry per dim, the mesh axis that splits it or
  None, as the entries of a JAX ``PartitionSpec``; ``()`` is replicated.
  :func:`param_shardings` gives a tree of them for a parameter tree,
  ``mode='tp'`` (attention heads and FFN columns, megatron style) or
  ``mode='fsdp'`` (the layer stack); :func:`batch_shardings` and
  :func:`replicated` those of batches and of the trainable tree.
* :func:`local_shard` takes this rank's contiguous block of a leaf along
  each split dim, :func:`gather_shard` puts the blocks back together in
  rank order.

The collectives (:func:`all_reduce`, :func:`all_gather_cat`,
:func:`broadcast`, :func:`send`, :func:`recv`) take CUDA tensors on nccl
and on gloo; gloo sends and receives no CUDA tensor (its TCP transport
reads the device pointer as a host one), so those two stage through pinned
host buffers there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist

# ---------------------------------------------------------------------------
# Process groups and the mesh.
# ---------------------------------------------------------------------------

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def launched_by_torchrun() -> bool:
    return all(k in os.environ for k in TORCHRUN_ENV)


@contextlib.contextmanager
def process_group(device: str = "cuda"):
    """The default process group for the block; yields this rank's device.

    An existing group is used as it is and left open.  Otherwise the group
    comes from torchrun's environment (nccl on ``cuda:LOCAL_RANK``; gloo
    with ``device='cpu'``) or, without it, is a group of one over a
    ``FileStore``; it is destroyed when the block ends."""
    cuda = torch.device(device).type == "cuda"
    if dist.is_initialized():
        yield _rank_device(cuda)
        return
    backend = "nccl" if cuda else "gloo"
    with contextlib.ExitStack() as stack:
        if launched_by_torchrun():
            if cuda:
                torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
            dist.init_process_group(backend, init_method="env://")
        else:
            tmp = stack.enter_context(tempfile.TemporaryDirectory())
            store = dist.FileStore(os.path.join(tmp, "store"), 1)
            dist.init_process_group(backend, store=store, rank=0,
                                    world_size=1)
        try:
            yield _rank_device(cuda)
        finally:
            dist.destroy_process_group()


def _rank_device(cuda: bool) -> torch.device:
    if not cuda:
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                   torch.cuda.current_device())))


def pick_n_data(batch_size: int, n_model: int = 1) -> int:
    """The largest data axis that divides the batch and fits the world
    with ``n_model`` ranks a replica (scripts/train.py:305-309)."""
    avail = dist.get_world_size() // n_model
    if avail < 1:
        raise ValueError(f"--n-model {n_model} needs at least {n_model} "
                         f"ranks; the world has {dist.get_world_size()}")
    return max(d for d in range(1, avail + 1) if batch_size % d == 0)


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device_type: str | None = None):
    """A ``DeviceMesh`` of the first ``n_data * n_model`` ranks laid out
    ``(n_data, n_model)`` with dims ``("data", "model")``.  Every rank of
    the world calls it; a rank outside the mesh gets one whose
    ``get_coordinate()`` is None."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_data * n_model > world:
        raise ValueError(f"a {n_data} x {n_model} mesh does not fit a world "
                         f"of {world}")
    if device_type is None:
        device_type = "cpu" if dist.get_backend() == "gloo" and not \
            torch.cuda.is_available() else "cuda"
    names = ("data", "model")
    if n_data * n_model == world:
        return init_device_mesh(device_type, (n_data, n_model),
                                mesh_dim_names=names)
    ranks = torch.arange(n_data * n_model).reshape(n_data, n_model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def mesh_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its group, size and index."""
    group: Any
    size: int
    index: int


def axis_of(mesh, axis: str) -> Axis:
    return Axis(mesh.get_group(axis), mesh_size(mesh, axis),
                mesh.get_local_rank(axis))


# ---------------------------------------------------------------------------
# Sharding rules: parameter-tree paths -> specs.
# ---------------------------------------------------------------------------

_DECODER_RULES = {
    # stacked decoder layers: (L, in, out)
    "wq": (None, None, "model"),
    "wk": (None, None, "model"),
    "wv": (None, None, "model"),
    "wo": (None, "model", None),
    "w_gate": (None, None, "model"),
    "w_up": (None, None, "model"),
    "w_down": (None, "model", None),
    "bq": (None, "model"),
    "bk": (None, "model"),
    "bv": (None, "model"),
    "embed": (None, None),
    "lm_head": (None, "model"),
}

# MoE decoders (Mixtral): the experts split over the model axis
_MOE_RULES = {
    "w_gate": (None, "model", None, None),
    "w_up": (None, "model", None, None),
    "w_down": (None, "model", None, None),
    "router": (None, None, None),
}

_SAM_ENC_RULES = {
    # per-block linears: (in, out)
    "wqkv": (None, "model"),
    "wo": ("model", None),
    "w1": (None, "model"),
    "w2": ("model", None),
    "b1": ("model",),
    "bqkv": ("model",),
}

_FSDP_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                    "ln1", "ln2", "bq", "bk", "bv", "router")


def _names(path: tuple) -> list:
    """The dict keys of a tree path (list indices dropped, as JAX's
    ``p.key`` skips sequence keys)."""
    return [p for p in path if isinstance(p, str)]


def _ndim(leaf) -> int:
    return getattr(leaf, "ndim", 0)


def _spec_for(path: tuple, leaf: Any) -> tuple:
    names = _names(path)
    key = names[-1] if names else ""
    if "llm" in names:
        for rules in (_MOE_RULES, _DECODER_RULES):
            if key in rules and _ndim(leaf) == len(rules[key]):
                return rules[key]
    if "sam_encoder" in names and key in _SAM_ENC_RULES \
            and _ndim(leaf) == len(_SAM_ENC_RULES[key]):
        return _SAM_ENC_RULES[key]
    return ()


def _fsdp_spec_for(path: tuple, leaf: Any, n_model: int = 1) -> tuple:
    """The stacked layer axis of the decoder's weights over ``"model"``
    (a leaf whose layer count the axis does not divide stays replicated);
    ``embed`` / ``lm_head`` by columns where the axis divides them."""
    names = _names(path)
    key = names[-1] if names else ""
    if "llm" in names and key in _FSDP_LAYER_KEYS:
        if _ndim(leaf) >= 2 and leaf.shape[0] % n_model == 0:
            return ("model",) + (None,) * (_ndim(leaf) - 1)
    if key in ("embed", "lm_head") and _ndim(leaf) == 2 \
            and leaf.shape[1] % n_model == 0:
        return (None, "model")
    return ()


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a nested dict / list / tuple tree, the same
    structure back; ``path`` holds the dict keys and list indices."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(mesh, params: Any, mode: str = "tp") -> Any:
    """The spec of every leaf of a parameter tree (frozen or whole).

    ``mode='tp'``: head / FFN column sharding (compute-parallel);
    ``mode='fsdp'``: layer-stack sharding (weight-memory-parallel)."""
    if mode == "tp":
        return tree_map_with_path(_spec_for, params)
    if mode != "fsdp":
        raise ValueError(f"mode {mode!r}: 'tp' or 'fsdp'")
    n_model = mesh_size(mesh, "model")
    return tree_map_with_path(
        lambda path, leaf: _fsdp_spec_for(path, leaf, n_model), params)


def batch_shardings(mesh, batch: Any) -> Any:
    """Every batch leaf split over ``"data"`` on axis 0."""
    return tree_map_with_path(
        lambda _, x: ("data",) + (None,) * (_ndim(x) - 1), batch)


def replicated(mesh, tree: Any) -> Any:
    return tree_map_with_path(lambda *_: (), tree)


# ---------------------------------------------------------------------------
# Shards and collectives.
# ---------------------------------------------------------------------------

def local_shard(leaf: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's contiguous block of ``leaf`` along every dim ``spec``
    splits (a copy, so the whole leaf can be freed)."""
    out = leaf
    for dim, name in enumerate(spec):
        if name is None:
            continue
        ax = axis_of(mesh, name)
        if leaf.shape[dim] % ax.size:
            raise ValueError(f"dim {dim} of a {tuple(leaf.shape)} leaf does "
                             f"not split into {ax.size} over {name!r}")
        out = out.chunk(ax.size, dim=dim)[ax.index]
    return out.clone() if out is not leaf else leaf


def gather_shard(local: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from the blocks :func:`local_shard` took, in rank
    order along each split dim."""
    out = local
    for dim, name in reversed(list(enumerate(spec))):
        if name is not None:
            out = all_gather_cat(out, dim, axis_of(mesh, name))
    return out


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the group in place; returns it."""
    dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order."""
    if axis.size == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t.contiguous(), group=axis.group)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, src: int, group=None, async_op: bool = False):
    """``t`` from the group rank ``src`` (a rank of the group, not of the
    world) in place; with ``async_op`` the work handle."""
    return dist.broadcast(t, dist.get_global_rank(group, src)
                          if group is not None else src,
                          group=group, async_op=async_op)


def send(t: torch.Tensor, dst: int, group=None) -> None:
    """``t`` to the group rank ``dst``."""
    dst = dist.get_global_rank(group, dst) if group is not None else dst
    if t.is_cuda and _gloo(group):
        t = t.to("cpu")
    dist.send(t.contiguous(), dst, group=group)


def recv(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Into ``t`` from the group rank ``src``; returns ``t``."""
    src = dist.get_global_rank(group, src) if group is not None else src
    if t.is_cuda and _gloo(group):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        dist.recv(host, src, group=group)
        return t.copy_(host)
    dist.recv(t, src, group=group)
    return t


def shard_rows(batch: Any, axis: Axis) -> Any:
    """This rank's block of rows of every batch leaf (numpy or tensor),
    the ``("data", ...)`` spec of :func:`batch_shardings`; the axis must
    divide the batch."""
    def rows(_, x):
        if x.shape[0] % axis.size:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"over {axis.size} data ranks")
        n = x.shape[0] // axis.size
        return x[axis.index * n:(axis.index + 1) * n]
    return tree_map_with_path(rows, batch)
