"""The device mesh of a data-parallel job (port of ``tti.parallel.mesh``).

``tti`` shards the frame batch over a 1-D ``"data"`` mesh of the chips one
process drives, and XLA inserts the collectives. PyTorch's idiom is one
process per card: a mesh here is a ``torch.distributed`` ``DeviceMesh``
over the initialised world (:func:`tti_torch.parallel.dcn.init_distributed`),
each rank serves the rows :func:`batch_slice` gives it, and
:func:`gather_batch` is the all-gather that turns every rank's rows back
into the global batch, as a ``P("data")``-sharded output read whole.

No model parallelism, as in ``tti``: YOLOv8n-seg fits on one card many
times over. A second axis ``"space"`` is ``tti``'s spatial partitioning of
the frame height (``create_mesh(shape, ("data", "space"))``): every rank of
a space group holds the same frames and computes a slab of their rows,
with the halo exchanges that XLA's SPMD partitioner inserts in ``tti``
done by hand (:mod:`tti_torch.parallel.spatial`; :func:`space_group` is
this rank's group of that axis).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.distributed as dist


def create_mesh(shape: tuple[int, ...] | None = None,
                axis_names: tuple[str, ...] = ("data",), device_type: str = "cuda"):
    """A ``DeviceMesh`` over the initialised world, one rank per position.
    ``shape=None`` puts every rank on axis 0. A shape that needs more ranks
    than the world has raises ``ValueError``, as ``tti``'s does, and so does
    one that needs fewer (each rank drives one card of the mesh)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise ValueError("create_mesh needs the process group: call "
                         "tti_torch.parallel.dcn.init_distributed first")
    world = dist.get_world_size()
    if not shape:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match the axes {axis_names}")
    n = math.prod(shape)
    if n != world:
        raise ValueError(f"mesh shape {shape} needs {n} ranks, the world has {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def _axis_of(mesh, axis: str) -> int | None:
    names = mesh.mesh_dim_names or ()
    return names.index(axis) if axis in names else None


def space_group(mesh):
    """(process group, rank in it, size) of this rank's row of the mesh's
    ``"space"`` axis: the ranks that hold the same frames, each a slab of
    their rows. None on a mesh without that axis."""
    if mesh is None or _axis_of(mesh, "space") is None:
        return None
    group = mesh.get_group("space")
    return group, dist.get_rank(group), dist.get_world_size(group)


def batch_slice(mesh, n: int, axis: str = "data") -> slice:
    """The rows of a global batch of ``n`` that this rank serves: its block
    of ``n / size`` along the mesh's ``axis`` (all ``n`` rows on a mesh
    without it). Every rank of a ``"space"`` group gets the same rows. A batch that is not a multiple of the axis raises
    ``ValueError``, as a ``P("data")`` sharding does."""
    dim = _axis_of(mesh, axis)
    if dim is None:
        return slice(0, n)
    size = mesh.size(dim)
    if n % size:
        raise ValueError(f"a batch of {n} does not split over the mesh's {axis!r} axis of "
                         f"{size} ranks: give a multiple of {size}")
    rows = n // size
    start = mesh.get_local_rank(axis) * rows
    return slice(start, start + rows)


def tree_map(fn: Callable[[torch.Tensor], Any], tree):
    """``fn`` on every tensor of ``tree`` (dicts, lists, tuples, named
    tuples and dataclasses of tensors; None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_leaves(tree) -> list[torch.Tensor]:
    leaves: list[torch.Tensor] = []
    tree_map(leaves.append, tree)
    return leaves


def _group(mesh, axis: str):
    return mesh.get_group(axis) if mesh is not None else dist.group.WORLD


def gather_batch(mesh, tree, axis: str = "data"):
    """All-gather along dim 0 over the mesh's ``axis``: every rank's rows of
    each tensor of ``tree``, in rank order, as the global batch. The
    tensors travel as one byte buffer, so a tree of any dtypes is one
    collective. Every rank must pass the same structure and shapes."""
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    group = _group(mesh, axis)
    world = dist.get_world_size(group)
    parts, spans, offset = [], [], 0
    for t in leaves:
        raw = t.contiguous().view(-1).view(torch.uint8)
        pad = -raw.numel() % 8  # each leaf's bytes start 8-aligned: a view of any dtype
        parts.append(raw)
        if pad:
            parts.append(raw.new_zeros(pad))
        spans.append((offset, raw.numel()))
        offset += raw.numel() + pad
    buf = torch.cat(parts)
    bufs = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(bufs, buf, group=group)
    it = iter(spans)

    def rebuild(t: torch.Tensor) -> torch.Tensor:
        start, nbytes = next(it)
        rows = [b[start:start + nbytes].view(t.dtype).view(t.shape) for b in bufs]
        return torch.cat(rows, dim=0)

    return tree_map(rebuild, tree)


def replicate(mesh, tree, axis: str = "data"):
    """Broadcast every tensor of ``tree`` (or a module's parameters and
    buffers) in place from the first rank of the mesh's ``axis`` (the
    world's rank 0 without a mesh); returns ``tree``."""
    group = _group(mesh, axis)
    src = dist.get_global_rank(group, 0) if mesh is not None else 0
    leaves = (list(tree.state_dict().values()) if isinstance(tree, torch.nn.Module)
              else tree_leaves(tree))
    with torch.no_grad():
        for t in leaves:
            dist.broadcast(t, src, group=group)
    return tree


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; the backward sums the gradient the same
    way, so that each rank's inputs receive the gradient of every rank's
    loss through the shared result."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce (sum) of ``x`` over ``group``."""
    return _AllReduceSum.apply(x, group)
