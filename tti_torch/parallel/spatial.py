"""Spatial partitioning: the frame's height split over the ranks of a
``"space"`` mesh axis (the port's counterpart of ``tti``'s
``frame_sharding``, tti/parallel/mesh.py:43).

``tti`` shards the model input's rows over a ``space`` axis and XLA's SPMD
partitioner inserts the halo exchanges. PyTorch has no such partitioner, so
this module does its work by hand:

- **the slab plan** (:func:`slab_plan`): each rank of a space group holds a
  slab of whole P5 rows (``UNIT`` = 32 model-input rows, the largest
  stride), so that every level's slab is whole rows, the stride-2
  convolutions stay aligned and the nearest upsample needs no halo. The P5
  rows are split as evenly as possible, the first ranks taking one more;
- **the halo** (:meth:`Space.halo`): before a convolution or pool that
  reads across rows, each rank takes the rows it needs from the ranks that
  hold them (one batch of point-to-point sends and receives; from further
  than a neighbour when a slab is thinner than the halo) and fills with the
  op's own padding value where the frame ends;
- **the MAX all-reduce** of int8's per-sample scales (:meth:`Space.max`),
  so that every slab quantizes with its whole sample's scale;
- **the gather** (:meth:`Space.gather_rows`): each head level's output and
  the protos, every rank's slab in order along H (padded to the largest
  slab and trimmed), so that the global stages see the unsharded tensors.

The modules that read across rows (``Conv``, ``SPPF``, ``Segment``'s shared
entry, the stem in ``YOLOv8Seg``) hold a ``space`` attribute, None unless
:func:`set_space` gives them this rank's :class:`Space`; with None they run
exactly as without a mesh. A space axis of one rank is no partitioning:
:func:`space_of` gives None for it, as XLA inserts nothing on such an axis.

The transport is a ``torch.distributed`` group (:class:`GroupTransport`):
NCCL moves the rows card to card. gloo's point-to-point ops take host
tensors only, so on a gloo group the halo rows of a CUDA tensor go through
the host; gloo's collectives (the MAX all-reduce, the gather) take CUDA
tensors as they are. Any other object with the same three methods serves
(the tests exchange between threads of one process).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from tti_torch.core.errors import ConfigError
from tti_torch.parallel.mesh import space_group, tree_leaves, tree_map

UNIT = 32  # model-input rows per P5 row: the largest stride

# Per process, since the last reset: halo exchanges (calls), the bytes each
# rank sent in them, MAX all-reduces, row gathers and the bytes each rank
# received in them (every rank's padded slabs, its own included).
COUNTS = {"halo": 0, "halo_bytes": 0, "max": 0, "gather": 0, "gather_bytes": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


@dataclass(frozen=True)
class SlabPlan:
    """P5 rows per rank of a space group, in rank order."""

    counts: tuple[int, ...]

    @property
    def total(self) -> int:
        return sum(self.counts)

    def bounds(self, rank: int) -> tuple[int, int]:
        """[start, stop) of ``rank``'s P5 rows."""
        start = sum(self.counts[:rank])
        return start, start + self.counts[rank]

    def input_rows(self, rank: int) -> tuple[int, int]:
        """[start, stop) of ``rank``'s model-input rows."""
        start, stop = self.bounds(rank)
        return UNIT * start, UNIT * stop


def slab_plan(height: int, size: int) -> SlabPlan:
    """The slabs of a model input of ``height`` rows over ``size`` ranks:
    its ``height / 32`` P5 rows as evenly as possible, the first ranks one
    more. A height off the 32-row grid, or more ranks than P5 rows, raises
    ``ConfigError``."""
    if height % UNIT:
        raise ConfigError(f"a space mesh splits the model input on {UNIT}-row P5 rows; "
                          f"{height} rows are not a multiple of {UNIT}")
    rows = height // UNIT
    if size > rows:
        raise ConfigError(f"a space axis of {size} ranks over a model input of {rows} P5 rows "
                          f"({height} rows): every rank needs at least one; use at most {rows}")
    q, extra = divmod(rows, size)
    return SlabPlan(tuple(q + (r < extra) for r in range(size)))


class GroupTransport:
    """Sends, receives and collectives over a ``torch.distributed`` group;
    peers are ranks in the group."""

    def __init__(self, group) -> None:
        self.group = group
        self.gloo = dist.get_backend(group) == "gloo"
        self.ranks = [dist.get_global_rank(group, r) for r in range(dist.get_world_size(group))]

    def exchange(self, sends: list, recvs: list) -> None:
        """``sends``: (peer, tensor); ``recvs``: (peer, contiguous buffer),
        filled in place. One batch of point-to-point ops."""
        staged = self.gloo and any(t.is_cuda for _, t in sends + recvs)
        host = (lambda t: t.cpu()) if staged else (lambda t: t)
        bufs = [host(t) for _, t in recvs]
        ops = [dist.P2POp(dist.isend, host(t), self.ranks[p], self.group) for p, t in sends]
        ops += [dist.P2POp(dist.irecv, b, self.ranks[p], self.group)
                for (p, _), b in zip(recvs, bufs)]
        if not ops:
            return
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged:
            for (_, t), b in zip(recvs, bufs):
                t.copy_(b)

    def all_reduce_max(self, t: torch.Tensor) -> None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)

    def all_gather(self, buf: torch.Tensor) -> list[torch.Tensor]:
        bufs = [torch.empty_like(buf) for _ in self.ranks]
        dist.all_gather(bufs, buf, group=self.group)
        return bufs


class Space:
    """This rank's slab of the frame's rows and the exchanges it makes.

    Tensors given to :meth:`halo` are NCHW slabs; those given to
    :meth:`gather_rows` NHWC. A slab's rows per P5 row (its level) follow
    from its height, so the same object serves every level."""

    def __init__(self, plan: SlabPlan, rank: int, transport) -> None:
        self.plan, self.rank, self.transport = plan, rank, transport
        self.start, self.stop = plan.bounds(rank)

    @property
    def size(self) -> int:
        return len(self.plan.counts)

    def input_rows(self) -> tuple[int, int]:
        """[start, stop) of this rank's model-input rows."""
        return self.plan.input_rows(self.rank)

    def _per_p5_row(self, h: int) -> int:
        n = self.stop - self.start
        if h % n:
            raise ValueError(f"a slab of {h} rows is not whole rows of rank {self.rank}'s {n} "
                             "P5 rows")
        return h // n

    def halo(self, x: torch.Tensor, above: int, below: int, fill: float = 0.0,
             wpad: int = 0) -> torch.Tensor:
        """NCHW slab (B, C, h, W) -> (B, C, above + h + below, W + 2 wpad):
        the ``above`` rows before it and ``below`` after it in the frame,
        from the ranks that hold them, ``fill`` beyond the frame's ends and
        in ``wpad`` columns each side (0 for a convolution's zero padding,
        -inf for a max-pool's). NHWC in memory (channels_last)."""
        b, c, h, w = x.shape
        f = self._per_p5_row(h)
        lo, hi, total = f * self.start, f * self.stop, f * self.plan.total
        out = x.new_empty((b, above + h + below, w + 2 * wpad, c))
        if wpad:
            out[:, :, :wpad].fill_(fill)
            out[:, :, wpad + w:].fill_(fill)
        inner = out[:, :, wpad:wpad + w]
        inner[:, above:above + h] = x.permute(0, 2, 3, 1)
        top, bottom = max(0, above - lo), max(0, hi + below - total)
        if top:
            inner[:, :top].fill_(fill)
        if bottom:
            inner[:, above + h + below - bottom:].fill_(fill)
        sends, recvs, placed = [], [], []
        for q in range(self.size):
            if q == self.rank:
                continue
            qlo, qhi = (f * r for r in self.plan.bounds(q))
            for a, e in ((lo - above, lo), (hi, hi + below)):  # rows q holds that we need
                a, e = max(a, qlo), min(e, qhi)
                if a < e:
                    buf = x.new_empty((b, e - a, w, c))
                    recvs.append((q, buf))
                    placed.append((a - lo + above, buf))
            for a, e in ((qlo - above, qlo), (qhi, qhi + below)):  # rows we hold that q needs
                a, e = max(a, lo), min(e, hi)
                if a < e:
                    sends.append((q, x[:, :, a - lo:e - lo].permute(0, 2, 3, 1).contiguous()))
        self.transport.exchange(sends, recvs)
        for row, buf in placed:
            inner[:, row:row + buf.shape[1]] = buf
        COUNTS["halo"] += 1
        COUNTS["halo_bytes"] += sum(t.numel() * t.element_size() for _, t in sends)
        return out.permute(0, 3, 1, 2)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The element-wise maximum of ``t`` over the group (a new tensor)."""
        out = t.clone()
        self.transport.all_reduce_max(out)
        COUNTS["max"] += 1
        return out

    def gather_rows(self, tree):
        """Every NHWC tensor of ``tree``: each rank's slab in order along H
        (dim 1), as the whole frame's. One collective: the slabs travel as
        one byte buffer, each padded to the largest slab's rows."""
        leaves = tree_leaves(tree)
        if not leaves:
            return tree
        most = max(self.plan.counts)
        parts, spans, offset = [], [], 0
        for t in leaves:
            f = self._per_p5_row(t.shape[1])
            padded = t.new_zeros((t.shape[0], f * most, *t.shape[2:]))
            padded[:, :t.shape[1]] = t
            raw = padded.view(-1).view(torch.uint8)
            pad = -raw.numel() % 8  # each leaf's bytes start 8-aligned
            parts.append(raw)
            if pad:
                parts.append(raw.new_zeros(pad))
            spans.append((offset, raw.numel(), padded.shape, f))
            offset += raw.numel() + pad
        bufs = self.transport.all_gather(torch.cat(parts))
        COUNTS["gather"] += 1
        COUNTS["gather_bytes"] += sum(b.numel() for b in bufs)
        it = iter(spans)

        def rebuild(t: torch.Tensor) -> torch.Tensor:
            start, nbytes, shape, f = next(it)
            return torch.cat([buf[start:start + nbytes].view(t.dtype).view(shape)[:, :f * n]
                              for buf, n in zip(bufs, self.plan.counts)], dim=1)

        return tree_map(rebuild, tree)


def space_of(mesh, height: int) -> Space | None:
    """This rank's :class:`Space` on ``mesh`` for a model input of
    ``height`` rows; None without a ``"space"`` axis or with one of one
    rank (no partitioning)."""
    found = space_group(mesh)
    if found is None or found[2] == 1:
        return None
    group, rank, size = found
    return Space(slab_plan(height, size), rank, GroupTransport(group))


def set_space(model: torch.nn.Module, space: Space | None) -> None:
    """Every module of ``model`` that reads across rows computes on
    ``space``'s slab (None: the whole frame)."""
    for m in model.modules():
        if hasattr(m, "space"):
            m.space = space
