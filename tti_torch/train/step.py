"""The training step on one card (port of ``tti.train.step``).

AdamW under global-norm clipping, a linear-warmup cosine schedule, the
YOLOv8-seg loss in float32 on upcast head outputs, BatchNorm running
statistics updated by the forward pass, and an EMA of the parameters (the
weights that are deployed).

The step mutates a :class:`TrainState` in place. Mixed precision follows the
reference: a model built with ``dtype=torch.bfloat16`` runs its convolutions
in bfloat16 on float32 parameters (the casts give float32 gradients) and the
loss runs in float32, outside any autocast region.

Data parallelism (the reference's ``"data"`` mesh) is a process group given
to :class:`TrainStep`: each rank steps on its rows of the global batch, its
BatchNorm normalises with the global batch's statistics, and the gradients
are averaged over the ranks before the clip, so every rank takes the same
update as the reference's sharded step does once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tti_torch.model.layers import set_batchnorm_group
from tti_torch.model.yolo import REG_MAX, STRIDES, RawPredictions, YOLOv8Seg
from tti_torch.postprocess.decode import dfl_expectation, flatten_predictions, make_anchors
from tti_torch.preprocess.letterbox import jit_divide
from tti_torch.train.assigner import task_aligned_assign
from tti_torch.train.losses import bbox_ciou, dfl_loss, seg_loss

Tensor = torch.Tensor

# YOLOv8 loss gains (box, cls, dfl, seg on top of box).
BOX_GAIN = 7.5
CLS_GAIN = 0.5
DFL_GAIN = 1.5
SEG_GAIN = 1.0
MAX_GRAD_NORM = 10.0
# EMA of the parameters: d = EMA_DECAY * (1 - exp(-step / EMA_TAU)).
EMA_DECAY = 0.999
EMA_TAU = 2000.0


@dataclass
class Targets:
    """Fixed-size per-image ground truth (padded with valid=False)."""

    boxes: Tensor  # (B, G, 4) xyxy in model-input px
    classes: Tensor  # (B, G) int
    masks: Tensor  # (B, G, Hm, Wm) float, 0/1 cells or occupancy fractions
    valid: Tensor  # (B, G) bool


def warmup_cosine_schedule(learning_rate: float, total_steps: int | None
                           ) -> Callable[[int], float]:
    """The learning rate for update number ``count`` (0 for the first).
    Without ``total_steps``: constant. With it: linear warmup from 1% of the
    peak, then cosine decay to 1% at ``total_steps``, as
    ``optax.warmup_cosine_decay_schedule`` with the reference's warmup
    length and its clamps for tiny runs."""
    if total_steps is None:
        return lambda count: learning_rate
    warmup = max(20, min(1000, total_steps // 20))
    warmup = max(min(warmup, max(total_steps // 5, 1), total_steps - 1), 0)
    decay = total_steps - warmup
    if decay <= 0:
        raise ValueError(f"total_steps must exceed the warmup ({total_steps} <= {warmup})")
    # optax's arithmetic as tti's jitted step runs it: constants combined in
    # float64, then float32 with the step count; the divisions by the warmup
    # and the decay length are products with their float32 reciprocals, and
    # XLA folds pi / decay and 0.5 * (1 - alpha) into one constant each. The
    # warmup's first value is f32(init - peak) + peak, which float32 does not
    # round back to init.
    f32 = np.float32
    init = end = learning_rate * 1e-2
    alpha = 0.0 if learning_rate == 0.0 else end / learning_rate
    rcp_warmup = f32(1) / f32(warmup) if warmup else f32(0)
    angle = f32(math.pi) * (f32(1) / f32(decay))
    half = f32(0.5) * f32(1 - alpha)

    def schedule(count: int) -> float:
        if count < warmup:
            frac = f32(1) - f32(min(max(count, 0), warmup)) * rcp_warmup
            return float(f32(init - learning_rate) * frac + f32(learning_rate))
        cosine = f32(1) + np.cos(f32(min(count - warmup, decay)) * angle)
        return float(f32(learning_rate) * (cosine * half + f32(alpha)))

    return schedule


def ema_decay(step: int) -> np.float32:
    """The EMA's weight of its old value at update number ``step`` (1 for
    the first): ``EMA_DECAY * (1 - exp(-step / EMA_TAU))`` in float32, the
    division taken as ``tti``'s jitted step takes it, the product with
    float32(1 / EMA_TAU)."""
    f32 = np.float32
    return f32(EMA_DECAY) * (f32(1) - np.exp(-f32(step) * (f32(1) / f32(EMA_TAU))))


def batch_mean(v: Tensor) -> Tensor:
    """The mean over a batch of per-image terms, as ``jnp.mean`` under
    ``jax.jit``: the sum times float32(1 / B) (:func:`jit_divide`)."""
    return jit_divide(v.sum(0), v.shape[0])


@dataclass
class TrainState:
    """Everything a run carries from step to step. ``model`` holds the
    parameters and the BatchNorm running statistics; ``ema`` the moving
    average of the parameters, by name; ``step`` the updates done."""

    model: YOLOv8Seg
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    ema: dict[str, Tensor]
    step: int = 0


def create_train_state(model: YOLOv8Seg, learning_rate: float = 1e-3,
                       weight_decay: float = 5e-4, total_steps: int | None = None
                       ) -> TrainState:
    """AdamW (optax's defaults: betas 0.9/0.999, eps 1e-8, decay on every
    parameter) for ``model``, which is already on its device. The EMA starts
    as a copy of the parameters, not the same tensors."""
    params = [p for p in model.parameters() if p.requires_grad]
    optimizer = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    ema = {name: p.detach().clone() for name, p in model.named_parameters()}
    return TrainState(model, optimizer, warmup_cosine_schedule(learning_rate, total_steps), ema)


def clip_by_global_norm_(grads: list[Tensor], max_norm: float = MAX_GRAD_NORM) -> Tensor:
    """In place, as ``optax.clip_by_global_norm``: gradients are scaled by
    ``max_norm / norm`` only when the global norm is not below ``max_norm``
    (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` and
    always). No host synchronisation. Returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


def yolo_seg_loss(raw: RawPredictions, targets: Targets, input_hw: tuple[int, int],
                  seg_class_gains: tuple[float, ...] | None = None,
                  seg_dtype: torch.dtype = torch.float32,
                  seg_chunk: int | None = None) -> dict[str, Tensor]:
    """Per-image YOLOv8-seg loss terms {cls, box, dfl, seg}, each (B,), on
    float32 head outputs."""
    box_l, cls_l, coefs, level_hw = flatten_predictions(raw)
    protos = raw.protos
    anchors, stride = make_anchors(level_hw, STRIDES, device=box_l.device)
    ltrb = dfl_expectation(box_l) * stride[None, :, None]
    cx, cy = anchors[None, :, 0], anchors[None, :, 1]
    pred_boxes = torch.stack([cx - ltrb[..., 0], cy - ltrb[..., 1],
                              cx + ltrb[..., 2], cy + ltrb[..., 3]], dim=-1)
    assign = task_aligned_assign(pred_boxes, torch.sigmoid(cls_l), anchors, targets.boxes,
                                 targets.classes, targets.valid)
    pos = assign["pos_mask"]
    tscores, tboxes = assign["target_scores"], assign["target_boxes"]
    zero = torch.zeros((), device=box_l.device)
    score_sum = tscores.sum((1, 2)).clamp(min=1.0)

    cls_bce = F.binary_cross_entropy_with_logits(cls_l, tscores, reduction="none")
    loss_cls = cls_bce.sum((1, 2)) / score_sum

    # Positives weigh at least 0.05, so geometry trains while the scores
    # bootstrap from a cold start.
    w = torch.where(pos, tscores.sum(-1).clamp(min=0.05), zero)
    ciou = bbox_ciou(pred_boxes, tboxes)
    loss_box = torch.where(pos, (1.0 - ciou) * w, zero).sum(1) / score_sum

    s = stride[None, :]
    t_ltrb = torch.stack([(cx - tboxes[..., 0]) / s, (cy - tboxes[..., 1]) / s,
                          (tboxes[..., 2] - cx) / s, (tboxes[..., 3] - cy) / s], dim=-1)
    dfl = dfl_loss(box_l.reshape(*box_l.shape[:2], 4, REG_MAX), t_ltrb)
    loss_dfl = torch.where(pos, dfl * w, zero).sum(1) / score_sum

    hm, wm = protos.shape[1], protos.shape[2]
    scale = torch.tensor([wm / input_hw[1], hm / input_hw[0]] * 2, device=box_l.device)
    anchor_w = None
    if seg_class_gains is not None:
        gains = torch.tensor(seg_class_gains, dtype=torch.float32, device=box_l.device)
        gt_gains = gains[targets.classes.clamp(min=0).long()]  # (B, G)
        anchor_w = torch.gather(gt_gains, 1, assign["assigned_gt"])
    loss_seg = seg_loss(coefs, protos, targets.masks, targets.boxes * scale,
                        assign["assigned_gt"], pos, chunk=seg_chunk, anchor_weights=anchor_w,
                        seg_dtype=seg_dtype)
    return {"cls": loss_cls, "box": loss_box, "dfl": loss_dfl, "seg": loss_seg}


class TrainStep:
    """One optimisation step: ``step(state, images, targets)`` runs
    :meth:`loss` (forward and loss), the backward pass and :meth:`update`
    (clip, AdamW at the schedule's rate for this step, EMA) and returns the
    loss terms as device scalars. The parts are public so that a caller can
    time them.

    The reference calls it ``make_train_step``.

    ``seg_class_gains``: per-class seg-loss gains (index = class id), None
    for the plain recipe. ``seg_dtype`` and ``seg_chunk`` (the ``chunk`` of
    :func:`tti_torch.train.losses.seg_loss`): see there.

    ``group``: the process group of a data-parallel run, each rank calling
    the step on its rows of the global batch. The loss is the mean over the
    rank's rows; after the backward pass the gradients are summed over the
    ranks in one flat all-reduce and divided by the ranks, before the clip
    (which then sees the global gradient); the returned terms are the
    ranks' means. ``bn_group`` is the group BatchNorm sums its statistics
    over (:func:`tti_torch.model.layers.set_batchnorm_group`): ``group``
    when it has more than one rank, else None, so that a one-rank group
    normalises exactly as no group does."""

    def __init__(self, input_hw: tuple[int, int], seg_class_gains=None,
                 seg_dtype: torch.dtype = torch.float32, seg_chunk: int | None = None,
                 group=None) -> None:
        self.input_hw = input_hw
        self.gains = tuple(seg_class_gains) if seg_class_gains is not None else None
        self.seg_dtype = seg_dtype
        self.seg_chunk = seg_chunk
        self.group = group
        self.bn_group = group if group is not None and dist.get_world_size(group) > 1 else None

    def loss(self, model: YOLOv8Seg, images: Tensor, targets: Targets
             ) -> tuple[Tensor, dict[str, Tensor]]:
        """Train-mode forward (BatchNorm running statistics move) and the
        loss: (total, mean of each term over the batch)."""
        model.train()
        set_batchnorm_group(model, self.bn_group)
        raw = model(images)
        raw = RawPredictions(*(tuple(t.float() for t in getattr(raw, k))
                               for k in ("box", "cls", "mcoef")), raw.protos.float())
        per_image = yolo_seg_loss(raw, targets, self.input_hw, self.gains, self.seg_dtype,
                                  self.seg_chunk)
        losses = {k: batch_mean(v) for k, v in per_image.items()}
        total = (BOX_GAIN * losses["box"] + CLS_GAIN * losses["cls"]
                 + DFL_GAIN * losses["dfl"] + BOX_GAIN * SEG_GAIN * losses["seg"])
        return total, losses

    def update(self, state: TrainState) -> None:
        """Clip the gradients, take the AdamW step at ``schedule(step)`` and
        move the EMA by ``d = EMA_DECAY * (1 - exp(-(step + 1) / EMA_TAU))``."""
        params = [p for group in state.optimizer.param_groups for p in group["params"]]
        clip_by_global_norm_([p.grad for p in params])
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
        state.optimizer.step()
        state.step += 1
        d = ema_decay(state.step)
        ema = list(state.ema.values())
        torch._foreach_mul_(ema, float(d))
        torch._foreach_add_(ema, [p.detach() for _, p in state.model.named_parameters()],
                            alpha=float(np.float32(1.0) - d))

    def all_reduce_grads(self, state: TrainState) -> None:
        """Average the gradients over ``group``: one flat bucket, summed,
        divided by the ranks."""
        grads = [p.grad for group in state.optimizer.param_groups for p in group["params"]
                 if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat.div_(dist.get_world_size(self.group))
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view(g.shape))

    def __call__(self, state: TrainState, images: Tensor, targets: Targets
                 ) -> dict[str, Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        total, losses = self.loss(state.model, images, targets)
        total.backward()
        if self.group is not None:
            self.all_reduce_grads(state)
        self.update(state)
        terms = {"total": total.detach(), **{k: v.detach() for k, v in losses.items()}}
        if self.group is None:
            return terms
        mean = torch.stack(list(terms.values()))
        dist.all_reduce(mean, group=self.group)
        mean /= dist.get_world_size(self.group)
        return dict(zip(terms, mean.unbind()))

