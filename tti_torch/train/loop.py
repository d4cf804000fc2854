"""The training run: dataset on the device, augmented batches, steps,
checkpoints, resume, and the export of the deploy checkpoint. The command
line (``python -m tti_torch.cli train`` / ``export-weights``) and the card's
smoke script both call these functions.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Mapping

import torch

from tti_torch.core.config import ModelConfig
from tti_torch.model.checkpoint import (from_flax_variables, load_flax_msgpack,
                                        save_flax_msgpack, to_flax_variables)
from tti_torch.model.yolo import create_model, init_model
from tti_torch.train.augment import DeviceDataset, make_augment_fn, step_generator
from tti_torch.train.checkpoint import (latest_checkpoint, load_train_payload,
                                        restore_train_state, save_train_state)
from tti_torch.train.data import soft_class_ids
from tti_torch.train.step import TrainState, TrainStep, create_train_state

Tensor = torch.Tensor

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def seg_gains(stitch_seg_gain: float, num_classes: int,
              stitch_class_id: int = ModelConfig.stitch_class_id) -> list[float] | None:
    """Per-class seg-loss gains with the stitch class at ``stitch_seg_gain``;
    None (the plain recipe) at 1.0."""
    if stitch_seg_gain == 1.0:
        return None
    gains = [1.0] * num_classes
    gains[stitch_class_id] = stitch_seg_gain
    return gains


def build_model(variant: str, num_classes: int, mask_stride: int, proto_head: str,
                dtype: torch.dtype, device: str | torch.device, init: str | None = None,
                seed: int = 0) -> torch.nn.Module:
    """The training-form model on ``device``: fresh (:func:`init_model`,
    draws from ``seed``) or, with ``init``, the params and batch stats of a
    deploy checkpoint (an unfolded flax msgpack with the k3/s2 stem)."""
    model = init_model(variant, num_classes, mask_stride, proto_head,
                       torch.Generator().manual_seed(seed), dtype=dtype)
    if init is not None:
        state = from_flax_variables(load_flax_msgpack(init))
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model.to(device).to(memory_format=torch.channels_last)


@dataclass
class Trainer:
    """A run's pieces: batch ``i`` is ``augment(data, step_generator(seed,
    i))``, so the stream is a pure function of the step index."""

    data: DeviceDataset
    state: TrainState
    step_fn: TrainStep
    augment: Callable
    seed: int = 0

    def batch(self, index: int):
        return self.augment(self.data, step_generator(self.seed, index,
                                                      self.data.images.device))

    def train_step(self, index: int) -> dict[str, Tensor]:
        images, targets = self.batch(index)
        return self.step_fn(self.state, images, targets)


def train_switches(env: Mapping[str, str]) -> dict:
    """The reference trainer's environment switches, with its value sets:
    ``TTI_SEG_DTYPE`` (``bf16`` selects bfloat16, anything else float32),
    ``TTI_SEG_CHUNK`` (an integer; 0 means unchunked; unset leaves the
    automatic policy) and ``TTI_AUGMENT_DTYPE`` (``bf16``, or ``f32``,
    ``fp32``, ``float32``; anything else leaves the caller's default, None
    here)."""
    chunk = env.get("TTI_SEG_CHUNK")
    aug = env.get("TTI_AUGMENT_DTYPE")
    return {"seg_dtype": torch.bfloat16 if env.get("TTI_SEG_DTYPE") == "bf16" else torch.float32,
            "seg_chunk": None if chunk is None else int(chunk),
            "augment_dtype": (torch.bfloat16 if aug == "bf16" else
                              torch.float32 if aug in ("f32", "fp32", "float32") else None)}


def step_and_augment(imgsz: int, batch_size: int, max_gt: int, dtype: torch.dtype,
                     seg_class_gains=None, env: Mapping[str, str] | None = None
                     ) -> tuple[TrainStep, Callable]:
    """The train step and the augment function of a run at ``imgsz``, under
    the switches of ``env`` (the process environment by default; see
    :func:`train_switches`). The augment's image chain runs in ``dtype``
    unless ``TTI_AUGMENT_DTYPE`` says otherwise."""
    sw = train_switches(os.environ if env is None else env)
    step = TrainStep((imgsz, imgsz), seg_class_gains=seg_class_gains, seg_dtype=sw["seg_dtype"],
                     seg_chunk=sw["seg_chunk"])
    return step, make_augment_fn(batch_size, max_gt, image_dtype=sw["augment_dtype"] or dtype)


def build_trainer(data: DeviceDataset, model: torch.nn.Module, batch_size: int, max_gt: int,
                  total_steps: int | None, lr: float = 1e-3, dtype: torch.dtype = torch.bfloat16,
                  seg_class_gains=None, seed: int = 0) -> Trainer:
    """The trainer for a model already on the dataset's device, under the
    process environment's switches (:func:`train_switches`)."""
    state = create_train_state(model, learning_rate=lr, total_steps=total_steps)
    step, augment = step_and_augment(data.imgsz, batch_size, max_gt, dtype, seg_class_gains)
    return Trainer(data, state, step, augment, seed)


def run(trainer: Trainer, start: int, total: int, out: str | None = None, log_every: int = 10,
        checkpoint_every: int = 0, log: Callable[[str], None] = print) -> int:
    """Steps ``start + 1`` .. ``total`` (batch index = step number), with a
    log line every ``log_every`` and a checkpoint in ``out`` every
    ``checkpoint_every`` steps. Returns the last step number."""
    seen = start
    for seen in range(start + 1, total + 1):
        metrics = trainer.train_step(seen)
        if log_every and seen % log_every == 0:
            log(f"step {seen}/{total}: "
                + " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items()))
        if out and checkpoint_every and seen % checkpoint_every == 0:
            save_train_state(trainer.state, out, step=seen)
    return seen


def train(samples, out: str, variant: str = "n", num_classes: int = 2, imgsz: int = 640,
          batch_size: int = 16, epochs: int = 100, lr: float = 1e-3, max_gt: int = 32,
          log_every: int = 10, checkpoint_every: int = 500, resume: bool = False,
          mask_stride: int = 4, proto_head: str = "deconv", stitch_seg_gain: float = 1.0,
          soft_masks=None, dtype: str = "bf16", device: str = "cuda", init: str | None = None,
          seed: int = 0, log: Callable[[str], None] = print) -> str:
    """``tti train`` on one card: returns the final checkpoint's path.
    ``resume`` continues the newest checkpoint in ``out`` and replays the
    same batch stream. No data parallelism."""
    from tti_torch.train.augment import build_device_dataset

    compute = DTYPES[dtype]
    model = build_model(variant, num_classes, mask_stride, proto_head, compute, device, init,
                        seed)
    total = max(len(samples) // batch_size, 1) * epochs
    data = build_device_dataset(samples, imgsz, max_gt, mask_stride=mask_stride,
                                soft_masks=soft_masks, device=device)
    trainer = build_trainer(data, model, batch_size, max_gt, total, lr, compute,
                            seg_gains(stitch_seg_gain, num_classes), seed)
    start = 0
    if resume:
        ckpt = latest_checkpoint(out)
        if ckpt is None:
            log(f"--resume: no checkpoint under {out}; starting fresh")
        else:
            restore_train_state(ckpt, trainer.state)
            start = trainer.state.step
            log(f"resumed {ckpt} at step {start}/{total}")
    seen = run(trainer, start, total, out, log_every, checkpoint_every, log)
    return save_train_state(trainer.state, out, step=seen)


def export_weights(train_dir: str, out: str, variant: str = "n", num_classes: int = 2,
                   imgsz: int = 960, mask_stride: int = 4, proto_head: str = "deconv",
                   soft_masks=None, recipe: str = "") -> dict:
    """Write the deploy msgpack (the EMA parameters with the running
    statistics, flax's tree and names) and its JSON sidecar from a training
    checkpoint (a ``step_N.pt`` or a run directory: its newest). Returns the
    sidecar."""
    import os

    src = train_dir
    if os.path.isdir(src):
        src = latest_checkpoint(src)
        if src is None:
            raise FileNotFoundError(f"no step_N.pt checkpoint in {train_dir}")
    payload = load_train_payload(src)
    model = create_model(variant, num_classes, mask_stride=mask_stride, proto_head=proto_head,
                         s2d_stem=False, folded_bn=False)
    model.load_state_dict({**payload["model"], **payload["ema"]}, strict=True)
    cfg = ModelConfig()
    soft_ids = soft_class_ids(soft_masks, num_classes, cfg.stitch_class_id, cfg.fabric_class_id)
    meta = {
        "source": src,
        "variant": variant,
        "num_classes": num_classes,
        "imgsz_trained": imgsz,
        "mask_stride": mask_stride,
        "proto_head": proto_head,
        "soft_masks": bool(soft_ids) and len(soft_ids) == num_classes,
        "soft_stitch": cfg.stitch_class_id in soft_ids,
        "soft_fabric": cfg.fabric_class_id in soft_ids,
        "weights": "EMA (deployed tree)",
        "recipe": recipe,
    }
    save_flax_msgpack(to_flax_variables(model.state_dict()), out, meta)
    return meta
