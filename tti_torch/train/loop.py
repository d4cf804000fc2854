"""The training run: dataset on the device, augmented batches, steps,
checkpoints, resume, and the export of the deploy checkpoint. The command
line (``python -m tti_torch.cli train`` / ``export-weights``) and the card's
smoke script both call these functions. ``train`` runs on every card of the
host, and of every host of a ``TTI_COORDINATOR`` job, data-parallel.

With ``host_aug`` the batches come from the host recipe instead
(:func:`tti_torch.train.data.batches`, the reference's ``--host-aug``): each
goes to the card through pinned memory (:func:`run_host`), into the same
:class:`TrainStep`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Mapping

import torch
import torch.distributed as dist

from tti_torch.core.config import ModelConfig
from tti_torch.core.errors import ConfigError
from tti_torch.model.checkpoint import (from_flax_variables, load_flax_msgpack,
                                        save_flax_msgpack, to_flax_variables)
from tti_torch.model.yolo import create_model, init_model
from tti_torch.parallel.dcn import (Job, free_local_coordinator, init_distributed, job_from_env,
                                    rank, shutdown)
from tti_torch.parallel.mesh import batch_slice, create_mesh, replicate
from tti_torch.train.augment import DeviceDataset, make_augment_fn, step_generator
from tti_torch.train.checkpoint import (latest_checkpoint, load_train_payload,
                                        restore_train_state, save_train_state)
from tti_torch.train.data import batches, soft_class_ids
from tti_torch.train.step import Targets, TrainState, TrainStep, create_train_state

Tensor = torch.Tensor

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}

# The reference's refusal of --resume with --host-aug.
HOST_AUG_RESUME = ("--resume requires the device-aug path (the host batch iterator has no "
                   "step-indexed stream to re-enter)")


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
                     seg_class_gains=None, env: Mapping[str, str] | None = None,
                     mesh=None) -> tuple[TrainStep, Callable]:
    """The train step and the augment function of a run at ``imgsz``, under
    the switches of ``env`` (the process environment by default; see
    :func:`train_switches`). The augment's image chain runs in ``dtype``
    unless ``TTI_AUGMENT_DTYPE`` says otherwise. With a data-parallel
    ``mesh``, ``batch_size`` is the global batch: the augment makes this
    rank's rows of it and the step averages over the mesh's ranks."""
    sw = train_switches(os.environ if env is None else env)
    rows = None if mesh is None else batch_slice(mesh, batch_size)
    step = TrainStep((imgsz, imgsz), seg_class_gains=seg_class_gains, seg_dtype=sw["seg_dtype"],
                     seg_chunk=sw["seg_chunk"],
                     group=None if mesh is None else mesh.get_group("data"))
    return step, make_augment_fn(batch_size, max_gt, image_dtype=sw["augment_dtype"] or dtype,
                                 rows=rows)


def build_trainer(data: DeviceDataset, model: torch.nn.Module, batch_size: int, max_gt: int,
                  total_steps: int | None, lr: float = 1e-3, dtype: torch.dtype = torch.bfloat16,
                  seg_class_gains=None, seed: int = 0, mesh=None) -> Trainer:
    """The trainer for a model already on the dataset's device, under the
    process environment's switches (:func:`train_switches`); with a
    ``mesh``, this rank's part of the data-parallel run
    (:func:`step_and_augment`)."""
    state = create_train_state(model, learning_rate=lr, total_steps=total_steps)
    step, augment = step_and_augment(data.imgsz, batch_size, max_gt, dtype, seg_class_gains,
                                     mesh=mesh)
    return Trainer(data, state, step, augment, seed)


def save_checkpoint(state: TrainState, out: str, step: int) -> str:
    """Rank 0 writes ``out/step_N.pt`` (any process outside a group does);
    every rank of a group waits for it. Returns the path."""
    if rank() == 0:
        path = save_train_state(state, out, step=step)
    else:
        path = os.path.join(out, f"step_{step}.pt")
    if dist.is_initialized():
        dist.barrier()
    return path


def run(trainer: Trainer, start: int, total: int, out: str | None = None, log_every: int = 10,
        checkpoint_every: int = 0, log: Callable[[str], None] = print) -> int:
    """Steps ``start + 1`` .. ``total`` (batch index = step number), with a
    log line every ``log_every`` and a checkpoint in ``out`` every
    ``checkpoint_every`` steps (:func:`save_checkpoint`). Returns the last
    step number."""
    seen = start
    for seen in range(start + 1, total + 1):
        metrics = trainer.train_step(seen)
        if log_every and seen % log_every == 0:
            log(f"step {seen}/{total}: "
                + " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items()))
        if out and checkpoint_every and seen % checkpoint_every == 0:
            save_checkpoint(trainer.state, out, seen)
    return seen


def host_batch_to_device(images, targets: Targets, device: str | torch.device,
                         rows: slice | None = None) -> tuple[Tensor, Targets]:
    """One host batch (:func:`tti_torch.train.data.batches`) on ``device``,
    through pinned memory on a CUDA device; with ``rows``, only this rank's
    rows of it (:func:`tti_torch.parallel.mesh.batch_slice`)."""
    device = torch.device(device)
    pinned = device.type == "cuda"

    def put(t: Tensor) -> Tensor:
        if rows is not None:
            t = t[rows]
        if pinned:
            t = t.pin_memory()
        return t.to(device, non_blocking=pinned)

    return put(torch.from_numpy(images)), Targets(*(put(t) for t in (
        targets.boxes, targets.classes, targets.masks, targets.valid)))


def run_host(state: TrainState, step: TrainStep, host_batches, device: str | torch.device,
             out: str | None = None, log_every: int = 10, checkpoint_every: int = 0,
             rows: slice | None = None, log: Callable[[str], None] = print) -> int:
    """One step per host batch of ``host_batches`` (``rows`` of each on a
    data-parallel rank), with the reference's log line (``step N:``, no
    total) every ``log_every`` steps and a checkpoint every
    ``checkpoint_every``. Returns the number of steps."""
    seen = 0
    for images, targets in host_batches:
        metrics = step(state, *host_batch_to_device(images, targets, device, rows))
        seen += 1
        if log_every and seen % log_every == 0:
            log(f"step {seen}: " + " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items()))
        if out and checkpoint_every and seen % checkpoint_every == 0:
            save_checkpoint(state, out, seen)
    return seen


def launches_per_card(device: str | torch.device) -> bool:
    """Whether ``train`` on ``device`` starts one process per local card: a
    CUDA device without an index on a host with more than one card, in a
    process outside any group."""
    device = torch.device(device)
    return (device.type == "cuda" and device.index is None and not dist.is_initialized()
            and torch.cuda.device_count() > 1)


def train(samples, out: str, device: str = "cuda", log: Callable[[str], None] = print,
          **recipe) -> str:
    """``tti train``: returns the final checkpoint's path. ``recipe``: the
    keyword arguments of :func:`train_rank` (``batch_size`` is the global
    batch; ``resume`` continues the newest checkpoint in ``out`` and
    replays the same batch stream).

    Like ``tti train``, it uses every card: with more than one local card
    (:func:`launches_per_card`) it starts one process per card, which join
    the ``TTI_*`` triple's job under the global numbering
    (:mod:`tti_torch.parallel.dcn`) or, without one, a job on this host. A
    process already in a group (the CLI joins the triple's job before
    every command) is one rank. The ranks form a ``"data"`` mesh
    (:func:`train_rank`)."""
    if not launches_per_card(device):
        return train_rank(samples, out, device=device, log=log, **recipe)
    cards = torch.cuda.device_count()
    job = job_from_env() or Job(free_local_coordinator())
    log(f"training on {cards} local cards (process {job.process_id} of {job.num_processes})")
    torch.multiprocessing.spawn(_card_main, args=(job, cards, samples, out, recipe),
                                nprocs=cards, join=True)
    return latest_checkpoint(out)


def _card_main(local_rank: int, job: Job, cards: int, samples, out: str, recipe: dict) -> None:
    """One card's process of :func:`train`."""
    init_distributed(job.coordinator, job.num_processes, job.process_id, device="cuda",
                     local_rank=local_rank, local_cards=cards)
    try:
        train_rank(samples, out, device=f"cuda:{local_rank}",
                   log=lambda line: print(line, flush=True), **recipe)
    finally:
        shutdown()


def train_rank(samples, out: str, variant: str = "n", num_classes: int = 2, imgsz: int = 640,
               batch_size: int = 16, epochs: int = 100, lr: float = 1e-3, max_gt: int = 32,
               log_every: int = 10, checkpoint_every: int = 500, resume: bool = False,
               mask_stride: int = 4, proto_head: str = "deconv", stitch_seg_gain: float = 1.0,
               soft_masks=None, dtype: str = "bf16", device: str = "cuda",
               init: str | None = None, seed: int = 0, host_aug: bool = False,
               log: Callable[[str], None] = print) -> str:
    """The run in this process: alone, or as one rank of the initialised
    group of more than one, where the ranks form a ``"data"`` mesh. There
    the dataset is on every card, the model starts as rank 0's, each rank
    steps on its rows of the global batch, only rank 0 logs and writes
    checkpoints (every rank waits for each), and ``resume`` restores on
    every rank from ``out``, which every host must see (a shared directory).
    ``host_aug``: the host recipe's batches (:func:`run_host`); every rank
    makes the whole global batch from ``seed`` and steps on its rows. It
    cannot resume."""
    from tti_torch.train.augment import build_device_dataset

    if host_aug and resume:
        raise ConfigError(HOST_AUG_RESUME)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if batch_size % world:
        raise ConfigError(f"--batch-size {batch_size} is the global batch: it must be a "
                          f"multiple of the {world} ranks")
    mesh = create_mesh(device_type=torch.device(device).type) if world > 1 else None
    if rank():
        log = lambda line: None
    compute = DTYPES[dtype]
    model = build_model(variant, num_classes, mask_stride, proto_head, compute, device, init,
                        seed)
    if mesh is not None:
        replicate(mesh, model)
    total = max(len(samples) // batch_size, 1) * epochs
    if host_aug:
        state = create_train_state(model, learning_rate=lr, total_steps=total)
        step, _ = step_and_augment(imgsz, batch_size, max_gt, compute,
                                   seg_gains(stitch_seg_gain, num_classes), mesh=mesh)
        host = batches(samples, batch_size, imgsz, max_gt=max_gt, seed=seed, epochs=epochs,
                       mask_stride=mask_stride, soft_masks=soft_masks)
        seen = run_host(state, step, host, device, out, log_every, checkpoint_every,
                        None if mesh is None else batch_slice(mesh, batch_size), log)
        return save_checkpoint(state, out, seen)
    data = build_device_dataset(samples, imgsz, max_gt, mask_stride=mask_stride,
                                soft_masks=soft_masks, device=device)
    trainer = build_trainer(data, model, batch_size, max_gt, total, lr, compute,
                            seg_gains(stitch_seg_gain, num_classes), seed, mesh=mesh)
    start = 0
    if resume:
        ckpt = latest_checkpoint(out)
        if world > 1:
            found = [None] * world
            dist.all_gather_object(found, None if ckpt is None else os.path.basename(ckpt))
            if len(set(found)) > 1:
                raise ConfigError(f"--resume: the ranks see different checkpoints in {out} "
                                  f"({found}); every host needs the same --out")
        if ckpt is None:
            log(f"--resume: no checkpoint under {out}; starting fresh")
        else:
            restore_train_state(ckpt, trainer.state)
            start = trainer.state.step
            log(f"resumed {ckpt} at step {start}/{total}")
    seen = run(trainer, start, total, out, log_every, checkpoint_every, log)
    return save_checkpoint(trainer.state, out, seen)


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
