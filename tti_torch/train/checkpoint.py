"""Training-state checkpoints (port of ``tti.train.checkpoint``).

A checkpoint is one ``torch.save`` file, ``step_N.pt``, holding the whole
:class:`tti_torch.train.step.TrainState`: the model's parameters and
BatchNorm running statistics, the EMA, the optimizer's state and the step.
It is written to a temporary name and renamed, so a run that dies while
saving leaves the previous checkpoint intact.
"""

from __future__ import annotations

import os
import re

import torch

from tti_torch.core.logging import get_logger
from tti_torch.train.step import TrainState

log = get_logger("train.checkpoint")

_NAME = re.compile(r"^step_(\d+)\.pt$")


def save_train_state(state: TrainState, directory: str, step: int | None = None) -> str:
    """Write ``directory/step_N.pt`` (N: ``step``, else the state's step);
    returns its path."""
    os.makedirs(directory, exist_ok=True)
    n = state.step if step is None else step
    path = os.path.join(directory, f"step_{n}.pt")
    payload = {"model": state.model.state_dict(), "ema": state.ema,
               "optimizer": state.optimizer.state_dict(), "step": state.step}
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    log.info("saved checkpoint: %s", path)
    return path


def load_train_payload(path: str) -> dict:
    """The saved dict of a checkpoint, tensors on the host."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint into ``state`` (same architecture and optimizer) in
    place; returns it. The file is read to the host: each tensor is copied
    to where the state keeps it (the optimizer keeps its step counts on the
    host, as a fresh one does)."""
    payload = load_train_payload(path)
    state.model.load_state_dict(payload["model"], strict=True)
    if set(payload["ema"]) != set(state.ema):
        raise ValueError(f"{path}: the EMA does not match the model")
    with torch.no_grad():
        for name, value in payload["ema"].items():
            state.ema[name].copy_(value)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state


def latest_checkpoint(directory: str) -> str | None:
    """The ``step_N.pt`` with the largest N in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [(int(m.group(1)), name) for name in os.listdir(directory)
             if (m := _NAME.match(name))]
    return os.path.join(directory, max(steps)[1]) if steps else None
