"""Multi-GPU and multi-host jobs (port of ``tti.parallel.dcn``).

``tti`` joins a multi-host job when ``TTI_COORDINATOR`` (host:port of
process 0) is set, with ``TTI_NUM_PROCESSES`` (default 1) and
``TTI_PROCESS_ID`` (default 0); a ``tti`` process is a host that drives all
of its chips. Here a process is a card, in PyTorch's idiom: host ``p`` of
``P`` starts one process per local card, ``L`` of them (``train``; every
other command starts one, on card 0), and the process of local card ``l``
joins as

    global rank = p * L + l,        world = P * L,

so every host must start the same ``L``. The default process group is
initialised with ``init_method="tcp://<TTI_COORDINATOR>"``, whose host runs
rank 0 (process 0, local card 0). The backend follows the device the caller
names: NCCL on CUDA, gloo on the CPU; it is never a fallback after a
failure.

Each rank feeds its own rows and gets them back, as in ``tti``:
:func:`global_batch` assembles the global batch from every rank's rows and
:func:`process_local_slice` takes this rank's rows of a global output.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Mapping

import torch
import torch.distributed as dist

from tti_torch.core.errors import ConfigError
from tti_torch.core.logging import get_logger
from tti_torch.parallel.mesh import batch_slice, gather_batch, tree_map

log = get_logger("parallel.dcn")

ENV_COORD = "TTI_COORDINATOR"
ENV_NPROC = "TTI_NUM_PROCESSES"
ENV_PID = "TTI_PROCESS_ID"


@dataclass(frozen=True)
class Job:
    """The multi-host job: the coordinator (host:port), the processes
    (hosts) and this one's id."""

    coordinator: str
    num_processes: int = 1
    process_id: int = 0


def job_from_env(coordinator: str | None = None, num_processes: int | None = None,
                 process_id: int | None = None, env: Mapping[str, str] | None = None
                 ) -> Job | None:
    """The job the arguments or the ``TTI_*`` triple describe, read as
    ``tti``'s ``init_distributed`` reads it; None without a coordinator
    (the other two alone start nothing)."""
    env = os.environ if env is None else env
    coordinator = coordinator or env.get(ENV_COORD)
    if not coordinator:
        return None
    job = Job(coordinator, int(num_processes or env.get(ENV_NPROC, "1")),
              int(process_id if process_id is not None else env.get(ENV_PID, "0")))
    if job.num_processes < 1 or not 0 <= job.process_id < job.num_processes:
        raise ConfigError(f"{ENV_PID}={job.process_id} is not a process of "
                          f"{ENV_NPROC}={job.num_processes}")
    return job


def global_rank(process_id: int, local_cards: int, local_rank: int) -> int:
    """The rank of local card ``local_rank`` on host ``process_id``, each
    host driving ``local_cards``."""
    return process_id * local_cards + local_rank


def backend_for(device: str | torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_local_coordinator() -> str:
    """127.0.0.1 with a free port, for a job on this host alone."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, *, device: str | torch.device = "cuda",
                     local_rank: int = 0, local_cards: int = 1) -> bool:
    """Join the job the arguments or the ``TTI_*`` triple describe, as local
    card ``local_rank`` of ``local_cards`` (see the module's docstring for
    the ranks). Returns False, and starts nothing, without a coordinator.
    On CUDA the process's current card becomes ``local_rank``."""
    job = job_from_env(coordinator, num_processes, process_id)
    if job is None:
        return False
    if not 0 <= local_rank < local_cards:
        raise ConfigError(f"local rank {local_rank} is not a card of {local_cards}")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank)
    rank = global_rank(job.process_id, local_cards, local_rank)
    world = job.num_processes * local_cards
    dist.init_process_group(backend_for(device), init_method=f"tcp://{job.coordinator}",
                            world_size=world, rank=rank)
    log.info("process group up (%s): rank %d of %d, process %d of %d, local card %d of %d",
             dist.get_backend(), rank, world, job.process_id, job.num_processes, local_rank,
             local_cards)
    return True


def rank() -> int:
    """This process's global rank (0 outside a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_batch(mesh, local):
    """Each rank's rows (dim 0 of every tensor of ``local``) -> the global
    batch, on every rank."""
    return gather_batch(mesh, local)


def process_local_slice(global_out, mesh):
    """This rank's rows (its :func:`batch_slice` on ``mesh``) of every
    tensor of a global batch output."""
    return tree_map(lambda t: t[batch_slice(mesh, t.shape[0])], global_out)
