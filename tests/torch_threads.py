"""Ranks of a space group as threads of one process: ``on_threads(plan,
fn)`` runs ``fn(rank, space)`` on one thread per slab of ``plan``, each
with a :class:`tti_torch.parallel.spatial.Space` whose transport is a
barrier and a mailbox, so that the modules run their own halo and gather
code with no process group. On a CUDA device every thread launches on the
device's default stream: a tensor a thread leaves in the mailbox before a
barrier is written before a peer's copy of it, launched after the barrier.
Used by ``tests/test_torch_spatial.py`` and by
``tools/space_cards_torch.py`` (the plain step's forward on other slabs).
"""

import threading

import torch

from tti_torch.parallel.spatial import Space


class _Mailbox:
    def __init__(self, size: int) -> None:
        self.size = size
        self.barrier = threading.Barrier(size, timeout=120)
        self.box: dict = {}


class ThreadTransport:
    """A space group's transport between threads of this process."""

    def __init__(self, mailbox: _Mailbox, rank: int) -> None:
        self.m, self.rank = mailbox, rank

    def exchange(self, sends, recvs) -> None:
        for peer, t in sends:
            self.m.box[(self.rank, peer)] = t
        self.m.barrier.wait()
        for peer, buf in recvs:
            buf.copy_(self.m.box[(peer, self.rank)])
        self.m.barrier.wait()

    def all_reduce_max(self, t) -> None:
        self.m.box[("max", self.rank)] = t.clone()
        self.m.barrier.wait()
        top = torch.stack([self.m.box[("max", q)] for q in range(self.m.size)]).amax(0)
        self.m.barrier.wait()
        t.copy_(top)

    def all_gather(self, buf):
        self.m.box[("gather", self.rank)] = buf
        self.m.barrier.wait()
        out = [self.m.box[("gather", q)].clone() for q in range(self.m.size)]
        self.m.barrier.wait()
        return out


def on_threads(plan, fn):
    """``fn(rank, space)`` on one thread per rank of ``plan``; the results
    in rank order. A rank that raises aborts the others' barriers."""
    mailbox = _Mailbox(len(plan.counts))
    results, errors = [None] * mailbox.size, []

    def work(r):
        try:
            results[r] = fn(r, Space(plan, r, ThreadTransport(mailbox, r)))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            mailbox.barrier.abort()

    threads = [threading.Thread(target=work, args=(r,)) for r in range(mailbox.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results
