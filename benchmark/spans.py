"""The program's own spans and counts over the traced segment, per batch:
what the ``program_span`` and ``program_counter`` metrics read.

``tti_torch.core.logging``'s process tracer is on while ``torch.profiler``
records, so the traced segment fills its ring: ``batch`` around each
hand-over (its id the pipeline's step number), ``upload``, ``preprocess``,
``forward``, ``detect`` and ``measure`` inside it, ``to_host`` around each
read-back with ``to_host.wait`` until its first copy returns, and the count
``d2h_copies``. A program without that tracer gives nothing to read.
"""

from __future__ import annotations

STAGES = ("upload", "preprocess", "forward", "detect", "measure")


def batches(ctx) -> list[dict]:
    """One row per batch of the traced segment whose spans are complete
    (``batch``, ``to_host`` and ``to_host.wait``), the last
    ``ctx.trace["steps"]`` of them: ``batch_host_ms``; each stage's device
    ms (None where the batch has no such span); ``readback_queued_ms``, the
    device ms from the ``batch`` span's end to its ``to_host`` span's start;
    ``readback_tail_ms``, the host ms of ``to_host`` less ``to_host.wait``;
    ``readback_copies``, the batch's ``d2h_copies``."""
    if ctx.trace is None:
        return []
    try:
        from tti_torch.core.logging import device_gap_ms, process_tracer
    except ImportError:
        return []
    groups: dict[int, dict] = {}
    for r in process_tracer().records():  # in the order the spans began
        if r.name == "batch":
            groups[r.batch] = {"batch": r}
        elif r.batch in groups:
            groups[r.batch].setdefault(r.name, []).append(r)
    rows = []
    for g in groups.values():
        b, to_host, wait = g["batch"], g.get("to_host"), g.get("to_host.wait")
        if not to_host or not wait:
            continue
        row = {"batch_host_ms": b.host_ms,
               "readback_queued_ms": device_gap_ms(b, to_host[0]),
               "readback_tail_ms": (sum(s.host_ms for s in to_host)
                                    - sum(s.host_ms for s in wait)),
               "readback_copies": sum(c.n for c in g.get("d2h_copies", ()))}
        for name in STAGES:
            ms = [s.device_ms for s in g.get(name, ())]
            row[name] = sum(ms) if ms and None not in ms else None
        rows.append((b.id, row))
    rows.sort(key=lambda r: r[0])
    return [row for _, row in rows[-ctx.trace["steps"]:]]


def mean(ctx, key: str) -> float | None:
    """``key``'s mean over the traced segment's complete batches that have
    it, or None."""
    values = [row[key] for row in batches(ctx) if row[key] is not None]
    return sum(values) / len(values) if values else None
