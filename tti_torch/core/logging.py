"""Structured logging (copy of ``tti.core.logging``) and the port's tracer.

Standard ``logging`` loggers under the root ``tti_torch``, carrying structured
``extra`` fields (keys prefixed ``tti_``), so deployments can ship JSON lines
while development gets readable console output.

:class:`StageTimer` keeps spans and counts in a bounded ring. The process
has one that the step's layers record into through :func:`span` and
:func:`count`, and only while it is on (:func:`tracer`): after
:func:`enable`, or while a ``torch.profiler`` session records. Off, each of
those boundaries reads two module-level flags and returns a shared no-op
context.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import sys
import threading
import time
from typing import Any

import torch
from torch.autograd import profiler as _profiler

_CONFIGURED = False


class JsonFormatter(logging.Formatter):
    """One JSON object per line; stable keys for log scrapers."""

    def format(self, record: logging.LogRecord) -> str:
        payload: dict[str, Any] = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        for key, value in record.__dict__.items():
            if key.startswith("tti_"):
                payload[key[4:]] = value
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload, default=str)


def configure(level: str | None = None, json_lines: bool | None = None) -> None:
    """Configure the root 'tti_torch' logger once. Env: TTI_LOG_LEVEL, TTI_LOG_JSON."""
    global _CONFIGURED
    root = logging.getLogger("tti_torch")
    if _CONFIGURED:
        return
    level = level or os.getenv("TTI_LOG_LEVEL", "INFO")
    if json_lines is None:
        json_lines = os.getenv("TTI_LOG_JSON", "0").strip().lower() in ("1", "true", "yes", "on")
    handler = logging.StreamHandler(sys.stderr)
    if json_lines:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)-7s %(name)s: %(message)s", "%H:%M:%S")
        )
    root.addHandler(handler)
    root.setLevel(level.upper())
    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    configure()
    return logging.getLogger(name if name.startswith("tti_torch") else f"tti_torch.{name}")


RING = 4096  # records a tracer keeps: the spans and counts of about 150 steps


class Span:
    """One span: its name, the batch it belongs to, the span open on its
    thread when it began (``parent``, that span's ``id``), and its start
    and end on ``time.perf_counter_ns``. ``device`` is the device whose
    work it times, None for host work; on a CUDA card ``events`` holds its
    two timing events."""

    __slots__ = ("name", "batch", "parent", "id", "device", "start_ns", "end_ns", "events",
                 "_device_ms")

    def __init__(self, name: str, batch: int | None, parent: int | None, id_: int,
                 device: torch.device | None, start_ns: int = 0, end_ns: int = 0) -> None:
        self.name, self.batch, self.parent, self.id = name, batch, parent, id_
        self.device, self.start_ns, self.end_ns = device, start_ns, end_ns
        self.events = None
        self._device_ms = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> float | None:
        """Device ms between the span's two events, once the device has
        passed the second (None before, and for host work); on a device
        other than a CUDA card, which runs the work as it is issued, the
        host ms."""
        if self._device_ms is None and self.events is not None and self.events[1].query():
            self._device_ms = self.events[0].elapsed_time(self.events[1])
        return self._device_ms


class Count:
    """``n`` of ``name`` counted at ``at_ns``, in a batch and under a span."""

    __slots__ = ("name", "batch", "parent", "id", "n", "at_ns")

    def __init__(self, name: str, batch: int | None, parent: int | None, id_: int, n: int,
                 at_ns: int) -> None:
        self.name, self.batch, self.parent, self.id, self.n, self.at_ns = (
            name, batch, parent, id_, n, at_ns)


def device_gap_ms(earlier: Span, later: Span) -> float | None:
    """Device ms from ``earlier``'s end to ``later``'s start, both timed on
    one CUDA card (None until the device has passed ``later``'s start), or
    host ms where both ran on the CPU."""
    if earlier.events is not None and later.events is not None:
        if not later.events[0].query():
            return None
        return earlier.events[1].elapsed_time(later.events[0])
    on_cpu = lambda s: s.device is not None and s.device.type == "cpu"
    if on_cpu(earlier) and on_cpu(later):
        return (later.start_ns - earlier.end_ns) / 1e6
    return None


def _device_of(device) -> torch.device | None:
    """The device of a device or of a tensor on it."""
    return device.device if isinstance(device, torch.Tensor) else device


class StageTimer:
    """Spans and counts, the last :data:`RING` of them kept.

    Usage::

        timer = StageTimer()
        with timer.stage("preprocess"):
            ...
        timer.summary()  # {'preprocess': {'n': 1, 'total_s': ..., 'mean_ms': ..., 'p50_ms': ...,
                         #                 'self_ms': ...}}

    :meth:`span` also times a device's work. On a CUDA card it records two
    timing events on the stream (the device's current one unless given),
    taken from a pool that the ring refills as it turns over; their device
    ms are read only once the caller has synchronised, and the tracer never
    synchronises. On the CPU, which runs the step as it is issued, a span's
    device ms are its host ms. While a ``torch.profiler`` session records,
    a span also opens a ``RecordFunction`` of its name, which a trace of
    host operators shows on the profiler's clock.
    """

    def __init__(self) -> None:
        self._ring: list[Span | Count | None] = [None] * RING
        self._ids = itertools.count()
        self._open = threading.local()  # each thread's stack of open spans
        self._events: dict[torch.device, list] = {}  # free timing events, by device
        self._streams: dict[tuple[int, int], torch.cuda.Stream] = {}  # by (card, raw handle)

    def stage(self, name: str) -> "_SpanCtx":
        """A span of host work."""
        return _SpanCtx(self, name, None, None, None)

    def span(self, name: str, device=None, batch: int | None = None,
             stream=None) -> "_SpanCtx":
        """A span of work on ``device`` (a device or a tensor on it; None:
        host work), timed on ``stream`` on a CUDA card. ``batch`` defaults
        to the enclosing span's."""
        return _SpanCtx(self, name, device, batch, stream)

    def record(self, name: str, seconds: float) -> None:
        """A span of host work of ``seconds`` that ended now."""
        end = time.perf_counter_ns()
        parent = self._top()
        self._put(Span(name, parent and parent.batch, parent and parent.id, next(self._ids),
                       None, end - round(seconds * 1e9), end))

    def count(self, name: str, n: int, batch: int | None = None) -> None:
        """``n`` of ``name``; ``batch`` defaults to the enclosing span's."""
        parent = self._top()
        if batch is None and parent is not None:
            batch = parent.batch
        self._put(Count(name, batch, parent and parent.id, next(self._ids), n,
                        time.perf_counter_ns()))

    def records(self) -> list[Span | Count]:
        """What the ring holds, in the order the spans began."""
        return sorted((r for r in self._ring if r is not None), key=lambda r: r.id)

    def summary(self) -> dict[str, dict[str, float]]:
        """Per name over what the ring holds. A span: ``n``, ``total_s``,
        host ``mean_ms`` and ``p50_ms``, ``self_ms`` (the mean of each span
        less what its child spans cover) and, where timed, ``device_ms``
        (the mean). A count: ``n``, ``total`` and ``mean``."""
        records = self.records()
        covered: dict[int, int] = {}
        by_name: dict[str, list] = {}
        for r in records:
            by_name.setdefault(r.name, []).append(r)
            if isinstance(r, Span) and r.parent is not None:
                covered[r.parent] = covered.get(r.parent, 0) + r.end_ns - r.start_ns
        out = {}
        for name, rs in by_name.items():
            if isinstance(rs[0], Count):
                total = sum(r.n for r in rs)
                out[name] = {"n": len(rs), "total": total, "mean": total / len(rs)}
                continue
            host = sorted(r.end_ns - r.start_ns for r in rs)
            total = sum(host)
            row = {"n": len(rs), "total_s": total / 1e9, "mean_ms": total / 1e6 / len(rs),
                   "p50_ms": host[len(host) // 2] / 1e6,
                   "self_ms": (total - sum(covered.get(r.id, 0) for r in rs)) / 1e6 / len(rs)}
            device = [d for d in (r.device_ms for r in rs) if d is not None]
            if device:
                row["device_ms"] = sum(device) / len(device)
            out[name] = row
        return out

    def clear(self) -> None:
        for i, r in enumerate(self._ring):
            self._ring[i] = None
            self._release(r)

    def _stack(self) -> list[Span]:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def _top(self) -> Span | None:
        stack = getattr(self._open, "stack", None)
        return stack[-1] if stack else None

    def _current_stream(self, device: torch.device):
        """The card's current stream, found by its raw handle (a cheap read,
        where ``torch.cuda.current_stream`` builds a new object each call)."""
        index = device.index if device.index is not None else torch.cuda.current_device()
        key = (index, torch._C._cuda_getCurrentRawStream(index))
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.current_stream(index)
        return stream

    def _event(self, device: torch.device):
        pool = self._events.get(device)
        return pool.pop() if pool else torch.cuda.Event(enable_timing=True)

    def _release(self, r) -> None:
        """Give an evicted span's events back to the pool, its device ms
        kept where the device has passed them."""
        if isinstance(r, Span) and r.events is not None:
            _ = r.device_ms
            self._events.setdefault(r.device, []).extend(r.events)
            r.events = None

    def _put(self, r: Span | Count) -> None:
        i = r.id % RING
        self._release(self._ring[i])
        self._ring[i] = r


class _SpanCtx:
    """An open span: :meth:`StageTimer.span`'s context, giving its
    :class:`Span`."""

    __slots__ = ("_timer", "_name", "_device", "_batch", "_stream", "_span", "_rf")

    def __init__(self, timer: StageTimer, name: str, device, batch: int | None,
                 stream) -> None:
        self._timer, self._name, self._device, self._batch = timer, name, device, batch
        self._stream, self._span, self._rf = stream, None, None

    def __enter__(self) -> Span:
        timer = self._timer
        stack = timer._stack()
        parent = stack[-1] if stack else None
        batch = self._batch if self._batch is not None or parent is None else parent.batch
        device = _device_of(self._device)
        span = Span(self._name, batch, parent and parent.id, next(timer._ids), device)
        stack.append(span)
        self._span = span
        if _profiler._is_profiler_enabled:
            self._rf = torch._C._profiler._RecordFunctionFast(self._name)
            self._rf.__enter__()
        span.start_ns = time.perf_counter_ns()
        if device is not None and device.type == "cuda":
            if self._stream is None:
                self._stream = timer._current_stream(device)
            span.events = (timer._event(device), timer._event(device))
            span.events[0].record(self._stream)
        return span

    def __exit__(self, *exc: object) -> None:
        span = self._span
        if span.events is not None:
            span.events[1].record(self._stream)
        span.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        if span.device is not None and span.events is None:
            span._device_ms = span.host_ms
        self._timer._stack().pop()
        self._timer._put(span)


# -- the process's tracer ------------------------------------------------------

_TRACER = StageTimer()
_enabled = False
_NULL = contextlib.nullcontext()


def enable() -> None:
    """Turn the process's tracer on, until :func:`disable`. A
    ``torch.profiler`` session turns it on by itself while it records."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def _traceable() -> bool:
    """Not inside a graph being compiled or exported, nor a CUDA graph
    being captured: the step's graphs take no span."""
    if torch.compiler.is_compiling():
        return False
    return not (torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing())


def tracer() -> StageTimer | None:
    """The process's tracer while it is on, else None."""
    if (_enabled or _profiler._is_profiler_enabled) and _traceable():
        return _TRACER
    return None


def process_tracer() -> StageTimer:
    """The process's tracer, on or off: what it recorded, to read."""
    return _TRACER


def span(name: str, device=None, batch: int | None = None, stream=None):
    """:meth:`StageTimer.span` of the process's tracer while it is on;
    off, the shared no-op context (which gives None)."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _NULL
    return _TRACER.span(name, device, batch, stream) if _traceable() else _NULL


def count(name: str, n: int, batch: int | None = None) -> None:
    """:meth:`StageTimer.count` of the process's tracer while it is on."""
    if (_enabled or _profiler._is_profiler_enabled) and _traceable():
        _TRACER.count(name, n, batch)
