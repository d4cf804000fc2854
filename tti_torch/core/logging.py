"""Structured logging (copy of ``tti.core.logging``; host code only).

Standard ``logging`` loggers under the root ``tti_torch``, carrying structured
``extra`` fields (keys prefixed ``tti_``), so deployments can ship JSON lines
while development gets readable console output.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any

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


class StageTimer:
    """Per-stage wall-clock timing on the host.

    Usage::

        timer = StageTimer()
        with timer.stage("preprocess"):
            ...
        timer.summary()  # {'preprocess': {'n': 1, 'total_s': ..., 'mean_ms': ..., 'p50_ms': ...}}
    """

    def __init__(self) -> None:
        self._acc: dict[str, list[float]] = {}

    def stage(self, name: str) -> "_StageCtx":
        return _StageCtx(self, name)

    def record(self, name: str, seconds: float) -> None:
        self._acc.setdefault(name, []).append(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, samples in self._acc.items():
            total = sum(samples)
            out[name] = {
                "n": len(samples),
                "total_s": total,
                "mean_ms": 1e3 * total / max(1, len(samples)),
                "p50_ms": 1e3 * sorted(samples)[len(samples) // 2] if samples else 0.0,
            }
        return out


class _StageCtx:
    def __init__(self, timer: StageTimer, name: str) -> None:
        self._timer = timer
        self._name = name
        self._t0 = 0.0

    def __enter__(self) -> "_StageCtx":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> None:
        self._timer.record(self._name, time.perf_counter() - self._t0)
