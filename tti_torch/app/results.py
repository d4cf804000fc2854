"""Host-boundary conversion: one frame's measurement -> the reference's dict
contract (copy of ``tti.app.results``).

``process_frame`` in the reference returns
``{'edge_distance_mm': float|None, 'stitch_width_mm': float|None,
   'stitch_count': int, 'timestamp': datetime[, 'error': str]}``
(reference: measurement.py:506-511; error paths measurement.py:212-216,
281-287,332-337). On the device the port uses NaN for "absent"; this module
restores None + error strings at the host boundary so downstream consumers of
the reference can switch over unchanged.
"""

from __future__ import annotations

import math
from datetime import datetime
from typing import Any

import numpy as np
import torch

ERR_NO_FABRIC = "Fabric not detected"  # (reference: measurement.py:287)
ERR_NO_STITCHES = "No stitches detected"  # (reference: measurement.py:337)
ERR_INFERENCE = "Model inference failed"  # (reference: measurement.py:215)


def _opt(value) -> float | None:
    v = float(np.asarray(value))
    return None if math.isnan(v) else v


def measurement_to_dict(meas, index: int | None = None, now: datetime | None = None) -> dict[str, Any]:
    """Convert one FrameMeasurement (or element ``index`` of a batched one) to
    the reference dict contract. Fields are numpy arrays (``outputs_to_host``)
    or tensors on any device (``MultiStreamRunner``'s smoothed results)."""

    def pick(x):
        arr = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        return arr[index] if index is not None else arr

    out: dict[str, Any] = {
        "edge_distance_mm": _opt(pick(meas.edge_distance_mm)),
        "stitch_width_mm": _opt(pick(meas.stitch_width_mm)),
        "stitch_count": int(pick(meas.n_dist)),
        "timestamp": now or datetime.now(),
    }
    if not bool(pick(meas.fabric_detected)):
        out["error"] = ERR_NO_FABRIC
    elif int(pick(meas.n_stitches)) == 0:
        out["error"] = ERR_NO_STITCHES
    return out
