#!/usr/bin/env python3
"""Per-frame comparison of two millimetre reports on the same scenes.

    python tools/compare_measure_reports.py A.json B.json

A and B are the JSON files that ``tools/measure_report.py`` and
``tools/measure_report_torch.py`` write beside their tables (same seed, same
scene count). For each path/dtype in both: frames with a reading in only one
of them, and the largest and median |A - B| of raw_edge_mm and raw_width_mm
over the frames where both read, and of n_detected. Host only.
"""

from __future__ import annotations

import json
import sys

import numpy as np


def compare(a: dict, b: dict) -> list[str]:
    if a["truth"]["edge"] != b["truth"]["edge"]:
        raise SystemExit("the two reports were not made on the same scenes")
    lines = []
    for key in sorted(set(a["per_frame"]) & set(b["per_frame"])):
        fa, fb = a["per_frame"][key], b["per_frame"][key]
        parts = [key]
        for name in ("edge", "width"):
            x = np.asarray(fa[f"{name}_measured"], float)
            y = np.asarray(fb[f"{name}_measured"], float)
            both = np.isfinite(x) & np.isfinite(y)
            d = np.abs(x[both] - y[both])
            parts.append(f"{name}: {int(both.sum())} frames in both, "
                         f"{int((np.isfinite(x) & ~np.isfinite(y)).sum())} only in A, "
                         f"{int((~np.isfinite(x) & np.isfinite(y)).sum())} only in B, "
                         f"|A - B| max {d.max():.6f} median {np.median(d):.6f} mm")
        n = np.asarray(fa["n_detected"]) - np.asarray(fb["n_detected"])
        parts.append(f"n_detected differs on {int((n != 0).sum())} frames")
        lines.append("; ".join(parts))
    return lines


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__.split("\n\n")[1].strip(), file=sys.stderr)
        return 2
    with open(sys.argv[1]) as f:
        a = json.load(f)
    with open(sys.argv[2]) as f:
        b = json.load(f)
    for line in compare(a, b):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
