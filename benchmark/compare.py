"""The numbers that decide ``correct``: the program's host outputs of a
sample of the window's frames against the plain reference's outputs for the
same frames.

Every number is a gap over the whole sample, from the detections down to
the millimetre readings:

- ``det_miss_pct``: of the confident detections (score at least the
  candidate threshold + 0.1) on either side, the share in % that has no
  detection of its class on the other side with IoU >= 0.5;
- ``score_gap``, ``box_gap_px``: over the detections matched one to one
  (same class, IoU >= 0.5, greedily by IoU), the mean |score difference|
  and the mean |coordinate difference| in frame pixels;
- ``stitch_miss_pct``, ``stitch_gap_px``: the same for the stitch sets
  (matched by centre, within half a stitch's width), and the mean |cx, cy,
  left, right difference| of the matched stitches in frame pixels;
- ``stitch_gap_q75_px``: over the matched pairs of stitches and the
  stitches of either side that have no match, the 75th percentile of a
  stitch's gap: the mean |cx, cy, left, right difference| of a pair,
  :data:`MISS_PX` for a stitch without a match. Rounding noise of the soft masks' moments
  averages out over a stitch's cells; an error common to them does not;
  with half of the frames left out, half of the entries are misses;
- ``envelope_gap``: the mean |difference| of the fabric envelope on the
  mask grid over the columns both sides find fabric in, and
  ``envelope_miss_pct`` the share of columns only one side finds it in;
- ``mm_gap``, ``mm_gap_max``: the mean and the largest |difference| of
  the seam-allowance and stitch-width readings (mm) where both sides give
  one, and ``mm_miss_pct`` the share of readings only one side gives.

A cell's limits file says which numbers are compared and their limits.
"""

from __future__ import annotations

import math

import numpy as np

MM_FIELDS = ("edge_distance_mm", "stitch_width_mm")
MISS_PX = 100.0  # the gap of a stitch that has no match on the other side


def frame_outputs(outs, j: int) -> dict:
    """Frame ``j`` of a ``PipelineOutputs`` as plain numpy."""
    m, s = outs.measurements, outs.stitches
    return {
        "boxes_frame": np.asarray(outs.boxes_frame[j], np.float64),
        "scores": np.asarray(outs.scores[j], np.float64),
        "classes": np.asarray(outs.classes[j]),
        "valid": np.asarray(outs.valid[j], bool),
        "stitches": {k: np.asarray(getattr(s, k)[j]) for k in ("cx", "cy", "left", "right",
                                                                 "valid")},
        "envelope": np.asarray(outs.envelope[j], np.float64),
        "measurements": {k: float(getattr(m, k)[j]) for k in MM_FIELDS},
    }


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area = lambda x: np.clip(x[:, 2] - x[:, 0], 0, None) * np.clip(x[:, 3] - x[:, 1], 0, None)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-9)


def _match(cost_ok: np.ndarray, score: np.ndarray) -> list[tuple[int, int]]:
    """One-to-one pairs, best ``score`` first, among allowed pairs."""
    pairs = []
    if cost_ok.size == 0:
        return pairs
    order = np.argsort(-np.where(cost_ok, score, -np.inf), axis=None, kind="stable")
    used_a, used_b = set(), set()
    for flat in order:
        i, j = divmod(int(flat), cost_ok.shape[1])
        if not cost_ok[i, j]:
            break
        if i not in used_a and j not in used_b:
            pairs.append((i, j))
            used_a.add(i)
            used_b.add(j)
    return pairs


class Gaps:
    """Accumulates the gaps frame by frame; :meth:`numbers` gives them."""

    def __init__(self, confident: float, record: bool = False) -> None:
        self.confident = confident
        self.record = {"det": [], "stitch": [], "mm": [], "env": []} if record else None
        self.sums: dict[str, float] = {}
        self.mm_max = 0.0
        self.stitch_gaps: list[float] = []
        self.frames = 0

    def _add(self, key: str, value: float) -> None:
        self.sums[key] = self.sums.get(key, 0.0) + value

    def add(self, prog: dict, ref: dict) -> None:
        self.frames += 1
        pv, rv = prog["valid"], ref["valid"]
        pb, rb = prog["boxes_frame"][pv], ref["boxes_frame"][rv]
        pc, rc = prog["classes"][pv], ref["classes"][rv]
        ps, rs = prog["scores"][pv], ref["scores"][rv]
        iou = _iou(pb, rb) if len(pb) and len(rb) else np.zeros((len(pb), len(rb)))
        ok = (iou >= 0.5) & (pc[:, None] == rc[None, :])
        for conf, has in ((ps >= self.confident, ok.any(1) if ok.size else np.zeros(len(pb), bool)),
                          (rs >= self.confident, ok.any(0) if ok.size else np.zeros(len(rb), bool))):
            self._add("det_confident", float(conf.sum()))
            self._add("det_missed", float((conf & ~has).sum()))
        for i, j in _match(ok, iou):
            self._add("det_pairs", 1)
            self._add("score_sum", abs(ps[i] - rs[j]))
            self._add("box_sum", float(np.abs(pb[i] - rb[j]).mean()))
            if self.record is not None:
                self.record["det"].append([int(pc[i]), ps[i], rs[j], *pb[i], *rb[j]])

        sp, sr = prog["stitches"], ref["stitches"]
        spv, srv = np.asarray(sp["valid"], bool), np.asarray(sr["valid"], bool)
        p_pts = np.stack([np.asarray(sp[k], np.float64)[spv] for k in ("cx", "cy", "left", "right")], 1)
        r_pts = np.stack([np.asarray(sr[k], np.float64)[srv] for k in ("cx", "cy", "left", "right")], 1)
        self._add("stitch_count", float(len(p_pts) + len(r_pts)))
        if len(p_pts) and len(r_pts):
            half = 0.5 * np.abs(r_pts[:, 3] - r_pts[:, 2])
            dist = np.abs(p_pts[:, None, 0] - r_pts[None, :, 0])
            pairs = _match(dist <= np.maximum(half[None, :], 1.0), -dist)
        else:
            pairs = []
        missed = len(p_pts) + len(r_pts) - 2 * len(pairs)
        self._add("stitch_missed", float(missed))
        self.stitch_gaps.extend([MISS_PX] * missed)
        for i, j in pairs:
            self._add("stitch_pairs", 1)
            gap = float(np.abs(p_pts[i] - r_pts[j]).mean())
            self._add("stitch_sum", gap)
            self.stitch_gaps.append(gap)
            if self.record is not None:
                self.record["stitch"].append([*p_pts[i], *r_pts[j]])

        pe, re_ = prog["envelope"], ref["envelope"]
        both, either = (pe >= 0) & (re_ >= 0), (pe >= 0) | (re_ >= 0)
        self._add("env_cols", float(either.sum()))
        self._add("env_missed", float((either & ~both).sum()))
        self._add("env_both", float(both.sum()))
        self._add("env_sum", float(np.abs(pe[both] - re_[both]).sum()))
        if self.record is not None:
            self.record["env"].append([float(np.abs(pe[both] - re_[both]).max(initial=0.0)),
                                       int((either & ~both).sum()), int(both.sum())])

        for k in MM_FIELDS:
            a, b = prog["measurements"][k], ref["measurements"][k]
            if self.record is not None:
                self.record["mm"].append([k, a, b])
            self._add("mm_count", 1)
            if math.isfinite(a) and math.isfinite(b):
                self._add("mm_pairs", 1)
                self._add("mm_sum", abs(a - b))
                self.mm_max = max(self.mm_max, abs(a - b))
            elif math.isfinite(a) != math.isfinite(b):
                self._add("mm_missed", 1)

    def numbers(self) -> dict[str, float]:
        s = lambda k: float(self.sums.get(k, 0.0))
        share = lambda a, b: 100.0 * s(a) / s(b) if s(b) else 0.0
        mean = lambda a, b: s(a) / s(b) if s(b) else 0.0
        return {
            "det_miss_pct": share("det_missed", "det_confident"),
            "score_gap": mean("score_sum", "det_pairs"),
            "box_gap_px": mean("box_sum", "det_pairs"),
            "stitch_miss_pct": share("stitch_missed", "stitch_count"),
            "stitch_gap_px": mean("stitch_sum", "stitch_pairs"),
            "stitch_gap_q75_px": (float(np.percentile(self.stitch_gaps, 75))
                                  if self.stitch_gaps else 0.0),
            "envelope_gap": mean("env_sum", "env_both"),
            "envelope_miss_pct": share("env_missed", "env_cols"),
            "mm_gap": mean("mm_sum", "mm_pairs"),
            "mm_gap_max": float(self.mm_max),
            "mm_miss_pct": share("mm_missed", "mm_count"),
        }

    def counts(self) -> dict[str, int]:
        return {"frames": self.frames, "detection_pairs": int(self.sums.get("det_pairs", 0)),
                "stitch_pairs": int(self.sums.get("stitch_pairs", 0)),
                "mm_pairs": int(self.sums.get("mm_pairs", 0))}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, list[str]]:
    """``correct`` and one line per compared number: its value and limit.
    A number that is not finite fails."""
    lines, ok = [], True
    for name, limit in limits.items():
        value = numbers[name]
        good = math.isfinite(value) and value <= limit
        ok &= good
        lines.append(f"{name} {value!r} limit {limit!r}{'' if good else ' FAIL'}")
    return ok, lines
