#!/usr/bin/env python3
"""Pass-2 weight bytes of each rank's slab on a space mesh, banded against
dense, for the s2d-emitting two-pass warp (``tti_torch.preprocess.
warp2pass.TwoPassWarp.rows``), counted from the undistort map alone: no
weight is built, so it runs at full width on a host.

Pass 2's weights over output rows [r0, r1) read, per output row, the two
source rows of its bilinear taps. The dense slab holds every column of
every row over the slab's band of source rows (plus the pad's rows); the
banded slab holds each band's rows over that band's own window. Both count
bf16 weights (the card's) by default.

    python tools/warp_bands_torch.py [--block 64] [--spaces 2,4]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# bench.py's two configurations: (frame rows, frame columns), imgsz.
CONFIGS = {"deploy": ((960, 1280), 960), "headline": ((1080, 1920), 640)}


def tap_rows(map_xy: np.ndarray, hs: int) -> tuple[np.ndarray, np.ndarray]:
    """For each output row of the map: the first and one past the last
    source row that a non-zero pass-2 weight of the row reads
    (``TwoPassWarp``'s taps y0 = floor(my) and y0 + 1, weights 1 - fy and
    fy); (big, -1 + 1) for a row that reads none."""
    mx, my = (np.asarray(map_xy[..., i], np.float64) for i in (0, 1))
    sent = (mx < -1e5) | (my < -1e5)
    y0 = np.floor(my).astype(np.int64)
    fy = (my - y0).astype(np.float32)
    lo = np.full(my.shape[0], np.iinfo(np.int64).max)
    hi = np.full(my.shape[0], -1)
    for tap, wgt in ((y0, 1.0 - fy), (y0 + 1, fy)):
        ok = (tap >= 0) & (tap < hs) & ~sent & (wgt != 0)
        lo = np.minimum(lo, np.where(ok, tap, lo[:, None]).min(1))
        hi = np.maximum(hi, np.where(ok, tap, -1).max(1))
    return lo, hi + 1


def slab_pass2(lo: np.ndarray, hi: np.ndarray, dst_w: int, r0: int, r1: int, block: int,
               size: int = 2) -> dict:
    """The slab [r0, r1)'s pass-2 weights: its source rows, its bands and
    their bytes (``size`` bytes per weight), and the dense slab's bytes."""
    from tti_torch.preprocess.warp2pass import PAD_ROWS

    live = hi[r0:r1] > lo[r0:r1]
    y0, y1 = ((int(lo[r0:r1][live].min()), int(hi[r0:r1][live].max())) if live.any()
              else (0, 1))
    banded, bands = 0, 0
    for b0 in range(0, len(lo), block):
        a, b = max(r0, b0), min(r1, b0 + block)
        if a >= b:
            continue
        bands += 1
        ok = hi[a:b] > lo[a:b]
        window = int(hi[a:b][ok].max() - lo[a:b][ok].min()) if ok.any() else 0
        banded += dst_w * (b - a) * (window + PAD_ROWS) * size
    return {"src_rows": (y0, y1), "bands": bands, "bytes": banded,
            "dense_bytes": dst_w * (r1 - r0) * (y1 - y0 + PAD_ROWS) * size}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--spaces", default="2", help="space sizes, comma-separated")
    args = ap.parse_args(argv)

    from tools.tune_device_torch import DIST, K_1280x960
    from tti_torch.parallel.spatial import slab_plan
    from tti_torch.preprocess.letterbox import make_letterbox_spec
    from tti_torch.preprocess.remap import build_small_undistort_map

    for name, ((h, w), imgsz) in CONFIGS.items():
        spec = make_letterbox_spec(h, w, imgsz, "rect")
        K = K_1280x960.copy()
        K[0] *= w / 1280
        K[1] *= h / 960
        lo, hi = tap_rows(build_small_undistort_map(K, DIST, spec, unpadded_src=True), spec.new_h)
        for n in (int(x) for x in args.spaces.split(",")):
            plan = slab_plan(spec.dst_h, n)
            for r in range(n):
                r0, r1 = plan.input_rows(r)
                s = slab_pass2(lo, hi, spec.dst_w, r0, r1, args.block)
                print(f"{name} ({h}x{w}, imgsz {imgsz}, model input {spec.dst_h}x{spec.dst_w}), "
                      f"space {n}, rank {r}: rows [{r0}, {r1}), pass-1 source rows "
                      f"{list(s['src_rows'])}, {s['bands']} pass-2 bands of {args.block} rows: "
                      f"{s['bytes']} bytes banded, {s['dense_bytes']} dense "
                      f"({s['bytes'] / s['dense_bytes']:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
