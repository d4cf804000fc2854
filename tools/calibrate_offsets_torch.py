"""Per-checkpoint readout-offset calibration through the port (``tti_torch``).

The learned occupancy/logit field places boundaries with a small systematic
mm bias, which belongs to the net, not the optics. The reference corrects
this class of error with empirically calibrated constants applied to the
final measurements (reference config.py:156-157). This tool derives the
constants per checkpoint and writes them into the checkpoint's sidecar
(``cal_edge_mm`` / ``cal_width_mm``), where
``MeasureConfig.with_subcell_from`` picks them up for every consumer; every
other key of the sidecar is kept. It is the counterpart of
``tools/calibrate_offsets.py`` and imports nothing of ``tti``.

Method: render N analytic deployment-geometry scenes
(``tools/measure_report_torch.py``'s oracle) from a seed disjoint from the
mm report's (report seed 0; calibration default 7700), run the port's
deploy step uncalibrated (``TTI_READOUT_CAL=0`` while the step is built and
run, so offsets already in the sidecar do not feed back), and store the
negated median signed error. The caller's ``TTI_READOUT_CAL`` is put back
afterwards.

    python tools/calibrate_offsets_torch.py --weights checkpoints/foo.msgpack
    # then: python tools/measure_report_torch.py --weights checkpoints/foo.msgpack

The card by default; ``--device cpu`` on the host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.measure_report_torch import PlaneMapper, make_measure_scene, run_pipeline  # noqa: E402


def calibrate(weights: str, scenes: int = 96, seed: int = 7700, imgsz: int = 960,
              batch: int = 16, dtype: str = "float32", undistort: bool = False,
              device: str = "cuda") -> dict:
    """The median signed edge and width errors of the uncalibrated deploy
    step on a fresh analytic scene set, negated, with the raw biases and the
    edge coverage. ``undistort=False`` is the reference-native path (the
    production default); the boundary bias is a mask-grid property that both
    paths share."""
    mapper = PlaneMapper()
    rng = np.random.default_rng(seed)
    frames, truths = [], []
    for i in range(scenes):
        bgr, truth = make_measure_scene(mapper, rng)
        frames.append(bgr)
        truths.append(truth)
        if (i + 1) % 32 == 0:
            print(f"rendered {i + 1}/{scenes}", flush=True)
    frames = np.stack(frames)
    gt_edge = np.array([t.frame_edge for t in truths])
    gt_width = np.array([t.frame_width for t in truths])

    # Uncalibrated whatever the sidecar holds: the step is built inside
    # run_pipeline, after the switch is set.
    previous = os.environ.get("TTI_READOUT_CAL")
    os.environ["TTI_READOUT_CAL"] = "0"
    try:
        edge, width, _ = run_pipeline(frames, weights, undistort=undistort, dtype=dtype,
                                      imgsz=imgsz, batch=batch, device=device)
    finally:
        if previous is None:
            del os.environ["TTI_READOUT_CAL"]
        else:
            os.environ["TTI_READOUT_CAL"] = previous

    e_ok = np.isfinite(edge)
    w_ok = np.isfinite(width)
    e_err = edge[e_ok] - gt_edge[e_ok]
    w_err = width[w_ok] - gt_width[w_ok]
    return {
        "cal_edge_mm": round(float(-np.median(e_err)), 4),
        "cal_width_mm": round(float(-np.median(w_err)), 4),
        "cal_scenes": int(scenes),
        "cal_seed": int(seed),
        "cal_edge_bias_raw": round(float(np.mean(e_err)), 4),
        "cal_width_bias_raw": round(float(np.mean(w_err)), 4),
        "cal_coverage": round(float(e_ok.mean()), 4),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--weights", required=True, help="deploy .msgpack (the sidecar .json next "
                    "to it receives the constants)")
    ap.add_argument("--scenes", type=int, default=96)
    ap.add_argument("--seed", type=int, default=7700,
                    help="must stay disjoint from the measure-report seed")
    ap.add_argument("--imgsz", type=int, default=960)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--undistort", action="store_true",
                    help="calibrate on the rectified path (default: reference-native)")
    ap.add_argument("--device", default="cuda", help="torch device (cpu only when asked)")
    args = ap.parse_args(argv)

    import torch

    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("calibrate_offsets_torch: no CUDA device (pass --device cpu for the host)",
                  file=sys.stderr)
            return 2
        # float32 means float32: no TF32 in the convolutions or products.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    cal = calibrate(args.weights, scenes=args.scenes, seed=args.seed, imgsz=args.imgsz,
                    batch=args.batch, dtype=args.dtype, undistort=args.undistort,
                    device=args.device)
    sidecar = args.weights + ".json"
    meta = {}
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            meta = json.load(f)
    meta.update(cal)
    with open(sidecar, "w") as f:
        json.dump(meta, f, indent=2)
    print(f"wrote {sidecar}: cal_edge_mm={cal['cal_edge_mm']:+.4f} "
          f"cal_width_mm={cal['cal_width_mm']:+.4f} "
          f"(raw bias {cal['cal_edge_bias_raw']:+.4f}/"
          f"{cal['cal_width_bias_raw']:+.4f}, {time.time()-t0:.0f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
