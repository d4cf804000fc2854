#!/usr/bin/env python3
"""Counts the calls that synchronise the host with the card in one
inspection step of ``tti_torch``.

    python tools/step_syncs_torch.py [--root DIR]

Builds the deploy step (960x1280 frames, imgsz 960, the cam checkpoint) and
the headline step (1080x1920 frames, imgsz 640, the stride-4 checkpoint) of
the ``tti_torch`` package under ``--root`` (default: this checkout; another
tree that holds ``tti_torch/`` and ``tests/torch_synth.py``, e.g. an unpacked
``git archive`` of an earlier commit, to count its step; the checkpoints come
from this checkout), warms each at batch 1 and 128 on device-resident seeded
frames, then runs ``step`` under ``torch.cuda.set_sync_debug_mode("warn")``
twice and prints the second window's count and where each call was raised
(the first window too where it differs). ``process_batch``'s upload and
read-back are outside the window. Needs a CUDA device; prints the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import os
import subprocess
import sys
import traceback
import warnings

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The deployment calibration (1280x960 sensor) and extrinsics.
K_960 = np.array([[937.1384518987244, 0.0, 636.148901113533],
                  [0.0, 884.022038878419, 422.3901781816556],
                  [0.0, 0.0, 1.0]])
DIST = np.array([0.07994929130530135, 0.04758675999900327, -0.04013555042332606,
                 -0.005228657034776396, -0.1334157094005971])
RVEC = np.array([-0.8631369244225452, -0.3919482615538663, -1.3591256137314185])
TVEC = np.array([0.005016396186926285, 0.03590342712705542, 0.09382141278570659])

CONFIGS = {  # name: (frame_hw, imgsz, checkpoint)
    "deploy": ((960, 1280), 960, "yolov8n_textile_cam.msgpack"),
    "headline": ((1080, 1920), 640, "yolov8n_textile.msgpack"),
}


def _sync_window(torch, pipe, frames) -> list[str]:
    """One ``pipe.step(frames)`` under ``set_sync_debug_mode("warn")``: for
    each synchronising call, the innermost frame of the call stack and the
    innermost frame of this checkout's code (where the step asked for it)."""
    found = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if not f.filename.endswith(("warnings.py", "step_syncs_torch.py"))]
        ours = [f for f in stack if os.path.abspath(f.filename).startswith(HERE)
                and "site-packages" not in f.filename]
        where = f"{os.path.relpath(filename, HERE)}:{lineno}"
        if ours and (ours[-1].filename, ours[-1].lineno) != (filename, lineno):
            where += f" from {os.path.relpath(ours[-1].filename, HERE)}:{ours[-1].lineno}"
        found.append(where)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pipe.step(frames)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return found


def count_step_syncs(torch, pipe, frames) -> tuple[int, list[str], list[str]]:
    """The synchronising calls of one ``pipe.step(frames)`` in steady state:
    after a warm step and a collection of the process's garbage (a finalizer
    may synchronise), two windows in turn; the second is the count. Returns
    (count, where each was raised, the first window's list, which differs
    from the second where something happened once in the process)."""
    pipe.step(frames)
    gc.collect()
    torch.cuda.synchronize()
    first = _sync_window(torch, pipe, frames)
    second = _sync_window(torch, pipe, frames)
    return len(second), second, first


def build_step(name: str, **pipe_kw):
    """The ``tti_torch`` step of configuration ``name`` as bench.py runs it:
    bf16, the deployment calibration scaled to the frame, bench.py's ROI;
    ``pipe_kw`` are further ``InspectionPipeline`` arguments."""
    from tti_torch.calib.io import CalibrationData
    from tti_torch.core.config import MeasureConfig, ModelConfig, RoiConfig
    from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
    from tti_torch.parallel.runtime import InspectionPipeline

    (h, w), imgsz, ckpt = CONFIGS[name]
    path = os.path.join(HERE, "checkpoints", ckpt)
    meta = checkpoint_metadata(path)
    K = K_960.copy()
    K[0] *= w / 1280.0
    K[1] *= h / 960.0
    cfg = ModelConfig(variant=meta.get("variant", "n"), num_classes=meta.get("num_classes", 2),
                      image_size=imgsz, dtype="bfloat16",
                      mask_stride=meta.get("mask_stride", 4),
                      proto_head=meta.get("proto_head", "deconv"))
    roi = RoiConfig(enabled=True, x_min=10, x_max=w - 10, y_min=min(300, h // 3),
                    y_max=h - min(200, h // 5))
    return InspectionPipeline(cfg, load_flax_msgpack(path), (h, w),
                              calibration=CalibrationData(K=K, dist=DIST, rvec=RVEC, tvec=TVEC),
                              measure_cfg=MeasureConfig().with_subcell_from(meta), roi=roi,
                              device="cuda", **pipe_kw)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE, help="the checkout whose tti_torch is counted")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "tests")]

    import torch
    from torch_synth import textile_frames

    if not torch.cuda.is_available():
        print("step_syncs_torch: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"tti_torch from {root}", flush=True)
    for name, (hw, _, _) in CONFIGS.items():
        pipe = build_step(name)
        base = textile_frames(8, *hw, seed=5)
        for batch in (1, 128):
            frames = torch.from_numpy(np.ascontiguousarray(
                np.tile(base, ((batch + 7) // 8, 1, 1, 1))[:batch])).cuda()
            n, where, first = count_step_syncs(torch, pipe, frames)
            print(f"{name} batch {batch}: {n} synchronising calls per step: {where}"
                  + (f" (the first window: {first})" if first != where else ""), flush=True)
        del pipe
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
