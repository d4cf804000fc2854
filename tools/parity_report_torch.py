"""Full-geometry predict-chain parity report of the port (``tti_torch``).

Runs the reference deployment's geometry, 1280x960 camera frames at predict
imgsz 960 with the Ultralytics auto minimal-rect letterbox (a 960x736 model
input; reference: config.py:59-60, measurement.py:208-210), and an
identity-scale 960x736 frame (no resample), through

  (a) the Ultralytics-semantics oracle (``tests/torch_ref.ultralytics_predict``:
      a torch forward and cv2 preprocessing, operation for operation), and
  (b) the port's predict chain (``tti_torch.app.predict.Predictor``) at
      float32 and at the production bfloat16 compute dtype (``--quant``:
      also the W8A8 int8 model, kernels E and F on the card),

and writes the table of ``tools/parity_report.py``: box and score agreement
and per-instance frame-resolution mask IoU against the 0.999 north star. It
keeps its own copies of that tool's frame generator and mask IoU (which live
in a test module of ``tti``), so it imports nothing of ``tti`` and no jax.

With ``--weights`` the checkpoint goes into the oracle through
``tti_torch.model.convert.to_torch_state_dict`` and the frames are the
port's seeded textile scenes (``tests/torch_scenes.textile_scene``, centre
cropped); without, a seeded detecting network
(``tests/torch_ref.make_detecting_model``) is converted the other way.

Usage (the card by default; ``--device cpu`` on the host):
  python tools/parity_report_torch.py [--weights CKPT] [--frames N] [--out PATH]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# The oracle and the scenes are test helpers, imported by module name from
# tests/: a regular package named ``tests`` installed on the host would
# shadow the repository's namespace package.
sys.path.insert(1, str(ROOT / "tests"))

import numpy as np  # noqa: E402

IOU_GOAL = 0.999


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two masks thresholded at 0.5 (1.0 when both are empty)."""
    a, b = a > 0.5, b > 0.5
    union = np.logical_or(a, b).sum()
    return 1.0 if union == 0 else float(np.logical_and(a, b).sum() / union)


def textured_frame(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth structured uint8 frame (pure noise makes every mask boundary
    pixel a coin flip; real frames are piecewise smooth)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (110 + 70 * np.sin(xx / 17.0 + rng.uniform(0, 6)) * np.cos(yy / 23.0)
            + 40 * np.sin((xx + 2 * yy) / 41.0))
    frame = np.stack([base, np.roll(base, 5, 1), np.roll(base, 9, 0)], -1)
    frame += rng.normal(0, 6, size=frame.shape)
    return np.clip(frame, 0, 255).astype(np.uint8)


def scene_frame(h: int, w: int, seed: int) -> np.ndarray:
    """A textile scene rendered at the frame's long side, centre-cropped to
    (h, w), BGR."""
    from torch_scenes import textile_scene

    rgb = textile_scene(max(h, w), np.random.default_rng(seed))[0]
    y0, x0 = (rgb.shape[0] - h) // 2, (rgb.shape[1] - w) // 2
    return np.ascontiguousarray(rgb[y0:y0 + h, x0:x0 + w, ::-1])


def card_line(device: str) -> str:
    """The card's name and power limit (nvidia-smi), or the host's device."""
    if not device.startswith("cuda"):
        return f"device {device}"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def compare(predictor, tmodel, make_frame, frame_hw, n_frames: int, imgsz: int,
            max_det: int) -> dict:
    """Oracle against the port on ``n_frames`` frames: greedy box matching
    (order may swap between near-equal scores), then box, score and mask IoU
    of each matched pair."""
    from torch_ref import ultralytics_predict

    stats = dict(frames=0, ref_dets=0, got_dets=0, matched=0, box_err=[], score_err=[],
                 ious=[], count_mismatch=0)
    for k in range(n_frames):
        frame = make_frame(*frame_hw, seed=1000 + k)
        ref = ultralytics_predict(tmodel, frame, imgsz=imgsz, conf_thresh=0.20,
                                  iou_thresh=0.25, max_det=max_det)
        got = predictor(frame[None])
        n_ref, n_got = len(ref["scores"]), int(got.valid[0].sum())
        stats["frames"] += 1
        stats["ref_dets"] += n_ref
        stats["got_dets"] += n_got
        stats["count_mismatch"] += int(n_ref != n_got)
        used: set[int] = set()
        masks_frame = predictor.masks_to_frame(got.masks_input[0])
        for i in range(min(n_got, masks_frame.shape[0])):
            best_j, best_d = None, 1e9
            for j in range(n_ref):
                if j not in used:
                    d = float(np.abs(got.boxes[0, i] - ref["boxes"][j]).max())
                    if d < best_d:
                        best_d, best_j = d, j
            if best_j is None or best_d >= 5.0:
                continue
            used.add(best_j)
            stats["matched"] += 1
            stats["box_err"].append(best_d)
            stats["score_err"].append(abs(float(got.scores[0, i]) - float(ref["scores"][best_j])))
            stats["ious"].append(mask_iou(masks_frame[i], ref["masks_frame"][best_j]))
    return stats


def table_row(s: dict) -> str:
    arr = lambda key: np.array(s[key]) if s[key] else np.array([np.nan])
    ious, be, se = arr("ious"), arr("box_err"), arr("score_err")
    return (f"| {s['geo']} | {s['dtype']} | {s['frames']} | {s['ref_dets']} | {s['got_dets']} | "
            f"{s['matched']} | {s['count_mismatch']} | {np.median(ious):.6f} | "
            f"{ious.min():.6f} | {float((ious >= IOU_GOAL).mean()):.3f} | {be.max():.3f} | "
            f"{se.max():.2e} |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--imgsz", type=int, default=960)
    ap.add_argument("--frame-h", type=int, default=960)
    ap.add_argument("--frame-w", type=int, default=1280)
    ap.add_argument("--out", default=None,
                    help="default: build/PARITY_REPORT_torch.md with --weights, "
                         "build/PARITY_DESIGN_torch.md without")
    ap.add_argument("--seed", type=int, default=0)
    # The seeded report network lights up ~900 anchors at 960 px: a candidate
    # budget sized to the scene, so that the comparison measures the chain.
    ap.add_argument("--pre-topk", type=int, default=4096)
    ap.add_argument("--max-det", type=int, default=200)
    ap.add_argument("--weights", default=None,
                    help="a checkpoint (msgpack + sidecar): parity with these weights")
    ap.add_argument("--quant", action="store_true",
                    help="add the TTI_QUANT=int8 row (W8A8, float32 carriers)")
    ap.add_argument("--device", default="cuda", help="torch device (cpu only when asked)")
    args = ap.parse_args(argv)
    if args.out is None:
        name = "PARITY_REPORT_torch.md" if args.weights else "PARITY_DESIGN_torch.md"
        args.out = str(ROOT / "build" / name)

    import torch

    from torch_ref import TorchYOLOv8Seg, make_detecting_model
    from tti_torch.app.predict import Predictor
    from tti_torch.core.config import ModelConfig
    from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
    from tti_torch.model.convert import convert_torch_state_dict, to_torch_state_dict

    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("parity_report_torch: no CUDA device (pass --device cpu for the host)",
                  file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False  # float32 means float32
        torch.backends.cudnn.allow_tf32 = False
    card = card_line(args.device)

    if args.weights:
        meta = checkpoint_metadata(args.weights)
        variant, nc = meta.get("variant", "n"), meta.get("num_classes", 2)
        variables = load_flax_msgpack(args.weights)
        tmodel = TorchYOLOv8Seg(variant, nc=nc)
        tmodel.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                                for k, v in to_torch_state_dict(variables).items()}, strict=True)
        tmodel.eval()
        make_frame = scene_frame
    else:
        variant, nc = "n", 2
        tmodel = make_detecting_model(variant, nc=nc, seed=args.seed)
        variables = convert_torch_state_dict(tmodel.state_dict())
        make_frame = textured_frame

    ident_h = (args.imgsz * 3 // 4 + 31) // 32 * 32
    geometries = [("resample-0.75", (args.frame_h, args.frame_w)),
                  ("identity-scale", (ident_h, args.imgsz))]
    dtypes = ["float32", "bfloat16"] + (["int8-w8a8"] if args.quant else [])
    rows = []
    for geo, frame_hw in geometries:
        for dtype in dtypes:
            cfg = ModelConfig(variant=variant, num_classes=nc, image_size=args.imgsz,
                              letterbox="rect",
                              dtype="float32" if dtype == "int8-w8a8" else dtype,
                              conf_thresh=0.20, iou_thresh=0.25, max_detections=args.max_det,
                              nms_pre_topk=args.pre_topk)
            predictor = Predictor(cfg, variables, frame_hw, mask_topk=args.max_det,
                                  device=args.device,
                                  quant="int8" if dtype == "int8-w8a8" else "")
            print(f"[{geo}/{dtype}] input geometry: {predictor.spec}", file=sys.stderr)
            t0 = time.time()
            stats = compare(predictor, tmodel, make_frame, frame_hw, args.frames, args.imgsz,
                            args.max_det)
            rows.append(dict(stats, geo=geo, dtype=dtype, wall_s=time.time() - t0))

    lines = [
        "# PARITY REPORT (tti_torch): full predict chain vs Ultralytics semantics",
        "",
        f"- Geometry: {args.frame_w}x{args.frame_h} frames, predict imgsz={args.imgsz} with the "
        "auto minimal-rect letterbox (reference measurement.py:208-210), and an identity-scale "
        f"{args.imgsz}x{ident_h} frame.",
        "- Oracle: the torch + cv2 reproduction of Ultralytics predict "
        "(`tests/torch_ref.ultralytics_predict`).",
        (f"- Weights: `{args.weights}`, put into the oracle through "
         "`tti_torch.model.convert.to_torch_state_dict` (strict load); frames are seeded "
         "textile scenes (`tests/torch_scenes.textile_scene`)." if args.weights else
         "- Weights: the seeded detecting YOLOv8n-seg (`tests/torch_ref.make_detecting_model`) "
         "converted by `tti_torch.model.convert.convert_torch_state_dict`; frames are "
         "textured test frames."),
        "- Chain: letterbox -> forward -> DFL decode -> conf filter (strict >) -> class-aware "
        "NMS -> process_mask(upsample=True) -> scale_boxes -> cv2 INTER_NEAREST mask resize to "
        "the frame; mask IoU at frame resolution.",
        f"- Port device: {card}.",
        "",
        "| geometry | port dtype | frames | oracle dets | port dets | matched | frames w/ count "
        "mismatch | median mask IoU | min mask IoU | frac IoU>=0.999 | max box err (px) | "
        "max score err |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
        *[table_row(s) for s in rows],
        "",
        f"North star: mask IoU >= {IOU_GOAL}. identity-scale/float32 is bit-comparable stage "
        "by stage; resample-0.75 adds the one documented difference (the oracle resizes with "
        "cv2 on uint8, the port in float on the device); bfloat16 is the production dtype.",
        "",
        f"Generated by tools/parity_report_torch.py, {time.strftime('%Y-%m-%d %H:%M:%S')}.",
    ]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("\n".join(lines) + "\n", encoding="utf-8")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
