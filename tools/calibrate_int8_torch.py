"""Offline activation-scale calibration for static W8A8 int8 (``TTI_QUANT=int8s``)
through the port (``tti_torch``).

The counterpart of ``tools/calibrate_int8.py``: the same flags, the same
chain (the checkpoint's plain-stem model with folded BatchNorm, in bf16, on
``letterbox_u8`` square frames, the predict-chain preprocess ``eval`` uses)
and the same JSON (``{"scales": {block path: scale}, "meta": {...}}``), so a
file from either tool serves either package's ``int8s`` step. Each scale is
``max(absmax, 1e-12) / 127`` of the block's input over the frames
(:func:`tti_torch.model.quantize.calibrate_act_scales`).

  python tools/calibrate_int8_torch.py --weights checkpoints/yolov8n_textile.msgpack \\
      --synth 64 --out build/int8_scales.json [--percentile 99.9]
  TTI_QUANT=int8s TTI_QUANT_SCALES=build/int8_scales.json python -m tti_torch.cli run ...

Input modes: ``--images`` <eval-format dataset dir> or ``--synth N`` (N
``tools/synth_textile.make_scene`` scenes, numpy only, from ``--seed``).
``--percentile`` below 100 clips outlier batches. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def calibration_frames(images: str, synth: int, imgsz: int, seed: int) -> np.ndarray:
    """(N, imgsz, imgsz, 3) uint8 BGR frames: ``synth`` seeded scenes, or the
    dataset's images resized as the evaluation loads them."""
    if synth:
        from tools.synth_textile import make_scene

        rng = np.random.default_rng(seed)
        return np.stack([make_scene(imgsz, rng)[0] for _ in range(synth)])
    from tti_torch.train.data import discover_dataset, sample_to_targets

    return np.stack([(sample_to_targets(s, imgsz, max_gt=1)[0][..., ::-1] * 255).astype(np.uint8)
                     for s in discover_dataset(images)])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", required=True)
    ap.add_argument("--images", default="", help="eval-format dataset dir")
    ap.add_argument("--synth", type=int, default=0,
                    help="render N synthetic scenes instead of --images")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--percentile", type=float, default=100.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", help="torch device (cpu only when asked)")
    args = ap.parse_args(argv)
    if bool(args.images) == bool(args.synth):
        ap.error("exactly one of --images / --synth")

    import torch

    from tti_torch.core.config import ModelConfig
    from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
    from tti_torch.model.quantize import calibrate_act_scales
    from tti_torch.parallel.runtime import inference_model
    from tti_torch.preprocess.letterbox import letterbox_u8, make_letterbox_spec

    meta = checkpoint_metadata(args.weights)
    variant = meta.get("variant", "n")
    nc = meta.get("num_classes", 2)
    mask_stride = meta.get("mask_stride", 4)
    proto_head = meta.get("proto_head", "deconv")
    cfg = ModelConfig(variant=variant, num_classes=nc, image_size=args.imgsz, dtype="bfloat16",
                      mask_stride=mask_stride, proto_head=proto_head)
    device = torch.device(args.device)
    # The folded float model with the plain stem, in the production compute
    # dtype: the int8 model quantizes from the tensors this one sees.
    model = inference_model(cfg, load_flax_msgpack(args.weights), device, s2d_input=False,
                            s2d_stem=False)
    frames = calibration_frames(args.images, args.synth, args.imgsz, args.seed)
    spec = make_letterbox_spec(args.imgsz, args.imgsz, args.imgsz, "square")

    def batches():
        for i in range(0, len(frames), args.batch):
            chunk = torch.from_numpy(np.ascontiguousarray(frames[i:i + args.batch])).to(device)
            yield letterbox_u8(chunk, spec, torch.bfloat16)

    scales = calibrate_act_scales(model, batches(), percentile=args.percentile)
    payload = {
        "scales": scales,
        "meta": {
            "weights": os.path.abspath(args.weights),
            "variant": variant, "num_classes": nc,
            "mask_stride": mask_stride, "proto_head": proto_head,
            "imgsz": args.imgsz,
            "frames": int(len(frames)),
            "source": args.images or f"synth:{args.synth}:seed{args.seed}",
            "percentile": args.percentile,
        },
    }
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    top = sorted(scales.items(), key=lambda kv: -kv[1])[:5]
    print(f"wrote {args.out}: {len(scales)} block scales "
          f"(largest: {', '.join(f'{k}={v:.4g}' for k, v in top)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
