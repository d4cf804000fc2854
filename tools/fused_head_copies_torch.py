#!/usr/bin/env python3
"""Whether the fused head's channel slices are copied before the convs that
read them, on the card.

    python tools/fused_head_copies_torch.py [--batch 128] [--iters 20]

With ``fused_head=True`` each head level runs one entry conv ``cvh_{level}``
and splits its output along the channels; on a channels_last tensor each
piece is a strided view. For the deploy (a 736x960 model input, the cam
checkpoint) and headline (384x640, the stride-4 checkpoint) models at full
width, bf16, channels_last, on the space-to-depth blocked input the default
step hands them, this runs one forward of the fused and of the unfused
model under ``torch.profiler`` and prints, for every conv that reads a
slice (``cv{2,3,4}_{level}_1``): whether its input was channels_last
contiguous, and the copy kernels (a device kernel whose name says copy)
that one call of that conv alone launches on the very input the forward
handed it, with their ms; the unfused model's readers, whose input is a
conv's own output, are the control. Then, per forward, the copy kernels
and their ms, fused against unfused, and the forward's mean device ms by
CUDA events over ``--iters`` forwards. Needs a CUDA device; prints the card's
name and power limit first and last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CONFIGS = {  # name: (model input height, width, checkpoint)
    "deploy": (736, 960, "yolov8n_textile_cam.msgpack"),
    "headline": (384, 640, "yolov8n_textile.msgpack"),
}


def build_model(torch, ckpt: str, fused: bool):
    from tti_torch.core.config import ModelConfig
    from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
    from tti_torch.parallel.runtime import inference_model

    path = os.path.join(HERE, "checkpoints", ckpt)
    meta = checkpoint_metadata(path)
    cfg = ModelConfig(variant=meta.get("variant", "n"), num_classes=meta.get("num_classes", 2),
                      dtype="bfloat16", mask_stride=meta.get("mask_stride", 4),
                      proto_head=meta.get("proto_head", "deconv"))
    return inference_model(cfg, load_flax_msgpack(path), torch.device("cuda"),
                           fused_head=fused)


def slice_readers(model) -> dict:
    """The convs that read the head-entry outputs: ``cv{2,3,4}_{level}_1``."""
    head = next(m for m in model.modules() if type(m).__name__ == "Segment")
    return {f"{b}_{lvl}_1": getattr(head, f"{b}_{lvl}_1")
            for lvl in range(3) for b in ("cv2", "cv3", "cv4")}


def device_kernels(torch, fn) -> list:
    """The device kernels ``fn`` launches, in order: (name, ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    return [(e.name, e.time_range.elapsed_us() / 1e3)
            for e in sorted(dev, key=lambda e: e.time_range.start)]


def is_copy(name: str) -> bool:
    return "copy" in name.lower()


def traced_forward(torch, model, x) -> dict:
    """Per slice reader: its input's layout, and the copy kernels of one
    call of the reader alone on the very input the forward handed it; per
    forward: the copy kernels and all device kernels."""
    inputs, handles = {}, []
    for name, mod in slice_readers(model).items():
        def keep(_m, args, name=name):
            inputs[name] = args[0]

        handles.append(mod.register_forward_pre_hook(keep))
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in handles:
            h.remove()
    readers = {}
    for name, mod in slice_readers(model).items():
        inp = inputs.pop(name)
        copies = [(n, t) for n, t in device_kernels(torch, lambda: mod(inp)) if is_copy(n)]
        readers[name] = {
            "input_channels_last_contiguous": bool(
                inp.is_contiguous(memory_format=torch.channels_last)),
            "input_copies": len(copies), "input_copy_ms": sum(t for _, t in copies),
            "copy_kernels": sorted({n[:100] for n, _ in copies})}
        del inp
    dev = device_kernels(torch, lambda: model(x))
    copy_dev = [(n, t) for n, t in dev if is_copy(n)]
    return {"readers": readers, "device_kernels": len(dev), "copy_kernels": len(copy_dev),
            "copy_ms": sum(t for _, t in copy_dev),
            "copy_kernel_names": sorted({n[:100] for n, _ in copy_dev})}


def forward_ms(torch, model, x, iters: int) -> float:
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            model(x)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("fused_head_copies_torch: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": card, "batch": args.batch}
    for config, (h, w, ckpt) in CONFIGS.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        # The s2d-blocked model input the default step hands the model.
        x = torch.rand(args.batch, h // 2, w // 2, 12, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
        per = {}
        for fused in (True, False):
            model = build_model(torch, ckpt, fused)
            model(x[:1])  # cuDNN's algorithm choice stays out of the trace
            per["fused" if fused else "unfused"] = {
                **traced_forward(torch, model, x), "forward_ms": forward_ms(torch, model, x,
                                                                            args.iters)}
            del model
            torch.cuda.empty_cache()
        f, u = per["fused"], per["unfused"]
        copies = lambda p: {n: r["input_copies"] for n, r in p["readers"].items()}
        strided = lambda p: sum(not r["input_channels_last_contiguous"]
                                for r in p["readers"].values())
        kernels = sorted({k for r in f["readers"].values() for k in r["copy_kernels"]})
        reader_ms = sum(r["input_copy_ms"] for r in f["readers"].values())
        print(f"{config} batch {args.batch}: copy kernels of each slice reader on its "
              f"input, fused {copies(f)} ({reader_ms:.3f} ms; {kernels or 'none'}; "
              f"{strided(f)} of {len(f['readers'])} inputs strided) against unfused "
              f"{copies(u)} ({strided(u)} strided); copy kernels per forward "
              f"{f['copy_kernels']} ({f['copy_ms']:.3f} ms) against "
              f"{u['copy_kernels']} ({u['copy_ms']:.3f} ms) unfused; device kernels "
              f"{f['device_kernels']} against {u['device_kernels']}; forward {f['forward_ms']:.3f}"
              f" ms against {u['forward_ms']:.3f} ms (CUDA events, {args.iters} forwards)",
              flush=True)
        out[config] = per
    print(json.dumps(out), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
