"""Train-step device time beside its floors, through the port
(``tti_torch``): the counterpart of ``tools/profile_train.py``.

It traces production training iterations, each the device augment
(``tti_torch.train.augment``: mosaic, affine, HSV, flip) and then the
``TrainStep`` (YOLOv8-seg forward, the assigner, the box, DFL, class and
mask losses, backward, AdamW and the EMA), with ``torch.profiler``, and
prints the device time per program (augment, step) and per op beside the
floors of :func:`flop_floors`: the forward's FLOPs counted from the model's
own convolution shapes at ``--imgsz`` (forward hooks, 2 per multiply-add),
the backward at twice the forward, over the H100's peaks.

The configuration is the production recipe's shape: imgsz 640, batch 64,
variant n, a synthetic dataset of ``--dataset-size`` images.

Usage (the card by default):
  python tools/profile_train_torch.py [--batch 64] [--imgsz 640] [--iters 3]
      [--mask-stride 4] [--dataset-size 320] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tools.profile_forward_torch import device_ops, report  # noqa: E402

# The H100 SXM's peaks (as chip_smoke.py states them): dense bf16 tensor
# core operations per second, and its memory's bytes per second.
PEAK_BF16_OPS = 989e12
HBM_BYTES_PER_S = 3.35e12
PROGRAMS = ("augment", "step")


def conv_flops(module, inp, out) -> float:
    """FLOPs of one convolution's call (2 per multiply-add): a convolution
    does in_channels / groups * kh * kw multiply-adds per output element, a
    transposed one out_channels / groups * kh * kw per input element."""
    import torch.nn as nn

    kh, kw = module.kernel_size
    if isinstance(module, nn.ConvTranspose2d):
        return 2.0 * inp[0].numel() * (module.out_channels // module.groups) * kh * kw
    return 2.0 * out.numel() * (module.in_channels // module.groups) * kh * kw


def forward_flops(model, imgsz: int, batch: int = 1) -> tuple[float, float]:
    """(FLOPs, activation bytes) of ``model``'s forward at batch ``batch``
    and ``imgsz``, from forward hooks on its convolutions: each call's FLOPs
    and the bytes of its input and output (read once, written once) in the
    model's dtype. Runs on the meta device: shapes only, no arithmetic."""
    import copy

    import torch
    import torch.nn as nn

    model = copy.deepcopy(model).to("meta").eval()
    totals = [0.0, 0.0]

    def hook(module, inp, out):
        totals[0] += conv_flops(module, inp, out)
        totals[1] += (inp[0].numel() + out.numel()) * out.element_size()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        with torch.no_grad():
            model(torch.zeros((batch, imgsz, imgsz, 3), device="meta"))
    finally:
        for h in handles:
            h.remove()
    return totals[0], totals[1]


def flop_floors(batch: int, imgsz: int, variant: str = "n", mask_stride: int = 4,
                proto_head: str = "deconv", dtype: str = "bf16") -> dict:
    """The floors of one training iteration on the H100, in ms: forward
    FLOPs from the model's shapes over the bf16 peak, backward twice that;
    the augment's bytes (each source image read once as u8, each output
    written once) over the memory's rate; the forward's activation bytes
    over the same."""
    import torch

    from tti_torch.model.yolo import create_model

    model = create_model(variant, 2, 32, mask_stride, proto_head, s2d_stem=False,
                         folded_bn=False,
                         dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)
    flops, act_bytes = forward_flops(model, imgsz, batch)
    out_bytes = 2 if dtype == "bf16" else 4
    aug_bytes = batch * imgsz * imgsz * 3 * (1 + out_bytes)
    return {"forward_gflop_per_image": flops / batch / 1e9,
            "forward_ms": flops / PEAK_BF16_OPS * 1e3,
            "backward_ms": 2.0 * flops / PEAK_BF16_OPS * 1e3,
            "augment_ms": aug_bytes / HBM_BYTES_PER_S * 1e3,
            "hbm_activations_ms": act_bytes / HBM_BYTES_PER_S * 1e3}


def program_ms(prof, ops, cuda: bool, iters: int, wall_ms: dict) -> dict:
    """Device ms per iteration of each program: on the card, the kernels
    that start inside the program's annotation on the device's timeline;
    on the CPU, the program's wall time (its ops run synchronously)."""
    from torch.autograd import DeviceType

    if not cuda:
        return {p: wall_ms[p] / iters for p in PROGRAMS}
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA and getattr(e, "is_user_annotation", False)
             and e.name in PROGRAMS]
    if not spans:
        return {p: None for p in PROGRAMS}
    out = dict.fromkeys(PROGRAMS, 0.0)
    for _, start, _, dur in ops:
        for name, s, e in spans:
            if s <= start < e:
                out[name] += dur / iters / 1e3
                break
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--mask-stride", type=int, default=4, choices=[2, 4])
    ap.add_argument("--dataset-size", type=int, default=320)
    ap.add_argument("--max-gt", type=int, default=16)
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                    help="trunk/head compute dtype (as tti_torch.cli train --dtype)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tti_torch.train.augment import DeviceDataset
    from tti_torch.train.loop import build_model, build_trainer

    cuda = torch.device(args.device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    # A synthetic dataset on the device, tti's tool's draws.
    rng = np.random.default_rng(0)
    n, g, sm = args.dataset_size, args.max_gt, args.imgsz // args.mask_stride
    put = lambda a: torch.from_numpy(a).to(args.device)
    data = DeviceDataset(
        images=put(rng.integers(0, 255, (n, args.imgsz, args.imgsz, 3), dtype=np.uint8)),
        boxes=put(rng.uniform(0, args.imgsz, (n, g, 4)).astype(np.float32)),
        classes=put(rng.integers(0, 2, (n, g), dtype=np.int32)),
        masks=put((rng.uniform(size=(n, g, sm, sm)) > 0.7).astype(np.uint8)),
        valid=put(np.ones((n, g), bool)))
    model = build_model("n", 2, args.mask_stride, "deconv", dtype, args.device)
    trainer = build_trainer(data, model, args.batch, args.max_gt, total_steps=1000, lr=1e-3,
                            dtype=dtype)
    wall_ms = dict.fromkeys(PROGRAMS, 0.0)

    def one_iter(i: int):
        t0 = time.perf_counter()
        with record_function("augment"):
            images, targets = trainer.batch(i)
        t1 = time.perf_counter()
        with record_function("step"):
            metrics = trainer.step_fn(trainer.state, images, targets)
        wall_ms["augment"] += (t1 - t0) * 1e3
        wall_ms["step"] += (time.perf_counter() - t1) * 1e3
        return metrics

    total0 = float(one_iter(0)["total"])  # warm-up
    t0 = time.perf_counter()
    float(one_iter(1)["total"])
    wall = time.perf_counter() - t0
    # Sustained: the trainer's loop reads the metrics every few steps, so
    # the dispatches pipeline; one fetch at the end of the block.
    n_sustained = max(args.iters * 3, 10)
    t0 = time.perf_counter()
    for i in range(1000, 1000 + n_sustained):
        metrics = one_iter(i)
    float(metrics["total"])
    sustained = (time.perf_counter() - t0) / n_sustained

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    wall_ms = dict.fromkeys(PROGRAMS, 0.0)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(2, 2 + args.iters):
            metrics = one_iter(i)
        float(metrics["total"])
        sync()
        window = time.perf_counter() - t0
    ops, busy = device_ops(prof, cuda)
    per_program = program_ms(prof, ops, cuda, args.iters, wall_ms)
    floors = flop_floors(args.batch, args.imgsz, mask_stride=args.mask_stride, dtype=args.dtype)

    print(f"\n== train iter (augment + step): batch {args.batch}, imgsz {args.imgsz}, "
          f"mask_stride {args.mask_stride}, {args.dtype}, {args.device} ==")
    print(f"wall {wall * 1e3:.1f} ms/iter -> {args.batch / wall:.1f} images/s; first-iter "
          f"loss {total0:.3f}")
    print(f"sustained ({n_sustained} iters, one fetch): {sustained * 1e3:.1f} ms/iter -> "
          f"{args.batch / sustained:.1f} images/s")
    print(f"\n-- device ms per program, beside its floor (H100: {PEAK_BF16_OPS / 1e12:.0f} "
          f"TFLOP/s bf16 dense, {HBM_BYTES_PER_S / 1e12:.2f} TB/s; forward "
          f"{floors['forward_gflop_per_image']:.3f} GFLOP per image) --")
    step_floor = floors["forward_ms"] + floors["backward_ms"]
    for name, floor in (("augment", floors["augment_ms"]), ("step", step_floor)):
        t = per_program[name]
        print(f"  {name:10s} {'not measured' if t is None else f'{t:8.3f} ms'}   floor "
              f"{floor:8.4f} ms")
    for k, v in floors.items():
        print(f"  floor {k:24s} {v:10.4f}")
    if not ops:
        print("no device events in the trace (device time not measured)")
        return {"per_program_ms": per_program, "floors": floors}
    summary = report(ops, busy, window, args.iters, args.top,
                     f"train iter, batch {args.batch}, imgsz {args.imgsz}", unit="iter")
    return {"per_program_ms": per_program, "floors": floors, "sustained_ms": sustained * 1e3,
            **summary}


if __name__ == "__main__":
    main()
