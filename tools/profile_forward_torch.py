"""Per-op profile of the production forward, through the port
(``tti_torch``): the counterpart of ``tools/profile_forward.py``.

It traces the inference-time model (s2d stem, folded BatchNorm, bf16,
channels_last: ``InspectionPipeline``'s own) on the preprocessed batch, or
with ``--full`` the whole ``InspectionPipeline.step`` (preprocess, forward,
detect, measure), with ``torch.profiler``: the CUDA activity on the card,
the operators on the CPU with ``--device cpu``. It prints the top ``--top``
device ops by time per step, the total per category (:func:`categorize`),
then the device's busy time and its idle share of the traced window (the
wall time of the traced steps, one synchronisation at their end).

Usage (the card by default):
  python tools/profile_forward_torch.py [--batch 128] [--imgsz 640] [--full] [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# (category, pattern over the lower-cased op name), first match wins: the
# hand-written kernels by their CUDA symbols and their operators' names
# (the CPU trace's), then NCCL, cuDNN, cuBLAS, copies, reductions and
# elementwise kernels.
CATEGORY_PATTERNS = [
    ("A mask stats soft", re.compile(r"stats_strips<[^,>]*, ?true|stats_moments<true"
                                     r"|mask_stats_soft")),
    ("B mask stats binary", re.compile(r"stats_strips|stats_moments|mask_stats_binary")),
    ("C warp pass 1", re.compile(r"warp_p1_kernel|warp_pass1_decimated")),
    ("D greedy NMS", re.compile(r"greedy_keep")),
    ("E int8 conv", re.compile(r"int8_conv")),
    ("F act scale", re.compile(r"act_absmax|act_scale_per_sample")),
    ("NCCL", re.compile(r"nccl")),
    ("cuDNN convolution", re.compile(r"conv|fprop|dgrad|wgrad|cudnn")),
    ("cuBLAS GEMM", re.compile(r"gemm|cublas|cutlass|nvjet|matmul|einsum|aten::bmm|aten::mm"
                               r"|aten::addmm")),
    ("copy", re.compile(r"direct_copy|memcpy|memset|copy_|nchwtonhwc|nhwctonchw|transpose"
                        r"|permute|contiguous|layout|aten::to\b|aten::cat|catarraybatched")),
    ("reduction", re.compile(r"reduce|sum|mean|amax|amin|max|min|norm|argmax|argmin|cumsum"
                             r"|softmax")),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled|pointwise|silu|sigmoid|add"
                               r"|mul|div|sub|where|clamp|exp")),
]


def categorize(name: str) -> str:
    low = name.lower()
    for cat, pat in CATEGORY_PATTERNS:
        if pat.search(low):
            return cat
    return "other"


def device_ops(prof, cuda: bool) -> tuple[list[tuple[str, float, float, float]], float]:
    """The trace's device ops as (name, start us, end us, duration us) and
    the device's busy us (the union of their intervals). On the card: the
    CUDA kernels, copies and memsets (user annotations left out); on the
    CPU: each operator's self time (nested operators are not counted twice),
    laid end to end."""
    from torch.autograd import DeviceType

    ops = []
    if cuda:
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
                ops.append((e.name, e.time_range.start, e.time_range.end,
                            e.time_range.elapsed_us()))
    else:
        for e in prof.events():
            if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0:
                ops.append((e.name, e.time_range.start, e.time_range.end,
                            e.self_cpu_time_total))
        return ops, sum(d for *_, d in ops)
    busy, spans = 0.0, sorted((s, e) for _, s, e, _ in ops)
    if spans:
        cur_s, cur_e = spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
    return ops, busy


def report(ops, busy_us: float, window_s: float, iters: int, top: int, label: str,
           unit: str = "step") -> dict:
    """Print busy / idle, the top ops and the category totals per ``unit``
    (a step, or a training iteration); the same numbers as a dict (ms per
    ``unit``)."""
    per_op = collections.Counter()
    for name, _, _, dur in ops:
        per_op[name] += dur
    per_cat, calls = collections.Counter(), collections.Counter()
    for name, dur in per_op.items():
        per_cat[categorize(name)] += dur
    for name, *_ in ops:
        calls[categorize(name)] += 1
    total = sum(per_op.values())
    ms = lambda us: us / iters / 1e3
    busy = ms(busy_us)
    window = window_s / iters * 1e3
    print(f"\n== {label}: wall {window:.3f} ms/{unit} in the trace, device busy {busy:.3f} "
          f"ms/{unit}, idle share {1.0 - busy / window:.1%}, ops {ms(total):.3f} ms/{unit} "
          f"({len(ops) // max(iters, 1)} per {unit}) ==")
    print(f"\n-- top {top} ops (ms/{unit}) --")
    for name, dur in per_op.most_common(top):
        print(f"  {ms(dur):8.3f}  {dur / total:6.1%}  {name[:110]}")
    print(f"\n-- by category (ms/{unit}, device ops per {unit}) --")
    for cat, dur in per_cat.most_common():
        print(f"  {cat:20s} {ms(dur):8.3f}  ({dur / total:5.1%})  {calls[cat] / iters:g}")
    print(f"  {'total':20s} {ms(total):8.3f}")
    return {"top": [(n, ms(d)) for n, d in per_op.most_common(top)],
            "categories": {c: ms(d) for c, d in per_cat.items()},
            "ops_per_step": {c: n / iters for c, n in calls.items()}, "total_ms": ms(total),
            "busy_ms": busy, "window_ms": window, "idle_share": 1.0 - busy / window}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--frame-h", type=int, default=1080)
    ap.add_argument("--frame-w", type=int, default=1920)
    ap.add_argument("--full", action="store_true",
                    help="profile the whole pipeline step (preprocess + forward + NMS + "
                         "measure) instead of the bare forward")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--mask-stride", type=int, default=4, choices=[2, 4],
                    help="proto grid stride (2 = hi-res deploy arch)")
    ap.add_argument("--proto-head", default="deconv", choices=["deconv", "subpixel"],
                    help="mask_stride=2 second stage architecture")
    ap.add_argument("--subcell", action="store_true",
                    help="profile the sub-cell (soft-checkpoint) boundary readout, the "
                         "as-deployed measure path for soft-mask-trained sidecars")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tools.tune_device_torch import build_pipeline

    cuda = torch.device(args.device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    pipeline = build_pipeline(args.batch, args.imgsz, (args.frame_h, args.frame_w), "n",
                              "bfloat16", mask_stride=args.mask_stride,
                              proto_head=args.proto_head, subcell=args.subcell,
                              device=args.device)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 255, size=(args.batch, args.frame_h,
                                                         args.frame_w, 3),
                                           dtype=np.uint8)).to(args.device)
    if args.full:
        def step():
            pipeline.step(frames)
    else:
        with torch.inference_mode():
            x = pipeline.preprocess(frames)

        @torch.inference_mode()
        def step():
            pipeline.model(x)

    step()  # warm-up
    sync()
    t0 = time.perf_counter()
    step()
    sync()
    base = time.perf_counter() - t0

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        sync()
        window = time.perf_counter() - t0
    ops, busy = device_ops(prof, cuda)
    label = "full pipeline step" if args.full else "bare forward"
    print(f"{label}: batch {args.batch}, imgsz {args.imgsz}, {args.device}, untraced wall "
          f"{base * 1e3:.2f} ms/step")
    if not ops:
        print("no device events in the trace (device time not measured)")
        return {"ops": 0}
    return report(ops, busy, window, args.iters, args.top,
                  f"{label}, batch {args.batch}, imgsz {args.imgsz}")


if __name__ == "__main__":
    main()
