"""Device-trace reduction: categories of device operations and the
device's busy time, from a ``torch.profiler`` trace of the card.

``CATEGORY_PATTERNS``, :func:`categorize`, :func:`device_ops` and
:func:`report` are a frozen copy of ``tools/profile_forward_torch.py`` at commit bb8100e. The
rest (:func:`union`, :func:`idle_gaps`, :func:`host_spans`) is the
benchmark's own reading of the same events.
"""

from __future__ import annotations

import collections
import re

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


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, sorted and merged."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def host_spans(prof) -> list[tuple[str, float, float]]:
    """The trace's host events, (name, start us, end us): the CUDA
    runtime's calls in a trace of CUDA activity, the operators in one of
    the CPU's."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CPU]


def idle_gaps(busy: list[tuple[float, float]], spans, t0: float, t1: float,
              top: int = 10) -> list[tuple[str, float]]:
    """The ``top`` longest stretches of [t0, t1] (us) in which no device
    operation ran, each named by what the host was doing when it began: the
    benchmark's span (``bench.*``) around that moment and the innermost
    host event open then. Returns (name, seconds), longest first."""
    gaps, cur = [], t0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for g0, g1 in gaps[:top]:
        open_ = [(s, n) for n, s, e in spans if s <= g0 < e]
        bench = [n for s, n in sorted(open_) if n.startswith("bench.")]
        ops = [n for s, n in sorted(open_) if not n.startswith("bench.")]
        name = " / ".join(([bench[-1]] if bench else []) + ([ops[-1]] if ops else []))
        out.append((name or "host: no operator open", (g1 - g0) / 1e6))
    return out
