"""One run of one cell: set-up, the measured window, the traced segment,
the check against the plain reference, and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json`` at the
root of the checkout: the cell's entry names its configuration
(``benchmark/configs/<config>.json``) and its traffic mix
(``benchmark/traffic/<traffic>.json``); its correctness limits are in
``benchmark/limits/<cell>.json``; each per-layer metric the file lists is
read by ``benchmark/metrics/<metric>.py``. A later cell or metric adds
files and entries and edits none of these.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from benchmark import compare
from benchmark.flops import config_flops
from benchmark.loop import Feed, run_loop
from benchmark.reference.chain import Geometry, ReferenceStep, readouts, roi_box
from benchmark.scenes import render_pool

FORBIDDEN = ("jax", "jaxlib", "flax", "tti")  # top-level module names
HERE = os.path.dirname(os.path.abspath(__file__))


class NoCard(RuntimeError):
    """The card the cell asks for is not there."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @staticmethod
    def load(name: str, root: str) -> "Cell":
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        pick = lambda ms: [m for m in ms if name in m.get("workloads", [name])]
        return Cell(name, entry,
                    load_json(os.path.join(HERE, "configs", entry["config"] + ".json")),
                    load_json(os.path.join(HERE, "traffic", entry["traffic"] + ".json")),
                    load_json(os.path.join(HERE, "limits", name + ".json")),
                    pick(bench["end_to_end"]), pick(bench["per_layer"]))


@dataclass
class Context:
    """What a per-layer metric's reader reads (``benchmark/metrics``)."""

    config: dict
    batch: int
    geometry: Geometry
    proto_hw: tuple[int, int]
    roi: tuple[float, float, float, float]
    readout_soft: bool
    flops_per_frame: float
    window: dict
    trace: dict | None = None
    step_outputs: list[dict] = field(default_factory=list)


def card(chips: int):
    """The card's name, count and power limit; raises :class:`NoCard`."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} CUDA card(s); "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present")
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=20).stdout.split("\n")[0].strip()
    except (OSError, subprocess.SubprocessError):
        limit = "not read"
    return torch.cuda.get_device_name(0), limit


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def frame_order(pool_size: int, batch: int, seed: int) -> np.ndarray:
    """(2, batch) pool indices of the two buffers: every scene of the pool
    in turn, in an order drawn from the seed."""
    n = 2 * batch
    ids = np.tile(np.arange(pool_size), -(-n // pool_size))[:n]
    return np.random.default_rng([seed, 1]).permutation(ids).reshape(2, batch)


def window_metrics(records, batch: int, seconds: float) -> dict:
    """The window's rate and tail: every frame read back by the window's end
    over the window's seconds, and the 95th percentile of every batch's time
    from its hand-over to its results on the host."""
    lat = [1e3 * (r.read - r.handed) for r in records]
    return {"seconds": seconds, "batches": len(records), "frames": batch * len(records),
            "frames_per_s": batch * len(records) / seconds,
            "reading_p95_ms": float(np.percentile(lat, 95)),
            "dispatch_s": [r.dispatched - r.handed for r in records], "latency_ms": lat}


def telemetry_line(outs_list) -> str:
    tele = {k: np.concatenate([o.telemetry[k] for o in outs_list]) for k in outs_list[0].telemetry}
    stitches = np.concatenate([o.stitches.valid.sum(-1) for o in outs_list])
    parts = [f"{k} mean {v.mean():.2f} min {v.min()} max {v.max()}" for k, v in tele.items()]
    parts.append(f"stitch set mean {stitches.mean():.2f}")
    mm = np.concatenate([o.measurements.edge_distance_mm for o in outs_list])
    parts.append(f"frames with a seam reading {np.isfinite(mm).mean():.3f}")
    return "traffic per frame: " + ", ".join(parts)


def run(name: str, seed: int, seconds: float, trace: bool, root: str, t_start: float,
        device: str = "cuda", shrink=None) -> dict:
    """One run of cell ``name``. ``shrink(cell)`` may change the loaded cell
    (tests run it on the CPU at a small size); ``device="cpu"`` skips the
    look for a card."""
    import torch

    cell = Cell.load(name, root)
    if shrink is not None:
        shrink(cell)
    cfg, traffic = cell.config, cell.traffic
    if device == "cuda":
        kind, power = card(cell.entry["chips"])
        log(f"card: {kind}, power limit {power}, torch {torch.__version__}")
    else:
        kind, power = "cpu", "n/a"
    batch = traffic["batch"]
    frame_hw = tuple(cfg["run"]["frame_hw"])

    t = time.perf_counter()
    pool = render_pool(cfg["run"]["scenes"], traffic["pool"], frame_hw, seed)
    order = frame_order(traffic["pool"], batch, seed)
    log(f"rendered {traffic['pool']} scenes in {time.perf_counter() - t:.1f} s")

    from benchmark.system import build_pipeline

    pipeline = build_pipeline(cfg, root, device)
    feed = Feed(pipeline, [pool[order[0]], pool[order[1]]], traffic["feed"])
    warm = run_loop(feed, batches=traffic["warmup_batches"],
                    keep=lambda rec, host: [(rec.index % 2, -1, host)] if rec.index < 2 else [])
    step_outputs = [host for _, _, host in warm.kept]
    if device == "cuda":
        torch.cuda.synchronize()
    log(telemetry_line(step_outputs))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s:.3f} s")

    # The measured window: every batch read back by its end counts.
    rng = np.random.default_rng([seed, 2])
    keep = lambda rec, host: [(rec.index % 2, int(j), compare.frame_outputs(host, int(j)))
                              for j in rng.choice(batch, traffic["kept_per_batch"], replace=False)]
    first = warm.records[-1].index + 2
    window = run_loop(feed, seconds=seconds, keep=keep, first=first)
    recs = window.records
    if not recs:
        raise RuntimeError("no batch was read back inside the window")
    win = window_metrics(recs, batch, seconds)
    lat = win["latency_ms"]
    t0 = recs[0].handed
    thirds = [sum(1 for r in recs if k * seconds / 3 <= r.read - t0 < (k + 1) * seconds / 3)
              for k in range(3)]
    log(f"window thirds: {[round(3 * batch * n / seconds, 1) for n in thirds]} frames/s")
    log(f"window: {len(recs)} batches in {seconds} s, reading latency median "
        f"{statistics.median(lat):.3f} ms, p95 {win['reading_p95_ms']:.3f} ms over "
        f"{len(lat)} batches")

    spec = Geometry.rect(*frame_hw, cfg["model"]["imgsz"])
    ms = cfg["model"]["mask_stride"]
    meta = load_json(os.path.join(root, cfg["run"]["checkpoint"] + ".json"))
    ctx = Context(cfg, batch, spec, (spec.dst_h // ms, spec.dst_w // ms),
                  roi_box(cfg["run"]["roi"], frame_hw),
                  any(readouts(meta)),
                  config_flops(cfg), win, step_outputs=[
                      {"boxes_frame": o.boxes_frame, "valid": o.valid} for o in step_outputs])
    if trace:
        ctx.trace = traced_segment(feed, traffic["trace_batches"], first + len(recs) + 1,
                                   device)
    if device == "cuda":
        torch.cuda.synchronize()
        memory_peak = int(torch.cuda.max_memory_allocated())
    else:
        memory_peak = 0
    metrics = {}
    if trace:
        for m in cell.per_layer:
            reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s, "frames_per_s": win["frames_per_s"],
               "reading_p95_ms": win["reading_p95_ms"]}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    # The program's state goes before the reference runs on the card.
    del feed, pipeline, warm
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    correct, lines, numbers = check(cell, root, pool, order, window.kept, seed, device)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or of the JAX package are loaded: {found}")

    result = {"correct": correct, "attempted": win["frames"], "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
                         "count": cell.entry["chips"], "memory_peak_bytes": memory_peak}}
    if ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace["busy_us"] / 1e6
        result["device"]["window_s"] = ctx.trace["window_s"]
        result["breakdown"] = ctx.trace["breakdown"]
    result["checked"] = {k: {"value": numbers[k], "limit": v} for k, v in cell.limits["limits"].items()}
    for line in lines:
        log(line)
    return result


def check(cell: Cell, root: str, pool, order, kept, seed: int, device: str):
    """Compare a sample of the kept frames, drawn from the seed, with the
    reference run on their scenes."""
    traffic = cell.traffic
    rng = np.random.default_rng([seed, 3])
    take = rng.choice(len(kept), min(traffic["sample_frames"], len(kept)), replace=False)
    sample = [kept[i] for i in sorted(take)]
    scenes = sorted({int(order[buf, j]) for buf, j, _ in sample})
    t = time.perf_counter()
    ref_step = ReferenceStep(cell.config, root, device)
    refs = dict(zip(scenes, ref_step(pool[scenes])))
    gaps = compare.Gaps(cell.config["run"]["nms"]["conf_thresh"] + 0.1)
    for buf, j, prog in sample:
        gaps.add(prog, refs[int(order[buf, j])])
    numbers = gaps.numbers()
    log(f"reference: {len(scenes)} scenes for {len(sample)} frames in "
        f"{time.perf_counter() - t:.1f} s; compared {gaps.counts()}")
    log("gaps: " + ", ".join(f"{k} {v!r}" for k, v in numbers.items()))
    correct, lines = compare.judge(numbers, cell.limits["limits"])
    return correct, lines, numbers


def traced_segment(feed, batches: int, first: int, device: str) -> dict:
    """``batches`` more batches of the same loop under ``torch.profiler``:
    the device's operations, its busy time (the union of their intervals),
    the segment's wall time, the top operations and the longest idle gaps.
    On the card the profiler records CUDA activity alone (the kernels,
    copies and the runtime's calls), not every host operator, so that it
    slows the loop it measures as little as it can; the idle gaps are named
    by the loop's own host-clock spans and the runtime call open then."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace as tr

    cuda = device == "cuda"
    spans: list = []
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        clock_ns = time.time_ns() - time.perf_counter_ns()  # the profiler's clock is time_ns's
        t0 = time.perf_counter()
        seg = run_loop(feed, batches=batches, first=first, spans=spans)
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    steps = len(seg.records) + 1  # the drained batch ran inside the trace too
    ops, busy_us = tr.device_ops(prof, cuda)
    with contextlib.redirect_stdout(io.StringIO()) as text:
        if ops:
            tr.report(ops, busy_us, window_s, steps, 10, "traced segment")
    log(text.getvalue())
    per_op: dict[str, float] = {}
    for name, _, _, dur in ops:
        per_op[name] = per_op.get(name, 0.0) + dur
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    if cuda:
        origin_ns = prof.profiler.kineto_results.trace_start_ns()
        us = lambda s: (s * 1e9 + clock_ns - origin_ns) / 1e3
        bench = [(n, us(a), us(b)) for n, a, b in spans]
        gaps = tr.idle_gaps(tr.union((s, e) for _, s, e, _ in ops), bench + tr.host_spans(prof),
                            us(t0), us(t0 + window_s))
    return {"ops": ops, "busy_us": busy_us, "window_s": window_s, "steps": steps,
            "breakdown": {"device_ops": [[n, d / 1e6] for n, d in top],
                          "idle_gaps": [[n, s] for n, s in gaps]}}
