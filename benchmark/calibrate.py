"""Readings for a cell's correctness limits, on the card: the comparison
numbers of the program on many seeds (the lower readings), of the control
on a few (the upper readings), of the program with half of each batch left
out (the upper readings of the shares of misses) and of the program in
float32 (a witness beside the reference), in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control-seeds 4 \
        [--fault-seeds 3] [--witness-seeds 3] [--first-seed N] [--record] [--out <file>.json]

Each seed renders the cell's scenes, fills the same two batches the
benchmark fills, runs the cell's loop for ``--batches`` batches on them
and compares as many frames as a run does (``sample_frames``) with the
plain reference, exactly as :func:`benchmark.harness.check` does. The
control is the program with its own int8 path on (``quant="int8"``:
W8A8 convolutions, kernels E and F), the next precision below the
configuration's bfloat16. The fault and the witness run on the program's
first seeds. The benchmark's own runs never run any of them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def left_out(tree, half: int):
    """Every tensor of a step's outputs with ``half`` more rows that hold
    nothing (zeros, False): the outputs of a step that ran on the first
    part of the batch only."""
    import dataclasses

    import torch

    if isinstance(tree, torch.Tensor):
        if not tree.dim():
            return tree
        return torch.cat([tree, tree.new_zeros((half, *tree.shape[1:]))])
    if isinstance(tree, dict):
        return {k: left_out(v, half) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: left_out(getattr(tree, f.name), half)
                                            for f in dataclasses.fields(tree)})
    return tree


def break_half_batch(pipeline):
    """The timed path broken underneath: each step runs on the first half
    of its batch and leaves the rest out."""
    step = pipeline._local_step

    def half_step(frames):
        half = len(frames) // 2
        return left_out(step(frames[:len(frames) - half]), half)

    pipeline._local_step = half_step
    return pipeline


def readings(cell, pipeline, ref_step, seeds, batches: int, record: bool = False) -> list[dict]:
    import numpy as np

    from benchmark import compare
    from benchmark.harness import frame_order, log
    from benchmark.loop import Feed, run_loop
    from benchmark.scenes import render_pool

    traffic, cfg = cell.traffic, cell.config
    batch, n = traffic["batch"], traffic["sample_frames"]
    per_batch = -(-n // batches)
    out = []
    feed = None
    for seed in seeds:
        t = time.perf_counter()
        pool = render_pool(cfg["run"]["scenes"], traffic["pool"], tuple(cfg["run"]["frame_hw"]),
                           seed)
        order = frame_order(traffic["pool"], batch, seed)
        frames = [pool[order[0]], pool[order[1]]]
        if feed is None:
            feed = Feed(pipeline, frames, traffic["feed"])
        else:
            feed.refill(frames)
        rng = np.random.default_rng([seed, 2])
        keep = lambda rec, host: [(rec.index % 2, int(j), compare.frame_outputs(host, int(j)))
                                  for j in rng.choice(batch, per_batch, replace=False)]
        kept = run_loop(feed, batches=batches, keep=keep).kept[:n]
        scenes = sorted({int(order[b, j]) for b, j, _ in kept})
        refs = dict(zip(scenes, ref_step(pool[scenes])))
        gaps = compare.Gaps(cfg["run"]["nms"]["conf_thresh"] + 0.1, record)
        for b, j, prog in kept:
            gaps.add(prog, refs[int(order[b, j])])
        row = {"seed": seed, **gaps.numbers(), **gaps.counts()}
        log(json.dumps(row) + f"  ({time.perf_counter() - t:.1f} s)")
        if record:
            row["pairs"] = gaps.record
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=4)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--witness-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=7_000_000_001)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--record", action="store_true",
                    help="also write every matched pair's values to --out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import Cell, card, log
    from benchmark.reference.chain import ReferenceStep
    from benchmark.system import build_pipeline

    cell = Cell.load(args.workload, ROOT)
    kind, power = card(cell.entry["chips"])
    log(f"card: {kind}, power limit {power}")
    ref_step = ReferenceStep(cell.config, ROOT, "cuda")
    result = {"cell": cell.name, "card": kind, "power_limit": power}
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds + args.control_seeds)]
    runs = (("program", lambda: build_pipeline(cell.config, ROOT, "cuda"), seeds[:args.seeds]),
            ("control", lambda: build_pipeline(cell.config, ROOT, "cuda", quant="int8"),
             seeds[args.seeds:]),
            ("fault_half_batch",
             lambda: break_half_batch(build_pipeline(cell.config, ROOT, "cuda")),
             seeds[:args.fault_seeds]),
            ("witness_float32", lambda: build_pipeline(cell.config, ROOT, "cuda", dtype="float32"),
             seeds[:args.witness_seeds]))
    for label, build, group in runs:
        if group:
            log(f"== {label}")
            result[label] = readings(cell, build(), ref_step, group, args.batches, args.record)
    names = [k for k in result["program"][0] if k not in ("seed", "frames", "detection_pairs",
                                                           "stitch_pairs", "mm_pairs", "pairs")]
    result["lower"] = {k: max(r[k] for r in result["program"]) for k in names}
    for label in ("control", "fault_half_batch", "witness_float32"):
        if label not in result:
            continue
        result[label + "_least"] = {k: min(r[k] for r in result[label]) for k in names}
        result[label + "_most"] = {k: max(r[k] for r in result[label]) for k in names}
        for k in names:
            lo, up = result["lower"][k], result[label + "_least"][k]
            log(f"{label} {k}: program at most {lo!r}, {label} at least {up!r}, at most "
                f"{result[label + '_most'][k]!r}, ratio {up / lo if lo else float('inf'):.2f}")
    if args.out:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
