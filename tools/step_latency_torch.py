#!/usr/bin/env python3
"""Times the default inspection step of ``tti_torch``: frames/s at batch 128
and the batch-1 p50, on device-resident frames.

    python tools/step_latency_torch.py [--root DIR] [--configs deploy headline]
        [--steps 10] [--p50-iters 50] [--quant int8]

Builds the deploy and headline steps as ``tools/step_syncs_torch.py`` does
(``--quant int8``: the W8A8 step, kernels E and F),
from the ``tti_torch`` package under ``--root`` (default: this checkout; an
unpacked ``git archive`` of an earlier commit times that commit's step).
Each step is warmed, then timed as ``chip_smoke.py``'s phases 4-5 time it:
``--steps`` steps at batch 128 between two synchronises (host clock), then
``--p50-iters`` steps of one frame, each followed by a synchronise (also
the p50 of the time until ``step`` returns, before that synchronise: the
host's enqueue, which includes any wait inside the step). Prints
one line per configuration and a JSON line; the card's name and power limit
come first and last. To compare two trees, run parent, change, change,
parent in one session on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TOOLS)

from step_syncs_torch import CONFIGS, HERE, build_step  # noqa: E402


def time_step(torch, pipe, frames, one, steps: int, p50_iters: int) -> dict:
    with torch.inference_mode():
        pipe.step(frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            pipe.step(frames)
        torch.cuda.synchronize()
        fps = frames.shape[0] * steps / (time.perf_counter() - t0)
        pipe.step(one)
        torch.cuda.synchronize()
        lats, enqueue = [], []
        for _ in range(p50_iters):
            t = time.perf_counter()
            pipe.step(one)
            enqueue.append(time.perf_counter() - t)
            torch.cuda.synchronize()
            lats.append(time.perf_counter() - t)
    ms = lambda a, q: 1e3 * float(np.percentile(a, q))
    return {"frames_per_s": fps, "p50_ms": ms(lats, 50), "p10_ms": ms(lats, 10),
            "p90_ms": ms(lats, 90), "enqueue_p50_ms": ms(enqueue, 50)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=HERE, help="the checkout whose tti_torch is timed")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--p50-iters", type=int, default=50)
    parser.add_argument("--configs", nargs="+", default=list(CONFIGS), choices=list(CONFIGS))
    parser.add_argument("--quant", default="", choices=["", "int8"],
                        help="the int8 step (TTI_QUANT=int8) instead of bf16")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "tests")]

    import torch
    from torch_synth import textile_frames

    if not torch.cuda.is_available():
        print("step_latency_torch: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    import tti_torch

    print(f"tti_torch from {os.path.dirname(os.path.dirname(tti_torch.__file__))}", flush=True)
    out = {"root": root, "card": card, "quant": args.quant}
    for name in args.configs:
        hw = CONFIGS[name][0]
        pipe = build_step(name, **({"quant": args.quant} if args.quant else {}))
        base = textile_frames(8, *hw, seed=5)
        frames = torch.from_numpy(np.ascontiguousarray(np.tile(base, (16, 1, 1, 1)))).cuda()
        one = frames[:1].contiguous()
        out[name] = t = time_step(torch, pipe, frames, one, args.steps, args.p50_iters)
        print(f"{name}{' ' + args.quant if args.quant else ''}: {t['frames_per_s']:.1f} frames/s at batch {frames.shape[0]}; batch-1 "
              f"p50 {t['p50_ms']:.3f} ms (p10 {t['p10_ms']:.3f}, p90 {t['p90_ms']:.3f}; "
              f"enqueue p50 {t['enqueue_p50_ms']:.3f}; {args.p50_iters} steps)", flush=True)
        del pipe, frames, one
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
