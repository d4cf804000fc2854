#!/usr/bin/env python3
"""The spatially partitioned inspection step (a ``("data", "space")`` mesh
of ``(1, N)``: each rank computes a slab of the frame's rows) on N cards
of this host, one process per card over NCCL, against the step without a
mesh on the same card.

    python tools/space_cards_torch.py [--spaces 1,2,4] [--out build/space_cards]

For each space size N of ``--spaces`` that the host's cards allow, N
processes (card r for rank r) run ``chip_smoke.py``'s deploy (960x1280,
imgsz 960) and headline (1080x1920, imgsz 640) steps on the mesh. With
N > 1 each rank holds its outputs to the plain step's on its card: in
float32 (TF32 off) at batch 1 and 2, ``__graft_entry__.py``'s bar (valid
and classes equal, scores 1e-5, frame boxes 1e-3 px, mm 1e-4, NaN where
NaN); the deploy int8 step (float32) at batch 2 and the headline step with
``warp_pass1="kernel"`` (kernel C on each slab's band of source rows,
float32) at batch 1 and 2 at the same bar; in bf16
at batch 128, the bar ``chip_smoke.py``'s modes phase holds a step to
that rounds differently from its reference (detection counts equal on
99% of the frames, mm within 0.25, the median within 0.01): a bf16
convolution over a slab rounds otherwise than over the whole frame, and
one flipped mask cell moves a reading by up to 0.24 mm. The bf16 readings
at batch 1 and 2 are reported beside it. It checks the
kernel launches per rank and step (A or B once, D once; C once on the
kernel route; E and F 66 times under int8), the halo exchanges (44 per step), the MAX all-reduces (66
under int8) and the one gather. Each rank then times the bf16 step at
batch 1 (p50 of 30 steps, host clock to a synchronise; rank 0 also times
the plain step first, while the others wait) with the host ms inside the
halo exchanges per step over those 30, and profiles 3 steps: the device's
busy ms per step without the NCCL kernels (they spin while a peer is
late), the NCCL kernels' and the copies' device ms. Prints the card's name and
power limit and one line per size and configuration, writes every rank's
readings to ``OUT/space_cards.json``, and exits 1 when a rank fails.

``TTI_WARP_BLOCKED`` (read as ``RuntimeSwitches.from_env`` reads it for
``run``) puts the banded two-pass warp of that block under every step but
the kernel route's (kernel C reads the dense weights), both on the mesh and
in the plain step it is held to; each rank prints its pass-2 bands and
their bytes beside the dense slab's.

``chip_smoke.py`` (phase 5f) starts the same ranks as gloo processes that
share one card (``launch(..., backend="gloo")``): gloo's point-to-point ops
take host tensors, so there the halo rows go through the host. The same
ranks then run ``BANDED`` (``launch(..., runs="checked,banded")``): the
deploy and headline steps with ``warp_block=64``, float32 at batch 1 and 2
at the bar above, bf16 at batch 1 timed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HALOS_PER_STEP = 44  # YOLOv8n-seg: backbone and neck 30, head 12, proto head 2
# Kernel launches per rank and step, by the tag's first part.
LAUNCHES = {
    "deploy": {"mask_stats_soft": 1, "greedy_keep": 1},
    "headline": {"mask_stats_binary": 1, "greedy_keep": 1},
    "headline_kernel_route": {"warp_pass1_decimated": 1, "mask_stats_binary": 1,
                              "greedy_keep": 1},
    "deploy_int8": {"int8_conv2d": 66, "act_scale_per_sample": 66, "mask_stats_soft": 1,
                    "greedy_keep": 1},
    "deploy_banded": {"mask_stats_soft": 1, "greedy_keep": 1},
    "headline_banded": {"mask_stats_binary": 1, "greedy_keep": 1},
}
# (tag, configuration, dtype, pipeline arguments, batches, timed)
CHECKED = (
    ("deploy/float32", "deploy", "float32", {}, (1, 2), False),
    ("deploy/bfloat16", "deploy", "bfloat16", {}, (1, 2, 128), True),
    ("headline/float32", "headline", "float32", {}, (1, 2), False),
    ("headline/bfloat16", "headline", "bfloat16", {}, (1, 2, 128), True),
    ("headline_kernel_route/float32", "headline", "float32", {"warp_pass1": "kernel"}, (1, 2),
     False),
    ("deploy_int8/float32", "deploy", "float32", {"quant": "int8"}, (2,), False),
)
TIMED_ONLY = (
    ("deploy/bfloat16", "deploy", "bfloat16", {}, (1,), True),
    ("headline/bfloat16", "headline", "bfloat16", {}, (1,), True),
)
# The banded two-pass warp (warp_block=64, one of tti's tune trials) on the
# mesh, against the banded step without a mesh: float32 at the bar, bf16
# batch 1 read and timed.
BANDED = (
    ("deploy_banded/float32", "deploy", "float32", {"warp_block": 64}, (1, 2), False),
    ("headline_banded/float32", "headline", "float32", {"warp_block": 64}, (1, 2), False),
    ("deploy_banded/bfloat16", "deploy", "bfloat16", {"warp_block": 64}, (1,), True),
    ("headline_banded/bfloat16", "headline", "bfloat16", {"warp_block": 64}, (1,), True),
)
RUNS = {"checked": CHECKED, "timed": TIMED_ONLY, "banded": BANDED}


def runs_of(names: str) -> tuple:
    """The runs of a comma-separated list of ``RUNS``' names, in order."""
    return tuple(run for name in names.split(",") for run in RUNS[name])
MM_FIELDS = ("edge_distance_mm", "stitch_width_mm", "raw_edge_mm", "raw_width_mm")
P50_ITERS = 30
BF16_BATCH = 128  # the bf16 bar's batch: chip_smoke's MODE_* bar holds over many frames


def compare(got, ref, dtype: str) -> dict:
    """The space step's host outputs against the plain step's: the float32
    bar, or at ``BF16_BATCH`` the bf16 bar (the module's docstring); the
    largest differences, whether every output is equal, and what failed
    the bar. bf16 at another batch: the readings only."""
    import chip_smoke as cs

    if dtype != "float32":
        same_n = float((got.valid.sum(1) == ref.valid.sum(1)).mean())
        d = cs.mm_differences(got, ref)
        out = {"same_count_share": same_n, "mm_max": float(d.max(initial=0.0)),
               "mm_median": float(np.median(d)) if d.size else 0.0, "readings": int(d.size),
               "bit_equal": all(np.array_equal(x, y, equal_nan=True) for x, y in (
                   (got.valid, ref.valid), (got.scores, ref.scores),
                   *((getattr(got.measurements, k), getattr(ref.measurements, k))
                     for k in MM_FIELDS))), "failed": []}
        if len(got.valid) == BF16_BATCH and not (
                same_n >= cs.MODE_NVALID_SHARE and out["mm_max"] <= cs.MODE_MM_MAX
                and out["mm_median"] <= cs.MODE_MM_MEDIAN and d.size):
            out["failed"].append(f"bf16 bar: {out}")
        return out
    failed = []
    if not np.array_equal(got.valid, ref.valid):
        failed.append(f"valid differs in {int((got.valid != ref.valid).sum())} rows")
    both = got.valid & ref.valid
    score = float(np.abs(got.scores - ref.scores)[both].max(initial=0.0))
    box = float(np.abs(got.boxes_frame - ref.boxes_frame)[both].max(initial=0.0))
    mm = 0.0
    for key in MM_FIELDS:
        a, b = getattr(got.measurements, key), getattr(ref.measurements, key)
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            failed.append(f"{key}: NaN pattern {np.isnan(a).tolist()} against "
                          f"{np.isnan(b).tolist()}")
        fin = np.isfinite(a) & np.isfinite(b)
        mm = max(mm, float(np.abs(a[fin] - b[fin]).max(initial=0.0)))
    if not np.array_equal(got.classes[both], ref.classes[both]):
        failed.append("classes differ")
    if not (score <= 1e-5 and box <= 1e-3 and mm <= 1e-4):
        failed.append(f"float32 bar: scores {score}, boxes {box} px, mm {mm}")
    for key in ("n_dist", "n_width", "n_stitches", "fabric_detected"):
        if not np.array_equal(getattr(got.measurements, key), getattr(ref.measurements, key)):
            failed.append(f"{key} differs")
    equal = all(np.array_equal(x, y, equal_nan=True) for x, y in (
        (got.valid, ref.valid), (got.scores, ref.scores), (got.boxes_frame, ref.boxes_frame),
        *((getattr(got.measurements, k), getattr(ref.measurements, k)) for k in MM_FIELDS)))
    return {"score": score, "box_px": box, "mm": mm, "bit_equal": equal, "failed": failed}


def inner_diffs(torch, plain, pipe, frames) -> dict:
    """Where the space step first departs from the plain step on
    ``frames``: the largest |diff| of this rank's model-input rows, of each
    gathered head output against the plain forward's, and of each when the
    slabs' forward takes the plain step's own input rows."""
    from tti_torch.parallel.mesh import tree_leaves

    with torch.inference_mode():
        x = plain.preprocess(frames)
        r0, r1 = pipe.input_rows
        rows = slice(r0 // 2, r1 // 2) if plain.model.s2d_input else slice(r0, r1)
        xs = pipe.preprocess(frames)
        want = plain.model(x)
        got = pipe.space.gather_rows(pipe.model(xs))
        same = pipe.space.gather_rows(pipe.model(x[:, rows].contiguous()))
        diff = lambda t: [float((a.float() - b.float()).abs().max())
                          for a, b in zip(tree_leaves(t), tree_leaves(want))]
        return {"input": float((xs.float() - x[:, rows].float()).abs().max()),
                "raw": diff(got), "raw_on_plain_input": diff(same)}


def p50_ms(torch, pipe, frames, iters=P50_ITERS, after_warmup=lambda: None) -> float:
    for _ in range(3):
        pipe.step(frames)
    after_warmup()
    lats = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipe.step(frames)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t)
    return 1e3 * float(np.median(lats))


def pass2_bytes(warp) -> dict:
    """A two-pass warp's pass-2 weights as one step reads them: its bands
    (one when dense), their bytes, and the bytes of the dense weights over
    the same output rows and source rows (``src_rows``)."""
    from tti_torch.preprocess.warp2pass import PAD_ROWS

    blocks = warp.w2_blocks if warp.block is not None else [(0, warp.w2)]
    size = blocks[0][1].element_size()
    rows = sum(2 * w.shape[2] if warp.s2d_out else w.shape[1] for _, w in blocks)
    y0, y1 = warp.src_rows
    return {"bands": len(blocks), "bytes": sum(w.numel() for _, w in blocks) * size,
            "dense_bytes": warp.dst_hw[1] * rows * (y1 - y0 + PAD_ROWS) * size}


def worker(rank: int, world: int, coordinator: str, backend: str, out_dir: str,
           runs: str) -> int:
    """One rank: the runs of ``runs_of(runs)`` on a (1, world) space mesh, each
    without ``warp_pass1="kernel"`` under the banded warp of
    ``TTI_WARP_BLOCKED`` when it is set and the run names no block; writes
    ``rank<r>.json``. A failed check raises."""
    sys.path[:0] = [HERE, os.path.join(HERE, "tests"), os.path.join(HERE, "tools")]
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from tti_torch.core.config import RuntimeSwitches
    from tti_torch.kernels import maskstats as ms
    from tti_torch.kernels import warp_p1 as wp
    from tti_torch.parallel import spatial
    from tti_torch.parallel.mesh import create_mesh
    from tti_torch.preprocess.warp2pass import TwoPassWarp

    block = RuntimeSwitches.from_env(os.environ).warp_block

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=world,
                            rank=rank)
    halo_s = [0.0]
    halo = spatial.Space.halo

    def timed_halo(self, *args, **kwargs):
        t = time.perf_counter()
        try:
            return halo(self, *args, **kwargs)
        finally:
            halo_s[0] += time.perf_counter() - t

    spatial.Space.halo = timed_halo
    result = {"rank": rank, "world": world, "backend": backend, "runs": {}}
    try:
        mesh = create_mesh((1, world), ("data", "space"), device_type="cuda")
        for tag, config, dtype, kw, batches, timed in runs_of(runs):
            hw, imgsz, ckpt = cs.CONFIGS[config]
            if block is not None and "warp_block" not in kw and "warp_pass1" not in kw:
                kw = dict(kw, warp_block=block)  # the kernel route takes no block
            plain = cs.build_pipeline(torch, hw, imgsz, ckpt, dtype=dtype, **kw)
            pipe = cs.build_pipeline(torch, hw, imgsz, ckpt, dtype=dtype, mesh=mesh, **kw)
            run = {"input_rows": pipe.input_rows, "warp_block": kw.get("warp_block"),
                   "pass1_rows": getattr(pipe.warp, "src_rows", None), "diffs": {}}
            if isinstance(pipe.warp, TwoPassWarp):
                run["pass2"] = pass2_bytes(pipe.warp)
            want = LAUNCHES[tag.split("/")[0]]
            for b in batches:
                frames = cs.textile(hw, b)
                ref = plain.process_batch(frames)
                cs.reset_launch_counts(ms, wp)
                spatial.reset_counts()
                got = pipe.process_batch(frames)
                launches = {k: v for k, v in cs.launch_counts(ms, wp).items() if v}
                counts = dict(spatial.COUNTS)
                cs.check(launches == want, f"{tag} batch {b}: launches {launches}, want {want}")
                if world > 1:
                    cs.check(counts["halo"] == HALOS_PER_STEP and counts["gather"] == 1
                             and counts["max"] == (66 if kw.get("quant") == "int8" else 0),
                             f"{tag} batch {b}: spatial counts {counts}")
                run["diffs"][b] = compare(got, ref, dtype)
                run.setdefault("launches", launches)
                run.setdefault("counts", {})[b] = counts
                if world > 1 and b == batches[0]:
                    run["inner_diffs"] = inner_diffs(
                        torch, plain, pipe, torch.from_numpy(frames).cuda())
            if timed:
                one = torch.from_numpy(cs.textile(hw, 1)).cuda()
                if rank == 0:
                    run["plain_p50_ms"] = p50_ms(torch, plain, one)
                    run["plain_busy_ms"] = cs.device_time(torch, lambda: plain.step(one), 3)[1]
                dist.barrier()
                run["p50_ms"] = p50_ms(torch, pipe, one,
                                       after_warmup=lambda: halo_s.__setitem__(0, 0.0))
                run["halo_host_ms_per_step"] = 1e3 * halo_s[0] / P50_ITERS
                spatial.reset_counts()
                # NCCL's kernels spin on the card while a peer is late: busy
                # leaves them out, and their own ms stand beside it.
                per_name, busy, n_ops = cs.device_time(torch, lambda: pipe.step(one), 3,
                                                       skip="nccl")
                run.update(busy_ms=busy, device_ops_per_step=n_ops,
                           nccl_device_ms_per_step=sum(v for k, v in per_name.items()
                                                       if "nccl" in k.lower()),
                           copy_device_ms_per_step=sum(v for k, v in per_name.items()
                                                       if "memcpy" in k.lower()),
                           halo_bytes_sent_per_step=spatial.COUNTS["halo_bytes"] / 3,
                           gather_bytes_per_step=spatial.COUNTS["gather_bytes"] / 3)
            result["runs"][tag] = run
            del plain, pipe
            torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    failed = [f"{tag} batch {b}: {why}" for tag, run in result["runs"].items()
              for b, d in run["diffs"].items() for why in d["failed"]]
    for line in failed:
        print(f"rank {rank}: {line}", flush=True)
    return 1 if failed else 0


def launch(world: int, backend: str, out_dir: str, runs: str = "checked",
           timeout: float = 600.0) -> list[dict]:
    """Start ``world`` worker processes (ranks of one ``backend`` job on
    127.0.0.1, card r for rank r under NCCL, card 0 for every rank under
    gloo) running ``runs_of(runs)``, wait for each within ``timeout``
    seconds, kill what is left; each rank's readings. A rank that fails
    raises ``RuntimeError`` with its output's end."""
    sys.path.insert(0, HERE)
    from tti_torch.parallel.dcn import free_local_coordinator

    os.makedirs(out_dir, exist_ok=True)
    coord = free_local_coordinator()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", "--rank", str(r), "--world",
         str(world), "--coordinator", coord, "--backend", backend, "--out", out_dir,
         "--runs", runs], cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=HERE))
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + f"\n[killed after {timeout} s]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"space rank {r} of {world} ({backend}) exited {p.returncode}:\n"
                               f"{text[-4000:]}")
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def summary_lines(ranks: list[dict], label: str) -> list[str]:
    """One line per configuration: every rank's readings side by side."""
    lines = []
    for tag, run0 in ranks[0]["runs"].items():
        runs = [r["runs"][tag] for r in ranks]
        parts = [f"{label}, {tag}: slabs (model-input rows) "
                 f"{[tuple(r['input_rows']) if r['input_rows'] else None for r in runs]}, "
                 f"pass-1 source rows {[r['pass1_rows'] for r in runs]}"]
        for b, d in run0["diffs"].items():
            same = ", bit-equal" if all(r["diffs"][b]["bit_equal"] for r in runs) else ""
            if "score" in d:
                parts.append(f"batch {b} against the plain step: max |diff| scores "
                             f"{d['score']:.3g}, boxes {d['box_px']:.3g} px, mm {d['mm']:.3g}"
                             + same)
            else:
                parts.append(f"batch {b} against the plain step: detection counts equal on "
                             f"{d['same_count_share']:.1%} of frames, mm max {d['mm_max']:.4g}, "
                             f"median {d['mm_median']:.4g} over {d['readings']} readings" + same)
        parts.append(f"launches per rank and step {run0['launches']}; exchanges "
                     f"{list(run0['counts'].values())[0]}")
        if "pass2" in run0:
            parts.append("pass-2 bands and bytes per rank (beside the dense slab's) " + ", ".join(
                f"{r['pass2']['bands']} bands {r['pass2']['bytes']} ({r['pass2']['dense_bytes']})"
                for r in runs) + (f", warp_block {run0['warp_block']}" if run0["warp_block"]
                                  else ""))
        if "inner_diffs" in run0:
            d = [r["inner_diffs"] for r in runs]
            parts.append("max |diff| against the plain step's, per rank: model-input rows "
                         f"{[x['input'] for x in d]}, head outputs {[max(x['raw']) for x in d]}, "
                         "head outputs on the plain step's input rows "
                         f"{[max(x['raw_on_plain_input']) for x in d]}")
        if "p50_ms" in run0:
            parts.append("batch-1 p50 per rank " + ", ".join(f"{r['p50_ms']:.3f}" for r in runs)
                         + f" ms (plain {run0['plain_p50_ms']:.3f}); busy without NCCL per rank "
                         + ", ".join("not measured" if r["busy_ms"] is None
                                     else f"{r['busy_ms']:.3f}" for r in runs)
                         + f" ms (plain {run0['plain_busy_ms'] or 0:.3f}); halo host ms per step "
                         + ", ".join(f"{r['halo_host_ms_per_step']:.3f}" for r in runs)
                         + "; NCCL device ms "
                         + ", ".join(f"{r['nccl_device_ms_per_step']:.3f}" for r in runs)
                         + "; copies' device ms "
                         + ", ".join(f"{r['copy_device_ms_per_step']:.3f}" for r in runs)
                         + f"; gather bytes per rank and step {run0['gather_bytes_per_step']:.0f}"
                         + "; halo bytes sent per rank and step "
                         + ", ".join(f"{r['halo_bytes_sent_per_step']:.0f}" for r in runs))
        lines.append("; ".join(parts))
    return lines


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--spaces", default="1,2,4", help="space sizes to run, comma-separated")
    parser.add_argument("--out", default=os.path.join(HERE, "build", "space_cards"))
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--coordinator", help=argparse.SUPPRESS)
    parser.add_argument("--backend", default="nccl", help=argparse.SUPPRESS)
    parser.add_argument("--runs", default="checked", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        return worker(args.rank, args.world, args.coordinator, args.backend, args.out,
                      args.runs)
    import torch

    if not torch.cuda.is_available():
        print("space_cards_torch: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    cards = torch.cuda.device_count()
    sys.path.insert(0, HERE)
    from tti_torch.kernels import build as kbuild

    kbuild.compile_all(("maskstats", "warp_p1", "nms", "int8conv"))  # once, for every rank
    print(card, flush=True)
    print(f"{cards} card(s): {smi.stdout.strip().splitlines()}", flush=True)
    results = {}
    for n in (int(s) for s in args.spaces.split(",")):
        if n > cards:
            print(f"space {n}: skipped, {cards} card(s) here", flush=True)
            continue
        t0 = time.perf_counter()
        try:
            ranks = launch(n, "nccl", os.path.join(args.out, f"space{n}"),
                           runs="checked" if n > 1 else "timed")
        except RuntimeError as e:
            print(e, flush=True)
            return 1
        results[n] = {"ranks": ranks, "wall_s": time.perf_counter() - t0}
        for line in summary_lines(ranks, f"space {n} over {n} card(s), NCCL"):
            print(line, flush=True)
        print(f"space {n}: {results[n]['wall_s']:.1f} s with the processes' start", flush=True)
    path = os.path.join(args.out, "space_cards.json")
    with open(path, "w") as f:
        json.dump({"card": card, "cards": cards, "spaces": results}, f)
    print(f"every rank's readings: {path}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
