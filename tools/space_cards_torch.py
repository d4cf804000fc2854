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
one flipped mask cell moves a reading by up to 0.24 mm; at batch 1 and 2
the bar below. It checks the
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
ranks then run ``BANDED`` (``launch(..., runs="checked,banded,dual")``): the
deploy and headline steps with ``warp_block=64``, float32 at batch 1 and 2
at the bar above, bf16 at batch 1 timed; and ``DUAL``: the dual step of the
headline checkpoint and ``yolov8n_textile_960.msgpack`` (phase 5's dual
check) on the mesh against the plain dual step, float32 at batch 1 and 2 at
the float32 bar, B and D twice, 88 halo exchanges and 2 gathers per rank
and step.

The bf16 steps at batch 1 and 2 are held to the plain step at that batch
within the plain step's own spread on those frames, measured in the same
process (:func:`plain_spread`): its readings of the same frames at batch
128, and with its forward computed on slabs of other shapes
(:func:`other_plans`: one and two ranks more, the split moved by one P5
row; :func:`on_slabs` runs them on threads of this process), against its
readings at batch b; at batch 2 the batch-1 spread of the first frame
counts too. A bf16 convolution rounds by the shape it is given, so a slab
of another shape is the yardstick for the slab of the mesh. The space
step must have the plain step's detection counts on every frame and its
mm within the larger of that spread and 0.01 mm (the modes phase's median
bar, the floor for a zero spread), never above 0.25 (:func:`spread_bar`);
and it must equal, bit for bit, :func:`on_slabs` with the mesh's own
slabs, which runs the same arithmetic with the halos and the gather
between threads. At each run's first batch each rank also names the first
convolution whose rows depart from the plain forward's on identical input
rows, and the CUDA kernels its two calls launch (:func:`conv_departures`).

    python tools/space_cards_torch.py --spaces 2 --repeat 20 [--backend gloo]

repeats the float32 deploy batch-1 check (``REPEAT_TAG``) 20 times in one
process pair and runs nothing else: the even repeats on the frame the other
runs check, the odd ones on fresh seeded frames. On any rank's miss each
rank writes ``rank<r>_miss<n>.npz`` beside its ``rank<r>.json``
(:class:`StepRecorder`): every halo's sent and received rows of that step,
the slab's head outputs (box, class and coefficient logits, protos) and the
plain step's for the same rows, and the frames. ``chip_smoke.py`` runs the
same check 3 times. ``--backend gloo`` puts every rank on card 0 (NCCL
refuses two ranks on one card).
"""

from __future__ import annotations

import argparse
import contextlib
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
    "dual": {"mask_stats_binary": 2, "greedy_keep": 2},
}
REPEAT_TAG = "deploy/float32"  # its batch-1 check repeats (--repeat; once in chip_smoke)
DUAL_SECOND = "yolov8n_textile_960.msgpack"  # beside the headline checkpoint, as in phase 5
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
# The dual step on the mesh, against the plain dual step at the float32 bar.
DUAL = (("dual/float32", "headline", "float32", {}, (1, 2), False),)
RUNS = {"checked": CHECKED, "timed": TIMED_ONLY, "banded": BANDED, "dual": DUAL,
        "repeat": (("deploy/float32", "deploy", "float32", {}, (1,), False),)}


def runs_of(names: str) -> tuple:
    """The runs of a comma-separated list of ``RUNS``' names, in order."""
    return tuple(run for name in names.split(",") for run in RUNS[name])


MM_FIELDS = ("edge_distance_mm", "stitch_width_mm", "raw_edge_mm", "raw_width_mm")
P50_ITERS = 30
BF16_BATCH = 128  # the bf16 bar's batch: chip_smoke's MODE_* bar holds over many frames


def spread_bar(mm_max: float, spread_mm_max: float, counts_equal: bool) -> dict:
    """The bf16 space step at batch 1 or 2 against the plain step at that
    batch: its largest mm difference ``mm_max`` within the plain step's own
    spread ``spread_mm_max`` (:func:`plain_spread`; the larger of it and ``MODE_MM_MEDIAN``,
    0.01 mm, the floor for a zero spread; never above ``MODE_MM_MAX``, 0.25
    mm), and equal detection counts on every frame."""
    import chip_smoke as cs

    limit = min(max(spread_mm_max, cs.MODE_MM_MEDIAN), cs.MODE_MM_MAX)
    return {"limit_mm": limit, "ok": bool(counts_equal and mm_max <= limit)}


def first_frames(out, b: int):
    """The mm readings of an output's first ``b`` frames (for
    ``chip_smoke.mm_differences``)."""
    from types import SimpleNamespace

    import chip_smoke as cs

    return SimpleNamespace(measurements=SimpleNamespace(
        **{k: getattr(out.measurements, k)[:b] for k in cs.MM_KEYS}))


def compare(got, ref, dtype: str, spread=None, emulated=None) -> dict:
    """The space step's host outputs against the plain step's: the float32
    bar, or at ``BF16_BATCH`` the bf16 bar (the module's docstring); the
    largest differences, whether every output is equal, and what failed
    the bar. bf16 at another batch, with ``spread`` (the plain step's own
    spread on these frames: its mm differences, :func:`plain_spread`):
    :func:`spread_bar`, and with ``emulated`` (:func:`on_slabs` with the
    mesh's own slabs) every output bit-equal to it; without them, the
    readings only."""
    import chip_smoke as cs

    if dtype != "float32":
        same_n = float((got.valid.sum(1) == ref.valid.sum(1)).mean())
        d = cs.mm_differences(got, ref)
        out = {"same_count_share": same_n, "mm_max": float(d.max(initial=0.0)),
               "mm_median": float(np.median(d)) if d.size else 0.0, "readings": int(d.size),
               "bit_equal": outputs_equal(got, ref), "failed": []}
        if len(got.valid) == BF16_BATCH and not (
                same_n >= cs.MODE_NVALID_SHARE and out["mm_max"] <= cs.MODE_MM_MAX
                and out["mm_median"] <= cs.MODE_MM_MEDIAN and d.size):
            out["failed"].append(f"bf16 bar: {out}")
        elif len(got.valid) != BF16_BATCH and spread is not None:
            out["spread_mm_max"] = float(spread.max(initial=0.0))
            bar = spread_bar(out["mm_max"], out["spread_mm_max"], same_n == 1.0)
            out["limit_mm"], out["spread_bar_met"] = bar["limit_mm"], bar["ok"]
            if not bar["ok"]:
                out["failed"].append(f"bf16 bar (counts equal, mm within the plain step's "
                                     f"spread): {out}")
        if emulated is not None:
            out["emulated_equal"] = outputs_equal(got, emulated)
            if not out["emulated_equal"]:
                out["failed"].append("bf16: not bit-equal to the same slabs' forward on "
                                     "threads of one process")
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
    return {"score": score, "box_px": box, "mm": mm, "bit_equal": outputs_equal(got, ref),
            "failed": failed}


def outputs_equal(got, ref) -> bool:
    """Valid rows, scores, frame boxes and mm readings bit-equal (NaN where
    NaN)."""
    return all(np.array_equal(x, y, equal_nan=True) for x, y in (
        (got.valid, ref.valid), (got.scores, ref.scores), (got.boxes_frame, ref.boxes_frame),
        *((getattr(got.measurements, k), getattr(ref.measurements, k)) for k in MM_FIELDS)))


def merge_compares(parts: dict) -> dict:
    """One entry from several outputs' :func:`compare` (float32: the dual
    step's two models): the largest differences, equal when all are, every
    failure named by its part."""
    return {"score": max(d["score"] for d in parts.values()),
            "box_px": max(d["box_px"] for d in parts.values()),
            "mm": max(d["mm"] for d in parts.values()),
            "bit_equal": all(d["bit_equal"] for d in parts.values()),
            "failed": [f"{name}: {why}" for name, d in parts.items() for why in d["failed"]]}


def other_plans(plan) -> list[tuple[int, ...]]:
    """Slabs of other shapes over the same P5 rows as ``plan``: one and two
    ranks more, and ``plan``'s split moved by one P5 row (the first slab
    one row taller, the last one shorter), where each exists."""
    from tti_torch.parallel.spatial import UNIT, slab_plan

    total, out = plan.total, []
    for size in (len(plan.counts) + 1, len(plan.counts) + 2):
        if size <= total:
            out.append(slab_plan(UNIT * total, size).counts)
    if plan.counts[-1] > 1:
        out.append((plan.counts[0] + 1, *plan.counts[1:-1], plan.counts[-1] - 1))
    return [c for c in dict.fromkeys(out) if c != plan.counts]


def on_slabs(torch, plain, frames, counts):
    """The plain pipeline's step on ``frames`` (host uint8) with its forward
    computed on slabs of ``counts`` P5 rows: one thread per slab, each with
    its own copy of the model, exchanging halos and gathering through this
    process's memory (``tests/torch_threads.py``); the preprocess and
    everything after the forward as the plain step runs them. Host
    outputs."""
    import copy

    from torch_threads import on_threads
    from tti_torch.parallel.spatial import SlabPlan, set_space

    plan = SlabPlan(tuple(counts))
    models = [copy.deepcopy(plain.model) for _ in plan.counts]
    on_card = plain.device.type == "cuda"
    with torch.inference_mode():
        x = plain.preprocess(torch.from_numpy(np.ascontiguousarray(frames)).to(plain.device))

        def forward(r, space):
            set_space(models[r], space)
            r0, r1 = plan.input_rows(r)
            rows = slice(r0 // 2, r1 // 2) if plain.model.s2d_input else slice(r0, r1)
            with (torch.cuda.device(plain.device) if on_card else contextlib.nullcontext()), \
                    torch.inference_mode():
                return space.gather_rows(models[r](x[:, rows].contiguous()))

        raw = on_threads(plan, forward)[0]
        model, plain.model = plain.model, lambda _: raw
        try:
            return plain.outputs_to_host(plain.postprocess_chain(x))
        finally:
            plain.model = model


def plain_spread(torch, plain, frames, ref, ref_full, plan) -> tuple:
    """The plain step's own spread on ``frames``: its mm readings computed
    otherwise than ``ref`` (the plain step at this batch) by equally valid
    arithmetic, against ``ref``: at ``BF16_BATCH`` (``ref_full``'s first
    frames) and with its forward on each of :func:`other_plans`' slabs
    (:func:`on_slabs`). Returns the differences and the largest per
    variant."""
    import chip_smoke as cs

    b = len(frames)
    variants = {f"batch {BF16_BATCH}": first_frames(ref_full, b)}
    variants.update({f"slabs {c}": on_slabs(torch, plain, frames, c) for c in other_plans(plan)})
    diffs = {name: cs.mm_differences(ref, v) for name, v in variants.items()}
    return (np.concatenate(list(diffs.values())),
            {name: float(d.max(initial=0.0)) for name, d in diffs.items()})


def repeat_frames(hw, b: int, n: int) -> tuple:
    """Repetition ``n``'s frames and their name: even ``n`` the frames every
    other check takes (``chip_smoke.textile``), odd ``n`` fresh seeded ones."""
    import chip_smoke as cs

    if n % 2 == 0:
        return cs.textile(hw, b), "textile"
    from torch_synth import textile_frames

    return textile_frames(b, *hw, seed=1000 + n), f"seed {1000 + n}"


def named_leaves(raw) -> dict:
    """A forward's head outputs by name (``RawPredictions``' fields and
    level), as detached device copies (no host sync)."""
    from tti_torch.parallel.mesh import tree_leaves

    if hasattr(raw, "protos"):
        pairs = [(f"{f}{lvl}", t) for f in ("box", "cls", "mcoef")
                 for lvl, t in enumerate(getattr(raw, f))] + [("protos", raw.protos)]
    else:
        pairs = [(f"leaf{n}", t) for n, t in enumerate(tree_leaves(raw))]
    return {name: t.detach().clone() for name, t in pairs}


def host(t) -> np.ndarray:
    return t.float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()


class StepRecorder:
    """Records one step of a space pipeline ``pipe`` and of the plain
    pipeline ``plain`` for a miss dump: every halo's sent and received rows
    in call order (device copies made after the exchange, so recording adds
    no host sync to the step), the slab's head outputs as the step hands
    them to the gather, and the plain forward's head outputs. Use as a
    context manager around both steps; :meth:`arrays` copies them to the
    host (only on a miss)."""

    def __init__(self, pipe, plain) -> None:
        self.pipe, self.plain = pipe, plain
        self.halos, self.slab, self.plain_out = [], {}, {}

    def __enter__(self) -> "StepRecorder":
        space = self.pipe.space
        exchange, gather = space.transport.exchange, space.gather_rows

        def recorded_exchange(sends, recvs):
            exchange(sends, recvs)
            copy = lambda pairs: [(p, t.detach().clone()) for p, t in pairs]
            self.halos.append((copy(sends), copy(recvs)))

        def recorded_gather(tree):
            self.slab = named_leaves(tree)
            return gather(tree)

        space.transport.exchange = recorded_exchange  # instance attributes over the methods
        space.gather_rows = recorded_gather
        self._hook = self.plain.model.register_forward_hook(
            lambda module, args, out: self.plain_out.update(named_leaves(out)))
        return self

    def __exit__(self, *exc) -> None:
        space = self.pipe.space
        del space.transport.exchange, space.gather_rows
        self._hook.remove()

    def arrays(self) -> dict:
        """``halo<h>/sent<n>_to<peer>`` and ``halo<h>/recv<n>_from<peer>``,
        ``slab/<name>`` and ``plain/<name>`` (the plain forward's rows of
        this slab), and ``slab_p5_rows`` (start, stop, total); host arrays,
        float32 for floating outputs."""
        space = self.pipe.space
        start, stop, total = space.start, space.stop, space.plan.total
        out = {"slab_p5_rows": np.array([start, stop, total])}
        for h, (sends, recvs) in enumerate(self.halos):
            out.update({f"halo{h:02d}/sent{n}_to{p}": host(t) for n, (p, t) in enumerate(sends)})
            out.update({f"halo{h:02d}/recv{n}_from{p}": host(t)
                        for n, (p, t) in enumerate(recvs)})
        out.update({f"slab/{k}": host(t) for k, t in self.slab.items()})
        for k, t in self.plain_out.items():
            f = t.shape[1] // total
            out[f"plain/{k}"] = host(t[:, f * start:f * stop])
        return out


def inner_diffs(torch, plain, pipe, frames) -> dict:
    """Where the space step first departs from the plain step on
    ``frames``: the largest |diff| of this rank's model-input rows, of each
    gathered head output against the plain forward's, of each when the
    slabs' forward takes the plain step's own input rows, and the first
    convolutions that depart then (:func:`conv_departures`)."""
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
            "raw": diff(got), "raw_on_plain_input": diff(same),
            "conv_departures": conv_departures(torch, plain, pipe, x)}


def conv_departures(torch, plain, pipe, x, first: int = 3) -> dict:
    """Where this rank's slab forward on the plain step's own input rows
    ``x`` first departs from the plain forward: every convolution of both,
    in the order they run, its output rows against the plain one's; the
    first ``first`` that differ (|diff| max, each call's input shape and
    padding), and for the first of them the CUDA kernels each of its two
    calls launches when run again alone on its recorded input
    (``torch.profiler``; other kernel names are another cuDNN algorithm)
    and their outputs' |diff| max then."""
    from torch.nn.modules.conv import _ConvNd

    calls = {"plain": [], "slab": []}

    def record(key, name):
        return lambda mod, args, kwargs, out: calls[key].append((name, mod, args, kwargs, out))

    hooks = [m.register_forward_hook(record(key, name), with_kwargs=True)
             for key, model in (("plain", plain.model), ("slab", pipe.model))
             for name, m in model.named_modules() if isinstance(m, _ConvNd)]
    r0, r1 = pipe.input_rows
    rows = slice(r0 // 2, r1 // 2) if plain.model.s2d_input else slice(r0, r1)
    try:
        with torch.inference_mode():
            plain.model(x)
            pipe.model(x[:, rows].contiguous())
    finally:
        for h in hooks:
            h.remove()
    total, start, stop = pipe.space.plan.total, pipe.space.start, pipe.space.stop
    out = {"convs": len(calls["plain"]), "departs": []}
    for i, (p, q) in enumerate(zip(calls["plain"], calls["slab"])):
        if p[0] != q[0]:
            out["order_differs_at"] = [p[0], q[0]]
            break
        f = p[4].shape[2] // total
        d = float((q[4].float() - p[4][:, :, f * start:f * stop].float()).abs().max())
        if d > 0:
            out["departs"].append({
                "index": i, "module": p[0], "max_abs_diff": d,
                "plain_input": list(p[2][0].shape), "plain_padding": str(p[3].get(
                    "padding", p[1].padding)),
                "slab_input": list(q[2][0].shape), "slab_padding": str(q[3].get(
                    "padding", q[1].padding))})
            if len(out["departs"]) == first:
                break
    if out["departs"] and x.is_cuda:
        import chip_smoke as cs

        i = out["departs"][0]["index"]
        again, kernels = {}, {}
        for key in ("plain", "slab"):
            _, mod, args, kwargs, _ = calls[key][i]

            def call(key=key, mod=mod, args=args, kwargs=kwargs):
                with torch.inference_mode():
                    again[key] = mod(*args, **kwargs)

            call()  # cuDNN's choice made, outside the profile
            kernels[key] = sorted(cs.device_time(torch, call, 3)[0])
        f = again["plain"].shape[2] // total
        out["kernels"] = kernels
        out["alone_max_abs_diff"] = float((again["slab"].float() - again["plain"][
            :, :, f * start:f * stop].float()).abs().max())
    return out


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
           runs: str, repeat: int = 1) -> int:
    """One rank: the runs of ``runs_of(runs)`` on a (1, world) space mesh, each
    without ``warp_pass1="kernel"`` under the banded warp of
    ``TTI_WARP_BLOCKED`` when it is set and the run names no block, the
    batch-1 check of ``REPEAT_TAG`` ``repeat`` times (a miss dump on any
    rank's miss); writes ``rank<r>.json``. A failed check raises."""
    t_start = time.perf_counter()
    sys.path[:0] = [HERE, os.path.join(HERE, "tests"), os.path.join(HERE, "tools")]
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from tti_torch.core.config import RuntimeSwitches
    from tti_torch.kernels import maskstats as ms
    from tti_torch.kernels import warp_p1 as wp
    from tti_torch.parallel import spatial
    from tti_torch.parallel.mesh import create_mesh
    from tti_torch.parallel.runtime import DualPipeline
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

    def any_rank(flag: bool) -> bool:
        t = torch.tensor([int(flag)], device="cuda" if backend == "nccl" else "cpu")
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    spatial.Space.halo = timed_halo
    # Seconds from the worker's entry to its joined group (imports, the card).
    result = {"rank": rank, "world": world, "backend": backend, "runs": {},
              "start_s": time.perf_counter() - t_start}
    try:
        mesh = create_mesh((1, world), ("data", "space"), device_type="cuda")
        for tag, config, dtype, kw, batches, timed in runs_of(runs):
            t_run = time.perf_counter()
            hw, imgsz, ckpt = cs.CONFIGS[config]
            if block is not None and "warp_block" not in kw and "warp_pass1" not in kw:
                kw = dict(kw, warp_block=block)  # the kernel route takes no block
            build = lambda c, m=None: cs.build_pipeline(torch, hw, imgsz, c, dtype=dtype, mesh=m,
                                                        **kw)
            dual = tag.startswith("dual/")
            plain, pipe = build(ckpt), build(ckpt, mesh)
            if dual:
                plain = DualPipeline(plain, build(DUAL_SECOND))
                pipe = DualPipeline(pipe, build(DUAL_SECOND, mesh))
            head = pipe.primary if dual else pipe
            run = {"input_rows": head.input_rows, "warp_block": kw.get("warp_block"),
                   "pass1_rows": getattr(head.warp, "src_rows", None), "diffs": {}}
            if isinstance(head.warp, TwoPassWarp):
                run["pass2"] = pass2_bytes(head.warp)
            want = LAUNCHES[tag.split("/")[0]]
            chains = 2 if dual else 1
            t_checks = time.perf_counter()
            # bf16: the plain step's readings at BF16_BATCH, the first of the
            # variants of its own spread at batch 1 and 2 (plain_spread).
            ref_full = (plain.process_batch(cs.textile(hw, BF16_BATCH))
                        if dtype != "float32" and BF16_BATCH in batches else None)
            spreads = []
            for b in batches:
                reps = repeat if tag == REPEAT_TAG and b == 1 else 1
                for n in range(reps):
                    frames, which = repeat_frames(hw, b, n)
                    recorder = (StepRecorder(pipe, plain) if tag == REPEAT_TAG and b == 1
                                else contextlib.nullcontext())  # the dump is always on
                    with recorder:
                        ref = (ref_full if b == BF16_BATCH and ref_full is not None
                               else plain.process_batch(frames))
                        cs.reset_launch_counts(ms, wp)
                        spatial.reset_counts()
                        got = pipe.process_batch(frames)
                    launches = {k: v for k, v in cs.launch_counts(ms, wp).items() if v}
                    counts = dict(spatial.COUNTS)
                    cs.check(launches == want,
                             f"{tag} batch {b}: launches {launches}, want {want}")
                    if world > 1:
                        cs.check(counts["halo"] == chains * HALOS_PER_STEP
                                 and counts["gather"] == chains
                                 and counts["max"] == (66 if kw.get("quant") == "int8" else 0),
                                 f"{tag} batch {b}: spatial counts {counts}")
                    if dual:
                        d = merge_compares({"primary": compare(got[0], ref[0], dtype),
                                            "secondary": compare(got[1], ref[1], dtype)})
                    elif ref_full is not None and b != BF16_BATCH and pipe.space is not None:
                        diffs, run.setdefault("spread_by_variant", {})[b] = plain_spread(
                            torch, plain, frames, ref, ref_full, pipe.space.plan)
                        spreads.append(diffs)  # a smaller batch's frames lead this one's
                        d = compare(got, ref, dtype, np.concatenate(spreads),
                                    on_slabs(torch, plain, frames, pipe.space.plan.counts))
                    else:
                        d = compare(got, ref, dtype)
                    if isinstance(recorder, StepRecorder):
                        rep = {"n": n, "frames": which, "missed": bool(d["failed"]),
                               **{k: d[k] for k in ("score", "box_px", "mm")}}
                        if any_rank(rep["missed"]):
                            rep["dump"] = os.path.join(out_dir, f"rank{rank}_miss{n}.npz")
                            np.savez(rep["dump"], frames=frames, **recorder.arrays())
                        run.setdefault("repeats", []).append(rep)
                    if n == 0:
                        run["diffs"][b] = d
                    else:
                        run["diffs"][b]["failed"] += [f"repeat {n} ({which}): {why}"
                                                      for why in d["failed"]]
                    run.setdefault("launches", launches)
                    run.setdefault("counts", {})[b] = counts
                if world > 1 and b == batches[0] and not dual:
                    run["inner_diffs"] = inner_diffs(
                        torch, plain, pipe, torch.from_numpy(cs.textile(hw, b)).cuda())
            t_timed = time.perf_counter()
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
            # Wall seconds of the run's parts: building its pipelines, the
            # checks, the timing.
            now = time.perf_counter()
            run["wall_s"] = {"setup": t_checks - t_run, "checks": t_timed - t_checks,
                             "timed": now - t_timed}
            result["runs"][tag] = run
            del plain, pipe, head, ref_full
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
           timeout: float = 600.0, repeat: int = 1) -> list[dict]:
    """Start ``world`` worker processes (ranks of one ``backend`` job on
    127.0.0.1, card r for rank r under NCCL, card 0 for every rank under
    gloo) running ``runs_of(runs)`` (``REPEAT_TAG``'s batch-1 check
    ``repeat`` times), wait for each within ``timeout`` seconds, kill what
    is left; each rank's readings. A rank that fails raises
    ``RuntimeError`` with its output's end (its readings are still in
    ``out_dir``)."""
    sys.path.insert(0, HERE)
    from tti_torch.parallel.dcn import free_local_coordinator

    os.makedirs(out_dir, exist_ok=True)
    coord = free_local_coordinator()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", "--rank", str(r), "--world",
         str(world), "--coordinator", coord, "--backend", backend, "--out", out_dir,
         "--runs", runs, "--repeat", str(repeat)], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
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
                spread = (f"; the plain step's own spread {d['spread_mm_max']:.4g} mm "
                          f"({spread_text(run0, b)}), its bar {d['limit_mm']:.4g} "
                          f"{'met' if d['spread_bar_met'] else 'NOT MET'}"
                          if "spread_mm_max" in d else "")
                if "emulated_equal" in d:
                    spread += ("; bit-equal to the same slabs on threads" if all(
                        r["diffs"][b]["emulated_equal"] for r in runs)
                        else "; NOT bit-equal to the same slabs on threads")
                parts.append(f"batch {b} against the plain step: detection counts equal on "
                             f"{d['same_count_share']:.1%} of frames, mm max {d['mm_max']:.4g}, "
                             f"median {d['mm_median']:.4g} over {d['readings']} readings"
                             + same + spread)
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
            parts.append("; ".join(departures_text(r, x["conv_departures"])
                                   for r, x in enumerate(d)))
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
        if "wall_s" in run0:
            parts.append("wall s per rank (set-up, checks, timing) " + ", ".join(
                "({setup:.1f}, {checks:.1f}, {timed:.1f})".format(**r["wall_s"]) for r in runs))
        lines.append("; ".join(parts))
    return lines


def spread_text(run: dict, b) -> str:
    """A run's spread variants at batch ``b`` and their largest mm
    differences, with the smaller batches' that the spread includes."""
    by = run.get("spread_by_variant", {})
    return ", ".join(f"batch {c}: " + ", ".join(f"{k} {v:.4g}" for k, v in by[c].items())
                     for c in by if int(c) <= int(b))


def departures_text(rank: int, dep: dict) -> str:
    """:func:`conv_departures`' reading as text."""
    if not dep["departs"]:
        return f"rank {rank}: all {dep['convs']} convolutions' rows bit-equal on those rows"
    first = dep["departs"][0]
    text = (f"rank {rank}: convolution {first['index'] + 1} of {dep['convs']} "
            f"({first['module']}) departs first, |diff| {first['max_abs_diff']:.4g} "
            f"(input {first['plain_input']} padding {first['plain_padding']} against the slab's "
            f"{first['slab_input']} padding {first['slab_padding']}); then "
            + ", ".join(f"{x['module']} {x['max_abs_diff']:.4g}" for x in dep["departs"][1:]))
    if "kernels" in dep:
        # The convolution's own kernels, by name up to its arguments (the
        # bias add and memsets left out).
        k = {key: sorted({n.removeprefix("void ").split("(")[0].split("<")[-1].rstrip(">")
                          if "cutlass" in n else n.removeprefix("void ").split("(")[0]
                          for n in names if "at::native" not in n and "Memset" not in n})
             for key, names in dep["kernels"].items()}
        text += (f"; alone again |diff| {dep['alone_max_abs_diff']:.4g}, "
                 + ("the same kernels " + str(k["plain"]) if k["plain"] == k["slab"] else
                    f"kernels {k['plain']} against the slab's {k['slab']}"))
    return text


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--spaces", default="1,2,4", help="space sizes to run, comma-separated")
    parser.add_argument("--out", default=os.path.join(HERE, "build", "space_cards"))
    parser.add_argument("--repeat", type=int, default=None, metavar="N",
                        help="only the float32 deploy batch-1 check, N times per space size "
                             "(a miss dump beside each rank's readings)")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                        help="nccl: card r for rank r; gloo: every rank on card 0")
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--coordinator", help=argparse.SUPPRESS)
    parser.add_argument("--runs", default="checked", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.repeat is not None and args.repeat < 1:
        parser.error("--repeat takes a count of at least 1")
    runs_of(args.runs)  # a KeyError names an unknown run
    return args


def repeat_summary(ranks: list[dict], label: str) -> str:
    """The repeated check's line: steps, misses (a step any rank missed) and
    on which frames, the largest differences, the dumps."""
    per_rank = [r["runs"].get(REPEAT_TAG, {}).get("repeats", []) for r in ranks]
    steps = list(zip(*per_rank))
    missed = [reps[0]["frames"] for reps in steps if any(rep["missed"] for rep in reps)]
    every = [rep for reps in steps for rep in reps]
    top = lambda k: max((rep[k] for rep in every), default=0.0)
    dumps = sorted(rep["dump"] for rep in every if rep.get("dump"))
    return (f"{label}, {REPEAT_TAG} batch 1 repeated: {len(missed)} miss(es) in {len(steps)} "
            f"steps ({sum(f == 'textile' for f in missed)} on the checked frame, "
            f"{sum(f != 'textile' for f in missed)} on fresh frames); largest |diff| over the "
            f"ranks scores {top('score'):.3g}, boxes {top('box_px'):.3g} px, mm {top('mm'):.3g}"
            + (f"; dumps {dumps}" if dumps else ""))


def read_ranks(out_dir: str, world: int) -> list[dict]:
    ranks = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                ranks.append(json.load(f))
    return ranks


def main() -> int:
    args = parse_args()
    if args.worker:
        return worker(args.rank, args.world, args.coordinator, args.backend, args.out,
                      args.runs, args.repeat or 1)
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
        if args.backend == "nccl" and n > cards:
            print(f"space {n}: skipped, {cards} card(s) here", flush=True)
            continue
        if args.repeat is not None and n == 1:
            print("space 1: skipped, the repeated check needs a space axis", flush=True)
            continue
        label = (f"space {n} over {n} card(s), NCCL" if args.backend == "nccl"
                 else f"space {n}, {n} gloo ranks sharing card 0")
        out_dir = os.path.join(args.out, f"space{n}")
        runs = "repeat" if args.repeat is not None else "checked" if n > 1 else "timed"
        t0 = time.perf_counter()
        try:
            ranks = launch(n, args.backend, out_dir, runs=runs, repeat=args.repeat or 1)
        except RuntimeError as e:
            print(e, flush=True)
            if args.repeat is not None and read_ranks(out_dir, n):
                print(repeat_summary(read_ranks(out_dir, n), label), flush=True)
            return 1
        results[n] = {"ranks": ranks, "wall_s": time.perf_counter() - t0}
        for line in summary_lines(ranks, label):
            print(line, flush=True)
        if args.repeat is not None:
            print(repeat_summary(ranks, label), flush=True)
        print(f"space {n}: {results[n]['wall_s']:.1f} s with the processes' start", flush=True)
    path = os.path.join(args.out, "space_cards.json")
    with open(path, "w") as f:
        json.dump({"card": card, "cards": cards, "spaces": results}, f)
    print(f"every rank's readings: {path}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
