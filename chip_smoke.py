#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``tti_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one printed line or block each; any failure raises and the script
exits non-zero without printing the final result line:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA mask-stats kernels from ``tti_torch/kernels/csrc`` into
   ``build/`` (nvcc), with the build time and ptxas' register report;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, plus edge cases (all rows invalid, a box reaching
   y2 == Hm, a bottom on the last row) and a small-logit case where the
   soft path's bf16 rounding shows (the plain version with float32 logits
   must fail that comparison);
4. deploy step: 960x1280 frames, imgsz 960, the stride-2 soft checkpoint,
   through ``InspectionPipeline.process_batch``; it must launch kernel A and
   agree with the same step run with the plain versions bound in the
   kernels' place;
5. headline step: 1080x1920 frames, imgsz 640, the stride-4 binary
   checkpoint, through kernel B, with the same checks;
6. timings: frames/s at batch 128 and the batch-1 p50 of both steps, and
   each kernel's time beside its plain version's and its bound, on the
   inputs the batch-128 step gives it and on a whole-grid synthetic input;
7. the ``kernels`` JSON line, then the final
   ``{"ok": true, "device": {...}}`` line.

Checks use seeded data only and need no network. Tolerances are stated
where they are applied.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# bench.py's deployment calibration (1280x960 sensor) and extrinsics.
K_960 = np.array([[937.1384518987244, 0.0, 636.148901113533],
                  [0.0, 884.022038878419, 422.3901781816556],
                  [0.0, 0.0, 1.0]])
DIST = np.array([0.07994929130530135, 0.04758675999900327, -0.04013555042332606,
                 -0.005228657034776396, -0.1334157094005971])
RVEC = np.array([-0.8631369244225452, -0.3919482615538663, -1.3591256137314185])
TVEC = np.array([0.005016396186926285, 0.03590342712705542, 0.09382141278570659])

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}  # dense bf16 tensor core; f32 FMA
BATCH = 128  # the production batch of both steps


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what: str) -> None:
    """A failed check ends the run (an assert would vanish under -O)."""
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def stats_problem(torch, b, hm, wm, d, seed, nm=32, coef_den=64):
    """Seeded inputs whose logits are exact in f32 in any summation order:
    protos k/128 (|k| <= 255, exact in bf16) and coefs j/coef_den
    (|j| <= 128, exact in bf16), so every partial sum is an integer
    multiple of 1/(128 coef_den) with magnitude below 2^20 such steps.
    Kernel and plain version then see identical logits, and only the soft
    path's sigmoid and float sums can differ. coef_den 64 gives |logit|
    around 5, where the sigmoid is flat; 512 gives |logit| around 0.65,
    where rounding the logits to bf16 moves p by up to about 1e-3."""
    rng = np.random.default_rng(seed)
    protos = rng.integers(-255, 256, size=(b, hm, wm, nm)) / 128.0
    coefs = rng.integers(-128, 129, size=(b, d, nm)) / coef_den
    x1 = rng.uniform(-4, wm - 4, (b, d))
    y1 = rng.uniform(-4, hm - 4, (b, d))
    boxes = np.stack([x1, y1, x1 + rng.uniform(2, wm / 3, (b, d)),
                      y1 + rng.uniform(2, hm / 3, (b, d))], -1)
    boxes[:, 0] = [-2.0, -1.0, wm + 3.0, hm + 5.0]  # fabric-like: whole grid
    boxes[:, 1] = [0.5, hm - 40.25, wm / 2, hm]  # reaches y2 == Hm
    valid = rng.uniform(size=(b, d)) > 0.2
    valid[:, :2] = True
    dev = "cuda"
    return (torch.tensor(protos, dtype=torch.bfloat16, device=dev),
            torch.tensor(coefs, dtype=torch.float32, device=dev),
            torch.tensor(boxes, dtype=torch.float32, device=dev),
            torch.tensor(valid, device=dev))


def field_errors(got: dict, ref: dict) -> dict[str, tuple[float, float]]:
    """Per key: max abs error and max error relative to max(1, |ref|)."""
    check(set(got) == set(ref), f"keys {sorted(got)} vs {sorted(ref)}")
    errs = {}
    for key in ref:
        a, r = got[key].float(), ref[key].float()
        check(a.shape == r.shape, f"{key}: shape {tuple(a.shape)} vs {tuple(r.shape)}")
        err = (a - r).abs()
        errs[key] = ((float(err.max()), float((err / r.abs().clamp(min=1.0)).max()))
                     if err.numel() else (0.0, 0.0))
    return errs


def compare(got: dict, ref: dict, exact: tuple, tol: float) -> tuple[float, float]:
    """Max abs and relative error over all fields. Keys in ``exact`` must
    match exactly; the others within ``tol`` relative (float sums taken in
    another order)."""
    worst_abs = worst_rel = 0.0
    for key, (abs_err, rel_err) in field_errors(got, ref).items():
        limit = 0.0 if key in exact else tol
        if rel_err > limit:
            raise AssertionError(f"{key}: max abs err {abs_err}, rel {rel_err} > {limit}")
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel_err)
    return worst_abs, worst_rel


BINARY_KEYS = ("m00", "m10", "m01", "col_any", "bottom")
SOFT_TOL = 1e-4


def check_kernels(torch, ms) -> dict:
    """Returns per-kernel {max_abs_err, max_rel_err} over every comparison."""
    errs = {"mask_stats_soft": [0.0, 0.0], "mask_stats_binary": [0.0, 0.0]}

    def run(name, args, label):
        soft = name == "mask_stats_soft"
        got = (ms.mask_stats_soft if soft else ms.mask_stats_binary)(*args)
        ref = (ms.mask_stats_soft_plain if soft else ms.mask_stats_binary_plain)(*args)
        torch.cuda.synchronize()
        # Binary fields are exact: the logits are identical, and the soft
        # path's occupancy test p >= 0.5 cannot flip (|logit| >= 2^-13 or 0).
        # Soft fields within 1e-4 relative: sums of sigmoids in another order.
        a, r = compare(got, ref, BINARY_KEYS, SOFT_TOL)
        errs[name][0] = max(errs[name][0], a)
        errs[name][1] = max(errs[name][1], r)
        log(f"  {name} {label}: max abs err {a:.3g}, max rel err {r:.3g}")
        return got

    run("mask_stats_soft", stats_problem(torch, 8, 368, 480, 64, 1), "(8,368,480,32) bf16 D=64")
    # The dtype policy: with small logits, bf16 rounding moves p by up to
    # about 1e-3, so a kernel that kept float32 logits would fail here. The
    # plain version with float32 logits must fail the same comparison.
    small = stats_problem(torch, 8, 368, 480, 64, 6, coef_den=512)
    got = run("mask_stats_soft", small, "(8,368,480,32) bf16 D=64, small logits")
    f32_err = max(r for key, (_, r) in field_errors(
        got, ms.mask_stats_soft_plain(*small, logits_dtype=torch.float32)).items()
        if key not in BINARY_KEYS)
    check(f32_err > SOFT_TOL, f"soft: float32 logits pass the bf16 comparison ({f32_err})")
    log(f"  mask_stats_soft small logits against the plain version with float32 logits: "
        f"max rel err {f32_err:.3g} > {SOFT_TOL} (the check separates the two precisions)")
    run("mask_stats_binary", stats_problem(torch, 8, 96, 160, 64, 2), "(8,96,160,32) bf16 D=64")
    run("mask_stats_binary", stats_problem(torch, 8, 96, 160, 200, 3), "(8,96,160,32) bf16 D=200")
    protos, coefs, boxes, valid = stats_problem(torch, 2, 40, 48, 16, 4)
    f32 = (protos.float(), coefs, boxes, valid)
    run("mask_stats_binary", f32, "f32 protos")
    for name in ("mask_stats_soft", "mask_stats_binary"):
        out = run(name, (protos, coefs, boxes, torch.zeros_like(valid)), "all rows invalid")
        check(float(out["m00"].abs().sum()) == 0.0 and bool((out["bottom"] == -1).all()),
              f"{name}: invalid rows must read empty")
        if name == "mask_stats_soft":
            check(float(out["m00s"].abs().sum()) == 0.0 and bool((out["bottom_sub"] == -1).all()),
                  "soft: invalid rows must read empty")
        # Every cell positive, the box reaching y2 == Hm: the bottom is the
        # last row and nothing below it is read (p_below = 0).
        pos = (torch.ones_like(protos) / 128, torch.ones_like(coefs) / 64)
        full = torch.tensor([[[0.0, 30.0, 48.0, 40.0]] * 16] * 2, device="cuda")
        out = run(name, (*pos, full, torch.ones_like(valid)), "bottom on the last row")
        check(bool((out["bottom"] == 39).all()), f"{name}: bottom must be the last row")
        if name == "mask_stats_soft":
            p = torch.sigmoid(torch.tensor(32 / 8192, device="cuda"))
            # 1e-5: one float32 step at 39 is 3.8e-6.
            check(torch.allclose(out["bottom_sub"], 39 + (p - 0.5) / p, atol=1e-5),
                  "soft: last-row bottom_sub must read p_below = 0")
    return {k: {"max_abs_err": v[0], "max_rel_err": v[1]} for k, v in errs.items()}


def time_ms(torch, fn, iters: int = 20, flush=None) -> float:
    """Mean device ms per call with CUDA events, after a warm-up call.
    ``flush`` (outside the timed window) evicts L2 before each call. A spin
    kernel (about 0.5 ms) then holds the stream while the host enqueues the
    call, so the window holds the device's time and not the wrapper's host
    time."""
    fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def kernel_bound_ms(torch, soft: bool, protos, coefs, boxes, valid) -> tuple[float, str, dict]:
    """Least time for this input: bytes (the protos cells that some valid box
    covers, read once, plus the other inputs and the outputs written once)
    over 3.35 TB/s, against the dot products' operations (2*nm per covered
    cell per detection) over the peak for their type (bf16 logits: tensor
    cores; f32 logits: f32 FMA)."""
    b, hm, wm, nm = protos.shape
    ys = torch.arange(hm, device="cuda").view(1, 1, hm, 1).float()
    xs = torch.arange(wm, device="cuda").view(1, 1, 1, wm).float()
    bx = lambda i: boxes[..., i, None, None]
    inside = ((xs >= bx(0)) & (xs < bx(2)) & (ys >= bx(1)) & (ys < bx(3))
              & valid[..., None, None])
    covered = int(inside.any(1).sum())
    cell_dets = int(inside.sum())
    d = coefs.shape[1]
    out_bytes = b * d * 4 * ((6 + 4 * wm) if soft else (3 + 2 * wm))
    in_bytes = covered * nm * protos.element_size() + coefs.numel() * 4 + boxes.numel() * 4 + valid.numel()
    nbytes = in_bytes + out_bytes
    ops = 2.0 * nm * cell_dets
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS["bf16" if soft else "f32"] * 1e3
    info = {"bytes": nbytes, "ops": ops}
    return (t_bytes, "bytes", info) if t_bytes >= t_ops else (t_ops, "operations", info)


def time_kernel(torch, ms, name, args, flush) -> dict:
    """One kernel against its plain version and its logits einsum alone,
    on ``args``, with the bound of this input."""
    soft = name == "mask_stats_soft"
    kern = ms.mask_stats_soft if soft else ms.mask_stats_binary
    plain = ms.mask_stats_soft_plain if soft else ms.mask_stats_binary_plain
    logits_dtype = torch.bfloat16 if soft else torch.float32
    with torch.inference_mode():
        t_k = time_ms(torch, lambda: kern(*args), flush=flush)
        t_p = time_ms(torch, lambda: plain(*args), flush=flush)
        t_e = time_ms(torch, lambda: ms._logits(args[0], args[1], logits_dtype), flush=flush)
        bound, bound_by, info = kernel_bound_ms(torch, soft, *args)
    return {"ms": t_k, "plain_ms": t_p, "einsum_ms": t_e, "bound_ms": bound,
            "bound_by": bound_by, "shape": list(args[0].shape), "d": args[1].shape[1], **info}


def log_kernel_time(name, label, t) -> None:
    log(f"  {name} on {label}, protos {tuple(t['shape'])}, D={t['d']}: kernel {t['ms']:.4f} ms, "
        f"plain {t['plain_ms']:.4f} ms, logits einsum alone {t['einsum_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['bytes'] / 1e6:.2f} MB, "
        f"{t['ops'] / 1e9:.3f} GFLOP)")


@contextlib.contextmanager
def stats_route(soft_fn, binary_fn):
    """Bind ``soft_fn``/``binary_fn`` where the measurement pass calls the
    mask-stats kernels, for the duration of the block."""
    import tti_torch.measure.pipeline as mp

    saved = mp.mask_stats_soft, mp.mask_stats_binary
    mp.mask_stats_soft, mp.mask_stats_binary = soft_fn, binary_fn
    try:
        yield
    finally:
        mp.mask_stats_soft, mp.mask_stats_binary = saved


def capture_stats_inputs(ms, pipe, frames) -> tuple:
    """The (protos, coefs, boxes_grid, valid) one step hands its kernel."""
    seen = []

    def recorder(fn):
        def wrapped(*args, **kwargs):
            seen.append(args)
            return fn(*args, **kwargs)
        return wrapped

    with stats_route(recorder(ms.mask_stats_soft), recorder(ms.mask_stats_binary)):
        pipe.step(frames)
    check(len(seen) == 1, f"one mask-stats call per step expected, got {len(seen)}")
    return seen[0]


# ---------------------------------------------------------------------------
# Phases 4-5: the inspection step
# ---------------------------------------------------------------------------


def build_pipeline(torch, frame_hw, imgsz, ckpt):
    from tti_torch.calib.io import CalibrationData
    from tti_torch.core.config import MeasureConfig, ModelConfig, RoiConfig
    from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
    from tti_torch.parallel.runtime import InspectionPipeline

    path = os.path.join(HERE, "checkpoints", ckpt)
    meta = checkpoint_metadata(path)
    h, w = frame_hw
    K = K_960.copy()
    K[0] *= w / 1280.0
    K[1] *= h / 960.0
    cfg = ModelConfig(variant=meta.get("variant", "n"), num_classes=meta.get("num_classes", 2),
                      image_size=imgsz, dtype="bfloat16",
                      mask_stride=meta.get("mask_stride", 4),
                      proto_head=meta.get("proto_head", "deconv"))
    return InspectionPipeline(
        cfg, load_flax_msgpack(path), frame_hw,
        calibration=CalibrationData(K=K, dist=DIST, rvec=RVEC, tvec=TVEC),
        measure_cfg=MeasureConfig().with_subcell_from(meta),
        roi=RoiConfig(enabled=True, x_min=10, x_max=w - 10, y_min=min(300, h // 3),
                      y_max=h - min(200, h // 5)),
        device="cuda")


def check_step(torch, ms, label, frame_hw, imgsz, ckpt, kernel):
    from torch_synth import textile_frames

    t0 = time.perf_counter()
    pipe = build_pipeline(torch, frame_hw, imgsz, ckpt)
    setup_s = time.perf_counter() - t0
    frames = textile_frames(4, *frame_hw, seed=5)
    ms.reset_launch_counts()
    got = pipe.process_batch(frames)
    launches = dict(ms.LAUNCHES)
    if launches[kernel] < 1:
        raise AssertionError(f"{label}: the step never launched {kernel}: {launches}")
    with stats_route(ms.mask_stats_soft_plain, ms.mask_stats_binary_plain):
        ref = pipe.process_batch(frames)

    # Same model run: detections are identical. Measurements within 0.01 mm
    # (the statistics sum in another order), counts and NaN pattern equal.
    for key in ("boxes_frame", "scores", "classes", "valid"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key), err_msg=key)
    m_err = 0.0
    for key in ("raw_edge_mm", "raw_width_mm", "n_dist", "n_width", "n_stitches",
                "fabric_detected"):
        a, r = getattr(got.measurements, key), getattr(ref.measurements, key)
        np.testing.assert_array_equal(np.isnan(a.astype(float)), np.isnan(r.astype(float)),
                                      err_msg=key)
        np.testing.assert_allclose(a.astype(float), r.astype(float), atol=1e-2, err_msg=key)
        both = ~np.isnan(a.astype(float))
        if both.any():
            m_err = max(m_err, float(np.abs(a[both].astype(float) - r[both].astype(float)).max()))
    env_err = float(np.abs(got.envelope.astype(float) - ref.envelope.astype(float)).max())
    if env_err > 1e-3:
        raise AssertionError(f"{label}: envelope differs from the plain step by {env_err}")
    # Shapes and finiteness: detections always finite; a measurement is
    # either finite or NaN (absent), never infinite.
    b = frames.shape[0]
    check(got.boxes_frame.shape == (b, pipe.model_cfg.max_detections, 4), "boxes shape")
    check(np.isfinite(got.boxes_frame).all() and np.isfinite(got.scores).all(),
          "boxes and scores must be finite")
    for key in ("raw_edge_mm", "raw_width_mm"):
        check(not np.isinf(getattr(got.measurements, key)).any(), f"{key} is infinite")
    sv = got.stitches.valid
    for key in ("cx", "cy", "left", "right"):
        check(np.isfinite(getattr(got.stitches, key)[sv]).all(), f"stitch {key} not finite")
    if not got.valid.any():
        raise AssertionError(f"{label}: no detections on the synthetic frames")
    log(f"{label}: pipeline set-up {setup_s:.1f} s; {launches[kernel]} launch(es) of {kernel} "
        f"per step; detections/frame {got.valid.sum(1).tolist()}; stitches/frame "
        f"{got.measurements.n_stitches.tolist()}; edge mm {np.round(got.measurements.raw_edge_mm, 4).tolist()}; "
        f"width mm {np.round(got.measurements.raw_width_mm, 4).tolist()}; "
        f"max |kernel - plain| over mm {m_err:.3g}, envelope {env_err:.3g}")
    return pipe, launches[kernel]


STAGES = ("preprocess", "forward", "detect", "measure")


def breakdown(torch, pipe, label, frames, step_ms):
    """Where one batch's step goes: stream time per stage (CUDA events
    between the stages, so device idle while the host enqueues counts to the
    stage that waits), then the profiler's device time by kernel name and the
    device's idle share of the unprofiled step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    iters = 5
    totals = dict.fromkeys(STAGES, 0.0)
    with torch.inference_mode():
        for _ in range(iters):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(STAGES) + 1)]
            ev[0].record()
            x = pipe.preprocess(frames)
            ev[1].record()
            raw = pipe.model(x)
            ev[2].record()
            dets, _ = pipe.detect(raw)
            ev[3].record()
            pipe.measure(dets, raw.protos)
            ev[4].record()
            ev[4].synchronize()
            for i, stage in enumerate(STAGES):
                totals[stage] += ev[i].elapsed_time(ev[i + 1]) / iters
    staged = sum(totals.values())
    log(f"{label} stages at batch {frames.shape[0]} (ms per step, share): " + ", ".join(
        f"{s} {t:.3f} ({t / staged:.1%})" for s, t in totals.items()))

    steps = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            pipe.step(frames)
        torch.cuda.synchronize()
    per_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
            spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        log(f"{label} profiler: no device events recorded")
        return {"stages_ms": totals, "busy_ms": None, "idle_share": None}
    spans.sort()
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3 / steps
    idle = 1.0 - busy / step_ms
    log(f"{label} profiler: {len(spans) // steps} device ops per step, busy {busy:.3f} ms of "
        f"a {step_ms:.3f} ms step (idle share {idle:.1%}); top kernels:")
    for name, t in sorted(per_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {t:8.3f} ms {t / busy:6.1%}  {name[:110]}")
    soft_or_binary = sum(t for n, t in per_name.items() if "mask_stats_kernel" in n)
    log(f"{label} mask-stats kernel: {soft_or_binary:.3f} ms per step ({soft_or_binary / busy:.1%} of busy)")
    return {"stages_ms": totals, "busy_ms": busy, "idle_share": idle,
            "mask_stats_ms": soft_or_binary}


def time_step(torch, ms, pipe, label, frame_hw):
    """Step timings and breakdowns; also returns the mask-stats inputs of
    one batch-128 step."""
    from torch_synth import textile_frames

    batch = BATCH
    base = torch.from_numpy(textile_frames(8, *frame_hw, seed=9)).cuda()
    frames = base.repeat((batch + 7) // 8, 1, 1, 1)[:batch].contiguous()
    pipe.step(frames)
    torch.cuda.synchronize()
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        pipe.step(frames)
    torch.cuda.synchronize()
    fps = batch * iters / (time.perf_counter() - t0)
    one = frames[:1].contiguous()
    pipe.step(one)
    torch.cuda.synchronize()
    lats = []
    for _ in range(50):
        t = time.perf_counter()
        pipe.step(one)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t)
    p50 = 1e3 * float(np.median(lats))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"{label}: {fps:.1f} frames/s at batch {batch} ({iters} steps, device-resident "
        f"frames); batch-1 p50 {p50:.3f} ms; peak device memory {peak_gb:.1f} GB")
    parts = breakdown(torch, pipe, label, frames, 1e3 * batch / fps)
    one_parts = breakdown(torch, pipe, f"{label} batch-1", one, p50)
    stats_args = capture_stats_inputs(ms, pipe, frames)
    return {"frames_per_s": fps, "batch": batch, "p50_ms": p50, "at_batch": parts,
            "at_batch_1": one_parts}, stats_args


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.append(os.path.join(HERE, "tests"))
    from tti_torch.kernels import maskstats as ms

    # Phase 1: the card.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Phase 2: build.
    t0 = time.perf_counter()
    ms.build()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for line in ms.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # Phase 3: kernels against their plain versions.
    log("kernel checks against the plain versions:")
    errs = check_kernels(torch, ms)

    # Phases 4-5: the two configurations through process_batch; each step's
    # own kernel inputs at batch 128 are kept for phase 6.
    dep, dep_launches = check_step(torch, ms, "deploy step (960x1280, imgsz 960, stride-2 soft)",
                                   (960, 1280), 960, "yolov8n_textile_cam.msgpack",
                                   "mask_stats_soft")
    dep_time, dep_args = time_step(torch, ms, dep, "deploy", (960, 1280))
    del dep
    torch.cuda.empty_cache()
    head, head_launches = check_step(torch, ms,
                                     "headline step (1080x1920, imgsz 640, stride-4 binary)",
                                     (1080, 1920), 640, "yolov8n_textile.msgpack",
                                     "mask_stats_binary")
    head_time, head_args = time_step(torch, ms, head, "headline", (1080, 1920))
    del head
    torch.cuda.empty_cache()

    # Phase 6: kernel timings, on each step's own inputs (the kernels line)
    # and on a synthetic input whose first box covers the whole grid.
    log("kernel timings (CUDA events, L2 flushed before each call):")
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: flush_buf.zero_()
    launches = {"mask_stats_soft": dep_launches, "mask_stats_binary": head_launches}
    replaces = {"mask_stats_soft": "tti/kernels/maskstats.py:454",
                "mask_stats_binary": "tti/kernels/maskstats.py:261"}
    step_inputs = {"mask_stats_soft": ("the deploy step's inputs", dep_args),
                   "mask_stats_binary": ("the headline step's inputs", head_args)}
    whole_grid = {"mask_stats_soft": (8, 368, 480, 64), "mask_stats_binary": (8, 96, 160, 64)}
    kernels = []
    for name in ("mask_stats_soft", "mask_stats_binary"):
        label, args = step_inputs[name]
        t = time_kernel(torch, ms, name, args, flush)
        log_kernel_time(name, label, t)
        g = time_kernel(torch, ms, name, stats_problem(torch, *whole_grid[name], seed=11), flush)
        log_kernel_time(name, "a whole-grid synthetic input", g)
        kernels.append({
            "name": name, "route": "cuda", "source": "tti_torch/kernels/csrc/maskstats.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": errs[name]["max_abs_err"], "max_rel_err": errs[name]["max_rel_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "einsum_ms": t["einsum_ms"],
            "timed_on": label, "timed_shape": t["shape"], "timed_d": t["d"],
            "whole_grid": {k: g[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape")},
        })
    del dep_args, head_args
    log(json.dumps({"steps": {"deploy": dep_time, "headline": head_time}}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
