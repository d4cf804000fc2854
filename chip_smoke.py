#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``tti_torch``) on one CUDA card.

    python3 chip_smoke.py [--first-design PATH] [--ablate]

``--first-design`` names a copy of the first design of ``maskstats.cu`` (the
file as the commit that added the port's measurement path had it); it is
built beside the current kernels and timed on the same inputs in phase 9,
before and after them. Nothing else uses it. ``--ablate`` runs phases 1-2
and then only :func:`ablate`: variants of ``maskstats.cu`` that leave one
part of the design out or tune it otherwise, timed on synthetic inputs
shaped like the steps' (what each part costs or buys).

Phases, one printed line or block each; any failure raises and the script
exits non-zero without printing the final result line:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``tti_torch/kernels/csrc`` (mask statistics,
   warp pass 1) into ``build/``, one nvcc process each, started together,
   and the C++ frame ring (g++), with the build time and ptxas' register
   report;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, plus edge cases. Mask statistics: all rows invalid, a
   box reaching y2 == Hm, a bottom on the last row, a small-logit case
   where the soft path's bf16 rounding shows (the plain version with float32
   logits must fail that comparison), the carries at the kernel's own chunk
   height (a bottom on a chunk's last and first row, on the box's last row,
   one-row boxes, a box over every chunk), boxes over the whole grid at both
   main-path shapes with 8 of 200 detections valid, and every comparison
   launched twice with bit-equal outputs. Warp pass 1: the headline shape at
   batch 128 and 1 with the headline warp's own weights, a k = 5 geometry,
   dense weights j/64, a frame holding every byte value on which the plain
   version that divides by 255 must fail, and the stride-k select alone
   (identity weights, bytes 0 or 255) at k = 3 and k = 5;
4. deploy step: 960x1280 frames, imgsz 960, the stride-2 soft checkpoint,
   through ``InspectionPipeline.process_batch``; it must launch kernel A and
   agree with the same step run with the plain versions bound in the
   kernels' place; then one ``step`` on device-resident frames at batch 128
   and at batch 1 under ``torch.cuda.set_sync_debug_mode("warn")`` must make
   at most one synchronising call (the NMS block check; the count and the
   NMS sweeps to the fixed point are printed);
5. headline step: 1080x1920 frames, imgsz 640, the stride-4 binary
   checkpoint, through kernel B, with the same checks (the synchronising
   calls too, also on the kernel route's step); then the same step
   with ``warp_pass1="kernel"`` at batch 128 (kernels C and B, once per step
   each), against the plain versions and against the "einsum" step; the
   packed-remap step against the two-pass step; the dual step (two
   checkpoints, one preprocess) against each model's own pipeline; four
   1080p streams through ``MultiStreamRunner`` (blocking and pipelined);
6. training (``tti_torch.train``, seeded synthetic scenes from
   ``tests/torch_scenes.py``): one float32 step at imgsz 64 on the card
   against the same step on the CPU; the deployed recipe r5s at full width
   (YOLOv8n-seg, imgsz 960, mask stride 2, sub-pixel protos, soft masks,
   stitch seg gain 2.0, max_gt 16, batch 8, bf16, initialised from the
   deploy checkpoint, 32 scenes on the device): 30 augmented steps with
   finite losses, 30 steps on one fixed batch with a falling loss, where
   bf16 stops (no op below float32 in the loss, with a control that puts
   the seg loss in bf16 and must be flagged) and the bf16 first-step loss
   terms against float32 on 4 batches, and save at step 10 + restore +
   5 steps equal to 15 uninterrupted steps bit for bit; the EMA exported
   with ``python -m tti_torch.cli export-weights`` and served by the deploy
   step (kernel A, against the plain versions); the headline geometry
   from scratch (imgsz 640, mask stride 4, binary masks, batch 64, bf16,
   10 steps); and, at both recipes, images/s, ms per step, peak memory and
   the device's idle share of the trainer's own loop (``train_step``, one
   synchronisation per window), then per-part iteration times in a
   separate loop;
7. the application at the deployed geometry (960x1280 frames, imgsz 960,
   the cam checkpoint, bf16, through the CLI's ``load_pipeline``): 32 seeded
   textile frames through the ``Orchestrator``'s own loop at inference
   interval 0, blocking and then pipelined, each with a sqlite database
   under ``build/app_smoke/``, ``SerialReader`` on a scripted counter (5
   stitches per frame) and ``random.Random(0)``: 32 frames each, kernel A
   once per frame, rows = inserts + the daily-reset row, the pipelined
   readings equal to the blocking ones (its stitch deltas and inserts one
   tick earlier, as its lag makes them), and the same frames with the plain
   statistics bound in the kernels' place give the same valid/inserted
   sequence and seam/width within 0.01 mm; one annotated JPEG per frame
   where OpenCV imports (none where it does not); frames/s, the stage timer,
   the host ms of fusion and of drawing and saving the annotated frame. Then
   ``python -m tti_torch.cli run --synthetic --max-frames 2
   --skip-calibration`` and ``--cameras 4`` in subprocesses (exit 0, two
   measurement records; eight stream records), from a directory holding a
   .env and the calibration files. Then ``tti eval``'s loop
   (``evaluate_samples``) with ``Predictor`` at the deployed recipe over 16
   seeded scenes in chunks of 8: box and mask mAP, images/s, the host
   seconds of ``evaluate``; bf16 against float32 on the card (median mask
   IoU >= 0.999) and the card's float32 against the CPU's on 2 scenes
   (boxes within 1e-2 px, mask IoU >= 0.999);
8. calibrate, then measure, at the deployed geometry: a ChArUco board
   lying on the fabric plane, seen by the deployment camera (the board's
   texture sampled at every pixel's plane point, so the view carries the
   lens distortion), through ``run_startup_calibration`` on a
   ``DirectorySource`` of three such views: the extrinsics file written, the
   recovered translation within 0.5 mm and rotation within 0.1 degree of the
   truth, and solver "cv2" within 1e-3 mm / 1e-4 rad of "tti"; then
   ``python -m tti_torch.cli calibrate-intrinsics --images`` on 8 views at
   several poses (exit 0, an rms printed); then the first 16 seed-0 scenes
   of ``tools/measure_report_torch.py`` through the deploy step in float32
   and bf16, with the true and with the recovered extrinsics: kernel A once
   per step, ``tests/test_measure_report.py``'s per-frame gate (every width
   finite, stitches >= min(truth, 3), an edge on most frames, edge error
   < 1.0 mm, width error < 0.8 mm), recovered against true within 0.05 mm
   per frame, kernel A against its plain version within 0.01 mm; coverage,
   p50, p95 and bias printed;
9. timings: frames/s at batch 128 and the batch-1 p50 of the steps, the
   stages, and each kernel's time beside its plain version's and its bound,
   on the inputs the batch-128 step gives it;
10. the ``kernels`` JSON line, then the final
   ``{"ok": true, "device": {...}}`` line.

Checks use seeded data only and need no network. Tolerances are stated
where they are applied.
"""

from __future__ import annotations

import contextlib
import glob
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
BF16_STEP = 2.0 ** -8  # one bfloat16 step, relative


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


def carry_problem(torch, hm, wm, chunk, seed=21):
    """Four frames whose occupancy is set by the row: channel 0 of the protos
    is +1 down to row r and -0.5 under it, channel 1 a small per-cell term,
    and detections 0-6 read just those two, so their bottom is r wherever
    their box reaches it. r is a chunk's last row, a chunk's first row, the
    grid's last row, and a chunk's last row again. Boxes: 0 over the whole
    grid (every chunk), 1 ending on row r, 2 row r alone, 3 the first row
    alone, 4 the last row alone and past the grid, 5 the chunk under r
    (nothing occupied), 6 from the middle of a chunk; 7 is random. Returns
    the inputs and the r of each frame. The logits are exact (1 + k/128)."""
    rng = np.random.default_rng(seed)
    rs = [3 * chunk - 1, 3 * chunk, hm - 1, 5 * chunk - 1]
    b, d = len(rs), 8
    protos = rng.integers(-255, 256, size=(b, hm, wm, 32)) / 128.0
    protos[..., 1] = rng.integers(-8, 9, size=(b, hm, wm)) / 128.0
    coefs = rng.integers(-128, 129, size=(b, d, 32)) / 64.0
    coefs[:, :7] = 0.0
    coefs[:, :7, :2] = 1.0
    boxes = np.zeros((b, d, 4))
    for i, r in enumerate(rs):
        protos[i, :, :, 0] = np.where(np.arange(hm) <= r, 1.0, -0.5)[:, None]
        rows = [(-1.0, hm + 2.0), (2.5, r + 1.0), (r, r + 1.0), (0.0, 1.0), (hm - 1.0, hm + 3.0),
                (r + 1.0, r + 1.0 + chunk), (r - 1.5, r + 2.2), (hm * 0.2, hm * 0.7)]
        boxes[i] = [[3.5, y1, wm - 2.5, y2] for y1, y2 in rows]
    dev = "cuda"
    return (torch.tensor(protos, dtype=torch.bfloat16, device=dev),
            torch.tensor(coefs, dtype=torch.float32, device=dev),
            torch.tensor(boxes, dtype=torch.float32, device=dev),
            torch.ones((b, d), dtype=torch.bool, device=dev)), rs


def whole_grid_problem(torch, b, hm, wm, seed):
    """D = 200 with 8 valid detections per frame, each box over the whole grid."""
    protos, coefs, boxes, valid = stats_problem(torch, b, hm, wm, 200, seed)
    boxes[:] = torch.tensor([-2.0, -1.0, wm + 3.0, hm + 5.0], device="cuda")
    valid[:] = False
    valid[:, 3:11] = True
    return protos, coefs, boxes, valid


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
        # No float atomics: a second launch gives the same bits.
        again = (ms.mask_stats_soft if soft else ms.mask_stats_binary)(*args)
        torch.cuda.synchronize()
        for key in got:
            check(torch.equal(got[key], again[key]), f"{name} {label}: {key} differs between two launches")
        log(f"  {name} {label}: max abs err {a:.3g}, max rel err {r:.3g}; two launches bit-equal")
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

    # The carries across chunks, at each kernel's own chunk height.
    for name, (hm, wm) in (("mask_stats_soft", (368, 480)), ("mask_stats_binary", (96, 160))):
        chunk = ms.CHUNK_ROWS[name]
        args, rs = carry_problem(torch, hm, wm, chunk)
        out = run(name, args, f"carries at chunk height {chunk}, grid {hm}x{wm}, bottoms at rows {rs}")
        cols = slice(4, wm - 3)  # the columns of every box
        for i, r in enumerate(rs):
            for det in (0, 1, 2, 6):
                check(bool((out["bottom"][i, det, cols] == r).all()),
                      f"{name}: frame {i} detection {det}: bottom must be row {r}")
            check(bool((out["bottom"][i, 5] == -1).all()),
                  f"{name}: frame {i}: the chunk under row {r} must read empty")
            check(bool((out["bottom"][i, 3, cols] == 0).all())
                  and bool((out["bottom"][i, 4, cols] == (hm - 1 if r == hm - 1 else -1)).all()),
                  f"{name}: frame {i}: one-row boxes on the first and the last row")
            if name == "mask_stats_soft" and r < hm - 1:
                # Box 0 reads the row under r (0 < frac < 1); box 1 ends on r (p_below = 0).
                frac0 = out["bottom_sub"][i, 0, cols] - r
                frac1 = out["bottom_sub"][i, 1, cols] - r
                check(bool(((frac0 > 0.5) & (frac0 < 0.99)).all()) and bool((frac1 < frac0).all()),
                      f"soft: frame {i}: p_below across the chunk boundary under row {r}")
    run("mask_stats_soft", whole_grid_problem(torch, 4, 368, 480, 12),
        "(4,368,480,32) D=200, 8 valid, every box over the whole grid")
    run("mask_stats_binary", whole_grid_problem(torch, 4, 96, 160, 13),
        "(4,96,160,32) D=200, 8 valid, every box over the whole grid")
    protos, coefs, boxes, valid = stats_problem(torch, 4, 368, 480, 200, 14)
    valid[:, 8:] = False
    run("mask_stats_soft", (protos, coefs, boxes, valid), "(4,368,480,32) D=200, 8 valid")
    return {k: {"max_abs_err": v[0], "max_rel_err": v[1]} for k, v in errs.items()}


def p1_errors(got, ref) -> tuple[float, float, int]:
    """Max abs error, max error relative to max(|ref|, 1/16), and how many
    elements differ at all."""
    d = (got.float() - ref.float()).abs()
    rel = d / ref.float().abs().clamp(min=2.0 ** -4)
    return float(d.max()), float(rel.max()), int((d > 0).sum())


def p1_plain_dividing(torch, frames, w1, k, off, hs, ws, pad_value):
    """The plain version with the unfused chain's normalisation: it divides
    by 255 where the kernel multiplies by 1/255. Only to show that the
    comparison tells the two apart."""
    wdt = w1.dtype
    small = frames[:, off::k, off::k, :][:, :hs, :ws, :].flip(-1)
    x = small.to(wdt) / torch.tensor(255.0, dtype=wdt) - torch.tensor(pad_value, dtype=wdt)
    return torch.einsum("bywc,ywo->ycbo", x.float(), w1.float()).to(wdt)


def k5_warp(torch):
    """A 480x480 frame at imgsz 96: an exact decimation by 5."""
    from tti_torch.preprocess.letterbox import decimation_stride, letterbox_spec
    from tti_torch.preprocess.remap import build_small_undistort_map
    from tti_torch.preprocess.warp2pass import TwoPassWarp

    spec = letterbox_spec(480, 480, 96)
    check(decimation_stride(spec) == 5, "480 px at imgsz 96 must decimate by 5")
    K = K_960.copy()
    K[0] *= 480 / 1280.0
    K[1] *= 480 / 960.0
    small_map = build_small_undistort_map(K, DIST, spec, unpadded_src=True)
    return spec, TwoPassWarp(small_map, (spec.new_h, spec.new_w), device="cuda")


def check_warp_p1(torch, wp, warp, spec) -> dict:
    """Kernel C against its plain version in bf16 on the card. ``warp`` and
    ``spec`` are the headline pipeline's. The limit is one bf16 step (2^-8)
    relative to max(|ref|, 1/16): the sum rounds once to bf16, and a float32
    sum taken in another order can fall on the other side of a rounding
    boundary. With the warp's own weights an output is a sum of at most two
    non-zero products, whose order cannot matter: equality is expected, and
    the count of differing elements is printed."""
    worst = [0.0, 0.0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    rand = lambda *shape: torch.randint(0, 256, (*shape, 3), dtype=torch.uint8, device="cuda",
                                        generator=gen)

    def run(label, frames, w1, kw):
        got = wp.warp_pass1_decimated(frames, w1, **kw)
        ref = wp.warp_pass1_decimated_plain(frames, w1, **kw)
        torch.cuda.synchronize()
        want_shape = (kw["hs"], 3, frames.shape[0], w1.shape[2])
        check(tuple(got.shape) == want_shape and got.dtype == w1.dtype,
              f"warp_pass1_decimated {label}: {tuple(got.shape)} {got.dtype}, expected {want_shape}")
        a, r, ndiff = p1_errors(got, ref)
        check(r <= BF16_STEP, f"warp_pass1_decimated {label}: max rel err {r} > {BF16_STEP}")
        worst[0], worst[1] = max(worst[0], a), max(worst[1], r)
        log(f"  warp_pass1_decimated {label}: max abs err {a:.3g}, max rel err {r:.3g}, "
            f"{ndiff} of {got.numel()} elements differ")
        return got

    head = dict(k=3, off=1, hs=spec.new_h, ws=spec.new_w, pad_value=warp.pad_value)
    check((head["hs"], head["ws"], warp.w1.shape[2]) == (360, 640, 640),
          f"headline pass-1 shape {tuple(warp.w1.shape)}")
    run("headline B=128, the warp's own W1", rand(BATCH, 1080, 1920), warp.w1, head)
    run("headline B=1, the warp's own W1", rand(1, 1080, 1920), warp.w1, head)
    spec5, warp5 = k5_warp(torch)
    kw5 = dict(k=5, off=2, hs=spec5.new_h, ws=spec5.new_w, pad_value=warp5.pad_value)
    run("k=5 (480x480, imgsz 96) B=5", rand(5, 480, 480), warp5.w1, kw5)
    dense = (torch.randint(-64, 65, tuple(warp.w1.shape), device="cuda", generator=gen).float()
             / 64).to(torch.bfloat16)
    run("headline B=128, dense W1 of values j/64", rand(BATCH, 1080, 1920), dense, head)
    del dense

    # The rounding rule: on a frame that holds every byte value the plain
    # version that divides by 255 must fail the comparison the kernel passes.
    ar = lambda n, shape: torch.arange(n, device="cuda").view(shape)
    every = ((ar(1920, (1, 1, -1, 1)) + 7 * ar(1080, (1, -1, 1, 1)) + 31 * ar(3, (1, 1, 1, -1))
              + 13 * ar(4, (-1, 1, 1, 1))) % 256).to(torch.uint8)
    got = run("headline B=4, every byte value", every, warp.w1, head)
    _, div_err, div_n = p1_errors(got, p1_plain_dividing(torch, every, warp.w1, **head))
    check(div_err > BF16_STEP, f"dividing by 255 passes the kernel's comparison ({div_err})")
    log(f"  warp_pass1_decimated against the plain version that divides by 255: max rel err "
        f"{div_err:.3g} > {BF16_STEP:.3g}, {div_n} elements differ (the check separates the two)")

    # The stride-k select by itself (the operation the TPU probes could not
    # lower): identity weights, pad 0, bytes 0 or 255. The output is then 0
    # or the one constant bf16(255) * bf16(1/255), at exactly the selected
    # positions and channels.
    one = torch.tensor(255.0, dtype=torch.bfloat16) * torch.tensor(1 / 255, dtype=torch.bfloat16)
    for k, b, h, w, hs, ws in ((3, 4, 1080, 1920, 360, 640), (5, 3, 480, 480, 96, 96)):
        off = (k - 1) // 2
        frames = rand(b, h, w) // 128 * 255
        eye = torch.eye(ws, dtype=torch.bfloat16, device="cuda").expand(hs, ws, ws).contiguous()
        got = wp.warp_pass1_decimated(frames, eye, k=k, off=off, hs=hs, ws=ws, pad_value=0.0)
        sel = frames[:, off::k, off::k, :][:, :hs, :ws, :].flip(-1).permute(1, 3, 0, 2)
        want = torch.where(sel == 255, one.to("cuda"), torch.zeros((), dtype=torch.bfloat16,
                                                                   device="cuda"))
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"stride-{k} select: kernel differs from frames[:, off::k, off::k, ::-1]")
        log(f"  stride-{k} select alone ({b}x{h}x{w} -> {hs}x{ws}, identity W1): equal to "
            f"frames[:, {off}::{k}, {off}::{k}, ::-1]; {int((got != 0).sum())} of {got.numel()} "
            f"outputs are the constant {float(one):g}")
    return {"max_abs_err": worst[0], "max_rel_err": worst[1], "dividing_rel_err": div_err}


def time_ms(torch, fn, iters: int = 20, flush=None) -> float:
    """Mean device ms per call with CUDA events, after a warm-up call.
    ``flush`` (outside the timed window) evicts L2 before each call. A spin
    kernel (about 0.5 ms) then holds the stream while the host enqueues the
    call, so the window holds the device's time and not the wrapper's host
    time. Python's garbage collector is off in the loop: once the training
    phase has filled the heap, a collection outlasts the spin and its host
    time would fall into a window."""
    import gc

    fn()
    gc.collect()
    gc.disable()
    try:
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
    finally:
        gc.enable()
    return total / iters


def kernel_bound_ms(torch, name: str, *args) -> tuple[float, str, dict]:
    """Least time for this input: the bytes the function must move (each
    input read once, each output written once) over 3.35 TB/s, against its
    operations over the peak for their type.

    Mask statistics (protos, coefs, boxes, valid): the protos cells that some
    valid box covers plus the other inputs and the outputs; 2*nm operations
    per covered cell per detection (bf16 logits: tensor cores; f32 logits:
    f32 FMA). Warp pass 1 (frames, w1, kw): of every kept source row the
    32-byte sectors that hold a sampled byte (at k = 3 and 5 that is the
    whole row; the skipped rows are not read), the weights and the output;
    2 * 3B * ws * wo * hs operations on the bf16 tensor cores."""
    if name == "warp_pass1_decimated":
        frames, w1, kw = args
        b, _, w, _ = frames.shape
        k, off, hs, ws = kw["k"], kw["off"], kw["hs"], kw["ws"]
        wo = w1.shape[2]
        first = 3 * (off + k * np.arange(ws))
        sectors = np.unique(np.concatenate([first // 32, (first + 2) // 32])).size
        frame_bytes = b * hs * min(32 * sectors, 3 * w)
        nbytes = frame_bytes + (w1.numel() + hs * 3 * b * wo) * w1.element_size()
        ops = 2.0 * 3 * b * ws * wo * hs
        peak = PEAK_OPS["bf16"]
    else:
        soft = name == "mask_stats_soft"
        protos, coefs, boxes, valid = args
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
        in_bytes = (covered * nm * protos.element_size() + coefs.numel() * 4
                    + boxes.numel() * 4 + valid.numel())
        nbytes = in_bytes + out_bytes
        ops = 2.0 * nm * cell_dets
        peak = PEAK_OPS["bf16" if soft else "f32"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    info = {"bytes": nbytes, "ops": ops}
    return (t_bytes, "bytes", info) if t_bytes >= t_ops else (t_ops, "operations", info)


def load_first_design(torch, path):
    """Build the first design of ``maskstats.cu`` from ``path`` and return
    ``call(soft, protos, coefs, boxes, valid)``, which launches it with the
    dtype policy's defaults (its C interface: the inputs, the shape, the two
    flags, then m, col_any, bottom[, col_p, bottom_sub] and the stream)."""
    import ctypes

    from tti_torch.kernels import build as kbuild

    out = kbuild.BUILD_DIR / "libtti_maskstats_first_design.so"
    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-o", str(out), path], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tti_mask_stats_soft.argtypes = [p, i, p, p, p, i, i, i, i, i, i, i] + [p] * 6
    lib.tti_mask_stats_binary.argtypes = [p, i, p, p, p, i, i, i, i, i, i, i] + [p] * 4

    def call(soft, protos, coefs, boxes, valid):
        b, hm, wm, nm = protos.shape
        d = coefs.shape[1]
        new = lambda *shape: torch.empty(shape, dtype=torch.float32, device="cuda")
        outs = [new(b, d, 6 if soft else 3)] + [new(b, d, wm) for _ in range(4 if soft else 2)]
        fn = lib.tti_mask_stats_soft if soft else lib.tti_mask_stats_binary
        err = fn(protos.data_ptr(), 1, coefs.data_ptr(), boxes.data_ptr(), valid.data_ptr(),
                 b, d, hm, wm, nm, int(soft), 1, *(t.data_ptr() for t in outs),
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"first design: cudaError {err}")
        return outs

    return call


def time_kernel(torch, ms, name, args, flush, first=None) -> dict:
    """One kernel against its plain version and its logits einsum alone,
    on ``args``, with the bound of this input; with ``first``, the first
    design's time on the same input, taken before and after the kernel's."""
    soft = name == "mask_stats_soft"
    kern = ms.mask_stats_soft if soft else ms.mask_stats_binary
    plain = ms.mask_stats_soft_plain if soft else ms.mask_stats_binary_plain
    logits_dtype = torch.bfloat16 if soft else torch.float32
    t = {}
    with torch.inference_mode():
        if first is not None:
            got, old = kern(*args), first(soft, *args)
            check(torch.equal(got["bottom"], old[2]) and torch.equal(got["col_any"], old[1]),
                  f"{name}: the first design disagrees on bottom or col_any")
            t["first_design_ms"] = [time_ms(torch, lambda: first(soft, *args), flush=flush)]
        t["ms"] = time_ms(torch, lambda: kern(*args), flush=flush)
        if first is not None:
            t["ms_again"] = time_ms(torch, lambda: kern(*args), flush=flush)
            t["first_design_ms"].append(time_ms(torch, lambda: first(soft, *args), flush=flush))
        t["plain_ms"] = time_ms(torch, lambda: plain(*args), flush=flush)
        t["einsum_ms"] = time_ms(torch, lambda: ms._logits(args[0], args[1], logits_dtype),
                                 flush=flush)
        bound, bound_by, info = kernel_bound_ms(torch, name, *args)
    return {**t, "bound_ms": bound, "bound_by": bound_by, "shape": list(args[0].shape),
            "d": args[1].shape[1], **info}


def log_kernel_time(name, label, t) -> None:
    first = (f" and {t['ms_again']:.4f} ms again, first design "
             f"{' and '.join(f'{v:.4f}' for v in t['first_design_ms'])} ms (before and after)"
             if "first_design_ms" in t else "")
    log(f"  {name} on {label}, protos {tuple(t['shape'])}, D={t['d']}: kernel {t['ms']:.4f} ms "
        f"({t['ms'] / t['bound_ms']:.2f}x its bound){first}, "
        f"plain {t['plain_ms']:.4f} ms, logits einsum alone {t['einsum_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['bytes'] / 1e6:.2f} MB, "
        f"{t['ops'] / 1e9:.3f} GFLOP)")


def step_like_problem(torch, b, hm, wm, d=64, seed=31):
    """Inputs shaped like a step's, made on the card: of ``d`` detections the
    first 8 are valid, one box over the full width and rows 0.27-0.81 of the
    grid (the fabric), seven small ones inside it (stitches). Protos k/128,
    coefs j/64 (exact logits)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    protos = torch.randint(-255, 256, (b, hm, wm, 32), device="cuda", generator=gen,
                           dtype=torch.int16).to(torch.bfloat16) / 128
    coefs = torch.randint(-128, 129, (b, d, 32), device="cuda", generator=gen).float() / 64
    boxes = torch.zeros(b, d, 4, device="cuda")
    boxes[:, 0] = torch.tensor([0.0, hm * 0.27, float(wm), hm * 0.81], device="cuda")
    u = torch.rand(b, 7, 2, device="cuda", generator=gen)
    x1, y1 = u[..., 0] * wm * 0.9, hm * (0.4 + 0.1 * u[..., 1])
    boxes[:, 1:8] = torch.stack([x1, y1, x1 + wm * 0.025, y1 + hm * 0.06], -1)
    valid = torch.zeros(b, d, dtype=torch.bool, device="cuda")
    valid[:, :8] = True
    return protos, coefs, boxes, valid


def _tuning(soft_chunk, soft_blocks, binary_chunk, binary_blocks) -> list[str]:
    return [f"-DTTI_MS_SOFT_CHUNK={soft_chunk}", f"-DTTI_MS_SOFT_BLOCKS={soft_blocks}",
            f"-DTTI_MS_BINARY_CHUNK={binary_chunk}", f"-DTTI_MS_BINARY_BLOCKS={binary_blocks}"]


ABLATIONS = {
    "as shipped": [],
    "without the fill": ["-DTTI_MS_WITHOUT_FILL"],
    "without the strips": ["-DTTI_MS_WITHOUT_STRIPS"],
    "without the moments launch": ["-DTTI_MS_WITHOUT_MOMENTS"],
    "loads started where they are used": ["-DTTI_MS_WITHOUT_PREFETCH"],
    "both kernels with 4-row chunks, 2 blocks per SM": _tuning(4, 2, 4, 2),
    "both kernels with 2-row chunks, 4 blocks per SM": _tuning(2, 4, 2, 4),
    "both kernels with 4-row chunks, 3 blocks per SM": _tuning(4, 3, 4, 3),
}


def ablate(torch, ms, kbuild, first) -> None:
    """Time variants of ``maskstats.cu`` (``ABLATIONS``: compiler flags that
    leave a part out, so their results are wrong on purpose, or change the
    tuning) and the number of blocks per frame, on inputs shaped like the
    steps', on one frame of each, and on the whole-grid inputs."""
    import ctypes
    import threading

    shipped = ms.build()
    libs, errors = {}, []

    def compile_variant(name, flags):
        out = kbuild.BUILD_DIR / f"libtti_maskstats_variant_{list(ABLATIONS).index(name)}.so"
        proc = subprocess.run([kbuild.nvcc(), *kbuild.NVCC_FLAGS, *flags, "-o", str(out),
                               str(kbuild.CSRC / "maskstats.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            errors.append(f"{name}: {proc.stderr}")
            return
        lib = ctypes.CDLL(str(out))
        for fn in ("tti_mask_stats_soft", "tti_mask_stats_binary"):
            getattr(lib, fn).argtypes = getattr(shipped, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib

    threads = [threading.Thread(target=compile_variant, args=kv) for kv in ABLATIONS.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, "\n".join(errors))

    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: flush_buf.zero_()
    inputs = (
        ("mask_stats_soft", "step-like, 128 frames", lambda: step_like_problem(torch, 128, 368, 480)),
        ("mask_stats_soft", "step-like, 1 frame", lambda: step_like_problem(torch, 1, 368, 480)),
        ("mask_stats_soft", "whole-grid, 8 frames", lambda: stats_problem(torch, 8, 368, 480, 64, 11)),
        ("mask_stats_binary", "step-like, 128 frames", lambda: step_like_problem(torch, 128, 96, 160)),
        ("mask_stats_binary", "step-like, 1 frame", lambda: step_like_problem(torch, 1, 96, 160)),
        ("mask_stats_binary", "whole-grid, 8 frames", lambda: stats_problem(torch, 8, 96, 160, 64, 11)),
    )
    default_blocks = ms.blocks_per_frame
    try:
        for name, label, make in inputs:
            args = make()
            soft = name == "mask_stats_soft"
            kern = ms.mask_stats_soft if soft else ms.mask_stats_binary
            bound, by, info = kernel_bound_ms(torch, name, *args)
            b, _, wm, _ = args[0].shape
            log(f"{name}, {label}, protos {tuple(args[0].shape)}, D={args[1].shape[1]}: bound "
                f"{bound:.4f} ms ({by}, {info['bytes'] / 1e6:.2f} MB), {default_blocks(b, wm)} blocks "
                f"per frame")
            with torch.inference_mode():
                if first is not None:
                    log(f"  {'first design':50s} {time_ms(torch, lambda: first(soft, *args), flush=flush):.4f} ms")
                for variant in ABLATIONS:
                    ms._lib = libs[variant]
                    t = time_ms(torch, lambda: kern(*args), flush=flush)
                    log(f"  {variant:50s} {t:.4f} ms ({t / bound:.2f}x its bound)")
                ms._lib = shipped
                sweep = {}
                for blocks in (8, 12, 16, 23, 32, 64, 128):
                    ms.blocks_per_frame = lambda b, wm, n=blocks: n
                    sweep[blocks] = time_ms(torch, lambda: kern(*args), flush=flush)
                ms.blocks_per_frame = default_blocks
                log("  as shipped, by blocks per frame: " + ", ".join(
                    f"{k}: {v:.4f}" for k, v in sweep.items()))
            del args
            torch.cuda.empty_cache()
    finally:
        ms._lib, ms.blocks_per_frame = shipped, default_blocks


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


@contextlib.contextmanager
def plain_routes(ms, wp):
    """Bind every kernel's plain version in the kernel's place."""
    import tti_torch.parallel.runtime as rt

    saved = rt.warp_pass1_decimated
    rt.warp_pass1_decimated = wp.warp_pass1_decimated_plain
    try:
        with stats_route(ms.mask_stats_soft_plain, ms.mask_stats_binary_plain):
            yield
    finally:
        rt.warp_pass1_decimated = saved


def reset_launch_counts(ms, wp) -> None:
    ms.reset_launch_counts()
    wp.reset_launch_counts()


def launch_counts(ms, wp) -> dict:
    return {**ms.LAUNCHES, **wp.LAUNCHES}


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


_FRAMES: dict = {}


def textile(frame_hw, n=8):
    """``n`` seeded synthetic textile frames (host, uint8), made once per size."""
    from torch_synth import textile_frames

    if frame_hw not in _FRAMES:
        _FRAMES[frame_hw] = textile_frames(8, *frame_hw, seed=5)
    base = _FRAMES[frame_hw]
    return np.ascontiguousarray(np.tile(base, ((n + 7) // 8, 1, 1, 1))[:n])


def bench_calibration(frame_hw):
    """bench.py's calibration, its intrinsics scaled to the frame size."""
    from tti_torch.calib.io import CalibrationData

    h, w = frame_hw
    K = K_960.copy()
    K[0] *= w / 1280.0
    K[1] *= h / 960.0
    return CalibrationData(K=K, dist=DIST, rvec=RVEC, tvec=TVEC)


def bench_roi(frame_hw):
    """bench.py's ROI for the frame size."""
    from tti_torch.core.config import RoiConfig

    h, w = frame_hw
    return RoiConfig(enabled=True, x_min=10, x_max=w - 10, y_min=min(300, h // 3),
                     y_max=h - min(200, h // 5))


def build_pipeline(torch, frame_hw, imgsz, ckpt, **kw):
    from tti_torch.core.config import MeasureConfig, ModelConfig
    from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
    from tti_torch.parallel.runtime import InspectionPipeline

    path = os.path.join(HERE, "checkpoints", ckpt)
    meta = checkpoint_metadata(path)
    cfg = ModelConfig(variant=meta.get("variant", "n"), num_classes=meta.get("num_classes", 2),
                      image_size=imgsz, dtype="bfloat16",
                      mask_stride=meta.get("mask_stride", 4),
                      proto_head=meta.get("proto_head", "deconv"))
    return InspectionPipeline(
        cfg, load_flax_msgpack(path), frame_hw, calibration=bench_calibration(frame_hw),
        measure_cfg=MeasureConfig().with_subcell_from(meta), roi=bench_roi(frame_hw),
        device="cuda", **kw)


MM_KEYS = ("raw_edge_mm", "raw_width_mm")


def mm_differences(a, b) -> np.ndarray:
    """|a - b| of the two mm readings on the frames where both measured."""
    out = []
    for key in MM_KEYS:
        x = getattr(a.measurements, key).astype(float)
        y = getattr(b.measurements, key).astype(float)
        both = np.isfinite(x) & np.isfinite(y)
        out.append(np.abs(x[both] - y[both]))
    return np.concatenate(out)


def mm_difference(a, b) -> tuple[float, int]:
    """The largest of :func:`mm_differences`, and how many readings there are."""
    d = mm_differences(a, b)
    return (float(d.max()) if d.size else 0.0), int(d.size)


def check_outputs(got, label, batch, max_det) -> None:
    """Shapes and finiteness: detections always finite; a measurement is
    either finite or NaN (absent), never infinite."""
    check(got.boxes_frame.shape == (batch, max_det, 4), f"{label}: boxes shape")
    check(np.isfinite(got.boxes_frame).all() and np.isfinite(got.scores).all(),
          f"{label}: boxes and scores must be finite")
    for key in MM_KEYS:
        check(not np.isinf(getattr(got.measurements, key)).any(), f"{label}: {key} is infinite")
    sv = got.stitches.valid
    for key in ("cx", "cy", "left", "right"):
        check(np.isfinite(getattr(got.stitches, key)[sv]).all(), f"{label}: stitch {key} not finite")
    check(got.valid.any(), f"{label}: no detections on the synthetic frames")


def check_step(torch, ms, wp, label, frame_hw, imgsz, ckpt, kernels, batch=4, **pipe_kw):
    """One configuration through ``process_batch``: every kernel in
    ``kernels`` must launch once in that step, and the step must agree with
    the same step run with the plain versions bound in the kernels' place."""
    t0 = time.perf_counter()
    pipe = build_pipeline(torch, frame_hw, imgsz, ckpt, **pipe_kw)
    setup_s = time.perf_counter() - t0
    frames = textile(frame_hw, batch)
    reset_launch_counts(ms, wp)
    got = pipe.process_batch(frames)
    launches = launch_counts(ms, wp)
    for kernel in kernels:
        check(launches[kernel] == 1, f"{label}: one launch of {kernel} per step expected: {launches}")
    with plain_routes(ms, wp):
        ref = pipe.process_batch(frames)
    check(launch_counts(ms, wp) == launches, f"{label}: the plain step launched a kernel")

    # The same model run, on a model input that is equal (kernel C equals its
    # plain version with the warp's weights) or absent from the comparison:
    # detections are identical. Measurements within 0.01 mm (the statistics
    # sum in another order), counts and NaN pattern equal.
    for key in ("boxes_frame", "scores", "classes", "valid"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key), err_msg=key)
    for key in (*MM_KEYS, "n_dist", "n_width", "n_stitches", "fabric_detected"):
        a, r = getattr(got.measurements, key), getattr(ref.measurements, key)
        np.testing.assert_array_equal(np.isnan(a.astype(float)), np.isnan(r.astype(float)),
                                      err_msg=key)
        np.testing.assert_allclose(a.astype(float), r.astype(float), atol=1e-2, err_msg=key)
    m_err, _ = mm_difference(got, ref)
    env_err = float(np.abs(got.envelope.astype(float) - ref.envelope.astype(float)).max())
    check(env_err <= 1e-3, f"{label}: envelope differs from the plain step by {env_err}")
    check_outputs(got, label, batch, pipe.model_cfg.max_detections)
    shown = slice(0, 4)
    log(f"{label}: pipeline set-up {setup_s:.1f} s; batch {batch}; launches per step "
        f"{ {k: launches[k] for k in kernels} }; detections/frame {got.valid.sum(1)[shown].tolist()}; "
        f"stitches/frame {got.measurements.n_stitches[shown].tolist()}; edge mm "
        f"{np.round(got.measurements.raw_edge_mm[shown], 4).tolist()}; width mm "
        f"{np.round(got.measurements.raw_width_mm[shown], 4).tolist()}; "
        f"max |kernel - plain| over mm {m_err:.3g}, envelope {env_err:.3g}")
    return pipe, launches, got


STAGES = ("preprocess", "forward", "detect", "measure")


def device_time(torch, fn, steps):
    """``fn`` run ``steps`` times under the profiler: device ms per step by
    kernel name, the device's busy ms per step (the union of its kernels'
    intervals) and its ops per step; busy is None without device events.
    User annotations on the device's timeline (``Optimizer.step#...``) span
    the gaps between their kernels and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    per_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
            spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        return per_name, None, 0
    spans.sort()
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return per_name, (busy + cur_e - cur_s) / 1e3 / steps, len(spans) // steps


def breakdown(torch, pipe, label, frames, step_ms, profile=True):
    """Where one batch's step goes: stream time per stage (CUDA events
    between the stages, so device idle while the host enqueues counts to the
    stage that waits), then (``profile``) the profiler's device time by
    kernel name and the device's idle share of the unprofiled step time."""
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
    if not profile:
        return {"stages_ms": totals}

    steps = 2
    per_name, busy, n_ops = device_time(torch, lambda: pipe.step(frames), steps)
    if busy is None:
        log(f"{label} profiler: no device events recorded")
        return {"stages_ms": totals, "busy_ms": None, "idle_share": None}
    idle = 1.0 - busy / step_ms
    log(f"{label} profiler: {n_ops} device ops per step, busy {busy:.3f} ms of "
        f"a {step_ms:.3f} ms step (idle share {idle:.1%}); top kernels:")
    for name, t in sorted(per_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {t:8.3f} ms {t / busy:6.1%}  {name[:110]}")
    soft_or_binary = sum(t for n, t in per_name.items()
                         if "stats_strips" in n or "stats_moments" in n)
    log(f"{label} mask-stats kernel: {soft_or_binary:.3f} ms per step ({soft_or_binary / busy:.1%} of busy)")
    return {"stages_ms": totals, "busy_ms": busy, "idle_share": idle,
            "mask_stats_ms": soft_or_binary}


def nms_sweeps(torch, pipe, frames) -> int:
    """The sweeps one step's NMS takes to its fixed point, the last one
    confirming it: the step's own candidates, swept one at a time with a
    host check after each."""
    import tti_torch.postprocess.nms as nms

    seen, saved = [], nms.greedy_suppress

    def recorder(*args):
        seen.append(args)
        return saved(*args)

    nms.greedy_suppress = recorder  # batched_nms looks it up at each call
    try:
        pipe.step(frames)
    finally:
        nms.greedy_suppress = saved
    check(len(seen) == 1, f"one NMS per step expected, got {len(seen)}")
    boxes, _, classes, _, ok, iou_thresh, _, class_aware = seen[0]
    blocked = nms.suppression_matrix(boxes, classes, iou_thresh, class_aware)
    keep, sweeps = ok, 0
    while True:
        new = nms.sweep(blocked, ok, keep)
        sweeps += 1
        if torch.equal(new, keep):
            return sweeps
        keep = new


def check_step_syncs(torch, pipe, label, frames) -> dict:
    """The synchronising calls in one step on device-resident frames (at
    most one: the NMS block check) and the NMS sweep count."""
    from step_syncs_torch import count_step_syncs

    import tti_torch.postprocess.nms as nms

    n, where, first = count_step_syncs(torch, pipe, frames)
    sweeps = nms_sweeps(torch, pipe, frames)
    log(f"{label} batch {frames.shape[0]}: {n} synchronising call(s) per step {where}"
        + (f" (the first window: {first})" if first != where else "")
        + f"; NMS reaches its fixed point in {sweeps} sweeps (blocks of {nms.SWEEPS_PER_CHECK})")
    check(n <= 1, f"{label}: {n} synchronising calls in one step (at most 1): {where}")
    return {"syncs": n, "where": where, "first_window": first, "nms_sweeps": sweeps}


def time_step(torch, ms, pipe, label, frame_hw, profile=True, iters=20, p50_iters=50):
    """Step timings and breakdowns, after the synchronising calls of one
    step at batch 128 and 1; also returns the mask-stats inputs of one
    batch-128 step."""
    batch = BATCH
    frames = torch.from_numpy(textile(frame_hw, batch)).cuda()
    one = frames[:1].contiguous()
    syncs = {b: check_step_syncs(torch, pipe, label, f) for b, f in ((batch, frames), (1, one))}
    pipe.step(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        pipe.step(frames)
    torch.cuda.synchronize()
    fps = batch * iters / (time.perf_counter() - t0)
    pipe.step(one)
    torch.cuda.synchronize()
    lats = []
    for _ in range(p50_iters):
        t = time.perf_counter()
        pipe.step(one)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t)
    p50 = 1e3 * float(np.median(lats))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"{label}: {fps:.1f} frames/s at batch {batch} ({iters} steps, device-resident "
        f"frames); batch-1 p50 {p50:.3f} ms; peak device memory {peak_gb:.1f} GB")
    parts = breakdown(torch, pipe, label, frames, 1e3 * batch / fps, profile)
    one_parts = breakdown(torch, pipe, f"{label} batch-1", one, p50, profile)
    stats_args = capture_stats_inputs(ms, pipe, frames)
    return {"frames_per_s": fps, "batch": batch, "p50_ms": p50, "at_batch": parts,
            "at_batch_1": one_parts, "syncs": syncs}, stats_args


def warp_in_f32(torch, warp, content):
    """The two-pass warp evaluated in float32 from the same (bf16) weights:
    both products and the pad shift in float32, no intermediate rounding."""
    pad = warp.pad_value
    i1 = torch.einsum("bywc,ywo->byoc", content.float() - pad, warp.w1.float())
    i1 = i1.reshape(i1.shape[0], i1.shape[1], -1, 2, i1.shape[3])
    w2 = warp.w2[..., :warp.src_hw[0]].float()  # without the rows that carry the pad
    out = torch.einsum("byodc,odvey->bvoedc", i1, w2) + pad
    b, v2, o2, dv, do, c = out.shape
    return out.reshape(b, v2, o2, dv * do * c)


def check_kernel_route(torch, head, head_k, got_e, got_k, frame_hw) -> dict:
    """The headline step with warp_pass1="kernel" against the "einsum" step
    on the same batch-128 frames."""
    from tti_torch.preprocess.letterbox import letterbox_content

    frames = torch.from_numpy(textile(frame_hw, BATCH)).cuda()
    with torch.inference_mode():
        x_e, x_k = head.preprocess(frames), head_k.preprocess(frames)
        diff = (x_e.float() - x_k.float()).abs()
        x_max, x_mean = float(diff.max()), float(diff.mean())
        # The card's bf16 warp against the same warp in float32 (4 frames).
        # Pass 2 adds the pad in its float32 accumulator and rounds once, as
        # the reference does.
        content = letterbox_content(frames[:4], head.spec, torch.float32, decimate=True)
        f32_diff = float((x_e[:4].float() - warp_in_f32(torch, head.warp, content)).abs().max())
    # 2^-7: the kernel multiplies by bf16(1/255) where the chain divides by
    # 255, one bf16 step of the content (2^-8 below 1.0), and the rounding
    # after pass 1 and after pass 2 can each move that by another step.
    limit = 2.0 ** -7
    check(x_max <= limit, f"kernel route: model input differs from the einsum route by {x_max}")
    # The binary readout is quantised: a model input that moves by a bf16
    # step can flip one mask cell at the 0 threshold, and one stride-4 cell
    # is 12 frame px, about 0.95 mm here; a reading is a mean over its 4-8
    # stitches, so one flipped cell moves it by 0.12-0.24 mm. Limit: 0.25 mm
    # on every reading, and the median reading within 0.05 mm.
    d = mm_differences(got_k, got_e)
    check(d.size > 0, "kernel route: no frame measured on both routes")
    mm, mm_med, over = float(d.max()), float(np.median(d)), int((d > 0.05).sum())
    check(mm <= 0.25 and mm_med <= 0.05,
          f"kernel route: mm differ from the einsum route by max {mm}, median {mm_med}")
    det_same = float((got_k.valid == got_e.valid).mean())
    log(f"headline kernel route against the einsum route at batch {BATCH}: model input max abs "
        f"diff {x_max:.4g} (limit {limit:.4g}), mean {x_mean:.3g}; mm diff over {d.size} readings: "
        f"max {mm:.4g} (limit 0.25), median {mm_med:.4g} (limit 0.05), {over} above 0.05; "
        f"detection slots that agree {det_same:.4%}")
    log(f"headline warp in bf16 against the same warp in float32 (4 frames): max abs diff "
        f"{f32_diff:.4g}")
    return {"input_max_abs_diff": x_max, "input_mean_abs_diff": x_mean, "mm_max_diff": mm,
            "mm_median_diff": mm_med, "bf16_vs_f32_warp_max_abs_diff": f32_diff}


def stage_ms(torch, fn, iters=10) -> float:
    """Stream ms per call of ``fn`` (CUDA events around ``iters`` calls)."""
    with torch.inference_mode():
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / iters


def check_packed(torch, ms, wp, head, frame_hw, imgsz, ckpt) -> dict:
    """The headline geometry with remap="packed" at batch 128, against the
    two-pass step."""
    label = "packed-remap step (1080x1920, imgsz 640, gather remap)"
    pipe, _, got = check_step(torch, ms, wp, label, frame_hw, imgsz, ckpt,
                              ("mask_stats_binary",), batch=BATCH, remap="packed")
    from tti_torch.preprocess.remap import PackedRemap

    check(isinstance(pipe.warp, PackedRemap), "remap='packed' must build the gather")
    frames = torch.from_numpy(textile(frame_hw, BATCH)).cuda()
    with torch.inference_mode():
        diff = (pipe.preprocess(frames).float() - head.preprocess(frames).float()).abs()
        mean, p99, worst = float(diff.mean()), float(diff.flatten()[::97].quantile(0.99)), float(diff.max())
    # The two routes differ by the interpolation kernel only (p99 positional
    # error under 0.01 px, larger only on the outermost columns), by the
    # gather's 8-bit packing and weights (1/255 = 0.0039) and by bf16
    # rounding of the outputs (2^-8 below 1.0): a mean absolute difference
    # under 0.01 on textile frames. The maximum sits on the edge columns and
    # is printed, not bounded.
    check(mean <= 0.01, f"packed route: mean abs model-input difference {mean} > 0.01")
    pre = stage_ms(torch, lambda: pipe.preprocess(frames))
    pre_two = stage_ms(torch, lambda: head.preprocess(frames))
    fps = BATCH * 1e3 / stage_ms(torch, lambda: pipe.step(frames), iters=5)
    log(f"packed-remap model input against the two-pass step's at batch {BATCH}: mean abs diff "
        f"{mean:.4g} (limit 0.01), p99 {p99:.4g}, max {worst:.4g}; preprocess stage {pre:.3f} ms "
        f"(two-pass {pre_two:.3f} ms); step {fps:.1f} frames/s")
    return {"input_mean_abs_diff": mean, "input_max_abs_diff": worst, "preprocess_ms": pre,
            "twopass_preprocess_ms": pre_two, "frames_per_s": fps}


def check_dual(torch, ms, wp, head, got_head, frame_hw, imgsz, ckpt_b) -> dict:
    """Two checkpoints on one preprocessed batch: each model's outputs equal
    its own single-pipeline outputs on the same frames."""
    from tti_torch.parallel.runtime import DualPipeline

    second = build_pipeline(torch, frame_hw, imgsz, ckpt_b)
    frames = textile(frame_hw, BATCH)
    solo_b = second.process_batch(frames)
    free_before = torch.cuda.memory_allocated()
    dual = DualPipeline(head, second)
    check(second.warp is head.warp, "the secondary must share the primary's warp weights")
    freed = (free_before - torch.cuda.memory_allocated()) / 1e6
    reset_launch_counts(ms, wp)
    out_a, out_b = dual.process_batch(frames)
    launches = launch_counts(ms, wp)
    check(launches["mask_stats_binary"] == 2, f"dual step: one kernel-B launch per model: {launches}")
    worst = {}
    for name, got, solo in (("primary", out_a, got_head), ("secondary", out_b, solo_b)):
        # The same model on the same preprocessed buffer: boxes within 1e-3
        # px, mm within 0.01 (atomics-free kernels: in fact equal).
        np.testing.assert_array_equal(got.valid, solo.valid, err_msg=name)
        np.testing.assert_allclose(got.boxes_frame, solo.boxes_frame, atol=1e-3, err_msg=name)
        for key in MM_KEYS:
            np.testing.assert_allclose(getattr(got.measurements, key),
                                       getattr(solo.measurements, key), atol=1e-2,
                                       equal_nan=True, err_msg=f"{name} {key}")
        check_outputs(got, f"dual {name}", BATCH, dual.primary.model_cfg.max_detections)
        worst[name] = (float(np.abs(got.boxes_frame - solo.boxes_frame).max()),
                       mm_difference(got, solo)[0])
    check(not np.array_equal(out_a.scores, out_b.scores), "the two checkpoints give equal scores")
    dev = torch.from_numpy(frames).cuda()
    fps = BATCH * 1e3 / stage_ms(torch, lambda: dual.step(dev), iters=10)
    log(f"dual step (1080x1920, imgsz 640, {ckpt_b} beside the headline checkpoint) at batch "
        f"{BATCH}: secondary shares the primary's warp ({freed:.0f} MB of device memory freed); "
        f"max |dual - single| boxes/mm: primary {worst['primary']}, secondary "
        f"{worst['secondary']}; {fps:.1f} frames/s (both models' full chains per frame)")
    return {"frames_per_s": fps, "warp_freed_mb": freed}


class FixedSource:
    """A 60 frames/s camera that shows one frame for ever."""

    def __init__(self, frame):
        self.frame = frame

    def read(self):
        time.sleep(1 / 60)
        return True, self.frame

    def reconnect(self): ...

    def release(self): ...


def time_runner(runner, n_steps=25) -> tuple[float, float]:
    """Seconds for ``n_steps`` blocking steps, then for ``n_steps + 1``
    pipelined steps and a flush (the first pipelined call only dispatches;
    its device work falls inside the window)."""
    runner.step()  # warm the batch's shapes
    t0 = time.perf_counter()
    for _ in range(n_steps):
        runner.step()
    sync_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    runner.step_pipelined()
    for _ in range(n_steps):
        runner.step_pipelined()
    runner.flush()
    return sync_s, time.perf_counter() - t0


def check_streams(torch, pipe, frame_hw) -> dict:
    """Four 1080p cameras through ``MultiStreamRunner`` with the C++ rings:
    first on fixed frames, where the pipelined results must equal the
    blocking ones; then on generated frames, 25 blocking steps, then 26
    pipelined steps and a flush."""
    from tti_torch.app.sources import SyntheticSource
    from tti_torch.parallel.streams import MultiStreamRunner

    n_steps = 25
    fixed = textile(frame_hw, 4)
    want = pipe.process_batch(fixed)
    runner = MultiStreamRunner(pipe, [FixedSource(f) for f in fixed], frame_hw, native=True)
    runner.start()
    try:
        check(runner.wait_for_frames(), "streams: no frames from the fixed sources")
        blocking, smoothed = runner.step()
        check(runner.step_pipelined() is None, "streams: the first pipelined call returns None")
        piped, _ = runner.step_pipelined()
        last, _ = runner.flush()
        check(runner.flush() is None, "streams: nothing left in flight after flush")
        # The same program on camera-paced sources that cost the host nothing.
        fixed_sync_s, fixed_pipe_s = time_runner(runner, n_steps)
    finally:
        runner.stop()
    for name, outs in (("blocking", blocking), ("pipelined", piped), ("flushed", last)):
        for key in ("boxes_frame", "scores", "valid"):
            np.testing.assert_array_equal(getattr(outs, key), getattr(want, key),
                                          err_msg=f"{name} {key}")
        for key in MM_KEYS:
            np.testing.assert_array_equal(getattr(outs.measurements, key),
                                          getattr(want.measurements, key), err_msg=f"{name} {key}")
    check(len(smoothed) == 4 and all(r.stitch_width_mm.is_cuda for r in smoothed),
          "streams: one smoothed measurement per stream, on the card")
    check_outputs(blocking, "streams", 4, pipe.model_cfg.max_detections)

    h, w = frame_hw
    runner = MultiStreamRunner(pipe, [SyntheticSource(h, w, seed=i) for i in range(4)], frame_hw,
                               native=True)
    check(all(wk.ring.native for wk in runner.workers), "streams: the C++ ring must be in use")
    runner.start()
    try:
        check(runner.wait_for_frames(10.0), "streams: no frames from the synthetic sources")
        sync_s, pipe_s = time_runner(runner, n_steps)
        outs, _ = runner.step()
        t0 = time.perf_counter()
        for _ in range(10):
            batch = runner.assemble_batch()
        gather_ms = (time.perf_counter() - t0) / 10 * 1e3
        captured = [wk.stats.captured for wk in runner.workers]
    finally:
        runner.stop()
    check(outs.boxes_frame.shape == (4, pipe.model_cfg.max_detections, 4), "streams: boxes shape")
    check(runner.batches == 2 * n_steps + 3, f"streams: {runner.batches} batches read")
    sync_fps, pipe_fps = 4 * n_steps / sync_s, 4 * (n_steps + 1) / pipe_s
    fixed_sync_fps, fixed_pipe_fps = 4 * n_steps / fixed_sync_s, 4 * (n_steps + 1) / fixed_pipe_s
    log(f"streams (4 x {h}x{w} generated frames, C++ rings, batch 4): blocking {sync_fps:.1f} "
        f"frames/s ({1e3 * sync_s / n_steps:.3f} ms/step), pipelined {pipe_fps:.1f} frames/s "
        f"({1e3 * pipe_s / (n_steps + 1):.3f} ms/step); host-to-device {batch.nbytes / 1e6:.1f} MB "
        f"per step; ring snapshot into the pinned buffer {gather_ms:.3f} ms; frames captured per "
        f"stream {captured}")
    log(f"streams on fixed frames (60 frames/s sources that cost the host nothing): blocking "
        f"{fixed_sync_fps:.1f} frames/s ({1e3 * fixed_sync_s / n_steps:.3f} ms/step), pipelined "
        f"{fixed_pipe_fps:.1f} frames/s ({1e3 * fixed_pipe_s / (n_steps + 1):.3f} ms/step)")
    return {"blocking_frames_per_s": sync_fps, "pipelined_frames_per_s": pipe_fps,
            "fixed_blocking_frames_per_s": fixed_sync_fps,
            "fixed_pipelined_frames_per_s": fixed_pipe_fps,
            "h2d_bytes_per_step": int(batch.nbytes), "gather_ms": gather_ms}


def time_warp_p1(torch, wp, pipe, frame_hw, flush) -> dict:
    """Kernel C at the headline step's shapes (batch 128 and 1): the kernel,
    its plain version, the unfused chain it replaces (letterbox_content ->
    subtract pad -> pass-1 einsum), its bound, and pass 2 from either
    layout."""
    from tti_torch.preprocess.letterbox import letterbox_content

    warp, spec = pipe.warp, pipe.spec
    kw = dict(k=3, off=1, hs=spec.new_h, ws=spec.new_w, pad_value=warp.pad_value)
    pad = torch.tensor(warp.pad_value, dtype=warp.w1.dtype)

    def unfused(f):
        content = letterbox_content(f, spec, torch.bfloat16, decimate=True)
        return torch.einsum("bywc,ywo->byoc", content.to(warp.w1.dtype) - pad, warp.w1)

    out = {}
    with torch.inference_mode():
        for batch in (BATCH, 1):
            frames = torch.from_numpy(textile(frame_hw, batch)).cuda()
            t = {"ms": time_ms(torch, lambda: wp.warp_pass1_decimated(frames, warp.w1, **kw),
                               flush=flush),
                 "plain_ms": time_ms(torch, lambda: wp.warp_pass1_decimated_plain(
                     frames, warp.w1, **kw), iters=5, flush=flush),
                 "unfused_ms": time_ms(torch, lambda: unfused(frames), flush=flush)}
            i1_k = wp.warp_pass1_decimated(frames, warp.w1, **kw)
            i1_e = unfused(frames)
            t["pass2_from_ycbo_ms"] = time_ms(
                torch, lambda: warp.apply_pass2_ycbo(i1_k, torch.bfloat16), flush=flush)
            t["pass2_from_byoc_ms"] = time_ms(torch, lambda: warp.apply_pass2(i1_e, torch.bfloat16), flush=flush)
            t["bound_ms"], t["bound_by"], info = kernel_bound_ms(
                torch, "warp_pass1_decimated", frames, warp.w1, kw)
            t.update(info, shape=list(frames.shape))
            out[batch] = t
            log(f"  warp_pass1_decimated on the headline step's frames {tuple(frames.shape)}, W1 "
                f"{tuple(warp.w1.shape)}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                f"unfused chain {t['unfused_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}; {t['bytes'] / 1e6:.2f} MB, {t['ops'] / 1e9:.3f} GFLOP); pass 2 "
                f"from (y,c,b,o) {t['pass2_from_ycbo_ms']:.4f} ms, from (b,y,o,c) "
                f"{t['pass2_from_byoc_ms']:.4f} ms")
    return out


# ---------------------------------------------------------------------------
# Phase 6: training
# ---------------------------------------------------------------------------


CAM_CKPT = os.path.join(HERE, "checkpoints", "yolov8n_textile_cam.msgpack")
R5S = dict(imgsz=960, mask_stride=2, proto_head="subpixel", soft_masks="all", max_gt=16,
           batch=8, gains=(2.0, 1.0), n_scenes=32, total_steps=10800)
HEADLINE_TRAIN = dict(imgsz=640, mask_stride=4, proto_head="deconv", soft_masks=None, max_gt=32,
                      batch=64, gains=None, n_scenes=32, total_steps=10)
LOSS_KEYS = ("total", "cls", "box", "dfl", "seg")


def train_dataset(torch, recipe, seed):
    from torch_scenes import textile_samples
    from tti_torch.train.augment import build_device_dataset

    return build_device_dataset(textile_samples(recipe["n_scenes"], recipe["imgsz"], seed=seed),
                                recipe["imgsz"], recipe["max_gt"], mask_stride=recipe["mask_stride"],
                                soft_masks=recipe["soft_masks"], device="cuda")


def recipe_trainer(torch, data, recipe, dtype, init, total_steps, lr=1e-3):
    """The recipe's trainer on the card; ``total_steps`` None: a constant rate."""
    from tti_torch.train.loop import build_model, build_trainer

    model = build_model("n", 2, recipe["mask_stride"], recipe["proto_head"], dtype, "cuda", init)
    return build_trainer(data, model, recipe["batch"], recipe["max_gt"], total_steps, lr, dtype,
                         recipe["gains"])


def finite_losses(metrics, label) -> dict:
    vals = {k: float(metrics[k]) for k in LOSS_KEYS}
    check(all(np.isfinite(v) for v in vals.values()), f"{label}: a loss term is not finite: {vals}")
    return vals


def check_train_card_vs_cpu(torch) -> dict:
    """One float32 step (forward, loss, backward) at imgsz 64, batch 2, on
    the card and on the CPU, same weights and batch, TF32 off. cuDNN and
    the CPU differ by summation order only: loss terms within 1e-4
    relative, every gradient within 1e-3 of its tensor's largest entry."""
    from torch_scenes import textile_samples
    from tti_torch.train.data import scene_to_targets
    from tti_torch.train.loop import build_model
    from tti_torch.train.step import Targets, TrainStep

    imgs, tgts = [], []
    for s in textile_samples(2, 64, seed=3):
        img, t = scene_to_targets(s.image.astype(np.float32) / 255.0, s.polygons, s.classes, 64, 8,
                                  mask_stride=2, soft_masks="stitch")
        imgs.append(img)
        tgts.append(t)
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model("n", 2, 2, "subpixel", torch.float32, dev, CAM_CKPT)
        targets = Targets(*(torch.from_numpy(np.stack([t[k] for t in tgts])).to(dev)
                            for k in ("boxes", "classes", "masks", "valid")))
        step = TrainStep((64, 64), seg_class_gains=(2.0, 1.0))
        total, losses = step.loss(model, torch.from_numpy(np.stack(imgs)).to(dev), targets)
        total.backward()
        terms = {"total": total, **losses}
        out[dev] = ({k: float(v.detach()) for k, v in terms.items()},
                    {n: p.grad.cpu() for n, p in model.named_parameters()})
    (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
    loss_rel = max(abs(lc[k] - lh[k]) / max(abs(lh[k]), 1e-12) for k in LOSS_KEYS)
    check(loss_rel <= 1e-4, f"train card vs cpu: loss terms differ by {loss_rel} relative: {lc} {lh}")
    grad_rel = max(float((gc[n] - gh[n]).abs().max()) / max(float(gh[n].abs().max()), 1e-12)
                   for n in gh)
    check(grad_rel <= 1e-3, f"train card vs cpu: a gradient differs by {grad_rel} of its largest entry")
    check(lc["seg"] > 0 and lc["box"] > 0, "train card vs cpu: the batch has no positives")
    log(f"train step card vs CPU (float32, imgsz 64, batch 2, TF32 off): loss terms max rel diff "
        f"{loss_rel:.3g} (limit 1e-4), gradients max diff {grad_rel:.3g} of each tensor's largest "
        f"entry over {len(gh)} tensors (limit 1e-3); total {lc['total']:.5f}")
    return {"loss_max_rel_diff": loss_rel, "grad_max_rel_diff": grad_rel, "total": lc["total"]}


def state_tensors(torch, state) -> dict:
    """Every tensor of a TrainState, by name, for bitwise comparison."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in state.ema.items()})
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items() if isinstance(v, torch.Tensor)})
    return out


def check_resume_bit_equal(torch, data, recipe, out_dir) -> dict:
    """Save at step 10 and restore into a fresh state: 5 more steps equal 15
    uninterrupted steps bit for bit (cuDNN deterministic, no autotuning)."""
    from tti_torch.train.checkpoint import restore_train_state, save_train_state

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        straight = recipe_trainer(torch, data, recipe, torch.bfloat16, CAM_CKPT,
                                  recipe["total_steps"])
        for i in range(1, 16):
            straight.train_step(i)
        first = recipe_trainer(torch, data, recipe, torch.bfloat16, CAM_CKPT, recipe["total_steps"])
        for i in range(1, 11):
            first.train_step(i)
        path = save_train_state(first.state, out_dir, step=10)
        del first
        resumed = recipe_trainer(torch, data, recipe, torch.bfloat16, CAM_CKPT,
                                 recipe["total_steps"])
        restore_train_state(path, resumed.state)
        check(resumed.state.step == 10, "resume: the restored step is not 10")
        for i in range(11, 16):
            resumed.train_step(i)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    a, b = state_tensors(torch, straight.state), state_tensors(torch, resumed.state)
    check(a.keys() == b.keys(), "resume: the states hold different tensors")
    differ = [k for k in a if a[k].device != b[k].device or not torch.equal(a[k], b[k])]
    check(not differ and straight.state.step == resumed.state.step == 15,
          f"resume: {len(differ)} of {len(a)} tensors differ after 15 steps, e.g. {differ[:5]}")
    log(f"r5s resume: saved at step 10 ({os.path.getsize(path) / 1e6:.1f} MB), restored into a "
        f"fresh state, 5 more steps: all {len(a)} tensors (params, BN statistics, EMA, AdamW "
        f"state) bit-equal to 15 uninterrupted steps")
    return {"tensors": len(a), "checkpoint_mb": os.path.getsize(path) / 1e6}


# bf16 against float32, relative difference of the first step's loss terms
# (no update) on the same weights and batch. The limits are about 3x the
# largest readings on an H100 over the r5s batches 1-4 (total 1.6e-3, the
# cls term 6.9e-3).
BF16_TOTAL_LIMIT = 5e-3
BF16_TERM_LIMIT = 2e-2


def low_precision_loss_ops(torch, step, model, images, targets) -> dict:
    """The aten ops that make a floating tensor other than float32 after the
    model's forward returns, with their counts, over ``step.loss``: where
    bf16 stops. A forward hook on the model marks the head's exit."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    found = {}

    class Record(TorchDispatchMode):
        after_head = False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if self.after_head and any(isinstance(t, torch.Tensor) and t.is_floating_point()
                                       and t.dtype != torch.float32 for t in tree_leaves(out)):
                found[str(func)] = found.get(str(func), 0) + 1
            return out

    mode = Record()
    hook = model.register_forward_hook(lambda *_: setattr(mode, "after_head", True))
    try:
        with torch.no_grad(), mode:
            step.loss(model, images, targets)
    finally:
        hook.remove()
    return found


def check_bf16(torch, data, trainer, batches=(1, 2, 3, 4)) -> dict:
    """r5s in bf16 against float32. Where bf16 stops: the bf16 model's loss
    makes no tensor in a lower precision after the head, and the same
    detector flags the seg loss run with ``seg_dtype=torch.bfloat16`` (the
    control). Then the first step's loss terms on ``batches``: the total
    within BF16_TOTAL_LIMIT and each term within BF16_TERM_LIMIT, relative.
    The control's own shift of the float32 model's seg term is printed: a
    comparison of loss values cannot resolve it, the detector can."""
    from tti_torch.train.loop import build_model
    from tti_torch.train.step import TrainStep

    models = {name: build_model("n", 2, R5S["mask_stride"], R5S["proto_head"], dt, "cuda", CAM_CKPT)
              for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32))}
    images, targets = trainer.batch(batches[0])
    sound = low_precision_loss_ops(torch, trainer.step_fn, models["bf16"], images, targets)
    check(not sound, f"r5s bf16: the loss runs ops below float32: {sound}")
    seg_bf16 = TrainStep(trainer.step_fn.input_hw, R5S["gains"], seg_dtype=torch.bfloat16)
    control = low_precision_loss_ops(torch, seg_bf16, models["bf16"], images, targets)
    check(control, "r5s bf16: the detector missed the seg loss in bf16 (the control)")
    rel = {k: 0.0 for k in LOSS_KEYS}
    control_seg = 0.0
    firsts = []
    for i in batches:
        images, targets = trainer.batch(i)
        terms = {}
        for name, model, step in (("bf16", models["bf16"], trainer.step_fn),
                                  ("f32", models["f32"], trainer.step_fn),
                                  ("f32_seg_bf16", models["f32"], seg_bf16)):
            with torch.no_grad():
                total, losses = step.loss(model, images.float(), targets)
            terms[name] = {"total": float(total), **{k: float(v) for k, v in losses.items()}}
        for k in LOSS_KEYS:
            rel[k] = max(rel[k], abs(terms["bf16"][k] - terms["f32"][k]) / abs(terms["f32"][k]))
        control_seg = max(control_seg, abs(terms["f32_seg_bf16"]["seg"] - terms["f32"]["seg"])
                          / abs(terms["f32"]["seg"]))
        firsts.append(terms)
    check(rel["total"] <= BF16_TOTAL_LIMIT and max(rel.values()) <= BF16_TERM_LIMIT,
          f"r5s bf16 vs float32 first-step loss terms, max relative difference over batches "
          f"{batches}: {rel} (limits: total {BF16_TOTAL_LIMIT}, each term {BF16_TERM_LIMIT})")
    log(f"r5s bf16: the loss makes no tensor below float32 after the head; the control "
        f"(seg_dtype=bf16) is flagged at {sum(control.values())} ops ({', '.join(sorted(control))}) "
        f"and moves the float32 model's seg term by at most {control_seg:.3g} relative")
    log(f"r5s first-step loss terms, bf16 against float32 over batches {list(batches)}: max relative "
        f"difference " + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
        + f" (limits: total {BF16_TOTAL_LIMIT}, each term {BF16_TERM_LIMIT}); batch "
        f"{batches[0]} totals bf16 {firsts[0]['bf16']['total']:.5f}, float32 "
        f"{firsts[0]['f32']['total']:.5f}")
    del models
    return {"rel_diff": rel, "terms": firsts, "control_ops": control,
            "control_seg_rel_diff": control_seg}


def time_training(torch, trainer, label, start, n, iters=10, part_iters=5) -> dict:
    """The trainer's own loop (batch ``n``), ``trainer.train_step`` with one
    synchronisation at the end as in ``loop.run``: images/s, ms per step
    and peak device memory over ``iters`` steps, then the profiler's device
    busy time over 3 more steps of the same loop, whose idle share is
    1 - busy / (ms per step). Then, in a separate loop of ``part_iters``
    steps through ``TrainStep``'s public parts, the ms of each part (CUDA
    events between augment, forward + loss, backward, optimizer + EMA, read
    after one synchronisation at the end)."""
    nxt = [start]

    def one_step():
        trainer.train_step(nxt[0])
        nxt[0] += 1

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        one_step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = 1e3 * wall / iters
    per_name, busy, n_ops = device_time(torch, one_step, 3)
    idle = None if busy is None else 1.0 - busy / step_ms

    step, state = trainer.step_fn, trainer.state
    marks = []
    for _ in range(part_iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        images, targets = trainer.batch(nxt[0])
        nxt[0] += 1
        ev[1].record()
        state.optimizer.zero_grad(set_to_none=True)
        total, _ = step.loss(state.model, images, targets)
        ev[2].record()
        total.backward()
        ev[3].record()
        step.update(state)
        ev[4].record()
        marks.append(ev)
    torch.cuda.synchronize()
    parts = {key: sum(ev[j].elapsed_time(ev[j + 1]) for ev in marks) / part_iters
             for j, key in enumerate(("augment", "forward_loss", "backward", "optimizer_ema"))}
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"{label} training (train_step, one sync per {iters} steps): {n * iters / wall:.1f} "
        f"images/s at batch {n}, {step_ms:.2f} ms per step; peak device memory {peak_gb:.2f} GB; "
        f"device busy " + (f"{busy:.2f} ms per step, idle share {idle:.1%}, {n_ops} device ops "
                           f"per step" if busy else "not measured (no device events)"))
    log(f"{label} per part ms over {part_iters} more steps (events, one sync): "
        + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.2f}")
    for name, t in top:
        log(f"  {t:8.3f} ms  {name[:110]}")
    return {"images_per_s": n * iters / wall, "batch": n, "step_ms": step_ms, "parts_ms": parts,
            "peak_memory_gb": peak_gb, "busy_ms": busy, "idle_share": idle, "ops_per_step": n_ops,
            "top_kernels_ms": dict(top)}


def check_training(torch, ms, wp, card) -> dict:
    """Phase 6 (see the module docstring). Launch counts are set to 0 before
    the training path and read after it: training launches no kernel; the
    deploy step with the exported checkpoint launches kernel A."""
    from tti_torch.cli.__main__ import main as cli
    from tti_torch.train.checkpoint import save_train_state

    out_dir = os.path.join(HERE, "build", "train_smoke")
    result = {"card": card, "card_vs_cpu": check_train_card_vs_cpu(torch)}

    t0 = time.perf_counter()
    data = train_dataset(torch, R5S, seed=101)
    log(f"r5s dataset: {data.images.shape[0]} scenes at {data.imgsz} px on the card, masks "
        f"{tuple(data.masks.shape[1:])} (soft={data.soft}), {int(data.valid.sum())} GT, built in "
        f"{time.perf_counter() - t0:.1f} s")
    reset_launch_counts(ms, wp)
    trainer = recipe_trainer(torch, data, R5S, torch.bfloat16, CAM_CKPT, R5S["total_steps"])
    t0 = time.perf_counter()
    aug = [finite_losses(trainer.train_step(i), f"r5s augmented step {i}") for i in range(1, 31)]
    torch.cuda.synchronize()
    launches = launch_counts(ms, wp)
    check(not any(launches.values()), f"training launched a kernel: {launches}")
    log(f"r5s (YOLOv8n-seg, imgsz 960, mask stride 2 sub-pixel, soft masks, stitch seg gain 2.0, "
        f"max_gt 16, batch 8, bf16, --init {os.path.basename(CAM_CKPT)}): 30 augmented steps in "
        f"{time.perf_counter() - t0:.1f} s, every loss term finite; totals step 1 "
        f"{aug[0]['total']:.4f}, step 30 {aug[-1]['total']:.4f}; kernel launches {launches}")
    result["r5s_augmented_totals"] = [a["total"] for a in aug]
    ckpt = save_train_state(trainer.state, out_dir)

    # One fixed batch, 30 steps at the recipe's peak rate (constant).
    images, targets = trainer.batch(1)
    fixed = recipe_trainer(torch, data, R5S, torch.bfloat16, CAM_CKPT, None)
    totals = [finite_losses(fixed.step_fn(fixed.state, images, targets), "r5s fixed batch")["total"]
              for _ in range(30)]
    first5, last5 = float(np.mean(totals[:5])), float(np.mean(totals[-5:]))
    check(last5 < first5, f"r5s fixed batch: the loss does not fall ({first5} -> {last5})")
    log(f"r5s fixed batch, 30 steps at lr 1e-3: mean total of the first 5 {first5:.4f}, of the "
        f"last 5 {last5:.4f}")
    result["r5s_fixed_batch"] = {"first5": first5, "last5": last5, "totals": totals}
    del fixed

    result["r5s_bf16_vs_f32"] = check_bf16(torch, data, trainer)
    result["r5s_resume"] = check_resume_bit_equal(torch, data, R5S, out_dir)
    result["r5s_timing"] = time_training(torch, trainer, "r5s", 31, R5S["batch"])
    del trainer, data
    torch.cuda.empty_cache()

    # Back into the inspection step: the EMA through export-weights.
    deploy = os.path.join(out_dir, "r5s_ema.msgpack")
    check(cli(["export-weights", "--train-dir", ckpt, "--out", deploy, "--imgsz", "960",
               "--mask-stride", "2", "--proto-head", "subpixel", "--soft-masks",
               "--recipe", "chip_smoke r5s: 30 steps from the deploy checkpoint"]) == 0,
          "export-weights failed")
    check_step(torch, ms, wp, "deploy step with the exported r5s EMA checkpoint", (960, 1280), 960,
               deploy, ("mask_stats_soft",))
    torch.cuda.empty_cache()

    # The headline geometry from scratch.
    data = train_dataset(torch, HEADLINE_TRAIN, seed=202)
    reset_launch_counts(ms, wp)
    trainer = recipe_trainer(torch, data, HEADLINE_TRAIN, torch.bfloat16, None,
                             HEADLINE_TRAIN["total_steps"])
    head = [finite_losses(trainer.train_step(i), f"headline step {i}") for i in range(1, 11)]
    check(not any(launch_counts(ms, wp).values()), "training launched a kernel")
    totals = ", ".join(f"{h['total']:.3f}" for h in head)
    log(f"headline from scratch (imgsz 640, mask stride 4, binary masks, max_gt 32, batch 64, bf16, "
        f"fresh init_model): 10 steps, every loss term finite; totals {totals}")
    result["headline_totals"] = [h["total"] for h in head]
    result["headline_timing"] = time_training(torch, trainer, "headline from scratch", 11,
                                               HEADLINE_TRAIN["batch"])
    del trainer, data
    torch.cuda.empty_cache()
    log(card)
    return result


# ---------------------------------------------------------------------------
# Phase 7: the application (``run`` and ``eval``)
# ---------------------------------------------------------------------------


# The deployed geometry and the phase's depth.
APP = dict(device="cuda", frame_hw=(960, 1280), imgsz=960, frames=32, scenes=16, chunk=8,
           cpu_scenes=2)
APP_DIR = os.path.join(HERE, "build", "app_smoke")


class CountingTransport:
    """A scripted ESP32 stitch counter for ``SerialReader``: it sends the
    count when the count changes, and ``read_available`` waits up to 50 ms
    for a change, so the reader's thread takes a new count at once."""

    def __init__(self):
        import threading

        self.cond = threading.Condition()
        self.count = self.sent = 0
        self.is_open = True

    def advance(self, n: int) -> None:
        with self.cond:
            self.count += n
            self.cond.notify_all()

    def read_available(self) -> bytes:
        with self.cond:
            self.cond.wait_for(lambda: self.count != self.sent or not self.is_open, timeout=0.05)
            if self.count == self.sent:
                return b""
            self.sent = self.count
            return f"{self.count}\n".encode()

    def close(self) -> None:
        with self.cond:
            self.is_open = False
            self.cond.notify_all()


class StitchedFrames:
    """Fixed frames as a camera on a sewing line: each read advances the
    stitch counter by ``PER_FRAME`` and returns once the serial reader has
    the new count, so a blocking tick sees a delta of exactly ``PER_FRAME``."""

    PER_FRAME = 5

    def __init__(self, frames, transport, reader):
        self.frames = list(frames)
        self.transport, self.reader = transport, reader

    def read(self):
        if not self.frames:
            return False, None
        self.transport.advance(self.PER_FRAME)
        deadline = time.monotonic() + 1.0
        while self.reader.get_stitch_count() != self.transport.count:
            check(time.monotonic() < deadline, "the serial reader did not take the count")
            time.sleep(0)
        return True, self.frames.pop(0)

    def reconnect(self): ...

    def release(self): ...


def run_loop(ms, wp, pipe, frames, tag, pipelined=False) -> dict:
    """``frames`` through the Orchestrator's own loop (``run``) at
    inference interval 0, with a sqlite database, the scripted serial
    counter and ``random.Random(0)``; launch counts set to 0 just before and
    read just after. Returns the per-frame results, frames/s (from the start
    of ``run`` to the end of the last frame's fusion, so the services'
    shutdown is outside), the host ms of ``_fuse_outputs``, of drawing the
    annotated frame and of saving it, the stage timer, the launches and the
    database's row count."""
    import random
    import sqlite3

    from tti_torch.app.orchestrator import Orchestrator
    from tti_torch.core.config import AppConfig, DatabaseConfig, RuntimeConfig, SerialConfig
    from tti_torch.services.serial_reader import SerialReader

    d = os.path.join(APP_DIR, tag)
    os.makedirs(d, exist_ok=True)
    cfg = AppConfig(model=pipe.model_cfg, measure=pipe.measure_cfg,
                    database=DatabaseConfig(sqlite_path=os.path.join(d, "line.db")),
                    runtime=RuntimeConfig(inference_interval_s=0.0,
                                          save_dir=os.path.join(d, "saved_annotations")))
    transport = CountingTransport()
    reader = SerialReader(SerialConfig(port="scripted"), transport_factory=lambda port: transport,
                          port_detector=lambda: None)
    check(reader.start_reading(), f"{tag}: the scripted serial reader did not start")
    orch = Orchestrator(cfg, pipe, StitchedFrames(frames, transport, reader),
                        rng=random.Random(0))
    orch.init_services()  # no ESP32, no MQTT server: the counter is the scripted one
    orch.serial = reader
    results, fusion_s, done = [], [], []
    fuse = orch._fuse_outputs

    def timed_fuse(outs):
        t = time.perf_counter()
        results.append(fuse(outs))
        done.append(time.perf_counter())
        fusion_s.append(done[-1] - t)
        return results[-1]

    orch._fuse_outputs = timed_fuse
    jpeg_s = {"render": [], "save": []}

    def timed(name, fn):
        def call(*args):
            t = time.perf_counter()
            out = fn(*args)
            jpeg_s[name].append(time.perf_counter() - t)
            return out
        return call

    orch.render_annotated = timed("render", orch.render_annotated)
    orch.save_annotated_frame = timed("save", orch.save_annotated_frame)
    reset_launch_counts(ms, wp)
    t0 = time.perf_counter()
    orch.run(max_frames=len(frames), pipelined=pipelined)
    launches = launch_counts(ms, wp)
    with sqlite3.connect(cfg.database.sqlite_path) as con:
        rows = con.execute('SELECT COUNT(*) FROM "measurements"').fetchone()[0]
    check(orch.frame_count == len(frames) == len(results),
          f"{tag}: {orch.frame_count} frames processed, {len(results)} fused, of {len(frames)}")
    # One annotated JPEG per frame where OpenCV imports, none where it does not.
    jpegs = len(glob.glob(os.path.join(cfg.runtime.save_dir, "*", "frame_*.jpg")))
    check(jpegs == (len(frames) if opencv_version() else 0),
          f"{tag}: {jpegs} annotated JPEGs for {len(frames)} frames (cv2 {opencv_version()})")
    return {"results": results, "frames_per_s": len(results) / (done[-1] - t0),
            "fusion_ms_p50": 1e3 * float(np.median(fusion_s)),
            "fusion_ms_mean": 1e3 * float(np.mean(fusion_s)), "timer": orch.timer.summary(),
            "render_ms_p50": 1e3 * float(np.median(jpeg_s["render"] or [0.0])),
            "save_ms_p50": 1e3 * float(np.median(jpeg_s["save"] or [0.0])),
            "launches": launches, "rows": rows, "inserted": sum(r["inserted"] for r in results),
            "jpegs": jpegs}


def opencv_version() -> str | None:
    """OpenCV's version where it imports (the loop then saves annotated
    JPEGs), else None."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2.__version__


def check_cli() -> dict:
    """``python -m tti_torch.cli run`` in a subprocess, from a working
    directory that holds a .env (the cam checkpoint, a sqlite path, the
    geometry) and the calibration files written by ``tti_torch.calib.io``:
    two frames of the single-camera loop at the reference's 2 s cadence,
    then four synthetic cameras through ``MultiStreamRunner``."""
    from tti_torch.calib.io import save_extrinsics, save_intrinsics

    d = os.path.join(APP_DIR, "cli")
    os.makedirs(d, exist_ok=True)
    (h, w), roi = APP["frame_hw"], bench_roi(APP["frame_hw"])
    calib = bench_calibration(APP["frame_hw"])
    save_intrinsics(calib.K, calib.dist, os.path.join(d, "camera_calibration.json"),
                    image_size=(w, h))
    save_extrinsics(calib.rvec, calib.tvec, os.path.join(d, "extrinsics.json"))
    with open(os.path.join(d, ".env"), "w", encoding="utf-8") as f:
        f.write(f"TTI_WEIGHTS={CAM_CKPT}\nTTI_SQLITE_PATH=line.db\nCALIB_W={w}\nCALIB_H={h}\n"
                f"TTI_IMAGE_SIZE={APP['imgsz']}\nROI_X_MIN={roi.x_min}\nROI_X_MAX={roi.x_max}\n"
                f"ROI_Y_MIN={roi.y_min}\nROI_Y_MAX={roi.y_max}\n")
    env = dict(os.environ, PYTHONPATH=HERE, TTI_LOG_JSON="1")
    out = {}
    for label, extra in (("run", ["--skip-calibration"]), ("run --cameras 4", ["--cameras", "4"])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "tti_torch.cli", "run", "--synthetic",
                               "--max-frames", "2", "--device", APP["device"], *extra],
                              cwd=d, env=env, capture_output=True, text=True, timeout=300)
        secs = time.perf_counter() - t0
        check(proc.returncode == 0, f"cli {label}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
        records = []
        for line in proc.stderr.splitlines():
            with contextlib.suppress(ValueError):
                records.append(json.loads(line))
        msgs = [r.get("msg", "") for r in records]
        if label == "run":
            n = sum(m == "measurement" for m in msgs)
            check(n == 2, f"cli {label}: {n} measurement records, expected 2")
        else:
            n = sum(m.startswith("stream ") for m in msgs)
            check(n == 8 and "multistream shutdown: 2 batches x 4 streams" in msgs,
                  f"cli {label}: {n} stream records; {msgs[-3:]}")
        out[label] = {"seconds": secs, "records": n}
        log(f"cli `python -m tti_torch.cli {label} --synthetic --max-frames 2`: exit 0 in "
            f"{secs:.1f} s, {n} records")
    return out


def matched_mask_ious(a, b, min_box_iou=0.5) -> list[float]:
    """Mask IoU of ``masks_input`` over detections of ``a`` matched to
    ``b`` (same image and class, greedy by box IoU >= ``min_box_iou``)."""
    from tti_torch.train.eval import box_iou

    out = []
    for i in range(a.valid.shape[0]):
        m = a.masks_input.shape[1]
        ia = np.flatnonzero(a.valid[i][:m])
        ib = np.flatnonzero(b.valid[i][:m])
        iou = box_iou(a.boxes[i][ia], b.boxes[i][ib])
        same = a.classes[i][ia][:, None] == b.classes[i][ib][None, :]
        iou = np.where(same, iou, 0.0)
        taken = np.zeros(len(ib), bool)
        for r in range(len(ia)):
            cand = np.where(taken, -1.0, iou[r])
            if cand.size == 0 or cand.max() < min_box_iou:
                continue
            c = int(cand.argmax())
            taken[c] = True
            ma, mb = a.masks_input[i, ia[r]] > 0, b.masks_input[i, ib[c]] > 0
            union = int((ma | mb).sum())
            out.append(1.0 if union == 0 else int((ma & mb).sum()) / union)
    return out


def check_eval(torch) -> dict:
    """``tti eval``'s loop (``evaluate_samples``) with ``Predictor`` at the
    deployed recipe (cam checkpoint, imgsz 960, stride 2, sub-pixel protos,
    bf16) over seeded scenes in chunks of 8: box mAP, mask mAP at the proto
    grid and at full resolution, images/s of the predict calls and the host
    seconds of ``evaluate``. Then bf16 against float32 on the card (median
    mask IoU of matched detections >= 0.999, the reference's own parity
    target) and the card's float32 against the CPU's (valid rows and classes
    equal, boxes within 1e-2 px, every mask IoU >= 0.999)."""
    from torch_scenes import textile_samples
    from tti_torch.app.predict import Predictor
    from tti_torch.core.config import ModelConfig
    from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
    from tti_torch.train.eval import evaluate_samples

    imgsz, chunk, dev = APP["imgsz"], APP["chunk"], APP["device"]
    meta = checkpoint_metadata(CAM_CKPT)
    variables = load_flax_msgpack(CAM_CKPT)

    def predictor(dtype, device):
        cfg = ModelConfig(weights=CAM_CKPT, image_size=imgsz, dtype=dtype,
                          mask_stride=meta["mask_stride"], proto_head=meta["proto_head"])
        return Predictor(cfg, variables, (imgsz, imgsz), mask_topk=64, proto_masks=True,
                         device=device)

    t0 = time.perf_counter()
    samples = textile_samples(APP["scenes"], imgsz, seed=303)
    scenes_s = time.perf_counter() - t0
    bgr = np.ascontiguousarray(np.stack([s.image[..., ::-1] for s in samples[:chunk]]))
    bf16 = predictor("bfloat16", dev)
    bf16(bgr)  # warm-up at the chunk's shape
    res = evaluate_samples(samples, bf16, imgsz, meta.get("num_classes", 2), meta["mask_stride"],
                           chunk=chunk)
    for key in ("box", "mask_proto", "mask_full"):
        check(all(np.isfinite(v) for v in res[key].values()), f"eval {key}: not finite")
    check(res["mask_full"]["mAP50"] > 0.0, "eval: the deploy checkpoint found nothing")
    fps = res["images"] / res["predict_s"]
    fmt = lambda d: {k: round(v, 4) for k, v in d.items()}
    log(f"eval ({res['images']} seeded scenes at {imgsz}, chunks of {chunk}, bf16; scenes drawn in "
        f"{scenes_s:.1f} s): box {fmt(res['box'])}; mask (proto grid) {fmt(res['mask_proto'])}; "
        f"mask (full resolution) {fmt(res['mask_full'])}; predict {fps:.1f} images/s; evaluate "
        f"{res['evaluate_s']:.2f} s on the host")

    f32 = predictor("float32", dev)
    a, b = bf16(bgr), f32(bgr)
    ious = matched_mask_ious(a, b)
    med = float(np.median(ious)) if ious else 0.0
    check(len(ious) > 0 and med >= 0.999,
          f"eval bf16 vs float32: median mask IoU {med} over {len(ious)} matched detections")
    log(f"predict bf16 against float32 on the card ({chunk} scenes): {len(ious)} matched "
        f"detections of {int(a.valid.sum())} / {int(b.valid.sum())}, mask IoU median {med:.5f} "
        f"(limit 0.999), min {min(ious):.4f}")

    n = APP["cpu_scenes"]
    g, c = f32(bgr[:n]), predictor("float32", "cpu")(bgr[:n])
    np.testing.assert_array_equal(g.valid, c.valid)
    np.testing.assert_array_equal(g.classes[g.valid], c.classes[c.valid])
    box_err = float(np.abs(g.boxes[g.valid] - c.boxes[c.valid]).max()) if g.valid.any() else 0.0
    cpu_ious = matched_mask_ious(g, c)
    check(box_err <= 1e-2, f"predict card vs CPU: boxes differ by {box_err} px")
    check(len(cpu_ious) == int(g.valid[:, :g.masks_input.shape[1]].sum())
          and min(cpu_ious, default=1.0) >= 0.999,
          f"predict card vs CPU: mask IoUs {sorted(cpu_ious)[:3]} over {len(cpu_ious)}")
    log(f"predict float32 card against CPU ({n} scenes): {int(g.valid.sum())} detections, boxes "
        f"max abs diff {box_err:.3g} px (limit 1e-2), mask IoU min {min(cpu_ious, default=1.0):.5f} "
        f"(limit 0.999)")
    return {"box": res["box"], "mask_proto": res["mask_proto"], "mask_full": res["mask_full"],
            "predict_images_per_s": fps, "evaluate_host_s": res["evaluate_s"],
            "bf16_vs_f32_mask_iou_median": med, "bf16_vs_f32_matched": len(ious),
            "card_vs_cpu_box_max_diff": box_err,
            "card_vs_cpu_mask_iou_min": min(cpu_ious, default=1.0)}


def check_application(torch, ms, wp, step_p50_ms) -> dict:
    """Phase 7 (see the module docstring)."""
    import shutil

    from tti_torch.cli.__main__ import load_pipeline
    from tti_torch.core.config import AppConfig, ModelConfig

    shutil.rmtree(APP_DIR, ignore_errors=True)
    os.makedirs(APP_DIR)
    frame_hw, n = APP["frame_hw"], APP["frames"]
    cfg = AppConfig(model=ModelConfig(weights=CAM_CKPT, image_size=APP["imgsz"]),
                    roi=bench_roi(frame_hw))
    t0 = time.perf_counter()
    pipe = load_pipeline(cfg, frame_hw, bench_calibration(frame_hw), device=APP["device"])
    setup_s = time.perf_counter() - t0
    check(pipe.model_cfg.mask_stride == 2 and pipe.measure_cfg.subcell_edge,
          "run: the sidecar's architecture and readout were not adopted")
    frames = list(textile(frame_hw, n))
    lats = []
    for i in range(12):  # the first two warm the batch-1 shapes
        t = time.perf_counter()
        pipe.process_batch(frames[i % n][None])
        lats.append(time.perf_counter() - t)
    process_p50 = 1e3 * float(np.median(lats[2:]))

    blocking = run_loop(ms, wp, pipe, frames, "blocking")
    piped = run_loop(ms, wp, pipe, frames, "pipelined", pipelined=True)
    with stats_route(ms.mask_stats_soft_plain, ms.mask_stats_binary_plain):
        plain = run_loop(ms, wp, pipe, frames, "plain")
    for tag, loop in (("blocking", blocking), ("pipelined", piped)):
        check(loop["launches"]["mask_stats_soft"] == n and not loop["launches"]["mask_stats_binary"],
              f"run {tag}: kernel A once per frame expected, launches {loop['launches']}")
        check(loop["rows"] == loop["inserted"] + 1,
              f"run {tag}: {loop['rows']} rows for {loop['inserted']} inserts + the reset row")
    check(not any(plain["launches"].values()), f"run plain: launched {plain['launches']}")
    check(blocking["inserted"] > 0, "run: nothing was inserted")
    keys = ("valid", "edge_distance_mm", "stitch_width_mm", "seam_mm", "width_mm", "stitch_count")
    seq = lambda loop: [tuple(r[k] for k in keys) for r in loop["results"]]
    check(seq(piped) == seq(blocking), "run: the pipelined readings differ from the blocking ones")
    # The pipelined loop fuses frame N after frame N+1's counter read, and
    # its last frame after no new read: the stitch deltas move one tick
    # earlier and the last frame inserts nothing.
    per = StitchedFrames.PER_FRAME
    check([r["stitch_delta"] for r in blocking["results"]] == [per] * n
          and [r["stitch_delta"] for r in piped["results"]] == [2 * per] + [per] * (n - 2) + [0],
          "run: the stitch deltas are not the expected ones")
    ins = lambda loop: [r["inserted"] for r in loop["results"]]
    check(ins(piped) == ins(blocking)[:-1] + [False],
          "run: the pipelined inserts are not the blocking ones shifted by the last tick")
    flags = lambda loop: [(r["valid"], r["inserted"]) for r in loop["results"]]
    check(flags(plain) == flags(blocking), "run: valid/inserted differ on the plain route")
    worst = 0.0
    for got, ref in zip(blocking["results"], plain["results"]):
        for key in ("seam_mm", "width_mm"):
            check((got[key] is None) == (ref[key] is None), f"run plain: {key} presence differs")
            if got[key] is not None:
                worst = max(worst, abs(got[key] - ref[key]))
    check(worst <= 1e-2, f"run: kernel and plain routes differ by {worst} mm")
    measured = sum(r["edge_distance_mm"] is not None for r in blocking["results"])
    check(measured > 0, "run: no frame measured")
    host_ms = lambda loop: (f"fusion p50 {loop['fusion_ms_p50']:.3f} ms, annotated frame: draw "
                            f"p50 {loop['render_ms_p50']:.3f} ms, save p50 "
                            f"{loop['save_ms_p50']:.3f} ms")
    stages = lambda loop: ", ".join(f"{k} p50 {v['p50_ms']:.3f} ms (mean {v['mean_ms']:.3f})"
                                    for k, v in loop["timer"].items())
    log(f"run ({n} frames {frame_hw[0]}x{frame_hw[1]}, imgsz {APP['imgsz']}, cam checkpoint, bf16, "
        f"interval 0, cv2 {opencv_version() or 'absent'}: {blocking['jpegs']} annotated JPEGs per "
        f"loop; pipeline set-up {setup_s:.1f} s): blocking {blocking['frames_per_s']:.2f} "
        f"frames/s [{stages(blocking)}; {host_ms(blocking)}], pipelined "
        f"{piped['frames_per_s']:.2f} frames/s [{stages(piped)}; {host_ms(piped)}]; batch-1 "
        f"process_batch p50 {process_p50:.3f} ms, "
        f"device-resident step p50 {step_p50_ms:.3f} ms (phase 4)")
    log(f"run: kernel A launches {blocking['launches']['mask_stats_soft']} (blocking), "
        f"{piped['launches']['mask_stats_soft']} (pipelined); {measured} of {n} frames measured; "
        f"inserts {blocking['inserted']} / {piped['inserted']}, rows {blocking['rows']} / "
        f"{piped['rows']}; pipelined readings = blocking, its stitch deltas and inserts one "
        f"tick earlier (last frame: delta 0, no insert); kernel vs plain route: valid/inserted "
        f"equal, seam/width max diff {worst:.3g} mm (limit 0.01)")
    summary = lambda loop: {k: loop[k] for k in ("frames_per_s", "fusion_ms_p50",
                                                 "fusion_ms_mean", "render_ms_p50", "save_ms_p50",
                                                 "timer", "launches", "rows", "inserted", "jpegs")}
    result = {"opencv": opencv_version(), "blocking": summary(blocking),
              "pipelined": summary(piped),
              "plain_route_max_mm_diff": worst, "measured_frames": measured,
              "process_batch_b1_p50_ms": process_p50, "step_b1_p50_ms": step_p50_ms}
    del pipe
    if APP["device"] == "cuda":
        torch.cuda.empty_cache()
    result["cli"] = check_cli()
    result["eval"] = check_eval(torch)
    return result


# ---------------------------------------------------------------------------
# Phase 8: calibrate, then measure
# ---------------------------------------------------------------------------


CAL_DIR = os.path.join(HERE, "build", "calib_smoke")
BOARD_PX_PER_M = 16000  # board texture: 0.0625 mm per texel, finer than a frame pixel
REPORT_SCENES = 16  # the first scenes of the mm report's seed 0


def board_texture(board):
    """The board's image at BOARD_PX_PER_M (texel (u, v) = board point (u, v) / BOARD_PX_PER_M m)."""
    cfg = board.config
    size = (int(cfg.squares_y * cfg.square_length_m * BOARD_PX_PER_M),
            int(cfg.squares_x * cfg.square_length_m * BOARD_PX_PER_M))
    return board.board.generateImage(size, marginSize=0, borderBits=1)


def deployment_board_view(cv2, mapper, texture, origin_mm):
    """The board lying on the fabric plane with its origin at world
    ``origin_mm``, seen by the deployment camera: the texture sampled at
    every pixel's plane point (so the view carries the lens distortion
    exactly), pre-inverted (the detector inverts), 3-channel."""
    b = (mapper.plane_mm - origin_mm) * (BOARD_PX_PER_M / 1000.0)
    view = cv2.remap(texture, b[..., 0].astype(np.float32), b[..., 1].astype(np.float32),
                     cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT, borderValue=255)
    return cv2.cvtColor(cv2.bitwise_not(view), cv2.COLOR_GRAY2BGR)


def pinhole_board_views(cv2, texture, n=8, hw=(960, 1280)):
    """``n`` views of the board at diverse tilts and depths through a
    zero-distortion camera (fx = fy = 880), pre-inverted: calibrate-intrinsics'
    input (tests/test_charuco.py's pose sweep)."""
    K = np.array([[880.0, 0, hw[1] / 2], [0, 880.0, hw[0] / 2], [0, 0, 1.0]])
    S = np.diag([1.0 / BOARD_PX_PER_M, 1.0 / BOARD_PX_PER_M, 1.0])
    rng = np.random.default_rng(3)
    views = []
    for k in range(n):
        ang = 2 * np.pi * k / n
        tilt = 0.35 + 0.15 * rng.uniform()
        rvec = np.array([tilt * np.cos(ang), tilt * np.sin(ang), 0.0]) + rng.normal(scale=0.05,
                                                                                   size=3)
        tvec = np.array([-0.03 + 0.02 * rng.uniform(), -0.025 + 0.02 * rng.uniform(),
                         0.18 + 0.1 * rng.uniform()])
        R, _ = cv2.Rodrigues(rvec)
        H = K @ np.column_stack([R[:, 0], R[:, 1], tvec]) @ S
        view = cv2.warpPerspective(texture, H, (hw[1], hw[0]), flags=cv2.INTER_LINEAR,
                                   borderValue=255)
        views.append(cv2.cvtColor(cv2.bitwise_not(view), cv2.COLOR_GRAY2BGR))
    return views


def rotation_deg(rvec_a, rvec_b, rodrigues) -> float:
    R = rodrigues(rvec_a) @ rodrigues(rvec_b).T
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))))


def error_summary(measured, truth) -> dict:
    """Coverage and |measured - truth| p50, p95 and the mean signed error."""
    ok = np.isfinite(measured)
    err = measured[ok] - truth[ok]
    return {"coverage": f"{int(ok.sum())}/{len(measured)}",
            "p50": float(np.percentile(np.abs(err), 50)) if ok.any() else None,
            "p95": float(np.percentile(np.abs(err), 95)) if ok.any() else None,
            "bias": float(err.mean()) if ok.any() else None}


def check_calibrate_measure(torch, ms, wp) -> dict:
    """Phase 8 (see the module docstring)."""
    import shutil

    import cv2
    import measure_report_torch as mr

    from tti_torch.app.orchestrator import run_startup_calibration
    from tti_torch.app.sources import DirectorySource
    from tti_torch.calib.charuco import create_charuco_board, detect_charuco, solve_board_pose
    from tti_torch.calib.io import load_extrinsics, save_intrinsics
    from tti_torch.core.config import AppConfig, RuntimeConfig

    shutil.rmtree(CAL_DIR, ignore_errors=True)
    views_dir = os.path.join(CAL_DIR, "views")
    os.makedirs(views_dir)
    t0 = time.perf_counter()
    mapper = mr.PlaneMapper()
    board = create_charuco_board()
    texture = board_texture(board)
    # The board centred on the plane point under the frame's centre: every
    # corner in view. Truth: the board frame is the world frame shifted by
    # ``origin`` in the plane, so R stays and t becomes R o + t.
    cfg = board.config
    half_mm = 500.0 * cfg.square_length_m * np.array([cfg.squares_y, cfg.squares_x])
    origin = mapper.plane_mm[mr.FRAME_HW[0] // 2, mr.FRAME_HW[1] // 2] - half_mm
    corners_px = mapper.to_pixel(board.chessboard_corners()[:, :2] * 1000.0 + origin)
    check(((corners_px > 20) & (corners_px < np.array(mr.FRAME_HW[::-1]) - 20)).all(),
          f"calibrate: board corners outside the frame: {corners_px.min(0)}, {corners_px.max(0)}")
    view = deployment_board_view(cv2, mapper, texture, origin)
    for i in range(3):
        cv2.imwrite(os.path.join(views_dir, f"view_{i}.png"), view)
    R_true = mr.rodrigues_np(mr.REF_RVEC)
    t_true = R_true @ np.array([*origin / 1000.0, 0.0]) + mr.REF_TVEC
    intrinsics = os.path.join(CAL_DIR, "camera_calibration.json")
    extrinsics = os.path.join(CAL_DIR, "extrinsics.json")
    save_intrinsics(mr.REF_K, mr.REF_DIST, intrinsics, image_size=mr.FRAME_HW[::-1])
    app = AppConfig(runtime=RuntimeConfig(intrinsics_file=intrinsics, extrinsics_file=extrinsics))
    # A finite source ends the capture loop at its last view.
    check(run_startup_calibration(app, DirectorySource(views_dir)) and os.path.exists(extrinsics),
          "calibrate: the startup gate did not write the extrinsics")
    rvec, tvec = load_extrinsics(extrinsics)
    t_err_mm = 1e3 * float(np.abs(tvec - t_true).max())
    r_err_deg = rotation_deg(rvec, mr.REF_RVEC, mr.rodrigues_np)
    corners, ids = detect_charuco(board, view)
    solved = {s: solve_board_pose(board, corners, ids, mr.REF_K, mr.REF_DIST, solver=s)
              for s in ("tti", "cv2")}
    cv2_t_mm = 1e3 * float(np.abs(solved["cv2"][1] - solved["tti"][1]).max())
    cv2_r_rad = float(np.abs(solved["cv2"][0] - solved["tti"][0]).max())
    gate_s = time.perf_counter() - t0
    log(f"calibrate: deployment-pose board ({len(ids)} of {len(board.chessboard_corners())} "
        f"corners, px x {corners_px[:, 0].min():.0f}-{corners_px[:, 0].max():.0f}, y "
        f"{corners_px[:, 1].min():.0f}-{corners_px[:, 1].max():.0f}); the gate wrote "
        f"extrinsics: tvec off by {t_err_mm:.4f} mm (limit 0.5), rotation by {r_err_deg:.5f} deg "
        f"(limit 0.1); reprojection rms {solved['tti'][2]:.4f} px; solver cv2 against tti "
        f"{cv2_t_mm:.2e} mm, {cv2_r_rad:.2e} rad (limits 1e-3, 1e-4); {gate_s:.1f} s")
    check(t_err_mm <= 0.5 and r_err_deg <= 0.1, "calibrate: the recovered pose is off")
    check(cv2_t_mm <= 1e-3 and cv2_r_rad <= 1e-4, "calibrate: solver cv2 disagrees with tti")

    # calibrate-intrinsics through the CLI, on views at several poses.
    intr_dir = os.path.join(CAL_DIR, "intrinsic_views")
    os.makedirs(intr_dir)
    for i, v in enumerate(pinhole_board_views(cv2, texture)):
        cv2.imwrite(os.path.join(intr_dir, f"view_{i:02d}.png"), v)
    out_json = os.path.join(CAL_DIR, "intrinsics_cli.json")
    proc = subprocess.run([sys.executable, "-m", "tti_torch.cli", "calibrate-intrinsics",
                           "--images", intr_dir, "--out", out_json], cwd=CAL_DIR,
                          env=dict(os.environ, PYTHONPATH=HERE), capture_output=True, text=True,
                          timeout=300)
    result_line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT: rms=")),
                       None)
    check(proc.returncode == 0 and result_line is not None and os.path.exists(out_json),
          f"calibrate-intrinsics: exit {proc.returncode}: {proc.stderr[-2000:]}")
    with open(out_json) as f:
        fx = json.load(f)["camera_matrix"][0][0]
    log(f"calibrate-intrinsics (8 views, fx 880 rendered): {result_line}; fx {fx:.2f}")

    # The first scenes of the mm report through the deploy step, with the
    # true and the recovered extrinsics, in float32 and bf16.
    rng = np.random.default_rng(0)
    scenes = [mr.make_measure_scene(mapper, rng) for _ in range(REPORT_SCENES)]
    frames = np.stack([f for f, _ in scenes])
    gt_edge = np.array([t.frame_edge for _, t in scenes])
    gt_width = np.array([t.frame_width for _, t in scenes])
    gt_n = np.array([t.n_stitches for _, t in scenes])
    summary = {"t_err_mm": t_err_mm, "r_err_deg": r_err_deg, "cv2_vs_tti_mm": cv2_t_mm,
               "cv2_vs_tti_rad": cv2_r_rad, "intrinsics_cli": result_line}
    kernel_a = summary["kernel_a_launches"] = []  # one per step, four steps
    for dtype in ("float32", "bfloat16"):
        got = {}
        for tag, (rv, tv) in (("true", (mr.REF_RVEC, mr.REF_TVEC)), ("recovered", (rvec, tvec))):
            pipe = mr.build_pipeline(CAM_CKPT, undistort=False, dtype=dtype, device="cuda",
                                     rvec=rv, tvec=tv)
            reset_launch_counts(ms, wp)
            out = pipe.process_batch(frames).measurements
            launches = launch_counts(ms, wp)
            kernel_a.append(launches["mask_stats_soft"])
            check(launches["mask_stats_soft"] == 1 and not launches["mask_stats_binary"],
                  f"measure {dtype} {tag}: kernel A once per step expected: {launches}")
            edge, width = out.raw_edge_mm.astype(float), out.raw_width_mm.astype(float)
            fin = np.isfinite(edge)
            label = f"measure {dtype}, {tag} extrinsics"
            check(np.isfinite(width).all(), f"{label}: a frame without a width: {width}")
            check((out.n_stitches >= np.minimum(gt_n, 3)).all(),
                  f"{label}: stitches {out.n_stitches.tolist()} against {gt_n.tolist()}")
            check(fin.sum() > len(edge) / 2, f"{label}: the edge on a minority of frames")
            check((np.abs(edge[fin] - gt_edge[fin]) < 1.0).all(), f"{label}: edge error >= 1 mm")
            check((np.abs(width - gt_width) < 0.8).all(), f"{label}: width error >= 0.8 mm")
            stats = {"edge": error_summary(edge, gt_edge), "width": error_summary(width, gt_width)}
            got[tag] = (edge, width)
            if tag == "true":
                with stats_route(ms.mask_stats_soft_plain, ms.mask_stats_binary_plain):
                    plain = pipe.process_batch(frames).measurements
                check(launch_counts(ms, wp) == launches, f"{label}: the plain step launched")
                for key in MM_KEYS:
                    a, r = getattr(out, key).astype(float), getattr(plain, key).astype(float)
                    check((np.isnan(a) == np.isnan(r)).all(), f"{label}: plain NaN pattern")
                    stats[f"plain_{key}"] = float(np.nanmax(np.abs(a - r), initial=0.0))
                check(max(stats["plain_raw_edge_mm"], stats["plain_raw_width_mm"]) <= 1e-2,
                      f"{label}: kernel A and its plain version differ by over 0.01 mm")
            summary[f"{dtype}/{tag}"] = stats
            log(f"{label} ({REPORT_SCENES} scenes, kernel A once): " + "; ".join(
                f"{k} {v['coverage']} p50 {v['p50']:.4f} p95 {v['p95']:.4f} bias "
                f"{v['bias']:+.4f} mm" for k, v in stats.items() if isinstance(v, dict))
                + ("; kernel A against its plain version "
                   f"{max(stats['plain_raw_edge_mm'], stats['plain_raw_width_mm']):.2e} mm"
                   if tag == "true" else ""))
            del pipe
        diffs = []
        for i in range(2):
            a, r = got["recovered"][i], got["true"][i]
            check((np.isnan(a) == np.isnan(r)).all(), f"measure {dtype}: recovered NaN pattern")
            diffs.append(np.abs(a - r)[np.isfinite(a)])
        worst = float(np.concatenate(diffs).max())
        summary[f"{dtype}/recovered_vs_true_mm"] = worst
        log(f"measure {dtype}: recovered against true extrinsics, max {worst:.2e} mm per frame "
            f"(limit 0.05)")
        check(worst <= 0.05, f"measure {dtype}: recovered extrinsics move a reading by {worst} mm")
    torch.cuda.empty_cache()
    summary["seconds"] = time.perf_counter() - t0
    log(f"calibrate, then measure: {summary['seconds']:.1f} s")
    return summary


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--first-design", metavar="PATH",
                        help="a copy of the first design of maskstats.cu, timed beside the kernels")
    parser.add_argument("--ablate", action="store_true",
                        help="time variants of maskstats.cu on synthetic inputs, and nothing else")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.append(os.path.join(HERE, "tests"))
    sys.path.append(os.path.join(HERE, "tools"))
    from tti_torch import native
    from tti_torch.kernels import build as kbuild
    from tti_torch.kernels import maskstats as ms
    from tti_torch.kernels import warp_p1 as wp

    # Phase 1: the card.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Phase 2: build, one nvcc per source, started together.
    t0 = time.perf_counter()
    kbuild.compile_all(("maskstats", "warp_p1"))
    ms.build()
    wp.build()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, maskstats.cu and warp_p1.cu)")
    for name, text in sorted(kbuild.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    t0 = time.perf_counter()
    check(native._load_library() is not None, "the C++ frame ring did not build")
    log(f"build: {time.perf_counter() - t0:.1f} s (g++, framering.cpp)")

    first = load_first_design(torch, opts.first_design) if opts.first_design else None
    if opts.ablate:
        ablate(torch, ms, kbuild, first)
        log(card)
        return 0

    # Phase 3: the mask-stats kernels against their plain versions.
    log("kernel checks against the plain versions:")
    errs = check_kernels(torch, ms)

    # Phases 4-5: the configurations through process_batch; each step's own
    # kernel inputs at batch 128 are kept for phase 9.
    head_hw, head_ckpt = (1080, 1920), "yolov8n_textile.msgpack"
    dep, dep_launches, _ = check_step(
        torch, ms, wp, "deploy step (960x1280, imgsz 960, stride-2 soft)", (960, 1280), 960,
        "yolov8n_textile_cam.msgpack", ("mask_stats_soft",))
    dep_time, dep_args = time_step(torch, ms, dep, "deploy", (960, 1280), iters=10, p50_iters=30)
    del dep
    torch.cuda.empty_cache()
    head, head_launches, got_e = check_step(
        torch, ms, wp, "headline step (1080x1920, imgsz 640, stride-4 binary)", head_hw, 640,
        head_ckpt, ("mask_stats_binary",), batch=BATCH)
    # Phase 3 again, for kernel C, with the headline warp's own weights.
    errs["warp_pass1_decimated"] = check_warp_p1(torch, wp, head.warp, head.spec)
    torch.cuda.empty_cache()
    head_time, head_args = time_step(torch, ms, head, "headline", head_hw)

    head_k, k_launches, got_k = check_step(
        torch, ms, wp, "headline step with warp_pass1='kernel'", head_hw, 640, head_ckpt,
        ("warp_pass1_decimated", "mask_stats_binary"), batch=BATCH, warp_pass1="kernel")
    route = check_kernel_route(torch, head, head_k, got_e, got_k, head_hw)
    head_k_time, _ = time_step(torch, ms, head_k, "headline, kernel route", head_hw, profile=False)
    torch.cuda.empty_cache()

    packed = check_packed(torch, ms, wp, head, head_hw, 640, head_ckpt)
    torch.cuda.empty_cache()
    dual = check_dual(torch, ms, wp, head, got_e, head_hw, 640, "yolov8n_textile_960.msgpack")
    torch.cuda.empty_cache()
    streams = check_streams(torch, head, head_hw)
    torch.cuda.empty_cache()

    # Phase 6: training.
    training = check_training(torch, ms, wp, card)

    # Phase 7: the application, ``run`` and ``eval``.
    application = check_application(torch, ms, wp, dep_time["p50_ms"])
    log(card)

    # Phase 8: calibrate, then measure, at the deployed geometry.
    calibrated = check_calibrate_measure(torch, ms, wp)

    # Phase 9: kernel timings, on each step's own inputs (the kernels line)
    # and, for the mask statistics, on a synthetic input whose first box
    # covers the whole grid.
    log("kernel timings (CUDA events, L2 flushed before each call):")
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: flush_buf.zero_()
    launches = {"mask_stats_soft": dep_launches["mask_stats_soft"],
                "mask_stats_binary": head_launches["mask_stats_binary"]}
    replaces = {"mask_stats_soft": "tti/kernels/maskstats.py:454",
                "mask_stats_binary": "tti/kernels/maskstats.py:261"}
    step_inputs = {"mask_stats_soft": ("the deploy step's inputs", dep_args),
                   "mask_stats_binary": ("the headline step's inputs", head_args)}
    whole_grid = {"mask_stats_soft": (8, 368, 480, 64), "mask_stats_binary": (8, 96, 160, 64)}
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "shape", "ms_again", "first_design_ms")
    kernels = []
    for name in ("mask_stats_soft", "mask_stats_binary"):
        label, args = step_inputs[name]
        t = time_kernel(torch, ms, name, args, flush, first)
        log_kernel_time(name, label, t)
        g = time_kernel(torch, ms, name, stats_problem(torch, *whole_grid[name], seed=11), flush,
                        first)
        log_kernel_time(name, "a whole-grid synthetic input", g)
        kernels.append({
            "name": name, "route": "cuda", "source": "tti_torch/kernels/csrc/maskstats.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": errs[name]["max_abs_err"], "max_rel_err": errs[name]["max_rel_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "einsum_ms": t["einsum_ms"],
            "timed_on": label, "timed_shape": t["shape"], "timed_d": t["d"],
            "run_launches": {"frames": APP["frames"], **{
                tag: application[tag]["launches"][name] for tag in ("blocking", "pipelined")}},
            **({"calibrate_measure_launches": calibrated["kernel_a_launches"]}
               if name == "mask_stats_soft" else {}),
            "whole_grid": {k: g[k] for k in timed if k in g},
            **({k: t[k] for k in ("ms_again", "first_design_ms")} if first else {}),
        })
    del dep_args, head_args
    torch.cuda.empty_cache()
    c = time_warp_p1(torch, wp, head_k, head_hw, flush)
    kernels.append({
        "name": "warp_pass1_decimated", "route": "cuda",
        "source": "tti_torch/kernels/csrc/warp_p1.cu", "replaces": "tti/kernels/warp_p1.py:64",
        "launches": k_launches["warp_pass1_decimated"],
        "max_abs_err": errs["warp_pass1_decimated"]["max_abs_err"],
        "max_rel_err": errs["warp_pass1_decimated"]["max_rel_err"],
        "ms": c[BATCH]["ms"], "plain_ms": c[BATCH]["plain_ms"], "bound_ms": c[BATCH]["bound_ms"],
        "bound_by": c[BATCH]["bound_by"], "library_ms": None,
        "unfused_ms": c[BATCH]["unfused_ms"], "timed_on": "the headline step's frames",
        "timed_shape": c[BATCH]["shape"],
        "pass2_from_ycbo_ms": c[BATCH]["pass2_from_ycbo_ms"],
        "pass2_from_byoc_ms": c[BATCH]["pass2_from_byoc_ms"],
        "batch_1": {k: c[1][k] for k in ("ms", "plain_ms", "unfused_ms", "bound_ms", "bound_by",
                                         "pass2_from_ycbo_ms", "pass2_from_byoc_ms")},
    })
    log(json.dumps({"card": card, "steps": {
        "deploy": dep_time, "headline": head_time, "headline_kernel_route": head_k_time,
        "kernel_route_vs_einsum": route, "packed": packed, "dual": dual, "streams": streams},
        "training": training, "application": application, "calibrate_measure": calibrated}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
