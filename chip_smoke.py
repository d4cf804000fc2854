#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``tti_torch``) on one CUDA card.

    python3 chip_smoke.py [--first-design PATH] [--first-design-int8 PATH]
                          [--first-design-warp PATH] [--first-design-nms PATH]
                          [--first-design-scale PATH] [--ablate]

``--first-design`` names a copy of the first design of ``maskstats.cu`` (the
file as the commit that added the port's measurement path had it); it is
built beside the current kernels and timed on the same inputs in phase 9,
before and after them. ``--first-design-int8`` names a copy of kernel E's
first design (``git show 7a2104c:tti_torch/kernels/csrc/int8conv.cu``):
phase 5c builds it, holds its
output equal to E's on every block input of the deploy int8 forward and
times it beside E there and, bound in E's place, on the whole deploy int8
step (E, then it, then E again). ``--first-design-warp`` names a copy of
kernel C's first design (``git show 0b702ac:tti_torch/kernels/csrc/warp_p1.cu``):
phase 3 holds its output equal to C's on the headline inputs at batch 128
and 1, and phase 9 times it beside C on the same inputs (first, C, C,
first). ``--first-design-nms`` names a copy of kernel D's first design
(``git show d4bb171:tti_torch/kernels/csrc/nms.cu``): phase 3 holds it
bit-equal to D on the deploy and headline steps' candidates at batch 128
and 1, and phase 9 times it beside D on every input D is timed on (first,
D, D, first). ``--first-design-scale`` names a copy of kernel F's first
design (``git show b58ffc1:tti_torch/kernels/csrc/int8conv.cu``): phase 5c
holds it bit-equal to F on every distinct input of the deploy int8 forward
at batch 128 and times it beside F there (first, F, F, first) and, bound in
F's place, on the whole deploy int8 step (F, then it, then F again). Nothing
else uses them. ``--ablate`` runs phases 1-2
and then only :func:`ablate`: variants of ``maskstats.cu`` that leave one
part of the design out or tune it otherwise, timed on synthetic inputs
shaped like the steps' (what each part costs or buys).

Phases, one printed line or block each, each ending with its wall seconds;
any failure raises and the script exits non-zero without printing the final
result line:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``tti_torch/kernels/csrc`` (mask statistics,
   warp pass 1, greedy NMS, the int8 convolution and activation scale) into
   ``build/``, one nvcc process each, started
   together, and the C++ frame ring (g++), with the build time and ptxas'
   register report;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, plus edge cases. Mask statistics: all rows invalid, a
   box reaching y2 == Hm, a bottom on the last row, a small-logit case
   where the soft path's bf16 rounding shows (the plain version with float32
   logits must fail that comparison), the carries at the kernel's own chunk
   height (a bottom on a chunk's last and first row, on the box's last row,
   one-row boxes, a box over every chunk), boxes over the whole grid at both
   main-path shapes with 8 of 200 detections valid, and every comparison
   launched twice with bit-equal outputs. Warp pass 1 (kernel C, which
   reads only the rows of W1 that the warp's table ``pass1_window`` says
   hold a non-zero): the headline shape at batch 128, 64, 33, 17, 16, 2
   and 1 with the headline warp's own weights, a k = 5 geometry and a W1
   whose non-zeros sit on its tiles' first and last rows and columns, with
   dead tiles and dead columns (0 differing elements: at most two non-zero
   products per output), dense weights j/64 (within one bf16 step), a
   frame holding every byte value on which the plain version that divides
   by 255 must fail, and the stride-k select alone (identity weights,
   bytes 0 or 255) at k = 3 and k = 5; every case launched twice,
   bit-equal. Kernel D (greedy
   NMS keep-set) bit-equal to ``greedy_keep_plain``, two launches bit-equal,
   at K = 256, 512, 1000 and 2048 (the rows in the scratch buffer), on a
   suppression chain through all K, every candidate invalid, every box
   identical, zero-area boxes, ``class_aware`` off, thresholds -0.25, 0
   and NaN, NaN and infinite coordinates (the division's route), boxes and
   validity off their 16- and 4-byte boundaries (the scalar loads); K = 1
   and 8192; B = 1 and 2 at K = 32, 200, 256 and 512, which cover every
   cluster size ``nms.cluster_size`` returns (1, 2, 4 and 8), and one input
   launched at each cluster size (the same bits); then (phases 4-5) on the
   deploy and headline steps' own candidates at batch 128 and 1;
3b. the checks that run in processes of their own and time nothing,
   started together while this process only waits, then each waited for
   and held to its bar in turn, with its wall seconds (taken beside the
   others): ``tools/calibrate_int8_torch.py --synth 16`` for both
   checkpoints (imgsz 960 and 640, scenes of ``tools/synth_textile_torch.py``:
   the scales of phases 5c and 5g);
   ``python -m tti_torch.cli run --synthetic --max-frames 2`` three times,
   each from its own directory holding a .env and the calibration files:
   ``--skip-calibration`` (two measurement records), ``--cameras 4`` (eight
   stream records, through ``MultiStreamRunner``) and
   ``--skip-calibration`` under ``TTI_QUANT=int8`` (two records); two gloo
   ranks sharing the card (``--gloo-rank`` processes) on the deploy step in
   float32 at batch 8 against the step without a mesh (valid equal, scores
   1e-5, boxes 1e-3 px, mm 1e-4; each rank's rows bit-equal to the step on
   those rows); ``python -m tti_torch.cli train`` with the ``TTI_*`` triple
   (a one-rank NCCL job) on 8 seeded scenes, 2 steps (exit 0, one
   checkpoint); ``python -m tti_torch.cli train --host-aug`` at r5s on
   phase 6's 16 seeded PNG scenes (one epoch, 2 steps at batch 8: exit 0,
   one checkpoint, finite losses logged); ``tools/calibrate_offsets_torch.py``
   on a copy of the deploy checkpoint and its sidecar under
   ``build/offsets_smoke/`` over 16 scenes (exit 0, every other key of the
   sidecar unchanged, both constants finite, printed beside the sidecar's);
4. deploy step: 960x1280 frames, imgsz 960, the stride-2 soft checkpoint,
   through ``InspectionPipeline.process_batch``; it must launch kernels A
   and D once and agree with the same step run with the plain versions
   bound in the kernels' place; then one ``step`` on device-resident frames
   at batch 128 and at batch 1 under ``torch.cuda.set_sync_debug_mode("warn")``
   must make no synchronising call and launch kernel D once;
5. headline step: 1080x1920 frames, imgsz 640, the stride-4 binary
   checkpoint, through kernel B, with the same checks (the synchronising
   calls too, also on the kernel route's step); then the same step
   with ``warp_pass1="kernel"`` at batch 128 (kernels C and B, once per step
   each), against the plain versions and against the "einsum" step, and
   its frames/s and batch-1 p50 against the "einsum" step's in turns; the
   packed-remap step against the two-pass step (its pack of the decimated
   bytes bit-equal to the float resize it skips); the dual step (two
   checkpoints, one preprocess, kernel D twice) against each model's own
   pipeline; four 1080p streams through ``MultiStreamRunner`` (blocking and
   pipelined); then the divisions by trace-time constants
   (:func:`check_jit_division`: ``scale_boxes_to_frame`` at the deploy and
   headline specs on 100,000 boxes, ``normalize`` of one headline batch in
   float32 and bfloat16, ``undistort_points``) on the card bit-equal to the
   CPU, with its wall seconds;
5b. the step's opt-in modes at full width, each where ``tti`` applies it
   (:data:`MODES`: lazy decode, fused head and ``warp_block=64`` on both
   configurations, ``warp_col_expand`` on the headline, ``fold_bn=False``
   and ``maskstats_logits="f32"`` on deploy):
   kernels once per step, no synchronising call at batch 128 and 1, float32
   (batch 8) within 1e-3 px and 1e-3 mm of its reference step (the default
   step), bf16 (batch 128)
   detection counts equal on most frames and mm within the kernel route's
   limits, frames/s and batch-1 p50 beside the reference step's; the
   phase's wall time;
5c. int8 inference (``TTI_QUANT``; kernels E and F, ``csrc/int8conv.cu``;
   the scales of phase 3b's calibrations): E and F held to their plain
   versions on synthetic cases (the plain stem, ci 3; the s2d stem, ci 12;
   3x3 and 1x1 shapes; K = 2304; a C2f channel slice whose other channels F
   must not see; an all-zero input, F's 1e-12 floor; an accumulator above
   2^24; the codes alone through identity 1x1 weights; bf16 and float32;
   per-sample and static scales; outputs that are not a multiple of E's
   tile, batch 1 at the smallest deploy block, co 128 and 256, two TMA
   boxes, NCHW inputs, a walk across 33 samples with scales 1e-3 to 1e3
   apart, C2f slices at channels 16, 32, 64 and 128): F bit-equal, E bit-equal before SiLU and
   within 1 ulp after, every call launched twice with equal outputs; F
   alone on the layouts its routes split (``int8conv.scale_plan``: spans
   starting off their 16-byte boundary, 8- and 4-byte vectors, C = 12
   slices, single elements, float32 and bf16, NaN, -inf and zero samples,
   batch 1 at the largest deploy input) and on two CUDA streams at once. Then
   the deploy and headline steps under ``quant="int8"`` and ``"int8s"`` at
   batch 128: E 66 launches per step, F 66 (int8) or 0 (int8s), A or B and
   D once; no synchronising call at batch 128 and 1; equal to the same step
   with the plain versions bound (detections equal, mm within 0.01);
   ``tti``'s detection contract (``tests/test_quantize.py``: every float
   detection with score > 0.4 has an int8 one of its class at IoU > 0.9),
   against the bf16 step and in float32 at batch 8: every detection kept at
   IoU > 0.8 and at most 10% of them below 0.9, the lowest printed
   (``tti``'s own int8 misses 0.9 for 2 of 46 at the headline; see
   ``INT8_IOU_FLOOR``); E and F against their plain versions on the input
   of every block of one batch-128 int8 forward and of the headline int8s
   forward on the batch's 8 distinct frames; frames/s and batch-1 p50 in
   turns with the bf16 step; the mm report's first 16 scenes through the deploy int8 and int8s steps
   under phase 8's gate; E's time on the deploy step's largest blocks
   beside its bound, cuDNN's bf16 convolution and (1x1) ``torch._int_mm``,
   F's beside its bound; F on every distinct input of the deploy int8
   forward at batch 128 (its route, time in two turns, byte bound,
   ``torch.linalg.vector_norm(inf)``'s time) and the sums over the 66
   inputs beside the profiler's F per step; E on every one of the 66 block inputs of the
   deploy int8 forward at batch 128, a table sorted by ms - bound ms and
   the sums, E's time per step against its bound per step (the headline's
   bound per step too); the contract exactly (every detection at IoU >
   0.9) on ``tti``'s own scene (the test's: the mm report's seed-7 scene,
   imgsz 640, float32), int8 and int8s; kernel G in the four int8 steps
   once per float convolution with a bias (the exit convs and the deconv,
   10 in the deploy model); the phase's wall time;
5j. kernel G (``csrc/conv_epilogue.cu``, the float convolutions' bias and
   SiLU; after 5c): 76 launches per deploy step at batch 128, and its
   device ms in a profiled step; each of the deploy forward's 76 epilogues
   at batch 128 bit-equal to the parent route (cuDNN's in-place bias add,
   then ``F.silu``), timed beside that route, the plain version and its
   byte bound, and the sums per step; the phase's wall time;
5d. the frozen step (``tti_torch.app.export``; every kernel is a registered
   operator, ``torch.ops.tti_torch.*``), each at batch 1: deploy bf16,
   the headline with ``warp_pass1="kernel"`` (its artifact also
   holds the CPU program, which is loaded and run on the host) and deploy
   ``quant="int8"``, each exported on the card, saved under
   ``build/frozen_smoke/``, loaded from the file and deleted: outputs
   against the live step's (detections equal, scores within 1e-6, boxes
   within 1e-5 px, mm within 0.01), launches per frozen call (A 1 and D 1;
   B, C and D 1; E 66, F 66, A 1 and D 1; every other kernel none), no
   synchronising call, export + save and load seconds and bytes, and the
   frozen step's batch-1 p50 against the live step's in turns; then each
   kernel's host microseconds per call on the batch-1
   steps' own calls, through its wrapper, its operator and the bare ctypes
   launch; the phase's wall time;
5e. data-parallel (``tti_torch.parallel.mesh`` and ``dcn``) on the one card:
   a one-rank NCCL job through ``init_distributed`` (the ``TTI_*`` triple's
   arguments, 127.0.0.1 and a free port; NCCL or the run fails) and its
   ``"data"`` mesh; the deploy step (batch 128), the headline kernel route
   and the deploy int8 step (batch 8) on the mesh, each through ``step``
   and ``process_batch_async``, every output equal to the step without a
   mesh bit for bit and the one-card step's launches (A and D once; C, B
   and D once; E and F 66 times, A and D once); the deploy mesh step with
   no synchronising call at batch 128 and 1, and its frames/s and batch-1
   p50 in turns with the plain step; the headline dual step on the mesh
   against the dual step without one (B and D twice); r5s at full width,
   3 steps of the synced ``TrainStep`` (the NCCL gradient all-reduce, and
   BatchNorm's global-batch statistics forced on at one rank) against the
   plain step (phase 6's bf16 bars on the loss terms; the first update
   within 2.2 lr, under 0.5% of the parameters apart by more than 1e-4),
   ms per step in turns, the all-reduces of one synced step counted and
   the NCCL kernels' device ms (two gloo ranks and the CLI's triple: phase
   3b); the phase's wall time;
5f. spatial partitioning (``tti_torch.parallel.spatial``, a ``("data",
   "space")`` mesh): a ``(1, 1)`` mesh over a one-rank NCCL job serves
   the plain deploy step (every output equal at batch 8, A and D once, no
   exchange, no synchronising call at batch 1); two gloo ranks sharing the
   card (``tools/space_cards_torch.py`` workers, a ``(1, 2)`` mesh) run the
   deploy and headline steps at full width against the step without a
   mesh: float32 (TF32 off) at batch 1 and 2 at ``__graft_entry__.py``'s
   bar, bf16 at batch 128 at phase 5b's bar (counts equal on 99% of the
   frames, mm within 0.25, median 0.01; batch 1 and 2 printed), the
   deploy int8 step (float32) at batch 2 and the headline kernel route
   (kernel C on each slab's band of source rows) at batch 1 and 2 at the
   float32 bar; per rank and step A or B once and D once (C once on the
   kernel route; E and F 66 times under int8, with 66 MAX all-reduces), 44
   halo exchanges and one gather; each rank's slab and
   pass-1 source rows, batch-1 p50 and device busy per rank against the
   plain step's, the host ms in the exchanges, the copies' device ms and
   the bytes each gather moves; then the same two ranks with the banded
   warp (``warp_block=64``, its pass-2 bands cut at each slab's rows):
   the deploy and headline steps in float32 at batch 1 and 2 against the
   banded step without a mesh at ``__graft_entry__.py``'s bar, per rank and
   step A or B once, D once, 44 halo exchanges and one gather, each rank's
   pass-2 bands and their bytes beside the dense slab's, and the bf16
   batch-1 p50 per rank beside the dense space step's; the phase's wall
   time;
   the float32 deploy batch-1 space check runs once, with its miss dump
   (``tools/space_cards_torch.py --repeat`` repeats it): on any rank's miss
   each rank writes its dump beside its readings (every halo's sent and
   received rows, the slab's head outputs and the plain step's for the
   same rows); the bf16 space steps at batch 1 and 2 are held to the plain
   step at that batch with equal detection counts and mm within the plain
   step's own spread on those frames, measured in the same process (its
   readings at batch 128 and with its forward on slabs of other shapes, by
   threads of one process; the smaller batch's spread included; floor 0.01
   mm, cap 0.25), and bit-equal to the same slabs' forward on threads;
   beside them the first convolution whose rows depart on identical input
   rows and the CUDA kernels its two calls launch; and the dual
   step (the headline checkpoint and
   ``yolov8n_textile_960.msgpack``) on the mesh against the plain dual step,
   float32 at batch 1 and 2 at the float32 bar, B and D twice, 88 halo
   exchanges and 2 gathers per rank and step; each run's wall seconds per
   rank (set-up, checks, timing);
5g. the tools that time the card, each in a subprocess, the four side by
   side and beside phase 5i's bench process (each run end to end checked;
   their times, taken beside the others, are not measurements):
   ``python -m tti_torch.cli tune-device`` at the headline geometry
   (batches 1 and 32, 5 + 5 steps, the trials baseline, warp_blocked=64,
   approx_topk=1, maskstats=pallas2, quant=int8 and quant=int8s on phase
   5c's headline scales, under ``build/tune_smoke/``: exit 0, the ``.env``
   written, the refused and unported trials' rows carrying their reasons,
   every other row's frames/s and p50 printed),
   ``tools/profile_forward_torch.py --batch 8 --full --iters 2`` (its top
   five ops and category totals), ``tools/profile_train_torch.py --batch 8
   --iters 2`` (ms per program beside the floors) and
   ``tools/host_overhead_torch.py --streams 4 --iters 20`` (its JSON line:
   the pinned upload and the device step measured); the phase's wall time;
5h. ``__graft_entry__.py``'s forward chain through the port: seeded
   480x640 textile frames at batch 1 and 8 through ``preprocess_frames(...,
   640)``, the raw model (``inference_model(..., s2d_input=False,
   s2d_stem=False)``, the stride-4 checkpoint in bf16) and
   ``decode_predictions``, then ``batched_nms`` (kernel D): the keep set and
   classes equal to the same chain with D's plain version bound, scores
   within 1e-5 and boxes within 1e-3 px, D launched once per call, no
   synchronising call, ms per call; then ``tti``'s public helpers on the
   card on the headline step's outputs for one 1080x1920 frame, each held
   to the same call on the CPU: ``masks_at_frame`` of 16 detections (the
   nearest resize of the card's masks at the input, which differ from the
   CPU's only within 1e-5 of the threshold), then on those masks the
   envelopes, the edge mask, ``stitch_stats`` (centroids within rtol 1e-5),
   ``sample_envelope`` and ``nearest_edge_candidates`` (equal); the
   phase's wall time;
5i. ``python -m tti_torch.cli bench`` (``bench_torch.py``, the port's
   ``bench.py``) in a subprocess started with phase 5g's tools and beside
   them, so its readings are checks, not measurements (``--bench-cli``:
   the CLI run as ``-m`` runs it, the kernels' launch counts set to 0
   before and read after) with
   ``TTI_BENCH_CONFIGS=all`` and ``TTI_BENCH_ITERS=10`` at the default batch
   of 128: exit 0; exactly two JSON lines on stdout, deploy first, with
   ``bench.py``'s keys, the two committed checkpoints as weights and finite
   positive values; the deploy, headline, dual and 4-stream lines on
   standard error in order; kernel A once per deploy step, B and D once per
   headline and 4-stream step and twice per dual step (:func:`bench_launches`);
   its seconds from start to end; then its two rows after the card line in
   ``build/BENCH_torch_smoke.txt`` and ``tools/regen_docs_torch.py --root
   build --readme build/README_smoke.md --tests 0`` on a copy of README:
   the port's block must hold both rows' values and the card line (its
   wall seconds);
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
   separate loop; then the host recipe (``--host-aug``) at r5s on 16
   seeded scenes written as PNG files: the host's ms per batch of ``batches``,
   the host loop (``run_host``: pinned upload, the same ``TrainStep``) in
   images/s beside the device augment's loop, no kernel launched (the CLI
   on the same scenes: phase 3b), with the wall time;
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
   the host ms of fusion and of drawing and saving the annotated frame (the
   CLI's ``run``: phase 3b). Then ``tti eval``'s loop
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
   several poses in a subprocess (exit 0, an rms printed), while the first
   16 seed-0 scenes of ``tools/measure_report_torch.py`` go through the
   deploy step in float32 and bf16, with the true and with the recovered
   extrinsics: kernel A once per step, ``tests/test_measure_report.py``'s per-frame gate (every width
   finite, stitches >= min(truth, 3), an edge on most frames, edge error
   < 1.0 mm, width error < 0.8 mm), recovered against true within 0.05 mm
   per frame, kernel A against its plain version within 0.01 mm; coverage,
   p50, p95 and bias printed; then the report's rectified rows on the same
   scenes (``undistort=True``: the two-pass warp ahead of the step, frames
   undistorted once), float32 and bf16: kernels A and D once per step, the
   same gate, the plain versions within 0.01 mm, rectified minus native
   p50, p95 and bias printed (``calibrate_offsets``: phase 3b); each part's
   wall time;
9. timings: frames/s at batch 128 and the batch-1 p50 of the steps, the
   stages, and each kernel's time beside its plain version's and its bound,
   on the inputs the batch-128 step gives it (kernels C and D also at batch
   1; C's bound counts what its weights need, W1's non-zeros and the table,
   beside the bound of reading W1 whole, with the share of W1 its boxes
   read; D also on seeded candidates at K = 512, 1000 and 2048 at batch 128
   and 1, each beside an empty kernel of its grid, clusters and shared
   memory, its cluster size and the latency of its pass-2 chain);
10. the whole script's wall time, the ``kernels`` JSON line (with each
   kernel's launches per mesh step of phase 5e), then the final
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

# The bench's deployment calibration (1280x960 sensor), extrinsics, ROI and
# configurations: bench_torch.py's, the one copy.
from bench_torch import (  # noqa: E402
    DEPLOY, DIST, HEADLINE, K_960, bench_calibration, bench_roi,
)

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


_DRAINS: dict = {}  # a process -> the future of its (stdout, stderr), see drain()
_ENDED: dict = {}  # a drained process -> when its output ended (perf_counter)


def drain(procs) -> None:
    """Read each process's output on a thread of its own from now on, so no
    process blocks on a full pipe while another is waited for, and note
    when each one's output ends."""
    from concurrent.futures import ThreadPoolExecutor

    def read(p):
        try:
            return p.communicate()
        finally:
            _ENDED[p] = time.perf_counter()

    pool = ThreadPoolExecutor(len(procs))
    for p in procs:
        _DRAINS[p] = pool.submit(read, p)
    pool.shutdown(wait=False)


def seconds_to_end(proc, t0: float) -> float:
    """Seconds from ``t0`` to the end of a waited-for process (its output's
    end when :func:`drain` read it, else now)."""
    return _ENDED.pop(proc, time.perf_counter()) - t0


def popens(x) -> list:
    """The subprocesses in a nest of tuples, lists and dicts."""
    if isinstance(x, subprocess.Popen):
        return [x]
    items = x.values() if isinstance(x, dict) else x if isinstance(x, (list, tuple)) else ()
    return [p for v in items for p in popens(v)]


def communicate(proc, timeout: float = 300.0) -> tuple:
    """A subprocess's standard output and error once it has ended (killed
    if it runs past ``timeout`` seconds, which fails the script)."""
    try:
        if proc in _DRAINS:
            return _DRAINS.pop(proc).result(timeout=timeout)
        return proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


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


def edge_tile_w1(torch, hs, ws, wo, gen):
    """A W1 (hs, ws, wo) whose non-zeros (values j/64, never 0) sit where a
    tiled walk over W1 breaks first: each 64-column tile of a row y holds
    one non-zero on the tile's first column and one on its last, their rows
    spanning exactly 80 source columns (one whole chunk), 81 (a second
    chunk of one row) or 16, at source column 0 and at ws - 1; every fourth
    tile and one column of each tile hold nothing (a dead tile, a dead
    column)."""
    w1 = torch.zeros((hs, ws, wo), dtype=torch.bfloat16, device="cuda")
    spans = (80, 81, 16, 1)
    for y in range(hs):
        for m in range(wo // 64):
            if (y + m) % 4 == 3:
                continue  # a dead tile
            span = min(spans[(y + m) % 4], ws)
            x0 = (0, ws - span, (37 * (y + m)) % max(ws - span, 1))[(y * 7 + m) % 3]
            vals = torch.randint(1, 65, (2,), device="cuda", generator=gen).float() / 64
            w1[y, x0, 64 * m] = vals[0]
            w1[y, x0 + span - 1, 64 * m + 63] = vals[1]
            w1[y, x0 + span // 2, 64 * m + 1 + (y + m) % 60] = vals[0]
    return w1


def load_first_warp(torch, path):
    """Build kernel C's first design (its ``warp_p1.cu``, from ``path``)
    into its own library and return ``call(frames, w1, k, off, hs, ws,
    pad_value)``, which launches it as its own wrapper did (dense W1, no
    table; not counted)."""
    import ctypes

    from tti_torch.kernels import build as kbuild

    out = kbuild.BUILD_DIR / "libtti_warp_p1_first_design.so"
    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-o", str(out), path], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tti_warp_pass1_decimated.argtypes = [p, ctypes.c_longlong, p, p, i, i, i, i, i, i, i, i,
                                             ctypes.c_float, i, i, i, p]
    lib.tti_warp_pass1_decimated.restype = i

    def call(frames, w1, k, off, hs, ws, pad_value):
        b, h, w, _ = frames.shape
        wo = w1.shape[2]
        out = torch.empty((hs, 3, b, wo), dtype=torch.bfloat16, device=frames.device)
        err = lib.tti_warp_pass1_decimated(
            frames.data_ptr(), frames.numel(), w1.data_ptr(), out.data_ptr(), b, h, w, k, off, hs,
            ws, wo, float(pad_value), 1, int(frames.data_ptr() % 16 == 0),
            int(w1.data_ptr() % 16 == 0 and wo % 8 == 0), torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"first design of kernel C: cudaError {err}")
        return out

    return call


def check_warp_p1(torch, wp, warp, spec, first=None) -> dict:
    """Kernel C against its plain version in bf16 on the card. ``warp`` and
    ``spec`` are the headline pipeline's. The limit is one bf16 step (2^-8)
    relative to max(|ref|, 1/16): the sum rounds once to bf16, and a float32
    sum taken in another order can fall on the other side of a rounding
    boundary. With at most two non-zero products per output (the warp's own
    weights, the edge-tile weights) the order cannot matter: there 0
    differing elements are required. Every case is launched twice, and the
    two outputs must be bit-equal. With ``first`` (the first design's
    launcher), its output on the headline inputs at batch 128 and 1 must
    equal the kernel's."""
    worst = [0.0, 0.0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    rand = lambda *shape: torch.randint(0, 256, (*shape, 3), dtype=torch.uint8, device="cuda",
                                        generator=gen)

    def run(label, frames, w1, kw, exact=False, vs_first=False):
        window = wp.pass1_window(w1)
        got = wp.warp_pass1_decimated(frames, w1, window, **kw)
        again = wp.warp_pass1_decimated(frames, w1, window, **kw)
        ref = wp.warp_pass1_decimated_plain(frames, w1, window, **kw)
        torch.cuda.synchronize()
        want_shape = (kw["hs"], 3, frames.shape[0], w1.shape[2])
        check(tuple(got.shape) == want_shape and got.dtype == w1.dtype,
              f"warp_pass1_decimated {label}: {tuple(got.shape)} {got.dtype}, expected {want_shape}")
        check(torch.equal(got, again), f"warp_pass1_decimated {label}: two launches differ")
        a, r, ndiff = p1_errors(got, ref)
        check(r <= BF16_STEP, f"warp_pass1_decimated {label}: max rel err {r} > {BF16_STEP}")
        check(ndiff == 0 or not exact, f"warp_pass1_decimated {label}: {ndiff} elements differ")
        worst[0], worst[1] = max(worst[0], a), max(worst[1], r)
        log(f"  warp_pass1_decimated {label}: max abs err {a:.3g}, max rel err {r:.3g}, "
            f"{ndiff} of {got.numel()} elements differ; two launches bit-equal")
        if first is not None and vs_first:
            old = first(frames, w1, **kw)
            torch.cuda.synchronize()
            check(torch.equal(old, got), f"warp_pass1_decimated {label}: the first design differs")
            log(f"  the first design on the same inputs: equal to the kernel")
        return got

    head = dict(k=3, off=1, hs=spec.new_h, ws=spec.new_w, pad_value=warp.pad_value)
    check((head["hs"], head["ws"], warp.w1.shape[2]) == (360, 640, 640),
          f"headline pass-1 shape {tuple(warp.w1.shape)}")
    for b in (BATCH, 64, 33, 17, 16, 2, 1):
        run(f"headline B={b}, the warp's own W1", rand(b, 1080, 1920), warp.w1, head, exact=True,
            vs_first=b in (BATCH, 1))
    # Frames that start and end off a 16-byte boundary (3 bytes into a
    # buffer): the spans' end bytes come by plain loads.
    buf = rand(2 * 1080 * 1920 + 1, 1).view(-1)
    run("headline B=2, 3 bytes into a buffer, the warp's own W1",
        buf[3:3 + 2 * 1080 * 1920 * 3].view(2, 1080, 1920, 3), warp.w1, head, exact=True)
    del buf
    spec5, warp5 = k5_warp(torch)
    kw5 = dict(k=5, off=2, hs=spec5.new_h, ws=spec5.new_w, pad_value=warp5.pad_value)
    run("k=5 (480x480, imgsz 96) B=5", rand(5, 480, 480), warp5.w1, kw5, exact=True)
    edge = edge_tile_w1(torch, 16, 640, 640, gen)
    run("B=40, non-zeros on the tiles' first and last rows and columns, dead tiles and columns",
        rand(40, 1080, 1920), edge, dict(head, hs=16), exact=True)
    del edge
    dense = (torch.randint(-64, 65, tuple(warp.w1.shape), device="cuda", generator=gen).float()
             / 64).to(torch.bfloat16)
    run("headline B=128, dense W1 of values j/64", rand(BATCH, 1080, 1920), dense, head)
    del dense

    # The rounding rule: on a frame that holds every byte value the plain
    # version that divides by 255 must fail the comparison the kernel passes.
    ar = lambda n, shape: torch.arange(n, device="cuda").view(shape)
    every = ((ar(1920, (1, 1, -1, 1)) + 7 * ar(1080, (1, -1, 1, 1)) + 31 * ar(3, (1, 1, 1, -1))
              + 13 * ar(4, (-1, 1, 1, 1))) % 256).to(torch.uint8)
    got = run("headline B=4, every byte value", every, warp.w1, head, exact=True)
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
        got = wp.warp_pass1_decimated(frames, eye, wp.pass1_window(eye), k=k, off=off, hs=hs,
                                      ws=ws, pad_value=0.0)
        sel = frames[:, off::k, off::k, :][:, :hs, :ws, :].flip(-1).permute(1, 3, 0, 2)
        want = torch.where(sel == 255, one.to("cuda"), torch.zeros((), dtype=torch.bfloat16,
                                                                   device="cuda"))
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"stride-{k} select: kernel differs from frames[:, off::k, off::k, ::-1]")
        log(f"  stride-{k} select alone ({b}x{h}x{w} -> {hs}x{ws}, identity W1): equal to "
            f"frames[:, {off}::{k}, {off}::{k}, ::-1]; {int((got != 0).sum())} of {got.numel()} "
            f"outputs are the constant {float(one):g}")
    return {"max_abs_err": worst[0], "max_rel_err": worst[1], "dividing_rel_err": div_err}


# ---------------------------------------------------------------------------
# Phase 3, kernel D: greedy NMS suppression
# ---------------------------------------------------------------------------


def nms_problem(torch, b, k, seed, spread=300.0, nc=2):
    """Score-sorted candidates on the card: boxes (B, K, 4) float32 xyxy,
    classes (B, K) int32, about 90% of them valid."""
    gen = np.random.default_rng(seed)
    xy = gen.uniform(0, spread, (b, k, 2))
    wh = gen.uniform(4, 60, (b, k, 2))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return (t(np.concatenate([xy, xy + wh], -1).astype(np.float32)),
            t(gen.integers(0, nc, (b, k)).astype(np.int32)), t(gen.uniform(size=(b, k)) < 0.9))


# Kernel D against its plain version over every case of this run: keep
# bits compared, keep bits that differ, and the largest |keep - plain|.
NMS_TALLY = {"compared": 0, "mismatched": 0, "max_abs_err": 0}


def check_nms_case(torch, label, boxes, classes, ok, iou_thresh=0.25, class_aware=True) -> int:
    """Kernel D against ``greedy_keep_plain`` on one input: the keep masks
    bit-equal, and two launches bit-equal. Adds to :data:`NMS_TALLY`;
    returns the kept count."""
    from tti_torch.kernels import nms as nk

    got = nk.greedy_keep(boxes, classes, ok, iou_thresh, class_aware)
    again = nk.greedy_keep(boxes, classes, ok, iou_thresh, class_aware)
    ref = nk.greedy_keep_plain(boxes, classes, ok, iou_thresh, class_aware)
    torch.cuda.synchronize()
    diff = (got.int() - ref.int()).abs()
    NMS_TALLY["compared"] += got.numel()
    NMS_TALLY["mismatched"] += int(diff.sum())
    NMS_TALLY["max_abs_err"] = max(NMS_TALLY["max_abs_err"], int(diff.max()))
    check(torch.equal(got, ref), f"kernel D {label}: the keep mask differs from the plain "
          f"version's in {int(diff.sum())} of {got.numel()} places")
    check(torch.equal(got, again), f"kernel D {label}: two launches differ")
    kept = int(got.sum())
    log(f"  greedy_keep {label}: (B, K) = {tuple(ok.shape)}, keep mask equal to the plain "
        f"version's ({kept} kept of {int(ok.sum())} valid); two launches bit-equal")
    return kept


def check_nms(torch) -> dict:
    """Kernel D on synthetic candidates (the steps' own candidates at batch
    128 and 1 follow in phases 4-5, in :func:`time_step`)."""
    # 1000: not a multiple of 32, the rows in shared memory above the default
    # 48 KB; 2048: the rows in the scratch buffer.
    for k in (256, 512, 1000, 2048):
        check_nms_case(torch, f"seeded K={k}", *nms_problem(torch, 16, k, seed=k))
    k, b = 256, 4
    x = torch.arange(k, dtype=torch.float32, device="cuda") * 2.0
    z = torch.zeros_like(x)
    # Each box overlaps the next (IoU 1/3) and not the one after: a chain
    # through all K, greedy keeps every other box.
    chain = torch.stack([x, z, x + 4.0, z + 1.0], -1).expand(b, k, 4).contiguous()
    cls0 = torch.zeros(b, k, dtype=torch.int32, device="cuda")
    ok = torch.ones(b, k, dtype=torch.bool, device="cuda")
    check(check_nms_case(torch, f"a chain through all {k}", chain, cls0, ok) == b * k // 2,
          "kernel D: the chain must keep every other box")
    for k2 in (512, 1000, 2048):
        x2 = torch.arange(k2, dtype=torch.float32, device="cuda") * 2.0
        chain2 = torch.stack([x2, x2 * 0, x2 + 4.0, x2 * 0 + 1.0], -1)[None].contiguous()
        ones2 = torch.ones(1, k2, dtype=torch.bool, device="cuda")
        check(check_nms_case(torch, f"a chain through all {k2}", chain2,
                             torch.zeros(1, k2, dtype=torch.int32, device="cuda"), ones2)
              == k2 // 2, "kernel D: the chain must keep every other box")
    check(check_nms_case(torch, "every candidate invalid", chain, cls0, ~ok) == 0,
          "kernel D: invalid candidates are never kept")
    same = torch.tensor([10.0, 10.0, 30.0, 30.0], device="cuda").expand(b, k, 4).contiguous()
    check(check_nms_case(torch, "every box identical", same, cls0, ok) == b,
          "kernel D: identical boxes keep the first")
    flat = torch.tensor([5.0, 5.0, 5.0, 9.0], device="cuda").expand(b, k, 4).contiguous()
    check(check_nms_case(torch, "zero-area boxes", flat, cls0, ok) == b * k,
          "kernel D: zero-area boxes overlap nothing")
    boxes, classes, valid = nms_problem(torch, 16, 256, seed=7)
    check_nms_case(torch, "class_aware off", boxes, classes, valid, class_aware=False)
    kept = check_nms_case(torch, "threshold -0.25", boxes, classes, valid, iou_thresh=-0.25)
    check(kept == int(valid.any(1).sum()),
          "kernel D: below a negative threshold every pair overlaps (one kept per frame)")
    check(check_nms_case(torch, "threshold NaN", boxes, classes, valid, iou_thresh=float("nan"))
          == int(valid.sum()), "kernel D: nothing overlaps above a NaN threshold")
    check_nms_case(torch, "threshold 0", boxes, classes, valid, iou_thresh=0.0)
    nan = boxes.clone()
    nan[:, ::7, 0] = float("nan")
    nan[:, 3::11, 3] = float("inf")
    check_nms_case(torch, "NaN and inf coordinates", nan, classes, valid)
    # IoUs on the threshold (the float test's margin, then the exact test):
    # pairs of IoU exactly 0.5 are kept apart at 0.5 and merged at the float
    # below it; the chain's IoU 2 / 6 rounds to float(1/3), not above
    # float(1/3), above the float below it.
    m = torch.arange(32, dtype=torch.float32, device="cuda") * 10.0
    pairs = torch.stack([torch.stack([m, 0 * m, m + 2.0, 0 * m + 1.0], -1),
                         torch.stack([m, 0 * m, m + 1.0, 0 * m + 1.0], -1)], 1).reshape(1, 64, 4)
    ones64 = torch.ones(1, 64, dtype=torch.bool, device="cuda")
    zeros64 = torch.zeros(1, 64, dtype=torch.int32, device="cuda")
    below = lambda v: float(np.nextafter(np.float32(v), np.float32(0)))
    check(check_nms_case(torch, "IoU 0.5 at threshold 0.5", pairs, zeros64, ones64, 0.5) == 64
          and check_nms_case(torch, "IoU 0.5 just above the threshold", pairs, zeros64, ones64,
                             below(0.5)) == 32, "kernel D: IoUs on the threshold")
    third = float(np.float32(1 / 3))
    check(check_nms_case(torch, "IoU 1/3 at threshold float(1/3)", chain, cls0, ok, third)
          == b * k and check_nms_case(torch, "IoU 1/3 just above the threshold", chain, cls0,
                                      ok, below(third)) == b * k // 2,
          "kernel D: the chain's IoUs on the threshold")
    # The staging's other routes: boxes off a 16-byte boundary (scalar
    # loads), validity off a 4-byte boundary (byte loads).
    buf = torch.empty(boxes.numel() + 1, dtype=torch.float32, device="cuda")
    shifted = buf[1:].view(boxes.shape)
    shifted.copy_(boxes)
    okbuf = torch.empty(valid.numel() + 1, dtype=torch.bool, device="cuda")
    ok_shifted = okbuf[1:].view(valid.shape)
    ok_shifted.copy_(valid)
    check_nms_case(torch, "boxes and validity off their 16- and 4-byte boundaries", shifted,
                   classes, ok_shifted)
    return check_nms_clusters(torch)


def check_nms_clusters(torch) -> dict:
    """Kernel D at K = 1 and 8192, at B = 1 and 2 at every cluster size
    ``cluster_size`` returns on this card, and one input launched at every
    cluster size (the same bits). Returns the cluster size per (B, K)."""
    from tti_torch.kernels import nms as nk

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = {}
    for b, k in ((1, 1), (4, 1), (2, 8192), (1, 8192)):
        chosen[(b, k)] = nk.cluster_size(b, k, sms)
        check_nms_case(torch, f"K={k} (cluster {chosen[(b, k)]})",
                       *nms_problem(torch, b, k, seed=k + b))
    for b in (1, 2):
        for k in (32, 200, 256, 512):
            chosen[(b, k)] = nk.cluster_size(b, k, sms)
            check_nms_case(torch, f"B={b} K={k} (cluster {chosen[(b, k)]})",
                           *nms_problem(torch, b, k, seed=100 * b + k, spread=80.0))
        sizes = {c for (bb, _), c in chosen.items() if bb == b}
        check(sizes == {1, 2, 4, 8}, f"kernel D at B={b}: cluster sizes {sorted(sizes)} "
              "checked, every size the choice can return expected")
    args = nms_problem(torch, 2, 512, seed=5, spread=120.0)
    keeps = {c: nk._launch(*args, 0.25, True, cluster=c) for c in (1, 2, 4, 8)}
    torch.cuda.synchronize()
    check(all(torch.equal(v, keeps[1]) for v in keeps.values()),
          "kernel D: the cluster sizes disagree")
    log(f"  greedy_keep (2, 512) at clusters 1, 2, 4 and 8: bit-equal; cluster size per (B, K) "
        f"on {sms} SMs {chosen}")
    return {f"{b}x{k}": c for (b, k), c in chosen.items()}


def nms_errors() -> dict:
    """Kernel D's errors against its plain version over every case checked
    in this run (phase 3 and the steps' candidates): the largest |keep -
    plain|, the share of keep bits that differ and their count."""
    t = NMS_TALLY
    return {"max_abs_err": float(t["max_abs_err"]),
            "max_rel_err": t["mismatched"] / max(t["compared"], 1),
            "mismatched_keep_bits": t["mismatched"], "compared_keep_bits": t["compared"]}


# Pass 2's chain in the redesign (csrc/nms.cu): one warp vote per word of
# 32 ranks (about 30 cycles, the figure used for the first design's vote
# step) and one dependent integer operation per rank in the word's bit loop
# (about 4 cycles), at the SXM part's boost clock.
VOTE_CYCLES, BIT_STEP_CYCLES, SM_CLOCK_HZ = 30, 4, 1.98e9


def nms_bound_ms(boxes) -> tuple[float, str, dict]:
    """Kernel D's least time on this input: its bytes (boxes, classes and ok
    read once, keep written once) over 3.35 TB/s against its operations,
    16 float32 operations per candidate pair j < i (the IoU and the test)
    over the float32 peak. Beside it (``chain_ms``), the latency of pass 2's
    dependent chain, which no parallelism shortens: K / 32 votes and K bit
    steps per frame, the frames in parallel."""
    b, k, _ = boxes.shape
    nbytes = b * k * (16 + 4 + 1 + 1)
    ops = 16.0 * b * k * (k - 1) / 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["f32"] * 1e3
    chain = (-(-k // 32) * VOTE_CYCLES + k * BIT_STEP_CYCLES) / SM_CLOCK_HZ * 1e3
    info = {"bytes": nbytes, "ops": ops, "serial_words": -(-k // 32), "chain_ms": chain}
    return (t_bytes, "bytes", info) if t_bytes >= t_ops else (t_ops, "operations", info)


def load_first_nms(torch, path):
    """Build kernel D's first design (its ``nms.cu``, from ``path``) into
    its own library and return ``call(boxes, classes, ok, iou_thresh,
    class_aware)``, which launches it as its own wrapper did (not
    counted)."""
    import ctypes

    from tti_torch.kernels import build as kbuild

    out = kbuild.BUILD_DIR / "libtti_nms_first_design.so"
    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-o", str(out), path], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tti_greedy_keep.argtypes = [p, p, p, p, p, i, i, ctypes.c_float, i, p]
    lib.tti_greedy_keep.restype = i
    lib.tti_greedy_keep_scratch_words.argtypes = [i]
    lib.tti_greedy_keep_scratch_words.restype = i

    def call(boxes, classes, ok, iou_thresh, class_aware=True):
        b, k = ok.shape
        keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
        words = lib.tti_greedy_keep_scratch_words(k)
        scratch = torch.empty((b, words), dtype=torch.int32, device=boxes.device) if words else None
        err = lib.tti_greedy_keep(boxes.data_ptr(), classes.data_ptr(), ok.data_ptr(),
                                  keep.data_ptr(), None if scratch is None else scratch.data_ptr(),
                                  b, k, float(iou_thresh), int(class_aware),
                                  torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"first design of kernel D: cudaError {err}")
        return keep

    return call


def check_first_nms(torch, first, cands: dict, label: str) -> None:
    """Phase 3 again, for kernel D's first design: bit-equal to D on a
    step's candidates at batch 128 and 1."""
    from tti_torch.kernels import nms as nk

    for b, args in cands.items():
        got, old = nk.greedy_keep(*args), first(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, old), f"kernel D's first design disagrees on the {label} "
              f"step's candidates at batch {b}")
        log(f"  greedy_keep's first design on the {label} step's candidates at batch {b}: "
            "bit-equal to D")


def time_nms(torch, args, flush, first=None, plain=True) -> dict:
    """Kernel D on one step's candidates: kernel, plain sweep, bound, the
    cluster size, and an empty kernel of D's grid, clusters and shared
    memory (the launch's fixed cost); with ``first``, the first design in turns
    with D (first, D, D, first)."""
    from tti_torch.kernels import nms as nk

    boxes, classes, ok, iou_thresh, class_aware = args
    b, k = ok.shape
    cluster = nk.cluster_size(b, k, torch.cuda.get_device_properties(0).multi_processor_count)
    kern = lambda: nk.greedy_keep(*args)
    t = {"cluster": cluster}
    with torch.inference_mode():
        if first is not None:
            t["first_design_ms"] = [time_ms(torch, lambda: first(*args), flush=flush)]
        t["ms"] = time_ms(torch, kern, flush=flush)
        if first is not None:
            t["ms_again"] = time_ms(torch, kern, flush=flush)
            t["first_design_ms"].append(time_ms(torch, lambda: first(*args), flush=flush))
        t["empty_ms"] = time_ms(torch, lambda: nk.empty_launch(b, k, cluster, boxes.device),
                                flush=flush)
        if plain:
            t["plain_ms"] = time_ms(torch, lambda: nk.greedy_keep_plain(*args), iters=5,
                                    flush=flush)
    bound, bound_by, info = nms_bound_ms(boxes)
    return {**t, "bound_ms": bound, "bound_by": bound_by, "shape": list(ok.shape), **info}


def log_nms_time(label, t) -> None:
    first = (f" and {t['ms_again']:.4f} again, first design "
             f"{' and '.join(f'{v:.4f}' for v in t['first_design_ms'])} ms (first, D, D, first)"
             if "first_design_ms" in t else "")
    plain = f", plain sweep {t['plain_ms']:.4f} ms" if "plain_ms" in t else ""
    log(f"  greedy_keep on {label}, (B, K) = {tuple(t['shape'])}, cluster {t['cluster']}: "
        f"kernel {t['ms']:.4f} ms{first}{plain}, empty kernel of its shape {t['empty_ms']:.4f} "
        f"ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}; {t['bytes'] / 1e6:.3f} MB, "
        f"{t['ops'] / 1e9:.4f} GFLOP), pass 2's chain {t['chain_ms']:.5f} ms "
        f"({t['serial_words']} votes, {t['shape'][1]} bit steps)")


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
    f32 FMA). Warp pass 1 (frames, w1, window, kw): of every kept source
    row the 32-byte sectors that hold a sampled byte (at k = 3 and 5 that is
    the whole row; the skipped rows are not read), what these weights need
    (their non-zero entries, 2 bytes each, and the table) and the output;
    2 * 3B operations per non-zero weight on the bf16 tensor cores. With
    ``dense=True``: all of W1 and 2 * 3B * ws * wo * hs operations (the
    bound of a product that reads W1 whole)."""
    if name == "warp_pass1_decimated":
        frames, w1, window, kw, dense = args
        b, _, w, _ = frames.shape
        k, off, hs, ws = kw["k"], kw["off"], kw["hs"], kw["ws"]
        wo = w1.shape[2]
        first = 3 * (off + k * np.arange(ws))
        sectors = np.unique(np.concatenate([first // 32, (first + 2) // 32])).size
        frame_bytes = b * hs * min(32 * sectors, 3 * w)
        weights = w1.numel() if dense else int((w1 != 0).sum())
        nbytes = (frame_bytes + (weights + hs * 3 * b * wo) * w1.element_size()
                  + (0 if dense else window.numel() * window.element_size()))
        ops = 2.0 * 3 * b * weights
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
    import tti_torch.model.layers as layers
    import tti_torch.parallel.runtime as rt
    import tti_torch.postprocess.nms as nms
    from tti_torch.kernels import int8conv as ik
    from tti_torch.kernels import nms as nk

    saved = (rt.warp_pass1_decimated, nms.greedy_keep, layers.int8_conv2d,
             layers.act_scale_per_sample)
    rt.warp_pass1_decimated = wp.warp_pass1_decimated_plain
    nms.greedy_keep = nk.greedy_keep_plain
    layers.int8_conv2d = ik.int8_conv2d_plain
    layers.act_scale_per_sample = ik.act_scale_per_sample_plain
    try:
        with stats_route(ms.mask_stats_soft_plain, ms.mask_stats_binary_plain):
            yield
    finally:
        (rt.warp_pass1_decimated, nms.greedy_keep, layers.int8_conv2d,
         layers.act_scale_per_sample) = saved


def reset_launch_counts(ms, wp) -> None:
    from tti_torch.kernels import conv_epilogue as ce
    from tti_torch.kernels import int8conv as ik
    from tti_torch.kernels import nms as nk

    ms.reset_launch_counts()
    wp.reset_launch_counts()
    nk.reset_launch_counts()
    ik.reset_launch_counts()
    ce.reset_launch_counts()


def launch_counts(ms, wp) -> dict:
    """Kernels A-F's launches since :func:`reset_launch_counts` (kernel G's,
    the convolutions' epilogue, are read in phases 5c and 5j)."""
    from tti_torch.kernels import int8conv as ik
    from tti_torch.kernels import nms as nk

    return {**ms.LAUNCHES, **wp.LAUNCHES, **nk.LAUNCHES, **ik.LAUNCHES}


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


def build_pipeline(torch, frame_hw, imgsz, ckpt, dtype="bfloat16", device="cuda", **kw):
    from tti_torch.core.config import MeasureConfig, ModelConfig
    from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
    from tti_torch.parallel.runtime import InspectionPipeline

    path = os.path.join(HERE, "checkpoints", ckpt)
    meta = checkpoint_metadata(path)
    cfg = ModelConfig(variant=meta.get("variant", "n"), num_classes=meta.get("num_classes", 2),
                      image_size=imgsz, dtype=dtype,
                      mask_stride=meta.get("mask_stride", 4),
                      proto_head=meta.get("proto_head", "deconv"))
    return InspectionPipeline(
        cfg, load_flax_msgpack(path), frame_hw, calibration=bench_calibration(frame_hw),
        measure_cfg=MeasureConfig().with_subcell_from(meta), roi=bench_roi(frame_hw),
        device=device, **kw)


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
    ``kernels`` and kernel D (NMS) must launch once in that step, and the
    step must agree with the same step run with the plain versions bound in
    the kernels' place."""
    t0 = time.perf_counter()
    pipe = build_pipeline(torch, frame_hw, imgsz, ckpt, **pipe_kw)
    setup_s = time.perf_counter() - t0
    frames = textile(frame_hw, batch)
    reset_launch_counts(ms, wp)
    got = pipe.process_batch(frames)
    launches = launch_counts(ms, wp)
    kernels = (*kernels, "greedy_keep")
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


def device_time(torch, fn, steps, skip=None):
    """``fn`` run ``steps`` times under the profiler: device ms per step by
    kernel name, the device's busy ms per step (the union of its kernels'
    intervals) and its ops per step; busy is None without device events.
    User annotations on the device's timeline (``Optimizer.step#...``) span
    the gaps between their kernels and are left out, and so are the events
    whose name holds ``skip`` (lower case), from busy only."""
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
            if skip is None or skip not in e.name.lower():
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


def capture_nms_inputs(pipe, frames) -> tuple:
    """The (boxes, classes, ok, iou_thresh, class_aware) one step hands
    kernel D."""
    import tti_torch.postprocess.nms as nms

    seen, saved = [], nms.greedy_keep

    def recorder(*args):
        seen.append(args)
        return saved(*args)

    nms.greedy_keep = recorder  # greedy_suppress looks it up at each call
    try:
        pipe.step(frames)
    finally:
        nms.greedy_keep = saved
    check(len(seen) == 1, f"one NMS per step expected, got {len(seen)}")
    return seen[0]


def check_step_syncs(torch, pipe, label, frames) -> dict:
    """The synchronising calls in one step on device-resident frames (none:
    NMS runs on the card) and kernel D's launches in one step (one)."""
    from step_syncs_torch import count_step_syncs

    from tti_torch.kernels import nms as nk

    n, where, first = count_step_syncs(torch, pipe, frames)
    nk.reset_launch_counts()
    pipe.step(frames)
    d = nk.LAUNCHES["greedy_keep"]
    log(f"{label} batch {frames.shape[0]}: {n} synchronising call(s) per step {where}"
        + (f" (the first window: {first})" if first != where else "")
        + f"; kernel D launches per step: {d}")
    check(n == 0, f"{label}: {n} synchronising calls in one step (none expected): {where}")
    check(d == 1, f"{label}: kernel D launched {d} times in one step (once expected)")
    return {"syncs": n, "where": where, "first_window": first, "greedy_keep_launches": d}


def time_step(torch, ms, pipe, label, frame_hw, profile=True, iters=20, p50_iters=50):
    """Step timings and breakdowns, after the synchronising calls of one
    step at batch 128 and 1; also returns the mask-stats inputs of one
    batch-128 step and kernel D's inputs at batch 128 and 1 (held to the
    plain version here: phase 3 on the step's own candidates)."""
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
    nms_args = {b: capture_nms_inputs(pipe, f) for b, f in ((batch, frames), (1, one))}
    for b, args in nms_args.items():
        check_nms_case(torch, f"{label}'s candidates at batch {b}", *args)
    return {"frames_per_s": fps, "batch": batch, "p50_ms": p50, "at_batch": parts,
            "at_batch_1": one_parts, "syncs": syncs}, (stats_args, nms_args)


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
    turns = time_pair(torch, head, head_k, frames, frames[:1].contiguous())
    log(f"headline kernel route against the einsum route in turns (einsum, kernel, kernel, "
        f"einsum; 4 steps of {BATCH} frames each): {turns['frames_per_s']:.1f} frames/s against "
        f"{turns['ref_frames_per_s']:.1f} ({turns['frames_per_s'] / turns['ref_frames_per_s'] - 1:+.1%}); "
        f"batch-1 p50 {turns['p50_ms']:.3f} ms against {turns['ref_p50_ms']:.3f}")
    return {"input_max_abs_diff": x_max, "input_mean_abs_diff": x_mean, "mm_max_diff": mm,
            "mm_median_diff": mm_med, "bf16_vs_f32_warp_max_abs_diff": f32_diff,
            "turns_vs_einsum": turns}


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
    two-pass step; at this exact decimation the gather packs the decimated
    bytes, bit-equal to the float resize it skips."""
    label = "packed-remap step (1080x1920, imgsz 640, gather remap)"
    pipe, _, got = check_step(torch, ms, wp, label, frame_hw, imgsz, ckpt,
                              ("mask_stats_binary",), batch=BATCH, remap="packed")
    from tti_torch.model.yolo import space_to_depth2
    from tti_torch.preprocess.letterbox import letterbox_content
    from tti_torch.preprocess.remap import PackedRemap

    check(isinstance(pipe.warp, PackedRemap), "remap='packed' must build the gather")
    frames = torch.from_numpy(textile(frame_hw, BATCH)).cuda()
    with torch.inference_mode():
        x = pipe.preprocess(frames)
        resized = pipe.warp(letterbox_content(frames, pipe.spec, pipe.dtype))
        resized = space_to_depth2(resized) if pipe.model.s2d_input else resized
        u8_differ = int((x != resized).sum())
        check(u8_differ == 0, f"packed route: the u8 pack and the float resize differ in "
              f"{u8_differ} model-input values")
        diff = (x.float() - head.preprocess(frames).float()).abs()
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
    log(f"packed-remap model input: the u8 pack equal to the float resize's in all "
        f"{x.numel()} values; against the two-pass step's at batch {BATCH}: mean abs diff "
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
    check(launches["mask_stats_binary"] == 2 and launches["greedy_keep"] == 2,
          f"dual step: one kernel-B and one kernel-D launch per model: {launches}")
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
    return {"frames_per_s": fps, "warp_freed_mb": freed,
            "greedy_keep_launches": launches["greedy_keep"]}


# ---------------------------------------------------------------------------
# Phase 5b: the step's opt-in modes
# ---------------------------------------------------------------------------

CONFIGS = {  # name: (frame_hw, imgsz, checkpoint), as phases 4-5 and the bench run them
    "deploy": (*DEPLOY, "yolov8n_textile_cam.msgpack"),
    "headline": (*HEADLINE, "yolov8n_textile.msgpack"),
}
# Each mode where tti applies it: (name, configuration, pipeline arguments);
# each is held to the default step of its configuration.
MODES = (
    ("lazy_decode", "deploy", dict(lazy_decode=True)),
    ("fused_head", "deploy", dict(fused_head=True)),
    ("warp_block=64", "deploy", dict(warp_block=64)),
    ("fold_bn=False", "deploy", dict(fold_bn=False)),
    ("maskstats_logits=f32", "deploy", dict(maskstats_logits="f32")),
    ("lazy_decode", "headline", dict(lazy_decode=True)),
    ("fused_head", "headline", dict(fused_head=True)),
    ("warp_block=64", "headline", dict(warp_block=64)),
    ("warp_col_expand", "headline", dict(warp_col_expand=True)),
)
MODE_F32_BATCH = 8
# bf16 against the reference bf16 step at batch 128: the share of frames
# with the same detection count, and mm limits. The kernel route's (max
# 0.25, median 0.05; one binary-mask cell flipped by a bf16 step moves a
# reading by up to 0.24 mm here), with the share and the median tightened
# from the readings of two H100 runs, which were equal: every frame's count
# equal in every mode, mm max 0.225 and median 0.0013 (fold_bn=False; every
# other mode at most 8.8e-05).
MODE_NVALID_SHARE, MODE_MM_MAX, MODE_MM_MEDIAN = 0.99, 0.25, 0.01


def check_jit_division(torch) -> dict:
    """Phases 4-5: the divisions by a constant fixed when ``tti`` traces its
    step (``tti_torch.preprocess.letterbox.jit_divide``, the product with
    the float32 reciprocal) on the card, bit-equal to the same inputs on the
    CPU: ``scale_boxes_to_frame`` on 100,000 seeded boxes at the deploy and
    headline specs, ``normalize`` of one headline batch of textile frames in
    float32 and bfloat16, and ``undistort_points`` with the deployment
    camera matrix on the card (zero distortion, as the undistorted step
    measures). Its wall seconds."""
    from tti_torch.calib.geometry import undistort_points
    from tti_torch.preprocess import letterbox as lb

    t0 = time.perf_counter()
    rng = np.random.default_rng(19)
    for label, ((h, w), imgsz) in (("deploy", DEPLOY), ("headline", HEADLINE)):
        spec = lb.letterbox_spec(h, w, imgsz)
        boxes = torch.from_numpy(rng.uniform(0, imgsz, (100_000, 4)).astype(np.float32))
        got = lb.scale_boxes_to_frame(boxes.cuda(), spec).cpu()
        check(torch.equal(got, lb.scale_boxes_to_frame(boxes, spec)),
              f"scale_boxes_to_frame at the {label} spec: the card differs from the CPU")
    frames = torch.from_numpy(textile(HEADLINE[0]))
    for dtype in (torch.float32, torch.bfloat16):
        got = lb.normalize(frames.cuda(), dtype).cpu()
        check(got.dtype == dtype and torch.equal(got, lb.normalize(frames, dtype)),
              f"normalize in {dtype}: the card differs from the CPU")
    uv = torch.from_numpy(rng.uniform(0, [1280, 960], (100_000, 2)).astype(np.float32))
    K = torch.from_numpy(K_960.astype(np.float32))
    for iters in (0, 5):
        got = undistort_points(uv.cuda(), K.cuda(), torch.zeros(5, device="cuda"), iters).cpu()
        check(torch.equal(got, undistort_points(uv, K, torch.zeros(5), iters)),
              f"undistort_points (iters {iters}): the card differs from the CPU")
    wall = time.perf_counter() - t0
    log(f"divisions by trace-time constants, card against CPU: scale_boxes_to_frame (deploy, "
        f"headline; 100,000 boxes), normalize ({frames.shape[0]} headline frames, float32 and "
        f"bfloat16), undistort_points (100,000 points): bit-equal ({wall:.1f} s wall)")
    return {"wall_s": wall}


def time_pair(torch, ref, pipe, frames, one, steps=4, p50_iters=8) -> dict:
    """``ref``'s and ``pipe``'s steps in turns (ref, pipe, pipe, ref), each
    turn ``steps`` steps at the batch of ``frames`` (host clock around a
    synchronise) and ``p50_iters`` steps on ``one``, after a warm step:
    frames/s over both turns and the p50 of both turns' latencies."""
    runs = {"ref": [0.0, []], "mode": [0.0, []]}
    with torch.inference_mode():
        for who, p in (("ref", ref), ("mode", pipe), ("mode", pipe), ("ref", ref)):
            p.step(frames)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                p.step(frames)
            torch.cuda.synchronize()
            runs[who][0] += time.perf_counter() - t0
            p.step(one)
            torch.cuda.synchronize()
            for _ in range(p50_iters):
                t = time.perf_counter()
                p.step(one)
                torch.cuda.synchronize()
                runs[who][1].append(time.perf_counter() - t)
    fps = lambda who: 2 * steps * frames.shape[0] / runs[who][0]
    p50 = lambda who: 1e3 * float(np.median(runs[who][1]))
    return {"frames_per_s": fps("mode"), "p50_ms": p50("mode"),
            "ref_frames_per_s": fps("ref"), "ref_p50_ms": p50("ref")}


def compare_f32(got, ref, label) -> tuple[float, float]:
    """A mode's float32 step against its reference step's on the same
    frames: detections equal, boxes within 1e-3 px, mm within 1e-3 and the
    same readings present."""
    np.testing.assert_array_equal(got.valid, ref.valid, err_msg=f"{label}: valid")
    np.testing.assert_array_equal(got.classes, ref.classes, err_msg=f"{label}: classes")
    box = float(np.abs(got.boxes_frame - ref.boxes_frame).max())
    check(box <= 1e-3, f"{label}: float32 boxes differ by {box} px (limit 1e-3)")
    for key in MM_KEYS:
        a, r = getattr(got.measurements, key), getattr(ref.measurements, key)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(r), err_msg=f"{label}: {key}")
    mm, n = mm_difference(got, ref)
    check(n > 0, f"{label}: no float32 reading to compare")
    check(mm <= 1e-3, f"{label}: float32 mm differ by {mm} (limit 1e-3)")
    return box, mm


def check_modes(torch, ms, wp) -> dict:
    """Phase 5b: each mode's step at full width. Its kernels launch once per
    step and it makes no synchronising call (batch 128 and 1); in float32
    (batch 8) it agrees with its reference step within 1e-3 px and 1e-3 mm;
    in bf16 (batch 128) the detection counts agree on most frames and the
    mm within the kernel route's limits; frames/s at batch 128 and the
    batch-1 p50 beside its reference step's; kernel G once per biased
    convolution."""
    from step_syncs_torch import count_step_syncs

    from tti_torch.kernels import conv_epilogue as ce

    t_phase = time.perf_counter()
    out: dict = {}
    for config, (hw, imgsz, ckpt) in CONFIGS.items():
        frames_np = textile(hw, BATCH)
        frames = torch.from_numpy(frames_np).cuda()
        one = frames[:1].contiguous()
        small = textile(hw, MODE_F32_BATCH)
        group = [(name, kw) for name, cfg, kw in MODES if cfg == config]
        # The reference step: bf16 (kept for the timings in turns) and float32.
        t0 = time.perf_counter()
        ref = build_pipeline(torch, hw, imgsz, ckpt)
        ref_out = ref.process_batch(frames_np)
        ref32 = build_pipeline(torch, hw, imgsz, ckpt, dtype="float32")
        ref32_out = ref32.process_batch(small)
        del ref32
        torch.cuda.empty_cache()
        ref_label = f"{config} default"
        weight_mb = lambda p: getattr(p.warp, "weight_bytes", 0) / 1e6
        log(f"  {ref_label}: the reference step built in bf16 and float32 in "
            f"{time.perf_counter() - t0:.1f} s")
        for name, kw in group:
            label = f"{config} {name}"
            t0 = time.perf_counter()
            pipe = build_pipeline(torch, hw, imgsz, ckpt, **kw)
            setup_s = time.perf_counter() - t0
            reset_launch_counts(ms, wp)
            got = pipe.process_batch(frames_np)
            launches = launch_counts(ms, wp)
            launches_g, want_g = ce.LAUNCHES["bias_act"], biased_convs(pipe.model)
            check(launches_g == want_g, f"{label}: {launches_g} launches of kernel G, "
                  f"{want_g} expected (one per biased convolution)")
            stats_kernel = ("mask_stats_soft" if pipe.measure_cfg.subcell_edge
                            else "mask_stats_binary")
            check(launches["greedy_keep"] == 1 and launches[stats_kernel] == 1,
                  f"{label}: kernels D and {stats_kernel} once per step expected: {launches}")
            syncs = {b: count_step_syncs(torch, pipe, f)[:2] for b, f in ((BATCH, frames),
                                                                          (1, one))}
            for b, (n, where) in syncs.items():
                check(n == 0, f"{label} batch {b}: {n} synchronising calls per step: {where}")
            t = time_pair(torch, ref, pipe, frames, one)
            check_outputs(got, label, BATCH, pipe.model_cfg.max_detections)
            warp_mb = (weight_mb(pipe), weight_mb(ref))
            del pipe
            same_n = float((got.valid.sum(1) == ref_out.valid.sum(1)).mean())
            d = mm_differences(got, ref_out)
            check(d.size > 0, f"{label}: no bf16 reading to compare")
            mm_max, mm_med = float(d.max()), float(np.median(d))
            check(same_n >= MODE_NVALID_SHARE,
                  f"{label}: bf16 detection counts agree on {same_n:.1%} of frames")
            check(mm_max <= MODE_MM_MAX and mm_med <= MODE_MM_MEDIAN,
                  f"{label}: bf16 mm differ by max {mm_max}, median {mm_med}")
            pipe32 = build_pipeline(torch, hw, imgsz, ckpt, dtype="float32", **kw)
            box32, mm32 = compare_f32(pipe32.process_batch(small), ref32_out, label)
            del pipe32
            torch.cuda.empty_cache()
            log(f"  {label}: {t['frames_per_s']:.1f} frames/s at batch {BATCH} against "
                f"{t['ref_frames_per_s']:.1f} ({t['frames_per_s'] / t['ref_frames_per_s'] - 1:+.1%}), "
                f"batch-1 p50 {t['p50_ms']:.3f} ms against {t['ref_p50_ms']:.3f} "
                f"({t['p50_ms'] / t['ref_p50_ms'] - 1:+.1%}) ({ref_label}, in turns); "
                f"launches {launches}; 0 syncs per step at batch {BATCH} and 1; bf16 against "
                f"the reference step: detection counts equal on {same_n:.1%} of frames, mm "
                f"max {mm_max:.4g} median {mm_med:.4g} over {d.size} readings; float32 (batch "
                f"{MODE_F32_BATCH}): boxes {box32:.3g} px, mm {mm32:.3g}; two-pass warp "
                f"weights {warp_mb[0]:.0f} MB (reference {warp_mb[1]:.0f} MB); set-up "
                f"{setup_s:.1f} s")
            out[label] = {**t, "reference": ref_label, "bias_act_launches": launches_g,
                          "bf16_nvalid_equal_share": same_n,
                          "bf16_mm_max": mm_max, "bf16_mm_median": mm_med,
                          "f32_box_max": box32, "f32_mm_max": mm32, "setup_s": setup_s,
                          "warp_weight_mb": warp_mb[0], "ref_warp_weight_mb": warp_mb[1]}
        del ref, frames, one
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"modes phase: {wall:.1f} s")
    out["wall_s"] = wall
    return out


# ---------------------------------------------------------------------------
# Phase 5c: int8 inference (kernels E and F)
# ---------------------------------------------------------------------------

PEAK_INT8_OPS = 1979e12  # H100 SXM, dense int8 tensor core operations per second
INT8_BLOCKS = 66  # quantized Conv blocks per forward, both checkpoints
# tti's detection contract against the float step (tests/test_quantize.py:123-170):
# every float detection with score > 0.4 has an int8 detection of its class at
# IoU > 0.9. Held exactly on tti's own scene (the test's: seed 7 of the mm
# report's scenes, 960x1280, imgsz 640, float32). On the configurations' 8
# textile frames W8A8 itself misses it for a few stitches: tti's own int8 on
# the CPU in float32 keeps 61 of 61 at deploy but 44 of 46 at the headline
# (tests/torch_int8_contract.py). There the confident detections below IoU 0.9
# are held to a share of INT8_BELOW_SHARE and each to IoU > INT8_IOU_FLOOR;
# the limits are the readings with margin (at most 48 of 736 below 0.9,
# headline int8 against bf16; the lowest IoU printed was 0.837).
INT8_SCORE, INT8_IOU, INT8_IOU_FLOOR, INT8_BELOW_SHARE = 0.4, 0.9, 0.8, 0.10
# Kernels E and F against their plain versions over every call checked in
# this run: calls, the largest SiLU difference in ulps and the largest
# |kernel - plain| of the activated outputs.
# F's own: calls, scales compared and the largest |kernel - plain|.
INT8_TALLY = {"calls": 0, "max_ulp": 0, "max_abs_err": 0.0, "f_calls": 0, "f_values": 0,
              "f_max_abs_err": 0.0}


def ulp_distance(torch, a, b) -> int:
    """The largest distance in units of the last place between two tensors
    of one float dtype: bit patterns mapped to ordered integers."""
    if a.dtype == torch.bfloat16:
        ia, ib, top = a.view(torch.int16).long(), b.view(torch.int16).long(), -(1 << 15)
    else:
        ia, ib, top = a.view(torch.int32).long(), b.view(torch.int32).long(), -(1 << 31)
    order = lambda i: torch.where(i < 0, top - i, i)
    return int((order(ia) - order(ib)).abs().max()) if a.numel() else 0


def check_int8_call(torch, ik, label, x, qpacked, wscale, bias, k, stride, pad, xscale=None,
                    act=True):
    """One quantized block through kernels F (``xscale`` None: per sample)
    and E against the plain versions on the same inputs, each kernel
    launched twice: F bit-equal; E's output before SiLU bit-equal (the
    codes, the int32 accumulators and the epilogue, read through the
    output); after SiLU within 1 ulp (the two toolkits' expf). Returns
    the largest |kernel - plain| after SiLU."""
    if xscale is None:
        s1, s2 = ik.act_scale_per_sample(x), ik.act_scale_per_sample(x)
        check(torch.equal(s1, s2), f"{label}: two launches of F differ")
        plain_s = ik.act_scale_per_sample_plain(x)
        f_err = float((s1 - plain_s).abs().max())
        INT8_TALLY["f_calls"] += 1
        INT8_TALLY["f_values"] += s1.numel()
        INT8_TALLY["f_max_abs_err"] = max(INT8_TALLY["f_max_abs_err"], f_err)
        check(torch.equal(s1, plain_s), f"{label}: F differs from its plain version (max "
              f"|diff| {f_err})")
        xscale = s1
    args = (x, qpacked, wscale, bias, xscale, k, stride, pad)
    lin = [ik.int8_conv2d(*args, act=False) for _ in range(2)]
    check(torch.equal(lin[0], lin[1]), f"{label}: two launches of E differ")
    plain = ik.int8_conv2d_plain(*args, act=False)
    if not torch.equal(lin[0], plain):
        d = (lin[0].float() - plain.float()).abs()
        raise AssertionError(f"{label}: E before SiLU differs from its plain version in "
                             f"{int((d > 0).sum())} of {d.numel()} values, max {float(d.max())}")
    if not act:
        INT8_TALLY["calls"] += 1
        return 0.0
    got = [ik.int8_conv2d(*args) for _ in range(2)]
    check(torch.equal(got[0], got[1]), f"{label}: two launches of E differ")
    ref = ik.silu_plain(plain)  # the plain version's own last step
    ulp = ulp_distance(torch, got[0], ref)
    err = float((got[0].float() - ref.float()).abs().max())
    check(ulp <= 1, f"{label}: E's SiLU differs from silu_plain's by {ulp} ulp (limit 1)")
    INT8_TALLY["calls"] += 1
    INT8_TALLY["max_ulp"] = max(INT8_TALLY["max_ulp"], ulp)
    INT8_TALLY["max_abs_err"] = max(INT8_TALLY["max_abs_err"], err)
    return err


def check_int8_kernels(torch, ik) -> dict:
    """Kernels E and F on synthetic cases beside the steps' own inputs: the
    plain stem (ci 3), the s2d stem (ci 12), the 3x3 and 1x1 shapes, K =
    2304, a C2f channel slice (F must not see the other channels), an
    all-zero input (F's 1e-12 floor), an accumulator above 2^24 and the
    codes alone (identity 1x1 weights), in bf16 and float32, per-sample
    and static scales; then E's tiles, walk and routes (ragged tiles, batch
    1, channel groups, two TMA boxes, NCHW inputs, a walk across samples,
    C2f slices at channels 16, 32, 64 and 128)."""
    g = torch.Generator(device="cuda").manual_seed(8)
    cl = torch.channels_last

    def weights(co, k, ci, lo=-127, hi=128):
        qw = torch.randint(lo, hi, (co, k, k, ci), generator=g, device="cuda").to(torch.int8)
        wscale = torch.rand(co, generator=g, device="cuda") * 0.02 + 1e-3
        bias = torch.randn(co, generator=g, device="cuda") * 0.5
        return ik.pack_qweight(qw), wscale, bias

    def act(shape, dtype=torch.bfloat16, scale=2.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype).contiguous(
            memory_format=cl)

    out = {}
    cases = [
        ("plain stem ci 3, k3 s2", torch.rand((4, 3, 96, 128), generator=g, device="cuda").to(
            torch.bfloat16).contiguous(memory_format=cl), weights(16, 3, 3), 3, 2, 1),
        ("s2d stem ci 12, k2 s1 p0", act((4, 12, 49, 65)), weights(16, 2, 12), 2, 1, 0),
        ("3x3 ci 16 -> 32, s2", act((4, 16, 48, 64)), weights(32, 3, 16), 3, 2, 1),
        ("1x1 ci 48 -> 32", act((4, 48, 24, 32)), weights(32, 1, 48), 1, 1, 0),
        ("3x3 ci 256 -> 256 (K 2304)", act((2, 256, 12, 16)), weights(256, 3, 256), 3, 1, 1),
        ("3x3 ci 16 -> 16, float32", act((4, 16, 40, 48), torch.float32), weights(16, 3, 16),
         3, 1, 1),
        ("plain stem ci 3, float32", torch.rand((2, 3, 64, 80), generator=g, device="cuda"
                                                ).contiguous(memory_format=cl),
         weights(16, 3, 3), 3, 2, 1),
    ]
    for label, x, (qp, ws, b), k, s, p in cases:
        check_int8_call(torch, ik, label, x, qp, ws, b, k, s, p)
        static = (x.float().abs().max() / 127.0).reshape(())
        check_int8_call(torch, ik, label + ", static scale", x, qp, ws, b, k, s, p, static)
    # A C2f bottleneck's input: channels 32-63 of a channels_last tensor,
    # read in place; the other channels hold values F must not see.
    base = act((4, 64, 24, 32))
    base[:, :32] = 1e4
    sl = base[:, 32:]
    check(not sl.is_contiguous(memory_format=cl) and sl.stride(1) == 1, "the slice is strided")
    qp, ws, b = weights(32, 3, 32)
    check_int8_call(torch, ik, "C2f channel slice", sl, qp, ws, b, 3, 1, 1)
    check(float(ik.act_scale_per_sample(sl).max()) < 1e3 / 127, "F read outside the slice")
    # A slice 8 bytes off alignment: TMA refuses it, E takes its ring route
    # (8-byte cp.async copies), as the s2d stem does.
    base = act((4, 24, 20, 24))
    sl = base[:, 4:20]
    check(sl.data_ptr() % 16 == 8, "the slice is 8 bytes off alignment")
    qp, ws, b = weights(32, 3, 16)
    check_int8_call(torch, ik, "3x3 ci 16, the ring route (8-byte copies)", sl, qp, ws, b, 3, 2, 1)
    # All zeros: F's floor, and E gives SiLU(bias).
    zero = torch.zeros((2, 16, 20, 24), dtype=torch.bfloat16, device="cuda").contiguous(
        memory_format=cl)
    check(torch.equal(ik.act_scale_per_sample(zero), torch.full((2,), 1e-12, device="cuda")
                      / torch.full((2,), 127.0, device="cuda")), "F's floor on zeros")
    qp, ws, b = weights(16, 3, 16)
    check_int8_call(torch, ik, "all-zero input", zero, qp, ws, b, 3, 1, 1)
    # Accumulators above 2^24: codes 126-127, weights 100-127, 2304 terms,
    # scales 1 and bias 0, so the output is float(acc) itself.
    big = (127.0 - (torch.rand((1, 256, 6, 8), generator=g, device="cuda") < 0.1).float()
           ).contiguous(memory_format=cl)
    qp, _, _ = weights(64, 3, 256, 100, 128)
    ones, zeros = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    check_int8_call(torch, ik, "accumulator above 2^24", big, qp, ones, zeros, 3, 1, 1,
                    torch.ones((), device="cuda"), act=False)
    acc = ik.int8_conv2d(big, qp, ones, zeros, torch.ones((), device="cuda"), 3, 1, 1, act=False)
    out["largest_accumulator"] = float(acc.max())
    check(out["largest_accumulator"] > 2 ** 24, "the accumulator case stays below 2^24")
    # The codes alone: identity 1x1 weights and wscale 1, bias 0: the output
    # is code * xscale, one value per code.
    eye = torch.eye(32, device="cuda").to(torch.int8).view(32, 1, 1, 32)
    check_int8_call(torch, ik, "the codes (identity 1x1)", act((4, 32, 24, 32), scale=5.0),
                    ik.pack_qweight(eye), torch.ones(32, device="cuda"),
                    torch.zeros(32, device="cuda"), 1, 1, 0, act=False)
    # The redesign's tiles, walk and routes: outputs that are not a multiple
    # of the tile (rows and 64 columns), batch 1 at the smallest deploy
    # block, co 128 and 256 (channel groups at s2), two TMA boxes (ci 384
    # and 512), inputs in NCHW order (the ring, one element per copy), a
    # walk across 33 samples whose scales lie 1e-3 to 1e3 apart, and C2f
    # slices at every channel offset the model uses.
    cases = [
        ("ragged tiles 70x150 -> 64", act((3, 32, 70, 150)), weights(64, 3, 32), 3, 1, 1),
        ("batch 1, P5 ci 256 -> 32", act((1, 256, 23, 30)), weights(32, 3, 256), 3, 1, 1),
        ("batch 1, P5 ci 256 -> 64", act((1, 256, 23, 30)), weights(64, 3, 256), 3, 1, 1),
        ("1x1 ci 64 -> 128", act((2, 64, 46, 60)), weights(128, 1, 64), 1, 1, 0),
        ("1x1 ci 512 -> 256, two boxes", act((2, 512, 12, 20)), weights(256, 1, 512), 1, 1, 0),
        ("1x1 ci 384 -> 128, two boxes", act((2, 384, 12, 20)), weights(128, 1, 384), 1, 1, 0),
        ("3x3 ci 128 -> 256, s2", act((2, 128, 46, 60)), weights(256, 3, 128), 3, 2, 1),
        ("NCHW ci 16, bf16", act((2, 16, 20, 24)).contiguous(), weights(16, 3, 16), 3, 1, 1),
        ("NCHW ci 16, float32", act((2, 16, 20, 24), torch.float32).contiguous(),
         weights(32, 3, 16), 3, 2, 1),
        ("float32 ci 64 -> 128, s2 (32-column tiles)", act((2, 64, 92, 120), torch.float32),
         weights(128, 3, 64), 3, 2, 1),
    ]
    for label, x, (qp, ws, b), k, s, p in cases:
        check_int8_call(torch, ik, label, x, qp, ws, b, k, s, p)
        static = (x.float().abs().max() / 127.0).reshape(())
        check_int8_call(torch, ik, label + ", static scale", x, qp, ws, b, k, s, p, static)
    spread = torch.logspace(-3, 3, 33, device="cuda").view(-1, 1, 1, 1)
    walk = (act((33, 32, 9, 70), torch.float32) * spread).to(torch.bfloat16).contiguous(
        memory_format=cl)
    qp, ws, b = weights(32, 3, 32)
    check_int8_call(torch, ik, "a walk across 33 samples", walk, qp, ws, b, 3, 1, 1)
    for c in (16, 32, 64, 128):
        base = act((2, 2 * c, 20, 24))
        base[:, :c] = 1e4
        qp, ws, b = weights(c, 3, c)
        check_int8_call(torch, ik, f"C2f slice at channel {c}", base[:, c:], qp, ws, b, 3, 1, 1)
    out["scale_routes"] = check_scale_layouts(torch, ik, g)
    torch.cuda.synchronize()
    log(f"  kernels E and F against their plain versions on {INT8_TALLY['calls']} synthetic "
        f"calls: F bit-equal, E bit-equal before SiLU, SiLU within "
        f"{INT8_TALLY['max_ulp']} ulp; largest accumulator {out['largest_accumulator']:.0f}")
    return out


def check_scale(torch, ik, label, x) -> None:
    """Kernel F alone against its plain version, launched twice: bit-equal
    (a NaN sample's scale NaN in both)."""
    got = [ik.act_scale_per_sample(x) for _ in range(2)]
    plain = ik.act_scale_per_sample_plain(x)
    same = lambda a, b: torch.allclose(a, b, rtol=0, atol=0, equal_nan=True)
    check(same(got[0], got[1]), f"{label}: two launches of F differ")
    check(same(got[0], plain), f"{label}: F differs from its plain version (max |diff| "
          f"{float((got[0] - plain).abs().max())})")
    INT8_TALLY["f_calls"] += 1
    INT8_TALLY["f_values"] += plain.numel()


def check_scale_layouts(torch, ik, g) -> dict:
    """Kernel F on the layouts its routes split (int8conv.scale_plan): dense
    samples starting at each of 8 elements past a 16-byte boundary and at
    odd sample strides (the span's head and tail), 8- and 4-byte vectors
    (slices off alignment), C = 12 slices, an NCHW slice (a dense span) and
    every other column (single elements), bf16 and float32; a NaN, an
    infinity and an all-zero sample; batch 1 at the largest deploy input
    (8 blocks in one cluster); then two CUDA streams running F at once on
    different inputs, each bit-equal to its plain version. Returns the
    (route, vector, cluster) of each labelled layout."""
    cl = torch.channels_last
    rnd = lambda shape, dtype: (torch.randn(shape, generator=g, device="cuda") * 3).to(dtype)
    routes = {}

    def one(label, x):
        check_scale(torch, ik, label, x)
        pl = ik.scale_plan(tuple(x.shape), x.stride(), x.element_size(), x.data_ptr(),
                           ik._sm_count(x.device))
        routes[label] = (pl.route, pl.vec, pl.cluster)

    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "float32"
        for off in range(8):
            buf = rnd(3 * 12 * 7 * 9 + 8, dtype)
            one(f"{tag} span at element {off}",
                torch.as_strided(buf, (3, 12, 7, 9), (756, 1, 108, 12), off))
        one(f"{tag} stem, odd sample stride", rnd((5, 12, 37, 49), dtype).contiguous(
            memory_format=cl))
        for nbytes in (8, 4):
            lo = nbytes // torch.tensor([], dtype=dtype).element_size()
            one(f"{tag} slice {nbytes} bytes off", rnd((4, 24, 20, 24), dtype).contiguous(
                memory_format=cl)[:, lo:lo + 16])
        one(f"{tag} C = 12 of 24", rnd((3, 24, 21, 19), dtype).contiguous(
            memory_format=cl)[:, 12:])
        one(f"{tag} NCHW slice", rnd((2, 32, 20, 24), dtype)[:, 3:19])
        one(f"{tag} every other column", rnd((2, 16, 20, 24), dtype)[..., ::2])
        special = rnd((3, 16, 8, 8), dtype)
        special[0] = 0.0
        special[1, 3, 2, 2] = float("nan")
        special[2, 5, 1, 1] = float("-inf")
        one(f"{tag} zero, NaN and -inf samples", special)
    one("batch 1, 64 x 184 x 240", rnd((1, 64, 184, 240), torch.bfloat16).contiguous(
        memory_format=cl))
    xa = rnd((128, 64, 92, 120), torch.bfloat16).contiguous(memory_format=cl)
    xb = rnd((128, 64, 46, 60), torch.bfloat16).contiguous(memory_format=cl)[:, 32:]
    want = [ik.act_scale_per_sample_plain(xa), ik.act_scale_per_sample_plain(xb)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    for _ in range(10):
        got = []
        for st, x in zip(streams, (xa, xb)):
            with torch.cuda.stream(st):
                got.append(ik.act_scale_per_sample(x))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              "F on two streams at once differs from its plain version")
    log(f"  F alone on {len(routes)} layouts (route, vector, blocks per sample): "
        + "; ".join(f"{k} {v}" for k, v in routes.items())
        + "; two streams at once, 10 times: bit-equal")
    return routes


def check_int8_layers(torch, ik, pipe, frames, label) -> int:
    """Kernels E and F against their plain versions on the input of every
    quantized block of one forward of ``pipe``'s model (forward pre-hooks);
    returns the number of blocks."""
    from tti_torch.model.layers import Conv

    blocks = [(n, m) for n, m in pipe.model.named_modules() if isinstance(m, Conv) and m.qmode]

    def hook(name):
        def run(m, args):
            check_int8_call(torch, ik, f"{label} {name}", args[0], m.qpacked, m.qscale, m.bias,
                            m.k, m.s, m.p, m.ascale if m.qmode == "int8s" else None)
        return run

    handles = [m.register_forward_pre_hook(hook(n)) for n, m in blocks]
    try:
        with torch.inference_mode():
            pipe.model(pipe.preprocess(frames))
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return len(blocks)


def box_ious(box, boxes) -> np.ndarray:
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:], boxes[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    area = (box[2] - box[0]) * (box[3] - box[1]) + (boxes[:, 2] - boxes[:, 0]) * (
        boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(area - inter, 1e-9)


def int8_contract(got, ref) -> tuple[int, list]:
    """tti's detection contract, frame by frame: the float detections with
    score > 0.4, and those of them with no int8 detection of the same class
    at IoU > 0.9 (frame, class, score, best IoU of its class)."""
    n, lost = 0, []
    for b in range(ref.valid.shape[0]):
        keep = ref.valid[b] & (ref.scores[b] > INT8_SCORE)
        qb, qc = got.boxes_frame[b][got.valid[b]], got.classes[b][got.valid[b]]
        for box, cls, score in zip(ref.boxes_frame[b][keep], ref.classes[b][keep],
                                   ref.scores[b][keep]):
            n += 1
            same = qc == cls
            best = float(box_ious(box, qb[same]).max()) if same.any() else 0.0
            if best <= INT8_IOU:
                lost.append((b, int(cls), round(float(score), 4), round(best, 4)))
    return n, lost


def check_contract(got, ref, label) -> tuple[int, list]:
    """The contract on the configurations' frames (see INT8_IOU_FLOOR): the
    float detections and those below IoU 0.9, lowest IoU first."""
    n, lost = int8_contract(got, ref)
    check(n > 0, f"{label}: no float detection with score > {INT8_SCORE}")
    lost.sort(key=lambda d: d[3])
    worst = [d for d in lost if d[3] <= INT8_IOU_FLOOR]
    check(not worst, f"{label}: {len(worst)} of {n} float detections with score > "
          f"{INT8_SCORE} lack an int8 detection of their class at IoU > {INT8_IOU_FLOOR} "
          f"(frame, class, score, best IoU): {worst[:8]}")
    check(len(lost) <= INT8_BELOW_SHARE * n,
          f"{label}: {len(lost)} of {n} float detections with score > {INT8_SCORE} lack an "
          f"int8 detection of their class at IoU > {INT8_IOU} (limit {INT8_BELOW_SHARE:.0%}): "
          f"{lost[:8]}")
    return n, lost


def check_tti_scene(torch, quant) -> dict:
    """tests/test_quantize.py's own case on the card: the mm report's seed-7
    scene (960x1280), imgsz 640, the stride-4 checkpoint, float32, no
    undistortion; ``int8s`` calibrated on that frame by the plain-stem float
    model, as the test does. Every float detection with score > 0.4 keeps an
    int8 detection of its class at IoU > 0.9."""
    import measure_report_torch as mr

    from tti_torch.core.config import ModelConfig
    from tti_torch.model.checkpoint import load_flax_msgpack
    from tti_torch.model.quantize import calibrate_act_scales
    from tti_torch.parallel.runtime import InspectionPipeline, inference_model
    from tti_torch.preprocess.letterbox import letterbox_u8, make_letterbox_spec

    frame, _ = mr.make_measure_scene(mr.PlaneMapper(), np.random.default_rng(7))
    frames = frame[None]
    path = os.path.join(HERE, "checkpoints", "yolov8n_textile.msgpack")
    cfg = ModelConfig(variant="n", num_classes=2, image_size=640, dtype="float32")
    build = lambda **kw: InspectionPipeline(cfg, load_flax_msgpack(path), mr.FRAME_HW,
                                            undistort=False, device="cuda", **kw)
    ref = build().process_batch(frames)
    kw = {"quant": quant}
    if quant == "int8s":
        calib = inference_model(cfg, load_flax_msgpack(path), torch.device("cuda"),
                                s2d_input=False, s2d_stem=False)
        spec = make_letterbox_spec(*mr.FRAME_HW, 640, "square")
        x = letterbox_u8(torch.from_numpy(frames).cuda(), spec, torch.float32)
        scales = calibrate_act_scales(calib, [x])
        kw["quant_scales"] = os.path.join(INT8_DIR, "scales_tti_scene.json")
        with open(kw["quant_scales"], "w") as f:
            json.dump({"scales": scales}, f)
    n, lost = int8_contract(build(**kw).process_batch(frames), ref)
    check(n > 0 and not lost, f"tti's scene, {quant}: {len(lost)} of {n} float detections "
          f"with score > {INT8_SCORE} lack an int8 detection of their class at IoU > "
          f"{INT8_IOU}: {lost}")
    return {"detections": n, "lost": lost}


_REPORT: dict = {}


def report_scenes():
    """The first REPORT_SCENES seed-0 scenes of the mm report: frames and
    truth (edge, width, stitch count), rendered once."""
    import measure_report_torch as mr

    if not _REPORT:
        mapper = mr.PlaneMapper()
        rng = np.random.default_rng(0)
        scenes = [mr.make_measure_scene(mapper, rng) for _ in range(REPORT_SCENES)]
        _REPORT.update(frames=np.stack([f for f, _ in scenes]),
                       edge=np.array([t.frame_edge for _, t in scenes]),
                       width=np.array([t.frame_width for _, t in scenes]),
                       n=np.array([t.n_stitches for _, t in scenes]))
    return _REPORT


def report_gate(out, label) -> dict:
    """Phase 8's per-frame gate (tests/test_measure_report.py's): every
    width finite, stitches >= min(truth, 3), an edge on most frames, edge
    error < 1.0 mm, width error < 0.8 mm; the error summary."""
    truth = report_scenes()
    edge, width = out.raw_edge_mm.astype(float), out.raw_width_mm.astype(float)
    fin = np.isfinite(edge)
    check(np.isfinite(width).all(), f"{label}: a frame without a width: {width}")
    check((out.n_stitches >= np.minimum(truth["n"], 3)).all(),
          f"{label}: stitches {out.n_stitches.tolist()} against {truth['n'].tolist()}")
    check(fin.sum() > len(edge) / 2, f"{label}: the edge on a minority of frames")
    check((np.abs(edge[fin] - truth["edge"][fin]) < 1.0).all(), f"{label}: edge error >= 1 mm")
    check((np.abs(width - truth["width"]) < 0.8).all(), f"{label}: width error >= 0.8 mm")
    return {"edge": error_summary(edge, truth["edge"]),
            "width": error_summary(width, truth["width"])}


def int8_bound_ms(x, qpacked, k, stride, pad) -> tuple[float, str, dict]:
    """Kernel E's least time on this input: the bytes it must move (the
    input's elements read once, the int8 weights, scales and bias, the
    output written once) over 3.35 TB/s, against 2*M*N*K over the dense
    int8 rate."""
    b, c, h, w = x.shape
    co = qpacked.shape[0]
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    m, kk = b * ho * wo, k * k * c
    nbytes = x.numel() * x.element_size() + co * kk + 8 * co + m * co * x.element_size()
    ops = 2.0 * m * co * kk
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_INT8_OPS * 1e3
    info = {"bytes": nbytes, "ops": ops, "M": m, "N": co, "K": kk}
    return (t_bytes, "bytes", info) if t_bytes >= t_ops else (t_ops, "operations", info)


def capture_block_inputs(torch, pipe, frames) -> list:
    """(name, block, input) of every quantized block of one forward."""
    from tti_torch.model.layers import Conv

    seen = []
    handles = [m.register_forward_pre_hook(
        lambda m, args, n=n: seen.append((n, m, args[0])))
        for n, m in pipe.model.named_modules() if isinstance(m, Conv) and m.qmode]
    try:
        with torch.inference_mode():
            pipe.model(pipe.preprocess(frames))
    finally:
        for h in handles:
            h.remove()
    return seen


def time_int8_layers(torch, ik, pipe, frames, flush, n_largest=4) -> dict:
    """Kernel E per call on the ``n_largest`` blocks of one batch-128
    forward by bytes moved, and on the largest 1x1 block: CUDA events, L2
    flushed; beside it its bound, the plain version, cuDNN's bf16
    convolution of the same layer (weights and scales dequantized) and, for
    a 1x1 block, ``torch._int_mm`` on the same integer product. Kernel F on
    the largest block input: its time, bound and plain version."""
    import torch.nn.functional as F

    blocks = capture_block_inputs(torch, pipe, frames)
    size = lambda e: int8_bound_ms(e[2], e[1].qpacked, e[1].k, e[1].s, e[1].p)[2]["bytes"]
    ranked = sorted(blocks, key=size, reverse=True)
    chosen = ranked[:n_largest]
    one_by_one = [e for e in ranked if e[1].k == 1]
    if one_by_one and one_by_one[0] not in chosen:
        chosen.append(one_by_one[0])
    rows = []
    with torch.inference_mode():
        for name, m, x in chosen:
            xscale = ik.act_scale_per_sample(x) if m.qmode == "int8" else m.ascale
            args = (x, m.qpacked, m.qscale, m.bias, xscale, m.k, m.s, m.p)
            t = {"block": name, "shape": list(x.shape), "k": m.k, "stride": m.s,
                 "ms": time_ms(torch, lambda: ik.int8_conv2d(*args), flush=flush),
                 "plain_ms": time_ms(torch, lambda: ik.int8_conv2d_plain(*args), iters=3,
                                     flush=flush)}
            bound, bound_by, info = int8_bound_ms(x, m.qpacked, m.k, m.s, m.p)
            t.update(bound_ms=bound, bound_by=bound_by, **info)
            co, ci = m.qpacked.shape[0], x.shape[1]
            w = (m.qpacked[:, :info["K"]].reshape(co, m.k, m.k, ci).permute(0, 3, 1, 2).float()
                 * m.qscale.view(-1, 1, 1, 1)).to(x.dtype).contiguous(
                     memory_format=torch.channels_last)
            bias = m.bias.to(x.dtype)
            t["cudnn_bf16_ms"] = time_ms(torch, lambda: F.conv2d(x, w, bias, m.s, m.p),
                                         flush=flush)
            t["int_mm_ms"] = None
            if m.k == 1 and m.s == 1 and ci % 8 == 0 and co % 8 == 0:
                a = ik.quantize_act_plain(x, xscale).to(torch.int8).permute(0, 2, 3, 1).reshape(
                    -1, ci)
                bmat = m.qpacked[:, :ci].contiguous().t()  # (K, N), column-major
                try:
                    t["int_mm_ms"] = time_ms(torch, lambda: torch._int_mm(a, bmat),
                                             flush=flush)
                except RuntimeError as e:
                    t["int_mm_error"] = str(e)[:200]
                del a
            rows.append(t)
            log(f"  E on {name} {tuple(x.shape)} k{m.k} s{m.s} -> {co}: {t['ms']:.4f} ms "
                f"({t['ms'] / bound:.2f}x its bound {bound:.4f} ms, {bound_by}; "
                f"{info['bytes'] / 1e6:.1f} MB, {info['ops'] / 1e9:.1f} GOP), plain "
                f"{t['plain_ms']:.3f} ms, cuDNN bf16 conv {t['cudnn_bf16_ms']:.4f} ms"
                + (f", torch._int_mm {t['int_mm_ms']:.4f} ms" if t["int_mm_ms"] else "")
                + (f", torch._int_mm refused: {t['int_mm_error']}" if "int_mm_error" in t
                   else ""))
            del w
        name, m, x = ranked[0]
        fb = x.numel() * x.element_size() + 4 * x.shape[0]
        f = {"block": name, "shape": list(x.shape),
             "ms": time_ms(torch, lambda: ik.act_scale_per_sample(x), flush=flush),
             "plain_ms": time_ms(torch, lambda: ik.act_scale_per_sample_plain(x), flush=flush),
             "bound_ms": fb / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": fb,
             "absmax_norm_ms": time_ms(torch, lambda: torch.linalg.vector_norm(
                 x, float("inf"), dim=(1, 2, 3)), flush=flush)}
        log(f"  F on {name} {tuple(x.shape)}: {f['ms']:.4f} ms ({f['ms'] / f['bound_ms']:.2f}x "
            f"its bound {f['bound_ms']:.4f} ms, {fb / 1e6:.1f} MB), plain {f['plain_ms']:.4f} "
            f"ms, torch.linalg.vector_norm(inf) (the absmax alone) {f['absmax_norm_ms']:.4f} ms")
    # The kernels line's row: the largest 1x1 block, which torch._int_mm
    # can time beside it.
    row_block = (one_by_one or ranked)[0][0]
    del blocks, ranked, chosen, one_by_one
    torch.cuda.empty_cache()
    return {"layers": rows, "row": next(t for t in rows if t["block"] == row_block), "f": f}


def first_vec_width(x, c: int) -> int:
    """Elements per load in the first designs of kernels E and F (their
    wrappers'): 8, 4 or 1, as channels, strides and alignment allow."""
    if x.stride(1) != 1:
        return 1
    for v in (8, 4):
        if (c % v == 0 and x.data_ptr() % (v * x.element_size()) == 0
                and all(s % v == 0 for s in (x.stride(0), x.stride(2), x.stride(3)))):
            return v
    return 1


def _first_int8_route(x, c, k, stride, bn):
    """The first design's choice of route (its wrapper's): the halo
    route's bytes per window pixel, or 0 for the direct route."""
    load_bytes = first_vec_width(x, c) * x.element_size()
    cp = (c if c % 32 == 16 else c + 16) if stride == 1 else c + 8
    hh, hw = 7 * stride + k, 15 * stride + k
    smem = (hh * hw * cp + 15) // 16 * 16 + 2 * bn * 48
    return cp if c % 16 == 0 and load_bytes == 16 and smem <= 100 * 1024 else 0


def load_first_int8(torch, path):
    """Build kernel E's first design (its ``int8conv.cu``, from ``path``)
    into its own library and return ``call(x, qpacked, wscale, bias,
    xscale, k, stride, pad, act=True)``, which launches it as its own
    wrapper did (its C interface and route choice; not counted)."""
    import ctypes

    from tti_torch.kernels import build as kbuild
    from tti_torch.kernels import int8conv as ik

    out = kbuild.BUILD_DIR / "libtti_int8conv_first_design.so"
    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-o", str(out), path], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tti_int8_conv2d.argtypes = [p, ll, ll, ll, ll, i, i, i, i, p, i, i, i, i, i, p, p, p, i,
                                    p, i, i, i, i, i, i, i, p]
    lib.tti_int8_conv2d.restype = i

    def call(x, qpacked, wscale, bias, xscale, k, stride, pad, act=True):
        b, c, h, w = x.shape
        co, kp = qpacked.shape
        bn = next(n for n in (64, 32, 16) if co % n == 0)
        ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
        y = torch.empty((b, co, ho, wo), dtype=x.dtype, device=x.device,
                        memory_format=torch.channels_last)
        err = lib.tti_int8_conv2d(
            x.data_ptr(), *x.stride(), b, c, h, w, qpacked.data_ptr(), kp, co, k, stride, pad,
            wscale.data_ptr(), bias.data_ptr(), xscale.data_ptr(), int(xscale.dim() == 1),
            y.data_ptr(), ho, wo, int(act), int(x.dtype == torch.bfloat16),
            first_vec_width(x, c), bn, _first_int8_route(x, c, k, stride, bn),
            torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"first design of kernel E: cudaError {err}")
        return y

    return call


def load_first_scale(torch, path):
    """Build kernel F's first design (the ``int8conv.cu`` of commit b58ffc1,
    from ``path``) into its own library and return ``call(x)``, which
    launches it as its own wrapper did: a (splits, B) grid, a ticket per
    sample zeroed by a memset before the launch (not counted)."""
    import ctypes

    from tti_torch.kernels import build as kbuild

    out = kbuild.BUILD_DIR / "libtti_int8conv_first_scale.so"
    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-o", str(out), path], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tti_act_scale_per_sample.argtypes = [p, ll, ll, ll, ll, i, i, i, i, i, i, i, i, p, p, p]
    lib.tti_act_scale_per_sample.restype = i

    def call(x):
        b, c, h, w = x.shape
        vec = first_vec_width(x, c)
        cpp = c // vec
        fast = int(x.stride(2) == w * x.stride(3) and 256 % cpp == 0)
        splits = max(1, min(-(-2 * 132 // b), h * w * cpp // 1024))
        buf = torch.empty(b + b * splits + b, dtype=torch.float32, device=x.device)
        err = lib.tti_act_scale_per_sample(
            x.data_ptr(), *x.stride(), b, c, h, w, int(x.dtype == torch.bfloat16), vec, splits,
            fast, buf[:b].data_ptr(), buf[b:].data_ptr(), torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"first design of kernel F: cudaError {err}")
        return buf[:b]

    return call


def time_scale_inputs(torch, ik, blocks, flush, profiler_ms, first=None) -> dict:
    """Kernel F on every distinct input layout of one forward (``blocks``:
    (name, block, input)), CUDA events, L2 flushed: its route, time in two
    turns, its byte bound and ``torch.linalg.vector_norm(inf)``'s time (the
    absmax alone); with ``first``, F's first design on the same input, held
    equal to F and timed in turns (first, F, F, first). Prints the table and
    the sums over every input of the forward (each layout as often as the
    forward takes it) beside ``profiler_ms``, the profiler's F per step."""
    rows = {}
    with torch.inference_mode():
        for name, _, x in blocks:
            key = (tuple(x.shape), x.stride(), x.data_ptr() % 16, x.dtype)
            if key in rows:
                rows[key]["inputs"] += 1
                continue
            pl = ik.scale_plan(tuple(x.shape), x.stride(), x.element_size(), x.data_ptr(),
                               ik._sm_count(x.device))
            nbytes = x.numel() * x.element_size() + 4 * x.shape[0]
            t = {"block": name, "shape": list(x.shape), "strides": list(x.stride()), "inputs": 1,
                 "route": "span" if pl.route == ik.SCALE_SPAN else "grid", "vec": pl.vec,
                 "cluster": pl.cluster, "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                 "bound_by": "bytes"}
            f = lambda: ik.act_scale_per_sample(x)
            if first is not None:
                check(torch.equal(first(x), f()), f"{name}: F's first design disagrees with F")
                t["first_design_ms"] = [time_ms(torch, lambda: first(x), flush=flush)]
            t["ms"] = [time_ms(torch, f, flush=flush), time_ms(torch, f, flush=flush)]
            if first is not None:
                t["first_design_ms"].append(time_ms(torch, lambda: first(x), flush=flush))
            t["absmax_norm_ms"] = time_ms(torch, lambda: torch.linalg.vector_norm(
                x, float("inf"), dim=(1, 2, 3)), flush=flush)
            rows[key] = t
    rows = list(rows.values())
    mean = lambda v: sum(v) / len(v)
    sums = {k: sum(t["inputs"] * (mean(t[k]) if isinstance(t[k], list) else t[k]) for t in rows)
            for k in ("ms", "bound_ms", "absmax_norm_ms", "first_design_ms") if k in rows[0]}
    sums["inputs"] = sum(t["inputs"] for t in rows)
    log(f"  F on each of the {len(rows)} distinct inputs of one forward ({sums['inputs']} "
        f"inputs; ms in two turns, bound ms, x bound, vector_norm(inf) ms"
        + (", first design ms before and after" if first else "") + "):")
    for t in rows:
        log(f"    {t['block']:14s} x{t['inputs']} {str(tuple(t['shape'])):22s} {t['route']:4s} "
            f"v{t['vec']} cl{t['cluster']}: {t['ms'][0]:.4f} {t['ms'][1]:.4f} "
            f"{t['bound_ms']:.4f} {mean(t['ms']) / t['bound_ms']:5.2f}x "
            f"{t['absmax_norm_ms']:.4f}"
            + (" | {:.4f} {:.4f}".format(*t["first_design_ms"]) if first else ""))
    log(f"  F per step (sum over the {sums['inputs']} inputs): {sums['ms']:.4f} ms against its "
        f"bound {sums['bound_ms']:.4f} ms ({sums['ms'] / sums['bound_ms']:.2f}x), the "
        f"profiler's {profiler_ms:.4f} ms; "
        f"vector_norm(inf) {sums['absmax_norm_ms']:.4f} ms"
        + (f"; the first design {sums['first_design_ms']:.4f} ms" if first else ""))
    return {"inputs": rows, **{f"per_step_{k}": v for k, v in sums.items()}}


@contextlib.contextmanager
def bound_in_layers(name: str, call):
    """The model's ``Conv`` blocks call ``call`` in the place of kernel E
    (``name`` "int8_conv2d") or F ("act_scale_per_sample")."""
    import tti_torch.model.layers as layers

    saved = getattr(layers, name)
    setattr(layers, name, call)
    try:
        yield
    finally:
        setattr(layers, name, saved)


def time_int8_blocks(torch, ik, blocks, flush, first=None) -> dict:
    """Kernel E once on the input of every quantized block of one forward
    (CUDA events, L2 flushed; 10 calls each) beside the block's bound and,
    with ``first``, the first design on the same input, its output held equal
    to E's. Prints the table sorted by ms - bound_ms and the sums over the
    forward: E's time per step against its bound per step."""
    rows = []
    with torch.inference_mode():
        for name, m, x in blocks:
            xscale = ik.act_scale_per_sample(x) if m.qmode == "int8" else m.ascale
            args = (x, m.qpacked, m.qscale, m.bias, xscale, m.k, m.s, m.p)
            bound, bound_by, _ = int8_bound_ms(x, m.qpacked, m.k, m.s, m.p)
            t = {"block": name, "shape": list(x.shape), "k": m.k, "stride": m.s,
                 "co": m.qpacked.shape[0], "bound_ms": bound, "bound_by": bound_by,
                 "ms": time_ms(torch, lambda: ik.int8_conv2d(*args), iters=10, flush=flush)}
            if first is not None:
                check(torch.equal(first(*args), ik.int8_conv2d(*args)),
                      f"{name}: E's first design disagrees with the current one")
                t["first_design_ms"] = time_ms(torch, lambda: first(*args), iters=10,
                                               flush=flush)
            rows.append(t)
    rows.sort(key=lambda t: t["ms"] - t["bound_ms"], reverse=True)
    sums = {k: sum(t[k] for t in rows) for k in ("ms", "bound_ms", "first_design_ms")
            if k in rows[0]}
    log(f"  E on each of the {len(rows)} blocks of one forward, sorted by ms - bound ms "
        f"(ms, bound ms, x bound" + (", first design ms" if first else "") + "):")
    for t in rows:
        log(f"    {t['block']:16s} {str(tuple(t['shape'])):22s} k{t['k']} s{t['stride']} -> "
            f"{t['co']:3d}: {t['ms']:8.4f} {t['bound_ms']:8.4f} {t['ms'] / t['bound_ms']:6.2f}x"
            + (f" {t['first_design_ms']:8.4f}" if first else ""))
    log(f"  E per step (sum over the blocks): {sums['ms']:.4f} ms against its bound "
        f"{sums['bound_ms']:.4f} ms ({sums['ms'] / sums['bound_ms']:.2f}x)"
        + (f"; the first design {sums['first_design_ms']:.4f} ms" if first else ""))
    return {"blocks": rows, **{f"per_step_{k}": v for k, v in sums.items()}}


def start_calibration(ckpt, imgsz, out_path):
    """``tools/calibrate_int8_torch.py --synth 16`` for a checkpoint at the
    configuration's imgsz, in a subprocess started now: the process and its
    start time."""
    return subprocess.Popen(
        [sys.executable, os.path.join(HERE, "tools", "calibrate_int8_torch.py"), "--weights",
         os.path.join(HERE, "checkpoints", ckpt), "--synth", "16", "--imgsz", str(imgsz),
         "--out", out_path], env=dict(os.environ, PYTHONPATH=HERE), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), time.perf_counter()


def finish_calibration(config: str, proc, t0) -> float:
    """Wait for :func:`start_calibration` (exit 0); its wall seconds."""
    stdout, stderr = communicate(proc)
    wall = seconds_to_end(proc, t0)
    check(proc.returncode == 0, f"calibrate_int8_torch.py ({config}): exit "
          f"{proc.returncode}\n{stderr[-2000:]}")
    log(f"  {config}: {stdout.strip()}; {wall:.1f} s")
    return wall


INT8_DIR = os.path.join(HERE, "build", "int8_smoke")
INT8_SCALES = {c: os.path.join(INT8_DIR, f"scales_{c}.json") for c in CONFIGS}


def check_int8(torch, ms, wp, ik, flush, first_int8=None, first_scale=None) -> dict:
    """Phase 5c (see the module docstring). ``first_int8``: kernel E's
    first design (:func:`load_first_int8`), timed beside E; ``first_scale``:
    kernel F's (:func:`load_first_scale`), timed beside F."""
    from step_syncs_torch import count_step_syncs

    from tti_torch.kernels import conv_epilogue as ce

    t_phase = time.perf_counter()
    scales = INT8_SCALES  # written by phase 3b's calibrations
    out: dict = {"synthetic": check_int8_kernels(torch, ik)}
    for config, (hw, imgsz, ckpt) in CONFIGS.items():
        frames_np = textile(hw, BATCH)
        frames = torch.from_numpy(frames_np).cuda()
        one = frames[:1].contiguous()
        ref = build_pipeline(torch, hw, imgsz, ckpt)
        ref_out = ref.process_batch(frames_np)
        small = textile(hw, MODE_F32_BATCH)
        ref32 = build_pipeline(torch, hw, imgsz, ckpt, dtype="float32")
        ref32_out = ref32.process_batch(small)
        del ref32
        for quant in ("int8", "int8s"):
            label = f"{config} {quant}"
            t0 = time.perf_counter()
            pipe = build_pipeline(torch, hw, imgsz, ckpt, quant=quant,
                                  quant_scales=scales[config] if quant == "int8s" else None)
            setup_s = time.perf_counter() - t0
            reset_launch_counts(ms, wp)
            got = pipe.process_batch(frames_np)
            launches = launch_counts(ms, wp)
            launches_g, want_g = ce.LAUNCHES["bias_act"], biased_convs(pipe.model)
            check(launches_g == want_g, f"{label}: {launches_g} launches of kernel G, "
                  f"{want_g} expected (one per biased convolution)")
            stats_kernel = ("mask_stats_soft" if pipe.measure_cfg.subcell_edge
                            else "mask_stats_binary")
            want_f = INT8_BLOCKS if quant == "int8" else 0
            check(launches["int8_conv2d"] == INT8_BLOCKS
                  and launches["act_scale_per_sample"] == want_f
                  and launches[stats_kernel] == 1 and launches["greedy_keep"] == 1,
                  f"{label}: E {INT8_BLOCKS}, F {want_f}, D and {stats_kernel} once per step "
                  f"expected: {launches}")
            check_outputs(got, label, BATCH, pipe.model_cfg.max_detections)
            with plain_routes(ms, wp):
                plain = pipe.process_batch(frames_np)
            check(launch_counts(ms, wp) == launches, f"{label}: the plain step launched")
            syncs = {b: count_step_syncs(torch, pipe, f)[:2] for b, f in ((BATCH, frames),
                                                                          (1, one))}
            for b, (n, where) in syncs.items():
                check(n == 0, f"{label} batch {b}: {n} synchronising calls per step: {where}")
            for key in ("boxes_frame", "scores", "classes", "valid"):
                np.testing.assert_array_equal(getattr(got, key), getattr(plain, key),
                                              err_msg=f"{label}: {key} against the plain step")
            plain_mm, _ = mm_difference(got, plain)
            check(plain_mm <= 1e-2, f"{label}: mm differ from the plain step by {plain_mm}")
            n, lost = check_contract(got, ref_out, f"{label} against bf16")
            pipe32 = build_pipeline(torch, hw, imgsz, ckpt, dtype="float32", quant=quant,
                                    quant_scales=scales[config] if quant == "int8s" else None)
            n32, lost32 = check_contract(pipe32.process_batch(small), ref32_out,
                                         f"{label} float32 (batch {MODE_F32_BATCH})")
            del pipe32
            d = mm_differences(got, ref_out)
            # Every block's own input under int8, and under int8s at the
            # headline on the batch's 8 distinct frames (the deploy's int8s
            # blocks run the same code with their static scales; left out
            # for the phase's time).
            blocks = (check_int8_layers(torch, ik, pipe, frames, label) if quant == "int8"
                      else check_int8_layers(torch, ik, pipe, frames[:MODE_F32_BATCH], label)
                      if config == "headline" else 0)
            t = time_pair(torch, ref, pipe, frames, one)
            res = {**t, "launches": {**{k: launches[k] for k in (
                "int8_conv2d", "act_scale_per_sample", stats_kernel, "greedy_keep")},
                "bias_act": launches_g},
                "syncs": {b: n for b, (n, _) in syncs.items()}, "plain_mm_max": plain_mm,
                "contract_detections": n, "contract_below": lost,
                "contract_f32_detections": n32, "contract_f32_below": lost32,
                "mm_vs_bf16_median": float(np.median(d)),
                "mm_vs_bf16_max": float(d.max()), "blocks_checked": blocks, "setup_s": setup_s}
            if config == "deploy":
                import measure_report_torch as mr

                mpipe = mr.build_pipeline(CAM_CKPT, undistort=False, dtype="bfloat16",
                                          device="cuda", quant=quant,
                                          quant_scales=scales[config] if quant == "int8s"
                                          else None)
                reset_launch_counts(ms, wp)
                meas = mpipe.process_batch(report_scenes()["frames"]).measurements
                check(launch_counts(ms, wp)["int8_conv2d"] == INT8_BLOCKS,
                      f"{label}: the mm report's step did not run kernel E")
                res["report"] = report_gate(meas, f"{label} mm report")
                del mpipe
            if config == "deploy" and quant == "int8":
                parts, busy, _ = device_time(torch, lambda: pipe.step(frames), 2)
                res["device_ms_per_step"] = busy
                res["e_ms_per_step"] = sum(v for k, v in parts.items() if "int8_conv" in k)
                res["f_ms_per_step"] = sum(v for k, v in parts.items() if "act_absmax" in k)
                out["timing"] = time_int8_layers(torch, ik, pipe, frames, flush)
                block_inputs = capture_block_inputs(torch, pipe, frames)
                out["blocks"] = blk = time_int8_blocks(torch, ik, block_inputs, flush,
                                                       first_int8)
                out["scale"] = sc = time_scale_inputs(torch, ik, block_inputs, flush,
                                                      res["f_ms_per_step"], first_scale)
                del block_inputs
                res["e_bound_ms_per_step"] = blk["per_step_bound_ms"]
                res["f_bound_ms_per_step"] = sc["per_step_bound_ms"]
                if first_scale is not None:
                    # F per step from the profiler (and the memsets of the
                    # step): the first design bound in its place, then F.
                    def f_step():
                        parts = device_time(torch, lambda: pipe.step(frames), 2)[0]
                        return (sum(v for k, v in parts.items() if "act_absmax" in k),
                                sum(v for k, v in parts.items() if "memset" in k.lower()))
                    with bound_in_layers("act_scale_per_sample", first_scale):
                        (res["first_design_f_ms_per_step"],
                         res["first_design_memset_ms_per_step"]) = f_step()
                    res["f_ms_per_step_again"], res["memset_ms_per_step"] = f_step()
                    log(f"  {label}: F per step (profiler) {res['f_ms_per_step']:.3f} and "
                        f"{res['f_ms_per_step_again']:.3f} ms, the first design between them "
                        f"{res['first_design_f_ms_per_step']:.3f} ms (memsets per step "
                        f"{res['first_design_memset_ms_per_step']:.3f} ms with it, "
                        f"{res['memset_ms_per_step']:.3f} without)")
                if first_int8 is not None:
                    # E per step from the profiler: the first design bound in
                    # its place, then the current design again.
                    e_step = lambda: sum(v for k, v in device_time(
                        torch, lambda: pipe.step(frames), 2)[0].items() if "int8_conv" in k)
                    with bound_in_layers("int8_conv2d", first_int8):
                        res["first_design_e_ms_per_step"] = e_step()
                    res["e_ms_per_step_again"] = e_step()
                    log(f"  {label}: E per step (profiler) {res['e_ms_per_step']:.3f} and "
                        f"{res['e_ms_per_step_again']:.3f} ms, the first design between them "
                        f"{res['first_design_e_ms_per_step']:.3f} ms")
            elif quant == "int8":
                res["e_bound_ms_per_step"] = sum(
                    int8_bound_ms(x, m.qpacked, m.k, m.s, m.p)[0]
                    for _, m, x in capture_block_inputs(torch, pipe, frames))
            out[label] = res
            log(f"  {label}: {t['frames_per_s']:.1f} frames/s at batch {BATCH} against bf16 "
                f"{t['ref_frames_per_s']:.1f} ({t['frames_per_s'] / t['ref_frames_per_s'] - 1:+.1%}), "
                f"batch-1 p50 {t['p50_ms']:.3f} ms against {t['ref_p50_ms']:.3f} (in turns); "
                f"launches {res['launches']}; 0 syncs per step at batch {BATCH} and 1; equal to "
                f"the plain step (mm {plain_mm:.2g}); tti's contract, detections > "
                f"{INT8_SCORE} kept at IoU > {INT8_IOU}: float32 {n32 - len(lost32)} of {n32} "
                f"{lost32[:2]}, bf16 {n - len(lost)} of {n} {lost[:2]} (lowest first; all at "
                f"IoU > {INT8_IOU_FLOOR}, at most {INT8_BELOW_SHARE:.0%} below {INT8_IOU}); mm against bf16 median {res['mm_vs_bf16_median']:.4g} "
                f"max {res['mm_vs_bf16_max']:.4g}; "
                + (f"E and F held to the plain versions on all {blocks} blocks' inputs; "
                   if blocks else "")
                + f"set-up {setup_s:.1f} s"
                + (f"; E {res['e_ms_per_step']:.3f} and F {res['f_ms_per_step']:.3f} of "
                   f"{res['device_ms_per_step']:.3f} device ms per step"
                   if "e_ms_per_step" in res else "")
                + (f"; E's bound per step {res['e_bound_ms_per_step']:.3f} ms"
                   if "e_bound_ms_per_step" in res else "")
                + (f", F's {res['f_bound_ms_per_step']:.3f} ms"
                   if "f_bound_ms_per_step" in res else "")
                + ("; mm report (16 scenes): " + "; ".join(
                    f"{k} {v['coverage']} p50 {v['p50']:.4f} p95 {v['p95']:.4f}"
                    for k, v in res["report"].items()) if "report" in res else ""))
            del pipe
            torch.cuda.empty_cache()
        del ref, frames, one
        torch.cuda.empty_cache()
    for quant in ("int8", "int8s"):
        out[f"tti scene {quant}"] = r = check_tti_scene(torch, quant)
        log(f"  tti's own scene (tests/test_quantize.py: seed 7, 960x1280, imgsz 640, float32), "
            f"{quant}: {r['detections']} float detections > {INT8_SCORE}, every one kept at IoU "
            f"> {INT8_IOU}")
    torch.cuda.empty_cache()
    out["tally"] = dict(INT8_TALLY)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"int8 phase: {out['wall_s']:.1f} s; E and F against their plain versions in "
        f"{INT8_TALLY['calls']} calls: before SiLU bit-equal, SiLU within "
        f"{INT8_TALLY['max_ulp']} ulp (max |diff| {INT8_TALLY['max_abs_err']:.3g}); F in "
        f"{INT8_TALLY['f_calls']} calls, {INT8_TALLY['f_values']} scales, max |diff| "
        f"{INT8_TALLY['f_max_abs_err']:.3g}")
    return out


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


def live_tile_share(torch, w1, window) -> dict:
    """What kernel C reads of W1 through ``window``: per (y, 64 output
    columns) the union of the columns' windows, cut into chunks of 80 rows
    (the kernel's chunk at the headline; each chunk a TMA box of 80 rows x
    64 columns). Returns the share of W1's bytes those boxes hold and the
    share of W1 that is non-zero."""
    hs, ws, wo = w1.shape
    w = window.view(hs, -1, 2)
    lo, hi = w[..., 0], w[..., 1]
    live = lo < hi
    tiles = (wo + 63) // 64
    pad = tiles * 64 - wo
    lo = torch.nn.functional.pad(torch.where(live, lo, ws), (0, pad), value=ws)
    hi = torch.nn.functional.pad(torch.where(live, hi, 0), (0, pad), value=0)
    span = (hi.view(hs, tiles, 64).amax(2) - lo.view(hs, tiles, 64).amin(2)).clamp(min=0)
    boxes = (span + 79) // 80
    return {"live_tile_share": float((boxes * 80 * 64).sum()) / (hs * ws * wo),
            "nonzero_share": float((w1 != 0).float().mean())}


def time_warp_p1(torch, wp, pipe, frame_hw, flush, first=None) -> dict:
    """Kernel C at the headline step's shapes (batch 128 and 1): the kernel,
    its plain version, the unfused chain it replaces (letterbox_content ->
    subtract pad -> pass-1 einsum), its bounds (what these weights need, and
    W1 read whole), the share of W1 it reads, and pass 2 from either
    layout; with ``first``, the first design on the same inputs in turns
    (first, kernel, kernel, first)."""
    from tti_torch.preprocess.letterbox import letterbox_content

    warp, spec = pipe.warp, pipe.spec
    window = warp.pass1_window()
    kw = dict(k=3, off=1, hs=spec.new_h, ws=spec.new_w, pad_value=warp.pad_value)
    pad = torch.tensor(warp.pad_value, dtype=warp.w1.dtype)

    def unfused(f):
        content = letterbox_content(f, spec, torch.bfloat16, decimate=True)
        return torch.einsum("bywc,ywo->byoc", content.to(warp.w1.dtype) - pad, warp.w1)

    share = live_tile_share(torch, warp.w1, window)
    out = {}
    with torch.inference_mode():
        for batch in (BATCH, 1):
            frames = torch.from_numpy(textile(frame_hw, batch)).cuda()
            kernel = lambda: wp.warp_pass1_decimated(frames, warp.w1, window, **kw)
            if first is not None:
                old = lambda: first(frames, warp.w1, **kw)
                t = {"first_design_ms": [time_ms(torch, old, flush=flush)],
                     "ms": time_ms(torch, kernel, flush=flush)}
                t["ms_again"] = time_ms(torch, kernel, flush=flush)
                t["first_design_ms"].append(time_ms(torch, old, flush=flush))
            else:
                t = {"ms": time_ms(torch, kernel, flush=flush)}
            t["plain_ms"] = time_ms(torch, lambda: wp.warp_pass1_decimated_plain(
                frames, warp.w1, window, **kw), iters=5, flush=flush)
            t["unfused_ms"] = time_ms(torch, lambda: unfused(frames), flush=flush)
            i1_k = kernel()
            i1_e = unfused(frames)
            t["pass2_from_ycbo_ms"] = time_ms(
                torch, lambda: warp.apply_pass2_ycbo(i1_k, torch.bfloat16), flush=flush)
            t["pass2_from_byoc_ms"] = time_ms(torch, lambda: warp.apply_pass2(i1_e, torch.bfloat16), flush=flush)
            t["bound_ms"], t["bound_by"], info = kernel_bound_ms(
                torch, "warp_pass1_decimated", frames, warp.w1, window, kw, False)
            t["bound_dense_ms"], _, dense = kernel_bound_ms(
                torch, "warp_pass1_decimated", frames, warp.w1, window, kw, True)
            t.update(info, shape=list(frames.shape), dense_bytes=dense["bytes"], **share)
            out[batch] = t
            firsts = (f", first design {' and '.join(f'{v:.4f}' for v in t['first_design_ms'])} ms"
                      f" (before and after; the kernel again {t['ms_again']:.4f} ms)"
                      if first is not None else "")
            log(f"  warp_pass1_decimated on the headline step's frames {tuple(frames.shape)}, W1 "
                f"{tuple(warp.w1.shape)}: kernel {t['ms']:.4f} ms{firsts}, plain "
                f"{t['plain_ms']:.4f} ms, unfused chain {t['unfused_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {t['bytes'] / 1e6:.2f} MB, what these "
                f"weights need), {t['bound_dense_ms']:.4f} ms reading W1 whole "
                f"({t['dense_bytes'] / 1e6:.2f} MB); W1 boxes read {share['live_tile_share']:.2%} "
                f"of W1 (non-zero {share['nonzero_share']:.3%}); pass 2 from (y,c,b,o) "
                f"{t['pass2_from_ycbo_ms']:.4f} ms, from (b,y,o,c) {t['pass2_from_byoc_ms']:.4f} ms")
    return out


# ---------------------------------------------------------------------------
# Phase 5j: kernel G, the float convolutions' bias and SiLU
# ---------------------------------------------------------------------------

EPILOGUES = 76  # kernel G per deploy step: 66 Conv blocks, 9 exit convs, the deconv


def biased_convs(model) -> int:
    """Kernel G's launches per forward of ``model`` on the card: one per
    float convolution with a bias (a quantized ``Conv`` block has none, its
    bias and SiLU are kernel E's)."""
    from tti_torch.model.layers import Conv2d, ConvTranspose2d

    return sum(isinstance(m, (Conv2d, ConvTranspose2d)) and m.bias is not None
               for m in model.modules())


def epilogue_parent(y, b, act):
    """What the port ran before kernel G on a convolution's output ``y``:
    cuDNN's route adds the bias in place, then ``F.silu``."""
    import torch.nn.functional as F

    out = y.add_(b.view(1, -1, 1, 1))
    return F.silu(out) if act else out


def capture_epilogues(torch, pipe, frames) -> list:
    """(y, bias, act) of every kernel G call of one forward of ``pipe`` on
    ``frames`` (uint8, on the card)."""
    import tti_torch.model.layers as layers

    seen, real = [], layers.bias_act

    def record(y, b, act=True):
        seen.append((y, b, act))
        return real(y, b, act)

    layers.bias_act = record
    try:
        with torch.inference_mode():
            pipe.model(pipe.preprocess(frames))
    finally:
        layers.bias_act = real
    return seen


def check_epilogue(torch, ce, flush) -> dict:
    """Phase 5j: kernel G on the deploy step at batch 128. Its launches per
    step (:data:`EPILOGUES`); each of the forward's epilogues against the
    parent route (cuDNN's in-place bias add, then ``F.silu``) bit for bit,
    timed with CUDA events (L2 flushed) beside that route (``library_ms``),
    the plain version and its byte bound (the output read and written once,
    the biases read); the sums per step; kernel G's device ms in a profiled
    step."""
    t_phase = time.perf_counter()
    hw, imgsz, ckpt = CONFIGS["deploy"]
    pipe = build_pipeline(torch, hw, imgsz, ckpt)
    frames_np = textile(hw, BATCH)
    ce.reset_launch_counts()
    pipe.process_batch(frames_np)
    launches = ce.LAUNCHES["bias_act"]
    check(launches == EPILOGUES, f"deploy step: {launches} launches of kernel G, "
          f"{EPILOGUES} expected")
    frames = torch.from_numpy(frames_np).cuda()
    per_name, _, _ = device_time(torch, lambda: pipe.step(frames), 2)
    step_g_ms = sum(t for n, t in per_name.items() if "bias_act_pointwise" in n)
    seen = capture_epilogues(torch, pipe, frames)
    check(len(seen) == EPILOGUES, f"{len(seen)} epilogues in the deploy forward")
    del pipe, frames
    torch.cuda.empty_cache()
    rows, differ, compared = [], 0, 0
    with torch.inference_mode():
        for y, b, act in seen:
            got, want = ce.bias_act(y, b, act), epilogue_parent(y.clone(), b, act)
            differ += int((got.view(torch.int16) != want.view(torch.int16)).sum())
            compared += got.numel()
            del got, want
            scratch = y.clone()  # the parent route adds in place
            nbytes = 2 * y.numel() * y.element_size() + b.numel() * b.element_size()
            rows.append({
                "shape": list(y.shape), "act": act,
                "route": ce.plan(tuple(y.shape), not y.is_contiguous(), y.element_size(),
                                 y.data_ptr() % 16 == 0).route,
                "ms": time_ms(torch, lambda: ce.bias_act(y, b, act), flush=flush),
                "plain_ms": time_ms(torch, lambda: ce.bias_act_plain(y, b, act), iters=5,
                                    flush=flush),
                "library_ms": time_ms(torch, lambda: epilogue_parent(scratch, b, act),
                                      flush=flush),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes})
            del scratch
    del seen
    torch.cuda.empty_cache()
    check(differ == 0, f"kernel G differs from the parent route in {differ} of {compared} "
          "elements")
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"kernel G on the deploy step's {len(rows)} epilogues at batch {BATCH}: bit-equal to "
        f"the parent route on {compared} elements; {launches} launches per step")
    log(f"  per step (sums, L2 flushed): G {total['ms']:.3f} ms ({total['ms'] / total['bound_ms']:.2f}x "
        f"its bound {total['bound_ms']:.3f} ms), parent route (add_ + F.silu) "
        f"{total['library_ms']:.3f} ms, plain version {total['plain_ms']:.3f} ms; in a profiled "
        f"step {step_g_ms:.3f} ms")
    for r in sorted(rows, key=lambda r: -r["ms"])[:6]:
        log(f"  {tuple(r['shape'])} act={r['act']} route {r['route']}: {r['ms']:.4f} ms "
            f"({r['ms'] / r['bound_ms']:.2f}x its bound {r['bound_ms']:.4f}), parent route "
            f"{r['library_ms']:.4f}, plain {r['plain_ms']:.4f}")
    wall = time.perf_counter() - t_phase
    log(f"kernel G phase: {wall:.1f} s")
    return {"launches": launches, "rows": rows, "per_step": total, "step_profiled_ms": step_g_ms,
            "differing_elements": differ, "compared_elements": compared, "wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 5d: the frozen step (tti_torch.app.export)
# ---------------------------------------------------------------------------


FROZEN_DIR = os.path.join(HERE, "build", "frozen_smoke")
# label, configuration, pipeline arguments, platforms, and each kernel's
# launches per frozen call (every other kernel's: none); each at batch 1
# (deploy bf16 also at batch 128 until the script's time limit cut it).
FROZEN = (
    ("deploy bf16", "deploy", {}, ("cuda",), {"mask_stats_soft": 1, "greedy_keep": 1}),
    ("headline kernel route", "headline", dict(warp_pass1="kernel"), ("cuda", "cpu"),
     {"warp_pass1_decimated": 1, "mask_stats_binary": 1, "greedy_keep": 1}),
    ("deploy int8", "deploy", dict(quant="int8"), ("cuda",),
     {"int8_conv2d": 66, "act_scale_per_sample": 66, "mask_stats_soft": 1, "greedy_keep": 1}),
)
# tti's export test: detections equal, scores within 1e-6, frame boxes within
# 1e-5 px; the mm readings within 0.01 mm, NaN where the live step has NaN.
FROZEN_SCORE_ATOL, FROZEN_BOX_ATOL, FROZEN_MM_ATOL = 1e-6, 1e-5, 1e-2


def check_frozen_outputs(torch, got: dict, live: dict, label: str) -> dict:
    """A frozen step's outputs against the live step's, name by name."""
    check(list(got) == list(live), f"{label}: output names {list(got)} vs {list(live)}")
    for name, value in live.items():
        check(got[name].shape == value.shape and got[name].dtype == value.dtype,
              f"{label}: {name} is {got[name].dtype} {tuple(got[name].shape)}, live "
              f"{value.dtype} {tuple(value.shape)}")
    for name in ("dets/valid", "dets/classes"):
        check(torch.equal(got[name], live[name]), f"{label}: {name} differs from the live step")
    err = lambda name: float((got[name].float() - live[name].float()).abs().max())
    errs = {"scores": err("dets/scores"), "boxes_frame": err("boxes_frame"), "mm": 0.0}
    check(errs["scores"] <= FROZEN_SCORE_ATOL, f"{label}: scores differ by {errs['scores']}")
    check(errs["boxes_frame"] <= FROZEN_BOX_ATOL, f"{label}: boxes differ by {errs['boxes_frame']}")
    for name in (n for n in live if n.startswith("measurements/") and n.endswith("_mm")):
        a, r = got[name].float(), live[name].float()
        check(torch.equal(a.isnan(), r.isnan()), f"{label}: {name} NaN pattern differs")
        both = ~r.isnan()
        if both.any():
            errs["mm"] = max(errs["mm"], float((a[both] - r[both]).abs().max()))
    check(errs["mm"] <= FROZEN_MM_ATOL, f"{label}: mm differ by {errs['mm']}")
    errs["bit_equal_leaves"] = sum(
        torch.equal(torch.nan_to_num(got[n].float(), 1e30), torch.nan_to_num(v.float(), 1e30))
        for n, v in live.items())
    return errs


def time_turns(torch, fns: dict, x, iters: int) -> dict:
    """``fns`` ({"live": ..., "frozen": ...}) on ``x`` in turns (live, frozen,
    frozen, live), each after a warm call: the p50 of ``iters`` single calls
    a turn (a synchronise after each), both turns of each."""
    runs = {who: [] for who in fns}
    for who in ("live", "frozen", "frozen", "live"):
        fns[who](x)
        torch.cuda.synchronize()
        for _ in range(iters):
            t = time.perf_counter()
            fns[who](x)
            torch.cuda.synchronize()
            runs[who].append(1e3 * (time.perf_counter() - t))
    return {who: float(np.median(v)) for who, v in runs.items()}


@contextlib.contextmanager
def recording(seen: dict):
    """Record the arguments of every kernel call the step makes, by kernel."""
    import tti_torch.measure.pipeline as mp
    import tti_torch.model.layers as layers
    import tti_torch.parallel.runtime as rt
    import tti_torch.postprocess.nms as nms

    sites = ((mp, "mask_stats_soft"), (mp, "mask_stats_binary"), (rt, "warp_pass1_decimated"),
             (nms, "greedy_keep"), (layers, "int8_conv2d"), (layers, "act_scale_per_sample"))
    saved = [getattr(m, a) for m, a in sites]

    def recorder(name, fn):
        def call(*args, **kwargs):
            seen.setdefault(name, []).append((args, kwargs))
            return fn(*args, **kwargs)
        return call

    for (m, a), fn in zip(sites, saved):
        setattr(m, a, recorder(a, fn))
    try:
        yield
    finally:
        for (m, a), fn in zip(sites, saved):
            setattr(m, a, fn)


def kernel_calls(ms, wp, nk, ik, name, args, kwargs) -> dict:
    """One recorded kernel call three ways: the wrapper the step calls, the
    operator alone, the bare ctypes launch."""
    if name.startswith("mask_stats"):
        soft = name == "mask_stats_soft"
        dt = kwargs["logits_dtype"]
        return {"wrapper": lambda: getattr(ms, name)(*args, **kwargs),
                "operator": lambda: ms._OPS[soft](*args, dt),
                "bare": lambda: ms._launch(soft, *args, dt)}
    if name == "warp_pass1_decimated":
        kw = [kwargs[k] for k in ("k", "off", "hs", "ws")]
        pad = float(kwargs["pad_value"])
        return {"wrapper": lambda: wp.warp_pass1_decimated(*args, **kwargs),
                "operator": lambda: wp._OP(*args, *kw, pad, True),
                "bare": lambda: wp._launch(*args, *kw, pad, True)}
    if name == "greedy_keep":
        b, c, o, thr, aware = args
        return {"wrapper": lambda: nk.greedy_keep(*args),
                "operator": lambda: nk._OP(b, c, o, float(thr), bool(aware)),
                "bare": lambda: nk._launch(*args)}
    if name == "int8_conv2d":
        x, qw, ws, bias, xs, k, s, p, act = args
        return {"wrapper": lambda: ik.int8_conv2d(*args),
                "operator": lambda: ik._CONV_OP(x, qw, ws, bias, xs, int(k), int(s), int(p),
                                                bool(act)),
                "bare": lambda: ik._launch_conv(*args)}
    return {"wrapper": lambda: ik.act_scale_per_sample(*args),
            "operator": lambda: ik._SCALE_OP(*args), "bare": lambda: ik._launch_scale(*args)}


def host_us_per_call(torch, calls: list[dict], n: int = 240, rounds: int = 5) -> dict:
    """Host microseconds per call, each way, over the step's own calls of one
    kernel repeated to ``n`` calls (no synchronise inside, so the host's
    clock times the host): the median of ``rounds`` rounds, ways in turns."""
    reps = -(-n // len(calls))
    out = {way: [] for way in calls[0]}
    for r in range(rounds):
        ways = list(out)[r % 3:] + list(out)[:r % 3]
        for way in ways:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(reps):
                for c in calls:
                    c[way]()
            out[way].append(1e6 * (time.perf_counter() - t) / (reps * len(calls)))
            torch.cuda.synchronize()
    return {way: float(np.median(v)) for way, v in out.items()}


def check_frozen(torch, ms, wp, ik) -> dict:
    """Export each configuration of :data:`FROZEN` on the card, save it under
    ``build/frozen_smoke``, load it from the file, run it against the live
    step (outputs, launches per call, synchronising calls, timings in
    turns) and delete it; then each kernel's host microseconds per call,
    operator against bare launch, on the batch-1 steps' own calls."""
    from types import SimpleNamespace

    from step_syncs_torch import count_step_syncs

    from tti_torch.app.export import SUFFIX, FrozenPipeline, export_pipeline, flatten_outputs
    from tti_torch.kernels import nms as nk

    t_phase = time.perf_counter()
    os.makedirs(FROZEN_DIR, exist_ok=True)
    out, recorded = {}, {}
    for label, config, kw, platforms, want in FROZEN:
        frame_hw, imgsz, ckpt = CONFIGS[config]
        pipe = build_pipeline(torch, frame_hw, imgsz, ckpt, **kw)
        x = torch.from_numpy(textile(frame_hw, 1)).cuda()
        tag = f"{label} batch 1"
        path = os.path.join(FROZEN_DIR, f"{config}_1{SUFFIX}")
        t0 = time.perf_counter()
        export_pipeline(pipe, 1, platforms=platforms, out=path)
        t1 = time.perf_counter()
        frozen = FrozenPipeline(path, device="cuda")
        t2 = time.perf_counter()
        size = os.path.getsize(path)
        check(frozen.manifest["platforms"] == list(platforms),
              f"{tag}: the manifest lists {frozen.manifest['platforms']}")
        cpu = None
        if "cpu" in platforms:
            host = FrozenPipeline(path, device="cpu")
            tc = time.perf_counter()
            got_cpu = host(x.cpu())
            cpu = {"run_s": time.perf_counter() - tc,
                   "detections": got_cpu["dets/valid"].sum(1).tolist()}
            check(list(got_cpu) == frozen.manifest["outputs"], f"{tag}: CPU program's names")
            del host
        os.remove(path)
        with torch.inference_mode():
            live = dict(zip(*flatten_outputs(pipe.step(x))))
        reset_launch_counts(ms, wp)
        got = frozen(x)
        launches = launch_counts(ms, wp)
        expected = {k: want.get(k, 0) for k in launches}
        check(launches == expected, f"{tag}: launches per frozen call {launches}, "
              f"expected {expected}")
        errs = check_frozen_outputs(torch, got, live, tag)
        n_sync, where, _ = count_step_syncs(torch, SimpleNamespace(step=frozen), x)
        check(n_sync == 0, f"{tag}: {n_sync} synchronising calls per frozen step: {where}")
        # 15 calls a turn (once 30: the script's time limit)
        timing = time_turns(torch, {"live": pipe.step, "frozen": frozen}, x, 15)
        shown = f"batch-1 p50 frozen {timing['frozen']:.3f} ms, live {timing['live']:.3f} ms"
        out[tag] = {"export_s": t1 - t0, "load_s": t2 - t1, "bytes": size,
                    "platforms": list(platforms), "launches": {k: v for k, v in
                                                               launches.items() if v},
                    "syncs": n_sync, "errors": errs, "timing": timing,
                    **({"cpu_program": cpu} if cpu else {})}
        log(f"frozen {tag}: export + save {t1 - t0:.1f} s, load {t2 - t1:.1f} s, "
            f"{size} bytes ({'+'.join(platforms)}); launches per call "
            f"{out[tag]['launches']}; 0 synchronising calls; |frozen - live| scores "
            f"{errs['scores']:.3g}, boxes {errs['boxes_frame']:.3g} px, mm {errs['mm']:.3g}, "
            f"{errs['bit_equal_leaves']} of {len(live)} leaves bit-equal; {shown}"
            + (f"; CPU program {cpu['run_s']:.1f} s, detections {cpu['detections']}"
               if cpu else ""))
        del frozen, got, live
        torch.cuda.empty_cache()
        seen: dict = {}
        with recording(seen), torch.inference_mode():
            pipe.step(x)
        for name, calls in seen.items():
            recorded.setdefault(name, [kernel_calls(ms, wp, nk, ik, name, a, k)
                                       for a, k in calls])
        del pipe, x
        torch.cuda.empty_cache()
    out["host_us_per_call"] = {}
    for name, calls in recorded.items():
        us = host_us_per_call(torch, calls)
        out["host_us_per_call"][name] = dict(us, calls_per_step=len(calls))
        log(f"  {name}: host us per call, bare launch {us['bare']:.1f}, operator "
            f"{us['operator']:.1f} (+{us['operator'] - us['bare']:.1f}), wrapper "
            f"{us['wrapper']:.1f} (+{us['wrapper'] - us['bare']:.1f}); {len(calls)} per "
            "batch-1 step")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"frozen step phase: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 5e: data-parallel (tti_torch.parallel.mesh and dcn)
# ---------------------------------------------------------------------------

# The mesh steps, each against the same step without a mesh on the same
# frames: (configuration, pipeline arguments, batch, kernel launches per
# step, which must be the one-card step's).
MESH_STEPS = {
    "deploy": ("deploy", {}, BATCH, {"mask_stats_soft": 1, "greedy_keep": 1}),
    "headline_kernel_route": ("headline", {"warp_pass1": "kernel"}, 8,
                              {"warp_pass1_decimated": 1, "mask_stats_binary": 1,
                               "greedy_keep": 1}),
    "deploy_int8": ("deploy", {"quant": "int8"}, 8,
                    {"int8_conv2d": 66, "act_scale_per_sample": 66, "mask_stats_soft": 1,
                     "greedy_keep": 1}),
}
GLOO_BATCH = 8
DP_DIR = os.path.join(HERE, "build", "dp_smoke")


def same_tree(torch, got, ref, label) -> int:
    """Every tensor of two output trees equal (NaN where NaN); the leaf count."""
    from tti_torch.parallel.mesh import tree_leaves

    a, b = tree_leaves(got), tree_leaves(ref)
    check(len(a) == len(b), f"{label}: {len(a)} outputs against {len(b)}")
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True, msg=label)
    return len(a)


def check_mesh_step(torch, ms, wp, mesh, tag) -> dict:
    """One configuration on the one-card mesh: its outputs equal the step's
    without a mesh, bit for bit, and it launches the kernels the one-card
    step launches. The deploy step is also checked for synchronising calls
    at batch 128 and 1 and timed in turns with the plain step."""
    config, kw, batch, want = MESH_STEPS[tag]
    hw, imgsz, ckpt = CONFIGS[config]
    plain = build_pipeline(torch, hw, imgsz, ckpt, **kw)
    sharded = build_pipeline(torch, hw, imgsz, ckpt, mesh=mesh, **kw)
    host = textile(hw, batch)
    frames = torch.from_numpy(host).cuda()
    ref = plain.step(frames)
    reset_launch_counts(ms, wp)
    got = sharded.step(frames)
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts(ms, wp).items() if v}
    check(launches == want, f"mesh {tag}: launches per step {launches}, the one-card step's {want}")
    n = same_tree(torch, got, ref, f"mesh {tag} step")
    same_tree(torch, sharded.process_batch_async(host), ref, f"mesh {tag} process_batch_async")
    out = {"launches": launches, "outputs": n, "batch": batch}
    line = (f"mesh {tag} step ({hw[0]}x{hw[1]}, imgsz {imgsz}, {kw or 'bf16'}) at batch {batch}: "
            f"{n} outputs equal to the plain step's (step and process_batch_async); launches per "
            f"step {launches}")
    if tag == "deploy":
        one = frames[:1].contiguous()
        out["syncs"] = {b: check_step_syncs(torch, sharded, f"mesh {tag}", f)["syncs"]
                        for b, f in ((batch, frames), (1, one))}
        out["turns"] = time_pair(torch, plain, sharded, frames, one, steps=5, p50_iters=10)
        out["gather_ms"] = {b: gather_ms(torch, mesh, plain.step(f))
                            for b, f in ((batch, frames), (1, one))}
        t = out["turns"]
        line += (f"; in turns with the plain step (plain, mesh, mesh, plain): mesh "
                 f"{t['frames_per_s']:.1f} frames/s, plain {t['ref_frames_per_s']:.1f} "
                 f"({100 * (t['frames_per_s'] / t['ref_frames_per_s'] - 1):+.2f}%); batch-1 p50 "
                 f"mesh {t['p50_ms']:.3f} ms, plain {t['ref_p50_ms']:.3f}; the all-gather of one "
                 f"step's outputs alone (host clock to a synchronise, median of 20): batch "
                 f"{batch} {out['gather_ms'][batch]:.3f} ms, batch 1 {out['gather_ms'][1]:.3f} ms")
    log(line)
    return out


def gather_ms(torch, mesh, outs, iters=20) -> float:
    """Median ms of ``gather_batch`` on one step's outputs, host clock to a
    synchronise."""
    from tti_torch.parallel.mesh import gather_batch

    lats = []
    for _ in range(iters + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        gather_batch(mesh, outs)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t)
    return 1e3 * float(np.median(lats[1:]))


def check_mesh_dual(torch, ms, wp, mesh) -> dict:
    """The headline dual step on the mesh against the dual step without one."""
    from tti_torch.parallel.runtime import DualPipeline

    hw, imgsz, ckpt = CONFIGS["headline"]
    duals = {tag: DualPipeline(build_pipeline(torch, hw, imgsz, ckpt, mesh=m),
                               build_pipeline(torch, hw, imgsz, "yolov8n_textile_960.msgpack",
                                              mesh=m))
             for tag, m in (("plain", None), ("mesh", mesh))}
    frames = torch.from_numpy(textile(hw, BATCH)).cuda()
    ref = duals["plain"].step(frames)
    reset_launch_counts(ms, wp)
    got = duals["mesh"].step(frames)
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts(ms, wp).items() if v}
    check(launches == {"mask_stats_binary": 2, "greedy_keep": 2},
          f"mesh dual step: launches per step {launches}")
    n = same_tree(torch, got, ref, "mesh dual step")
    log(f"mesh dual step (headline, yolov8n_textile_960 beside it) at batch {BATCH}: {n} outputs "
        f"equal to the plain dual step's; launches per step {launches}")
    return {"launches": launches, "outputs": n}


def param_bar(a, b, lr) -> tuple[float, float]:
    """The largest |a - b| over the parameters, in learning rates, and the
    share of parameters apart by more than 1e-4."""
    d = np.concatenate([np.abs(x.detach().float().cpu().numpy() - y.detach().float().cpu().numpy())
                        .ravel() for x, y in zip(a.parameters(), b.parameters())])
    return float(d.max() / lr), float((d > 1e-4).mean())


@contextlib.contextmanager
def count_collectives():
    """Counts ``torch.distributed``'s all-reduce and all-gather calls (the
    names the port calls) while the block runs; yields the counts."""
    import torch.distributed as dist

    seen = {"all_reduce": 0, "all_gather": 0}
    saved = {k: getattr(dist, k) for k in seen}

    def wrap(name):
        def call(*args, **kwargs):
            seen[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for k in seen:
        setattr(dist, k, wrap(k))
    try:
        yield seen
    finally:
        for k, fn in saved.items():
            setattr(dist, k, fn)


def nccl_device_ms(prof) -> tuple[float, int, dict]:
    """Device ms of the NCCL kernels in a profile and how many ran; and, by
    name, the count and device ms (what ran inside) of every event whose
    name holds "nccl" (c10d's ``nccl:<collective>`` ranges included)."""
    ms, n, seen = 0.0, 0, {}
    for e in prof.key_averages():
        if "nccl" not in e.key.lower():
            continue
        self_t = getattr(e, "self_device_time_total", None)
        self_t = getattr(e, "self_cuda_time_total", 0.0) if self_t is None else self_t
        total = getattr(e, "device_time_total", None)
        total = getattr(e, "cuda_time_total", 0.0) if total is None else total
        seen[e.key] = (e.count, total / 1e3)
        if self_t and not e.key.startswith("nccl:"):
            ms += self_t / 1e3
            n += e.count
    return ms, n, seen


def synced_pair(torch, data, mesh, dtype, lr):
    """The r5s trainer twice: plain, and data-parallel on the one-rank
    ``mesh`` with BatchNorm's global-batch statistics forced on (a one-rank
    group leaves them to ``F.batch_norm``)."""
    plain = recipe_trainer(torch, data, R5S, dtype, CAM_CKPT, None, lr)
    synced = recipe_trainer(torch, data, R5S, dtype, CAM_CKPT, None, lr, mesh=mesh)
    check(synced.step_fn.group is not None and synced.step_fn.bn_group is None,
          "a one-rank mesh must leave BatchNorm to F.batch_norm")
    synced.step_fn.bn_group = mesh.get_group("data")
    return plain, synced


def check_mesh_training(torch, mesh) -> dict:
    """r5s at full width, the synced ``TrainStep`` (the gradient all-reduce,
    and BatchNorm's global-batch statistics) against the plain step at a
    constant lr 1e-3. In bf16, 3 steps: the first step's loss terms (the
    same parameters) within phase 6's bf16 bars; the later steps' and the
    parameters' differences printed (a bf16 BatchNorm output rounds the
    other way wherever the two formulas' statistics differ in the last
    bits, and Adam's first update turns any gradient's sign flip into 2
    lr). In float32, one step to ``__graft_entry__.py``'s bar: the loss
    within 1e-3 relative, the update within 2.2 lr, under 0.5% of the
    parameters apart by more than 1e-4. Then bf16 ms per step in turns, and
    the collectives of one synced step, counted and timed on the card."""
    lr = 1e-3
    data = train_dataset(torch, R5S, seed=101)
    plain, synced = synced_pair(torch, data, mesh, torch.float32, lr)
    a = finite_losses(plain.train_step(1), "r5s float32 plain step")
    b = finite_losses(synced.train_step(1), "r5s float32 synced step")
    f32_rel = {k: abs(b[k] - a[k]) / abs(a[k]) for k in LOSS_KEYS}
    f32_bar = param_bar(synced.state.model, plain.state.model, lr)
    check(f32_rel["total"] <= 1e-3, f"r5s float32 synced against plain, loss: {f32_rel}")
    check(f32_bar[0] <= 2.2 and f32_bar[1] < 5e-3,
          f"r5s float32 synced against plain, the update: {f32_bar} (2.2 lr, 0.5%)")
    del plain, synced
    plain, synced = synced_pair(torch, data, mesh, torch.bfloat16, lr)
    rels, bars = [], []
    for i in (1, 2, 3):
        a = finite_losses(plain.train_step(i), f"r5s plain step {i}")
        b = finite_losses(synced.train_step(i), f"r5s synced step {i}")
        rels.append({k: abs(b[k] - a[k]) / abs(a[k]) for k in LOSS_KEYS})
        bars.append(param_bar(synced.state.model, plain.state.model, lr))
    check(rels[0]["total"] <= BF16_TOTAL_LIMIT and max(rels[0].values()) <= BF16_TERM_LIMIT,
          f"r5s bf16 synced against plain, first-step loss terms: {rels[0]}")

    # In turns: plain; the gradient and loss all-reduces alone (BatchNorm
    # per rank, as a one-rank group runs); both with the global-batch
    # BatchNorm.
    grads_only = recipe_trainer(torch, data, R5S, torch.bfloat16, CAM_CKPT, None, lr, mesh=mesh)
    runs = {"plain": [], "grads_only": [], "synced": []}
    step = 4
    for who, tr in (("plain", plain), ("grads_only", grads_only), ("synced", synced),
                    ("synced", synced), ("grads_only", grads_only), ("plain", plain)):
        tr.train_step(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step += 1
            tr.train_step(step)
        torch.cuda.synchronize()
        runs[who].append((time.perf_counter() - t0) / 5 * 1e3)
    ms_per_step = {k: float(np.mean(v)) for k, v in runs.items()}
    del grads_only

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with count_collectives() as calls, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        synced.train_step(step + 1)
        torch.cuda.synchronize()
    nccl_ms, nccl_kernels, nccl_events = nccl_device_ms(prof)
    traces = {}
    for who, tr in (("plain", plain), ("synced", synced)):
        step += 2
        per_name, busy, kernels = device_time(torch, lambda: tr.train_step(step), 2)
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
        traces[who] = {"busy_ms": busy, "kernels_per_step": kernels,
                       "top": [(k[:60], v) for k, v in top]}
    n_bn = sum(1 for m in synced.state.model.modules() if type(m).__name__ == "BatchNorm")
    log(f"r5s synced TrainStep (NCCL, one rank; BatchNorm's global-batch statistics forced on) "
        f"against the plain step: float32, one step: loss terms' relative difference "
        + ", ".join(f"{k} {v:.3g}" for k, v in f32_rel.items())
        + f", the update's max |diff| {f32_bar[0]:.3g} lr, share > 1e-4 {f32_bar[1]:.3g}; "
        f"bf16, by step: " + "; ".join(", ".join(f"{k} {v:.3g}" for k, v in rel.items())
                                        for rel in rels)
        + "; parameters after each bf16 step, max |diff| in lr and share > 1e-4: "
        + ", ".join(f"({m:.3g}, {s:.3g})" for m, s in bars))
    log(f"r5s ms per step in turns (plain, grads_only, synced, synced, grads_only, plain; 5 "
        f"steps each): plain {ms_per_step['plain']:.2f}, the gradient and loss all-reduces "
        f"alone {ms_per_step['grads_only']:.2f} "
        f"({ms_per_step['grads_only'] - ms_per_step['plain']:+.2f} ms), with the global-batch "
        f"BatchNorm {ms_per_step['synced']:.2f} "
        f"({ms_per_step['synced'] - ms_per_step['plain']:+.2f} ms); per synced step "
        f"{calls['all_reduce']} all-reduces ({n_bn} BatchNorm layers, forward and backward, the "
        f"gradient bucket, the loss terms), NCCL kernels {nccl_kernels}, "
        + (f"{nccl_ms:.3f} device ms" if nccl_kernels else "device ms not measured "
           "(no NCCL kernel in the profile)")
        + f"; events named nccl (count, device ms inside): {nccl_events}")
    for who, t in traces.items():
        log(f"r5s {who} step under the profiler (2 steps): device busy "
            + (f"{t['busy_ms']:.2f} ms" if t["busy_ms"] is not None else "not measured")
            + f" per step, {t['kernels_per_step']} kernels per step; the largest: "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in t["top"]))
    del plain, synced, data
    torch.cuda.empty_cache()
    return {"f32_loss_rel_diff": f32_rel, "f32_param_bar": f32_bar, "bf16_loss_rel_diff": rels,
            "bf16_param_bars": bars, "ms_per_step": ms_per_step,
            "runs_ms": runs, "all_reduces_per_step": calls["all_reduce"],
            "batchnorm_layers": n_bn, "nccl_kernels_per_step": nccl_kernels,
            "nccl_device_ms_per_step": nccl_ms if nccl_kernels else None,
            "nccl_events": nccl_events, "traces": traces}


def gloo_rank_main(torch, rank: int, coordinator: str, out_dir: str) -> int:
    """One of two gloo ranks sharing the card (``--gloo-rank``): the deploy
    step in float32 at batch GLOO_BATCH on a two-rank mesh; writes its
    outputs."""
    import torch.distributed as dist

    from torch_dist import outputs_to_arrays
    from tti_torch.parallel.mesh import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}", world_size=2, rank=rank)
    try:
        torch.cuda.set_device(0)
        hw, imgsz, ckpt = CONFIGS["deploy"]
        pipe = build_pipeline(torch, hw, imgsz, ckpt, dtype="float32",
                              mesh=create_mesh(device_type="cuda"))
        out = pipe.process_batch(textile(hw, GLOO_BATCH))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **outputs_to_arrays(out, "mesh"))
    finally:
        dist.destroy_process_group()
    return 0


def gloo_rank_argv(rank: int, coordinator: str, out_dir: str) -> list[str]:
    return [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--gloo-rank", str(rank),
            "--gloo-coordinator", coordinator, "--gloo-out", out_dir]


def start_gloo_pair() -> tuple:
    """Start the two gloo ranks of :func:`finish_gloo_pair` (``--gloo-rank``
    processes sharing the card): the processes and their start time."""
    from tti_torch.parallel.dcn import free_local_coordinator

    out_dir = os.path.join(DP_DIR, "gloo")
    os.makedirs(out_dir, exist_ok=True)
    coord = free_local_coordinator()
    return [subprocess.Popen(gloo_rank_argv(r, coord, out_dir), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(2)], \
        time.perf_counter()


def finish_gloo_pair(torch, started) -> dict:
    """Two gloo ranks on the one card (:func:`start_gloo_pair`) ran the
    deploy step in float32 (TF32 off) at batch GLOO_BATCH, half of it each:
    against the float32 step without a mesh on the whole batch,
    ``__graft_entry__.py``'s bar (valid equal, scores 1e-5, boxes 1e-3 px,
    mm 1e-4: the card's convolutions at batch 4 and 8 sum in other orders);
    against that step on each rank's rows, bit for bit; the two ranks'
    outputs equal."""
    from torch_dist import arrays_to_outputs, outputs_to_arrays

    procs, t0 = started
    outs = [communicate(p)[0] for p in procs]
    wall = max(seconds_to_end(p, t0) for p in procs)
    for r, (p, text) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"gloo rank {r} exited {p.returncode}:\n{text[-3000:]}")
    hw, imgsz, ckpt = CONFIGS["deploy"]
    plain = build_pipeline(torch, hw, imgsz, ckpt, dtype="float32")
    frames = textile(hw, GLOO_BATCH)
    ref = plain.process_batch(frames)
    half = GLOO_BATCH // 2
    rows = [outputs_to_arrays(plain.process_batch(frames[r * half:(r + 1) * half]), "mesh")
            for r in range(2)]
    del plain
    torch.cuda.empty_cache()
    out_dir = os.path.join(DP_DIR, "gloo")
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(2)]
    for k, v in ranks[0].items():
        np.testing.assert_array_equal(v, ranks[1][k], err_msg=k)
    for k, v in ranks[0].items():  # each rank's rows: the plain step on those rows
        np.testing.assert_array_equal(np.concatenate([rows[0][k], rows[1][k]]), v, err_msg=k)
    got = arrays_to_outputs(ranks[0], "mesh")
    np.testing.assert_array_equal(got.valid, ref.valid)
    np.testing.assert_allclose(got.scores, ref.scores, atol=1e-5)
    np.testing.assert_allclose(got.boxes_frame, ref.boxes_frame, atol=1e-3)
    worst = {}
    for key in ("edge_distance_mm", "stitch_width_mm", "raw_edge_mm", "raw_width_mm"):
        a, b = getattr(got.measurements, key), getattr(ref.measurements, key)
        np.testing.assert_allclose(a, b, atol=1e-4, equal_nan=True, err_msg=key)
        both = np.isfinite(a) & np.isfinite(b)
        worst[key] = float(np.abs(a[both] - b[both]).max()) if both.any() else 0.0
    score = float(np.abs(got.scores - ref.scores).max())
    box = float(np.abs(got.boxes_frame - ref.boxes_frame).max())
    log(f"  two gloo ranks sharing the card, deploy step in float32 at batch {GLOO_BATCH} ({half} "
        f"frames each, CUDA tensors through gloo's all-gather): equal to the plain step on each "
        f"rank's rows; against it on the whole batch valid equal, max |diff| scores {score:.3g}, "
        f"boxes {box:.3g} px, mm {max(worst.values()):.3g}; the ranks ended {wall:.1f} s after "
        "their start")
    return {"max_score_diff": score, "max_box_diff": box, "max_mm_diff": worst, "wall_s": wall}


def start_cli_train_triple():
    """``python -m tti_torch.cli train`` with the TTI_* triple (one process,
    a one-rank NCCL job) on 8 seeded scenes, 2 steps, started now: the
    process, its output directory and its start time."""
    from torch_scenes import textile_samples
    from tti_torch.parallel.dcn import free_local_coordinator

    root = os.path.join(DP_DIR, "cli")
    images = write_yolo_dataset(textile_samples(8, 320, seed=7), root)
    out = os.path.join(root, "run")
    env = dict(os.environ, TTI_COORDINATOR=free_local_coordinator(), TTI_NUM_PROCESSES="1",
               TTI_PROCESS_ID="0", PYTHONPATH=HERE)
    proc = subprocess.Popen([sys.executable, "-m", "tti_torch.cli", "train", "--images", images,
                             "--out", out, "--imgsz", "320", "--batch-size", "4", "--epochs", "1",
                             "--max-gt", "8", "--log-every", "1"], cwd=HERE, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, out, time.perf_counter()


def finish_cli_train_triple(proc, out, t0) -> dict:
    """Wait for :func:`start_cli_train_triple`: exit 0, one checkpoint, the
    triple's NCCL job joined."""
    stdout, stderr = communicate(proc)
    wall = seconds_to_end(proc, t0)
    check(proc.returncode == 0, f"cli train with the triple exited {proc.returncode}:\n"
          f"{stdout[-2000:]}\n{stderr[-3000:]}")
    written = sorted(os.listdir(out))
    check(written == ["step_2.pt"], f"cli train with the triple wrote {written}")
    check("process group up (nccl): rank 0 of 1" in stderr + stdout,
          "cli train did not join the triple's NCCL job")
    log(f"  python -m tti_torch.cli train with TTI_COORDINATOR (one process, NCCL) on 8 scenes at "
        f"imgsz 320, 2 steps: exit 0, {written}, {wall:.1f} s")
    return {"exit": 0, "written": written, "wall_s": wall}


def check_data_parallel(torch, ms, wp, card) -> dict:
    """Phase 5e (see the module docstring)."""
    import torch.distributed as dist

    from tti_torch.parallel import dcn
    from tti_torch.parallel.mesh import create_mesh

    t_phase = time.perf_counter()
    check(dcn.init_distributed(dcn.free_local_coordinator(), 1, 0, device="cuda"),
          "init_distributed did not start the one-rank job")
    try:
        check(dist.get_backend() == "nccl", f"the card's group runs {dist.get_backend()}")
        mesh = create_mesh(device_type="cuda")
        result = {"card": card, "backend": dist.get_backend(), "steps": {}}
        for tag in MESH_STEPS:
            result["steps"][tag] = check_mesh_step(torch, ms, wp, mesh, tag)
            torch.cuda.empty_cache()
        result["dual"] = check_mesh_dual(torch, ms, wp, mesh)
        torch.cuda.empty_cache()
        result["training"] = check_mesh_training(torch, mesh)
    finally:
        dcn.shutdown()
    result["wall_s"] = time.perf_counter() - t_phase
    log(f"data-parallel phase: {result['wall_s']:.1f} s")
    log(card)
    return result


# ---------------------------------------------------------------------------
# Phase 5f: spatial partitioning (the "space" mesh axis)
# ---------------------------------------------------------------------------

SPACE_DIR = os.path.join(HERE, "build", "space_smoke")
SPACE_REPEATS = 1  # the float32 deploy batch-1 space check with its miss dump (time limit)


def check_space(torch, ms, wp, card) -> dict:
    """Phase 5f (see the module docstring)."""
    import torch.distributed as dist

    from space_cards_torch import launch, repeat_summary, summary_lines
    from tti_torch.parallel import dcn, spatial
    from tti_torch.parallel.mesh import create_mesh

    t_phase = time.perf_counter()
    result = {"card": card}
    check(dcn.init_distributed(dcn.free_local_coordinator(), 1, 0, device="cuda"),
          "init_distributed did not start the one-rank job")
    try:
        check(dist.get_backend() == "nccl", f"the card's group runs {dist.get_backend()}")
        grid = create_mesh((1, 1), ("data", "space"), device_type="cuda")
        hw, imgsz, ckpt = CONFIGS["deploy"]
        plain = build_pipeline(torch, hw, imgsz, ckpt)
        one_rank = build_pipeline(torch, hw, imgsz, ckpt, mesh=grid)
        check(one_rank.space is None, "a space axis of one rank must run the plain step")
        frames = torch.from_numpy(textile(hw, 8)).cuda()
        ref = plain.step(frames)
        reset_launch_counts(ms, wp)
        spatial.reset_counts()
        got = one_rank.step(frames)
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts(ms, wp).items() if v}
        check(launches == {"mask_stats_soft": 1, "greedy_keep": 1},
              f"(1, 1) space mesh: launches per step {launches}")
        check(not any(spatial.COUNTS.values()), f"(1, 1) space mesh exchanged: {spatial.COUNTS}")
        n = same_tree(torch, got, ref, "(1, 1) space mesh step")
        syncs = check_step_syncs(torch, one_rank, "(1, 1) space mesh deploy step",
                                 frames[:1].contiguous())["syncs"]
        result["one_rank_nccl"] = {"outputs": n, "launches": launches, "syncs": syncs}
        log(f"(1, 1) (data, space) mesh over a one-rank NCCL job, deploy bf16 at batch 8: {n} "
            f"outputs equal to the plain step's, launches {launches}, no exchange, {syncs} "
            "synchronising calls at batch 1")
        del plain, one_rank, frames, ref, got
        torch.cuda.empty_cache()
    finally:
        dcn.shutdown()
    t0 = time.perf_counter()
    label = "space 2, two gloo ranks sharing the card"
    ranks = launch(2, "gloo", os.path.join(SPACE_DIR, "space2"), runs="checked,banded,dual",
                   repeat=SPACE_REPEATS)
    result["gloo_2"] = {"ranks": ranks, "wall_s": time.perf_counter() - t0}
    for line in summary_lines(ranks, label):
        log(line)
    log(repeat_summary(ranks, label))
    log(f"space 2, dense, banded and dual: {result['gloo_2']['wall_s']:.1f} s with the "
        "processes' start")
    result["banded_p50_ms"] = check_space_banded(ranks)
    result["bf16_spread"] = check_space_spread(ranks)
    result["wall_s"] = time.perf_counter() - t_phase
    log(f"spatial phase: {result['wall_s']:.1f} s")
    log(card)
    return result


def check_space_banded(ranks: list) -> dict:
    """Phase 5f, the banded warp (``warp_block=64``) on the space mesh, from
    the two gloo ranks' ``space_cards_torch.BANDED`` runs (each rank holds
    its float32 outputs to the banded step without a mesh at the bar, and
    checks its launches and exchanges per step): each rank's pass-2 bands
    and bytes against the dense slab's, and its bf16 batch-1 p50 beside the
    dense space step's of the same processes. Returns the p50s."""
    for r, rank in enumerate(ranks):
        for tag, run in rank["runs"].items():
            if "_banded/" not in tag:
                continue
            p2 = run["pass2"]
            check(p2["bands"] > 1 and p2["bytes"] < p2["dense_bytes"],
                  f"rank {r} {tag}: pass-2 weights {p2}")
            log(f"  rank {r}, {tag}: launches per step {run['launches']}; per step at batch "
                + ", ".join(f"{b}: {c['halo']} halo exchanges, {c['gather']} gather"
                            for b, c in run["counts"].items())
                + f"; pass-2 bands {p2['bands']}, {p2['bytes']} bytes against the dense slab's "
                f"{p2['dense_bytes']} ({p2['bytes'] / p2['dense_bytes']:.3f})")
    p50 = {}
    for config in ("deploy", "headline"):
        dense = [x["runs"][f"{config}/bfloat16"]["p50_ms"] for x in ranks]
        banded = [x["runs"][f"{config}_banded/bfloat16"]["p50_ms"] for x in ranks]
        p50[config] = {"dense": dense, "banded": banded}
        log(f"  {config} bf16 batch-1 p50 per rank, banded (warp_block=64) "
            + ", ".join(f"{v:.3f}" for v in banded) + " ms against the dense space step's "
            + ", ".join(f"{v:.3f}" for v in dense) + " ms (the same processes, dense first)")
    return p50


def check_space_spread(ranks: list) -> dict:
    """Phase 5f, the bf16 space steps at batch 1 and 2: each rank held them
    to the plain step at that batch within the plain step's own spread on
    those frames (``space_cards_torch.plain_spread``: batch 128's readings
    and the forward on slabs of other shapes, floor 0.01 mm, cap 0.25,
    detection counts equal) and bit-equal to the same slabs computed on
    threads of one process; a rank that missed failed the phase already.
    Prints and returns each check's readings."""
    from space_cards_torch import spread_text

    out = {}
    for r, rank in enumerate(ranks):
        for tag, run in rank["runs"].items():
            for b, d in run["diffs"].items():
                if "spread_mm_max" not in d:
                    continue
                out[f"rank {r} {tag} batch {b}"] = {k: d[k] for k in (
                    "spread_mm_max", "limit_mm", "spread_bar_met", "mm_max", "same_count_share",
                    "emulated_equal")}
                log(f"  rank {r}, {tag} batch {b}: the plain step's own spread "
                    f"{d['spread_mm_max']:.4g} mm ({spread_text(run, b)}); the space step "
                    f"against the plain step {d['mm_max']:.4g} mm; the bar {d['limit_mm']:.4g} "
                    f"{'met' if d['spread_bar_met'] else 'NOT MET'}; detection counts equal on "
                    f"{d['same_count_share']:.0%} of frames; "
                    f"{'' if d['emulated_equal'] else 'NOT '}bit-equal to the same slabs on "
                    "threads")
    check(len(out) == 2 * 2 * len(ranks), f"bf16 spread checks: {sorted(out)}")
    check(all(v["spread_bar_met"] and v["emulated_equal"] for v in out.values()),
          f"bf16 space steps: {out}")
    log(f"  the bf16 space step within the plain step's own spread and bit-equal to its "
        f"slabs on threads: {len(out)} of {len(out)} (rank, configuration, batch)")
    return out


# ---------------------------------------------------------------------------
# Phase 5g: the tools that time the card (tune-device, profile, host overhead)
# ---------------------------------------------------------------------------

TOOLS_DIR = os.path.join(HERE, "build", "tune_smoke")
TUNE_TRIALS = "baseline,warp_blocked=64,approx_topk=1,maskstats=pallas2,quant=int8,quant=int8s"


def start_tool(argv: list):
    """One tool in a subprocess from the repository's root, started now:
    the process and its start time."""
    return (subprocess.Popen([sys.executable, *argv], cwd=HERE, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True,
                             env=dict(os.environ, PYTHONPATH=HERE)), time.perf_counter())


def finish_tool(started, label: str) -> str:
    """Wait for :func:`start_tool`'s process; its standard output. A
    non-zero exit fails the script."""
    proc, t0 = started
    stdout, stderr = communicate(proc)
    check(proc.returncode == 0, f"{label} exited {proc.returncode}:\n{stdout[-3000:]}\n"
          f"{stderr[-3000:]}")
    log(f"{label}: exit 0, ended {seconds_to_end(proc, t0):.1f} s after the four started")
    return stdout


def section(text: str, head: str, n: int | None = None) -> list[str]:
    """The lines after the line that starts with ``head`` up to the next
    blank line (at most ``n``)."""
    lines = text.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith(head)) + 1
    out = []
    for line in lines[start:]:
        if not line.strip() or (n is not None and len(out) == n):
            break
        out.append(line)
    return out


TOOL_ARGV = {
    "tune": ["-m", "tti_torch.cli", "tune-device", "--batches", "1,32", "--iters", "5",
             "--lat-iters", "5", "--trials", TUNE_TRIALS, "--int8-scales",
             INT8_SCALES["headline"], "--out", os.path.join(TOOLS_DIR, "tune.env")],
    "profile_forward": ["tools/profile_forward_torch.py", "--batch", "8", "--full", "--iters", "2"],
    "profile_train": ["tools/profile_train_torch.py", "--batch", "8", "--iters", "2"],
    "host_overhead": ["tools/host_overhead_torch.py", "--streams", "4", "--iters", "20"],
}


def check_tools(card) -> dict:
    """Phase 5g (see the module docstring). The four tools run side by side
    on the card: each checks that its tool runs end to end; their times are
    taken beside the other three and are not measurements."""
    t_phase = time.perf_counter()
    os.makedirs(TOOLS_DIR, exist_ok=True)
    started = {name: start_tool(argv) for name, argv in TOOL_ARGV.items()}
    try:
        drain(popens(started))
        out = os.path.join(TOOLS_DIR, "tune.env")
        finish_tool(started["tune"], "python -m tti_torch.cli tune-device (headline 1080x1920, "
                    "imgsz 640)")
        with open(out) as f:
            env_text = f.read()
        with open(out + ".json") as f:
            rows = json.load(f)
        check(len(rows) == 12, f"tune-device: {len(rows)} rows, want 6 trials x 2 batches")
        for r in rows:
            if r["name"] == "approx_topk=1":
                check((r["error"] or "").startswith("ConfigError: TTI_APPROX_TOPK=1 is not "
                                                    "ported"), f"tune-device: approx_topk row {r}")
            elif r["name"] == "maskstats=pallas2":
                check("TTI_MASKSTATS has no counterpart" in (r["error"] or ""),
                      f"tune-device: maskstats row {r}")
            else:
                check(r["error"] is None and r["fps"] > 0 and np.isfinite(r["p50_ms"]),
                      f"tune-device: trial failed: {r}")
            log(f"  tune-device batch {r['batch']:3d} {r['name']:18s} " + (
                f"{r['fps']:9.1f} frames/s, p50 {r['p50_ms']:7.3f} ms, set-up and first step "
                f"{r['compile_s']:.1f} s" if r["error"] is None
                else f"reason: {r['error'][:110]}"))
        log("  tune.env: " + " | ".join(env_text.strip().splitlines()))

        prof = finish_tool(started["profile_forward"],
                           "tools/profile_forward_torch.py --batch 8 --full --iters 2")
        summary = next(line for line in prof.splitlines() if line.startswith("== "))
        log(f"  {summary}")
        for line in (section(prof, "-- top", 5) + ["  categories:"]
                     + section(prof, "-- by category")):
            log(f"  {line}")
        train = finish_tool(started["profile_train"],
                            "tools/profile_train_torch.py --batch 8 --iters 2")
        head = next(line for line in train.splitlines() if line.startswith("== train iter"))
        for line in [head] + section(train, head) + section(train, "-- device ms per program"):
            log(f"  {line}")
        host = finish_tool(started["host_overhead"],
                           "tools/host_overhead_torch.py --streams 4 --iters 20")
    finally:
        for p in popens(started):
            if p.poll() is None:
                p.kill()
                p.wait()
    line = json.loads(host.strip().splitlines()[-1])
    check(line["h2d_ms_pinned"] is not None and line["device_step"] == "measured",
          f"host_overhead: {line}")
    log(f"  host_overhead: {json.dumps(line)}")
    wall = time.perf_counter() - t_phase
    log(f"tools phase: {wall:.1f} s (the four side by side: their times are not measurements)")
    log(card)
    return {"tune_rows": rows, "tune_env": env_text, "host_overhead": line, "wall_s": wall,
            "profile_forward": prof[-4000:], "profile_train": train[-4000:]}


# ---------------------------------------------------------------------------
# Phase 5h: __graft_entry__.py's forward chain and tti's public helpers
# ---------------------------------------------------------------------------


ENTRY_HW, ENTRY_BATCHES = (480, 640), (1, 8)
HELPER_DETS = 16  # the detections masks_at_frame takes (16 x 1080 x 1920 float32: 133 MB)


def entry_forward(torch, model):
    """``__graft_entry__.py``'s ``forward_step`` through the port: uint8
    frames -> ``preprocess_frames(..., 640)`` (float32, square) -> the model
    -> DFL decode -> ``batched_nms`` (kernel D), its thresholds."""
    from tti_torch.postprocess.decode import decode_predictions
    from tti_torch.postprocess.nms import batched_nms
    from tti_torch.preprocess.letterbox import preprocess_frames

    @torch.inference_mode()
    def forward_step(frames_u8):
        x, _ = preprocess_frames(frames_u8, 640)
        boxes, probs, coefs = decode_predictions(model(x))
        dets = batched_nms(boxes, probs, coefs, conf_thresh=0.20, iou_thresh=0.25, max_det=200)
        return dets.boxes, dets.scores, dets.classes, dets.valid

    return forward_step


def check_entry_chain(torch, ms, wp, card) -> dict:
    """The chain at batch 1 and 8 on seeded 480x640 textile frames: against
    itself with kernel D's plain version bound (the keep set, classes
    equal; scores within 1e-5 and boxes within 1e-3 px,
    ``__graft_entry__.py``'s bar), kernel D once per call, no
    synchronising call."""
    from types import SimpleNamespace

    from step_syncs_torch import count_step_syncs

    from tti_torch.core.config import ModelConfig
    from tti_torch.kernels import nms as nk
    from tti_torch.model.checkpoint import load_flax_msgpack
    from tti_torch.parallel.runtime import inference_model

    model = inference_model(ModelConfig(image_size=640, dtype="bfloat16"),
                            load_flax_msgpack(os.path.join(HERE, "checkpoints",
                                                           "yolov8n_textile.msgpack")),
                            torch.device("cuda"), s2d_input=False, s2d_stem=False)
    forward_step = entry_forward(torch, model)
    out = {}
    for b in ENTRY_BATCHES:
        frames = torch.from_numpy(textile(ENTRY_HW, b)).cuda()
        forward_step(frames)  # warm
        nk.reset_launch_counts()
        got = [t.cpu() for t in forward_step(frames)]
        d = nk.LAUNCHES["greedy_keep"]
        with plain_routes(ms, wp):
            want = [t.cpu() for t in forward_step(frames)]
        n_syncs, syncs, _ = count_step_syncs(torch, SimpleNamespace(step=forward_step), frames)
        boxes, scores, classes, valid = got
        check(torch.equal(valid, want[3]), f"entry chain batch {b}: the keep set differs from "
              "the chain with D's plain version")
        check(torch.equal(classes, want[2]), f"entry chain batch {b}: classes differ")
        s_err = float((scores - want[1]).abs().max())
        b_err = float((boxes - want[0]).abs().max())
        check(s_err <= 1e-5 and b_err <= 1e-3, f"entry chain batch {b}: scores {s_err}, boxes "
              f"{b_err} px against the plain-D chain (limits 1e-5, 1e-3)")
        check(d == 1, f"entry chain batch {b}: kernel D launched {d} times (once expected)")
        check(n_syncs == 0, f"entry chain batch {b}: synchronising calls {syncs}")
        n = int(valid.sum())
        check(n > 0, f"entry chain batch {b}: no detection on the textile frames")
        check(bool(torch.isfinite(boxes[valid]).all() and torch.isfinite(scores[valid]).all()),
              f"entry chain batch {b}: non-finite outputs")
        t = time_ms(torch, lambda: forward_step(frames), iters=10)
        out[b] = {"detections": n, "greedy_keep_launches": d, "syncs": n_syncs,
                  "score_err": s_err, "box_err": b_err, "ms_per_call": t}
        log(f"  entry chain batch {b} ({ENTRY_HW[0]}x{ENTRY_HW[1]} -> 640, bf16): {n} "
            f"detections, keep set equal to the plain-D chain (scores {s_err:.3g}, boxes "
            f"{b_err:.3g} px), D launched {d}, {n_syncs} syncs, {t:.3f} ms per call [{card}]")
    del model
    return out


def check_helpers(torch, head, card) -> dict:
    """``tti``'s public helpers on the card, on the headline step's outputs
    for one 1080x1920 frame, each held to the same call on the CPU:
    ``masks_at_frame`` of the first 16 detections equal to the CPU's
    nearest resize of the card's masks at the input, which differ from the
    CPU's only where the upsampled probability lies within 1e-5 of 0.5;
    then on those frame masks the envelopes, the edge mask,
    ``nearest_edge_candidates``, ``stitch_stats`` and ``sample_envelope``
    equal (the centroids within rtol 1e-5: float32 moment sums over up to
    2e6 pixels in another order)."""
    from tti_torch.measure import ops
    from tti_torch.postprocess import masks as pm
    from tti_torch.preprocess.letterbox import map_xyxy

    frame_hw = (1080, 1920)
    frames = torch.from_numpy(textile(frame_hw, 1)).cuda()
    with torch.inference_mode():
        raw = head.model(head.preprocess(frames))
        dets, _ = head.detect(raw)
    input_hw = (head.spec.dst_h, head.spec.dst_w)
    order = torch.sort(dets.valid[0].to(torch.uint8), descending=True, stable=True).indices
    rows = order[:HELPER_DETS]
    protos = raw.protos[0].float()
    coefs, boxes, valid = dets.coefs[0, rows].float(), dets.boxes[0, rows], dets.valid[0, rows]
    classes = dets.classes[0, rows]
    args = (protos, coefs, boxes, valid)
    cpu = lambda ts: tuple(t.cpu() if torch.is_tensor(t) else t for t in ts)
    timings = {}

    def both(name, fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(*a)
        torch.cuda.synchronize()
        timings[name] = (time.perf_counter() - t0) * 1e3
        return got, fn(*cpu(a))

    (on_card, on_cpu) = both("masks_at_frame", pm.masks_at_frame, *args, input_hw, frame_hw)
    at_input = pm.masks_at_input(*args, input_hw)
    probs = pm.upsample_masks(pm.assemble_masks(*cpu(args), input_hw, threshold=None), input_hw)
    near = (probs - 0.5).abs() < 1e-5
    differ = at_input.cpu() != pm.masks_at_input(*cpu(args), input_hw)
    check(not (differ & ~near).any(), "masks_at_frame: the card's masks at the input differ "
          "from the CPU's away from the threshold")
    check(torch.equal(on_card.cpu(), pm.resize_nearest_cv2(at_input.cpu(), frame_hw)),
          "masks_at_frame on the card is not the nearest resize of its masks at the input")
    n_differ = int((on_card.cpu() != on_cpu).sum())
    masks = on_card
    stitch = (classes == head.model_cfg.stitch_class_id) & valid
    fabric = (masks * ((classes == head.model_cfg.fabric_class_id) & valid)[:, None, None]
              ).amax(0) > 0
    check(bool(stitch.any()) and bool(fabric.any()), "helpers: the headline frame has no "
          f"stitch ({int(stitch.sum())}) or no fabric ({int(fabric.sum())} px) to work on")
    results = {}
    for name, fn, a in (
            ("fabric_lower_envelope", ops.fabric_lower_envelope, (fabric,)),
            ("fabric_upper_envelope", ops.fabric_upper_envelope, (fabric,)),
            ("fabric_edge_mask", ops.fabric_edge_mask, (fabric,))):
        got, want = both(name, fn, *a)
        check(torch.equal(got.cpu(), want), f"{name}: the card differs from the CPU")
        results[name] = got
    sx, sy = frame_hw[1] / input_hw[1], frame_hw[0] / input_hw[0]  # the masks' grid
    sb = map_xyxy(boxes, lambda x: x * sx, lambda y: y * sy)
    (got, want) = both("stitch_stats", ops.stitch_stats, masks, sb, stitch)
    for i, field in enumerate(("cx", "cy", "left", "right", "has_mask")):
        g, w = got[i].cpu(), want[i]
        ok = (torch.allclose(g, w, rtol=1e-5, atol=0.0) if field in ("cx", "cy")
              else torch.equal(g, w))
        check(ok, f"stitch_stats {field}: the card differs from the CPU")
    cx, cy = got[0], got[1]
    nbr = torch.arange(-3, 4, device=masks.device)
    (got, want) = both("sample_envelope", ops.sample_envelope,
                       results["fabric_lower_envelope"], cx, nbr)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          "sample_envelope: the card differs from the CPU")
    (got, want) = both("nearest_edge_candidates", ops.nearest_edge_candidates,
                       results["fabric_edge_mask"], cx[0], cy[0], 20)
    for g, w, field in zip(got, want, ("ys", "xs", "dist", "valid")):
        check(torch.equal(g.cpu(), w), f"nearest_edge_candidates {field}: the card differs "
              "from the CPU")
    out = {"detections": int(valid.sum()), "stitches": int(stitch.sum()),
           "fabric_px": int(fabric.sum()), "edge_px": int(results["fabric_edge_mask"].sum()),
           "frame_mask_px_differing_from_cpu": n_differ, "near_threshold_px": int(near.sum()),
           "ms_on_card": timings}
    log(f"  helpers on the headline step's outputs (1 frame, {HELPER_DETS} detections, "
        f"1080x1920): {out['detections']} valid, {out['stitches']} stitches, "
        f"{out['fabric_px']} fabric px, {out['edge_px']} edge px; masks_at_frame: {n_differ} "
        f"frame px differ from the CPU ({out['near_threshold_px']} input px within 1e-5 of "
        f"0.5); every other helper equal to the CPU [{card}]")
    log("  card ms (first call, host clock): " + ", ".join(
        f"{k} {v:.2f}" for k, v in timings.items()) + f" [{card}]")
    return out


def check_entry_helpers(torch, ms, wp, head, card) -> dict:
    """Phase 5h (see the module docstring)."""
    t_phase = time.perf_counter()
    out = {"entry": check_entry_chain(torch, ms, wp, card),
           "helpers": check_helpers(torch, head, card)}
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"entry chain and helpers: {out['wall_s']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 5i: ``python -m tti_torch.cli bench`` (bench_torch.py)
# ---------------------------------------------------------------------------


BENCH_ITERS = 10
BENCH_DIR = os.path.join(HERE, "build", "bench_smoke")
BENCH_ROW_KEYS = ["metric", "value", "unit", "vs_baseline", "weights", "p50_ms_unclamped",
                  "sync_roundtrip_ms"]
BENCH_METRICS = ("deploy_960p_imgsz960_s2_frames_per_sec_per_chip_e2e",
                 "undistorted_1080p_frames_per_sec_per_chip_e2e")
BENCH_ERR_LINES = ("deploy batch=", "headline batch=", "config4 dual-model: ",
                   "config5 4-stream line host-fed: ")


def bench_launches(iters: int) -> dict:
    """Kernel launches of one ``TTI_BENCH_CONFIGS=all`` run at ``iters``:
    each row's ``iters`` timed steps, a warm one and 1 + 10 at batch 1; the
    dual step's iters + 1; the 4-stream line's 1 + 25 + 26. A once per
    deploy step, B and D once per headline and 4-stream step and twice per
    dual step."""
    row, dual, streams = iters + 12, iters + 1, 52
    return {"mask_stats_soft": row, "mask_stats_binary": row + 2 * dual + streams,
            "greedy_keep": 2 * row + 2 * dual + streams}


def bench_cli_main(out_path: str) -> int:
    """Phase 5i's subprocess: ``python -m tti_torch.cli bench`` run in this
    process (``runpy``, as ``-m`` runs it), every kernel's launch count set
    to 0 before and written to ``out_path`` after. Its exit code."""
    import runpy

    from tti_torch.kernels import maskstats as ms
    from tti_torch.kernels import warp_p1 as wp

    reset_launch_counts(ms, wp)
    sys.argv = ["tti_torch.cli", "bench"]
    try:
        runpy.run_module("tti_torch.cli", run_name="__main__", alter_sys=True)
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    with open(out_path, "w") as f:
        json.dump(launch_counts(ms, wp), f)
    return rc


BENCH_LAUNCHES = os.path.join(BENCH_DIR, "launches.json")


def start_bench():
    """Phase 5i's process, started now (beside phase 5g's tools): the
    process and its start time. It is killed at exit if still running."""
    import atexit

    os.makedirs(BENCH_DIR, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if not k.startswith("TTI_")}
    env.update(TTI_BENCH_CONFIGS="all", TTI_BENCH_ITERS=str(BENCH_ITERS), PYTHONPATH=HERE)
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "chip_smoke.py"), "--bench-cli",
                             BENCH_LAUNCHES], cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    drain([proc])
    atexit.register(lambda: proc.poll() is None and (proc.kill(), proc.wait()))
    return proc, time.perf_counter()


def check_bench(card, started) -> dict:
    """Phase 5i (see the module docstring): wait for :func:`start_bench`'s
    process and hold what it printed and launched."""
    proc, t0 = started
    stdout, stderr = communicate(proc, timeout=300)
    wall = seconds_to_end(proc, t0)
    check(proc.returncode == 0, f"python -m tti_torch.cli bench exited {proc.returncode}:\n"
          f"{stdout[-3000:]}\n{stderr[-3000:]}")
    lines = [line for line in stdout.splitlines() if line.strip()]
    check(len(lines) == 2, f"bench: {len(lines)} lines on stdout, want 2:\n{stdout[-3000:]}")
    rows = [json.loads(line) for line in lines]
    weights = [os.path.join(HERE, "checkpoints", c)
               for c in ("yolov8n_textile_cam.msgpack", "yolov8n_textile.msgpack")]
    for row, metric, ckpt in zip(rows, BENCH_METRICS, weights):
        check(list(row) == BENCH_ROW_KEYS and row["metric"] == metric, f"bench row {row}")
        check(row["weights"] == ckpt, f"bench: {metric} weighs {row['weights']}, want {ckpt}")
        # The round trip of a finished step's sum may round to 0.00 ms.
        check(all(np.isfinite(row[k]) and row[k] > 0
                  for k in ("value", "vs_baseline", "p50_ms_unclamped"))
              and np.isfinite(row["sync_roundtrip_ms"]) and row["sync_roundtrip_ms"] >= 0,
              f"bench row {row}")
        log(f"  {json.dumps(row)}")
    err = stderr.splitlines()
    found = []
    for start in BENCH_ERR_LINES:
        at = [i for i, line in enumerate(err) if line.startswith(start)]
        check(len(at) == 1, f"bench: {len(at)} stderr lines start {start!r}:\n{stderr[-3000:]}")
        found.append(at[0])
        log(f"  {err[at[0]]}")
    check(found == sorted(found), f"bench: stderr lines out of order: {found}")
    dual_fps = float(err[found[2]].split()[2])
    sync_fps, pipe_fps = (float(part.split()[0])
                          for part in err[found[3]].split(": ", 1)[1].split(", ")[:2])
    check(min(dual_fps, sync_fps, pipe_fps) > 0, "bench: a stderr line reads 0 frames/s")
    with open(BENCH_LAUNCHES) as f:
        launches = {k: v for k, v in json.load(f).items() if v}
    want = bench_launches(BENCH_ITERS)
    check(launches == want, f"bench launches {launches}, want {want}")
    log(f"  launches in the bench process: {launches} (as counted for iters {BENCH_ITERS})")
    log(f"bench (python -m tti_torch.cli bench, TTI_BENCH_CONFIGS=all, TTI_BENCH_ITERS="
        f"{BENCH_ITERS}, batch 128): ended {wall:.1f} s after it started, beside phase 5g's "
        f"tools (its readings are checks, not measurements) [{card}]")
    return {"rows": rows, "dual_fps": dual_fps, "streams_fps": [sync_fps, pipe_fps],
            "launches": launches, "wall_s": wall}


BENCH_RECORD = os.path.join(HERE, "build", "BENCH_torch_smoke.txt")


def check_regen_docs(card, rows) -> dict:
    """Phase 5i, after the bench: its two rows after the card line in
    ``build/BENCH_torch_smoke.txt``, then ``tools/regen_docs_torch.py --root
    build --readme build/README_smoke.md --tests 0`` on a copy of README;
    the port's block must hold both rows' values and the card line. Its
    wall seconds."""
    import shutil

    t0 = time.perf_counter()
    with open(BENCH_RECORD, "w") as f:
        f.write("\n".join([card, *(json.dumps(row) for row in rows)]) + "\n")
    readme = os.path.join(HERE, "build", "README_smoke.md")
    shutil.copy(os.path.join(HERE, "README.md"), readme)
    proc = subprocess.run([sys.executable, os.path.join(HERE, "tools", "regen_docs_torch.py"),
                           "--root", os.path.join(HERE, "build"), "--readme", readme,
                           "--tests", "0"], cwd=HERE, capture_output=True, text=True,
                          timeout=120)
    check(proc.returncode == 0, f"regen_docs_torch.py exited {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    with open(readme) as f:
        block = f.read().split("<!-- AUTOGEN:PERF_TORCH -->", 1)[1].split(
            "<!-- /AUTOGEN:PERF_TORCH -->", 1)[0]
    for row in rows:
        check(f"**{row['value']} frames/s per card**" in block,
              f"README's port block lacks {row['metric']}'s value {row['value']}:\n{block}")
    check(f"| {card} |" in block, f"README's port block lacks the card line {card!r}:\n{block}")
    wall = time.perf_counter() - t0
    log(f"  README's port block (tools/regen_docs_torch.py) from {BENCH_RECORD}: both rows' "
        f"values and the card line ({wall:.1f} s wall)")
    return {"wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 6: training
# ---------------------------------------------------------------------------


CAM_CKPT = os.path.join(HERE, "checkpoints", "yolov8n_textile_cam.msgpack")
R5S = dict(imgsz=960, mask_stride=2, proto_head="subpixel", soft_masks="all", max_gt=16,
           batch=8, gains=(2.0, 1.0), n_scenes=32, total_steps=10800)
HEADLINE_TRAIN = dict(imgsz=640, mask_stride=4, proto_head="deconv", soft_masks=None, max_gt=32,
                      batch=64, gains=None, n_scenes=32, total_steps=10)
LOSS_KEYS = ("total", "cls", "box", "dfl", "seg")


_DATASETS: dict = {}  # (seed, recipe) -> (the device dataset, the seconds it took to build)


def train_dataset(torch, recipe, seed):
    """The recipe's seeded scenes as a device dataset, built once per recipe
    and seed (phases 5e and 6 share r5s'; trainers only read it)."""
    from torch_scenes import textile_samples
    from tti_torch.train.augment import build_device_dataset

    key = (seed, tuple(sorted(recipe.items())))
    if key not in _DATASETS:
        t0 = time.perf_counter()
        data = build_device_dataset(
            textile_samples(recipe["n_scenes"], recipe["imgsz"], seed=seed), recipe["imgsz"],
            recipe["max_gt"], mask_stride=recipe["mask_stride"], soft_masks=recipe["soft_masks"],
            device="cuda")
        _DATASETS[key] = (data, time.perf_counter() - t0)
    return _DATASETS[key][0]


def recipe_trainer(torch, data, recipe, dtype, init, total_steps, lr=1e-3, mesh=None):
    """The recipe's trainer on the card; ``total_steps`` None: a constant rate."""
    from tti_torch.train.loop import build_model, build_trainer

    model = build_model("n", 2, recipe["mask_stride"], recipe["proto_head"], dtype, "cuda", init)
    return build_trainer(data, model, recipe["batch"], recipe["max_gt"], total_steps, lr, dtype,
                         recipe["gains"], mesh=mesh)


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


def write_yolo_dataset(samples, root: str) -> str:
    """``samples`` (decoded ``Sample``s) as a YOLO-format set under ``root``:
    ``images/s_i.png`` and ``labels/s_i.txt``. Returns the images directory."""
    import cv2

    images, labels = os.path.join(root, "images"), os.path.join(root, "labels")
    for d in (images, labels):
        os.makedirs(d, exist_ok=True)
    for i, s in enumerate(samples):
        cv2.imwrite(os.path.join(images, f"s_{i}.png"), np.ascontiguousarray(s.image[..., ::-1]))
        with open(os.path.join(labels, f"s_{i}.txt"), "w") as f:
            f.write("\n".join(f"{c} " + " ".join(f"{v:.6f}" for v in p.ravel())
                              for p, c in zip(s.polygons, s.classes)))
    return images


HOST_AUG_SCENES = 16  # two batches of 8: the host recipe runs at about 2.5 s a batch


HOST_AUG_DIR = os.path.join(HERE, "build", "train_smoke", "host_aug")


def host_aug_images() -> str:
    """Phase 6's host-recipe scenes (HOST_AUG_SCENES seeded scenes at r5s'
    imgsz, PNG files under ``build/train_smoke/host_aug``), written now: the
    images directory."""
    import shutil

    from torch_scenes import textile_samples

    shutil.rmtree(HOST_AUG_DIR, ignore_errors=True)
    return write_yolo_dataset(textile_samples(HOST_AUG_SCENES, R5S["imgsz"], seed=101),
                              HOST_AUG_DIR)


def start_host_aug_cli(images: str):
    """``python -m tti_torch.cli train --host-aug`` at r5s on
    :func:`host_aug_images` (one epoch, batch 8, from the deploy
    checkpoint), started now: the process, its output directory and its
    start time."""
    out = os.path.join(HOST_AUG_DIR, "run")
    argv = [sys.executable, "-m", "tti_torch.cli", "train", "--host-aug", "--images", images,
            "--out", out, "--imgsz", str(R5S["imgsz"]), "--batch-size", str(R5S["batch"]),
            "--epochs", "1", "--max-gt", str(R5S["max_gt"]), "--log-every", "1",
            "--checkpoint-every", "0", "--mask-stride", str(R5S["mask_stride"]), "--proto-head",
            R5S["proto_head"], "--soft-masks", "--stitch-seg-gain", "2.0", "--init", CAM_CKPT]
    return (subprocess.Popen(argv, cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            out, time.perf_counter())


def finish_host_aug_cli(proc, out, t0) -> dict:
    """Wait for :func:`start_host_aug_cli`: exit 0, one checkpoint, finite
    losses on every logged step."""
    stdout, stderr = communicate(proc)
    cli_s = seconds_to_end(proc, t0)
    check(proc.returncode == 0, f"cli train --host-aug exited {proc.returncode}:\n"
          f"{stdout[-2000:]}\n{stderr[-3000:]}")
    steps = HOST_AUG_SCENES // R5S["batch"]
    written = sorted(os.listdir(out))
    check(written == [f"step_{steps}.pt"], f"cli train --host-aug wrote {written}")
    step_lines = [ln for ln in stdout.splitlines() if ln.startswith("step ")]
    check(len(step_lines) == steps, f"cli train --host-aug logged {step_lines}")
    for line in step_lines:
        terms = {k: float(v) for k, v in (kv.split("=") for kv in line.split(": ")[1].split())}
        check(all(np.isfinite(v) for v in terms.values()), f"cli --host-aug: {line}")
    log(f"  python -m tti_torch.cli train --host-aug (r5s, batch {R5S['batch']}, 1 epoch): exit 0, "
        f"{written}, {len(step_lines)} steps logged, last: {step_lines[-1]}; {cli_s:.1f} s")
    return {"cli_s": cli_s, "cli_written": written, "cli_last_step": step_lines[-1]}


def check_host_aug(torch, ms, wp, device_timing: dict) -> dict:
    """Phase 6's host recipe (``train --host-aug``) at r5s on the
    HOST_AUG_SCENES scenes of :func:`host_aug_images` (phase 3b wrote them
    and ran the CLI on them): the host's ms per batch of ``batches`` (one
    epoch, files decoded on first use) and the host loop (``run_host``:
    each batch through pinned memory into the same ``TrainStep``) in
    images/s beside the device augment's loop. Training launches no
    kernel."""
    from tti_torch.train.data import batches, discover_dataset
    from tti_torch.train.loop import build_model, run_host, step_and_augment
    from tti_torch.train.step import create_train_state

    t_phase = time.perf_counter()
    samples = discover_dataset(os.path.join(HOST_AUG_DIR, "images"))
    recipe = dict(max_gt=R5S["max_gt"], mask_stride=R5S["mask_stride"],
                  soft_masks=R5S["soft_masks"])
    n = R5S["batch"]
    marks = [time.perf_counter()]
    for _ in batches(samples, n, R5S["imgsz"], seed=0, epochs=1, **recipe):
        marks.append(time.perf_counter())
    per_batch = np.diff(marks) * 1e3
    # The host loop in this process: one warm-up step, then one epoch timed.
    reset_launch_counts(ms, wp)
    model = build_model("n", 2, R5S["mask_stride"], R5S["proto_head"], torch.bfloat16, "cuda",
                        CAM_CKPT)
    state = create_train_state(model, learning_rate=1e-3, total_steps=R5S["total_steps"])
    step, _ = step_and_augment(R5S["imgsz"], n, R5S["max_gt"], torch.bfloat16, R5S["gains"])
    run_host(state, step, batches(samples[:n], n, R5S["imgsz"], seed=1, epochs=1, **recipe),
             "cuda", log_every=0)
    logged = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = run_host(state, step, batches(samples, n, R5S["imgsz"], seed=0, epochs=1, **recipe),
                     "cuda", log_every=1, log=logged.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(ms, wp)
    check(not any(launches.values()), f"host-aug training launched a kernel: {launches}")
    for line in logged:
        terms = dict(kv.split("=") for kv in line.split(": ")[1].split())
        check(all(np.isfinite(float(v)) for v in terms.values()), f"host-aug: {line}")
    del model, state, step
    torch.cuda.empty_cache()

    images_per_s = n * steps / wall
    log(f"r5s host augment (--host-aug recipe, {len(samples)} PNG scenes at "
        f"{R5S['imgsz']} px): batches() {per_batch.mean():.1f} ms per batch of {n} on the host "
        f"(min {per_batch.min():.1f}, max {per_batch.max():.1f}, first includes decoding); "
        f"the host loop (batches, pinned upload, TrainStep) {images_per_s:.1f} images/s, "
        f"{1e3 * wall / steps:.2f} ms per step over {steps} steps; the device augment's loop "
        f"{device_timing['images_per_s']:.1f} images/s, {device_timing['step_ms']:.2f} ms per "
        f"step (this phase); kernel launches {launches}")
    wall_s = time.perf_counter() - t_phase
    log(f"host augment checks: {wall_s:.1f} s")
    return {"host_ms_per_batch": per_batch.tolist(), "images_per_s": images_per_s,
            "step_ms": 1e3 * wall / steps, "device_images_per_s": device_timing["images_per_s"],
            "device_step_ms": device_timing["step_ms"], "wall_s": wall_s}


def check_training(torch, ms, wp, card) -> dict:
    """Phase 6 (see the module docstring). Launch counts are set to 0 before
    the training path and read after it: training launches no kernel; the
    deploy step with the exported checkpoint launches kernel A."""
    from tti_torch.cli.__main__ import main as cli
    from tti_torch.train.checkpoint import save_train_state

    out_dir = os.path.join(HERE, "build", "train_smoke")
    result = {"card": card, "card_vs_cpu": check_train_card_vs_cpu(torch)}

    data = train_dataset(torch, R5S, seed=101)
    built_s = next(t for d, t in _DATASETS.values() if d is data)
    log(f"r5s dataset: {data.images.shape[0]} scenes at {data.imgsz} px on the card, masks "
        f"{tuple(data.masks.shape[1:])} (soft={data.soft}), {int(data.valid.sum())} GT, built in "
        f"{built_s:.1f} s (once, for phases 5e and 6)")
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
    result["r5s_host_aug"] = check_host_aug(torch, ms, wp, result["r5s_timing"])

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


def cli_workdir(name: str) -> str:
    """A working directory for one CLI run, ``build/cli_smoke/<name>``: a
    .env (the cam checkpoint, a sqlite path, the geometry) and the
    calibration files written by ``tti_torch.calib.io``."""
    from tti_torch.calib.io import save_extrinsics, save_intrinsics

    d = os.path.join(CLI_DIR, name)
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
    return d


def start_cli(d: str, extra: list, env_extra: dict | None = None):
    """``python -m tti_torch.cli run --synthetic --max-frames 2`` in ``d``,
    started now: (the process, its start time)."""
    env = dict(os.environ, PYTHONPATH=HERE, TTI_LOG_JSON="1", **(env_extra or {}))
    return subprocess.Popen([sys.executable, "-m", "tti_torch.cli", "run", "--synthetic",
                             "--max-frames", "2", "--device", APP["device"], *extra], cwd=d,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True), time.perf_counter()


def finish_cli(started, label: str) -> tuple:
    """Wait for :func:`start_cli`'s process (exit 0 required): the seconds it
    took and the messages of its JSON log records."""
    proc, t0 = started
    _, stderr = communicate(proc)
    secs = seconds_to_end(proc, t0)
    check(proc.returncode == 0, f"cli {label}: exit {proc.returncode}\n{stderr[-3000:]}")
    records = []
    for line in stderr.splitlines():
        with contextlib.suppress(ValueError):
            records.append(json.loads(line))
    return secs, [r.get("msg", "") for r in records]


CLI_DIR = os.path.join(HERE, "build", "cli_smoke")
# ``python -m tti_torch.cli run --synthetic --max-frames 2``, each in its own
# working directory: (label, arguments, environment, records expected).
CLI_RUNS = (
    ("one camera", ["--skip-calibration"], {}, 2),
    ("four cameras", ["--cameras", "4"], {}, 8),
    ("int8", ["--skip-calibration"], {"TTI_QUANT": "int8"}, 2),
)


def start_cli_runs() -> dict:
    """Every run of :data:`CLI_RUNS`, started now."""
    import shutil

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    return {label: start_cli(cli_workdir(f"run{i}"), extra, env)
            for i, (label, extra, env, _) in enumerate(CLI_RUNS)}


def finish_cli_runs(started: dict) -> dict:
    """Wait for :func:`start_cli_runs`: each exits 0; the single-camera loop
    at the reference's 2 s cadence logs two measurement records (also under
    ``TTI_QUANT=int8``), the four synthetic cameras through
    ``MultiStreamRunner`` eight stream records."""
    out = {}
    for label, extra, env, want in CLI_RUNS:
        secs, msgs = finish_cli(started[label], label)
        if "--cameras" in extra:
            n = sum(m.startswith("stream ") for m in msgs)
            check(n == want and "multistream shutdown: 2 batches x 4 streams" in msgs,
                  f"cli {label}: {n} stream records; {msgs[-3:]}")
        else:
            n = sum(m == "measurement" for m in msgs)
            check(n == want, f"cli {label}: {n} measurement records, expected {want}")
        out[label] = {"seconds": secs, "records": n}
        argv = " ".join([*(f"{k}={v}" for k, v in env.items()), "python -m tti_torch.cli run",
                         "--synthetic --max-frames 2", *extra])
        log(f"  cli `{argv}`: exit 0 in {secs:.1f} s, {n} records")
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
    with plain_routes(ms, wp):
        plain = run_loop(ms, wp, pipe, frames, "plain")
    for tag, loop in (("blocking", blocking), ("pipelined", piped)):
        check(loop["launches"]["mask_stats_soft"] == n and not loop["launches"]["mask_stats_binary"]
              and loop["launches"]["greedy_keep"] == n,
              f"run {tag}: kernels A and D once per frame expected, launches {loop['launches']}")
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


def check_rectified_rows(torch, ms, wp, frames, summary) -> dict:
    """The mm report's rectified rows (``undistort=True``: the two-pass
    warp ahead of the deploy step, frames undistorted once) on phase 8's
    scenes, float32 and bf16: kernels A and D once per step, the per-frame
    gate, the plain statistics bound in the kernels' place within 0.01 mm,
    and rectified minus reference-native p50, p95 and bias."""
    import measure_report_torch as mr

    t0 = time.perf_counter()
    out = {}
    for dtype in ("float32", "bfloat16"):
        label = f"rectified {dtype}"
        pipe = mr.build_pipeline(CAM_CKPT, undistort=True, dtype=dtype, device="cuda")
        check(pipe.warp is not None and pipe.measure_cfg.undistort_iters == 0,
              f"{label}: not rectified once (warp {pipe.warp}, point undistortion "
              f"{pipe.measure_cfg.undistort_iters} iterations)")
        reset_launch_counts(ms, wp)
        meas = pipe.process_batch(frames).measurements
        launches = launch_counts(ms, wp)
        check(launches["mask_stats_soft"] == 1 and launches["greedy_keep"] == 1
              and sum(launches.values()) == 2, f"{label}: kernels A and D once expected: "
              f"{launches}")
        stats = report_gate(meas, label)
        with plain_routes(ms, wp):
            plain = pipe.process_batch(frames).measurements
        check(launch_counts(ms, wp) == launches, f"{label}: the plain step launched")
        for key in MM_KEYS:
            a, r = getattr(meas, key).astype(float), getattr(plain, key).astype(float)
            check((np.isnan(a) == np.isnan(r)).all(), f"{label}: plain NaN pattern")
            stats[f"plain_{key}"] = float(np.nanmax(np.abs(a - r), initial=0.0))
        plain_mm = max(stats["plain_raw_edge_mm"], stats["plain_raw_width_mm"])
        check(plain_mm <= 1e-2, f"{label}: kernel A and its plain version differ by {plain_mm} mm")
        native = summary[f"{dtype}/true"]
        stats["minus_native"] = {
            k: {q: stats[k][q] - native[k][q] for q in ("p50", "p95", "bias")}
            for k in ("edge", "width")}
        out[dtype] = stats
        log(f"{label} ({REPORT_SCENES} scenes, A {launches['mask_stats_soft']} and D "
            f"{launches['greedy_keep']} launches): " + "; ".join(
                f"{k} {stats[k]['coverage']} p50 {stats[k]['p50']:.4f} p95 "
                f"{stats[k]['p95']:.4f} bias {stats[k]['bias']:+.4f} mm (rectified - native: "
                f"p50 {stats['minus_native'][k]['p50']:+.4f}, p95 "
                f"{stats['minus_native'][k]['p95']:+.4f}, bias "
                f"{stats['minus_native'][k]['bias']:+.4f})" for k in ("edge", "width"))
            + f"; kernel A against its plain version {plain_mm:.2e} mm")
        del pipe
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"rectified rows: {out['seconds']:.1f} s")
    return out


OFFSET_SCENES = 16  # phase 3b's calibrate_offsets_torch run (the tool's default is 96)


def start_calibrate_offsets():
    """``tools/calibrate_offsets_torch.py`` on a copy of the deploy
    checkpoint and its sidecar under ``build/offsets_smoke``, over
    OFFSET_SCENES scenes, in a subprocess started now."""
    import shutil

    d = os.path.join(HERE, "build", "offsets_smoke")
    os.makedirs(d, exist_ok=True)
    weights = os.path.join(d, os.path.basename(CAM_CKPT))
    shutil.copy(CAM_CKPT, weights)
    shutil.copy(CAM_CKPT + ".json", weights + ".json")
    argv = [sys.executable, os.path.join(HERE, "tools", "calibrate_offsets_torch.py"),
            "--weights", weights, "--scenes", str(OFFSET_SCENES)]
    proc = subprocess.Popen(argv, cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, weights, time.perf_counter()


def finish_calibrate_offsets(proc, weights, t0) -> dict:
    """Wait for :func:`start_calibrate_offsets`: exit 0, every key of the
    sidecar but the calibration's unchanged, both constants finite; printed
    beside the deploy sidecar's."""
    stdout, stderr = communicate(proc)
    wall = seconds_to_end(proc, t0)
    check(proc.returncode == 0, f"calibrate_offsets_torch exited {proc.returncode}:\n"
          f"{stdout[-2000:]}\n{stderr[-3000:]}")
    with open(CAM_CKPT + ".json") as f:
        before = json.load(f)
    with open(weights + ".json") as f:
        after = json.load(f)
    cal_keys = {k for k in after if k.startswith("cal_")}
    check(set(after) == set(before) and {k: v for k, v in after.items() if k not in cal_keys}
          == {k: v for k, v in before.items() if k not in cal_keys},
          "calibrate_offsets_torch changed a sidecar key besides the calibration's")
    edge, width = after["cal_edge_mm"], after["cal_width_mm"]
    check(np.isfinite(edge) and np.isfinite(width), f"offsets not finite: {edge}, {width}")
    check(after["cal_scenes"] == OFFSET_SCENES, f"cal_scenes {after['cal_scenes']}")
    line = next((ln for ln in stdout.splitlines() if ln.startswith("wrote ")), "")
    log(f"  calibrate_offsets_torch ({OFFSET_SCENES} scenes, seed {after['cal_seed']}, float32, "
        f"reference-native): cal_edge_mm {edge:+.4f} (deploy sidecar {before['cal_edge_mm']:+.4f}, "
        f"{before['cal_scenes']} scenes), cal_width_mm {width:+.4f} (sidecar "
        f"{before['cal_width_mm']:+.4f}); raw bias {after['cal_edge_bias_raw']:+.4f} / "
        f"{after['cal_width_bias_raw']:+.4f}, edge coverage {after['cal_coverage']}; every other "
        f"key kept; exit 0, {wall:.1f} s: {line}")
    return {"cal": {k: after[k] for k in sorted(cal_keys)},
            "sidecar": {k: before[k] for k in sorted(cal_keys)}, "wall_s": wall}


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
    intr = subprocess.Popen([sys.executable, "-m", "tti_torch.cli", "calibrate-intrinsics",
                             "--images", intr_dir, "--out", out_json], cwd=CAL_DIR,
                            env=dict(os.environ, PYTHONPATH=HERE), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)

    # The first scenes of the mm report through the deploy step, with the
    # true and the recovered extrinsics, in float32 and bf16, while the CLI
    # solves the intrinsics on the host.
    rng = np.random.default_rng(0)
    scenes = [mr.make_measure_scene(mapper, rng) for _ in range(REPORT_SCENES)]
    frames = np.stack([f for f, _ in scenes])
    gt_edge = np.array([t.frame_edge for _, t in scenes])
    gt_width = np.array([t.frame_width for _, t in scenes])
    gt_n = np.array([t.n_stitches for _, t in scenes])
    summary = {"t_err_mm": t_err_mm, "r_err_deg": r_err_deg, "cv2_vs_tti_mm": cv2_t_mm,
               "cv2_vs_tti_rad": cv2_r_rad}
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
                with plain_routes(ms, wp):
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
    stdout, stderr = communicate(intr)
    result_line = next((ln for ln in stdout.splitlines() if ln.startswith("RESULT: rms=")), None)
    check(intr.returncode == 0 and result_line is not None and os.path.exists(out_json),
          f"calibrate-intrinsics: exit {intr.returncode}: {stderr[-2000:]}")
    with open(out_json) as f:
        fx = json.load(f)["camera_matrix"][0][0]
    summary["intrinsics_cli"] = result_line
    log(f"calibrate-intrinsics (8 views, fx 880 rendered): {result_line}; fx {fx:.2f}")
    summary["rectified"] = check_rectified_rows(torch, ms, wp, frames, summary)
    summary["seconds"] = time.perf_counter() - t0
    log(f"calibrate, then measure: {summary['seconds']:.1f} s")
    return summary


# ---------------------------------------------------------------------------
# Phase 3b: the checks that run in processes of their own, side by side
# ---------------------------------------------------------------------------


def check_side_by_side(torch) -> dict:
    """Phase 3b (see the module docstring): every check that runs in
    processes of its own and times nothing, started together, then each
    waited for and held to its bar in turn. This process starts them and
    waits: no timing of this script runs beside them."""
    t_phase = time.perf_counter()
    os.makedirs(INT8_DIR, exist_ok=True)
    started: dict = {}
    try:
        started["calibration"] = {c: start_calibration(ckpt, imgsz, INT8_SCALES[c])
                                  for c, (_, imgsz, ckpt) in CONFIGS.items()}
        started["cli"] = start_cli_runs()
        started["gloo_pair"] = start_gloo_pair()
        started["calibrate_offsets"] = start_calibrate_offsets()
        started["cli_train"] = start_cli_train_triple()
        started["host_aug_cli"] = start_host_aug_cli(host_aug_images())
        drain(popens(started))
        log(f"  {len(popens(started))} processes started in {time.perf_counter() - t_phase:.1f} s "
            "(the two training sets written meanwhile)")
        out = {"calibration_s": {c: finish_calibration(c, *p)
                                 for c, p in started["calibration"].items()},
               "cli": finish_cli_runs(started["cli"]),
               "cli_train": finish_cli_train_triple(*started["cli_train"]),
               "host_aug_cli": finish_host_aug_cli(*started["host_aug_cli"]),
               "calibrate_offsets": finish_calibrate_offsets(*started["calibrate_offsets"]),
               "gloo_pair": finish_gloo_pair(torch, started["gloo_pair"])}
    finally:
        for p in popens(started):
            if p.poll() is None:
                p.kill()
                p.wait()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--first-design", metavar="PATH",
                        help="a copy of the first design of maskstats.cu, timed beside the kernels")
    parser.add_argument("--first-design-int8", metavar="PATH",
                        help="a copy of kernel E's first int8conv.cu (commit 7a2104c), timed "
                             "beside kernel E in phase 5c")
    parser.add_argument("--first-design-warp", metavar="PATH",
                        help="a copy of kernel C's first warp_p1.cu (commit 0b702ac), held equal "
                             "to kernel C and timed beside it")
    parser.add_argument("--first-design-nms", metavar="PATH",
                        help="a copy of kernel D's first nms.cu (commit d4bb171), held equal "
                             "to kernel D and timed beside it")
    parser.add_argument("--first-design-scale", metavar="PATH",
                        help="a copy of kernel F's first int8conv.cu (commit b58ffc1), held "
                             "equal to kernel F and timed beside it in phase 5c")
    parser.add_argument("--ablate", action="store_true",
                        help="time variants of maskstats.cu on synthetic inputs, and nothing else")
    parser.add_argument("--gloo-rank", type=int, default=None,
                        help="run as rank 0 or 1 of phase 5e's two gloo ranks on the card, "
                             "and nothing else (phase 5e starts them)")
    parser.add_argument("--gloo-coordinator", help="host:port of the gloo ranks' job")
    parser.add_argument("--gloo-out", help="where a gloo rank writes its outputs")
    parser.add_argument("--bench-cli", metavar="PATH",
                        help="run python -m tti_torch.cli bench in this process and write its "
                             "kernel launch counts to PATH, and nothing else (phase 5i starts it)")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    t_script = time.perf_counter()
    sys.path.insert(0, HERE)
    sys.path.append(os.path.join(HERE, "tests"))
    sys.path.append(os.path.join(HERE, "tools"))
    if opts.gloo_rank is not None:
        return gloo_rank_main(torch, opts.gloo_rank, opts.gloo_coordinator, opts.gloo_out)
    if opts.bench_cli is not None:
        return bench_cli_main(opts.bench_cli)
    from tti_torch import native
    from tti_torch.kernels import build as kbuild
    from tti_torch.kernels import conv_epilogue as ce
    from tti_torch.kernels import int8conv as ik
    from tti_torch.kernels import maskstats as ms
    from tti_torch.kernels import nms as nk
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
    kbuild.compile_all(("maskstats", "warp_p1", "nms", "int8conv", "conv_epilogue"))
    ms.build()
    wp.build()
    nk.build()
    ik.build()
    ce.build()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a, maskstats.cu, warp_p1.cu, "
        "nms.cu, int8conv.cu and conv_epilogue.cu)")
    for name, text in sorted(kbuild.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    t0 = time.perf_counter()
    check(native._load_library() is not None, "the C++ frame ring did not build")
    log(f"build: {time.perf_counter() - t0:.1f} s (g++, framering.cpp)")

    first = load_first_design(torch, opts.first_design) if opts.first_design else None
    first_int8 = (load_first_int8(torch, opts.first_design_int8) if opts.first_design_int8
                  else None)
    first_warp = (load_first_warp(torch, opts.first_design_warp) if opts.first_design_warp
                  else None)
    first_nms = load_first_nms(torch, opts.first_design_nms) if opts.first_design_nms else None
    first_scale = (load_first_scale(torch, opts.first_design_scale) if opts.first_design_scale
                   else None)
    if opts.ablate:
        ablate(torch, ms, kbuild, first)
        log(card)
        return 0

    # Each phase's wall seconds, logged as it ends.
    phase_s, t_phase = {}, [t_script]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - t_phase[0]
        t_phase[0] = now
        log(f"phase {name}: {phase_s[name]:.1f} s wall")

    phase_done("1-2 (card, build)")

    # Phase 3: the mask-stats kernels and kernel D against their plain versions.
    log("kernel checks against the plain versions:")
    errs = check_kernels(torch, ms)
    nms_clusters = check_nms(torch)
    phase_done("3 (kernels against their plain versions)")

    # Phase 3b: the int8 calibrations, the CLI runs and trainings, two gloo
    # ranks and calibrate_offsets, each in processes of its own, side by side.
    log("the checks in processes of their own, side by side (nothing timed meanwhile):")
    side = check_side_by_side(torch)
    phase_done("3b (subprocess checks, side by side)")

    # Phases 4-5: the configurations through process_batch; each step's own
    # kernel inputs at batch 128 are kept for phase 9.
    head_hw, head_ckpt = (1080, 1920), "yolov8n_textile.msgpack"
    dep, dep_launches, _ = check_step(
        torch, ms, wp, "deploy step (960x1280, imgsz 960, stride-2 soft)", (960, 1280), 960,
        "yolov8n_textile_cam.msgpack", ("mask_stats_soft",))
    dep_time, (dep_args, dep_nms) = time_step(torch, ms, dep, "deploy", (960, 1280), iters=10,
                                              p50_iters=30)
    del dep
    torch.cuda.empty_cache()
    head, head_launches, got_e = check_step(
        torch, ms, wp, "headline step (1080x1920, imgsz 640, stride-4 binary)", head_hw, 640,
        head_ckpt, ("mask_stats_binary",), batch=BATCH)
    # Phase 3 again, for kernel C, with the headline warp's own weights.
    errs["warp_pass1_decimated"] = check_warp_p1(torch, wp, head.warp, head.spec, first_warp)
    torch.cuda.empty_cache()
    head_time, (head_args, head_nms) = time_step(torch, ms, head, "headline", head_hw)
    if first_nms is not None:  # phase 3 again, for kernel D's first design
        check_first_nms(torch, first_nms, dep_nms, "deploy")
        check_first_nms(torch, first_nms, head_nms, "headline")

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
    jit_division = check_jit_division(torch)

    phase_done("4-5 (the steps)")

    # Phase 5b: the step's opt-in modes at full width.
    log("the step's modes (each against its reference step, bf16 and float32):")
    modes = check_modes(torch, ms, wp)
    phase_done("5b (modes)")

    # Phase 5c: int8 inference at full width (kernels E and F).
    log("int8 inference (kernels E and F; CUDA events, L2 flushed before each timed call):")
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = lambda: flush_buf.zero_()
    int8 = check_int8(torch, ms, wp, ik, flush, first_int8, first_scale)
    phase_done("5c (int8)")

    # Phase 5j: kernel G, the float convolutions' bias and SiLU.
    log("kernel G (the float convolutions' bias and SiLU; CUDA events, L2 flushed):")
    epilogue = check_epilogue(torch, ce, flush)
    phase_done("5j (kernel G)")

    # Phase 5d: the frozen step, exported, saved, loaded and run on the card.
    log("the frozen step (torch.export through the kernels' operators):")
    frozen = check_frozen(torch, ms, wp, ik)
    frozen_launches = {tag: v["launches"] for tag, v in frozen.items()
                       if isinstance(v, dict) and "launches" in v}
    log(card)
    phase_done("5d (frozen step)")

    # Phase 5e: data-parallel, on the one card.
    log("data-parallel (tti_torch.parallel: a one-rank NCCL mesh; two gloo ranks and cli train "
        "with the TTI_* triple ran in phase 3b):")
    data_parallel = check_data_parallel(torch, ms, wp, card)
    mesh_launches = {**{tag: v["launches"] for tag, v in data_parallel["steps"].items()},
                     "dual": data_parallel["dual"]["launches"]}
    phase_done("5e (data-parallel)")

    # Phase 5f: spatial partitioning, on the one card.
    log("spatial partitioning (a (data, space) mesh: a one-rank NCCL job, then two gloo ranks "
        "sharing the card):")
    space = check_space(torch, ms, wp, card)
    space_launches = {tag: run["launches"]
                      for tag, run in space["gloo_2"]["ranks"][0]["runs"].items()}
    phase_done("5f (space)")

    # Phase 5g: tune-device and the card-timing tools, each in a subprocess,
    # beside phase 5i's bench process.
    log("the tools that time the card (tune-device, profile_forward, profile_train, "
        "host_overhead; phase 5i's bench started beside them):")
    bench_started = start_bench()
    tools = check_tools(card)
    phase_done("5g (tools)")

    # Phase 5h: __graft_entry__.py's forward chain and tti's public helpers.
    log("__graft_entry__.py's forward chain (kernel D) and tti's public helpers on the card:")
    entry_helpers = check_entry_helpers(torch, ms, wp, head, card)
    phase_done("5h (entry chain, helpers)")

    # Phase 5i: python -m tti_torch.cli bench, in the subprocess started in 5g.
    log("python -m tti_torch.cli bench (bench_torch.py: bench.py's rows, the dual step and "
        "four streams):")
    bench_run = check_bench(card, bench_started)
    bench_run["readme"] = check_regen_docs(card, bench_run["rows"])
    phase_done("5i (bench)")

    # Phase 6: training.
    training = check_training(torch, ms, wp, card)
    phase_done("6 (training)")

    # Phase 7: the application, ``run`` and ``eval``.
    application = check_application(torch, ms, wp, dep_time["p50_ms"])
    log(card)
    phase_done("7 (application)")

    # Phase 8: calibrate, then measure, at the deployed geometry.
    calibrated = check_calibrate_measure(torch, ms, wp)
    phase_done("8 (calibrate, then measure)")

    # Phase 9: kernel timings, on each step's own inputs (the kernels line)
    # and, for the mask statistics, on a synthetic input whose first box
    # covers the whole grid.
    log("kernel timings (CUDA events, L2 flushed before each call):")
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
    c = time_warp_p1(torch, wp, head_k, head_hw, flush, first_warp)
    kernels.append({
        "name": "warp_pass1_decimated", "route": "cuda",
        "source": "tti_torch/kernels/csrc/warp_p1.cu", "replaces": "tti/kernels/warp_p1.py:64",
        "launches": k_launches["warp_pass1_decimated"],
        "max_abs_err": errs["warp_pass1_decimated"]["max_abs_err"],
        "max_rel_err": errs["warp_pass1_decimated"]["max_rel_err"],
        "ms": c[BATCH]["ms"], "plain_ms": c[BATCH]["plain_ms"], "bound_ms": c[BATCH]["bound_ms"],
        "bound_by": c[BATCH]["bound_by"], "library_ms": None,
        "bound_dense_ms": c[BATCH]["bound_dense_ms"],
        "live_tile_share": c[BATCH]["live_tile_share"],
        "nonzero_share": c[BATCH]["nonzero_share"],
        "unfused_ms": c[BATCH]["unfused_ms"], "timed_on": "the headline step's frames",
        "timed_shape": c[BATCH]["shape"],
        "pass2_from_ycbo_ms": c[BATCH]["pass2_from_ycbo_ms"],
        "pass2_from_byoc_ms": c[BATCH]["pass2_from_byoc_ms"],
        **({k: c[BATCH][k] for k in ("first_design_ms", "ms_again")} if first_warp else {}),
        # The headline step at batch 128, frames/s: each route timed alone
        # (phase 5) and the two in turns (einsum, kernel, kernel, einsum).
        "step_frames_per_s": {
            "kernel_route_alone": head_k_time["frames_per_s"],
            "einsum_alone": head_time["frames_per_s"],
            "kernel_route_in_turns": route["turns_vs_einsum"]["frames_per_s"],
            "einsum_in_turns": route["turns_vs_einsum"]["ref_frames_per_s"]},
        "batch_1": {k: c[1][k] for k in ("ms", "plain_ms", "unfused_ms", "bound_ms", "bound_by",
                                         "bound_dense_ms", "pass2_from_ycbo_ms",
                                         "pass2_from_byoc_ms", "first_design_ms", "ms_again")
                    if k in c[1]},
    })
    d_times = {}
    for config, cands in (("deploy", dep_nms), ("headline", head_nms)):
        for b, args in cands.items():
            d_times[(config, b)] = t = time_nms(torch, args, flush, first_nms)
            log_nms_time(f"the {config} step's candidates at batch {b}", t)
    for k in (512, 1000, 2048):  # larger K than the steps': seeded candidates
        for b in (BATCH, 1):
            d_times[(f"seeded K={k}", b)] = t = time_nms(
                torch, (*nms_problem(torch, b, k, seed=k), 0.25, True), flush, first_nms,
                plain=False)
            log_nms_time(f"seeded candidates at batch {b}", t)
    d = d_times[("headline", BATCH)]
    errs["greedy_keep"] = nms_errors()
    log(f"  greedy_keep against the plain version over this run's cases: "
        f"{errs['greedy_keep']['mismatched_keep_bits']} of "
        f"{errs['greedy_keep']['compared_keep_bits']} keep bits differ")
    kernels.append({
        "name": "greedy_keep", "route": "cuda", "source": "tti_torch/kernels/csrc/nms.cu",
        "replaces": "tti/postprocess/nms.py:70",
        "launches": head_launches["greedy_keep"],
        "max_abs_err": errs["greedy_keep"]["max_abs_err"],
        "max_rel_err": errs["greedy_keep"]["max_rel_err"],
        "mismatched_keep_bits": errs["greedy_keep"]["mismatched_keep_bits"],
        "compared_keep_bits": errs["greedy_keep"]["compared_keep_bits"],
        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": None,
        "timed_on": "the headline step's candidates", "timed_shape": d["shape"],
        "cluster": d["cluster"], "empty_ms": d["empty_ms"],
        **({k: d[k] for k in ("first_design_ms", "ms_again")} if first_nms else {}),
        "cluster_per_b_k": nms_clusters,
        "dual_launches": dual["greedy_keep_launches"],
        "entry_chain_launches": {b: v["greedy_keep_launches"]
                                 for b, v in entry_helpers["entry"].items()},
        "other_inputs": {f"{c} batch {b}": {k: t[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "shape", "cluster", "empty_ms",
            "first_design_ms", "ms_again") if k in t}
            for (c, b), t in d_times.items() if (c, b) != ("headline", BATCH)},
    })
    del dep_nms, head_nms
    e, f, dep8 = int8["timing"]["row"], int8["timing"]["f"], int8["deploy int8"]
    kernels.append({
        "name": "int8_conv2d", "route": "cuda", "source": "tti_torch/kernels/csrc/int8conv.cu",
        "replaces": "tti/model/layers.py:106", "launches": dep8["launches"]["int8_conv2d"],
        "max_abs_err": INT8_TALLY["max_abs_err"], "max_ulp_after_silu": INT8_TALLY["max_ulp"],
        "calls_compared": INT8_TALLY["calls"],
        "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
        "bound_by": e["bound_by"], "library_ms": e["int_mm_ms"],
        "library": "torch._int_mm, the integer product alone", "cudnn_bf16_ms": e["cudnn_bf16_ms"],
        "timed_on": f"the deploy int8 step's block {e['block']} at batch {BATCH}",
        "timed_shape": e["shape"], "ms_per_step": dep8["e_ms_per_step"],
        "per_step_ms": int8["blocks"]["per_step_ms"],
        "per_step_bound_ms": int8["blocks"]["per_step_bound_ms"],
        "headline_per_step_bound_ms": int8["headline int8"]["e_bound_ms_per_step"],
        **({"first_design_per_step_ms": int8["blocks"]["per_step_first_design_ms"],
            "first_design_ms_per_step": dep8["first_design_e_ms_per_step"],
            "ms_per_step_again": dep8["e_ms_per_step_again"]} if first_int8 else {}),
        "launches_per_step": {k: v["launches"]["int8_conv2d"] for k, v in int8.items()
                              if isinstance(v, dict) and "launches" in v},
        "other_blocks": [{k: t[k] for k in ("block", "shape", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "cudnn_bf16_ms", "int_mm_ms")}
                         for t in int8["timing"]["layers"] if t is not e],
    })
    kernels.append({
        "name": "act_scale_per_sample", "route": "cuda",
        "source": "tti_torch/kernels/csrc/int8conv.cu", "replaces": "tti/model/layers.py:26",
        "launches": dep8["launches"]["act_scale_per_sample"],
        "max_abs_err": INT8_TALLY["f_max_abs_err"], "calls_compared": INT8_TALLY["f_calls"],
        "scales_compared": INT8_TALLY["f_values"],
        "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
        "bound_by": f["bound_by"], "library_ms": None, "absmax_norm_ms": f["absmax_norm_ms"],
        "timed_on": f"the deploy int8 step's block {f['block']} input at batch {BATCH}",
        "timed_shape": f["shape"], "ms_per_step": dep8["f_ms_per_step"],
        "per_step_ms": int8["scale"]["per_step_ms"],
        "per_step_bound_ms": int8["scale"]["per_step_bound_ms"],
        "per_step_absmax_norm_ms": int8["scale"]["per_step_absmax_norm_ms"],
        "routes": {r: sum(t["inputs"] for t in int8["scale"]["inputs"] if t["route"] == r)
                   for r in ("span", "grid")},
        "inputs": [{k: t[k] for k in ("block", "shape", "inputs", "route", "vec", "cluster", "ms",
                                      "bound_ms", "absmax_norm_ms", "first_design_ms") if k in t}
                   for t in int8["scale"]["inputs"]],
        "synthetic_routes": {k: list(v) for k, v in int8["synthetic"]["scale_routes"].items()},
        **({"first_design_per_step_ms": int8["scale"]["per_step_first_design_ms"],
            "first_design_ms_per_step": dep8["first_design_f_ms_per_step"],
            "ms_per_step_again": dep8["f_ms_per_step_again"]} if first_scale else {}),
        "launches_per_step": {k: v["launches"]["act_scale_per_sample"]
                              for k, v in int8.items() if isinstance(v, dict) and "launches" in v},
    })
    for k in kernels:  # every kernel is an operator: its launches per frozen call, host cost
        k["frozen_launches"] = {tag: n.get(k["name"], 0) for tag, n in frozen_launches.items()}
        k["host_us_per_call"] = frozen["host_us_per_call"].get(k["name"])
        # Launches per mesh step (phase 5e), by configuration: the one-card step's.
        k["mesh_launches"] = {tag: n.get(k["name"], 0) for tag, n in mesh_launches.items()}
        # Launches per rank and step of the space step (phase 5f, two ranks).
        k["space_launches"] = {tag: n.get(k["name"], 0) for tag, n in space_launches.items()}
        # Launches in phase 5i's bench process (TTI_BENCH_CONFIGS=all).
        k["bench_launches"] = bench_run["launches"].get(k["name"], 0)
    # Kernel G's row, after the loop above: phases 5d-5i count kernels A-F only.
    g = epilogue["per_step"]
    kernels.append({
        "name": "bias_act", "route": "cuda", "source": "tti_torch/kernels/csrc/conv_epilogue.cu",
        "replaces": "none (tti leaves the bias and SiLU to XLA's fusion)",
        "launches": epilogue["launches"],
        "differing_elements": epilogue["differing_elements"],
        "compared_elements": epilogue["compared_elements"],
        "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"], "bound_by": "bytes",
        "library_ms": g["library_ms"],
        "library": "the parent route: cuDNN's in-place bias add, then F.silu",
        "timed_on": f"the deploy step's {EPILOGUES} epilogues at batch {BATCH}, summed",
        "step_profiled_ms": epilogue["step_profiled_ms"],
        "launches_per_step": {"deploy": epilogue["launches"],
                              **{k: v["launches"]["bias_act"] for k, v in int8.items()
                                 if isinstance(v, dict) and "launches" in v}},
        "epilogues": epilogue["rows"],
    })
    phase_done("9 (kernel timings)")
    log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s (its limit: 1200 s)")
    log(json.dumps({"card": card, "steps": {
        "deploy": dep_time, "headline": head_time, "headline_kernel_route": head_k_time,
        "kernel_route_vs_einsum": route, "packed": packed, "dual": dual, "streams": streams,
        "jit_division": jit_division, "modes": modes, "int8": int8, "frozen": frozen, "data_parallel": data_parallel,
        "space": space, "tools": tools, "entry_helpers": entry_helpers, "bench": bench_run,
        "side_by_side": side},
        "training": training, "application": application, "calibrate_measure": calibrated,
        "phase_s": phase_s}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
