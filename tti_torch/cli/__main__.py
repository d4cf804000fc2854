"""Command line of the port: ``python -m tti_torch.cli <command>``.

    calibrate        the extrinsic ChArUco calibration on the camera [--solver tti|cv2]
    calibrate-intrinsics
                     intrinsics from board views [--images DIR] [--out] [--max-views]
    run              the measurement loop [--images DIR | --synthetic]
                     [--cameras N] [--max-frames N] [--pipelined]
                     [--skip-calibration]
    check-model      annotated detection dump (JPEGs, needs cv2)
    eval             box and mask mAP on a YOLO-format dataset
    train            train a segmentation model on a YOLO-format dataset
    export-weights   the deploy msgpack + sidecar from a training checkpoint
    export           the frozen inspection step: torch.export programs + weights
                     in one artifact [--out] [--batch] [--platforms cuda,cpu]
    convert          an Ultralytics .pt -> a flax-layout msgpack checkpoint
    validate-reference
                     the reference's trained .pt end to end: convert, strict
                     structural check, parity and mm reports [, eval]
    capture          timed dataset capture from the camera [--out] [--interval]
    view             live camera view ('q' quits)
    tune-camera      exposure/brightness/contrast tuning [--set PROP=VALUE ...]
    tune-device      sweep the runtime switches on this card, write the winners as
                     .env lines (tools/tune_device_torch.py)
    bench            not ported yet: refused, naming its ROADMAP item

The flags are ``tti``'s, plus ``--device`` (default cuda; ``run``,
``check-model``, ``eval``, ``train``, ``export``, ``validate-reference``,
``tune-device``, which also takes the tool's ``--lat-iters``)
and ``--init`` (``train``: start from a deploy checkpoint's params and batch
stats). The calibration commands run
on the host (numpy and OpenCV) and take no ``--device``. ``run`` on a camera
first runs the startup calibration gate, as ``tti`` does, unless given
``--skip-calibration``. Configuration comes from the environment and ``.env``
as in ``tti`` (:func:`tti_torch.core.config.load_config`); ``run`` and
``check-model`` build their step under ``tti``'s runtime switches
(``TTI_REMAP``, ``TTI_WARP_S2D``, ``TTI_WARP_BLOCKED``, ``TTI_WARP_COLEXPAND``,
``TTI_LAZY_DECODE``, ``TTI_FUSED_HEAD``, ``TTI_FOLDED_BN``,
``TTI_MASKSTATS_LOGITS``, ``TTI_QUANT``, ``TTI_QUANT_SCALES``;
:class:`tti_torch.core.config.RuntimeSwitches`), read from the environment
and ``.env`` alike, and log once each switch of ``tti``'s that has no
counterpart here. ``eval`` serves ``TTI_QUANT=int8`` / ``int8s`` as ``tti``
does (the plain-stem folded model, quantized). A ``TTI_QUANT`` that cannot
apply is refused with ``tti``'s message (another value, unfolded BN, the
fused head, ``int8s`` without its scales file). ``export`` writes the
port's own artifact (:mod:`tti_torch.app.export`; ``--platforms`` defaults to
``cuda,cpu``), which ``tti`` does not load, nor the port ``tti``'s.
``train --host-aug`` trains on the reference's host recipe
(:func:`tti_torch.train.data.batches`) and refuses ``--resume`` as ``tti``
does. ``capture``, ``view`` and ``tune-camera`` are host OpenCV tools on the
camera and touch no device. Refused, naming the reason or the ROADMAP item
that ports them: ``bench`` and ``TTI_APPROX_TOPK=1``.
Before every command, as ``tti`` does, the
process joins the multi-host job of ``TTI_COORDINATOR`` (with
``TTI_NUM_PROCESSES`` and ``TTI_PROCESS_ID``;
:func:`tti_torch.parallel.dcn.init_distributed`, NCCL for ``--device cuda``,
gloo otherwise) as its host's one process, on card 0; ``train`` instead
starts one process per local card when the host has more than one, each
joining under the global numbering (:func:`tti_torch.train.loop.train`),
and trains data-parallel over every rank with ``--batch-size`` as the
global batch. Only rank 0 of ``train`` prints and writes checkpoints.
``train`` reads ``tti``'s trainer switches ``TTI_SEG_DTYPE``,
``TTI_SEG_CHUNK`` and ``TTI_AUGMENT_DTYPE`` from the process environment
(:func:`tti_torch.train.loop.train_switches`); ``TTI_READOUT_CAL=0`` drops
the sidecar's readout offsets
(:meth:`tti_torch.core.config.MeasureConfig.with_subcell_from`).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from tti_torch.core.config import (
    APPROX_TOPK_REFUSAL, AppConfig, check_process_switches, load_config,
)
from tti_torch.core.errors import ConfigError
from tti_torch.core.logging import get_logger
from tti_torch.parallel import dcn

log = get_logger("cli")


def _refuse(message: str) -> int:
    print(message, file=sys.stderr)
    return 1


def _refuses_switches(switches) -> bool:
    """``TTI_APPROX_TOPK=1``, refused before anything is built (a
    ``TTI_QUANT`` that cannot apply is refused where the step is built:
    :func:`main`)."""
    if switches.approx_topk:
        _refuse(APPROX_TOPK_REFUSAL)
        return True
    return False


def _log_no_counterpart(names) -> None:
    """Say that each set ``tti`` switch of ``names`` has no counterpart here:
    the process-level ones before every command, the step's once per step
    built (``run`` and ``check-model`` build one)."""
    from tti_torch.core.config import NO_COUNTERPART

    for name in names:
        log.info("%s has no counterpart in tti_torch and is not read: %s", name,
                 NO_COUNTERPART[name])


def _random_variables(model_cfg) -> dict:
    """A fresh model's flax tree (seed 0), for runs without a checkpoint."""
    import torch

    from tti_torch.model.checkpoint import to_flax_variables
    from tti_torch.model.yolo import init_model

    model = init_model(model_cfg.variant, model_cfg.num_classes, model_cfg.mask_stride,
                       model_cfg.proto_head, generator=torch.Generator().manual_seed(0))
    return to_flax_variables(model.state_dict())


def _adopt_architecture(model_cfg, meta: dict):
    """The checkpoint sidecar is authoritative about the architecture it was
    trained with (variant, num_classes, mask_stride, proto_head)."""
    arch = {k: meta[k] for k in ("variant", "num_classes", "mask_stride", "proto_head")
            if k in meta}
    drift = {k: getattr(model_cfg, k) for k, v in arch.items() if getattr(model_cfg, k) != v}
    if drift:
        log.info("adopting checkpoint architecture %s (config had %s)", arch, drift)
    return dataclasses.replace(model_cfg, **arch)


def load_pipeline(cfg: AppConfig, frame_hw: tuple[int, int], calibration=None,
                  device: str = "cuda", return_masks: bool = False):
    """The inspection step for ``cfg`` (``tti``'s ``_load_pipeline``): the
    checkpoint ``cfg.model.weights`` with its sidecar's architecture and
    readout (``MeasureConfig.with_subcell_from``), or a random model when the
    file does not exist, built under ``cfg.switches``."""
    from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
    from tti_torch.parallel.runtime import InspectionPipeline

    weights = cfg.model.weights
    if weights and os.path.exists(weights):
        meta = checkpoint_metadata(weights)
        measure = cfg.measure.with_subcell_from(meta)
        if measure.subcell_edge:
            log.info("soft-mask checkpoint: sub-cell boundary readout on "
                     "(TTI_SUBCELL_EDGE=0 forces binary)")
        cfg = cfg.replace(model=_adopt_architecture(cfg.model, meta), measure=measure)
        variables = load_flax_msgpack(weights)
        log.info("loaded weights from %s", weights)
    else:
        log.warning("weights %r not found — using random init", weights)
        variables = _random_variables(cfg.model)
    _log_no_counterpart(cfg.switches.no_counterpart)
    return InspectionPipeline(cfg.model, variables, frame_hw, calibration=calibration,
                              measure_cfg=cfg.measure, roi=cfg.roi, device=device,
                              return_masks=return_masks, **cfg.switches.pipeline_kwargs())


def _load_calibration(cfg: AppConfig):
    from tti_torch.calib.io import CalibrationData

    rt = cfg.runtime
    if os.path.exists(rt.intrinsics_file) and os.path.exists(rt.extrinsics_file):
        return CalibrationData.load(rt.intrinsics_file, rt.extrinsics_file)
    return None


def _probe_hw(source) -> tuple[int, int]:
    ok, frame = source.read()
    if not ok:
        raise RuntimeError("source produced no frames")
    source._idx = 0  # rewind DirectorySource
    return frame.shape[:2]


def cmd_calibrate(args) -> int:
    """The extrinsic ChArUco calibration on the camera (the startup gate)."""
    from tti_torch.app.orchestrator import run_startup_calibration
    from tti_torch.app.sources import OpenCVCameraSource

    cfg = load_config()
    source = OpenCVCameraSource(cfg.camera)
    try:
        ok = run_startup_calibration(cfg, source, solver=args.solver)
    finally:
        source.release()
    print("RESULT:", "SUCCESS" if ok else "FAILED")
    return 0 if ok else 1


def cmd_calibrate_intrinsics(args) -> int:
    """Intrinsic calibration from the camera or an image directory."""
    from tti_torch.app.sources import DirectorySource, OpenCVCameraSource, frames_iter
    from tti_torch.calib.charuco import create_charuco_board
    from tti_torch.calib.intrinsics import calibrate_intrinsics

    cfg = load_config(validate=False)
    source = DirectorySource(args.images) if args.images else OpenCVCameraSource(cfg.camera)
    board = create_charuco_board(cfg.board)
    try:
        result = calibrate_intrinsics(frames_iter(source), board=board,
                                      output_path=args.out, max_views=args.max_views)
    finally:
        source.release()
    print(f"RESULT: rms={result.rms:.3f}px views={result.n_views} -> {args.out}")
    return 0


def cmd_run(args) -> int:
    """The measurement loop (the reference's ``python main.py``)."""
    from tti_torch.app.orchestrator import Orchestrator, run_startup_calibration
    from tti_torch.app.sources import DirectorySource, OpenCVCameraSource, SyntheticSource

    cfg = load_config(validate=not args.no_validate)
    if _refuses_switches(cfg.switches):
        return 1
    if args.cameras and args.cameras > 1:
        return _run_multistream(args, cfg)
    if args.images:
        source = DirectorySource(args.images, loop=args.loop)
        frame_hw = _probe_hw(source)
    elif args.synthetic:
        # Unbounded: the loop's own frame counter ends a bounded run.
        source = SyntheticSource(cfg.camera.height, cfg.camera.width)
        frame_hw = (cfg.camera.height, cfg.camera.width)
    else:
        source = OpenCVCameraSource(cfg.camera)
        frame_hw = (cfg.camera.height, cfg.camera.width)
        if not args.skip_calibration and not run_startup_calibration(cfg, source):
            return 1

    calibration = _load_calibration(cfg)
    if calibration is None:
        log.warning("calibration files missing — running detection-only")
    pipeline = load_pipeline(cfg, frame_hw, calibration, device=args.device)
    orch = Orchestrator(cfg, pipeline, source, show=args.show)
    orch.init_services()
    orch.run(max_frames=args.max_frames, pipelined=args.pipelined)
    return 0


def _run_multistream(args, cfg: AppConfig) -> int:
    """Several cameras through one batched step, smoothing per stream;
    metrics are logged (the database schema has no stream id)."""
    import time

    from tti_torch.app.results import measurement_to_dict
    from tti_torch.app.sources import OpenCVCameraSource, SyntheticSource
    from tti_torch.parallel.streams import MultiStreamRunner

    n = args.cameras
    frame_hw = (cfg.camera.height, cfg.camera.width)
    if args.synthetic:
        sources = [SyntheticSource(*frame_hw, seed=i) for i in range(n)]
    else:
        sources = [OpenCVCameraSource(cfg.camera, index=f"/dev/video{i}") for i in range(n)]
    pipeline = load_pipeline(cfg, frame_hw, _load_calibration(cfg), device=args.device)
    runner = MultiStreamRunner(pipeline, sources, frame_hw)
    runner.start()
    batches = 0

    def report(outs, results) -> None:
        if results:
            for stream, meas in enumerate(results):
                d = measurement_to_dict(meas)
                log.info("stream %d: edge=%s width=%s n=%d", stream,
                         d["edge_distance_mm"], d["stitch_width_mm"], d["stitch_count"])
        else:  # detection-only: per-stream counts, so a bounded run is not silent
            for stream in range(len(sources)):
                log.info("stream %d: %d detections", stream, int(outs.valid[stream].sum()))

    try:
        if not runner.wait_for_frames():
            log.error("streams produced no frames")
            return 1
        # Dispatches count against --max-frames: each step_pipelined() puts
        # one batch in flight and flush() reports the last one.
        dispatched = 0
        while args.max_frames is None or dispatched < args.max_frames:
            stepped = runner.step_pipelined()
            dispatched += 1
            if stepped is not None:
                report(*stepped)
                batches += 1
            time.sleep(cfg.runtime.inference_interval_s)
    except KeyboardInterrupt:
        pass
    finally:
        drained = runner.flush()
        if drained is not None:
            report(*drained)
            batches += 1
        runner.stop()
        log.info("multistream shutdown: %d batches x %d streams", batches, len(sources))
    return 0


def cmd_check_model(args) -> int:
    """Headless segmentation check with annotated JPEG dumps."""
    cfg = load_config(validate=False)
    if _refuses_switches(cfg.switches):
        return 1
    try:
        import cv2
    except ImportError:
        return _refuse("check-model writes JPEGs with OpenCV (cv2), which does not import here")
    from tti_torch.app.annotate import annotate_frame, overlay_masks
    from tti_torch.app.sources import DirectorySource, SyntheticSource

    if args.images:
        source = DirectorySource(args.images)
        frame_hw = _probe_hw(source)
    else:
        source = SyntheticSource(cfg.camera.height, cfg.camera.width, count=args.max_frames)
        frame_hw = (cfg.camera.height, cfg.camera.width)
    pipeline = load_pipeline(cfg, frame_hw, device=args.device, return_masks=True)
    os.makedirs(args.out, exist_ok=True)
    count = 0
    while count < args.max_frames:
        ok, frame = source.read()
        if not ok:
            break
        outs = pipeline.process_batch(frame[None])
        n = int(outs.valid[0].sum())
        annotated = frame
        if outs.masks is not None:
            annotated = overlay_masks(annotated, outs.masks[0], outs.classes[0], outs.valid[0],
                                      pipeline.spec)
        annotated = annotate_frame(annotated, outs.boxes_frame[0], outs.classes[0],
                                   outs.valid[0], cfg.model.stitch_class_id,
                                   cfg.model.fabric_class_id, hud_lines=[f"detections: {n}"])
        path = os.path.join(args.out, f"check_{count:05d}.jpg")
        cv2.imwrite(path, annotated)
        print(f"{path}: {n} detections")
        count += 1
    return 0


def cmd_eval(args) -> int:
    """Box mAP and mask mAP at the proto grid and at full resolution (the
    ``process_mask(upsample=True)`` masks against GT rasterised at imgsz) of
    a checkpoint on a YOLO-format dataset."""
    from tti_torch.app.predict import Predictor
    from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
    from tti_torch.train.data import discover_dataset
    from tti_torch.train.eval import evaluate_samples

    if args.imgsz % 32:
        # The rect letterbox rounds a non-stride size up while the GT
        # rasterises at args.imgsz: the mask grids would not match.
        raise SystemExit(f"--imgsz must be a multiple of 32, got {args.imgsz}")
    cfg = load_config(validate=False)
    quant = cfg.switches.quant
    model_cfg = dataclasses.replace(cfg.model, image_size=args.imgsz,
                                    mask_stride=args.mask_stride, proto_head=args.proto_head,
                                    **({"weights": args.weights} if args.weights else {}))
    have_weights = model_cfg.weights and os.path.exists(model_cfg.weights)
    if have_weights:
        model_cfg = _adopt_architecture(model_cfg, checkpoint_metadata(model_cfg.weights))
    if have_weights:
        variables = load_flax_msgpack(model_cfg.weights)
        log.info("loaded weights from %s", model_cfg.weights)
    else:
        log.warning("weights %r not found — using random init", model_cfg.weights)
        variables = _random_variables(model_cfg)
    predictor = Predictor(model_cfg, variables, (args.imgsz, args.imgsz), mask_topk=64,
                          proto_masks=True, device=args.device, quant=quant,
                          quant_scales=cfg.switches.quant_scales)
    if quant:
        log.info("evaluating with TTI_QUANT=%s (W8A8 PTQ)", quant)
    samples = discover_dataset(args.images)
    res = evaluate_samples(samples, predictor, args.imgsz, model_cfg.num_classes,
                           model_cfg.mask_stride, progress=lambda line: print(line, flush=True))
    for label, key in (("box", "box"), ("mask(proto-res)", "mask_proto"),
                       ("mask(full-res)", "mask_full")):
        print(f"{label}:", {k: round(v, 4) for k, v in res[key].items()})
    return 0


def cmd_train(args) -> int:
    from tti_torch.train.data import discover_dataset
    from tti_torch.train.loop import HOST_AUG_RESUME, train

    if args.resume and args.host_aug:
        print(HOST_AUG_RESUME)
        return 1
    path = train(discover_dataset(args.images), args.out, variant=args.variant,
                 num_classes=args.num_classes, imgsz=args.imgsz, batch_size=args.batch_size,
                 epochs=args.epochs, lr=args.lr, max_gt=args.max_gt, log_every=args.log_every,
                 checkpoint_every=args.checkpoint_every, resume=args.resume,
                 mask_stride=args.mask_stride, proto_head=args.proto_head,
                 stitch_seg_gain=args.stitch_seg_gain, soft_masks=args.soft_masks,
                 dtype=args.dtype, device=args.device, init=args.init,
                 host_aug=args.host_aug, log=lambda line: print(line, flush=True))
    if dcn.rank() == 0:
        print("final checkpoint:", path)
    return 0


def cmd_capture(args) -> int:
    """Timed dataset capture (reference: Utils/auto_capture.py)."""
    import time

    import cv2

    from tti_torch.app.sources import OpenCVCameraSource

    cfg = load_config(validate=False)
    source = OpenCVCameraSource(cfg.camera)
    os.makedirs(args.out, exist_ok=True)
    count = 0
    try:
        while count < args.max_frames:
            ok, frame = source.read()
            if not ok:
                continue
            path = os.path.join(args.out, f"capture_{count:05d}.jpg")
            cv2.imwrite(path, frame)
            print("saved", path)
            count += 1
            time.sleep(args.interval)
    finally:
        source.release()
    return 0


def _show_loop(source, window: str, on_no_frame: str = "break") -> int:
    """The read / imshow / 'q' loop of the live-view tools. ``on_no_frame``:
    "break" ends on the first failed read (reference Utils/usb_camera.py),
    "skip" keeps polling (the tuning tool)."""
    import cv2

    try:
        while True:
            ok, frame = source.read()
            if ok:
                cv2.imshow(window, frame)
            elif on_no_frame == "break":
                log.error("no frame from camera")
                return 1
            if cv2.waitKey(1) & 0xFF == ord("q"):
                return 0
    except KeyboardInterrupt:
        return 0
    finally:
        source.release()
        cv2.destroyAllWindows()


def cmd_view(args) -> int:
    """Live camera view (reference: Utils/usb_camera.py). 'q' quits."""
    from tti_torch.app.sources import OpenCVCameraSource

    cfg = load_config(validate=False)
    return _show_loop(OpenCVCameraSource(cfg.camera), "tti view (q to quit)")


def cmd_tune_camera(args) -> int:
    """Interactive exposure/brightness/contrast tuning (reference:
    Testing/test1.py's trackbar tool); ``--set`` applies values without a
    window."""
    import cv2

    from tti_torch.app.sources import OpenCVCameraSource

    cfg = load_config(validate=False)
    source = OpenCVCameraSource(cfg.camera)
    cap = source.cap
    props = {
        "exposure": cv2.CAP_PROP_EXPOSURE,
        "brightness": cv2.CAP_PROP_BRIGHTNESS,
        "contrast": cv2.CAP_PROP_CONTRAST,
        "gain": cv2.CAP_PROP_GAIN,
    }
    try:
        if args.set:
            for assignment in args.set:
                key, _, value = assignment.partition("=")
                if key not in props:
                    print(f"unknown property {key!r}; choose from {sorted(props)}")
                    return 1
                cap.set(props[key], float(value))
                print(f"{key} = {cap.get(props[key])}")
            return 0
        window = "tti tune-camera (q to quit)"
        cv2.namedWindow(window)
        for name, prop in props.items():
            current = int(max(0, cap.get(prop)))
            cv2.createTrackbar(name, window, current, 255,
                               lambda v, p=prop: cap.set(p, float(v)))
        # Exposure changes often stall a read or two: keep polling.
        return _show_loop(source, window, on_no_frame="skip")
    finally:
        source.release()  # the --set return; a second release is harmless


def cmd_bench(args) -> int:
    return _refuse("bench is not ported yet: the port's bench script (bench_torch.py, both "
                   "configurations timed in repeated pairs) is ROADMAP Queue 1 item 1. "
                   "python3 chip_smoke.py times the steps on the card meanwhile.")


def cmd_tune_device(args) -> int:
    """Sweep the runtime switches on this card and geometry and write the
    winning configuration as .env lines (``tools/tune_device_torch.py``),
    with ``tti``'s arguments plus ``--device``."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if root not in sys.path:
        sys.path.insert(0, root)
    from tools.tune_device_torch import main as tune_main

    argv = ["--batches", args.batches, "--imgsz", str(args.imgsz),
            "--frame-h", str(args.frame_h), "--frame-w", str(args.frame_w),
            "--variant", args.variant, "--dtype", args.dtype,
            "--iters", str(args.iters), "--out", args.out,
            "--mask-stride", str(args.mask_stride),
            "--proto-head", args.proto_head]
    if args.trials:
        argv += ["--trials", args.trials]
    if args.allow_approx:
        argv.append("--allow-approx")
    if args.subcell:
        argv.append("--subcell")
    if args.int8_scales:
        argv += ["--int8-scales", args.int8_scales]
    if args.lat_iters is not None:
        argv += ["--lat-iters", str(args.lat_iters)]
    tune_main(argv + ["--device", args.device])
    return 0


def cmd_export_weights(args) -> int:
    from tti_torch.train.loop import export_weights

    export_weights(args.train_dir, args.out, variant=args.variant, num_classes=args.num_classes,
                   imgsz=args.imgsz, mask_stride=args.mask_stride, proto_head=args.proto_head,
                   soft_masks=args.soft_masks, recipe=args.recipe)
    print("deploy checkpoint:", args.out)
    print("sidecar:", args.out + ".json")
    return 0


def cmd_export(args) -> int:
    """Freeze the whole inspection step (preprocess, model, NMS, mask
    statistics, measurement) into one artifact: a torch.export program per
    platform and the weights (:func:`tti_torch.app.export.export_pipeline`)."""
    import torch

    from tti_torch.app.export import SUFFIX, export_pipeline

    out = args.out or "tti_pipeline" + SUFFIX
    cfg = load_config(validate=False)
    if _refuses_switches(cfg.switches):
        return 1
    platforms = tuple(args.platforms.split(","))
    if "cuda" in platforms and not torch.cuda.is_available():
        return _refuse("export --platforms names cuda, but no CUDA device is available "
                       "(--platforms cpu --device cpu exports for the host alone)")
    frame_hw = (cfg.camera.height, cfg.camera.width)
    calibration = _load_calibration(cfg)
    if calibration is None:
        log.warning("calibration files missing — exporting detection-only")
    pipeline = load_pipeline(cfg, frame_hw, calibration, device=args.device)
    export_pipeline(pipeline, batch=args.batch, platforms=platforms, out=out)
    print(f"exported batch={args.batch} frames={frame_hw} platforms={','.join(platforms)} "
          f"-> {out} ({os.path.getsize(out)} bytes)")
    return 0


def _load_state_dict(path: str) -> dict:
    """The state dict inside a ``.pt``: the file itself, a module's, or the
    one under ``model`` / ``ema`` / ``state_dict`` (Ultralytics checkpoints
    keep the model under ``model``)."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        return obj.state_dict()
    if isinstance(obj, dict):
        for key in ("model", "ema", "state_dict"):
            if key in obj:
                inner = obj[key]
                return inner.state_dict() if hasattr(inner, "state_dict") else inner
    return obj


def cmd_convert(args) -> int:
    """An Ultralytics ``.pt`` -> a flax-layout msgpack checkpoint."""
    from tti_torch.model.checkpoint import save_flax_msgpack
    from tti_torch.model.convert import convert_torch_state_dict

    variables = convert_torch_state_dict(_load_state_dict(args.pt))
    save_flax_msgpack(variables, args.out, metadata={"source": args.pt})
    print("wrote", args.out)
    return 0


def cmd_validate_reference(args) -> int:
    """The reference's trained weights (``best_Model.pt``,
    ``single_needle_model.pt``; reference config.py:67, measurement.py:145)
    end to end, as ``tti validate-reference``: convert -> the strict
    structural check against the port's own model, both ways
    (``load_report.json``) -> the checkpoint and its sidecar -> the parity
    report against the torch oracle at the deployment geometry and the mm
    report -> the optional mAP eval. Everything lands in ``--out-dir``."""
    import json

    import numpy as np

    from tti_torch.model.checkpoint import save_flax_msgpack, to_flax_variables
    from tti_torch.model.convert import convert_torch_state_dict, verify_tree_shapes
    from tti_torch.model.yolo import create_model, model_channels

    os.makedirs(args.out_dir, exist_ok=True)
    state_dict = _load_state_dict(args.pt)
    variables = convert_torch_state_dict(state_dict)
    # The architecture from the converted tree (a .pt carries no sidecar):
    # the width from m1's output channels, the classes from the class
    # branch's exit bias. Ultralytics heads are always proto stride 4.
    try:
        c128 = int(np.shape(variables["params"]["m1"]["conv"]["kernel"])[-1])
        nc = int(np.shape(variables["params"]["m22"]["cv3_0_2"]["bias"])[0])
    except KeyError as e:
        print(f"FAIL: converted tree is missing {e} — not an Ultralytics YOLOv8-seg state dict?")
        return 1
    variant = next((v for v in ("n", "s", "m", "l", "x") if model_channels(v)["c128"] == c128),
                   None)
    if variant is None:
        print(f"FAIL: no YOLOv8 variant has width {c128} at m1")
        return 1
    print(f"architecture: yolov8{variant}-seg, {nc} classes")

    template = to_flax_variables(create_model(variant, nc=nc, s2d_stem=False,
                                              folded_bn=False).state_dict())
    problems = [p for coll in ("params", "batch_stats")
                for p in verify_tree_shapes(variables.get(coll, {}), template[coll], path=coll)]
    report = {"source_pt": args.pt, "torch_keys": len(state_dict), "variant": variant,
              "num_classes": nc, "strict_load_problems": problems}
    with open(os.path.join(args.out_dir, "load_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    if problems:
        print(f"FAIL: {len(problems)} structural problems (see {args.out_dir}/load_report.json):")
        for p in problems[:10]:
            print("  ", p)
        return 1
    print(f"strict load OK: {len(state_dict)} torch keys -> the port's tree, 0 problems")

    ckpt = os.path.join(args.out_dir, args.name)
    save_flax_msgpack(variables, ckpt, metadata={
        "source": args.pt, "variant": variant, "num_classes": nc, "imgsz_trained": 960,
        "mask_stride": 4, "recipe": "converted from reference .pt (tti_torch validate-reference)"})
    print("checkpoint:", ckpt)

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if root not in sys.path:
        sys.path.insert(0, root)
    if not args.skip_parity:
        from tools.parity_report_torch import main as parity_main

        parity_out = os.path.join(args.out_dir, "PARITY_REFERENCE.md")
        rc = parity_main(["--weights", ckpt, "--frames", str(args.frames), "--imgsz",
                          str(args.imgsz), "--frame-h", str(args.frame_h), "--frame-w",
                          str(args.frame_w), "--out", parity_out, "--device", args.device])
        print(f"parity report: {parity_out}")
        if rc:
            return rc
    if not args.skip_measure:
        from tools.measure_report_torch import main as measure_main

        measure_out = os.path.join(args.out_dir, "MEASURE_REFERENCE.md")
        rc = measure_main(["--weights", ckpt, "--scenes", str(args.scenes), "--imgsz",
                           str(args.imgsz), "--out", measure_out, "--device", args.device])
        print(f"measure report: {measure_out}")
        if rc:
            return rc
    if args.images:
        return main(["eval", "--images", args.images, "--weights", ckpt, "--imgsz",
                     str(args.imgsz), "--device", args.device])
    return 0


def _soft_masks_flag(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--soft-masks", nargs="?", const="all", default=None,
                   help=f"{what} (all | stitch | fabric | comma ids; bare flag = all)")


def _architecture_flags(p: argparse.ArgumentParser, imgsz: int) -> None:
    p.add_argument("--variant", default="n")
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--imgsz", type=int, default=imgsz)
    p.add_argument("--mask-stride", type=int, default=4, choices=[2, 4],
                   help="proto grid = imgsz / mask_stride (2: the hi-res proto head)")
    p.add_argument("--proto-head", default="deconv", choices=["deconv", "subpixel"],
                   help="mask_stride=2 second stage: learned deconv or sub-pixel conv")


def _device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", help="torch device (cpu only when asked)")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m tti_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("calibrate", help="run extrinsic ChArUco calibration")
    p.add_argument("--solver", default="tti", choices=["tti", "cv2"])
    p.set_defaults(func=cmd_calibrate)

    p = sub.add_parser("calibrate-intrinsics",
                       help="intrinsic camera calibration from board views")
    p.add_argument("--images", help="calibrate from an image directory")
    p.add_argument("--out", default="camera_calibration.json")
    p.add_argument("--max-views", type=int, default=25)
    p.set_defaults(func=cmd_calibrate_intrinsics)

    p = sub.add_parser("export-weights",
                       help="export a deploy msgpack + sidecar from a training checkpoint (EMA)")
    p.add_argument("--train-dir", required=True,
                   help="a run directory (its newest step_N.pt) or one step_N.pt")
    p.add_argument("--out", required=True, help="output .msgpack path")
    _architecture_flags(p, 960)
    _soft_masks_flag(p, "record which classes trained with area-occupancy targets")
    p.add_argument("--recipe", default="", help="free-text provenance line for the sidecar")
    p.set_defaults(func=cmd_export_weights)

    p = sub.add_parser("train", help="train a segmentation model (YOLO-format data)")
    p.add_argument("--images", required=True, help="dataset images directory")
    p.add_argument("--out", default="checkpoints")
    _architecture_flags(p, 640)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--max-gt", type=int, default=32)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint in --out (replays the "
                        "step-indexed batch stream)")
    p.add_argument("--stitch-seg-gain", type=float, default=1.0,
                   help="extra seg-loss weight on stitch-class positives")
    _soft_masks_flag(p, "area-occupancy mask targets for these classes")
    p.add_argument("--host-aug", action="store_true",
                   help="cv2 host-side augmentation instead of the default "
                        "device-side (device-resident) pipeline")
    p.add_argument("--dtype", default="bf16", choices=["f32", "bf16"],
                   help="convolution compute dtype (parameters and loss stay float32)")
    _device_flag(p)
    p.add_argument("--init", default=None, metavar="CHECKPOINT",
                   help="start from a deploy msgpack's params and batch stats")
    p.set_defaults(func=cmd_train)

    p = sub.add_parser("run", help="measurement loop (main.py equivalent)")
    p.add_argument("--images", help="replay image directory instead of camera")
    p.add_argument("--synthetic", action="store_true", help="synthetic frames")
    p.add_argument("--loop", action="store_true")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--skip-calibration", action="store_true")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--show", action="store_true",
                   help="live annotated display, 'q' quits (needs cv2)")
    p.add_argument("--cameras", type=int, default=1,
                   help="multi-camera line: N streams through one device pipeline")
    p.add_argument("--pipelined", action="store_true",
                   help="double-buffer the single-camera loop (results lag one tick)")
    _device_flag(p)
    p.set_defaults(func=cmd_run)

    p = sub.add_parser("check-model", help="annotated detection dump")
    p.add_argument("--images")
    p.add_argument("--out", default="check_frames")
    p.add_argument("--max-frames", type=int, default=20)
    _device_flag(p)
    p.set_defaults(func=cmd_check_model)

    p = sub.add_parser("eval", help="box+mask mAP on a YOLO-format dataset")
    p.add_argument("--images", required=True)
    p.add_argument("--weights")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--mask-stride", type=int, default=4, choices=[2, 4])
    p.add_argument("--proto-head", default="deconv", choices=["deconv", "subpixel"])
    _device_flag(p)
    p.set_defaults(func=cmd_eval)

    p = sub.add_parser("convert", help="convert .pt weights to a msgpack checkpoint")
    p.add_argument("--pt", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(func=cmd_convert)

    p = sub.add_parser(
        "validate-reference",
        help="one-shot validation of the reference's trained .pt: convert -> strict load "
             "report -> torch-oracle parity -> measure report")
    p.add_argument("--pt", required=True, help="path to the reference .pt")
    p.add_argument("--out-dir", default="validation")
    p.add_argument("--name", default="reference_model.msgpack",
                   help="converted checkpoint filename inside --out-dir")
    p.add_argument("--frames", type=int, default=8,
                   help="parity frames at the deployment geometry")
    p.add_argument("--scenes", type=int, default=64,
                   help="analytic scenes for the mm measure report")
    p.add_argument("--imgsz", type=int, default=960,
                   help="model input size (960 = deployment geometry, reference "
                        "measurement.py:210)")
    p.add_argument("--frame-h", type=int, default=960)
    p.add_argument("--frame-w", type=int, default=1280)
    p.add_argument("--images", default="",
                   help="optional labeled real-frame dataset for an mAP eval")
    p.add_argument("--skip-parity", action="store_true")
    p.add_argument("--skip-measure", action="store_true")
    _device_flag(p)
    p.set_defaults(func=cmd_validate_reference)

    p = sub.add_parser("export", help="freeze the inspection step into torch.export programs "
                       "+ weights in one artifact")
    p.add_argument("--out", default=None,
                   help="the artifact's path (default tti_pipeline.ttitorch.zip)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--platforms", default="cuda,cpu",
                   help="comma-separated devices to trace for (default cuda,cpu)")
    _device_flag(p)
    p.set_defaults(func=cmd_export)

    p = sub.add_parser("capture", help="timed dataset capture")
    p.add_argument("--out", default="captures")
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--max-frames", type=int, default=1000)
    p.set_defaults(func=cmd_capture)

    p = sub.add_parser("view", help="live camera view")
    p.set_defaults(func=cmd_view)

    p = sub.add_parser("tune-camera", help="exposure/brightness/contrast tuning")
    p.add_argument("--set", nargs="*", metavar="PROP=VALUE",
                   help="headless: apply values and exit (e.g. exposure=3.5)")
    p.set_defaults(func=cmd_tune_camera)

    p = sub.add_parser("bench", help="run the throughput benchmark (not ported yet)")
    p.set_defaults(func=cmd_bench)

    p = sub.add_parser("tune-device", help="auto-tune the env-gated perf variants on this "
                       "device; writes winning .env lines")
    p.add_argument("--batches", default="1,128")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--frame-h", type=int, default=1080)
    p.add_argument("--frame-w", type=int, default=1920)
    p.add_argument("--variant", default="n")
    p.add_argument("--mask-stride", type=int, default=4, choices=[2, 4],
                   help="proto-head stride (2 = the hi-res deploy arch)")
    p.add_argument("--proto-head", default="deconv", choices=["deconv", "subpixel"])
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--trials", default="", help="comma list (default: all)")
    p.add_argument("--allow-approx", action="store_true",
                   help="let approximate/quantized variants win")
    p.add_argument("--subcell", action="store_true",
                   help="time the sub-cell (soft-checkpoint) boundary readout")
    p.add_argument("--int8-scales", default="",
                   help="calibrated activation-scale JSON — adds quant=int8s")
    p.add_argument("--out", default="tune.env")
    p.add_argument("--lat-iters", type=int, default=None,
                   help="synced steps per latency p50 (default: the tool's, 15)")
    _device_flag(p)
    p.set_defaults(func=cmd_tune_device)

    args = parser.parse_args(argv)
    try:
        _log_no_counterpart(check_process_switches(os.environ))
        _join_job(args)
        return args.func(args)
    except ConfigError as e:  # a setting that cannot apply (a TTI_QUANT, ...): its reason
        return _refuse(str(e))
    finally:
        dcn.shutdown()


def _join_job(args) -> None:
    """``tti``'s ``init_distributed`` before the command: join the
    ``TTI_*`` triple's job, if one is set, as this host's one process on
    the command's device (the host's commands without ``--device``: gloo).
    ``train`` on several local cards joins in its per-card processes."""
    from tti_torch.train.loop import launches_per_card

    device = getattr(args, "device", "cpu")
    if not (args.command == "train" and launches_per_card(device)):
        dcn.init_distributed(device=device)


if __name__ == "__main__":
    sys.exit(main())
