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

The flags are ``tti``'s, plus ``--device`` (default cuda; ``run``,
``check-model``, ``eval``, ``train``) and ``--init`` (``train``: start from
a deploy checkpoint's params and batch stats). The calibration commands run
on the host (numpy and OpenCV) and take no ``--device``. ``run`` on a camera
first runs the startup calibration gate, as ``tti`` does, unless given
``--skip-calibration``. Configuration comes from the environment and ``.env``
as in ``tti`` (:func:`tti_torch.core.config.load_config`). Refused, naming
the ROADMAP item that ports them: ``train --host-aug`` and ``TTI_QUANT=int8``
/ ``int8s`` (int8 inference).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from tti_torch.core.config import AppConfig, load_config
from tti_torch.core.logging import get_logger

log = get_logger("cli")


def _refuse(message: str) -> int:
    print(message, file=sys.stderr)
    return 1


def _refuses_quant() -> bool:
    """``TTI_QUANT=int8``/``int8s`` asks for int8 inference, which the port
    does not have: say so rather than serve bf16 in its place."""
    quant = os.environ.get("TTI_QUANT", "")
    if quant in ("int8", "int8s"):
        _refuse(f"TTI_QUANT={quant} is not ported: tti_torch has no int8 inference yet "
                "(ROADMAP Queue 1 item 5, int8 inference). Unset TTI_QUANT.")
        return True
    return False


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
    file does not exist."""
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
    return InspectionPipeline(cfg.model, variables, frame_hw, calibration=calibration,
                              measure_cfg=cfg.measure, roi=cfg.roi, device=device,
                              return_masks=return_masks)


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

    if _refuses_quant():
        return 1
    cfg = load_config(validate=not args.no_validate)
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
    if _refuses_quant():
        return 1
    try:
        import cv2
    except ImportError:
        return _refuse("check-model writes JPEGs with OpenCV (cv2), which does not import here")
    from tti_torch.app.annotate import annotate_frame, overlay_masks
    from tti_torch.app.sources import DirectorySource, SyntheticSource

    cfg = load_config(validate=False)
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
    if _refuses_quant():
        return 1
    cfg = load_config(validate=False)
    model_cfg = dataclasses.replace(cfg.model, image_size=args.imgsz,
                                    mask_stride=args.mask_stride, proto_head=args.proto_head,
                                    **({"weights": args.weights} if args.weights else {}))
    have_weights = model_cfg.weights and os.path.exists(model_cfg.weights)
    if have_weights:
        model_cfg = _adopt_architecture(model_cfg, checkpoint_metadata(model_cfg.weights))
    samples = discover_dataset(args.images)
    if have_weights:
        variables = load_flax_msgpack(model_cfg.weights)
        log.info("loaded weights from %s", model_cfg.weights)
    else:
        log.warning("weights %r not found — using random init", model_cfg.weights)
        variables = _random_variables(model_cfg)
    predictor = Predictor(model_cfg, variables, (args.imgsz, args.imgsz), mask_topk=64,
                          proto_masks=True, device=args.device)
    res = evaluate_samples(samples, predictor, args.imgsz, model_cfg.num_classes,
                           model_cfg.mask_stride, progress=lambda line: print(line, flush=True))
    for label, key in (("box", "box"), ("mask(proto-res)", "mask_proto"),
                       ("mask(full-res)", "mask_full")):
        print(f"{label}:", {k: round(v, 4) for k, v in res[key].items()})
    return 0


def cmd_train(args) -> int:
    from tti_torch.train.data import discover_dataset
    from tti_torch.train.loop import train

    if args.host_aug:
        print("--host-aug is not ported: tti_torch augments on the device. The host "
              "recipe is ROADMAP Queue 1 item 4 (--host-aug).", file=sys.stderr)
        return 1
    path = train(discover_dataset(args.images), args.out, variant=args.variant,
                 num_classes=args.num_classes, imgsz=args.imgsz, batch_size=args.batch_size,
                 epochs=args.epochs, lr=args.lr, max_gt=args.max_gt, log_every=args.log_every,
                 checkpoint_every=args.checkpoint_every, resume=args.resume,
                 mask_stride=args.mask_stride, proto_head=args.proto_head,
                 stitch_seg_gain=args.stitch_seg_gain, soft_masks=args.soft_masks,
                 dtype=args.dtype, device=args.device, init=args.init,
                 log=lambda line: print(line, flush=True))
    print("final checkpoint:", path)
    return 0


def cmd_export_weights(args) -> int:
    from tti_torch.train.loop import export_weights

    export_weights(args.train_dir, args.out, variant=args.variant, num_classes=args.num_classes,
                   imgsz=args.imgsz, mask_stride=args.mask_stride, proto_head=args.proto_head,
                   soft_masks=args.soft_masks, recipe=args.recipe)
    print("deploy checkpoint:", args.out)
    print("sidecar:", args.out + ".json")
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
                   help="the reference's cv2 host augmentation: not ported, refused")
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

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
