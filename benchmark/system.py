"""The system under test: ``tti_torch``'s ``InspectionPipeline`` built as a
configuration file states it. The only module of the benchmark, with
:mod:`benchmark.loop`, that imports the program."""

from __future__ import annotations

import hashlib
import os

from benchmark.deployment import calibration_arrays, roi_bounds

def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def check_checkpoint(config: dict, root: str) -> str:
    """The checkpoint's path, after its bytes and its sidecar's are found to
    be the ones the configuration names."""
    run = config["run"]
    path = os.path.join(root, run["checkpoint"])
    for file, want in ((path, run["checkpoint_sha256"]), (path + ".json", run["sidecar_sha256"])):
        got = sha256(file)
        if got != want:
            raise RuntimeError(f"{file}: sha256 {got}, the configuration names {want}")
    return path


def build_pipeline(config: dict, root: str, device: str = "cuda", quant: str | None = None,
                   dtype: str | None = None):
    """``InspectionPipeline`` of ``config`` on ``device``, under the
    runtime's defaults and the checkpoint sidecar's readout. ``quant`` and
    ``dtype`` (None: the configuration's) give the control and the float32
    witness of :mod:`benchmark.calibrate`."""
    from tti_torch.calib.io import CalibrationData
    from tti_torch.core.config import MeasureConfig, ModelConfig, RoiConfig
    from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
    from tti_torch.parallel.runtime import InspectionPipeline

    run, m = config["run"], config["model"]
    path = check_checkpoint(config, root)
    meta = checkpoint_metadata(path)
    nms = run["nms"]
    model_cfg = ModelConfig(variant=m["variant"], num_classes=m["nc"], image_size=m["imgsz"],
                            dtype=dtype or m["dtype"], mask_stride=m["mask_stride"],
                            proto_head=m["proto_head"], conf_thresh=nms["conf_thresh"],
                            iou_thresh=nms["iou_thresh"], max_detections=nms["max_det"],
                            nms_pre_topk=nms["pre_topk"],
                            stitch_class_id=run["measure"]["stitch_class_id"],
                            fabric_class_id=run["measure"]["fabric_class_id"])
    mc = run["measure"]
    measure_cfg = MeasureConfig(min_stitches=mc["min_stitches"],
                                max_px_distance=mc["max_px_distance"],
                                envelope_neighborhood=mc["envelope_neighborhood"],
                                max_stitches=mc["max_stitches"],
                                max_stats_dets=mc["max_stats_dets"]).with_subcell_from(meta)
    frame_hw = tuple(run["frame_hw"])
    return InspectionPipeline(
        model_cfg, load_flax_msgpack(path), frame_hw,
        calibration=CalibrationData(**calibration_arrays(run["camera"], frame_hw)),
        measure_cfg=measure_cfg, roi=RoiConfig(enabled=True, **roi_bounds(run["roi"], frame_hw)),
        device=device, quant=run["quant"] if quant is None else quant)
