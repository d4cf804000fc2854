"""mAP evaluation and the application CLI against tti.

- ``evaluate``, ``box_iou`` and ``mask_iou_matrix`` (a copy of numpy code)
  equal tti's exactly on seeded random payloads.
- ``python -m tti_torch.cli eval --device cpu`` against tti's ``cmd_eval``
  on a 4-image YOLO-format dataset (seeded textile scenes written with cv2)
  at imgsz 128 (at 64 the checkpoints find nothing and every metric reads
  0), float32, both checkpoint kinds: every printed metric within
  1e-3 (the two networks differ by float32 rounding; tti's own masks
  rasterise with cv2.fillPoly when cv2 imports, so its rasteriser is bound
  to the scanline fill both packages share without cv2).
- ``run --synthetic --max-frames 2 --device cpu --skip-calibration`` exits 0
  and logs two measurements; ``check-model`` writes its JPEGs.
- The refusals: a ``TTI_QUANT`` that cannot apply (unfolded BN, the fused
  head, ``int8s`` without its scales file) stops ``run``, ``eval`` and
  ``check-model`` with ``tti``'s message before anything is opened;
  ``run`` on a camera without ``--skip-calibration`` runs the startup
  calibration gate, which stops the run when neither intrinsics nor
  extrinsics are on disk.
"""

import ast
import logging
import os
import sqlite3

import numpy as np
import pytest
import torch

import tti.train.data as jdata
import tti.train.eval as jeval
import tti_torch.train.data as tdata
import tti_torch.train.eval as teval
from tests.torch_scenes import textile_scene
from tti.cli.__main__ import main as tti_main
from tti_torch.calib.io import save_extrinsics, save_intrinsics
from tti_torch.cli.__main__ import main as port_main

torch.set_num_threads(2)


def _payload(rng, n_img, use_masks, hw=(24, 32)):
    images = []
    for _ in range(n_img):
        g, p = int(rng.integers(0, 6)), int(rng.integers(0, 9))
        gt = rng.uniform(0, 20, (g, 2))
        gt_boxes = np.concatenate([gt, gt + rng.uniform(2, 12, (g, 2))], 1)
        pick = rng.integers(0, max(g, 1), p)
        pred_boxes = (gt_boxes[pick] if g else rng.uniform(0, 20, (p, 4))) + rng.normal(0, 1.5, (p, 4))
        kw = {}
        if use_masks:
            kw = dict(pred_masks=rng.random((p, *hw)) > 0.6, gt_masks=rng.random((g, *hw)) > 0.6)
            if g:
                kw["pred_masks"][: min(p, g)] |= kw["gt_masks"][pick[: min(p, g)]]
        images.append(dict(pred_boxes=pred_boxes, pred_scores=rng.random(p),
                           pred_classes=rng.integers(0, 3, p), gt_boxes=gt_boxes,
                           gt_classes=rng.integers(0, 3, g), **kw))
    return images


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("use_masks", [False, True], ids=["box", "mask"])
def test_evaluate_equal(seed, use_masks):
    rng = np.random.default_rng(seed)
    payload = _payload(rng, 6, use_masks)
    got = teval.evaluate([teval.ImageEval(**p) for p in payload], 3, use_masks=use_masks)
    want = jeval.evaluate([jeval.ImageEval(**p) for p in payload], 3, use_masks=use_masks)
    assert got == want
    assert teval.IOU_THRESHOLDS == jeval.IOU_THRESHOLDS


def test_iou_matrices_equal():
    rng = np.random.default_rng(5)
    a, b = rng.uniform(0, 50, (7, 4)), rng.uniform(0, 50, (5, 4))
    a[:, 2:] += a[:, :2]
    b[:, 2:] += b[:, :2]
    np.testing.assert_array_equal(teval.box_iou(a, b), jeval.box_iou(a, b))
    ma, mb = rng.random((4, 9, 11)) > 0.5, rng.random((3, 9, 11)) > 0.4
    np.testing.assert_array_equal(teval.mask_iou_matrix(ma, mb), jeval.mask_iou_matrix(ma, mb))
    for fn in (teval.box_iou, teval.mask_iou_matrix):
        assert fn(np.zeros((0, 4)), b).shape == (0, 5)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("ds") / "images"
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        img, polys, classes = textile_scene(128, rng)
        cv2.imwrite(str(root / f"s_{i}.png"), img[..., ::-1])
        (root / f"s_{i}.txt").write_text("".join(
            f"{c} " + " ".join(f"{v:.6f}" for v in p.ravel()) + "\n"
            for p, c in zip(polys, classes)))
    return str(root)


def _metrics(text):
    out = {}
    for line in text.splitlines():
        label, sep, rest = line.partition(": ")
        if sep and label in ("box", "mask(proto-res)", "mask(full-res)"):
            out[label] = ast.literal_eval(rest)
    return out


@pytest.mark.parametrize("ckpt,flags", [
    ("yolov8n_textile", []),
    ("yolov8n_textile_cam", ["--mask-stride", "2", "--proto-head", "subpixel"]),
], ids=["stride4", "stride2_subpixel"])
def test_eval_cli_matches_tti(ckpt, flags, dataset, monkeypatch, capsys):
    monkeypatch.setenv("TTI_DTYPE", "float32")
    monkeypatch.setenv("CONF_THRESH", "0.05")
    monkeypatch.setattr(jdata, "rasterize_polygon", tdata.rasterize_polygon)
    args = ["eval", "--images", dataset, "--imgsz", "128",
            "--weights", f"checkpoints/{ckpt}.msgpack", *flags]
    assert tti_main(args) == 0
    want = _metrics(capsys.readouterr().out)
    assert port_main(args + ["--device", "cpu"]) == 0
    got = _metrics(capsys.readouterr().out)
    assert got.keys() == want.keys() == {"box", "mask(proto-res)", "mask(full-res)"}
    for label in want:
        assert got[label].keys() == want[label].keys()
        for key, value in want[label].items():
            assert got[label][key] == pytest.approx(value, abs=1e-3), (label, key)
    assert want["mask(full-res)"]["mAP50"] > 0.05  # the checkpoints find the scenes


def _write_deployment(tmp_path, ref_intrinsics, ref_extrinsics, monkeypatch):
    """A working directory as a deployment has it: .env, calibration files."""
    monkeypatch.chdir(tmp_path)
    K, dist = ref_intrinsics
    K = K.copy()
    K[:2] *= 0.25
    save_intrinsics(K, dist, "camera_calibration.json", image_size=(320, 240))
    save_extrinsics(*ref_extrinsics, "extrinsics.json")
    weights = os.path.join(os.path.dirname(os.path.dirname(__file__)), "checkpoints",
                           "yolov8n_textile_cam.msgpack")
    (tmp_path / ".env").write_text(
        f"TTI_WEIGHTS={weights}\nTTI_SQLITE_PATH=line.db\nCALIB_W=320\nCALIB_H=240\n"
        "TTI_IMAGE_SIZE=256\nROI_Y_MIN=60\nROI_Y_MAX=200\n")


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


def test_run_cli_synthetic(tmp_path, ref_intrinsics, ref_extrinsics, monkeypatch):
    _write_deployment(tmp_path, ref_intrinsics, ref_extrinsics, monkeypatch)
    handler = _Records()
    logger = logging.getLogger("tti_torch.app.orchestrator")
    logger.addHandler(handler)
    try:
        rc = port_main(["run", "--synthetic", "--max-frames", "2", "--device", "cpu",
                        "--skip-calibration"])
    finally:
        logger.removeHandler(handler)
    assert rc == 0
    measured = [r for r in handler.records if r.getMessage() == "measurement"]
    assert len(measured) == 2 and all(r.tti_valid for r in measured)
    with sqlite3.connect(str(tmp_path / "line.db")) as con:  # the daily-reset row only
        assert con.execute('SELECT COUNT(*) FROM "measurements"').fetchone() == (1,)
    sessions = list((tmp_path / "saved_annotations").iterdir())
    assert len(sessions) == 1  # one session directory; its JPEGs need cv2
    assert len(list(sessions[0].glob("frame_*.jpg"))) == (2 if _has_cv2() else 0)


def _has_cv2():
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def test_check_model_cli_writes_jpegs(tmp_path, ref_intrinsics, ref_extrinsics, monkeypatch,
                                      capsys):
    pytest.importorskip("cv2")
    _write_deployment(tmp_path, ref_intrinsics, ref_extrinsics, monkeypatch)
    assert port_main(["check-model", "--out", "dump", "--max-frames", "2", "--device",
                      "cpu"]) == 0
    assert sorted(p.name for p in (tmp_path / "dump").iterdir()) == ["check_00000.jpg",
                                                                      "check_00001.jpg"]
    assert "detections" in capsys.readouterr().out


@pytest.mark.parametrize("argv,env,item", [
    (["run", "--device", "cpu"], {}, "cannot load intrinsics"),
    (["run", "--synthetic", "--device", "cpu"], {"TTI_QUANT": "int8", "TTI_FOLDED_BN": "0"},
     "TTI_QUANT=int8 requires folded BN"),
    (["eval", "--images", "none", "--imgsz", "64", "--device", "cpu"], {"TTI_QUANT": "int8s"},
     "TTI_QUANT=int8s needs TTI_QUANT_SCALES"),
    (["check-model", "--device", "cpu"], {"TTI_QUANT": "int8", "TTI_FUSED_HEAD": "1"},
     "TTI_FUSED_HEAD=1 is unsupported"),
], ids=["camera_without_calibration", "run_int8", "eval_int8s", "check_model_int8"])
def test_cli_refusals(argv, env, item, tmp_path, monkeypatch, capsys):
    import tti_torch.app.sources as sources

    monkeypatch.chdir(tmp_path)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    # A camera that opens (there is none here); the gate reads no frame.
    monkeypatch.setattr(sources, "OpenCVCameraSource",
                        lambda cfg, index=None: sources.SyntheticSource(8, 8, count=1))
    handler = _Records()
    logger = logging.getLogger("tti_torch.app.orchestrator")
    logger.addHandler(handler)
    try:
        assert port_main(argv) == 1
    finally:
        logger.removeHandler(handler)
    said = capsys.readouterr().err + "\n".join(r.getMessage() for r in handler.records)
    assert item in said
    assert not any(tmp_path.iterdir())  # stopped before opening anything
