"""tti_torch stands alone: it imports neither jax (nor flax, optax, msgpack)
nor anything of tti, and a tiny CPU inspection step, one frame of the
measurement loop and a training step run with all of them blocked, and with
the optional back ends (cv2, PIL, MySQL, paho-mqtt, pyserial) blocked too.
The calibration modules import without OpenCV (it is imported where it is
used), and ``tools/measure_report_torch.py``, ``tools/calibrate_int8_torch.py``,
``tools/calibrate_offsets_torch.py``, ``tools/proto_ceiling_torch.py``,
``tools/space_cards_torch.py``, ``tools/tune_device_torch.py``,
``tools/host_overhead_torch.py``, ``tools/profile_forward_torch.py`` and
``tools/profile_train_torch.py`` import neither tti nor the tools they stand
beside. ``tti``'s public helpers that no step calls (the dense-mask
measurement primitives, ``project_points``, ``local_mm_per_px``,
``masks_at_frame``, ``letterbox``, ``preprocess_frames``,
``frame_points_to_input``, ``InferenceError``, ``ServiceError``) import
and run with the same modules blocked."""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "tti_torch"

SCRIPT = r"""
import pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "tti",
             "cv2", "PIL", "mysql", "paho", "serial"):
    sys.modules[name] = None  # any import of these now raises ImportError
import importlib
import tti_torch
names = [m.name for m in pkgutil.walk_packages(tti_torch.__path__, "tti_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("tti_torch.native", "tti_torch.app.sources", "tti_torch.parallel.streams",
             "tti_torch.kernels.warp_p1", "tti_torch.kernels.nms", "tti_torch.kernels.int8conv",
             "tti_torch.model.quantize", "tti_torch.core.logging", "tti_torch.cli.__main__",
             "tti_torch.model.convert", "tti_torch.parallel.mesh", "tti_torch.parallel.dcn",
             "tti_torch.parallel.spatial",
             *(f"tti_torch.train.{m}" for m in ("assigner", "losses", "step", "augment", "data",
                                               "checkpoint", "loop", "eval")),
             *(f"tti_torch.services.{m}" for m in ("hardware", "serial_reader", "database",
                                                  "mqtt", "cleaner")),
             *(f"tti_torch.app.{m}" for m in ("results", "annotate", "orchestrator",
                                             "predict", "export")),
             *(f"tti_torch.calib.{m}" for m in ("pnp", "charuco", "intrinsics"))):
    assert name in names and name in sys.modules, name
sys.path.insert(0, "tools")
import measure_report_torch
import calibrate_int8_torch
import parity_report_torch
import calibrate_offsets_torch
import proto_ceiling_torch
import space_cards_torch
import tune_device_torch
import host_overhead_torch
import profile_forward_torch
import profile_train_torch
import warp_bands_torch
assert "measure_report" not in sys.modules and "tools.measure_report" not in sys.modules
assert "calibrate_int8" not in sys.modules
for name in ("calibrate_offsets", "tools.calibrate_offsets", "proto_ceiling",
             "tools.proto_ceiling", "tune_device", "tools.tune_device", "host_overhead",
             "tools.host_overhead", "profile_forward", "tools.profile_forward",
             "profile_train", "tools.profile_train"):
    assert name not in sys.modules, name
assert "parity_report" not in sys.modules and "test_predict_parity" not in sys.modules
import torch
from tti_torch.calib.geometry import local_mm_per_px, project_points
from tti_torch.core import InferenceError, TtiError
from tti_torch.core.errors import ServiceError
from tti_torch.measure.ops import (fabric_edge_mask, fabric_lower_envelope,
                                   fabric_upper_envelope, nearest_edge_candidates,
                                   sample_envelope, stitch_stats)
from tti_torch.postprocess.masks import masks_at_frame
from tti_torch.preprocess.letterbox import (frame_points_to_input, letterbox, letterbox_spec,
                                            preprocess_frames)
assert issubclass(InferenceError, TtiError) and issubclass(ServiceError, TtiError)
fab = torch.zeros(6, 8, dtype=torch.bool)
fab[2:5, 1:7] = True
assert fabric_lower_envelope(fab)[3] == 4 and fabric_upper_envelope(fab)[3] == 2
assert nearest_edge_candidates(fabric_edge_mask(fab), 3.0, 0.0, k=4)[3].all()
assert stitch_stats(fab[None].float(), torch.zeros(1, 4), torch.ones(1, dtype=torch.bool))[4]
assert sample_envelope(fabric_lower_envelope(fab), torch.tensor([3.0]),
                       torch.arange(-1, 2))[1].all()
assert masks_at_frame(torch.zeros(4, 4, 8), torch.zeros(2, 8), torch.zeros(2, 4),
                      torch.ones(2, dtype=torch.bool), (16, 16), (20, 24)).shape == (2, 20, 24)
x, spec = preprocess_frames(torch.zeros(1, 12, 16, 3, dtype=torch.uint8), 8)
assert x.shape == (1, 8, 8, 3) and letterbox(x, letterbox_spec(8, 8, 16)).shape == (1, 16, 16, 3)
assert frame_points_to_input(torch.zeros(3, 2), spec).shape == (3, 2)
K3 = [[90.0, 0, 64], [0, 90.0, 48], [0, 0, 1]]
assert project_points(torch.tensor([[0.0, 0.0, 1.0]]), [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], K3,
                      [0.0] * 5).shape == (1, 2)
assert local_mm_per_px(torch.tensor([[64.0, 48.0]]), K3, [0.0] * 5, torch.eye(3),
                       [0.0, 0.0, 0.1])[1].all()
from tti_torch.calib.charuco import create_charuco_board
from tti_torch.core.errors import CalibrationError
try:
    create_charuco_board()
    raise AssertionError("a board without cv2")
except CalibrationError:
    pass

import numpy as np
from tti_torch.calib.io import CalibrationData
from tti_torch.core.config import MeasureConfig, ModelConfig, RoiConfig
from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
from tti_torch.parallel.runtime import InspectionPipeline
from tests.torch_synth import textile_frames

path = "checkpoints/yolov8n_textile_cam.msgpack"
meta = checkpoint_metadata(path)
K = np.array([[90.0, 0, 64], [0, 90.0, 48], [0, 0, 1]])
calib = CalibrationData(K=K, dist=np.array([0.05, 0.01, 0, 0, 0.0]),
                        rvec=np.array([-0.86, -0.39, -1.36]), tvec=np.array([0.005, 0.036, 0.094]))
pipe = InspectionPipeline(ModelConfig(image_size=128, dtype="float32", mask_stride=2,
                                      proto_head="subpixel"),
                          load_flax_msgpack(path), (96, 128), calib,
                          MeasureConfig().with_subcell_from(meta), RoiConfig(x_min=1, x_max=127,
                                                                             y_min=1, y_max=95),
                          device="cpu")
out = pipe.process_batch(textile_frames(1, 96, 128))
assert out.boxes_frame.shape == (1, 200, 4) and out.envelope.shape == (1, 64)
modes = InspectionPipeline(ModelConfig(image_size=128, dtype="float32", mask_stride=2,
                                       proto_head="subpixel"),
                           load_flax_msgpack(path), (96, 128), calib,
                           MeasureConfig().with_subcell_from(meta),
                           RoiConfig(x_min=1, x_max=127, y_min=1, y_max=95), device="cpu",
                           lazy_decode=True, fused_head=True, fold_bn=False, warp_block=32,
                           maskstats_logits="f32")
assert modes.process_batch(textile_frames(1, 96, 128)).boxes_frame.shape == (1, 200, 4)
int8 = InspectionPipeline(ModelConfig(image_size=128, dtype="float32", mask_stride=2,
                                      proto_head="subpixel"),
                          load_flax_msgpack(path), (96, 128), calib,
                          MeasureConfig().with_subcell_from(meta),
                          RoiConfig(x_min=1, x_max=127, y_min=1, y_max=95), device="cpu",
                          quant="int8")
assert int8.process_batch(textile_frames(1, 96, 128)).boxes_frame.shape == (1, 200, 4)
import os, random, tempfile
from tti_torch.app.orchestrator import Orchestrator
from tti_torch.app.sources import SyntheticSource
from tti_torch.core.config import AppConfig, DatabaseConfig, RuntimeConfig
tmp = tempfile.mkdtemp()
cfg = AppConfig(database=DatabaseConfig(sqlite_path=os.path.join(tmp, "m.db")),
                runtime=RuntimeConfig(inference_interval_s=0.0, save_dir=os.path.join(tmp, "a")))
orch = Orchestrator(cfg, pipe, SyntheticSource(96, 128), rng=random.Random(0))
orch.init_services()  # no serial port, no MQTT server, no cv2: each degrades
orch.run(max_frames=1)
assert orch.frame_count == 1 and orch.render_annotated(None, {}) is None
import torch
from tests.torch_scenes import textile_samples
from tti_torch.train.augment import build_device_dataset
from tti_torch.train.loop import build_model, build_trainer, run

data = build_device_dataset(textile_samples(2, 32), 32, 4, device="cpu")
trainer = build_trainer(data, build_model("n", 2, 4, "deconv", torch.float32, "cpu"), 2, 4, 2,
                        dtype=torch.float32)
assert run(trainer, 0, 1, log_every=0) == 1 and trainer.state.step == 1
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "tti") and sys.modules[m]]
assert not bad, bad
print("OK", len(names))
"""


def test_port_imports_nothing_of_jax_or_tti():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_port_sources_name_no_forbidden_module():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|msgpack|tti"
                         r"|tools\.measure_report|measure_report|tools\.calibrate_offsets"
                         r"|calibrate_offsets|tools\.proto_ceiling|proto_ceiling"
                         r"|tools\.tune_device|tune_device|tools\.host_overhead|host_overhead"
                         r"|tools\.profile_forward|profile_forward|tools\.profile_train"
                         r"|profile_train)\b", re.M)
    sources = [p for ext in ("*.py", "*.cu", "*.cuh", "*.cpp") for p in PORT.rglob(ext)]
    sources += [REPO / "chip_smoke.py", REPO / "tests" / "torch_scenes.py",
                REPO / "tests" / "torch_synth.py", REPO / "tests" / "torch_dist.py"]
    sources += sorted((REPO / "tools").glob("*_torch.py"))
    names = {p.name for p in sources}
    assert len(sources) > 10 and {"maskstats.cu", "warp_p1.cu", "nms.cu", "framering.cpp", "loop.py",
                                  "assigner.py", "augment.py", "__main__.py", "orchestrator.py",
                                  "predict.py", "eval.py", "database.py", "pnp.py",
                                  "charuco.py", "intrinsics.py", "torch_scenes.py",
                                  "measure_report_torch.py", "step_syncs_torch.py",
                                  "step_latency_torch.py", "fused_head_copies_torch.py",
                                  "int8conv.cu", "int8conv.py", "quantize.py",
                                  "calibrate_int8_torch.py", "export.py", "convert.py",
                                  "parity_report_torch.py", "mesh.py", "dcn.py",
                                  "torch_dist.py", "calibrate_offsets_torch.py",
                                  "proto_ceiling_torch.py", "tune_device_torch.py",
                                  "host_overhead_torch.py", "profile_forward_torch.py",
                                  "profile_train_torch.py"} <= names
    offenders = {str(p.relative_to(REPO)): pattern.findall(p.read_text())
                 for p in sources if pattern.search(p.read_text())}
    assert not offenders, offenders
