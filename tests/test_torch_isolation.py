"""tti_torch stands alone: it imports neither jax (nor flax, optax, msgpack)
nor anything of tti, and a tiny CPU inspection step and a training step run
with all of them blocked."""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "tti_torch"

SCRIPT = r"""
import pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "tti"):
    sys.modules[name] = None  # any import of these now raises ImportError
import importlib
import tti_torch
names = [m.name for m in pkgutil.walk_packages(tti_torch.__path__, "tti_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("tti_torch.native", "tti_torch.app.sources", "tti_torch.parallel.streams",
             "tti_torch.kernels.warp_p1", "tti_torch.core.logging", "tti_torch.cli.__main__",
             *(f"tti_torch.train.{m}" for m in ("assigner", "losses", "step", "augment", "data",
                                               "checkpoint", "loop"))):
    assert name in names and name in sys.modules, name

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
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|msgpack|tti)\b", re.M)
    sources = [p for ext in ("*.py", "*.cu", "*.cuh", "*.cpp") for p in PORT.rglob(ext)]
    sources += [REPO / "chip_smoke.py", REPO / "tests" / "torch_scenes.py",
                REPO / "tests" / "torch_synth.py"]
    names = {p.name for p in sources}
    assert len(sources) > 10 and {"maskstats.cu", "warp_p1.cu", "framering.cpp", "loop.py",
                                  "assigner.py", "augment.py", "__main__.py",
                                  "torch_scenes.py"} <= names
    offenders = {str(p.relative_to(REPO)): pattern.findall(p.read_text())
                 for p in sources if pattern.search(p.read_text())}
    assert not offenders, offenders
