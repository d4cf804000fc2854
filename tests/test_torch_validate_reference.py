"""``python -m tti_torch.cli validate-reference`` and ``convert``: the port's
one-shot harness for the reference's trained weights (``best_Model.pt``,
``single_needle_model.pt``; reference config.py:67, measurement.py:145), run
end to end on a synthetic Ultralytics-format ``.pt``
(``tests/torch_ref.TorchYOLOv8Seg`` saved with ``torch.save``) on the CPU,
as ``tests/test_validate_reference.py`` runs ``tti``'s, and refusing a
state dict that is not YOLOv8-seg."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tests.torch_ref import TorchYOLOv8Seg
from tti_torch.model.checkpoint import load_flax_msgpack
from tti_torch.model.convert import convert_torch_state_dict

REPO = Path(__file__).resolve().parents[1]


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "tti_torch.cli", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def _save_pt(tmp_path):
    torch.manual_seed(0)
    tmodel = TorchYOLOv8Seg(variant="n", nc=2)
    pt = str(tmp_path / "best_Model.pt")
    torch.save({"model": tmodel}, pt)
    return pt, tmodel


def test_validate_reference_end_to_end(tmp_path):
    """convert -> strict load report -> parity and measure reports, one shot."""
    pt, tmodel = _save_pt(tmp_path)
    out_dir = tmp_path / "validation"
    proc = _cli("validate-reference", "--pt", pt, "--out-dir", str(out_dir), "--frames", "2",
                "--scenes", "2", "--imgsz", "320", "--frame-h", "240", "--frame-w", "320",
                "--device", "cpu", cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    report = json.loads((out_dir / "load_report.json").read_text())
    assert report["variant"] == "n" and report["num_classes"] == 2
    assert report["strict_load_problems"] == [] and report["torch_keys"] > 100
    assert set(report) == {"source_pt", "torch_keys", "variant", "num_classes",
                           "strict_load_problems"}
    ckpt = out_dir / "reference_model.msgpack"
    meta = json.loads(Path(str(ckpt) + ".json").read_text())
    assert meta["variant"] == "n" and meta["mask_stride"] == 4 and meta["num_classes"] == 2
    assert (out_dir / "PARITY_REFERENCE.md").exists() and (out_dir / "MEASURE_REFERENCE.md").exists()
    assert "| identity-scale | float32 |" in (out_dir / "PARITY_REFERENCE.md").read_text()

    # ``convert`` writes the same tree.
    proc = _cli("convert", "--pt", pt, "--out", str(tmp_path / "c.msgpack"), cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = convert_torch_state_dict(tmodel.state_dict())
    for tree in (load_flax_msgpack(str(ckpt)), load_flax_msgpack(str(tmp_path / "c.msgpack"))):
        np.testing.assert_array_equal(tree["params"]["m22"]["cv3_0_2"]["bias"],
                                      want["params"]["m22"]["cv3_0_2"]["bias"])
        np.testing.assert_array_equal(tree["batch_stats"]["m9"]["cv2"]["bn"]["var"],
                                      want["batch_stats"]["m9"]["cv2"]["bn"]["var"])


def test_validate_reference_rejects_garbage(tmp_path):
    """A .pt that is not a YOLOv8-seg state dict fails loudly, exit 1."""
    pt = str(tmp_path / "junk.pt")
    torch.save({"model.0.conv.weight": torch.zeros(16, 3, 3, 3)}, pt)
    proc = _cli("validate-reference", "--pt", pt, "--out-dir", str(tmp_path / "v"),
                "--skip-parity", "--skip-measure", "--device", "cpu", cwd=tmp_path)
    assert proc.returncode == 1
    assert "FAIL" in proc.stdout
