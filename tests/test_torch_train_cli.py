"""``python -m tti_torch.cli train`` and ``export-weights`` on the CPU at
imgsz 32, with the deployed recipe's flags (stride-2 sub-pixel protos,
soft masks, stitch seg gain 2.0, --init from the deploy checkpoint).

A resumed run must equal the uninterrupted run bit for bit (same process
kind, same CPU kernels); the exported msgpack must read the same in tti's
loader and the port's, and the port's InspectionPipeline must serve it.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_scenes import textile_samples
from tti.model import convert as jconvert
from tti.model.yolo import create_model as jax_create_model
from tti_torch.cli.__main__ import main
from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and more threads per process only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

REPO = Path(__file__).resolve().parents[1]
INIT = str(REPO / "checkpoints" / "yolov8n_textile_cam.msgpack")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    for i, s in enumerate(textile_samples(2, 32, seed=2)):
        Image.fromarray(s.image).save(root / "images" / f"s_{i}.png")
        (root / "labels" / f"s_{i}.txt").write_text("\n".join(
            f"{c} " + " ".join(f"{v:.6f}" for v in p.ravel())
            for p, c in zip(s.polygons, s.classes)))
    return str(root / "images")


def _args(images, out, epochs):
    return ["train", "--images", images, "--out", str(out), "--imgsz", "32", "--batch-size", "2",
            "--epochs", str(epochs), "--max-gt", "8", "--log-every", "1",
            "--checkpoint-every", "1", "--mask-stride", "2", "--proto-head", "subpixel",
            "--soft-masks", "--stitch-seg-gain", "2.0", "--dtype", "f32", "--device", "cpu",
            "--init", INIT]


@pytest.fixture(scope="module")
def uninterrupted(dataset, tmp_path_factory):
    out = tmp_path_factory.mktemp("run")
    assert main(_args(dataset, out, 3)) == 0  # 1 step per epoch: 3 steps
    return out


def _payload(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_equal_payloads(a, b):
    assert a["step"] == b["step"]
    for key in ("model", "ema"):
        assert a[key].keys() == b[key].keys()
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name]), (key, name)
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


def test_train_writes_checkpoints_and_logs(uninterrupted, capsys):
    names = sorted(os.listdir(uninterrupted))
    assert names == [f"step_{i}.pt" for i in range(1, 4)]
    state = _payload(uninterrupted / "step_3.pt")
    assert state["step"] == 3 and "m0.bn.running_var" in state["model"]
    assert not torch.equal(state["ema"]["m1.conv.weight"], state["model"]["m1.conv.weight"])


def test_resume_equals_uninterrupted(dataset, uninterrupted, tmp_path, capsys):
    """Interrupted after step 1 of the same 3-step run (the later
    checkpoints removed), then --resume: the final state is the
    uninterrupted run's, bit for bit (the batch stream is a function of
    the step)."""
    out = tmp_path / "resumed"
    shutil.copytree(uninterrupted, out)
    for i in (2, 3):
        os.remove(out / f"step_{i}.pt")
    assert main(_args(dataset, out, 3) + ["--resume"]) == 0
    text = capsys.readouterr().out
    assert "resumed" in text and "at step 1/3" in text
    assert "step 2/3" in text and "step 3/3" in text and "step 1/3:" not in text
    _assert_equal_payloads(_payload(out / "step_3.pt"), _payload(uninterrupted / "step_3.pt"))


def test_module_command_line(dataset, tmp_path):
    """The command as a user runs it, in its own process."""
    out = tmp_path / "cmd"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "tti_torch.cli", *_args(dataset, out, 1)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "step 1/1:" in proc.stdout and "final checkpoint:" in proc.stdout
    assert (out / "step_1.pt").exists()


def test_host_aug_is_refused(dataset, tmp_path, capsys):
    """``--host-aug`` with ``--resume`` is refused with tti's message (the
    host batch stream has no step index to re-enter), before anything is
    built or written."""
    assert main(_args(dataset, tmp_path, 1) + ["--host-aug", "--resume"]) == 1
    assert capsys.readouterr().out.splitlines() == [
        "--resume requires the device-aug path (the host batch iterator has no "
        "step-indexed stream to re-enter)"]
    assert not os.listdir(tmp_path)


def test_host_aug_trains(dataset, tmp_path, capsys):
    """``--host-aug`` trains on the host recipe's batches: tti's log line
    (``step N:``, no total) with finite losses, a checkpoint every step and
    the final one."""
    out = tmp_path / "host"
    assert main(_args(dataset, out, 2) + ["--host-aug"]) == 0
    lines = capsys.readouterr().out.splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in steps] == ["step 1", "step 2"]
    for ln in steps:
        terms = dict(kv.split("=") for kv in ln.split(": ")[1].split())
        assert set(terms) == {"total", "cls", "box", "dfl", "seg"}
        assert all(np.isfinite(float(v)) for v in terms.values()), ln
    assert lines[-1] == f"final checkpoint: {out / 'step_2.pt'}"
    assert sorted(os.listdir(out)) == ["step_1.pt", "step_2.pt"]
    state = _payload(out / "step_2.pt")
    assert state["step"] == 2 and not torch.equal(state["ema"]["m1.conv.weight"],
                                                  state["model"]["m1.conv.weight"])


def test_export_weights_loads_in_tti_and_serves(uninterrupted, tmp_path, capsys):
    deploy = str(tmp_path / "deploy.msgpack")
    assert main(["export-weights", "--train-dir", str(uninterrupted), "--out", deploy,
                 "--imgsz", "32", "--mask-stride", "2", "--proto-head", "subpixel",
                 "--soft-masks", "--recipe", "test run"]) == 0
    meta = checkpoint_metadata(deploy)
    assert meta == jconvert.checkpoint_metadata(deploy)
    assert meta["soft_masks"] is True and meta["recipe"] == "test run"
    assert meta["source"].endswith("step_3.pt") and meta["weights"] == "EMA (deployed tree)"
    ours = load_flax_msgpack(deploy)
    template = jax.eval_shape(lambda: jax_create_model(
        "n", nc=2, mask_stride=2, proto_head="subpixel").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    theirs = jconvert.load_checkpoint(deploy, template)
    a = jax.tree_util.tree_leaves_with_path(ours)
    b = dict(jax.tree_util.tree_leaves_with_path(theirs))
    assert len(a) == len(b) > 300
    for path, value in a:
        np.testing.assert_array_equal(value, np.asarray(b[path]))
    # The EMA parameters and the running statistics went out.
    state = _payload(uninterrupted / "step_3.pt")
    np.testing.assert_array_equal(ours["params"]["m1"]["conv"]["kernel"],
                                  state["ema"]["m1.conv.weight"].numpy().transpose(2, 3, 1, 0))
    np.testing.assert_array_equal(ours["batch_stats"]["m1"]["bn"]["var"],
                                  state["model"]["m1.bn.running_var"].numpy())

    from tests.torch_synth import textile_frames
    from tti_torch.calib.io import CalibrationData
    from tti_torch.core.config import MeasureConfig, ModelConfig, RoiConfig
    from tti_torch.parallel.runtime import InspectionPipeline

    calib = CalibrationData(K=np.array([[90.0, 0, 64], [0, 90.0, 48], [0, 0, 1]]),
                            dist=np.array([0.05, 0.01, 0, 0, 0.0]),
                            rvec=np.array([-0.86, -0.39, -1.36]), tvec=np.array([0.005, 0.036, 0.094]))
    pipe = InspectionPipeline(ModelConfig(image_size=64, dtype="float32", mask_stride=2,
                                          proto_head="subpixel"), ours, (48, 64), calib,
                              MeasureConfig().with_subcell_from(meta),
                              RoiConfig(x_min=1, x_max=63, y_min=1, y_max=47), device="cpu")
    out = pipe.process_batch(textile_frames(2, 48, 64, seed=1))
    assert out.boxes_frame.shape == (2, 200, 4) and np.isfinite(out.scores).all()
