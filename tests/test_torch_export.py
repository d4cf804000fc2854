"""The port's frozen step (``tti_torch.app.export``) on the CPU, at
``tests/torch_pair.py``'s small geometries, float32:

- the frozen CPU program equals the live ``postprocess_chain(preprocess(...))``
  bit for bit, NaNs in place (deploy; headline with ``warp_pass1="kernel"``);
- held against ``tti``'s frozen step (``tti.app.export`` with
  ``platforms=("cpu",)``) on the same frames, name by name, within
  ``tests/torch_pair.assert_outputs_match``'s tolerances;
- a wrong geometry, dtype or device raises, and so does asking for "cuda"
  without a card (an artifact with both programs is made and loaded on the
  card, in ``chip_smoke.py`` phase 5d: this file needs ``tti``, which the
  card's machine does not have);
- a weights swap: the headline artifact run with ``yolov8n_textile_960``'s
  tensors equals a live pipeline built on that checkpoint;
- loading is self-contained: a subprocess with jax, tti and the port's model,
  parallel, preprocess, postprocess and measure packages blocked loads the
  artifact and reproduces the outputs;
- ``python -m tti_torch.cli export`` on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.torch_pair import assert_outputs_match, pipelines
from tti_torch.app.export import FrozenPipeline, export_pipeline, flatten_outputs

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def deploy(ref_intrinsics):
    pipe, ref, frames = pipelines("deploy", ref_intrinsics)
    return pipe, ref, frames, export_pipeline(pipe, batch=2, platforms=("cpu",))


@pytest.fixture(scope="module")
def headline(ref_intrinsics):
    pipe, _, frames = pipelines("headline", ref_intrinsics, port_kw=dict(warp_pass1="kernel"))
    return pipe, frames, export_pipeline(pipe, batch=2, platforms=("cpu",))


def _assert_same(frozen: dict, live: dict) -> None:
    assert list(frozen) == list(live)
    for name, value in live.items():
        torch.testing.assert_close(frozen[name], value, rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m: f"{name}: {m}")


def _live(pipe, frames):
    names, leaves = flatten_outputs(pipe.step(torch.from_numpy(frames)))
    return dict(zip(names, leaves))


def test_frozen_deploy_equals_live_step(deploy):
    pipe, _, frames, blob = deploy
    frozen = FrozenPipeline(blob, device="cpu")
    out = frozen(torch.from_numpy(frames))
    _assert_same(out, _live(pipe, frames))
    assert out["dets/valid"].sum() >= 2 and torch.isfinite(out["measurements/raw_width_mm"]).any()
    m = frozen.manifest
    assert m["batch"] == 2 and m["frame_hw"] == [240, 320] and m["platforms"] == ["cpu"]
    assert m["n_variable_leaves"] == len(m["variables"]) > 100
    assert [r["name"] for r in m["warp"]] == ["cam/K", "cam/dist", "cam/R", "cam/t", "warp/w1",
                                             "warp/w2"]


def test_frozen_headline_kernel_route_equals_live_step(headline):
    pipe, frames, blob = headline
    frozen = FrozenPipeline(blob, device="cpu")
    _assert_same(frozen(torch.from_numpy(frames)), _live(pipe, frames))
    # Kernel C's table travels as a weight input beside W1.
    names = [r["name"] for r in frozen.manifest["warp"]]
    assert names.index("warp/w1_window") == names.index("warp/w1") + 2


def _as_outputs(d: dict) -> SimpleNamespace:
    """Flat ``{name: array}`` -> the fields ``assert_outputs_match`` reads."""
    d = {k: np.asarray(v) for k, v in d.items()}
    group = lambda p: {k.split("/", 1)[1]: v for k, v in d.items() if k.startswith(p + "/")}
    return SimpleNamespace(valid=d["dets/valid"], classes=d["dets/classes"],
                           scores=d["dets/scores"], boxes_frame=d["boxes_frame"],
                           telemetry=group("telemetry"), envelope=d["envelope"],
                           measurements=SimpleNamespace(**group("measurements")),
                           stitches=SimpleNamespace(**group("stitches")))


def test_frozen_step_matches_tti_frozen_step(deploy):
    """Both packages' artifacts on the same frames, name by name."""
    from tti.app.export import FrozenPipeline as TtiFrozen
    from tti.app.export import export_pipeline as tti_export

    _, ref, frames, blob = deploy
    ref_out = TtiFrozen(tti_export(ref, batch=2, platforms=("cpu",)))(frames)
    got = FrozenPipeline(blob, device="cpu")(torch.from_numpy(frames))
    assert list(got) == list(ref_out)
    assert_outputs_match(_as_outputs(got), _as_outputs(ref_out))
    assert int(np.asarray(ref_out["dets/valid"]).sum()) >= 2


def test_wrong_input_raises(deploy):
    _, _, frames, blob = deploy
    frozen = FrozenPipeline(blob, device="cpu")
    x = torch.from_numpy(frames)
    for bad in (x[:1], x.float(), x[:, :-2], x.to("meta")):
        with pytest.raises(ValueError, match="frozen for"):
            frozen(bad)
    with pytest.raises(ValueError, match="holds programs for"):
        FrozenPipeline(blob, device="meta")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a card")
def test_cuda_without_a_card_raises(deploy):
    pipe, _, _, _ = deploy
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_pipeline(pipe, batch=1, platforms=("cuda", "cpu"))
    with pytest.raises(ValueError, match="platforms"):
        export_pipeline(pipe, batch=1, platforms=("tpu",))


def test_weights_swap_reuses_the_program(headline, ref_intrinsics):
    _, frames, blob = headline
    other = pipelines("headline_b", ref_intrinsics, port_kw=dict(warp_pass1="kernel"))[0]
    frozen = FrozenPipeline(blob, device="cpu")
    before = frozen(torch.from_numpy(frames))
    frozen.swap_weights(other)
    after = frozen(torch.from_numpy(frames))
    _assert_same(after, _live(other, frames))
    assert not torch.equal(before["dets/scores"], after["dets/scores"])
    deploy_pipe = pipelines("deploy", ref_intrinsics)[0]
    with pytest.raises(ValueError, match="do not match"):
        frozen.swap_weights(deploy_pipe)


LOADER = r"""
import sys
for name in ("jax", "jaxlib", "flax", "msgpack", "tti", "tti_torch.model", "tti_torch.parallel",
             "tti_torch.preprocess", "tti_torch.postprocess", "tti_torch.measure"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np
import torch
from tti_torch.app.export import FrozenPipeline
frozen = FrozenPipeline(sys.argv[1], device="cpu")
out = frozen(torch.from_numpy(np.load(sys.argv[2])))
want = torch.load(sys.argv[3])
assert list(out) == list(want)
for k in want:
    torch.testing.assert_close(out[k], want[k], rtol=0, atol=0, equal_nan=True)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "tti") and sys.modules[m]]
assert not bad, bad
print("OK", len(out))
"""


def test_loading_is_self_contained(headline, tmp_path):
    pipe, frames, blob = headline
    artifact = tmp_path / "a.ttitorch.zip"
    artifact.write_bytes(blob)
    np.save(tmp_path / "frames.npy", frames)
    torch.save(_live(pipe, frames), tmp_path / "want.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", LOADER, str(artifact),
                           str(tmp_path / "frames.npy"), str(tmp_path / "want.pt")],
                          cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK 24")


def test_cli_export_on_the_cpu(ref_intrinsics, tmp_path, monkeypatch):
    """``python -m tti_torch.cli export`` from a directory with a ``.env``
    and the calibration files, for the host; "cuda" without a card refused."""
    from tti_torch.calib.io import save_extrinsics, save_intrinsics
    from tti_torch.cli.__main__ import main as port_main
    from tests.torch_pair import RVEC, TVEC
    from tests.torch_synth import textile_frames

    monkeypatch.chdir(tmp_path)
    K, dist = ref_intrinsics
    save_intrinsics(K * np.array([[0.25], [0.25], [1.0]]), dist, "camera_calibration.json",
                    image_size=(320, 240))
    save_extrinsics(RVEC, TVEC, "extrinsics.json")
    weights = str(REPO / "checkpoints" / "yolov8n_textile_cam.msgpack")
    (tmp_path / ".env").write_text(
        f"TTI_WEIGHTS={weights}\nTTI_SQLITE_PATH=line.db\nCALIB_W=320\nCALIB_H=240\n"
        "TTI_IMAGE_SIZE=256\nROI_Y_MIN=60\nROI_Y_MAX=200\n")
    assert port_main(["export", "--platforms", "cpu", "--device", "cpu", "--out", "a.zip"]) == 0
    frozen = FrozenPipeline("a.zip", device="cpu")
    assert frozen.manifest["batch"] == 1 and frozen.manifest["frame_hw"] == [240, 320]
    assert [r["name"] for r in frozen.manifest["warp"]][:4] == ["cam/K", "cam/dist", "cam/R",
                                                              "cam/t"]
    out = frozen(torch.from_numpy(textile_frames(1, 240, 320, seed=5)))
    assert out["measurements/raw_edge_mm"].shape == (1,) and bool(out["dets/valid"].any())
    if not torch.cuda.is_available():
        assert port_main(["export", "--device", "cpu", "--out", "b.zip"]) == 1
