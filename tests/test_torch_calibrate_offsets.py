"""``tools/calibrate_offsets_torch.py`` against ``tools/calibrate_offsets.py``
on 4 full-size deploy scenes (seed 7700, 1280x960, imgsz 960, the cam
checkpoint, float32 on the CPU), each run on its own ``tmp_path`` copy of
the checkpoint and its sidecar:

- the port's constants equal tti's within 1e-3 mm;
- the same whether the sidecar already holds offsets or not (the chain runs
  uncalibrated: ``TTI_READOUT_CAL=0`` while it is built and run);
- ``main`` writes the constants into the sidecar and keeps every other key;
- the caller's ``TTI_READOUT_CAL`` is put back, set or unset (tti deletes it
  even when the caller had set it: a departure, ROADMAP Queue 3).
"""

import json
import os
import shutil

import pytest

pytest.importorskip("cv2")

import tools.calibrate_offsets as ref_tool  # noqa: E402
import tools.calibrate_offsets_torch as port_tool  # noqa: E402

WEIGHTS = "checkpoints/yolov8n_textile_cam.msgpack"
CAL_KEYS = ("cal_edge_mm", "cal_width_mm", "cal_scenes", "cal_seed", "cal_edge_bias_raw",
            "cal_width_bias_raw", "cal_coverage")


def _copy(root, with_offsets: bool) -> str:
    root.mkdir()
    path = str(root / "cam.msgpack")
    shutil.copy(WEIGHTS, path)
    with open(WEIGHTS + ".json") as f:
        meta = json.load(f)
    if not with_offsets:
        meta = {k: v for k, v in meta.items() if k not in CAL_KEYS}
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ``main`` on a copy with offsets (the caller's
    ``TTI_READOUT_CAL=1`` set), its ``calibrate`` on a copy without (the
    variable unset), and tti's ``calibrate`` on a copy with offsets."""
    root = tmp_path_factory.mktemp("calib")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TTI_READOUT_CAL", "1")
        out["main_path"] = _copy(root / "main", with_offsets=True)
        out["main_rc"] = port_tool.main(["--weights", out["main_path"], "--scenes", "4",
                                         "--device", "cpu"])
        out["env_after_set"] = os.environ.get("TTI_READOUT_CAL")
        mp.delenv("TTI_READOUT_CAL")
        out["fresh"] = port_tool.calibrate(_copy(root / "fresh", with_offsets=False), scenes=4,
                                           device="cpu")
        out["env_after_unset"] = os.environ.get("TTI_READOUT_CAL", "unset")
        out["tti"] = ref_tool.calibrate(_copy(root / "tti", with_offsets=True), scenes=4)
    return out


def test_constants_equal_tti(runs):
    with open(runs["main_path"] + ".json") as f:
        written = json.load(f)
    ours, theirs = runs["fresh"], runs["tti"]
    assert set(ours) == set(theirs) == set(CAL_KEYS)
    for key in ("cal_edge_mm", "cal_width_mm", "cal_edge_bias_raw", "cal_width_bias_raw"):
        assert abs(ours[key] - theirs[key]) <= 1e-3, (key, ours[key], theirs[key])
    for key in ("cal_scenes", "cal_seed", "cal_coverage"):
        assert ours[key] == theirs[key], key
    assert ours["cal_scenes"] == 4 and ours["cal_seed"] == 7700
    # Offsets already in the sidecar change nothing: the chain runs uncalibrated.
    assert {k: written[k] for k in CAL_KEYS} == ours


def test_main_keeps_every_other_key(runs, capsys):
    assert runs["main_rc"] == 0
    with open(WEIGHTS + ".json") as f:
        before = json.load(f)
    with open(runs["main_path"] + ".json") as f:
        after = json.load(f)
    assert set(after) == set(before)
    assert {k: v for k, v in after.items() if k not in CAL_KEYS} == {
        k: v for k, v in before.items() if k not in CAL_KEYS}


def test_caller_readout_cal_is_put_back(runs):
    assert runs["env_after_set"] == "1"
    assert runs["env_after_unset"] == "unset"
