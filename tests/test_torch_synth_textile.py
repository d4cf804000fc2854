"""``tools/synth_textile_torch.py`` (the port's copy of the training-data
generator) against ``tools/synth_textile.py`` on the same seeds: the flat
scenes bit for bit (images, polygons, classes), the camera-domain scenes
through each package's ``PlaneMapper`` (their plane maps bit-equal, so the
scenes are too), and the files ``write_split`` and ``write_camera_split``
write (labels and JPEG bytes)."""

import sys
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import measure_report  # noqa: E402
import measure_report_torch  # noqa: E402
import synth_textile as ref  # noqa: E402
import synth_textile_torch as port  # noqa: E402


def _same_scene(got, want):
    (img, polys, classes), (img_r, polys_r, classes_r) = got[:3], want[:3]
    np.testing.assert_array_equal(img, img_r)
    assert classes == classes_r and len(polys) == len(polys_r)
    for p, q in zip(polys, polys_r):
        assert p.dtype == q.dtype
        np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("size", [64, 160, 320])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_scene_bit_equal(size, seed):
    rng, rng_r = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):  # two scenes from one stream: the draws stay in step
        _same_scene(port.make_scene(size, rng), ref.make_scene(size, rng_r))
    assert rng.bit_generator.state == rng_r.bit_generator.state


@pytest.fixture(scope="module")
def mappers():
    """Each package's mappers, distorted and pinhole, at the deployment's
    1280x960 frame."""
    return {dist: (measure_report_torch.PlaneMapper(**kw), measure_report.PlaneMapper(**kw))
            for dist, kw in (("distorted", {}), ("pinhole", {"dist": np.zeros(5)}))}


@pytest.mark.parametrize("mode", ["distorted", "pinhole"])
def test_make_camera_scene_bit_equal(mode, mappers):
    """The port's mapper equals ``tools/measure_report``'s to the bit, and so
    do the scenes, their polygons and their per-pixel label masks."""
    ours, theirs = mappers[mode]
    np.testing.assert_array_equal(ours.plane_mm, theirs.plane_mm)
    for seed in (0, 3):
        got = port.make_camera_scene(ours, np.random.default_rng(seed), return_masks=True)
        want = ref.make_camera_scene(theirs, np.random.default_rng(seed), return_masks=True)
        _same_scene(got, want)
        assert len(got[3]) == len(want[3])
        for m, n in zip(got[3], want[3]):
            np.testing.assert_array_equal(m, n)
        sq, polys = port._pad_square(got[0], got[1])
        sq_r, polys_r = ref._pad_square(want[0], want[1])
        np.testing.assert_array_equal(sq, sq_r)
        for p, q in zip(polys, polys_r):
            np.testing.assert_array_equal(p, q)


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_write_split_same_files(tmp_path):
    port.write_split(str(tmp_path / "port"), 4, 96, seed=3, quality=88)
    ref.write_split(str(tmp_path / "ref"), 4, 96, seed=3, quality=88)
    got, want = _files(tmp_path / "port"), _files(tmp_path / "ref")
    assert len(got) == 8 and got == want


def test_write_camera_split_same_files(tmp_path, capsys):
    """n=4 with seed 2, which draws every sub-domain: one distorted, two
    pinhole and one flat scene (at 160 px)."""
    port.write_camera_split(str(tmp_path / "port"), 4, seed=2, quality=88, flat_size=160)
    ref.write_camera_split(str(tmp_path / "ref"), 4, seed=2, quality=88, flat_size=160)
    out = capsys.readouterr().out.splitlines()
    assert [line.split(": ", 1)[1] for line in out] == [
        "{'distorted': 1, 'pinhole': 2, 'flat': 1}"] * 2
    got, want = _files(tmp_path / "port"), _files(tmp_path / "ref")
    assert len(got) == 8 and got == want
