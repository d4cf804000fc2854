"""The port's dataset code against tti.train.data: labels, discovery, the
scanline raster and its soft form, soft_class_ids, scene_to_targets and
build_device_dataset. Exact: the same float32 arithmetic on both sides.

tti rasterises with cv2.fillPoly when it can import cv2, which differs from
the scanline fill on boundary cells; the port has only the scanline fill, so
every comparison blocks cv2 on tti's side (images are then decoded with PIL
on both sides).
"""

import sys

import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_scenes import textile_samples
from tti.train import augment as jaug
from tti.train import data as jdata
from tti_torch.train import augment as taug
from tti_torch.train import data as tdata


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and more threads per process only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)


def _write_dataset(root, n=4, size=48, yolo_layout=True):
    images = root / "images"
    labels = root / "labels" if yolo_layout else images
    images.mkdir(parents=True)
    labels.mkdir(parents=True, exist_ok=True)
    for i, s in enumerate(textile_samples(n, size, seed=9)):
        Image.fromarray(s.image).save(images / f"s_{i}.png")
        lines = [f"{c} " + " ".join(f"{v:.6f}" for v in p.ravel())
                 for p, c in zip(s.polygons, s.classes)]
        lines += ["1 0.1 0.2 0.3 0.4", "0 0.1 0.2 0.3 0.4 0.5", ""]  # too few / odd: skipped
        (labels / f"s_{i}.txt").write_text("\n".join(lines))
    (images / "notes.txt").write_text("not an image")
    return images


@pytest.mark.parametrize("yolo_layout", [True, False])
def test_labels_and_discovery(tmp_path, yolo_layout):
    images = _write_dataset(tmp_path, yolo_layout=yolo_layout)
    got, ref = tdata.discover_dataset(str(images)), jdata.discover_dataset(str(images))
    assert [s.image_path for s in got] == [s.image_path for s in ref] and len(got) == 4
    for a, b in zip(got, ref):
        assert a.classes == b.classes and len(a.classes) >= 6
        for p, q in zip(a.polygons, b.polygons):
            np.testing.assert_array_equal(p, q)
    assert tdata.parse_label_file(str(tmp_path / "missing.txt")) == ([], [])
    with pytest.raises(FileNotFoundError):
        tdata.discover_dataset(str(tmp_path / "labels" if yolo_layout else tmp_path))


def _polygons():
    rng = np.random.default_rng(2)
    # In [0, 1], as every caller clips (see test_raster_left_of_the_image).
    polys = [rng.uniform(0.0, 1.0, (k, 2)).astype(np.float32) for k in (3, 4, 5, 7, 9, 12)]
    polys.append(np.array([[0.25, 0.25], [0.75, 0.25], [0.75, 0.75], [0.25, 0.75]], np.float32))
    polys.append(np.array([[0.1, 0.5], [0.9, 0.5], [0.5, 0.9]], np.float32))  # horizontal edge
    polys.append(np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]], np.float32))
    polys.append(np.array([[0.2, 0.2], [0.8, 0.2], [0.5, 0.5], [0.8, 0.8], [0.2, 0.8]],
                          np.float32))  # concave
    polys.append(np.array([[0.3, 0.3], [0.3, 0.3], [0.3, 0.3]], np.float32))  # degenerate
    polys += [s.polygons[0] for s in textile_samples(2, 64, seed=4)]  # the fabric band
    return polys


@pytest.mark.parametrize("hw", [(16, 16), (24, 40), (37, 29)])
def test_rasterize_polygon_matches_tti_scanline(no_cv2, hw):
    for i, poly in enumerate(_polygons()):
        got = tdata.rasterize_polygon(poly, hw)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jdata.rasterize_polygon(poly, hw), err_msg=str(i))
        for factor in (2, 4):
            np.testing.assert_array_equal(tdata.rasterize_polygon_soft(poly, hw, factor),
                                          jdata.rasterize_polygon_soft(poly, hw, factor))


def test_raster_left_of_the_image(no_cv2):
    """A pair of crossings left of column 0 (a polygon past the left edge)
    fills nothing in the port. tti slices ``mask[row, 0:hi]`` with a
    negative ``hi`` there and fills the row up to its last column; its
    callers clip polygons to [0, 1] first, where that cannot happen."""
    poly = np.array([[-0.5, 0.2], [-0.2, 0.2], [-0.2, 0.8], [-0.5, 0.8]], np.float32)
    assert not tdata.rasterize_polygon(poly, (16, 16)).any()
    assert jdata.rasterize_polygon(poly, (16, 16))[8, :13].all()
    clipped = np.clip(poly, 0.0, 1.0)
    np.testing.assert_array_equal(tdata.rasterize_polygon(clipped, (16, 16)),
                                  jdata.rasterize_polygon(clipped, (16, 16)))


SPELLINGS = [None, False, "", True, "all", "stitch", "fabric", "0,1", "1", (1,), [0, 1]]


@pytest.mark.parametrize("spelling", SPELLINGS, ids=[repr(s) for s in SPELLINGS])
def test_soft_class_ids(spelling):
    assert tdata.soft_class_ids(spelling) == jdata.soft_class_ids(spelling)
    assert tdata.soft_class_ids(spelling, 3, 2, 0) == jdata.soft_class_ids(spelling, 3, 2, 0)


@pytest.mark.parametrize("soft", [False, "stitch", "all"])
def test_scene_to_targets(no_cv2, soft):
    for s in textile_samples(2, 64, seed=5):
        img = s.image.astype(np.float32) / 255.0
        polys = s.polygons + [np.array([[0.5, 0.5], [0.51, 0.5], [0.51, 0.9]], np.float32)]
        classes = s.classes + [0]  # under 2 px wide: dropped
        _, got = tdata.scene_to_targets(img, polys, classes, 64, 6, mask_stride=2, soft_masks=soft)
        _, ref = jdata.scene_to_targets(img, polys, classes, 64, 6, mask_stride=2, soft_masks=soft)
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


@pytest.mark.parametrize("soft,stride", [(False, 4), ("all", 2), ("stitch", 2), ("0", 4)])
def test_build_device_dataset(tmp_path, no_cv2, soft, stride):
    images = _write_dataset(tmp_path, n=3, size=48)
    got = taug.build_device_dataset(tdata.discover_dataset(str(images)), 48, 10,
                                    mask_stride=stride, soft_masks=soft, device="cpu")
    ref = jaug.build_device_dataset(jdata.discover_dataset(str(images)), 48, 10,
                                    mask_stride=stride, soft_masks=soft)
    assert got.soft == ref.soft
    for key in ("images", "boxes", "classes", "masks", "valid"):
        np.testing.assert_array_equal(getattr(got, key).numpy(), np.asarray(getattr(ref, key)),
                                      err_msg=key)
    assert got.imgsz == 48 and got.valid.sum() > 12


def test_decoded_samples(tmp_path, no_cv2):
    """A Sample may carry its decoded image; it must have the training size."""
    images = _write_dataset(tmp_path, n=2, size=48)
    from_files = taug.build_device_dataset(tdata.discover_dataset(str(images)), 48, 10,
                                           device="cpu")
    decoded = textile_samples(2, 48, seed=9)
    in_memory = taug.build_device_dataset(decoded, 48, 10, device="cpu")
    assert torch.equal(from_files.images, in_memory.images)
    assert torch.equal(from_files.masks, in_memory.masks)
    np.testing.assert_array_equal(tdata.load_image(decoded[0], 48),
                                  decoded[0].image.astype(np.float32) / 255.0)
    with pytest.raises(ValueError, match="expected"):
        tdata.load_sample_u8(decoded[0], 64)
    _, t = tdata.sample_to_targets(decoded[1], 48, 10, hflip=True, mask_stride=4)
    _, r = jdata.scene_to_targets(decoded[1].image[:, ::-1].astype(np.float32) / 255.0,
                                  [np.stack([1.0 - p[:, 0], p[:, 1]], -1) for p in decoded[1].polygons],
                                  decoded[1].classes, 48, 10)
    np.testing.assert_array_equal(t["masks"], r["masks"])
