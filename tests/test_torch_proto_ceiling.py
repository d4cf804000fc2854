"""``tools/proto_ceiling_torch.py`` against ``tools/proto_ceiling.py``.

- ``bilinear_upsample`` (torch) against cv2's ``INTER_LINEAR`` resize, which
  tti's tool calls: equal within 1e-6 at the proto strides' integer factors
  and at a ratio that is not one.
- ``oracle_masks`` equal to tti's, both variants, both strides, on the same
  GT masks.
- ``run_geometry``'s mAP50 and mAP50-95 within 1e-6 of tti's on a seeded set
  (``tests/torch_scenes.py``), both variants and both strides. tti's GT is
  rasterised with cv2 blocked (its scanline fill, the port's only one; as
  ``tests/test_torch_train_data.py`` does); its resize keeps cv2.
"""

import sys

import numpy as np
import pytest
import torch

from tests.torch_scenes import textile_samples

cv2 = pytest.importorskip("cv2")

import tools.proto_ceiling as ref_tool  # noqa: E402
import tools.proto_ceiling_torch as port_tool  # noqa: E402


def _scanline(fn):
    def call(*args, **kwargs):
        saved = sys.modules.get("cv2")
        sys.modules["cv2"] = None
        try:
            return fn(*args, **kwargs)
        finally:
            sys.modules["cv2"] = saved
    return call


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    """Five seeded scenes as a YOLO-format set (labels; the images are not
    read), discovered by each package."""
    from PIL import Image

    from tti.train.data import discover_dataset as ref_discover
    from tti_torch.train.data import discover_dataset

    root = tmp_path_factory.mktemp("ceiling")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    for i, s in enumerate(textile_samples(5, 96, seed=21)):
        Image.fromarray(s.image).save(root / "images" / f"s_{i}.png")
        (root / "labels" / f"s_{i}.txt").write_text("\n".join(
            f"{c} " + " ".join(f"{v:.6f}" for v in p.ravel())
            for p, c in zip(s.polygons, s.classes)))
    return discover_dataset(str(root / "images")), ref_discover(str(root / "images"))


@pytest.mark.parametrize("shape,out_hw", [((16, 16), (64, 64)), ((32, 24), (64, 48)),
                                          ((7, 9), (23, 30))])
def test_bilinear_upsample_is_cv2_inter_linear(shape, out_hw):
    mask = np.random.default_rng(sum(shape)).uniform(0, 1, shape).astype(np.float32)
    got = port_tool.bilinear_upsample(torch.from_numpy(mask)[None], out_hw)[0].numpy()
    want = cv2.resize(mask, (out_hw[1], out_hw[0]), interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("stride", [2, 4])
@pytest.mark.parametrize("variant", ["soft", "binary"])
def test_oracle_masks_equal_tti(samples, variant, stride):
    from tti_torch.train.data import rasterize_polygon

    imgsz = 128
    s = samples[0][1]
    gt = np.stack([rasterize_polygon(p, (imgsz, imgsz)) for p in s.polygons])
    boxes = np.stack([np.concatenate([p.min(0), p.max(0)]) * imgsz
                      for p in s.polygons]).astype(np.float64)
    got = port_tool.oracle_masks(gt, boxes, imgsz, variant, stride, device="cpu")
    want = ref_tool.oracle_masks(gt, boxes, imgsz, variant, stride)
    assert got.dtype == want.dtype == np.float32 and got.sum() > 100
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stride", [2, 4])
@pytest.mark.parametrize("variant", ["soft", "binary"])
def test_run_geometry_equals_tti(samples, monkeypatch, variant, stride):
    monkeypatch.setattr(ref_tool, "rasterize_polygon", _scanline(ref_tool.rasterize_polygon))
    ours, theirs = samples
    got = port_tool.run_geometry(ours, 192, variant, stride, device="cpu")
    want = ref_tool.run_geometry(theirs, 192, variant, stride)
    for key in ("mAP50", "mAP50_95"):
        assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])
    assert got == pytest.approx(want, abs=1e-6)
    assert 0.1 < got["mAP50_95"] <= 1.0


def test_main_writes_the_table(samples, tmp_path, capsys):
    """``main`` writes the table to ``--out``, which defaults to a file
    under build/ (never the repo's MASK_CEILING.md)."""
    out = tmp_path / "ceiling.md"
    images = samples[0][0].image_path.rsplit("/", 1)[0]
    assert port_tool.main(["--images", images, "--imgsz", "64", "--device", "cpu",
                           "--out", str(out)]) == 0
    text = out.read_text()
    assert "| 64 | 16x16 | soft |" in text and "| 64 | 16x16 | binary |" in text
    assert "imgsz=64 proto=16 binary:" in capsys.readouterr().out
    default = port_tool.build_parser().parse_args(["--images", images]).out
    assert default == str(port_tool.ROOT) + "/build/MASK_CEILING_torch.md"
