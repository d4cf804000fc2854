"""The host augmentation recipe (``train --host-aug``) against tti's:
``hsv_jitter``, ``random_scale_shift``, ``mosaic4`` and ``batches`` of
``tti_torch.train.data`` against ``tti.train.data`` on a seeded YOLO-format
set (``tests/torch_scenes.py`` written as PNG files), in one process, so
with one OpenCV: images equal, targets equal, the numpy Generator left in
the same state. Over two epochs, with and without soft masks, at mask
strides 2 and 4.

tti rasterises the targets with cv2.fillPoly when it can import cv2, the
port with the scanline fill alone (ROADMAP, traps): tti's rasteriser is
called with cv2 blocked, and everything else on both sides runs with cv2.
Without cv2 both packages take their fallbacks (a value-only HSV jitter, a
nearest affine), held equal too.

Then the data-parallel rows: two ranks' ``batch_slice`` rows of each host
batch, as ``run_host`` hands them to the step, make up the unsharded batch.
"""

import sys

import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_scenes import textile_samples
from tti.train import data as jdata
from tti_torch.parallel.mesh import batch_slice
from tti_torch.train import data as tdata
from tti_torch.train.loop import host_batch_to_device, run_host

pytest.importorskip("cv2")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and more threads per process only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _without_cv2(fn):
    """``fn`` called with cv2 blocked (tti's scanline rasteriser)."""
    def call(*args, **kwargs):
        saved = sys.modules.get("cv2")
        sys.modules["cv2"] = None
        try:
            return fn(*args, **kwargs)
        finally:
            sys.modules["cv2"] = saved
    return call


@pytest.fixture
def tti_scanline(monkeypatch):
    monkeypatch.setattr(jdata, "rasterize_polygon", _without_cv2(jdata.rasterize_polygon))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Six scenes at 200 px (resized to imgsz on load), YOLO layout."""
    root = tmp_path_factory.mktemp("hostaug")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    for i, s in enumerate(textile_samples(6, 200, seed=13)):
        Image.fromarray(s.image).save(root / "images" / f"s_{i}.png")
        (root / "labels" / f"s_{i}.txt").write_text("\n".join(
            f"{c} " + " ".join(f"{v:.6f}" for v in p.ravel())
            for p, c in zip(s.polygons, s.classes)))
    images = str(root / "images")
    return tdata.discover_dataset(images), jdata.discover_dataset(images)


def _rngs(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _same_state(a, b):
    assert a.bit_generator.state == b.bit_generator.state


def _image(seed, size=48):
    return np.random.default_rng(seed).uniform(0, 1, (size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hsv_jitter_equals_tti(seed):
    ra, rb = _rngs(seed)
    got = tdata.hsv_jitter(_image(seed), ra)
    want = jdata.hsv_jitter(_image(seed), rb)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    _same_state(ra, rb)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_scale_shift_equals_tti(seed):
    polys = [np.random.default_rng(seed).uniform(0, 1, (5, 2)).astype(np.float32)]
    ra, rb = _rngs(seed)
    got, got_p = tdata.random_scale_shift(_image(seed), polys, ra)
    want, want_p = jdata.random_scale_shift(_image(seed), polys, rb)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_p[0], want_p[0])
    _same_state(ra, rb)


def test_fallbacks_without_cv2_equal_tti(monkeypatch):
    """No cv2 on either side: the value-only jitter (one draw) and the
    nearest affine."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    polys = [np.array([[0.2, 0.2], [0.8, 0.3], [0.5, 0.9]], np.float32)]
    ra, rb = _rngs(4)
    np.testing.assert_array_equal(tdata.hsv_jitter(_image(4), ra), jdata.hsv_jitter(_image(4), rb))
    got, got_p = tdata.random_scale_shift(_image(5), polys, ra)
    want, want_p = jdata.random_scale_shift(_image(5), polys, rb)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_p[0], want_p[0])
    _same_state(ra, rb)


def test_mosaic4_and_augmented_scene_equal_tti(dataset):
    ours, theirs = dataset
    ra, rb = _rngs(3)
    got = tdata.mosaic4(ours[:4], 64, ra)
    want = jdata.mosaic4(theirs[:4], 64, rb)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2] == want[2] and len(got[1]) == len(want[1]) > 8
    for p, q in zip(got[1], want[1]):
        np.testing.assert_array_equal(p, q)
    idxs = np.array([5, 0, 2, 2])
    for _ in range(3):  # mosaic, scale/shift, HSV and flip draws, in turn
        got = tdata.augmented_scene(ours, idxs, 64, ra)
        want = jdata.augmented_scene(theirs, idxs, 64, rb)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[2] == want[2]
        for p, q in zip(got[1], want[1]):
            np.testing.assert_array_equal(p, q)
    single = tdata.augmented_scene(ours, idxs[:1], 64, ra)  # fewer than 4: no mosaic
    np.testing.assert_array_equal(single[0], jdata.augmented_scene(theirs, idxs[:1], 64, rb)[0])
    _same_state(ra, rb)


@pytest.mark.parametrize("stride", [2, 4])
@pytest.mark.parametrize("soft", [None, "all"])
def test_batches_equal_tti(dataset, tti_scanline, soft, stride):
    """Two epochs of batch 2 (three batches each) at imgsz 160, seed 5."""
    ours, theirs = dataset
    kw = dict(max_gt=12, seed=5, epochs=2, mask_stride=stride, soft_masks=soft)
    got = list(tdata.batches(ours, 2, 160, **kw))
    want = list(jdata.batches(theirs, 2, 160, **kw))
    assert len(got) == len(want) == 6
    for (images, targets), (ref_images, ref_targets) in zip(got, want):
        assert images.shape == (2, 160, 160, 3) and images.dtype == np.float32
        np.testing.assert_array_equal(images, ref_images)
        for name in ("boxes", "classes", "masks", "valid"):
            a, b = getattr(targets, name).numpy(), np.asarray(getattr(ref_targets, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert targets.masks.shape == (2, 12, 160 // stride, 160 // stride)
    classes = torch.cat([t.classes[t.valid] for _, t in got])
    assert (classes == 0).sum() > 10 and (classes == 1).sum() > 10  # stitches and fabric
    if soft:  # fractional boundary cells reach the targets
        masks = torch.cat([t.masks for _, t in got])
        assert ((masks > 0) & (masks < 1)).any()


def test_batches_without_augment_and_refusal(dataset, tti_scanline):
    ours, theirs = dataset
    got = next(tdata.batches(ours, 3, 64, augment=False, seed=1, epochs=1))
    want = next(jdata.batches(theirs, 3, 64, augment=False, seed=1, epochs=1))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].masks.numpy(), np.asarray(want[1].masks))
    with pytest.raises(ValueError, match="batch_size=7"):
        next(tdata.batches(ours, 7, 64))


class _Mesh:
    """A two-rank ``"data"`` mesh as ``batch_slice`` reads it."""

    mesh_dim_names = ("data",)

    def __init__(self, rank):
        self.rank = rank

    def size(self, dim):
        return 2

    def get_local_rank(self, axis):
        return self.rank


def test_two_ranks_rows_make_the_unsharded_batch(dataset):
    """Each rank draws the whole global batch from the seed and steps on its
    ``batch_slice`` rows: rank 0's rows then rank 1's are the unsharded
    batch, for every batch of an epoch."""
    ours, _ = dataset
    kw = dict(max_gt=8, seed=11, epochs=1, mask_stride=2, soft_masks="all")
    seen = {}
    for rank in (None, 0, 1):
        rows = None if rank is None else batch_slice(_Mesh(rank), 4)
        seen[rank] = []
        step = lambda state, x, t, out=seen[rank]: out.append((x, t)) or {"total": x.sum()}
        logged = []
        n = run_host(None, step, tdata.batches(ours, 4, 64, **kw), "cpu", rows=rows,
                     log_every=1, log=logged.append)
        assert n == 1 and logged[0].startswith("step 1: total=")
    assert batch_slice(_Mesh(1), 4) == slice(2, 4)
    for (x, t), (x0, t0), (x1, t1) in zip(seen[None], seen[0], seen[1]):
        assert x0.shape[0] == x1.shape[0] == 2 and x.dtype == torch.float32
        torch.testing.assert_close(torch.cat([x0, x1]), x, rtol=0, atol=0)
        for name in ("boxes", "classes", "masks", "valid"):
            assert torch.equal(torch.cat([getattr(t0, name), getattr(t1, name)]),
                               getattr(t, name)), name


def test_host_batch_to_device_keeps_dtypes(dataset):
    ours, _ = dataset
    images, targets = next(tdata.batches(ours, 2, 32, max_gt=4, seed=0))
    x, t = host_batch_to_device(images, targets, "cpu", slice(1, 2))
    assert x.shape == (1, 32, 32, 3) and x.dtype == torch.float32
    assert (t.boxes.dtype, t.classes.dtype, t.masks.dtype, t.valid.dtype) == (
        torch.float32, torch.int32, torch.float32, torch.bool)
    assert torch.equal(t.masks, targets.masks[1:2])
