"""``TwoPassWarp.rows`` in blocked mode (the banded warp on a space mesh's
slab): each slab's output equals the whole banded warp's output on those
rows, float32 on the CPU within 1e-6 (pass 2 sums fewer zero terms over the
slab's windows: the same products, in another grouping).

Geometry: the headline's CPU-test frames (216x384, an exact x3 decimation
to 72x128 content in a 96-row model input, 3 P5 rows: slabs of 64 and 32
rows at space 2, 32 each at space 3). Blocks: 16 divides every slab, 24
splits the band [48, 72) at row 64, 128 is larger than any slab; each with
the s2d-emitting warp and without it (there the bands run over the live
rows and the letterbox's pad rows come from ``_finish``).
"""

import numpy as np
import pytest
import torch

from tti_torch.parallel.spatial import slab_plan
from tti_torch.preprocess.letterbox import make_letterbox_spec
from tti_torch.preprocess.remap import build_small_undistort_map
from tti_torch.preprocess.warp2pass import PAD_ROWS, TwoPassWarp

FRAME_HW, IMGSZ = (216, 384), 128


@pytest.fixture(scope="module")
def small_map(ref_intrinsics):
    K, dist = ref_intrinsics
    K = K.copy()
    K[0] *= FRAME_HW[1] / 1280.0
    K[1] *= FRAME_HW[0] / 960.0
    spec = make_letterbox_spec(*FRAME_HW, IMGSZ, "rect")
    return spec, build_small_undistort_map(K, dist, spec, unpadded_src=True)


def _slabs(height):
    """Every slab of the space sizes 2 and 3, and a slab of rows that lies
    past the content (the letterbox's pad rows)."""
    out = []
    for size in (2, 3):
        plan = slab_plan(height, size)
        out += [plan.input_rows(r) for r in range(size)]
    return out + [(height - 8, height)]


@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "rows"])
@pytest.mark.parametrize("block", [16, 24, 128], ids=["divides", "splits", "larger"])
def test_blocked_slab_equals_the_whole_banded_warp(small_map, s2d, block):
    spec, smap = small_map
    src_hw = (spec.new_h, spec.new_w)
    warp = TwoPassWarp(smap, src_hw, s2d_out=s2d, device="cpu", block=block)
    dense = TwoPassWarp(smap, src_hw, s2d_out=s2d, device="cpu")
    content = torch.from_numpy(np.random.default_rng(3).uniform(
        0.0, 1.0, (2, *src_hw, 3)).astype(np.float32))
    whole = warp(content)
    assert spec.dst_h == 96
    for r0, r1 in _slabs(spec.dst_h):
        slab = warp.rows(r0, r1)
        y0, y1 = slab.src_rows
        assert 0 <= y0 < y1 <= src_hw[0]
        got = slab(content[:, y0:y1])
        want = whole[:, r0 // 2:r1 // 2] if s2d else whole[:, r0:r1]
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6, msg=f"rows [{r0}, {r1})")
        # Pass 1 reads the dense slab's band of source rows; the bands' pad
        # terms ride along; pass 2 keeps no more weights than the dense slab.
        same = dense.rows(r0, r1)
        assert slab.src_rows == same.src_rows
        assert all(w.shape[0] == y1 - y0 for _, w in slab.w1_blocks)
        pad_terms = torch.tensor(warp.pad_terms + [0.0] * (PAD_ROWS - len(warp.pad_terms)))
        for start, w in slab.w2_blocks:
            assert 0 <= start and start + w.shape[-1] - PAD_ROWS <= y1 - y0
            pads = w[..., -PAD_ROWS:].reshape(-1, PAD_ROWS)
            assert torch.equal(pads, pad_terms.expand_as(pads))
        banded = sum(w.numel() for _, w in slab.w2_blocks)
        assert banded <= same.w2.numel()


@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "rows"])
def test_blocked_slab_bands_follow_the_slab(small_map, s2d):
    """A block that divides the slab keeps whole bands; one that does not
    splits the band at the slab's edge, and each part keeps its own rows."""
    spec, smap = small_map
    src_hw = (spec.new_h, spec.new_w)
    rows = lambda w: 2 * w.shape[2] if s2d else w.shape[1]
    for block, top, bottom in ((16, [16] * 4, [16] * 2), (24, [24, 24, 16], [8, 24])):
        warp = TwoPassWarp(smap, src_hw, s2d_out=s2d, device="cpu", block=block)
        assert (warp.row_start, warp.row_stop) == (0, 96)  # every row of this map is live
        assert [rows(w) for _, w in warp.rows(0, 64).w2_blocks] == top
        assert [rows(w) for _, w in warp.rows(64, 96).w2_blocks] == bottom


def test_blocked_slab_over_dead_rows():
    """A map whose first and last rows sample nothing (sentinels): without
    ``s2d_out`` the bands run over the live rows [4, 28) only, so a slab's
    cut is offset by ``row_start``, and a slab of dead rows alone keeps one
    band of no rows and emits the pad value."""
    dst_h, dst_w, src_hw = 32, 16, (20, 16)
    yy, xx = np.meshgrid(np.arange(dst_h, dtype=np.float32), np.arange(dst_w, dtype=np.float32),
                         indexing="ij")
    smap = np.stack([xx * 0.93 + 0.4, (yy - 4) * 0.77 + 0.05 * np.sin(xx)], axis=-1)
    smap[:4] = smap[28:] = -1e6
    content = torch.from_numpy(np.random.default_rng(4).uniform(
        0.0, 1.0, (2, *src_hw, 3)).astype(np.float32))
    for block in (6, 8, 40):
        warp = TwoPassWarp(smap, src_hw, s2d_out=False, device="cpu", block=block)
        assert (warp.row_start, warp.row_stop) == (4, 28)
        whole = warp(content)
        for r0, r1 in ((0, 16), (16, 32), (0, 4), (28, 32), (2, 30), (10, 12)):
            slab = warp.rows(r0, r1)
            y0, y1 = slab.src_rows
            torch.testing.assert_close(slab(content[:, y0:y1]), whole[:, r0:r1], rtol=0,
                                       atol=1e-6, msg=f"block {block}, rows [{r0}, {r1})")
        dead = warp.rows(28, 32)
        assert len(dead.w2_blocks) == 1 and dead.w2_blocks[0][1].shape[1] == 0


@pytest.mark.parametrize("block", [16, 24, 128])
def test_band_bytes_counted_from_the_map(small_map, block):
    """``tools/warp_bands_torch.py`` counts each slab's pass-2 bands and
    bytes from the map alone; ``tools/space_cards_torch.py`` reads them off
    the built slab (``pass2_bytes``): the two agree, banded and dense."""
    from tools.space_cards_torch import pass2_bytes
    from tools.warp_bands_torch import slab_pass2, tap_rows

    spec, smap = small_map
    src_hw = (spec.new_h, spec.new_w)
    warp = TwoPassWarp(smap, src_hw, s2d_out=True, device="cpu", block=block)
    dense = TwoPassWarp(smap, src_hw, s2d_out=True, device="cpu")
    lo, hi = tap_rows(smap, spec.new_h)
    for r0, r1 in _slabs(spec.dst_h):
        counted = slab_pass2(lo, hi, spec.dst_w, r0, r1, block, size=4)
        built = pass2_bytes(warp.rows(r0, r1))
        assert counted["src_rows"] == warp.rows(r0, r1).src_rows
        assert (counted["bands"], counted["bytes"], counted["dense_bytes"]) == (
            built["bands"], built["bytes"], built["dense_bytes"])
        whole = pass2_bytes(dense.rows(r0, r1))
        assert whole["bands"] == 1 and whole["bytes"] == whole["dense_bytes"] == built[
            "dense_bytes"]
