"""The step's warp modes against tti with the same switch set, on the
paired pipelines of ``tests/torch_pair.py`` at the headline geometry (an
exact x3 decimation, where every warp mode applies; float32 on the CPU,
boxes within 1e-3 px, mm within 1e-3), and against the port's default
step: the banded two-pass warp, the column-expanded one, and the packed
gather (which packs the decimated bytes) against tti's with
``TTI_REMAP_U8_DECIMATE=1``."""

import pytest

from tti_torch.preprocess.remap import PackedRemap
from tti_torch.preprocess.warp2pass import TwoPassWarp
from tests.torch_pair import mode_against_tti

MODES = {
    "blocked": ({"TTI_WARP_BLOCKED": "16"}, dict(warp_block=16)),
    "col_expand": ({"TTI_WARP_COLEXPAND": "1"}, dict(warp_col_expand=True)),
    "packed_u8_decimate": ({"TTI_REMAP": "packed", "TTI_REMAP_U8_DECIMATE": "1"},
                           dict(remap="packed")),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_warp_mode(mode, ref_intrinsics, monkeypatch):
    env, kw = MODES[mode]
    # The packed route's default is the two-pass warp: it is held to tti only.
    pipe, _ = mode_against_tti("headline", env, kw, ref_intrinsics, monkeypatch,
                               exact=mode != "packed_u8_decimate")
    warp = pipe.warp
    if mode == "packed_u8_decimate":
        assert isinstance(warp, PackedRemap)
    else:
        assert isinstance(warp, TwoPassWarp) and warp.s2d_out
        assert (warp.block, warp.col_expand) == ((16, None) if mode == "blocked"
                                                 else (None, (3, 1, 384)))
