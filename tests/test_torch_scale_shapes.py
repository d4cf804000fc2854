"""``tools/scale_shapes_torch.py`` builds kernel F alone from
``csrc/int8conv.cu`` with other block shapes; its source is made here (the
card compiles it)."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))

import scale_shapes_torch as ss  # noqa: E402


@pytest.mark.parametrize("name", sorted(ss.SHAPES))
def test_f_source_takes_the_shape(name):
    """F's constants replaced, clusters of 16 allowed, the shared-memory
    setter and the C function outside the anonymous namespace, braces
    balanced, and nothing of kernel E."""
    threads, per_sm, unroll = ss.SHAPES[name]
    src = ss.f_source(threads, per_sm, unroll)
    for const, value in (("kFThreads", threads), ("kFBlocksPerSm", per_sm),
                         ("kFUnroll", unroll), ("kFMaxCluster", 16)):
        assert src.count(f"constexpr int {const} = ") == 1
        assert f"constexpr int {const} = {value};" in src
    assert src.count("{") == src.count("}")
    assert src.index("}  // namespace") < src.index('extern "C" {') < src.index(
        "int tti_act_scale_per_sample(")
    assert "void tti_f_set_smem(int s)" in src and "cfg.dynamicSmemBytes = g_smem;" in src
    assert "act_absmax_kernel" in src and "int8_conv_kernel" not in src
    assert all(n in ss.SHAPES for rows in ss.ROWS.values() for n, _, _ in rows)
