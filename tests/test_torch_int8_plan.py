"""Kernel E's planner (``tti_torch.kernels.int8conv.plan_conv``) on the CPU,
and kernel E against its plain version on the card.

The planner is pure Python: every block of both configurations' int8
forwards gets a route (TMA, or the ``cp.async`` ring for the stems), a tile,
a ring depth and a shared-memory layout within 227 KB. The block inputs'
layouts (channel slices, strides, offsets) come from one forward of the
port's model at each configuration's main-path size with the convolution
stubbed out, so nothing is convolved here.

The ``cuda`` tests hold the kernel to ``int8_conv2d_plain`` (bit-equal
before SiLU, within 1 ulp after) on the shapes the redesign must get right.
This file imports no JAX, so it also runs where only the port is installed:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_int8_plan.py -m cuda``.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import tti_torch.model.layers as layers
from tti_torch.kernels import int8conv as ik
from tti_torch.model.yolo import create_model

BATCH = 128
# (s2d input (H/2, W/2), mask_stride, proto_head) of the two configurations'
# models: deploy 736x960 (imgsz 960, rect), headline 384x640 (imgsz 640).
CONFIGS = {"deploy": ((368, 480), 2, "subpixel"), "headline": ((192, 320), 4, "deconv")}


@functools.lru_cache(maxsize=None)
def block_inputs(config: str, plain_stem: bool = False) -> tuple:
    """(name, shape, strides, byte offset, co, k, stride, pad) of every
    quantized block's input in one bf16 forward at the configuration's
    size, channels_last as on the card."""
    (h2, w2), mask_stride, proto = CONFIGS[config]
    model = create_model("n", mask_stride=mask_stride, proto_head=proto, qmode="int8",
                         s2d_stem=not plain_stem)
    model = model.to(torch.bfloat16).to(memory_format=torch.channels_last)
    names = {id(m): n for n, m in model.named_modules() if isinstance(m, layers.Conv)}
    seen = []

    def stub(x, qp, ws, b, xs, k, s, p, act=True):
        ho, wo = (x.shape[2] + 2 * p - k) // s + 1, (x.shape[3] + 2 * p - k) // s + 1
        seen.append((tuple(x.shape), x.stride(), x.storage_offset() * x.element_size(),
                     qp.shape[0], k, s, p))
        return torch.zeros((x.shape[0], qp.shape[0], ho, wo), dtype=x.dtype).contiguous(
            memory_format=torch.channels_last)

    hooks = [m.register_forward_pre_hook(lambda m, a: seen.append(names[id(m)]))
             for m in model.modules() if isinstance(m, layers.Conv)]
    saved = layers.int8_conv2d, layers.act_scale_per_sample
    layers.int8_conv2d, layers.act_scale_per_sample = stub, lambda x: torch.ones(x.shape[0])
    try:
        x = (torch.zeros((1, 2 * h2, 2 * w2, 3)) if plain_stem
             else torch.zeros((1, h2, w2, 12))).to(torch.bfloat16)
        with torch.inference_mode():
            model(x)
    finally:
        layers.int8_conv2d, layers.act_scale_per_sample = saved
        for h in hooks:
            h.remove()
    return tuple((seen[i], *seen[i + 1]) for i in range(0, len(seen), 2))


def plan_block(shape, strides, offset, co, k, s, p, batch=BATCH, esize=2, base=1 << 20):
    b, c, h, w = (batch, *shape[1:])
    st = ik._canonical_strides((b, c, h, w), strides)
    route, vbytes = ik.input_route(c, esize, st, base + offset)
    return ik.plan_conv(b, c, h, w, co, k, s, p, esize, route, vbytes, sms=132)


def check_layout(pl: ik.ConvPlan) -> None:
    """The plan's shared memory: within the limit, regions in order and
    disjoint, each aligned as the kernel reads it (TMA destinations and the
    codes 128 bytes, wgmma operands 16, mbarriers 8)."""
    assert pl.smem + ik.SMEM_SLACK <= ik.SMEM_LIMIT
    assert pl.raw_bytes % 128 == 0 and pl.region_bytes % 128 == 0
    assert pl.nbox * pl.region_bytes == pl.raw_bytes
    assert pl.off_codes == pl.stages * pl.raw_bytes
    assert pl.off_w == pl.off_codes + pl.consumers * pl.codes_bytes
    assert pl.codes_bytes >= pl.planes * pl.plane_bytes + 16 * ik.TILE_COLS
    assert pl.plane_bytes % 128 == 16 and pl.plane_bytes >= pl.wr * pl.wcp * 16
    assert pl.off_wsb >= pl.off_w + pl.bn * pl.nch * 16
    assert pl.off_stage >= pl.off_wsb + 8 * pl.bn
    assert pl.off_bar >= pl.off_stage + pl.consumers * ik.TILE_COLS * pl.stage_pitch
    for off in (pl.off_codes, pl.off_w, pl.off_wsb, pl.off_stage, pl.off_bar):
        assert off % 128 == 0
    assert pl.smem == pl.off_bar + 16 * pl.stages
    assert pl.consumers in ik.CONSUMER_COUNTS
    assert pl.stages in ik.ring_depths(pl.consumers)  # each consumer owns its stages
    assert 1 <= pl.grid <= pl.items and pl.groups * pl.bn > 0
    assert pl.nch % 2 == 0 and pl.ksteps * 2 == pl.nch and pl.planes2 % 2 == 0
    assert pl.wr <= 256 and pl.wc <= 256 and pl.cbox <= ik.BOX_CHANNELS  # TMA box extents
    assert pl.stage_pitch % 16 == 0


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("esize,batch", [(2, BATCH), (4, 8)])
def test_plan_every_block(config, esize, batch):
    """Every one of the 66 blocks, in bf16 at batch 128 and in float32 at
    batch 8 (the contract's float32 steps): TMA but for the s2d stem (the
    ring, 8-byte copies of its 24-byte pixels), a layout within 227 KB, a
    grid no larger than the tiles, the TMA rules on every TMA input's
    offset and strides (the C2f slices included), and the whole output
    tiled once. bf16 tiles are 64 columns wide."""
    blocks = block_inputs(config)
    assert len(blocks) == 66
    ring = []
    for name, shape, strides, offset, co, k, s, p in blocks:
        pl = plan_block(shape, strides, offset, co, k, s, p, batch=batch, esize=esize)
        ho, wo = ik._out_hw(shape[2], shape[3], k, s, p)
        assert esize == 4 or pl.cols == min(ik.TILE_COLS, wo)
        check_layout(pl)
        if pl.route == ik.ROUTE_RING:
            ring.append((name, pl.vbytes))
        else:
            assert strides[1] == 1 and shape[1] % 16 == 0 and offset % 16 == 0
            assert all(st * 2 % 16 == 0 for st in (strides[0], strides[2], strides[3]))
            assert pl.nbox * pl.cbox == shape[1] and pl.cbox % 16 == 0
            assert pl.tx_bytes == pl.nbox * pl.wr * pl.wc * pl.cbox * esize <= pl.raw_bytes
        assert pl.tiles_y * pl.tm >= ho > (pl.tiles_y - 1) * pl.tm
        assert pl.tiles_x * pl.cols >= wo > (pl.tiles_x - 1) * pl.cols
        assert pl.items == batch * pl.tiles_y * pl.tiles_x * pl.groups
    assert ring == [("m0s2d", 8 if esize == 2 else 16)]


def test_plan_c2f_slices_take_tma():
    """The bottlenecks' inputs are channel slices of cv1's output: at channel
    16, 32, 64 and 128 of twice as many, a 32-256 byte offset and a pixel
    stride of 64-512 bytes, all TMA; the slices at every offset the model
    uses appear in the forwards."""
    offsets = set()
    for config in CONFIGS:
        for name, shape, strides, offset, co, k, s, p in block_inputs(config):
            if offset:
                assert strides[3] == 2 * shape[1] and offset == 2 * shape[1]
                offsets.add(shape[1])
                assert plan_block(shape, strides, offset, co, k, s, p).route == ik.ROUTE_TMA
    assert offsets == {16, 32, 64, 128}


@pytest.mark.parametrize("esize,vbytes", [(2, 2), (4, 4)])
def test_plan_plain_stem_takes_the_ring(esize, vbytes):
    """``eval``'s plain stem (ci 3, k3 s2): 6- or 12-byte pixels, one
    element per copy (plain loads for bf16, 4-byte cp.async for float32);
    its window padded to one plane of 16 codes."""
    (name, shape, strides, offset, co, k, s, p), *_ = block_inputs("deploy", plain_stem=True)
    assert name == "m0" and shape[1] == 3 and strides[1] == 1
    pl = plan_block(shape, strides, offset, co, k, s, p, esize=esize)
    assert (pl.route, pl.vbytes, pl.planes, pl.cr, pl.nch) == (ik.ROUTE_RING, vbytes, 1, 16, 18)
    check_layout(pl)


@pytest.mark.parametrize("strides,ptr,want", [
    ((16 * 40 * 48, 1, 16 * 48, 16), 0, (ik.ROUTE_TMA, 0)),        # channels_last
    ((64 * 40 * 48, 1, 64 * 48, 64), 32, (ik.ROUTE_TMA, 0)),       # a slice at channel 16
    ((24 * 40 * 48, 1, 24 * 48, 24), 8, (ik.ROUTE_RING, 8)),       # 8 bytes off alignment
    ((16 * 40 * 48, 40 * 48, 48, 1), 0, (ik.ROUTE_RING, 2)),       # NCHW: one element a copy
])
def test_input_route(strides, ptr, want):
    assert ik.input_route(16, 2, strides, ptr) == want


def test_geo_fields_mirror_the_kernel():
    """The planner's fields, in order, are ``struct Geo`` of
    csrc/int8conv.cu, which the kernel takes as it is."""
    src = (Path(ik.__file__).parent / "csrc" / "int8conv.cu").read_text()
    body = re.search(r"struct Geo \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"\b(\w+)[,;]", re.sub(r"\bint\b", "", body))
    assert tuple(fields) == ik.GEO_FIELDS
    assert f"kGeoFields = {len(fields)};" in src


def test_a_layout_no_route_takes_raises():
    """A 1x1 block over 8192 channels: one window row of 64 pixels is 1 MB
    of bf16, more than shared memory holds; the planner raises, and so does
    the wrapper before any launch."""
    with pytest.raises(ValueError, match="fits"):
        plan_block((1, 8192, 8, 64), (8192 * 8 * 64, 1, 8192 * 64, 8192), 0, 64, 1, 1, 0)


def test_tile_walk_covers_every_output_once():
    """The kernel's walk (block i takes items i, i + grid, ...; consumer
    warpgroup w of a block every ``consumers``-th of them; item -> (sample,
    tile row, tile column, group)), mirrored here: every output pixel and
    channel group once, each block on one group, across sample boundaries."""
    pl = plan_block((1, 64, 23, 30), (64 * 23 * 30, 1, 64 * 30, 64), 0, 128, 3, 1, 1, batch=5)
    ho, wo = ik._out_hw(23, 30, 3, 1, 1)
    for grid in (pl.groups, 3 * pl.groups, 7 * pl.groups):
        seen = set()
        for blk in range(grid):
            for wg in range(pl.consumers):
                for item in range(blk + wg * grid, pl.items, pl.consumers * grid):
                    assert item % pl.groups == blk % pl.groups
                    t = item // pl.groups
                    tx, ty, b = t % pl.tiles_x, t // pl.tiles_x % pl.tiles_y, t // (
                        pl.tiles_x * pl.tiles_y)
                    for r in range(min(pl.tm, ho - ty * pl.tm)):
                        for m in range(min(pl.cols, wo - tx * pl.cols)):
                            key = (b, ty * pl.tm + r, tx * pl.cols + m, item % pl.groups)
                            assert key not in seen
                            seen.add(key)
        assert len(seen) == 5 * ho * wo * pl.groups


# ---------------------------------------------------------------------------
# Kernel F's plan (int8conv.scale_plan): its route, vector width and blocks
# per sample, and the kernel's walk of a sample modelled here.
# ---------------------------------------------------------------------------

def first_design_slow(shape, strides, offset, base=1 << 20) -> bool:
    """F's first design took its per-element loop (three integer divisions
    per element) unless its vectors per pixel divided its 256 threads."""
    c = shape[1]
    vec = next((v for v in (8, 4) if c % v == 0 and (base + offset) % (2 * v) == 0
                and all(st % v == 0 for st in (strides[0], strides[2], strides[3]))), 1)
    return 256 % (c // vec) != 0


def scale_plan_of(shape, strides, offset, batch=BATCH, esize=2, base=1 << 20, sms=132):
    return ik.scale_plan((batch, *shape[1:]), strides, esize, base + offset, sms)


def walk_offsets(pl: ik.ScalePlan, address: int, esize: int) -> list[int]:
    """The element offsets one sample's units read, as the kernel computes
    them: the span from its first 16-byte boundary (elements before it and
    after the last whole vector one at a time), or a grid unit k split by
    the multiply-high divisions into (i0, i1, i2)."""
    if pl.route == ik.SCALE_SPAN:
        head = min(pl.units, (16 - address % 16) % 16 // esize)
        nvec = (pl.units - head) // pl.vec
        body = [head + k * pl.vec + e for k in range(nvec) for e in range(pl.vec)]
        return list(range(head)) + body + list(range(head + nvec * pl.vec, pl.units))
    (_, n1, n2), (s0, s1, s2) = pl.dims, pl.strides
    (m1, l1), (m2, l2) = ik.fast_div(n1), ik.fast_div(n2)
    out = []
    for k in range(pl.units):
        r = ((k * m2 >> 32) + k) >> l2
        i0 = ((r * m1 >> 32) + r) >> l1
        out += [i0 * s0 + (r - i0 * n1) * s1 + (k - r * n2) * s2 + e for e in range(pl.vec)]
    return out


def element_offsets(shape, strides) -> list[int]:
    c, h, w = shape[1:]
    _, sc, sh, sw = strides
    return [ci * sc + y * sh + xi * sw for ci in range(c) for y in range(h) for xi in range(w)]


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("esize,batch", [(2, BATCH), (2, 1), (4, 8)])
def test_scale_plan_every_input(config, esize, batch):
    """Every one of the int8 forward's 66 inputs gets 16-byte vectors: 58
    dense samples (the stem's padded input and the concatenated C2f inputs
    among them) read flat, the 8 bottleneck halves of cv1's output (pixels
    of C channels at a pitch of 2C) as a grid of pixels; none takes single
    elements. At batch 128 two blocks per sample fill the 264 resident
    blocks, at batch 1 eight (the cluster's most). At deploy, these are the
    11 inputs the first design read element by element."""
    blocks = block_inputs(config)
    assert len(blocks) == 66
    routes = {}
    for name, shape, strides, offset, *_ in blocks:
        pl = scale_plan_of(shape, strides, offset, batch=batch, esize=esize)
        routes[name] = pl.route
        assert pl.vec == 16 // esize, name
        if pl.route == ik.SCALE_GRID:
            assert offset and strides[3] == 2 * shape[1] and pl.dims[2] * pl.vec == shape[1]
            assert pl.strides == (strides[2], strides[3], pl.vec)
        else:
            assert pl.units == shape[1] * shape[2] * shape[3]
        per_block = ik.F_THREADS * ik.F_UNROLL * pl.vec
        work = -(-shape[1] * shape[2] * shape[3] // per_block)
        assert pl.cluster == min({BATCH: 2, 1: 8, 8: 8}[batch], work), name
    grid = sorted(n for n, r in routes.items() if r == ik.SCALE_GRID)
    assert len(grid) == 8 and all(".m0.cv1" in n for n in grid)
    if config != "deploy":
        return
    slow = [(n, sh) for n, sh, st, off, *_ in blocks if first_design_slow(sh, st, off)]
    assert len(slow) == 11 and all(routes[n] == ik.SCALE_SPAN for n, _ in slow)
    assert {sh[1] for _, sh in slow} == {12, 48, 96, 192, 384}
    assert ("m0s2d", (1, 12, 369, 481)) in slow


@pytest.mark.parametrize("case,shape,strides,offset,esize,want", [
    # (route, vec, cluster) at the case's batch
    ("channel slice", (128, 32, 92, 120), (706560, 1, 7680, 64), 64, 2,
     (ik.SCALE_GRID, 8, 2)),
    ("slice 8 bytes off", (4, 16, 20, 24), (11520, 1, 576, 24), 8, 2, (ik.SCALE_GRID, 4, 1)),
    ("slice 4 bytes off", (4, 16, 20, 24), (11520, 1, 576, 24), 4, 2, (ik.SCALE_GRID, 2, 1)),
    ("C = 12, dense", (4, 12, 49, 65), (38220, 1, 780, 12), 0, 2, (ik.SCALE_SPAN, 8, 2)),
    ("C = 12 of 24, bf16", (3, 12, 21, 19), (9576, 1, 456, 24), 24, 2, (ik.SCALE_GRID, 4, 1)),
    ("C = 12 of 24, float32", (3, 12, 21, 19), (9576, 1, 456, 24), 48, 4,
     (ik.SCALE_GRID, 4, 1)),
    ("batch 1, 64 x 184 x 240", (1, 64, 184, 240), (2826240, 1, 15360, 64), 0, 2,
     (ik.SCALE_SPAN, 8, 8)),
    ("NCHW slice", (2, 16, 20, 24), (15360, 480, 24, 1), 1440, 4, (ik.SCALE_SPAN, 4, 1)),
    ("every other column", (2, 16, 20, 12), (15360, 480, 24, 2), 0, 4, (ik.SCALE_GRID, 1, 1)),
])
def test_scale_plan_layouts(case, shape, strides, offset, esize, want):
    """The route, vector width and blocks per sample of layouts beside the
    deploy step's; the kernel's walk of one sample (the last, whose start
    moves with the sample stride) reads each of its elements once."""
    base = 1 << 20
    pl = ik.scale_plan(shape, strides, esize, base + offset, 132)
    assert (pl.route, pl.vec, pl.cluster) == want
    if shape[1] * shape[2] * shape[3] <= 200_000:
        address = base + offset + (shape[0] - 1) * strides[0] * esize
        got = walk_offsets(pl, address, esize)
        assert sorted(got) == sorted(element_offsets(shape, strides))


def test_scale_walk_of_the_deploy_grid_inputs():
    """The 8 grid inputs' walk, a sample each: every element of the slice
    once, none of the other half's channels."""
    for name, shape, strides, offset, *_ in block_inputs("deploy"):
        pl = scale_plan_of(shape, strides, offset)
        if pl.route == ik.SCALE_GRID:
            got = walk_offsets(pl, (1 << 20) + offset, 2)
            assert len(got) == len(set(got)) == shape[1] * shape[2] * shape[3], name
            assert set(got) == set(element_offsets(shape, strides)), name


def test_fast_div_is_exact():
    """``(umulhi(n, mul) + n) >> shift == n // d`` for every divisor the
    plans use and others, at n up to 2^31 - 1; mul fits 32 bits."""
    rng = np.random.default_rng(12)
    ns = np.concatenate([np.arange(5000), rng.integers(0, 2 ** 31, 20000),
                         2 ** 31 - 1 - np.arange(5000)]).astype(object)
    divisors = list(range(1, 300)) + [460, 2760, 44160, 2 ** 20, 2 ** 20 + 1, 3 ** 19,
                                      2 ** 30 - 1, 2 ** 30, 2 ** 30 + 1, 2 ** 31 - 1]
    for d in divisors:
        mul, shift = ik.fast_div(d)
        assert 0 < mul < 2 ** 32
        for n in ns:
            assert ((n * mul >> 32) + n) >> shift == n // d, (d, n)


def test_scale_constants_mirror_the_kernel():
    """F's launch constants and routes are the kernel's (csrc/int8conv.cu)."""
    src = (Path(ik.__file__).parent / "csrc" / "int8conv.cu").read_text()
    for name, value in (("kFThreads", ik.F_THREADS), ("kFBlocksPerSm", ik.F_BLOCKS_PER_SM),
                        ("kFUnroll", ik.F_UNROLL), ("kFMaxCluster", ik.F_MAX_CLUSTER),
                        ("kScaleSpan", ik.SCALE_SPAN), ("kScaleGrid", ik.SCALE_GRID)):
        assert f"constexpr int {name} = {value};" in src, name


# ---------------------------------------------------------------------------
# The kernel's fast divisions (csrc/int8conv.cu, quantize_fast and silu_fast)
# modelled in numpy: float32 values, an FMA as the float64 sum of an exact
# float32 product cast back once, rcp.approx as the rounded reciprocal moved
# by up to 1 ulp. Wherever the fast form's code or bf16 output differs from
# the exact one's (the IEEE quotient; for SiLU, y times the IEEE reciprocal),
# its test must fire (the kernel then redoes the value).
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _bf16(v):
    bits = v.view(np.uint32).astype(np.uint64)
    return (((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("scale,spread", [(0.0371, 2.0), (1.3e-3, 0.1), (0.25, 40.0)])
def test_fast_quantize_redoes_every_misrounding(scale, spread):
    rng = np.random.default_rng(9)
    n = 2_000_000
    x = (rng.standard_normal(n) * spread).astype(np.float32)
    s = np.full(n, scale, np.float32)
    rcp = (1.0 / s.astype(np.float64)).astype(np.float32)
    q0 = x * rcp
    q1 = _fma(_fma(-s, q0, x), rcp, q0)
    t = np.clip(np.where(np.abs(q0) < 1024, q1, q0), -127, 127).astype(np.float32)
    flag = np.abs(t - np.rint(t)) > np.float32(0.499969482421875)
    exact = np.clip((x.astype(np.float64) / scale).astype(np.float32), -127, 127)
    assert not ((np.rint(t) != np.rint(exact)) & ~flag).any()
    assert flag.mean() < 1e-3


@pytest.mark.parametrize("spread", [4.0, 0.5])
def test_fast_silu_redoes_every_misrounding(spread):
    rng = np.random.default_rng(10)
    n = 2_000_000
    y = _bf16((rng.standard_normal(n) * spread).astype(np.float32))
    d = (np.float32(1) + np.exp(-y.astype(np.float64)).astype(np.float32)).astype(np.float32)
    rcp = (1.0 / d.astype(np.float64)).astype(np.float32)
    r = (rcp.view(np.int32) + rng.integers(-1, 2, n).astype(np.int32)).view(np.float32)
    r1 = _fma(_fma(-d, r, np.ones_like(d)), r, r)
    p = y * r1
    low = (p.view(np.uint32) & 0xFFFF).astype(np.int64)
    flag = ((low - 0x7FFC) >= 0) & ((low - 0x7FFC) <= 8) | ~(d < 2.0 ** 40) | (
        (np.abs(y) < 2.0 ** -40) & (y != 0))
    exact = y * rcp  # y times the IEEE reciprocal, rounded once
    assert not ((_bf16(p) != _bf16(exact)) & ~flag).any()
    assert flag.mean() < 1e-2


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel E runs on the card only)")
    return torch.device("cuda")


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.dtype == torch.bfloat16:
        ia, ib, top = a.view(torch.int16).long(), b.view(torch.int16).long(), -(1 << 15)
    else:
        ia, ib, top = a.view(torch.int32).long(), b.view(torch.int32).long(), -(1 << 31)
    order = lambda i: torch.where(i < 0, top - i, i)
    return int((order(ia) - order(ib)).abs().max()) if a.numel() else 0


def hold(x, co, k, s, p, xscale=None, seed=0):
    """Kernel E against its plain version: two launches equal, bit-equal
    before SiLU, within 1 ulp after."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    c = x.shape[1]
    qw = torch.randint(-127, 128, (co, k, k, c), generator=g, device=x.device).to(torch.int8)
    qp = ik.pack_qweight(qw)
    ws = torch.rand(co, generator=g, device=x.device) * 0.02 + 1e-3
    b = torch.randn(co, generator=g, device=x.device) * 0.5
    xs = ik.act_scale_per_sample(x) if xscale is None else xscale
    args = (x, qp, ws, b, xs, k, s, p)
    lin = [ik.int8_conv2d(*args, act=False) for _ in range(2)]
    assert torch.equal(lin[0], lin[1])
    plain = ik.int8_conv2d_plain(*args, act=False)
    d = (lin[0].float() - plain.float()).abs()
    assert torch.equal(lin[0], plain), (
        f"{int((d > 0).sum())} of {d.numel()} differ, max {float(d.max())}; first at "
        f"{[i.tolist() for i in torch.nonzero(d)[:4]]}")
    got = [ik.int8_conv2d(*args) for _ in range(2)]
    assert torch.equal(got[0], got[1])
    assert ulps(got[0], ik.silu_plain(ik.int8_conv2d_plain(*args, act=False))) <= 1


def act(shape, dtype=torch.bfloat16, scale=2.0, seed=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,co,k,s,p", [
    ((4, 12, 49, 65), 16, 2, 1, 0),      # the s2d stem: the ring, 8-byte copies
    ((4, 3, 96, 128), 16, 3, 2, 1),      # the plain stem: the ring, plain loads
    ((4, 16, 48, 64), 32, 3, 2, 1),      # stride 2: columns split by parity
    ((3, 32, 70, 150), 64, 3, 1, 1),     # tiles ragged in both dimensions
    ((4, 48, 24, 32), 32, 1, 1, 0),      # 1x1, three planes (an odd tap)
    ((2, 256, 12, 16), 256, 3, 1, 1),    # K 2304, co 256 (groups)
    ((1, 256, 23, 30), 32, 3, 1, 1),     # batch 1 at the smallest deploy block
    ((1, 256, 23, 30), 64, 3, 1, 1),
    ((2, 512, 12, 20), 256, 1, 1, 0),    # 1x1 over 512 channels: two TMA boxes
    ((2, 384, 12, 20), 128, 1, 1, 0),    # two boxes of 192
])
def test_kernel_matches_plain_on_card(cuda_device, shape, co, k, s, p):
    hold(act(shape), co, k, s, p)


@pytest.mark.cuda
def test_kernel_layouts_on_card(cuda_device):
    """float32 (also in 32-column tiles), a static 0-d scale, C2f slices at
    every offset the model uses, an 8-byte-misaligned slice, an NCHW input,
    and a walk across 33 samples with scales 1e-3 to 1e3 apart (each tile
    takes its sample's)."""
    hold(act((4, 16, 40, 48), torch.float32), 16, 3, 1, 1)
    hold(act((2, 64, 92, 120), torch.float32), 128, 3, 2, 1)  # 32-column tiles
    x = act((4, 64, 24, 32))
    hold(x, 32, 3, 1, 1, (x.float().abs().max() / 127).reshape(()))
    for c in (16, 32, 64, 128):
        base = act((2, 2 * c, 20, 24))
        hold(base[:, c:], c, 3, 1, 1)
    sl = act((4, 24, 20, 24))[:, 4:20]
    assert sl.data_ptr() % 16 == 8
    hold(sl, 32, 3, 2, 1)
    hold(act((2, 16, 20, 24)).contiguous(), 16, 3, 1, 1)
    walk = act((33, 32, 9, 70)) * torch.logspace(-3, 3, 33, device="cuda").view(-1, 1, 1, 1).to(
        torch.bfloat16)
    hold(walk.contiguous(memory_format=torch.channels_last), 32, 3, 1, 1)


def hold_scale(x):
    """Kernel F against its plain version: two launches equal, bit-equal
    (a NaN sample's scale NaN in both)."""
    got = [ik.act_scale_per_sample(x) for _ in range(2)]
    plain = ik.act_scale_per_sample_plain(x)
    assert torch.equal(got[0], got[1]) or torch.allclose(got[0], got[1], 0, 0, equal_nan=True)
    assert torch.allclose(got[0], plain, rtol=0, atol=0, equal_nan=True), (
        f"max |diff| {float((got[0] - plain).abs().max())}")


@pytest.mark.cuda
def test_scale_matches_plain_on_card(cuda_device):
    """Kernel F on every deploy input layout at batch 2 and 1 and on the
    layouts of :func:`test_scale_plan_layouts`, in bf16 and float32 (each
    sample's span starting off its 16-byte boundary too), with a NaN, an
    infinity and all-zero samples."""
    for batch in (2, 1):
        for name, shape, strides, offset, *_ in block_inputs("deploy"):
            buf = torch.randn(batch * strides[0] + offset // 2 + 8, device="cuda").to(
                torch.bfloat16)
            hold_scale(torch.as_strided(buf, (batch, *shape[1:]), strides, offset // 2))
    for dtype in (torch.bfloat16, torch.float32):
        for off in range(8):
            buf = torch.randn(3 * 12 * 7 * 9 + 8, device="cuda").to(dtype)
            hold_scale(torch.as_strided(buf, (3, 12, 7, 9), (756, 1, 108, 12), off))
        hold_scale(act((3, 24, 21, 19), dtype)[:, 12:])
        hold_scale(act((4, 24, 20, 24), dtype)[:, 4:20])
        hold_scale(act((2, 32, 20, 24), dtype).contiguous()[:, 3:19])
        hold_scale(act((2, 16, 20, 24), dtype).contiguous()[..., ::2])
        special = act((3, 16, 8, 8), dtype)
        special[0] = 0.0
        special[1, 3, 2, 2] = float("nan")
        special[2, 5, 1, 1] = float("-inf")
        hold_scale(special)
