"""int8 inference on the card: the quantized convolution (kernel E) and the
per-sample activation scale (kernel F), hand-written CUDA kernels with their
plain PyTorch versions.

:func:`int8_conv2d` (kernel E) computes ``tti``'s ``Conv`` block in
``qmode="int8"`` / ``"int8s"`` (``tti.model.layers.Conv``, whose
convolution is XLA's int8 ``conv_general_dilated``, not a ``pallas_call``):
the input quantized by its scale, ``clamp(rint(x / s), -127, 127)``, an
int8 x int8 -> int32 convolution with the packed weights, then ``acc *
(xscale * wscale) + bias`` in float32, rounded to the input's dtype, then
SiLU in ``tti``'s form, ``y * sigmoid(y)`` (:func:`silu_plain`).
:func:`act_scale_per_sample` (kernel F) is ``tti``'s
``quantize_act_per_sample`` scale: ``max(absmax, 1e-12) / 127`` per sample,
as its jitted step computes it (the product with float32(1/127)).

Tensors are NCHW-indexed (the port's modules), any strides: a channel slice
of a channels_last tensor is read in place. The output is channels_last.
Weights are packed once at load by :func:`pack_qweight`: ``(co, kh, kw,
ci)`` int8 -> ``(co, Kp)``, K in (kh, kw, ci) order zero-padded to a
multiple of 32.

Each kernel is an operator, ``torch.ops.tti_torch.int8_conv2d`` and
``act_scale_per_sample`` (:func:`tti_torch.kernels.build.register_op`): on
CPU tensors it runs the plain version; on CUDA tensors it launches the
kernel or raises. E's plan depends on the input's address, so it is chosen
in the CUDA implementation at each call, never in a trace. The plain version
quantizes in float32, convolves the
integer values in float64 (exact) and runs the same float32 epilogue in the
same order, so the kernel equals it bit for bit (SiLU's ``expf`` aside, see
``csrc/int8conv.cu``, where what bounds the kernels and their design are
written).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from tti_torch.kernels.build import load_library, register_op

Tensor = torch.Tensor

K_ALIGN = 32  # the packed weights' K padding (one wgmma k32 step)

# Kernel launches (plain-version calls are not counted).
LAUNCHES = {"int8_conv2d": 0, "act_scale_per_sample": 0}

_lib: ctypes.CDLL | None = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPES_BY_SIZE = {4: 0, 2: 1}
_SMS = 132  # H100 SXM; the planners' default, the card's own count at launch


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = load_library("int8conv")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tti_int8_conv2d.argtypes = [p, ll, ll, ll, ll, i, i, i, i, p, i, i, i, i, i, p, p,
                                        p, i, p, i, i, i, i, p, p]
        lib.tti_int8_conv2d.restype = i
        u = ctypes.c_uint
        lib.tti_act_scale_per_sample.argtypes = [p, ll, ll, ll, ll, i, i, i, i, i, i, i, u, i,
                                                 u, i, i, p, p]
        lib.tti_act_scale_per_sample.restype = i
        _lib = lib
    return _lib


def pack_qweight(qweight: Tensor) -> Tensor:
    """``(co, kh, kw, ci)`` int8 -> ``(co, Kp)`` int8, K = kh*kw*ci in that
    order, zero-padded to a multiple of :data:`K_ALIGN`."""
    co = qweight.shape[0]
    flat = qweight.reshape(co, -1)
    k = flat.shape[1]
    return F.pad(flat, (0, (-k) % K_ALIGN)).contiguous()


def _out_hw(h: int, w: int, k: int, stride: int, pad: int) -> tuple[int, int]:
    return (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1


# ---------------------------------------------------------------------------
# Plain versions (CPU path and test oracle)
# ---------------------------------------------------------------------------


# float32(1 / 127): F divides by 127 as tti's jitted step does, by the
# product with the float32 reciprocal (tti_torch.preprocess.letterbox.
# jit_divide; the kernels import no other package of the port, and the
# kernel holds the same constant, kRcp127).
RCP_127 = float.fromhex("0x1.020408p-7")


def act_scale_per_sample_plain(x: Tensor) -> Tensor:
    """(B, C, H, W) -> (B,) float32 ``max(max |x|, 1e-12) / 127`` as
    ``tti``'s jitted step computes it: the product with :data:`RCP_127`."""
    absmax = torch.clamp(x.float().abs().amax(dim=(1, 2, 3)), min=1e-12)
    return absmax * RCP_127


def silu_plain(y: Tensor) -> Tensor:
    """SiLU as ``tti``'s block computes it, ``y * sigmoid(y)``: in float32
    on ``y``'s value, ``sigmoid`` an IEEE reciprocal of ``1 + exp(-y)``, one
    product, rounded once to ``y``'s dtype. ``F.silu`` divides ``y`` by ``1 +
    exp(-y)`` instead, which rounds differently in about one value in four;
    a code of the next block whose quotient lies within that ulp of a
    half-integer then rounds the other way, and each such flip moves the
    outputs it feeds by a quantization step."""
    yf = y.float()
    return (yf * torch.sigmoid(yf)).to(y.dtype)


def quantize_act_plain(x: Tensor, xscale: Tensor) -> Tensor:
    """The int8 codes of ``x`` (as float32): ``clamp(round(x / s), -127,
    127)``, ``s`` per sample ((B,)) or one scale (0-d)."""
    s = xscale.view(-1, 1, 1, 1) if xscale.dim() == 1 else xscale
    return torch.clamp(torch.round(x.float() / s), -127.0, 127.0)


def int8_accumulate_plain(q: Tensor, qweight: Tensor, k: int, stride: int, pad: int) -> Tensor:
    """The exact int32 accumulators of codes ``q`` (B, ci, H, W) with the
    packed weights, as float64 (B, co, Ho, Wo)."""
    co, ci = qweight.shape[0], q.shape[1]
    w = qweight[:, :k * k * ci].reshape(co, k, k, ci).permute(0, 3, 1, 2)
    # float64 products and sums of integers below 2^53 are exact in any
    # order; cuDNN is kept out so that no transform-based algorithm is used.
    with torch.backends.cudnn.flags(enabled=False):
        return F.conv2d(q.double(), w.double(), stride=stride, padding=pad)


def int8_conv2d_plain(x: Tensor, qweight: Tensor, wscale: Tensor, bias: Tensor, xscale: Tensor,
                      k: int, stride: int = 1, pad: int = 0, act: bool = True) -> Tensor:
    """Kernel E's function in plain PyTorch (see :func:`int8_conv2d`)."""
    acc = int8_accumulate_plain(quantize_act_plain(x, xscale), qweight, k, stride, pad)
    xs = xscale.view(-1, 1, 1, 1) if xscale.dim() == 1 else xscale
    y = acc.float() * (xs * wscale.view(1, -1, 1, 1)) + bias.view(1, -1, 1, 1)
    y = y.to(x.dtype)
    if act:
        y = silu_plain(y)
    return y.contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


# Kernel E's planner: the route, the tile and the shared-memory layout of one
# call, in the order of ``struct Geo`` in csrc/int8conv.cu (which takes them as
# they are and checks only what it must).
GEO_FIELDS = ("route", "vbytes", "tm", "stages", "bn", "groups", "cbox", "nbox", "planes",
              "planes2", "cr", "wr", "wc", "wcp", "part", "cols", "tiles_x", "tiles_y", "items",
              "region_bytes", "raw_bytes", "plane_bytes", "codes_bytes", "off_codes", "off_w",
              "off_wsb", "off_stage", "off_bar", "smem", "stage_pitch", "nch", "ksteps",
              "tx_bytes", "grid", "consumers")
ROUTE_TMA, ROUTE_RING = 0, 1
SMEM_LIMIT = 227 * 1024  # dynamic shared memory one block may opt into (H100)
SMEM_SLACK = 128  # the kernel aligns its dynamic shared memory to 128 bytes
TILE_COLS = 64  # rows of one wgmma m64 product: a tile row's output columns, at most
TILE_WIDTHS = (64, 32, 16)  # output columns of a tile, widest first
CONSUMER_COUNTS = (3, 2, 1)  # consumer warpgroups per block, most first
TILE_ROWS = (8, 4, 2, 1)  # output rows of a tile, largest first
BOX_CHANNELS = 256  # a TMA box's largest extent


def ring_depths(consumers: int) -> tuple[int, int]:
    """Raw windows in the ring, most first: multiples of the consumer count
    (consumer c owns the stages s = c mod consumers; see csrc/int8conv.cu)."""
    return (2, 1) if consumers == 1 else (2 * consumers, consumers)


@dataclass(frozen=True)
class ConvPlan:
    """One call of kernel E: the route (``ROUTE_TMA`` or ``ROUTE_RING``),
    ``vbytes`` (the ring's bytes per copy: 16, 8, 4, or 2 for plain loads),
    ``tm`` output rows of ``TILE_COLS`` columns per tile, ``stages`` raw
    windows in the ring, ``bn`` output channels per group (``groups`` =
    co / bn; a block keeps one group's weights), the window (``wr`` rows x
    ``wc`` columns; TMA boxes of ``cbox`` channels, ``nbox`` of them), the
    code planes (``planes`` of 16 channels, ``wcp`` positions per window row,
    columns split by their remainder mod the stride into parts of ``part``),
    the shared-memory offsets, ``grid``, the most blocks the launch uses
    (the kernel lowers it to what is resident at once), and ``consumers``,
    its consumer warpgroups."""

    route: int
    vbytes: int
    tm: int
    stages: int
    bn: int
    groups: int
    cbox: int
    nbox: int
    planes: int
    planes2: int
    cr: int
    wr: int
    wc: int
    wcp: int
    part: int
    cols: int
    tiles_x: int
    tiles_y: int
    items: int
    region_bytes: int
    raw_bytes: int
    plane_bytes: int
    codes_bytes: int
    off_codes: int
    off_w: int
    off_wsb: int
    off_stage: int
    off_bar: int
    smem: int
    stage_pitch: int
    nch: int
    ksteps: int
    tx_bytes: int
    grid: int
    consumers: int

    def as_ints(self) -> list[int]:
        return [getattr(self, f) for f in GEO_FIELDS]


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def _canonical_strides(shape, strides) -> tuple[int, ...]:
    """(sN, sC, sH, sW) with the stride of an extent-1 dimension replaced by
    the one a dense layout would give it (it is never stepped over, and TMA
    checks it)."""
    b, c, h, w = shape
    sn, sc, sh, sw = strides
    if w == 1:
        sw = c * sc if sc == 1 else 1
    if h == 1:
        sh = w * sw
    if b == 1:
        sn = h * sh if sc == 1 else c * sc
    return sn, sc, sh, sw


def input_route(c: int, esize: int, strides, ptr: int) -> tuple[int, int]:
    """(route, bytes per copy) for an input of ``c`` channels, element size
    ``esize``, strides (sN, sC, sH, sW) in elements and base address
    ``ptr``. TMA wherever a tensor map can describe it: channels contiguous
    and a multiple of 16, a 16-byte-aligned base and byte strides that are
    multiples of 16. Otherwise the ``cp.async`` ring: 16-, 8- or 4-byte
    copies of contiguous channels where the sizes and alignments allow,
    else one element per copy (4-byte copies, or plain loads for bf16)."""
    sn, sc, sh, sw = strides
    steps = (sn * esize, sh * esize, sw * esize)
    if sc == 1 and c % 16 == 0 and ptr % 16 == 0 and all(s % 16 == 0 for s in steps):
        return ROUTE_TMA, 0
    if sc == 1:
        for v in (16, 8, 4):
            if (c * esize) % v == 0 and ptr % v == 0 and all(s % v == 0 for s in steps):
                return ROUTE_RING, v
    return ROUTE_RING, esize


def _boxes(c: int) -> int:
    """TMA boxes per window: the fewest of equal channel counts, each a
    multiple of 16 and at most :data:`BOX_CHANNELS`."""
    n = -(-c // BOX_CHANNELS)
    while c % n or (c // n) % 16:
        n += 1
    return n


def _layout(route, vbytes, tm, stages, bn, cols, consumers, *, c, ho, wo, b, co, k, stride,
            esize) -> ConvPlan:
    planes = -(-c // 16)
    planes2 = planes + planes % 2
    cr = 16 * planes
    cols = min(cols, wo)
    wr, wc = (tm - 1) * stride + k, (cols - 1) * stride + k
    part = -(-wc // stride)
    wcp = part * stride
    nbox = _boxes(c) if route == ROUTE_TMA else 1
    cbox = c // nbox if route == ROUTE_TMA else cr
    region = _up(wr * wc * cbox * esize, 128)
    raw = nbox * region
    plane = _up(wr * wcp * 16, 128) + 16  # 16 mod 128: a warp's stores spread over the banks
    codes = _up(planes * plane + 16 * TILE_COLS, 128)  # + a tile row of overread
    nch = k * k * planes2
    pitch = bn * esize + 16
    off_codes = stages * raw
    off_w = off_codes + consumers * codes
    off_wsb = off_w + _up(bn * nch * 16, 128)
    off_stage = off_wsb + _up(8 * bn, 128)
    off_bar = off_stage + consumers * _up(TILE_COLS * pitch, 128)
    tiles_x, tiles_y = -(-wo // cols), -(-ho // tm)
    groups = co // bn
    items = b * tiles_y * tiles_x * groups
    return ConvPlan(route=route, vbytes=vbytes, tm=tm, stages=stages, bn=bn, groups=groups,
                    cbox=cbox, nbox=nbox, planes=planes, planes2=planes2, cr=cr, wr=wr, wc=wc,
                    wcp=wcp, part=part, cols=cols, tiles_x=tiles_x, tiles_y=tiles_y,
                    items=items, region_bytes=region, raw_bytes=raw, plane_bytes=plane,
                    codes_bytes=codes, off_codes=off_codes, off_w=off_w, off_wsb=off_wsb,
                    off_stage=off_stage, off_bar=off_bar, smem=off_bar + 16 * stages,
                    stage_pitch=pitch, nch=nch, ksteps=nch // 2,
                    tx_bytes=nbox * wr * wc * cbox * esize if route == ROUTE_TMA else 0,
                    grid=items, consumers=consumers)


@functools.lru_cache(maxsize=1024)
def plan_conv(b: int, c: int, h: int, w: int, co: int, k: int, stride: int, pad: int,
              esize: int, route: int, vbytes: int, sms: int = _SMS) -> ConvPlan:
    """Kernel E's plan for one call. The widest group of output channels
    whose weights fit beside a one-row window of 64 output columns in the
    shallowest ring (all 66 blocks of both configurations keep all co, but
    the P4/P5 3x3 blocks of 128-256 channels: each group re-quantizes the
    window), else of 32 or 16 columns (a tile row is still one m64 product,
    its other rows discarded: float32 windows at stride 2); three consumer
    warpgroups where they keep that group and width, else two, else one
    (more consumers hide each other's float latency; fewer leave room for
    a wider group: a P4/P5 3x3 block's window is quantized once per group,
    so one consumer and all co beat two and a quarter of it); then the
    tallest tile that fits and
    still gives ``sms`` items (or as many as one-row tiles give); then the
    deepest ring. Raises ``ValueError`` when no tile fits shared memory.
    Cached: a step asks for the same 66 plans every time, and planning on
    every launch cost the host-bound steps frames/s."""
    ho, wo = _out_hw(h, w, k, stride, pad)
    geo = dict(c=c, ho=ho, wo=wo, b=b, co=co, k=k, stride=stride, esize=esize)
    fits = lambda p: p.smem + SMEM_SLACK <= SMEM_LIMIT
    bns = [n for n in (128, 64, 32, 16) if n <= co and co % n == 0]
    options = []  # (cols, bn, consumers) that fit a one-row tile
    for nc in CONSUMER_COUNTS:
        shallow = ring_depths(nc)[-1]
        found = next(((cols, bn) for cols in TILE_WIDTHS for bn in bns if fits(
            _layout(route, vbytes, 1, shallow, bn, cols, nc, **geo))), None)
        if found is not None:
            options.append((*found, nc))
    if not options:
        raise ValueError(f"kernel E: no tile of a ({c}, {h}, {w}) input, k={k}, stride={stride} "
                         f"-> {co} fits {SMEM_LIMIT} bytes of shared memory")
    cols, bn, nc = max(options)
    depths = ring_depths(nc)
    lay = lambda tm, stages: _layout(route, vbytes, tm, stages, bn, cols, nc, **geo)
    one_row = lay(1, depths[-1]).items
    tm = next(t for t in TILE_ROWS if t == 1 or (
        t <= ho and fits(lay(t, depths[-1])) and lay(t, depths[-1]).items >= min(one_row, sms)))
    return lay(tm, next(s for s in depths if fits(lay(tm, s))))


@functools.lru_cache(maxsize=1024)
def _geo(plan: ConvPlan) -> ctypes.Array:
    """The plan as the kernel's ``int geo[]`` (read only by the kernel)."""
    return (ctypes.c_int * len(GEO_FIELDS))(*plan.as_ints())


def _check_input(x: Tensor, what: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{what}: input must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: input must be float32 or bfloat16, got {x.dtype}")
    if x[0].numel() >= 2 ** 31 or x.shape[0] > 65535:
        raise ValueError(f"{what}: input {tuple(x.shape)} too large for one launch")


# Kernel F's launch (csrc/int8conv.cu, kFThreads ... kScaleGrid).
F_THREADS = 1024
F_BLOCKS_PER_SM = 2
F_UNROLL = 4
F_MAX_CLUSTER = 8
SCALE_SPAN, SCALE_GRID = 0, 1


@dataclass(frozen=True)
class ScalePlan:
    """Kernel F's route for one input. ``route``: :data:`SCALE_SPAN` (each
    sample one dense span of ``units`` elements, read as 16-byte vectors
    from its first 16-byte boundary) or :data:`SCALE_GRID` (``dims`` (d0, d1,
    d2) of ``units = d0 * d1 * d2`` units of ``vec`` elements, ``strides`` in
    elements per unit step, d2 contiguous when ``vec`` > 1). ``cluster``:
    blocks per sample."""

    route: int
    vec: int
    units: int
    dims: tuple[int, int, int]
    strides: tuple[int, int, int]
    cluster: int


def fast_div(d: int) -> tuple[int, int]:
    """(mul, shift) with ``n // d == (umulhi(n, mul) + n) >> shift`` for
    every 0 <= n < 2^31 (Granlund and Montgomery; the kernel's fast_div)."""
    shift = (d - 1).bit_length()
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def scale_plan(shape: tuple, strides: tuple, esize: int, address: int,
               sms: int = _SMS) -> ScalePlan:
    """Kernel F's route, vector width and blocks per sample for a (B, C, H,
    W) input with these element strides, element size and data address.

    A sample whose C*H*W elements fill one span (its dimensions of size
    above 1 dense in some order) is read flat. Otherwise its dimensions go
    outermost first by stride, and the innermost is read in 16-, 8- or
    4-byte vectors when it is contiguous and the vector divides its size,
    the other strides and the address; else one element at a time. The
    batch is spread over the resident blocks (``sms`` x
    :data:`F_BLOCKS_PER_SM`), at most :data:`F_MAX_CLUSTER` per sample and
    no more than give each thread :data:`F_UNROLL` vectors."""
    b, n = shape[0], shape[1] * shape[2] * shape[3]
    live = sorted(((st, sz) for sz, st in zip(shape[1:], strides[1:]) if sz > 1), reverse=True)
    dense, span = True, 1
    for st, sz in reversed(live):
        dense, span = dense and st == span, span * sz
    if dense:
        route, vec, units = SCALE_SPAN, 16 // esize, n
        dims, steps = (1, 1, n), (0, 0, 1)
    else:
        live = [(1, 0)] * (3 - len(live)) + [(sz, st) for st, sz in live]
        (d0, s0), (d1, s1), (d2, s2) = live
        vec = next((v for v in (16 // esize, 8 // esize, 4 // esize) if v > 1 and s2 == 1
                    and d2 % v == 0 and address % (v * esize) == 0
                    and all(st % v == 0 for st in (strides[0], s0, s1))), 1)
        route, units = SCALE_GRID, d0 * d1 * (d2 // vec)
        dims, steps = (d0, d1, d2 // vec), (s0, s1, s2 * vec)
    per_block = F_THREADS * F_UNROLL * vec
    cluster = max(1, min(F_MAX_CLUSTER, sms * F_BLOCKS_PER_SM // b, -(-n // per_block)))
    return ScalePlan(route, vec, units, dims, steps, cluster)


@functools.lru_cache(maxsize=1024)
def _scale_args(shape: tuple, strides: tuple, esize: int, align: int, sms: int) -> tuple:
    """The kernel's arguments between the sample stride and the scale
    pointer (``align``: the address mod 16, all the plan reads of it)."""
    pl = scale_plan(shape, strides, esize, align, sms)
    (_, n1, n2), (s0, s1, s2) = pl.dims, pl.strides
    return (s0, s1, s2, shape[0], _DTYPES_BY_SIZE[esize], pl.route, pl.vec, pl.units, n1, n2,
            *fast_div(n1), *fast_div(n2), pl.cluster)


def _launch_scale(x: Tensor) -> Tensor:
    args = _scale_args(tuple(x.shape), x.stride(), x.element_size(), x.data_ptr() % 16,
                       _sm_count(x.device))
    lib = build()
    scale = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tti_act_scale_per_sample(x.data_ptr(), x.stride(0), *args, scale.data_ptr(),
                                           stream)
    if err != 0:
        raise RuntimeError(f"activation-scale kernel launch failed: cudaError {err}")
    LAUNCHES["act_scale_per_sample"] += 1
    return scale


_SCALE_OP = register_op("act_scale_per_sample(Tensor x) -> Tensor",
                        act_scale_per_sample_plain, _launch_scale,
                        lambda x: torch.empty((x.shape[0],), dtype=torch.float32,
                                              device=x.device))


def act_scale_per_sample(x: Tensor) -> Tensor:
    """Kernel F: (B, C, H, W) float32 or bfloat16, any strides -> (B,)
    float32 ``max(absmax, 1e-12) / 127`` per sample."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the activation scale runs on cpu or cuda tensors, got {x.device}")
    _check_input(x, "act_scale_per_sample")
    return _SCALE_OP(x)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_conv(x: Tensor, qweight: Tensor, wscale: Tensor, bias: Tensor, xscale: Tensor,
                 k: int, stride: int, pad: int, act: bool) -> Tensor:
    b, c, h, w = x.shape
    co, kp = qweight.shape
    for name, t, dtype in (("qweight", qweight, torch.int8), ("wscale", wscale, torch.float32),
                           ("bias", bias, torch.float32), ("xscale", xscale, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, the input on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if wscale.shape != (co,) or bias.shape != (co,) or xscale.shape not in ((), (b,)):
        raise ValueError(f"wscale {tuple(wscale.shape)}, bias {tuple(bias.shape)}, xscale "
                         f"{tuple(xscale.shape)} against co={co}, B={b}")
    if co % 16 or kp % K_ALIGN or kp < k * k * c:
        raise ValueError(f"qweight {tuple(qweight.shape)} does not fit k={k}, ci={c}: co must "
                         f"be a multiple of 16, Kp a multiple of {K_ALIGN} >= {k * k * c}")
    out = _conv_out(x, qweight, k, stride, pad)
    ho, wo = out.shape[2:]
    if out.numel() == 0:
        return out
    if out.numel() >= 2 ** 31:
        raise ValueError(f"output {tuple(out.shape)} too large for one launch")
    strides = _canonical_strides(x.shape, x.stride())
    route, vbytes = input_route(c, x.element_size(), strides, x.data_ptr())
    plan = plan_conv(b, c, h, w, co, k, stride, pad, x.element_size(), route, vbytes,
                     _sm_count(x.device))
    geo = _geo(plan)
    lib = build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tti_int8_conv2d(
            x.data_ptr(), *strides, b, c, h, w, qweight.data_ptr(), kp, co, k, stride, pad,
            wscale.data_ptr(), bias.data_ptr(), xscale.data_ptr(), int(xscale.dim() == 1),
            out.data_ptr(), ho, wo, int(act), _DTYPES[x.dtype], geo, stream)
    if err != 0:
        raise RuntimeError(f"int8 convolution kernel launch failed: error {err}")
    LAUNCHES["int8_conv2d"] += 1
    return out


def _conv_out(x: Tensor, qweight: Tensor, k: int, stride: int, pad: int) -> Tensor:
    """E's output, uninitialised: (B, co, Ho, Wo) in ``x``'s dtype,
    channels_last (the CPU, CUDA and fake implementations all make it so,
    strides included)."""
    ho, wo = _out_hw(x.shape[2], x.shape[3], k, stride, pad)
    return torch.empty((x.shape[0], qweight.shape[0], ho, wo), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last)


def _conv_plain_op(x: Tensor, qweight: Tensor, wscale: Tensor, bias: Tensor, xscale: Tensor,
                   k: int, stride: int, pad: int, act: bool) -> Tensor:
    y = int8_conv2d_plain(x, qweight, wscale, bias, xscale, k, stride, pad, act)
    return _conv_out(x, qweight, k, stride, pad).copy_(y)


_CONV_OP = register_op(
    "int8_conv2d(Tensor x, Tensor qweight, Tensor wscale, Tensor bias, Tensor xscale, int k, "
    "int stride, int pad, bool act) -> Tensor",
    _conv_plain_op, _launch_conv,
    lambda x, qweight, wscale, bias, xscale, k, stride, pad, act: _conv_out(
        x, qweight, k, stride, pad))


def int8_conv2d(x: Tensor, qweight: Tensor, wscale: Tensor, bias: Tensor, xscale: Tensor,
                k: int, stride: int = 1, pad: int = 0, act: bool = True) -> Tensor:
    """Kernel E: the quantized ``Conv`` block.

    ``x`` (B, ci, H, W) float32 or bfloat16, any strides; ``qweight`` the
    packed (co, Kp) int8 weights (:func:`pack_qweight`); ``wscale`` and
    ``bias`` (co,) float32; ``xscale`` float32, (B,) per sample
    (``TTI_QUANT=int8``, :func:`act_scale_per_sample`) or 0-d (``int8s``).
    Square kernel ``k``, symmetric zero padding ``pad``. Returns (B, co,
    Ho, Wo) in ``x``'s dtype, channels_last."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the int8 convolution runs on cpu or cuda tensors, got {x.device}")
    _check_input(x, "int8_conv2d")
    return _CONV_OP(x, qweight, wscale, bias, xscale, int(k), int(stride), int(pad), bool(act))
