"""Mask-prototype statistics: two hand-written CUDA kernels and their plain
PyTorch versions (port of ``tti.kernels.maskstats``).

- :func:`mask_stats_soft` (kernel A) replaces the TPU's soft v2 kernel
  ``_stats2s_kernel`` (``instance_mask_stats_soft_pallas2`` and
  ``_batched``). Contract: ``instance_mask_stats_soft_xla``.
- :func:`mask_stats_binary` (kernel B) replaces ``_stats2_kernel`` and
  ``_stats_kernel`` (``instance_mask_stats_pallas2``/``_pallas`` and their
  ``_batched`` forms). Contract: ``instance_mask_stats_xla``, for any D.

Both take a batch: protos (B, Hm, Wm, nm) bf16/f32, coefs (B, D, nm) f32,
boxes_grid (B, D, 4) f32 xyxy on the proto grid, valid (B, D) bool. Each
kernel is an operator, ``torch.ops.tti_torch.mask_stats_soft`` and
``mask_stats_binary`` (:func:`tti_torch.kernels.build.register_op`): on CPU
tensors it runs the plain version; on CUDA tensors it launches the kernel or
raises. The operator returns the moments as one (B, D, 6 or 3) tensor and
the per-column fields in :data:`COLUMN_FIELDS` order; the wrapper rebuilds
the dict. What bounds the kernels and how their design meets it is written
in ``csrc/maskstats.cu``: bytes, the bf16 protos read once per frame and the
per-column outputs of every detection written once.

The kernels cut the work by cells, not by detection: a unit is a strip of
``STRIP_COLS`` columns of one valid box, whose rows go in chunks of
``CHUNK_ROWS`` to the warps of one block; the chunks' per-column carries
(bottom row, p there, p under it) are combined in order, the strips' moments
are added in order by a second small launch, and invalid detections cost a
fill of zeros and -1. Nothing is read back to the host and nothing is added
by float atomics: two calls on the same input return the same bits.
:func:`mask_stats_chunked_plain` is that decomposition in plain PyTorch, for
tests of its logic where there is no card.

Dtype policy (the reference's ``_logits_dtype``): the binary path thresholds
f32 logits; the soft path rounds coefs to bf16 and the f32-accumulated
logits to bf16 before the sigmoid. ``logits_dtype`` selects either.

The shared library is built with nvcc at first use into ``build/`` at the
repository root, from ``csrc/maskstats.cu`` alone, and bound with ctypes
(:mod:`tti_torch.kernels.build`).
"""

from __future__ import annotations

import ctypes

import torch

from tti_torch.kernels.build import load_library, register_op

Tensor = torch.Tensor

# The kernels' tiling (``kStrip`` and ``kChunk`` of csrc/maskstats.cu): a unit
# of work is a strip of columns of one box, its rows cut into chunks.
STRIP_COLS = 32
CHUNK_ROWS = {"mask_stats_soft": 4, "mask_stats_binary": 2}

# The operators' outputs: the moments, in the order of their last axis, then
# the per-column fields.
MOMENTS = {"mask_stats_soft": ("m00", "m10", "m01", "m00s", "m10s", "m01s"),
           "mask_stats_binary": ("m00", "m10", "m01")}
COLUMN_FIELDS = {"mask_stats_soft": ("col_any", "bottom", "col_p", "bottom_sub"),
                 "mask_stats_binary": ("col_any", "bottom")}

# Wrapper calls that launched their kernel (plain-version calls are not
# counted; one call is one count, whatever it launches on the device).
LAUNCHES = {"mask_stats_soft": 0, "mask_stats_binary": 0}

_lib: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = load_library("maskstats")
        p, i = ctypes.c_void_p, ctypes.c_int
        common = [p, i, p, p, p, i, i, i, i, i, i, i, i]
        lib.tti_mask_stats_soft.argtypes = common + [p, p, p, p, p, p, p, p]
        lib.tti_mask_stats_binary.argtypes = common + [p, p, p, p, p]
        for fn in (lib.tti_mask_stats_soft, lib.tti_mask_stats_binary,
                   lib.tti_mask_stats_strip_cols, lib.tti_mask_stats_chunk_rows):
            fn.restype = i
        lib.tti_mask_stats_chunk_rows.argtypes = [i]
        tiling = (lib.tti_mask_stats_strip_cols(),
                  {"mask_stats_soft": lib.tti_mask_stats_chunk_rows(1),
                   "mask_stats_binary": lib.tti_mask_stats_chunk_rows(0)})
        if tiling != (STRIP_COLS, CHUNK_ROWS):
            raise RuntimeError(f"maskstats.cu is tiled {tiling}, the wrapper expects "
                               f"{(STRIP_COLS, CHUNK_ROWS)}")
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Plain versions (the dense einsum formulation; CPU path and test oracle)
# ---------------------------------------------------------------------------


def _logits(protos: Tensor, coefs: Tensor, logits_dtype: torch.dtype) -> Tensor:
    """(B, D, Hm, Wm) f32 logits, rounded to bf16 when asked (after an f32
    accumulation of bf16 inputs)."""
    if logits_dtype == torch.bfloat16:
        c = coefs.to(torch.bfloat16).float()
        p = protos.to(torch.bfloat16).float()
        return torch.einsum("bdc,bhwc->bdhw", c, p).to(torch.bfloat16).float()
    if logits_dtype != torch.float32:
        raise ValueError(f"logits_dtype must be float32 or bfloat16, got {logits_dtype}")
    return torch.einsum("bdc,bhwc->bdhw", coefs.float(), protos.float())


def _grid(protos: Tensor, boxes_grid: Tensor, valid: Tensor):
    hm, wm = protos.shape[1], protos.shape[2]
    ys = torch.arange(hm, dtype=torch.float32, device=protos.device).view(1, 1, hm, 1)
    xs = torch.arange(wm, dtype=torch.float32, device=protos.device).view(1, 1, 1, wm)
    bx = lambda i: boxes_grid[..., i, None, None].float()
    inside = (xs >= bx(0)) & (xs < bx(2)) & (ys >= bx(1)) & (ys < bx(3))
    return ys, xs, inside & valid[..., None, None]


def _binary_fields(mask: Tensor, ys: Tensor, xs: Tensor) -> dict[str, Tensor]:
    return {
        "m00": mask.sum((2, 3)),
        "m10": (mask * xs).sum((2, 3)),
        "m01": (mask * ys).sum((2, 3)),
        "col_any": mask.amax(2),
        "bottom": torch.where(mask > 0, ys, -1.0).amax(2),
    }


def mask_stats_binary_plain(protos: Tensor, coefs: Tensor, boxes_grid: Tensor, valid: Tensor,
                            logits_dtype: torch.dtype = torch.float32) -> dict[str, Tensor]:
    """Dense binary statistics: mask = logits > 0 inside the box, valid rows."""
    ys, xs, inside = _grid(protos, boxes_grid, valid)
    mask = ((_logits(protos, coefs, logits_dtype) > 0.0) & inside).float()
    return _binary_fields(mask, ys, xs)


def mask_stats_soft_plain(protos: Tensor, coefs: Tensor, boxes_grid: Tensor, valid: Tensor,
                          logits_dtype: torch.dtype = torch.bfloat16) -> dict[str, Tensor]:
    """Dense occupancy-aware statistics: the binary fields of p >= 0.5, the
    probability moments, per-column max p and the sub-cell lower boundary
    bottom + clip((p_b - 0.5) / max(p_b - p_below, 1e-6), 0, 1)."""
    ys, xs, inside = _grid(protos, boxes_grid, valid)
    p = torch.where(inside, torch.sigmoid(_logits(protos, coefs, logits_dtype)), 0.0)
    out = _binary_fields((p >= 0.5).float(), ys, xs)
    bottom = out["bottom"]
    p_b = torch.where(ys == bottom[:, :, None, :], p, 0.0).sum(2)
    p_below = torch.where(ys == bottom[:, :, None, :] + 1.0, p, 0.0).sum(2)
    frac = torch.clamp((p_b - 0.5) / torch.clamp(p_b - p_below, min=1e-6), 0.0, 1.0)
    out.update({
        "m00s": p.sum((2, 3)),
        "m10s": (p * xs).sum((2, 3)),
        "m01s": (p * ys).sum((2, 3)),
        "bottom_sub": torch.where(bottom >= 0, bottom + frac, -1.0),
        "col_p": p.amax(2),
    })
    return out


# ---------------------------------------------------------------------------
# The kernels' decomposition in plain PyTorch
# ---------------------------------------------------------------------------


def _cell_range(lo: Tensor, hi: Tensor, n: int) -> tuple[Tensor, Tensor]:
    """The integers i of [0, n) with lo <= i < hi, as [ilo, ihi); a NaN bound
    gives none (the kernels' ``cell_range``)."""
    ilo = torch.where(lo > 0, torch.clamp(torch.ceil(lo), max=n), 0.0)
    ihi = torch.where(hi < n, torch.clamp(torch.ceil(hi), min=0), float(n))
    ihi = torch.maximum(ihi, ilo)
    nan = torch.isnan(lo) | torch.isnan(hi)
    return torch.where(nan, 0.0, ilo).long(), torch.where(nan, 0.0, ihi).long()


def mask_stats_chunked_plain(soft: bool, protos: Tensor, coefs: Tensor, boxes_grid: Tensor,
                             valid: Tensor, logits_dtype: torch.dtype | None = None,
                             chunk: int | None = None, strip: int = STRIP_COLS
                             ) -> dict[str, Tensor]:
    """The statistics computed the way the kernels cut the work, for tests of
    that logic where no card is present: integer cell ranges per box, rows in
    chunks of ``chunk`` grid rows that each yield per-column partials (bottom,
    p there, p of the row under it inside the chunk, p of the first row, max
    p) and moments per strip of ``strip`` columns, then the chunks combined
    bottom-up and a detection's strips added in order."""
    if logits_dtype is None:
        logits_dtype = torch.bfloat16 if soft else torch.float32
    if chunk is None:
        chunk = CHUNK_ROWS["mask_stats_soft" if soft else "mask_stats_binary"]
    _, hm, wm, _ = protos.shape
    x0, x1 = _cell_range(boxes_grid[..., 0], boxes_grid[..., 2], wm)
    y0, y1 = _cell_range(boxes_grid[..., 1], boxes_grid[..., 3], hm)
    live = valid & (x1 > x0) & (y1 > y0)
    x0, x1, y0, y1 = (torch.where(live, t, 0)[..., None] for t in (x0, x1, y0, y1))
    xs = torch.arange(wm, device=protos.device)
    cols = (xs >= x0) & (xs < x1)  # (B, D, Wm)
    nstrips = -(-wm // strip)
    per_strip = lambda t: torch.nn.functional.pad(t, (0, nstrips * strip - wm)).reshape(
        *t.shape[:-1], nstrips, strip).sum(-1)
    zeros = lambda: torch.zeros(cols.shape, dtype=torch.float32, device=protos.device)
    parts, moments = [], [0.0] * (6 if soft else 3)
    for r0 in range(0, hm, chunk):
        rows = range(r0, min(r0 + chunk, hm))
        logits = _logits(protos[:, rows.start:rows.stop], coefs, logits_dtype)
        bot, p_b, p_below, first_p, cp = zeros() - 1, zeros(), zeros(), zeros(), zeros()
        sums = [zeros() for _ in moments]
        for j, y in enumerate(rows):
            inside = cols & (y >= y0) & (y < y1)
            lg = logits[:, :, j]
            if soft:
                p = torch.where(inside, torch.sigmoid(lg), 0.0)
                occ = inside & (p >= 0.5)
                first_p = torch.where(inside & (y == torch.clamp(y0, min=r0)), p, first_p)
                p_below = torch.where(occ, 0.0, torch.where(
                    inside & (bot >= 0) & (bot + 1 == y), p, p_below))
                p_b = torch.where(occ, p, p_b)
                cp = torch.maximum(cp, p)
                for k, w in enumerate((1.0, xs.float(), float(y))):
                    sums[3 + k] = sums[3 + k] + p * w
            else:
                occ = inside & (lg > 0)
            bot = torch.where(occ, float(y), bot)
            for k, w in enumerate((1.0, xs.float(), float(y))):
                sums[k] = sums[k] + occ.float() * w
        # A chunk outside the box's rows is never visited: its first-row p is
        # not a number, so that a combine that read it would show.
        visited = (r0 < y1) & (r0 + chunk > y0)
        parts.append((bot, p_b, p_below, torch.where(visited, first_p, float("nan")), cp))
        moments = [m + per_strip(s) for m, s in zip(moments, sums)]

    # Ordered combine, bottom-up: the lowest chunk with an occupied cell.
    bot, p_b, p_below, cp = zeros() - 1, zeros(), zeros(), zeros()
    for c in reversed(range(len(parts))):
        c_bot, c_pb, c_pbelow, _, c_cp = parts[c]
        take = (bot < 0) & (c_bot >= 0)
        under = c_bot + 1  # on a chunk's last row: the next chunk's first row
        crosses = (under == (c + 1) * chunk) & (under < y1)
        if c + 1 < len(parts):
            c_pbelow = torch.where(crosses, parts[c + 1][3], c_pbelow)
        bot, p_b = torch.where(take, c_bot, bot), torch.where(take, c_pb, p_b)
        p_below = torch.where(take, c_pbelow, p_below)
        cp = torch.maximum(cp, c_cp)
    strips = torch.arange(nstrips, device=protos.device)
    owned = live[..., None] & (strips >= x0 // strip) & (strips < (x1 - 1) // strip + 1)
    m = [torch.where(owned, t, 0.0).sum(-1) for t in moments]
    out = {"m00": m[0], "m10": m[1], "m01": m[2], "col_any": (bot >= 0).float(), "bottom": bot}
    if soft:
        frac = torch.clamp((p_b - 0.5) / torch.clamp(p_b - p_below, min=1e-6), 0.0, 1.0)
        out.update({"m00s": m[3], "m10s": m[4], "m01s": m[5], "col_p": cp,
                    "bottom_sub": torch.where(bot >= 0, bot + frac, -1.0)})
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(protos: Tensor, coefs: Tensor, boxes_grid: Tensor, valid: Tensor,
           logits_dtype: torch.dtype) -> None:
    if protos.dim() != 4 or coefs.dim() != 3 or boxes_grid.dim() != 3 or valid.dim() != 2:
        raise ValueError("expected protos (B,Hm,Wm,nm), coefs (B,D,nm), boxes (B,D,4), valid (B,D)")
    b, _, _, nm = protos.shape
    d = coefs.shape[1]
    if coefs.shape != (b, d, nm) or boxes_grid.shape != (b, d, 4) or valid.shape != (b, d):
        raise ValueError(
            f"shape mismatch: protos {tuple(protos.shape)}, coefs {tuple(coefs.shape)}, "
            f"boxes {tuple(boxes_grid.shape)}, valid {tuple(valid.shape)}")
    if protos.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"protos must be bfloat16 or float32, got {protos.dtype}")
    for name, t, dt in (("coefs", coefs, torch.float32), ("boxes_grid", boxes_grid, torch.float32),
                        ("valid", valid, torch.bool)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    for name, t in (("protos", protos), ("coefs", coefs), ("boxes_grid", boxes_grid),
                    ("valid", valid)):
        if t.device != protos.device:
            raise ValueError(f"{name} is on {t.device}, protos on {protos.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if logits_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"logits_dtype must be float32 or bfloat16, got {logits_dtype}")


def blocks_per_frame(b: int, wm: int) -> int:
    """Thread blocks a frame's strips are dealt to. At least enough for a box
    over the whole width plus a few small ones, so that most blocks hold one
    strip; more when the batch is small, up to about 2048 blocks in all (each
    block lists its frame's strips first, which costs about a microsecond)."""
    return max(-(-wm // STRIP_COLS) + 8, min(-(-2048 // b), 128))


def _launch(soft: bool, protos: Tensor, coefs: Tensor, boxes_grid: Tensor, valid: Tensor,
            logits_dtype: torch.dtype) -> tuple[Tensor, ...]:
    b, hm, wm, nm = protos.shape
    if b > 65535:
        raise ValueError(f"at most 65535 frames per launch, got {b}")
    lib = build()
    d = coefs.shape[1]
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=protos.device)
    m = new(b, d, 6 if soft else 3)
    cols = tuple(new(b, d, wm) for _ in range(4 if soft else 2))
    if b * d == 0:
        return (m, *cols)
    col_any, bottom, *extra = cols
    # Scratch: the moments of every (frame, detection, strip); the kernel
    # writes what it reads, so it needs no initial value.
    nstrips = -(-wm // STRIP_COLS)
    part_u = torch.empty((b, d, nstrips, 3), dtype=torch.int64, device=protos.device)
    part_f = (new(b, d, nstrips, 3),) if soft else ()
    per16 = 16 // protos.element_size()
    vec = int(nm % per16 == 0 and protos.data_ptr() % 16 == 0)
    fn = lib.tti_mask_stats_soft if soft else lib.tti_mask_stats_binary
    with torch.cuda.device(protos.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(protos.data_ptr(), int(protos.dtype == torch.bfloat16), coefs.data_ptr(),
                 boxes_grid.data_ptr(), valid.data_ptr(), b, d, hm, wm, nm,
                 int(logits_dtype == torch.bfloat16), vec, blocks_per_frame(b, wm), m.data_ptr(),
                 col_any.data_ptr(), bottom.data_ptr(), *(t.data_ptr() for t in extra),
                 part_u.data_ptr(), *(t.data_ptr() for t in part_f), stream)
    if err != 0:
        raise RuntimeError(f"mask-stats kernel launch failed: cudaError {err}")
    LAUNCHES["mask_stats_soft" if soft else "mask_stats_binary"] += 1
    return (m, *cols)


def _register(soft: bool):
    name = "mask_stats_soft" if soft else "mask_stats_binary"
    plain = mask_stats_soft_plain if soft else mask_stats_binary_plain

    def cpu(protos, coefs, boxes_grid, valid, logits_dtype):
        out = plain(protos, coefs, boxes_grid, valid, logits_dtype)
        return (torch.stack([out[k] for k in MOMENTS[name]], -1),
                *(out[k] for k in COLUMN_FIELDS[name]))

    def fake(protos, coefs, boxes_grid, valid, logits_dtype):
        b, d, wm = coefs.shape[0], coefs.shape[1], protos.shape[2]
        new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=protos.device)
        return (new(b, d, len(MOMENTS[name])), *(new(b, d, wm) for _ in COLUMN_FIELDS[name]))

    cuda = lambda *args: _launch(soft, *args)
    outs = ", ".join(["Tensor"] * (1 + len(COLUMN_FIELDS[name])))
    return register_op(f"{name}(Tensor protos, Tensor coefs, Tensor boxes_grid, Tensor valid, "
                       f"ScalarType logits_dtype) -> ({outs})", cpu, cuda, fake)


_OPS = {soft: _register(soft) for soft in (True, False)}


def _dispatch(soft: bool, protos, coefs, boxes_grid, valid, logits_dtype) -> dict[str, Tensor]:
    if protos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mask stats run on cpu or cuda tensors, got {protos.device}")
    _check(protos, coefs, boxes_grid, valid, logits_dtype)
    name = "mask_stats_soft" if soft else "mask_stats_binary"
    m, *cols = _OPS[soft](protos, coefs, boxes_grid, valid, logits_dtype)
    return {**{k: m[..., i] for i, k in enumerate(MOMENTS[name])},
            **dict(zip(COLUMN_FIELDS[name], cols))}


def mask_stats_soft(protos: Tensor, coefs: Tensor, boxes_grid: Tensor, valid: Tensor,
                    logits_dtype: torch.dtype = torch.bfloat16) -> dict[str, Tensor]:
    """Kernel A: soft statistics (keys of :func:`mask_stats_soft_plain`)."""
    return _dispatch(True, protos, coefs, boxes_grid, valid, logits_dtype)


def mask_stats_binary(protos: Tensor, coefs: Tensor, boxes_grid: Tensor, valid: Tensor,
                      logits_dtype: torch.dtype = torch.float32) -> dict[str, Tensor]:
    """Kernel B: binary statistics (keys of :func:`mask_stats_binary_plain`)."""
    return _dispatch(False, protos, coefs, boxes_grid, valid, logits_dtype)


def subcell_col_extent(col_p: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Sub-cell left/right extent from a per-column max-probability profile
    (..., W): 0.5-crossings on the rising and falling flanks around the
    binary extremes, in bottom_sub's center-mapped units. Returns
    (left_sub, right_sub, any_occupied); without an occupied column the
    argmax fallbacks are returned with any_occupied False."""
    w = col_p.shape[-1]
    occ = col_p >= 0.5
    any_occ = occ.any(-1)
    occ_i = occ.to(torch.uint8)
    left_i = occ_i.argmax(-1)
    right_i = w - 1 - occ_i.flip(-1).argmax(-1)
    take = lambda idx: torch.gather(col_p, -1, idx[..., None])[..., 0]
    p_l = take(left_i)
    p_lprev = torch.where(left_i > 0, take(torch.clamp(left_i - 1, min=0)), 0.0)
    lfrac = torch.clamp((0.5 - p_lprev) / torch.clamp(p_l - p_lprev, min=1e-6), 0.0, 1.0)
    p_r = take(right_i)
    p_rnext = torch.where(right_i < w - 1, take(torch.clamp(right_i + 1, max=w - 1)), 0.0)
    rfrac = torch.clamp((p_r - 0.5) / torch.clamp(p_r - p_rnext, min=1e-6), 0.0, 1.0)
    return left_i.float() - 1.0 + lfrac, right_i.float() + rfrac, any_occ
