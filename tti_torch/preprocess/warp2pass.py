"""The undistort remap as two separable matmuls (port of
``tti.preprocess.warp2pass.TwoPassWarp``).

  pass 1 (horizontal): I1[y, xo]  = sum_w  src[y, w] * W1[y, w, xo]
  pass 2 (vertical):   out[v, xo] = sum_y  I1[y, xo] * W2[xo, v, y]

The weights are built by the reference's numpy code. Both passes are plain
large products left to cuBLAS, as the reference left them to XLA. The input
is shifted by the pad value so zero-weight rows resolve to the border color.
``s2d_out`` emits the frame space-to-depth blocked (B, H/2, W/2, 4C) with the
letterbox row padding folded into zero weight rows.

Two exact options of the reference: ``block`` slices both weight matrices
into bands (per block of output columns, pass 1 keeps the source columns
its kernels touch; per block of output rows, pass 2 keeps the source rows),
so the zeros outside the band are neither stored nor read; ``col_expand``
scatters pass 1's kernels onto the full-resolution columns of an exact
integer decimation, so pass 1 takes row-sliced full-width frames.

A rank of a space mesh takes :meth:`TwoPassWarp.rows`: pass 2 sliced to its
slab's output rows, pass 1 to the source rows that slab reads.

The shift back is part of pass 2, so that the result is rounded once, as the
reference adds the pad to its float32 accumulator: ``W2`` carries
``PAD_ROWS`` more source rows, whose weights are the float32 pad value split
into terms the weight type holds exactly (three in bfloat16, one in
float32), and pass 2 is fed as many rows of ones under the pass-1
intermediate. The product's own float32 accumulator then adds the pad.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from tti_torch.preprocess.letterbox import PAD_VALUE

_SENTINEL = -1e5
PAD_ROWS = 8  # constant rows under the pass-1 intermediate (keeps hs + PAD_ROWS a multiple of 8)


def split_exactly(value: float, dtype: torch.dtype) -> list[float]:
    """``value`` (rounded to float32) as a sum of three numbers that ``dtype``
    holds exactly, largest first: each is the rounded rest. Three bfloat16
    terms hold the 24 bits of a float32."""
    rest, out = float(np.float32(value)), []
    for _ in range(3):
        out.append(float(torch.tensor(rest, dtype=torch.float64).to(dtype)))
        rest -= out[-1]
    return out


class TwoPassWarp:
    """Precompiled two-pass warp for one calibration + letterbox geometry.

    Raises ValueError when the vertical map is not strictly monotonic per
    column; the runtime then falls back to the gather (``PackedRemap``)."""

    def __init__(self, map_xy: np.ndarray, src_hw: tuple[int, int],
                 pad_value: float = PAD_VALUE / 255.0, s2d_out: bool = False,
                 device: str | torch.device = "cuda",
                 weight_dtype: torch.dtype | None = None,
                 col_expand: tuple[int, int, int] | None = None,
                 block: int | None = None) -> None:
        """``col_expand=(k, off, full_w)``: pass 1 samples full-resolution
        column ``off + k * c`` for content column c, from (B, hs, full_w, C)
        row-sliced frames. ``block``: the band width in output columns
        (pass 1) and output rows (pass 2); even with ``s2d_out``."""
        device = torch.device(device)
        if weight_dtype is None:
            # bf16 weights on the card (8 mantissa bits, as the reference's
            # TPU path); f32 on the CPU, as the reference's CPU path.
            weight_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        self.src_hw = src_hw
        self.pad_value = float(pad_value)
        hs, ws = src_hw
        self.src_rows = (0, hs)  # the source rows pass 1 reads (rows(): a band)
        dst_h, dst_w = map_xy.shape[:2]
        self.dst_hw = (dst_h, dst_w)

        mx = np.asarray(map_xy[..., 0], np.float64)
        my = np.asarray(map_xy[..., 1], np.float64)
        live_row = ~np.all((mx < _SENTINEL) | (my < _SENTINEL), axis=1)
        live = np.nonzero(live_row)[0]
        self.row_start = int(live.min()) if live.size else 0
        self.row_stop = int(live.max()) + 1 if live.size else 0
        mx = mx[self.row_start:self.row_stop]
        my = my[self.row_start:self.row_stop]
        ho, wo = mx.shape

        col_live = ~np.all((mx < _SENTINEL) | (my < _SENTINEL), axis=0)
        sent = (mx < _SENTINEL) | (my < _SENTINEL)
        if np.any(np.diff(my, axis=0)[:, col_live] <= 0):
            raise ValueError("vertical map not strictly monotonic per column")

        # sx*(xo, y): horizontal source position for intermediate row y of
        # column xo (the per-column inverse of the vertical map).
        ys = np.arange(hs, dtype=np.float64)
        yo_grid = np.arange(ho, dtype=np.float64)
        sxstar = np.zeros((hs, wo), np.float64)
        for xo in range(wo):
            if col_live[xo]:
                yo_hat = np.interp(ys, my[:, xo], yo_grid)
                sxstar[:, xo] = np.interp(yo_hat, yo_grid, mx[:, xo])

        # The weights are laid out in float32 on the device (the dense
        # matrices are mostly zeros, gigabytes at the deployed geometry:
        # writing them there skips the host's pages and the copy). Every
        # (row, tap, column) is written once (a point's two taps differ), so
        # a plain indexed write is the reference's np.add.at sum.
        on_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        w1 = torch.zeros((hs, ws, wo), dtype=torch.float32, device=device)
        x0 = np.floor(sxstar).astype(np.int64)
        fx = (sxstar - x0).astype(np.float32)
        rows = np.broadcast_to(ys.astype(np.int64)[:, None], (hs, wo))
        cols = np.broadcast_to(np.arange(wo)[None, :], (hs, wo))
        for tap, wgt in ((x0, 1.0 - fx), (x0 + 1, fx)):
            ok = (tap >= 0) & (tap < ws) & col_live[None, :]
            w1[on_dev(rows[ok]), on_dev(tap[ok]), on_dev(cols[ok])] = on_dev(wgt[ok])

        w2 = torch.zeros((wo, ho, hs), dtype=torch.float32, device=device)
        y0 = np.floor(my).astype(np.int64)
        fy = (my - y0).astype(np.float32)
        vrows = np.broadcast_to(yo_grid.astype(np.int64)[:, None], (ho, wo))
        vcols = np.broadcast_to(np.arange(wo)[None, :], (ho, wo))
        for tap, wgt in ((y0, 1.0 - fy), (y0 + 1, fy)):
            ok = (tap >= 0) & (tap < hs) & ~sent
            w2[on_dev(vcols[ok]), on_dev(vrows[ok]), on_dev(tap[ok])] = on_dev(wgt[ok])

        self.col_expand = col_expand
        if col_expand is not None:
            k, off, full_w = col_expand
            w1_full = w1.new_zeros((hs, full_w, wo))
            w1_full[:, off:off + k * ws:k, :] = w1
            w1 = w1_full

        self.s2d_out = s2d_out
        if s2d_out:
            if dst_h % 2 or wo % 2:
                raise ValueError("s2d_out requires even dst dims")
            w2_full = w2.new_zeros((wo, dst_h, hs))
            w2_full[:, self.row_start:self.row_stop] = w2
            w2 = w2_full
        self.block = block
        self.pad_terms = split_exactly(self.pad_value, weight_dtype)
        # Rounded from float32 to the weight type on the device.
        to_type = lambda w: w.to(weight_dtype).contiguous()
        if block is not None:
            if s2d_out and block % 2:
                raise ValueError("s2d_out blocked mode needs an even block")
            self.w1 = self.w2 = self.w1_window = None
            # Each band's window starts at a multiple of 16, as the reference's.
            self.w1_blocks = []  # (first source column, (hs, columns, block))
            for o0 in range(0, wo, block):
                blk = w1[:, :, o0:o0 + block]
                c0, c1 = _live_window((blk != 0.0).any(2).any(0).cpu().numpy())
                self.w1_blocks.append((c0, to_type(blk[:, c0:c1])))
            self.w2_blocks = []  # (first source row, weights + PAD_ROWS pad columns)
            for v0 in range(0, w2.shape[1], block):
                blk = w2[:, v0:v0 + block, :]
                y0, y1 = _live_window((blk != 0.0).any(1).any(0).cpu().numpy())
                self.w2_blocks.append((y0, self._with_pad_terms(to_type(blk[:, :, y0:y1]))))
            return
        self.w1 = to_type(w1)
        self.w2 = self._with_pad_terms(to_type(w2))
        self.w1_window: torch.Tensor | None = None  # pass1_window()'s table, once asked for

    def pass1_window(self) -> torch.Tensor:
        """The fused pass-1 kernel's table of ``w1`` (:func:`tti_torch.kernels.
        warp_p1.pass1_window`): for each (y, o) the first source column with
        a non-zero weight and one past the last. Computed once, on the
        device, from the weights as this warp holds them (after the
        rounding to the weight type), and kept as ``w1_window``: ``w1`` is
        not replaced after construction. The blocked mode holds no dense
        ``w1`` and raises ValueError."""
        if self.w1 is None:
            raise ValueError("the pass-1 table needs the dense w1; this warp is blocked "
                             f"(block={self.block})")
        if self.w1_window is None:
            from tti_torch.kernels.warp_p1 import pass1_window

            self.w1_window = pass1_window(self.w1)
        return self.w1_window

    def rows(self, r0: int, r1: int) -> "TwoPassWarp":
        """The same warp for output rows [r0, r1) of the model input only
        (a space mesh's slab; even bounds in ``s2d_out`` mode): pass 2's
        weights sliced to those rows, pass 1's to the band of source rows
        [y0, y1) = ``src_rows`` that they read (one row when they read
        none: its weights there are zero). The kept weights are the same
        values; pass 2 sums fewer zero terms. In blocked mode pass 2's bands
        are cut at the slab's rows (whole bands where the block divides the
        slab, a band split at its edge otherwise), each keeping its own
        window of source rows and the pad's terms; pass 1's column bands stay
        whole in columns, cut to ``src_rows`` as the dense ``w1`` is."""
        hs = self.src_hw[0]
        out = copy.copy(self)
        if self.s2d_out:
            if r0 % 2 or r1 % 2:
                raise ValueError(f"s2d_out slabs start and end on even rows, got [{r0}, {r1})")
            a, b = r0, r1  # rows of W2's output axis
        else:
            a, b = max(r0, self.row_start), min(r1, self.row_stop)
            b = max(a, b)
            out.row_start, out.row_stop = a - r0, b - r0
            out.dst_hw = (r1 - r0, self.dst_hw[1])
            a, b = a - self.row_start, b - self.row_start
        if self.block is not None:
            return self._rows_blocked(out, a, b)
        w2 = self.w2[:, :, a // 2:b // 2] if self.s2d_out else self.w2[:, a:b]
        y0, y1 = _live_span(w2, hs) or (0, 1)
        out.src_rows = (y0, y1)
        out.w2 = torch.cat([w2[..., y0:y1], w2[..., hs:]], dim=-1)
        out.w1 = self.w1[y0:y1].clone()  # copies: the whole warp's weights can go
        if self.w1_window is not None:
            out.w1_window = self.w1_window[y0:y1].clone()
        return out

    def _rows_blocked(self, out: "TwoPassWarp", a: int, b: int) -> "TwoPassWarp":
        """:meth:`rows` of a blocked warp, for rows [a, b) of W2's output
        axis: each pass-2 band cut to those rows, its window narrowed to the
        source rows that its kept rows read."""
        cut_rows = (lambda w, lo, hi: w[:, :, lo // 2:hi // 2]) if self.s2d_out else (
            lambda w, lo, hi: w[:, lo:hi])
        cut, v0 = [], 0  # (band's first source row, its weights on the slab's rows)
        for y0, w in self.w2_blocks:
            rows = 2 * w.shape[2] if self.s2d_out else w.shape[1]
            lo, hi = max(a, v0) - v0, min(b, v0 + rows) - v0
            v0 += rows
            if lo < hi:
                cut.append((y0, cut_rows(w, lo, hi)))
        if not cut:  # the slab lies in the letterbox's pad rows: one band of no rows
            cut.append((self.w2_blocks[0][0], cut_rows(self.w2_blocks[0][1], 0, 0)))
        spans = []  # each band's live source rows, global [first, last + 1), or None
        for y0, w in cut:
            span = _live_span(w, w.shape[-1] - PAD_ROWS)
            spans.append(span and (y0 + span[0], y0 + span[1]))
        kept = [s for s in spans if s is not None]
        y0s, y1s = (min(s[0] for s in kept), max(s[1] for s in kept)) if kept else (0, 1)
        out.src_rows = (y0s, y1s)
        out.w2_blocks = []
        for (y0, w), span in zip(cut, spans):
            l0, l1 = span or (y0s, y0s)
            n = w.shape[-1] - PAD_ROWS
            # The band's live source rows, then its pad terms: the same values.
            out.w2_blocks.append((l0 - y0s, torch.cat([w[..., l0 - y0:l1 - y0], w[..., n:]],
                                                      dim=-1)))
        out.w1_blocks = [(c0, w[y0s:y1s].clone()) for c0, w in self.w1_blocks]
        return out

    def _with_pad_terms(self, w2: torch.Tensor) -> torch.Tensor:
        """(..., y) pass-2 weights -> (..., y + PAD_ROWS): the warp's weights,
        then the pad's terms on every output row (a zero-weight row resolves
        to the pad), then zeros; in ``s2d_out`` mode reshaped to (o2, do,
        v2, dv, y + PAD_ROWS)."""
        out = w2.new_zeros((*w2.shape[:-1], w2.shape[-1] + PAD_ROWS))
        out[..., :w2.shape[-1]] = w2
        for i, term in enumerate(self.pad_terms):
            out[..., w2.shape[-1] + i] = term
        if self.s2d_out:
            o, v, y = out.shape
            out = out.reshape(o // 2, 2, v // 2, 2, y)
        return out

    @property
    def weight_bytes(self) -> int:
        """Bytes of warp weights one step reads."""
        ws = ([self.w1, self.w2] if self.block is None
              else [w for _, w in self.w1_blocks + self.w2_blocks])
        return sum(w.numel() * w.element_size() for w in ws)

    def apply(self, content: torch.Tensor) -> torch.Tensor:
        """(B, hs, ws, C) content (or (B, hs, full_w, C) rows with
        ``col_expand``) -> (B, dst_h, dst_w, C) warped + padded, or
        (B, dst_h/2, dst_w/2, 4C) blocked in ``s2d_out`` mode. A
        :meth:`rows` slab takes its ``src_rows`` of the content."""
        wdt = (self.w1 if self.block is None else self.w1_blocks[0][1]).dtype
        x = content.to(wdt) - torch.tensor(self.pad_value, dtype=wdt)
        b, hs, ws, c = x.shape
        # Pass 1 is the einsum "bywc,ywo->byoc" as the batched product it is.
        xr = x.permute(1, 0, 3, 2).reshape(hs, b * c, ws)
        if self.block is not None:
            i1 = torch.cat([torch.bmm(xr[..., c0:c0 + w.shape[1]], w)
                            for c0, w in self.w1_blocks], dim=-1)
            return self._pass2_blocked(i1.view(hs, b, c, -1).permute(1, 0, 3, 2), content.dtype)
        # Written straight above the rows of ones: (hs + PAD_ROWS, b, c, wo).
        buf = x.new_empty(hs + PAD_ROWS, b, c, self.w1.shape[2])
        buf[hs:] = 1.0
        torch.bmm(xr, self.w1, out=buf[:hs].view(hs, b * c, -1))
        return self._pass2(buf.permute(1, 0, 3, 2), content.dtype)

    def apply_pass2(self, i1: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        """Pass 2 over the pass-1 intermediate in (b, y, o, c) layout."""
        if self.block is not None:
            return self._pass2_blocked(i1, out_dtype)
        return self._pass2(_with_ones(i1, 1), out_dtype)

    def _pass2(self, i1: torch.Tensor, out_dtype: torch.dtype, w2: torch.Tensor | None = None,
               finish: bool = True) -> torch.Tensor:
        """Pass 2 over (b, y + PAD_ROWS, o, c): the intermediate, then ones."""
        w2 = self.w2 if w2 is None else w2
        if self.s2d_out:
            i1 = i1.reshape(i1.shape[0], i1.shape[1], -1, 2, i1.shape[3])
            out = torch.einsum("byodc,odvey->bvoedc", i1, w2)
        else:
            out = torch.einsum("byoc,ovy->bvoc", i1, w2)
        return self._finish(out, out_dtype) if finish else out

    def _pass2_blocked(self, i1: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        """Pass 2 band by band over (b, hs, o, c): each band's source-row
        window, then the rows of ones, against the band's weights."""
        ones = i1.new_ones((i1.shape[0], PAD_ROWS, *i1.shape[2:]))
        outs = [self._pass2(torch.cat([i1[:, y0:y0 + w.shape[-1] - PAD_ROWS], ones], dim=1),
                            out_dtype, w, finish=False)
                for y0, w in self.w2_blocks]
        return self._finish(torch.cat(outs, dim=1), out_dtype)

    def apply_pass2_ycbo(self, i1: torch.Tensor, out_dtype: torch.dtype | None = None
                         ) -> torch.Tensor:
        """Pass 2 over a pass-1 intermediate in (y, c, b, o) layout, which is
        what :func:`tti_torch.kernels.warp_p1.warp_pass1_decimated` emits:
        the same product as :meth:`apply_pass2` with the free dimensions
        (c, b) in place of (b, c). Dense weights only, as the reference."""
        if self.block is not None:
            raise NotImplementedError("pass-2-from-i1 requires dense weights")
        out_dtype = out_dtype or i1.dtype
        i1 = _with_ones(i1.to(self.w2.dtype), 0)
        if self.s2d_out:
            y, c, b, o = i1.shape
            out = torch.einsum("ycbod,odvey->bvoedc", i1.reshape(y, c, b, o // 2, 2), self.w2)
        else:
            out = torch.einsum("ycbo,ovy->bvoc", i1, self.w2)
        return self._finish(out, out_dtype)

    def _finish(self, out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Give the product (the pad is already in it) its final form."""
        out = out.to(dtype)
        if self.s2d_out:
            b, v2, o2, dv, do, c = out.shape
            # channel (dv*2 + do)*C + c: space_to_depth2's order.
            return out.reshape(b, v2, o2, dv * do * c)
        dst_h = self.dst_hw[0]
        return torch.nn.functional.pad(
            out, (0, 0, 0, 0, self.row_start, dst_h - self.row_stop), value=self.pad_value)

    __call__ = apply


def _live_span(w2: torch.Tensor, n: int) -> tuple[int, int] | None:
    """[first, last + 1) of the source rows among the first ``n`` that the
    pass-2 weights ``w2`` (..., n + PAD_ROWS) give a non-zero weight; None
    when they give none."""
    live = torch.nonzero((w2[..., :n] != 0).flatten(0, -2).any(0)).flatten().tolist()
    return (live[0], live[-1] + 1) if live else None


def _live_window(live: np.ndarray) -> tuple[int, int]:
    """[start, stop) of the True entries of ``live``, the start rounded down
    to a multiple of 16; (0, 16) (clipped) when there are none."""
    idx = np.nonzero(live)[0]
    if idx.size == 0:
        return 0, min(16, live.size)
    return (int(idx.min()) // 16) * 16, int(idx.max()) + 1


def _with_ones(i1: torch.Tensor, dim: int) -> torch.Tensor:
    """``i1`` with ``PAD_ROWS`` rows of ones appended along its source-row
    dimension ``dim``: one copy, the rows that meet the pad's terms in ``W2``."""
    shape = list(i1.shape)
    rows = shape[dim]
    shape[dim] = rows + PAD_ROWS
    out = i1.new_empty(shape)
    out.narrow(dim, 0, rows).copy_(i1)
    out.narrow(dim, rows, PAD_ROWS).fill_(1.0)
    return out
