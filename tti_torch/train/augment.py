"""Training augmentation on the card (port of ``tti.train.augment``).

The whole training set lives on the device (:class:`DeviceDataset`, uint8
images and padded ground truth) and each batch is made there: mosaic of four
images, random scale and translation, HSV jitter and horizontal flip, the
Ultralytics defaults. The crop, scale and translation of the mosaic canvas
are one axis-aligned resample, :func:`scale_and_translate`, as two banded
products; the GT boxes move analytically and the proto-resolution masks go
through the same resample.

Drawing and applying are separate: :func:`draw_params` takes every random
number of a batch from one ``torch.Generator`` and :func:`apply` is a pure
function of the data and those draws. :func:`step_generator` seeds a
generator from (seed, step index), so the stream of batches is a pure
function of the step and a resumed run sees the batches an uninterrupted run
would have.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tti_torch.preprocess.letterbox import jit_divide
from tti_torch.train.step import Targets

Tensor = torch.Tensor

PAD_GRAY = 114.0 / 255.0
_EPS32 = float(np.finfo(np.float32).eps)


@dataclass
class DeviceDataset:
    """The whole training set on the device.

    ``masks`` hold 0/1 cells, or u8-quantised occupancy fractions (0..255)
    for the soft classes. ``soft``: True when every class is soft, a tuple
    of the soft class ids when some are, () when none."""

    images: Tensor  # (N, S, S, 3) uint8 RGB
    boxes: Tensor  # (N, G, 4) float32 xyxy px at S
    classes: Tensor  # (N, G) int32
    masks: Tensor  # (N, G, Sm, Sm) uint8 at proto resolution S / mask_stride
    valid: Tensor  # (N, G) bool
    soft: bool | tuple = ()

    @property
    def imgsz(self) -> int:
        return self.images.shape[1]


def build_device_dataset(samples, imgsz: int, max_gt: int, mask_stride: int = 4,
                         soft_masks=False, device: str | torch.device = "cuda"
                         ) -> DeviceDataset:
    """Decode and rasterise the dataset once on the host, then upload it.

    ``soft_masks`` takes every :func:`tti_torch.train.data.soft_class_ids`
    spelling: the soft classes' masks hold area-occupancy fractions
    (quantised to u8, the same footprint), the others binary cells."""
    from tti_torch.train.data import (load_sample_u8, rasterize_polygon,
                                      rasterize_polygon_soft, soft_class_ids)

    soft_ids = soft_class_ids(soft_masks)
    n = len(samples)
    sm = imgsz // mask_stride
    images = np.zeros((n, imgsz, imgsz, 3), np.uint8)
    boxes = np.zeros((n, max_gt, 4), np.float32)
    classes = np.zeros((n, max_gt), np.int32)
    masks = np.zeros((n, max_gt, sm, sm), np.uint8)
    valid = np.zeros((n, max_gt), bool)
    all_soft = bool(soft_ids) and all(c in soft_ids for s in samples for c in s.classes)
    for i, s in enumerate(samples):
        images[i] = load_sample_u8(s, imgsz)
        for g, (poly, cls) in enumerate(zip(s.polygons[:max_gt], s.classes[:max_gt])):
            p = np.clip(poly, 0.0, 1.0)
            boxes[i, g] = [p[:, 0].min() * imgsz, p[:, 1].min() * imgsz,
                           p[:, 0].max() * imgsz, p[:, 1].max() * imgsz]
            classes[i, g] = cls
            if cls in soft_ids:
                frac = rasterize_polygon_soft(p, (sm, sm), mask_stride)
                masks[i, g] = np.round(frac * 255.0).astype(np.uint8)
            else:
                masks[i, g] = rasterize_polygon(p, (sm, sm)).astype(np.uint8)
            valid[i, g] = True
    put = lambda a: torch.from_numpy(a).to(device)
    return DeviceDataset(put(images), put(boxes), put(classes), put(masks), put(valid),
                         soft=True if all_soft else soft_ids)


def _weight_mat(in_size: int, out_size: int, scale: Tensor, translation: Tensor) -> Tensor:
    """(..., in, out) linear-interpolation weights of
    ``jax.image.compute_weight_mat`` (antialias off), in float32: each
    output sample is renormalised by the sum of its in-range taps, and a
    sample whose position falls outside [-0.5, in - 0.5] gets none."""
    inv = 1.0 / scale.float()
    out_pos = torch.arange(out_size, dtype=torch.float32, device=scale.device)
    sample = (out_pos + 0.5) * inv[..., None] - translation.float()[..., None] * inv[..., None] - 0.5
    in_pos = torch.arange(in_size, dtype=torch.float32, device=scale.device)
    w = (1 - (sample[..., None, :] - in_pos[:, None]).abs()).clamp(min=0)
    total = w.sum(-2, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[..., None, :], w, torch.zeros_like(w))


def scale_and_translate(x: Tensor, out_hw: tuple[int, int], scale: Tensor,
                        translation: Tensor) -> Tensor:
    """``jax.image.scale_and_translate(x, ..., spatial_dims=(1, 2),
    method="linear", antialias=False)`` over a batch: x (B, H, W, C); scale
    and translation (B, 2) as (y, x). Output pixel (i, j) samples input
    position ((i + 0.5 - ty) / sy - 0.5, (j + 0.5 - tx) / sx - 0.5). The
    positions come from float32 scale and translation whatever x's dtype;
    the weights are then cast to x's dtype and the two products run in it."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    wy = _weight_mat(h, oh, scale[:, 0], translation[:, 0]).to(x.dtype)  # (B, H, oh)
    wx = _weight_mat(w, ow, scale[:, 1], translation[:, 1]).to(x.dtype)  # (B, W, ow)
    t = torch.bmm(x.permute(0, 1, 3, 2).reshape(b, h * c, w), wx)  # (B, H*C, ow)
    t = torch.bmm(wy.transpose(1, 2), t.reshape(b, h, c * ow))  # (B, oh, C*ow)
    return t.reshape(b, oh, c, ow).permute(0, 1, 3, 2)


def _rgb_to_hsv(rgb: Tensor) -> Tensor:
    """[0, 1] RGB -> (h in [0, 1), s, v), elementwise in rgb's dtype."""
    r, g, b = rgb.unbind(-1)
    v = rgb.amax(-1)
    c = v - rgb.amin(-1)
    pos = c > 0
    safe_c = torch.where(pos, c, torch.ones_like(c))
    h = torch.where(v == r, (g - b) / safe_c,
                    torch.where(v == g, 2.0 + (b - r) / safe_c, 4.0 + (r - g) / safe_c))
    # / 6 as tti's jitted augment takes it (jit_divide); the run-time divisors
    # above and below are true divisions in both.
    h = torch.where(pos, torch.remainder(jit_divide(h, 6.0), 1.0), torch.zeros_like(h))
    s = torch.where(v > 0, c / torch.where(v > 0, v, torch.ones_like(v)), torch.zeros_like(v))
    return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(hsv: Tensor) -> Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    pick = lambda *vals: torch.stack(vals, -1).gather(-1, i.long()[..., None])[..., 0]
    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def _hsv_jitter(img: Tensor, gains: Tensor) -> Tensor:
    """img (B, S, S, 3); gains (B, 3) multipliers of h, s, v, applied in the
    image's dtype."""
    r = gains.to(img.dtype)[:, None, None, :]
    hsv = _rgb_to_hsv(img)
    h = torch.remainder(hsv[..., 0] * r[..., 0], 1.0)
    s = (hsv[..., 1] * r[..., 1]).clamp(0.0, 1.0)
    v = (hsv[..., 2] * r[..., 2]).clamp(0.0, 1.0)
    return _hsv_to_rgb(torch.stack([h, s, v], dim=-1))


def step_generator(seed: int, step: int, device: str | torch.device) -> torch.Generator:
    """The generator of batch number ``step``, seeded from (seed, step)
    through numpy's SeedSequence (a 32-bit seed: the CPU generator reads
    no more)."""
    state = np.random.SeedSequence([seed, step]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def draw_params(generator: torch.Generator, n: int, n_images: int, scale: float = 0.5,
                translate: float = 0.1, mosaic_p: float = 1.0, flip_p: float = 0.5,
                hsv_gains: tuple[float, float, float] = (0.015, 0.7, 0.4)) -> dict[str, Tensor]:
    """Every random number of ``n`` augmented samples, on the generator's
    device: ``idx`` (n, 4) the mosaic's four images; ``mosaic`` (n,) bool;
    ``scale``, ``tx``, ``ty`` (n,); ``ctr`` (n, 2) the crop centre as a
    fraction of the 2S canvas, in [0.25, 0.75); ``hsv`` (n, 3) the h, s, v
    multipliers 1 + U(-1, 1) * gain; ``flip`` (n,) bool."""
    dev = generator.device
    u = lambda *shape: torch.rand(shape, generator=generator, device=dev)
    uniform = lambda lo, hi, *shape: u(*shape) * (hi - lo) + lo
    return {
        "idx": torch.randint(0, n_images, (n, 4), generator=generator, device=dev),
        "mosaic": u(n) < mosaic_p,
        "scale": uniform(1.0 - scale, 1.0 + scale, n),
        "tx": uniform(-translate, translate, n),
        "ty": uniform(-translate, translate, n),
        "ctr": uniform(0.25, 0.75, n, 2),
        "hsv": uniform(-1.0, 1.0, n, 3) * torch.tensor(hsv_gains, device=dev) + 1.0,
        "flip": u(n) < flip_p,
    }


def canvas_to_out(c: Tensor, origin: Tensor, sc: Tensor, shift: Tensor, s_px: int) -> Tensor:
    """Canvas px -> output px along one axis of the window at ``origin``,
    scaled by ``sc`` and shifted by ``shift`` (a fraction of the output):
    ``tti``'s ``canvas_to_out``, whose ``/ s_px`` its jitted augment takes as
    the product with the float32 reciprocal (:func:`jit_divide`)."""
    return ((jit_divide(c - origin, s_px) - 0.5) * sc + 0.5 + shift) * s_px


def apply(data: DeviceDataset, params: dict[str, Tensor], max_gt: int,
          image_dtype: torch.dtype = torch.float32) -> tuple[Tensor, Targets]:
    """One augmented batch from the draws of :func:`draw_params`: images
    (B, S, S, 3) in ``image_dtype`` and float32 targets with G = min(max_gt,
    4 x the dataset's GT slots)."""
    s_px = data.imgsz
    sm = data.masks.shape[2]
    q = s_px // sm
    g_src = data.boxes.shape[1]
    dev = data.images.device
    dt = image_dtype
    b = params["idx"].shape[0]
    mosaic, flip = params["mosaic"], params["flip"]
    sc, tx, ty = params["scale"], params["tx"], params["ty"]
    # Without mosaic all four tiles are the first image, the window is that
    # tile, and tiles 1-3 are border gray.
    idx = torch.where(mosaic[:, None], params["idx"], params["idx"][:, :1].expand(b, 4))
    tiles = data.images[idx]  # (B, 4, S, S, 3)
    keep = mosaic[:, None] | (torch.arange(4, device=dev) == 0)[None]
    tiles = torch.where(keep[..., None, None, None], tiles, torch.full_like(tiles, 114))
    canvas = torch.cat([torch.cat([tiles[:, 0], tiles[:, 1]], dim=2),
                        torch.cat([tiles[:, 2], tiles[:, 3]], dim=2)], dim=1)  # (B, 2S, 2S, 3)

    ctr = params["ctr"] * (2 * s_px)
    zero = torch.zeros_like(sc)
    x0 = torch.where(mosaic, (ctr[:, 0] - s_px // 2).clamp(0, s_px), zero)
    y0 = torch.where(mosaic, (ctr[:, 1] - s_px // 2).clamp(0, s_px), zero)

    # Image: the window's crop, scale and translation as one resample.
    # Out-of-canvas taps get no weight, so the image is shifted by the pad
    # gray before and after: borders blend towards it.
    t_x = (0.5 + tx) * s_px - sc * (x0 + 0.5 * s_px)
    t_y = (0.5 + ty) * s_px - sc * (y0 + 0.5 * s_px)
    pad = torch.tensor(PAD_GRAY, dtype=dt, device=dev)
    img = pad + scale_and_translate(
        canvas.to(dt) * torch.tensor(1.0 / 255.0, dtype=dt, device=dev) - pad, (s_px, s_px),
        torch.stack([sc, sc], -1), torch.stack([t_y, t_x], -1))
    img = _hsv_jitter(img.clamp(0.0, 1.0), params["hsv"])
    img = torch.where(flip[:, None, None, None], img.flip(2), img)

    # Ground truth: the four tiles' G slots are candidates, moved
    # analytically; the first max_gt valid ones stay (a stable sort).
    tile_off = torch.tensor([[0, 0], [s_px, 0], [0, s_px], [s_px, s_px]], dtype=torch.float32,
                            device=dev)
    cand_boxes = (data.boxes[idx] + tile_off.repeat(1, 2)[None, :, None, :]).reshape(b, -1, 4)
    cand_classes = data.classes[idx].reshape(b, -1)
    tile_of = torch.arange(4 * g_src, device=dev) // g_src
    cand_valid = data.valid[idx].reshape(b, -1) & (mosaic[:, None] | (tile_of == 0)[None])

    col = lambda t: t[:, None]
    to_out_x = lambda xc: canvas_to_out(xc, col(x0), col(sc), col(tx), s_px)
    to_out_y = lambda yc: canvas_to_out(yc, col(y0), col(sc), col(ty), s_px)
    bx0, by0 = to_out_x(cand_boxes[..., 0]), to_out_y(cand_boxes[..., 1])
    bx1, by1 = to_out_x(cand_boxes[..., 2]), to_out_y(cand_boxes[..., 3])
    fl = col(flip)
    bx0, bx1 = torch.where(fl, s_px - bx1, bx0), torch.where(fl, s_px - bx0, bx1)
    out_boxes = torch.stack([bx0, by0, bx1, by1], -1).clamp(0, s_px)
    cand_valid = (cand_valid & (out_boxes[..., 2] - out_boxes[..., 0] >= 2.0)
                  & (out_boxes[..., 3] - out_boxes[..., 1] >= 2.0))
    order = torch.sort((~cand_valid).to(torch.uint8), dim=1, stable=True)[1][:, :max_gt]
    g = order.shape[1]
    sel_boxes = torch.gather(out_boxes, 1, order[..., None].expand(b, g, 4))
    sel_classes = torch.gather(cand_classes, 1, order)
    sel_valid = torch.gather(cand_valid, 1, order)
    sel_tile, sel_slot = order // g_src, order % g_src

    # Masks: the same resample at proto resolution, per selected slot. Proto
    # cell p is centred at model px q p + (q - 1) / 2 on both grids.
    src = data.masks[torch.gather(idx, 1, sel_tile), sel_slot].float()  # (B, G, Sm, Sm)
    if data.soft is True:
        is_soft = torch.ones_like(sel_valid)
    elif data.soft:
        is_soft = torch.isin(sel_classes, torch.tensor(data.soft, dtype=sel_classes.dtype,
                                                       device=dev))
    else:
        is_soft = torch.zeros_like(sel_valid)
    src = torch.where(is_soft[..., None, None], src * (1.0 / 255.0), src)
    off = tile_off[sel_tile]  # (B, G, 2)
    c_x = ((col(x0) - off[..., 0] - q / 2.0) / q - (0.5 + col(tx)) * s_px / (q * col(sc))
           + s_px / (2.0 * q))
    c_y = ((col(y0) - off[..., 1] - q / 2.0) / q - (0.5 + col(ty)) * s_px / (q * col(sc))
           + s_px / (2.0 * q))
    scg = col(sc).expand(b, g)
    m = scale_and_translate(src.reshape(b * g, sm, sm, 1), (sm, sm),
                            torch.stack([scg, scg], -1).reshape(-1, 2),
                            torch.stack([-scg * (c_y + 0.5), -scg * (c_x + 0.5)], -1).reshape(-1, 2)
                            ).reshape(b, g, sm, sm)
    m = torch.where(is_soft[..., None, None], m, (m > 0.5).float())
    m = torch.where(sel_valid[..., None, None], m.clamp(0.0, 1.0), torch.zeros_like(m))
    m = torch.where(flip[:, None, None, None], m.flip(3), m)
    return img, Targets(sel_boxes, sel_classes, m, sel_valid)


def make_augment_fn(batch_size: int, max_gt: int, scale: float = 0.5, translate: float = 0.1,
                    mosaic_p: float = 1.0, flip_p: float = 0.5,
                    hsv_gains: tuple[float, float, float] = (0.015, 0.7, 0.4),
                    image_dtype: torch.dtype | None = None, rows: slice | None = None):
    """``fn(data, generator) -> (images, Targets)``: one fresh augmented
    batch. ``image_dtype``: the image chain's dtype (None: float32; the
    trainer passes its compute dtype). ``rows``: a data-parallel rank's
    rows (:func:`tti_torch.parallel.mesh.batch_slice`): the draws are the
    whole batch's and only these rows are made, so a rank's samples are
    rows of the unsharded batch."""
    dt = image_dtype or torch.float32

    def batch_fn(data: DeviceDataset, generator: torch.Generator) -> tuple[Tensor, Targets]:
        params = draw_params(generator, batch_size, data.images.shape[0], scale, translate,
                             mosaic_p, flip_p, hsv_gains)
        if rows is not None:
            params = {k: v[rows] for k, v in params.items()}
        return apply(data, params, max_gt, dt)

    return batch_fn
