"""The plain reference of the inspection step: uint8 BGR frames in, the
step's host outputs out, in float32 (TF32 off) and float64 numpy.

    letterbox (Ultralytics rect, bilinear) -> two-pass undistort warp (the
    per-column inverse of the vertical map, then two linear interpolations)
    -> YOLOv8-seg (:mod:`benchmark.reference.yolo`) -> DFL decode -> greedy
    class-aware NMS -> ROI gate -> mask statistics -> stitch set and fabric
    envelope -> pixel -> plane millimetres

Everything the program derives at set-up is derived here again from the
configuration and the raw checkpoint: the letterbox geometry, the warp's
sampling positions from K and the distortion, the plain k3/s2 stem and the
unfolded BatchNorm, the camera's rotation, the readout offsets of the
checkpoint's sidecar. It imports nothing of the program.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.msgpack_flax import load_flax_msgpack
from benchmark.reference.yolo import REG_MAX, STRIDES, ReferenceYOLOv8Seg

PAD = 114.0 / 255.0


@dataclass(frozen=True)
class Geometry:
    """Ultralytics' minimal-rect letterbox of a frame at ``imgsz``."""

    src_h: int
    src_w: int
    dst_h: int
    dst_w: int
    scale: float
    new_h: int
    new_w: int
    pad_top: int
    pad_left: int

    @staticmethod
    def rect(src_h: int, src_w: int, imgsz: int, stride: int = 32) -> "Geometry":
        t = -(-imgsz // stride) * stride
        r = min(t / src_h, t / src_w)
        new_h, new_w = round(src_h * r), round(src_w * r)
        dh, dw = (t - new_h) % stride, (t - new_w) % stride
        return Geometry(src_h, src_w, new_h + dh, new_w + dw, r, new_h, new_w,
                        int(round(dh / 2 - 0.1)), int(round(dw / 2 - 0.1)))


def roi_box(roi: dict, frame_hw) -> tuple[float, float, float, float]:
    """The deployment's ROI (x from ``x_min`` to ``w + x_max_from_right``,
    y from ``min(y_min, h // 3)`` to ``h - min(y_max_from_bottom, h // 5)``),
    clipped to the frame, as (x1, y1, x2, y2)."""
    h, w = frame_hw
    x1, x2 = min(max(roi["x_min"], 0), w - 1), min(max(w + roi["x_max_from_right"], 0), w - 1)
    y1 = min(max(min(roi["y_min"], h // 3), 0), h - 1)
    y2 = min(max(h - min(roi["y_max_from_bottom"], h // 5), 0), h - 1)
    return float(x1), float(y1), float(x2), float(y2)


def readouts(meta: dict) -> tuple[bool, bool]:
    """(sub-cell stitch readout, sub-cell envelope) from a checkpoint's
    sidecar: per-class keys split the two, the older ``soft_masks`` drives
    both, an explicit ``subcell_envelope`` wins."""
    legacy = bool(meta.get("soft_masks", False))
    sub = bool(meta.get("soft_stitch", legacy))
    if "subcell_envelope" in meta:
        return sub, bool(meta["subcell_envelope"])
    if "soft_fabric" in meta or "soft_stitch" in meta:
        return sub, bool(meta.get("soft_fabric", legacy))
    return sub, sub


def rodrigues(rvec) -> np.ndarray:
    rvec = np.asarray(rvec, np.float64).reshape(3)
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.cos(theta) * np.eye(3) + (1 - np.cos(theta)) * np.outer(k, k) + np.sin(theta) * kx


def distort(xy: np.ndarray, K: np.ndarray, dist: np.ndarray) -> np.ndarray:
    """Ideal normalised coordinates -> distorted pixels (OpenCV's model)."""
    k1, k2, p1, p2, k3 = dist
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([K[0, 0] * xd + K[0, 1] * yd + K[0, 2], K[1, 1] * yd + K[1, 2]], -1)


class Warp:
    """The rectifying warp of the letterboxed frame, as two passes: pass 1
    resamples each content row y at the horizontal position sx*(y, xo)
    where the vertical map of output column xo crosses row y; pass 2
    resamples each output column vertically at the map's row. Taps outside
    the content contribute the pad value."""

    def __init__(self, K: np.ndarray, dist: np.ndarray, g: Geometry, device) -> None:
        s = g.scale
        Ks = np.asarray(K, np.float64).copy()  # K in letterboxed pixels
        Ks[0, 0] *= s
        Ks[1, 1] *= s
        Ks[0, 1] *= s
        Ks[0, 2] = (Ks[0, 2] + 0.5) * s - 0.5 + g.pad_left
        Ks[1, 2] = (Ks[1, 2] + 0.5) * s - 0.5 + g.pad_top
        ys, xs = np.meshgrid(np.arange(g.dst_h, dtype=np.float64),
                             np.arange(g.dst_w, dtype=np.float64), indexing="ij")
        xy = np.stack([(xs - Ks[0, 2]) / Ks[0, 0], (ys - Ks[1, 2]) / Ks[1, 1]], -1)
        src = distort(xy, Ks, np.asarray(dist, np.float64))
        mx, my = src[..., 0] - g.pad_left, src[..., 1] - g.pad_top  # content coordinates
        if np.any(np.diff(my, axis=0) <= 0):
            raise ValueError("the vertical map is not monotonic: no two-pass warp")
        hs, ws = g.new_h, g.new_w
        ho, wo = mx.shape
        yo = np.arange(ho, dtype=np.float64)
        sx = np.empty((hs, wo))
        rows = np.arange(hs, dtype=np.float64)
        for c in range(wo):
            sx[:, c] = np.interp(np.interp(rows, my[:, c], yo), yo, mx[:, c])
        dev = torch.device(device)
        x0 = np.floor(sx)
        self.p1 = self._taps(x0, sx - x0, ws, dev)
        y0 = np.floor(my)
        self.p2 = self._taps(y0, my - y0, hs, dev)

    @staticmethod
    def _taps(i0: np.ndarray, frac: np.ndarray, n: int, dev):
        out = []
        for tap, w in ((i0, 1.0 - frac), (i0 + 1, frac)):
            ok = (tap >= 0) & (tap < n)
            out.append((torch.as_tensor(np.clip(tap, 0, n - 1).astype(np.int64), device=dev),
                        torch.as_tensor(np.where(ok, w, 0.0).astype(np.float32), device=dev)))
        return out

    def __call__(self, content: torch.Tensor) -> torch.Tensor:
        """(B, hs, ws, 3) float32 -> (B, dst_h, dst_w, 3)."""
        x = content - PAD
        b, hs, ws, c = x.shape
        i1 = 0
        for idx, w in self.p1:  # idx, w: (hs, wo)
            g = torch.gather(x, 2, idx[None, :, :, None].expand(b, -1, -1, c))
            i1 = i1 + g * w[None, :, :, None]
        out = 0
        for idx, w in self.p2:  # (ho, wo)
            g = torch.gather(i1, 1, idx[None, :, :, None].expand(b, -1, -1, c))
            out = out + g * w[None, :, :, None]
        return out + PAD


def anchors(levels, device):
    pts, strides = [], []
    for (h, w), s in zip(levels, STRIDES):
        yy, xx = torch.meshgrid((torch.arange(h, device=device) + 0.5) * s,
                                (torch.arange(w, device=device) + 0.5) * s, indexing="ij")
        pts.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], -1))
        strides.append(torch.full((h * w,), float(s), device=device))
    return torch.cat(pts), torch.cat(strides)


def iou_matrix(b: np.ndarray) -> np.ndarray:
    area = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    lt = np.maximum(b[:, None, :2], b[None, :, :2])
    rb = np.minimum(b[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-9)


def greedy_nms(boxes, scores, classes, conf, iou_thresh, pre_topk, max_det):
    """Candidates over ``conf``, the top ``pre_topk`` by score (ties in
    index order), the greedy class-aware keep-set, the top ``max_det``
    survivors. Returns indices into the anchors and their scores."""
    ranked = np.where(scores > conf, scores, -1.0)
    order = np.argsort(-ranked, kind="stable")[:pre_topk]
    ok = ranked[order] > 0
    cand = boxes[order]
    same = classes[order][:, None] == classes[order][None, :]
    blocked = (iou_matrix(cand) > iou_thresh) & same
    keep = np.zeros(len(order), bool)
    for i in range(len(order)):
        keep[i] = ok[i] and not np.any(blocked[i, :i] & keep[:i])
    sel = np.argsort(-np.where(keep, ranked[order], -1.0), kind="stable")[:max_det]
    sel = sel[keep[sel]]
    return order[sel]


def masked_median(vals: np.ndarray) -> float | None:
    return float(np.median(vals)) if vals.size else None


def kmeans2(values: np.ndarray, valid: np.ndarray, iters: int = 10) -> np.ndarray:
    """1-D two-means over the valid values from the extremes; a split that
    empties a cluster keeps the centres."""
    v = values[valid]
    c0, c1 = v.min(), v.max()
    for _ in range(iters):
        lab = np.abs(v - c1) < np.abs(v - c0)
        if lab.all() or not lab.any():
            continue
        c0, c1 = v[~lab].mean(), v[lab].mean()
    labels = np.zeros(values.shape, np.int32)
    labels[valid] = (np.abs(v - c1) < np.abs(v - c0)).astype(np.int32)
    return labels


class ReferenceStep:
    """The reference for one configuration (``config`` is the parsed
    ``benchmark/configs/<name>.json``, ``root`` the checkout)."""

    def __init__(self, config: dict, root: str, device) -> None:
        self.device = torch.device(device)
        run = config["run"]
        ckpt = f"{root}/{run['checkpoint']}"
        with open(ckpt + ".json", encoding="utf-8") as f:
            self.meta = json.load(f)
        m = config["model"]
        self.model = ReferenceYOLOv8Seg(load_flax_msgpack(ckpt), self.device, m["variant"],
                                        m["mask_stride"], m["proto_head"])
        self.cfg = run
        h, w = run["frame_hw"]
        self.g = Geometry.rect(h, w, m["imgsz"])
        cam = run["camera"]
        K = np.array(cam["K_sensor"], np.float64)
        K[0] *= w / cam["sensor_wh"][0]
        K[1] *= h / cam["sensor_wh"][1]
        self.K = K
        self.R = rodrigues(cam["rvec"])
        self.t = np.asarray(cam["tvec"], np.float64)
        self.warp = Warp(K, np.asarray(cam["dist"], np.float64), self.g, self.device)
        self.roi = roi_box(run["roi"], (h, w))
        self.subcell, self.env_subcell = readouts(self.meta)
        self.cal_edge = float(self.meta.get("cal_edge_mm", 0.0))
        self.cal_width = float(self.meta.get("cal_width_mm", 0.0))

    # -- device part: preprocess, forward, decode -------------------------

    @torch.no_grad()
    def _forward(self, frames_u8: np.ndarray):
        g = self.g
        x = torch.as_tensor(frames_u8, device=self.device).flip(-1).float() / 255.0
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(g.new_h, g.new_w), mode="bilinear",
                          align_corners=False, antialias=False).permute(0, 2, 3, 1)
        x = self.warp(x).permute(0, 3, 1, 2).contiguous()
        box, cls, coef, protos, levels = self.model(x)
        pts, strides = anchors(levels, self.device)
        b = box.shape[0]
        ltrb = (torch.softmax(box.reshape(b, -1, 4, REG_MAX), -1)
                * torch.arange(REG_MAX, device=self.device)).sum(-1) * strides[None, :, None]
        boxes = torch.cat([pts[None] - ltrb[..., :2], pts[None] + ltrb[..., 2:]], -1)
        return boxes, torch.sigmoid(cls), coef, protos

    def __call__(self, frames_u8: np.ndarray, block: int = 8) -> list[dict]:
        """Per-frame outputs for (N, H, W, 3) uint8 BGR frames, in blocks."""
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            out = []
            for i in range(0, len(frames_u8), block):
                boxes, probs, coefs, protos = self._forward(frames_u8[i:i + block])
                for j in range(boxes.shape[0]):
                    out.append(self._frame(boxes[j], probs[j], coefs[j], protos[j]))
            return out
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    # -- per frame: NMS, measurement --------------------------------------

    def _frame(self, boxes, probs, coefs, protos) -> dict:
        c, g, run = self.cfg, self.g, self.cfg
        nms = c["nms"]
        probs_np = probs.double().cpu().numpy()
        scores_all, classes_all = probs_np.max(-1), probs_np.argmax(-1)
        boxes_np = boxes.double().cpu().numpy()
        keep = greedy_nms(boxes_np, scores_all, classes_all, nms["conf_thresh"],
                          nms["iou_thresh"], nms["pre_topk"], nms["max_det"])
        d = nms["max_det"]
        n = len(keep)
        bx = np.zeros((d, 4))
        bx[:n] = boxes_np[keep]
        scores = np.zeros(d)
        scores[:n] = scores_all[keep]
        classes = np.full(d, -1, np.int64)
        classes[:n] = classes_all[keep]
        valid = np.arange(d) < n
        frame_boxes = bx.copy()
        frame_boxes[:, 0::2] = np.clip((bx[:, 0::2] - g.pad_left) / g.scale, 0, g.src_w)
        frame_boxes[:, 1::2] = np.clip((bx[:, 1::2] - g.pad_top) / g.scale, 0, g.src_h)
        out = {"boxes_frame": frame_boxes, "scores": scores, "classes": classes, "valid": valid,
               "telemetry": {"n_candidates": int((scores_all > nms["conf_thresh"]).sum()),
                             "n_valid": n}}
        coef_sel = torch.zeros((d, coefs.shape[-1]), device=self.device)
        coef_sel[:n] = coefs[torch.as_tensor(keep, device=self.device, dtype=torch.long)]
        out.update(self._measure(bx, scores, classes, valid, frame_boxes, coef_sel, protos))
        return out

    def _mask_stats(self, protos, coefs, boxes_grid, rows):
        """Statistics of the masks of ``rows`` (the in-ROI top detections)
        on the proto grid, in float32 on the device, returned as float64
        numpy."""
        hm, wm, _ = protos.shape
        dev = self.device
        bg = torch.as_tensor(boxes_grid, dtype=torch.float32, device=dev)
        ys = torch.arange(hm, dtype=torch.float32, device=dev).view(1, hm, 1)
        xs = torch.arange(wm, dtype=torch.float32, device=dev).view(1, 1, wm)
        inside = ((xs >= bg[:, 0, None, None]) & (xs < bg[:, 2, None, None])
                  & (ys >= bg[:, 1, None, None]) & (ys < bg[:, 3, None, None])
                  & torch.as_tensor(rows, device=dev)[:, None, None])
        logits = torch.einsum("dc,hwc->dhw", coefs, protos)
        if self.subcell or self.env_subcell:
            p = torch.where(inside, torch.sigmoid(logits), 0.0)
            occ = p >= 0.5
        else:
            p = None
            occ = (logits > 0) & inside
        m = occ.float()
        st = {"m00": m.sum((1, 2)), "m10": (m * xs).sum((1, 2)), "m01": (m * ys).sum((1, 2)),
              "col_any": m.amax(1), "bottom": torch.where(occ, ys, -1.0).amax(1)}
        if p is not None:
            bottom = st["bottom"]
            p_b = torch.where(ys == bottom[:, None, :], p, 0.0).sum(1)
            p_below = torch.where(ys == bottom[:, None, :] + 1, p, 0.0).sum(1)
            frac = torch.clamp((p_b - 0.5) / torch.clamp(p_b - p_below, min=1e-6), 0.0, 1.0)
            st.update({"m00s": p.sum((1, 2)), "m10s": (p * xs).sum((1, 2)),
                       "m01s": (p * ys).sum((1, 2)), "col_p": p.amax(1),
                       "bottom_sub": torch.where(bottom >= 0, bottom + frac, -1.0)})
        return {k: v.double().cpu().numpy() for k, v in st.items()}

    def _to_mm(self, uv: np.ndarray):
        """Rectified pixels (..., 2) -> plane millimetres, and whether the
        ray meets the plane."""
        K, R, t = self.K, self.R, self.t
        v0 = (uv[..., 1] - K[1, 2]) / K[1, 1]
        u0 = (uv[..., 0] - K[0, 2] - K[0, 1] * v0) / K[0, 0]
        ray = np.stack([u0, v0, np.ones_like(u0)], -1)
        n_c = R[:, 2]
        denom = ray @ n_c
        ok = np.abs(denom) >= 1e-9
        s = (n_c @ t) / np.where(ok, denom, 1.0)
        world = (s[..., None] * ray - t) @ R
        return np.where(ok[..., None], world, 0.0) * 1000.0, ok

    def _measure(self, bx, scores, classes, valid, frame_boxes, coefs, protos) -> dict:
        g, mc = self.g, self.cfg["measure"]
        stitch_id, fabric_id = mc["stitch_class_id"], mc["fabric_class_id"]
        x1, y1, x2, y2 = self.roi
        cx = 0.5 * (frame_boxes[:, 0] + frame_boxes[:, 2])
        cy = 0.5 * (frame_boxes[:, 1] + frame_boxes[:, 3])
        in_roi_full = (cx >= x1) & (cx <= x2) & (cy >= y1) & (cy <= y2) & valid
        tele = {"n_roi_valid": int(in_roi_full.sum()),
                "n_stitches_raw": int((in_roi_full & (classes == stitch_id)).sum())}
        top = mc["max_stats_dets"]
        in_roi = in_roi_full[:top]
        hm, wm = protos.shape[0], protos.shape[1]
        grid = bx[:top].copy()
        grid[:, 0::2] *= wm / g.dst_w
        grid[:, 1::2] *= hm / g.dst_h
        st = self._mask_stats(protos, coefs[:top], grid, in_roi)
        is_stitch = in_roi & (classes[:top] == stitch_id)
        is_fabric = in_roi & (classes[:top] == fabric_id)
        key = "bottom_sub" if self.env_subcell else "bottom"
        env = np.where(is_fabric[:, None], st[key], -1.0).max(0) if top else np.full(wm, -1.0)
        fabric_any = bool(np.any(is_fabric & (st["m00"] > 0)))
        q = g.dst_w / wm
        nst = mc["max_stitches"]
        order = np.argsort(-np.where(is_stitch, scores[:top], -1.0), kind="stable")[:nst]
        sel = is_stitch[order]
        b = grid[order]
        if self.subcell:
            m00 = st["m00s"][order]
            has = (m00 > 1e-6) & sel
            cxm = st["m10s"][order] / np.maximum(m00, 1e-6)
            cym = st["m01s"][order] / np.maximum(m00, 1e-6)
            left, right = self._subcell_extent(st["col_p"][order])
            dlt = (q - 1.0) / (2.0 * q)
            cxm = np.where(has, cxm, 0.5 * (b[:, 0] + b[:, 2]) - dlt)
            cym = np.where(has, cym, 0.5 * (b[:, 1] + b[:, 3]) - dlt)
            left = np.where(has, left, b[:, 0] - dlt)
            right = np.where(has, right, b[:, 2] - dlt)
            lo, hi = (q - 1) / 2, (q - 1) / 2
        else:
            m00 = st["m00"][order]
            has = (m00 > 1e-6) & sel
            cxm = st["m10"][order] / np.maximum(m00, 1e-6)
            cym = st["m01"][order] / np.maximum(m00, 1e-6)
            col = st["col_any"][order] > 0
            left = np.argmax(col, -1).astype(np.float64)
            right = (wm - 1 - np.argmax(col[:, ::-1], -1)).astype(np.float64)
            cxm = np.where(has, cxm, 0.5 * (b[:, 0] + b[:, 2]))
            cym = np.where(has, cym, 0.5 * (b[:, 1] + b[:, 3]))
            left = np.where(has, left, b[:, 0])
            right = np.where(has, right, b[:, 2])
            lo, hi = 0.0, q - 1.0
        mid = (q - 1) / 2
        st_cx = (cxm * q + mid - g.pad_left) / g.scale
        st_cy = (cym * q + mid - g.pad_top) / g.scale
        st_l = (left * q + lo - g.pad_left) / g.scale
        st_r = (right * q + hi - g.pad_left) / g.scale
        stitches = {"cx": st_cx, "cy": st_cy, "left": st_l, "right": st_r, "valid": sel}
        meas = self._readings(stitches, env, fabric_any, q)
        return {"stitches": stitches, "envelope": env, "measurements": meas,
                "telemetry_measure": tele}

    @staticmethod
    def _subcell_extent(col_p: np.ndarray):
        w = col_p.shape[-1]
        occ = col_p >= 0.5
        li = np.argmax(occ, -1)
        ri = w - 1 - np.argmax(occ[:, ::-1], -1)
        rows = np.arange(len(col_p))
        p_l = col_p[rows, li]
        p_lp = np.where(li > 0, col_p[rows, np.maximum(li - 1, 0)], 0.0)
        lfrac = np.clip((0.5 - p_lp) / np.maximum(p_l - p_lp, 1e-6), 0, 1)
        p_r = col_p[rows, ri]
        p_rn = np.where(ri < w - 1, col_p[rows, np.minimum(ri + 1, w - 1)], 0.0)
        rfrac = np.clip((p_r - 0.5) / np.maximum(p_r - p_rn, 1e-6), 0, 1)
        return li - 1.0 + lfrac, ri + rfrac

    def _readings(self, s: dict, env: np.ndarray, fabric_any: bool, q: float) -> dict:
        g, mc = self.g, self.cfg["measure"]
        valid = s["valid"]
        n_st = int(valid.sum())
        to_frame_env = ((lambda y: (y * q + (q - 1) / 2 - g.pad_top) / g.scale)
                        if self.env_subcell
                        else (lambda y: (y * q + (q - 1) - g.pad_top) / g.scale))
        # widths from all stitches
        wl, okl = self._to_mm(np.stack([s["left"], s["cy"]], -1))
        wr, okr = self._to_mm(np.stack([s["right"], s["cy"]], -1))
        widths = np.linalg.norm(wr - wl, axis=-1)
        width_valid = valid & okl & okr
        # the envelope around each stitch's column
        nb = mc["envelope_neighborhood"]
        w = env.shape[0]
        env_y = np.zeros(len(valid))
        has_env = np.zeros(len(valid), bool)
        for i in range(len(valid)):
            cols_f = ((s["cx"][i] + np.arange(-nb, nb + 1)) * g.scale + g.pad_left) / q
            cols = np.clip(np.trunc(cols_f).astype(np.int64), 0, w - 1)
            vals = env[cols]
            med = masked_median(vals[vals >= 0])
            if med is not None:
                env_y[i], has_env[i] = to_frame_env(med), True
        # row selection
        if n_st >= 2:
            labels = kmeans2(s["cy"], valid)
            live_env = env[env >= 0]
            c_dist = []
            for lab in (0, 1):
                sel = valid & (labels == lab)
                if sel.any() and live_env.size:
                    c_dist.append(abs(s["cy"][sel].mean() - to_frame_env(live_env.mean())))
                else:
                    c_dist.append(1e9)
            chosen = 1 if (live_env.size and not c_dist[0] < c_dist[1]) else 0
            selected = valid & (labels == chosen)
        else:
            selected = valid.copy()
        near = selected & has_env & (np.abs(s["cy"] - env_y) < mc["max_px_distance"])
        final = near if near.any() else selected
        e1, ok1 = self._to_mm(np.stack([s["cx"], s["cy"]], -1))
        e2, ok2 = self._to_mm(np.stack([s["cx"], env_y], -1))
        dists = np.linalg.norm(e2 - e1, axis=-1)
        dist_valid = final & has_env & ok1 & ok2
        n_dist, n_width = int(dist_valid.sum()), int(width_valid.sum())
        usable = fabric_any and n_st > 0
        edge = (dists[dist_valid].mean() + self.cal_edge
                if usable and n_dist >= mc["min_stitches"] else math.nan)
        width = (widths[width_valid].mean() + self.cal_width
                 if usable and n_width >= mc["min_stitches"] else math.nan)
        return {"edge_distance_mm": edge, "stitch_width_mm": width,
                "n_dist": n_dist if usable else 0, "n_width": n_width if usable else 0,
                "n_stitches": n_st, "fabric_detected": fabric_any}
