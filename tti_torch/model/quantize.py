"""Post-training int8 quantization (W8A8) for inference (port of
``tti.model.quantize``).

Scheme, as in the reference:

- weights: per-output-channel symmetric int8 (``scale = absmax / 127``,
  round half to even, clip to +-127), computed offline from the
  BatchNorm-folded float tree (:func:`quantize_weights`);
- activations: per-sample symmetric int8 quantized at run time
  (``qmode="int8"``, kernel F's absmax), or one static per-tensor scale per
  block calibrated offline (``qmode="int8s"``,
  :func:`calibrate_act_scales`, ``tools/calibrate_int8_torch.py``);
- accumulation: int32, then ``acc * (act_scale * weight_scale) + bias`` in
  float32 (kernel E, :mod:`tti_torch.kernels.int8conv`).

Only the YOLOv8 ``Conv`` blocks (conv + folded BN + SiLU) quantize; the
head's exit 1x1 convs (``cv{2,3,4}_{level}_2``), the proto head's
transposed-conv upsamples and everything after the model stay float.

The tree functions work on the flax-layout numpy tree, as
:func:`tti_torch.model.checkpoint.fold_batchnorm` does, so a quantized tree
is the reference's bit for bit.
"""

from __future__ import annotations

import json
import os
from typing import Iterable

import numpy as np
import torch

from tti_torch.core.errors import ConfigError
from tti_torch.model.layers import Conv

Tree = dict


def calibrate_act_scales(model: torch.nn.Module, batches: Iterable[torch.Tensor],
                         percentile: float = 100.0) -> dict[str, float]:
    """Per-``Conv``-block input activation scales on calibration data.

    ``model``: a float inference model with folded BatchNorm (its ``Conv``
    blocks are what :func:`quantize_weights` quantizes). A forward
    pre-hook on every block records the input's absmax; within one forward
    a block called again keeps the running max (the reference's ``sow``
    reduces repeats the same way). ``batches``: the model inputs the int8
    model will see. ``percentile``: 100 takes the absmax over all batches;
    below 100, that percentile of the per-batch absmax stream.

    Returns ``{"m1": scale, "m2/cv1": scale, ...}`` keyed by the
    '/'-joined block path, ``max(absmax, 1e-12) / 127``.
    """
    current: dict[str, float] = {}

    def hook(path: str):
        def record(_module, args) -> None:
            top = float(args[0].detach().float().abs().amax())
            current[path] = max(current.get(path, 0.0), top)
        return record

    handles = [mod.register_forward_pre_hook(hook(name.replace(".", "/")))
               for name, mod in model.named_modules() if isinstance(mod, Conv)]
    per_batch: dict[str, list[float]] = {}
    try:
        with torch.inference_mode():
            for x in batches:
                current.clear()
                model(x)
                for path, top in current.items():
                    per_batch.setdefault(path, []).append(top)
    finally:
        for handle in handles:
            handle.remove()
    if not per_batch:
        raise ValueError("no Conv block ran: was the model a YOLOv8Seg with Conv blocks, and "
                         "were there batches?")
    out: dict[str, float] = {}
    for path, vals in per_batch.items():
        a = np.asarray(vals, np.float64)
        absmax = float(np.max(a)) if percentile >= 100.0 else float(np.percentile(a, percentile))
        out[path] = max(absmax, 1e-12) / 127.0
    return out


def check_quant(quant: str, fold_bn: bool = True, fused_head: bool = False) -> None:
    """Raise ``ConfigError`` with the reference's message where ``TTI_QUANT``
    cannot apply: a value other than "", "int8" or "int8s", unfolded
    BatchNorm, or the fused head."""
    if quant not in ("", "int8", "int8s"):
        raise ConfigError(f"TTI_QUANT must be '', 'int8' or 'int8s', got {quant!r}")
    if quant and not fold_bn:
        raise ConfigError(f"TTI_QUANT={quant} requires folded BN (TTI_FOLDED_BN=1)")
    if quant and fused_head:
        raise ConfigError(f"TTI_QUANT={quant} + TTI_FUSED_HEAD=1 is unsupported "
                          "(no calibration path for the fused entries)")


def load_act_scales(path: str | None) -> dict[str, float]:
    """The ``"scales"`` of a calibration file (``tools/calibrate_int8_torch.py``
    or ``tools/calibrate_int8.py``: the two write the same JSON)."""
    if not path or not os.path.exists(path):
        raise ConfigError("TTI_QUANT=int8s needs TTI_QUANT_SCALES=<json from "
                          f"tools/calibrate_int8.py> (per-block activation scales); got {path!r}")
    with open(path, encoding="utf-8") as f:
        return dict(json.load(f)["scales"])


def quantize_conv_kernel(kernel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(kh, kw, ci, co) float kernel -> (int8 kernel, (co,) float32 scales).

    Symmetric per output channel: ``scale_c = absmax_c / 127``,
    ``q = clip(rint(w / scale), -127, 127)`` (half to even, as the
    activation quantizer rounds)."""
    k = np.asarray(kernel, np.float32)
    co = k.shape[-1]
    absmax = np.max(np.abs(k.reshape(-1, co)), axis=0)
    scale = np.maximum(absmax, 1e-12) / 127.0
    kq = np.clip(np.rint(k / scale), -127, 127).astype(np.int8)
    return kq, scale.astype(np.float32)


def quantize_weights(variables: Tree, skip: tuple[str, ...] = (),
                     act_scales: dict[str, float] | None = None) -> Tree:
    """BatchNorm-folded float tree -> the tree of a ``qmode="int8"`` /
    ``"int8s"`` model.

    Every ``Conv`` block node (``{'conv': {'kernel', 'bias'}}``, the shape
    ``fold_batchnorm`` emits) becomes ``{'qkernel' int8, 'qscale' f32,
    'bias' f32}``. Plain convs whose parameters sit at the module level (the
    head's exit 1x1s, the proto head's ``upsample`` deconvs) stay float.

    ``skip``: '/'-joined module paths left float. ``act_scales``: calibrated
    per-block input scales (:func:`calibrate_act_scales`), attached as each
    block's ``ascale`` for ``qmode="int8s"``; every quantized block must
    have one.
    """
    if "params" not in variables:
        raise ValueError("expected {'params': ...} (run fold_batchnorm first)")
    if "batch_stats" in variables and variables["batch_stats"]:
        raise ValueError("unfolded variables: run fold_batchnorm before quantize_weights")

    def skipped(path: tuple[str, ...]) -> bool:
        joined = "/".join(path)
        return any(joined == s or joined.startswith(s + "/") for s in skip)

    def walk(node: Tree, path: tuple[str, ...]) -> Tree:
        out: Tree = {}
        for key, val in node.items():
            if not isinstance(val, dict):
                out[key] = val
                continue
            sub = path + (key,)
            conv = val.get("conv")
            if (isinstance(conv, dict) and "kernel" in conv
                    and np.asarray(conv["kernel"]).ndim == 4 and not skipped(sub)):
                kq, scale = quantize_conv_kernel(conv["kernel"])
                new: Tree = {"qkernel": kq, "qscale": scale,
                             "bias": np.asarray(conv["bias"], np.float32)}
                if act_scales is not None:
                    new["ascale"] = np.asarray(act_scales["/".join(sub)], np.float32)
                # Container blocks (C2f) hold sub-blocks beside their own conv.
                rest = {k: v for k, v in val.items() if k != "conv"}
                if rest:
                    new.update(walk(rest, sub))
                out[key] = new
            else:
                out[key] = walk(val, sub)
        return out

    try:
        params = walk(dict(variables["params"]), ())
    except KeyError as e:
        raise ValueError(
            f"act_scales is missing calibrated block {e} — regenerate with "
            "tools/calibrate_int8.py against THIS checkpoint/architecture") from None
    return {"params": params}
