"""Ultralytics PyTorch state dicts <-> the flax-layout variable tree (port of
``tti.model.convert``'s conversion).

The reference's trained weights (``best_Model.pt``, ``single_needle_model.pt``)
are Ultralytics state dicts (``model.{idx}.{...}`` keys). This module maps
them to the tree of numpy arrays that :mod:`tti_torch.model.checkpoint` reads
and writes (``save_flax_msgpack``, ``from_flax_variables``), and back, under
``tti``'s rules:

- conv weights (O, I, kH, kW) -> (kH, kW, I, O);
- the proto deconv's weights (I, O, kH, kW) -> both spatial axes flipped,
  then (kH, kW, I, O);
- BatchNorm weight/bias -> ``params/.../bn/{scale,bias}``, running
  mean/var -> ``batch_stats/.../bn/{mean,var}``;
- ``model.22.dfl.conv.weight`` is skipped: the fixed arange(16) projection,
  a softmax expectation in :mod:`tti_torch.postprocess.decode`;
- keys outside ``model.`` are ignored, an unknown parameter suffix raises;
- :func:`to_torch_state_dict` refuses a folded tree (no running statistics)
  and the stride-2 proto head (no Ultralytics counterpart).

The module index map (m0..m22) is the model's (:mod:`tti_torch.model.yolo`).
The checkpoint transforms (``stem_to_s2d``, ``fold_batchnorm``) and the
msgpack writer are :mod:`tti_torch.model.checkpoint`'s.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np

Tree = dict[str, Any]

_HEAD_BRANCH = re.compile(r"^(cv[234])\.(\d)\.(\d)\.(.*)$")
_C2F_INNER = re.compile(r"^m\.(\d+)\.(.*)$")


def _set_path(tree: Tree, path: list[str], value: np.ndarray) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _to_numpy(t: Any) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _convert_leaf(rest: str, tensor: np.ndarray, params_path: list[str], params: Tree,
                  batch_stats: Tree, transpose_deconv: bool = False) -> None:
    """Map one torch parameter suffix ('conv.weight', 'bn.running_mean', ...)
    into the tree rooted at ``params_path``."""
    if rest == "conv.weight":
        _set_path(params, params_path + ["conv", "kernel"], tensor.transpose(2, 3, 1, 0))
    elif rest == "bn.weight":
        _set_path(params, params_path + ["bn", "scale"], tensor)
    elif rest == "bn.bias":
        _set_path(params, params_path + ["bn", "bias"], tensor)
    elif rest == "bn.running_mean":
        _set_path(batch_stats, params_path + ["bn", "mean"], tensor)
    elif rest == "bn.running_var":
        _set_path(batch_stats, params_path + ["bn", "var"], tensor)
    elif rest == "bn.num_batches_tracked":
        pass
    elif rest == "weight":  # a plain conv with bias, or the proto deconv
        if transpose_deconv:
            # torch's ConvTranspose2d applies its kernel flipped relative to
            # flax's ConvTranspose: flip both spatial axes, then (I, O, kH, kW)
            # -> (kH, kW, I, O).
            _set_path(params, params_path + ["kernel"],
                      tensor[:, :, ::-1, ::-1].transpose(2, 3, 0, 1).copy())
        else:
            _set_path(params, params_path + ["kernel"], tensor.transpose(2, 3, 1, 0))
    elif rest == "bias":
        _set_path(params, params_path + ["bias"], tensor)
    else:
        raise ValueError(f"unhandled parameter suffix: {rest!r} at {'/'.join(params_path)}")


def convert_torch_state_dict(state_dict: Mapping[str, Any]) -> dict[str, Tree]:
    """An Ultralytics-format state dict -> ``{'params': ..., 'batch_stats':
    ...}`` of numpy float32 arrays, the tree of an unfolded YOLOv8-seg
    checkpoint."""
    params: Tree = {}
    batch_stats: Tree = {}
    for name, value in state_dict.items():
        if not name.startswith("model."):
            continue
        tensor = _to_numpy(value)
        _, idx, rest = name.split(".", 2)
        path = [f"m{idx}"]
        if "dfl" in rest:
            continue  # the fixed arange projection, realised in decode
        head = _HEAD_BRANCH.match(rest)
        if head:  # head branches: cv2/cv3/cv4 .level.block.suffix
            branch, level, block, suffix = head.groups()
            _convert_leaf(suffix, tensor, path + [f"{branch}_{level}_{block}"], params,
                          batch_stats)
            continue
        if rest.startswith("proto."):
            sub = rest[len("proto."):]
            if sub.startswith("upsample."):
                _convert_leaf(sub[len("upsample."):], tensor, path + ["proto", "upsample"],
                              params, batch_stats, transpose_deconv=True)
            else:
                inner, _, suffix = sub.partition(".")
                _convert_leaf(suffix, tensor, path + ["proto", inner], params, batch_stats)
            continue
        inner_match = _C2F_INNER.match(rest)
        if inner_match:  # C2f bottlenecks: m.{j}.cvX.* -> m{j}/cvX/*
            j, sub = inner_match.groups()
            inner, _, suffix = sub.partition(".")
            _convert_leaf(suffix, tensor, path + [f"m{j}", inner], params, batch_stats)
            continue
        if rest.startswith(("cv1.", "cv2.")):  # C2f/SPPF cv1/cv2
            inner, _, suffix = rest.partition(".")
            _convert_leaf(suffix, tensor, path + [inner], params, batch_stats)
        else:  # a plain Conv block: 'conv.weight' / 'bn.*'
            _convert_leaf(rest, tensor, path, params, batch_stats)
    return {"params": params, "batch_stats": batch_stats}


_HEAD_KEY = re.compile(r"^cv[234]_\d+_\d+$")
_MODULE_KEY = re.compile(r"^m\d+$")


def _torch_prefix(path: list[str]) -> str:
    parts: list[str] = []
    for depth, key in enumerate(path):
        if depth == 0:
            if not _MODULE_KEY.fullmatch(key):
                raise ValueError(f"cannot export transformed module {key!r}: export the raw "
                                 "(pre-s2d, pre-head-fusion) checkpoint")
            parts += ["model", key[1:]]  # m22 -> model.22
        elif _HEAD_KEY.fullmatch(key):
            parts += key.split("_")  # cv2_0_1 -> cv2.0.1
        elif _MODULE_KEY.fullmatch(key):
            parts += ["m", key[1:]]  # a C2f bottleneck: m0 -> m.0
        else:
            parts.append(key)  # cv1/cv2/cv3/proto/upsample/conv/bn
    return ".".join(parts)


def to_torch_state_dict(variables: Tree, reg_max: int = 16) -> dict[str, np.ndarray]:
    """Inverse of :func:`convert_torch_state_dict`: the tree -> an
    Ultralytics-format state dict of numpy float32 arrays, with the fixed DFL
    projection and zero ``num_batches_tracked`` entries, so that
    ``load_state_dict(strict=True)`` takes it. Needs an unfolded tree
    (params and batch_stats)."""
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    proto = params.get("m22", {}).get("proto", {})
    if "upsample2" in proto or "cv2b" in proto:
        raise ValueError("mask_stride=2 checkpoints (hi-res proto head) have no Ultralytics "
                         "counterpart: the torch Segment head is fixed at proto=input/4")
    out: dict[str, np.ndarray] = {}
    f32 = lambda a: np.asarray(a, np.float32)

    def emit(path: list[str], pnode: Tree, snode: Any) -> None:
        prefix = _torch_prefix(path)
        if "kernel" in pnode:  # a plain conv (the head's exit 1x1s) or the proto deconv
            k = f32(pnode["kernel"])
            if path[-1] == "upsample":
                out[prefix + ".weight"] = k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1].copy()
            else:
                out[prefix + ".weight"] = k.transpose(3, 2, 0, 1).copy()
            if "bias" in pnode:
                out[prefix + ".bias"] = f32(pnode["bias"])
            return
        if "conv" in pnode and "bn" not in pnode and "kernel" in pnode["conv"]:
            raise ValueError(f"{prefix}: BN-folded variables cannot be exported: pass the "
                             "unfolded checkpoint (torch needs running statistics)")
        if "conv" in pnode and "bn" in pnode:
            out[prefix + ".conv.weight"] = f32(pnode["conv"]["kernel"]).transpose(3, 2, 0, 1).copy()
            out[prefix + ".bn.weight"] = f32(pnode["bn"]["scale"])
            out[prefix + ".bn.bias"] = f32(pnode["bn"]["bias"])
            sbn = (snode or {}).get("bn")
            if sbn is None:
                raise ValueError(f"{prefix}: missing batch_stats for BN export")
            out[prefix + ".bn.running_mean"] = f32(sbn["mean"])
            out[prefix + ".bn.running_var"] = f32(sbn["var"])
            out[prefix + ".bn.num_batches_tracked"] = np.zeros((), np.int64)
            return
        for key, child in pnode.items():
            if isinstance(child, dict):
                emit(path + [key], child, snode.get(key, {}) if isinstance(snode, dict) else {})

    for module, pnode in params.items():
        emit([module], pnode, batch_stats.get(module, {}))
    out["model.22.dfl.conv.weight"] = np.arange(reg_max, dtype=np.float32).reshape(
        1, reg_max, 1, 1)
    return out


def verify_tree_shapes(converted: Tree, reference: Tree, path: str = "") -> list[str]:
    """``converted`` against a reference tree of the same architecture: the
    missing and unexpected keys and the shape mismatches, both ways (an
    empty list: structurally identical)."""
    problems: list[str] = []
    for missing in sorted(set(reference) - set(converted)):
        problems.append(f"missing {path}/{missing}")
    for extra in sorted(set(converted) - set(reference)):
        problems.append(f"unexpected {path}/{extra}")
    for key in sorted(set(reference) & set(converted)):
        r, c = reference[key], converted[key]
        if isinstance(r, dict):
            if not isinstance(c, dict):
                problems.append(f"type mismatch at {path}/{key}")
            else:
                problems.extend(verify_tree_shapes(c, r, f"{path}/{key}"))
        elif tuple(np.shape(c)) != tuple(np.shape(r)):
            problems.append(f"shape mismatch at {path}/{key}: {np.shape(c)} vs {np.shape(r)}")
    return problems
