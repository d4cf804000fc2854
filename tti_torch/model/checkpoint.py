"""Flax msgpack checkpoints <-> PyTorch state dicts, without flax or msgpack.

Four parts:

- :func:`load_flax_msgpack` is a small pure-Python msgpack decoder for the
  files ``flax.serialization.to_bytes`` writes: maps, strings, bin, arrays,
  ints, floats, nil/bool, and ext type 1 (a packed ``(shape, dtype_name,
  buffer)`` ndarray; ext 3 is the same for numpy scalars).
  :func:`checkpoint_metadata` reads the ``.json`` sidecar.
- :func:`save_flax_msgpack` is the encoder for the same format (what
  ``tti.model.convert.save_checkpoint`` writes), with the sidecar.
- :func:`stem_to_s2d` and :func:`fold_batchnorm` are copies of the exact
  inference transforms in ``tti.model.convert``.
- :func:`from_flax_variables` maps a flax tree onto
  :class:`tti_torch.model.yolo.YOLOv8Seg`'s state dict and
  :func:`to_flax_variables` maps back: module paths are the flax paths
  joined with '.', conv kernels go (kH, kW, I, O) <-> (O, I, kH, kW), and
  transposed-conv kernels go (kH, kW, I, O) <-> (I, O, kH, kW) with both
  spatial axes flipped (flax's ConvTranspose applies its kernel un-flipped,
  torch's ConvTranspose2d is the gradient of a correlation). An unfolded
  tree's ``bn`` nodes are the BatchNorm's weight (flax ``scale``) and bias,
  and its ``batch_stats`` the running mean and variance.
"""

from __future__ import annotations

import copy
import json
import os
import struct
from typing import Any

import numpy as np

Tree = dict[str, Any]

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """Decoder state over one msgpack byte string (big-endian wire format)."""

    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(">" + fmt, self.take(size))[0]

    def obj(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # code -> (length format, kind)
            0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
            0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
            0xDC: ("H", "array"), 0xDD: ("I", "array"),
            0xDE: ("H", "map"), 0xDF: ("I", "map"),
            0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.unpack("b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, buf = _Reader(payload).obj()
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        if dtype_name == "bfloat16":  # upper half of an f32 bit pattern
            raw = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
            arr = raw.view(np.float32)
        else:
            arr = np.frombuffer(buf, np.dtype(dtype_name)).copy()
        return arr.reshape(tuple(shape))


def _unchunk(tree: Any) -> Any:
    """Reassemble flax's chunked-array leaves (written for very large arrays)."""
    if not isinstance(tree, dict):
        return tree
    if tree.get("__msgpack_chunked_array__"):
        shape = tuple(tree["shape"][k] for k in sorted(tree["shape"], key=int))
        chunks = [tree["chunks"][k] for k in sorted(tree["chunks"], key=int)]
        return np.concatenate([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_flax_msgpack(path: str) -> Tree:
    """Decode a flax msgpack checkpoint into a nested dict of numpy arrays."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return _unchunk(tree)


class _Writer:
    """Encoder state: msgpack's big-endian wire format, the subset
    :class:`_Reader` decodes."""

    def __init__(self) -> None:
        self.parts: list[bytes] = []

    def head(self, n: int, fix: int | None, fix_max: int, codes: tuple[int, ...]) -> None:
        """A type byte and length: the fix form below ``fix_max``, else the
        8-, 16- or 32-bit length form (``codes``, smallest first; maps and
        arrays have no 8-bit form)."""
        if fix is not None and n <= fix_max:
            self.parts.append(struct.pack(">B", fix | n))
            return
        fmts = ("B", "H", "I")[3 - len(codes):]
        for code, fmt in zip(codes, fmts):
            if n < 1 << (8 * struct.calcsize(fmt)):
                self.parts.append(struct.pack(">B" + fmt, code, n))
                return
        raise ValueError(f"msgpack object of {n} elements is too large")

    def obj(self, x: Any) -> None:
        if isinstance(x, dict):
            self.head(len(x), 0x80, 15, (0xDE, 0xDF))
            for key, value in x.items():
                self.obj(str(key))
                self.obj(value)
        elif isinstance(x, str):
            data = x.encode("utf-8")
            self.head(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
            self.parts.append(data)
        elif isinstance(x, bytes):
            self.head(len(x), None, -1, (0xC4, 0xC5, 0xC6))
            self.parts.append(x)
        elif isinstance(x, (list, tuple)):
            self.head(len(x), 0x90, 15, (0xDC, 0xDD))
            for item in x:
                self.obj(item)
        elif x is None or isinstance(x, bool):
            self.parts.append({None: b"\xc0", False: b"\xc2", True: b"\xc3"}[x])
        elif isinstance(x, int):
            if 0 <= x <= 0x7F or -32 <= x < 0:
                self.parts.append(struct.pack(">b" if x < 0 else ">B", x))
                return
            forms = ((0xCC, "B"), (0xCD, "H"), (0xCE, "I"), (0xCF, "Q")) if x > 0 else \
                ((0xD0, "b"), (0xD1, "h"), (0xD2, "i"), (0xD3, "q"))
            for code, fmt in forms:
                bits = 8 * struct.calcsize(fmt)
                if (x < 1 << bits) if x > 0 else (x >= -(1 << (bits - 1))):
                    self.parts.append(struct.pack(">B" + fmt, code, x))
                    return
            raise ValueError(f"integer {x} is out of msgpack's range")
        elif isinstance(x, float):
            self.parts.append(struct.pack(">Bd", 0xCB, x))
        elif isinstance(x, np.ndarray):
            self.ext(_EXT_NDARRAY, x)
        else:
            raise TypeError(f"cannot encode {type(x).__name__} as msgpack")

    def ext(self, code: int, arr: np.ndarray) -> None:
        inner = _Writer()
        arr = np.ascontiguousarray(arr)
        inner.obj([list(arr.shape), arr.dtype.name, arr.tobytes()])
        payload = b"".join(inner.parts)
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            self.parts.append(struct.pack(">Bb", fixext[n], code))
        else:
            self.head(n, None, -1, (0xC7, 0xC8, 0xC9))
            self.parts.append(struct.pack(">b", code))
        self.parts.append(payload)


def save_flax_msgpack(variables: Tree, path: str, metadata: dict | None = None) -> None:
    """Write a nested dict of numpy arrays as ``flax.serialization.to_bytes``
    does (ndarray leaves as ext type 1), and ``metadata`` as the ``.json``
    sidecar. The file loads in ``tti.model.convert.load_checkpoint`` and in
    :func:`load_flax_msgpack`. (Arrays above flax's 1 GiB chunk size would
    need its chunked form; a checkpoint of this model has none.)"""
    writer = _Writer()
    writer.obj(variables)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(b"".join(writer.parts))
    os.replace(tmp, path)
    if metadata is not None:
        with open(path + ".json", "w", encoding="utf-8") as f:
            json.dump(metadata, f, indent=2)


def checkpoint_metadata(path: str) -> dict:
    """The ``{path}.json`` sidecar, or {} when there is none."""
    sidecar = path + ".json"
    if not os.path.isfile(sidecar):
        return {}
    with open(sidecar, "r", encoding="utf-8") as f:
        return json.load(f)


def stem_to_s2d(variables: Tree) -> Tree:
    """Rewrite the k3/s2 stem (m0) into the exact space-to-depth form (m0s2d):
    a k2/s1 conv over the 2x2-blocked 12-channel input, applied after one row
    and one column of zero padding at the top/left (copy of the reference)."""
    new_vars = {
        "params": dict(variables["params"]),
        "batch_stats": dict(variables["batch_stats"]),
    }
    w = np.asarray(variables["params"]["m0"]["conv"]["kernel"])  # (3,3,3,C)
    c_in, c_out = w.shape[2], w.shape[3]
    k2 = np.zeros((2, 2, 4 * c_in, c_out), w.dtype)
    for P in (0, 1):
        for a in (0, 1):
            di = 2 * P + a - 1
            if not 0 <= di <= 2:
                continue
            for Q in (0, 1):
                for b in (0, 1):
                    dj = 2 * Q + b - 1
                    if not 0 <= dj <= 2:
                        continue
                    k2[P, Q, (a * 2 + b) * c_in:(a * 2 + b + 1) * c_in] = w[di, dj]
    m0 = copy.deepcopy(dict(variables["params"]["m0"]))
    m0["conv"] = {"kernel": k2}
    new_vars["params"].pop("m0")
    new_vars["params"]["m0s2d"] = m0
    bs = dict(new_vars["batch_stats"])
    bs["m0s2d"] = bs.pop("m0")
    new_vars["batch_stats"] = bs
    return new_vars


def fuse_head_entries(variables: Tree) -> Tree:
    """Concatenate the three head branches' entry convs (``cv2_L_0``,
    ``cv3_L_0``, ``cv4_L_0``, which read the same level feature map) into one
    conv ``cvh_L`` with stacked output channels, kernels and BatchNorm
    parameters and statistics alike (copy of the reference). Exact: three
    convs on one input equal one conv with their filters stacked."""
    params = dict(variables["params"])
    stats = dict(variables["batch_stats"])
    m22p = copy.deepcopy(dict(params["m22"]))
    m22s = copy.deepcopy(dict(stats["m22"]))
    for level in range(3):
        branches = [f"cv2_{level}_0", f"cv3_{level}_0", f"cv4_{level}_0"]
        cat = lambda tree, *keys: np.concatenate(
            [np.asarray(_at(tree[b], keys)) for b in branches], axis=-1)
        m22p[f"cvh_{level}"] = {
            "conv": {"kernel": cat(m22p, "conv", "kernel")},
            "bn": {key: cat(m22p, "bn", key) for key in ("scale", "bias")},
        }
        m22s[f"cvh_{level}"] = {"bn": {key: cat(m22s, "bn", key) for key in ("mean", "var")}}
        for b in branches:
            m22p.pop(b)
            m22s.pop(b)
    params["m22"] = m22p
    stats["m22"] = m22s
    return {"params": params, "batch_stats": stats}


def _at(tree: Tree, keys: tuple[str, ...]) -> Any:
    for key in keys:
        tree = tree[key]
    return tree


def fold_batchnorm(variables: Tree) -> Tree:
    """Fold every Conv-block BatchNorm into its conv: W' = W*s/sqrt(v+eps),
    b' = beta - m*s/sqrt(v+eps), computed in float64 (copy of the
    reference). Returns {'params': ...} with no 'bn' nodes."""
    eps = 1e-3  # BatchNorm epsilon of the YOLOv8 Conv block

    def fold(params: Tree, stats: Tree) -> Tree:
        out: Tree = {}
        for key, node in params.items():
            if not isinstance(node, dict):
                out[key] = node
                continue
            if "conv" in node and "bn" in node and "kernel" in node.get("conv", {}):
                kernel = np.asarray(node["conv"]["kernel"], np.float64)
                scale = np.asarray(node["bn"]["scale"], np.float64)
                beta = np.asarray(node["bn"]["bias"], np.float64)
                mean = np.asarray(stats[key]["bn"]["mean"], np.float64)
                var = np.asarray(stats[key]["bn"]["var"], np.float64)
                g = scale / np.sqrt(var + eps)
                folded = dict(node)
                folded["conv"] = {
                    "kernel": (kernel * g).astype(np.float32),
                    "bias": (beta - mean * g).astype(np.float32),
                }
                folded.pop("bn")
                rest = {k: v for k, v in folded.items() if k != "conv"}
                if any(isinstance(v, dict) for v in rest.values()):
                    folded.update(fold(rest, stats.get(key, {})))
                out[key] = folded
            else:
                out[key] = fold(node, stats.get(key, {}))
        return out

    return {"params": fold(dict(variables["params"]), dict(variables["batch_stats"]))}


_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def from_flax_variables(variables_np: Tree) -> dict[str, np.ndarray]:
    """Flax variables (numpy leaves) -> a state dict for
    :class:`tti_torch.model.yolo.YOLOv8Seg` (numpy values: float leaves as
    float32, other leaves as they are). A folded tree ({'params': ...}) fits
    the ``folded_bn=True`` model; an unfolded one ({'params', 'batch_stats'},
    ``bn`` nodes) the ``folded_bn=False`` model; a quantized one
    (:func:`tti_torch.model.quantize.quantize_weights`: ``qkernel`` int8,
    ``qscale``, ``bias``, ``ascale``) the ``qmode`` model, ``qkernel``
    (kh, kw, I, O) becoming ``qweight`` (O, kh, kw, I)."""
    out: dict[str, np.ndarray] = {}
    stats_root = variables_np.get("batch_stats")

    def walk(node: Tree, stats: Tree | None, path: list[str]) -> None:
        for key, child in node.items():
            if key == "bn":
                if stats is None or "bn" not in stats:
                    raise ValueError(f"{'/'.join(path)}: BatchNorm without batch_stats; "
                                     "pass the batch_stats or run fold_batchnorm first")
                for src, dst in _BN_PARAMS.items():
                    out[".".join(path + ["bn", dst])] = np.asarray(child[src], np.float32)
                for src, dst in _BN_STATS.items():
                    out[".".join(path + ["bn", dst])] = np.asarray(stats["bn"][src], np.float32)
                continue
            if isinstance(child, dict):
                walk(child, None if stats is None else stats.get(key), path + [key])
                continue
            arr = np.asarray(child)
            if arr.dtype.kind == "f":
                arr = arr.astype(np.float32, copy=False)
            if key == "qkernel":  # (kh, kw, I, O) int8 -> (O, kh, kw, I), kernel E's K order
                out[".".join(path + ["qweight"])] = np.ascontiguousarray(arr.transpose(3, 0, 1, 2))
                continue
            name = ".".join(path + ["weight" if key == "kernel" else key])
            if key == "kernel":
                if path[-1].startswith("upsample"):
                    arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
                else:
                    arr = arr.transpose(3, 2, 0, 1)
            out[name] = np.ascontiguousarray(arr) if arr.ndim else arr.copy()  # keeps 0-d

    walk(variables_np["params"], stats_root, [])
    return out


def to_flax_variables(state_dict: dict[str, Any]) -> Tree:
    """Inverse of :func:`from_flax_variables`: a ``YOLOv8Seg`` state dict
    (tensors or arrays) -> the flax tree under flax's names, numpy float32
    leaves (int8 ``qweight`` -> ``qkernel``, int8): {'params'} for a folded or
    quantized model, {'params', 'batch_stats'} for an unfolded one."""
    params: Tree = {}
    stats: Tree = {}

    def put(tree: Tree, path: list[str], value: np.ndarray) -> None:
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = value

    for name, value in state_dict.items():
        if hasattr(value, "detach"):  # a tensor: int8 as it is, every other dtype as float32
            value = value.detach().cpu()
            arr = value.numpy() if str(value.dtype) == "torch.int8" else value.float().numpy()
        else:
            arr = np.asarray(value)
        if arr.dtype != np.int8:
            arr = arr.astype(np.float32, copy=False)
        *path, leaf = name.split(".")
        if path and path[-1] == "bn":
            if leaf in _BN_STATS.values():
                src = {v: k for k, v in _BN_STATS.items()}[leaf]
                put(stats, path + [src], np.ascontiguousarray(arr))
            else:
                put(params, path + [{v: k for k, v in _BN_PARAMS.items()}[leaf]], arr)
            continue
        if leaf == "qweight":
            put(params, path + ["qkernel"], np.ascontiguousarray(arr.transpose(1, 2, 3, 0)))
            continue
        if leaf == "weight":
            if path[-1].startswith("upsample"):
                arr = arr[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                arr = arr.transpose(2, 3, 1, 0)
            leaf = "kernel"
        put(params, path + [leaf], np.ascontiguousarray(arr) if arr.ndim else arr)
    return {"params": params, "batch_stats": stats} if stats else {"params": params}
