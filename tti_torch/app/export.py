"""Frozen deployment artifacts: the whole inspection step as ``torch.export``
programs (port of ``tti.app.export``).

:func:`export_pipeline` freezes a built
:class:`tti_torch.parallel.runtime.InspectionPipeline`'s device step, the
preprocess (letterbox and undistort warp), the YOLOv8-seg forward, decode and
NMS, the mask statistics and the px->mm measurement, for one batch size and
frame geometry. :class:`FrozenPipeline` runs it again from the artifact
alone: loading needs torch, this module and ``tti_torch.kernels`` (whose
modules register the kernels' operators the programs call), not the model,
preprocess, postprocess or measurement code.

- One program per device. ``tti`` lowers one StableHLO for several
  platforms; a torch trace records its device in factory calls, so the port
  traces the step once per requested device ("cuda", "cpu") and keeps every
  program in one artifact. The CUDA program launches kernels A-G through
  their operators; the CPU program reaches their plain versions through the
  same operators (the CPU trace of a float model records no kernel G: its
  convolutions take their biases).
- Weights stay arguments, as in ``tti``: the model's parameters and buffers
  (``v<i>``) and every other tensor of the pipeline, the warp's weights and
  the calibration (``w<i>``), are inputs of the program, stored once beside
  the programs, never lifted into them as constants. Entries of the same
  names, shapes and dtypes (a recalibrated warp, a retrained checkpoint) run
  in the same program (:meth:`FrozenPipeline.swap_weights`).
- Outputs are the step's leaves under ``tti``'s ``/``-joined names
  (``dets/valid``, ``measurements/edge_distance_mm``, ...): dict keys in
  sorted order, dataclass fields in their order.

Artifact layout, a zip stored without compression (the port's own format:
``tti``'s ``.npz`` holds StableHLO, which torch cannot write)::

    manifest.json       format, batch, frame_hw, platforms, outputs, leaves
    program/<platform>  torch.export archive (torch.export.save) of that trace
    v<i>, w<i>          raw bytes of each leaf (dtype and shape in the manifest)
"""

from __future__ import annotations

import dataclasses
import io
import itertools
import json
import os
import zipfile
from typing import Any, BinaryIO, Callable

import torch

import tti_torch.kernels.conv_epilogue  # noqa: F401  (registers the kernels' operators)
import tti_torch.kernels.int8conv  # noqa: F401
import tti_torch.kernels.maskstats  # noqa: F401
import tti_torch.kernels.nms  # noqa: F401
import tti_torch.kernels.warp_p1  # noqa: F401

FORMAT = "tti_torch.export"
FORMAT_VERSION = 1
SUFFIX = ".ttitorch.zip"  # the artifact's file extension
CONSTANT_BYTES_LIMIT = 1 << 20  # tensors a trace may hold as constants (scalars made in the step)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# The pipeline's tensors and the step's outputs as named leaves
# ---------------------------------------------------------------------------


def _walk(obj: Any, path: str, fn: Callable[[str, Tensor], Any]) -> Any:
    """``obj`` with each tensor inside it replaced by ``fn(path, tensor)``:
    lists, tuples and dicts rebuilt, objects of this package shallow-copied;
    anything else kept as it is."""
    join = lambda key: f"{path}/{key}" if path else str(key)
    if isinstance(obj, Tensor):
        return fn(path, obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_walk(x, join(i), fn) for i, x in enumerate(obj))
    if isinstance(obj, dict):
        return {k: _walk(v, join(k), fn) for k, v in obj.items()}
    if type(obj).__module__.startswith("tti_torch.") and hasattr(obj, "__dict__") \
            and not isinstance(obj, torch.nn.Module):
        new = object.__new__(type(obj))
        new.__dict__.update({k: _walk(v, join(k), fn) for k, v in vars(obj).items()})
        return new
    return obj


def _pipeline_tensors(pipeline) -> dict[str, Tensor]:
    """Every tensor the step reads besides the model's: the warp's weights,
    the calibration, ... by attribute path."""
    found: dict[str, Tensor] = {}
    for key, value in vars(pipeline).items():
        if key not in ("model", "_uploader"):
            _walk(value, key, lambda path, t: found.setdefault(path, t))
    return found


def _model_tensors(model: torch.nn.Module) -> dict[str, Tensor]:
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def flatten_outputs(outs: Any, path: str = "") -> tuple[list[str], list[Tensor]]:
    """(names, leaves) of a step's outputs, in ``tti``'s order: dict keys
    sorted, dataclass fields in declaration order, names ``/``-joined."""
    join = lambda key: f"{path}/{key}" if path else str(key)
    if isinstance(outs, Tensor):
        return [path], [outs]
    if dataclasses.is_dataclass(outs):
        items = [(f.name, getattr(outs, f.name)) for f in dataclasses.fields(outs)]
    elif isinstance(outs, dict):
        items = sorted(outs.items())
    else:
        raise TypeError(f"cannot flatten a {type(outs).__name__} at {path!r}")
    names, leaves = [], []
    for key, value in items:
        n, l = flatten_outputs(value, join(key))
        names += n
        leaves += l
    return names, leaves


class _Bound:
    """The model called with other tensors in place of its own (its other
    attributes read through)."""

    def __init__(self, module: torch.nn.Module, state: dict[str, Tensor]) -> None:
        self._module, self._state = module, state

    def __call__(self, x: Tensor):
        return torch.func.functional_call(self._module, self._state, (x,))

    def __getattr__(self, name: str) -> Any:
        return getattr(self._module, name)


class _Step(torch.nn.Module):
    """(model leaves, pipeline leaves, frames) -> the step's output leaves.
    Holds no tensor of its own: the pipeline is kept out of the module tree,
    and every tensor it reads comes in as an argument."""

    def __init__(self, pipeline, v_names: list[str], w_names: list[str],
                 record: Callable[[list[str]], Any]) -> None:
        super().__init__()
        object.__setattr__(self, "_pipeline", pipeline)
        self.v_names, self.w_names = v_names, w_names
        self._record = record  # takes the output names (export restores the module's state)

    def forward(self, v_flat: list[Tensor], w_flat: list[Tensor], frames_u8: Tensor):
        pipe = self._pipeline
        w = dict(zip(self.w_names, w_flat))
        step = _walk(pipe, "", lambda path, t: w.get(path, t))
        step.model = _Bound(pipe.model, dict(zip(self.v_names, v_flat)))
        step._uploader = None
        names, leaves = flatten_outputs(step.postprocess_chain(step.preprocess(frames_u8)))
        self._record(names)
        return tuple(leaves)


def _device_of(platform: str, pipeline) -> torch.device:
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"platforms are 'cuda' and 'cpu', got {platform!r}")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("platform 'cuda' asked for, but no CUDA device is available")
    if pipeline.device.type == platform:
        return pipeline.device
    return torch.device(platform)


def _example(t: Tensor, device: torch.device) -> Tensor:
    """``t`` itself on its own device, else an uninitialised stand-in of its
    layout (the trace reads shapes, strides and dtypes only)."""
    if t.device == device:
        return t
    return torch.empty_strided(t.shape, _dense(t).stride(), dtype=t.dtype, device=device)


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------


def _dense(t: Tensor) -> Tensor:
    """``t``, or a contiguous copy where its elements do not fill one span
    of memory. A dense tensor keeps its strides (channels_last weights stay
    so: the traced convolutions saw them so)."""
    t = t.detach()
    dense = t.is_contiguous() or (t.dim() == 4 and t.is_contiguous(
        memory_format=torch.channels_last))
    return t if dense else t.contiguous()


def _bytes_of(t: Tensor) -> Tensor:
    """A dense tensor's memory as one uint8 vector (a view)."""
    return t.as_strided((t.numel(),), (1,)).view(torch.uint8)


def _leaf_record(name: str, entry: str, t: Tensor) -> dict:
    return {"name": name, "entry": entry, "dtype": str(t.dtype).removeprefix("torch."),
            "shape": list(t.shape), "stride": list(_dense(t).stride())}


def _write_tensor(zf: zipfile.ZipFile, entry: str, t: Tensor) -> None:
    host = _dense(t).cpu()
    with zf.open(entry, "w", force_zip64=True) as f:
        f.write(memoryview(_bytes_of(host).numpy()))


def export_pipeline(pipeline, batch: int, platforms=("cuda", "cpu"),
                    out: str | os.PathLike | BinaryIO | None = None) -> bytes | None:
    """Freeze a built InspectionPipeline's device step for uint8 frames
    ``(batch, H, W, 3)``, one program per platform in ``platforms``.

    Returns the artifact's bytes, or writes it to ``out`` (a path or a
    binary file) and returns None; the weights are copied to the host one
    tensor at a time, straight into the artifact. Asking for "cuda" without
    a CUDA device raises. The frozen signature is (model leaves, pipeline
    leaves, frames) -> output leaves; the manifest holds their names."""
    platforms = tuple(platforms)
    devices = {p: _device_of(p, pipeline) for p in platforms}
    model_t = _model_tensors(pipeline.model)
    other_t = _pipeline_tensors(pipeline)
    v_names, w_names = list(model_t), list(other_t)
    h, w = pipeline.frame_hw
    out_names: list[str] = []
    step = _Step(pipeline, v_names, w_names, out_names.extend)

    programs: dict[str, bytes] = {}
    for platform, device in devices.items():
        args = ([_example(t, device) for t in model_t.values()],
                [_example(t, device) for t in other_t.values()],
                torch.empty((batch, h, w, 3), dtype=torch.uint8, device=device))
        out_names.clear()
        ep = torch.export.export(step, args, strict=False)
        ep.example_inputs = None  # else saved with the program: the weights twice
        held = sum(t.numel() * t.element_size() for t in (*ep.state_dict.values(),
                   *(c for c in ep.constants.values() if isinstance(c, Tensor))))
        if held > CONSTANT_BYTES_LIMIT:
            raise RuntimeError(f"the {platform} trace holds {held} bytes of tensors as "
                               "constants: a tensor of the step is not among its arguments")
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        programs[platform] = buf.getvalue()

    manifest = {
        "format": FORMAT,
        "format_version": FORMAT_VERSION,
        "batch": batch,
        "frame_hw": [h, w],
        "platforms": list(platforms),
        "outputs": out_names,
        "n_variable_leaves": len(v_names),
        "n_warp_leaves": len(w_names),
        "variables": [_leaf_record(n, f"v{i}", t) for i, (n, t) in enumerate(model_t.items())],
        "warp": [_leaf_record(n, f"w{i}", t) for i, (n, t) in enumerate(other_t.items())],
    }
    target = io.BytesIO() if out is None else out
    with zipfile.ZipFile(target, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        zf.writestr("manifest.json", json.dumps(manifest, indent=1))
        for platform, blob in programs.items():
            zf.writestr(f"program/{platform}", blob)
        for group, tensors in (("variables", model_t), ("warp", other_t)):
            for rec, t in zip(manifest[group], tensors.values()):
                _write_tensor(zf, rec["entry"], t)
    return target.getvalue() if out is None else None


# ---------------------------------------------------------------------------
# Load and run
# ---------------------------------------------------------------------------


def _read_tensor(zf: zipfile.ZipFile, rec: dict, device: torch.device) -> Tensor:
    t = torch.empty_strided(rec["shape"], rec["stride"], dtype=getattr(torch, rec["dtype"]))
    with zf.open(rec["entry"]) as f:
        view, got = memoryview(_bytes_of(t).numpy()), 0
        while got < len(view):
            n = f.readinto(view[got:])
            if not n:
                raise ValueError(f"artifact entry {rec['entry']} is truncated")
            got += n
    return t.to(device)


class FrozenPipeline:
    """A loaded export artifact: uint8 frames on its device ->
    ``{name: tensor}``.

    ``data`` is the artifact's bytes or a path. ``device``: the program to
    run, "cuda" (the default) or "cpu"; the weights are loaded there. Needs
    torch and this module only (this module imports ``tti_torch.kernels``,
    which registers the operators the programs call)."""

    def __init__(self, data: bytes | str | os.PathLike, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        src = io.BytesIO(bytes(data)) if isinstance(data, (bytes, bytearray)) else data
        with zipfile.ZipFile(src) as zf:
            self.manifest = json.loads(zf.read("manifest.json"))
            if (self.manifest.get("format") != FORMAT
                    or self.manifest.get("format_version") != FORMAT_VERSION):
                raise ValueError(f"not a {FORMAT} artifact of version {FORMAT_VERSION}: "
                                 f"{self.manifest.get('format')} "
                                 f"{self.manifest.get('format_version')}")
            platform = self.device.type
            if platform not in self.manifest["platforms"]:
                raise ValueError(f"the artifact holds programs for {self.manifest['platforms']},"
                                 f" not {platform}")
            program = torch.export.load(io.BytesIO(zf.read(f"program/{platform}")))
            self._v = [_read_tensor(zf, r, self.device) for r in self.manifest["variables"]]
            self._w = [_read_tensor(zf, r, self.device) for r in self.manifest["warp"]]
        self._module = program.module()

    def swap_weights(self, pipeline) -> None:
        """Run with ``pipeline``'s model and pipeline tensors instead (a
        retrained checkpoint, a recalibrated warp): the same names, shapes
        and dtypes as the frozen ones, else ValueError (and nothing is
        swapped)."""
        groups = {"variables": _model_tensors(pipeline.model),
                  "warp": _pipeline_tensors(pipeline)}
        for group, tensors in groups.items():
            want = [(r["name"], r["dtype"], r["shape"]) for r in self.manifest[group]]
            got = [(n, str(t.dtype).removeprefix("torch."), list(t.shape))
                   for n, t in tensors.items()]
            for g, w in itertools.zip_longest(got, want):
                if g != w:
                    raise ValueError(f"{group} do not match the frozen program's: got {g}, "
                                     f"frozen {w}")
        self._v, self._w = ([t.detach().to(self.device) for t in groups[g].values()]
                            for g in ("variables", "warp"))

    def __call__(self, frames_u8: Tensor) -> dict[str, Tensor]:
        b, (h, w) = self.manifest["batch"], self.manifest["frame_hw"]
        if (tuple(frames_u8.shape) != (b, h, w, 3) or frames_u8.dtype != torch.uint8
                or frames_u8.device != self.device):
            raise ValueError(f"artifact frozen for uint8 {(b, h, w, 3)} on {self.device}, got "
                             f"{frames_u8.dtype} {tuple(frames_u8.shape)} on {frames_u8.device}")
        with torch.inference_mode():
            leaves = self._module(self._v, self._w, frames_u8)
        return dict(zip(self.manifest["outputs"], leaves))
