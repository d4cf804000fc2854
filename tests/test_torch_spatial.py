"""Spatial partitioning in one process (``tti_torch.parallel.spatial``):
the slab plan, the halo exchange and the row gather between threads that
stand for the ranks of a space group, every module of ``YOLOv8Seg`` on
slabs against the same module on the whole tensor, and the preprocess's
slabs against the rows of the whole model input.

The threads exchange through ``tests/torch_threads.py``'s
``ThreadTransport`` (a barrier and a mailbox), so that the modules run their own halo code with no process
group. Float32 modules are held within 1e-5 of the whole tensor's outputs:
on the CPU a convolution over a slab and its halo sums in another order
than over the whole tensor (about 1e-8 apart). Quantized (``int8``)
modules equal it bit for bit: their products are integer sums, and each
slab quantizes with the whole sample's scale (the MAX over the group).
"""

import copy

import pytest
import torch
import torch.nn.functional as F

import tti_torch.calib.io as tio
import tti_torch.core.config as tcfg
from tests.torch_dist import pipeline_settings
from tests.torch_synth import textile_frames
from tests.torch_threads import on_threads
from tti_torch.core.errors import ConfigError
from tti_torch.model.checkpoint import load_flax_msgpack
from tti_torch.model.yolo import RawPredictions
from tti_torch.parallel import runtime
from tti_torch.parallel.runtime import InspectionPipeline, inference_model
from tti_torch.parallel.spatial import (COUNTS, UNIT, SlabPlan, Space, reset_counts, set_space,
                                        slab_plan)

torch.set_num_threads(2)


# -- the slab plan ---------------------------------------------------------

@pytest.mark.parametrize("height,size,counts", [
    (736, 2, (12, 11)), (736, 4, (6, 6, 6, 5)),  # deploy: 23 P5 rows
    (384, 2, (6, 6)), (384, 4, (3, 3, 3, 3)),  # headline: 12
    (96, 2, (2, 1)), (736, 23, (1,) * 23)])
def test_slab_plan_rows(height, size, counts):
    plan = slab_plan(height, size)
    assert plan.counts == counts and plan.total * UNIT == height
    rows = [plan.input_rows(r) for r in range(size)]
    assert rows[0][0] == 0 and rows[-1][1] == height
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert all((r1 - r0) % UNIT == 0 for r0, r1 in rows)


def test_slab_plan_refusals():
    with pytest.raises(ConfigError, match="24 ranks over a model input of 23 P5 rows"):
        slab_plan(736, 24)
    with pytest.raises(ConfigError, match="740 rows are not a multiple of 32"):
        slab_plan(740, 2)


# -- ranks as threads ------------------------------------------------------

def slab(x, plan, rank, dim):
    """Rank's rows of ``x`` along ``dim`` (x covers the plan's P5 rows)."""
    f = x.shape[dim] // plan.total
    start, stop = plan.bounds(rank)
    return x.narrow(dim, f * start, f * (stop - start))


# -- the halo and the gather -----------------------------------------------

@pytest.mark.parametrize("counts", [(2, 1), (1, 1, 1), (1, 2, 1, 1)])
@pytest.mark.parametrize("above,below,fill,wpad", [
    (1, 1, 0.0, 1), (1, 0, 0.0, 0), (2, 2, float("-inf"), 0), (3, 2, 0.0, 2)])
def test_halo_takes_the_neighbours_rows(counts, above, below, fill, wpad):
    """Each rank's slab with its halo is the whole tensor's rows around it,
    padded with ``fill`` beyond the frame, however thin the slabs (a halo
    of 2-3 rows over slabs of one P5 row at 2 rows per P5 row reaches two
    ranks away)."""
    plan = SlabPlan(counts)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 2 * plan.total, 7, generator=g).contiguous(
        memory_format=torch.channels_last)
    whole = F.pad(x, (wpad, wpad, above, below), value=fill)
    reset_counts()
    got = on_threads(plan, lambda r, space: space.halo(slab(x, plan, r, 2), above, below, fill,
                                                       wpad))
    for r, h in enumerate(got):
        start, stop = plan.bounds(r)
        assert h.is_contiguous(memory_format=torch.channels_last)
        torch.testing.assert_close(h, whole[:, :, 2 * start:2 * stop + above + below],
                                   rtol=0, atol=0)
    assert COUNTS["halo"] == len(counts)


def test_gather_rows_restores_each_level():
    """NHWC leaves at three levels over uneven slabs: every rank gets the
    whole tensors, in row order, each dtype kept."""
    plan = SlabPlan((3, 1, 2))
    g = torch.Generator().manual_seed(2)
    whole = RawPredictions(
        box=tuple(torch.randn(2, f * plan.total, 5, 4, generator=g) for f in (4, 2, 1)),
        cls=tuple(torch.randn(2, f * plan.total, 5, 2, generator=g).to(torch.bfloat16)
                  for f in (4, 2, 1)),
        mcoef=tuple(torch.randn(2, f * plan.total, 5, 3, generator=g) for f in (4, 2, 1)),
        protos=torch.randn(2, 16 * plan.total, 20, 3, generator=g))
    local = lambda r: RawPredictions(*(
        tuple(slab(t, plan, r, 1) for t in v) if isinstance(v, tuple) else slab(v, plan, r, 1)
        for v in (whole.box, whole.cls, whole.mcoef, whole.protos)))
    for got in on_threads(plan, lambda r, space: space.gather_rows(local(r))):
        for a, b in zip([*got.box, *got.cls, *got.mcoef, got.protos],
                        [*whole.box, *whole.cls, *whole.mcoef, whole.protos]):
            assert a.dtype == b.dtype
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- the forward on slabs --------------------------------------------------

MODELS = {  # checkpoint, mask stride, proto head, fused head, quant
    "deploy": ("yolov8n_textile_cam", 2, "subpixel", False, ""),
    "headline_fused": ("yolov8n_textile", 4, "deconv", True, ""),
    "deploy_int8": ("yolov8n_textile_cam", 2, "subpixel", False, "int8"),
}
MODULES = ["m1", "m2", "m3", "m4", "m5", "m6", "m7", "m8", "m9", "m12", "m15", "m16", "m18",
           "m19", "m21", "m22", "model"]


@pytest.fixture(scope="module", params=sorted(MODELS))
def model_inputs(request):
    """(model, name, {module: (args, output)}) of one whole forward on a
    96 x 64 model input (3 P5 rows, s2d blocked)."""
    ckpt, stride, head, fused, quant = MODELS[request.param]
    cfg = tcfg.ModelConfig(variant="n", num_classes=2, image_size=96, dtype="float32",
                           mask_stride=stride, proto_head=head)
    model = inference_model(cfg, load_flax_msgpack(f"checkpoints/{ckpt}.msgpack"),
                            torch.device("cpu"), fused_head=fused, quant=quant)
    g = torch.Generator().manual_seed(3)
    x = torch.rand(2, 48, 32, 12, generator=g)
    seen = {}
    hooks = [getattr(model, n).register_forward_hook(
        lambda mod, args, out, n=n: seen.__setitem__(n, (args, out))) for n in MODULES[:-1]]
    with torch.no_grad():
        seen["model"] = ((x,), model(x))
    for h in hooks:
        h.remove()
    return model, request.param, seen


def _slab_args(args, plan, rank):
    """A module's inputs, sliced: NCHW tensors on dim 2; the model's NHWC
    input on dim 1."""
    def cut(t):
        return slab(t, plan, rank, 1 if t.shape[-1] == 12 else 2)
    return tuple(tuple(cut(t) for t in a) if isinstance(a, tuple) else cut(a) for a in args)


def _outputs(out):
    if isinstance(out, RawPredictions):
        return [*out.box, *out.cls, *out.mcoef, out.protos], 1  # NHWC
    return [out], 2


@pytest.mark.parametrize("counts", [(2, 1), (1, 1, 1)])
@pytest.mark.parametrize("name", MODULES)
def test_module_on_slabs_equals_the_whole(model_inputs, name, counts):
    """``name`` on each rank's slab (halos from the other threads) against
    the same module on the whole tensor: an uneven split, and one P5 row
    per rank (SPPF's 2-row pools reach two ranks away there, -inf past the
    frame's ends)."""
    model, label, seen = model_inputs
    module = model if name == "model" else getattr(model, name)
    args, want = seen[name]
    plan = SlabPlan(counts)

    def run(r, space):
        mod = copy.deepcopy(module)
        set_space(mod, space)
        with torch.no_grad():
            return mod(*_slab_args(args, plan, r))

    got = on_threads(plan, run)
    whole, dim = _outputs(want)
    parts = [_outputs(o)[0] for o in got]
    exact = label.endswith("int8")
    for i, ref in enumerate(whole):
        joined = torch.cat([p[i] for p in parts], dim=dim)
        torch.testing.assert_close(joined, ref, rtol=0, atol=0 if exact else 1e-5)


def test_a_module_without_a_space_runs_as_before(model_inputs):
    """``set_space(model, None)`` is the model as built: no exchange."""
    model, _, seen = model_inputs
    (x,), want = seen["model"]
    set_space(model, None)
    reset_counts()
    with torch.no_grad():
        got = model(x)
    assert COUNTS == dict.fromkeys(COUNTS, 0)
    for a, b in zip(_outputs(got)[0], _outputs(want)[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- the preprocess's slabs --------------------------------------------------

def _pipeline(ref_intrinsics, geometry="headline", calibrated=True, **kw):
    s = pipeline_settings(geometry, ref_intrinsics)
    return InspectionPipeline(
        tcfg.ModelConfig(**s["model"]), load_flax_msgpack(s["path"]), s["hw"],
        tio.CalibrationData(**s["calib"]) if calibrated else None,
        tcfg.MeasureConfig(min_stitches=1).with_subcell_from(s["meta"]),
        tcfg.RoiConfig(**s["roi"]), device="cpu", **kw)


@pytest.fixture
def slab_of(monkeypatch):
    """Pipelines built as rank ``rank`` of a space group of ``size`` (a
    Space without a transport: the preprocess exchanges nothing)."""
    def set_rank(rank, size):
        monkeypatch.setattr(runtime, "space_of",
                            lambda mesh, h: Space(slab_plan(h, size), rank, None))
    return set_rank


@pytest.mark.parametrize("geometry,kw", [
    ("headline", {}),  # the dense two-pass warp after the exact x3 decimation
    ("deploy", {}),  # after the 0.8 bilinear resize
    ("headline", {"warp_pass1": "kernel"}),  # kernel C's plain version on the band
    ("headline", {"remap": "packed"}),
    ("headline", {"warp_s2d": False}),
    ("deploy", {"warp_s2d": False}),
    ("headline", {"warp_col_expand": True}),
    ("headline", {"warp_block": 16}),  # the banded warp: bands that divide the slabs
    ("headline", {"warp_block": 24}),  # a band split at the slabs' edge
    ("headline", {"warp_block": 24, "warp_col_expand": True}),
    ("deploy", {"warp_block": 64}),
    ("deploy", {"warp_block": 24, "warp_s2d": False}),
    ("headline", {"undistort": False}),  # the letterbox alone
    ("deploy", {"undistort": False}),
])
@pytest.mark.parametrize("size", [2, 3])
def test_preprocess_slab_is_the_whole_inputs_rows(ref_intrinsics, slab_of, geometry, kw, size):
    """Each rank's preprocess emits its slab's rows of the model input: the
    warp's pass 1 on the source rows the slab reads, pass 2 on its rows."""
    whole_pipe = _pipeline(ref_intrinsics, geometry, **kw)
    frames = torch.from_numpy(textile_frames(2, *whole_pipe.frame_hw, seed=5))
    whole = whole_pipe.preprocess(frames)
    blocked = whole_pipe.model.s2d_input
    height = whole_pipe.spec.dst_h
    plan = slab_plan(height, size)
    for r in range(size):
        slab_of(r, size)
        pipe = _pipeline(ref_intrinsics, geometry, mesh=_FakeMesh(), **kw)
        r0, r1 = plan.input_rows(r)
        assert pipe.input_rows == (r0, r1)
        got = pipe.preprocess(frames)
        want = whole[:, r0 // 2:r1 // 2] if blocked else whole[:, r0:r1]
        # Pass 2 sums fewer zero terms over the slab's band: the same
        # products, added in another grouping.
        torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


class _FakeMesh:
    """A mesh for the ``slab_of`` pipelines (``space_of`` is replaced)."""

    mesh_dim_names = ("data", "space")
    device_type = "cpu"

    def size(self, dim):
        return 1

    def get_local_rank(self, axis):
        return 0
