"""The port's data-parallel inspection step on two gloo ranks against
``tti``'s own mesh step, on the CPU, float32 (``jax_default_matmul_precision
"highest"``).

``tti`` runs ``InspectionPipeline(mesh=create_mesh(shape=(2,)))`` on two of
the conftest's virtual CPU devices; the port runs the same pipeline
arguments (``tests/torch_dist.py``, the paired headline geometry: 216x384
frames, imgsz 128, the stride-4 checkpoint) in two processes, each a rank of
a ``"data"`` mesh that serves two of the four frames. Each rank's global
outputs are held to ``tti``'s within ``__graft_entry__.py``'s bar for the
sharded step (valid equal, scores 1e-5, frame boxes 1e-3 px, measurements
1e-4 mm, NaN where ``tti`` has NaN), and to the port's own step without a
mesh on the whole batch bit for bit, scores within one float32 ulp: each
rank runs the unchanged step on its rows. The workers run one intra-op
thread (``tests/torch_dist.py``): with more, MKL and oneDNN split a product
or a convolution over the threads by its shape, so a batch of two and a
batch of four sum in other orders (boxes 6.1e-05 apart on an 8-core
AVX-512 host at two threads). The scores' ulp is PyTorch's CPU loop: a
contiguous tensor's last ``n mod 2 * lanes`` elements take the scalar
``exp`` of the C library, the others the vector one, so which of a frame's
class logits take which depends on the batch (one score of 800, 1.5e-08,
in the dual case on that host). The mesh step's three entries
(``process_batch``, ``process_batch_async``, ``step``) give the same
outputs bit for bit, and so do the two ranks. Cases: the step, the dual step (a second checkpoint on the same
slab) and the ``int8s`` step, whose scales file (the port's
``calibrate_act_scales``) both packages read.
"""

import json

import numpy as np
import pytest
import torch

from tests.torch_dist import GEOMETRIES, arrays_to_outputs, run_ranks
from tests.torch_pair import SWITCHES, pipelines
from tests.torch_synth import textile_frames
from tti.parallel.mesh import create_mesh as jax_create_mesh
from tti.parallel.runtime import DualPipeline as JaxDual
from tti_torch.model.checkpoint import load_flax_msgpack
from tti_torch.model.quantize import calibrate_act_scales
from tti_torch.model.yolo import depth_to_space2
from tti_torch.parallel.runtime import inference_model

FRAMES = 4


@pytest.fixture
def clean_env(monkeypatch):
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _graft_bar(got, ref):
    """``__graft_entry__.py``'s sharded-against-unsharded comparison."""
    np.testing.assert_array_equal(got.valid, ref.valid)
    np.testing.assert_allclose(got.scores, ref.scores, atol=1e-5)
    np.testing.assert_allclose(got.boxes_frame, ref.boxes_frame, atol=1e-3)
    for field in ("edge_distance_mm", "stitch_width_mm", "raw_edge_mm", "raw_width_mm",
                  "n_dist", "n_width", "n_stitches", "fabric_detected"):
        np.testing.assert_allclose(getattr(got.measurements, field),
                                   np.asarray(getattr(ref.measurements, field)), atol=1e-4,
                                   equal_nan=True, err_msg=field)


def _bit_equal(arrays, a: str, b: str, scores_ulp: int = 0):
    """Every output of tag ``a`` equals tag ``b``'s bit for bit; the
    scores within ``scores_ulp`` float32 ulps where that is not 0."""
    keys = [k.split("/", 1)[1] for k in arrays if k.startswith(f"{a}/")]
    assert keys
    for k in keys:
        got, want = arrays[f"{a}/{k}"], arrays[f"{b}/{k}"]
        if k == "scores" and scores_ulp:
            np.testing.assert_array_max_ulp(got, want, maxulp=scores_ulp)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def _run(case, ref_intrinsics, tmp_path, scales=""):
    frames = textile_frames(FRAMES, *GEOMETRIES["headline"][1], seed=5)  # as pipelines() makes
    np.savez(tmp_path / "inputs.npz", frames=frames, K=ref_intrinsics[0], dist=ref_intrinsics[1],
             scales=np.array(scales))
    ranks = run_ranks(case, tmp_path)
    return frames, ranks


def _check_ranks(ranks, tags):
    for arrays in ranks:
        for tag in tags:
            suffix = tag[len("mesh"):]
            _bit_equal(arrays, tag, "single" + suffix, scores_ulp=1)  # the whole batch
            for entry in ("async", "step"):
                _bit_equal(arrays, tag, entry + suffix)
    for k, v in ranks[0].items():
        np.testing.assert_array_equal(v, ranks[1][k], err_msg=k)


def test_mesh_step_matches_tti_mesh_step(ref_intrinsics, clean_env, tmp_path):
    mesh = jax_create_mesh(shape=(2,))
    frames, ranks = _run("step", ref_intrinsics, tmp_path)
    ref = pipelines("headline", ref_intrinsics, ref_kw=dict(mesh=mesh), n_frames=FRAMES)[1]
    want = ref.process_batch(frames)
    _check_ranks(ranks, ["mesh"])
    got = arrays_to_outputs(ranks[0], "mesh")
    _graft_bar(got, want)
    assert got.valid.shape[0] == FRAMES and got.valid[:2].any() and got.valid[2:].any()


def test_mesh_dual_step_matches_tti(ref_intrinsics, clean_env, tmp_path):
    mesh = jax_create_mesh(shape=(2,))
    frames, ranks = _run("dual", ref_intrinsics, tmp_path)
    ref_a = pipelines("headline", ref_intrinsics, ref_kw=dict(mesh=mesh))[1]
    ref_b = pipelines("headline_b", ref_intrinsics, ref_kw=dict(mesh=mesh))[1]
    want_a, want_b = JaxDual(ref_a, ref_b).process_batch(frames)
    _check_ranks(ranks, ["mesh_a", "mesh_b"])
    got_a, got_b = arrays_to_outputs(ranks[0], "mesh_a"), arrays_to_outputs(ranks[0], "mesh_b")
    _graft_bar(got_a, want_a)
    _graft_bar(got_b, want_b)
    assert not np.allclose(got_a.scores, got_b.scores, atol=1e-3)  # two models


def test_mesh_int8s_step_matches_tti(ref_intrinsics, clean_env, tmp_path):
    """One scales file, calibrated by the port on the step's own model input
    (as ``tests/test_torch_quantize_step.py`` does), read by both sides."""
    pipe, _, frames = pipelines("headline", ref_intrinsics, n_frames=FRAMES)
    model = inference_model(pipe.model_cfg,
                            load_flax_msgpack(f"checkpoints/{GEOMETRIES['headline'][0]}.msgpack"),
                            torch.device("cpu"), s2d_input=False, s2d_stem=False)
    x = depth_to_space2(pipe.preprocess(torch.from_numpy(frames)))
    scales = tmp_path / "scales.json"
    scales.write_text(json.dumps({"scales": calibrate_act_scales(model, [x])}))
    frames, ranks = _run("int8s", ref_intrinsics, tmp_path, str(scales))
    clean_env.setenv("TTI_QUANT", "int8s")
    clean_env.setenv("TTI_QUANT_SCALES", str(scales))
    ref = pipelines("headline", ref_intrinsics, ref_kw=dict(mesh=jax_create_mesh(shape=(2,))),
                    n_frames=FRAMES)[1]
    want = ref.process_batch(frames)
    _check_ranks(ranks, ["mesh"])
    _graft_bar(arrays_to_outputs(ranks[0], "mesh"), want)
