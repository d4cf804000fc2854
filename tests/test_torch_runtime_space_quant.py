"""The port's spatially partitioned int8 steps on two gloo ranks of a
``(1, 2)`` ``("data", "space")`` mesh against ``tti``'s, on the CPU
(``tests/test_torch_runtime_space.py`` has the float32 steps and the
bar).

``int8s`` (static scales) is held to ``tti``'s space-mesh step and to the
port's step without a mesh at ``__graft_entry__.py``'s bar. Under dynamic
``int8`` each of the 66 blocks' per-sample scales is the maximum over the
slabs (one MAX all-reduce per block), so every code, every integer sum and
every output equals the step without a mesh bit for bit; the step is held
to ``tti``'s jitted int8 step on its own space mesh with
``tests/test_torch_quantize_step.py``'s int8 tolerances (boxes 2 px, scores
2e-2, mm 0.5: the two packages' SiLU can differ by an ulp, their exp's
last bit, which moves codes).
"""

import json

import numpy as np
import torch

from tests.test_torch_runtime_space import (FRAMES, clean_env, entries_and_ranks_agree,  # noqa: F401
                                            graft_bar, run_space)
from tests.torch_dist import GEOMETRIES, arrays_to_outputs
from tests.torch_pair import pipelines
from tti.parallel.mesh import create_mesh as jax_create_mesh
from tti_torch.model.checkpoint import load_flax_msgpack
from tti_torch.model.quantize import calibrate_act_scales
from tti_torch.model.yolo import depth_to_space2
from tti_torch.parallel.runtime import inference_model

INT8_MATCH = dict(box=2.0, score=2e-2, mm=0.5)  # tests/test_torch_quantize_step.py's


def test_space_int8s_step_matches_tti(ref_intrinsics, clean_env, tmp_path):
    """One scales file, calibrated by the port on the step's own model input
    (as ``tests/test_torch_runtime_mesh.py`` does), read by both sides."""
    pipe, _, frames = pipelines("headline", ref_intrinsics, n_frames=FRAMES)
    model = inference_model(pipe.model_cfg,
                            load_flax_msgpack(f"checkpoints/{GEOMETRIES['headline'][0]}.msgpack"),
                            torch.device("cpu"), s2d_input=False, s2d_stem=False)
    x = depth_to_space2(pipe.preprocess(torch.from_numpy(frames)))
    scales = tmp_path / "scales.json"
    scales.write_text(json.dumps({"scales": calibrate_act_scales(model, [x])}))
    frames, ranks = run_space("space_int8s", ref_intrinsics, tmp_path, scales=str(scales))
    clean_env.setenv("TTI_QUANT", "int8s")
    clean_env.setenv("TTI_QUANT_SCALES", str(scales))
    mesh = jax_create_mesh(shape=(1, 2), axis_names=("data", "space"))
    ref = pipelines("headline", ref_intrinsics, ref_kw=dict(mesh=mesh), n_frames=FRAMES)[1]
    entries_and_ranks_agree(ranks, ["mesh"])
    got = arrays_to_outputs(ranks[0], "mesh")
    graft_bar(got, ref.process_batch(frames))
    graft_bar(got, arrays_to_outputs(ranks[0], "single"))
    assert int(ranks[0]["counts/max"]) == 0  # static scales: no all-reduce


def test_space_int8_step_equals_the_step_without_a_mesh(ref_intrinsics, clean_env, tmp_path):
    """Dynamic int8 at the deploy geometry: each of the 66 blocks' per-sample
    scales is the maximum over the two slabs, so every code, every integer
    sum and every output equals the step without a mesh, bit for bit; and
    the step is held to ``tti``'s jitted int8 step on its own space mesh."""
    frames, ranks = run_space("space_int8", ref_intrinsics, tmp_path, geometry="deploy")
    entries_and_ranks_agree(ranks, ["mesh"])
    arrays = ranks[0]
    keys = [k.split("/", 1)[1] for k in arrays if k.startswith("mesh/")]
    for k in keys:
        np.testing.assert_array_equal(arrays[f"mesh/{k}"], arrays[f"single/{k}"], err_msg=k)
    assert int(arrays["counts/max"]) == 66 and int(arrays["counts/halo"]) == 44
    clean_env.setenv("TTI_QUANT", "int8")
    mesh = jax_create_mesh(shape=(1, 2), axis_names=("data", "space"))
    ref = pipelines("deploy", ref_intrinsics, ref_kw=dict(mesh=mesh), n_frames=FRAMES)[1]
    graft_bar(arrays_to_outputs(arrays, "mesh"), ref.process_batch(frames), **INT8_MATCH)
