"""The port's spatially partitioned inspection step on two gloo ranks
against ``tti``'s own ``(data, space)`` mesh step, on the CPU, float32
(``jax_default_matmul_precision "highest"``).

``tti`` runs ``InspectionPipeline(mesh=create_mesh((1, 2), ("data",
"space")))`` on two of the conftest's virtual CPU devices: XLA shards the
frame height and inserts the halo exchanges. The port runs the same
pipeline arguments (``tests/torch_dist.py``) in two processes, the two
ranks of one space group: each computes a slab of the model input's rows,
exchanges each convolution's and pool's halo rows with the other, and
gathers the head outputs before detect and measure. The headline geometry's
model input has 3 P5 rows (96 x 128), so the slabs are uneven (2 and 1 P5
rows); the deploy geometry's has 6 (3 and 3) and a bilinear resize before
its warp.

Each rank's outputs are held to ``tti``'s within ``__graft_entry__.py``'s
bar for the sharded step (valid and classes equal, scores 1e-5, frame boxes
1e-3 px, measurements 1e-4 mm, NaN where ``tti`` has NaN), and to the
port's own step without a mesh at the same bar: the slabs' convolutions sum
in another order than the whole frame's on the CPU. Under ``int8`` the
convolutions are integer sums and every slab quantizes with the whole
sample's scale (the MAX all-reduce), so that step equals the step without a
mesh bit for bit; it is held to ``tti``'s jitted int8 step with
``tests/test_torch_quantize_step.py``'s int8 tolerances. The mesh step's
three entries (``process_batch``, ``process_batch_async``, ``step``) give
the same outputs, and so do the ranks. Cases: the step and the dual step
on ``(1, 2)``, and the step on four ranks of a ``(2, 2)`` mesh against
``tti``'s ``(2, 2)`` mesh; ``int8s`` and ``int8`` are in
``test_torch_runtime_space_quant.py``. Each rank counts the halo exchanges
of one step: 44 per model for both checkpoints (the backbone and neck 30,
the head 12, the proto head 2).
"""

import numpy as np
import pytest

from tests.torch_dist import GEOMETRIES, arrays_to_outputs, run_ranks
from tests.torch_pair import SWITCHES, pipelines
from tests.torch_synth import textile_frames
from tti.parallel.mesh import create_mesh as jax_create_mesh
from tti.parallel.runtime import DualPipeline as JaxDual

FRAMES = 2


@pytest.fixture
def clean_env(monkeypatch):
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def graft_bar(got, ref, box=1e-3, score=1e-5, mm=1e-4):
    """``__graft_entry__.py``'s sharded-against-unsharded comparison."""
    np.testing.assert_array_equal(got.valid, ref.valid)
    np.testing.assert_array_equal(got.classes, ref.classes)
    np.testing.assert_allclose(got.scores, ref.scores, atol=score)
    np.testing.assert_allclose(got.boxes_frame, ref.boxes_frame, atol=box)
    for field in ("edge_distance_mm", "stitch_width_mm", "raw_edge_mm", "raw_width_mm",
                  "n_dist", "n_width", "n_stitches", "fabric_detected"):
        np.testing.assert_allclose(getattr(got.measurements, field),
                                   np.asarray(getattr(ref.measurements, field)), atol=mm,
                                   equal_nan=True, err_msg=field)


def entries_and_ranks_agree(ranks, tags):
    """The mesh step's three entries give the same outputs on each rank,
    and every rank the same (the bytes each sends differ)."""
    for arrays in ranks:
        for tag in tags:
            suffix = tag[len("mesh"):]
            keys = [k.split("/", 1)[1] for k in arrays if k.startswith(f"{tag}/")]
            assert keys
            for entry in ("async", "step"):
                for k in keys:
                    np.testing.assert_array_equal(arrays[f"{tag}/{k}"],
                                                  arrays[f"{entry}{suffix}/{k}"], err_msg=k)
    for k, v in ranks[0].items():
        for other in ranks[1:] if k != "counts/halo_bytes" else ():
            np.testing.assert_array_equal(v, other[k], err_msg=k)


def run_space(case, ref_intrinsics, tmp_path, geometry="headline", frames=FRAMES, scales="",
              world=2):
    frames = textile_frames(frames, *GEOMETRIES[geometry][1], seed=5)  # as pipelines() makes
    np.savez(tmp_path / "inputs.npz", frames=frames, K=ref_intrinsics[0], dist=ref_intrinsics[1],
             scales=np.array(scales), geometry=np.array(geometry))
    return frames, run_ranks(case, tmp_path, world)


def test_space_step_matches_tti_space_step(ref_intrinsics, clean_env, tmp_path):
    frames, ranks = run_space("space_step", ref_intrinsics, tmp_path)
    mesh = jax_create_mesh(shape=(1, 2), axis_names=("data", "space"))
    ref = pipelines("headline", ref_intrinsics, ref_kw=dict(mesh=mesh), n_frames=FRAMES)[1]
    want = ref.process_batch(frames)
    entries_and_ranks_agree(ranks, ["mesh"])
    got = arrays_to_outputs(ranks[0], "mesh")
    graft_bar(got, want)
    graft_bar(got, arrays_to_outputs(ranks[0], "single"))
    assert got.valid.any(axis=1).all() and np.isfinite(got.measurements.raw_width_mm).any()
    assert int(ranks[0]["counts/halo"]) == 44 and int(ranks[0]["counts/gather"]) == 1
    assert int(ranks[0]["counts/max"]) == 0


def test_space_dual_step_matches_tti(ref_intrinsics, clean_env, tmp_path):
    frames, ranks = run_space("space_dual", ref_intrinsics, tmp_path)
    mesh = jax_create_mesh(shape=(1, 2), axis_names=("data", "space"))
    ref_a = pipelines("headline", ref_intrinsics, ref_kw=dict(mesh=mesh))[1]
    ref_b = pipelines("headline_b", ref_intrinsics, ref_kw=dict(mesh=mesh))[1]
    want_a, want_b = JaxDual(ref_a, ref_b).process_batch(frames)
    entries_and_ranks_agree(ranks, ["mesh_a", "mesh_b"])
    got_a, got_b = arrays_to_outputs(ranks[0], "mesh_a"), arrays_to_outputs(ranks[0], "mesh_b")
    graft_bar(got_a, want_a)
    graft_bar(got_b, want_b)
    assert not np.allclose(got_a.scores, got_b.scores, atol=1e-3)  # two models
    assert int(ranks[0]["counts/halo"]) == 88 and int(ranks[0]["counts/gather"]) == 2


def test_grid_step_matches_tti_grid_step(ref_intrinsics, clean_env, tmp_path):
    """Four gloo ranks on a ``(2, 2)`` mesh: two data groups of two frames
    each, each split over a space group of two; every rank ends with the
    global batch's outputs."""
    frames, ranks = run_space("grid_step", ref_intrinsics, tmp_path, frames=4, world=4)
    mesh = jax_create_mesh(shape=(2, 2), axis_names=("data", "space"))
    ref = pipelines("headline", ref_intrinsics, ref_kw=dict(mesh=mesh), n_frames=4)[1]
    entries_and_ranks_agree(ranks, ["mesh"])
    got = arrays_to_outputs(ranks[0], "mesh")
    assert got.valid.shape[0] == 4 and got.valid[:2].any() and got.valid[2:].any()
    graft_bar(got, ref.process_batch(frames))
    graft_bar(got, arrays_to_outputs(ranks[0], "single"))
    assert int(ranks[0]["counts/halo"]) == 44 and int(ranks[0]["counts/gather"]) == 1
