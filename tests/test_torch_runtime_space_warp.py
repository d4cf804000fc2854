"""The banded two-pass warp (``warp_block``, ``tti``'s ``TTI_WARP_BLOCKED``)
on the port's spatially partitioned step: two gloo ranks of a ``(1, 2)``
``("data", "space")`` mesh against ``tti``'s ``(1, 2)`` mesh step under
``TTI_WARP_BLOCKED``, on the CPU, float32.

``tti`` builds the banded warp whatever the mesh and lets XLA partition its
bands along the sharded frame height; each rank of the port cuts the bands
at its slab's rows (``TwoPassWarp.rows``). The headline geometry's model
input has 3 P5 rows (96 rows; slabs of 64 and 32): block 16 divides both
slabs, block 24 splits the band [48, 72) at row 64. Each rank's outputs are
held to ``tti``'s at ``__graft_entry__.py``'s bar (valid and classes equal,
scores 1e-5, frame boxes 1e-3 px, measurements 1e-4 mm, NaN where ``tti``
has NaN) and to the port's banded step without a mesh at the same bar; the
three entries and both ranks agree; each step counts 44 halo exchanges per
model and one gather. Cases: the step with blocks 16 and 24 (one launch),
and the dual step with block 24.
"""

import numpy as np

from tests.test_torch_runtime_space import clean_env, graft_bar  # noqa: F401 (fixture)
from tests.torch_dist import arrays_to_outputs
from tests.torch_pair import pipelines
from tti.parallel.mesh import create_mesh as jax_create_mesh
from tti.parallel.runtime import DualPipeline as JaxDual

FRAMES = 2


def _ranks(case, ref_intrinsics, tmp_path, blocks):
    from tests.torch_dist import GEOMETRIES, run_ranks
    from tests.torch_synth import textile_frames

    frames = textile_frames(FRAMES, *GEOMETRIES["headline"][1], seed=5)  # as pipelines() makes
    np.savez(tmp_path / "inputs.npz", frames=frames, K=ref_intrinsics[0],
             dist=ref_intrinsics[1], geometry=np.array("headline"),
             warp_blocks=np.array(blocks))
    return frames, run_ranks(case, tmp_path)


def _agree(ranks, tags):
    """The mesh step's three entries give the same outputs on each rank,
    and every rank the same (the halo bytes each sends differ)."""
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
        if not k.endswith("/halo_bytes"):
            np.testing.assert_array_equal(v, ranks[1][k], err_msg=k)


def test_banded_space_step_matches_tti(ref_intrinsics, clean_env, tmp_path):  # noqa: F811
    frames, ranks = _ranks("space_step", ref_intrinsics, tmp_path, [16, 24])
    mesh = jax_create_mesh(shape=(1, 2), axis_names=("data", "space"))
    _agree(ranks, ["mesh_16", "mesh_24"])
    for block in (16, 24):
        clean_env.setenv("TTI_WARP_BLOCKED", str(block))  # tti reads it at construction
        ref = pipelines("headline", ref_intrinsics, ref_kw=dict(mesh=mesh), n_frames=FRAMES)[1]
        assert ref.remap_xy.block == block
        got = arrays_to_outputs(ranks[0], f"mesh_{block}")
        graft_bar(got, ref.process_batch(frames))
        graft_bar(got, arrays_to_outputs(ranks[0], f"single_{block}"))
        assert got.valid.any(axis=1).all() and np.isfinite(got.measurements.raw_width_mm).any()
        assert int(ranks[0][f"counts_{block}/halo"]) == 44
        assert int(ranks[0][f"counts_{block}/gather"]) == 1


def test_banded_space_dual_step_matches_tti(ref_intrinsics, clean_env, tmp_path):  # noqa: F811
    frames, ranks = _ranks("space_dual", ref_intrinsics, tmp_path, [24])
    clean_env.setenv("TTI_WARP_BLOCKED", "24")
    mesh = jax_create_mesh(shape=(1, 2), axis_names=("data", "space"))
    ref_a = pipelines("headline", ref_intrinsics, ref_kw=dict(mesh=mesh))[1]
    ref_b = pipelines("headline_b", ref_intrinsics, ref_kw=dict(mesh=mesh))[1]
    want_a, want_b = JaxDual(ref_a, ref_b).process_batch(frames)
    _agree(ranks, ["mesh_24_a", "mesh_24_b"])
    got_a, got_b = (arrays_to_outputs(ranks[0], f"mesh_24_{x}") for x in "ab")
    graft_bar(got_a, want_a)
    graft_bar(got_b, want_b)
    graft_bar(got_a, arrays_to_outputs(ranks[0], "single_24_a"))
    assert not np.allclose(got_a.scores, got_b.scores, atol=1e-3)  # two models
    assert int(ranks[0]["counts_24/halo"]) == 88 and int(ranks[0]["counts_24/gather"]) == 2
