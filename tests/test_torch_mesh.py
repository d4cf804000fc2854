"""The port's mesh and multi-host helpers (``tti_torch.parallel.mesh`` and
``dcn``) on the CPU: ``tti``'s ``TTI_*`` triple read as ``tti`` reads it,
the rank mapping (one process per card), ``create_mesh``'s shapes (a
``("data", "space")`` mesh included) and refusals on a one-rank gloo group
in this process, ``batch_slice`` and its refusal, what a pipeline on a
space mesh refuses, and ``gather_batch`` on a tree of every dtype the step
returns. Two and four ranks run in ``test_torch_runtime_mesh.py``,
``test_torch_runtime_space.py``, ``test_torch_train_sharded.py`` and
``test_torch_dcn.py``; the space axis's halos in ``test_torch_spatial.py``."""

from dataclasses import dataclass

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tti_torch.core.errors import ConfigError
from tti_torch.parallel import dcn
from tti_torch.parallel.mesh import (batch_slice, create_mesh, gather_batch, replicate,
                                     space_group)

TRIPLE = (dcn.ENV_COORD, dcn.ENV_NPROC, dcn.ENV_PID)


@pytest.fixture
def no_triple(monkeypatch):
    for name in TRIPLE:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.fixture
def one_rank(no_triple):
    """A one-rank gloo group in this process, destroyed after the test."""
    assert dcn.init_distributed(dcn.free_local_coordinator(), 1, 0, device="cpu")
    try:
        yield
    finally:
        dcn.shutdown()


def test_init_distributed_without_a_coordinator_starts_nothing(no_triple):
    assert dcn.init_distributed(device="cpu") is False
    assert not dist.is_initialized()
    # As in tti, the other two alone do not start a job.
    no_triple.setenv(dcn.ENV_NPROC, "2")
    no_triple.setenv(dcn.ENV_PID, "1")
    assert dcn.job_from_env() is None
    assert dcn.init_distributed(device="cpu") is False and not dist.is_initialized()


def test_the_triple_is_read_as_tti_reads_it(no_triple):
    no_triple.setenv(dcn.ENV_COORD, "10.0.0.1:1234")
    assert dcn.job_from_env() == dcn.Job("10.0.0.1:1234", 1, 0)  # tti's defaults
    no_triple.setenv(dcn.ENV_NPROC, "4")
    no_triple.setenv(dcn.ENV_PID, "3")
    assert dcn.job_from_env() == dcn.Job("10.0.0.1:1234", 4, 3)
    # Arguments win over the environment, as in tti's init_distributed.
    assert dcn.job_from_env("h:1", 2, 0) == dcn.Job("h:1", 2, 0)
    with pytest.raises(ConfigError, match="TTI_PROCESS_ID=4"):
        dcn.job_from_env("h:1", 4, 4)


@pytest.mark.parametrize("process_id,local_cards,local_rank,expect", [
    (0, 1, 0, 0), (1, 1, 0, 1), (0, 4, 3, 3), (1, 4, 0, 4), (2, 4, 1, 9), (3, 8, 7, 31)])
def test_rank_mapping(process_id, local_cards, local_rank, expect):
    """A process is a card: global rank = process_id * local_cards + local_rank."""
    assert dcn.global_rank(process_id, local_cards, local_rank) == expect


def test_backend_follows_the_device():
    assert dcn.backend_for("cuda") == "nccl" and dcn.backend_for("cuda:1") == "nccl"
    assert dcn.backend_for("cpu") == "gloo"


def test_one_rank_group_from_the_triple(no_triple):
    no_triple.setenv(dcn.ENV_COORD, dcn.free_local_coordinator())
    assert dcn.init_distributed(device="cpu")
    try:
        assert dist.get_world_size() == 1 and dcn.rank() == 0
        assert dist.get_backend() == "gloo"
    finally:
        dcn.shutdown()
    assert not dist.is_initialized() and dcn.rank() == 0


def test_create_mesh_shapes_and_refusals(one_rank):
    mesh = create_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data",) and mesh.size(0) == 1
    assert create_mesh((1, 1), ("data", "model"), device_type="cpu").mesh.shape == (1, 1)
    with pytest.raises(ValueError, match="needs 2 ranks, the world has 1"):
        create_mesh((2,), device_type="cpu")
    assert space_group(mesh) is None
    # The (data, space) mesh of spatial partitioning: this rank's space group.
    grid = create_mesh((1, 1), ("data", "space"), device_type="cpu")
    assert grid.mesh_dim_names == ("data", "space") and grid.mesh.shape == (1, 1)
    group, rank, size = space_group(grid)
    assert (rank, size) == (0, 1) and dist.get_world_size(group) == 1
    with pytest.raises(ValueError, match="does not match"):
        create_mesh((1,), ("data", "model"), device_type="cpu")


def test_create_mesh_needs_the_group(no_triple):
    with pytest.raises(ValueError, match="init_distributed"):
        create_mesh(device_type="cpu")


class _Mesh:
    """A mesh's coordinates without a group: ``batch_slice`` reads only these."""

    def __init__(self, names, sizes, coords):
        self.mesh_dim_names, self._sizes, self._coords = names, sizes, coords

    def size(self, dim):
        return self._sizes[dim]

    def get_local_rank(self, axis):
        return self._coords[self.mesh_dim_names.index(axis)]


@pytest.mark.parametrize("ranks,n", [(2, 4), (2, 8), (4, 128), (3, 6)])
def test_batch_slice_splits_in_rank_order(ranks, n):
    rows = [batch_slice(_Mesh(("data",), (ranks,), (r,)), n) for r in range(ranks)]
    assert [(s.start, s.stop) for s in rows] == [(r * n // ranks, (r + 1) * n // ranks)
                                                for r in range(ranks)]


def test_batch_slice_refusals():
    with pytest.raises(ValueError, match="a batch of 5 does not split .* give a multiple of 2"):
        batch_slice(_Mesh(("data",), (2,), (0,)), 5)
    # A mesh without a data axis serves every row on every rank (a P(None) sharding).
    assert batch_slice(_Mesh(("model",), (2,), (1,)), 5) == slice(0, 5)
    # A (data, space) mesh: the ranks of a space group serve the same rows.
    grid = [[batch_slice(_Mesh(("data", "space"), (2, 2), (d, s)), 4) for s in (0, 1)]
            for d in (0, 1)]
    assert grid == [[slice(0, 2)] * 2, [slice(2, 4)] * 2]
    with pytest.raises(ValueError, match="a batch of 3 does not split"):
        batch_slice(_Mesh(("data", "space"), (2, 2), (0, 1)), 3)


def test_pipeline_refuses_a_space_mesh(monkeypatch):
    """What a space mesh cannot serve is refused by name, before any weight
    is read: more ranks than the model input has P5 rows (a 64-row input
    has 2). The banded warp is served there (``tests/test_torch_warp_rows.py``,
    ``tests/test_torch_runtime_space_warp.py``)."""
    from tti_torch.core.config import ModelConfig
    from tti_torch.parallel import runtime
    from tti_torch.parallel.spatial import Space, slab_plan

    mesh = _Mesh(("data", "space"), (1, 2), (0, 0))
    mesh.device_type = "cpu"
    for size, kw, match in ((4, {}, "4 ranks over a model input of 2 P5 rows"),
                            (4, {"warp_block": 16}, "4 ranks over a model input of 2 P5 rows")):
        monkeypatch.setattr(runtime, "space_of",
                            lambda m, h, size=size: Space(slab_plan(h, size), 0, None))
        with pytest.raises(ConfigError, match=match):
            runtime.InspectionPipeline(ModelConfig(image_size=64), {}, (48, 64), device="cpu",
                                       mesh=mesh, **kw)


def test_one_rank_space_mesh_serves_the_plain_step(one_rank, ref_intrinsics):
    """A space axis of one rank is no partitioning (as XLA inserts nothing on
    it): the step on a (1, 1) mesh equals the step without a mesh, bit for
    bit, and exchanges nothing."""
    from tests.torch_dist import _port_pipeline
    from tests.torch_synth import textile_frames
    from tti_torch.parallel.spatial import COUNTS, reset_counts

    mesh = create_mesh((1, 1), ("data", "space"), device_type="cpu")
    pipe = _port_pipeline("headline", ref_intrinsics, mesh)
    assert pipe.space is None and pipe.input_rows is None
    frames = textile_frames(2, *pipe.frame_hw, seed=5)
    reset_counts()
    got = pipe.process_batch(frames)
    assert COUNTS == dict.fromkeys(COUNTS, 0)
    want = _port_pipeline("headline", ref_intrinsics).process_batch(frames)
    for key in ("boxes_frame", "scores", "classes", "valid", "envelope"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    for key in ("raw_edge_mm", "raw_width_mm", "n_stitches"):
        np.testing.assert_array_equal(getattr(got.measurements, key),
                                      getattr(want.measurements, key), err_msg=key)


@dataclass
class _Leaves:
    flags: torch.Tensor
    ints: torch.Tensor
    absent: torch.Tensor | None = None


def test_gather_batch_on_one_rank_returns_every_dtype(one_rank):
    """Every leaf travels in one byte buffer: each comes back with its dtype,
    shape and values (NaN included)."""
    mesh = create_mesh(device_type="cpu")
    g = torch.Generator().manual_seed(0)
    tree = {"f32": torch.randn(3, 5, 7, generator=g),
            "f64": torch.randn(3, 1, dtype=torch.float64, generator=g),
            "nan": torch.tensor([[float("nan"), 1.0]] * 3),
            "bf16": torch.randn(3, 3, generator=g).to(torch.bfloat16),
            "leaves": _Leaves(torch.rand(3, 9, generator=g) > 0.5,
                              torch.arange(3 * 2, dtype=torch.int32).reshape(3, 2)),
            "pair": (torch.arange(3, dtype=torch.uint8), torch.arange(3, dtype=torch.int64))}
    out = gather_batch(mesh, tree)
    assert isinstance(out["leaves"], _Leaves) and out["leaves"].absent is None
    flat = lambda t: [t["f32"], t["f64"], t["nan"], t["bf16"], t["leaves"].flags,
                      t["leaves"].ints, *t["pair"]]
    for a, b in zip(flat(out), flat(tree)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    # replicate: rank 0's values, in place.
    x = torch.arange(4.0)
    assert replicate(mesh, {"x": x})["x"] is x and torch.equal(x, torch.arange(4.0))
    np.testing.assert_array_equal(dcn.process_local_slice(out, mesh)["f32"], tree["f32"])
