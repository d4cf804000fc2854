"""The port's data-parallel training step on two gloo ranks against the
port's single-process step on the whole batch, on the CPU, float32.

The batch: global batch 4 (two rows per rank) of the device augment over six
64 px synthetic textile scenes, the deploy checkpoint's weights (stride-2
sub-pixel protos), seg gains (2.0, 1.0), AdamW at lr 1e-3
(``tests/torch_dist.py``, case ``train``). The port's single step is held
to ``tti``'s in ``tests/test_torch_train_step.py``, so this closes the
chain to ``tti``'s sharded step, whose bar this is
(``__graft_entry__.py``'s dry run): the loss within 1e-3 relative, every
parameter's update within 2.2 learning rates (Adam's first update is a
sign for any gradient above eps: a near-zero gradient summed in another
order may flip it), under 0.5% of the parameters apart by more than 1e-4.
The BatchNorm running statistics within 1e-5 (relative to values above
1), each rank's augmented rows bit-equal to rows of the unsharded batch,
the two ranks' parameters bit-equal after three steps, and a save on rank 0
at step 2, a resume on both ranks and one more step bit-equal to three
uninterrupted steps. In this process, on a one-rank group: the step with
the group is the step without it bit for bit (BatchNorm stays
``F.batch_norm``), and the global-batch BatchNorm's formula (flax's, forced
on one rank) against ``F.batch_norm``'s.
"""

import numpy as np
import pytest
import torch

from tests.torch_dist import TRAIN, run_ranks
from tti_torch.model.layers import BatchNorm
from tti_torch.parallel import dcn
from tti_torch.train.step import TrainStep


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("train", tmp_path_factory.mktemp("train_ranks"))


def test_rows_split_in_rank_order(ranks):
    assert [tuple(r["rows"]) for r in ranks] == [(0, 2), (2, 4)]


def test_augmented_rows_are_rows_of_the_unsharded_batch(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["aug_sharded"], r["aug_single_rows"])
        for name in ("boxes", "classes", "masks", "valid"):
            np.testing.assert_array_equal(r[f"tgt_sharded.{name}"], r[f"tgt_single_rows.{name}"])


def test_sharded_step_matches_the_single_step(ranks):
    lr = TRAIN["lr"]
    for r in ranks:
        np.testing.assert_allclose(r["loss_sharded"], r["loss_single"], rtol=1e-3)
        diffs = np.abs(r["params1_sharded"] - r["params1_single"])
        assert diffs.max() <= 2.2 * lr, diffs.max()
        assert (diffs > 1e-4).mean() < 5e-3
        # The step moved the parameters: the comparison is not of two copies.
        assert np.abs(r["params1_single"] - r["params_before"]).max() > 0.5 * lr


def test_batchnorm_running_statistics_are_the_global_batch(ranks):
    for r in ranks:
        np.testing.assert_allclose(r["bn_sharded"], r["bn_single"], rtol=1e-5, atol=1e-5)


def test_ranks_stay_bit_equal(ranks):
    for key in ("loss_sharded", "params1_sharded", "state3"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)


def test_resume_replays_the_uninterrupted_run(ranks):
    for r in ranks:
        assert int(r["resumed_step"]) == 3
        np.testing.assert_array_equal(r["state3_resumed"], r["state3"])


@pytest.fixture
def one_rank(monkeypatch):
    for name in (dcn.ENV_COORD, dcn.ENV_NPROC, dcn.ENV_PID):
        monkeypatch.delenv(name, raising=False)
    assert dcn.init_distributed(dcn.free_local_coordinator(), 1, 0, device="cpu")
    try:
        yield torch.distributed.group.WORLD
    finally:
        dcn.shutdown()


def _trainer(mesh=None):
    from tests.torch_scenes import textile_samples
    from tti_torch.train.augment import build_device_dataset
    from tti_torch.train.loop import build_model, build_trainer

    t = TRAIN
    data = build_device_dataset(textile_samples(4, t["imgsz"], seed=5), t["imgsz"], t["max_gt"],
                                mask_stride=2, soft_masks="stitch", device="cpu")
    model = build_model("n", 2, 2, "subpixel", torch.float32, "cpu", init=t["ckpt"])
    return build_trainer(data, model, 2, t["max_gt"], t["total"], t["lr"], torch.float32,
                         t["gains"], mesh=mesh)


def test_one_rank_group_steps_as_no_group(one_rank):
    from tti_torch.parallel.mesh import create_mesh

    torch.set_num_threads(2)
    plain, grouped = _trainer(), _trainer(create_mesh(device_type="cpu"))
    assert grouped.step_fn.group is not None and grouped.step_fn.bn_group is None
    for i in (1, 2):
        a, b = plain.train_step(i), grouped.train_step(i)
        assert all(torch.equal(a[k], b[k]) for k in a)
    for (name, p), q in zip(plain.state.model.state_dict().items(),
                            grouped.state.model.state_dict().values()):
        assert torch.equal(p, q), name


def test_global_batch_norm_formula(one_rank):
    """Forced on one rank, the synced path computes flax's statistics of the
    same rows: outputs, gradients and running statistics against
    ``F.batch_norm``'s (which sums in another order) within float32's
    rounding."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(4, 8, 6, 5, generator=g) * 3 + 1).requires_grad_(True)
    out = {}
    for tag, group in (("plain", None), ("synced", one_rank)):
        bn = BatchNorm(8)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 2, 8))
            bn.bias.copy_(torch.linspace(-1, 1, 8))
        bn.group = group
        x.grad = None
        y = bn(x)
        (y * torch.linspace(-1, 1, 5)).sum().backward()
        out[tag] = (y.detach(), x.grad.clone(), bn.weight.grad, bn.running_mean, bn.running_var)
    for a, b in zip(out["synced"], out["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert not torch.equal(out["synced"][4], torch.ones(8))  # the statistics moved


def test_train_step_takes_a_group_only_where_it_has_more_than_one_rank(one_rank):
    assert TrainStep((64, 64)).bn_group is None
    assert TrainStep((64, 64), group=one_rank).bn_group is None
