"""The port's weight conversion (``tti_torch.model.convert``) against
``tti.model.convert`` and the torch reference model: the converted tree
equals tti's leaf for leaf, ``to_torch_state_dict`` round trips, the port's
model on the converted tree computes ``tests/torch_ref.TorchYOLOv8Seg``'s
forward (float32, 2e-4, the tolerance of ``tests/test_convert.py``'s forward
test), and tti's three rejections hold."""

import numpy as np
import pytest
import torch

from tests.torch_ref import TorchYOLOv8Seg, randomize_running_stats
from tti.model import convert as jconvert
from tti_torch.model import checkpoint as ck
from tti_torch.model.convert import (
    convert_torch_state_dict, to_torch_state_dict, verify_tree_shapes,
)
from tti_torch.model.yolo import create_model


def _torch_model(seed=0):
    torch.manual_seed(seed)
    model = TorchYOLOv8Seg(variant="n", nc=2)
    randomize_running_stats(model, seed)
    return model.eval()


def _leaves(tree, path=""):
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from _leaves(value, f"{path}/{key}")
        else:
            yield f"{path}/{key}", np.asarray(value)


def test_converted_tree_equals_tti_leaf_for_leaf():
    sd = _torch_model().state_dict()
    got = dict(_leaves(convert_torch_state_dict(sd)))
    ref = dict(_leaves(jconvert.convert_torch_state_dict(sd)))
    assert list(got) == list(ref) and len(got) > 300
    for key, value in ref.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_to_torch_state_dict_round_trips_and_matches_tti():
    tmodel = _torch_model(1)
    original = {k: v.detach().numpy().copy() for k, v in tmodel.state_dict().items()}
    variables = convert_torch_state_dict(tmodel.state_dict())
    sd = to_torch_state_dict(variables)
    assert set(sd) == set(original)
    for key in original:
        np.testing.assert_array_equal(sd[key], original[key], err_msg=key)
    ref = jconvert.to_torch_state_dict(variables)
    assert list(sd) == list(ref)
    for key in ref:
        np.testing.assert_array_equal(sd[key], ref[key], err_msg=key)
    fresh = TorchYOLOv8Seg(variant="n", nc=2)
    fresh.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                          strict=True)


@pytest.mark.parametrize("folded", [False, True])
def test_port_model_on_converted_tree_matches_torch_reference(folded):
    """The converted tree in the port's model, unfolded (BatchNorm with
    running statistics, the plain stem) and in the step's inference form (s2d
    stem, folded BatchNorm), against the reference's forward."""
    tmodel = _torch_model(2)
    tree = convert_torch_state_dict(tmodel.state_dict())
    if folded:
        tree = ck.fold_batchnorm(ck.stem_to_s2d(tree))
    model = create_model("n", 2, s2d_input=False, s2d_stem=folded, folded_bn=folded)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in ck.from_flax_variables(tree).items()},
                          strict=True)
    x = np.random.default_rng(3).uniform(size=(1, 96, 128, 3)).astype(np.float32)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
        box, cls, coef, protos = tmodel(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    for mine, theirs in zip((*got.box, *got.cls, *got.mcoef, got.protos),
                            (*box, *cls, *coef, protos)):
        np.testing.assert_allclose(mine.numpy(), theirs.numpy().transpose(0, 2, 3, 1),
                                   rtol=2e-4, atol=2e-4)


def test_tree_verifies_against_the_ports_own_model():
    tree = convert_torch_state_dict(_torch_model().state_dict())
    template = ck.to_flax_variables(create_model("n", 2, s2d_stem=False,
                                                 folded_bn=False).state_dict())
    for coll in ("params", "batch_stats"):
        assert verify_tree_shapes(tree[coll], template[coll], coll) == []
        assert (verify_tree_shapes(tree[coll], template[coll], coll)
                == jconvert.verify_tree_shapes(tree[coll], template[coll], coll))
    broken = {"params": dict(tree["params"], extra={"w": np.zeros(1)})}
    broken["params"].pop("m3")
    got = verify_tree_shapes(broken["params"], template["params"], "params")
    assert got == jconvert.verify_tree_shapes(broken["params"], template["params"], "params")
    assert "missing params/m3" in got and "unexpected params/extra" in got


def test_dfl_and_non_model_keys_are_skipped():
    sd = dict(_torch_model().state_dict())
    sd["epoch"] = torch.tensor(3)
    sd["optimizer.lr"] = torch.tensor(0.1)
    tree = convert_torch_state_dict(sd)
    assert not any("dfl" in k for k, _ in _leaves(tree))
    assert "epoch" not in tree["params"] and "optimizer" not in tree["params"]


def test_unknown_suffix_raises():
    with pytest.raises(ValueError, match="unhandled"):
        convert_torch_state_dict({"model.0.conv.weird_stat": torch.zeros(3)})


def test_to_torch_state_dict_rejects_folded_and_hires_trees():
    tree = convert_torch_state_dict(_torch_model().state_dict())
    with pytest.raises(ValueError, match="folded|batch_stats"):
        to_torch_state_dict(ck.fold_batchnorm(tree))
    hires = ck.load_flax_msgpack("checkpoints/yolov8n_textile_960_s2.msgpack")
    with pytest.raises(ValueError, match="mask_stride=2"):
        to_torch_state_dict(hires)
