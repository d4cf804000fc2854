"""The fused head entry: ``fuse_head_entries`` array-equal to tti's, the
fused model equal to the unfused one and to tti's fused model, folded and
unfolded (float32, jax_default_matmul_precision="highest": summation order
only, 1e-4 absolute on whole-network outputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tti.model import convert as jconvert
from tti.model.yolo import YOLOv8Seg as JaxYOLO
from tti_torch.model import checkpoint as ck
from tti_torch.model.yolo import create_model, space_to_depth2


@pytest.fixture(scope="module")
def tree():
    return ck.load_flax_msgpack("checkpoints/yolov8n_textile_cam.msgpack")


def _leaves(t, prefix=""):
    for k, v in t.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_fuse_head_entries_equals_tti(tree):
    s2d = ck.stem_to_s2d(tree)
    got = dict(_leaves(ck.fuse_head_entries(s2d)))
    want = dict(_leaves(jconvert.fuse_head_entries(jconvert.stem_to_s2d(tree))))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert "params/m22/cvh_0/conv/kernel" in got and "params/m22/cv2_0_0/conv/kernel" not in got
    # Folded after fusing, as the reference orders it.
    folded = dict(_leaves(ck.fold_batchnorm(ck.fuse_head_entries(s2d))))
    want = dict(_leaves(jconvert.fold_batchnorm(jconvert.fuse_head_entries(
        jconvert.stem_to_s2d(tree)))))
    assert folded.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(folded[key], want[key], err_msg=key)


def _port_model(tree, fused, fold):
    t = ck.stem_to_s2d(tree)
    if fused:
        t = ck.fuse_head_entries(t)
    if fold:
        t = ck.fold_batchnorm(t)
    model = create_model("n", 2, mask_stride=2, proto_head="subpixel", folded_bn=fold,
                         fused_head=fused)
    sd = ck.from_flax_variables(t)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model.eval(), t


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "unfolded"])
def test_fused_forward_equals_unfused_and_tti(tree, fold):
    x = np.random.default_rng(3).uniform(size=(2, 128, 160, 3)).astype(np.float32)
    xs = space_to_depth2(torch.from_numpy(x))
    fused, fused_tree = _port_model(tree, True, fold)
    plain, _ = _port_model(tree, False, fold)
    with torch.no_grad():
        got, base = fused(xs), plain(xs)
    jm = JaxYOLO(variant="n", nc=2, s2d_stem=True, s2d_input=True, folded_bn=fold,
                 fused_head_entry=True, mask_stride=2, proto_head="subpixel")
    ref = jm.apply(fused_tree, jnp.asarray(xs.numpy()), train=False)
    for field in ("box", "cls", "mcoef"):
        for a, b, c in zip(getattr(got, field), getattr(base, field), getattr(ref, field)):
            assert tuple(a.shape) == c.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, err_msg=field)
            np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-4, err_msg=field)
    np.testing.assert_array_equal(got.protos.numpy(), base.protos.numpy())
    # The flax names map both ways.
    back = ck.to_flax_variables(fused.state_dict())
    assert "cvh_2" in back["params"]["m22"] and (fold or "cvh_2" in back["batch_stats"]["m22"])
