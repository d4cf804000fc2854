"""The port's training-form model, its initialisation and the flax trees in
both directions, against tti.

Tolerances (float32 on both sides, jax_default_matmul_precision="highest",
so differences are summation order): train-mode outputs 2e-3 absolute and
batch statistics 1e-4 relative, since batch normalisation divides by batch
standard deviations that can be small at these sizes; eval() against the
folded inference model 1e-3 absolute on outputs of order 1-10 (the folded
weights round once more). Trees, files and initial values: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tti.model import convert as jconvert
from tti.model.yolo import create_model as jax_create_model
from tti_torch.model import checkpoint as ck
from tti_torch.model.yolo import STRIDES, create_model, init_model


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and more threads per process only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

CHECKPOINTS = {  # name: (file, mask_stride, proto_head)
    "cam_s2_subpixel": ("yolov8n_textile_cam", 2, "subpixel"),
    "textile_s4": ("yolov8n_textile", 4, "deconv"),
}


def _variables(name):
    return ck.load_flax_msgpack(f"checkpoints/{CHECKPOINTS[name][0]}.msgpack")


def _train_model(name, variables):
    _, stride, head = CHECKPOINTS[name]
    model = create_model("n", 2, mask_stride=stride, proto_head=head, s2d_stem=False,
                         folded_bn=False)
    sd = ck.from_flax_variables(variables)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model


def _nhwc_fields(raw):
    return [t.detach().numpy() for t in (*raw.box, *raw.cls, *raw.mcoef, raw.protos)]


def _flax_fields(raw):
    return [np.asarray(t) for t in (*raw.box, *raw.cls, *raw.mcoef, raw.protos)]


@pytest.mark.parametrize("name", sorted(CHECKPOINTS))
def test_train_mode_matches_flax(name):
    """Train mode: batch statistics normalise, and the running statistics
    move as flax's (biased variance, momentum 0.97) on a second call too."""
    variables = _variables(name)
    _, stride, head = CHECKPOINTS[name]
    x = np.random.default_rng(3).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    jmodel = jax_create_model("n", nc=2, mask_stride=stride, proto_head=head)
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))
    ref, upd = apply(variables, jnp.asarray(x))
    ref2, upd2 = apply({"params": variables["params"], **upd}, jnp.asarray(x[::-1]))
    model = _train_model(name, variables).train()
    got = model(torch.from_numpy(x))
    got2 = model(torch.from_numpy(np.ascontiguousarray(x[::-1])))
    for a, b in zip(_nhwc_fields(got) + _nhwc_fields(got2), _flax_fields(ref) + _flax_fields(ref2)):
        np.testing.assert_allclose(a, b, atol=2e-3)
    stats = ck.to_flax_variables(model.state_dict())["batch_stats"]
    want = jax.tree_util.tree_leaves_with_path(upd2["batch_stats"])
    got_stats = dict(jax.tree_util.tree_leaves_with_path(stats))
    assert len(want) == len(got_stats) > 100
    for path, value in want:
        np.testing.assert_allclose(got_stats[path], np.asarray(value), rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", sorted(CHECKPOINTS))
def test_eval_matches_folded_inference(name):
    variables = _variables(name)
    _, stride, head = CHECKPOINTS[name]
    x = torch.from_numpy(np.random.default_rng(4).uniform(size=(2, 64, 96, 3)).astype(np.float32))
    model = _train_model(name, variables).eval()
    folded = create_model("n", 2, mask_stride=stride, proto_head=head, s2d_input=False)
    sd = ck.from_flax_variables(ck.fold_batchnorm(ck.stem_to_s2d(variables)))
    folded.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        for a, b in zip(_nhwc_fields(model(x)), _nhwc_fields(folded.eval()(x))):
            np.testing.assert_allclose(a, b, atol=1e-3)


def _flax_tree_shapes(stride, head):
    model = jax_create_model("n", nc=2, mask_stride=stride, proto_head=head)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 64, 64, 3)), train=False))
    return {jax.tree_util.keystr(p): v.shape for p, v in jax.tree_util.tree_leaves_with_path(shapes)}


@pytest.mark.parametrize("stride,head", [(4, "deconv"), (2, "subpixel"), (2, "deconv")])
def test_init_model_tree_and_distributions(stride, head):
    """init_model has flax's tree (names and shapes) and its initial
    distributions: truncated lecun-normal kernels, zero biases, BN 1/0/0/1,
    the class-bias prior and DFL biases at 1."""
    model = init_model("n", 2, stride, head, torch.Generator().manual_seed(0))
    tree = ck.to_flax_variables(model.state_dict())
    got = {jax.tree_util.keystr(p): v.shape for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert got == _flax_tree_shapes(stride, head)
    kernels = [(n, m.weight.detach()) for n, m in model.named_modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    for name, w in kernels:
        fan_in = w[0].numel() if isinstance(dict(model.named_modules())[name], torch.nn.Conv2d) \
            else w.shape[0] * w[0, 0].numel()
        std = np.sqrt(1.0 / fan_in)
        # Truncated at two standard deviations of the underlying normal.
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6, name
        if w.numel() >= 2000:
            assert abs(float(w.std()) / std - 1) < 0.1, name
    for path, v in jax.tree_util.tree_leaves_with_path(tree["batch_stats"]):
        key = jax.tree_util.keystr(path)
        assert np.all(v == (0.0 if key.endswith("['mean']") else 1.0)), key
    for path, v in jax.tree_util.tree_leaves_with_path(tree["params"]):
        key = jax.tree_util.keystr(path)
        if "['bn']" in key:
            assert np.all(v == (1.0 if key.endswith("['scale']") else 0.0)), key
        elif key.endswith("['bias']"):
            level = next((lv for lv in range(3) if f"_{lv}_2'" in key), None)
            if level is not None and "cv3" in key:
                want = np.log(5 / 2 / (640 / STRIDES[level]) ** 2)
                np.testing.assert_allclose(v, want, rtol=1e-6, err_msg=key)
            elif level is not None and "cv2" in key:
                assert np.all(v == 1.0), key
            else:
                assert np.all(v == 0.0), key


def test_init_model_seeded():
    a = init_model("n", 2, 4, generator=torch.Generator().manual_seed(5)).state_dict()
    b = init_model("n", 2, 4, generator=torch.Generator().manual_seed(5)).state_dict()
    c = init_model("n", 2, 4, generator=torch.Generator().manual_seed(6))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["m1.conv.weight"], c.m1.conv.weight.detach())


@pytest.mark.parametrize("name", sorted(CHECKPOINTS))
def test_flax_tree_round_trip_and_writer(name, tmp_path):
    """from_flax_variables then to_flax_variables gives the tree back; the
    writer's bytes are flax's own, and tti's loader reads the file."""
    variables = _variables(name)
    _, stride, head = CHECKPOINTS[name]
    model = _train_model(name, variables)
    back = ck.to_flax_variables(model.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(leaves) == len(got)
    for path, value in leaves:
        np.testing.assert_array_equal(got[path], value)
    path = str(tmp_path / "w.msgpack")
    ck.save_flax_msgpack(back, path, {"variant": "n"})
    with open(path, "rb") as f:
        assert f.read() == serialization.to_bytes(back)
    template = jax.eval_shape(lambda: jax_create_model(
        "n", nc=2, mask_stride=stride, proto_head=head).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    loaded = jconvert.load_checkpoint(path, template)
    for p, value in leaves:
        np.testing.assert_array_equal(np.asarray(dict(jax.tree_util.tree_leaves_with_path(
            loaded))[p]), value)
    assert ck.checkpoint_metadata(path) == jconvert.checkpoint_metadata(path) == {"variant": "n"}


def test_unfolded_tree_needs_batch_stats():
    variables = _variables("textile_s4")
    with pytest.raises(ValueError, match="batch_stats"):
        ck.from_flax_variables({"params": variables["params"]})
