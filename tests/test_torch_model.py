"""The port's YOLOv8-seg layers and model against tti's flax modules.

Tolerance: float32 on both sides (jax_default_matmul_precision="highest"),
so differences are summation order only. 1e-4 absolute on activations of
order 1-10 for whole-network outputs, 2e-5 for single layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tti.model import convert as jconvert
from tti.model import layers as jl
from tti.model.yolo import YOLOv8Seg as JaxYOLO
from tti_torch.model import checkpoint as ck
from tti_torch.model import layers as tl
from tti_torch.model.yolo import create_model, space_to_depth2


def _load(module, flax_params):
    """Load a folded flax subtree into a port module."""
    sd = ck.from_flax_variables({"params": flax_params})
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _run_flax(module, x, seed=0):
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    # Random, non-trivial biases (init makes them zero).
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (rng.normal(0, 0.1, a.shape).astype(np.float32)
                                   if a.ndim == 1 else 0.0), params)
    return params, np.asarray(module.apply({"params": params}, jnp.asarray(x)))


LAYERS = {
    "conv3x3s2": (lambda: jl.Conv(24, 3, 2, folded=True), lambda: tl.Conv(16, 24, 3, 2), 16),
    "c2f": (lambda: jl.C2f(32, 2, True, folded=True), lambda: tl.C2f(16, 32, 2, True), 16),
    "sppf": (lambda: jl.SPPF(32, 5, folded=True), lambda: tl.SPPF(16, 32, 5), 16),
    "proto": (lambda: jl.Proto(16, 8, folded=True), lambda: tl.Proto(12, 16, 8), 12),
    "proto_deconv2": (lambda: jl.Proto(16, 8, folded=True, ups=2),
                      lambda: tl.Proto(12, 16, 8, ups=2), 12),
    "proto_subpixel": (lambda: jl.Proto(16, 8, folded=True, ups=2, subpixel=True),
                       lambda: tl.Proto(12, 16, 8, ups=2, subpixel=True), 12),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_flax(name):
    make_jax, make_torch, c_in = LAYERS[name]
    x = np.random.default_rng(1).normal(size=(2, 12, 10, c_in)).astype(np.float32)
    params, ref = _run_flax(make_jax(), x)
    with torch.no_grad():
        got = _load(make_torch(), params)(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_conv_transpose_kernel_layout():
    """flax ConvTranspose (kH, kW, I, O), stride 2, VALID: out[2i+a, 2j+b] =
    x[i, j] @ K[1-a, 1-b]; the converted torch weight is that kernel with
    both spatial axes flipped."""
    import flax.linen as nn

    x = np.random.default_rng(2).normal(size=(1, 3, 4, 5)).astype(np.float32)
    mod = nn.ConvTranspose(6, (2, 2), strides=(2, 2), padding="VALID")
    params, ref = _run_flax(mod, x)
    k = np.asarray(params["kernel"])
    np.testing.assert_allclose(ref[0, 0, 0], x[0, 0, 0] @ k[1, 1] + params["bias"], atol=1e-5)
    conv = torch.nn.ConvTranspose2d(5, 6, 2, 2)
    with torch.no_grad():
        got = _load(torch.nn.ModuleDict({"upsample": conv}), {"upsample": params})["upsample"](
            _nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("name,imgsz,ms,head", [
    ("yolov8n_textile", (128, 192), 4, "deconv"),
    ("yolov8n_textile_cam", (160, 224), 2, "subpixel"),
])
def test_full_model_matches_flax_on_real_checkpoints(name, imgsz, ms, head):
    tree = ck.load_flax_msgpack(f"checkpoints/{name}.msgpack")
    folded = ck.fold_batchnorm(ck.stem_to_s2d(tree))
    x = np.random.default_rng(3).uniform(size=(2, *imgsz, 3)).astype(np.float32)
    xs = space_to_depth2(torch.from_numpy(x))
    jm = JaxYOLO(variant="n", nc=2, s2d_stem=True, s2d_input=True, folded_bn=True,
                 mask_stride=ms, proto_head=head)
    ref = jm.apply(jconvert.fold_batchnorm(jconvert.stem_to_s2d(tree)), jnp.asarray(xs.numpy()))
    model = create_model("n", 2, mask_stride=ms, proto_head=head)
    sd = ck.from_flax_variables(folded)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = model.eval()(xs)
    for field in ("box", "cls", "mcoef"):
        for a, b in zip(getattr(got, field), getattr(ref, field)):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, err_msg=field)
    assert tuple(got.protos.shape) == (2, imgsz[0] // ms, imgsz[1] // ms, 32)
    np.testing.assert_allclose(got.protos.numpy(), np.asarray(ref.protos), atol=1e-4)
    # The model blocks a raw (B, H, W, 3) input itself when s2d_input=False.
    model.s2d_input = False
    with torch.no_grad():
        raw = model(torch.from_numpy(x))
    np.testing.assert_array_equal(raw.protos.numpy(), got.protos.numpy())
