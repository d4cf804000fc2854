"""The port's device augmentation against tti.train.augment, fed tti's own
random draws.

``tti_draws`` takes the numbers out of a jax key exactly as
``tti.train.augment._augment_one`` splits and uses it; the port's ``apply``
gets them and must reproduce tti's batch. Float32 on both sides.
Tolerances: images 2e-5 absolute (resample sums and the HSV round trip in
another order); boxes 1e-4 px; classes and valid exact; soft masks 1e-5;
binary masks are thresholds of resampled values at 0.5, so a value within
rounding of 0.5 may land on the other side: at most 0.1% of cells differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_scenes import textile_samples
from tti.train import augment as jaug
from tti_torch.train import augment as taug


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and more threads per process only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

GAINS = (0.015, 0.7, 0.4)


def tti_draws(keys, n_images, scale=0.5, translate=0.1, mosaic_p=1.0, flip_p=0.5,
              hsv_gains=GAINS):
    """The draws of tti's _augment_one for each key, as the port's params."""
    def one(key):
        k_idx, k_mosaic, k_geom, k_hsv, k_flip = jax.random.split(key, 5)
        ks, ktx, kty, kc = jax.random.split(k_geom, 4)
        return {
            "idx": jax.random.randint(k_idx, (4,), 0, n_images),
            "mosaic": jax.random.uniform(k_mosaic) < mosaic_p,
            "scale": jax.random.uniform(ks, minval=1.0 - scale, maxval=1.0 + scale),
            "tx": jax.random.uniform(ktx, minval=-translate, maxval=translate),
            "ty": jax.random.uniform(kty, minval=-translate, maxval=translate),
            "ctr": jax.random.uniform(kc, (2,), minval=0.25, maxval=0.75),
            "hsv": jax.random.uniform(k_hsv, (3,), minval=-1.0, maxval=1.0)
            * jnp.asarray(hsv_gains) + 1.0,
            "flip": jax.random.uniform(k_flip) < flip_p,
        }
    draws = jax.vmap(one)(keys)
    return {k: torch.tensor(np.asarray(v)).long() if k == "idx"
            else torch.tensor(np.asarray(v)) for k, v in draws.items()}


def _datasets(imgsz, stride, soft, n=6, max_gt=8):
    port = taug.build_device_dataset(textile_samples(n, imgsz, seed=11), imgsz, max_gt,
                                     mask_stride=stride, soft_masks=soft, device="cpu")
    ref = jaug.DeviceDataset(images=jnp.asarray(port.images.numpy()),
                             boxes=jnp.asarray(port.boxes.numpy()),
                             classes=jnp.asarray(port.classes.numpy()),
                             masks=jnp.asarray(port.masks.numpy()),
                             valid=jnp.asarray(port.valid.numpy()), soft=port.soft)
    return port, ref


# Each soft kind at both mask strides, mosaic and flip each on and off for
# every kind: name -> (mask stride, soft spec, mosaic_p, flip_p).
CASES = {
    "binary_s4_mosaic_flip": (4, False, 1.0, 1.0),
    "binary_s2_plain": (2, False, 0.0, 0.0),
    "allsoft_s2_mosaic_noflip": (2, "all", 1.0, 0.0),
    "allsoft_s4_nomosaic_flip": (4, "all", 0.0, 1.0),
    "stitchsoft_s2_mosaic_flip": (2, "stitch", 1.0, 1.0),
    "stitchsoft_s4_plain": (4, "stitch", 0.0, 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_with_tti_draws(case):
    stride, soft, mosaic_p, flip_p = CASES[case]
    imgsz, batch, max_gt = 96, 4, 8
    port, ref = _datasets(imgsz, stride, soft)
    assert port.soft == (True if soft == "all" else (0,) if soft == "stitch" else ())
    keys = jax.random.split(jax.random.key(len(case)), batch)
    imgs_ref, t_ref = jax.jit(jax.vmap(lambda k: jaug._augment_one(
        k, ref, max_gt, 0.5, 0.1, mosaic_p, flip_p, GAINS)))(keys)
    params = tti_draws(keys, port.images.shape[0], mosaic_p=mosaic_p, flip_p=flip_p)
    imgs, t = taug.apply(port, params, max_gt)
    np.testing.assert_allclose(imgs.numpy(), np.asarray(imgs_ref), atol=2e-5)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(t_ref["valid"]))
    np.testing.assert_array_equal(t.classes.numpy(), np.asarray(t_ref["classes"]))
    np.testing.assert_allclose(t.boxes.numpy(), np.asarray(t_ref["boxes"]), atol=1e-4)
    assert t.valid.any()
    got_m, ref_m = t.masks.numpy(), np.asarray(t_ref["masks"])
    soft_slots = (np.ones_like(got_m[:, :, 0, 0], bool) if soft == "all" else
                  (t.classes.numpy() == 0) if soft == "stitch" else
                  np.zeros_like(got_m[:, :, 0, 0], bool))
    np.testing.assert_allclose(got_m[soft_slots], ref_m[soft_slots], atol=1e-5)
    binary = ~soft_slots
    if binary.any():
        assert set(np.unique(got_m[binary])) <= {0.0, 1.0}
        assert (got_m[binary] != ref_m[binary]).mean() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scale_and_translate_matches_jax(dtype):
    """Random scales 0.5-1.5 and translations, upsampling and downsampling,
    samples falling outside the input; the positions come from float32
    scale and translation in both dtypes. bf16: within two bf16 steps of
    values of order 1 (tti's einsum rounds between its products too)."""
    rng = np.random.default_rng(0)
    b, h, w, c = 5, 20, 28, 3
    x = rng.uniform(-1, 1, (b, h, w, c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (b, 2)).astype(np.float32)
    trans = rng.uniform(-8, 8, (b, 2)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for out_hw in ((20, 28), (31, 17)):
        got = taug.scale_and_translate(torch.from_numpy(x).to(dtype), out_hw,
                                       torch.from_numpy(scale), torch.from_numpy(trans)).float()
        for i in range(b):
            ref = jax.image.scale_and_translate(
                jnp.asarray(x[i]).astype(jdt), (*out_hw, c), (0, 1), jnp.asarray(scale[i]),
                jnp.asarray(trans[i]), method="linear", antialias=False).astype(jnp.float32)
            atol = 1e-5 if dtype == torch.float32 else 2 * 2.0 ** -8
            np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), atol=atol)


def test_identity_configuration_reproduces_the_source():
    """No mosaic, scale 1, no translation, flip or HSV change: the batch is
    the source images and their ground truth."""
    port, _ = _datasets(96, 2, "stitch", n=3)  # stitches at least 2 px high
    gen = torch.Generator().manual_seed(0)
    params = taug.draw_params(gen, 3, 3, scale=0.0, translate=0.0, mosaic_p=0.0, flip_p=0.0,
                              hsv_gains=(0.0, 0.0, 0.0))
    params["idx"][:, 0] = torch.arange(3)
    imgs, t = taug.apply(port, params, max_gt=8)
    np.testing.assert_allclose(imgs.numpy(), port.images.numpy() / 255.0, atol=2e-6)
    np.testing.assert_array_equal(t.valid.numpy(), port.valid.numpy())
    assert (t.valid & (t.classes == 0)).sum() >= 15
    np.testing.assert_array_equal(t.classes.numpy(), port.classes.numpy())
    np.testing.assert_allclose(t.boxes.numpy(), port.boxes.numpy(), atol=1e-4)
    soft = (t.classes == 0)[..., None, None].numpy()
    src = port.masks.numpy().astype(np.float32)
    np.testing.assert_allclose(t.masks.numpy(), np.where(soft, src / 255.0, src), atol=1e-6)


def test_batch_stream_is_a_function_of_the_step():
    """step_generator(seed, step) gives the same batch every time, and
    another step or seed another batch."""
    port, _ = _datasets(32, 4, False)
    fn = taug.make_augment_fn(3, 8)
    a = fn(port, taug.step_generator(0, 5, "cpu"))
    b = fn(port, taug.step_generator(0, 5, "cpu"))
    c = fn(port, taug.step_generator(0, 6, "cpu"))
    d = fn(port, taug.step_generator(1, 5, "cpu"))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1].masks, b[1].masks)
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], d[0])
    assert a[0].dtype == torch.float32
    assert fn.__name__ == "batch_fn"
    half = taug.make_augment_fn(3, 8, image_dtype=torch.bfloat16)(
        port, taug.step_generator(0, 5, "cpu"))[0]
    assert half.dtype == torch.bfloat16
    assert float((half.float() - a[0]).abs().max()) <= 3 * 2.0 ** -8
