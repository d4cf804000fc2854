"""The port's training step against tti.train.step on the same weights and
batch: loss terms, every gradient, the optimizer, the schedule, the clip
and one whole step (params, batch stats, EMA, step).

Float32 on both sides (jax_default_matmul_precision="highest"); the batch
is two 64 px synthetic textile scenes with per-class soft targets, the
deploy checkpoint's weights (stride-2 sub-pixel protos) and seg gains
(2.0, 1.0). tti's train step is compiled twice: its loss and gradient, and
its whole step. Tolerances: loss terms 1e-4 relative; gradients 1e-3
relative to each tensor's largest entry (the batch statistics' backward
sums over whole feature maps in another order); after one update the
parameters within 2.5 learning rates of tti's (Adam's first step is
lr * g / (|g| + eps), a sign for any gradient above eps, so a gradient
near zero can take the other sign), and their mean difference under 1% of
one learning rate; the optimizer fed tti's gradients and the schedule
1e-6 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_scenes import textile_samples
from tti.model.yolo import STRIDES as JSTRIDES, create_model as jax_create_model
from tti.postprocess.decode import flatten_predictions as jflatten, make_anchors as jmake_anchors
from tti.train import step as jstep
from tti_torch.model import checkpoint as ck
from tti_torch.model.layers import Proto
from tti_torch.train import step as tstep
from tti_torch.train.data import scene_to_targets
from tti_torch.train.loop import build_model, step_and_augment, train_switches


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and more threads per process only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

IMGSZ, MAX_GT, GAINS, LR, TOTAL = 64, 8, (2.0, 1.0), 1e-3, 10
CKPT = "checkpoints/yolov8n_textile_cam.msgpack"


@pytest.fixture(scope="module")
def problem():
    images, tgts = [], []
    for s in textile_samples(2, IMGSZ, seed=3):
        img, t = scene_to_targets(s.image.astype(np.float32) / 255.0, s.polygons, s.classes,
                                  IMGSZ, MAX_GT, mask_stride=2, soft_masks="stitch")
        images.append(img)
        tgts.append(t)
    stack = {k: np.stack([t[k] for t in tgts]) for k in ("boxes", "classes", "masks", "valid")}
    return np.stack(images).astype(np.float32), stack, ck.load_flax_msgpack(CKPT)


def _port(problem):
    images, t, variables = problem
    model = build_model("n", 2, 2, "subpixel", torch.float32, "cpu", init=CKPT)
    targets = tstep.Targets(*(torch.from_numpy(t[k]) for k in ("boxes", "classes", "masks", "valid")))
    return model, torch.from_numpy(images), targets


def _jax(problem):
    images, t, variables = problem
    model = jax_create_model("n", nc=2, mask_stride=2, proto_head="subpixel")
    targets = jstep.Targets(**{k: jnp.asarray(t[k]) for k in ("boxes", "classes", "masks", "valid")})
    return model, jnp.asarray(images), targets, variables


def _jax_loss(model):
    """tti's loss as its make_train_step builds it (step.py:218-254)."""
    def loss_fn(params, batch_stats, images, targets):
        raw, updates = model.apply({"params": params, "batch_stats": batch_stats}, images,
                                   train=True, mutable=["batch_stats"])
        box_f, cls_f, coef_f, level_hw = jflatten(raw)
        anchors, spa = jmake_anchors(level_hw, JSTRIDES)
        per_image = jax.vmap(lambda bf, cf, mf, pr, tb, tc, tm, tv: jstep._loss_single(
            (bf, cf, mf), pr, anchors, spa, tb, tc, tm, tv, (IMGSZ, IMGSZ),
            seg_class_gains=GAINS))(box_f, cls_f, coef_f, raw.protos, targets.boxes,
                                    targets.classes, targets.masks, targets.valid)
        losses = {k: jnp.mean(v) for k, v in per_image.items()}
        total = (jstep.BOX_GAIN * losses["box"] + jstep.CLS_GAIN * losses["cls"]
                 + jstep.DFL_GAIN * losses["dfl"] + jstep.BOX_GAIN * jstep.SEG_GAIN * losses["seg"])
        return total, (losses, updates["batch_stats"])
    return loss_fn


@pytest.fixture(scope="module")
def jax_value_and_grad(problem):
    model, images, targets, variables = _jax(problem)
    fn = jax.jit(jax.value_and_grad(_jax_loss(model), has_aux=True))
    (total, (losses, stats)), grads = fn(variables["params"], variables["batch_stats"], images,
                                         targets)
    return float(total), {k: float(v) for k, v in losses.items()}, grads


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_grads(problem):
    model, images, targets = _port(problem)
    step = tstep.TrainStep((IMGSZ, IMGSZ), seg_class_gains=GAINS)
    total, losses = step.loss(model, images, targets)
    total.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return float(total.detach()), {k: float(v.detach()) for k, v in losses.items()}, grads


def test_loss_terms_and_every_gradient(problem, jax_value_and_grad):
    ref_total, ref_losses, ref_grads = jax_value_and_grad
    total, losses, grads = _port_grads(problem)
    assert losses["seg"] > 0 and losses["box"] > 0  # the batch has positives
    np.testing.assert_allclose(total, ref_total, rtol=1e-4)
    for key in ("cls", "box", "dfl", "seg"):
        np.testing.assert_allclose(losses[key], ref_losses[key], rtol=1e-4, err_msg=key)
    got = _leaves(ck.to_flax_variables(grads)["params"])
    want = _leaves(ref_grads)
    assert got.keys() == want.keys() and len(got) > 200
    for key, ref in want.items():
        scale = max(float(np.abs(ref).max()), 1e-8)
        err = float(np.abs(got[key] - ref).max())
        assert err <= 1e-3 * scale, f"{key}: max err {err} vs max |grad| {scale}"


def _with_schedule_count(state, k):
    """tti's optimizer state with only the schedule's counter set to k."""
    if type(state).__name__ == "ScaleByScheduleState":
        return state._replace(count=jnp.asarray(k, jnp.int32))
    if isinstance(state, tuple):
        items = [_with_schedule_count(s, k) for s in state]
        return type(state)(*items) if hasattr(state, "_fields") else tuple(items)
    return state


def _tti_schedule(total):
    """The learning rate tti's create_train_state applies at update k, read
    from its optimizer: a fresh Adam state, unit gradient and a zero
    parameter, so the update is -lr times Adam's own first-step factor."""
    model = jax_create_model("n")
    params = {"w": jnp.zeros(())}
    _, tx = jstep.create_train_state(model, {"params": params, "batch_stats": {}},
                                     learning_rate=LR, total_steps=total)
    state = tx.init(params)
    grad = {"w": jnp.ones(())}
    adam = optax.scale_by_adam(eps=1e-8)
    factor = float(adam.update(grad, adam.init(params))[0]["w"])

    def lr(k):
        upd, _ = tx.update(grad, _with_schedule_count(state, k), params)
        return -float(upd["w"]) / factor
    return lr


@pytest.mark.parametrize("total", [1, 2, 5, 100, 10000])
def test_schedule_matches_tti(total):
    """Warmup and cosine, with the clamps for tiny runs; update k reads
    schedule(k) before the step is counted."""
    ref = _tti_schedule(total)
    port = tstep.warmup_cosine_schedule(LR, total)
    counts = sorted({0, 1, 2, 3, total // 2, total - 1, total, total + 5, 19, 20, 21, 499, 500})
    for k in counts:
        np.testing.assert_allclose(port(k), ref(k), rtol=1e-6, err_msg=f"count {k}")
    assert tstep.warmup_cosine_schedule(LR, None)(7) == LR


@pytest.mark.parametrize("scale", [0.01, 1.0, 100.0])
def test_clip_matches_optax(scale):
    """optax scales by max_norm / norm only when the norm is not below
    max_norm; torch.nn.utils.clip_grad_norm_ would divide by norm + 1e-6."""
    rng = np.random.default_rng(4)
    grads = [rng.normal(size=s).astype(np.float32) * scale for s in ((3, 4), (50,), (2, 2, 5))]
    ref, _ = optax.clip_by_global_norm(10.0).update(grads, None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = tstep.clip_by_global_norm_(got)
    np.testing.assert_allclose(float(norm), np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                                        for g in grads)), rtol=1e-6)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


def test_optimizer_fed_tti_gradients_matches_optax(problem, jax_value_and_grad):
    """Three updates of the mask-prototype head's parameters with tti's
    gradients for them, scaled 1, -0.5 and to a global norm of 30 (the clip
    engages), through the port's update and through tti's optax chain:
    parameters and EMA."""
    _, _, grads = jax_value_and_grad
    _, _, _, variables = _jax(problem)
    sub = lambda tree: tree["m22"]["proto"]
    module = Proto(64, 64, 32, ups=2, subpixel=True, folded=False)
    sd = ck.from_flax_variables({"params": sub(variables["params"]),
                                 "batch_stats": sub(variables["batch_stats"])})
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    state = tstep.create_train_state(module, LR, total_steps=TOTAL)
    step = tstep.TrainStep((IMGSZ, IMGSZ))
    params = sub(variables["params"])
    jstate, tx = jstep.create_train_state(jax_create_model("n"), {"params": params,
                                                                  "batch_stats": {}},
                                          learning_rate=LR, total_steps=TOTAL)
    opt, ema = jstate.opt_state, jstate.ema_params
    g0 = sub(grads)
    norm = float(optax.global_norm(g0))
    flat = ck.from_flax_variables({"params": g0, "batch_stats": sub(variables["batch_stats"])})

    @jax.jit
    def ref_update(params, opt, ema, factor, step1):
        upd, opt = tx.update(jax.tree_util.tree_map(lambda a: a * factor, g0), opt, params)
        params = optax.apply_updates(params, upd)
        d = 0.999 * (1.0 - jnp.exp(-step1 / 2000.0))
        return params, opt, jax.tree_util.tree_map(lambda e, p: e * d + p * (1.0 - d), ema, params)

    for i, factor in enumerate((1.0, -0.5, 30.0 / norm)):
        params, opt, ema = ref_update(params, opt, ema, jnp.float32(factor), jnp.float32(i + 1))
        for name, p in module.named_parameters():
            p.grad = torch.from_numpy(flat[name] * np.float32(factor))
        step.update(state)
        assert state.step == i + 1
        got = _leaves(ck.to_flax_variables(dict(module.named_parameters()))["params"])
        got_ema = _leaves(ck.to_flax_variables(state.ema)["params"])
        assert got.keys() == _leaves(params).keys() and len(got) > 10
        for key, ref in _leaves(params).items():
            np.testing.assert_allclose(got[key], ref, rtol=1e-6, atol=1e-7, err_msg=key)
        for key, ref in _leaves(ema).items():
            np.testing.assert_allclose(got_ema[key], ref, rtol=1e-6, atol=1e-7, err_msg=key)


def test_whole_step_matches_tti(problem):
    """One step of tti's make_train_step against the port's: parameters,
    batch statistics, EMA, step and the returned losses."""
    _assert_whole_step_matches(problem, tstep.TrainStep((IMGSZ, IMGSZ), seg_class_gains=GAINS))


@pytest.mark.parametrize("env", [{"TTI_SEG_DTYPE": "bf16"}, {"TTI_SEG_CHUNK": "0"},
                                 {"TTI_SEG_CHUNK": "16"}, {"TTI_AUGMENT_DTYPE": "f32"}],
                         ids=["seg_bf16", "seg_unchunked", "seg_chunk16", "augment_f32"])
def test_whole_step_matches_tti_under_switch(problem, env, monkeypatch):
    """The same comparison with one of tti's trainer switches set in the
    process environment, which tti reads when it traces its step and the
    port's ``train`` when it builds its step (``step_and_augment``); same
    tolerances."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    # tti reads the switches while tracing, and jax caches the traces of its
    # module-level functions (the checkpointed seg term) across steps: trace
    # afresh under this test's switch.
    jax.clear_caches()
    step, _ = step_and_augment(IMGSZ, 2, MAX_GT, torch.float32, GAINS)
    _assert_whole_step_matches(problem, step)
    jax.clear_caches()


def _assert_whole_step_matches(problem, port_step):
    jmodel, images, targets, variables = _jax(problem)
    jstate, tx = jstep.create_train_state(jmodel, variables, learning_rate=LR, total_steps=TOTAL)
    jfn = jstep.make_train_step(jmodel, tx, (IMGSZ, IMGSZ), seg_class_gains=GAINS)
    jstate, jmetrics = jfn(jstate, images, targets)
    model, timages, ttargets = _port(problem)
    state = tstep.create_train_state(model, LR, total_steps=TOTAL)
    metrics = port_step(state, timages, ttargets)
    assert state.step == int(jstate.step) == 1
    for key, value in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(value), rtol=1e-4, err_msg=key)
    lr0 = tstep.warmup_cosine_schedule(LR, TOTAL)(0)
    tree = ck.to_flax_variables(model.state_dict())
    for name, got, ref in (("params", tree["params"], jstate.params),
                           ("ema", ck.to_flax_variables(state.ema)["params"], jstate.ema_params)):
        got, ref = _leaves(got), _leaves(ref)
        diffs = np.concatenate([np.abs(got[k] - r).ravel() for k, r in ref.items()])
        assert diffs.max() <= 2.5 * lr0, (name, diffs.max())
        assert diffs.mean() <= 0.01 * lr0, (name, diffs.mean())
    got, ref = _leaves(tree["batch_stats"]), _leaves(jstate.batch_stats)
    assert got.keys() == ref.keys()
    for key, r in ref.items():
        np.testing.assert_allclose(got[key], r, rtol=1e-4, atol=1e-6, err_msg=key)


def test_ema_starts_as_a_copy(problem):
    model, _, _ = _port(problem)
    state = tstep.create_train_state(model, LR)
    for name, p in model.named_parameters():
        e = state.ema[name]
        assert torch.equal(e, p.detach()) and e.data_ptr() != p.data_ptr(), name


def test_bf16_stops_at_the_head(problem, monkeypatch):
    """A bf16 model runs its convolutions in bf16 on float32 parameters; the
    head's exits are upcast and the loss (the seg logits included, at the
    default seg_dtype) runs in float32, with float32 gradients. No autocast
    region anywhere."""
    from tti_torch.train import losses as tlo

    _, images, targets = _port(problem)
    model = build_model("n", 2, 2, "subpixel", torch.bfloat16, "cpu", init=CKPT)
    seen = []
    real = tlo._seg_per_anchor
    monkeypatch.setattr(tlo, "_seg_per_anchor",
                        lambda c, a, p, *r: seen.append((c.dtype, p.dtype)) or real(c, a, p, *r))
    raw = model(images)
    assert raw.box[0].dtype == raw.protos.dtype == torch.bfloat16
    step = tstep.TrainStep((IMGSZ, IMGSZ), seg_class_gains=GAINS)
    total, losses = step.loss(model, images, targets)
    assert total.dtype == torch.float32 and all(v.dtype == torch.float32 for v in losses.values())
    assert seen and all(d == (torch.float32, torch.float32) for d in seen)
    total.backward()
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in model.parameters())
    assert not torch.is_autocast_enabled()


SWITCH_VALUES = [None, "", "bf16", "BF16", " bf16", "f32", "fp32", "float32", "F32", "0", "16",
                 "x"]


@pytest.mark.parametrize("value", SWITCH_VALUES)
def test_train_switches_parse_as_tti(value, monkeypatch):
    """Each of tti's trainer switches, fallbacks included, selects what
    tti's own readers select: ``TTI_SEG_DTYPE`` (tti's
    ``_seg_storage_dtype``), ``TTI_AUGMENT_DTYPE`` (``_image_dtype``, under
    either default) and ``TTI_SEG_CHUNK`` (an integer, 0 unchunked, as
    ``seg_loss`` reads it)."""
    from tti.train import augment as jaug
    from tti.train import losses as jlosses

    to_torch = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for name in ("TTI_SEG_DTYPE", "TTI_AUGMENT_DTYPE", "TTI_SEG_CHUNK"):
        monkeypatch.delenv(name, raising=False)
        if value is not None:
            monkeypatch.setenv(name, value)
    if value is not None and value.strip().isdigit():
        assert train_switches(os.environ)["seg_chunk"] == int(value)
    elif value is not None:
        with pytest.raises(ValueError):  # tti's int() raises on the same values
            train_switches(os.environ)
        monkeypatch.delenv("TTI_SEG_CHUNK")
    sw = train_switches(os.environ)
    assert sw["seg_dtype"] == to_torch[jlosses._seg_storage_dtype()]
    for default in (torch.bfloat16, torch.float32):
        jdefault = jnp.bfloat16 if default == torch.bfloat16 else jnp.float32
        assert (sw["augment_dtype"] or default) == to_torch[jaug._image_dtype(default=jdefault)]


@pytest.mark.parametrize("env,chunks,seg_dtype,image_dtype", [
    ({}, 1, torch.float32, torch.bfloat16),
    ({"TTI_SEG_CHUNK": "16", "TTI_SEG_DTYPE": "bf16"}, 5, torch.bfloat16, torch.bfloat16),
    ({"TTI_SEG_CHUNK": "0", "TTI_AUGMENT_DTYPE": "f32"}, 1, torch.float32, torch.float32),
], ids=["unset", "chunk16_bf16", "unchunked_f32"])
def test_train_builds_its_step_and_augment_under_the_switches(problem, env, chunks, seg_dtype,
                                                              image_dtype, monkeypatch):
    """``step_and_augment`` (what ``build_trainer`` and so ``train`` run)
    applies the switches: the seg loss's chunks (80 anchors at this batch:
    five chunks of 16) and storage dtype, and the augment's image dtype for
    a bf16 run."""
    from tti_torch.train import losses as tlo
    from tti_torch.train.augment import build_device_dataset, step_generator

    for name in ("TTI_SEG_DTYPE", "TTI_AUGMENT_DTYPE", "TTI_SEG_CHUNK"):
        monkeypatch.delenv(name, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    step, augment = step_and_augment(IMGSZ, 2, MAX_GT, torch.bfloat16, GAINS)
    seen = []
    real = tlo._seg_per_anchor
    monkeypatch.setattr(tlo, "_seg_per_anchor",
                        lambda c, *r: seen.append((c.shape[1], r[-1])) or real(c, *r))
    model, images, targets = _port(problem)
    step.loss(model, images, targets)
    assert len(seen) == chunks and all(d == seg_dtype for _, d in seen)
    data = build_device_dataset(textile_samples(4, IMGSZ, seed=5), IMGSZ, MAX_GT, mask_stride=2,
                                device="cpu")
    assert augment(data, step_generator(0, 1, "cpu"))[0].dtype == image_dtype
