"""The mask-statistics plain versions against tti's dense XLA contracts and
its Pallas kernels (interpret mode, as tests/test_kernels.py runs them).

Exactness: the "quantized" problems use protos k/128 (|k| <= 255) and
coefs j/64 (|j| <= 128), so every logit is an exact float32 multiple of
2^-13 whatever the summation order. Binary fields then match exactly, at
f32 logits and at the soft path's bf16 default; the soft float sums differ
only by summation order (1e-5 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tti.kernels import maskstats as jms
from tti_torch.kernels import maskstats as ms

BINARY = ("m00", "m10", "m01", "col_any", "bottom")
SOFT = BINARY + ("m00s", "m10s", "m01s", "bottom_sub", "col_p")


def _problem(seed, b=2, hm=24, wm=40, d=20, nm=32, quantized=True):
    rng = np.random.default_rng(seed)
    if quantized:
        protos = rng.integers(-255, 256, (b, hm, wm, nm)) / 128.0
        coefs = rng.integers(-128, 129, (b, d, nm)) / 64.0
    else:
        protos = rng.normal(size=(b, hm, wm, nm))
        coefs = rng.normal(size=(b, d, nm)) * 0.5
    x1 = rng.uniform(-3, wm - 4, (b, d))
    y1 = rng.uniform(-3, hm - 4, (b, d))
    boxes = np.stack([x1, y1, x1 + rng.uniform(2, wm / 2, (b, d)),
                      y1 + rng.uniform(2, hm / 2, (b, d))], -1)
    boxes[:, 0] = [-1.0, -2.0, wm + 2.0, hm + 3.0]  # whole grid
    boxes[:, 1] = [2.5, hm - 7.5, wm / 2, hm]  # reaches y2 == Hm
    valid = rng.uniform(size=(b, d)) > 0.25
    valid[:, :2] = True
    return (protos.astype(np.float32), coefs.astype(np.float32),
            boxes.astype(np.float32), valid)


def _torch(args):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)


def _per_frame(fn, args, **kw):
    """Run a single-frame tti function over the batch, stacked."""
    outs = [fn(*(jnp.asarray(a[i]) for a in args), **kw) for i in range(args[0].shape[0])]
    return {k: np.stack([np.asarray(o[k]) for o in outs]) for k in outs[0]}


def _compare(got, ref, keys, exact, rtol=1e-5):
    for key in keys:
        a, r = got[key].numpy(), np.asarray(ref[key])
        assert a.shape == r.shape, key
        if key in exact:
            np.testing.assert_array_equal(a, r, err_msg=key)
        else:
            np.testing.assert_allclose(a, r, rtol=rtol, atol=rtol, err_msg=key)


@pytest.mark.parametrize("seed", [0, 1])
def test_binary_plain_matches_xla_exactly(seed):
    args = _problem(seed)
    got = ms.mask_stats_binary_plain(*_torch(args))
    _compare(got, _per_frame(jms.instance_mask_stats_xla, args), BINARY, BINARY)


@pytest.mark.parametrize("logits", ["f32", "bf16"])
def test_soft_plain_matches_xla(logits, monkeypatch):
    """f32 logits pinned on the reference side, or its bf16 default."""
    if logits == "f32":
        monkeypatch.setenv("TTI_MASKSTATS_LOGITS", "f32")
    else:
        monkeypatch.delenv("TTI_MASKSTATS_LOGITS", raising=False)
    args = _problem(2)
    dtype = torch.float32 if logits == "f32" else torch.bfloat16
    got = ms.mask_stats_soft_plain(*_torch(args), logits_dtype=dtype)
    _compare(got, _per_frame(jms.instance_mask_stats_soft_xla, args), SOFT, BINARY)


def test_plain_matches_xla_on_gaussian_inputs(monkeypatch):
    """Unquantized inputs: logits agree to float32 rounding, so the same
    tolerance as tests/test_kernels.py (1e-3) holds, plus 1e-5 relative for
    probability sums in the thousands (summation order)."""
    monkeypatch.setenv("TTI_MASKSTATS_LOGITS", "f32")
    args = _problem(3, quantized=False)
    ref_b = _per_frame(jms.instance_mask_stats_xla, args)
    ref_s = _per_frame(jms.instance_mask_stats_soft_xla, args)
    got_b = ms.mask_stats_binary_plain(*_torch(args))
    got_s = ms.mask_stats_soft_plain(*_torch(args), logits_dtype=torch.float32)
    for got, ref, keys in ((got_b, ref_b, BINARY), (got_s, ref_s, SOFT)):
        for key in keys:
            np.testing.assert_allclose(got[key].numpy(), ref[key], rtol=1e-5, atol=1e-3,
                                       err_msg=key)


def test_plain_matches_pallas_interpret(monkeypatch):
    """Against the TPU kernels themselves (rows 1-6 of the kernel table):
    v2 binary and soft, batched grids, and v1 at D > 128."""
    monkeypatch.setenv("TTI_MASKSTATS_LOGITS", "f32")
    args = _problem(4, d=24)
    jargs = tuple(jnp.asarray(a) for a in args)
    got_b = ms.mask_stats_binary_plain(*_torch(args))
    got_s = ms.mask_stats_soft_plain(*_torch(args), logits_dtype=torch.float32)
    _compare(got_b, jms.instance_mask_stats_pallas2_batched(*jargs, interpret=True),
             BINARY, BINARY)
    _compare(got_s, jms.instance_mask_stats_soft_pallas2_batched(*jargs, interpret=True),
             SOFT, BINARY)
    _compare(got_b, jms.instance_mask_stats_pallas_batched(*jargs, interpret=True),
             BINARY, BINARY)
    one = tuple(a[:1] for a in args)
    _compare({k: v[0] for k, v in ms.mask_stats_soft_plain(
        *_torch(one), logits_dtype=torch.float32).items()},
        jms.instance_mask_stats_soft_pallas2(*(jnp.asarray(a[0]) for a in one), interpret=True),
        SOFT, BINARY)
    big = _problem(5, b=1, hm=16, wm=24, d=140)  # the v1 contract: no D cap
    _compare({k: v[0] for k, v in ms.mask_stats_binary_plain(*_torch(big)).items()},
             jms.instance_mask_stats_pallas(*(jnp.asarray(a[0]) for a in big), interpret=True),
             BINARY, BINARY)


def test_edge_cases_match_reference(monkeypatch):
    """All rows invalid; every cell positive in a box reaching y2 == Hm,
    so the bottom is the last row and p_below = 0."""
    monkeypatch.delenv("TTI_MASKSTATS_LOGITS", raising=False)
    protos, coefs, boxes, valid = _problem(6)
    for fn, ref_fn in ((ms.mask_stats_binary_plain, jms.instance_mask_stats_xla),
                       (ms.mask_stats_soft_plain, jms.instance_mask_stats_soft_xla)):
        args = (protos, coefs, boxes, np.zeros_like(valid))
        out = fn(*_torch(args))
        assert float(out["m00"].abs().sum()) == 0.0 and bool((out["bottom"] == -1).all())
        if "bottom_sub" in out:  # zeroed coefficients would give p = 0.5 here
            assert float(out["m00s"].sum()) == 0.0 and bool((out["bottom_sub"] == -1).all())
            assert float(out["col_p"].sum()) == 0.0
        _compare(out, _per_frame(ref_fn, args), out.keys(), BINARY)
        hm = protos.shape[1]
        full = np.broadcast_to(np.array([0, hm - 6, 40, hm], np.float32), boxes.shape).copy()
        args = (np.ones_like(protos) / 128, np.ones_like(coefs) / 64, full, np.ones_like(valid))
        out = fn(*_torch(args))
        assert bool((out["bottom"] == hm - 1).all())
        _compare(out, _per_frame(ref_fn, args), out.keys(), BINARY)


def test_wrappers_take_plain_version_on_cpu_only():
    args = _torch(_problem(7))
    before = dict(ms.LAUNCHES)
    for kernel, plain in ((ms.mask_stats_soft, ms.mask_stats_soft_plain),
                          (ms.mask_stats_binary, ms.mask_stats_binary_plain)):
        got, ref = kernel(*args), plain(*args)
        assert sorted(got) == sorted(ref)
        for key in ref:
            assert torch.equal(got[key], ref[key])
    assert ms.LAUNCHES == before  # a plain-version call is not a launch
    with pytest.raises(ValueError, match="cpu or cuda"):
        ms.mask_stats_binary(*(a.to("meta") for a in args))


def test_subcell_col_extent_matches():
    rng = np.random.default_rng(8)
    col_p = rng.uniform(0, 1, (3, 5, 40)).astype(np.float32)
    col_p[0, 0] = 0.2  # no occupied column: argmax fallbacks
    col_p[1, 1, 0] = 0.9  # occupied first / last columns
    col_p[1, 1, -1] = 0.9
    got = ms.subcell_col_extent(torch.from_numpy(col_p))
    ref = jms.subcell_col_extent(jnp.asarray(col_p))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-6)


CHUNKS = [1, 2, 3, 4, 8, "Hm"]
CARRY_HM, CARRY_WM = 48, 40
CARRY_CASES = ("next_chunk", "box_last_row", "grid_last_row", "chunk_outside", "one_row",
               "all_invalid", "nan_box")


def _chunked(soft, args, chunk, **kw):
    hm = args[0].shape[1]
    return ms.mask_stats_chunked_plain(soft, *_torch(args), chunk=hm if chunk == "Hm" else chunk,
                                       **kw)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("soft", [False, True], ids=["binary", "soft"])
def test_chunked_matches_plain(soft, chunk):
    """The kernels' decomposition (chunk partials, ordered combine, strip
    moments) on random boxes, some over the whole grid or reaching y2 == Hm.
    Quantized inputs: binary fields exact, soft sums within 1e-5."""
    args = _problem(10, hm=26, wm=70, d=12)
    plain = ms.mask_stats_soft_plain if soft else ms.mask_stats_binary_plain
    got, ref = _chunked(soft, args, chunk, strip=32), plain(*_torch(args))
    _compare(got, {k: v.numpy() for k, v in ref.items()}, ref.keys(), BINARY)


def _carry_case(name):
    """One frame, two detections on a 48x40 grid. Detection 0 reads channel
    0, a row profile that is +1 down to row ``r`` and -0.5 under it, plus a
    small per-cell term (channel 1) so that p differs from column to column;
    its box makes the named case. Row 23 ends a chunk of 1, 2, 3, 4 and 8 rows.
    Detection 1 is a random box with random coefficients."""
    rng = np.random.default_rng(11)
    hm, wm = CARRY_HM, CARRY_WM
    r = {"grid_last_row": hm - 1, "chunk_outside": 28}.get(name, 23)
    y12 = {"next_chunk": (-1.0, hm + 2.0), "box_last_row": (2.5, 24.0),
           "grid_last_row": (5.0, hm + 2.0), "chunk_outside": (26.5, 30.2),
           "one_row": (23.0, 24.0)}.get(name, (-1.0, hm + 2.0))
    protos = rng.integers(-255, 256, (1, hm, wm, 32)) / 128.0
    protos[0, :, :, 0] = np.where(np.arange(hm) <= r, 1.0, -0.5)[:, None]
    protos[0, :, :, 1] = rng.integers(-8, 9, (hm, wm)) / 128.0
    coefs = rng.integers(-128, 129, (1, 2, 32)) / 64.0
    coefs[0, 0] = 0.0
    coefs[0, 0, :2] = 1.0
    boxes = np.array([[[3.5, y12[0], 36.0, y12[1]], [10.2, 7.7, 30.0, 41.5]]])
    if name == "nan_box":
        boxes[0, 0, 0] = np.nan
    valid = np.full((1, 2), name != "all_invalid")
    return (protos.astype(np.float32), coefs.astype(np.float32), boxes.astype(np.float32),
            valid), r


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", CARRY_CASES)
@pytest.mark.parametrize("soft", [False, True], ids=["binary", "soft"])
def test_chunked_carries(soft, case, chunk):
    """The carries across chunks: a bottom on a chunk's last row (p_below is
    the next chunk's first row), on the last row of the box or of the grid
    (p_below = 0), a box inside one chunk, a one-row box, invalid rows and a
    NaN box (empty). Binary fields exact, soft within 1e-5."""
    args, r = _carry_case(case)
    plain = ms.mask_stats_soft_plain if soft else ms.mask_stats_binary_plain
    got, ref = _chunked(soft, args, chunk), plain(*_torch(args))
    _compare(got, {k: v.numpy() for k, v in ref.items()}, ref.keys(), BINARY)
    inside = slice(4, 36)  # the columns of detection 0's box
    bottom = got["bottom"][0, 0]
    if case in ("all_invalid", "nan_box"):
        assert bool((bottom == -1).all()) and float(got["m00"][0, 0]) == 0.0
        return
    assert bool((bottom[inside] == r).all()) and bool((bottom[:4] == -1).all())
    if soft:
        frac = got["bottom_sub"][0, 0, inside] - r
        if case == "next_chunk":  # the row under the bottom is read: 0 < frac < 1
            assert bool(((frac > 0.5) & (frac < 0.99)).all())
        elif case != "chunk_outside":  # nothing under the bottom: frac = (p_b - 0.5) / p_b
            p_b = torch.sigmoid(torch.from_numpy(args[0][0, r, inside, :2].sum(-1)).to(
                torch.bfloat16).float())
            np.testing.assert_allclose(frac.numpy(), ((p_b - 0.5) / p_b).numpy(), atol=1e-5)


@pytest.mark.parametrize("soft", [False, True], ids=["binary", "soft"])
def test_chunked_matches_xla(soft, monkeypatch):
    """The decomposition at the kernels' own tiling against tti's contract."""
    monkeypatch.delenv("TTI_MASKSTATS_LOGITS", raising=False)
    args = _problem(12, hm=26, wm=70, d=12)
    ref_fn = jms.instance_mask_stats_soft_xla if soft else jms.instance_mask_stats_xla
    got = ms.mask_stats_chunked_plain(soft, *_torch(args))
    _compare(got, _per_frame(ref_fn, args), SOFT if soft else BINARY, BINARY)


def test_blocks_per_frame_and_tiling():
    assert ms.STRIP_COLS == 32
    assert ms.CHUNK_ROWS == {"mask_stats_soft": 4, "mask_stats_binary": 2}
    assert ms.blocks_per_frame(128, 480) == 23 and ms.blocks_per_frame(128, 160) == 16
    assert ms.blocks_per_frame(1, 160) == 128 and ms.blocks_per_frame(4096, 33) == 10


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run python3 chip_smoke.py on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("soft", [True, False])
def test_kernel_matches_plain_on_card(cuda_device, soft):
    """Quantized inputs: binary fields exact, soft sums within 1e-5."""
    args = tuple(t.to(cuda_device) for t in _torch(_problem(9, b=3, hm=48, wm=80, d=150)))
    args = (args[0].to(torch.bfloat16),) + args[1:]
    kernel = ms.mask_stats_soft if soft else ms.mask_stats_binary
    plain = ms.mask_stats_soft_plain if soft else ms.mask_stats_binary_plain
    before = ms.LAUNCHES["mask_stats_soft" if soft else "mask_stats_binary"]
    got, ref = kernel(*args), plain(*args)
    assert ms.LAUNCHES["mask_stats_soft" if soft else "mask_stats_binary"] == before + 1
    _compare({k: v.cpu() for k, v in got.items()}, {k: v.cpu() for k, v in ref.items()},
             ref.keys(), BINARY)
