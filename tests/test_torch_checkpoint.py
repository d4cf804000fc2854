"""The port's checkpoint reader, weight transforms and config against tti.

Same checkpoints, same numpy trees: the pure-Python msgpack decoder must
give bit-identical leaves to flax.serialization, and the copied transforms
(stem_to_s2d, fold_batchnorm) bit-identical outputs to tti.model.convert.
"""

import math

import numpy as np
import pytest
from flax import serialization

from tti.core.config import MeasureConfig as JaxMeasureConfig
from tti.model import convert as jconvert
from tti_torch.core.config import MeasureConfig, ModelConfig
from tti_torch.core.errors import ConfigError
from tti_torch.model import checkpoint as ck

CHECKPOINTS = ["checkpoints/yolov8n_textile.msgpack", "checkpoints/yolov8n_textile_cam.msgpack"]


def _flax_tree(path):
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


def _assert_trees_equal(a, b, where=""):
    assert isinstance(a, dict) and isinstance(b, dict), where
    assert sorted(a) == sorted(b), (where, sorted(a), sorted(b))
    for key in a:
        if isinstance(a[key], dict):
            _assert_trees_equal(a[key], b[key], f"{where}/{key}")
        else:
            x, y = np.asarray(a[key]), np.asarray(b[key])
            assert x.dtype == y.dtype and x.shape == y.shape, f"{where}/{key}"
            np.testing.assert_array_equal(x, y, err_msg=f"{where}/{key}")


@pytest.mark.parametrize("path", CHECKPOINTS)
def test_msgpack_decoder_matches_flax(path):
    _assert_trees_equal(ck.load_flax_msgpack(path), _flax_tree(path))


def test_msgpack_decoder_scalars_and_containers(tmp_path):
    """Every msgpack type flax writes, through flax's own encoder."""
    tree = {"a": {"b": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "c": np.array([1, -2], np.int64)},
            "s": np.float32(2.5), "n": -7, "big": 2 ** 40, "x": 0.25, "t": True,
            "name": "é" * 40, "empty": {}}
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.to_bytes(tree))
    got = ck.load_flax_msgpack(str(path))
    ref = serialization.msgpack_restore(path.read_bytes())
    for key in ("n", "big", "x", "t", "name", "empty"):
        assert got[key] == ref[key]
    np.testing.assert_array_equal(got["s"], ref["s"])
    _assert_trees_equal(got["a"], ref["a"])


@pytest.mark.parametrize("path", CHECKPOINTS)
def test_stem_to_s2d_and_fold_match_tti(path):
    tree = ck.load_flax_msgpack(path)
    ref = _flax_tree(path)
    _assert_trees_equal(ck.stem_to_s2d(tree), jconvert.stem_to_s2d(ref))
    _assert_trees_equal(ck.fold_batchnorm(ck.stem_to_s2d(tree)),
                        jconvert.fold_batchnorm(jconvert.stem_to_s2d(ref)))


def test_from_flax_variables_names_and_layouts():
    tree = ck.fold_batchnorm(ck.stem_to_s2d(ck.load_flax_msgpack(CHECKPOINTS[1])))
    sd = ck.from_flax_variables(tree)
    params = tree["params"]
    k = params["m1"]["conv"]["kernel"]  # (kH, kW, I, O)
    np.testing.assert_array_equal(sd["m1.conv.weight"], k.transpose(3, 2, 0, 1))
    # Transposed conv: (kH, kW, I, O) -> (I, O, kH, kW), both spatial axes flipped.
    up = params["m22"]["proto"]["upsample"]["kernel"]
    np.testing.assert_array_equal(sd["m22.proto.upsample.weight"][:, :, 0, 1], up[1, 0])
    assert "m22.proto.cv3sp.conv.bias" in sd and "m0s2d.conv.weight" in sd
    # An unfolded tree maps with its batch_stats (the training-form model);
    # its params alone do not.
    unfolded = ck.load_flax_msgpack(CHECKPOINTS[0])
    sd = ck.from_flax_variables(unfolded)
    np.testing.assert_array_equal(sd["m1.bn.running_var"],
                                  unfolded["batch_stats"]["m1"]["bn"]["var"])
    np.testing.assert_array_equal(sd["m1.bn.weight"], unfolded["params"]["m1"]["bn"]["scale"])
    with pytest.raises(ValueError, match="fold_batchnorm"):
        ck.from_flax_variables({"params": unfolded["params"]})


@pytest.mark.parametrize("path", CHECKPOINTS)
def test_sidecar_resolution_matches_tti(path, monkeypatch):
    monkeypatch.delenv("TTI_READOUT_CAL", raising=False)
    meta = ck.checkpoint_metadata(path)
    assert meta == jconvert.checkpoint_metadata(path)
    got = MeasureConfig().with_subcell_from(meta)
    ref = JaxMeasureConfig().with_subcell_from(meta)
    for key in ("subcell_edge", "subcell_envelope", "cal_edge_mm", "cal_width_mm"):
        assert getattr(got, key) == getattr(ref, key), key
    assert got.envelope_subcell == ref.envelope_subcell
    pinned = MeasureConfig(cal_edge_mm=0.5, subcell_edge=False).with_subcell_from(meta)
    assert pinned.cal_edge_mm == 0.5 and pinned.subcell_edge is False


@pytest.mark.parametrize("value", ["0", "off", " OFF ", "false", "No", "1", "on", "", None])
@pytest.mark.parametrize("explicit", [{}, {"cal_edge_mm": 0.5, "cal_width_mm": -0.25}],
                         ids=["sidecar", "explicit"])
def test_readout_cal_switch_matches_tti(value, explicit, monkeypatch):
    """``TTI_READOUT_CAL`` set to 0, false, no or off (case and whitespace
    ignored) drops both offsets, explicit ones included; any other value, or
    none, keeps the sidecar's (0.1175 / 0.1606 mm on the deploy checkpoint)
    under explicit non-zero config."""
    if value is None:
        monkeypatch.delenv("TTI_READOUT_CAL", raising=False)
    else:
        monkeypatch.setenv("TTI_READOUT_CAL", value)
    meta = ck.checkpoint_metadata("checkpoints/yolov8n_textile_cam.msgpack")
    got = MeasureConfig(**explicit).with_subcell_from(meta)
    ref = JaxMeasureConfig(**explicit).with_subcell_from(meta)
    assert (got.cal_edge_mm, got.cal_width_mm) == (ref.cal_edge_mm, ref.cal_width_mm)
    off = value is not None and value.strip().lower() in ("0", "off", "false", "no")
    want = ((0.0, 0.0) if off else (0.5, -0.25) if explicit
            else (meta["cal_edge_mm"], meta["cal_width_mm"]))
    assert (got.cal_edge_mm, got.cal_width_mm) == want
    assert off or explicit or want == (0.1175, 0.1606)


@pytest.mark.parametrize("bad", [math.nan, math.inf, "nan"])
def test_nonfinite_readout_offsets_rejected(bad):
    with pytest.raises(ConfigError):
        MeasureConfig().with_subcell_from({"cal_edge_mm": bad})
    with pytest.raises(ConfigError):
        MeasureConfig(cal_width_mm=float(bad))


def test_model_config_validation():
    with pytest.raises(ValueError):
        ModelConfig(mask_stride=3)
    with pytest.raises(ValueError):
        ModelConfig(proto_head="x")
    assert ModelConfig().nms_pre_topk == 256 and ModelConfig().conf_thresh == 0.20
