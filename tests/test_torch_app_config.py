"""The port's configuration tree and calibration writers against tti's: the
same environment mapping and .env file give equal ``asdict`` trees, the
same invalid settings raise the same ConfigError messages, and the
calibration files are byte-equal."""

import dataclasses

import numpy as np
import pytest

import tti.calib.io as jio
import tti.core.config as jcfg
import tti.core.errors as jerr
import tti_torch.calib.io as tio
import tti_torch.core.config as tcfg
import tti_torch.core.errors as terr

ENVS = {
    "defaults": ({}, ""),
    "deploy": ({"TTI_WEIGHTS": "checkpoints/yolov8n_textile_cam.msgpack", "TTI_IMAGE_SIZE": "960",
                "TTI_MASK_STRIDE": "2", "TTI_PROTO_HEAD": "subpixel", "TTI_DTYPE": "float32",
                "TTI_SUBCELL_EDGE": "1", "TTI_SUBCELL_ENVELOPE": "off", "CONF_THRESH": "0.3",
                "MAX_DETECTIONS": "100", "CALIB_W": "640", "CALIB_H": "480",
                "ROI_Y_MIN": "100", "ROI_Y_MAX": "400"}, ""),
    "services": ({"DB_HOST": "db.local", "DB_USER": "u", "DB_PASSWORD": "p",
                  "DB_DATABASE": "d", "DB_TABLE": "line7", "MQTT_SERVER": "broker",
                  "MQTT_PORT": "1883", "MQTT_TLS_INSECURE": "no", "SERIAL_PORT": "/dev/ttyACM0",
                  "SEAM_LENGTH_OFFSET": "-1.1", "STITCH_WIDTH_OFFSET": "x",
                  "CAMERA_INDEX": "/dev/video2", "CAMERA_EXPOSURE": "4"}, ""),
    "dotenv": ({"TTI_SQLITE_PATH": "env_wins.db"},
               "# line config\nTTI_SQLITE_PATH=file_loses.db\nTTI_DB_BACKEND='sqlite'\n"
               "ROI_ENABLED=false\nCALIB_W = 800\nnot a pair\nMQTT_USERNAME=\"op\"\n"),
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_load_config_trees_equal(name, tmp_path):
    env, dotenv = ENVS[name]
    path = tmp_path / ".env"
    path.write_text(dotenv)
    got = tcfg.load_config(dotenv_path=str(path), env=env)
    want = jcfg.load_config(dotenv_path=str(path), env=env)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.mqtt.topic == want.mqtt.topic
    assert got.measure.envelope_subcell == want.measure.envelope_subcell
    assert tcfg.load_dotenv_file(str(path)) == jcfg.load_dotenv_file(str(path))


@pytest.mark.parametrize("env", [
    {"ROI_Y_MIN": "500", "ROI_Y_MAX": "400"},
    {"CALIB_W": "320", "CALIB_H": "240"},  # default ROI outside a small frame
    {"ROI_X_MAX": "2000"},
    {"DB_HOST": "db.local", "DB_USER": "u"},
    {"TTI_DB_BACKEND": "mysql"},
])
def test_config_errors_equal(env):
    with pytest.raises(jerr.ConfigError) as want:
        jcfg.load_config(dotenv_path=None, env=env)
    with pytest.raises(terr.ConfigError) as got:
        tcfg.load_config(dotenv_path=None, env=env)
    assert str(got.value) == str(want.value)
    # Unvalidated, both trees still build and agree.
    assert dataclasses.asdict(tcfg.load_config(dotenv_path=None, env=env, validate=False)) == \
        dataclasses.asdict(jcfg.load_config(dotenv_path=None, env=env, validate=False))


def test_calibration_files_byte_equal(tmp_path, ref_intrinsics, ref_extrinsics):
    K, dist = ref_intrinsics
    rvec, tvec = ref_extrinsics
    for mod, tag in ((tio, "port"), (jio, "tti")):
        mod.save_intrinsics(K, dist, str(tmp_path / f"{tag}_k.json"), image_size=(1280, 960),
                            rms=0.31)
        mod.save_intrinsics(K, dist, str(tmp_path / f"{tag}_k_bare.json"))
        mod.save_extrinsics(rvec, tvec, str(tmp_path / f"{tag}_e.json"))
    for stem in ("k", "k_bare", "e"):
        assert (tmp_path / f"port_{stem}.json").read_bytes() == \
            (tmp_path / f"tti_{stem}.json").read_bytes()
    got = tio.CalibrationData.load(str(tmp_path / "port_k.json"), str(tmp_path / "port_e.json"))
    np.testing.assert_array_equal(got.K, K)
    np.testing.assert_array_equal(got.dist, dist)
    np.testing.assert_array_equal(got.tvec, tvec)
    assert got.image_size == (1280, 960) and got.rms == 0.31
