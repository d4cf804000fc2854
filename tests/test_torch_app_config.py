"""The port's configuration tree and calibration writers against tti's: the
same environment mapping and .env file give equal ``asdict`` trees, the
same invalid settings raise the same ConfigError messages, and the
calibration files are byte-equal."""

import dataclasses
import logging

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


def _sections(cfg) -> dict:
    """The port's tree as ``asdict`` without ``switches``, the section the
    port adds (tti reads its runtime switches where it builds its step)."""
    tree = dataclasses.asdict(cfg)
    assert tree.pop("switches") == dataclasses.asdict(cfg.switches)
    return tree


@pytest.mark.parametrize("name", sorted(ENVS))
def test_load_config_trees_equal(name, tmp_path):
    env, dotenv = ENVS[name]
    path = tmp_path / ".env"
    path.write_text(dotenv)
    got = tcfg.load_config(dotenv_path=str(path), env=env)
    want = jcfg.load_config(dotenv_path=str(path), env=env)
    assert _sections(got) == dataclasses.asdict(want)
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
    assert _sections(tcfg.load_config(dotenv_path=None, env=env, validate=False)) == \
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


SWITCH_TABLE = [  # (environment, the fields it sets), as tti's runtime reads each name
    ({}, {}),
    ({"TTI_REMAP": "packed"}, {"remap": "packed"}),
    ({"TTI_WARP_S2D": "0"}, {"warp_s2d": False}),
    ({"TTI_WARP_S2D": "false"}, {}),  # only "0" turns it off
    ({"TTI_WARP_BLOCKED": "0"}, {}),  # "0": dense
    ({"TTI_WARP_BLOCKED": ""}, {}),
    ({"TTI_WARP_BLOCKED": "64"}, {"warp_block": 64}),
    ({"TTI_WARP_COLEXPAND": "1"}, {"warp_col_expand": True}),
    ({"TTI_WARP_COLEXPAND": "true"}, {}),  # only "1" turns it on
    ({"TTI_LAZY_DECODE": "1"}, {"lazy_decode": True}),
    ({"TTI_FUSED_HEAD": "1"}, {"fused_head": True}),
    ({"TTI_FOLDED_BN": "0"}, {"fold_bn": False}),
    ({"TTI_FOLDED_BN": "no"}, {}),
    ({"TTI_REMAP_U8_DECIMATE": "1"}, {"no_counterpart": ("TTI_REMAP_U8_DECIMATE",)}),
    ({"TTI_MASKSTATS_LOGITS": "f32"}, {"maskstats_logits": "f32"}),
    ({"TTI_MASKSTATS_LOGITS": "bf16"}, {"maskstats_logits": "bf16"}),
    ({"TTI_MASKSTATS_LOGITS": "fp32"}, {}),  # anything else: the dtype policy
    ({"TTI_APPROX_TOPK": "1"}, {"approx_topk": True}),
    ({"TTI_QUANT": "int8s"}, {"quant": "int8s"}),
    ({"TTI_INPUT_LAYOUT": "0", "TTI_MASKSTATS": "pallas2", "TTI_REMAP_SWAR": "0"},
     {"no_counterpart": ("TTI_INPUT_LAYOUT", "TTI_MASKSTATS", "TTI_REMAP_SWAR")}),
]


@pytest.mark.parametrize("env,fields", SWITCH_TABLE,
                         ids=[",".join(f"{k}={v}" for k, v in e.items()) or "defaults"
                              for e, _ in SWITCH_TABLE])
def test_runtime_switches_parse_as_tti(env, fields):
    want = dataclasses.replace(tcfg.RuntimeSwitches(), **fields)
    assert tcfg.RuntimeSwitches.from_env(env) == want
    assert tcfg.load_config(dotenv_path=None, env=env, validate=False).switches == want


def test_runtime_switches_from_dotenv_and_errors(tmp_path):
    """``.env`` sets the switches (the environment wins), and the
    pipeline's arguments are the switches that have one."""
    path = tmp_path / ".env"
    path.write_text("TTI_REMAP=packed\nTTI_LAZY_DECODE=1\nTTI_FOLDED_BN=0\n")
    cfg = tcfg.load_config(dotenv_path=str(path), env={"TTI_FOLDED_BN": "1"})
    assert cfg.switches.pipeline_kwargs() == dict(
        remap="packed", warp_s2d=True, warp_block=None, warp_col_expand=False, lazy_decode=True,
        fused_head=False, fold_bn=True, maskstats_logits="auto", quant="", quant_scales=None)
    with pytest.raises(terr.ConfigError, match="TTI_WARP_BLOCKED"):
        tcfg.RuntimeSwitches.from_env({"TTI_WARP_BLOCKED": "wide"})


@pytest.mark.parametrize("env,said", [
    ({"TTI_APPROX_TOPK": "1"}, "approximate top-k"),
    ({"TTI_QUANT": "int4"}, "TTI_QUANT must be"),
], ids=["approx_topk", "quant_other"])
def test_cli_refuses_switches(env, said, tmp_path, monkeypatch, capsys):
    from tti_torch.cli.__main__ import main as port_main

    monkeypatch.chdir(tmp_path)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert port_main(["run", "--synthetic", "--device", "cpu"]) == 1
    assert said in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_load_pipeline_builds_under_the_switches(tmp_path, monkeypatch):
    """``load_pipeline`` hands the switches to the pipeline and logs each
    set name that has no counterpart."""
    import tti_torch.cli.__main__ as cli
    from tti_torch.parallel import dcn
    import tti_torch.parallel.runtime as rt

    seen = []
    monkeypatch.setattr(rt, "InspectionPipeline", lambda *a, **kw: seen.append(kw))
    monkeypatch.setattr(cli, "_random_variables", lambda model_cfg: {})
    env = {"TTI_WARP_BLOCKED": "32", "TTI_FUSED_HEAD": "1", "TTI_MASKSTATS_LOGITS": "f32",
           "TTI_INPUT_LAYOUT": "0", "TTI_REMAP_SKIP_PAD_ROWS": "0",
           "TTI_WEIGHTS": str(tmp_path / "none.msgpack")}
    cfg = tcfg.load_config(dotenv_path=None, env=env, validate=False)
    logger, handler = logging.getLogger("tti_torch.cli"), _Records()
    logger.addHandler(handler)
    try:
        cli.load_pipeline(cfg, (96, 128), device="cpu")
    finally:
        logger.removeHandler(handler)
    assert seen[0]["warp_block"] == 32 and seen[0]["fused_head"] and \
        seen[0]["maskstats_logits"] == "f32" and seen[0]["fold_bn"]
    told = [m for m in handler.messages if "no counterpart" in m]
    assert len(told) == 2 and "TTI_INPUT_LAYOUT" in told[0] and "SKIP_PAD_ROWS" in told[1]


CLI_COMMANDS = {
    "calibrate": ["calibrate"],
    "calibrate-intrinsics": ["calibrate-intrinsics", "--images", "none"],
    "export-weights": ["export-weights", "--train-dir", "none", "--out", "x.msgpack"],
    "train": ["train", "--images", "none", "--device", "cpu"],
    "run": ["run", "--synthetic", "--device", "cpu"],
    "check-model": ["check-model", "--device", "cpu"],
    "eval": ["eval", "--images", "none", "--device", "cpu"],
    "convert": ["convert", "--pt", "none.pt", "--out", "x.msgpack"],
    "validate-reference": ["validate-reference", "--pt", "none.pt", "--device", "cpu"],
    "export": ["export", "--device", "cpu", "--platforms", "cpu"],
}


@pytest.mark.parametrize("command", sorted(CLI_COMMANDS))
def test_cli_refuses_multi_host(command, tmp_path, monkeypatch):
    """tti joins a multi-host job before every command when TTI_COORDINATOR
    is set (its init_distributed); so does the port, which once refused the
    triple: every command runs inside the job's process group (a one-process
    job on this host, gloo on the CPU), read as tti reads the triple, and
    the group is gone when the command returns. The other two alone start
    no group."""
    import torch.distributed as dist

    import tti_torch.cli.__main__ as cli
    from tti_torch.parallel import dcn

    seen = []
    monkeypatch.setattr(cli, "cmd_" + command.replace("-", "_"), lambda args: seen.append(
        (dist.is_initialized() and (dist.get_world_size(), dist.get_rank(),
                                    dist.get_backend()))) or 0)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TTI_NUM_PROCESSES", "1")
    monkeypatch.setenv("TTI_PROCESS_ID", "0")
    assert cli.main(CLI_COMMANDS[command]) == 0
    assert seen == [False] and not dist.is_initialized()
    monkeypatch.setenv("TTI_COORDINATOR", dcn.free_local_coordinator())
    assert cli.main(CLI_COMMANDS[command]) == 0
    assert seen[1] == (1, 0, "gloo") and not dist.is_initialized()
    assert not any(tmp_path.iterdir())
    assert tcfg.check_process_switches({"TTI_COORDINATOR": "h:1"}) == ()
    assert tcfg.check_process_switches({"TTI_NUM_PROCESSES": "2", "TTI_PROCESS_ID": "1"}) == ()


def test_cli_logs_the_compilation_cache_dir(tmp_path, monkeypatch):
    """TTI_JAX_CACHE_DIR (tti's XLA compilation cache, read before every
    command) is logged as having no counterpart, once, and not again by the
    step's own switches."""
    from tti_torch.cli.__main__ import main as port_main

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TTI_JAX_CACHE_DIR", str(tmp_path / "cache"))
    logger, handler = logging.getLogger("tti_torch.cli"), _Records()
    logger.addHandler(handler)
    try:
        assert port_main(["convert", "--pt", "none.pt", "--out", "x.msgpack"]) != 0
    except FileNotFoundError:
        pass
    finally:
        logger.removeHandler(handler)
    told = [m for m in handler.messages if "no counterpart" in m]
    assert len(told) == 1 and "TTI_JAX_CACHE_DIR" in told[0]
    assert "TTI_JAX_CACHE_DIR" in tcfg.NO_COUNTERPART
    assert tcfg.RuntimeSwitches.from_env({"TTI_JAX_CACHE_DIR": "d"}).no_counterpart == ()
    assert not (tmp_path / "cache").exists()
