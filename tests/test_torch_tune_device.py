"""``tools/tune_device_torch.py`` and the port's ``tune-device`` against
``tti``'s ``tools/tune_device.py`` and ``tti tune-device``: ``tti``'s three
tune tests ported (one baseline trial end to end, leaving no gate in the
environment; canned results through both tools giving the same ``.env``
lines apart from the header; a failed trial reported, not raised), the rows
of the trials that cannot run here, and the argv the two command lines hand
their tools."""

import json
import os

import pytest

import tools.tune_device as tti_td
import tools.tune_device_torch as td
from tti_torch.core.config import APPROX_TOPK_REFUSAL, NO_COUNTERPART

SMALL = ["--imgsz", "64", "--frame-h", "96", "--frame-w", "128", "--device", "cpu"]


def test_tune_device_baseline_trial(tmp_path, monkeypatch):
    monkeypatch.setenv("TTI_WARP_BLOCKED", "16")  # the caller's env must not leak into trials
    out = str(tmp_path / "tune.env")
    td.main(["--batches", "2", *SMALL, "--iters", "2", "--lat-iters", "2",
             "--trials", "baseline", "--out", out])
    text = open(out).read()
    assert "throughput winner at batch 2: baseline" in text
    assert "platform=cpu" in text.splitlines()[1]
    rows = json.load(open(out + ".json"))
    assert len(rows) == 1 and rows[0]["error"] is None
    assert rows[0]["fps"] > 0 and rows[0]["p50_ms"] >= 0 and rows[0]["compile_s"] > 0
    for g in td.GATES:  # every trial resets every gate
        assert g not in os.environ


CANNED = {
    ("baseline", 1): (100.0, 30.0),
    ("baseline", 16): (400.0, 40.0),
    ("baseline", 128): (1600.0, 50.0),
    ("warp_blocked=64", 1): (290.0, 20.0),
    ("warp_blocked=64", 16): (380.0, 25.0),
    ("warp_blocked=64", 128): (1300.0, 45.0),
    ("warp_s2d=0", 1): (120.0, 35.0),
    ("warp_s2d=0", 16): (410.0, 41.0),
    ("warp_s2d=0", 128): (1650.0, 52.0),
    ("quant=int8", 1): (130.0, 10.0),
    ("quant=int8", 16): (500.0, 20.0),
    ("quant=int8", 128): (2000.0, 30.0),
}


@pytest.mark.parametrize("extra", [[], ["--allow-approx"]], ids=["exact", "allow_approx"])
@pytest.mark.parametrize("trials", ["baseline,warp_blocked=64",
                                    "baseline,warp_blocked=64,warp_s2d=0,quant=int8"])
def test_canned_results_write_tti_env_lines(tmp_path, monkeypatch, trials, extra):
    """The same trial results through both tools' ``main``: the ``.env``
    lines equal apart from the two header lines (the time, the platform),
    and the ``.json`` rows equal."""
    def fake(module):
        def trial(name, env, batch, *a, **k):
            fps, p50 = CANNED[(name, batch)]
            return module.TrialResult(name, batch, fps, p50, 0.0)
        return trial

    monkeypatch.setattr(tti_td, "run_trial", fake(tti_td))
    monkeypatch.setattr(td, "run_trial", fake(td))
    argv = ["--batches", "1,16,128", "--trials", trials, *extra]
    tti_td.main(argv + ["--out", str(tmp_path / "tti.env")])
    td.main(argv + ["--out", str(tmp_path / "port.env"), "--device", "cpu"])
    ref = open(tmp_path / "tti.env").read().splitlines()
    got = open(tmp_path / "port.env").read().splitlines()
    assert len(got) > 3 and got[2:] == ref[2:]
    assert all(x[0].startswith("# tti device tune — ") for x in (got, ref))
    assert got[1].rsplit("platform=", 1)[0] == ref[1].rsplit("platform=", 1)[0]
    rows = [json.load(open(tmp_path / f"{side}.env.json")) for side in ("port", "tti")]
    assert rows[0] == rows[1]
    if trials.endswith("quant=int8"):
        winner = "quant=int8" if extra else "warp_s2d=0"
        assert f"throughput winner at batch 128: {winner}" in got[2]
    else:
        assert "crossover inside (1, 16)" in got[-1]


def test_tune_device_failed_trial_reported(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("unsupported on this toolchain")

    monkeypatch.setattr(td, "build_pipeline", boom)
    out = str(tmp_path / "tune.env")
    td.main(["--batches", "2", *SMALL, "--trials", "baseline,warp_s2d=0", "--out", out])
    rows = json.load(open(out + ".json"))
    assert len(rows) == 2 and all(r["error"] == "RuntimeError: unsupported on this toolchain"
                                  for r in rows)  # every trial failed, none crashed
    assert os.path.exists(out)  # the report is still written
    for g in td.GATES:
        assert g not in os.environ


def test_every_tti_trial_has_a_row(tmp_path):
    """The port keeps every one of tti's trial names, in tti's order (plus
    ``quant=int8s`` with ``--int8-scales``, as tti); the trials it cannot
    run report why: ``TTI_MASKSTATS`` has no counterpart, ``TTI_APPROX_TOPK``
    is refused with the CLI's words. Neither sets or leaves a gate."""
    assert [n for n, _ in td.TRIALS] == [n for n, _ in tti_td.TRIALS]
    assert td.EXACT_TRIALS == tti_td.EXACT_TRIALS
    out = str(tmp_path / "tune.env")
    td.main(["--batches", "1", *SMALL, "--iters", "1", "--lat-iters", "1", "--out", out,
             "--trials", "maskstats=pallas_batched,maskstats=pallas2,approx_topk=1"])
    rows = {r["name"]: r for r in json.load(open(out + ".json"))}
    assert list(rows) == ["maskstats=pallas_batched", "maskstats=pallas2", "approx_topk=1"]
    for name in ("maskstats=pallas_batched", "maskstats=pallas2"):
        assert rows[name]["error"] == ("TTI_MASKSTATS has no counterpart in tti_torch: "
                                       + NO_COUNTERPART["TTI_MASKSTATS"])
    assert rows["approx_topk=1"]["error"] == f"ConfigError: {APPROX_TOPK_REFUSAL}"
    assert all(r["fps"] == 0.0 for r in rows.values())
    assert "winner" not in open(out).read()
    for g in (*td.GATES, "TTI_MASKSTATS"):
        assert g not in os.environ


@pytest.mark.parametrize("argv", [
    [],
    ["--batches", "1,32", "--imgsz", "320", "--frame-h", "480", "--frame-w", "640",
     "--mask-stride", "2", "--proto-head", "subpixel", "--dtype", "float32", "--iters", "5",
     "--trials", "baseline,quant=int8s", "--allow-approx", "--subcell",
     "--int8-scales", "s.json", "--out", "x.env"],
])
def test_cli_hands_the_tool_tti_argv(argv, monkeypatch):
    """``python -m tti_torch.cli tune-device`` hands its tool the argv that
    ``tti tune-device`` hands ``tools/tune_device.py``, then ``--device``;
    ``--lat-iters`` (the tool's flag, which tti's command line lacks) only
    when given."""
    from tti.cli.__main__ import main as tti_main
    from tti_torch.cli.__main__ import main as port_main

    seen = {}
    monkeypatch.setattr(tti_td, "main", lambda a: seen.__setitem__("tti", a))
    monkeypatch.setattr(td, "main", lambda a: seen.__setitem__("port", a))
    assert tti_main(["tune-device", *argv]) == 0
    assert port_main(["tune-device", *argv, "--device", "cpu"]) == 0
    assert seen["port"] == seen["tti"] + ["--device", "cpu"]
    assert port_main(["tune-device", *argv, "--lat-iters", "5"]) == 0
    assert seen["port"] == seen["tti"] + ["--lat-iters", "5", "--device", "cuda"]
