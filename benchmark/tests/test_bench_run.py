"""A whole run of the harness on the CPU at a small size: its last line,
the comparison passing on the program and failing when the timed path is
broken underneath; the control on the card; the isolation check."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import calibrate, isolation
from benchmark.harness import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2**33 + 101  # more than 32 signed bits hold


def small(dtype="float32"):
    """The deploy cell at 480x640 (every second pixel of the sensor's
    scene) and imgsz 640, at which the checkpoint still finds the scenes'
    stitches, four frames a batch: small enough for the CPU. float32 on
    the CPU, so that the program's own gap to the reference is round-off."""
    def shrink(cell):
        cell.config["run"]["frame_hw"] = [480, 640]
        cell.config["model"]["imgsz"] = 640
        cell.config["model"]["dtype"] = dtype
        cell.traffic.update(batch=4, pool=2, warmup_batches=2, trace_batches=2, sample_frames=6)
    return shrink


def run_small(trace=False, cell="deploy.b128.host"):
    torch.set_num_threads(4)
    return run(cell, SEED, 4.0, trace, ROOT, time.perf_counter(), device="cpu", shrink=small())


def test_result_line_keys_and_the_program_is_correct():
    res = run_small(trace=True)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checked"  # the compared numbers come last
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
                                  "window_s"}
    assert {"dispatch_ms", "step_mfu", "conv_ms", "nms_roofline"} <= set(res["metrics"])
    assert "maskstats_soft_roofline" in res["metrics"]  # the checkpoint's soft readout: kernel A
    for name, m in res["checked"].items():
        assert m["value"] <= m["limit"], name
    json.dumps(res)


def test_end_to_end_line():
    res = run_small()
    assert set(res["metrics"]) == {"setup_s", "frames_per_s", "reading_p95_ms"}
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from tti_torch.parallel.runtime import InspectionPipeline

    original = InspectionPipeline._local_step

    def half_step(self, frames):
        half = len(frames) // 2
        return calibrate.left_out(original(self, frames[:len(frames) - half]), half)

    monkeypatch.setattr(InspectionPipeline, "_local_step", half_step)
    res = run_small(cell="deploy.b128.resident")
    assert res["correct"] is False
    assert res["checked"]["det_miss_pct"]["value"] > res["checked"]["det_miss_pct"]["limit"]


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    """Every stitch's centre one pixel to the right, where the step makes it."""
    from tti_torch.parallel import runtime

    original = runtime.InspectionPipeline.postprocess_chain

    def altered(self, x):
        outs = original(self, x)
        outs["stitches"] = dataclasses.replace(outs["stitches"], cx=outs["stitches"].cx + 1.0)
        return outs

    monkeypatch.setattr(runtime.InspectionPipeline, "postprocess_chain", altered)
    assert run_small()["correct"] is False


def test_a_loaded_jax_gives_no_result(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(RuntimeError, match="JAX"):
        run_small()


def test_isolation():
    assert isolation.source_faults() == []
    assert isolation.runtime_faults() == []


def test_isolation_finds_a_forbidden_import(tmp_path, monkeypatch):
    bad = tmp_path / "reference"
    bad.mkdir()
    (bad / "leak.py").write_text("import tti_torch.model.yolo\nfrom tti import cli\n")
    monkeypatch.setattr(isolation, "HERE", str(tmp_path))
    faults = isolation.source_faults()
    assert any("imports tti" in f for f in faults)
    assert any("(the reference) imports tti_torch" in f for f in faults)


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                          "--workload", "deploy.b128.host", "--seed", str(SEED),
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["deploy.b128.host", "deploy.b128.resident"])
def test_control_is_not_correct_on_the_card(card, cell):
    """The control (the program's int8 path, kernels E and F) at the cell's
    geometry on a batch of 16, three seeds: the comparison refuses it."""
    from benchmark import calibrate, compare
    from benchmark.harness import Cell
    from benchmark.reference.chain import ReferenceStep
    from benchmark.system import build_pipeline

    c = Cell.load(cell, ROOT)
    c.traffic.update(batch=16, sample_frames=16)
    rows = calibrate.readings(c, build_pipeline(c.config, ROOT, "cuda", quant="int8"),
                              ReferenceStep(c.config, ROOT, "cuda"), [SEED, SEED + 1, SEED + 2],
                              4)
    for row in rows:
        assert compare.judge(row, c.limits["limits"])[0] is False, row
