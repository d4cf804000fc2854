"""The port's tracer (``tti_torch.core.logging``): off, it records nothing
and leaves the step's outputs as they are; on (``enable()`` or a
``torch.profiler`` session), the step's spans and counts with their
parents and batch ids; the bounded ring; ``summary()``'s self time."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tti_torch.calib.io import CalibrationData
from tti_torch.core import logging as tracing
from tti_torch.core.config import MeasureConfig, ModelConfig, RoiConfig
from tti_torch.core.logging import RING, Count, Span, StageTimer, device_gap_ms
from tti_torch.model.checkpoint import checkpoint_metadata, load_flax_msgpack
from tti_torch.parallel.runtime import DualPipeline, InspectionPipeline

CKPT = "checkpoints/yolov8n_textile_cam.msgpack"
HW = (96, 128)
BLOCKS = {f"forward.{b}" for b in ("m0s2d", "m1", "m2", "m3", "m4", "m5", "m6", "m7", "m8",
                                   "m9", "m12", "m15", "m16", "m18", "m19", "m21", "m22")}
STAGES = {"upload", "preprocess", "forward", "detect", "measure"}


def small_pipeline() -> InspectionPipeline:
    """The deploy checkpoint at imgsz 128 on 96x128 frames, calibrated, so
    that measure runs; float32 on the CPU."""
    calib = CalibrationData(K=np.array([[90.0, 0, 64], [0, 90.0, 48], [0, 0, 1]]),
                            dist=np.array([0.05, 0.01, 0, 0, 0.0]),
                            rvec=np.array([-0.86, -0.39, -1.36]),
                            tvec=np.array([0.005, 0.036, 0.094]))
    return InspectionPipeline(
        ModelConfig(image_size=128, dtype="float32", mask_stride=2, proto_head="subpixel"),
        load_flax_msgpack(CKPT), HW, calib,
        MeasureConfig().with_subcell_from(checkpoint_metadata(CKPT)),
        RoiConfig(x_min=1, x_max=127, y_min=1, y_max=95), device="cpu")


@pytest.fixture(scope="module")
def pipe():
    return small_pipeline()


@pytest.fixture
def tracer():
    """The process's tracer, emptied, and off again afterwards."""
    t = tracing.process_tracer()
    t.clear()
    yield t
    tracing.disable()
    t.clear()


def arrays(outs) -> list[np.ndarray]:
    """Every array of a ``PipelineOutputs``, in field order."""
    out = []
    for f in dataclasses.fields(outs):
        value = getattr(outs, f.name)
        if isinstance(value, np.ndarray):
            out.append(value)
        elif isinstance(value, dict):
            out.extend(value[k] for k in sorted(value))
        elif dataclasses.is_dataclass(value):
            out.extend(getattr(value, g.name) for g in dataclasses.fields(value))
    return out


def frames():
    """Two synthetic textile scenes (imported here: the card's test run
    may see another top-level ``tests`` package)."""
    from tests.torch_synth import textile_frames

    return textile_frames(2, *HW, seed=3)


def one_batch(pipe):
    return pipe.outputs_to_host(pipe.process_batch_async(frames()))


def check_step_spans(records, steps_before: int, host) -> None:
    spans = {r.id: r for r in records if isinstance(r, Span)}
    parent = lambda r: spans[r.parent].name if r.parent is not None else None
    by_name = {}
    for r in records:
        by_name.setdefault(r.name, []).append(r)
    batch = by_name["batch"]
    assert len(batch) == 1 and batch[0].parent is None
    bid = batch[0].batch
    assert bid == steps_before + 1
    for name in STAGES:
        (s,) = by_name[name]
        assert parent(s) == "batch" and s.batch == bid, name
    for name in BLOCKS:
        (s,) = by_name[name]
        assert parent(s) == "forward" and s.batch == bid, name
    (to_host,) = by_name["to_host"]
    assert to_host.parent is None and to_host.batch == bid
    assert to_host.start_ns >= batch[0].end_ns
    (wait,) = by_name["to_host.wait"]
    assert parent(wait) == "to_host" and wait.batch == bid
    (copies,) = by_name["d2h_copies"]
    assert isinstance(copies, Count) and parent(copies) == "to_host" and copies.batch == bid
    assert copies.n == len(arrays(host))
    for s in spans.values():  # on the CPU a span's device ms are its host ms
        assert s.end_ns >= s.start_ns
        if s.name in STAGES:
            assert s.device_ms == s.host_ms
    assert device_gap_ms(batch[0], to_host) == (to_host.start_ns - batch[0].end_ns) / 1e6


def test_off_records_nothing_and_on_changes_no_output(pipe, tracer):
    assert tracing.tracer() is None
    off = one_batch(pipe)
    assert tracer.records() == []
    tracing.enable()
    assert tracing.tracer() is tracer
    on = one_batch(pipe)
    assert tracer.records()
    got, want = arrays(on), arrays(off)
    assert len(got) == len(want) >= 20
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("switch", ["enable", "profiler"])
def test_a_step_records_its_spans(pipe, tracer, switch):
    steps = pipe.steps
    if switch == "enable":
        tracing.enable()
        host = one_batch(pipe)
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            host = one_batch(pipe)
        # Each span opens a RecordFunction of its name: the trace shows it.
        names = {e.name for e in prof.events()}
        assert {"batch", "forward", "forward.m9", "to_host.wait"} <= names
    check_step_spans(tracer.records(), steps, host)


def test_nothing_is_recorded_after_the_profiler_exits(pipe, tracer):
    with profile(activities=[ProfilerActivity.CPU]):
        one_batch(pipe)
    n = len(tracer.records())
    assert n > 0 and tracing.tracer() is None
    one_batch(pipe)
    assert len(tracer.records()) == n


def test_off_while_a_graph_is_compiled(pipe, tracer, monkeypatch):
    tracing.enable()
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert tracing.tracer() is None
    one_batch(pipe)
    assert tracer.records() == []


def test_dual_pipeline_records_one_batch_and_two_chains(pipe, tracer):
    dual = DualPipeline(pipe, small_pipeline())
    steps = pipe.steps
    tracing.enable()
    outs_a, outs_b = dual.process_batch_async(frames())
    pipe.outputs_to_host(outs_a)
    pipe.outputs_to_host(outs_b)
    names = [r.name for r in tracer.records()]
    assert names.count("batch") == 1 and names.count("preprocess") == 1
    for name in ("forward", "detect", "measure", "to_host", "d2h_copies"):
        assert names.count(name) == 2, name
    assert {r.batch for r in tracer.records()} == {steps + 1}


def test_the_ring_keeps_its_size():
    t = StageTimer()
    for i in range(RING + 100):
        t.count("n", i)
    with t.stage("last"):
        pass
    records = t.records()
    assert len(records) == RING
    assert records[-1].name == "last" and records[0].n == 101
    assert t.summary()["n"]["n"] == RING - 1


def test_summary_self_time_is_the_span_less_its_children():
    t = StageTimer()
    with t.stage("parent"):
        for _ in range(2):
            with t.stage("child"):
                time.sleep(0.002)
        t.count("things", 3)
    records = t.records()
    (parent,) = [r for r in records if r.name == "parent"]
    children = [r for r in records if r.name == "child"]
    assert all(c.parent == parent.id for c in children)
    covered = sum(c.end_ns - c.start_ns for c in children)
    s = t.summary()
    assert s["parent"]["self_ms"] == (parent.end_ns - parent.start_ns - covered) / 1e6
    assert 0 <= s["parent"]["self_ms"] < s["parent"]["mean_ms"] - 4.0
    assert s["child"]["n"] == 2 and s["child"]["self_ms"] == s["child"]["mean_ms"]
    assert "device_ms" not in s["parent"]  # host work has no device time
    assert s["things"] == {"n": 1, "total": 3, "mean": 3.0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (python -m pytest tests/test_torch_tracing.py -m cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_ms_on_the_card(cuda_device, tracer):
    """A span's device ms against events around the same work, on the
    current stream and under a side stream: the span times the stream the
    work runs on, and its two events lie inside the outer ones."""
    x = torch.randn(2048, 2048, device=cuda_device)
    tracing.enable()
    for stream in (torch.cuda.current_stream(cuda_device), torch.cuda.Stream(cuda_device)):
        with torch.cuda.stream(stream):
            outer = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            outer[0].record()
            with tracing.span("work", cuda_device) as span:
                for _ in range(20):
                    x = x @ x / 2048
            outer[1].record()
        torch.cuda.synchronize()
        whole = outer[0].elapsed_time(outer[1])
        assert 0.9 * whole <= span.device_ms <= whole
    assert tracing.process_tracer().summary()["work"]["n"] == 2
