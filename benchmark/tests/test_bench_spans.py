"""The metrics read from the program's own spans and counts
(``benchmark/spans.py``), on a small traced run of the harness on the CPU,
where a span's device ms are its host ms."""

from __future__ import annotations

from benchmark.tests.test_bench_run import run_small

SPAN_METRICS = ("batch_host_ms", "preprocess_ms", "forward_ms", "detect_ms", "measure_ms",
                "readback_queued_ms", "readback_tail_ms", "readback_copies")


def test_a_traced_run_reports_the_program_spans():
    from tti_torch.core.logging import Span, process_tracer

    tracer = process_tracer()
    tracer.clear()
    res = run_small(trace=True)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in SPAN_METRICS + ("upload_device_ms",):
        assert m[name] > 0, name
    assert m["readback_copies"] == 22
    assert res["metrics"]["readback_copies"]["unit"] == "copies"
    # Per batch, the stages run inside the hand-over: their sum is at most
    # the batch's span and its read-back's.
    spans = [r for r in tracer.records() if isinstance(r, Span)]
    batches = {s.batch for s in spans if s.name == "batch"}
    assert len(batches) == 3  # the traced segment's two batches and the drained one
    for b in batches:
        ms = lambda name: sum(s.host_ms for s in spans if s.batch == b and s.name == name)
        stages = sum(ms(n) for n in ("preprocess", "forward", "detect", "measure"))
        assert 0 < stages <= ms("batch") + ms("to_host")
    assert (m["preprocess_ms"] + m["forward_ms"] + m["detect_ms"] + m["measure_ms"]
            <= m["batch_host_ms"])


def test_no_tracer_no_metric(monkeypatch):
    """A program without the tracer (an older one) gives nothing to read."""
    import sys
    import types

    from benchmark import spans

    monkeypatch.setitem(sys.modules, "tti_torch.core.logging", types.ModuleType("old"))
    ctx = types.SimpleNamespace(trace={"steps": 3})
    assert spans.batches(ctx) == [] and spans.mean(ctx, "forward") is None
    assert spans.batches(types.SimpleNamespace(trace=None)) == []
