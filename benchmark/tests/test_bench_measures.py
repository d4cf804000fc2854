"""What the harness measures: rates over the whole window and tails over
every batch, the loop's window, the FLOP counter, and the roofline counts
of kernels A, B and D against ``chip_smoke.py``'s own bound helpers."""

from __future__ import annotations

import time
import types

import numpy as np
import pytest
import torch

from benchmark.flops import forward_flops, thop_deconv_excess
from benchmark.harness import window_metrics
from benchmark.loop import Record, run_loop
from benchmark.rooflines import maskstats, nms
from benchmark.scenes import render_pool


def test_rate_counts_every_batch_over_the_whole_window_and_the_tail_every_batch():
    lat = [10.0] * 95 + [50.0, 60.0, 70.0, 80.0, 90.0]  # ms; a chunked median would hide these
    recs = [Record(i, handed=i * 0.1, dispatched=i * 0.1 + 0.001, read=i * 0.1 + lat[i] / 1e3)
            for i in range(100)]
    w = window_metrics(recs, batch=128, seconds=10.0)
    assert w["frames_per_s"] == 128 * 100 / 10.0
    assert w["reading_p95_ms"] == pytest.approx(np.percentile(lat, 95))
    assert w["reading_p95_ms"] > 10.0
    assert w["dispatch_s"] == pytest.approx([0.001] * 100)


class SlowFeed:
    """A feed whose results arrive ``step`` seconds after hand-over."""

    def __init__(self, step):
        self.step, self.handed = step, []

    def hand(self, i):
        self.handed.append(i)
        return time.perf_counter() + self.step

    def read(self, ready):
        time.sleep(max(0.0, ready - time.perf_counter()))
        return ready


def test_window_counts_only_batches_read_back_before_its_end():
    feed = SlowFeed(0.02)
    t0 = time.perf_counter()
    res = run_loop(feed, seconds=0.3)
    end = t0 + 0.3
    assert res.records and all(r.read <= end + 1e-3 for r in res.records)
    # The batch read after the end and the one still in flight are not counted.
    assert len(feed.handed) == len(res.records) + 2
    assert [r.index for r in res.records] == list(range(len(res.records)))


def test_loop_of_fixed_batches_keeps_what_it_is_asked():
    feed = SlowFeed(0.0)
    res = run_loop(feed, batches=5, keep=lambda rec, host: [(rec.index % 2, 0, host)], first=3)
    assert [r.index for r in res.records] == [3, 4, 5, 6, 7]
    assert len(res.kept) == 5 and len(feed.handed) == 6


def test_loop_keeps_host_clock_spans_of_every_hand_over_and_read_back():
    spans = []
    res = run_loop(SlowFeed(0.005), batches=3, spans=spans)
    names = [n for n, _, _ in spans]
    assert names.count("bench.dispatch") == 4 and names.count("bench.read") == 4
    assert all(a <= b for _, a, b in spans)
    assert len(res.records) == 3


@pytest.mark.parametrize("name,frame_hw", [("camera_scene", (480, 640)),
                                           ("textile_frames", (120, 160))])
def test_scene_pool_is_drawn_from_the_seed_whatever_the_threads(name, frame_hw):
    one = render_pool(name, 3, frame_hw, 2**33 + 7, threads=1)
    assert one.shape == (3, *frame_hw, 3) and one.dtype == np.uint8
    np.testing.assert_array_equal(one, render_pool(name, 3, frame_hw, 2**33 + 7, threads=3))
    assert not np.array_equal(one, render_pool(name, 3, frame_hw, 2**33 + 8))
    assert not np.array_equal(one[0], one[1])  # distinct scenes


@pytest.mark.parametrize("variant,published", [("n", 12.6), ("s", 42.6), ("m", 110.2)])
def test_flops_match_ultralytics_published_figures(variant, published):
    """Ultralytics publishes YOLOv8-seg's GFLOPs at imgsz 640 with 80
    classes, rounded to 0.1, counted by ``thop``, which charges each
    stride-2 transposed convolution four times its multiply-accumulates.
    With that excess added, the count is within the rounding: 0.05 GFLOP."""
    ours = forward_flops(640, 640, 80, variant) + thop_deconv_excess(640, 640, variant)
    assert abs(ours / 1e9 - published) <= 0.05


def _chip_smoke():
    import chip_smoke

    # ``kernel_bound_ms`` builds its grid on "cuda": give it the CPU.
    shim = types.SimpleNamespace(arange=lambda *a, device=None, **k: torch.arange(*a, **k))
    return chip_smoke, shim


@pytest.mark.parametrize("soft", [True, False])
def test_mask_stats_counts_match_chip_smoke(soft):
    cs, shim = _chip_smoke()
    g = torch.Generator().manual_seed(3)
    b, hm, wm, nm, d = 4, 96, 160, 32, 64
    protos = torch.zeros((b, hm, wm, nm), dtype=torch.bfloat16)
    coefs = torch.zeros((b, d, nm))
    xy = torch.rand((b, d, 2), generator=g) * torch.tensor([wm, hm])
    wh = torch.rand((b, d, 2), generator=g) * 30
    boxes = torch.cat([xy - wh, xy + wh], -1)
    valid = torch.rand((b, d), generator=g) > 0.3
    name = "mask_stats_soft" if soft else "mask_stats_binary"
    want = cs.kernel_bound_ms(shim, name, protos, coefs, boxes, valid)
    got = maskstats.bound_ms(soft, (b, hm, wm, nm), 2, boxes.numpy(), valid.numpy())
    assert got[1] == want[1] and got[0] == pytest.approx(want[0], rel=1e-12)
    assert got[2] == want[2]


@pytest.mark.parametrize("b,k", [(128, 256), (1, 256), (16, 512)])
def test_nms_counts_match_chip_smoke(b, k):
    cs, _ = _chip_smoke()
    want = cs.nms_bound_ms(torch.zeros((b, k, 4)))
    got = nms.bound(b, k)
    assert got[:2] == pytest.approx(want[:2]) and got[2]["ops"] == want[2]["ops"]
    assert got[2]["bytes"] == want[2]["bytes"]
