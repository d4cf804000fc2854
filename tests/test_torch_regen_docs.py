"""``tools/regen_docs_torch.py`` on synthetic records in a temporary root:
bench rows with ``bench.py``'s keys after an ``nvidia-smi`` line, the mm
report's JSON and the parity table, written into a copy of README. The
block carries every number and the card line; ``--check`` says whether
README would change; a record without an NVIDIA card line is refused and
nothing is written; ``tti``'s ``AUTOGEN:PERF`` block is left byte for byte;
each marker stays once; the committed block names a card on every row."""

from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path

import pytest

import tools.regen_docs_torch as tool

REPO = Path(__file__).resolve().parents[1]
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
DEPLOY = {"metric": "deploy_960p_imgsz960_s2_frames_per_sec_per_chip_e2e", "value": 1960.7,
          "unit": "frames/s", "vs_baseline": 3.921,
          "weights": "/x/checkpoints/yolov8n_textile_cam.msgpack",
          "p50_ms_unclamped": 18.48, "sync_roundtrip_ms": 0.03}
HEADLINE = {"metric": "undistorted_1080p_frames_per_sec_per_chip_e2e", "value": 6281.47,
            "unit": "frames/s", "vs_baseline": 12.563,
            "weights": "/x/checkpoints/yolov8n_textile.msgpack",
            "p50_ms_unclamped": 15.61, "sync_roundtrip_ms": 0.02}


def _stats(p50, p95, bias):
    return {"n": 250, "p50": p50, "p95": p95, "max": 0.9, "bias": bias}


def write_records(root: Path, card: str | None = CARD, mm_card: str | None = CARD,
                  parity_card: str | None = CARD) -> None:
    root.mkdir(parents=True, exist_ok=True)
    bench = ([card] if card is not None else []) + [json.dumps(DEPLOY), json.dumps(HEADLINE)]
    (root / "BENCH_torch_smoke.txt").write_text("\n".join(bench) + "\n")
    row = {"path": "reference-native", "dtype": "float32", "edge": _stats(0.12, 0.3871, -0.0334),
           "width": _stats(0.05, 0.1213, -0.0031), "det_ratio": 1.0}
    other = dict(row, dtype="bfloat16", edge=_stats(0.2, 0.5, 0.1))
    smooth = dict(row, edge=_stats(0.1, 0.2661, 0.0), width=_stats(0.04, 0.0942, 0.0),
                  raw_edge=_stats(0.1, 0.39, 0.0), raw_width=_stats(0.1, 0.12, 0.0),
                  window=8, scenes=48)
    report = {"torch": "2.11.0", "seed": 0, "weights": "checkpoints/yolov8n_textile_cam.msgpack",
              "readout": "sub-cell 0.5-crossing", "protocol": [other, row],
              "smoothed": [smooth], "truth": {"edge": [4.0] * 256, "width": [3.0] * 256}}
    if mm_card is not None:
        report["card"] = mm_card
    (root / "MEASURE_REPORT_torch.json").write_text(json.dumps(report))
    lines = ["# PARITY REPORT (tti_torch)", ""]
    lines.append("- Weights: `checkpoints/yolov8n_textile.msgpack`, put into the oracle.")
    if parity_card is not None:
        lines.append(f"- Port device: {parity_card}.")
    lines += ["", "| geometry | port dtype | frames | oracle dets | port dets | matched | "
              "frames w/ count mismatch | median mask IoU | min mask IoU | frac IoU>=0.999 | "
              "max box err (px) | max score err |", "|---|---|---|---|---|---|---|---|---|---|---|---|",
              "| resample-0.75 | float32 | 8 | 40 | 40 | 40 | 0 | 0.999871 | 0.99 | 0.9 | 0.1 | 1e-05 |",
              "| resample-0.75 | bfloat16 | 8 | 40 | 40 | 40 | 0 | 0.999652 | 0.98 | 0.8 | 0.2 | 1e-03 |",
              "| identity-scale | float32 | 8 | 40 | 40 | 40 | 0 | 1.000000 | 1.0 | 1.0 | 0.0 | 0 |"]
    (root / "PARITY_REPORT_torch.md").write_text("\n".join(lines) + "\n")


@pytest.fixture
def setup(tmp_path):
    readme = tmp_path / "README.md"
    shutil.copy(REPO / "README.md", readme)
    root = tmp_path / "records"
    write_records(root)
    return root, readme


def run(root, readme, *extra) -> int:
    return tool.main(["--root", str(root), "--readme", str(readme), *extra])


def block(text: str) -> str:
    return text.split(tool.BEGIN, 1)[1].split(tool.END, 1)[0]


def tti_block(text: str) -> str:
    return text.split("<!-- AUTOGEN:PERF -->", 1)[1].split("<!-- /AUTOGEN:PERF -->", 1)[0]


def test_block_carries_every_number_and_the_card(setup):
    root, readme = setup
    assert run(root, readme, "--tests", "1234") == 0
    got = block(readme.read_text())
    for number in ("6281.47", "15.61", "0.02", "1960.7", "18.48", "0.03", "0.999871",
                   "0.999652", "0.387", "0.121", "-0.033", "-0.003", "0.266", "0.094",
                   "16.9x", "14.3x", "256 scenes", "**1234**", "(yolov8n_textile.msgpack)"):
        assert number in got, number
    rows = [line for line in got.splitlines() if line.startswith("| ") and "---" not in line][1:]
    assert len(rows) == 5
    for line in rows:
        assert line.endswith(f"| {CARD} |"), line
    assert "BENCH_torch_smoke.txt" in got and "MEASURE_REPORT_torch.json" in got
    assert "PARITY_REPORT_torch.md" in got
    assert "TPU" not in got and "≥" not in got and "Target" not in got


def test_check_exits_1_before_the_write_and_0_after(setup):
    root, readme = setup
    before = readme.read_bytes()
    assert run(root, readme, "--tests", "7", "--check") == 1
    assert readme.read_bytes() == before
    assert run(root, readme, "--tests", "7") == 0
    assert run(root, readme, "--tests", "7", "--check") == 0
    assert run(root, readme, "--tests", "0", "--check") == 0  # 0 keeps the count written


@pytest.mark.parametrize("record", ["bench_no_card", "bench_other_card", "mm_no_card",
                                    "parity_no_card"])
def test_a_record_without_a_card_line_is_refused(tmp_path, record, capsys):
    readme = tmp_path / "README.md"
    shutil.copy(REPO / "README.md", readme)
    root = tmp_path / "records"
    cards = {"bench_no_card": {"card": None}, "bench_other_card": {"card": "device cpu"},
             "mm_no_card": {"mm_card": None}, "parity_no_card": {"parity_card": None}}[record]
    write_records(root, **cards)
    before = readme.read_bytes()
    assert run(root, readme, "--tests", "3") == 2
    assert readme.read_bytes() == before
    assert "refused" in capsys.readouterr().err


def test_tti_block_is_untouched_and_each_marker_stays_once(setup):
    root, readme = setup
    original = readme.read_text()
    assert run(root, readme, "--tests", "5") == 0
    write_records(root, card="NVIDIA H100 80GB HBM3, 350.00 W")
    assert run(root, readme, "--tests", "0") == 0
    text = readme.read_text()
    assert tti_block(text) == tti_block(original)
    assert text.split(tool.BEGIN)[0] == original.split(tool.BEGIN)[0]
    assert text.split(tool.END)[1] == original.split(tool.END)[1]
    for marker in (tool.BEGIN, tool.END, "<!-- AUTOGEN:PERF -->", "<!-- /AUTOGEN:PERF -->"):
        assert text.count(marker) == 1, marker
    assert "350.00 W" in block(text) and "**5**" in block(text)


def test_missing_records_leave_their_rows_out_and_the_newest_bench_wins(setup):
    root, readme = setup
    os.remove(root / "MEASURE_REPORT_torch.json")
    os.remove(root / "PARITY_REPORT_torch.md")
    newer = root / "BENCH_torch_z.txt"
    newer.write_text(f"{CARD}\n" + json.dumps(dict(HEADLINE, value=111.5)) + "\n")
    stamp = os.path.getmtime(root / "BENCH_torch_smoke.txt") + 10
    os.utime(newer, (stamp, stamp))
    assert run(root, readme, "--tests", "0") == 0
    got = block(readme.read_text())
    assert "111.5" in got and "BENCH_torch_z.txt" in got and "6281.47" not in got
    assert "Deployment geometry" not in got and "IoU" not in got and "mm accuracy" not in got


def test_committed_block_names_an_nvidia_card_on_every_row():
    """README's committed port block, as the tool wrote it: every row ends
    with an NVIDIA card line; no TPU figure and no target."""
    text = (REPO / "README.md").read_text()
    got = block(text)
    rows = [line for line in got.splitlines() if line.startswith("| ") and "---" not in line][1:]
    assert rows
    for line in rows:
        assert re.search(r"\| NVIDIA [^|]+, [\d.]+ W \|$", line), line
    assert "TPU" not in got and "≥" not in got
