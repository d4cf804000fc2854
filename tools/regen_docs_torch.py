"""Rewrite README's measured numbers for the PyTorch/H100 port from its records.

The port's counterpart of ``tools/regen_docs.py``: every number between the
``AUTOGEN:PERF_TORCH`` markers in README's port section is rewritten from the
port's own records, so that block cannot disagree with them. ``tti``'s
``AUTOGEN:PERF`` block (its TPU table) is never touched. The records, under
``build/`` or ``--root DIR``:

  * the newest ``BENCH_torch*.txt``   -> headline and deploy frames/s, the
    unclamped p50 and the sync round trip: the output of
    ``{ nvidia-smi --query-gpu=name,power.limit --format=csv,noheader;
    python3 bench_torch.py; } | tee build/BENCH_torch_<name>.txt``
    (its first line that is not JSON is the card, its JSON lines with a
    ``metric`` key are the rows)
  * ``MEASURE_REPORT_torch.json``     -> the mm accuracy row, raw and smoothed
    p95 and the validity-window ratios (``tools/measure_report_torch.py``,
    its ``card`` entry)
  * ``PARITY_REPORT_torch.md``        -> the median mask IoU of the deployment
    geometry in float32 and bfloat16 (``tools/parity_report_torch.py``, its
    "Port device:" line)
  * ``pytest --collect-only -q tests/test_torch_*.py`` -> the port's test
    count (``--tests N`` gives it, ``--tests 0`` keeps the one written)

Each row names its record and the card line ``nvidia-smi`` gave; there is no
target column and no TPU figure. A record that is missing leaves its row out.
A record without a card line, or whose card line names no NVIDIA card, is
refused (exit 2) and nothing is written.

  python tools/regen_docs_torch.py                       # collects the tests
  python tools/regen_docs_torch.py --tests 0             # keeps the count
  python tools/regen_docs_torch.py --tests 0 --check     # exit 1 if README would change
  python tools/regen_docs_torch.py --root D --readme R   # other records, another file
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BEGIN, END = "<!-- AUTOGEN:PERF_TORCH -->", "<!-- /AUTOGEN:PERF_TORCH -->"
TESTS_LINE = re.compile(r"^Port tests: \*\*(\d+)\*\* collected", re.M)


class Refused(Exception):
    """A record that cannot go into README (no NVIDIA card line)."""


def checked_card(card: str | None, record: str) -> str:
    card = (card or "").strip()
    if not card:
        raise Refused(f"{record} has no card line")
    if "NVIDIA" not in card:
        raise Refused(f"{record}'s card line names no NVIDIA card: {card!r}")
    return card


def newest_bench(root: str) -> tuple[str, str, list[dict]] | None:
    """The newest ``BENCH_torch*.txt`` -> (name, card line, metric rows)."""
    paths = glob.glob(os.path.join(root, "BENCH_torch*.txt"))
    if not paths:
        return None
    path = max(paths, key=lambda p: (os.path.getmtime(p), p))
    name = os.path.basename(path)
    card, rows = None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line) if line.startswith("{") else None
            except json.JSONDecodeError:
                row = None
            if row is None:
                card = line if card is None else card
            elif "metric" in row:
                rows.append(row)
    return name, checked_card(card, name), rows


def load_measure(root: str) -> tuple[str, dict] | None:
    path = os.path.join(root, "MEASURE_REPORT_torch.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        report = json.load(f)
    return checked_card(report.get("card"), os.path.basename(path)), report


def parity_row(root: str) -> tuple[str, str, str, str] | None:
    """(card, weights, f32 median IoU, bf16 median IoU) of the resample-0.75
    rows (the deployment geometry), read as ``tools/regen_docs.py`` reads
    them."""
    path = os.path.join(root, "PARITY_REPORT_torch.md")
    if not os.path.exists(path):
        return None
    card = f32 = bf16 = None
    weights = "seeded weights"
    with open(path) as f:
        for line in f:
            if line.startswith("- Port device:"):
                card = line.split(":", 1)[1].strip().rstrip(".")
            elif line.startswith("- Weights: `"):
                weights = os.path.basename(line.split("`")[1])
            cells = [c.strip() for c in line.split("|")]
            # | geometry | dtype | frames | oracle | port | matched | mismatch
            # | MEDIAN IoU | ... -> the median is cells[8]
            if len(cells) > 9 and cells[1] == "resample-0.75":
                if cells[2] == "float32":
                    f32 = cells[8]
                elif cells[2] == "bfloat16":
                    bf16 = cells[8]
    card = checked_card(card, os.path.basename(path))
    return (card, weights, f32, bf16) if f32 and bf16 else None


def count_tests() -> int:
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         *sorted(glob.glob(os.path.join(ROOT, "tests", "test_torch_*.py")))],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    found = re.findall(r"(\d+) tests? collected", out.stdout + out.stderr)
    if not found:
        raise SystemExit(f"could not count tests:\n{out.stdout[-2000:]}")
    return int(found[-1])


def build_block(root: str, n_tests: int | None) -> str:
    """The block between the markers (raises ``Refused``)."""
    from tti_torch.core.config import ValidationConfig

    bench, meas, par = newest_bench(root), load_measure(root), parity_row(root)
    inside = os.path.abspath(root).startswith(ROOT + os.sep)
    rel = os.path.relpath(os.path.abspath(root), ROOT) if inside else root
    lines = ["| Metric | Value | Record | Card |", "|---|---|---|---|"]
    if bench:
        name, card, rows = bench
        rec = f"{rel}/{name}"
        headline = next((r for r in rows if "1080p" in r.get("metric", "")), None)
        deploy = next((r for r in rows if r.get("metric", "").startswith("deploy")), None)
        if headline:
            lines.append(
                f"| End-to-end undistorted 1080p throughput (`bench_torch.py` headline row, "
                f"{os.path.basename(headline.get('weights', ''))}) | "
                f"**{headline['value']} frames/s per card** | {rec} | {card} |")
            if "p50_ms_unclamped" in headline:
                lines.append(
                    f"| Single-frame p50 latency (1080p -> 640 px seg + measurement) | "
                    f"{headline['p50_ms_unclamped']} ms dispatch + sync (sync round trip "
                    f"{headline.get('sync_roundtrip_ms')} ms) | {rec} | {card} |")
        if deploy:
            lines.append(
                f"| Deployment geometry (1280x960, imgsz 960, hi-res subpixel head; "
                f"`bench_torch.py` deploy row, {os.path.basename(deploy.get('weights', ''))}) | "
                f"**{deploy['value']} frames/s per card**; p50 "
                f"{deploy.get('p50_ms_unclamped')} ms (sync round trip "
                f"{deploy.get('sync_roundtrip_ms')} ms) | {rec} | {card} |")
    if par:
        card, weights, f32, bf16 = par
        lines.append(
            f"| Mask parity vs Ultralytics predict semantics, deployment geometry ({weights}) | "
            f"median IoU **{f32} float32 / {bf16} bfloat16** | "
            f"{rel}/PARITY_REPORT_torch.md | {card} |")
    if meas:
        card, report = meas
        pick = lambda key: next((p for p in report.get(key, [])
                                 if p["path"] == "reference-native" and p["dtype"] == "float32"),
                                None)
        raw, sm = pick("protocol"), pick("smoothed")
        if raw:
            scenes = len(report.get("truth", {}).get("edge", [])) or raw["edge"]["n"]
            value = (f"p95 **{raw['edge']['p95']:.3f} mm edge / {raw['width']['p95']:.3f} mm "
                     f"width** raw per frame (bias {raw['edge']['bias']:+.3f} / "
                     f"{raw['width']['bias']:+.3f})")
            if sm:
                v = ValidationConfig()
                edge_win = v.seam_upper_mm - v.seam_lower_mm
                width_win = v.stitch_upper_mm - v.stitch_lower_mm
                value += (f"; **{sm['edge']['p95']:.3f} / {sm['width']['p95']:.3f} smoothed** "
                          f"({sm['scenes']} scenes, window {sm['window']}) - "
                          f"{edge_win / sm['edge']['p95']:.1f}x / "
                          f"{width_win / sm['width']['p95']:.1f}x inside the validity windows")
            lines.append(
                f"| mm accuracy vs analytic truth ({scenes} scenes, reference-native float32, "
                f"{os.path.basename(report.get('weights', ''))}, "
                f"{report.get('readout', 'auto readout')}) | {value} | "
                f"{rel}/MEASURE_REPORT_torch.json | {card} |")
    if n_tests:
        lines += ["", f"Port tests: **{n_tests}** collected by `pytest --collect-only -q "
                      "tests/test_torch_*.py` on the CPU."]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(ROOT, "build"),
                    help="the directory of the records (default: build/)")
    ap.add_argument("--readme", default=os.path.join(ROOT, "README.md"))
    ap.add_argument("--tests", type=int, default=None,
                    help="the port's test count (0: keep the one written; default: "
                         "pytest --collect-only)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if README would change (no write)")
    args = ap.parse_args(argv)

    with open(args.readme) as f:
        text = f.read()
    if text.count(BEGIN) != 1 or text.count(END) != 1:
        print(f"{args.readme} needs each AUTOGEN:PERF_TORCH marker once", file=sys.stderr)
        return 2
    if args.tests == 0:
        kept = TESTS_LINE.search(text.split(BEGIN, 1)[1].split(END, 1)[0])
        n_tests = int(kept.group(1)) if kept else None
    else:
        n_tests = args.tests or count_tests()
    try:
        block = build_block(args.root, n_tests)
    except Refused as e:
        print(f"refused, README unchanged: {e}", file=sys.stderr)
        return 2
    new = re.sub(re.escape(BEGIN) + r".*?" + re.escape(END),
                 lambda _: f"{BEGIN}\n{block}\n{END}", text, flags=re.S)
    if new == text:
        print(f"{args.readme} already in sync")
        return 0
    if args.check:
        print(f"{args.readme} is out of sync with the port's records", file=sys.stderr)
        return 1
    with open(args.readme, "w") as f:
        f.write(new)
    print(f"{args.readme} regenerated from the port's records")
    return 0


if __name__ == "__main__":
    sys.exit(main())
