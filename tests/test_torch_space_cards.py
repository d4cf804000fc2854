"""``tools/space_cards_torch.py`` on the CPU: its command line (``--repeat``,
``--backend``, the runs ``dual`` and ``repeat``), the bf16 bar it derives
from the plain step's measured spread (counts equal, the spread with a
0.01 mm floor, 0.25 mm cap), the slabs of other shapes that spread reads
(``other_plans``, ``on_slabs``), and on a gloo pair of ranks
(``tests/torch_dist.py``'s ``space_dump`` case) its miss dump (every
halo's sent and received rows, the slab's head outputs and the plain
step's for the same rows), the space step bit-equal to ``on_slabs`` with
the mesh's own slabs, and ``conv_departures``."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from tests.torch_dist import GEOMETRIES, run_ranks
from tests.torch_synth import textile_frames

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / d) for d in ("tools", "tests")]
import space_cards_torch as sc  # noqa: E402

HEAD = [f"{f}{lvl}" for f in ("box", "cls", "mcoef") for lvl in range(3)] + ["protos"]


def test_repeat_and_backend_parse():
    args = sc.parse_args(["--spaces", "2", "--repeat", "20", "--backend", "gloo"])
    assert (args.spaces, args.repeat, args.backend, args.worker) == ("2", 20, "gloo", False)
    assert sc.parse_args([]).repeat is None and sc.parse_args([]).backend == "nccl"
    worker = sc.parse_args(["--worker", "--rank", "1", "--world", "2", "--coordinator", "h:1",
                            "--runs", "checked,banded,dual", "--repeat", "3"])
    assert (worker.rank, worker.runs, worker.repeat) == (1, "checked,banded,dual", 3)
    for bad in (["--repeat", "0"], ["--backend", "mpi"], ["--runs", "nonesuch"]):
        with pytest.raises((SystemExit, KeyError)):
            sc.parse_args(bad)


def test_dual_and_repeat_runs():
    (dual,) = sc.runs_of("dual")
    assert dual[:5] == ("dual/float32", "headline", "float32", {}, (1, 2))
    assert sc.LAUNCHES["dual"] == {"mask_stats_binary": 2, "greedy_keep": 2}
    assert sc.DUAL_SECOND == "yolov8n_textile_960.msgpack"
    (repeat,) = sc.runs_of("repeat")
    assert repeat[0] == sc.REPEAT_TAG and repeat[4] == (1,)
    assert sc.REPEAT_TAG in [run[0] for run in sc.CHECKED]
    tags = [run[0] for run in sc.runs_of("checked,banded,dual")]
    assert tags[-1] == "dual/float32" and len(tags) == len(sc.CHECKED) + len(sc.BANDED) + 1


@pytest.mark.parametrize("space_mm, spread_mm, counts, limit, ok", [
    (0.05, 0.08, True, 0.08, True),     # inside the measured spread
    (0.09, 0.08, True, 0.08, False),    # outside it
    (0.008, 0.0, True, 0.01, True),     # a zero spread: the 0.01 mm floor
    (0.011, 0.0, True, 0.01, False),
    (0.26, 0.4, True, 0.25, False),     # nothing above 0.25 mm, whatever the spread
    (0.25, 0.4, True, 0.25, True),
    (0.0, 0.08, False, 0.08, False),    # a frame's detection count differs
])
def test_spread_bar(space_mm, spread_mm, counts, limit, ok):
    assert sc.spread_bar(space_mm, spread_mm, counts) == {"limit_mm": limit, "ok": ok}


def _outputs(width_mm, n_valid=(3, 2)):
    fields = {k: np.array(width_mm, np.float32) for k in sc.MM_FIELDS}
    valid = np.zeros((len(width_mm), 4), bool)
    for f, n in enumerate(n_valid[:len(width_mm)]):
        valid[f, :n] = True
    return SimpleNamespace(valid=valid, scores=valid.astype(np.float32),
                           boxes_frame=np.zeros((*valid.shape, 4), np.float32),
                           measurements=SimpleNamespace(**fields))


def test_bf16_compare_at_batch_two_against_the_spread():
    """Counts that differ, a reading outside the measured spread or beyond
    0.25 mm fail; a space step that differs from the same slabs on threads
    fails whatever its readings."""
    ref = _outputs([5.0, 6.0])
    spread = np.array([0.0, 0.03])  # the plain step's own spread on these frames
    inside = sc.compare(_outputs([5.02, 6.0]), ref, "bfloat16", spread)
    assert not inside["failed"] and inside["spread_bar_met"] and inside["limit_mm"] == 0.03
    outside = sc.compare(_outputs([5.05, 6.0]), ref, "bfloat16", spread)
    assert outside["failed"] and not outside["spread_bar_met"]
    assert outside["mm_max"] == pytest.approx(0.05, abs=1e-6)
    counts = sc.compare(_outputs([5.0, 6.0], n_valid=(3, 1)), ref, "bfloat16", spread)
    assert counts["failed"] and not counts["spread_bar_met"]
    assert sc.compare(_outputs([5.3, 6.0]), ref, "bfloat16", np.array([0.4]))["failed"]
    assert "spread_bar_met" not in sc.compare(_outputs([5.05, 6.0]), ref, "bfloat16")
    got = _outputs([5.02, 6.0])
    same = sc.compare(got, ref, "bfloat16", spread, emulated=_outputs([5.02, 6.0]))
    assert same["emulated_equal"] and not same["failed"]
    other = sc.compare(got, ref, "bfloat16", spread, emulated=_outputs([5.021, 6.0]))
    assert not other["emulated_equal"] and other["failed"]
    first = sc.first_frames(_outputs([1.0, 2.0, 3.0], n_valid=(1, 1, 1)), 2)
    assert first.measurements.raw_width_mm.tolist() == [1.0, 2.0]


@pytest.mark.parametrize("counts, others", [
    ((12, 11), [(8, 8, 7), (6, 6, 6, 5), (13, 10)]),  # deploy, 23 P5 rows
    ((6, 6), [(4, 4, 4), (3, 3, 3, 3), (7, 5)]),  # headline, 12
    ((3, 3), [(2, 2, 2), (2, 2, 1, 1), (4, 2)]),
    ((2, 1), [(1, 1, 1)]),
    ((1, 1), []),
])
def test_other_plans(counts, others):
    from tti_torch.parallel.spatial import SlabPlan

    assert sc.other_plans(SlabPlan(counts)) == others


def test_on_slabs_of_other_shapes_meet_the_float32_bar(ref_intrinsics):
    """The plain step with its forward on threads over slabs of each shape
    ``other_plans`` gives, against the plain step: the float32 bar."""
    import torch

    from tests.torch_dist import _port_pipeline
    from tti_torch.parallel.spatial import SlabPlan

    frames = textile_frames(1, *GEOMETRIES["deploy"][1], seed=5)
    plain = _port_pipeline("deploy", ref_intrinsics)
    ref = plain.process_batch(frames)
    for counts in sc.other_plans(SlabPlan((3, 3))):
        d = sc.compare(sc.on_slabs(torch, plain, frames, counts), ref, "float32")
        assert not d["failed"], (counts, d)


def test_miss_dump_on_a_gloo_pair(ref_intrinsics, tmp_path):
    frames = textile_frames(1, *GEOMETRIES["deploy"][1], seed=5)
    np.savez(tmp_path / "inputs.npz", frames=frames, K=ref_intrinsics[0],
             dist=ref_intrinsics[1], geometry=np.array("deploy"))
    ranks = run_ranks("space_dump", tmp_path)
    for r, arrays in enumerate(ranks):
        halos = sorted({k.split("/")[0] for k in arrays if k.startswith("halo")})
        assert halos == [f"halo{h:02d}" for h in range(sc.HALOS_PER_STEP)]
        assert arrays["slab_p5_rows"].tolist() == [[0, 3, 6], [3, 6, 6]][r]
        for name in HEAD:
            slab, plain = arrays[f"slab/{name}"], arrays[f"plain/{name}"]
            assert slab.shape == plain.shape and slab.shape[1] > 0
            np.testing.assert_allclose(slab, plain, atol=1e-3, err_msg=f"rank {r} {name}")
    # The space step equals the same slabs' forward on threads of one
    # process, bit for bit; no convolution departs beyond float32 rounding.
    for r, arrays in enumerate(ranks):
        space = {k.split("/", 1)[1]: v for k, v in arrays.items() if k.startswith("space/")}
        assert space and all(
            np.array_equal(v, arrays[f"threads/{k}"], equal_nan=True) for k, v in space.items())
        assert arrays["departures/convs"] >= 60 and arrays["departures/max"] < 1e-4
    # Each halo's rows: what one rank sent is what the other received.
    for h in range(sc.HALOS_PER_STEP):
        for src, dst in ((0, 1), (1, 0)):
            sent = [v for k, v in sorted(ranks[src].items())
                    if k.startswith(f"halo{h:02d}/sent") and k.endswith(f"_to{dst}")]
            got = [v for k, v in sorted(ranks[dst].items())
                   if k.startswith(f"halo{h:02d}/recv") and k.endswith(f"_from{src}")]
            assert len(sent) == len(got) and all(np.array_equal(a, b) for a, b in zip(sent, got))
        assert any(k.startswith(f"halo{h:02d}/sent") for k in ranks[0])
