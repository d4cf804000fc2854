"""Two processes of ``python -m tti_torch.cli train`` joined by ``tti``'s
multi-host triple (``TTI_COORDINATOR=127.0.0.1:<free>``,
``TTI_NUM_PROCESSES=2``, ``TTI_PROCESS_ID=0/1``) on the CPU: the port's
counterpart of ``tests/test_dcn.py::test_two_process_dcn_train_step``.
Each process is a host with one rank (``--device cpu``: gloo); they train
two steps data-parallel at global batch 2, and only rank 0 prints and
writes checkpoints (each process is given its own ``--out``, so the
directories tell who wrote). A global batch that does not split over the
two ranks is refused by both, with the reason."""

import sys

import pytest
from PIL import Image

from tests.torch_dist import launch
from tests.torch_scenes import textile_samples


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("dcn_ds")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    for i, s in enumerate(textile_samples(2, 32, seed=2)):
        Image.fromarray(s.image).save(root / "images" / f"s_{i}.png")
        (root / "labels" / f"s_{i}.txt").write_text("\n".join(
            f"{c} " + " ".join(f"{v:.6f}" for v in p.ravel())
            for p, c in zip(s.polygons, s.classes)))
    return str(root / "images")


def _train(dataset, outs, batch):
    return launch(lambda r: [
        sys.executable, "-m", "tti_torch.cli", "train", "--images", dataset, "--out",
        str(outs[r]), "--imgsz", "32", "--batch-size", str(batch), "--epochs", "2",
        "--max-gt", "8", "--log-every", "1", "--checkpoint-every", "1", "--dtype", "f32",
        "--device", "cpu"])


def test_two_process_cli_train(dataset, tmp_path):
    outs = [tmp_path / "rank0", tmp_path / "rank1"]
    results = _train(dataset, outs, batch=2)
    for r, (code, out) in enumerate(results):
        assert code == 0, f"process {r} exited {code}:\n{out[-6000:]}"
    assert sorted(p.name for p in outs[0].iterdir()) == ["step_1.pt", "step_2.pt"]
    assert not outs[1].exists() or not any(outs[1].iterdir())
    out0, out1 = results[0][1], results[1][1]
    assert "step 2/2:" in out0 and "final checkpoint:" in out0
    assert "step 2/2:" not in out1 and "final checkpoint:" not in out1


def test_batch_not_a_multiple_of_the_ranks_is_refused(dataset, tmp_path):
    results = _train(dataset, [tmp_path / "a", tmp_path / "b"], batch=3)
    for code, out in results:
        assert code == 1, out[-3000:]
        assert "--batch-size 3 is the global batch: it must be a multiple of the 2 ranks" in out
    assert not any(tmp_path.iterdir())
