"""Multi-rank checks of the port on the CPU (data-parallel and spatial):
the launcher the tests call and the worker each rank runs.

``run_ranks(case, ...)`` starts ``python -m tests.torch_dist <case> <dir>``
twice, as ranks 0 and 1 of a gloo job on 127.0.0.1 (a free port, ``tti``'s
``TTI_*`` triple), each with its own time limit: a rank that raises leaves
its peer blocked in a collective, so both are killed when the limit
passes and the test fails. Each rank writes ``rank<r>.npz`` into ``dir``.
The worker imports ``torch`` and ``tti_torch`` only, never ``jax``: the
test process holds the ``tti`` side.

Cases (inputs in ``dir/inputs.npz``):

- ``step``, ``dual``, ``int8s``: the port's inspection step on a mesh over
  the two ranks against the same step without a mesh on the whole batch
  (``process_batch``, and the mesh step's ``process_batch_async`` and
  ``step`` entries);
- ``space_<kind>`` (kind ``step``, ``dual``, ``int8s``, ``int8``) and
  ``grid_step``: the same on a ``("data", "space")`` mesh of ``(1, 2)``
  and ``(2, 2)`` ranks (``MESHES``), on the geometry and batch of the
  inputs file (and each banded warp of its ``warp_blocks``, if any), with
  each rank's counts of the spatial exchanges of one step;
- ``space_dump``: one deploy step on the ``(1, 2)`` mesh and the step
  without a mesh under ``tools/space_cards_torch.py``'s ``StepRecorder``:
  the arrays of its miss dump;
- ``train``: the data-parallel ``TrainStep`` and its trainer.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]

RVEC = np.array([-0.8631369244225452, -0.3919482615538663, -1.3591256137314185])
TVEC = np.array([0.005016396186926285, 0.03590342712705542, 0.09382141278570659])

GEOMETRIES = {
    "deploy": ("yolov8n_textile_cam", (240, 320), 240),
    "headline": ("yolov8n_textile", (216, 384), 128),
    "headline_b": ("yolov8n_textile_960", (216, 384), 128),
}


def pipeline_settings(name, intrinsics, dist=None) -> dict:
    """The paired pipelines' settings of geometry ``name`` (see
    ``tests/torch_pair.py``): checkpoint path and sidecar, frame size, the
    model, ROI and calibration arguments (numpy), shared by both
    packages."""
    from tti_torch.model.checkpoint import checkpoint_metadata

    ckpt, hw, imgsz = GEOMETRIES[name]
    path = f"checkpoints/{ckpt}.msgpack"
    meta = checkpoint_metadata(path)
    K, dist0 = intrinsics
    K = np.array(K, dtype=np.float64)
    K[0] *= hw[1] / 1280.0
    K[1] *= hw[0] / 960.0
    return dict(
        path=path, meta=meta, hw=hw,
        model=dict(variant="n", num_classes=2, image_size=imgsz, dtype="float32",
                   conf_thresh=0.05, mask_stride=meta.get("mask_stride", 4),
                   proto_head=meta.get("proto_head", "deconv")),
        roi=dict(enabled=True, x_min=10, x_max=hw[1] - 10, y_min=min(300, hw[0] // 3),
                 y_max=hw[0] - min(200, hw[0] // 5)),
        calib=dict(K=K, dist=dist0 if dist is None else dist, rvec=RVEC, tvec=TVEC))


# -- the launcher ----------------------------------------------------------

def launch(argv_of_rank, world: int = 2, env_extra: dict | None = None,
           timeout: float = 240.0) -> list[tuple[int, str]]:
    """Start ``world`` processes (``argv_of_rank(r)``) as the ranks of one
    job (``TTI_COORDINATOR`` 127.0.0.1:<free>, ``TTI_NUM_PROCESSES`` world,
    ``TTI_PROCESS_ID`` r), wait for each within ``timeout`` seconds, kill
    whatever is left. Returns (exit code, output) per rank; a rank still
    running at the limit reads -9. Each rank runs one intra-op thread: the
    cases hold a rank's rows bit for bit to a step on another batch shape,
    and from two threads on MKL and oneDNN block a product by the batch's
    shape."""
    from tti_torch.parallel.dcn import free_local_coordinator

    coord = free_local_coordinator()
    procs = []
    for r in range(world):
        env = dict(os.environ, TTI_COORDINATOR=coord, TTI_NUM_PROCESSES=str(world),
                   TTI_PROCESS_ID=str(r), PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   **(env_extra or {}))
        procs.append(subprocess.Popen(argv_of_rank(r), env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    results = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out += f"\n[killed after {timeout} s]"
            results.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


MESHES = {"space": ((1, 2), ("data", "space")), "grid": ((2, 2), ("data", "space"))}


def run_ranks(case: str, workdir: Path, world: int = 2) -> list[dict]:
    """Run ``case`` on ``world`` gloo ranks; each rank's arrays."""
    results = launch(lambda r: [sys.executable, "-m", "tests.torch_dist", case, str(workdir)],
                     world)
    for r, (code, out) in enumerate(results):
        assert code == 0, f"rank {r} of {case!r} exited {code}:\n{out[-6000:]}"
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(world)]


# -- outputs as arrays -----------------------------------------------------

def outputs_to_arrays(out, prefix: str) -> dict:
    """A ``PipelineOutputs`` as flat named arrays."""
    import dataclasses

    arrays = {f"{prefix}/{k}": getattr(out, k)
              for k in ("boxes_frame", "scores", "classes", "valid", "envelope")}
    for group in ("measurements", "stitches"):
        value = getattr(out, group)
        for f in dataclasses.fields(value):
            arrays[f"{prefix}/{group}.{f.name}"] = getattr(value, f.name)
    for k, v in out.telemetry.items():
        arrays[f"{prefix}/telemetry.{k}"] = v
    return arrays


def arrays_to_outputs(arrays: dict, prefix: str):
    """The ``PipelineOutputs`` of :func:`outputs_to_arrays`."""
    from tti_torch.measure.pipeline import FrameMeasurement, StitchSet
    from tti_torch.parallel.runtime import PipelineOutputs

    def group(name, cls):
        return cls(**{k.split(".", 1)[1]: v for k, v in arrays.items()
                      if k.startswith(f"{prefix}/{name}.")})

    return PipelineOutputs(
        boxes_frame=arrays[f"{prefix}/boxes_frame"], scores=arrays[f"{prefix}/scores"],
        classes=arrays[f"{prefix}/classes"], valid=arrays[f"{prefix}/valid"], masks=None,
        measurements=group("measurements", FrameMeasurement),
        stitches=group("stitches", StitchSet), envelope=arrays[f"{prefix}/envelope"],
        telemetry=group("telemetry", dict))


# -- the worker ------------------------------------------------------------

def _port_pipeline(name, intrinsics, mesh=None, **kw):
    import tti_torch.calib.io as tio
    import tti_torch.core.config as tcfg
    from tti_torch.model.checkpoint import load_flax_msgpack
    from tti_torch.parallel.runtime import InspectionPipeline

    s = pipeline_settings(name, intrinsics)
    return InspectionPipeline(tcfg.ModelConfig(**s["model"]), load_flax_msgpack(s["path"]),
                              s["hw"], tio.CalibrationData(**s["calib"]),
                              tcfg.MeasureConfig(min_stitches=1).with_subcell_from(s["meta"]),
                              tcfg.RoiConfig(**s["roi"]), device="cpu", mesh=mesh, **kw)


def _inference(case: str, inputs: dict, mesh) -> dict:
    """The mesh step's outputs through each entry and the same step without
    a mesh on the whole batch; with ``warp_blocks`` in the inputs, once per
    block of the banded warp (the tags and counts then end in ``_<block>``)."""
    import torch

    from tti_torch.parallel import spatial
    from tti_torch.parallel.runtime import DualPipeline, InspectionPipeline

    case = case.split("_", 1)[-1]
    frames = inputs["frames"]
    intrinsics = (inputs["K"], inputs["dist"])
    geometry = str(inputs["geometry"]) if "geometry" in inputs else "headline"
    kw = ({"quant": "int8s", "quant_scales": str(inputs["scales"])} if case == "int8s"
          else {"quant": "int8"} if case == "int8" else {})
    blocks = [int(b) for b in inputs["warp_blocks"]] if "warp_blocks" in inputs else [None]

    def build(m, block):
        extra = {} if block is None else {"warp_block": block}
        pipe = _port_pipeline(geometry, intrinsics, m, **kw, **extra)
        if case != "dual":
            return pipe
        return DualPipeline(pipe, _port_pipeline("headline_b", intrinsics, m, **extra))

    arrays = {}
    for block in blocks:
        sfx = "" if block is None else f"_{block}"
        for tag, m in (("mesh", mesh), ("single", None)):
            step = build(m, block)
            spatial.reset_counts()
            outs = step.process_batch(frames)
            if m is not None:
                arrays.update({f"counts{sfx}/{k}": np.array(v)
                               for k, v in spatial.COUNTS.items()})
            if case == "dual":
                arrays.update(outputs_to_arrays(outs[0], f"{tag}{sfx}_a"))
                arrays.update(outputs_to_arrays(outs[1], f"{tag}{sfx}_b"))
            else:
                arrays.update(outputs_to_arrays(outs, f"{tag}{sfx}"))
            if m is None:
                continue
            host = InspectionPipeline.outputs_to_host
            async_outs = step.process_batch_async(frames)
            step_outs = step.step(torch.from_numpy(frames))
            if case == "dual":
                for suffix, i in (("a", 0), ("b", 1)):
                    arrays.update(outputs_to_arrays(host(async_outs[i]), f"async{sfx}_{suffix}"))
                    arrays.update(outputs_to_arrays(host(step_outs[i]), f"step{sfx}_{suffix}"))
            else:
                arrays.update(outputs_to_arrays(host(async_outs), f"async{sfx}"))
                arrays.update(outputs_to_arrays(host(step_outs), f"step{sfx}"))
    return arrays


def _dump(inputs: dict, mesh) -> dict:
    """``space_cards_torch.StepRecorder``'s arrays for one step of the space
    pipeline and one of the plain pipeline on the inputs' frames; the space
    step's outputs (``space/``) beside ``on_slabs`` with the mesh's own
    slabs (``threads/``); ``conv_departures``' count of convolutions and
    largest departure."""
    import torch

    sys.path[:0] = [str(REPO / "tools"), str(REPO / "tests")]
    from space_cards_torch import StepRecorder, conv_departures, on_slabs

    intrinsics = (inputs["K"], inputs["dist"])
    geometry = str(inputs["geometry"])
    plain, pipe = _port_pipeline(geometry, intrinsics), _port_pipeline(geometry, intrinsics, mesh)
    with StepRecorder(pipe, plain) as recorder:
        plain.process_batch(inputs["frames"])
        got = pipe.process_batch(inputs["frames"])
    arrays = recorder.arrays()
    arrays.update(outputs_to_arrays(got, "space"))
    arrays.update(outputs_to_arrays(
        on_slabs(torch, plain, inputs["frames"], pipe.space.plan.counts), "threads"))
    with torch.inference_mode():
        x = plain.preprocess(torch.from_numpy(inputs["frames"]))
    dep = conv_departures(torch, plain, pipe, x)
    arrays["departures/convs"] = np.array(dep["convs"])
    arrays["departures/max"] = np.array(max((d["max_abs_diff"] for d in dep["departs"]),
                                            default=0.0))
    return arrays


TRAIN = dict(imgsz=64, batch=4, max_gt=8, lr=1e-3, total=None, gains=(2.0, 1.0),
             ckpt="checkpoints/yolov8n_textile_cam.msgpack")


def _flat(state, with_stats: bool = False):
    import torch

    tensors = [p.detach() for p in state.model.parameters()]
    if with_stats:
        tensors += [b for name, b in state.model.named_buffers() if "running" in name]
        tensors += list(state.ema.values())
    return torch.cat([t.reshape(-1).float() for t in tensors]).numpy()


def _train(out_dir: str, mesh) -> dict:
    """One data-parallel step against the single-process step on the whole
    batch, the augmented rows, three steps, and save at step 2 + resume +
    one step against three uninterrupted steps."""
    import torch

    from tests.torch_scenes import textile_samples
    from tti_torch.model.layers import BatchNorm
    from tti_torch.parallel.mesh import batch_slice
    from tti_torch.train.augment import build_device_dataset
    from tti_torch.train.checkpoint import latest_checkpoint, restore_train_state
    from tti_torch.train.loop import build_model, build_trainer, run

    t = TRAIN
    data = build_device_dataset(textile_samples(6, t["imgsz"], seed=5), t["imgsz"], t["max_gt"],
                                mask_stride=2, soft_masks="stitch", device="cpu")

    def trainer(m):
        model = build_model("n", 2, 2, "subpixel", torch.float32, "cpu", init=t["ckpt"])
        return build_trainer(data, model, t["batch"], t["max_gt"], t["total"], t["lr"],
                             torch.float32, t["gains"], seed=0, mesh=m)

    sharded, single = trainer(mesh), trainer(None)
    rows = batch_slice(mesh, t["batch"])
    arrays = {"rows": np.array([rows.start, rows.stop])}
    (img_s, tgt_s), (img_u, tgt_u) = sharded.batch(1), single.batch(1)
    arrays.update({"aug_sharded": img_s.numpy(), "aug_single_rows": img_u[rows].numpy()})
    for name in ("boxes", "classes", "masks", "valid"):
        arrays[f"tgt_sharded.{name}"] = getattr(tgt_s, name).numpy()
        arrays[f"tgt_single_rows.{name}"] = getattr(tgt_u, name)[rows].numpy()

    arrays["params_before"] = _flat(sharded.state)
    for tag, tr in (("sharded", sharded), ("single", single)):
        metrics = tr.train_step(1)
        arrays[f"loss_{tag}"] = np.array([float(metrics[k]) for k in sorted(metrics)])
        arrays[f"params1_{tag}"] = _flat(tr.state)
        arrays[f"bn_{tag}"] = torch.cat([
            torch.cat([m.running_mean, m.running_var]) for m in tr.state.model.modules()
            if isinstance(m, BatchNorm)]).numpy()
    run(sharded, 1, 3, log_every=0)
    arrays["state3"] = _flat(sharded.state, with_stats=True)

    first = trainer(mesh)
    run(first, 0, 2, out_dir, log_every=0, checkpoint_every=2)
    resumed = trainer(mesh)
    restore_train_state(latest_checkpoint(out_dir), resumed.state)
    run(resumed, resumed.state.step, 3, log_every=0)
    arrays["state3_resumed"] = _flat(resumed.state, with_stats=True)
    arrays["resumed_step"] = np.array(resumed.state.step)
    return arrays


def main(argv: list[str]) -> int:
    import torch

    from tti_torch.parallel import dcn
    from tti_torch.parallel.mesh import create_mesh

    case, workdir = argv
    torch.set_num_threads(1)
    assert dcn.init_distributed(device="cpu")  # the TTI_* triple, gloo
    try:
        shape = MESHES.get(case.split("_", 1)[0])
        mesh = create_mesh(*shape, device_type="cpu") if shape else create_mesh(device_type="cpu")
        if case == "train":
            arrays = _train(os.path.join(workdir, "ckpt"), mesh)
        elif case == "space_dump":
            arrays = _dump(dict(np.load(os.path.join(workdir, "inputs.npz"))), mesh)
        else:
            arrays = _inference(case, dict(np.load(os.path.join(workdir, "inputs.npz"))), mesh)
        np.savez(os.path.join(workdir, f"rank{dcn.rank()}.npz"), **arrays)
    finally:
        dcn.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
