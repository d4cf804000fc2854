"""Device auto-tuner of the port (``tti_torch``): the counterpart of
``tools/tune_device.py``. It sweeps the runtime switches on the user's card
and geometry and writes the winning configuration as ``.env`` lines.

Every switch of the step that won on one shape and lost on another stays
behind an environment gate; which one wins depends on the batch, the frame
geometry, the model and the card, which differ per deployment. This tool
times them on the deployment, as ``tti``'s does, and writes the best set.

Usage (the card by default; ``--device cpu`` on the host):
  python tools/tune_device_torch.py --batches 1,128 --out tune.env
  python -m tti_torch.cli tune-device           # the same, through the CLI

Method per trial, ``tti``'s: every gate is popped from ``os.environ``, the
trial's gates are set, a fresh ``InspectionPipeline`` is built through the
reading of the environment that ``run`` uses
(:meth:`tti_torch.core.config.RuntimeSwitches.from_env`), one warm-up step
runs and the round trip of a scalar fetch of the scores is timed; frames/s
comes from ``--iters`` steps behind one fetch, the p50 from ``--lat-iters``
synced steps less that round trip; every gate is popped after the trial.
A trial that cannot run here (a switch with no counterpart in the port, the
refused ``TTI_APPROX_TOPK``) gets a row whose ``error`` says why.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tti_torch.core.config import APPROX_TOPK_REFUSAL, NO_COUNTERPART  # noqa: E402

# The port's runtime switches (RuntimeSwitches.from_env reads them): every
# trial starts from none of them set, so it does not depend on the caller's
# environment.
GATES = ["TTI_REMAP", "TTI_WARP_S2D", "TTI_WARP_BLOCKED", "TTI_WARP_COLEXPAND",
         "TTI_LAZY_DECODE", "TTI_FUSED_HEAD", "TTI_FOLDED_BN", "TTI_MASKSTATS_LOGITS",
         "TTI_APPROX_TOPK", "TTI_QUANT", "TTI_QUANT_SCALES"]

# tti's trials, in tti's order, under tti's names.
TRIALS: list[tuple[str, dict[str, str]]] = [
    ("baseline", {}),
    ("maskstats=pallas_batched", {"TTI_MASKSTATS": "pallas_batched"}),
    ("maskstats=pallas2", {"TTI_MASKSTATS": "pallas2"}),
    ("maskstats_logits=bf16", {"TTI_MASKSTATS_LOGITS": "bf16"}),
    ("warp_s2d=0", {"TTI_WARP_S2D": "0"}),
    ("warp_blocked=64", {"TTI_WARP_BLOCKED": "64"}),
    ("approx_topk=1", {"TTI_APPROX_TOPK": "1"}),
    ("quant=int8", {"TTI_QUANT": "int8"}),
]

# Exact trials may win the tune outright; approximate and quantized ones
# (the bf16 mask logits among them) win only with --allow-approx.
EXACT_TRIALS = {t for t, env in TRIALS if "TTI_APPROX_TOPK" not in env
                and "TTI_QUANT" not in env and "TTI_MASKSTATS_LOGITS" not in env}

# bench.py's geometry (the deployment's intrinsics scaled to the frame, its
# distortion and extrinsics), as tti's tool builds it.
K_1280x960 = np.array([[937.1384518987244, 0.0, 636.148901113533],
                       [0.0, 884.022038878419, 422.3901781816556],
                       [0.0, 0.0, 1.0]])
DIST = np.array([0.07994929130530135, 0.04758675999900327, -0.04013555042332606,
                 -0.005228657034776396, -0.1334157094005971])
RVEC = np.array([-0.8631369244225452, -0.3919482615538663, -1.3591256137314185])
TVEC = np.array([0.005016396186926285, 0.03590342712705542, 0.09382141278570659])


def build_pipeline(batch: int, imgsz: int, frame_hw: tuple[int, int], variant: str, dtype: str,
                   mask_stride: int = 4, proto_head: str = "deconv", subcell: bool = False,
                   device: str = "cuda"):
    """The inspection step at ``frame_hw`` and ``imgsz`` under the
    environment's switches, with a fresh model's weights (seed 0). A switch
    that the port refuses, or has no counterpart for, raises
    ``ConfigError``."""
    import torch

    from tti_torch.calib.io import CalibrationData
    from tti_torch.core.config import MeasureConfig, ModelConfig, RoiConfig, RuntimeSwitches
    from tti_torch.core.errors import ConfigError
    from tti_torch.model.checkpoint import to_flax_variables
    from tti_torch.model.yolo import init_model
    from tti_torch.parallel.runtime import InspectionPipeline

    switches = RuntimeSwitches.from_env(os.environ)
    if switches.approx_topk:
        raise ConfigError(APPROX_TOPK_REFUSAL)
    frame_h, frame_w = frame_hw
    K = K_1280x960.copy()
    K[0] *= frame_w / 1280
    K[1] *= frame_h / 960
    calib = CalibrationData(K=K, dist=DIST, rvec=RVEC, tvec=TVEC)
    model = init_model(variant, 2, mask_stride, proto_head, torch.Generator().manual_seed(0))
    cfg = ModelConfig(variant=variant, num_classes=2, image_size=imgsz, dtype=dtype,
                      mask_stride=mask_stride, proto_head=proto_head)
    return InspectionPipeline(
        cfg, to_flax_variables(model.state_dict()), frame_hw, calibration=calib,
        # --subcell times the soft checkpoints' as-deployed readout.
        measure_cfg=MeasureConfig(subcell_edge=subcell),
        roi=RoiConfig(enabled=True, x_min=10, x_max=frame_w - 10, y_min=300,
                      y_max=frame_h - 200),
        device=device, **switches.pipeline_kwargs())


@dataclasses.dataclass
class TrialResult:
    name: str
    batch: int
    fps: float
    p50_ms: float
    compile_s: float
    error: str | None = None


def no_counterpart(env: dict[str, str]) -> str | None:
    """Why a trial's gates cannot run here: the reason of each gate that the
    port has no counterpart for, or None."""
    names = [g for g in env if g in NO_COUNTERPART]
    return "; ".join(f"{g} has no counterpart in tti_torch: {NO_COUNTERPART[g]}"
                     for g in names) or None


def run_trial(name: str, env: dict[str, str], batch: int, imgsz: int,
              frame_hw: tuple[int, int], variant: str, dtype: str, iters: int, lat_iters: int,
              mask_stride: int = 4, proto_head: str = "deconv", subcell: bool = False,
              device: str = "cuda") -> TrialResult:
    import torch

    why = no_counterpart(env)
    if why is not None:
        return TrialResult(name, batch, 0.0, float("inf"), 0.0, error=why)
    for g in GATES:
        os.environ.pop(g, None)
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        pipe = build_pipeline(batch, imgsz, frame_hw, variant, dtype, mask_stride=mask_stride,
                              proto_head=proto_head, subcell=subcell, device=device)
        rng = np.random.default_rng(0)
        frames = torch.from_numpy(rng.integers(0, 255, size=(batch, *frame_hw, 3),
                                               dtype=np.uint8)).to(device)

        def sync(outs) -> float:
            return float(outs["dets"].scores.float().sum())

        out = pipe.step(frames)
        sync(out)
        compile_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        sync(out)
        roundtrip = time.perf_counter() - t0

        t0 = time.perf_counter()
        for _ in range(iters):
            out = pipe.step(frames)
        sync(out)
        fps = batch * iters / max(time.perf_counter() - t0 - roundtrip, 1e-9)

        lats = []
        for _ in range(lat_iters):
            t1 = time.perf_counter()
            sync(pipe.step(frames))
            lats.append(time.perf_counter() - t1)
        # Less the scalar fetch's own round trip, as tti's tool does.
        p50 = max(float(np.median(lats)) - roundtrip, 0.0) * 1e3
        res = TrialResult(name, batch, fps, p50, compile_s)
    except Exception as e:  # a trial that cannot run here is reported, not raised
        res = TrialResult(name, batch, 0.0, float("inf"), 0.0, error=f"{type(e).__name__}: {e}")
    finally:
        for g in (*GATES, *env):
            os.environ.pop(g, None)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return res


def platform(device: str) -> str:
    """``cuda`` and the card's name, or ``cpu``: the header's platform."""
    import torch

    if torch.device(device).type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(torch.device(device))})"
    return "cpu"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="1,128", help="comma list of batch sizes to tune")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--frame-h", type=int, default=1080)
    ap.add_argument("--frame-w", type=int, default=1920)
    ap.add_argument("--variant", default="n")
    ap.add_argument("--mask-stride", type=int, default=4, choices=[2, 4],
                    help="proto-head stride (2 = the hi-res deploy arch)")
    ap.add_argument("--proto-head", default="deconv", choices=["deconv", "subpixel"],
                    help="mask_stride=2 second stage architecture")
    ap.add_argument("--subcell", action="store_true",
                    help="time the sub-cell (soft-checkpoint) boundary readout, the "
                         "as-deployed measure path for soft-mask-trained sidecars")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--lat-iters", type=int, default=15)
    ap.add_argument("--trials", default="", help="comma list of trial names to run (default: all)")
    ap.add_argument("--allow-approx", action="store_true",
                    help="let approximate/quantized trials win the tune (they are always "
                         "measured and reported)")
    ap.add_argument("--int8-scales", default="",
                    help="activation-scale JSON (tools/calibrate_int8_torch.py): adds a "
                         "quant=int8s trial for this architecture; the file's block keys must "
                         "match the swept architecture")
    ap.add_argument("--out", default="tune.env")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    trials = list(TRIALS)
    if args.int8_scales:
        trials.append(("quant=int8s", {"TTI_QUANT": "int8s",
                                       "TTI_QUANT_SCALES": os.path.abspath(args.int8_scales)}))
    if args.trials:
        keep = set(args.trials.split(","))
        trials = [t for t in trials if t[0] in keep]
    batches = [int(b) for b in args.batches.split(",")]
    frame_hw = (args.frame_h, args.frame_w)

    results: list[TrialResult] = []
    for batch in batches:
        for name, env in trials:
            r = run_trial(name, env, batch, args.imgsz, frame_hw, args.variant, args.dtype,
                          args.iters, args.lat_iters, mask_stride=args.mask_stride,
                          proto_head=args.proto_head, subcell=args.subcell, device=args.device)
            results.append(r)
            if r.error:
                print(f"[batch {batch:4d}] {name:28s} FAILED: {r.error}", flush=True)
            else:
                print(f"[batch {batch:4d}] {name:28s} {r.fps:9.1f} frames/s  "
                      f"p50 {r.p50_ms:7.2f} ms  (compile {r.compile_s:.0f}s)", flush=True)

    # Winners: throughput at the largest batch, latency at the smallest;
    # approximate and quantized trials only with --allow-approx.
    def eligible(r: TrialResult) -> bool:
        return r.error is None and (args.allow_approx or r.name in EXACT_TRIALS)

    big, small = max(batches), min(batches)
    thr = [r for r in results if r.batch == big and eligible(r)]
    lat = [r for r in results if r.batch == small and eligible(r)]
    best_thr = max(thr, key=lambda r: r.fps) if thr else None
    best_lat = min(lat, key=lambda r: r.p50_ms) if lat else None

    env_of = dict(trials)
    lines = [f"# tti device tune — {time.strftime('%Y-%m-%d %H:%M:%S')}",
             f"# geometry: {frame_hw[0]}x{frame_hw[1]} imgsz={args.imgsz} "
             f"variant={args.variant} dtype={args.dtype} platform={platform(args.device)}"]
    if best_thr:
        lines.append(f"# throughput winner at batch {big}: {best_thr.name} "
                     f"({best_thr.fps:.1f} frames/s)")
        for k, v in env_of[best_thr.name].items():
            lines.append(f"{k}={v}")
    if best_lat and best_lat.name != (best_thr.name if best_thr else None):
        lines.append(f"# latency winner at batch {small}: {best_lat.name} "
                     f"(p50 {best_lat.p50_ms:.2f} ms) — for small-batch "
                     f"deployments use instead:")
        for k, v in env_of[best_lat.name].items():
            lines.append(f"# {k}={v}")
        # The batch range where the latency winner beats the baseline, as
        # measured (sweep more batches to tighten the crossover).
        base = {r.batch: r for r in results if r.name == "baseline" and r.error is None}
        mine = {r.batch: r for r in results if r.name == best_lat.name and r.error is None}
        shared = sorted(set(base) & set(mine))
        wins = [b for b in shared if mine[b].fps > base[b].fps]
        if wins and len(shared) > 1:
            losses = [b for b in shared if b not in wins]
            hi = min((b for b in losses if b > max(wins)), default=None)
            if hi is None:
                lines.append(f"# {best_lat.name} beats baseline at every "
                             f"measured batch ({shared[0]}..{shared[-1]})")
            else:
                lines.append(f"# {best_lat.name} wins at batch <= {max(wins)}"
                             f"; baseline wins from batch {hi} up "
                             f"(crossover inside ({max(wins)}, {hi}))")
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(args.out + ".json", "w") as f:
        json.dump([dataclasses.asdict(r) for r in results], f, indent=1)
    print(f"wrote {args.out} (+.json)")


if __name__ == "__main__":
    main()
