"""tti's detection contract for int8 (``tests/test_quantize.py:123-170``:
every float detection with score > 0.4 has an int8 detection of its class
at IoU > 0.9) on a configuration's frames, on the CPU in float32, for tti
and for the port: each package's int8 step against its own float32 step, on
the eight seeded textile frames ``chip_smoke.py``'s phase 5c holds in
float32 (deploy: 960x1280, imgsz 960, the cam checkpoint; headline:
1080x1920, imgsz 640), with bench.py's calibration and ROI. For each
package it prints the float detections with score > 0.4, those below IoU
0.9 and the lowest best IoUs (frame, class, score, best IoU). ``--nudge N``
then runs the port's int8 step N more times, each with its model input
moved by at most one float32 ulp per value (seeded), to show how far a
rounding difference alone moves the contract's IoUs. ``--card`` (on a
machine with a CUDA card; the port only) runs the port's float32 and int8
steps on the card and on the CPU in one process, prints how far the card's
model input and float32 detections are from the CPU's, and holds the
contract on the card, on the CPU, and on the CPU fed the card's model input
(which separates the preprocessing from the model's own arithmetic).

    JAX_PLATFORMS=cpu python tests/torch_int8_contract.py --config deploy \\
        --quant int8s --scales build/int8_smoke/scales_deploy.json

``--scales`` is an ``int8s`` calibration file (``tools/calibrate_int8_torch.py``
or ``tools/calibrate_int8.py``; ``chip_smoke.py`` writes its own under
``build/int8_smoke/``). Full-size frames: about a minute per pipeline on a
CPU and a few GiB of memory.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

FRAMES = 8  # chip_smoke's MODE_F32_BATCH: the float32 contract's frames


def best_ious(got, ref) -> list:
    """(frame, class, score, best IoU of an int8 detection of its class) for
    every float detection with score > 0.4, lowest IoU first."""
    out = []
    for b in range(ref.valid.shape[0]):
        keep = ref.valid[b] & (ref.scores[b] > cs.INT8_SCORE)
        qb, qc = got.boxes_frame[b][got.valid[b]], got.classes[b][got.valid[b]]
        for box, cls, score in zip(ref.boxes_frame[b][keep], ref.classes[b][keep],
                                   ref.scores[b][keep]):
            same = qc == cls
            best = float(cs.box_ious(box, qb[same]).max()) if same.any() else 0.0
            out.append((b, int(cls), round(float(score), 4), round(best, 4)))
    return sorted(out, key=lambda d: d[3])


def tti_outputs(config, quant, scales, frames):
    """tti's float32 step and its ``quant`` step (tti reads the switches
    from the environment) on ``frames``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from flax import serialization

    import tti.calib.io as jio
    import tti.core.config as jcfg
    from tti.parallel.runtime import InspectionPipeline
    from tti_torch.model.checkpoint import checkpoint_metadata

    hw, imgsz, ckpt = cs.CONFIGS[config]
    path = os.path.join(ROOT, "checkpoints", ckpt)
    meta = checkpoint_metadata(path)
    with open(path, "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    cal, roi = cs.bench_calibration(hw), cs.bench_roi(hw)
    model_cfg = jcfg.ModelConfig(variant="n", num_classes=2, image_size=imgsz,
                                 dtype="float32", mask_stride=meta.get("mask_stride", 4),
                                 proto_head=meta.get("proto_head", "deconv"))
    outs = []
    for q in ("", quant):
        os.environ["TTI_QUANT"] = q
        if scales:
            os.environ["TTI_QUANT_SCALES"] = scales
        pipe = InspectionPipeline(
            model_cfg, variables, hw,
            jio.CalibrationData(K=cal.K, dist=cal.dist, rvec=cal.rvec, tvec=cal.tvec),
            jcfg.MeasureConfig().with_subcell_from(meta),
            jcfg.RoiConfig(enabled=True, x_min=roi.x_min, x_max=roi.x_max, y_min=roi.y_min,
                           y_max=roi.y_max))
        o = pipe.process_batch(frames)
        outs.append(type("Outputs", (), {k: np.asarray(getattr(o, k)) for k in (
            "valid", "scores", "classes", "boxes_frame")}))
    return outs


def port_outputs(config, quant, scales, frames, nudge=0):
    """The port's float32 step and its ``quant`` step on the CPU, then the
    ``quant`` step again for each of ``nudge`` seeds with every value of its
    model input moved to a neighbouring float32 (or kept), at random."""
    import torch

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    hw, imgsz, ckpt = cs.CONFIGS[config]
    build = lambda **kw: cs.build_pipeline(torch, hw, imgsz, ckpt, dtype="float32",
                                           device="cpu", **kw)
    pipe = build(quant=quant, quant_scales=scales)
    outs = [build().process_batch(frames), pipe.process_batch(frames)]
    for seed in range(nudge):
        g = torch.Generator().manual_seed(seed)

        def move(m, args):
            x = args[0]
            step = torch.randint(-1, 2, x.shape, generator=g).to(x.dtype)
            return (torch.nextafter(x, x + step),)

        handle = pipe.model.register_forward_pre_hook(move)
        try:
            outs.append(pipe.process_batch(frames))
        finally:
            handle.remove()
    return outs


def card_against_cpu(config, quant, scales, frames) -> None:
    """See ``--card`` in the module docstring."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    hw, imgsz, ckpt = cs.CONFIGS[config]
    quant_kw = {"quant": quant, "quant_scales": scales}
    inputs, outs = {}, {}
    for device in ("cuda", "cpu"):
        for q in ("", quant):
            pipe = cs.build_pipeline(torch, hw, imgsz, ckpt, dtype="float32", device=device,
                                     **(quant_kw if q else {}))
            seen = {}

            def grab(m, args):
                seen["x"] = args[0].detach().cpu()

            handle = pipe.model.register_forward_pre_hook(grab)
            outs[device, q] = pipe.process_batch(frames)
            handle.remove()
            inputs[device, q] = seen["x"]
            if device == "cpu":  # the same CPU model fed the card's model input
                card_x = inputs["cuda", q]
                handle = pipe.model.register_forward_pre_hook(lambda m, args: (card_x,))
                outs["cpu, card input", q] = pipe.process_batch(frames)
                handle.remove()
            del pipe
    d = (inputs["cuda", ""] - inputs["cpu", ""]).abs()
    print(f"model input, card against CPU: max |diff| {float(d.max()):.3g} in "
          f"{int((d > 0).sum())} of {d.numel()} values", flush=True)
    card, cpu = outs["cuda", ""], outs["cpu", ""]
    ious = best_ious(cpu, card)
    print(f"float32 detections, card against CPU: {int(card.valid.sum())} against "
          f"{int(cpu.valid.sum())}; those with score > {cs.INT8_SCORE} on the card, lowest "
          f"IoU with a CPU detection of their class: {ious[:3]}", flush=True)
    for where in ("cuda", "cpu", "cpu, card input"):
        ious = best_ious(outs[where, quant], outs[where, ""])
        below = [x for x in ious if x[3] <= cs.INT8_IOU]
        print(f"port {config} {quant} float32 on {where}: {len(ious) - len(below)} of "
              f"{len(ious)} kept at IoU > {cs.INT8_IOU}; lowest: {ious[:3]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(cs.CONFIGS), default="deploy")
    ap.add_argument("--quant", choices=["int8", "int8s"], default="int8")
    ap.add_argument("--scales", help="the int8s calibration file")
    ap.add_argument("--package", choices=["tti", "port", "both"], default="both")
    ap.add_argument("--nudge", type=int, default=0,
                    help="the port's int8 step again on N seeded one-ulp moves of its input")
    ap.add_argument("--card", action="store_true",
                    help="the port on the card against the port on the CPU")
    args = ap.parse_args()
    if args.quant == "int8s" and not args.scales:
        ap.error("--quant int8s needs --scales")
    frames = cs.textile(cs.CONFIGS[args.config][0], FRAMES)
    if args.card:
        card_against_cpu(args.config, args.quant, args.scales, frames)
        return 0
    for name, run in (("tti", tti_outputs), ("port", port_outputs)):
        if args.package not in (name, "both"):
            continue
        t0 = time.perf_counter()
        extra = {"nudge": args.nudge} if name == "port" else {}
        ref, *gots = run(args.config, args.quant, args.scales, frames, **extra)
        for i, got in enumerate(gots):
            ious = best_ious(got, ref)
            below = [d for d in ious if d[3] <= cs.INT8_IOU]
            label = f" (input nudged, seed {i - 1})" if i else ""
            print(f"{name} {args.config} {args.quant} float32{label}: {len(ious) - len(below)} "
                  f"of {len(ious)} float detections > {cs.INT8_SCORE} kept at IoU > "
                  f"{cs.INT8_IOU}; below: {below}; lowest: {ious[:3]} "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
