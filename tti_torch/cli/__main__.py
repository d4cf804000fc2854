"""Command line of the port: ``python -m tti_torch.cli <command>``.

    train            train a segmentation model on a YOLO-format dataset
    export-weights   the deploy msgpack + sidecar from a training checkpoint

The flags are ``tti``'s, plus ``--device`` (default cuda) and ``--init``
(start from a deploy checkpoint's params and batch stats). ``--host-aug``
(the reference's cv2 host augmentation) is refused: training augments on
the device.
"""

from __future__ import annotations

import argparse
import sys


def cmd_train(args) -> int:
    from tti_torch.train.data import discover_dataset
    from tti_torch.train.loop import train

    if args.host_aug:
        print("--host-aug is not ported: tti_torch augments on the device. The host "
              "recipe is ROADMAP Queue 1 item 3 (--host-aug).", file=sys.stderr)
        return 1
    path = train(discover_dataset(args.images), args.out, variant=args.variant,
                 num_classes=args.num_classes, imgsz=args.imgsz, batch_size=args.batch_size,
                 epochs=args.epochs, lr=args.lr, max_gt=args.max_gt, log_every=args.log_every,
                 checkpoint_every=args.checkpoint_every, resume=args.resume,
                 mask_stride=args.mask_stride, proto_head=args.proto_head,
                 stitch_seg_gain=args.stitch_seg_gain, soft_masks=args.soft_masks,
                 dtype=args.dtype, device=args.device, init=args.init,
                 log=lambda line: print(line, flush=True))
    print("final checkpoint:", path)
    return 0


def cmd_export_weights(args) -> int:
    from tti_torch.train.loop import export_weights

    export_weights(args.train_dir, args.out, variant=args.variant, num_classes=args.num_classes,
                   imgsz=args.imgsz, mask_stride=args.mask_stride, proto_head=args.proto_head,
                   soft_masks=args.soft_masks, recipe=args.recipe)
    print("deploy checkpoint:", args.out)
    print("sidecar:", args.out + ".json")
    return 0


def _soft_masks_flag(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--soft-masks", nargs="?", const="all", default=None,
                   help=f"{what} (all | stitch | fabric | comma ids; bare flag = all)")


def _architecture_flags(p: argparse.ArgumentParser, imgsz: int) -> None:
    p.add_argument("--variant", default="n")
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--imgsz", type=int, default=imgsz)
    p.add_argument("--mask-stride", type=int, default=4, choices=[2, 4],
                   help="proto grid = imgsz / mask_stride (2: the hi-res proto head)")
    p.add_argument("--proto-head", default="deconv", choices=["deconv", "subpixel"],
                   help="mask_stride=2 second stage: learned deconv or sub-pixel conv")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m tti_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("export-weights",
                       help="export a deploy msgpack + sidecar from a training checkpoint (EMA)")
    p.add_argument("--train-dir", required=True,
                   help="a run directory (its newest step_N.pt) or one step_N.pt")
    p.add_argument("--out", required=True, help="output .msgpack path")
    _architecture_flags(p, 960)
    _soft_masks_flag(p, "record which classes trained with area-occupancy targets")
    p.add_argument("--recipe", default="", help="free-text provenance line for the sidecar")
    p.set_defaults(func=cmd_export_weights)

    p = sub.add_parser("train", help="train a segmentation model (YOLO-format data)")
    p.add_argument("--images", required=True, help="dataset images directory")
    p.add_argument("--out", default="checkpoints")
    _architecture_flags(p, 640)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--max-gt", type=int, default=32)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint in --out (replays the "
                        "step-indexed batch stream)")
    p.add_argument("--stitch-seg-gain", type=float, default=1.0,
                   help="extra seg-loss weight on stitch-class positives")
    _soft_masks_flag(p, "area-occupancy mask targets for these classes")
    p.add_argument("--host-aug", action="store_true",
                   help="the reference's cv2 host augmentation: not ported, refused")
    p.add_argument("--dtype", default="bf16", choices=["f32", "bf16"],
                   help="convolution compute dtype (parameters and loss stay float32)")
    p.add_argument("--device", default="cuda", help="torch device (cpu only when asked)")
    p.add_argument("--init", default=None, metavar="CHECKPOINT",
                   help="start from a deploy msgpack's params and batch stats")
    p.set_defaults(func=cmd_train)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
