#!/usr/bin/env python3
"""``python -m tti_torch.cli train`` on every card of this host against the
same run on one card.

    python tools/train_cards_torch.py [--imgsz 320] [--scenes 8] [--out build/train_cards]

Writes ``--scenes`` seeded synthetic scenes (``tests/torch_scenes.py``) as
a YOLO directory, then runs one float32 step at the global batch of all
the scenes twice: on every local card (the command starts one process per
card, NCCL; the batch must split over the cards) and on card 0 alone
(``CUDA_VISIBLE_DEVICES=0``), TF32 off in both (``NVIDIA_TF32_OVERRIDE=0``).
The two final checkpoints are held to ``__graft_entry__.py``'s bar for a
sharded step: every parameter within 2.2 learning rates (the first AdamW
update is a sign for any gradient above eps), under 0.5% of them apart by
more than 1e-4, the BatchNorm running statistics within 1e-5 relative.
Only the many-card run's rank 0 may write. Prints the card's name and
power limit, the cards, each run's wall time (process start included) and
the readings; exits 1 when a check fails. Needs CUDA and OpenCV (the
dataset's image files).
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3


def write_dataset(root: str, n: int, imgsz: int) -> str:
    import cv2

    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    from torch_scenes import textile_samples

    images, labels = os.path.join(root, "images"), os.path.join(root, "labels")
    for d in (images, labels):
        os.makedirs(d, exist_ok=True)
    for i, s in enumerate(textile_samples(n, imgsz, seed=7)):
        cv2.imwrite(os.path.join(images, f"s_{i}.png"), np.ascontiguousarray(s.image[..., ::-1]))
        with open(os.path.join(labels, f"s_{i}.txt"), "w") as f:
            f.write("\n".join(f"{c} " + " ".join(f"{v:.6f}" for v in p.ravel())
                              for p, c in zip(s.polygons, s.classes)))
    return images


def train(images: str, out: str, imgsz: int, batch: int, env_extra: dict) -> tuple[float, str]:
    env = dict(os.environ, PYTHONPATH=HERE, NVIDIA_TF32_OVERRIDE="0", **env_extra)
    for name in ("TTI_COORDINATOR", "TTI_NUM_PROCESSES", "TTI_PROCESS_ID"):
        env.pop(name, None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tti_torch.cli", "train", "--images", images,
                           "--out", out, "--imgsz", str(imgsz), "--batch-size", str(batch),
                           "--epochs", "1", "--max-gt", "16", "--log-every", "1", "--dtype",
                           "f32", "--lr", str(LR)], cwd=HERE, env=env, capture_output=True,
                          text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise SystemExit(f"train into {out} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                         f"{proc.stderr[-3000:]}")
    return wall, proc.stdout


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--imgsz", type=int, default=320)
    parser.add_argument("--scenes", type=int, default=8, help="the global batch: one step")
    parser.add_argument("--out", default=os.path.join(HERE, "build", "train_cards"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("train_cards_torch: no CUDA device", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    shutil.rmtree(args.out, ignore_errors=True)
    images = write_dataset(os.path.join(args.out, "data"), args.scenes, args.imgsz)
    runs = {"every_card": os.path.join(args.out, "every_card"),
            "one_card": os.path.join(args.out, "one_card")}
    wall_all, log_all = train(images, runs["every_card"], args.imgsz, args.scenes, {})
    wall_one, _ = train(images, runs["one_card"], args.imgsz, args.scenes,
                        {"CUDA_VISIBLE_DEVICES": "0"})
    written = {k: sorted(os.listdir(v)) for k, v in runs.items()}
    payloads = {k: torch.load(os.path.join(v, "step_1.pt"), map_location="cpu",
                              weights_only=True) for k, v in runs.items()}
    a, b = payloads["every_card"]["model"], payloads["one_card"]["model"]
    params = [k for k in a if "running" not in k and a[k].is_floating_point()]
    stats = [k for k in a if "running" in k]
    d = np.concatenate([(a[k] - b[k]).abs().numpy().ravel() for k in params])
    s = max(float(((a[k] - b[k]).abs() / b[k].abs().clamp(min=1.0)).max()) for k in stats)
    ok = (written == {"every_card": ["step_1.pt"], "one_card": ["step_1.pt"]}
          and f"training on {cards} local cards" in log_all
          and d.max() <= 2.2 * LR and (d > 1e-4).mean() < 5e-3 and s <= 1e-5)
    print(f"{cards} cards, global batch {args.scenes} at imgsz {args.imgsz}, one float32 step: "
          f"every card {wall_all:.1f} s, one card {wall_one:.1f} s (wall, process start "
          f"included); parameters max |diff| {d.max() / LR:.3g} lr, share > 1e-4 "
          f"{(d > 1e-4).mean():.3g}; running statistics max relative diff {s:.3g}; "
          f"written {written}: {'ok' if ok else 'FAILED'}", flush=True)
    print(smi.stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
