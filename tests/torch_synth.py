"""Seeded synthetic textile frames for checks of the inspection step.

A dark bench, a bright woven fabric band with a wavy top edge, and a row of
dark stitches straddling that edge: the scene the checkpoints were trained
on, drawn with numpy alone. Not a training-data generator.
"""

from __future__ import annotations

import numpy as np


def textile_frames(batch: int, height: int, width: int, seed: int = 0) -> np.ndarray:
    """(batch, height, width, 3) uint8 BGR frames."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    frames = np.empty((batch, height, width, 3), np.uint8)
    for i in range(batch):
        img = np.full((height, width, 3), rng.uniform(20, 50), np.float32)
        fy = rng.uniform(0.45, 0.6) * height
        edge = fy + rng.uniform(1, 4) * height / 240 * np.sin(
            xx * rng.uniform(2, 6) * np.pi / width + rng.uniform(0, 6.28))
        pitch = rng.uniform(4.0, 7.0) * width / 320
        weave = 0.08 * np.sin(xx * 2 * np.pi / pitch) + 0.08 * np.sin(yy * 2 * np.pi / pitch)
        tint = rng.uniform(0.7, 1.0, 3).astype(np.float32)
        fabric = yy >= edge
        img[fabric] = (200.0 * (0.85 + weave[..., None]) * tint)[fabric]
        n = int(rng.integers(5, 9))
        gap = width / (n + 1)
        hw, hh = 0.025 * width, 0.012 * height
        for k in range(n):
            cx = (k + 1) * gap + rng.normal(0, 0.01 * width)
            cy = fy + rng.uniform(0.0, 0.01) * height
            mark = (np.abs(xx - cx) <= hw) & (np.abs(yy - cy) <= hh)
            img[mark] = rng.uniform(10, 40)
        img += rng.normal(0, 4, size=img.shape)
        frames[i] = np.clip(img, 0, 255).astype(np.uint8)
    return frames
