"""Seeded synthetic training scenes with ground truth, drawn with numpy
alone: the textile scene of ``tests/torch_synth.py`` (dark bench, bright
woven fabric band with a wavy top edge, dark stitches straddling it), here
square, RGB, and with its labels: the fabric band as a polygon (class 1)
and each stitch as a quad (class 0), in normalised coordinates.
"""

from __future__ import annotations

import numpy as np

STITCH, FABRIC = 0, 1


def textile_scene(size: int, rng: np.random.Generator, edge_points: int = 17):
    """One (size, size, 3) uint8 RGB image, its polygons (each (K, 2)
    normalised) and their classes."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.full((size, size, 3), rng.uniform(20, 50), np.float32)
    fy = rng.uniform(0.45, 0.6) * size
    amp, freq, phase = rng.uniform(1, 4) * size / 240, rng.uniform(2, 6), rng.uniform(0, 6.28)
    edge_of = lambda x: fy + amp * np.sin(x * freq * np.pi / size + phase)
    pitch = rng.uniform(4.0, 7.0) * size / 320
    weave = 0.08 * np.sin(xx * 2 * np.pi / pitch) + 0.08 * np.sin(yy * 2 * np.pi / pitch)
    tint = rng.uniform(0.7, 1.0, 3).astype(np.float32)
    fabric = yy >= edge_of(xx)
    img[fabric] = (200.0 * (0.85 + weave[..., None]) * tint)[fabric]
    xs = np.linspace(0.0, size, edge_points)
    top = np.stack([xs, edge_of(xs)], -1)
    polygons = [np.concatenate([top, [[size, size], [0.0, size]]]) / size]
    classes = [FABRIC]
    n = int(rng.integers(5, 9))
    gap = size / (n + 1)
    hw, hh = 0.025 * size, 0.012 * size
    for k in range(n):
        cx = (k + 1) * gap + rng.normal(0, 0.01 * size)
        cy = fy + rng.uniform(0.0, 0.01) * size
        mark = (np.abs(xx - cx) <= hw) & (np.abs(yy - cy) <= hh)
        img[mark] = rng.uniform(10, 40)
        quad = np.array([[cx - hw, cy - hh], [cx + hw, cy - hh], [cx + hw, cy + hh],
                         [cx - hw, cy + hh]])
        polygons.append(np.clip(quad / size, 0.0, 1.0))
        classes.append(STITCH)
    img += rng.normal(0, 4, size=img.shape)
    return (np.clip(img, 0, 255).astype(np.uint8), [p.astype(np.float32) for p in polygons],
            classes)


def textile_samples(n: int, size: int, seed: int = 0):
    """``n`` scenes as ``tti_torch.train.data.Sample``s carrying their
    decoded images (no files)."""
    from tti_torch.train.data import Sample

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        img, polys, classes = textile_scene(size, rng)
        out.append(Sample(f"scene_{i:04d}", polys, classes, image=img))
    return out
