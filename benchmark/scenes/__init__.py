"""Scene generators of the traffic, one module each, found by name: a
module ``benchmark/scenes/<name>.py`` defines ``maker(frame_hw)``, which
returns a function from a seed to one (H, W, 3) uint8 BGR frame."""

from __future__ import annotations

import importlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def render_pool(name: str, n: int, frame_hw: tuple[int, int], seed: int,
                threads: int = 4) -> np.ndarray:
    """``n`` distinct scenes of generator ``name``: scene ``i`` is drawn
    from the seed sequence ``(seed, i)``, so the pool is the same whatever
    the number of threads that render it."""
    make = importlib.import_module(f"benchmark.scenes.{name}").maker(tuple(frame_hw))
    with ThreadPoolExecutor(threads) as pool:
        return np.stack(list(pool.map(lambda i: make([seed, i]), range(n))))
