"""The benchmark of ``tti_torch`` on NVIDIA cards: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It renders the cell's frames from the seed, builds the program, warms up
the cell's batch shape (all of that is ``setup_s``), runs the closed loop
for ``--seconds``, and with ``--trace 1`` runs a traced segment of the
same loop after the window. Then it frees the program, checks a sample
of the window's outputs against the plain reference, prints each compared
number beside its limit as the last lines of standard error, and prints
the result as one JSON object, the last line of standard output. It exits
with 1, printing no result, when the card the cell asks for is not there
or when JAX or the JAX package has been loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def environment() -> None:
    """The program under its defaults, its caches inside the checkout."""
    for key in [k for k in os.environ if k.startswith("TTI_")]:
        del os.environ[key]
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    from benchmark.harness import NoCard, run

    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace), ROOT, T_START)
    except NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 1
    except RuntimeError as e:
        if "JAX" in str(e):
            print(f"no result: {e}", file=sys.stderr)
            return 1
        raise
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
