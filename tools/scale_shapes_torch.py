#!/usr/bin/env python3
"""Kernel F's block shape on the card: variants of ``csrc/int8conv.cu``'s
F (threads per block, resident blocks per SM, vector loads in flight per
thread) built alone, each launched at several blocks per sample, timed in
turns on the deploy int8 forward's inputs at batch 128 and at batch 1.

    python tools/scale_shapes_torch.py [--out build/scale_shapes.json]

Each variant is F's source with its three constants replaced (and, for the
batch-1 rows, clusters of up to 16 blocks, the non-portable size, and
optionally enough dynamic shared memory that one block fills an SM); it is
compiled by nvcc into ``build/`` and launched through its own C function
with ``int8conv.scale_plan``'s route and vector width, the blocks per
sample set by the row. The inputs keep the forward's layouts (channel
slices, the stem's padded input) at random bf16 values; every launch is
held bit-equal to ``act_scale_per_sample_plain``. Times are CUDA-event
means of 20 calls, L2 flushed before each, every configuration twice in
the order forward then reversed (the spread of the two is printed beside
the mean). The card's name and power limit come first and last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import threading

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(HERE, "tti_torch", "kernels", "csrc", "int8conv.cu")

# name: (threads per block, resident blocks per SM, vector loads per thread)
SHAPES = {"T512U4P4": (512, 4, 4), "T256U4P8": (256, 8, 4), "T512U8P2": (512, 2, 8),
          "T1024U4P2": (1024, 2, 4)}
SPREAD_SMEM = 120 * 1024  # more than half an SM's shared memory: one block per SM
# (shape, blocks per sample, dynamic shared memory) of each timed configuration
ROWS = {128: [("T512U4P4", 4, 0), ("T512U4P4", 8, 0), ("T512U4P4", 2, 0), ("T256U4P8", 8, 0),
              ("T512U8P2", 2, 0), ("T1024U4P2", 2, 0), ("T512U8P2", 4, 0)],
        1: [("T512U4P4", 8, 0), ("T512U4P4", 16, 0), ("T512U4P4", 16, SPREAD_SMEM),
            ("T512U8P2", 16, SPREAD_SMEM), ("T1024U4P2", 16, SPREAD_SMEM),
            ("T1024U4P2", 8, SPREAD_SMEM), ("T1024U4P2", 8, 0), ("T256U4P8", 16, SPREAD_SMEM)]}
INPUTS = ("m0s2d", "m1", "m2.m0.cv1", "m4.cv1", "m4.cv2", "m6.m0.cv2", "m8.m0.cv1",
          "m22.cv4_2_1", "m22.proto.cv2", "m2.cv2", "m6.cv1")


def f_source(threads: int, blocks_per_sm: int, unroll: int, text: str | None = None) -> str:
    """F alone from int8conv.cu (its constants, device code and C function),
    with these constants, clusters of up to 16 blocks and a setter of the
    launch's dynamic shared memory, ``tti_f_set_smem``."""
    lines = (text if text is not None else open(SOURCE).read()).split("\n")

    def find(prefix, start=0):
        return next(i for i in range(start, len(lines)) if lines[i].startswith(prefix))

    c0, c1 = find("// F: threads per block"), find("constexpr float kRcp127")
    f0 = find("// Kernel F", c1) - 1
    f1 = find("}  // namespace", f0)
    body = "\n".join(lines[c0:c1 + 1] + lines[f0:f1])
    for name, value in (("kFThreads", threads), ("kFBlocksPerSm", blocks_per_sm),
                        ("kFUnroll", unroll), ("kFMaxCluster", 16)):
        head = f"constexpr int {name} = "
        i = body.index(head)
        body = body[:i] + f"{head}{value};" + body[body.index("\n", i):]
    body = body.replace("  cfg.stream = stream;\n", """  cfg.stream = stream;
  cfg.dynamicSmemBytes = g_smem;
  cudaFuncSetAttribute(act_absmax_kernel<S, V, kRoute>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, g_smem);
  cudaFuncSetAttribute(act_absmax_kernel<S, V, kRoute>,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
""")
    ext = "\n".join(lines[find("// Kernel F (see the header"):])
    return ("#include <cooperative_groups.h>\n#include <cuda.h>\n#include <cuda_runtime.h>\n"
            "#include <stdint.h>\nnamespace cg = cooperative_groups;\nnamespace {\n"
            "int g_smem = 0;\n" + body + "\n}  // namespace\n\nextern \"C\" {\n"
            "void tti_f_set_smem(int s) { g_smem = s; }\n\n" + ext + "\n")


def build_shape(name: str, shape: tuple) -> ctypes.CDLL:
    from tti_torch.kernels import build as kbuild

    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, out = kbuild.BUILD_DIR / f"scale_{name}.cu", kbuild.BUILD_DIR / f"libscale_{name}.so"
    src.write_text(f_source(*shape))
    subprocess.run([kbuild.nvcc(), *kbuild.NVCC_FLAGS, "-o", str(out), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    lib.tti_act_scale_per_sample.argtypes = [p, ll, ll, ll, ll, i, i, i, i, i, i, i, u, i, u, i,
                                             i, p, p]
    lib.tti_act_scale_per_sample.restype = i
    lib.tti_f_set_smem.argtypes = [i]
    return lib


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the readings here as JSON")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("scale_shapes_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_torch_int8_plan import block_inputs

    from tti_torch.kernels import int8conv as ik

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs, errors = {}, []

    def work(name):
        try:
            libs[name] = build_shape(name, SHAPES[name])
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(n,)) for n in SHAPES]
    [t.start() for t in threads]
    [t.join() for t in threads]
    if errors:
        raise errors[0]
    flush_buf = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def time_ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            flush_buf.zero_()
            torch.cuda._sleep(1_000_000)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    def launch(name, x, cluster, smem):
        pl = ik.scale_plan(tuple(x.shape), x.stride(), x.element_size(), x.data_ptr())
        (_, n1, n2), (s0, s1, s2) = pl.dims, pl.strides
        out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
        libs[name].tti_f_set_smem(smem)
        err = libs[name].tti_act_scale_per_sample(
            x.data_ptr(), x.stride(0), s0, s1, s2, x.shape[0], 1, pl.route, pl.vec, pl.units,
            n1, n2, *ik.fast_div(n1), *ik.fast_div(n2), cluster, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} at {cluster} blocks per sample: cudaError {err}")
        return out

    layouts = {n: (sh, st, off) for n, sh, st, off, *_ in block_inputs("deploy") if n in INPUTS}
    readings = {}
    for batch, rows in ROWS.items():
        print(f"batch {batch}: ms (spread) for " + ", ".join(
            f"{n} x{cl}{' spread' if smem else ''}" for n, cl, smem in rows), flush=True)
        for name, (shape, strides, offset) in layouts.items():
            flat = (torch.randn(batch * strides[0] + offset // 2 + 8, device="cuda") * 3).to(
                torch.bfloat16)
            x = torch.as_strided(flat, (batch, *shape[1:]), strides, offset // 2)
            want = ik.act_scale_per_sample_plain(x)
            times = [[] for _ in rows]
            for i in list(range(len(rows))) + list(reversed(range(len(rows)))):
                shp, cluster, smem = rows[i]
                fn = lambda: launch(shp, x, cluster, smem)
                if not torch.equal(fn(), want):
                    raise AssertionError(f"{shp} x{cluster} differs from the plain version "
                                         f"on {name}")
                times[i].append(time_ms(fn))
            bound = (x.numel() * 2 + 4 * batch) / 3.35e12 * 1e3
            readings[f"{name} batch {batch}"] = {"bound_ms": bound, "rows": [
                {"shape": r[0], "cluster": r[1], "smem": r[2], "ms": t} for r, t in zip(rows, times)]}
            print(f"  {name:14s} bound {bound:.4f}: " + "  ".join(
                f"{sum(t) / 2:.4f}({max(t) - min(t):.4f})" for t in times), flush=True)
            del x, flat
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w") as f:
            json.dump({"card": card, "readings": readings}, f)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
