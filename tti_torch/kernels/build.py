"""Build-and-load helper shared by the CUDA kernel modules, and their
operator registrations.

Each kernel source under ``csrc/`` becomes one shared library with a plain C
interface: compiled by nvcc at first use into ``build/`` at the repository
root, keyed by a hash of the source and the flags, and loaded with ctypes.
Nothing is built when a module is imported.

Each kernel is one operator ``torch.ops.tti_torch.<name>``
(:func:`register_op`): its CPU implementation is the kernel's plain version,
its CUDA implementation the ctypes launch, and its fake implementation gives
the output's shapes, dtypes and strides without touching data, so that
``torch.export`` records the operator in a traced step. The live step calls
the same operators. They are registered with ``torch.library.Library``
rather than the ``custom_op`` decorator, whose Python wrapper costs more host
time per call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_logs: dict[str, str] = {}  # source name -> ptxas' register/spill report


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def compile_source(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (once per source hash); returns the library's path."""
    src = CSRC / f"{name}.cu"
    tag = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libtti_{name}_{tag}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{build_logs[name]}")
        os.replace(tmp, out)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, compiled if need be. The caller
    sets ``argtypes`` and ``restype`` on its functions."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(compile_source(name)))
        return _libs[name]


def compile_all(names: tuple[str, ...]) -> None:
    """Compile several sources at once, one nvcc process each."""
    errors: list[BaseException] = []

    def work(name: str) -> None:
        try:
            compile_source(name)
        except BaseException as e:  # re-raised below, in the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


_ops = torch.library.Library("tti_torch", "FRAGMENT")


def register_op(schema: str, cpu: Callable, cuda: Callable, fake: Callable):
    """Define ``tti_torch::<name>`` by its ``schema``, with a CPU, a CUDA and
    a fake implementation; returns the operator's overload, the object the
    wrappers call."""
    name = schema.split("(", 1)[0]
    _ops.define(schema)
    _ops.impl(name, cpu, "CPU")
    _ops.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"tti_torch::{name}", fake, lib=_ops)
    return getattr(torch.ops.tti_torch, name).default
