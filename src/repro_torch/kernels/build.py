"""Build and bind the port's hand-written CUDA kernels.

Each kernel source under ``kernels/*/csrc`` has a plain C launch function
and includes no PyTorch header, so ``nvcc`` compiles it in seconds into a
shared library for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so <sources>

The library lands in ``build/`` of the checkout (git-ignored) at first use,
named by a hash of its sources and flags, so an edited source is rebuilt and
an unchanged one is loaded as built.  ``ctypes`` loads it with explicit
``argtypes``; every launch function returns ``cudaGetLastError()``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
import time
from typing import Dict, Sequence, Tuple

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """One shared library: its sources and the C functions it exports
    (name → ctypes argtypes; every function returns a C ``int``).  The
    ``.cu`` sources are compiled; headers listed beside them are hashed
    into the library's name, so an edited header rebuilds it."""

    name: str
    sources: Tuple[pathlib.Path, ...]
    functions: Tuple[Tuple[str, Tuple], ...]

    def digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in self.sources:
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return h.hexdigest()[:16]

    @property
    def path(self) -> pathlib.Path:
        return BUILD_DIR / f"lib{self.name}-{self.digest()}.so"


_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "port's kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(libraries: Sequence[KernelLibrary]) -> float:
    """Compile every library not yet built, all ``nvcc`` processes started
    together; returns the wall seconds spent.  Raises with the compiler's
    output when a build fails."""
    t0 = time.perf_counter()
    todo = [lib for lib in libraries if not lib.path.exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for lib in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               *(str(src) for src in lib.sources if src.suffix == ".cu")]
        jobs.append((lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, lib.path)     # atomic: no half-written library
        else:
            os.unlink(tmp)
            failures.append(f"{lib.name}: nvcc exit {proc.returncode}\n"
                            f"{out.decode(errors='replace')}")
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def load(lib: KernelLibrary) -> ctypes.CDLL:
    """The loaded library, built first if needed (once per process)."""
    with _LOCK:
        handle = _LOADED.get(lib.name)
        if handle is None:
            build([lib])
            handle = ctypes.CDLL(str(lib.path))
            for fn_name, argtypes in lib.functions:
                fn = getattr(handle, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LOADED[lib.name] = handle
        return handle


def check_launch(kernel: str, err: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch function."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with "
                           f"cudaError_t {err}")
