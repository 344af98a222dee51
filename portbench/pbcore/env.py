"""Process plumbing of one benchmark run.

* ``process_age_s``: seconds since the process started, from the kernel's
  record of its start time, so ``setup_s`` counts the interpreter's start
  and every import too.
* ``one_thread_pools``: the host math libraries' pools held to one thread;
* ``pin_caches``: every build and kernel cache at a fixed path inside the
  checkout, so only the first run of a cell in a checkout builds.
* ``freeze_setup`` and ``GcPauses``: set-up's objects kept out of the
  collector's walks in the window, and the collector's pauses counted;
* ``forbidden_loaded``: the JAX side of the repository must never load in
  a run.  Module names are compared by their whole top-level name (the part
  before the first dot): ``repro_torch`` is the port and passes, ``repro``
  is the JAX package and does not.
"""
from __future__ import annotations

import gc
import os
import pathlib
import sys
import time
from typing import List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
_IMPORTED = time.perf_counter()


def setup_seconds() -> float:
    """``process_age_s``, or the seconds since this module was imported
    where ``/proc`` does not say."""
    age = process_age_s()
    return age if age is not None else time.perf_counter() - _IMPORTED


def process_age_s() -> Optional[float]:
    """Seconds since this process started (10 ms resolution), or ``None``
    where ``/proc`` does not say."""
    try:
        with open("/proc/self/stat") as f:
            stat = f.read()
        # fields after the command name: state is field 3, starttime 22
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return None


def one_thread_pools() -> None:
    """One thread in each host math pool (OpenMP, MKL, OpenBLAS), set
    before torch or NumPy is imported: the run's host threads are the
    program's, and idle pool threads spinning beside them would take the
    cores they wait for."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def pin_caches(root: pathlib.Path) -> None:
    """Point the build and kernel caches PyTorch, Triton and the CUDA
    driver know of at fixed directories under ``root/build`` (git-ignored).
    The port's own kernels already build into ``root/build/kernels``."""
    build = root / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(build / sub)


def freeze_setup() -> None:
    """Collect set-up's garbage and move every object alive now out of the
    collector's reach.  Without it each full collection in the window walks
    every object that importing torch and building the cell made, a pause
    that grows with set-up and stalls the window's host threads."""
    gc.collect()
    gc.freeze()


class GcPauses:
    """The collector's pauses while the block runs: how many, their total
    and the longest, in seconds."""

    def __enter__(self):
        self.count, self.total_s, self.max_s = 0, 0.0, 0.0
        self._t = None
        gc.callbacks.append(self._hook)
        return self

    def _hook(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            dt = time.perf_counter() - self._t
            self.count += 1
            self.total_s += dt
            self.max_s = max(self.max_s, dt)

    def __exit__(self, *exc):
        gc.callbacks.remove(self._hook)
        return False

    def summary(self) -> dict:
        return {"count": self.count, "total_ms": self.total_s * 1e3,
                "max_ms": self.max_s * 1e3}


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: every
    module loaded in this process)."""
    if modules is None:       # a None entry blocks an import: not loaded
        modules = [m for m, mod in list(sys.modules.items())
                   if mod is not None]
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))
