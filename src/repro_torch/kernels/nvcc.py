"""Build and bind the port's hand-written CUDA kernels.

Each kernel library is one ``csrc/*.cu`` file with a plain C interface.  It
is compiled with ``nvcc`` for ``sm_90a`` at first use, into
``build/repro_torch_kernels/`` at the repository root (gitignored), under a
name keyed by a hash of the source and the flags, and loaded with
``ctypes``.  A failed build raises; nothing falls back.  Nothing here runs
when a module is imported, so the CPU tests import every kernel module
without a toolkit.  A service launches from one thread per slot, so a
library loads under its own lock (once a process) and the wrappers count
their launches through :func:`count_launch`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, List, Optional

_REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc(src: Path) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        f"nvcc not found: the CUDA kernels are built from {src} at first use "
        "and need the CUDA toolkit on PATH")


class Library:
    """One kernel library of this process, built (or found built) and loaded
    at the first :meth:`load`; ``bind`` sets the C functions' argument and
    result types; ``flags`` are extra ``nvcc`` flags (a ``-D`` macro that a
    source compiles in, under a ``stem`` of its own).  ``builds`` counts the
    loads this process made: 1 after the first CUDA launch, 0 on the CPU."""

    _all: List["Library"] = []

    def __init__(self, src: Path, stem: str,
                 bind: Callable[[ctypes.CDLL], None], flags: tuple = ()):
        self.src, self.stem, self._bind = src, stem, bind
        self.flags = NVCC_FLAGS + tuple(flags)
        self.lib: Optional[ctypes.CDLL] = None
        self.builds = 0
        self._lock = threading.Lock()
        Library._all.append(self)

    def load(self) -> ctypes.CDLL:
        if self.lib is not None:
            return self.lib
        with self._lock:
            if self.lib is None:
                self._build_and_load()
        return self.lib

    def _build_and_load(self) -> None:
        text = self.src.read_bytes()
        key = hashlib.sha256(text + " ".join(self.flags).encode()
                             ).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"lib{self.stem}_{key}.so"
        if not so.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(self.src), *self.flags, "-o", tmp, str(self.src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {self.src}:\n"
                    f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)       # atomic: concurrent builds agree
        lib = ctypes.CDLL(str(so))
        self._bind(lib)
        self.builds += 1
        self.lib = lib


def total_builds() -> int:
    """Kernel-library loads made by this process, over every library."""
    return sum(lib.builds for lib in Library._all)


_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (a read-modify-write that two
    threads launching at once would otherwise lose)."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
