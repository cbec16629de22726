"""Build the port's CUDA sources into shared libraries and load them.

Every kernel source under ``csrc/`` has a plain C interface.  It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library keyed by a hash of the
source, under ``_build/`` beside this file (git ignores the directory), and
loaded with ``ctypes``.  A :class:`CudaLibrary` builds at first use;
:func:`build_all` starts one ``nvcc`` per source at once and waits for all,
so a fresh checkout pays for the slowest build, not their sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class CudaLibrary:
    """One ``csrc/*.cu`` source, built once per content hash and loaded.

    ``bind`` sets ``argtypes``/``restype`` on the loaded library.  ``info``
    records the library path, the seconds ``nvcc`` took (0.0 when the
    library was already built) and ``-Xptxas -v``'s report.
    """

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self._bind = bind
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()
        self.info: dict = {}

    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}_{digest}.so"

    def _start(self) -> tuple[subprocess.Popen, Path, float] | None:
        """Start ``nvcc`` unless the library is already built."""
        lib_path = self.path()
        if lib_path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, time.perf_counter()

    def _finish(self, started) -> None:
        seconds, log = 0.0, ""
        if started is not None:
            proc, tmp, t0 = started
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} ({proc.returncode}):\n{log}")
            os.replace(tmp, self.path())
        lib = ctypes.CDLL(str(self.path()))
        self._bind(lib)
        self.info.update(path=str(self.path()), seconds=seconds, log=log)
        self._lib = lib

    def load(self) -> ctypes.CDLL:
        """Compile (once per source hash) and load the library."""
        with self._lock:
            if self._lib is None:
                self._finish(self._start())
            return self._lib


def build_all(libs: Iterable[CudaLibrary]) -> None:
    """Build and load every library, all ``nvcc`` processes at once."""
    libs = list(libs)
    for lib in libs:
        lib._lock.acquire()
    try:
        started = [None if lib._lib is not None else lib._start() for lib in libs]
        for lib, st in zip(libs, started):
            if lib._lib is None:
                lib._finish(st)
    finally:
        for lib in libs:
            lib._lock.release()


def check_int32(name: str, t, shape: tuple[int, ...]) -> None:
    """A kernel argument must be a contiguous int32 tensor of this shape."""
    import torch

    if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous int32 tensor of shape {shape}, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def raise_on(name: str, err: int) -> None:
    """Raise if a launch entry point returned a CUDA error."""
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "CudaLibrary", "build_all", "check_int32", "raise_on"]
