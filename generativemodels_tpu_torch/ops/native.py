"""Build a CUDA source of the package into a shared library, load it, bind it.

Route: `nvcc` by hand into a library with a plain C interface, loaded with
ctypes (no PyTorch headers, so a build takes seconds). The library goes
into `generativemodels_tpu_torch/_build/`, named by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. The build happens at first use, never at import; builds
of different sources may run at once, in threads. `Launcher` binds one
entry point of a built library and counts its launches.
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

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_locks_lock = threading.Lock()
_build_locks: dict[str, threading.Lock] = {}


def find_nvcc() -> str:
    """Path of nvcc: CUDA_HOME's as PyTorch finds it, else the one on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def build_library(source_name: str) -> tuple[Path, str]:
    """Compile `csrc/<source_name>` unless its hashed library exists.

    Returns the library path and the compiler's log (ptxas register and
    shared-memory report). Raises RuntimeError with nvcc's stderr on failure.
    """
    source = CSRC_DIR / source_name
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{source.stem}-{digest}.so"
    log = lib.with_suffix(".log")
    with _locks_lock:
        lock = _build_locks.setdefault(source_name, threading.Lock())
    with lock:
        if lib.exists():
            return lib, log.read_text() if log.exists() else ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: a concurrent process
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {source} (exit {proc.returncode}):\n{proc.stderr}"
                )
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return lib, log.read_text()


def load_library(source_name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<source_name>`."""
    path, _ = build_library(source_name)
    return ctypes.CDLL(str(path))


class Launcher:
    """Binds one entry point of a `csrc/` source, built at first use.

    `launches` counts the kernel launches made through this object and
    nothing else, so a run can show that its main path went through the
    kernel.
    """

    source = ""
    symbol = ""
    argtypes: tuple = ()

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()

    def _function(self):
        with self._lock:
            if self._fn is None:
                fn = getattr(load_library(self.source), self.symbol)
                fn.argtypes = list(self.argtypes) + [ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    def _launch(self, device: torch.device, *args) -> None:
        stream = torch.cuda.current_stream(device).cuda_stream
        err = self._function()(*args, device.index, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed with CUDA error {err}")
        self.launches += 1
