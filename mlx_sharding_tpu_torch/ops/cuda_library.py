"""Build and load one of the port's CUDA kernel libraries.

Each library is one ``csrc/*.cu`` file with a plain C interface, which may
include headers of ``csrc/`` (``#include "name.cuh"``). On first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``_build/`` (keyed by a hash of
the source, every ``csrc/`` header it includes and the flags, renamed into
place atomically so that concurrent processes never load a half-written
file) and loaded with ``ctypes``. No PyTorch headers are included, so a
build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_headers(source: Path) -> list:
    """The headers ``source`` includes with quotes, and theirs in turn,
    found as nvcc finds them (beside the including file, then in
    ``csrc/``), in a fixed order."""
    found, todo = [], [source]
    while todo:
        current = todo.pop(0)
        for name in _INCLUDE.findall(current.read_bytes()):
            for folder in (current.parent, CSRC_DIR):
                path = (folder / name.decode()).resolve()
                if path.exists():
                    if path not in found:
                        found.append(path)
                        todo.append(path)
                    break
    return found


class CudaLibrary:
    """A kernel library, built once per process and source hash.

    ``bind(lib)`` sets the ``argtypes``/``restype`` of the library's C
    functions: every pointer and the stream as ``c_void_p``."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC_DIR / source
        self._bind = bind
        self._lock = threading.Lock()
        self._lib = None
        self.build_log = ""

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self._build()))
                lib.mst_cuda_error_string.restype = ctypes.c_char_p
                lib.mst_cuda_error_string.argtypes = [ctypes.c_int]
                self._bind(lib)
                self._lib = lib
            return self._lib

    def build(self) -> str:
        """Compile (or find) and load the library; returns nvcc's log,
        whose ``-Xptxas -v`` lines give registers, shared memory and
        spills."""
        self.get()
        return self.build_log

    def check(self, err: int, what: str) -> None:
        """Raise if a C entry point returned a CUDA error."""
        if err:
            msg = self._lib.mst_cuda_error_string(err).decode()
            raise RuntimeError(f"{what} launch failed: {msg}")

    def key(self) -> str:
        """The build key: a hash of the source, the headers it includes
        from ``csrc/`` and the flags."""
        digest = hashlib.sha256(self.source.read_bytes())
        for header in local_headers(self.source):
            digest.update(header.name.encode() + b"\0" + header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return digest.hexdigest()[:16]

    def _build(self) -> Path:
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(
                f"nvcc not found: {self.source.name} is compiled on first use "
                "and needs the CUDA toolkit"
            )
        out = BUILD_DIR / f"{self.source.stem}_{self.key()}.so"
        if out.exists():
            self.build_log = f"cached: {out.name}"
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(self.source)],
            capture_output=True, text=True, check=False,
        )
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {self.source.name}:\n{self.build_log}")
        os.replace(tmp, out)
        return out
