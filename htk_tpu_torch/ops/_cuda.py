"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Each kernel source has plain C entry points. It is compiled with nvcc for
`sm_90a` into a shared library under csrc/_build/, keyed by a hash of the
source and the flags, at first use on a machine with a card, and loaded
with ctypes. Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Callable

import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_BUILD_DIR = os.path.join(_CSRC, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
SMEM_MAX = 232448  # 227 KB, the most shared memory a Hopper block can use


def _nvcc(name: str) -> str:
    cand = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cand.append(os.path.join(home, "bin", "nvcc"))
    cand.append("/usr/local/cuda/bin/nvcc")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(f"{name}: nvcc not found (PATH, CUDA_HOME, "
                       "/usr/local/cuda/bin); the CUDA kernel cannot build")


class LaunchCount:
    """A named launch count: a plain integer that a kernel's wrapper
    raises by one at every launch and nowhere else; callers reset and
    read it to show that a path went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


def launch(entry, fn: str, count: LaunchCount, card: int, *args) -> None:
    """Call a C entry point with `args` and the raw handle of card
    `card`'s current stream, entering the card's device context only if
    it is not the current one; raise on a launch error, else count the
    launch. No torch.device or Stream object is built on this path."""
    if card == torch._C._cuda_getDevice():
        err = entry(*args, torch._C._cuda_getCurrentRawStream(card))
    else:
        with torch.cuda.device(card):
            err = entry(*args, torch._C._cuda_getCurrentRawStream(card))
    if err != 0:
        raise RuntimeError(f"{fn}: launch failed with cudaError {err}")
    count.launches += 1


class CudaKernel(LaunchCount):
    """One compiled kernel library and its launch count.

    `bind(lib)` declares the C entry point's argtypes and restype on the
    loaded library.
    """

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        super().__init__(name)
        self.source = os.path.join(_CSRC, f"{name}.cu")
        self._bind = bind
        self._lib = None
        self.build_seconds = None

    def library_path(self) -> str:
        with open(self.source, "rb") as f:
            src = f.read()
        key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
        return os.path.join(_BUILD_DIR,
                            f"{self.name}_{key.hexdigest()[:16]}.so")

    def build(self):
        """Compile (once per source hash) and load the library."""
        if self._lib is not None:
            return self._lib
        path = self.library_path()
        if not os.path.exists(path):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(self.name), *NVCC_FLAGS, "-o", tmp, self.source]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError("%s: nvcc failed (%d)\n%s\n%s" % (
                    self.name, proc.returncode, " ".join(cmd), proc.stderr))
            os.replace(tmp, path)
            self.build_seconds = time.perf_counter() - t0
        else:
            self.build_seconds = 0.0
        lib = ctypes.CDLL(path)
        self._bind(lib)
        self._lib = lib
        return lib
