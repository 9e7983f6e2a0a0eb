"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Each kernel source has plain C entry points. It is compiled with nvcc for
`sm_90a` into a shared library under csrc/_build/ (utils/build.py, keyed
by a hash of the source and the flags) at first use on a machine with a
card, and loaded with ctypes. Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from typing import Callable

import torch

from ..utils.build import build_library
from ..utils.build import library_path as _library_path

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
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
        return _library_path(self.name, self.source, NVCC_FLAGS)

    def build(self):
        """Compile (once per source hash) and load the library."""
        if self._lib is not None:
            return self._lib
        path, self.build_seconds = build_library(
            self.name, self.source, lambda: _nvcc(self.name), NVCC_FLAGS)
        lib = ctypes.CDLL(path)
        self._bind(lib)
        self._lib = lib
        return lib
