"""Build a shared library from one source file, once per source and flags.

The port's hand-written code is compiled at first use, never at import:
the CUDA kernels (csrc/*.cu, nvcc) and the host runtime (native/*.cpp,
g++). Each library lands in csrc/_build/ under a name keyed by a hash of
the source and the flags, so an edit rebuilds it and an unchanged source
is compiled once per checkout. The compiler writes to a file named after
the process and the result is renamed into place, so processes that build
the same library at once (test workers) each load a whole file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from typing import Callable, List, Tuple

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "_build")


class BuildFailed(RuntimeError):
    """The compiler exited with an error; the message holds its command
    line and its stderr."""


def library_path(name: str, source: str, flags: List[str]) -> str:
    """Where `source` built with `flags` lives under BUILD_DIR."""
    with open(source, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{name}_{key.hexdigest()[:16]}.so")


def build_library(name: str, source: str, compiler: Callable[[], str],
                  flags: List[str]) -> Tuple[str, float]:
    """Compile `source` into a shared library with `compiler() flags -o
    out source` unless it is built already; return its path and the
    seconds the compiler took (0.0 when nothing was compiled). `compiler`
    is asked for its path only when there is something to compile, and
    raises when there is none. Raises BuildFailed when the compiler
    fails."""
    path = library_path(name, source, flags)
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cc = compiler()
    t0 = time.perf_counter()
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [cc, *flags, "-o", tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise BuildFailed("%s: %s failed (%d)\n%s\n%s" % (
            name, os.path.basename(cc), proc.returncode,
            " ".join(cmd), proc.stderr))
    os.replace(tmp, path)
    return path, time.perf_counter() - t0
