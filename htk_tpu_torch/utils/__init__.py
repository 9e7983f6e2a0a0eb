"""L1 runtime: config, CLI, errors, log arithmetic (HShell/HMem/HMath roles)."""

from .config import Config
from .errors import HError, HRError, HTKError
from .logmath import LZERO, LSMALL, MINLOGEXP, ladd, ladd_reduce

__all__ = [
    "Config",
    "HError",
    "HRError",
    "HTKError",
    "LZERO",
    "LSMALL",
    "MINLOGEXP",
    "ladd",
    "ladd_reduce",
]
