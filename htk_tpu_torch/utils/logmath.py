"""Log-domain arithmetic with HTK's clamping semantics, in torch.

The PyTorch counterpart of `htk_tpu/utils/logmath.py`: the same constants
as plain Python floats and torch twins of `ladd`, `ladd_reduce`
(`HTKLib/HMath.c : LAdd()`) and `exp_or_zero` (HTK's L2F):

  LZERO   = -1.0e10   log(0): any log-prob at or below this is "zero"
  LSMALL  = -0.5e10   results below this are flushed to LZERO
  MINEARG = -708.3   exp arguments are clamped here before exp
  minLogExp = -log(-LZERO): increments smaller than exp(minLogExp) drop

Functions take tensors of any float dtype and keep it.
"""

from __future__ import annotations

import math

import torch

LZERO = -1.0e10
LSMALL = -0.5e10
MINEARG = -708.3
MINLARG = 2.45e-308
MINLOGEXP = -math.log(-LZERO)


def ladd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """HTK LAdd: log(exp(x)+exp(y)) with LZERO/LSMALL flush-to-zero."""
    hi = torch.maximum(x, y)
    lo = torch.minimum(x, y)
    diff = lo - hi  # <= 0
    dropped = torch.where(hi < LSMALL, torch.full_like(hi, LZERO), hi)
    safe_diff = torch.clamp(diff, min=MINLOGEXP)
    summed = hi + torch.log1p(torch.exp(safe_diff))
    return torch.where(diff < MINLOGEXP, dropped, summed)


def ladd_reduce(a: torch.Tensor, dim: int = -1,
                keepdim: bool = False) -> torch.Tensor:
    """logsumexp along `dim` with HTK LAdd clamping semantics.

    A max-shifted sum that drops increments below minLogExp of the max
    and flushes results below LSMALL, as htk_tpu's `ladd_reduce`."""
    hi = torch.amax(a, dim=dim, keepdim=True)
    diff = a - hi
    contrib = torch.where(diff < MINLOGEXP, torch.zeros_like(diff),
                          torch.exp(torch.clamp(diff, min=MINLOGEXP)))
    s = hi + torch.log(torch.sum(contrib, dim=dim, keepdim=True))
    s = torch.where(hi < LSMALL, torch.full_like(s, LZERO), s)
    if not keepdim:
        s = s.squeeze(dim)
    return s


def exp_or_zero(x: torch.Tensor) -> torch.Tensor:
    """exp(x) with x <= LSMALL mapping to 0 (HTK's L2F pattern)."""
    return torch.where(x > LSMALL, torch.exp(torch.clamp(x, min=MINEARG)),
                       torch.zeros_like(x))
