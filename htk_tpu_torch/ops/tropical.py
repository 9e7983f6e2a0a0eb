"""Tropical (max-plus) matrix-vector product on a pre-transposed operand.

The PyTorch counterpart of `htk_tpu/ops/tropical_pallas.py`, with its
signatures: `pad_tropical_operand` pads trans to (Cp, Cp) with LZERO
(Cp = C rounded up to a multiple of 128, at least 128) and transposes it,
once per network; `tropical_matvec_argmax_padded` takes WE (Bp, Cp) and
that transT; `tropical_matvec_argmax` takes WE (B, C) and trans (C, C)
as they are. All compute

    out[b, j] = max_i WE[b, i] + trans[i, j]      arg[b, j] = first such i

which is the contract of ops/maxplus, so they are served by the same
kernel (csrc/maxplus.cu) through `maxplus._launch` on CUDA tensors and by
`maxplus_plain` on CPU tensors. The kernel reads trans by rows, so the
padded wrapper transposes transT back once and keeps the copy on the
operand (refreshed if the operand is modified in place); no call
transposes per frame.

The TPU kernel starts its running max at (LZERO, 0) (floor=True in
ops/maxplus); the reference's non-Pallas branch (`use_pallas=False`) is
the raw max (floor=False). `tropical_matvec_argmax` keeps that switch:
`use_pallas` selects the contract, not an implementation.

`LAUNCHES.launches` counts the kernel launches made through these
wrappers (ops/maxplus's own count does not include them).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.logmath import LZERO
from . import maxplus as _mp
from ._cuda import LaunchCount

LAUNCHES = LaunchCount("tropical")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_tropical_operand(trans, C: Optional[int] = None) -> torch.Tensor:
    """Pad trans to (Cp, Cp) and pre-transpose it. Do this ONCE per
    network (not per frame): returns transT (Cp, Cp)."""
    C = C if C is not None else trans.shape[0]
    Cp = _round_up(max(C, 128), 128)
    tp = torch.full((Cp, Cp), LZERO, dtype=torch.float32,
                    device=trans.device)
    tp[:C, :C] = trans
    return tp.t().contiguous()


def _untransposed(transT: torch.Tensor) -> torch.Tensor:
    """trans from transT, computed once per operand (and again only after
    the operand changes in place)."""
    held = getattr(transT, "_maxplus_rows", None)
    if held is None or held[0] != transT._version:
        held = (transT._version, transT.t().contiguous())
        transT._maxplus_rows = held
    return held[1]


def _product(WE, trans, floor: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dispatch of ops/maxplus, counted on LAUNCHES."""
    if WE.device.type == "cpu":
        return _mp.maxplus_plain(WE, trans, floor)
    if WE.device.type != "cuda":
        raise ValueError(f"tropical: no implementation for device "
                         f"{WE.device}")
    return _mp._launch(WE, trans, floor, LAUNCHES)


def tropical_matvec_argmax_padded(WE_p, transT_p):
    """Pre-padded fast path: WE_p (Bp, Cp), transT_p (Cp, Cp) ->
    (out (Bp, Cp), arg (Bp, Cp)). Padded sources hold LZERO and never
    win; padded targets produce rows the caller masks."""
    return _product(WE_p, _untransposed(transT_p), floor=True)


def tropical_matvec_argmax(WE, trans, use_pallas: Optional[bool] = None):
    """entry[b, j] = max_i WE[b, i] + trans[i, j], with first-max argmax.

    One-shot use: the kernel takes any (B, C), so nothing is padded (the
    reference pads to 128 for the TPU; padded LZERO sources never win).
    use_pallas None or True: the TPU kernel's contract, floored at
    (LZERO, 0); False: the reference's plain branch, the raw max."""
    return _product(WE, trans, floor=use_pallas is not False)
