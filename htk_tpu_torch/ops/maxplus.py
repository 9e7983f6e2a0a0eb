"""Max-plus matrix-vector product with argmax: kernel + plain.

    val[b, j] = max_i WE[b, i] + trans[i, j]      arg[b, j] = first such i

for WE (B, C) and trans (C, C) float32, giving val (B, C) float32 and arg
(B, C) int32. This is the per-frame cross-word step of the uniform-row LV
decoder (algo/decode.py), the contract of the TPU kernel
`htk_tpu/ops/maxplus_pallas.py : maxplus_matvec`.

Two floor contracts, chosen by `floor`:

  floor=True   the running max starts at (LZERO, 0), as the TPU kernels
               do (maxplus_pallas.py, tropical_pallas.py): a target whose
               every candidate is at or below LZERO gets (LZERO, 0)
  floor=False  it starts at (-inf, 0): the raw max and its argmax, as the
               decoder's dense XLA branch (htk_tpu/algo/decode.py :
               _make_uniform_step) computes them; the decoder uses this

The two differ only where every candidate of a target is <= LZERO (all
source rows dead). Implementations with one signature:

  maxplus_plain  `WE[:, :, None] + trans[None]` and `torch.max(dim=1)`
                 (first maximum), on any device
  maxplus_cuda   the hand-written Hopper kernel (csrc/maxplus.cu), built
                 with nvcc at first use into csrc/_build/ and bound
                 through ctypes

`maxplus` takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises. `maxplus_matvec(WE, trans)` is the
counterpart of the TPU kernel's function (floor=True).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..utils.logmath import LZERO
from ._cuda import CudaKernel


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.maxplus_launch.argtypes = [vp] * 4 + [ci] * 3 + [vp]
    lib.maxplus_launch.restype = ci


KERNEL = CudaKernel("maxplus", _bind)


def _check_operands(WE, trans) -> Tuple[int, int]:
    if WE.dim() != 2:
        raise ValueError(f"maxplus: WE must be (B, C), got {tuple(WE.shape)}")
    B, C = WE.shape
    if tuple(trans.shape) != (C, C):
        raise ValueError(f"maxplus: trans must be ({C}, {C}), got "
                         f"{tuple(trans.shape)}")
    for name, x in (("WE", WE), ("trans", trans)):
        if x.dtype != torch.float32:
            raise TypeError(f"maxplus: {name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"maxplus: {name} must be contiguous")
    if trans.device != WE.device:
        raise ValueError(f"maxplus: trans on {trans.device}, WE on "
                         f"{WE.device}")
    return B, C


def maxplus_plain(WE, trans, floor: bool) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The plain torch version (any device): the (B, C, C) broadcast."""
    _check_operands(WE, trans)
    val, arg = torch.max(WE[:, :, None] + trans[None], dim=1)
    arg = arg.to(torch.int32)
    if floor:
        low = val <= LZERO
        val = torch.where(low, torch.full_like(val, LZERO), val)
        arg = torch.where(low, torch.zeros_like(arg), arg)
    return val, arg


def _launch(WE, trans, floor: bool):
    """One kernel launch on the current stream, uncounted (the counted
    wrappers are maxplus_cuda and ops/tropical's)."""
    B, C = _check_operands(WE, trans)
    if not WE.is_cuda:
        raise ValueError(f"maxplus_cuda: operands must lie on a CUDA device, "
                         f"not {WE.device}")
    val = torch.empty((B, C), dtype=torch.float32, device=WE.device)
    arg = torch.empty((B, C), dtype=torch.int32, device=WE.device)
    if B and C:
        lib = KERNEL.build()
        with torch.cuda.device(WE.device):
            stream = torch.cuda.current_stream(WE.device).cuda_stream
            err = lib.maxplus_launch(WE.data_ptr(), trans.data_ptr(),
                                     val.data_ptr(), arg.data_ptr(), B, C,
                                     int(bool(floor)), stream)
        if err != 0:
            raise RuntimeError(f"maxplus_cuda: launch failed with cudaError "
                               f"{err}")
    return val, arg


def maxplus_cuda(WE, trans, floor: bool) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """The Hopper kernel (csrc/maxplus.cu); operands on one GPU. Allocates
    the outputs and launches on the current stream without synchronising."""
    out = _launch(WE, trans, floor)
    if WE.numel():
        KERNEL.launches += 1
    return out


def maxplus(WE, trans, floor: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on where WE lies: the plain version for CPU tensors, the
    kernel for CUDA tensors (which raises rather than fall back)."""
    if WE.device.type == "cpu":
        return maxplus_plain(WE, trans, floor)
    if WE.device.type != "cuda":
        raise ValueError(f"maxplus: no implementation for device {WE.device}")
    return maxplus_cuda(WE, trans, floor)


def maxplus_matvec(WE, trans) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C) x (C, C) max-plus product with first-max argmax, floored at
    LZERO: what `htk_tpu/ops/maxplus_pallas.py : maxplus_matvec` returns."""
    return maxplus(WE, trans, floor=True)
