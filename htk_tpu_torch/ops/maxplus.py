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

The kernel splits the source range i into `chunks` (`grid_chunks`: enough
that the grid covers the card twice over) and merges the chunks' partial
maxima in ascending order with a strict `>`, which is the serial first
maximum. It keeps, per card and stream, a scratch of partials and a row
of ticket counters that every launch leaves at zero.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils.logmath import LZERO
from ._cuda import CudaKernel, LaunchCount, launch


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.maxplus_launch.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    lib.maxplus_launch.restype = ci


KERNEL = CudaKernel("maxplus", _bind)
COLS, BATCH, WARPS = 32, 8, 8  # csrc/maxplus.cu: kCols, kBatch, kWarps
MIN_BLOCKS = 264  # twice the H100's 132 SMs
_WORK = {}  # (card, stream) -> (tickets, partials), grown on demand


def grid_chunks(B: int, C: int) -> int:
    """The kernel's source chunks at (B, C): enough for MIN_BLOCKS blocks,
    with at least one source row for each warp of a block."""
    tiles = -(-C // COLS) * -(-B // BATCH)
    return max(1, min(-(-MIN_BLOCKS // tiles), C // WARPS))


def _workspace(card: int, tiles: int, n_part: int):
    """Ticket counters (zero) and an int32 scratch of 2 n_part partials,
    kept per card and stream; a launch leaves the counters at zero, and
    launches on one stream never overlap."""
    key = (card, torch._C._cuda_getCurrentRawStream(card))
    held = _WORK.get(key)
    n_t, n_p = (0, 0) if held is None else (held[0].numel(),
                                            held[1].numel())
    if n_t < tiles or n_p < 2 * n_part:
        held = (torch.zeros(max(tiles, n_t), dtype=torch.int32, device=card),
                torch.empty(max(2 * n_part, n_p), dtype=torch.int32,
                            device=card))
        _WORK[key] = held
    return held


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


def _launch(WE, trans, floor: bool, count: LaunchCount,
            chunks: Optional[int] = None):
    """One kernel launch on the current stream, counted on `count`
    (KERNEL for maxplus_cuda, ops/tropical's own count for its wrappers).
    `chunks` forces the number of source chunks (default grid_chunks)."""
    B, C = _check_operands(WE, trans)
    if not WE.is_cuda:
        raise ValueError(f"maxplus_cuda: operands must lie on a CUDA device, "
                         f"not {WE.device}")
    val = torch.empty((B, C), dtype=torch.float32, device=WE.device)
    arg = torch.empty((B, C), dtype=torch.int32, device=WE.device)
    if B and C:
        chunks = grid_chunks(B, C) if chunks is None else int(chunks)
        if chunks < 1:
            raise ValueError(f"maxplus_cuda: chunks must be >= 1, got "
                             f"{chunks}")
        card = WE.get_device()
        n_part = chunks * B * C if chunks > 1 else 0
        tickets, part = _workspace(card, -(-C // COLS) * -(-B // BATCH),
                                   n_part)
        ptr = part.data_ptr()
        launch(KERNEL.build().maxplus_launch, "maxplus_cuda", count, card,
               WE.data_ptr(), trans.data_ptr(), val.data_ptr(),
               arg.data_ptr(), ptr, ptr + 4 * n_part, tickets.data_ptr(), B,
               C, chunks, int(bool(floor)))
    return val, arg


def maxplus_cuda(WE, trans, floor: bool, chunks: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Hopper kernel (csrc/maxplus.cu); operands on one GPU. Allocates
    the outputs and launches on the current stream without synchronising;
    `chunks` forces the split of the source range (tests)."""
    return _launch(WE, trans, floor, KERNEL, chunks)


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
