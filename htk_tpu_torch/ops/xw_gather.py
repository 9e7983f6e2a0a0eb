"""Segmented max-plus and gather-add over a static slot stream: kernels +
plain versions.

    segmax      val[b, out_row[r]] = max_{k in seg r} WE[b, preds[k]] + scores[k]
                arg[b, out_row[r]] = preds[k*], k* the FIRST slot reaching it
    gather_add  out[b, n] = WE[b, pred[n]] + lp[n]

for WE (B, C) float32, preds/pred (N,) int32, scores/lp (N,) float32, the
segment offsets seg_off (R+1,) int32 and the output column of each segment
out_row (R,) int32 (distinct columns of [0, C_out)). An empty segment gives
(2 * LZERO, -1); columns no segment names hold the same. Slot indices must
lie in [0, C): neither version checks them.

segmax is the exact explicit-bigram leg of the factored cross-word step
(htk_tpu/algo/decode.py : _make_uniform_step, the per-bucket loop, and
htk_tpu/ops/xw_route.py : routed_explicit_leg): the running max is seeded
with a segment's first slot and moves only on a strict `>`, so it equals
`jnp.max`/`jnp.argmax` over a padded bucket row, pads included. gather_add
is the windowed slot gather of htk_tpu/ops/xw_pallas.py. The probe kernels
of benchmarks/gather_probe.py and benchmarks/dyngather_probe.py run on the
same two kernels (`bucket_max`, `lane_gather`).

Implementations with one signature each:

  segmax_plain, gather_add_plain   torch ops on any device: segments
                                   grouped by width, `WE[:, P] + S` and
                                   `torch.max(dim=2)` per group
  segmax_cuda, gather_add_cuda     the hand-written Hopper kernels
                                   (csrc/xw_gather.cu), built with nvcc at
                                   first use into csrc/_build/ and bound
                                   through ctypes

`segmax` and `gather_add` take the plain version for CPU tensors only; for
CUDA tensors they launch the kernel or raise. SEGMAX and GATHER_ADD count
the launches of the two kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.logmath import LZERO
from ._cuda import CudaKernel, LaunchCount


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.segmax_launch.argtypes = [vp] * 7 + [ci] * 4 + [vp]
    lib.segmax_launch.restype = ci
    lib.gather_add_launch.argtypes = [vp] * 4 + [ci] * 3 + [vp]
    lib.gather_add_launch.restype = ci


KERNEL = CudaKernel("xw_gather", _bind)
SEGMAX = LaunchCount("segmax")
GATHER_ADD = LaunchCount("gather_add")


def _need(x, name: str, fn: str, dtype, dim: int, device) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {x.dtype}")
    if x.dim() != dim:
        raise ValueError(f"{fn}: {name} must have {dim} dimensions, got "
                         f"shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")
    if x.device != device:
        raise ValueError(f"{fn}: {name} on {x.device}, WE on {device}")


def _check_segmax(WE, preds, scores, seg_off, out_row, C_out) -> None:
    f32, i32, dev = torch.float32, torch.int32, WE.device
    _need(WE, "WE", "segmax", f32, 2, dev)
    _need(preds, "preds", "segmax", i32, 1, dev)
    _need(scores, "scores", "segmax", f32, 1, dev)
    _need(seg_off, "seg_off", "segmax", i32, 1, dev)
    _need(out_row, "out_row", "segmax", i32, 1, dev)
    if scores.shape != preds.shape:
        raise ValueError(f"segmax: scores {tuple(scores.shape)} and preds "
                         f"{tuple(preds.shape)} differ")
    R = out_row.shape[0]
    if seg_off.shape[0] != R + 1:
        raise ValueError(f"segmax: seg_off must be ({R + 1},) for {R} "
                         f"segments, got {tuple(seg_off.shape)}")
    if R > C_out:
        raise ValueError(f"segmax: {R} segments exceed C_out = {C_out}")


def _check_gather(WE, pred, lp) -> None:
    dev = WE.device
    _need(WE, "WE", "gather_add", torch.float32, 2, dev)
    _need(pred, "pred", "gather_add", torch.int32, 1, dev)
    if lp is not None:
        _need(lp, "lp", "gather_add", torch.float32, 1, dev)
        if lp.shape != pred.shape:
            raise ValueError(f"gather_add: lp {tuple(lp.shape)} and pred "
                             f"{tuple(pred.shape)} differ")


def _outputs(B, C_out, R, device):
    """val and arg; filled with (2 * LZERO, -1) unless every column gets
    a segment's result."""
    if R == C_out:
        return (torch.empty((B, C_out), dtype=torch.float32, device=device),
                torch.empty((B, C_out), dtype=torch.int32, device=device))
    return (torch.full((B, C_out), 2 * LZERO, dtype=torch.float32,
                       device=device),
            torch.full((B, C_out), -1, dtype=torch.int32, device=device))


def _groups(seg_off):
    """The segments grouped by width: [(width, segment indices (n,),
    slot indices (n, width))] on seg_off's device. Built once per tensor
    (one host copy of the offsets) and kept on it, rebuilt if it changes
    in place."""
    cached = getattr(seg_off, "_xw_groups", None)
    if cached is not None and cached[0] == seg_off._version:
        return cached[1]
    off = seg_off.cpu().numpy().astype(np.int64)
    width = np.diff(off)
    groups = []
    for w in np.unique(width).tolist():
        if w == 0:
            continue
        rows = np.flatnonzero(width == w)
        idx = off[rows][:, None] + np.arange(w)
        groups.append((w, torch.as_tensor(rows, device=seg_off.device),
                       torch.as_tensor(idx, device=seg_off.device)))
    seg_off._xw_groups = (seg_off._version, groups)
    return groups


def segmax_plain(WE, preds, scores, seg_off, out_row,
                 C_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain torch version (any device): per group of equal-width
    segments the (B, n, width) candidates, their max and the pred of the
    first maximum."""
    _check_segmax(WE, preds, scores, seg_off, out_row, C_out)
    B = WE.shape[0]
    val = torch.full((B, C_out), 2 * LZERO, dtype=torch.float32,
                     device=WE.device)
    arg = torch.full((B, C_out), -1, dtype=torch.int32, device=WE.device)
    for _w, rows, idx in _groups(seg_off):
        P = preds[idx].long()  # (n, w)
        v, k = torch.max(WE[:, P] + scores[idx][None], dim=2)
        a = P[None].expand(B, -1, -1).gather(2, k[..., None])[..., 0]
        cols = out_row[rows].long()
        val[:, cols] = v
        arg[:, cols] = a.to(torch.int32)
    return val, arg


def _to_cuda(x, fn: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{fn}: operands must lie on a CUDA device, not "
                         f"{x.device}")


def segmax_cuda(WE, preds, scores, seg_off, out_row,
                C_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Hopper kernel (csrc/xw_gather.cu); operands on one GPU.
    Allocates the outputs and launches on the current stream without
    synchronising."""
    _check_segmax(WE, preds, scores, seg_off, out_row, C_out)
    _to_cuda(WE, "segmax_cuda")
    B, C = WE.shape
    R = out_row.shape[0]
    val, arg = _outputs(B, C_out, R, WE.device)
    if B and R:
        lib = KERNEL.build()
        with torch.cuda.device(WE.device):
            stream = torch.cuda.current_stream(WE.device).cuda_stream
            err = lib.segmax_launch(
                WE.data_ptr(), preds.data_ptr(), scores.data_ptr(),
                seg_off.data_ptr(), out_row.data_ptr(), val.data_ptr(),
                arg.data_ptr(), B, C, R, C_out, stream)
        if err != 0:
            raise RuntimeError(f"segmax_cuda: launch failed with cudaError "
                               f"{err}")
        SEGMAX.launches += 1
    return val, arg


def segmax(WE, preds, scores, seg_off, out_row,
           C_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on where WE lies: the plain version for CPU tensors, the
    kernel for CUDA tensors (which raises rather than fall back)."""
    if WE.device.type == "cpu":
        return segmax_plain(WE, preds, scores, seg_off, out_row, C_out)
    if WE.device.type != "cuda":
        raise ValueError(f"segmax: no implementation for device {WE.device}")
    return segmax_cuda(WE, preds, scores, seg_off, out_row, C_out)


def gather_add_plain(WE, pred, lp: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain torch version (any device): `WE[:, pred] + lp`, or the
    gather alone when lp is None."""
    _check_gather(WE, pred, lp)
    g = WE[:, pred.long()]
    return g if lp is None else g + lp[None]


def gather_add_cuda(WE, pred, lp: Optional[torch.Tensor]) -> torch.Tensor:
    """The Hopper kernel (csrc/xw_gather.cu); operands on one GPU.
    Allocates the output and launches on the current stream without
    synchronising."""
    _check_gather(WE, pred, lp)
    _to_cuda(WE, "gather_add_cuda")
    B, C = WE.shape
    N = pred.shape[0]
    out = torch.empty((B, N), dtype=torch.float32, device=WE.device)
    if B and N:
        lib = KERNEL.build()
        with torch.cuda.device(WE.device):
            stream = torch.cuda.current_stream(WE.device).cuda_stream
            err = lib.gather_add_launch(
                WE.data_ptr(), pred.data_ptr(),
                None if lp is None else lp.data_ptr(), out.data_ptr(),
                B, C, N, stream)
        if err != 0:
            raise RuntimeError(f"gather_add_cuda: launch failed with "
                               f"cudaError {err}")
        GATHER_ADD.launches += 1
    return out


def gather_add(WE, pred, lp: Optional[torch.Tensor]) -> torch.Tensor:
    """Dispatch on where WE lies, as `segmax` does."""
    if WE.device.type == "cpu":
        return gather_add_plain(WE, pred, lp)
    if WE.device.type != "cuda":
        raise ValueError(f"gather_add: no implementation for device "
                         f"{WE.device}")
    return gather_add_cuda(WE, pred, lp)


_UNIFORM = {}


def _uniform_segments(CB: int, FB: int, device):
    """seg_off and out_row of CB segments of width FB, in order; built once
    per shape and device."""
    key = (CB, FB, str(device))
    if key not in _UNIFORM:
        _UNIFORM[key] = (
            torch.arange(CB + 1, dtype=torch.int32, device=device) * FB,
            torch.arange(CB, dtype=torch.int32, device=device))
    return _UNIFORM[key]


def bucket_max(we, preds, scores) -> torch.Tensor:
    """(CB,) = max_f we[preds[c, f]] + scores[c, f] for we (C,) float32,
    preds (CB, FB) int32 and scores (CB, FB) float32: the function of
    benchmarks/gather_probe.py's Pallas kernel (its (CB, 1) output as a
    vector), on the segmax kernel with B = 1."""
    fn = "bucket_max"
    _need(we, "we", fn, torch.float32, 1, we.device)
    _need(preds, "preds", fn, torch.int32, 2, we.device)
    _need(scores, "scores", fn, torch.float32, 2, we.device)
    if scores.shape != preds.shape:
        raise ValueError(f"{fn}: scores {tuple(scores.shape)} and preds "
                         f"{tuple(preds.shape)} differ")
    CB, FB = preds.shape
    seg_off, rows = _uniform_segments(CB, FB, we.device)
    return segmax(we[None], preds.reshape(-1), scores.reshape(-1), seg_off,
                  rows, CB)[0][0]


def lane_gather(tbl, idx) -> torch.Tensor:
    """tbl[0][idx] for tbl (R, W) float32 and idx (n, L) int32: the function
    of benchmarks/dyngather_probe.py's Pallas kernel (a take_along_axis of
    the broadcast first table row), on the gather-add kernel with B = 1 and
    no add, so the result is the table's values exactly."""
    fn = "lane_gather"
    _need(tbl, "tbl", fn, torch.float32, 2, tbl.device)
    _need(idx, "idx", fn, torch.int32, 2, tbl.device)
    n, L = idx.shape
    return gather_add(tbl[:1], idx.reshape(-1), None).reshape(n, L)
