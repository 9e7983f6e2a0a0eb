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

  segmax_plain, gather_add_plain,  torch ops on any device: segments
  lane_gather_plain                grouped by width, `WE[:, P] + S` and
                                   `torch.max(dim=2)` per group
  segmax_cuda, gather_add_cuda,    the hand-written Hopper kernels
  lane_gather_cuda                 (csrc/xw_gather.cu), built with nvcc at
                                   first use into csrc/_build/ and
                                   bound through ctypes

The segmax kernel gives each segment a group of 2 to 32 lanes, as its
quads (4 slots from a multiple of 4) ask (`lane_class`), and merges their
(value, slot) pairs so that the first slot reaching the max wins, as in
the serial walk. Its host schedule (`schedule`: the segments sorted by
lanes, cut into warp tasks) and launch shape (`launch_shape`: batch rows
a block, so that they fit in shared memory, and blocks a row group) are
built once per seg_off tensor and kept on it (`_plan`); both are plain
numpy, tested on the CPU.

`segmax`, `gather_add` and `lane_gather` take the plain version for CPU
tensors only; for CUDA tensors they launch the kernel or raise. SEGMAX and
GATHER_ADD count the launches of the two kernels. Each entry checks each
operand once (`_check`: dtype, rank, contiguity, and on the card the
card's index compared as an integer) and launches on the raw handle of the
current stream, entering the card's device context only when it is not
current.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.logmath import LZERO
from ._cuda import SMEM_MAX, CudaKernel, LaunchCount, launch


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.segmax_launch.argtypes = [vp] * 8 + [ci] * 8 + [vp]
    lib.segmax_launch.restype = ci
    lib.gather_add_launch.argtypes = [vp] * 4 + [ci] * 3 + [vp]
    lib.gather_add_launch.restype = ci


KERNEL = CudaKernel("xw_gather", _bind)
SEGMAX = LaunchCount("segmax")
GATHER_ADD = LaunchCount("gather_add")
# csrc/xw_gather.cu: kClasses, kSegThreads / 32, kRowsMax
CLASSES, SEG_WARPS, ROWS_MAX = 6, 32, 8
# the lanes of a segment: at least LANES_MIN, and enough that none takes
# more than LANE_QUADS quads (4 slots), up to a warp
LANE_QUADS, LANES_MIN = 3, 2


def _check(x, fn: str, name: str, dtype, dim: int, where) -> None:
    """One operand, checked once per entry: dtype, rank, contiguity, and
    that it lies where WE lies (`where` from `_where(WE)`)."""
    if x.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {x.dtype}")
    if x.dim() != dim:
        raise ValueError(f"{fn}: {name} must have {dim} dimensions, got "
                         f"shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")
    if (x.get_device() if type(where) is int else x.device) != where:
        raise ValueError(f"{fn}: {name} on {x.device}, WE on {where}")


def _where(WE):
    """WE's place as `_check` compares it: on the card its index, an int
    (no torch.device object is built on the kernels' path); elsewhere its
    torch.device."""
    return WE.get_device() if WE.is_cuda else WE.device


def _check_segmax(WE, preds, scores, seg_off, out_row, C_out,
                  fn="segmax", skip=None) -> None:
    f32, i32, at = torch.float32, torch.int32, _where(WE)
    _check(WE, fn, "WE", f32, 2, at)
    _check(preds, fn, "preds", i32, 1, at)
    _check(scores, fn, "scores", f32, 1, at)
    _check(seg_off, fn, "seg_off", i32, 1, at)
    _check(out_row, fn, "out_row", i32, 1, at)
    if skip is not None:
        _check(skip, fn, "skip", torch.bool, 0, at)
    if scores.shape != preds.shape:
        raise ValueError(f"{fn}: scores {tuple(scores.shape)} and preds "
                         f"{tuple(preds.shape)} differ")
    R = out_row.shape[0]
    if seg_off.shape[0] != R + 1:
        raise ValueError(f"{fn}: seg_off must be ({R + 1},) for {R} "
                         f"segments, got {tuple(seg_off.shape)}")
    if R > C_out:
        raise ValueError(f"{fn}: {R} segments exceed C_out = {C_out}")


def _check_gather(WE, pred, lp, fn="gather_add") -> None:
    at = _where(WE)
    _check(WE, fn, "WE", torch.float32, 2, at)
    _check(pred, fn, "pred", torch.int32, 1, at)
    if lp is not None:
        _check(lp, fn, "lp", torch.float32, 1, at)
        if lp.shape != pred.shape:
            raise ValueError(f"{fn}: lp {tuple(lp.shape)} and pred "
                             f"{tuple(pred.shape)} differ")


def _check_lane(tbl, idx, fn="lane_gather") -> None:
    at = _where(tbl)
    _check(tbl, fn, "tbl", torch.float32, 2, at)
    _check(idx, fn, "idx", torch.int32, 2, at)
    if tbl.shape[0] == 0:
        raise ValueError(f"{fn}: tbl has no row to gather from")


def _to_cuda(x, fn: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{fn}: operands must lie on a CUDA device, not "
                         f"{x.device}")


def _plain_device(x, fn: str) -> None:
    if x.device.type != "cpu":
        raise ValueError(f"{fn}: no implementation for device {x.device}")


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


def segmax_plain(WE, preds, scores, seg_off, out_row, C_out: int,
                 skip: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain torch version (any device): per group of equal-width
    segments the (B, n, width) candidates, their max and the pred of the
    first maximum. `skip` is accepted and ignored: the outputs are always
    computed, which the kernel's contract allows."""
    _check_segmax(WE, preds, scores, seg_off, out_row, C_out, skip=skip)
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


def quads(seg_off) -> np.ndarray:
    """The quads (4 slots from a multiple of 4) each segment touches; 0
    for an empty one."""
    off = np.asarray(seg_off, np.int64)
    k0, k1 = off[:-1], off[1:]
    return np.where(k1 > k0, (k1 + 3) // 4 - k0 // 4, 0)


def lane_class(seg_off) -> np.ndarray:
    """log2 of the lanes the kernel gives each segment: the fewest (a
    power of two, at least LANES_MIN, at most 32) that leave a lane at
    most LANE_QUADS of its quads."""
    need = np.maximum(-(-quads(seg_off) // LANE_QUADS), LANES_MIN)
    return sum((need > 1 << c).astype(np.int64) for c in range(CLASSES - 1))


def schedule(seg_off, lanes: Optional[int] = None) -> np.ndarray:
    """The kernel's host schedule (int32): CLASSES + 1 prefix counts of
    warp tasks, CLASSES + 1 prefix counts of segments, each position's
    slot range (k0, k1), then the segment at each position: the segments
    sorted by class, stably. Class c gives each segment 2**c lanes and a
    warp task 32 >> c segments; `lanes` (a power of two, 1-32) puts every
    segment in one class."""
    off = np.asarray(seg_off, np.int64)
    if lanes is None:
        cls = lane_class(off)
    else:
        c = int(lanes).bit_length() - 1
        if lanes < 1 or 1 << c != lanes or c >= CLASSES:
            raise ValueError(f"segmax_cuda: lanes must be 1, 2, 4, 8, 16 or "
                             f"32, got {lanes}")
        cls = np.full(len(off) - 1, c, np.int64)
    count = np.bincount(cls, minlength=CLASSES)
    tasks = -(-count // (32 >> np.arange(CLASSES)))
    order = np.argsort(cls, kind="stable")
    span = np.stack([off[order], off[order + 1]], axis=1)
    return np.concatenate([[0], np.cumsum(tasks), [0], np.cumsum(count),
                           span.reshape(-1), order]).astype(np.int32)


def launch_shape(B: int, C: int, n_tasks: int, sms: int,
                 staged: Optional[bool] = None) -> Tuple[int, int, bool]:
    """(rows, chunks, staged) of a launch: `rows` batch rows a block and
    `chunks` blocks a row group, so that the grid holds one block an SM
    when staged (each block copies its rows) or two (the threads' limit),
    but no more blocks than the warp tasks need. Staged, `rows` is a power
    of two: the most of WE's rows that fit in shared memory, at most
    ROWS_MAX and no more than B asks; unstaged, up to ROWS_MAX, the B rows
    shared evenly among the row groups. `staged` forces the copy on or off
    (tests)."""
    fit = SMEM_MAX // (4 * C)
    if staged is None:
        staged = fit >= 1
    elif staged and fit < 1:
        raise ValueError(f"segmax_cuda: a row of WE ({4 * C} bytes) does not "
                         f"fit in shared memory ({SMEM_MAX} bytes)")
    if staged:
        rows = 1 << (min(ROWS_MAX, fit).bit_length() - 1)
        rows = min(rows, 1 << (B - 1).bit_length())
        groups = -(-B // rows)
    else:
        groups = -(-B // ROWS_MAX)
        rows = -(-B // groups)
    blocks = sms if staged else 2 * sms
    chunks = max(1, min(-(-blocks // groups), -(-n_tasks // SEG_WARPS)))
    return rows, chunks, bool(staged)


def _plan(seg_off, B: int, C: int, card: int, lanes, staged):
    """The schedule on the card and the launch shape, built once per
    (B, C, lanes, staged) and kept on seg_off (one host copy of the
    offsets), rebuilt if it changes in place."""
    key = (B, C, lanes, staged)
    cached = getattr(seg_off, "_xw_plan", None)
    if cached is None or cached[0] != seg_off._version:
        cached = seg_off._xw_plan = (seg_off._version, {})
    plan = cached[1].get(key)
    if plan is None:
        sched = schedule(seg_off.cpu().numpy(), lanes)
        sms = torch.cuda.get_device_properties(card).multi_processor_count
        plan = cached[1][key] = (
            torch.as_tensor(sched, device=seg_off.device),
            *launch_shape(B, C, int(sched[CLASSES]), sms, staged))
    return plan


def segmax_cuda(WE, preds, scores, seg_off, out_row, C_out: int,
                skip: Optional[torch.Tensor] = None,
                lanes: Optional[int] = None, staged: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Hopper kernel (csrc/xw_gather.cu); operands on one GPU.
    Allocates the outputs and launches on the current stream without
    synchronising. `skip`, a 0-dim bool tensor on the card, is read by
    the kernel: where it holds True every block returns at once and val
    and arg are unspecified (the launch still counts); the host never
    reads it. `lanes` forces the lanes a segment (1-32) and `staged` the
    copy of WE into shared memory on or off (tests)."""
    _to_cuda(WE, "segmax_cuda")
    _check_segmax(WE, preds, scores, seg_off, out_row, C_out, "segmax_cuda",
                  skip)
    B, C = WE.shape
    R = out_row.shape[0]
    val, arg = _outputs(B, C_out, R, WE.device)
    if B and R:
        card = WE.get_device()
        sched, rows, chunks, st = _plan(seg_off, B, C, card, lanes, staged)
        launch(KERNEL.build().segmax_launch, "segmax_cuda", SEGMAX, card,
               WE.data_ptr(), preds.data_ptr(), scores.data_ptr(),
               out_row.data_ptr(), sched.data_ptr(),
               None if skip is None else skip.data_ptr(), val.data_ptr(),
               arg.data_ptr(), B, C, preds.shape[0], R, C_out, rows,
               int(st), chunks)
    return val, arg


def segmax(WE, preds, scores, seg_off, out_row, C_out: int,
           skip: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on where WE lies: the kernel for CUDA tensors (which
    raises rather than fall back), the plain version for CPU tensors.
    Where `skip` holds True the outputs are unspecified."""
    if WE.is_cuda:
        return segmax_cuda(WE, preds, scores, seg_off, out_row, C_out, skip)
    _plain_device(WE, "segmax")
    return segmax_plain(WE, preds, scores, seg_off, out_row, C_out, skip)


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
    _to_cuda(WE, "gather_add_cuda")
    _check_gather(WE, pred, lp, "gather_add_cuda")
    B, C = WE.shape
    N = pred.shape[0]
    out = WE.new_empty((B, N))
    if B and N:
        launch(KERNEL.build().gather_add_launch, "gather_add_cuda",
                GATHER_ADD, WE.get_device(), WE.data_ptr(), pred.data_ptr(),
                None if lp is None else lp.data_ptr(), out.data_ptr(), B, C,
                N)
    return out


def gather_add(WE, pred, lp: Optional[torch.Tensor]) -> torch.Tensor:
    """Dispatch on where WE lies, as `segmax` does."""
    if WE.is_cuda:
        return gather_add_cuda(WE, pred, lp)
    _plain_device(WE, "gather_add")
    return gather_add_plain(WE, pred, lp)


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
    at = _where(we)
    _check(we, fn, "we", torch.float32, 1, at)
    _check(preds, fn, "preds", torch.int32, 2, at)
    _check(scores, fn, "scores", torch.float32, 2, at)
    if scores.shape != preds.shape:
        raise ValueError(f"{fn}: scores {tuple(scores.shape)} and preds "
                         f"{tuple(preds.shape)} differ")
    CB, FB = preds.shape
    seg_off, rows = _uniform_segments(CB, FB, we.device)
    return segmax(we[None], preds.reshape(-1), scores.reshape(-1), seg_off,
                  rows, CB)[0][0]


def lane_gather_plain(tbl, idx) -> torch.Tensor:
    """The plain torch version (any device) of `lane_gather`."""
    _check_lane(tbl, idx)
    return tbl[0][idx.long()]


def lane_gather_cuda(tbl, idx) -> torch.Tensor:
    """`lane_gather` on the gather-add kernel with B = 1 (the table's
    first row) and no add; operands on one GPU, each checked once. The
    output is shaped like idx (`empty_like`, the cheapest allocation on
    the host), since a call is little more than its host work."""
    fn = "lane_gather_cuda"
    card = tbl.get_device()
    if card < 0:
        _to_cuda(tbl, fn)
    _check(tbl, fn, "tbl", torch.float32, 2, card)
    _check(idx, fn, "idx", torch.int32, 2, card)
    if tbl.shape[0] == 0:
        raise ValueError(f"{fn}: tbl has no row to gather from")
    out = torch.empty_like(idx, dtype=torch.float32)
    n = out.numel()
    if n:
        launch(KERNEL.build().gather_add_launch, fn, GATHER_ADD, card,
                tbl.data_ptr(), idx.data_ptr(), None, out.data_ptr(), 1,
                tbl.shape[1], n)
    return out


def lane_gather(tbl, idx) -> torch.Tensor:
    """tbl[0][idx] for tbl (R, W) float32 and idx (n, L) int32: the function
    of benchmarks/dyngather_probe.py's Pallas kernel (a take_along_axis of
    the broadcast first table row), on the gather-add kernel with B = 1 and
    no add, so the result is the table's values exactly. Dispatches as
    `segmax` does."""
    if tbl.is_cuda:
        return lane_gather_cuda(tbl, idx)
    _plain_device(tbl, "lane_gather")
    return lane_gather_plain(tbl, idx)
