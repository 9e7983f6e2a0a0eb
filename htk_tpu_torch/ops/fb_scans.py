"""HFB forward-backward scans: kernel + plain.

`fb_scans` runs, for a batch of utterances, the backward scan (with HFB's
beta beam when `beam` is given), the forward scan (confined to the live
betas under a beam), logP and the summed transition posteriors xi of
`htk_tpu/algo/fb.py : backward_scan, forward_scan, xi_scan`, the work of
the JAX package's Pallas kernel `htk_tpu/ops/fb_pallas.py :
fb_scans_pallas` (which takes no beam; this one does, so HERest -t runs on
the kernel too):

  inputs   outp (B, T, Q) f32, logA (B, Q, Q) f32, a0/aE (B, Q) f32,
           t_real (B,) int32, beam: float or None, xi: bool
  outputs  alphas (B, T, Q), betas (B, T, Q), logp (B,), xi (B, Q, Q) f32
           (None where the caller passes xi=False: nothing computes it)

Alphas and betas at t >= t_real carry on the recursion as in the
reference; only t < t_real is meaningful. Two implementations with one
signature:

  fb_scans_plain  the three batched torch scans of algo/fb.py
  fb_scans_cuda   the hand-written Hopper kernel (csrc/fb_scans.cu), built
                  with nvcc at first use into csrc/_build/ and bound
                  through ctypes; it works on the live cells of logA
                  only (above LZERO/2; the others add exactly nothing),
                  listed per state on the card at every launch, in one of
                  two designs (`fb_plan`): "narrow", blocks of a scan each
                  (the composites of HERest, HMMIRest, FULLC and -K), and
                  "wide", one cooperative grid over the card with a grid
                  barrier a step (large composites: the phone loop of
                  HNTrainSGD's sequence criterion, any Q past the narrow
                  design's shared memory)

`fb_scans` takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..algo import fb as _fb
from ..utils.logmath import LZERO, ladd_reduce
from ._cuda import SMEM_MAX, CudaKernel, launch

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                Optional[torch.Tensor]]
_MAX_WARPS = 32  # csrc/fb_scans.cu kMaxWarps
WIDE_WARPS = 32  # csrc/fb_scans.cu kWideWarps: warps a wide-scan block
TILE_ROWS = 128  # csrc/fb_scans.cu kTileRows: rows a predecessor tile
LONG_LIST = 64  # csrc/fb_scans.cu kLongList: a list this long takes a warp
STATE_COST = 32  # csrc/fb_scans.cu kStateCost: a state's cost in the split
WIDE_Q = 896  # fb_plan: the wide design from this many states on
# shared memory a wide-scan block has for its copy of the state vector
# (csrc/fb_scans.cu keeps 1 KB of the 227 for its static arrays)
WIDE_VEC_SMEM = SMEM_MAX - 1024


def _bind(lib):
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fb_scans_launch.argtypes = [vp] * 13 + [ci] * 5 + [cf, vp]
    lib.fb_scans_launch.restype = ci
    lib.fb_scans_wide_launch.argtypes = ([vp] * 19 + [ci] * 4 + [cf]
                                         + [ci] * 2 + [vp])
    lib.fb_scans_wide_launch.restype = ci


KERNEL = CudaKernel("fb_scans", _bind)


def smem_bytes(Q: int, dirs: int, entries: int) -> int:
    """The scan kernel's shared memory for a block that runs `dirs` scans
    (1, or 2 under a beam) with `entries` live cells in its lists: two
    state vectors, the per-warp maxima, the lists' offsets and entries."""
    return 4 * (2 * Q + _MAX_WARPS + dirs * (Q + 1)) + 8 * entries


def scan_smem(Q: int, beam: bool) -> int:
    """The narrow design's scan kernel's dynamic shared memory at launch:
    room for every cell of logA in each list, or SMEM_MAX; a block whose
    lists exceed it reads them from global memory. Raises where not even
    the state vectors and offsets fit (`fb_plan` sends such Q to the wide
    design)."""
    dirs = 2 if beam else 1
    if smem_bytes(Q, dirs, 0) > SMEM_MAX:
        raise ValueError(f"fb_scans_cuda: Q = {Q} states do not fit the "
                         "scan kernel's shared memory")
    return min(SMEM_MAX, smem_bytes(Q, dirs, dirs * Q * Q))


def fb_plan(B: int, T: int, Q: int, beam: Optional[float]) -> str:
    """The design that `fb_scans_cuda` launches for these shapes: "narrow"
    below WIDE_Q states where its state vectors and offsets fit a block's
    shared memory, "wide" from WIDE_Q on. A host rule on the shapes alone
    (no read of the operands). B and T do not decide it: the wide design
    pays a grid barrier a step whatever the batch. On an H100 (700 W) at
    T = 256 (scripts/fb_designs.py, PERF.md §6) the wide design is the
    faster from Q = 640 (B = 1) and 896 (B = 8) on composites with 2%
    random links, and the narrow one 7-10x slower from Q = 1,152 on,
    where their lists leave its shared memory; on banded composites the
    narrow one stays faster to Q = 1,280, by 0.3-0.5 ms from Q = 896."""
    del B, T
    narrow_fits = smem_bytes(Q, 2 if beam is not None else 1, 0) <= SMEM_MAX
    return "narrow" if Q < WIDE_Q and narrow_fits else "wide"


def wide_vec_smem(Q: int) -> int:
    """The wide scan's dynamic shared memory: a block's copy of the state
    vector (4 Q bytes) where it fits WIDE_VEC_SMEM, else 0 (the scan reads
    the vector from L2: Q past 57,856)."""
    return 4 * Q if 4 * Q <= WIDE_VEC_SMEM else 0


def lists_in_smem(logA, beam: bool) -> bool:
    """Whether every scan block keeps its live-cell lists in shared memory
    for this logA (B, Q, Q), as the kernel decides at launch; else it
    reads them from global memory. Reads logA's values (a host sync on
    the card): for tests and reports, not the launch path."""
    Q = logA.shape[1]
    dirs = 2 if beam else 1
    nnz = int((logA > LZERO / 2).sum(dim=(1, 2)).max())
    return smem_bytes(Q, dirs, dirs * nnz) <= scan_smem(Q, beam)


def _check_operands(outp, logA, a0, aE, t_real):
    """Shapes, dtypes and contiguity shared by both implementations."""
    if outp.dim() != 3:
        raise ValueError(f"fb_scans: outp must be (B, T, Q), got "
                         f"{tuple(outp.shape)}")
    B, T, Q = outp.shape
    want = {"logA": (logA, (B, Q, Q)), "a0": (a0, (B, Q)),
            "aE": (aE, (B, Q)), "t_real": (t_real, (B,))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"fb_scans: {name} must be {shape}, got "
                             f"{tuple(x.shape)}")
    for name, x in (("outp", outp), ("logA", logA), ("a0", a0), ("aE", aE)):
        if x.dtype != torch.float32:
            raise TypeError(f"fb_scans: {name} must be float32, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"fb_scans: {name} must be contiguous")
    if t_real.dtype != torch.int32:
        raise TypeError(f"fb_scans: t_real must be int32, got {t_real.dtype}")
    return B, T, Q


def fb_scans_plain(outp, logA, a0, aE, t_real,
                   beam: Optional[float] = None, xi: bool = True) -> Outputs:
    """Batched torch scans (any device); xi=False skips `xi_scan`."""
    B = _check_operands(outp, logA, a0, aE, t_real)[0]
    betas = _fb.backward_scan(outp, logA, aE, t_real, beam=beam)
    alphas = _fb.forward_scan(outp, logA, a0, t_real,
                              betas=betas if beam is not None else None)
    last = (t_real.long() - 1).clamp(min=0)
    alpha_last = alphas[torch.arange(B, device=outp.device), last]
    logp = ladd_reduce(alpha_last + aE, dim=-1)
    if not xi:
        return alphas, betas, logp, None
    return alphas, betas, logp, _fb.xi_scan(alphas, betas, outp, logA, logp,
                                            t_real)


def fb_scans_cuda(outp, logA, a0, aE, t_real, beam: Optional[float] = None,
                  xi: bool = True, path: Optional[str] = None,
                  events: Optional[Sequence] = None) -> Outputs:
    """The Hopper kernel (csrc/fb_scans.cu); operands on one GPU.

    Raises on operands the kernel cannot take; allocates the outputs and
    the live-cell lists' scratch (B, 2, Q + 1), (B, Q / 128, Q) and 2 x
    (B, 2, Q, Q), and the wide design's state vectors, split and barrier;
    launches on the current stream without synchronising. `path` forces
    a design ("narrow" or "wide"; by default `fb_plan`'s). The narrow
    design keeps the lists in shared memory when they fit (`smem_bytes`
    against `scan_smem`), else reads them from global memory, and refuses
    a Q whose state vectors do not fit (`scan_smem`). `events`: four
    torch.cuda.Events that the wide launch records before its tables,
    before its scan, before xi and at its end (timing)."""
    B, T, Q = _check_operands(outp, logA, a0, aE, t_real)
    card = outp.get_device()
    if not (outp.is_cuda and all(x.get_device() == card
                                 for x in (logA, a0, aE, t_real))):
        raise ValueError("fb_scans_cuda: every operand must lie on the same "
                         f"CUDA device as outp ({outp.device})")
    design = fb_plan(B, T, Q, beam) if path is None else path
    if design not in ("narrow", "wide"):
        raise ValueError(f"fb_scans_cuda: path must be 'narrow' or 'wide', "
                         f"got {path!r}")
    if events is not None and design != "wide":
        raise ValueError("fb_scans_cuda: events time the wide design only")
    smem = scan_smem(Q, beam is not None) if design == "narrow" else 0
    dev = outp.device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    alphas = torch.empty((B, T, Q), dtype=f32, device=dev)
    betas = torch.empty((B, T, Q), dtype=f32, device=dev)
    logp = torch.empty((B,), dtype=f32, device=dev)
    xi_out = torch.empty((B, Q, Q), dtype=f32, device=dev) if xi else None
    if not (B and Q):
        return alphas, betas, logp, xi_out
    xi_ptr = xi_out.data_ptr() if xi else None
    use_beam = int(beam is not None)
    beam_f = 0.0 if beam is None else float(beam)
    off = torch.empty((B, 2, Q + 1), dtype=i64, device=dev)
    part = torch.empty((B, -(-Q // TILE_ROWS), Q), dtype=i64, device=dev)
    lists = torch.empty((2, B, 2, Q, Q), dtype=i32, device=dev)
    tables = (off.data_ptr(), part.data_ptr(), lists[0].data_ptr(),
              lists[1].data_ptr())
    if design == "narrow":
        launch(KERNEL.build().fb_scans_launch, "fb_scans_cuda", KERNEL, card,
               outp.data_ptr(), logA.data_ptr(), a0.data_ptr(),
               aE.data_ptr(), t_real.data_ptr(), alphas.data_ptr(),
               betas.data_ptr(), logp.data_ptr(), xi_ptr, *tables, B, T, Q,
               smem, use_beam, beam_f)
        return alphas, betas, logp, xi_out
    # the grid is at most two blocks of 1,024 threads an SM
    rows = max(B, 2 * torch.cuda.get_device_properties(card)
               .multi_processor_count)
    buf = torch.full((2, 2, B, Q), LZERO, dtype=f32, device=dev)
    raw = torch.empty((B, Q) if use_beam else (1,), dtype=f32, device=dev)
    gmax = torch.full((B, T) if use_beam else (1,), -2 ** 31, dtype=i32,
                      device=dev)
    ranges = torch.empty((2, rows, WIDE_WARPS, 2), dtype=i32, device=dev)
    barrier = torch.zeros((2,), dtype=i32, device=dev)
    ev = None
    if events is not None:
        for e in events:  # creates each event on this stream
            e.record()
        ev = (ctypes.c_void_p * 4)(*(e.cuda_event for e in events))
    launch(KERNEL.build().fb_scans_wide_launch, "fb_scans_cuda", KERNEL,
           card, outp.data_ptr(), logA.data_ptr(), a0.data_ptr(),
           aE.data_ptr(), t_real.data_ptr(), alphas.data_ptr(),
           betas.data_ptr(), logp.data_ptr(), xi_ptr, *tables,
           buf.data_ptr(), raw.data_ptr(), gmax.data_ptr(),
           ranges.data_ptr(), barrier.data_ptr(), ev, B, T, Q, use_beam,
           beam_f, wide_vec_smem(Q), rows)
    return alphas, betas, logp, xi_out


def fb_scans(outp, logA, a0, aE, t_real, beam: Optional[float] = None,
             xi: bool = True) -> Outputs:
    """Dispatch on where `outp` lies: the plain version for CPU tensors,
    the kernel for CUDA tensors (which raises rather than fall back)."""
    if outp.device.type == "cpu":
        return fb_scans_plain(outp, logA, a0, aE, t_real, beam, xi)
    if outp.device.type != "cuda":
        raise ValueError(f"fb_scans: no implementation for device "
                         f"{outp.device}")
    return fb_scans_cuda(outp, logA, a0, aE, t_real, beam, xi)
