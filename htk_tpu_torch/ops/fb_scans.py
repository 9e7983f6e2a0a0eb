"""HFB forward-backward scans: kernel + plain.

`fb_scans` runs, for a batch of utterances, the backward scan (with HFB's
beta beam when `beam` is given), the forward scan (confined to the live
betas under a beam), logP and the summed transition posteriors xi of
`htk_tpu/algo/fb.py : backward_scan, forward_scan, xi_scan`, the work of
the JAX package's Pallas kernel `htk_tpu/ops/fb_pallas.py :
fb_scans_pallas` (which takes no beam; this one does, so HERest -t runs on
the kernel too):

  inputs   outp (B, T, Q) f32, logA (B, Q, Q) f32, a0/aE (B, Q) f32,
           t_real (B,) int32, beam: float or None
  outputs  alphas (B, T, Q), betas (B, T, Q), logp (B,), xi (B, Q, Q) f32

Alphas and betas at t >= t_real carry on the recursion as in the
reference; only t < t_real is meaningful. Two implementations with one
signature:

  fb_scans_plain  the three batched torch scans of algo/fb.py
  fb_scans_cuda   the hand-written Hopper kernel (csrc/fb_scans.cu), built
                  with nvcc at first use into csrc/_build/ and bound
                  through ctypes; it works on the live cells of logA
                  only (above LZERO/2; the others add exactly nothing),
                  listed per state on the card at every launch

`fb_scans` takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..algo import fb as _fb
from ..utils.logmath import LZERO, ladd_reduce
from ._cuda import SMEM_MAX, CudaKernel, launch

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
_MAX_WARPS = 32  # csrc/fb_scans.cu kMaxWarps


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fb_scans_launch.argtypes = ([vp] * 12 + [ci] * 5
                                    + [ctypes.c_float, vp])
    lib.fb_scans_launch.restype = ci


KERNEL = CudaKernel("fb_scans", _bind)


def smem_bytes(Q: int, dirs: int, entries: int) -> int:
    """The scan kernel's shared memory for a block that runs `dirs` scans
    (1, or 2 under a beam) with `entries` live cells in its lists: two
    state vectors, the per-warp maxima, the lists' offsets and entries."""
    return 4 * (2 * Q + _MAX_WARPS + dirs * (Q + 1)) + 8 * entries


def scan_smem(Q: int, beam: bool) -> int:
    """The scan kernel's dynamic shared memory at launch: room for every
    cell of logA in each list, or SMEM_MAX; a block whose lists exceed it
    reads them from global memory. Raises where not even the state
    vectors and offsets fit."""
    dirs = 2 if beam else 1
    if smem_bytes(Q, dirs, 0) > SMEM_MAX:
        raise ValueError(f"fb_scans_cuda: Q = {Q} states do not fit the "
                         "scan kernel's shared memory")
    return min(SMEM_MAX, smem_bytes(Q, dirs, dirs * Q * Q))


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
                   beam: Optional[float] = None) -> Outputs:
    """Batched torch scans (any device)."""
    B = _check_operands(outp, logA, a0, aE, t_real)[0]
    betas = _fb.backward_scan(outp, logA, aE, t_real, beam=beam)
    alphas = _fb.forward_scan(outp, logA, a0, t_real,
                              betas=betas if beam is not None else None)
    last = (t_real.long() - 1).clamp(min=0)
    alpha_last = alphas[torch.arange(B, device=outp.device), last]
    logp = ladd_reduce(alpha_last + aE, dim=-1)
    xi = _fb.xi_scan(alphas, betas, outp, logA, logp, t_real)
    return alphas, betas, logp, xi


def fb_scans_cuda(outp, logA, a0, aE, t_real,
                  beam: Optional[float] = None) -> Outputs:
    """The Hopper kernel (csrc/fb_scans.cu); operands on one GPU.

    Raises on operands the kernel cannot take; allocates the outputs and
    the live-cell lists' scratch (B, 2, Q + 1) and 2 x (B, 2, Q, Q);
    launches on the current stream without synchronising. The lists sit
    in shared memory when they fit (`smem_bytes` against `scan_smem`),
    else the scan reads them from global memory."""
    B, T, Q = _check_operands(outp, logA, a0, aE, t_real)
    card = outp.get_device()
    if not (outp.is_cuda and all(x.get_device() == card
                                 for x in (logA, a0, aE, t_real))):
        raise ValueError("fb_scans_cuda: every operand must lie on the same "
                         f"CUDA device as outp ({outp.device})")
    dev = outp.device
    alphas = torch.empty((B, T, Q), dtype=torch.float32, device=dev)
    betas = torch.empty((B, T, Q), dtype=torch.float32, device=dev)
    logp = torch.empty((B,), dtype=torch.float32, device=dev)
    xi = torch.empty((B, Q, Q), dtype=torch.float32, device=dev)
    if B and Q:
        smem = scan_smem(Q, beam is not None)
        off = torch.empty((B, 2, Q + 1), dtype=torch.int32, device=dev)
        lists = torch.empty((2, B, 2, Q, Q), dtype=torch.int32, device=dev)
        launch(KERNEL.build().fb_scans_launch, "fb_scans_cuda", KERNEL, card,
               outp.data_ptr(), logA.data_ptr(), a0.data_ptr(),
               aE.data_ptr(), t_real.data_ptr(), alphas.data_ptr(),
               betas.data_ptr(), logp.data_ptr(), xi.data_ptr(),
               off.data_ptr(), lists[0].data_ptr(), lists[1].data_ptr(), B,
               T, Q, smem, int(beam is not None),
               0.0 if beam is None else float(beam))
    return alphas, betas, logp, xi


def fb_scans(outp, logA, a0, aE, t_real,
             beam: Optional[float] = None) -> Outputs:
    """Dispatch on where `outp` lies: the plain version for CPU tensors,
    the kernel for CUDA tensors (which raises rather than fall back)."""
    if outp.device.type == "cpu":
        return fb_scans_plain(outp, logA, a0, aE, t_real, beam)
    if outp.device.type != "cuda":
        raise ValueError(f"fb_scans: no implementation for device "
                         f"{outp.device}")
    return fb_scans_cuda(outp, logA, a0, aE, t_real, beam)
