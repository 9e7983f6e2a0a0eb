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
                  through ctypes

`fb_scans` takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..algo import fb as _fb
from ..utils.logmath import ladd_reduce
from ._cuda import SMEM_MAX, CudaKernel

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
_WARPS = 32  # the scan kernel's warps per block (csrc/fb_scans.cu kThreads)


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fb_scans_launch.argtypes = ([vp] * 10 + [ci] * 5
                                    + [ctypes.c_float, vp])
    lib.fb_scans_launch.restype = ci


KERNEL = CudaKernel("fb_scans", _bind)


def smem_bytes(Q: int) -> int:
    """The scan kernel's dynamic shared memory with logA in it: two state
    vectors, the per-warp maxima and logA at a row stride of Q + 1."""
    return 4 * (2 * Q + _WARPS + Q * (Q + 1))


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

    Raises on operands the kernel cannot take; allocates the outputs;
    launches on the current stream without synchronising. logA sits in
    shared memory when it fits (Q <= 239), else the kernel reads it and a
    transposed copy from global memory."""
    B, T, Q = _check_operands(outp, logA, a0, aE, t_real)
    dev = outp.device
    if not (outp.is_cuda and all(x.device == dev
                                 for x in (logA, a0, aE, t_real))):
        raise ValueError("fb_scans_cuda: every operand must lie on the same "
                         f"CUDA device as outp ({dev})")
    alphas = torch.empty((B, T, Q), dtype=torch.float32, device=dev)
    betas = torch.empty((B, T, Q), dtype=torch.float32, device=dev)
    logp = torch.empty((B,), dtype=torch.float32, device=dev)
    xi = torch.empty((B, Q, Q), dtype=torch.float32, device=dev)
    if B:
        in_smem = smem_bytes(Q) <= SMEM_MAX
        logAT = None if in_smem else logA.transpose(1, 2).contiguous()
        lib = KERNEL.build()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fb_scans_launch(
                outp.data_ptr(), logA.data_ptr(),
                None if logAT is None else logAT.data_ptr(), a0.data_ptr(),
                aE.data_ptr(), t_real.data_ptr(), alphas.data_ptr(),
                betas.data_ptr(), logp.data_ptr(), xi.data_ptr(),
                B, T, Q, int(in_smem), int(beam is not None),
                0.0 if beam is None else float(beam), stream)
        if err != 0:
            raise RuntimeError(f"fb_scans_cuda: launch failed with "
                               f"cudaError {err}")
        KERNEL.launches += 1
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
