"""HRec token-passing decode over a general word network: kernel + plain.

`decode_scan` runs the per-frame recursion of `htk_tpu/algo/decode.py :
decode_scan` for a batch of utterances and returns, like the JAX package's
vmapped scan and its Pallas kernel (`htk_tpu/ops/decode_pallas.py :
decode_scan_pallas`):

  finals   (v, wn, wt)     (B, Ns)    f32 / i32 / i32
  records  (WE, pwn, pwt)  (B, T, Nn) f32 / i32 / i32, all T frames

Two implementations with one signature:

  decode_scan_plain  batched torch: segment reductions (`scatter_reduce`
                     amax over node_of_state, then amin over the state
                     indices that reach the max: the first-state rule) and
                     a (B, Nn, Nn) broadcast max/argmax for the cross-word
                     step. O(Ns) per frame outside the cross-word step.
  decode_scan_cuda   the hand-written Hopper kernel (csrc/decode_scan.cu),
                     built with nvcc at first use into csrc/_build/ and
                     bound through ctypes.

`decode_scan` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises. Word-link records follow the
reference's tie rules: first maximising state, first source node, first
band offset k. Dead word ends hold max(LZERO, ...) values, whose records
are -1.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..utils.errors import HError
from ..utils.logmath import LSMALL, LZERO
from ._cuda import SMEM_MAX as _SMEM_MAX
from ._cuda import CudaKernel

# shared memory per block: WE, entry and an (4 B each per node)
_SMEM_PER_NODE = 12

Outputs = Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.decode_scan_launch.argtypes = [vp] * 16 + [ci] * 5 + [vp]
    lib.decode_scan_launch.restype = ci


KERNEL = CudaKernel("decode_scan", _bind)


def _check_operands(outp, band, a0, aE, node_of_state, entry_bonus, trans,
                    start_entry, word_pen, n_nodes):
    """Shapes, dtypes and contiguity shared by both implementations."""
    if outp.dim() != 3:
        raise ValueError(f"decode_scan: outp must be (B, T, Ns), got "
                         f"{tuple(outp.shape)}")
    B, T, Ns = outp.shape
    if band.dim() != 2 or band.shape[1] != Ns or band.shape[0] < 1:
        raise ValueError(f"decode_scan: band must be (K, {Ns}), got "
                         f"{tuple(band.shape)}")
    K = band.shape[0]
    Nn = int(n_nodes)
    want = {"a0": (a0, (Ns,)), "aE": (aE, (Ns,)),
            "entry_bonus": (entry_bonus, (Ns,)),
            "node_of_state": (node_of_state, (Ns,)),
            "trans": (trans, (Nn, Nn)), "start_entry": (start_entry, (Nn,)),
            "word_pen": (word_pen, (Nn,))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"decode_scan: {name} must be {shape}, got "
                             f"{tuple(x.shape)}")
    for name, x in [("outp", outp), ("band", band), ("a0", a0), ("aE", aE),
                    ("entry_bonus", entry_bonus), ("trans", trans),
                    ("start_entry", start_entry), ("word_pen", word_pen)]:
        if x.dtype != torch.float32:
            raise TypeError(f"decode_scan: {name} must be float32, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"decode_scan: {name} must be contiguous")
    if node_of_state.dtype not in (torch.int32, torch.int64):
        raise TypeError("decode_scan: node_of_state must be int32 or int64")
    return B, T, Ns, Nn, K


def decode_scan_plain(outp, band, a0, aE, node_of_state, entry_bonus, trans,
                      start_entry, word_pen, n_nodes: int) -> Outputs:
    """Batched torch version of the decode recursion (any device)."""
    B, T, Ns, Nn, K = _check_operands(
        outp, band, a0, aE, node_of_state, entry_bonus, trans, start_entry,
        word_pen, n_nodes)
    dev = outp.device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    nos = node_of_state.to(i64).expand(B, Ns)
    sidx = torch.arange(Ns, device=dev, dtype=i64).expand(B, Ns)
    no_state = torch.full((B, Ns), Ns, dtype=i64, device=dev)
    lz_n = torch.full((B, Nn), LZERO, dtype=f32, device=dev)
    ns_n = torch.full((B, Nn), Ns, dtype=i64, device=dev)
    minus1 = torch.tensor(-1, dtype=i32, device=dev)
    lz_pad = torch.full((B, K - 1), LZERO, dtype=f32, device=dev)
    m1_pad = torch.full((B, K - 1), -1, dtype=i32, device=dev)

    v = torch.full((B, Ns), LZERO, dtype=f32, device=dev)
    wn = torch.full((B, Ns), -1, dtype=i32, device=dev)
    wt = torch.full((B, Ns), -1, dtype=i32, device=dev)
    WEs = torch.empty((B, T, Nn), dtype=f32, device=dev)
    pwns = torch.empty((B, T, Nn), dtype=i32, device=dev)
    pwts = torch.empty((B, T, Nn), dtype=i32, device=dev)
    for t in range(T):
        # 1. word ends: segment max, then the first state reaching it
        e = v + aE
        WE = lz_n.scatter_reduce(1, nos, e, "amax", include_self=True)
        hit = e == WE.gather(1, nos)
        sid = ns_n.scatter_reduce(1, nos, torch.where(hit, sidx, no_state),
                                  "amin", include_self=True)
        sid = sid.clamp(max=Ns - 1)
        ok = WE > LSMALL
        WEs[:, t] = WE
        pwns[:, t] = torch.where(ok, wn.gather(1, sid), minus1)
        pwts[:, t] = torch.where(ok, wt.gather(1, sid), minus1)

        # 2. cross-word max-plus (+ start entry at t == 0)
        if t == 0:
            entry = start_entry.expand(B, Nn)
            an = torch.full((B, Nn), -1, dtype=i32, device=dev)
        else:
            m, arg = torch.max(WE[:, :, None] + trans[None], dim=1)
            entry = m + word_pen
            an = arg.to(i32)
        entry_s = (entry.gather(1, nos) + a0) + entry_bonus

        # 3. within-word band: first k on ties
        vp = torch.cat([lz_pad, v], dim=1)
        wnp = torch.cat([m1_pad, wn], dim=1)
        wtp = torch.cat([m1_pad, wt], dim=1)
        lo = [K - 1 - k for k in range(K)]
        cands = torch.stack([vp[:, o:o + Ns] + band[k]
                             for k, o in enumerate(lo)], dim=1)
        within, argk = torch.max(cands, dim=1)
        argk = argk[:, None]
        wwn = torch.stack([wnp[:, o:o + Ns] for o in lo], 1).gather(
            1, argk)[:, 0]
        wwt = torch.stack([wtp[:, o:o + Ns] for o in lo], 1).gather(
            1, argk)[:, 0]

        # 4. combine
        use_entry = entry_s > within
        v = torch.maximum(within, entry_s) + outp[:, t]
        tm1 = torch.tensor(t - 1, dtype=i32, device=dev)
        wn = torch.where(use_entry, an.gather(1, nos), wwn)
        wt = torch.where(use_entry, tm1, wwt)
        dead = v <= LSMALL
        wn = torch.where(dead, minus1, wn)
        wt = torch.where(dead, minus1, wt)
    return (v, wn, wt), (WEs, pwns, pwts)


def decode_scan_cuda(outp, band, a0, aE, node_of_state, entry_bonus, trans,
                     start_entry, word_pen, n_nodes: int) -> Outputs:
    """The Hopper kernel (csrc/decode_scan.cu); operands on one GPU.

    Raises on operands the kernel cannot take; allocates the outputs and
    the (2, B, Ns) ping-pong scratch; launches on the current stream
    without synchronising."""
    B, T, Ns, Nn, K = _check_operands(
        outp, band, a0, aE, node_of_state, entry_bonus, trans, start_entry,
        word_pen, n_nodes)
    dev = outp.device
    if not (outp.is_cuda and all(
            x.device == dev for x in (band, a0, aE, node_of_state,
                                      entry_bonus, trans, start_entry,
                                      word_pen))):
        raise ValueError("decode_scan_cuda: every operand must lie on the "
                         f"same CUDA device as outp ({dev})")
    if Nn * _SMEM_PER_NODE > _SMEM_MAX:
        HError(8528, "decode_scan: %d word nodes exceed the kernel's shared "
                     "memory (at most %d)", Nn, _SMEM_MAX // _SMEM_PER_NODE)
    nos = node_of_state.to(torch.int32).contiguous()
    if Ns > 1 and not bool((nos[1:] >= nos[:-1]).all()):
        HError(8528, "decode_scan: node_of_state must be non-decreasing "
                     "(each node's states contiguous)")
    if Ns and (int(nos[0]) < 0 or int(nos[-1]) >= Nn):
        HError(8528, "decode_scan: node_of_state outside [0, %d)", Nn)
    node_off = torch.searchsorted(
        nos, torch.arange(Nn + 1, device=dev, dtype=torch.int32)
    ).to(torch.int32)
    f32, i32 = torch.float32, torch.int32
    WE = torch.empty((B, T, Nn), dtype=f32, device=dev)
    pwn = torch.empty((B, T, Nn), dtype=i32, device=dev)
    pwt = torch.empty((B, T, Nn), dtype=i32, device=dev)
    vbuf = torch.empty((2, B, Ns), dtype=f32, device=dev)
    wnbuf = torch.empty((2, B, Ns), dtype=i32, device=dev)
    wtbuf = torch.empty((2, B, Ns), dtype=i32, device=dev)
    if B:
        lib = KERNEL.build()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.decode_scan_launch(
                outp.data_ptr(), band.data_ptr(), a0.data_ptr(),
                aE.data_ptr(), entry_bonus.data_ptr(), nos.data_ptr(),
                node_off.data_ptr(), trans.data_ptr(),
                start_entry.data_ptr(), word_pen.data_ptr(),
                WE.data_ptr(), pwn.data_ptr(), pwt.data_ptr(),
                vbuf.data_ptr(), wnbuf.data_ptr(), wtbuf.data_ptr(),
                B, T, Ns, Nn, K, stream)
        if err != 0:
            raise RuntimeError(f"decode_scan_cuda: launch failed with "
                               f"cudaError {err}")
        KERNEL.launches += 1
    fin = T & 1
    return (vbuf[fin], wnbuf[fin], wtbuf[fin]), (WE, pwn, pwt)


def decode_scan(outp, band, a0, aE, node_of_state, entry_bonus, trans,
                start_entry, word_pen, n_nodes: int) -> Outputs:
    """Dispatch on where `outp` lies: the plain version for CPU tensors,
    the kernel for CUDA tensors (which raises rather than fall back)."""
    if outp.device.type == "cpu":
        return decode_scan_plain(outp, band, a0, aE, node_of_state,
                                 entry_bonus, trans, start_entry, word_pen,
                                 n_nodes)
    if outp.device.type != "cuda":
        raise ValueError(f"decode_scan: no implementation for device "
                         f"{outp.device}")
    return decode_scan_cuda(outp, band, a0, aE, node_of_state, entry_bonus,
                            trans, start_entry, word_pen, n_nodes)
