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
                     bound through ctypes: one cooperative grid over the
                     card, each block owning a contiguous range of nodes
                     (`partition`), one grid barrier a frame.

`decode_scan` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises. Word-link records follow the
reference's tie rules: first maximising state, first source node, first
band offset k. Dead word ends hold max(LZERO, ...) values, whose records
are -1.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.errors import HError
from ..utils.logmath import LSMALL, LZERO
from ._cuda import SMEM_MAX, CudaKernel

THREADS = 1024  # threads per block of csrc/decode_scan.cu (kThreads)
_WARPS = THREADS // 32

Outputs = Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.decode_scan_launch.argtypes = [vp] * 17 + [ci] * 13 + [vp]
    lib.decode_scan_launch.restype = ci
    lib.decode_scan_grid.argtypes = [ci]
    lib.decode_scan_grid.restype = ci


KERNEL = CudaKernel("decode_scan", _bind)


@dataclass(frozen=True)
class Partition:
    """The kernel's cut of a network over G blocks (host numpy). Block g
    owns nodes [nodes[g], nodes[g+1]), their states [states[g],
    states[g+1]) and the same target columns of trans."""
    nodes: np.ndarray   # (G + 1,) node boundaries
    states: np.ndarray  # (G + 1,) state boundaries
    cols_max: int       # the most columns a block owns (at least 1)
    nnp: int            # Nn padded for 16-byte, bank-spread row reads
    jw: int             # lanes across columns in the cross-word step
    gw: int             # lanes per (utterance, node) in band and combine
    trans_in_smem: bool  # columns kept in shared memory, else read from L2
    bchunk_max: int     # the most utterances a block takes at once


def _padded_nodes(n_nodes: int) -> int:
    """Nn rounded up to a multiple of 4 whose quarter is odd: the row
    stride of the kernel's shared-memory WE rows and columns."""
    nnp = -(-n_nodes // 4) * 4
    return nnp + 4 if nnp % 8 == 0 else nnp


def smem_bytes(nnp: int, cols_max: int, jw: int, bchunk: int,
               trans_in_smem: bool) -> int:
    """Dynamic shared memory of one block, as the kernel lays it out: the
    columns (cols_max, nnp) if kept there, then per utterance of a chunk
    its WE row (nnp,) and its columns' entry and an, then the cross-word
    step's (value, index) partials, then its nodes' state offsets, word
    penalties and start entries."""
    ngroups = -(-cols_max // jw)
    npart = max(bchunk * ngroups, _WARPS) * jw
    return 4 * ((nnp * cols_max if trans_in_smem else 0)
                + bchunk * (nnp + 2 * cols_max) + 2 * npart
                + 3 * cols_max + 1)


def _pow2_at_least(x: int, cap: int = 32) -> int:
    return min(cap, 1 << (max(1, x) - 1).bit_length())


def partition(node_off: np.ndarray, K: int, G: int) -> Partition:
    """Cut the nodes into G contiguous ranges at node boundaries,
    balancing each range's work a frame: its columns (Nn add-and-compares
    each in the cross-word step) and its states (2K + 6 operations each).
    Ranges may be empty (Nn < G, or nodes wider than an even share).
    Raises HError 8528 if one utterance's WE row and a block's columns do
    not fit shared memory."""
    node_off = np.asarray(node_off, np.int64)
    Nn = len(node_off) - 1
    cum = np.concatenate([[0], np.cumsum(Nn + (2 * K + 6)
                                         * np.diff(node_off))])
    tgt = cum[-1] * np.arange(G + 1) / G
    hi = np.searchsorted(cum, tgt)
    lo = np.maximum(hi - 1, 0)
    nodes = np.where(tgt - cum[lo] <= cum[hi] - tgt, lo, hi)
    nodes[0], nodes[-1] = 0, Nn
    states = node_off[nodes]
    cols_max = max(1, int(np.diff(nodes).max()))
    nnp = _padded_nodes(Nn)
    jw = _pow2_at_least(cols_max)
    if smem_bytes(nnp, cols_max, jw, 1, False) > SMEM_MAX:
        HError(8528, "decode_scan: %d word nodes, %d columns a block at "
                     "G = %d: one word-end row and the columns' entries "
                     "exceed the kernel's shared memory", Nn, cols_max, G)
    in_smem = smem_bytes(nnp, cols_max, jw, 1, True) <= SMEM_MAX
    lo, hi = 1, 1 << 16  # the largest chunk that fits: 1 does
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if smem_bytes(nnp, cols_max, jw, mid, in_smem) <= SMEM_MAX:
            lo = mid
        else:
            hi = mid - 1
    return Partition(nodes=nodes.astype(np.int32),
                     states=states.astype(np.int32),
                     cols_max=cols_max, nnp=nnp, jw=jw,
                     gw=_pow2_at_least(-(-int(node_off[-1]) // max(Nn, 1))),
                     trans_in_smem=in_smem, bchunk_max=lo)


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


_GRID = {}


def full_grid(device_index: int) -> int:
    """The kernel's full grid on a card: its SM count times the blocks an
    SM holds at the full shared-memory budget (132 on an H100); asked of
    the card once."""
    g = _GRID.get(device_index)
    if g is None:
        lib = KERNEL.build()
        with torch.cuda.device(device_index):
            g = lib.decode_scan_grid(device_index)
        if g <= 0:
            raise RuntimeError(f"decode_scan: occupancy query failed with "
                               f"cudaError {-g}")
        _GRID[device_index] = g
    return g


def _plan(node_of_state, Nn: int, K: int, G: int) -> dict:
    """What the kernel needs of node_of_state: the node offsets and the
    partition's bounds on its device, validated (states sorted by node,
    nodes in range). Built once per (Nn, K, G) with one host copy and kept
    on the tensor, rebuilt if it changes in place."""
    cache = getattr(node_of_state, "_decode_plans", None)
    if cache is None or cache[0] != node_of_state._version:
        cache = node_of_state._decode_plans = (node_of_state._version, {})
    plan = cache[1].get((Nn, K, G))
    if plan is None:
        nos = node_of_state.cpu().numpy()
        if len(nos) > 1 and not (nos[1:] >= nos[:-1]).all():
            HError(8528, "decode_scan: node_of_state must be non-decreasing "
                         "(each node's states contiguous)")
        if len(nos) and (nos[0] < 0 or nos[-1] >= Nn):
            HError(8528, "decode_scan: node_of_state outside [0, %d)", Nn)
        node_off = np.searchsorted(nos, np.arange(Nn + 1))
        part = partition(node_off, K, G)
        dev = node_of_state.device
        plan = cache[1][(Nn, K, G)] = {
            "part": part,
            "node_off": torch.as_tensor(node_off.astype(np.int32),
                                        device=dev),
            "bounds": torch.as_tensor(part.nodes, device=dev)}
    return plan


def decode_scan_cuda(outp, band, a0, aE, node_of_state, entry_bonus, trans,
                     start_entry, word_pen, n_nodes: int,
                     grid: Optional[int] = None) -> Outputs:
    """The Hopper kernel (csrc/decode_scan.cu); operands on one GPU.

    Raises on operands the kernel cannot take; allocates the outputs, the
    (2, B, Ns) ping-pong scratch and the barrier counter; launches the
    cooperative grid on the current stream without synchronising. `grid`
    forces the number of blocks (tests); by default the full grid."""
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
    G = full_grid(dev.index) if grid is None else int(grid)
    if G < 1 or T * G >= 2 ** 32:
        HError(8528, "decode_scan: a grid of %d blocks over %d frames is "
                     "outside the barrier counter's range", G, T)
    plan = _plan(node_of_state, Nn, K, G)
    part = plan["part"]
    bchunk = max(1, min(B, part.bchunk_max))
    f32, i32 = torch.float32, torch.int32
    WE = torch.empty((B, T, Nn), dtype=f32, device=dev)
    pwn = torch.empty((B, T, Nn), dtype=i32, device=dev)
    pwt = torch.empty((B, T, Nn), dtype=i32, device=dev)
    vbuf = torch.empty((2, B, Ns), dtype=f32, device=dev)
    wnbuf = torch.empty((2, B, Ns), dtype=i32, device=dev)
    wtbuf = torch.empty((2, B, Ns), dtype=i32, device=dev)
    if B:
        barrier = torch.zeros(1, dtype=i32, device=dev)
        lib = KERNEL.build()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.decode_scan_launch(
                outp.data_ptr(), band.data_ptr(), a0.data_ptr(),
                aE.data_ptr(), entry_bonus.data_ptr(),
                plan["node_off"].data_ptr(), plan["bounds"].data_ptr(),
                trans.data_ptr(), start_entry.data_ptr(),
                word_pen.data_ptr(), WE.data_ptr(), pwn.data_ptr(),
                pwt.data_ptr(), vbuf.data_ptr(), wnbuf.data_ptr(),
                wtbuf.data_ptr(), barrier.data_ptr(), B, T, Ns, Nn, K,
                part.nnp, part.cols_max, int(part.trans_in_smem), bchunk,
                part.jw, part.gw, G,
                smem_bytes(part.nnp, part.cols_max, part.jw, bchunk,
                           part.trans_in_smem), stream)
        if err != 0:
            raise RuntimeError(f"decode_scan_cuda: cooperative launch of "
                               f"{G} blocks failed with cudaError {err}")
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
