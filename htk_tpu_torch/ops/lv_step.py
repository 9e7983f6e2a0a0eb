"""The uniform-row LV decoder's frame update on the card: one launch a
frame of csrc/lv_step.cu.

`LvSteps` runs one call's frame loop. Given the step's tables (the
network's band, a0, aE, bonus and start entry, LM-scaled where the plain
step scales them), it holds the carry (v, rec) in two pairs of (B, Ns)
buffers used in turn and the word-end planes WEs (B, T, C) float32, pwns
and pwts (B, T, C) int32, all allocated once a call. `step(tl, t, ...)`
launches frame t on the current stream without synchronising: the entry
into every row, the banded within-word update on frame tl of the chunk
given to `chunk`, and the word ends of the new carry, written as plane
t + 1 and as the contiguous (B, C) `we_buf` that the next frame's
cross-word leg reads. Frame t's entry comes from

  - the start entry, at t == 0;
  - the factored exact leg (`uni` and `bow` given): the back-off best
    the previous launch reduced into a slot of its own, and the explicit
    leg's (exp_v, exp_a) from segmax where strictly better (`exp`, or
    none where the net has no explicit bigram);
  - any other leg's (m, an) planes, (B, C) each.

With a beam below algo/decode._BEAM_OFF a frame takes two launches (the
new scores and each batch row's largest, then the prune and the word
ends); without, one. Plane 0 (the word ends of the start carry) is
formed once with torch ops as the plain step forms it.

The plain version is the torch step, `algo/decode._make_uniform_step`,
which the decoder takes for CPU tensors (`algo/decode._uniform_scan`);
this module has no CPU mode. The kernel does the plain step's float32
operations in its order with its tie rules, so every plane and the carry
equal it bit for bit. `KERNEL.launches` counts the launches.

The operands are checked once a call (`LvSteps(...)`: dtype, rank,
shape, contiguity, one CUDA device), a chunk of scores once a chunk, the
(m, an) planes at every step; the launch passes one ctypes structure,
updated in place, by reference.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils.logmath import LZERO
from ._cuda import CudaKernel, launch

K_MAX = 3  # csrc/lv_step.cu: kKMax, the widest band
BSZ_MAX = 32  # csrc/lv_step.cu: kBMax, batch rows a block
WARPS = 8  # csrc/lv_step.cu: kWarps
FUSED, UPDATE, ENDS = 0, 1, 2  # csrc/lv_step.cu: Phase
TBITS = 15  # algo/decode.REC_TBITS
# blocks a launch should reach (times the SMs) before a block takes every
# batch row: the batch rows are cut into chunks until the grid does
BLOCKS_PER_SM = 16

_PTRS = ("v", "rec", "v_out", "rec_out", "outp", "band", "a0", "aE",
         "bonus", "start", "bo", "uni", "xv", "xa", "we", "pwn", "pwt",
         "we_buf", "bow", "bo_next", "top")


class _Args(ctypes.Structure):
    """csrc/lv_step.cu's `Args`, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [("outp_bstride", ctypes.c_longlong),
                   ("plane_bstride", ctypes.c_longlong),
                   ("word_pen", ctypes.c_float), ("beam", ctypes.c_float)]
                + [(n, ctypes.c_int) for n in ("B", "C", "S", "K", "t",
                                               "phase", "bsz")])


def _bind(lib):
    lib.lv_step_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.lv_step_launch.restype = ctypes.c_int


KERNEL = CudaKernel("lv_step", _bind)


def _check(x, name: str, dtype, shape, at) -> None:
    """One operand: dtype, shape, contiguity, and that it lies where the
    band lies (`at`)."""
    if x.dtype != dtype:
        raise TypeError(f"lv_step: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"lv_step: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"lv_step: {name} must be contiguous")
    if x.device != at:
        raise ValueError(f"lv_step: {name} on {x.device}, band on {at}")


def warp_rows(S: int) -> int:
    """Word rows a warp takes (csrc/lv_step.cu): 32 / G where a lane holds
    two states (S even, at most 64; G the smallest power of two at least
    S / 2), else 1."""
    if S % 2 or S > 64:
        return 1
    return 32 // (1 << (S // 2 - 1).bit_length())


def batch_chunk(B: int, C: int, S: int, sms: int) -> int:
    """Batch rows a block: all of B, or fewer, cut evenly, until the grid
    reaches BLOCKS_PER_SM blocks an SM, at most BSZ_MAX."""
    tiles = -(-C // (WARPS * warp_rows(S)))
    chunks = min(B, max(1, -(-BLOCKS_PER_SM * sms // tiles)))
    chunks = max(chunks, -(-B // BSZ_MAX))
    return -(-B // chunks)


class LvSteps:
    """One call's frame loop on the card (see the module's docstring).

    `band` (K, Ns), `a0`, `aE` (Ns,), `bonus`, `start` (C,) float32 on one
    CUDA device, Ns = C S; `uni` and `bow` (C,) for the factored exact
    leg, else None; `word_pen` and `beam` Python floats (`beam` None for
    none)."""

    def __init__(self, band, a0, aE, bonus, start, S: int, B: int, T: int,
                 word_pen: float, beam: Optional[float],
                 uni=None, bow=None):
        f32 = torch.float32
        at = band.device
        if band.dtype != f32 or band.dim() != 2:
            raise TypeError(f"lv_step: band must be a 2-d {f32} tensor, got "
                            f"{band.dtype} of shape {tuple(band.shape)}")
        K, Ns = band.shape
        if S < 1 or Ns % S or Ns == 0:
            raise ValueError(f"lv_step: {Ns} states are not rows of S={S}")
        C = Ns // S
        if not 1 <= K <= K_MAX:
            raise ValueError(f"lv_step: a band of {K} shifts (1-{K_MAX})")
        if B < 1 or not 0 <= T <= (1 << TBITS):
            raise ValueError(f"lv_step: B={B}, T={T} out of range")
        if (uni is None) != (bow is None):
            raise ValueError("lv_step: uni and bow go together")
        _check(band, "band", f32, (K, Ns), at)
        for name, x, n in (("a0", a0, Ns), ("aE", aE, Ns), ("bonus", bonus, C),
                           ("start", start, C), ("uni", uni, C),
                           ("bow", bow, C)):
            if x is not None:
                _check(x, name, f32, (n,), at)
        if band.device.type != "cuda":
            raise ValueError(f"lv_step: operands must lie on a CUDA device, "
                             f"not {band.device}")
        self.card = band.get_device()
        bsz = batch_chunk(B, C, S, torch.cuda.get_device_properties(
            self.card).multi_processor_count)
        self.B, self.T, self.C, self.Ns = B, T, C, Ns
        self.factored = uni is not None
        self.beam = beam is not None
        self._tables = (band, a0, aE, bonus, start, uni, bow)
        self.v = torch.full((2, B, Ns), LZERO, dtype=f32, device=at)
        # the records (B, Ns) as uint32 bits: (an + 1) << TBITS | t fits
        self.rec = torch.zeros((2, B, Ns), dtype=torch.int32, device=at)
        self.WEs = torch.empty((B, T, C), dtype=f32, device=at)
        self.pwns = torch.empty((B, T, C), dtype=torch.int32, device=at)
        self.pwts = torch.empty((B, T, C), dtype=torch.int32, device=at)
        # the word ends of the start carry (v = LZERO, records 0): plane 0
        self.we_buf = torch.max((self.v[0] + aE[None]).reshape(B, C, S),
                                dim=2).values
        if T:
            self.WEs[:, 0] = self.we_buf
            self.pwns[:, 0] = -1
            self.pwts[:, 0] = -1
        # each frame's packed keys, 0 below every key: each batch row's
        # back-off best (64-bit) and largest new score (32-bit)
        self._bo = (torch.zeros((T + 1, B), dtype=torch.int64, device=at)
                    if self.factored else None)
        self._top = (torch.zeros((T, B), dtype=torch.int32, device=at)
                     if self.beam else None)
        a = self._args = _Args()
        a.band, a.a0, a.aE, a.bonus = (x.data_ptr()
                                       for x in (band, a0, aE, bonus))
        if self.factored:
            a.uni, a.bow = uni.data_ptr(), bow.data_ptr()
        a.we_buf = self.we_buf.data_ptr()
        a.plane_bstride = T * C
        a.word_pen = float(word_pen)
        a.beam = float(beam) if self.beam else 0.0
        a.B, a.C, a.S, a.K, a.bsz = B, C, S, K, bsz
        self._v_ptr = [self.v[i].data_ptr() for i in (0, 1)]
        self._rec_ptr = [self.rec[i].data_ptr() for i in (0, 1)]
        self._start = start.data_ptr()
        self._we, self._pwn, self._pwt = (
            x.data_ptr() for x in (self.WEs, self.pwns, self.pwts))
        self._bo_ptr = self._bo.data_ptr() if self.factored else 0
        self._top_ptr = self._top.data_ptr() if self.beam else 0
        self._outp, self._outp_ptr, self._frames = None, 0, 0
        self._entry = None

    def chunk(self, outp) -> None:
        """The scores of the next frames: (B, CH, Ns) float32 on the card,
        each frame's rows of Ns states contiguous (a batch stride of its
        own is fine)."""
        if outp.dtype != torch.float32:
            raise TypeError(f"lv_step: outp must be torch.float32, got "
                            f"{outp.dtype}")
        if (outp.dim() != 3 or outp.shape[0] != self.B
                or outp.shape[2] != self.Ns):
            raise ValueError(f"lv_step: outp must be (B={self.B}, CH, "
                             f"Ns={self.Ns}), got {tuple(outp.shape)}")
        if outp.stride(2) != 1 or outp.stride(1) != self.Ns:
            raise ValueError(f"lv_step: outp's frames must be contiguous "
                             f"rows, got strides {outp.stride()}")
        if outp.device != self.v.device:
            raise ValueError(f"lv_step: outp on {outp.device}, band on "
                             f"{self.v.device}")
        self._outp = outp  # kept alive until the next chunk
        self._outp_ptr = outp.data_ptr()
        self._args.outp_bstride = outp.stride(0)
        self._frames = outp.shape[1]

    def _planes(self, m, an) -> Tuple[int, int]:
        """The entry planes' pointers; the planes (`an` as int32) are
        kept alive until the next step has launched."""
        B, C = self.B, self.C
        at = self.v.device
        _check(m, "m", torch.float32, (B, C), at)
        if an.dtype != torch.int32 or not an.is_contiguous():
            an = an.to(torch.int32).contiguous()
        _check(an, "an", torch.int32, (B, C), at)
        self._entry = (m, an)
        return m.data_ptr(), an.data_ptr()

    def step(self, tl: int, t: int, m=None, an=None, exp=None) -> None:
        """Launch frame t on frame tl of the chunk. The entry: `exp`
        (exp_v float32, exp_a int32, (B, C) each, or None) on the factored
        exact leg, else the (m, an) planes (an of any integer dtype); both
        are read but unused at t == 0."""
        if not 0 <= tl < self._frames:
            raise ValueError(f"lv_step: frame {tl} of a chunk of "
                             f"{self._frames}")
        if not 0 <= t < self.T:
            raise ValueError(f"lv_step: frame {t} of {self.T}")
        a = self._args
        B, C = self.B, self.C
        cur = t & 1
        a.v, a.rec = self._v_ptr[cur], self._rec_ptr[cur]
        a.v_out, a.rec_out = self._v_ptr[cur ^ 1], self._rec_ptr[cur ^ 1]
        a.outp = self._outp_ptr + 4 * tl * self.Ns
        a.t = t
        a.start = a.bo = a.xv = a.xa = None
        if self.factored:
            if exp is not None:
                a.xv, a.xa = self._planes(*exp)
        elif m is None:
            raise ValueError("lv_step: a leg other than the factored exact "
                             "one needs its (m, an) planes")
        else:
            a.xv, a.xa = self._planes(m, an)
        if t == 0:
            a.start = self._start
        elif self.factored:
            a.bo = self._bo_ptr + 8 * B * t
        if t + 1 == self.T:
            a.we = a.pwn = a.pwt = a.we_buf = a.bo_next = None
        else:
            o = 4 * C * (t + 1)
            a.we, a.pwn, a.pwt = self._we + o, self._pwn + o, self._pwt + o
            a.we_buf = self.we_buf.data_ptr()
            if self.factored:
                a.bo_next = self._bo_ptr + 8 * B * (t + 1)
        fn = KERNEL.build().lv_step_launch
        ref = ctypes.byref(a)
        if self.beam:
            a.top = self._top_ptr + 4 * B * t
            a.phase = UPDATE
            launch(fn, "lv_step", KERNEL, self.card, ref)
            a.phase = ENDS
        else:
            a.phase = FUSED
        launch(fn, "lv_step", KERNEL, self.card, ref)

    def result(self):
        """((v, rec) (B, Ns) after the last frame, rec int64), and the
        planes (WEs, pwns, pwts)."""
        v, rec = self.v[self.T & 1], self.rec[self.T & 1]
        return (v, rec.to(torch.int64) & 0xFFFFFFFF), (self.WEs, self.pwns,
                                                       self.pwts)
