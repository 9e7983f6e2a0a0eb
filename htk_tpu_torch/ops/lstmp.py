"""The pointwise cell of an LSTMP layer's frame step: csrc/lstmp_cell.cu on
the card, its plain torch version on the CPU.

One step of B batch rows and n_c cells takes

    gx    (B, 4 n_c)  the input part of the gate pre-activations, W_x x_t
    gr    (B, 4 n_c)  the recurrent part, W_r r_{t-1}
    c     (B, n_c)    c_{t-1}
    peep  (3, n_c)    p_i, p_f, p_o
    bias  (4 n_c,)

(gate rows i, f, c, o, n_c each) and gives c_t and m_t, (B, n_c) each, in
these float32 operations, in this order, each rounded on its own:

    z = (gx + gr) + bias
    i = sigmoid(z_i + p_i c)    f = sigmoid(z_f + p_f c)
    c_t = f c + i tanh(z_c)
    o = sigmoid(z_o + p_o c_t)  m_t = o tanh(c_t)

`lstmp_cell_plain` is the plain version (any device). `CellSteps` holds
one layer call's state: the call's gate rows gx (S, B, 4 n_c) from the
input GEMM, the recurrent part `gr` (B, 4 n_c) that the caller's GEMM
writes before each step (zero before the first), the cell state in two
(B, n_c) buffers used in turn (zero before the first step), and `m`
(B, n_c). `step(t)` runs frame t: the plain version for CPU tensors, one
launch of the kernel for CUDA tensors (counted on `KERNEL.launches`),
never a fallback. The kernel does the plain version's operations in its
order (no fused multiply-add; sigmoid as 1 / (1 + exp(-x)), as torch
computes it on the card), so the two agree bit for bit on the card. The
operands are checked once a call; a step fills one ctypes structure.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda import CudaKernel, launch

_PTRS = ("gx", "gr", "c", "peep", "bias", "c_out", "m_out")


class _Args(ctypes.Structure):
    """csrc/lstmp_cell.cu's `LstmpCellArgs`, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [("gx_bstride", ctypes.c_longlong), ("B", ctypes.c_int),
                   ("n_c", ctypes.c_int)])


def _bind(lib):
    lib.lstmp_cell_launch.argtypes = [ctypes.POINTER(_Args),
                                      ctypes.c_void_p]
    lib.lstmp_cell_launch.restype = ctypes.c_int


KERNEL = CudaKernel("lstmp_cell", _bind)


def lstmp_cell_plain(gx, gr, c, peep, bias):
    """(c_t, m_t) of one step (the module's docstring), in torch."""
    n = c.shape[1]
    z = gx + gr + bias
    i = torch.sigmoid(z[:, :n] + peep[0] * c)
    f = torch.sigmoid(z[:, n:2 * n] + peep[1] * c)
    ct = f * c + i * torch.tanh(z[:, 2 * n:3 * n])
    o = torch.sigmoid(z[:, 3 * n:] + peep[2] * ct)
    return ct, o * torch.tanh(ct)


def _check(x, name: str, shape, at) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"lstmp_cell: {name} must be torch.float32, got "
                        f"{x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"lstmp_cell: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"lstmp_cell: {name} must be contiguous")
    if x.device != at:
        raise ValueError(f"lstmp_cell: {name} on {x.device}, gx on {at}")


class CellSteps:
    """One LSTMP layer call's cell (see the module's docstring): `gx`
    (S, B, 4 n_c), `peep` (3, n_c), `bias` (4 n_c,), float32, contiguous,
    on one device."""

    def __init__(self, gx, peep, bias):
        if gx.dim() != 3 or gx.shape[2] % 4:
            raise ValueError(f"lstmp_cell: gx must be (S, B, 4 n_c), got "
                             f"{tuple(gx.shape)}")
        S, B, G = gx.shape
        n = G // 4
        at = gx.device
        _check(gx, "gx", (S, B, G), at)
        _check(peep, "peep", (3, n), at)
        _check(bias, "bias", (G,), at)
        self.S, self.B, self.n_c = S, B, n
        self.gx, self.peep, self.bias = gx, peep, bias
        self.gr = torch.zeros((B, G), dtype=torch.float32, device=at)
        self.c = torch.zeros((2, B, n), dtype=torch.float32, device=at)
        self.m = torch.empty((B, n), dtype=torch.float32, device=at)
        self.on_card = at.type == "cuda"
        if self.on_card:
            self.card = gx.get_device()
            a = self._args = _Args()
            a.gr, a.peep, a.bias, a.m_out = (
                x.data_ptr() for x in (self.gr, peep, bias, self.m))
            a.gx_bstride, a.B, a.n_c = G, B, n
            self._c_ptr = [self.c[k].data_ptr() for k in (0, 1)]
            self._gx_ptr = gx.data_ptr()

    def step(self, t: int) -> None:
        """Frame t: c_t into `self.c[(t + 1) % 2]`, m_t into `self.m`,
        from gx[t], `self.gr` and c_{t-1} in `self.c[t % 2]`."""
        if not 0 <= t < self.S:
            raise ValueError(f"lstmp_cell: frame {t} of {self.S}")
        cur = t & 1
        if not self.on_card:
            ct, m = lstmp_cell_plain(self.gx[t], self.gr, self.c[cur],
                                     self.peep, self.bias)
            self.c[cur ^ 1] = ct
            self.m.copy_(m)
            return
        a = self._args
        a.gx = self._gx_ptr + 4 * t * self.B * 4 * self.n_c
        a.c, a.c_out = self._c_ptr[cur], self._c_ptr[cur ^ 1]
        launch(KERNEL.build().lstmp_cell_launch, "lstmp_cell", KERNEL,
               self.card, ctypes.byref(a))
