"""The least time the hybrid LSTMP's OutP and its cell kernel could take on
one H100, at the frozen peaks of `_bounds.py`.

The OutP (algo/nnet.hybrid_outp, a call a batch): the larger of the
operations over the FP32 peak and the bytes (the weights once a call,
each layer's input and output rows once) over HBM bandwidth, from the
program's own counts on its `htk.ann.forward` span (`flops`,
`weight_bytes`, `act_bytes`). Every call of the cell is compute-bound,
so the bound of the window's sums is the sum of the calls' bounds.

The cell (csrc/lstmp_cell.cu, a launch a frame step of a layer): the
gate rows gx and gr (4 n_c a batch row each), c_{t-1}, the peepholes
(3 n_c) and the bias (4 n_c) in, c_t and m_t out, float32; about 29
operations a (batch row, cell): the four gates' two adds, the three
peepholes' multiply and add, three sigmoids (a negation's exp, an add, a
divide), two tanh, c_t's two multiplies and add, m's multiply.

The OutP's kernels are found in the trace by name: cuBLAS's GEMMs and
GEMVs (FP32 on an H100 under torch 2.11: the input and output layers'
large products, and the frame steps' products at M = B rows, which
cuBLAS may split over K and then reduce), and the cell. No other code of
the cell multiplies matrices: the LV loop and the walk multiply none.
"""

from __future__ import annotations

from ._bounds import FP32_OPS, HBM_BPS, bound

KERNEL_KEYS = ("gemm", "gemv", "splitkreduce", "lstmp_cell")
CELL_OPS = 29  # operations a (batch row, cell), as above


def outp_bound_s(flops: float, nbytes: float) -> float:
    """Seconds: the larger of the operations over the FP32 peak and the
    bytes over bandwidth."""
    return max(flops / FP32_OPS, nbytes / HBM_BPS)


def is_outp_kernel(kernel: str) -> bool:
    """Whether a kernel of the trace is one of the LSTM OutP's."""
    k = kernel.lower()
    return any(key in k for key in KERNEL_KEYS)


def cell_bound_ms(B: int, n_c: int) -> float:
    """Milliseconds of one lstmp_cell launch over B batch rows of n_c
    cells."""
    nbytes = 4 * (2 * 4 * B * n_c + 3 * B * n_c + 7 * n_c)
    return bound(nbytes, CELL_OPS * B * n_c)
