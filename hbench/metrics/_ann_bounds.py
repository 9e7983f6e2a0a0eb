"""The least time the hybrid DNN's GEMMs could take on one H100, at the
frozen peaks of `_bounds.py`: the larger of the operations over the FP32
peak and the bytes (the weights once a call, each layer's input and output
activations once) over HBM bandwidth. The operations and bytes are the
program's own counts on its `htk.ann.forward` span (`flops`,
`weight_bytes`, `act_bytes`: algo/nnet.hybrid_outp), summed over the
window's calls; every call of the cell is compute-bound, so the bound of
the sums is the sum of the calls' bounds.

The GEMM kernels are found in the trace by name: every GEMM that cuBLAS
launches for the DNN on an H100 (torch 2.11, CUDA 12.8) carries "gemm" in
its name: FP32 `sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_*`
(one a layer), TF32 `sm90_xmma_gemm_f32f32_tf32f32_f32_*` and
`cutlass_80_tensorop_s1688gemm_*`. No other code of the hybrid cell
multiplies matrices.
"""

from __future__ import annotations

from ._bounds import FP32_OPS, HBM_BPS

GEMM_KEY = "gemm"


def ann_bound_s(flops: float, nbytes: float) -> float:
    """Seconds: the larger of the operations over the FP32 peak and the
    bytes over bandwidth."""
    return max(flops / FP32_OPS, nbytes / HBM_BPS)


def is_gemm(kernel: str) -> bool:
    """Whether a kernel of the trace is one of cuBLAS's GEMMs."""
    return GEMM_KEY in kernel.lower()
