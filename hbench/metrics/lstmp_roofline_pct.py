"""lstmp_roofline_pct: the hybrid LSTMP's OutP share of its roofline in the
traced window: `_lstmp_bounds.outp_bound_s` of the `flops`,
`weight_bytes` and `act_bytes` that the `htk.ann.forward` spans count
(algo/nnet.hybrid_outp, a call a batch), over the device time of the
trace's GEMM, GEMV and lstmp_cell kernels, in %. The card's profiler
drops some launch records; the cell's launches are counted
(ops/lstmp.KERNEL), the GEMMs' are not, so the kernels' device time is
scaled by the cell's launches over its records kept (the GEMMs are
launched in the same frame loop, two to a cell launch). In a 51-s traced
window of the cell on an H100 the profiler kept every record of both:
the cell's 106,185 launches, and one GEMM or GEMV record for each of the
212,409 products (2 a frame step but the first of a layer, and 4 a
call), besides the split-K kernels' second kernels; the scale read 1
there. None where no
span or no such kernel was recorded: the other cells, an untraced run,
or a program without the span."""

from hbench.metrics._lstmp_bounds import is_outp_kernel, outp_bound_s
from hbench.metrics._spans import spans


def read(ctx):
    fw = (spans(ctx) or {}).get("htk.ann.forward")
    tr = ctx.get("trace")
    if not fw or tr is None:
        return None
    dev_s = sum(t for k, t in tr.kernel_s.items() if is_outp_kernel(k))
    if dev_s <= 0:
        return None
    cell_s, recorded = tr.time_of("lstmp_cell")
    launched = ctx["launches"].get("lstmp_cell", 0)
    if recorded and launched > recorded:
        dev_s *= launched / recorded
    c = fw["counts"]
    nbytes = c.get("weight_bytes", 0) + c.get("act_bytes", 0)
    return 100.0 * outp_bound_s(c.get("flops", 0), nbytes) / dev_s
