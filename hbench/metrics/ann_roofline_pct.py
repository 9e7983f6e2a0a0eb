"""ann_roofline_pct: the hybrid DNN's share of its roofline in the traced
window: `_ann_bounds.ann_bound_s` of the `flops`, `weight_bytes` and
`act_bytes` that the `htk.ann.forward` spans count (algo/nnet.hybrid_outp,
a call a batch), over the device time of the trace's GEMM kernels, in %.
In the hybrid cell the DNN launches every GEMM (OutP is the DNN's, the LV
loop multiplies no matrices). None where no span or no GEMM was recorded:
the GMM cells, an untraced run, or a program without the span."""

from hbench.metrics._ann_bounds import ann_bound_s, is_gemm
from hbench.metrics._spans import spans


def read(ctx):
    fw = (spans(ctx) or {}).get("htk.ann.forward")
    tr = ctx.get("trace")
    if not fw or tr is None:
        return None
    dev_s = sum(t for k, t in tr.kernel_s.items() if is_gemm(k))
    if dev_s <= 0:
        return None
    c = fw["counts"]
    nbytes = c.get("weight_bytes", 0) + c.get("act_bytes", 0)
    return 100.0 * ann_bound_s(c.get("flops", 0), nbytes) / dev_s
