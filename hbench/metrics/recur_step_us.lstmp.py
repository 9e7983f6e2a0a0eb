"""recur_step_us.lstmp: the time of a frame step of the hybrid LSTMP's
recurrence in the traced window: the summed time of the `htk.ann.recur`
spans (an LSTMP layer's frame loop each, in algo/nnet._lstmp_layer: the
recurrent GEMM, the cell, the projection GEMM a step) over their
`frame_steps`, in microseconds."""

from hbench.metrics._spans import spans


def read(ctx):
    st = (spans(ctx) or {}).get("htk.ann.recur")
    if not st or st["counts"].get("frame_steps", 0) <= 0:
        return None
    return st["total_ns"] * 1e-3 / st["counts"]["frame_steps"]
