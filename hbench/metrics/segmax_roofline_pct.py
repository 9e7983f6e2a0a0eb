"""segmax_roofline_pct: csrc/xw_gather.cu's segmax kernel's share of its
roofline: `segmax_bound` of each launch's (B, C, padded slots, target
rows) summed, over the kernel's device time in the trace."""

from hbench.metrics._read import roofline


def read(ctx):
    return roofline(ctx, "segmax", "segmax_kernel")
