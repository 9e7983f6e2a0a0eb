"""decode_scan_roofline_pct: csrc/decode_scan.cu's share of its roofline:
`decode_bound` of each launch's (B, T, Ns, Nn, K) summed, over the
kernel's device time in the trace."""

from hbench.metrics._read import roofline


def read(ctx):
    return roofline(ctx, "decode_scan", "decode_scan_kernel")
