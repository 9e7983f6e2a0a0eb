"""lstmp_cell_roofline_pct: csrc/lstmp_cell.cu's share of its roofline:
`_lstmp_bounds.cell_bound_ms` of each launch's (B, n_c) summed, over the
kernel's device time in the trace."""

from hbench.metrics._read import roofline


def read(ctx):
    return roofline(ctx, "lstmp_cell", "lstmp_cell")
