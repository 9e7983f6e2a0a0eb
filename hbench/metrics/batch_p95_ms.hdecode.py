"""batch_p95_ms.hdecode: the 95th percentile of the host-clock time of
each `generate_lattice_batch` call in the window, synchronised at its
end."""

from hbench.core.stats import percentile


def read(ctx):
    if ctx.get("job") != "lattice" or not ctx.get("call_ms"):
        return None
    return percentile(ctx["call_ms"], 95)
