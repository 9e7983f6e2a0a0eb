"""device_idle_pct.decode: the share of the traced decoding window in
which no kernel, copy or set ran on the card (torch.profiler)."""

from hbench.metrics._read import idle


def read(ctx):
    return idle(ctx, "decode")
