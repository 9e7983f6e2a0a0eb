"""mfu.decode: the decoding step's share of the FP32 peak. Every Gaussian
of the set scored on every real frame decoded in the window (2 x 2D x M
operations a frame), over the window's seconds; the recursion's own work
is left out."""

from hbench.metrics._read import mfu


def read(ctx):
    return mfu(ctx, "decode")
