"""bucket_p95_ms.hvite: the 95th percentile of the host-clock time of each
`decode_batch` call in the window (a bucket handed over until its
transcripts are on the host), synchronised at its end."""

from hbench.core.stats import percentile


def read(ctx):
    if ctx.get("job") != "decode" or not ctx.get("call_ms"):
        return None
    return percentile(ctx["call_ms"], 95)
