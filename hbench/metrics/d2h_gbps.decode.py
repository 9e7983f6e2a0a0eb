"""d2h_gbps.decode: the rate of the program's copies from the card to the
host in the traced window: the `d2h_bytes` that algo/decode.py counts
(the planes of `htk.decode.to_host`; the records of `htk.lattice.to_host`
and, in pass 2 of the lattice walk, each wave's gather of pruned
predecessors, `htk.lattice.gather`) over the summed time of the spans
that count them, in GB/s. None where nothing left the card."""

from hbench.metrics._spans import spans


def read(ctx):
    s = spans(ctx)
    if not s:
        return None
    nbytes = ns = 0
    for v in s.values():
        if "d2h_bytes" in v["counts"]:
            nbytes += v["counts"]["d2h_bytes"]
            ns += v["total_ns"]
    if nbytes <= 0 or ns <= 0:
        return None
    return nbytes / ns  # bytes a nanosecond are GB/s
