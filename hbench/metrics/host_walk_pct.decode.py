"""host_walk_pct.decode: the share of the decoder's calls spent walking
the records on the host, in the traced window: the self time of
`htk.decode.finalize` (decode_batch's `_finalize` loop), or of
`htk.lattice.records`, `htk.lattice.resurrect` and `htk.lattice.walk`
(generate_lattice_batch's passes 1-3; pass 2's gathers from the card,
`htk.lattice.gather`, are copies and left out), over the time of the
calls (`htk.decode.batch`, `htk.lattice.batch`), in %."""

from hbench.metrics._spans import spans

WALK = {
    "decode": (("htk.decode.finalize",), "htk.decode.batch"),
    "lattice": (("htk.lattice.records", "htk.lattice.resurrect",
                 "htk.lattice.walk"), "htk.lattice.batch"),
}


def read(ctx):
    s = spans(ctx)
    if not s or ctx.get("job") not in WALK:
        return None
    parts, call = WALK[ctx["job"]]
    if call not in s or s[call]["total_ns"] <= 0:
        return None
    walk = sum(s[p]["self_ns"] for p in parts if p in s)
    return 100.0 * walk / s[call]["total_ns"]
