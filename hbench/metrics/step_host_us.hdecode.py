"""step_host_us.hdecode: the host's time a frame step of the uniform-row
decoder's frame loop in the traced window: the summed time of the
`htk.lv.step` spans (a chunk of `step` calls each, in `_lv_scan_body`)
over their `frame_steps`, in microseconds."""

from hbench.metrics._spans import spans


def read(ctx):
    st = (spans(ctx) or {}).get("htk.lv.step")
    if not st or st["counts"].get("frame_steps", 0) <= 0:
        return None
    return st["total_ns"] * 1e-3 / st["counts"]["frame_steps"]
