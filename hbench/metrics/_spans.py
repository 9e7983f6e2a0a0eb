"""What the span readers share: the spans that the program recorded in
the traced window, summed by name (`htk_tpu_torch.utils.metrics.summary`:
a count, total and self nanoseconds, and summed counts a name). The
program records its spans while a torch profiler runs, so the recorder
holds the traced window's calls when the readers run. A program without
spans (one older than the recorder) gives None, and so does an untraced
context.
"""

from __future__ import annotations

from typing import Optional


def spans(ctx: dict) -> Optional[dict]:
    """The traced window's spans by name, or None where there are none."""
    if ctx.get("trace") is None:
        return None
    from htk_tpu_torch.utils import metrics

    summary = getattr(metrics, "summary", None)
    return (summary() or None) if summary is not None else None
