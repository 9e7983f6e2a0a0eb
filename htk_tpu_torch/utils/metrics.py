"""Structured metrics and the profiler hook of a tool's device hot loop.

The torch counterpart of `htk_tpu/utils/metrics.py`:

  HTKTPU: METRICS = file   append one JSON line per tool milestone
                           (tool, wall time, the tool's key numbers)
  HTKTPU: PROFILE = dir    wrap the tool's hot loop in a torch.profiler
                           trace written as dir/<tool>/trace.json
                           (chrome://tracing / Perfetto)

Both are config-driven no-ops by default.
"""

from __future__ import annotations

import contextlib
import json
import os
import time


def emit_metric(cfg, tool: str, **record) -> None:
    """Append one JSONL metrics record if HTKTPU:METRICS is configured."""
    path = cfg.str_("METRICS", None, module="HTKTPU") if cfg else None
    if not path:
        return
    rec = {"tool": tool, "ts": round(time.time(), 3)}
    rec.update(record)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def maybe_profile(cfg, tool: str):
    """torch.profiler trace around a tool's hot loop when configured."""
    d = cfg.str_("PROFILE", None, module="HTKTPU") if cfg else None
    if not d:
        yield
        return
    import torch

    out = os.path.join(d, tool)
    os.makedirs(out, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
