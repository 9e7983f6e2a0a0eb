"""Profiler hook for a tool's device hot loop.

The torch counterpart of `htk_tpu/utils/metrics.py : maybe_profile`:

  HTKTPU: PROFILE = dir    wrap the tool's hot loop in a torch.profiler
                           trace written as dir/<tool>/trace.json
                           (chrome://tracing / Perfetto)

A config-driven no-op by default.
"""

from __future__ import annotations

import contextlib
import os


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
