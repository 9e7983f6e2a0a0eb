"""What the per-layer readers share. A reader gets the run's context:

  side, job      "decode" and the driver ("decode", "lattice")
  window_s       the measured window's seconds (host clock)
  model_flops    the model's own arithmetic over the window's real frames
  bounds_ms      each kernel's roofline bound summed over its launches
  launches       each kernel's launches, from the program's LaunchCount
  call_ms        each call's host-clock milliseconds
  trace          the traced window (core.trace.Trace), or None untraced
"""

from __future__ import annotations

from typing import Optional

from ._bounds import FP32_OPS


def mfu(ctx: dict, side: str) -> Optional[float]:
    """The model's arithmetic over the window at the FP32 peak, in %."""
    if ctx.get("side") != side or not ctx.get("model_flops"):
        return None
    return 100.0 * ctx["model_flops"] / ctx["window_s"] / FP32_OPS


def roofline(ctx: dict, key: str, kernel: str) -> Optional[float]:
    """A kernel's bound over its device time, in %. The card's profiler
    drops some launch records, so the device time is the time of the
    records kept scaled to the launches made."""
    tr, n = ctx.get("trace"), ctx["launches"].get(key, 0)
    if tr is None or not n:
        return None
    dev_s, recorded = tr.time_of(kernel)
    if not recorded or dev_s <= 0:
        return None
    return 100.0 * ctx["bounds_ms"][key] * 1e-3 / (dev_s * n / recorded)


def idle(ctx: dict, side: str) -> Optional[float]:
    """The share of the traced window in which nothing ran on the
    device, in %."""
    tr = ctx.get("trace")
    if ctx.get("side") != side or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
