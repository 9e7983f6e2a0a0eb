"""Structured metrics, the profiler hook of a tool's device hot loop, and
the program's spans and counters.

The torch counterpart of `htk_tpu/utils/metrics.py`:

  HTKTPU: METRICS = file   append one JSON line per tool milestone
                           (tool, wall time, the tool's key numbers)
  HTKTPU: PROFILE = dir    wrap the tool's hot loop in a torch.profiler
                           trace written as dir/<tool>/trace.json
                           (chrome://tracing / Perfetto), with the spans'
                           `summary()` beside it as dir/<tool>/summary.json

Both are config-driven no-ops by default.

Spans. `span(name, **counts)` marks a stage of a call into the program
(a batch, its padding, OutP, the scan, the copies, the host walk), never
a single frame. It is off unless recording is on: while a torch profiler
records (HTKTPU: PROFILE, a benchmark's traced window) or inside
`recording()`. Off, a span costs a check of the profiler's state and of
one flag and returns a shared no-op context. On, it

  - opens a profiler range named `name` while a profiler records, so
    that the span is a host event on kineto's timeline, on the clock of
    the device's kernels and copies. The range is an operator's
    (`torch._C._profiler._RecordFunctionFast`), not the user annotation
    of `torch.profiler.record_function`: on a CUDA card kineto copies a
    user annotation onto the device's timeline over the kernels launched
    inside it, and a trace reader that takes the device's events for its
    busy time would count those copies as work;
  - appends a `SpanRecord` to `RECORDER`: its name, the call it belongs
    to (every span of one top-level call shares a `call_id`), its
    parent, start and end on kineto's clock, and its integer counts.

`add(name, n)` adds to a count of the innermost open span. `RECORDER`
keeps the spans of the latest recording session only: it starts afresh
when recording begins after a span ran with it off, or at the outermost
`recording()`. `summary()` sums the records by span name.

Times: kineto reports a host event's start on the Unix epoch clock, as
`time.time_ns()` reads it, so the recorder reads that clock
(tests/test_torch_trace.py holds the two together).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

_profiling = torch.autograd._profiler_enabled  # a profiler records
_range = torch._C._profiler._RecordFunctionFast  # a profiler range
clock_ns = time.time_ns  # kineto's clock for host events
CAP = 1_000_000  # records a session keeps; the rest are counted as dropped


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
    """torch.profiler trace around a tool's hot loop when configured, and
    the summary of the spans recorded under it."""
    d = cfg.str_("PROFILE", None, module="HTKTPU") if cfg else None
    if not d:
        yield
        return
    out = os.path.join(d, tool)
    os.makedirs(out, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with recording(), torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump({"spans": summary(), "dropped": RECORDER.dropped}, f,
                  indent=1)


@dataclass
class SpanRecord:
    """One span of a recording session. `parent` is the index in
    `Recorder.records` of the span it opened inside (-1 for a call's
    top span, or where that span was dropped); `end_ns` is 0 while the
    span is open."""

    name: str
    call_id: int
    parent: int
    start_ns: int
    end_ns: int = 0
    counts: Dict[str, int] = field(default_factory=dict)


class Recorder:
    """The spans of the latest recording session, in the order they
    opened (one thread's: the decoders' calls are not concurrent)."""

    def __init__(self):
        self.cap = CAP
        self.depth = 0  # open `recording()` contexts
        self.clear()

    def clear(self) -> None:
        self.records: List[SpanRecord] = []
        self.dropped = 0
        self.lapsed = False  # whether a span ran with recording off since
        self.open: List[int] = []  # indices of the open spans (-1 dropped)
        self.calls = 0

    def enter(self, name: str, counts: Dict[str, int]) -> int:
        if not self.open:
            if self.lapsed:
                self.clear()
            self.calls += 1
        if len(self.records) >= self.cap:
            self.dropped += 1
            idx = -1
        else:
            idx = len(self.records)
            self.records.append(SpanRecord(
                name, self.calls, self.open[-1] if self.open else -1, 0,
                counts=counts))
        self.open.append(idx)
        return idx


RECORDER = Recorder()


class _Span:
    """A span while recording is on."""

    __slots__ = ("name", "counts", "fn", "idx")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name, self.counts, self.fn = name, counts, None

    def __enter__(self):
        if _profiling():
            self.fn = _range(self.name)
        self.idx = RECORDER.enter(self.name, self.counts)
        if self.idx >= 0:
            # before the range's entry, which stamps its start early and
            # may then set itself up (about 1.5 ms the first time)
            RECORDER.records[self.idx].start_ns = clock_ns()
        if self.fn is not None:
            self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        if self.idx >= 0:
            RECORDER.records[self.idx].end_ns = clock_ns()
        if RECORDER.open:
            RECORDER.open.pop()
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, **counts: int):
    """A context around one stage of a call: recorded while recording is
    on (see the module's docstring), the shared no-op context otherwise.
    `counts` start the span's integer counts."""
    if _profiling() or RECORDER.depth:
        return _Span(name, counts)
    RECORDER.lapsed = True
    return _OFF


def add(name: str, n: int) -> None:
    """Add `n` to the count `name` of the innermost open span (nothing
    while none is recorded)."""
    if RECORDER.open and RECORDER.open[-1] >= 0:
        c = RECORDER.records[RECORDER.open[-1]].counts
        c[name] = c.get(name, 0) + int(n)


def device_wait(name: str, device) -> None:
    """While recording, a span `name` around a synchronize of `device`
    where it is a CUDA device: the wait for the queued work, kept apart
    from the copies that follow it (which would wait for it anyway).
    Nothing while recording is off."""
    if not (_profiling() or RECORDER.depth):
        RECORDER.lapsed = True
        return
    with _Span(name, {}):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


@contextlib.contextmanager
def recording():
    """Record spans inside the context whether or not a profiler runs; the
    outermost one outside a profiler starts a new session."""
    if not RECORDER.depth and not _profiling():
        RECORDER.clear()
    RECORDER.depth += 1
    try:
        yield
    finally:
        RECORDER.depth -= 1


def summary() -> Dict[str, dict]:
    """By span name over the closed spans of the session: `count`,
    `total_ns`, `self_ns` (the total less the part its child spans
    cover) and `counts` (each count summed)."""
    recs = RECORDER.records
    inner = [0] * len(recs)
    for r in recs:
        if r.end_ns and r.parent >= 0:
            inner[r.parent] += r.end_ns - r.start_ns
    out: Dict[str, dict] = {}
    for r, kids in zip(recs, inner):
        if not r.end_ns:
            continue
        s = out.setdefault(r.name, {"count": 0, "total_ns": 0,
                                    "self_ns": 0, "counts": {}})
        s["count"] += 1
        s["total_ns"] += r.end_ns - r.start_ns
        s["self_ns"] += r.end_ns - r.start_ns - kids
        for k, v in r.counts.items():
            s["counts"][k] = s["counts"].get(k, 0) + v
    return out
