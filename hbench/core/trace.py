"""Reading a torch.profiler trace of the measured window: the device's busy
time (the union of its kernels, copies and sets), each kernel's device
time and records, the operations that took most device time, and the idle
gaps by what the host was doing.

The window is the harness's own `hbench.window` annotation. Device
activity is clipped to it. An idle gap is named after the innermost host
operation or annotation that covers its middle; gaps are summed by that
name.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

WINDOW = "hbench.window"
BREAKDOWN = 10


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float] = field(default_factory=dict)
    kernel_n: Dict[str, int] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def time_of(self, key: str) -> Tuple[float, int]:
        """Device seconds and records of the kernels whose name holds
        `key`."""
        s = n = 0
        for name, t in self.kernel_s.items():
            if key in name:
                s += t
                n += self.kernel_n[name]
        return s, n


def _where(e) -> str:
    """"device" for a kernel, copy or set on the card, "host" for an
    operation or annotation on the CPU, "" for the rest (the card's copies
    of annotations, runtime calls)."""
    kind = str(e.activity_type()).lower() if hasattr(e, "activity_type") \
        else ""
    on_card = "cuda" in str(e.device_type()).lower()
    if "annotation" in kind or "runtime" in kind or "python" in kind:
        return "host" if ("user" in kind and not on_card) else ""
    return "device" if on_card else "host"


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters,
    with the functor it runs where the name carries one; other names
    (copies, sets) whole."""
    n = name.replace("(anonymous namespace)::", "").replace("void ", "")
    if "<" not in n and "::" not in n:
        return n.split("(")[0] if re.match(r"^\w+\(", n) else n
    base = re.split(r"[<(]", n, maxsplit=1)[0].split("::")[-1].strip()
    for pat in (r"CUDAFunctor_\w+", r"\w+Functor\w*", r"\w+Ops\b",
                r"\w+_kernel_impl"):
        m = re.search(pat, n[len(base):])
        if m:
            return f"{base}[{m.group(0)}]"
    return base


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged, sorted intervals (n, 2) of the rows of `iv`."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.nonzero(new)[0]
    last = np.append(idx[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], axis=1)


def read(prof) -> Trace:
    """Summarise a finished `torch.profiler.profile` session."""
    evs = prof.profiler.kineto_results.events()
    dev, host, w = [], [], None
    for e in evs:
        k = _where(e)
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if k == "device" and not e.name().startswith("hbench."):
            dev.append((e.name(), a, b))
        elif k == "host":
            if e.name() == WINDOW:
                w = (a, b)
            else:
                host.append((a, b, e.name()))
    if w is None:
        raise RuntimeError(f"trace: no {WINDOW} annotation recorded")
    w0, w1 = w
    kernel_s: Dict[str, float] = {}
    kernel_n: Dict[str, int] = {}
    iv = []
    for name, a, b in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        iv.append((a, b))
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-9
        kernel_n[name] = kernel_n.get(name, 0) + 1
    busy = _union(np.asarray(iv, np.int64).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9
    by_name: Dict[str, float] = {}
    for name, t in kernel_s.items():
        by_name[short_name(name)] = by_name.get(short_name(name), 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN]
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy_s,
                 kernel_s=kernel_s, kernel_n=kernel_n, device_ops=top,
                 idle_gaps=_idle_gaps(busy, w0, w1, host))


def _idle_gaps(busy: np.ndarray, w0: int, w1: int, host) -> List:
    """Idle seconds by the innermost host event over each gap's middle:
    one sweep over the host events by start, a stack of the open ones."""
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    host.sort()
    by: Dict[str, float] = {}
    stack: List[tuple] = []
    k = 0
    for a, b in gaps.tolist():
        mid = (a + b) // 2
        while k < len(host) and host[k][0] <= mid:
            while stack and stack[-1][1] < host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "idle, no host operation"
        by[name] = by.get(name, 0.0) + (b - a) * 1e-9
    return sorted(by.items(), key=lambda kv: -kv[1])[:BREAKDOWN]
