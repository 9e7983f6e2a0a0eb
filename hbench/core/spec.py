"""Finding a cell's files by name: `BENCHMARK.json` at the checkout's root
names the cell, its configuration file and its metrics; the cell's traffic
is `hbench/workloads/<cell>.json`, its window loop
`hbench/drivers/<driver>.py`, and each per-layer metric a reader
`hbench/metrics/<metric>.py` with a function `read(ctx)` that returns a
number or None (nothing to read in this cell).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

HBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HBENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclass
class Cell:
    name: str
    config: dict  # the configuration file's contents
    workload: dict  # the cell's traffic file's contents
    chips: int
    end_to_end: List[dict]  # the metrics this cell reports with --trace 0
    per_layer: List[dict]  # ... and with --trace 1


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load(root: str, rel: str) -> dict:
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its files read."""
    bench = benchmark(root)
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, name) and m["moves"] in moved]
    return Cell(name=name, config=_load(root, conf["file"]),
                workload=_load(root, os.path.join("hbench", "workloads",
                                                  f"{name}.json")),
                chips=int(wl["chips"]), end_to_end=e2e, per_layer=layer)


def driver(kind: str):
    """The window loop of a kind of job: hbench/drivers/<kind>.py."""
    return importlib.import_module(f"hbench.drivers.{kind}")


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """The `read` function of hbench/metrics/<metric>.py."""
    path = os.path.join(HBENCH, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "hbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def readers(metrics: List[dict]) -> Dict[str, Callable]:
    return {m["name"]: reader(m["name"]) for m in metrics}
