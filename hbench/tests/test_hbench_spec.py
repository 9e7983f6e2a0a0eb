"""BENCHMARK.json and the files it names: they parse, every name and unit
keeps to the allowed characters, every metric's cells report the
end-to-end metric it moves, and nothing under hbench/ imports JAX or the
JAX package (top-level module names compared whole)."""

import ast
import json
import os

import pytest

from hbench.core import spec
from hbench.run import FORBIDDEN

BENCH = spec.benchmark()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _files(ext=".py"):
    for d, _, fs in os.walk(spec.HBENCH):
        for f in fs:
            if f.endswith(ext):
                yield os.path.join(d, f)


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["hbench"]
    assert BENCH["command"] == ["python3", "hbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_allowed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert spec.NAME.match(n), n
    for e in BENCH[kind]:
        if "unit" in e:
            assert spec.UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text


def test_configs_parse_and_are_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("hbench/")
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert c["name"] in used


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_files(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4)
    c = spec.cell(w["name"])
    assert c.workload["name"] == w["name"]
    assert c.workload["why"] == w["why"]
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert spec.driver(c.workload["driver"]).Job
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in cells
            assert "workloads" not in moved or w in moved["workloads"]
        assert callable(spec.reader(m["name"]))


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def _top_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_forbidden_names_compare_whole():
    tops = {m.split(".")[0] for m in ("htk_tpu_torch.algo.decode",
                                      "htk_tpu.algo", "jaxlib.xla")}
    assert tops & set(FORBIDDEN) == {"htk_tpu", "jaxlib"}


@pytest.mark.parametrize("path", sorted(_files()),
                         ids=lambda p: os.path.relpath(p, spec.HBENCH))
def test_no_jax_and_no_jax_package(path):
    assert not set(_top_imports(path)) & set(FORBIDDEN)
    src = open(path).read()
    for old in ("bench.py", "benchmarks/", "BENCH_", "MULTICHIP_"):
        assert old not in src or path.endswith("test_hbench_spec.py")


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(spec.HBENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            assert "htk_tpu_torch" not in set(_top_imports(
                os.path.join(ref, f)))
