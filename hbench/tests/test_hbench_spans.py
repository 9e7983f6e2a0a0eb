"""The readers of the program's spans (metrics/_spans.py and the three
metrics that read it), on the tiny CPU cells of test_hbench_cells.py: a
traced run reports each span metric in the cells that list it, a share
lies in [0, 100], nothing leaves a CUDA device on the CPU so the copy
rate reads None, an untraced run records no span, and a program without
the recorder (the benchmark laid over an older checkout) reads None."""

import pytest
import torch

from hbench.core import spec
from htk_tpu_torch.utils import metrics

from .test_hbench_cells import CELLS, run

SPAN_METRICS = ["d2h_gbps.decode", "host_walk_pct.decode",
                "step_host_us.hdecode"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _listed(name):
    return {m["name"] for m in spec.cell(name).per_layer}


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_the_span_metrics_it_lists(name):
    out = run(name, trace=True)
    assert out["correct"]
    m = out["metrics"]
    listed = _listed(name)
    for k in ("host_walk_pct.decode", "step_host_us.hdecode"):
        assert (k in m) == (k in listed), k
    assert 0.0 <= m["host_walk_pct.decode"]["value"] <= 100.0
    # on the CPU nothing is copied off a CUDA device
    assert "d2h_gbps.decode" not in m
    if "step_host_us.hdecode" in m:
        assert m["step_host_us.hdecode"]["value"] > 0
    assert {r.name.split(".")[1] for r in metrics.RECORDER.records} == (
        {"lattice", "lv"} if spec.cell(name).workload["driver"] == "lattice"
        else {"decode"})


@pytest.mark.parametrize("name", CELLS)
def test_an_untraced_run_records_no_span(name):
    before = list(metrics.RECORDER.records)
    out = run(name, trace=False)
    assert out["correct"]
    assert metrics.RECORDER.records == before
    assert metrics.RECORDER.lapsed and metrics.RECORDER.open == []


FAKE = {
    "htk.lattice.batch": {"count": 2, "total_ns": 4_000_000_000,
                          "self_ns": 0, "counts": {}},
    "htk.lattice.to_host": {"count": 2, "total_ns": 2_000_000,
                            "self_ns": 2_000_000,
                            "counts": {"d2h_bytes": 12_000_000}},
    "htk.lattice.resurrect": {"count": 2, "total_ns": 2_000_000,
                              "self_ns": 1_000_000, "counts": {}},
    "htk.lattice.gather": {"count": 3, "total_ns": 1_000_000,
                           "self_ns": 1_000_000,
                           "counts": {"d2h_bytes": 3_000_000}},
    "htk.lattice.records": {"count": 2, "total_ns": 199_000_000,
                            "self_ns": 199_000_000, "counts": {}},
    "htk.lattice.walk": {"count": 2, "total_ns": 800_000_000,
                         "self_ns": 800_000_000, "counts": {}},
    "htk.lv.step": {"count": 20, "total_ns": 2_560_000_000,
                    "self_ns": 2_560_000_000,
                    "counts": {"frame_steps": 1280}},
}
CTX = {"job": "lattice", "side": "decode", "trace": object()}


@pytest.mark.parametrize("metric, want", [
    ("d2h_gbps.decode", 15e6 / 3e6),  # 15 MB in 3 ms
    ("host_walk_pct.decode", 100.0 * 1.0e9 / 4e9),
    ("step_host_us.hdecode", 2.56e6 / 1280),
])
def test_reader_arithmetic(monkeypatch, metric, want):
    monkeypatch.setattr(metrics, "summary", lambda: FAKE)
    assert spec.reader(metric)(CTX) == pytest.approx(want, rel=1e-12)
    assert spec.reader(metric)(dict(CTX, trace=None)) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_readers_read_none_without_spans(monkeypatch, metric):
    read = spec.reader(metric)
    monkeypatch.setattr(metrics, "summary", lambda: {})
    assert read(CTX) is None
    monkeypatch.delattr(metrics, "summary")  # an older program
    assert read(CTX) is None


def test_the_walk_share_reads_the_cells_own_spans(monkeypatch):
    monkeypatch.setattr(metrics, "summary", lambda: FAKE)
    read = spec.reader("host_walk_pct.decode")
    assert read(dict(CTX, job="decode")) is None  # no htk.decode.* spans
    assert read(dict(CTX, job="other")) is None
