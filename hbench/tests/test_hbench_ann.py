"""The hybrid cell, wsj20k_dnn7x2048.hdecode, on the CPU: its configuration
holds the published widths, a tiny version of it (3 sigmoid layers of 64
over the tiny cells' system) agrees with the plain reference, a traced run
records the DNN's spans, and planted faults in the DNN come out not
correct: a hidden layer skipped, the matmuls' inputs rounded to TF32's 10
mantissa bits, and the splice clamped at the padded length instead of at
each utterance's own; `ann_gap` sees each."""

import json
import os
import time

import pytest
import torch

from hbench.core import spec
from hbench.core.trace import Trace
from hbench.drivers import lattice_ann
from hbench.run import run_cell
from hbench.traffic.synth import build_structure
from htk_tpu_torch.algo import nnet
from htk_tpu_torch.models import ann as ann_mod
from htk_tpu_torch.utils import metrics

from .test_hbench_cells import SEED, tiny

CELL = "wsj20k_dnn7x2048.hdecode"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(trace=False, seed=SEED):
    c = tiny(CELL)
    c.config = dict(c.config, hidden=[64, 64, 64])
    return run_cell(c, seed, 1.0, trace, CPU, t_process=time.perf_counter())


def test_the_configuration_holds_the_published_widths():
    c = spec.cell(CELL)
    cfg = c.config
    assert cfg["reduced"] == [] and c.chips == 1
    assert cfg["context"] == 5 and cfg["dim"] == 39
    assert cfg["hidden"] == [2048] * 7 and cfg["activation"] == "SIGMOID"
    assert cfg["n_targets"] == cfg["n_tied"] == 9304
    # every tied state is some triphone's: the DNN has 9,304 outputs
    assert len(lattice_ann.target_order(build_structure(cfg))) == 9304
    sizes = [k for k in cfg if isinstance(cfg[k], (int, float, list))
             and k not in ("reduced", "precision", "assumed")]
    cited = set(cfg["cited"])
    assumed = {a.split()[0] for a in cfg["assumed"]}
    assert set(sizes) <= cited | assumed | {"structure_seed"}, \
        set(sizes) - cited - assumed
    n_in = 11 * 39
    dims = [n_in, *cfg["hidden"], cfg["n_targets"]]
    weights = sum(a * b for a, b in zip(dims, dims[1:]))
    assert weights == 45_099_008 and sum(dims[1:]) == 23_640


def test_the_tiny_cell_agrees_with_the_reference():
    out = run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 4
    c = out["checks"]["ann_gap"]
    assert 0 < c["value"] <= c["limit"]


def test_a_traced_run_records_the_dnn():
    out = run(trace=True)
    assert out["correct"]
    s = metrics.summary()
    fw = s["htk.ann.forward"]
    assert "htk.ann.splice" in s
    c = fw["counts"]
    K = len(lattice_ann.target_order(build_structure(tiny(CELL).config)))
    assert c["frames"] > 0 and c["flops"] == 2 * c["frames"] * (
        429 * 64 + 2 * 64 * 64 + 64 * K)
    assert c["weight_bytes"] > 0 and c["act_bytes"] > 0
    m = out["metrics"]
    # nothing runs on a CUDA device here: no GEMM kernel to read
    assert "ann_roofline_pct" not in m
    assert m["mfu.decode"]["value"] > 0


def test_the_roofline_reader_on_a_made_up_trace(monkeypatch):
    flops, wb, ab = 1.34e12, 1.8e8, 2.0e9
    monkeypatch.setattr(metrics, "summary", lambda: {
        "htk.ann.forward": {"count": 1, "total_ns": 1, "self_ns": 1,
                            "counts": {"flops": flops, "weight_bytes": wb,
                                       "act_bytes": ab}}})
    tr = Trace(window_s=1.0, busy_s=0.5, kernel_s={
        "sm90_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize128x128": 0.03,
        "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_256x128>": 0.005,
        "void segmax_kernel<4>(...)": 0.2}, kernel_n={})
    read = spec.reader("ann_roofline_pct")
    # 1.34e12 operations at 67 TFLOP/s: 20 ms of bound over 35 ms
    assert read({"trace": tr}) == pytest.approx(100 * 0.02 / 0.035)
    assert read({"trace": None}) is None
    monkeypatch.setattr(metrics, "summary", lambda: {})
    assert read({"trace": tr}) is None


def _tf32(x):
    """x rounded to the nearest of TF32's 10 mantissa bits."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _faulty_forward(how):
    def forward(params, activations, x, return_logits=True):
        h = x
        for i, ((W, b), act) in enumerate(zip(params, activations)):
            if how == "layer_skipped" and i == 1:
                continue
            if how == "tf32":
                h = _tf32(h) @ _tf32(W).T + b
            else:
                h = h @ W.T + b
            if i == len(params) - 1 and return_logits:
                return h
            h = ann_mod._act(h, act)
        return h
    return forward


@pytest.mark.parametrize("how,number", [
    ("layer_skipped", "ann_gap"), ("tf32", "ann_gap"),
    ("splice_padded", "ann_gap")])
def test_a_faulty_dnn_is_not_correct(monkeypatch, how, number):
    if how == "splice_padded":
        monkeypatch.setattr(nnet, "splice", lambda x, c, lengths=None:
                            ann_mod.splice(x, c))
    else:
        monkeypatch.setattr(ann_mod, "forward", _faulty_forward(how))
    out = run()
    assert not out["correct"]
    c = out["checks"][number]
    assert c["value"] > c["limit"], out["checks"]


def test_the_cells_files_are_found():
    w = next(x for x in spec.benchmark()["workloads"] if x["name"] == CELL)
    assert spec.driver(spec.cell(CELL).workload["driver"]).Job
    assert os.path.exists(os.path.join(spec.ROOT, "hbench", "configs",
                                       w["config"] + ".json"))
    with open(os.path.join(spec.HBENCH, "workloads", CELL + ".json")) as f:
        assert json.load(f)["limits"]["ann_gap"] > 0
