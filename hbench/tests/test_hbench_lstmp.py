"""The LSTMP hybrid cell, wsj20k_lstmp3x832.hdecode, on the CPU: its
configuration holds the published widths, a tiny version of it (2 LSTMP
layers of 32 cells, a projection of 16, over the tiny cells' system)
agrees with the plain reference, a traced run records the recurrence's
spans, its readers work on a made-up trace, and planted faults come out
not correct: a recurrent weight perturbed in the program only, the delay
one frame off, the state reset between two halves of an utterance, and
the GEMMs' inputs rounded to TF32's 10 mantissa bits; `lstm_gap` sees
each. A 1-best moved off the best path counts in `paths_not_best`,
whose margin takes only a float32 near-tie."""

import time

import pytest
import torch

from hbench.core import spec
from hbench.core.trace import Trace
from hbench.drivers import lattice_ann, lattice_lstmp
from hbench.metrics._lstmp_bounds import cell_bound_ms
from hbench.run import run_cell
from hbench.traffic.synth import build_structure
from htk_tpu_torch.algo import nnet
from htk_tpu_torch.utils import metrics

from .test_hbench_cells import SEED, tiny

CELL = "wsj20k_lstmp3x832.hdecode"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(trace=False, seed=SEED):
    c = tiny(CELL)
    c.config = dict(c.config, lstm_layers=2, cells=32, projection=16)
    return run_cell(c, seed, 1.0, trace, CPU, t_process=time.perf_counter())


def test_the_configuration_holds_the_published_widths():
    c = spec.cell(CELL)
    cfg = c.config
    assert cfg["reduced"] == [] and c.chips == 1
    assert (cfg["lstm_layers"], cfg["cells"], cfg["projection"],
            cfg["out_delay"]) == (3, 832, 512, 5)
    assert cfg["peepholes"] is True and cfg["context"] == 0
    assert cfg["dim"] == 39 and cfg["n_targets"] == cfg["n_tied"] == 9304
    assert len(lattice_ann.target_order(build_structure(cfg))) == 9304
    sizes = [k for k in cfg if isinstance(cfg[k], (int, float, list))
             and k not in ("reduced", "precision", "assumed")]
    cited = set(cfg["cited"])
    assumed = {a.split()[0] for a in cfg["assumed"]}
    assert set(sizes) <= cited | assumed | {"structure_seed"}, \
        set(sizes) - cited - assumed
    n_c, n_r = 832, 512
    first = 4 * n_c * 39 + 4 * n_c * n_r + 3 * n_c + 4 * n_c + n_r * n_c
    rest = 2 * 4 * n_c * n_r + 3 * n_c + 4 * n_c + n_r * n_c
    out = 9304 * n_r + 9304
    assert (first, rest, out) == (2_265_536, 3_839_680, 4_772_952)
    # the sibling's traffic unchanged: only the `driver` key and the limits
    # (lstm_gap for ann_gap) differ, besides the name and the why
    sib = spec.cell("wsj20k_dnn7x2048.hdecode").workload
    own = c.workload
    assert own["driver"] == "lattice_lstmp" and own["limits"]["lstm_gap"] > 0
    other = ("name", "why", "driver", "limits")
    assert ({k: v for k, v in own.items() if k not in other}
            == {k: v for k, v in sib.items() if k not in other})
    lim = dict(own["limits"], ann_gap=sib["limits"]["ann_gap"])
    del lim["lstm_gap"]
    assert lim == sib["limits"]


def test_the_tiny_cell_agrees_with_the_reference():
    out = run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 4
    c = out["checks"]["lstm_gap"]
    assert 0 < c["value"] <= c["limit"]


def test_a_traced_run_records_the_recurrence():
    out = run(trace=True)
    assert out["correct"]
    s = metrics.summary()
    rc = s["htk.ann.recur"]["counts"]
    # on the CPU the plain cell steps: no kernel step
    assert rc["frame_steps"] > 0 and rc["kernel_steps"] == 0
    assert s["htk.ann.forward"]["counts"]["flops"] > 0
    m = out["metrics"]
    assert m["recur_step_us.lstmp"]["value"] > 0
    # nothing runs on a CUDA device here: no kernel to read
    assert "lstmp_roofline_pct" not in m
    assert "lstmp_cell_roofline_pct" not in m
    assert m["mfu.decode"]["value"] > 0


def test_the_readers_on_a_made_up_trace(monkeypatch):
    flops, wb, ab = 6.7e11, 6e7, 1e9
    monkeypatch.setattr(metrics, "summary", lambda: {
        "htk.ann.forward": {"count": 1, "total_ns": 1, "self_ns": 1,
                            "counts": {"flops": flops, "weight_bytes": wb,
                                       "act_bytes": ab}},
        "htk.ann.recur": {"count": 3, "total_ns": 60_000_000,
                          "self_ns": 60_000_000,
                          "counts": {"frame_steps": 3000,
                                     "kernel_steps": 3000}}})
    tr = Trace(window_s=1.0, busy_s=0.5, kernel_s={
        "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8": 0.05,
        "void gemv2T_kernel_val<int, int, float>(...)": 0.02,
        "void (anonymous namespace)::lstmp_cell_kernel(Args)": 0.01,
        "void segmax_kernel<4>(...)": 0.2}, kernel_n={
        "void (anonymous namespace)::lstmp_cell_kernel(Args)": 900})
    ctx = {"trace": tr, "launches": {"lstmp_cell": 1000},
           "bounds_ms": {"lstmp_cell": 1000 * cell_bound_ms(13, 832)}}
    # 6.7e11 operations at 67 TFLOP/s: 10 ms over 80 ms scaled by the
    # cell's 1,000 launches over its 900 records
    read = spec.reader("lstmp_roofline_pct")
    assert read(ctx) == pytest.approx(100 * 0.01 / (0.08 * 1000 / 900))
    cell = spec.reader("lstmp_cell_roofline_pct")(ctx)
    assert cell == pytest.approx(100 * cell_bound_ms(13, 832) * 1e-3 * 900
                                 / 0.01)
    assert spec.reader("recur_step_us.lstmp")(ctx) == pytest.approx(20.0)
    assert read({"trace": None}) is None
    monkeypatch.setattr(metrics, "summary", lambda: {})
    assert read(ctx) is None
    assert spec.reader("recur_step_us.lstmp")(ctx) is None


def _tf32(x):
    """x rounded to the nearest of TF32's 10 mantissa bits."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _faulty_layer(how):
    """algo/nnet._lstmp_layer with a planted fault."""
    real = nnet._lstmp_layer

    def layer(h, wx, wr, peep, b, wrm):
        if how == "recur_perturbed":
            wr = wr.clone()
            wr[0, 0] += 0.05
        if how == "tf32":
            h, wx, wr, wrm = (_tf32(x) for x in (h, wx, wr, wrm))
        if how != "state_reset":
            return real(h, wx, wr, peep, b, wrm)
        S = h.shape[0] // 2  # the second half starts from a zero state
        return torch.cat([real(h[:S], wx, wr, peep, b, wrm),
                          real(h[S:], wx, wr, peep, b, wrm)])
    return layer


@pytest.mark.parametrize("how", ["recur_perturbed", "delay_off",
                                 "state_reset", "tf32"])
def test_a_faulty_lstm_is_not_correct(monkeypatch, how):
    if how == "delay_off":
        init = lattice_lstmp.Job.__init__

        def shifted(self, *a, **kw):
            init(self, *a, **kw)
            self.ann.out_delay += 1
        monkeypatch.setattr(lattice_lstmp.Job, "__init__", shifted)
    else:
        monkeypatch.setattr(nnet, "_lstmp_layer", _faulty_layer(how))
    out = run()
    assert not out["correct"]
    c = out["checks"]["lstm_gap"]
    assert c["value"] > c["limit"], out["checks"]


def _moved(times, k):
    """The word times with the first word's end moved k frames (or -k
    where k would leave the second word no frame)."""
    (a, e), (a1, e1) = times[0], times[1]
    k = k if e + k < e1 else -k
    return [(a, e + k), (e + k + 1, e1)] + list(times[2:])


def test_a_path_off_the_best_is_counted(monkeypatch):
    """paths_not_best's margin takes a float32 near-tie, not a path that
    is off the best: a 1-best whose first word ends 2 frames away from
    where the decoder put it scores far below the reference's best, and
    the window's log names the widest gap against its limit."""
    call = lattice_lstmp.Job.call

    def moved(self, feats):
        return [r if r is None or len(r[0]) < 2 else
                (r[0], _moved(r[1], 2), r[2], r[3])
                for r in call(self, feats)]
    monkeypatch.setattr(lattice_lstmp.Job, "call", moved)
    out = run()
    c = out["checks"]["paths_not_best"]
    assert not out["correct"] and c["value"] > c["limit"] == 0
    log = [w for w in out["windows"] if w.startswith("check: widest path")]
    assert len(log) == 1
    gap, margin = float(log[0].split()[4]), float(log[0].split()[-1])
    assert gap > margin == out["checks"]["score_gap"]["limit"]
