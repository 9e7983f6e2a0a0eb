"""Each cell driven end to end on the CPU at a tiny size (the program's
plain torch versions in place of its kernels): the reference agrees with
the program, a traced run reads its per-layer metrics, and a run whose
timed path is broken underneath comes out not correct."""

import time

import pytest
import torch

from hbench.core import spec
from hbench.run import run_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11  # past 32 signed bits, as the driver's seeds are


def tiny(name):
    """The cell at a tiny size: widths and traffic cut, limits kept (the
    lattice cell's Gaussians closer together, so that its tiny lattices
    hold alternative predecessors)."""
    c = spec.cell(name)
    lat = c.workload["driver"] == "lattice"
    c.config = dict(c.config, n_words=300 if lat else 30,
                    n_phones=8, n_tied=20, n_mix=2)
    if lat:
        c.config["mean_scale"] = 1.0
    if c.config["grammar"] == "word_pair":
        c.config["fanout"] = 6
    c.workload = dict(c.workload, pool=12, frames=[60, 140], batch=4,
                      check_requests=5, check_block=4, keep_requests=6)
    return c


def run(name, trace=False, seed=SEED):
    return run_cell(tiny(name), seed, 1.0, trace, CPU,
                    t_process=time.perf_counter())


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_program_on_the_cpu(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 4
    for k, c in out["checks"].items():
        assert c["value"] <= c["limit"], (k, c)
    assert list(out)[-1] == "checks"
    want = {m["name"] for m in spec.cell(name).end_to_end}
    assert set(out["metrics"]) == want


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_its_per_layer_metrics(name):
    out = run(name, trace=True)
    assert out["correct"]
    m = out["metrics"]
    assert m["mfu.decode"]["value"] > 0
    # no device on the CPU: the roofline readers find nothing to read
    assert not any(k.endswith("roofline_pct") for k in m)
    assert out["device"]["window_s"] > 0
    assert out["breakdown"]["idle_gaps"]


def _broken(monkeypatch, name, how):
    mod = spec.driver(tiny(name).workload["driver"])
    call = mod.Job.call

    def broken(self, feats):
        out = call(self, feats)
        if how == "token":  # a word altered where it is produced
            ws, times, score, extra = out[0]
            ws = list(ws)
            ws[len(ws) // 2] = (ws[len(ws) // 2] + 1) % len(self.st.words)
            out[0] = (ws, times, score, extra)
        elif how == "half_missing":  # half of the bucket left out
            out[len(out) // 2:] = [None] * (len(out) - len(out) // 2)
        elif how == "half_repeated":  # the rest answered from the first half
            h = len(out) // 2
            out[h:] = (out[:h] * 2)[:len(out) - h]
        elif how in ("alternatives_dropped", "alternatives_underscored"):
            for r in out:  # the walk's alternative predecessors
                if r is not None and r[3] is not None:
                    _alternatives(r[3], how)
        return out

    monkeypatch.setattr(mod.Job, "call", broken)


def _alternatives(lat, how):
    """Drop every alternative arc of a lattice, or score each 1 lower. A
    record's first arc is its own predecessor's; the end node (no arc
    leaves it) takes one arc a final record."""
    leaves = {a.start for a in lat.arcs}
    end = next(n.id for n in lat.nodes if n.id not in leaves)
    seen, keep = set(), []
    for a in lat.arcs:
        if a.end in seen and a.end != end:
            if how == "alternatives_dropped":
                continue
            a.aclike -= 1.0
        seen.add(a.end)
        keep.append(a)
    lat.arcs[:] = keep



@pytest.mark.parametrize("how", ["token", "half_missing", "half_repeated"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, how):
    _broken(monkeypatch, name, how)
    assert not run(name)["correct"]


LATTICE_CELLS = [c for c in CELLS
                 if spec.cell(c).workload["driver"] == "lattice"]


@pytest.mark.parametrize("how,number", [
    ("alternatives_dropped", "alts_missing"),
    ("alternatives_underscored", "arc_gap")])
@pytest.mark.parametrize("name", LATTICE_CELLS)
def test_a_broken_lattice_walk_is_not_correct(monkeypatch, name, how,
                                              number):
    _broken(monkeypatch, name, how)
    out = run(name)
    assert not out["correct"]
    c = out["checks"][number]
    assert c["value"] > c["limit"], out["checks"]
