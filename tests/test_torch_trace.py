"""Spans and counters inside the port's two batched decoders
(htk_tpu_torch/utils/metrics.py; algo/decode.py's `decode_batch` on a
general word net, HVite's DECODEBATCH path, and `generate_lattice_batch`
on a factored uniform-row loop, HDecode's pass 1, also under a record
budget small enough that pass 2 gathers pruned predecessors back from
the device planes), at a tiny size.

With recording off a call records nothing, opens no profiler range and
synchronises nothing. Under a torch profiler or `recording()` each
call yields the span tree below, one `call_id` a call, `frame_steps`
summing to the padded frames and `d2h_bytes` 0 where nothing leaves a
CUDA device (on the card, the bytes of the arrays copied: the
`cuda`-marked case, run there with `--noconftest`, as this file imports
no JAX). Each span starts where kineto's host event of it starts (an
operator's range, which kineto does not copy onto a card's timeline),
the results are bit-identical with recording on and off, the recorder
holds the latest session only, `summary()` takes a child's time out of
its parent's self time, and HTKTPU: PROFILE writes the summary beside
the trace.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from htk_tpu_torch.algo import decode as dec
from htk_tpu_torch.algo.lvnet import compile_lv_loop
from htk_tpu_torch.algo.net import compile_network, word_internal_phone_map
from htk_tpu_torch.io.dictionary import read_dict
from htk_tpu_torch.io.htkfeat import read_htk_file
from htk_tpu_torch.io.mmf import load_mmf
from htk_tpu_torch.io.slf import read_slf
from htk_tpu_torch.models.hmmset import compile_hmmset
from htk_tpu_torch.synth import lv_system, write_system
from htk_tpu_torch.utils import metrics
from htk_tpu_torch.utils.config import Config

LM, PEN = 2.0, -3.0
KINDS = ["hvite", "hdecode", "hdecode_gathers"]
MODES = ["profiler", "recording"]
# each span's parent in one call
TREE = {
    "hvite": {
        "htk.decode.batch": None,
        "htk.decode.pad": "htk.decode.batch",
        "htk.decode.outp": "htk.decode.batch",
        "htk.decode.scan": "htk.decode.batch",
        "htk.decode.wait": "htk.decode.batch",
        "htk.decode.to_host": "htk.decode.batch",
        "htk.decode.finalize": "htk.decode.batch",
    },
    "hdecode": {
        "htk.lattice.batch": None,
        "htk.lattice.pad": "htk.lattice.batch",
        "htk.lv.outp": "htk.lattice.batch",
        "htk.lv.step": "htk.lattice.batch",
        "htk.lattice.compact": "htk.lattice.batch",
        "htk.lattice.wait": "htk.lattice.batch",
        "htk.lattice.to_host": "htk.lattice.batch",
        "htk.lattice.records": "htk.lattice.batch",
        "htk.lattice.resurrect": "htk.lattice.batch",
        "htk.lattice.walk": "htk.lattice.batch",
    },
}
TREE["hdecode_gathers"] = {**TREE["hdecode"],
                           "htk.lattice.gather": "htk.lattice.resurrect"}
COPIES = {"hvite": ["htk.decode.to_host"],
          "hdecode": ["htk.lattice.to_host"],
          "hdecode_gathers": ["htk.lattice.to_host", "htk.lattice.gather"]}
K_REC = {"hdecode": 16384, "hdecode_gathers": 40}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    metrics.RECORDER.clear()


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    """Both tiny systems: a general word net (6 words) with its
    utterances, and a factored 60-word LV loop with its own."""
    s = write_system(str(tmp_path_factory.mktemp("trace_sys")), n_words=6,
                     n_phones=8, n_tied=20, n_mix=2, n_utts=4,
                     min_frames=60, max_frames=150, fanout=3, seed=1,
                     binary_mmf=False)
    comp = compile_hmmset(load_mmf([s.hmmdefs]))
    net = compile_network(read_slf(s.wdnet), read_dict(s.dict), comp,
                          phone_map=word_internal_phone_map(comp.names))
    with open(s.scp) as f:
        feats = [read_htk_file(p).data for p in f.read().split()]
    lv = lv_system(60, n_tied=20, n_mix=2, n_phones=8, n_utts=3,
                   min_frames=60, max_frames=140, fanout=6)
    lvnet = compile_lv_loop(lv.words, lv.vocab, lv.comp, lm=lv.lm,
                            factored=True)
    lvs = (lvnet, lv.comp, lv.feats)
    return {"hvite": (net, comp, feats), "hdecode": lvs,
            "hdecode_gathers": lvs}


def call(systems, kind, device="cpu", stats=None):
    """One call of the kind's decoder on its system; what it returns, on
    the host."""
    net, comp, feats = systems[kind]
    if kind == "hvite":
        return dec.decode_batch(net, comp, feats, LM, PEN, device=device)
    return dec.generate_lattice_batch(
        net, comp, feats, 12.0, 0.0, lattice_beam=250.0, max_preds=8,
        want_results=True, stats=stats, k_rec=K_REC[kind], device=device)


def padded_T(systems, kind):
    return -(-max(f.shape[0] for f in systems[kind][2]) // 128) * 128


def recorded(mode):
    if mode == "profiler":
        return profile(activities=[ProfilerActivity.CPU])
    return metrics.recording()


def check_tree(recs, kind):
    """Every span of `recs` is one of the kind's, under its parent and
    inside its interval, and each of the kind's spans is there."""
    tree = TREE[kind]
    assert {r.name for r in recs} == set(tree)
    for r in recs:
        assert 0 < r.start_ns <= r.end_ns
        if tree[r.name] is None:
            assert r.parent == -1
            continue
        p = metrics.RECORDER.records[r.parent]
        assert p.name == tree[r.name] and p.call_id == r.call_id
        assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


@pytest.mark.parametrize("kind", KINDS)
def test_off_records_nothing_and_opens_no_range(systems, kind,
                                                monkeypatch):
    call(systems, kind)  # a call while off: the last session has lapsed
    before = list(metrics.RECORDER.records)

    def refuse(*a, **k):
        raise AssertionError("entered while recording is off")

    monkeypatch.setattr(metrics, "_range", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    call(systems, kind)
    assert metrics.RECORDER.records == before
    assert metrics.RECORDER.open == [] and metrics.RECORDER.lapsed


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_each_call_yields_its_span_tree(systems, kind, mode):
    with recorded(mode):
        call(systems, kind)
        call(systems, kind)
    recs = metrics.RECORDER.records
    assert metrics.RECORDER.open == [] and metrics.RECORDER.dropped == 0
    assert sorted({r.call_id for r in recs}) == [1, 2]
    for cid in (1, 2):
        check_tree([r for r in recs if r.call_id == cid], kind)
    s = metrics.summary()
    assert s[next(iter(TREE[kind]))]["count"] == 2
    for name in COPIES[kind]:
        assert s[name]["counts"] == {"d2h_bytes": 0}
    if kind != "hvite":
        T = padded_T(systems, kind)
        for cid in (1, 2):
            steps = [r.counts["frame_steps"] for r in recs
                     if r.call_id == cid and r.name == "htk.lv.step"]
            assert sum(steps) == T and len(steps) == T // steps[0]
        assert s["htk.lv.outp"]["count"] == s["htk.lv.step"]["count"]


@pytest.mark.parametrize("kind", KINDS)
def test_spans_start_with_their_kineto_events(systems, kind):
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        call(systems, kind)
    ours = {}
    for r in metrics.RECORDER.records:
        ours.setdefault(r.name, []).append(r.start_ns)
    theirs = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ours:
            # on the host only: nothing of a span is copied onto a card
            assert "cuda" not in str(e.device_type()).lower(), e.name()
            theirs.setdefault(e.name(), []).append(e.start_ns())
    assert set(theirs) == set(ours)
    for name, starts in ours.items():
        assert len(theirs[name]) == len(starts), name
        gap = np.abs(np.array(sorted(theirs[name])) - np.array(starts))
        assert gap.max() < 1_000_000, (name, gap.max())


def _same(kind, a, b):
    if kind == "hvite":
        return all(x.words == y.words and x.times == y.times
                   and x.score == y.score for x, y in zip(a, b))
    return all(la == lb and ra.words == rb.words and ra.times == rb.times
               and ra.score == rb.score
               for (la, ra), (lb, rb) in zip(a, b))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_results_are_identical_with_recording_on_and_off(systems, kind,
                                                         mode):
    st_off, st_on = {}, {}
    off = call(systems, kind, stats=st_off)
    with recorded(mode):
        on = call(systems, kind, stats=st_on)
    assert metrics.RECORDER.records
    assert len(on) == len(off) and all(r is not None for r in off)
    assert _same(kind, on, off)
    assert st_on == st_off


@pytest.mark.parametrize("second", MODES)
@pytest.mark.parametrize("first", MODES)
def test_the_recorder_holds_the_latest_session_only(systems, first,
                                                    second):
    with recorded(first):
        call(systems, "hvite")
        call(systems, "hvite")
    call(systems, "hvite")  # recording off in between
    with recorded(second):
        call(systems, "hvite")
    recs = metrics.RECORDER.records
    assert {r.call_id for r in recs} == {1}
    assert len(recs) == len(TREE["hvite"])


def test_back_to_back_recording_contexts_start_afresh(systems):
    with metrics.recording():
        call(systems, "hvite")
    with metrics.recording():
        call(systems, "hvite")
    assert {r.call_id for r in metrics.RECORDER.records} == {1}


def test_summary_self_time_leaves_out_the_children():
    with metrics.recording():
        with metrics.span("a", n=1):
            with metrics.span("b", n=2):
                metrics.add("n", 3)
                with metrics.span("c"):
                    pass
            with metrics.span("b"):
                metrics.add("n", 4)
            metrics.add("n", 5)
    metrics.add("n", 6)  # no open span: nothing
    recs = metrics.RECORDER.records
    dur = [r.end_ns - r.start_ns for r in recs]
    s = metrics.summary()
    assert [r.name for r in recs] == ["a", "b", "c", "b"]
    assert [r.parent for r in recs] == [-1, 0, 1, 0]
    assert s["a"]["self_ns"] == dur[0] - dur[1] - dur[3]
    assert s["b"]["self_ns"] == dur[1] - dur[2] + dur[3]
    assert s["b"]["total_ns"] == dur[1] + dur[3] and s["b"]["count"] == 2
    assert s["c"]["self_ns"] == s["c"]["total_ns"] == dur[2]
    assert s["a"]["counts"] == {"n": 6} and s["b"]["counts"] == {"n": 9}


def test_summary_of_a_call_sums_its_children(systems):
    with metrics.recording():
        call(systems, "hvite")
    recs = metrics.RECORDER.records
    top = recs[0]
    kids = sum(r.end_ns - r.start_ns for r in recs if r.parent == 0)
    s = metrics.summary()["htk.decode.batch"]
    assert s["total_ns"] == top.end_ns - top.start_ns
    assert s["self_ns"] == s["total_ns"] - kids >= 0


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(metrics.RECORDER, "cap", 2)
    with metrics.recording():
        with metrics.span("a"):
            with metrics.span("b"):
                with metrics.span("c"):
                    metrics.add("n", 1)  # on a dropped span: nothing
            with metrics.span("d"):
                pass
    assert [r.name for r in metrics.RECORDER.records] == ["a", "b"]
    assert metrics.RECORDER.dropped == 2 and metrics.RECORDER.open == []
    assert metrics.summary()["b"]["counts"] == {}


def test_hprofile_writes_the_summary_beside_the_trace(systems, tmp_path):
    cfg = Config()
    cfg.set("PROFILE", str(tmp_path), module="HTKTPU")
    with metrics.maybe_profile(cfg, "HVite"):
        call(systems, "hvite")
    assert (tmp_path / "HVite" / "trace.json").exists()
    with open(tmp_path / "HVite" / "summary.json") as f:
        got = json.load(f)
    assert got["dropped"] == 0
    assert set(got["spans"]) == set(TREE["hvite"])
    assert got["spans"]["htk.decode.batch"]["count"] == 1
    assert got["spans"] == json.loads(json.dumps(metrics.summary()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_copies_off_the_card_count_their_bytes(systems, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: d2h_bytes counts copies off it")
    net, comp, feats = systems[kind]
    st = {}
    with metrics.recording():
        call(systems, kind, device="cuda", stats=st)
    s = metrics.summary()
    B, T = len(feats), padded_T(systems, kind)
    if kind == "hvite":
        outp = dec._net_outp(net, comp, np.zeros((B, T, feats[0].shape[1]),
                                                 np.float32), "highest",
                             "cuda")
        carry, planes = dec.run_decode_batch(outp, net, LM, PEN)
        want = sum(t.numel() * t.element_size() for t in carry + planes)
        assert s["htk.decode.to_host"]["counts"]["d2h_bytes"] == want
        return
    C = net.n_nodes
    K = min(dec.LAT_TOPK, C)
    M = min(T * K, K_REC[kind])
    want = B * (K + M) * 4 + B * (3 * K + 4 * M + 1) * 8
    assert s["htk.lattice.to_host"]["counts"]["d2h_bytes"] == want
    g = s.get("htk.lattice.gather", {"count": 0, "counts": {"d2h_bytes": 0}})
    got = g["counts"]["d2h_bytes"]  # three float64 of each record gathered
    assert g["count"] == st["gathers"] and (got > 0) == (st["gathers"] > 0)
    assert got % 24 == 0 and got >= 24 * st["resurrected"]
