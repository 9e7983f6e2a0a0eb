"""The port's lattices on uniform-row (LV) nets against htk_tpu's, on the
CPU: `generate_lattice_batch` through the device compaction
(`_lv_lattice_pipeline`) and the sequential `generate_lattice`.

Nets, after tests/test_lvdecode.py:114-260 and
tests/test_trigram_guide.py:
  - dense: the 3-word loop of test_lvdecode.py, and `compile_lv_loop` on a
    small `synth.write_system` (its dict and lm.arpa);
  - factored: `synth.lv_system(300)` compiled factored, decoded exact,
    top-A and adaptive-exact;
  - trigram-guided: `lv_system(300, lm_order=3)` with `trigram=True`.

Each holds: SLF within `assert_slf_close` of htk_tpu's; the batch equal to
the port's sequential generator byte for byte; the `want_results` 1-best
equal to htk_tpu's and to the port's `decode_batch`; a k_rec overflow
warns 8523 and keeps the records htk_tpu keeps; the k_lat cap; tight
lattice beams. On these systems every kept record's predecessor is in
the beam and no entry time has an alternative predecessor in reach, so
the resurrection of pruned predecessors (forced by a record budget) and
`max_preds=8` alternative arcs are held on the lexicon nets below. The
10-word lexicons of tests/test_torch_lvdecode.py (factored and trigram)
share phones between
words, so their word ends tie in real arithmetic, and the two packages'
OutP roundings break those ties either way: there both packages score
the same observation likelihoods (htk_tpu's OutP stands in for the
port's scorer) and the SLF must be byte-identical. Every ranking of the
pipeline takes the higher value first and the lower index among equal
values, as jax.lax.top_k does; the tie test shows it on rows that tie
on every frame.
"""

import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from htk_tpu.algo import decode as jdec
from htk_tpu.algo.lvnet import compile_lv_loop as j_compile
from htk_tpu.io.dictionary import Vocab as JVocab
from htk_tpu.io.lm import NGramLM as JNGramLM
from htk_tpu.io import slf as jslf
from htk_tpu.models.hmmset import CompiledHMMSet as JCompiledHMMSet
from htk_tpu.ops.outp import all_state_outp as j_all_state_outp
from htk_tpu_torch import convert
from htk_tpu_torch.algo import decode as pdec
from htk_tpu_torch.algo.lvnet import compile_lv_loop as p_compile
from htk_tpu_torch.io.slf import write_slf
from htk_tpu_torch.synth import lv_system

from _torch_compare import assert_slf_close, one_torch_thread  # noqa: F401
from test_decode import emit_frames
from test_torch_lvdecode import BIG, SMALL, TIED, TRI, nets

LM, PEN = 2.0, -1.0
SEQS = [["sil", "aa", "iy", "aa", "sil"], ["sil", "iy", "sil"],
        ["aa", "iy", "aa", "iy"]]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def _slf(lat):
    with tempfile.TemporaryDirectory() as t:
        p = os.path.join(t, "x.lat")
        (jslf.write_slf if isinstance(lat, jslf.Lattice) else write_slf)(
            lat, p)
        with open(p) as f:
            return f.read()


def _jax_twin(s, **kw):
    """htk_tpu's objects for a port `LVSystem`, and both nets."""
    jc = convert._carry(JCompiledHMMSet, s.comp)
    jv = JVocab()
    for w in s.words:
        jv.add_pron(w, s.vocab.get(w).prons[0].phones)
    jl = JNGramLM(order=s.lm.order)
    for k in ("unigrams", "bigrams", "trigrams", "tri_bo"):
        getattr(jl, k).update(getattr(s.lm, k))
    pn = p_compile(s.words, s.vocab, s.comp, lm=s.lm, factored=True, **kw)
    jn = j_compile(s.words, jv, jc, lm=jl, factored=True, **kw)
    return jc, jn, s.comp, pn


def _write_system_net(root):
    from htk_tpu.algo.net import word_internal_phone_map as j_pmap
    from htk_tpu.io.dictionary import read_dict as j_read_dict
    from htk_tpu.io.lm import read_arpa as j_read_arpa
    from htk_tpu.io.mmf import load_mmf as j_load_mmf
    from htk_tpu.models.hmmset import compile_hmmset as j_compile_set
    from htk_tpu_torch.algo.net import word_internal_phone_map
    from htk_tpu_torch.io.dictionary import read_dict
    from htk_tpu_torch.io.htkfeat import read_htk_file
    from htk_tpu_torch.io.lm import read_arpa
    from htk_tpu_torch.io.mmf import load_mmf
    from htk_tpu_torch.models.hmmset import compile_hmmset
    from htk_tpu_torch.synth import write_system

    s = write_system(root, n_words=20, n_phones=8, n_tied=400, n_mix=2,
                     n_utts=3, min_frames=60, max_frames=150, fanout=4,
                     seed=2)
    jc = j_compile_set(j_load_mmf([s.hmmdefs]))
    pc = compile_hmmset(load_mmf([s.hmmdefs]))
    words = [f"w{i}" for i in range(20)]
    jn = j_compile(words, j_read_dict(s.dict), jc, lm=j_read_arpa(s.lm),
                   phone_map=j_pmap(jc.names))
    pn = p_compile(words, read_dict(s.dict), pc, lm=read_arpa(s.lm),
                   phone_map=word_internal_phone_map(pc.names))
    return (jc, jn, pc, pn), [read_htk_file(p).data for p in s.feats]


LV = dict(n_tied=2000, n_mix=2, n_utts=3, min_frames=60, max_frames=120)


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    """name -> ((jax comp, jax net, port comp, port net), feats,
    max_active, decode scales)."""
    small = nets(SMALL)
    feats = [emit_frames(s, seed=i + 1) for i, s in enumerate(SEQS)]
    dense_sys, dense_feats = _write_system_net(
        str(tmp_path_factory.mktemp("lvlat_dense")))
    fac = lv_system(300, seed=3, **LV)
    tri = lv_system(300, lm_order=3, seed=4, **LV)
    fac_nets = _jax_twin(fac)
    return {
        "dense": (small, feats, None, (LM, PEN)),
        "dense_system": (dense_sys, dense_feats, None, (8.0, -10.0)),
        "factored": (fac_nets, fac.feats, None, (12.0, 0.0)),
        "factored_topa": (fac_nets, fac.feats, 32, (12.0, 0.0)),
        "factored_adaptive": (fac_nets, fac.feats, -32, (12.0, 0.0)),
        "trigram": (_jax_twin(tri, trigram=True), tri.feats, 64,
                    (12.0, 0.0)),
    }


CASES = ["dense", "dense_system", "factored", "factored_topa",
         "factored_adaptive", "trigram"]


def _both(case, **kw):
    (jc, jn, pc, pn), feats, ma, (lm, pen) = case
    kw.setdefault("lattice_beam", 150.0)
    got = pdec.generate_lattice_batch(pn, pc, feats, lm, pen, pad_to=16,
                                      max_active=ma, want_results=True,
                                      device="cpu", **kw)
    ref = jdec.generate_lattice_batch(jn, jc, feats, lm, pen, pad_to=16,
                                      max_active=ma, want_results=True, **kw)
    return got, ref


def _same_results(rp, rj, rel=1e-5):
    assert rp is not None and rj is not None
    assert rp.words == list(rj.words) and rp.times == list(rj.times)
    assert rp.score == pytest.approx(rj.score, rel=rel)


@pytest.mark.parametrize("name", CASES)
def test_batch_equals_reference(systems, name):
    got, ref = _both(systems[name])
    for (lt, r), (jl, jr) in zip(got, ref):
        assert len(lt.arcs) > 10
        assert_slf_close(_slf(lt), _slf(jl))
        _same_results(r, jr)


@pytest.mark.parametrize("name", CASES)
def test_batch_equals_sequential_and_decode_batch(systems, name):
    (jc, jn, pc, pn), feats, ma, (lm, pen) = systems[name]
    got = pdec.generate_lattice_batch(pn, pc, feats, lm, pen, 150.0,
                                      pad_to=16, max_active=ma,
                                      want_results=True, device="cpu")
    best = pdec.decode_batch(pn, pc, feats, lm, pen, pad_to=16,
                             max_active=ma, device="cpu")
    for f, (lt, r), rb in zip(feats, got, best):
        sl, sr = pdec.generate_lattice(pn, pc, f, lm, pen, 150.0,
                                       max_active=ma, want_result=True,
                                       device="cpu")
        assert _slf(lt) == _slf(sl)
        assert (r.words, r.times) == (sr.words, sr.times)
        assert (r.words, r.times) == (rb.words, rb.times)
        assert r.score == pytest.approx(rb.score, rel=1e-6)
    plain = pdec.generate_lattice_batch(pn, pc, feats, lm, pen, 150.0,
                                        pad_to=16, max_active=ma,
                                        device="cpu")
    assert [_slf(x) for x in plain] == [_slf(x) for x, _ in got]


@pytest.fixture
def reference_outp(monkeypatch):
    """The port decodes htk_tpu's observation log-likelihoods: its scorer
    is swapped for htk_tpu's `all_state_outp` of the same set."""
    def use(jc):
        def scorer_for(comp, device, precision="highest"):
            def score(x):
                xs = np.asarray(x.cpu(), np.float32)
                lb, _ = j_all_state_outp(
                    xs.reshape(-1, xs.shape[-1]), jc.means, jc.variances,
                    jc.gconsts, jc.state_mix, jc.state_logw,
                    precision=precision,
                    slot_blocks=tuple(jc.slot_blocks) or None,
                    state_sw=jc.state_sw)
                return torch.as_tensor(
                    np.array(lb).reshape(*xs.shape[:-1], -1),
                    device=x.device)
            return score
        monkeypatch.setattr(pdec, "scorer_for", scorer_for)
    return use


LEX = {"dense": (SMALL, {}), "factored": (BIG, {"factored": True}),
       "trigram": (BIG, {"tri": TRI, "trigram": True}), "tied": (TIED, {})}


def _lex_case(reference_outp, lex):
    words, kw = LEX[lex]
    jc, jn, pc, pn = nets(words, **kw)
    reference_outp(jc)
    feats = [emit_frames(s, seed=i + 1) for i, s in enumerate(SEQS)]
    return (jc, jn, pc, pn), feats, None, (LM, PEN)


@pytest.mark.parametrize("lex", ["dense", "factored", "trigram", "tied"])
@pytest.mark.parametrize("extra", [{}, {"max_preds": 8}, {"k_lat": 2},
                                   {"lattice_beam": 5.0}])
def test_lexicon_nets_equal_reference_exactly(reference_outp, lex, extra):
    got, ref = _both(_lex_case(reference_outp, lex), **extra)
    for (lt, r), (jl, jr) in zip(got, ref):
        assert _slf(lt) == _slf(jl)
        _same_results(r, jr)


@pytest.mark.parametrize("lex", ["dense", "factored", "trigram"])
def test_k_rec_overflow_warns_8523_and_keeps_the_reference_records(
        reference_outp, capsys, lex):
    case = _lex_case(reference_outp, lex)
    full, _ = _both(case, lattice_beam=400.0)
    stats = {}
    (jc, jn, pc, pn), feats, _ma, (lm, pen) = case
    got = pdec.generate_lattice_batch(pn, pc, feats, lm, pen, 400.0,
                                      pad_to=16, k_rec=20, stats=stats,
                                      device="cpu")
    assert "WARNING [-8523]" in capsys.readouterr().err
    assert stats["overflow"] == len(feats)
    assert stats["in_beam"] > len(feats) * 20
    ref = jdec.generate_lattice_batch(jn, jc, feats, lm, pen, 400.0,
                                      pad_to=16, k_rec=20)
    for lt, jl, (lf, _r) in zip(got, ref, full):
        assert _slf(lt) == _slf(jl)
        assert len(lt.arcs) < len(lf.arcs)


@pytest.mark.parametrize("name", ["dense", "factored", "trigram"])
def test_k_lat_cap_equals_reference(systems, name):
    got, ref = _both(systems[name], k_lat=2)
    for (lt, r), (jl, jr) in zip(got, ref):
        assert_slf_close(_slf(lt), _slf(jl))
        _same_results(r, jr)


@pytest.mark.parametrize("name", ["dense", "factored", "trigram"])
@pytest.mark.parametrize("beam", [5.0, 30.0])
def test_tight_beam_equals_reference_and_sequential(systems, name, beam):
    (jc, jn, pc, pn), feats, ma, (lm, pen) = systems[name]
    got = pdec.generate_lattice_batch(pn, pc, feats, lm, pen, beam,
                                      pad_to=16, max_active=ma,
                                      device="cpu")
    ref = jdec.generate_lattice_batch(jn, jc, feats, lm, pen, beam,
                                      pad_to=16, max_active=ma)
    for f, lt, jl in zip(feats, got, ref):
        assert_slf_close(_slf(lt), _slf(jl))
        assert _slf(lt) == _slf(pdec.generate_lattice(
            pn, pc, f, lm, pen, beam, max_active=ma, device="cpu"))


@pytest.mark.parametrize("lex", ["dense", "factored", "trigram"])
def test_pruned_predecessors_resurrect_as_reference(reference_outp, lex):
    """A record budget below the in-beam count drops predecessors of
    kept records; they come back from the planes left on the device, one
    gather per wave for the whole batch, as in htk_tpu."""
    (jc, jn, pc, pn), feats, _ma, (lm, pen) = _lex_case(reference_outp,
                                                        lex)
    stats = {}
    kw = dict(lattice_beam=400.0, pad_to=16, k_rec=30)
    got = pdec.generate_lattice_batch(pn, pc, feats, lm, pen, stats=stats,
                                      want_results=True, device="cpu", **kw)
    assert stats["gathers"] >= 1 and stats["resurrected"] >= 1
    ref = jdec.generate_lattice_batch(jn, jc, feats, lm, pen,
                                      want_results=True, **kw)
    for (lt, r), (jl, jr) in zip(got, ref):
        assert _slf(lt) == _slf(jl)
        _same_results(r, jr)


@pytest.mark.parametrize("lex", ["dense", "factored", "trigram"])
def test_max_preds_adds_alternative_arcs(reference_outp, lex):
    case = _lex_case(reference_outp, lex)
    got, ref = _both(case, max_preds=8)
    one, _ = _both(case)
    for (lt, r), (jl, jr), (l1, _r1) in zip(got, ref, one):
        assert _slf(lt) == _slf(jl)
        assert len(lt.arcs) > len(l1.arcs)
        assert len(lt.nodes) == len(l1.nodes)


def test_ranked_breaks_ties_as_top_k():
    rng = np.random.default_rng(5)
    key = rng.integers(0, 4, (3, 7, 40)).astype(np.float32)
    for k in (1, 5, 40):
        v, i = pdec._ranked(torch.as_tensor(key), k)
        jv, ji = jax.lax.top_k(key, k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_tied_rows_keep_the_lower_rows(reference_outp):
    """A1-A3 (and I1-I2) tie on every frame: under a per-frame cap of 2
    records the kept word ends are the lower rows, A1 and A2, as in
    htk_tpu; A3 never makes a lattice node."""
    case = _lex_case(reference_outp, "tied")
    (jc, jn, pc, pn), feats, _ma, (lm, pen) = case
    kw = dict(lattice_beam=400.0, pad_to=16, k_lat=2)
    got = pdec.generate_lattice_batch(pn, pc, feats, lm, pen, device="cpu",
                                      **kw)
    ref = jdec.generate_lattice_batch(jn, jc, feats, lm, pen, **kw)
    words = set()
    for lt, jl in zip(got, ref):
        assert _slf(lt) == _slf(jl)
        words |= {n.word for n in lt.nodes}
    assert "A3" not in words and {"A1", "A2", "I1", "I2"} <= words


def test_the_walk_span_counts_records_arcs_and_alternatives(
        reference_outp):
    """Under `recording()` the `htk.lattice.walk` span of one call counts
    the records walked (each lattice's nodes but its two !NULL ends), the
    arcs emitted, and the alternative-predecessor arcs among them (the
    arcs beyond a LATPREDS 1 call on the same input)."""
    from htk_tpu_torch.utils import metrics

    (jc, jn, pc, pn), feats, _ma, (lm, pen) = _lex_case(reference_outp,
                                                        "factored")
    kw = dict(lattice_beam=150.0, pad_to=16, device="cpu")
    with metrics.recording():
        got = pdec.generate_lattice_batch(pn, pc, feats, lm, pen,
                                          max_preds=8, **kw)
        walk, = [s for s in metrics.RECORDER.records
                 if s.name == "htk.lattice.walk"]
    one = pdec.generate_lattice_batch(pn, pc, feats, lm, pen, **kw)
    arcs = sum(len(lt.arcs) for lt in got)
    assert walk.counts == {
        "records": sum(len(lt.nodes) - 2 for lt in got), "arcs": arcs,
        "alt_arcs": arcs - sum(len(lt.arcs) for lt in one)}
    assert walk.counts["alt_arcs"] > 0
