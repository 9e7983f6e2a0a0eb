"""The port's uniform-row LV decoder (htk_tpu_torch: io/lm, algo/lvnet,
algo/decode's uniform path) against htk_tpu's, on the CPU.

The same inputs go through both packages:

  - ARPA files read by both `read_arpa`s give equal dicts;
  - `compile_lv_loop` on the same vocabulary, HMM set and LM gives equal
    network arrays, dense and factored (the xw tables too);
  - the uniform step (`decode_scan_uniform_batch`) on the same numpy outp
    gives planes v/WE within atol 1e-5 on live entries (the same live
    sets) and the records wn/wt/pwn/pwt exactly equal: the dense exact
    leg, top-A with A < C on tied word ends, and a beam that binds; on
    factored nets the exact leg, top-A on tied word ends, adaptive-exact
    top-A and a binding beam; on trigram-guided nets with and without
    top-A, and without successor tables (the bucket branch);
  - `decode`/`decode_batch` end to end over tests/test_lvdecode.py's
    fixtures, tests/test_trigram_guide.py's and a small synthetic system
    (synth.write_system, with its lm.arpa) give equal words and times and
    scores within rel 1e-5 (the two packages' OutP matmuls round
    differently), dense, factored and trigram-guided; adaptive-exact
    scores equal the port's own exact decode (==), and its factored
    decode equals its dense one;
  - an utterance over the packed record's 32,767 frames is chunked the
    same way.
"""

import os

import numpy as np
import pytest
import torch

from htk_tpu.algo import decode as jdec
from htk_tpu.algo.lvnet import compile_lv_loop as j_compile
from htk_tpu.io.dictionary import Vocab as JVocab
from htk_tpu.io.lm import read_arpa as j_read_arpa
from htk_tpu.io.lm import write_arpa as j_write_arpa
from htk_tpu_torch import convert
from htk_tpu_torch.algo import decode as pdec
from htk_tpu_torch.algo.lvnet import compile_lv_loop as p_compile
from htk_tpu_torch.io.dictionary import Vocab as PVocab
from htk_tpu_torch.io.lm import read_arpa as p_read_arpa
from htk_tpu_torch.utils.errors import HTKError
from htk_tpu_torch.utils.logmath import LZERO

from test_decode import emit_frames, separable_set
from test_lvdecode import make_lm
from test_trigram_guide import make_trilm

NET_ARRAYS = ("comp_state", "band", "a0", "aE", "chain_of", "node_of_chain",
              "chain_pron_prob", "trans", "start_entry", "end_exit")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The port's entry points run on the card unless the CPU is asked
    for."""
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def vocabs(lex, silent=()):
    """The same dictionary in both packages: word -> phone list."""
    out = []
    for cls in (JVocab, PVocab):
        v = cls()
        for w, ph in lex.items():
            v.add_pron(w, ph, out_sym="" if w in silent else None)
        out.append(v)
    return out


SMALL = {"A": ["aa"], "I": ["iy"], "S": ["sil"]}
# ten multi-phone words (tests/test_lvdecode.py's factored fixture)
BIG = {"W0": ["aa"], "W1": ["iy"], "W2": ["sil"], "W3": ["aa", "iy"],
       "W4": ["iy", "aa"], "W5": ["aa", "sil"], "W6": ["sil", "iy"],
       "W7": ["aa", "iy", "aa"], "W8": ["iy", "sil", "iy"],
       "W9": ["sil", "aa", "sil"]}
# repeated pronunciations: rows A1-A3 (and I1-I2) tie on every frame
TIED = {"A1": ["aa"], "A2": ["aa"], "A3": ["aa"], "I1": ["iy"],
        "I2": ["iy"], "S": ["sil"]}


def nets(lex, lm=True, silent=(), tri=None, bows=None, **kw):
    """(jax comp, jax net, port comp, port net) for a lexicon; `tri`
    (explicit trigrams) and `bows` (bigram back-off weights) promote the
    LM to order 3 (tests/test_trigram_guide.py's make_trilm)."""
    jc = separable_set()
    pc = convert.compiled_hmmset_from(jc)
    jv, pv = vocabs(lex, silent)
    words = list(lex)
    jlm = make_lm(tuple(words)) if lm else None
    if tri is not None:
        jlm = make_trilm(tuple(words), tri=tri, bows=bows)
    jn = j_compile(words, jv, jc, lm=jlm, **kw)
    pn = p_compile(words, pv, pc, lm=convert.ngram_lm_from(jlm)
                   if lm else None, **kw)
    return jc, jn, pc, pn


def assert_results(rp, rj):
    assert (rp is None) == (rj is None)
    if rj is None:
        return
    assert rp.words == list(rj.words)
    assert rp.times == list(rj.times)
    assert rp.score == pytest.approx(rj.score, rel=1e-5)


def assert_planes(got, ref, atol=1e-5):
    (v, wn, wt), (WE, pwn, pwt) = got
    (vr, wnr, wtr), (WEr, pwnr, pwtr) = [[np.asarray(x) for x in g]
                                         for g in ref]
    for a, b in ((v, vr), (WE, WEr)):
        a = a.numpy()
        live = b > LZERO / 2
        assert np.array_equal(live, a > LZERO / 2)
        np.testing.assert_allclose(a[live], b[live], atol=atol, rtol=0)
    for a, b in ((wn, wnr), (wt, wtr), (pwn, pwnr), (pwt, pwtr)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b)


# -- io/lm -----------------------------------------------------------------

def test_read_arpa_equal_dicts(tmp_path):
    lm = make_lm(tuple(BIG))
    lm.order = 3
    lm.trigrams[("W1", "W2", "W3")] = -1.5
    lm.tri_bo[("W1", "W2", "W3")] = -0.25
    path = str(tmp_path / "lm.arpa")
    j_write_arpa(lm, path)
    jl, pl = j_read_arpa(path), p_read_arpa(path)
    assert pl.order == jl.order == 3
    for k in ("unigrams", "bigrams", "trigrams", "tri_bo"):
        got, ref = getattr(pl, k), dict(getattr(jl, k))
        assert got.keys() == ref.keys()
        for key in ref:
            assert np.allclose(got[key], ref[key], rtol=1e-12, atol=0)
    for f in ("bigram_arrays", "bigram_bow_arrays", "trigram_arrays"):
        for a, b in zip(getattr(pl, f)(list(BIG)), getattr(jl, f)(list(BIG))):
            np.testing.assert_allclose(a, b, rtol=1e-12)


def test_convert_ngram_lm_from():
    lm = make_lm(tuple(BIG))
    got = convert.ngram_lm_from(lm)
    assert got.order == lm.order and got.unigrams == lm.unigrams
    assert got.bigrams == lm.bigrams and got.bigrams is not lm.bigrams
    assert got.logp_bi("W1", "W2") == lm.logp_bi("W1", "W2")


# -- algo/lvnet ------------------------------------------------------------

@pytest.mark.parametrize("factored", [False, True])
def test_compile_lv_loop_equal_arrays(factored):
    _jc, jn, _pc, pn = nets(BIG, factored=factored)
    for k in NET_ARRAYS:
        np.testing.assert_array_equal(getattr(pn, k), getattr(jn, k), k)
    assert pn.uniform_width == jn.uniform_width
    assert pn.node_words == jn.node_words and pn.node_out == jn.node_out
    if not factored:
        assert pn.xw_backoff is None is jn.xw_backoff
        return
    xp, xj = pn.xw_backoff, jn.xw_backoff
    for k in ("bow", "uni", "inv", "succ_j", "succ_p", "marg"):
        np.testing.assert_array_equal(xp[k], xj[k], k)
    assert len(xp["buckets"]) == len(xj["buckets"])
    for (p1, s1), (p2, s2) in zip(xp["buckets"], xj["buckets"]):
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(s1, s2)
    for a, b in zip(xp["slots"], xj["slots"]):
        np.testing.assert_array_equal(a, b)


def test_convert_carries_uniform_networks():
    """decode_network_from on uniform nets, dense and factored: the
    port's own compilation of the same inputs, uniform_width and the xw
    tables included."""
    for factored in (False, True):
        _jc, jn, _pc, pn = nets(BIG, factored=factored)
        cn = convert.decode_network_from(jn)
        assert cn.uniform_width == pn.uniform_width
        for k in NET_ARRAYS:
            np.testing.assert_array_equal(getattr(cn, k), getattr(pn, k))
        if factored:
            np.testing.assert_array_equal(cn.xw_backoff["succ_j"],
                                          pn.xw_backoff["succ_j"])
            assert cn.xw_backoff["succ_j"] is not jn.xw_backoff["succ_j"]


def test_convert_carries_trigram_tables():
    """decode_network_from carries xw_backoff and xw_trigram whole,
    o3max and iters included, equal to the port's own compilation."""
    _jc, jn, _pc, pn = nets(BIG, tri=TRI, trigram=True)
    cn = convert.decode_network_from(jn)
    x3, p3 = cn.xw_trigram, pn.xw_trigram
    assert x3 is not None and x3.keys() == p3.keys()
    for k, v in p3.items():
        np.testing.assert_array_equal(x3[k], v, k)
    assert (x3["o3max"], x3["iters"]) == (jn.xw_trigram["o3max"],
                                          jn.xw_trigram["iters"])
    assert x3["tri_j"] is not jn.xw_trigram["tri_j"]
    for a, b in zip(cn.xw_backoff["slots"], pn.xw_backoff["slots"]):
        np.testing.assert_array_equal(a, b)


# -- the uniform step --------------------------------------------------------

def scan_both(jn, pn, outp, lm_scale=2.0, word_pen=-1.5, beam=1e30,
              max_active=None):
    """The step of both packages on the same outp, with the net's
    factored and trigram tables (if any) LM-scaled as decode scales
    them."""
    jd = jdec._net_dev(jn)
    ref = jdec.decode_scan_uniform_batch(
        outp, jd["band"], jd["a0"], jd["aE"], jn.uniform_width, jd["bonus"],
        jd["trans"] * lm_scale, jd["start"] * lm_scale, word_pen, beam,
        max_active, xw=jdec._scale_xw(jd.get("xw"), lm_scale),
        xw3=jdec._scale_xw3(jd.get("xw3"), lm_scale))
    pd = pdec._net_dev(pn, "cpu")
    got = pdec.decode_scan_uniform_batch(
        torch.as_tensor(outp), pd["band"], pd["a0"], pd["aE"],
        pn.uniform_width, pd["bonus"], pd["trans"] * lm_scale,
        pd["start"] * lm_scale, word_pen, beam, max_active,
        pdec._scale_xw(pd.get("xw"), lm_scale),
        pdec._scale_xw3(pd.get("xw3"), lm_scale))
    return got, ref


def net_outp(net, rng, B, T, integer=False):
    """Random observation scores per physical state, gathered to the
    network's states as the decoder does (rows with one pronunciation
    get the same scores)."""
    n_phys = int(net.comp_state.max()) + 1
    if integer:
        phys = -rng.integers(0, 3, (B, T, n_phys))
    else:
        phys = rng.normal(size=(B, T, n_phys)) * 2 - 4
    return phys[:, :, net.comp_state].astype(np.float32)


@pytest.mark.parametrize("case", ["dense", "topa_ties", "beam",
                                  "topa_beam", "integer_outp"])
def test_uniform_step_equals_reference(case):
    lex = TIED if case.startswith("topa") else BIG
    _jc, jn, _pc, pn = nets(lex, factored=False)
    B, T = 3, 40
    outp = net_outp(pn, np.random.default_rng(7), B, T,
                    integer=case == "integer_outp")
    kw = {"dense": {}, "integer_outp": {},
          "topa_ties": {"max_active": 2},
          "beam": {"beam": 3.0},
          "topa_beam": {"max_active": 4, "beam": 6.0}}[case]
    got, ref = scan_both(jn, pn, outp, **kw)
    assert got[1][0].shape == (B, T, pn.n_nodes)
    assert_planes(got, ref)
    if "beam" in case:  # the beam binds: more states die than without it
        unpruned = scan_both(jn, pn, outp, max_active=kw.get("max_active"))
        assert int((got[0][0] <= LZERO / 2).sum()) > int(
            (unpruned[0][0][0] <= LZERO / 2).sum())


def test_topa_ties_take_the_lower_row_first():
    """Rows A1-A3 share a pronunciation and an LM row, so their word ends
    tie on every frame. With A = 2, A1 and A2 propagate (jax.lax.top_k's
    order, lower index first), and every entry record of an A word names
    A1, the first maximum among the kept rows, never A2 or A3."""
    _jc, jn, _pc, pn = nets(TIED, factored=False)
    outp = net_outp(pn, np.random.default_rng(3), 2, 30)
    got, ref = scan_both(jn, pn, outp, max_active=2)
    assert_planes(got, ref)
    WE, pwn = got[1][0], got[1][1]
    live = WE[:, :, 0] > LZERO / 2
    assert bool(live.any())
    assert torch.equal(WE[:, :, 0][live], WE[:, :, 2][live])
    named = set(pwn[pwn >= 0].tolist())
    assert 0 in named and not named & {1, 2}


# explicit trigrams over BIG's words (tests/test_trigram_guide.py's shape)
TRI = {("W3", "W4", "W3"): np.log(0.9), ("W7", "W4", "W0"): np.log(0.7),
       ("!ENTER", "W1", "W2"): np.log(0.8)}


@pytest.mark.parametrize("case", ["exact", "topa_ties", "adaptive",
                                  "adaptive_wide", "adaptive_ties", "beam",
                                  "xw3", "xw3_topa", "xw3_buckets"])
def test_factored_step_equals_reference(case):
    """The factored legs: exact (segmax over the buckets), top-A on tied
    word ends (scatter-max), adaptive-exact top-A (both legs every frame,
    selected on the batch-wide certificate), a binding beam, and trigram
    guidance with and without top-A and without successor tables."""
    lex = TIED if "ties" in case else BIG
    kw = {"tri": TRI, "trigram": True} if case.startswith("xw3") else {}
    _jc, jn, _pc, pn = nets(lex, factored=True, **kw)
    if case == "xw3_buckets":  # the step's bucket branch under guidance
        jn.xw_backoff["succ_j"] = pn.xw_backoff["succ_j"] = None
    outp = net_outp(pn, np.random.default_rng(7), 3, 40,
                    integer="ties" in case)
    scan_kw = {"topa_ties": {"max_active": 2}, "adaptive": {"max_active": -4},
               "adaptive_wide": {"max_active": -8},
               "adaptive_ties": {"max_active": -2}, "beam": {"beam": 3.0},
               "xw3_topa": {"max_active": 4}}.get(case, {})
    got, ref = scan_both(jn, pn, outp, **scan_kw)
    assert_planes(got, ref)
    if case == "beam":  # the beam binds
        unpruned = scan_both(jn, pn, outp)[0]
        assert int((got[0][0] <= LZERO / 2).sum()) > int(
            (unpruned[0][0] <= LZERO / 2).sum())


def test_factored_tie_rules():
    """On tied word ends (A1-A3, equal scores) the exact leg names each
    target's FIRST live slot, as the reference's bucket argmax does, and
    the top-A scatter leg the HIGHEST kept source row, as the reference's
    scatter-max does."""
    _jc, _jn, _pc, pn = nets(TIED, factored=True)
    C = pn.n_nodes
    x = pdec._scale_xw(pdec._xw_dev(pn.xw_backoff, "cpu"), 1.0)
    WE = torch.full((1, C), 2 * LZERO)
    WE[0, :3] = -1.0
    _v, a = pdec._segmax_leg(WE, x, C)
    src, tgt, _p = pn.xw_backoff["slots"]
    first = [src[(tgt == j) & (src < 3)][0] for j in range(C)]
    assert a[0].tolist() == first
    pwn = torch.full((1, C), -1, dtype=torch.int32)
    for A, top in ((3, 2), (2, 1)):  # kept rows 0..A-1: the highest wins
        m, an = pdec._factored_leg(x, C, A, False)(WE, pwn)
        assert an[0].tolist() == [top] * C


def test_record_range_raises_8520():
    _jc, _jn, _pc, pn = nets(SMALL)
    d = pdec._net_dev(pn, "cpu")
    outp = torch.zeros((1, pdec.REC_TMASK + 1, pn.n_states))
    with pytest.raises(HTKError) as e:
        pdec.decode_scan_uniform_batch(
            outp, d["band"], d["a0"], d["aE"], pn.uniform_width, d["bonus"],
            d["trans"], d["start"], 0.0)
    assert e.value.code == 8520


# -- decode / decode_batch ---------------------------------------------------

@pytest.mark.parametrize("lm", [False, True])
@pytest.mark.parametrize("kw", [{}, {"lm_scale": 3.0, "word_pen": -2.0},
                                {"max_active": 2}, {"beam": 30.0},
                                {"beam": 30.0, "max_active": 1}])
def test_decode_equals_reference(lm, kw):
    jc, jn, pc, pn = nets(SMALL, lm=lm, silent=("S",))
    for seed, seq in ((3, ["sil", "aa", "iy", "aa", "sil"]),
                      (11, ["sil", "aa", "iy", "aa", "iy", "sil"])):
        feats = emit_frames(seq, seed=seed)
        assert_results(pdec.decode(pn, pc, feats, device="cpu", **kw),
                       jdec.decode(jn, jc, feats, **kw))


@pytest.mark.parametrize("kw", [{}, {"max_active": 6},
                                {"max_active": 3, "beam": 40.0}])
def test_decode_batch_equals_reference_and_sequential(kw):
    jc, jn, pc, pn = nets(BIG, factored=False)
    seqs = [["aa", "iy", "aa", "iy", "aa"], ["sil", "aa", "iy", "sil"],
            ["iy", "sil", "iy"]]
    feats = [emit_frames(s, seed=i + 1) for i, s in enumerate(seqs)]
    got = pdec.decode_batch(pn, pc, feats, 2.0, -1.0, pad_to=16,
                            device="cpu", **kw)
    ref = jdec.decode_batch(jn, jc, feats, 2.0, -1.0, pad_to=16, **kw)
    for f, rp, rj in zip(feats, got, ref):
        assert_results(rp, rj)
        one = pdec.decode(pn, pc, f, 2.0, -1.0, device="cpu", **kw)
        assert (one.words, one.times) == (rp.words, rp.times)
        assert one.score == pytest.approx(rp.score, rel=1e-6)


@pytest.mark.parametrize("kw", [{}, {"max_active": 6}, {"max_active": -6},
                                {"max_active": -3, "beam": 40.0}])
def test_factored_decode_batch_equals_reference(kw):
    jc, jn, pc, pn = nets(BIG, factored=True)
    seqs = [["aa", "iy", "aa", "iy", "aa"], ["sil", "aa", "iy", "sil"],
            ["iy", "sil", "iy"]]
    feats = [emit_frames(s, seed=i + 1) for i, s in enumerate(seqs)]
    got = pdec.decode_batch(pn, pc, feats, 2.0, -1.0, pad_to=16,
                            device="cpu", **kw)
    ref = jdec.decode_batch(jn, jc, feats, 2.0, -1.0, pad_to=16, **kw)
    for rp, rj in zip(got, ref):
        assert_results(rp, rj)


@pytest.mark.parametrize("case", ["steer", "topa"])
def test_trigram_decode_equals_reference(case):
    """tests/test_trigram_guide.py's fixtures: an explicit trigram that
    outweighs the acoustics flips the transcript in both packages; top-A
    covering the live word ends leaves the guided decode unchanged."""
    if case == "steer":
        jc, jn, pc, pn = nets(SMALL, silent=("S",), trigram=True,
                              tri={("A", "I", "A"): np.log(0.95)},
                              bows={("A", "I"): np.log(1e-4)})
        feats = np.concatenate([emit_frames(["aa", "iy"], seed=3),
                                np.full((8, 3), 2.3, np.float32)])
        rp = pdec.decode(pn, pc, feats, lm_scale=8.0, device="cpu")
        assert_results(rp, jdec.decode(jn, jc, feats, lm_scale=8.0))
        assert rp.words == ["A", "I", "A"]
        return
    jc, jn, pc, pn = nets(BIG, tri={("W3", "W4", "W3"): np.log(0.9)},
                          trigram=True)
    for seed, seq in ((3, ["aa", "iy", "aa", "iy", "aa"]),
                      (9, ["sil", "aa", "iy", "sil"])):
        feats = emit_frames(seq, seed=seed)
        r0 = pdec.decode(pn, pc, feats, 2.0, -1.0, device="cpu")
        ra = pdec.decode(pn, pc, feats, 2.0, -1.0, max_active=6,
                         device="cpu")
        assert_results(ra, jdec.decode(jn, jc, feats, 2.0, -1.0,
                                       max_active=6))
        assert (ra.words, ra.times) == (r0.words, r0.times)
        assert ra.score == pytest.approx(r0.score, rel=1e-6)


def test_adaptive_scores_equal_exact():
    """The certificate's contract: adaptive-exact top-A gives the exact
    decode's scores (==), words and times, whatever A."""
    _jc, _jn, pc, pn = nets(BIG, factored=True)
    seqs = [["aa", "iy", "aa", "iy", "aa"], ["sil", "aa", "iy", "sil"],
            ["iy", "sil", "iy"], ["aa", "sil", "aa"]]
    feats = [emit_frames(s, seed=i + 4) for i, s in enumerate(seqs)]
    exact = pdec.decode_batch(pn, pc, feats, 2.0, -1.0, pad_to=16,
                              device="cpu")
    for A in (1, 3, 6):
        got = pdec.decode_batch(pn, pc, feats, 2.0, -1.0, pad_to=16,
                                max_active=-A, device="cpu")
        for g, e in zip(got, exact):
            assert (g.words, g.times, g.score) == (e.words, e.times,
                                                   e.score)


def test_adaptive_gates_segmax_per_frame(monkeypatch):
    """The adaptive-exact leg hands segmax the certificate as its `skip`
    flag, one launch a frame; at A = 1 some frames take the slow path
    (flag False) and some skip it (True), and the decode equals exact."""
    from htk_tpu_torch.ops import xw_gather as xg

    _jc, _jn, pc, pn = nets(BIG, factored=True)
    seqs = [["aa", "iy", "aa", "iy", "aa"], ["sil", "aa", "iy", "sil"]]
    feats = [emit_frames(s, seed=i + 4) for i, s in enumerate(seqs)]
    exact = pdec.decode_batch(pn, pc, feats, 2.0, -1.0, pad_to=16,
                              device="cpu")
    flags, real = [], xg.segmax

    def record(WE, preds, scores, seg_off, out_row, C_out, skip=None):
        flags.append(None if skip is None else bool(skip))
        return real(WE, preds, scores, seg_off, out_row, C_out, skip)

    monkeypatch.setattr(xg, "segmax", record)
    got = pdec.decode_batch(pn, pc, feats, 2.0, -1.0, pad_to=16,
                            max_active=-1, device="cpu")
    T = -(-max(f.shape[0] for f in feats) // 16) * 16
    assert len(flags) == T and None not in flags
    assert True in flags and False in flags
    for g, e in zip(got, exact):
        assert (g.words, g.times, g.score) == (e.words, e.times, e.score)


def test_factored_equals_dense():
    """As tests/test_lvdecode.py:266-287: with explicit bigrams above
    their back-off products everywhere, the factored and dense forms give
    the same decode."""
    _jc, _jn, pc, pf = nets(BIG, factored=True)
    _jc, _jn, pc, pd = nets(BIG, factored=False)
    assert pf.xw_backoff is not None and pd.xw_backoff is None
    for seed, seq in ((3, ["sil", "aa", "iy", "aa", "sil"]),
                      (9, ["iy", "iy", "sil", "aa"])):
        feats = emit_frames(seq, seed=seed)
        rf = pdec.decode(pf, pc, feats, 3.0, -2.0, device="cpu")
        rd = pdec.decode(pd, pc, feats, 3.0, -2.0, device="cpu")
        assert (rf.words, rf.times) == (rd.words, rd.times)
        assert rf.score == pytest.approx(rd.score, rel=1e-6)


def test_nonbinding_topa_equals_exact():
    """max_active covering every live word end leaves the decode equal to
    the exact dense leg."""
    _jc, _jn, pc, pn = nets(BIG, factored=False)
    feats = emit_frames(["aa", "iy", "aa", "iy", "aa"], seed=3)
    r0 = pdec.decode(pn, pc, feats, 2.0, -1.0, device="cpu")
    for A in (pn.n_nodes, 6):
        ra = pdec.decode(pn, pc, feats, 2.0, -1.0, max_active=A,
                         device="cpu")
        assert (ra.words, ra.times) == (r0.words, r0.times)
        assert ra.score == pytest.approx(r0.score, rel=1e-6)


def test_synthetic_system_equals_reference_and_word_network(tmp_path):
    """A 20-word system written by synth.write_system: the LV network
    from its dict and lm.arpa decodes as htk_tpu's does, and gives the
    same words as the port's general decoder on wdnet.slf (the same LM
    as a word network)."""
    from htk_tpu.algo.net import word_internal_phone_map as j_pmap
    from htk_tpu.io.dictionary import read_dict as j_read_dict
    from htk_tpu.io.mmf import load_mmf as j_load_mmf
    from htk_tpu.models.hmmset import compile_hmmset as j_compile_set
    from htk_tpu_torch.algo.net import (compile_network,
                                        word_internal_phone_map)
    from htk_tpu_torch.io.dictionary import read_dict
    from htk_tpu_torch.io.htkfeat import read_htk_file
    from htk_tpu_torch.io.mmf import load_mmf
    from htk_tpu_torch.io.slf import read_slf
    from htk_tpu_torch.models.hmmset import compile_hmmset
    from htk_tpu_torch.synth import write_system

    s = write_system(str(tmp_path), n_words=20, n_phones=8, n_tied=30,
                     n_mix=2, n_utts=4, min_frames=60, max_frames=150,
                     fanout=4, seed=2)
    assert os.path.exists(s.lm)
    jc = j_compile_set(j_load_mmf([s.hmmdefs]))
    pc = compile_hmmset(load_mmf([s.hmmdefs]))
    jv, pv = j_read_dict(s.dict), read_dict(s.dict)
    words = [f"w{i}" for i in range(20)]
    jn = j_compile(words, jv, jc, lm=j_read_arpa(s.lm),
                   phone_map=j_pmap(jc.names))
    pn = p_compile(words, pv, pc, lm=p_read_arpa(s.lm),
                   phone_map=word_internal_phone_map(pc.names))
    assert pn.xw_backoff is None and pn.n_nodes == 20
    np.testing.assert_array_equal(pn.trans, jn.trans)
    feats = [read_htk_file(p).data for p in s.feats]
    got = pdec.decode_batch(pn, pc, feats, 8.0, -10.0, device="cpu")
    ref = jdec.decode_batch(jn, jc, feats, 8.0, -10.0)
    for rp, rj in zip(got, ref):
        assert_results(rp, rj)
    gnet = compile_network(read_slf(s.wdnet), pv, pc,
                           phone_map=word_internal_phone_map(pc.names))
    hv = pdec.decode_batch(gnet, pc, feats, 8.0, -10.0, device="cpu")
    assert [r.words for r in got] == [r.words for r in hv]
    assert all(r.words for r in got)


def test_long_utterance_chunks_as_reference():
    """Over 32,767 frames: decode_batch routes the long utterance through
    the chunked decode and batches the short one, as htk_tpu does (the
    reference test's shape: repeated word units with silence gaps)."""
    jc, jn, pc, pn = nets(SMALL, silent=("S",))
    unit = emit_frames(["aa", "iy", "sil"], frames_per=8, seed=3)
    reps = (pdec.REC_TMASK + 2000) // unit.shape[0] + 1
    long_f = np.tile(unit, (reps, 1)).astype(np.float32)
    short_f = emit_frames(["sil", "aa", "iy", "sil"], seed=5)
    got = pdec.decode_batch(pn, pc, [short_f, long_f], pad_to=16,
                            device="cpu")
    ref = jdec.decode_batch(jn, jc, [short_f, long_f], pad_to=16)
    for rp, rj in zip(got, ref):
        assert_results(rp, rj)
    assert len(got[1].words) == 2 * reps
    assert got[1].times[-1][1] > pdec.CHUNK_T


def test_unported_legs_raise_8527():
    """The factored and trigram-guided legs, which raised HError 8527
    before they were ported, now equal htk_tpu's through decode,
    decode_batch and decode_scan_uniform_batch."""
    feats = emit_frames(["aa", "iy", "aa"], seed=1)
    for kw in ({"factored": True}, {"tri": TRI, "trigram": True}):
        jc, jn, pc, pn = nets(BIG, **kw)
        assert pn.xw_backoff is not None
        assert (pn.xw_trigram is not None) == ("tri" in kw)
        assert_results(pdec.decode(pn, pc, feats, 2.0, device="cpu"),
                       jdec.decode(jn, jc, feats, 2.0))
        assert_results(
            pdec.decode_batch(pn, pc, [feats], 2.0, device="cpu")[0],
            jdec.decode_batch(jn, jc, [feats], 2.0)[0])
        outp = net_outp(pn, np.random.default_rng(2), 2, 12)
        assert_planes(*scan_both(jn, pn, outp))


def test_adaptive_topa_without_factored_tables_raises_8526():
    """As in the reference: adaptive-exact top-A (negative max_active)
    needs the factored tables."""
    jc, jn, pc, pn = nets(BIG, factored=False)
    feats = emit_frames(["aa", "iy"], seed=1)
    with pytest.raises(HTKError) as e:
        pdec.decode_batch(pn, pc, [feats], max_active=-4, device="cpu")
    assert e.value.code == 8526
