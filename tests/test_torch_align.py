"""The port's forced alignment (algo/viterbi, HVite -a/-m/-z/-b, HInit,
HRest) against htk_tpu's, on the CPU.

- `viterbi_scan` on the same numpy operands (random, banded like a
  composite's logA, and with integer scores that tie widely) gives the
  score within 1e-5 relative and the same traced state path: both take
  the first maximum among equal candidates. Backpointers of unreachable
  states are never followed, so only the traced path is compared.
- `align` on systems written by `synth.write_system`, its Gaussians
  diagonal and made full-covariance. The two packages' OutP matmuls
  round differently in the last bits. Where adjacent models
  share no tied state (a pool of 400 tied states), the states,
  `model_seq` times and the HVite outputs are identical, segment scores
  within 1e-4 relative. On a pool of 20 tied states, adjacent models can
  share a state, and then moving the model boundary inside a run of that
  state permutes the same transition factors: an exact tie in real
  arithmetic, which the rounding breaks either way. There the path of
  physical states is identical and the score within 1e-4 relative, which
  is what both packages' alignments agree on.
- A two-stream set (stream weights 0.7 / 1.3) aligns as the reference's
  does: the score within 1e-4 relative, the same physical state path.
  Discrete sets, which the port's alignment does not take, raise HError
  7331.
- HVite -a (rec.mlf byte-identical), -a -m (labels and times identical,
  scores within 1e-4 relative), -a -z (lattices within `assert_slf_close`)
  and -b, and HError 8621 on a word the dictionary lacks.
- HInit and HRest on the -a -m output with -l: the same state path at
  every HInit iteration, the same per-iteration totals, and the MMFs
  within tests/test_torch_herest.py's tolerances.
"""

import collections
import os

import numpy as np
import pytest

from htk_tpu.algo import viterbi as jvit
from htk_tpu.algo.composite import build_composite as j_build
from htk_tpu.io.mmf import load_mmf as j_mmf
from htk_tpu.models.hmmset import CompiledHMMSet as JCompiledHMMSet
from htk_tpu.models.hmmset import compile_hmmset as j_comp
from htk_tpu.tools import hinit as j_hinit
from htk_tpu.tools import hrest as j_hrest
from htk_tpu.tools import hvite as j_hvite
from htk_tpu_torch import convert
from htk_tpu_torch.algo import viterbi as pvit
from htk_tpu_torch.algo.composite import build_composite
from htk_tpu_torch.algo.net import word_internal_phone_map
from htk_tpu_torch.io.dictionary import read_dict
from htk_tpu_torch.io.htkfeat import read_htk_file
from htk_tpu_torch.io.mlf import MLF
from htk_tpu_torch.io.mmf import load_mmf, save_mmf
from htk_tpu_torch.models.hmmset import compile_hmmset
from htk_tpu_torch.models.proto import clone_proto, make_proto
from htk_tpu_torch.synth import write_system, write_word_mlf
from htk_tpu_torch.tools import hinit as p_hinit
from htk_tpu_torch.tools import hrest as p_hrest
from htk_tpu_torch.tools import hvite as p_hvite
from htk_tpu_torch.utils.errors import HTKError
from htk_tpu_torch.utils.logmath import LZERO

import torch

from _torch_compare import assert_slf_close, one_torch_thread  # noqa: F401
from test_torch_herest import assert_mmf_close

SCORE_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def _system(root, n_tied):
    s = write_system(str(root), n_words=6, n_phones=8, n_tied=n_tied,
                     n_mix=2, dim=39, n_utts=6, min_frames=60,
                     max_frames=150, fanout=3, seed=1, binary_mmf=False)
    write_word_mlf(s, os.path.join(s.root, "words.mlf"))
    return s


@pytest.fixture(scope="module")
def untied(tmp_path_factory):
    """400 tied states: no two adjacent models of an alignment share one."""
    return _system(tmp_path_factory.mktemp("align400"), 400)


@pytest.fixture(scope="module")
def tied(tmp_path_factory):
    return _system(tmp_path_factory.mktemp("align20"), 20)


def _trace(deltas, bps, aE):
    """align's host traceback over the planes."""
    T = deltas.shape[0]
    states = np.zeros(T, np.int64)
    states[-1] = int(np.argmax(deltas[T - 1] + aE))
    for t in range(T - 1, 0, -1):
        states[t - 1] = int(bps[t, states[t]])
    return states


def _operands(seed, T=40, Q=24, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        outp = rng.integers(-3, 1, (T, Q)).astype(np.float32)
    else:
        outp = rng.normal(-5.0, 3.0, (T, Q)).astype(np.float32)
    logA = np.full((Q, Q), LZERO, np.float32)
    for q in range(Q):
        for d in (0, 1, 2):
            if q + d < Q:
                logA[q, q + d] = (-float(rng.integers(0, 3)) if ties
                                  else np.log(rng.uniform(0.1, 0.9)))
    a0 = np.full(Q, LZERO, np.float32)
    a0[:2] = 0.0
    aE = np.full(Q, LZERO, np.float32)
    aE[-2:] = -0.5
    return outp, logA, a0, aE


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True),
                                       (3, True)])
def test_viterbi_scan_equals_reference(seed, ties):
    ops = _operands(seed, ties=ties)
    T = ops[0].shape[0]
    for t_real in (T, T - 7):
        sp, dp, bp = pvit.viterbi_scan(*(torch.as_tensor(a) for a in ops),
                                       t_real)
        sj, dj, bj = jvit.viterbi_scan(*ops, t_real)
        assert float(sp) == pytest.approx(float(sj), rel=1e-5)
        dp, bp, dj, bj = (np.asarray(a) for a in (dp, bp, dj, bj))
        np.testing.assert_array_equal(_trace(dp, bp, ops[3]),
                                      _trace(dj, bj, ops[3]))
        assert (bp[0] == -1).all()


def _full_covariance(comp, seed=0):
    """The set made full-covariance in place: each Gaussian's precision
    diag(1 / var) plus a random rank-one term, as its Cholesky factor
    `fc_proj`, `fc_mu` and gConst (the form compile_hmmset builds)."""
    rng = np.random.default_rng(seed)
    M, D = comp.means.shape
    mu = comp.means.astype(np.float64)
    fc_proj = np.zeros((M, D, D), np.float32)
    fc_mu = np.zeros((M, D), np.float32)
    gconsts = np.zeros(M, np.float32)
    for m in range(M):
        a = rng.normal(size=D) * 0.3
        P = np.diag(1.0 / comp.variances[m].astype(np.float64)) \
            + np.outer(a, a)
        L = np.linalg.cholesky(P)
        fc_proj[m], fc_mu[m] = L, mu[m] @ L
        gconsts[m] = D * np.log(2 * np.pi) - np.linalg.slogdet(P)[1]
    comp.full_cov, comp.fc_proj, comp.fc_mu = True, fc_proj, fc_mu
    comp.gconsts = gconsts
    return comp


def _load(s, full=False):
    comp = compile_hmmset(load_mmf([s.hmmdefs]))
    if full:
        comp = _full_covariance(comp)
        jcomp = convert._carry(JCompiledHMMSet, comp)
    else:
        jcomp = j_comp(j_mmf([s.hmmdefs]))
    vocab = read_dict(s.dict)
    pmap = word_internal_phone_map(comp.names)
    feats = [read_htk_file(p).data for p in s.feats]
    return comp, jcomp, vocab, pmap, feats


def _models(vocab, pmap, words):
    return [p for w in words for p in pmap(vocab.get(w).prons[0].phones)]


def _aligns(s, full=False):
    comp, jcomp, vocab, pmap, feats = _load(s, full)
    for f, words in zip(feats, s.transcripts):
        names = _models(vocab, pmap, words)
        hmm = build_composite(comp, [comp.model_id(n) for n in names])
        jhmm = j_build(jcomp, [jcomp.model_id(n) for n in names])
        yield (hmm, pvit.align(comp, hmm, f, device="cpu"),
               jvit.align(jcomp, jhmm, f))


@pytest.mark.parametrize("full", [False, True], ids=["diag", "fullc"])
def test_align_equals_reference(untied, full):
    for _hmm, rp, rj in _aligns(untied, full):
        assert rp.score == pytest.approx(rj.score, rel=SCORE_RTOL)
        np.testing.assert_array_equal(rp.states, rj.states)
        assert [m[:3] for m in rp.model_seq] == [m[:3] for m in rj.model_seq]
        for a, b in zip(rp.model_seq, rj.model_seq):
            assert a[3] == pytest.approx(b[3], rel=SCORE_RTOL)


def test_align_on_shared_states_keeps_the_physical_path(tied):
    """Adjacent models sharing a tied state tie exactly; the physical
    state path and the score agree, whichever model the rounding gives
    the boundary frames to."""
    for hmm, rp, rj in _aligns(tied):
        assert rp.score == pytest.approx(rj.score, rel=SCORE_RTOL)
        np.testing.assert_array_equal(hmm.comp_state[rp.states],
                                      hmm.comp_state[rj.states])


PHONES = ["aa", "eh", "iy", "uw"]


def _multi_stream_set(path, widths=(20, 19), nmix=2, seed=3):
    """A two-stream set (stream widths summing to 39) over the untied
    system's phones, random Gaussians and stream weights 0.7 / 1.3,
    written to `path` with the port's writer."""
    hs = make_proto(nstates=5, dim=sum(widths), parm_kind="USER",
                    nmix=nmix, stream_widths=list(widths))
    cl = clone_proto(hs, "proto", PHONES)
    rng = np.random.default_rng(seed)
    for h in cl.hmms.values():
        for si in h.states:
            si.stream_weights = np.asarray([0.7, 1.3], np.float32)
            for k, se in enumerate(si.streams):
                for mp in se.mixes:
                    mp.mean = rng.normal(size=widths[k]).astype(np.float32)
                    mp.var = (0.5 + rng.random(widths[k])).astype(
                        np.float32)
                    mp.fix_gconst()
    save_mmf(cl, path)
    return path


@pytest.mark.parametrize("what", ["multi-stream", "discrete"])
def test_align_refuses_unported_sets_with_7331(untied, tmp_path, what):
    """Discrete sets are refused with HError 7331. Multi-stream sets,
    refused until the scorer's stream sum was taken for alignment, now
    align as the reference does: the score within SCORE_RTOL and the
    same physical state path."""
    comp, _jc, vocab, pmap, feats = _load(untied)
    if what == "discrete":
        hmm = build_composite(comp, [comp.model_id(n) for n in _models(
            vocab, pmap, untied.transcripts[0])])
        comp.discrete = True
        with pytest.raises(HTKError) as e:
            pvit.align(comp, hmm, feats[0], device="cpu")
        assert e.value.code == 7331
        return
    mmf = _multi_stream_set(str(tmp_path / "ms"))
    pc, jc = compile_hmmset(load_mmf([mmf])), j_comp(j_mmf([mmf]))
    assert len(pc.slot_blocks) == 2 and pc.state_sw is not None
    rng = np.random.default_rng(5)
    for k in range(3):
        names = [PHONES[int(i)] for i in rng.integers(0, len(PHONES), 4)]
        x = rng.normal(size=(60 + 17 * k, 39)).astype(np.float32)
        hmm = build_composite(pc, [pc.model_id(n) for n in names])
        jhmm = j_build(jc, [jc.model_id(n) for n in names])
        rp = pvit.align(pc, hmm, x, device="cpu")
        rj = jvit.align(jc, jhmm, x)
        assert rp.score == pytest.approx(rj.score, rel=SCORE_RTOL)
        np.testing.assert_array_equal(hmm.comp_state[rp.states],
                                      jhmm.comp_state[rj.states])


def _hvite(run, s, out, extra):
    os.makedirs(out, exist_ok=True)
    argv = ["-a", "-I", os.path.join(s.root, "words.mlf"), "-H", s.hmmdefs,
            "-i", f"{out}/rec.mlf", "-l", out, *extra, "-S", s.scp, s.dict,
            s.hmmlist]
    assert run(argv) == 0
    return {f: open(os.path.join(out, f), "rb").read()
            for f in sorted(os.listdir(out))}


def _labels(text):
    """(name, start, end, word tag) and the score of each label line."""
    rows, scores = [], []
    for ln in text.decode().splitlines():
        f = ln.split()
        if len(f) >= 4 and f[0].isdigit():
            rows.append((f[0], f[1], f[2], f[4:]))
            scores.append(float(f[3]))
        else:
            rows.append(tuple(f))
    return rows, np.asarray(scores)


@pytest.mark.parametrize("extra", [[], ["-m"], ["-z", "lat"], ["-b", "w2"],
                                   ["-m", "-o", "N"]])
def test_hvite_align_equals_reference(untied, tmp_path, extra):
    got = _hvite(p_hvite.run, untied, str(tmp_path / "t"), extra)
    ref = _hvite(j_hvite.run, untied, str(tmp_path / "j"), extra)
    assert sorted(got) == sorted(ref)
    if "-m" in extra:
        (gr, gs), (rr, rs) = _labels(got["rec.mlf"]), _labels(ref["rec.mlf"])
        assert gr == rr and len(gs) > 0
        np.testing.assert_allclose(gs, rs, rtol=SCORE_RTOL)
    else:
        assert got["rec.mlf"] == ref["rec.mlf"]
    lats = [f for f in got if f.endswith(".lat")]
    assert len(lats) == (len(untied.feats) if "-z" in extra else 0)
    for f in lats:
        assert_slf_close(got[f].decode(), ref[f].decode())


def test_hvite_align_unknown_word_raises_8621(untied, tmp_path):
    mlf = str(tmp_path / "bad.mlf")
    with open(mlf, "w") as f:
        f.write('#!MLF!#\n"*/utt000.lab"\nNOSUCHWORD\n.\n')
    with pytest.raises(HTKError) as e:
        p_hvite.run(["-a", "-I", mlf, "-H", untied.hmmdefs, "-i",
                     str(tmp_path / "r.mlf"), untied.dict, untied.hmmlist,
                     untied.feats[0]])
    assert e.value.code == 8621


@pytest.fixture(scope="module")
def segments(untied, tmp_path_factory):
    """The -a -m alignment of the system, the label with the most
    segments in it, and a flat proto."""
    root = str(tmp_path_factory.mktemp("segs"))
    mlf = os.path.join(root, "aligned.mlf")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HTK_TPU_TORCH_DEVICE", "cpu")
        assert p_hvite.run(["-a", "-m", "-y", "lab", "-I",
                            os.path.join(untied.root, "words.mlf"), "-H",
                            untied.hmmdefs, "-i", mlf, "-S", untied.scp,
                            untied.dict, untied.hmmlist]) == 0
    m = MLF.load(mlf)
    count = collections.Counter(lab.name for _p, tr in m.entries
                                for lab in tr.labels)
    label = count.most_common(1)[0][0]
    proto = os.path.join(root, "proto")
    save_mmf(make_proto(nstates=5, dim=39, parm_kind="MFCC_E_D_A"), proto)
    return mlf, label, proto


def _record_paths(monkeypatch, module):
    """The state path of every alignment `module` (a tool) runs."""
    paths = []
    real = module.align

    def spy(*a, **k):
        res = real(*a, **k)
        paths.append(np.asarray(res.states).copy())
        return res

    monkeypatch.setattr(module, "align", spy)
    return paths


def test_hinit_hrest_equal_reference(untied, segments, tmp_path,
                                     monkeypatch, capsys):
    mlf, label, proto = segments
    outs, traces, paths = {}, {}, {}
    for name, hinit, hrest in (("t", p_hinit, p_hrest),
                               ("j", j_hinit, j_hrest)):
        d = str(tmp_path / name)
        paths[name] = _record_paths(monkeypatch, hinit)
        capsys.readouterr()
        assert hinit.run(["-T", "1", "-i", "4", "-l", label, "-o", label,
                          "-I", mlf, "-M", f"{d}/init", "-S", untied.scp,
                          proto]) == 0
        assert hrest.run(["-T", "1", "-i", "4", "-l", label, "-I", mlf,
                          "-M", f"{d}/rest", "-S", untied.scp,
                          f"{d}/init/{label}"]) == 0
        traces[name] = capsys.readouterr().out.replace(d, "")
        outs[name] = (f"{d}/init/{label}", f"{d}/rest/{label}")
    assert len(paths["t"]) == len(paths["j"]) > 0
    for a, b in zip(paths["t"], paths["j"]):
        np.testing.assert_array_equal(a, b)
    assert traces["t"] == traces["j"]
    assert "HRest: iter 1 total logP" in traces["t"]
    for got, ref in zip(outs["t"], outs["j"]):
        assert_mmf_close(got, ref)
