"""Hybrid DNN-HMM decoding on HDecode's batched LV path, on the CPU: the
batched `hybrid_outp` and `generate_lattice_batch(state_scores_list=...)`.

A 200-word factored LV loop (`synth.lv_system`) and a seeded DNN of 11 x 39
inputs, 3 sigmoid layers of 64 and one output a tied state of the set,
over utterances of unequal lengths:

  (a) the batched scores equal each utterance's own scores to the bit on
      every real frame, the last 5 of the shorter utterances (where the
      splice clamps at the utterance's own end) included;
  (b) the batch's lattices and 1-bests equal `generate_lattice(
      state_scores=...)` on each utterance, byte for byte;
  (c) the port against the plain float64 reference (tests/plain_hybrid.py):
      the DNN's scores, the best score and every arc's acoustic score;
  (d) the batch against htk_tpu's `generate_lattice_batch(
      state_scores_list=...)` on the same scores;
  (e) the GMM path of `generate_lattice_batch`: its lattices equal those
      of the hook fed the GMM's own state scores, byte for byte.

Also: the hook on a general net, the padded-tensor form, and
`model_params` refused beside it, by `decode_batch` too.
"""

import numpy as np
import pytest
import torch

from htk_tpu.algo import decode as jdec
from htk_tpu_torch.algo import decode as pdec
from htk_tpu_torch.algo.nnet import check_targets, hybrid_outp
from htk_tpu_torch.models.ann import ANNDef, ANNModule, Layer
from htk_tpu_torch.synth import lv_system
from htk_tpu_torch.utils.errors import HTKError

import plain_hybrid as ph
from _torch_compare import assert_slf_close, one_torch_thread  # noqa: F401
from test_torch_lvlattice import _jax_twin, _slf

LM, PEN = 12.0, 0.0
CONTEXT, HIDDEN = 5, (64, 64, 64)
F32_U = 2.0 ** -24


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def make_ann(n_in, n_out, seed, gain=4.0):
    """Sigmoid layers of HIDDEN with N(0, gain^2 / fan-in) weights and
    biases, a SOFTMAX output a target, Dirichlet(1) priors."""
    rng = np.random.default_rng(seed)
    dims = [n_in * (2 * CONTEXT + 1), *HIDDEN, n_out]
    layers = []
    for k in range(len(dims) - 1):
        sd = gain / np.sqrt(dims[k])
        layers.append(Layer(
            weight=(rng.standard_normal((dims[k + 1], dims[k])) * sd
                    ).astype(np.float32),
            bias=(rng.standard_normal(dims[k + 1]) * sd).astype(np.float32),
            activation="SIGMOID" if k < len(dims) - 2 else "SOFTMAX"))
    return ANNDef(name="dnn", layers=layers, context=CONTEXT,
                  target_priors=rng.dirichlet(np.ones(n_out)).astype(
                      np.float32),
                  target_names=[f"S{k}" for k in range(n_out)])


@pytest.fixture(scope="module")
def case():
    s = lv_system(200, n_tied=40, n_mix=2, n_utts=4, min_frames=60,
                  max_frames=140, seed=21)
    jc, jn, pc, pn = _jax_twin(s)
    ann = make_ann(s.comp.dim, s.comp.n_states, seed=5)
    check_targets(ann, s.comp)
    feats = [np.asarray(f, np.float32) for f in s.feats]
    assert len({len(f) for f in feats}) > 1
    model = ANNModule(ann, "cpu")
    lens = [len(f) for f in feats]
    T = -(-max(lens) // 16) * 16
    fb = np.zeros((len(feats), T, feats[0].shape[1]), np.float32)
    for b, f in enumerate(feats):
        fb[b, :len(f)] = f
    batch = hybrid_outp(ann, fb, device="cpu", model=model, lengths=lens)
    return dict(s=s, jc=jc, jn=jn, pc=pc, pn=pn, ann=ann, feats=feats,
                lens=lens, model=model, batch=batch,
                single=[hybrid_outp(ann, f, device="cpu", model=model)
                        for f in feats])


def test_a_batched_scores_equal_each_utterance_to_the_bit(case):
    batch, lens = case["batch"], case["lens"]
    assert torch.isfinite(batch).all()  # padded rows too
    for b, one in enumerate(case["single"]):
        assert torch.equal(batch[b, :lens[b]], one)
        # the shorter utterances' last frames: the splice clamps at their
        # own end, not at the padded T
        assert torch.equal(batch[b, lens[b] - CONTEXT:lens[b]],
                           one[-CONTEXT:])


def test_splice_clamps_at_each_utterance_end(case):
    from htk_tpu_torch.models.ann import splice
    x = torch.arange(2 * 6 * 1, dtype=torch.float32).reshape(2, 6, 1)
    got = splice(x, 2, [4, 6])
    assert got[0, 3].tolist() == [1.0, 2.0, 3.0, 3.0, 3.0]
    assert got[0, 5].tolist() == [3.0, 3.0, 3.0, 3.0, 3.0]
    assert got[1, 5].tolist() == [9.0, 10.0, 11.0, 11.0, 11.0]
    assert torch.equal(got[1], splice(x[1], 2))


def _batch(case, scores, **kw):
    return pdec.generate_lattice_batch(
        case["pn"], case["pc"], case["feats"], LM, PEN, 20.0,
        want_results=True, max_preds=8, state_scores_list=scores,
        device="cpu", **kw)


def test_b_batch_equals_sequential_generate_lattice(case):
    got = _batch(case, case["single"])
    for (lt, r), sc, f in zip(got, case["single"], case["feats"]):
        sl, sr = pdec.generate_lattice(
            case["pn"], case["pc"], f, LM, PEN, 20.0, want_result=True,
            max_preds=8, state_scores=sc, device="cpu")
        assert len(lt.arcs) > 10
        assert _slf(lt) == _slf(sl)
        assert (r.words, r.times) == (sr.words, sr.times)
        assert r.score == pytest.approx(sr.score, rel=1e-6)


def test_the_padded_tensor_form_equals_the_list_form(case):
    a = _batch(case, case["single"])
    b = _batch(case, case["batch"])
    assert [(_slf(x), r.words, r.times, r.score) for x, r in a] == \
        [(_slf(x), r.words, r.times, r.score) for x, r in b]


def _plain_loop(s, comp):
    """The loop of `s` as plain arrays: each word's chain of the compiled
    set's state ids (DNN output k is state k), the back-off bigram as a
    dense matrix, sentence entry and exit through the back-off."""
    idx = {id(si): k for k, si in enumerate(comp._state_objs)}
    hset = comp._hset
    chains = [np.array([idx[id(si)] for name in s.vocab.get(w).prons[0]
                        .phones for si in hset.hmms[name].states], np.int64)
              for w in s.words]
    uni = np.array([s.lm.unigrams[w][0] for w in s.words])
    bow = np.array([s.lm.unigrams[w][1] for w in s.words])
    lm = bow[:, None] + uni[None, :]
    pos = {w: k for k, w in enumerate(s.words)}
    for (u, v), (p, _b) in s.lm.bigrams.items():
        if u in pos and v in pos:
            lm[pos[u], pos[v]] = max(p, lm[pos[u], pos[v]])
    start = s.lm.unigrams["!ENTER"][1] + uni
    end = bow + s.lm.unigrams["!EXIT"][0]
    tp = hset.hmms[s.vocab.get(s.words[0]).prons[0].phones[0]].transp
    return ph.WordLoop(chains, lm, start, end, float(np.log(tp[1, 1])),
                       float(np.log(tp[1, 2])), LM, PEN)


def test_c_port_equals_the_plain_reference(case):
    ann, s = case["ann"], case["s"]
    layers = [(l.weight, l.bias, l.activation) for l in ann.layers]
    loop = _plain_loop(s, case["pc"])
    word = {w: k for k, w in enumerate(s.words)}
    got = _batch(case, case["batch"])
    n_arcs = 0
    for b, (lt, r) in enumerate(got):
        ref = ph.dnn_scores(layers, ann.target_priors, CONTEXT,
                            case["feats"][b])
        # float32 through three layers of 64 and a log-softmax: about
        # 1e-6 of scores of a few tens
        np.testing.assert_allclose(case["single"][b].numpy(), ref.numpy(),
                                   rtol=0, atol=1e-4)
        best = ph.best_score(loop, ref)
        T = case["lens"][b]
        # a float32 running score rounds on every frame: at most T
        # roundings of |best|, twice over for the sums' order
        assert abs(r.score - best) <= 2 * T * F32_U * abs(best)
        nodes = {n.id: n for n in lt.nodes}
        end = next(n.id for n in lt.nodes if n.word == "!NULL" and n.time)
        arcs = [a for a in lt.arcs if a.end != end]
        t1 = [round(nodes[a.end].time / 0.01) - 1 for a in arcs]
        t0 = [round(nodes[a.start].time / 0.01) for a in arcs]
        seg = ph.segment_scores(loop, ref, [word[nodes[a.end].word]
                                            for a in arcs], t0, t1)
        # an arc's score is the difference of two running scores
        np.testing.assert_allclose([a.aclike for a in arcs], seg, rtol=0,
                                   atol=2 * T * F32_U * abs(best) + 0.01)
        n_arcs += len(arcs)
    assert n_arcs > 100


def test_d_batch_equals_htk_tpu_on_the_same_scores(case):
    scores = [x.numpy() for x in case["single"]]
    got = _batch(case, scores, pad_to=16)
    ref = jdec.generate_lattice_batch(
        case["jn"], case["jc"], case["feats"], LM, PEN, 20.0, pad_to=16,
        want_results=True, max_preds=8, state_scores_list=scores)
    for (lt, r), (jl, jr) in zip(got, ref):
        assert_slf_close(_slf(lt), _slf(jl))
        assert r.words == list(jr.words) and r.times == list(jr.times)
        assert r.score == pytest.approx(jr.score, rel=1e-5)


def test_e_gmm_path_equals_the_hook_on_its_own_scores(case):
    pn, pc, feats = case["pn"], case["pc"], case["feats"]
    gmm = pdec.generate_lattice_batch(pn, pc, feats, LM, PEN, 20.0,
                                      want_results=True, max_preds=8,
                                      device="cpu")
    own = [pdec.scorer_for(pc, torch.device("cpu"))(
        torch.as_tensor(f)) for f in feats]
    hook = _batch(case, own)
    assert [(_slf(x), r.words, r.times, r.score) for x, r in gmm] == \
        [(_slf(x), r.words, r.times, r.score) for x, r in hook]


def test_general_net_takes_the_hook(case):
    from htk_tpu_torch.algo.net import compile_network
    from htk_tpu_torch.synth import bigram_network

    s = case["s"]
    words = s.words[:12]
    succ = [[(k + 1) % 12, (k + 5) % 12] for k in range(12)]
    net = compile_network(bigram_network(words, succ, 2), s.vocab, s.comp)
    assert not net.uniform_width
    got = pdec.generate_lattice_batch(
        net, case["pc"], case["feats"], LM, PEN, 20.0, want_results=True,
        state_scores_list=case["single"], device="cpu")
    for (lt, r), sc, f in zip(got, case["single"], case["feats"]):
        sl, sr = pdec.generate_lattice(net, case["pc"], f, LM, PEN, 20.0,
                                       want_result=True, state_scores=sc,
                                       device="cpu")
        assert _slf(lt) == _slf(sl)
        assert (r.words, r.times) == (sr.words, sr.times)


def test_model_params_beside_the_hook_are_refused(case):
    pc = case["pc"]
    mp = {"means": pc.means, "variances": pc.variances,
          "gconsts": pc.gconsts}
    with pytest.raises(HTKError) as e:
        _batch(case, case["single"], model_params=mp)
    assert e.value.code == 8626
    with pytest.raises(HTKError) as e:
        pdec.decode_batch(case["pn"], pc, case["feats"], LM, PEN,
                          state_scores_list=case["single"], model_params=mp,
                          device="cpu")
    assert e.value.code == 8626


def test_targets_must_be_the_sets_states(case):
    ann, comp = case["ann"], case["pc"]
    names = list(ann.target_names)
    try:
        ann.target_names = names[::-1]
        with pytest.raises(HTKError) as e:
            check_targets(ann, comp)
        assert e.value.code == 7712
        macro = {id(si): n for n, si in comp._hset.macros["s"].items()}
        ann.target_names = [macro[id(si)] for si in comp._state_objs]
        check_targets(ann, comp)
    finally:
        ann.target_names = names


@pytest.fixture(scope="module")
def hdecode_system(tmp_path_factory):
    """A 20-word `write_system` decoded on the LV loop, and an ANN file of
    `make_ann`'s shape with a target a state of its set."""
    import os

    from htk_tpu_torch.io.mmf import load_mmf
    from htk_tpu_torch.models.ann import save_ann
    from htk_tpu_torch.models.hmmset import compile_hmmset
    from htk_tpu_torch.synth import write_system

    root = str(tmp_path_factory.mktemp("hdecode_N"))
    s = write_system(root, n_words=20, n_phones=8, n_tied=400, n_mix=2,
                     n_utts=3, min_frames=60, max_frames=150, fanout=4,
                     seed=2, binary_mmf=False)
    comp = compile_hmmset(load_mmf([s.hmmdefs]))
    ann = make_ann(comp.dim, comp.n_states, seed=9)
    save_ann(ann, os.path.join(root, "ann"))
    with open(os.path.join(root, "lv.cfg"), "w") as f:
        f.write("HTKTPU: LVDECODE = T\n")
    return s


def _hdecode(s, out, files, extra=()):
    import os

    from htk_tpu_torch.tools import hdecode

    os.makedirs(out, exist_ok=True)
    assert hdecode.run([
        "-C", os.path.join(s.root, "lv.cfg"), "-w", s.lm, "-s", "8", "-p",
        "-10", "-n", "30", "-N", os.path.join(s.root, "ann"), "-z", "lat",
        "-l", out, "-i", os.path.join(out, "rec.mlf"), *extra, "-H",
        s.hmmdefs, s.dict, s.hmmlist, *files]) == 0
    return {f: open(os.path.join(out, f)).read()
            for f in sorted(os.listdir(out)) if f.endswith(".lat")}


def test_hdecode_N_batches_and_equals_each_utterance_alone(
        hdecode_system, tmp_path, monkeypatch):
    """HDecode -N: the batched pass 1 (one `hybrid_outp` and one
    `generate_lattice_batch` a batch) writes the lattices that each file
    decoded alone writes (`generate_lattice(state_scores=...)`)."""
    from htk_tpu_torch.tools import hdecode

    s = hdecode_system
    calls = []
    real = pdec.generate_lattice_batch

    def counting(*a, **kw):
        calls.append(kw["state_scores_list"].shape)
        return real(*a, **kw)

    monkeypatch.setattr(hdecode, "generate_lattice_batch", counting)
    batch = _hdecode(s, str(tmp_path / "batch"), s.feats)
    assert len(calls) == 1 and calls[0][0] == len(s.feats)
    alone = {}
    for f in s.feats:
        alone.update(_hdecode(s, str(tmp_path / "alone"), [f]))
    assert len(batch) == len(s.feats) and batch == alone


def test_hdecode_refuses_N_with_J(hdecode_system, tmp_path):
    s = hdecode_system
    with pytest.raises(HTKError) as e:
        _hdecode(s, str(tmp_path), s.feats, ["-J", str(tmp_path)])
    assert "-N" in str(e.value) and "-J" in str(e.value)
