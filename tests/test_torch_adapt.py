"""The port's speaker adaptation (htk_tpu_torch algo/adapt.py and
algo/fb.mix_posteriors_utterance) against htk_tpu's, on the CPU.

Inputs are made from numpy seeds on the small sets of tests/test_fb.py
and tests/test_multistream.py, written to an MMF and loaded by each
package, and go through both packages:

  - `mix_posteriors_utterance`, single- and two-stream: gamma (T, M)
    within atol 1e-5 + eps32 * |logP|, logP within 1e-6 relative. Each
    posterior is exp(alpha + beta - logP) of float32 terms the size of
    |logP| (225-405 here), whose last bit is eps32 * |logP| (2.7e-5 to
    4.8e-5), and the two packages' OutP matmuls and scans round
    differently in it (the gaps seen: 2e-7 to 3.1e-5);
  - the statistics and estimates of MLLRMEAN (blocks, regression classes,
    the regression tree's back-off, MLLRVAR, full covariance), CMLLR
    (blocks, base classes), MLLRCOV and MAP, on the cases of
    tests/test_adapt.py. adapt.py is the reference's numpy, and the
    port's accumulators are torch tensors converted once at each
    function's entry, so every result is held at rtol 1e-12 (in practice
    bit for bit);
  - the model-space applications (MLLR classes, MLLRCOV and base-class
    CMLLR through the full-covariance scorer) and the port's scorer on
    them against the reference's `full_cov_mix_scores`, within 1e-4 of
    scale;
  - TMF and base-class files written by each package byte-identical, and
    each package reading the other's;
  - the device scorer cached on a compiled set: `write_back` and
    `drop_device_caches` drop it, and a `model_params` override scores
    with a scorer of its own and leaves the cached one alone. The first
    assertion fails against a cache that is never dropped.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htk_tpu.algo import adapt as jad
from htk_tpu.algo import fb as jfb
from htk_tpu.algo.fb import Accumulators as JAccumulators
from htk_tpu.algo.trainer import Trainer as JTrainer
from htk_tpu.algo.trainer import pad_batch as j_pad_batch
from htk_tpu.algo.trainer import prepare_utterance as j_prep
from htk_tpu.io.mmf import load_mmf as j_load_mmf
from htk_tpu.io.mmf import save_mmf as j_save_mmf
from htk_tpu.models.hmmset import compile_hmmset as j_compile
from htk_tpu.ops.outp import full_cov_mix_scores as j_fc_scores
from htk_tpu_torch import convert
from htk_tpu_torch.algo import adapt as pad
from htk_tpu_torch.algo.decode import decode, scorer_for
from htk_tpu_torch.algo.fb import mix_posteriors_utterance
from htk_tpu_torch.algo.net import compile_network, word_internal_phone_map
from htk_tpu_torch.algo.trainer import Trainer, pad_batch, prepare_utterance
from htk_tpu_torch.io.dictionary import read_dict
from htk_tpu_torch.io.htkfeat import read_htk_file
from htk_tpu_torch.io.mmf import load_mmf
from htk_tpu_torch.io.slf import read_slf
from htk_tpu_torch.models.hmmset import (compile_hmmset, drop_device_caches,
                                         write_back)
from htk_tpu_torch.ops.outp import GaussianScorer
from htk_tpu_torch.synth import write_system

from _torch_compare import one_torch_thread  # noqa: F401
from test_fb import small_set
from test_multistream import ms_set

GAMMA_ATOL = 1e-5
EST_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def _pair(hset, path):
    """The set written once and compiled by both packages from the file."""
    j_save_mmf(hset, str(path))
    return (compile_hmmset(load_mmf([str(path)])),
            j_compile(j_load_mmf([str(path)])))


def _sets(tmp_path, nmix, seed):
    return _pair(small_set(nmix=nmix, seed=seed)._hset, tmp_path / "mmf")


def _accs(comp, target, occ_per_mix, var_scale=1.0):
    """Accumulators as if the data of each Gaussian were `target` with
    `var_scale` times the model variances (tests/test_adapt.py's
    accs_for_shift): (the reference's numpy, the port's tensors)."""
    M = comp.n_mix
    S, mm = comp.state_mix.shape
    occ = np.full(M, occ_per_mix, np.float32)
    j = JAccumulators(
        occ=occ, sum_x=(occ[:, None] * target).astype(np.float32),
        sum_xx=(occ[:, None] * (target ** 2 + var_scale * comp.variances)
                ).astype(np.float32),
        wt_occ=np.full((S, mm), occ_per_mix, np.float32),
        tr=np.zeros(comp.log_transp.size, np.float32),
        total_logp=np.float32(0.0), total_frames=np.float32(occ_per_mix * M),
        n_utts=np.float32(1.0))
    return j, convert.accumulators_from(j)


def _same_xf(a, b):
    assert a.kind == b.kind
    np.testing.assert_allclose(a.A, b.A, rtol=EST_RTOL, atol=0)
    np.testing.assert_allclose(a.b, b.b, rtol=EST_RTOL, atol=0)
    if b.var_scale is None:
        assert a.var_scale is None
    else:
        np.testing.assert_allclose(a.var_scale, b.var_scale, rtol=EST_RTOL)


def _same_xfs(got, ref):
    (xg, cg), (xr, cr) = got, ref
    assert len(xg) == len(xr)
    np.testing.assert_array_equal(cg, cr)
    for a, b in zip(xg, xr):
        _same_xf(a, b)


# -- mix_posteriors_utterance ----------------------------------------------


@pytest.mark.parametrize("streams", [1, 2], ids=["single", "two-stream"])
def test_mix_posteriors_match_reference(tmp_path, streams):
    hs = (small_set(nmix=2, seed=4)._hset if streams == 1
          else ms_set(seed=4, nmix=2))
    comp, jcomp = _pair(hs, tmp_path / "mmf")
    rng = np.random.default_rng(7)
    pt, jt = Trainer(comp, device="cpu"), JTrainer(jcomp)
    names = [comp.names[i] for i in (0, 1, 0, 1)]
    for T in (29, 40):
        x = (rng.normal(size=(T, comp.dim)) * 1.5).astype(np.float32)
        arrs = pad_batch([prepare_utterance(comp, "u", x, names)],
                         comp.n_states)
        lp, gam = mix_posteriors_utterance(
            *(torch.as_tensor(arrs[k][0]) for k in (
                "feats", "t_real", "comp_state", "q_mask", "logA", "a0",
                "aE")),
            **pt.params(), slot_blocks=tuple(comp.slot_blocks) or None)
        jarrs = j_pad_batch([j_prep(jcomp, "u", x, names)], jcomp.n_states)
        p = jt.params()
        jlp, jgam = jfb.mix_posteriors_utterance(
            *(jnp.asarray(jarrs[k][0]) for k in (
                "feats", "t_real", "comp_state", "q_mask", "logA", "a0",
                "aE")),
            means=p[0], variances=p[1], gconsts=p[2], state_mix=p[3],
            state_logw=p[4], state_sw=p[5],
            slot_blocks=tuple(jcomp.slot_blocks) or None)
        assert gam.shape == tuple(jgam.shape)
        np.testing.assert_allclose(
            gam.numpy(), np.asarray(jgam), rtol=0,
            atol=GAMMA_ATOL + np.finfo(np.float32).eps * abs(float(jlp)))
        assert float(lp) == pytest.approx(float(jlp), rel=1e-6)
        # frames past the utterance (pad_batch's bucket) carry nothing
        assert gam.shape[0] > T and not gam[T:].any()


# -- statistics and estimates ------------------------------------------------


@pytest.mark.parametrize("case", ["shift", "linear", "blocks"])
def test_mllr_mean_matches_reference(tmp_path, case):
    comp, jcomp = _sets(tmp_path, nmix=3 if case == "blocks" else 2,
                        seed=10)
    if case == "linear":
        A = np.array([[1.1, 0.1, 0.0], [0.0, 0.9, -0.1], [0.05, 0.0, 1.05]])
        target = comp.means @ A.T + np.array([0.3, -0.2, 0.1])
    else:
        target = comp.means + np.array([1.0, -0.7, 0.4])
    ja, pa = _accs(comp, target, 4.0 if case == "blocks" else 30.0)
    blocks = 3 if case == "blocks" else 1
    got = pad.estimate_mllr_mean(comp, pa, blocks=blocks)
    _same_xf(got, jad.estimate_mllr_mean(jcomp, ja, blocks=blocks))
    np.testing.assert_allclose(got.apply_to_means(comp.means), target,
                               atol=0.2)


def test_mllr_mean_full_covariance_matches_reference(tmp_path):
    from test_torch_align import _full_covariance

    comp, _jc = _sets(tmp_path, nmix=2, seed=11)
    comp = _full_covariance(comp)
    jcomp = convert._carry(type(_jc), comp)
    ja, pa = _accs(comp, comp.means + 0.5, 20.0)
    _same_xf(pad.estimate_mllr_mean(comp, pa),
             jad.estimate_mllr_mean(jcomp, ja))


def test_mllr_var_matches_reference(tmp_path):
    comp, jcomp = _sets(tmp_path, nmix=1, seed=12)
    scale = np.array([2.0, 0.5, 1.5])
    ja, pa = _accs(comp, comp.means, 80.0, var_scale=scale[None, :])
    H = pad.estimate_mllr_var(comp, pa, comp.means)
    np.testing.assert_allclose(H, jad.estimate_mllr_var(jcomp, ja,
                                                        jcomp.means),
                               rtol=EST_RTOL)
    np.testing.assert_allclose(H, scale, rtol=1e-3)


@pytest.mark.parametrize("thresh,mllr_var", [(1e9, False), (1.0, False),
                                             (1.0, True)])
def test_mllr_tree_matches_reference(tmp_path, thresh, mllr_var):
    comp, jcomp = _sets(tmp_path, nmix=2, seed=13)
    tree = pad.build_regression_tree(comp, 3)
    for a, b in zip(tree, jad.build_regression_tree(jcomp, 3)):
        np.testing.assert_array_equal(a, b)
    ja, pa = _accs(comp, comp.means + np.array([1.0, -1.0, 0.5]), 50.0)
    _same_xfs(pad.estimate_mllr_tree(comp, pa, *tree, occ_thresh=thresh,
                                     mllr_var=mllr_var),
              jad.estimate_mllr_tree(jcomp, ja, *tree, occ_thresh=thresh,
                                     mllr_var=mllr_var))


def test_mllr_classes_match_reference(tmp_path):
    comp, jcomp = _sets(tmp_path, nmix=3, seed=14)
    classes = pad.build_regression_classes(comp, 2)
    np.testing.assert_array_equal(
        classes, jad.build_regression_classes(jcomp, 2))
    ja, pa = _accs(comp, comp.means + 0.8, 60.0)
    got = pad.estimate_mllr_classes(comp, pa, classes)
    _same_xfs(got, jad.estimate_mllr_classes(jcomp, ja, classes))
    xfs, c2x = got
    np.testing.assert_allclose(
        pad.apply_mllr_classes(comp, comp.means, xfs, c2x, classes),
        jad.apply_mllr_classes(jcomp, jcomp.means, xfs, c2x, classes),
        rtol=EST_RTOL)


def _cmllr_data(comp, seed, T, offsets, classes=None):
    """Frames of each Gaussian in turn, shifted by its class's offset,
    with one-hot posteriors."""
    rng = np.random.default_rng(seed)
    M, D = comp.n_mix, comp.dim
    ms = rng.integers(0, M, size=T)
    feats = comp.means[ms] + rng.normal(size=(T, D)) * np.sqrt(
        comp.variances[ms])
    cls = np.zeros(M, np.int32) if classes is None else classes
    for c, off in enumerate(offsets):
        feats[cls[ms] == c] += off
    gam = np.zeros((T, M))
    gam[np.arange(T), ms] = 1.0
    return feats, gam


@pytest.mark.parametrize("blocks,T", [(1, 1200), (3, 60)])
def test_cmllr_matches_reference(tmp_path, blocks, T):
    comp, jcomp = _sets(tmp_path, nmix=3, seed=12)
    offset = np.array([0.8, -0.5, 0.3])
    feats, gam = _cmllr_data(comp, 0, T, [offset])
    st = pad.cmllr_stats_from_gammas(feats, gam, comp.means, comp.variances)
    jst = jad.cmllr_stats_from_gammas(feats, gam, jcomp.means,
                                      jcomp.variances)
    np.testing.assert_allclose(st.G, jst.G, rtol=EST_RTOL)
    np.testing.assert_allclose(st.k, jst.k, rtol=EST_RTOL)
    assert st.beta == jst.beta
    got = pad.estimate_cmllr(st, n_iter=50, blocks=blocks)
    _same_xf(got, jad.estimate_cmllr(jst, n_iter=50, blocks=blocks))
    np.testing.assert_allclose(got.b, -offset, atol=0.4)


def test_cmllr_classes_match_reference(tmp_path):
    comp, jcomp = _sets(tmp_path, nmix=2, seed=9)
    classes = (np.arange(comp.n_mix) % 2).astype(np.int32)
    feats, gam = _cmllr_data(comp, 9, 1200, [np.array([2.0, -1.0, 0.5]),
                                             np.array([-1.5, 0.8, 2.0])],
                             classes)
    out = []
    for ad, c in ((pad, comp), (jad, jcomp)):
        g = ad.cmllr_stats_from_gammas(feats, gam, c.means, c.variances)
        cs = [ad.cmllr_stats_from_gammas(
            feats, gam * (classes[None, :] == k), c.means, c.variances)
            for k in (0, 1)]
        for thresh in (10.0, 1e9):
            out.append(ad.estimate_cmllr_classes(cs, g, occ_thresh=thresh))
    _same_xfs(out[0], out[2])
    _same_xfs(out[1], out[3])
    assert list(out[0][1]) == [1, 2] and set(out[1][1]) == {0}


def test_mllrcov_matches_reference(tmp_path):
    comp, jcomp = _sets(tmp_path, nmix=1, seed=5)
    rng = np.random.default_rng(5)
    M, D = comp.n_mix, comp.dim
    H0 = np.eye(D)
    H0[:2, :2] = [[np.cos(0.7), -np.sin(0.7)], [np.sin(0.7), np.cos(0.7)]]
    H0[2, 2] = 1.6
    ms = rng.integers(0, M, size=3000)
    feats = comp.means[ms] + (rng.normal(size=(3000, D))
                              * np.sqrt(comp.variances[ms])) @ H0.T
    gam = np.zeros((3000, M))
    gam[np.arange(3000), ms] = 1.0
    G, beta = pad.mllrcov_stats_from_gammas(feats, gam, comp.means,
                                            comp.variances)
    jG, jbeta = jad.mllrcov_stats_from_gammas(feats, gam, jcomp.means,
                                              jcomp.variances)
    np.testing.assert_allclose(G, jG, rtol=EST_RTOL)
    assert beta == jbeta
    _same_xf(pad.estimate_mllrcov(G, beta), jad.estimate_mllrcov(jG, jbeta))


@pytest.mark.parametrize("how", ["mllrcov", "cmllr-classes"])
def test_full_covariance_applications_match_reference(tmp_path, how):
    """The model-space applications, and the port's scorer on them
    against the reference's full-covariance scores."""
    comp, jcomp = _sets(tmp_path, nmix=2, seed=6)
    rng = np.random.default_rng(6)
    D = comp.dim
    xf = pad.Transform(kind="MLLRCOV" if how == "mllrcov" else "CMLLR",
                       A=np.eye(D) + 0.15 * rng.normal(size=(D, D)),
                       b=(np.zeros(D) if how == "mllrcov"
                          else rng.normal(size=D)))
    if how == "mllrcov":
        got = pad.apply_mllrcov(comp, xf)
        ref = jad.apply_mllrcov(jcomp, xf)
    else:
        classes = (np.arange(comp.n_mix) % 2).astype(np.int32)
        xf2 = pad.Transform(kind="CMLLR", A=np.eye(D) * 1.1, b=np.ones(D))
        c2x = np.array([0, 1], np.int32)
        got = pad.apply_cmllr_classes_fc(comp, [xf, xf2], c2x, classes)
        ref = jad.apply_cmllr_classes_fc(jcomp, [xf, xf2], c2x, classes)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    comp.fc_proj, comp.fc_mu, comp.gconsts = got
    comp.full_cov = True
    x = rng.normal(size=(5, D)).astype(np.float32)
    sc = GaussianScorer(comp, "cpu")
    from htk_tpu_torch.ops.outp import full_cov_mix_scores

    mine = full_cov_mix_scores(torch.as_tensor(x), sc.fc_proj, sc.fc_mu,
                               sc.gconsts).numpy()
    theirs = np.asarray(j_fc_scores(*(jnp.asarray(a) for a in (x, *ref))))
    scale = np.abs(theirs).max()
    np.testing.assert_allclose(mine / scale, theirs / scale, atol=1e-4)


def test_map_update_matches_reference(tmp_path):
    comp, jcomp = _sets(tmp_path, nmix=1, seed=13)
    ja, pa = _accs(comp, comp.means + 2.0, 10.0)
    for tau in (1.0, 5.0, 1000.0):
        np.testing.assert_array_equal(pad.map_update(comp, pa, tau),
                                      jad.map_update(jcomp, ja, tau))


@pytest.mark.parametrize("mask,name", [
    ("%%_*", "sA_u3.mfc"), ("*/%%%_*.mfc", "data/abc_001.mfc"),
    ("%%%*", "spk1utt.mfc"), ("zz%%", "sA_u3.mfc"),
    ("%%%%_*", "spkC/spkC_adapt0.mfc")])
def test_speaker_mask_matches_reference(mask, name):
    assert pad.speaker_from_mask(mask, name) == jad.speaker_from_mask(
        mask, name)


# -- files -------------------------------------------------------------------


def _xf(kind, D, seed, var=False):
    rng = np.random.default_rng(seed)
    return pad.Transform(kind=kind, A=np.eye(D) + 0.1 * rng.normal(
        size=(D, D)), b=rng.normal(size=D),
        var_scale=(0.5 + rng.random(D)) if var else None)


@pytest.mark.parametrize("what", ["MLLRMEAN", "MLLRVAR", "CMLLR", "MLLRCOV",
                                  "MLLRCLASSES", "CMLLRCLASSES"])
def test_tmf_files_byte_identical(tmp_path, what):
    D = 5
    classes = np.array([0, 1, 1, 0, 2, 2, 1], np.int32)
    c2x = np.array([0, 1, 0], np.int32)
    paths = {}
    for ad, tag in ((pad, "p"), (jad, "j")):
        path = str(tmp_path / f"{tag}.tmf")
        if what.endswith("CLASSES"):
            kind = what[:-7].replace("MLLR", "MLLRMEAN") if what.startswith(
                "MLLR") else "CMLLR"
            xfs = [_xf(kind, D, s, var=(s == 1 and kind == "MLLRMEAN"))
                   for s in (0, 1)]
            ad.save_tmf_classes(path, "spk", xfs, c2x, classes, kind=what)
        else:
            ad.save_tmf(path, "spk", _xf(
                "MLLRMEAN" if what == "MLLRVAR" else what, D, 3,
                var=what == "MLLRVAR"))
        paths[tag] = path
    assert open(paths["p"], "rb").read() == open(paths["j"], "rb").read()
    # each package reads the other's file
    for mine, theirs in ((pad, paths["j"]), (jad, paths["p"])):
        multi = mine.load_tmf_classes(theirs)
        if what.endswith("CLASSES"):
            name, xfs, got_c2x, got_cls = multi
            np.testing.assert_array_equal(got_cls, classes)
            np.testing.assert_array_equal(got_c2x, c2x)
        else:
            assert multi is None
            name, xf = mine.load_tmf(theirs)
            assert xf.kind == ("MLLRMEAN" if what == "MLLRVAR" else what)
            assert (xf.var_scale is not None) == (what == "MLLRVAR")
        assert name == "spk"


@pytest.mark.parametrize("tree", [False, True])
def test_baseclass_files_byte_identical(tmp_path, tree):
    comp, jcomp = _sets(tmp_path, nmix=2, seed=3)
    classes, parent, leaf = pad.build_regression_tree(comp, 3)
    kw = dict(parent=parent, leaf_node=leaf) if tree else {}
    pp, jp = str(tmp_path / "p.cls"), str(tmp_path / "j.cls")
    pad.save_baseclass(pp, "rtree", classes, **kw)
    jad.save_baseclass(jp, "rtree", classes, **kw)
    assert open(pp, "rb").read() == open(jp, "rb").read()
    for mine, theirs, c in ((pad, jp, comp), (jad, pp, jcomp)):
        name, got, got_tree = mine.load_baseclass(theirs)
        assert name == "rtree"
        np.testing.assert_array_equal(got, classes)
        assert (got_tree is not None) == tree


def test_itemlist_baseclass_matches_reference(tmp_path):
    comp, jcomp = _sets(tmp_path, nmix=2, seed=3)
    p = str(tmp_path / "bc.base")
    with open(p, "w") as f:
        f.write('~b "twoclass"\n<MMFIDMASK> *\n<PARAMETERS> MIXBASE\n'
                "<NUMCLASSES> 2\n"
                "  <CLASS> 1 {a.state[2-3].mix[1-2]}\n"
                "  <CLASS> 2 {b.state[2-3].mix[1-2]}\n")
    got = pad.load_baseclass(p, hset=comp._hset, comp=comp)
    ref = jad.load_baseclass(p, hset=jcomp._hset, comp=jcomp)
    assert got[0] == ref[0] == "twoclass" and got[2] is ref[2] is None
    np.testing.assert_array_equal(got[1], ref[1])


# -- the cached device scorer -------------------------------------------------


@pytest.fixture(scope="module")
def small_system(tmp_path_factory):
    s = write_system(str(tmp_path_factory.mktemp("adapt_sys")), n_words=6,
                     n_phones=8, n_tied=20, n_mix=2, dim=39, n_utts=2,
                     min_frames=60, max_frames=100, fanout=3, seed=2,
                     binary_mmf=False)
    return s


def _net(s, comp):
    return compile_network(read_slf(s.wdnet), read_dict(s.dict), comp,
                           phone_map=word_internal_phone_map(comp.names))


def test_write_back_drops_the_cached_scorer(small_system):
    s = small_system
    comp = compile_hmmset(load_mmf([s.hmmdefs]))
    net = _net(s, comp)
    x = read_htk_file(s.feats[0]).data
    r0 = decode(net, comp, x, device="cpu")
    cached = scorer_for(comp, "cpu")
    rng = np.random.default_rng(0)
    shift = rng.normal(size=comp.dim).astype(np.float32)
    new_vars = comp.variances * 1.3
    write_back(comp, means=comp.means + shift, variances=new_vars)
    assert scorer_for(comp, "cpu") is not cached
    r1 = decode(net, comp, x, device="cpu")
    fresh = compile_hmmset(load_mmf([s.hmmdefs]))
    write_back(fresh, means=fresh.means + shift, variances=new_vars)
    r2 = decode(_net(s, fresh), fresh, x, device="cpu")
    assert r1.score == r2.score and r1.words == r2.words
    assert r1.score != r0.score
    # an in-place change outside write_back drops it through the helper
    comp.gconsts = comp.gconsts + 1.0
    drop_device_caches(comp)
    r3 = decode(net, comp, x, device="cpu")
    assert r3.score < r1.score


def test_model_params_use_their_own_scorer(small_system):
    s = small_system
    comp = compile_hmmset(load_mmf([s.hmmdefs]))
    net = _net(s, comp)
    x = read_htk_file(s.feats[1]).data
    r0 = decode(net, comp, x, device="cpu")
    cached = scorer_for(comp, "cpu")
    from htk_tpu_torch.tools._xfcli import recomputed_gconsts

    mp = {"means": comp.means + 0.3, "variances": comp.variances * 0.8}
    mp["gconsts"] = recomputed_gconsts(comp, mp["variances"])
    r_mp = decode(net, comp, x, model_params=mp, device="cpu")
    assert scorer_for(comp, "cpu") is cached
    assert decode(net, comp, x, device="cpu").score == r0.score
    adapted = compile_hmmset(load_mmf([s.hmmdefs]))
    write_back(adapted, means=mp["means"], variances=mp["variances"])
    r_wb = decode(net, adapted, x, device="cpu")
    assert r_mp.score == pytest.approx(r_wb.score, rel=1e-6)
    assert r_mp.words == r_wb.words and r_mp.score != r0.score
