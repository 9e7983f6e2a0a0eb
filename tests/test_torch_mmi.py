"""Port MMI training (htk_tpu_torch algo/fb.py's arc options, algo/ebw.py,
tools/hmmirest.py) against htk_tpu's, on the CPU.

Operands come from numpy seeds and go through both packages:

  - `fb_batch` with per-utterance `weights` and `gather_outp` on a padded
    batch of arc composites (rows of t_real = 0 among them): logP within
    1e-5 relative, accumulators at rtol 1e-5 plus 1e-5 of each field's
    scale, as tests/test_torch_fb.py holds the unweighted batch (the
    scatter sums in another order than segment_sum, and the packages'
    float32 matmuls round differently); `loglik_batch` within 1e-5
    relative;
  - `ArcFB.score` and `ArcFB.accumulate` on the same arcs as htk_tpu's
    ArcFB (tests/test_mmi_arcfb.py's set): scores within rel 1e-5, abs
    1e-3, accumulators within rtol 2e-4, atol 2e-3, that test's bounds;
  - a 4,096-wide arc launch with one real row (padding inert): one
    utterance counted, the arc's frames as its occupancy mass, its score
    equal to a narrow launch's;
  - `ebw_update` on equal accumulators: identical arrays (the same
    float64 numpy code);
  - `accumulate_lattice` on one of the chain's HVite -z lattices (below):
    logP within 1e-5 relative, accumulators at ArcFB's bounds;
  - HMMIRest in MMI, MPE and -q modes on tests/test_e2e_latt.py's chain
    (the demo corpus at tests/test_e2e.py's size, trained, decoded into
    HVite -z denominator lattices, aligned into HVite -a numerator
    lattices and timed word references, all by the port on the CPU):
    the MMFs within tests/test_torch_herest.py's tolerances;
  - the MMI criterion that HMMIRest -T 1 prints rises over two
    iterations (tests/test_e2e_latt.py's check).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htk_tpu.algo import fb as jfb
from htk_tpu.algo.composite import build_composite as j_build
from htk_tpu.algo.ebw import EBWConfig as JEBWConfig
from htk_tpu.algo.ebw import ebw_update as j_ebw_update
from htk_tpu.algo.trainer import Trainer as JTrainer
from htk_tpu.algo.trainer import UttData, pad_batch
from htk_tpu.models.hmmset import compile_hmmset as j_compile
from htk_tpu.models.proto import clone_proto, make_proto
from htk_tpu.tools import hmmirest as j_hmmirest
from htk_tpu_torch import convert
from htk_tpu_torch.algo import fb as tfb
from htk_tpu_torch.algo.ebw import EBWConfig, ebw_update
from htk_tpu_torch.algo.fb import Accumulators
from htk_tpu_torch.algo.trainer import Trainer
from htk_tpu_torch.recipes import demo
from htk_tpu_torch.tools import (hbuild, hcompv, hcopy, herest, hmmirest,
                                 hvite)

from _torch_compare import one_torch_thread  # noqa: F401
from test_torch_herest import assert_mmf_close

FIELDS = ("occ", "sum_x", "sum_xx", "wt_occ", "tr")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def sets():
    """tests/test_mmi_arcfb.py's set (4 models, 8 dims, 2 mixtures) in
    both packages."""
    rng = np.random.default_rng(3)
    hs = make_proto(nstates=5, dim=8, parm_kind="USER", nmix=2)
    cl = clone_proto(hs, "proto", ["aa", "iy", "uw", "sil"])
    for h in cl.hmms.values():
        for si in h.states:
            for mp in si.streams[0].mixes:
                mp.mean = rng.normal(size=8).astype(np.float32)
                mp.var = (0.5 + rng.random(8)).astype(np.float32)
                mp.fix_gconst()
    jc = j_compile(cl)
    return jc, convert.compiled_hmmset_from(jc)


PRONS = [("aa",), ("aa", "iy"), ("uw", "iy", "aa"), ("sil",)]


def _arcs(jc, seed, lengths=(40, 57, 33), per_utt=17):
    """Utterance features and arcs (utt, t0, t1, model ids), duplicates
    included, with a weight each."""
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(T, 8)).astype(np.float32) * 0.5
             for T in lengths]
    arcs = []
    for u, T in enumerate(lengths):
        for _ in range(per_utt):
            p = PRONS[int(rng.integers(len(PRONS)))]
            span = int(rng.integers(9 * len(p), 9 * len(p) + 16))
            t0 = int(rng.integers(0, max(1, T - span)))
            arcs.append((u, t0, min(T, t0 + span),
                         tuple(jc.model_id(x) for x in p)))
    return feats, arcs, rng.random(len(arcs)).astype(np.float32)


def _padded(jc, feats, arcs, extra_rows=3):
    """One padded batch of the arcs (pad_batch), with `extra_rows` rows of
    t_real = 0 on composite 0's operands, as ArcFB pads a launch."""
    batch = [UttData(name=str(k), feats=feats[u][t0:t1],
                     hmm=j_build(jc, list(ids)))
             for k, (u, t0, t1, ids) in enumerate(arcs)]
    arrs = pad_batch(batch, jc.n_states)
    for k, v in arrs.items():
        pad = np.repeat(v[:1], extra_rows, axis=0)
        if k == "feats":
            pad = np.zeros_like(pad)
        if k == "t_real":
            pad = np.zeros_like(pad)
        arrs[k] = np.concatenate([v, pad])
    return arrs


def _close(got: Accumulators, ref, rtol, atol=0.0, scale_tol=0.0):
    """Each field within rtol plus atol plus scale_tol of its largest
    magnitude."""
    for name in FIELDS:
        g = getattr(got, name).numpy()
        r = np.asarray(getattr(ref, name))
        tol = atol + scale_tol * float(np.abs(r).max())
        np.testing.assert_allclose(g, r, rtol=rtol, atol=tol, err_msg=name)
    for name in ("total_logp", "total_frames", "n_utts"):
        assert float(getattr(got, name)) == pytest.approx(
            float(np.asarray(getattr(ref, name))), rel=1e-5)


@pytest.mark.parametrize("gather", [True, False])
def test_fb_batch_weights_and_gather_match_jax(sets, gather):
    jc, tc = sets
    feats, arcs, w = _arcs(jc, 5, per_utt=6)
    arrs = _padded(jc, feats, arcs)
    wts = np.concatenate([w, np.ones(3, np.float32)])
    jt, tt = JTrainer(jc), Trainer(tc, device="cpu")
    jp = jt.params()
    keys = ("feats", "t_real", "comp_state", "q_mask", "logA", "a0", "aE",
            "tr_seg", "entry_seg", "exit_seg")
    blocks = tuple(jc.slot_blocks) or None
    jlp, jacc = jfb.fb_batch(
        *(jnp.asarray(arrs[k]) for k in keys), jnp.asarray(wts),
        means=jp[0], variances=jp[1], gconsts=jp[2], state_mix=jp[3],
        state_logw=jp[4], state_sw=jp[5], slot_blocks=blocks,
        n_states=jc.n_states, tr_flat=jt.tr_flat, gather_outp=gather)
    tlp, tacc = tfb.fb_batch(
        *(torch.as_tensor(arrs[k]) for k in keys), torch.as_tensor(wts),
        **tt.params(), slot_blocks=blocks, n_states=tc.n_states,
        tr_flat=tt.tr_flat, gather_outp=gather)
    n = len(arcs)
    np.testing.assert_allclose(tlp.numpy()[:n], np.asarray(jlp)[:n],
                               rtol=1e-5)
    _close(tacc, jacc, 1e-5, scale_tol=1e-5)
    assert float(tacc.n_utts) == n  # the t_real = 0 rows count nothing

    jll = jfb.loglik_batch(
        *(jnp.asarray(arrs[k]) for k in keys[:7]), means=jp[0],
        variances=jp[1], gconsts=jp[2], state_mix=jp[3], state_logw=jp[4],
        state_sw=jp[5], slot_blocks=blocks, gather_outp=gather)
    tll = tfb.loglik_batch(
        *(torch.as_tensor(arrs[k]) for k in keys[:7]), **tt.params(),
        slot_blocks=blocks, gather_outp=gather)
    np.testing.assert_allclose(tll.numpy()[:n], np.asarray(jll)[:n],
                               rtol=1e-5)
    np.testing.assert_allclose(tll.numpy()[:n], tlp.numpy()[:n], rtol=1e-6)
    one = tfb.loglik_utterance(
        *(torch.as_tensor(arrs[k][0]) for k in keys[:7]), **tt.params(),
        slot_blocks=blocks, gather_outp=gather)
    assert float(one) == pytest.approx(float(tll[0]), rel=1e-6)


def _arcfbs(jc, tc, feats, arcs, w, batch):
    """Both packages' ArcFB over the same arcs: (jax ArcFB, its bank, its
    ArcUtts), (port ArcFB, its bank, its ArcUtts), weights by name."""
    sides = []
    for mod, comp, tr in ((j_hmmirest, jc, JTrainer(jc)),
                          (hmmirest, tc, Trainer(tc, device="cpu"))):
        afb = mod.ArcFB(tr, comp, batch=batch)
        utts, wn, seen = [], {}, {}
        for k, (u, t0, t1, ids) in enumerate(arcs):
            afb.composite(ids)
            nm = seen.setdefault((ids, t0, t1, u), f"a{k}")
            if nm == f"a{k}":
                utts.append(mod.ArcUtt(name=nm, utt=u, t0=t0, t1=t1,
                                       ids=ids))
            wn[nm] = wn.get(nm, 0.0) + float(w[k])
        sides.append((afb, afb.load_block(feats), utts))
    return sides, wn


def test_arcfb_matches_jax(sets):
    jc, tc = sets
    feats, arcs, w = _arcs(jc, 7)
    ((ja, jbank, jutts), (ta, tbank, tutts)), wn = _arcfbs(
        jc, tc, feats, arcs, w, 64)
    jll = ja.score(jbank, jutts)
    tll = ta.score(tbank, tutts)
    assert tll.keys() == jll.keys()
    for nm, v in jll.items():
        assert tll[nm] == pytest.approx(v, rel=1e-5, abs=1e-3), nm
    jt = ja.accumulate(jbank, jutts, wn, jfb.zero_accs(
        jc.n_mix, jc.dim, jc.n_states, jc.max_mix, ja.trainer.tr_flat))
    tt = ta.accumulate(tbank, tutts, wn, tfb.zero_accs(
        tc.n_mix, tc.dim, tc.n_states, tc.max_mix, ta.trainer.tr_flat,
        device="cpu"))
    _close(tt, jt, 2e-4, atol=2e-3)
    assert ta.launches["score"] == len(ta._buckets(tutts))


def test_arcfb_padding_rows_inert(sets):
    """One real arc in a launch 4,096 wide (tests/test_mmi_arcfb.py's
    case): the 4,095 rows of t_real = 0 on composite 0 add nothing, and
    the arc scores as it does in a narrow launch."""
    jc, tc = sets
    rng = np.random.default_rng(11)
    feats = [rng.normal(size=(30, 8)).astype(np.float32) * 0.5]
    ids = (tc.model_id("aa"),)
    scores = []
    for batch in (4096, 1):
        afb = hmmirest.ArcFB(Trainer(tc, device="cpu"), tc, batch=batch)
        afb.composite(ids)
        utts = [hmmirest.ArcUtt(name="only", utt=0, t0=2, t1=20, ids=ids)]
        bank = afb.load_block(feats)
        assert afb._buckets(utts)[0][2] == max(32, batch)
        scores.append(afb.score(bank, utts)["only"])
        total = afb.accumulate(bank, utts, {"only": 1.0}, tfb.zero_accs(
            tc.n_mix, tc.dim, tc.n_states, tc.max_mix, afb.trainer.tr_flat,
            device="cpu"))
        assert float(total.n_utts) == 1.0
        assert float(total.total_frames) == 18.0
        assert float(total.occ.sum()) == pytest.approx(18.0, rel=1e-5)
    assert scores[0] == scores[1]


def test_ebw_update_equal(sets):
    jc, tc = sets
    rng = np.random.default_rng(2)
    M, D, S, K = jc.n_mix, jc.dim, jc.n_states, jc.max_mix

    def accs():
        occ = rng.random(M).astype(np.float32) * 20
        return dict(occ=occ,
                    sum_x=(rng.normal(size=(M, D)) * occ[:, None]
                           ).astype(np.float32),
                    sum_xx=((1 + rng.random((M, D))) * occ[:, None] * 2
                            ).astype(np.float32),
                    wt_occ=rng.random((S, K)).astype(np.float32) * 10,
                    tr=np.zeros(1, np.float32),
                    total_logp=np.float32(0), total_frames=np.float32(0),
                    n_utts=np.float32(0))

    num, den = accs(), accs()
    for cfg in ((2.0, 0.0), (1.0, 50.0)):
        got = ebw_update(tc, Accumulators(**num), Accumulators(**den),
                         EBWConfig(e=cfg[0], tau_i=cfg[1]))
        ref = j_ebw_update(jc, jfb.Accumulators(**num),
                           jfb.Accumulators(**den),
                           JEBWConfig(e=cfg[0], tau_i=cfg[1]))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


@pytest.fixture(scope="module")
def mmi_system(tmp_path_factory):
    """tests/test_e2e_latt.py's chain on the port, on the CPU: the demo
    corpus at tests/test_e2e.py's size (6 utterances of 2 words over
    aa/iy), HCopy, HCompV, two HERest iterations, HBuild; then HVite -z
    denominator lattices (-p -8, as that test), HVite -a numerator
    lattices and timed word references."""
    root = tmp_path_factory.mktemp("mmi_sys")
    mp = pytest.MonkeyPatch()
    mp.setenv("HTK_TPU_TORCH_DEVICE", "cpu")
    mp.chdir(root)
    demo.make_corpus(n_train=6, seed=5, words={"A": ["aa"], "I": ["iy"]},
                     n_words=2)
    for d in ("hmm0", "hmm1", "hmm2", "den", "num"):
        os.makedirs(d, exist_ok=True)
    assert hcopy.run(["-C", "cfg_wav", "-S", "copy.scp"]) == 0
    assert hcompv.run(["-C", "cfg", "-f", "0.01", "-m", "-M", "hmm0", "-S",
                       "train.scp", "proto"]) == 0
    demo.clone_monophones()
    for it in (1, 2):
        assert herest.run(["-C", "cfg", "-I", "phones.mlf", "-H",
                           f"hmm{it - 1}/hmmdefs", "-M", f"hmm{it}", "-S",
                           "train.scp", "monophones"]) == 0
    assert hbuild.run(["wlist", "wdnet.slf"]) == 0
    tail = ["-H", "hmm2/hmmdefs", "-S", "train.scp", "dict", "monophones"]
    assert hvite.run(["-w", "wdnet.slf", "-p", "-8", "-z", "lat", "-l",
                      "den", "-i", "rec.mlf", *tail]) == 0
    assert hvite.run(["-a", "-I", "words.mlf", "-z", "lat", "-l", "num",
                      "-y", "lab", "-i", "timed.mlf", *tail]) == 0
    mp.undo()
    return root


MMI_MODES = {
    "MMI": ("", ["-I", "phones.mlf"]),
    "MPE": ("HMMIREST: DISCRMODE = MPE\n", ["-I", "timed.mlf"]),
    "q": ("", ["-q", "num"]),
}


def _hmmirest(run, out, args=(), mmf="hmm2/hmmdefs"):
    return run(["-T", "1", *args, "-r", "den", "-d", "dict", "-H", mmf,
                "-M", out, "-S", "train.scp", "monophones"])


def test_accumulate_lattice_matches_jax(mmi_system):
    from htk_tpu.algo.trainer import Trainer as JT
    from htk_tpu.io.dictionary import read_dict as j_read_dict
    from htk_tpu.io.mmf import load_mmf as j_load_mmf
    from htk_tpu.io.slf import read_slf as j_read_slf
    from htk_tpu_torch.io.dictionary import read_dict
    from htk_tpu_torch.io.htkfeat import read_htk_file
    from htk_tpu_torch.io.slf import read_slf

    root = mmi_system
    jc = j_compile(j_load_mmf([str(root / "hmm2/hmmdefs")]))
    tc = convert.compiled_hmmset_from(jc)
    feats = read_htk_file(str(root / "u0.mfc")).data
    lat = str(root / "den/u0.lat")
    jt, tt = JT(jc), Trainer(tc, device="cpu")
    jtot, jlp = j_hmmirest.accumulate_lattice(
        j_read_slf(lat), j_read_dict(str(root / "dict")), jc, jt, feats,
        100000, "u0", 1.0, jfb.zero_accs(jc.n_mix, jc.dim, jc.n_states,
                                         jc.max_mix, jt.tr_flat))
    ttot, tlp = hmmirest.accumulate_lattice(
        read_slf(lat), read_dict(str(root / "dict")), tc, tt, feats, 100000,
        "u0", 1.0, tfb.zero_accs(tc.n_mix, tc.dim, tc.n_states, tc.max_mix,
                                 tt.tr_flat, device="cpu"))
    assert tlp == pytest.approx(jlp, rel=1e-5)
    _close(ttot, jtot, 2e-4, atol=2e-3)
    assert float(ttot.n_utts) > 0


@pytest.mark.parametrize("mode", list(MMI_MODES))
def test_hmmirest_matches_jax(mmi_system, monkeypatch, mode, capsys):
    monkeypatch.chdir(mmi_system)
    cfg_text, extra = MMI_MODES[mode]
    with open(f"cfg_{mode}", "w") as f:
        f.write("HMMIREST: ACCBLOCK = 4\n" + cfg_text)
    for name, run in (("jax", j_hmmirest.run), ("port", hmmirest.run)):
        assert _hmmirest(run, f"{mode}_{name}",
                         ["-C", f"cfg_{mode}", *extra]) == 0
    text = capsys.readouterr().out
    got, ref = f"{mode}_port/hmmdefs", f"{mode}_jax/hmmdefs"
    assert_mmf_close(got, ref)
    if mode != "MPE":
        crit = [float(x) for x in
                re.findall(r"MMI criterion (-?[0-9.]+)", text)]
        assert len(crit) == 2
        assert crit[1] == pytest.approx(crit[0], rel=1e-5, abs=0.05)


def test_mmi_criterion_rises(mmi_system, monkeypatch, capsys):
    """Each iteration's criterion scores its input model, so crits[i+1] >
    crits[i] says iteration i's update helped."""
    monkeypatch.chdir(mmi_system)
    src, crits = "hmm2/hmmdefs", []
    for it in ("ita", "itb", "itc"):
        assert _hmmirest(hmmirest.run, it, ["-I", "phones.mlf"], src) == 0
        m = re.search(r"MMI criterion (-?[0-9.]+)", capsys.readouterr().out)
        assert m, "criterion line missing under -T 1"
        crits.append(float(m.group(1)))
        src = f"{it}/hmmdefs"
    assert crits[1] > crits[0] and crits[2] > crits[1], crits
