"""Port DNN stack (htk_tpu_torch models/ann.py, algo/nnet.py, tools
hntrainsgd/hnforward, HVite -N and the decoder's state_scores hook)
against htk_tpu's, on the CPU.

The same numpy-seeded inputs go through both packages:

  - `init_ann` (the same numpy generator): identical weights; `splice`:
    identical; `forward`, `ANNModule` and `hybrid_outp`: within atol 1e-5
    (tests/test_ann.py's bound); `save_ann` writes identical bytes and
    each package reads the other's file;
  - three steps of each update rule (momentum, AdaGrad, WEIGHTDECAY with
    GRADCLIP, the sequence criterion's soft targets), lr changing between
    steps: parameters within rtol 1e-5, atol 1e-6 (autograd's and XLA's
    float32 gradients round differently);
  - two epochs under each LRSCHEDULER (NEWBOB, EXPDECAY, LIST, ADAGRAD,
    FIXED; FIXED also with the host-shipped minibatches of a cache over
    4 GiB): weights within TRAIN_ATOL = 1e-5 (the packages part by
    under 5e-8 over 15 epochs of such nets: they visit the same frames in
    the same order), priors identical;
  - the hand-written momentum rule equals torch.optim.SGD's while lr is
    constant and parts from it once lr changes (so it is not to be
    "simplified" into torch.optim);
  - `make_phone_loop`: byte-identical arrays; config #4's loop (Q =
    10,332) and any past the narrow design's shared memory go to the
    fb_scans kernel's wide design; `_gamma_phys` occupancies within 5e-5
    and logP within 1e-5 relative; `mmi_frame_targets` soft
    targets within atol 5e-5 and the objective within 1e-5 relative. Why
    5e-5: each target is a difference of two posteriors exp(alpha + beta
    - logP), whose float32 sums reach a few hundred in magnitude here
    (ulp 3e-5), and the packages' log-softmax scores part in the last
    bits, so the posteriors part by up to 1.8e-5 on the chain's six
    utterances;
  - the tools on tests/test_torch_mmi.py's trained chain: HNTrainSGD
    (cfg_dnn of run_demo.sh, -e 3; and CRITERION = MMI, one iteration
    after one epoch on two utterances)
    writes an ANN within TRAIN_ATOL of htk_tpu's with identical priors and
    target names; HNForward on htk_tpu's ANN file writes .pos files of
    identical headers and data within atol 1e-5 (also -l); HVite -N on
    that file writes a byte-identical rec.mlf, and with -z lattices of
    the same structure with a= within 0.05;
  - the decoder's hook on a uniform-row (LV) net: `decode` with
    state_scores from a carried-across ANN (convert.ann_from) gives the
    same words and times, scores within 1e-5 relative.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htk_tpu.algo import decode as jdec
from htk_tpu.algo import nnet as jn
from htk_tpu.io.mmf import load_mmf as j_load_mmf
from htk_tpu.models import ann as ja
from htk_tpu.models.hmmset import compile_hmmset as j_compile
from htk_tpu.tools import hnforward as j_hnforward
from htk_tpu.tools import hntrainsgd as j_hntrainsgd
from htk_tpu.tools import hvite as j_hvite
from htk_tpu_torch import convert
from htk_tpu_torch.algo import decode as pdec
from htk_tpu_torch.algo import nnet as tn
from htk_tpu_torch.io.htkfeat import read_htk_file
from htk_tpu_torch.io.mlf import MLF, find_labels
from htk_tpu_torch.models import ann as ta
from htk_tpu_torch.ops import fb_scans as fbs
from htk_tpu_torch.ops._cuda import SMEM_MAX
from htk_tpu_torch.recipes import demo
from htk_tpu_torch.tools import hnforward, hntrainsgd, hvite

from _torch_compare import assert_slf_close, one_torch_thread  # noqa: F401
from test_decode import emit_frames
from test_torch_lvdecode import BIG, nets
from test_torch_mmi import mmi_system, sets  # noqa: F401

TRAIN_ATOL = 1e-5
SCHEDULERS = ("NEWBOB", "EXPDECAY", "LIST", "ADAGRAD", "FIXED")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def _anns(in_dim=6, hidden=(16, 12), out=5, context=1, act="SIGMOID",
          seed=0):
    """The same initial ANN in both packages."""
    j = ja.init_ann("t", in_dim, list(hidden), out, context=context,
                    activation=act, seed=seed)
    return j, convert.ann_from(j)


def _assert_anns_close(got, ref, atol=TRAIN_ATOL):
    assert len(got.layers) == len(ref.layers)
    for lg, lr in zip(got.layers, ref.layers):
        assert lg.activation == lr.activation
        np.testing.assert_allclose(lg.weight, lr.weight, rtol=0, atol=atol)
        np.testing.assert_allclose(lg.bias, lr.bias, rtol=0, atol=atol)


def test_init_splice_forward_and_files(tmp_path):
    j, t = _anns()
    t2 = ta.init_ann("t", 6, [16, 12], 5, context=1, activation="SIGMOID",
                     seed=0)
    for a, b, c in zip(j.layers, t.layers, t2.layers):
        np.testing.assert_array_equal(a.weight, c.weight)
        np.testing.assert_array_equal(a.bias, c.bias)
        assert a.activation == c.activation
    x = np.random.default_rng(1).normal(size=(9, 6)).astype(np.float32)
    xt = torch.as_tensor(x)
    for ctx in (0, 1, 3):
        np.testing.assert_array_equal(
            ta.splice(xt, ctx).numpy(),
            np.asarray(ja.splice(jnp.asarray(x), ctx)))
    xs = np.array(ja.splice(jnp.asarray(x), 1))
    acts = [l.activation for l in j.layers]
    ref = np.asarray(ja.forward(ja.ann_params(j), acts, jnp.asarray(xs)))
    got = ta.forward(ta.ann_params(t), acts, torch.as_tensor(xs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    with torch.no_grad():
        mod = ta.ANNModule(t)(torch.as_tensor(xs)).numpy()
    np.testing.assert_array_equal(mod, got)
    for obj, path in ((j, "ann_j"), (t, "ann_t")):
        obj.target_priors = np.full(5, 0.2, np.float32)
        obj.target_names = [f"S{i}" for i in range(5)]
    ja.save_ann(j, str(tmp_path / "ann_j"))
    ta.save_ann(t, str(tmp_path / "ann_t"))
    assert (tmp_path / "ann_j").read_bytes() == \
        (tmp_path / "ann_t").read_bytes()
    back = ta.load_ann(str(tmp_path / "ann_j"))
    assert back.context == 1 and back.target_names == j.target_names
    _assert_anns_close(back, ja.load_ann(str(tmp_path / "ann_t")), atol=0)


def test_hybrid_outp_matches_jax():
    j, t = _anns(out=7, act="RELU")
    pri = np.random.default_rng(4).dirichlet(np.ones(7)).astype(np.float32)
    j.target_priors = t.target_priors = pri
    x = np.random.default_rng(5).normal(size=(30, 6)).astype(np.float32)
    for scale in (1.0, 0.0):
        np.testing.assert_allclose(
            tn.hybrid_outp(t, x, scale, device="cpu").numpy(),
            np.asarray(jn.hybrid_outp(j, x, scale)), rtol=0, atol=1e-5)


RULES = {
    "momentum": dict(wd=0.0, clip=0.0),
    "adagrad": dict(wd=0.0, clip=0.0),
    "wd_clip": dict(wd=1e-2, clip=0.05),
    "soft": dict(wd=0.0, clip=0.0),
}


@pytest.mark.parametrize("rule", list(RULES))
def test_update_rule_steps_match_jax(rule):
    j, t = _anns(act="RELU")
    rng = np.random.default_rng(8)
    x = rng.normal(size=(40, 18)).astype(np.float32)
    y = rng.integers(0, 5, 40).astype(np.int32)
    z = rng.normal(size=(40, 5)).astype(np.float32)
    soft = np.eye(5, dtype=np.float32)[y] - np.exp(z) / np.exp(z).sum(
        1, keepdims=True)
    acts = tuple(l.activation for l in j.layers)
    jp = ja.ann_params(j)
    jv = [tuple(jnp.zeros_like(a) for a in pair) for pair in jp]
    model = ta.ANNModule(t)
    tv = [torch.zeros_like(p) for p in model.parameters()]
    kw = RULES[rule]
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    for lr in (0.1, 0.05, 0.05):
        if rule == "adagrad":
            jp, jv, _c, _a = jn._sgd_step_adagrad(
                jp, jv, jnp.asarray(x), jnp.asarray(y), acts, lr, 1.0, **kw)
            tn._sgd_step_adagrad(model, tv, xt, yt, lr, 1.0, **kw)
        elif rule == "soft":
            jp, jv, _l = jn._sgd_step_soft(
                jp, jv, jnp.asarray(x), jnp.asarray(soft), acts, lr, 0.5,
                **kw)
            tn._sgd_step_soft(model, tv, xt, torch.as_tensor(soft), lr, 0.5,
                              **kw)
        else:
            jp, jv, _c, _a = jn._sgd_step(
                jp, jv, jnp.asarray(x), jnp.asarray(y), acts, lr, 0.5, **kw)
            tn._sgd_step(model, tv, xt, yt, lr, 0.5, **kw)
        for (jw, jb), (tw, tb) in zip(jp, model.params()):
            np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(tb.detach().numpy(), np.asarray(jb),
                                       rtol=1e-5, atol=1e-6)


def test_momentum_rule_is_not_torch_optim_sgd():
    """HNTrainSGD's v = m*v - lr*g; p += v equals torch.optim.SGD's
    buf = m*buf + g; p -= lr*buf only while lr stays put."""
    _j, t = _anns(act="RELU")
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.normal(size=(40, 18)).astype(np.float32))
    y = torch.as_tensor(rng.integers(0, 5, 40).astype(np.int32))
    ours = ta.ANNModule(t)
    vel = [torch.zeros_like(p) for p in ours.parameters()]
    theirs = ta.ANNModule(t)
    opt = torch.optim.SGD(theirs.parameters(), lr=0.1, momentum=0.5)
    gaps = []
    for lr in (0.1, 0.1, 0.1, 0.02, 0.02):
        tn._sgd_step(ours, vel, x, y, lr, 0.5)
        for g in opt.param_groups:
            g["lr"] = lr
        opt.zero_grad()
        ce, _acc = tn._ce(theirs, x, y)
        ce.backward()
        opt.step()
        gaps.append(max(float((a - b).detach().abs().max()) for a, b in
                        zip(ours.parameters(), theirs.parameters())))
    assert max(gaps[:3]) < 1e-6, gaps
    assert gaps[4] > 100 * max(gaps[:3]) and gaps[4] > 1e-4, gaps


def _data(n=600, in_dim=18, k=5, seed=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n).astype(np.int32)
    centers = rng.normal(size=(k, in_dim)) * 1.5
    x = (centers[y] + rng.normal(size=(n, in_dim))).astype(np.float32)
    return x, y


@pytest.mark.parametrize("sched", SCHEDULERS + ("FIXED-shipped",))
def test_epochs_match_jax(sched, monkeypatch):
    name = sched.split("-")[0]
    if sched.endswith("shipped"):
        monkeypatch.setattr(tn, "CACHE_BYTES", 0)
    x, y = _data()
    j, t = _anns(act="RELU")
    kw = dict(lr=0.05, n_epochs=2, batch_size=64, scheduler=name,
              lr_list=[0.08, 0.03], newbob_ramp=10.0, weight_decay=1e-3,
              seed=4)
    jn.train_ann(j, x, y, jn.SGDConfig(**kw))
    seen = []
    tn.train_ann(t, x, y, tn.SGDConfig(**kw), device="cpu",
                 on_epoch=lambda *a: seen.append(a[1]))
    _assert_anns_close(t, j)
    np.testing.assert_array_equal(t.target_priors, j.target_priors)
    assert len(seen) == 2
    if name == "EXPDECAY":
        assert seen == [0.05, 0.025]
    if name == "LIST":
        assert seen == [0.08, 0.03]


@pytest.fixture(scope="module")
def chain_comps(mmi_system):
    """The trained demo-chain set (3 monophones) in both packages, and
    each utterance's features and phone transcription."""
    jc = j_compile(j_load_mmf([str(mmi_system / "hmm2/hmmdefs")]))
    mlfs = [MLF.load(str(mmi_system / "phones.mlf"))]
    utts = []
    for i in range(6):
        path = str(mmi_system / f"u{i}.mfc")
        f = read_htk_file(path).data
        names = [lab.name for lab in find_labels(path, mlfs).labels]
        utts.append((np.asarray(f, np.float32), names))
    return jc, convert.compiled_hmmset_from(jc), utts


def test_make_phone_loop_byte_equal(sets, chain_comps):
    for jc, tc in (sets, chain_comps[:2]):
        for lp in (None, -2.5):
            got = tn.make_phone_loop(tc, lp)
            ref = jn.make_phone_loop(jc, lp)
            for g, r in zip(got, ref):
                assert g.dtype == r.dtype
                np.testing.assert_array_equal(g, r)


def test_phone_loop_fits_the_scan_kernel():
    """config #4's phone loop (3,444 models of 3 emitting states: Q =
    10,332) runs on the fb_scans kernel's wide design, and so does a loop
    past 19,359 states, where the narrow design's shared memory ends (12 Q
    + 132 bytes over 227 KB). The narrow design, forced, still takes the
    phone loop (its lists read from global memory) and refuses such a Q
    with a message; the dispatch never sends it there, nor to the plain
    version."""
    assert fbs.fb_plan(1, 504, 10332, None) == "wide"
    assert fbs.smem_bytes(10332, 1, 0) <= SMEM_MAX
    assert fbs.scan_smem(10332, False) == SMEM_MAX
    fbs.scan_smem(19359, False)
    with pytest.raises(ValueError, match="do not fit"):
        fbs.scan_smem(19360, False)
    for Q in (19360, 3 * 6451, 60000):
        assert fbs.fb_plan(1, 504, Q, None) == "wide"


def test_gamma_phys_matches_jax(chain_comps):
    """The port's _gamma_phys (one fb_scans call, xi=False) against
    htk_tpu's (forward_scan and backward_scan) on the chain set's phone
    loop with random scores: occupancies within 5e-5, logP within 1e-5
    relative (the module docstring's tolerances)."""
    jc, tc, utts = chain_comps
    loop_j, loop_t = jn.make_phone_loop(jc), tn.make_phone_loop(tc)
    rng = np.random.default_rng(8)
    for T in (1, 37, 90):
        scores = (rng.normal(size=(T, jc.n_states)) * 2).astype(np.float32)
        gj, lj = jn._gamma_phys(jnp.asarray(scores), *loop_j, jc.n_states)
        gt, lt = tn._gamma_phys(torch.as_tensor(scores), *loop_t,
                                tc.n_states)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                                   atol=5e-5)
        assert float(lt) == pytest.approx(float(lj), rel=1e-5)


def test_mmi_frame_targets_match_jax(chain_comps):
    jc, tc, utts = chain_comps
    j, t = _anns(in_dim=39, hidden=(24,), out=jc.n_states, context=1,
                 act="RELU", seed=2)
    pri = np.random.default_rng(6).dirichlet(np.ones(jc.n_states))
    j.target_priors = t.target_priors = pri.astype(np.float32)
    loop_j, loop_t = jn.make_phone_loop(jc), tn.make_phone_loop(tc)
    for feats, names in utts[:2]:
        cj, oj = jn.mmi_frame_targets(j, jc, feats, names, loop_j)
        ct, ot = tn.mmi_frame_targets(t, tc, feats, names, loop_t,
                                      device="cpu")
        np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=5e-5)
        assert ot == pytest.approx(oj, rel=1e-5)


@pytest.fixture(scope="module")
def dnn_dir(mmi_system):
    """htk_tpu's HNTrainSGD on the chain (run_demo.sh's cfg_dnn, -e 3):
    the ANN file the decode and forward comparisons read."""
    mp = pytest.MonkeyPatch()
    mp.chdir(mmi_system)
    with open("cfg_dnn", "w") as f:
        f.write(demo.CFG_DNN)
    assert j_hntrainsgd.run(["-C", "cfg_dnn", "-e", "3", "-I", "phones.mlf",
                             "-H", "hmm2/hmmdefs", "-M", "dnn_jax", "-S",
                             "train.scp", "monophones"]) == 0
    mp.undo()
    return mmi_system


@pytest.mark.parametrize("crit", ["CE", "MMI"])
def test_hntrainsgd_matches_jax(dnn_dir, monkeypatch, crit):
    monkeypatch.chdir(dnn_dir)
    ref = "dnn_jax/ann"
    args = ["-C", "cfg_dnn", "-e", "3", "-I", "phones.mlf", "-H",
            "hmm2/hmmdefs", "-S", "train.scp", "monophones"]
    if crit == "MMI":
        # two utterances and one CE epoch keep htk_tpu's per-length
        # compiles few
        with open("cfg_seq", "w") as f:
            f.write(demo.CFG_DNN + "HNTRAINSGD: CRITERION = MMI\n"
                    "HNTRAINSGD: SEQITERS = 1\n")
        with open("train2.scp", "w") as f:
            f.write("u0.mfc\nu1.mfc\n")
        args[1], args[3], args[-2] = "cfg_seq", "1", "train2.scp"
        assert j_hntrainsgd.run(["-M", "seq_jax", *args]) == 0
        ref = "seq_jax/ann"
    assert hntrainsgd.run(["-M", f"{crit}_port", *args]) == 0
    got, want = ta.load_ann(f"{crit}_port/ann"), ta.load_ann(ref)
    _assert_anns_close(got, want)
    np.testing.assert_array_equal(got.target_priors, want.target_priors)
    assert got.target_names == want.target_names and got.context == 2


@pytest.mark.parametrize("logpost", [False, True])
def test_hnforward_matches_jax(dnn_dir, monkeypatch, logpost):
    monkeypatch.chdir(dnn_dir)
    flag = ["-l"] if logpost else []
    for name, run in (("jax", j_hnforward.run), ("port", hnforward.run)):
        assert run(["-N", "dnn_jax/ann", *flag, "-M", f"pos_{name}", "-S",
                    "train.scp", "monophones"]) == 0
    for i in range(6):
        g = read_htk_file(f"pos_port/u{i}.pos")
        r = read_htk_file(f"pos_jax/u{i}.pos")
        assert (g.samp_period, g.parm_kind) == (r.samp_period, r.parm_kind)
        np.testing.assert_allclose(g.data, r.data, rtol=0, atol=1e-5)


def test_hvite_N_matches_jax(dnn_dir, monkeypatch):
    """HVite -N on a general word network: rec.mlf byte-identical, and
    with -z the lattices of the same structure (a= within 0.05)."""
    monkeypatch.chdir(dnn_dir)
    for name, run in (("jax", j_hvite.run), ("port", hvite.run)):
        os.makedirs(f"latN_{name}", exist_ok=True)
        assert run(["-w", "wdnet.slf", "-p", "-8", "-N", "dnn_jax/ann",
                    "-i", f"recN_{name}.mlf", "-H", "hmm2/hmmdefs", "-S",
                    "train.scp", "dict", "monophones"]) == 0
        assert run(["-w", "wdnet.slf", "-p", "-8", "-N", "dnn_jax/ann",
                    "-z", "lat", "-l", f"latN_{name}", "-i",
                    f"recNz_{name}.mlf", "-H", "hmm2/hmmdefs", "-S",
                    "train.scp", "dict", "monophones"]) == 0
    with open("recN_port.mlf", "rb") as f, open("recN_jax.mlf", "rb") as g:
        assert f.read() == g.read()
    with open("recNz_port.mlf", "rb") as f, open("recNz_jax.mlf", "rb") as g:
        assert f.read() == g.read()
    lats = sorted(os.listdir("latN_jax"))
    assert sorted(os.listdir("latN_port")) == lats and len(lats) == 6
    for nm in lats:
        with open(f"latN_port/{nm}") as f, open(f"latN_jax/{nm}") as g:
            assert_slf_close(f.read(), g.read())


def test_decode_state_scores_uniform_net_matches_jax():
    """The hook on a uniform-row (LV) net: both decoders on the scores of
    the same (carried-across) ANN give the same words and times."""
    jc, jnet, pc, pnet = nets(BIG)
    assert jnet.uniform_width and pnet.uniform_width
    j, t = _anns(in_dim=3, hidden=(16,), out=jc.n_states, context=1,
                 act="RELU", seed=5)
    x, y = _data(n=400, in_dim=9, k=jc.n_states, seed=7)
    jn.train_ann(j, x, y, jn.SGDConfig(lr=0.1, n_epochs=3, batch_size=32))
    t = convert.ann_from(j)
    feats = emit_frames(["sil", "aa", "iy", "aa", "sil", "iy"], seed=3)
    js = np.asarray(jn.hybrid_outp(j, feats))
    ts = tn.hybrid_outp(t, feats, device="cpu")
    rj = jdec.decode(jnet, jc, feats, 2.0, -1.0, state_scores=js)
    rp = pdec.decode(pnet, pc, feats, 2.0, -1.0, state_scores=ts,
                     device="cpu")
    assert rj is not None and rp is not None
    assert rp.words == rj.words and rp.times == rj.times
    assert rp.score == pytest.approx(rj.score, rel=1e-5)
