"""Port HVite -w recognition (htk_tpu_torch) against htk_tpu's, on the CPU.

A tiny system (6 words, 8 phones, 20 tied 2-mixture states, 39 dims, 6
utterances) is written with the port's generator (htk_tpu_torch/synth.py),
and both packages' HVite run on the same files: the two rec.mlf must be
byte-identical, through the batched buckets (HREC: DECODEBATCH = 8) and
through the per-utterance path (a single file).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from htk_tpu.io.mmf import save_mmf as j_save_mmf
from htk_tpu.tools import hvite as jax_hvite
from htk_tpu_torch.synth import word_accuracy, write_system
from htk_tpu_torch.tools import hvite as torch_hvite
from htk_tpu_torch.utils.logmath import LZERO

from _torch_compare import one_torch_thread  # noqa: F401
from test_discrete import discrete_set

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The port's tools run on the card unless the CPU is asked for."""
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hvite_sys"))
    s = write_system(root, n_words=6, n_phones=8, n_tied=20, n_mix=2,
                     dim=39, n_utts=6, min_frames=60, max_frames=150,
                     fanout=3, seed=1, binary_mmf=False)
    cfg = os.path.join(root, "batch.cfg")
    with open(cfg, "w") as f:
        f.write("HREC: DECODEBATCH = 8\n")
    return s, cfg


def _argv(s, mlf, files, cfg=None):
    """HVite arguments: `files` is "scp" (-S test.scp) or a list."""
    argv = ["-w", s.wdnet, "-H", s.hmmdefs, "-i", mlf, "-s", "2.0",
            "-p", "-3.0"]
    if cfg:
        argv += ["-C", cfg]
    if files == "scp":
        return argv + ["-S", s.scp, s.dict, s.hmmlist]
    return argv + [s.dict, s.hmmlist] + list(files)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_batched_mlf_byte_identical(system, tmp_path):
    s, cfg = system
    ref, got = str(tmp_path / "jax.mlf"), str(tmp_path / "torch.mlf")
    assert jax_hvite.run(_argv(s, ref, "scp", cfg)) == 0
    assert torch_hvite.run(_argv(s, got, "scp", cfg)) == 0
    assert _read(got) == _read(ref)
    from htk_tpu_torch.io.mlf import MLF

    m = MLF.load(got)
    hyps = [m.lookup(f"*/{os.path.basename(p)[:-4]}.rec").names()
            for p in s.feats]
    assert all(hyps)
    assert word_accuracy(s.transcripts, hyps) > 50.0


def test_single_file_mlf_byte_identical(system, tmp_path):
    s, _cfg = system
    ref, got = str(tmp_path / "jax1.mlf"), str(tmp_path / "torch1.mlf")
    one = [s.feats[2]]
    assert jax_hvite.run(_argv(s, ref, one)) == 0
    assert torch_hvite.run(_argv(s, got, one)) == 0
    assert _read(got) == _read(ref)
    assert b".rec" in _read(got)


def test_decode_batch_equals_per_utterance(system):
    """Padded buckets finalise every utterance at its own length."""
    from htk_tpu_torch.algo.decode import decode, decode_batch
    from htk_tpu_torch.algo.net import compile_network, word_internal_phone_map
    from htk_tpu_torch.io.dictionary import read_dict
    from htk_tpu_torch.io.htkfeat import read_htk_file
    from htk_tpu_torch.io.mmf import load_mmf
    from htk_tpu_torch.io.slf import read_slf
    from htk_tpu_torch.models.hmmset import compile_hmmset

    s, _cfg = system
    comp = compile_hmmset(load_mmf([s.hmmdefs]))
    net = compile_network(read_slf(s.wdnet), read_dict(s.dict), comp,
                          phone_map=word_internal_phone_map(comp.names))
    feats = [read_htk_file(p).data for p in s.feats[:4]]
    rs = decode_batch(net, comp, feats, 2.0, -3.0, pad_to=64, device="cpu")
    for f, r in zip(feats, rs):
        one = decode(net, comp, f, 2.0, -3.0, device="cpu")
        assert (r.words, r.times) == (one.words, one.times)
        assert abs(r.score - one.score) < 1e-3


@pytest.mark.parametrize("hook", ["hybrid", "discrete", "model_params"])
def test_decode_batch_hooks_equal_reference(system, hook):
    """decode_batch's hybrid hook (`state_scores_list`: ANN-style scores
    of either sign, and a discrete set's table lookups) and adaptation
    hook (`model_params`) on a general net: every utterance of a padded
    bucket decodes as htk_tpu's own `decode` of it under the same hook."""
    from htk_tpu.algo import decode as jdec
    from htk_tpu.algo.net import compile_network as j_net
    from htk_tpu.algo.net import word_internal_phone_map as j_pmap
    from htk_tpu.io.dictionary import read_dict as j_dict
    from htk_tpu.io.mmf import load_mmf as j_mmf
    from htk_tpu.io.slf import read_slf as j_slf
    from htk_tpu.models.hmmset import compile_hmmset as j_comp
    from htk_tpu_torch.algo.decode import decode_batch
    from htk_tpu_torch.algo.net import compile_network, word_internal_phone_map
    from htk_tpu_torch.io.dictionary import read_dict
    from htk_tpu_torch.io.htkfeat import read_htk_file
    from htk_tpu_torch.io.mmf import load_mmf
    from htk_tpu_torch.io.slf import read_slf
    from htk_tpu_torch.models.hmmset import compile_hmmset
    from htk_tpu_torch.tools._xfcli import recomputed_gconsts

    s, _cfg = system
    jc = j_comp(j_mmf([s.hmmdefs]))
    jn = j_net(j_slf(s.wdnet), j_dict(s.dict), jc,
               phone_map=j_pmap(jc.names))
    pc = compile_hmmset(load_mmf([s.hmmdefs]))
    pn = compile_network(read_slf(s.wdnet), read_dict(s.dict), pc,
                         phone_map=word_internal_phone_map(pc.names))
    feats = [read_htk_file(p).data for p in s.feats[:4]]
    rng = np.random.default_rng(3)
    if hook == "model_params":
        mp = {"means": pc.means + 0.3, "variances": pc.variances * 0.8}
        mp["gconsts"] = recomputed_gconsts(pc, mp["variances"])
        got = decode_batch(pn, pc, feats, 2.0, -3.0, pad_to=64,
                           model_params=mp, device="cpu")
        kws = [{"model_params": mp}] * len(feats)
    else:
        if hook == "hybrid":
            scores = [rng.normal(0.0, 3.0, (len(f), pc.n_states)).astype(
                np.float32) for f in feats]
        else:
            table = np.log(rng.dirichlet(np.ones(16), pc.n_states)).astype(
                np.float32)
            scores = [np.ascontiguousarray(
                table[:, rng.integers(0, 16, len(f))].T) for f in feats]
        got = decode_batch(pn, pc, feats, 2.0, -3.0, pad_to=64,
                           state_scores_list=scores, device="cpu")
        kws = [{"state_scores": sc} for sc in scores]
    for f, r, kw in zip(feats, got, kws):
        ref = jdec.decode(jn, jc, f, 2.0, -3.0, **kw)
        assert r is not None and ref is not None
        assert (r.words, r.times) == (list(ref.words), list(ref.times))
        assert r.score == pytest.approx(ref.score, rel=1e-5)


def _final_records_loop(net, v, wn, wt, kind=None):
    """The Python loop `_final_records` was, over a sort of `kind`: each
    state in descending order of v + aE, taken where it beats its node's
    best so far (LZERO at the start)."""
    nos = np.asarray(net.node_of_chain[net.chain_of])
    e_state = np.asarray(v) + np.asarray(net.aE)
    WE_fin = np.full(net.n_nodes, LZERO, np.float64)
    pwn_fin = np.full(net.n_nodes, -1, np.int64)
    pwt_fin = np.full(net.n_nodes, -1, np.int64)
    for st in np.argsort(-e_state, kind=kind):
        i = nos[st]
        if e_state[st] > WE_fin[i]:
            WE_fin[i] = e_state[st]
            pwn_fin[i] = wn[st]
            pwt_fin[i] = wt[st]
    return WE_fin, pwn_fin, pwt_fin


@pytest.mark.parametrize("kind", [None, "stable"])
def test_final_records_equal_the_loop(kind):
    """The vectorised word-end finals against the loop they replaced, on
    a net with planted ties (states of one node at the same v + aE with
    different records), states at and below LZERO, and nodes with no
    live state; under the stable sort a tie goes to the lowest state."""
    from types import SimpleNamespace

    from htk_tpu_torch.algo.decode import _final_records

    rng = np.random.default_rng(11)
    Nc, Nn = 300, 60
    chain_of = np.repeat(np.arange(Nc), 4)
    Ns = chain_of.size
    net = SimpleNamespace(
        node_of_chain=rng.integers(0, Nn - 3, Nc), chain_of=chain_of,
        aE=np.where(rng.random(Ns) < 0.2, LZERO,
                    rng.integers(-2, 1, Ns)).astype(np.float32),
        n_nodes=Nn)
    v = rng.integers(-6, 0, Ns).astype(np.float32)  # ties galore
    v[rng.random(Ns) < 0.15] = LZERO
    # node Nn - 3: one chain, its states at v + aE == LZERO exactly
    net.node_of_chain[0] = Nn - 3
    v[:4], net.aE[:4] = LZERO, 0.0
    wn = rng.permutation(Ns).astype(np.int32)
    wt = rng.integers(0, 500, Ns).astype(np.int32)
    got = _final_records(net, v, wn, wt, kind=kind)
    ref = _final_records_loop(net, v, wn, wt, kind=kind)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    nos = net.node_of_chain[chain_of]
    e = v + net.aE
    live = [i for i in range(Nn) if (e[nos == i] > LZERO).any()]
    assert live and Nn - 3 not in live
    tied = [i for i in live
            if (e[nos == i] == e[nos == i].max()).sum() > 1]
    assert tied
    if kind == "stable":
        for i in live:
            first = np.flatnonzero((nos == i) & (e == e[nos == i].max()))[0]
            assert got[1][i] == wn[first]


def test_convert_carries_jax_objects(system):
    """convert.py rebuilds the JAX package's compiled set and network as
    the port's, equal to the port's own compilation of the same files."""
    from htk_tpu.algo.net import compile_network as j_net
    from htk_tpu.algo.net import word_internal_phone_map as j_pmap
    from htk_tpu.io.dictionary import read_dict as j_dict
    from htk_tpu.io.mmf import load_mmf as j_mmf
    from htk_tpu.io.slf import read_slf as j_slf
    from htk_tpu.models.hmmset import compile_hmmset as j_comp
    from htk_tpu_torch import convert
    from htk_tpu_torch.algo.net import compile_network, word_internal_phone_map
    from htk_tpu_torch.io.dictionary import read_dict
    from htk_tpu_torch.io.mmf import load_mmf
    from htk_tpu_torch.io.slf import read_slf
    from htk_tpu_torch.models.hmmset import compile_hmmset

    s, _cfg = system
    jc = j_comp(j_mmf([s.hmmdefs]))
    jn = j_net(j_slf(s.wdnet), j_dict(s.dict), jc,
               phone_map=j_pmap(jc.names))
    pc = compile_hmmset(load_mmf([s.hmmdefs]))
    pn = compile_network(read_slf(s.wdnet), read_dict(s.dict), pc,
                         phone_map=word_internal_phone_map(pc.names))
    cc, cn = convert.compiled_hmmset_from(jc), convert.decode_network_from(jn)
    for k in ("means", "variances", "gconsts", "state_mix", "state_logw",
              "log_transp", "model_states"):
        np.testing.assert_array_equal(getattr(cc, k), getattr(pc, k))
    assert cc.names == pc.names and cc.slot_blocks == pc.slot_blocks
    for k in ("comp_state", "band", "a0", "aE", "chain_of", "node_of_chain",
              "chain_pron_prob", "trans", "start_entry", "end_exit"):
        np.testing.assert_array_equal(getattr(cn, k), getattr(pn, k))
    assert cn.node_words == pn.node_words and cn.n_nodes == pn.n_nodes
    scorer, d = convert.to_device(cc, cn, "cpu")
    assert torch.equal(d["trans"], torch.as_tensor(pn.trans))
    assert scorer.Wt.shape == (2 * pc.dim, pc.n_mix)


@pytest.mark.parametrize("opt", [["-k", "-J", "xf"], ["-J", "xf"],
                                 ["DISCRETE"]])
def test_unported_options_raise_numbered_error(system, tmp_path, opt,
                                               capsys, monkeypatch):
    """Recognition with a discrete set, refused with HError 3290 until
    the discrete module was ported, now decodes as the reference does:
    tests/test_torch_discrete.py's codeword files over a word loop of
    A and B, each file's table-lookup scores through the decoder's
    state_scores_list hook, rec.mlf byte-identical. Input
    transforms (-J, and -k), refused until the adaptation module was
    ported, now decode as the reference does: a global MLLRMEAN TMF under
    -J (-k adds nothing, the MMF has no ~a), rec.mlf byte-identical."""
    s, _cfg = system
    if opt == ["DISCRETE"]:
        from htk_tpu_torch.algo import decode as pdec
        from test_torch_discrete import write_discrete_corpus

        root = str(tmp_path)
        write_discrete_corpus(root)
        mmf = os.path.join(root, "discrete")
        j_save_mmf(discrete_set(), mmf)
        calls = []
        real = pdec.decode_batch
        monkeypatch.setattr(torch_hvite, "decode_batch", lambda *a, **k: (
            calls.extend(x.shape for x in k["state_scores_list"]),
            real(*a, **k))[1])
        outs = []
        for run, tag in ((jax_hvite.run, "j"), (torch_hvite.run, "p")):
            mlf = os.path.join(root, f"rec_{tag}.mlf")
            assert run(["-w", os.path.join(root, "wdnet.slf"), "-H", mmf,
                        "-i", mlf, "-S", os.path.join(root, "train.scp"),
                        os.path.join(root, "dict"),
                        os.path.join(root, "list")]) == 0
            outs.append(_read(mlf))
        assert outs[0] == outs[1]
        assert len(calls) == 6
        return
    from htk_tpu_torch.algo.adapt import Transform, save_tmf

    xf_dir = tmp_path / "xf"
    xf_dir.mkdir()
    rng = np.random.default_rng(4)
    save_tmf(str(xf_dir / "global.tmf"), "global", Transform(
        kind="MLLRMEAN", A=np.eye(39) + 0.02 * rng.normal(size=(39, 39)),
        b=0.1 * rng.normal(size=39)))
    opt = [str(xf_dir) if o == "xf" else o for o in opt]
    outs = []
    for run, tag in ((torch_hvite.run, "p"), (jax_hvite.run, "j")):
        mlf = str(tmp_path / f"{tag}.mlf")
        assert run(opt + _argv(s, mlf, "scp")) == 0
        outs.append(_read(mlf))
    assert outs[0] == outs[1]


def test_uniform_network_raises_numbered_error():
    """Uniform-row nets decode, dense and factored; adaptive-exact top-A
    on a factored net whose tables lack the successor lists raises HError
    8526, as the reference's own check does (htk_tpu/algo/decode.py:
    411-417)."""
    from htk_tpu_torch.algo.decode import decode
    from htk_tpu_torch.algo.net import DecodeNetwork
    from htk_tpu_torch.utils.errors import HTKError

    z = np.zeros(1, np.float32)
    i = np.zeros(1, np.int32)
    net = DecodeNetwork(comp_state=i, band=z[None], a0=z, aE=z, chain_of=i,
                        node_of_chain=i, chain_pron_prob=z, node_words=["a"],
                        node_out=[None], trans=np.zeros((0, 0), np.float32),
                        start_entry=z, end_exit=z, uniform_width=1,
                        xw_backoff={"bow": z, "uni": z, "buckets": [],
                                    "inv": np.zeros(1, np.int32),
                                    "succ_j": None})
    with pytest.raises(HTKError) as e:
        decode(net, None, np.zeros((3, 39), np.float32), max_active=-4,
               device="cpu")
    assert e.value.code == 8526


def test_port_imports_no_jax_and_no_htk_tpu():
    """Every module of the port, and chip_smoke.py, imported in a fresh
    interpreter (the pytest process has jax loaded, by conftest), pulls in
    neither jax nor htk_tpu."""
    code = ("import importlib, pkgutil, sys, htk_tpu_torch, chip_smoke\n"
            "mods = [m.name for m in pkgutil.walk_packages("
            "htk_tpu_torch.__path__, 'htk_tpu_torch.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "need = {'htk_tpu_torch.tools.herest', "
            "'htk_tpu_torch.ops.fb_scans', 'htk_tpu_torch.algo.trainer', "
            "'htk_tpu_torch.parallel.acc_files', "
            "'htk_tpu_torch.algo.lvnet', 'htk_tpu_torch.io.lm', "
            "'htk_tpu_torch.ops.maxplus', 'htk_tpu_torch.ops.tropical', "
            "'htk_tpu_torch.ops.xw_gather', 'htk_tpu_torch.ops.xw_route', "
            "'htk_tpu_torch.ops.xw_window', 'htk_tpu_torch.ops.dsp', "
            "'htk_tpu_torch.io.wavefile', 'htk_tpu_torch.io.vq', "
            "'htk_tpu_torch.models.proto', 'htk_tpu_torch.models.itemlist', "
            "'htk_tpu_torch.algo.tree', 'htk_tpu_torch.algo.kmeans', "
            "'htk_tpu_torch.algo.latops', 'htk_tpu_torch.tools.hcopy', "
            "'htk_tpu_torch.tools.hcompv', 'htk_tpu_torch.tools.hled', "
            "'htk_tpu_torch.tools.hhed', 'htk_tpu_torch.tools.hbuild', "
            "'htk_tpu_torch.tools.hresults', "
            "'htk_tpu_torch.algo.viterbi', 'htk_tpu_torch.tools.hinit', "
            "'htk_tpu_torch.tools.hrest', 'htk_tpu_torch.tools.hdecode', "
            "'htk_tpu_torch.tools.lbuild', 'htk_tpu_torch.tools.hlrescore', "
            "'htk_tpu_torch.recipes.demo', 'htk_tpu_torch.recipes.speech', "
            "'htk_tpu_torch.io.audio', 'htk_tpu_torch.ops.stream', "
            "'htk_tpu_torch.algo.stream_decode', 'htk_tpu_torch.utils.graf', "
            "'htk_tpu_torch.parallel.mesh', 'htk_tpu_torch.parallel.timeshard', "
            "'htk_tpu_torch.parallel.dryrun', "
            + ", ".join(f"'htk_tpu_torch.tools.{t}'" for t in (
                "hlist", "hlstats", "hdman", "hsgen", "hsmooth", "hparse",
                "hlmcopy", "lgram", "lmerge", "lplex", "lsubset", "cluster",
                "hslab")) + "}\n"
            "assert need <= set(mods), need - set(mods)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'htk_tpu' or "
            "m.startswith('htk_tpu.')]\n"
            "print(len(mods), bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
