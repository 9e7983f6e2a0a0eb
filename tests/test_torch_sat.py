"""The port's adaptation tools against htk_tpu's, on the CPU: HERest -K
and -a -J (and MAP), HVite and HDecode -J/-h/-k, HHEd RC and XF, and the
full recipe's corpus writer.

Each tool of both packages runs on the same files, on the fixtures of
tests/test_sat.py (4-dim USER features, two speakers with a per-speaker
bias and CMLLR input transforms that remove it) and tests/test_e2e_adapt.py
(a 6-utterance MFCC_E_D_A corpus, monophones trained by the port here):

  - HERest -K: the TMFs' A, b (and MLLRVAR scales) within 2e-3 of each
    array's scale plus 1e-3 relative. The statistics come from float32
    posteriors or accumulators, which the two packages' OutP and scans
    round differently (tests/test_torch_adapt.py), and the estimates
    solve small float64 systems from them;
  - HERest -a -J (CMLLR in feature space, MLLR speaker groups in model
    space) and HMAP: MAPTAU: MMFs within tests/test_torch_herest.py's
    tolerances;
  - HVite -J -h (parent and speaker chains, MLLRCOV and base-class CMLLR
    through the full-covariance scorer, batched feature-space chains),
    HVite -k after HHEd XF, and HDecode -J -h/-k: rec.mlf byte-identical;
  - HHEd RC (the base-class file and MMF) and XF (the MMF with its ~a
    macro): byte-identical;
  - `recipes.full.make_corpus` against recipes/full/make_corpus.py at
    N_TRAIN = N_ADAPT = N_TEST = 1: every file byte-identical.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from htk_tpu.tools import hdecode as j_hdecode
from htk_tpu.tools import herest as j_herest
from htk_tpu.tools import hhed as j_hhed
from htk_tpu.tools import hvite as j_hvite
from htk_tpu_torch.algo.adapt import (Transform, load_tmf, load_tmf_classes,
                                      save_tmf)
from htk_tpu_torch.io import parmkind as pk
from htk_tpu_torch.io.htkfeat import read_htk_file, write_htk_file
from htk_tpu_torch.io.mmf import load_mmf, save_mmf
from htk_tpu_torch.models.proto import clone_proto, make_proto
from htk_tpu_torch.recipes import full as p_full
from htk_tpu_torch.tools import hbuild as p_hbuild
from htk_tpu_torch.tools import hcompv as p_hcompv
from htk_tpu_torch.tools import hcopy as p_hcopy
from htk_tpu_torch.tools import hdecode as p_hdecode
from htk_tpu_torch.tools import herest as p_herest
from htk_tpu_torch.tools import hhed as p_hhed
from htk_tpu_torch.tools import hvite as p_hvite
from htk_tpu_torch.tools import lbuild as p_lbuild

from _torch_compare import one_torch_thread  # noqa: F401
from test_e2e import synth_utterance, write_wav
from test_torch_herest import assert_mmf_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TMF_ATOL = 2e-3  # of each array's scale
TMF_RTOL = 1e-3

DIM = 4
CENTERS = {"aa": 4.0, "iy": -4.0}
BIAS = {"spkA": 2.0, "spkB": 1.0}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


@pytest.fixture(scope="module")
def sat_root(tmp_path_factory):
    """tests/test_sat.py's corpus, once for the module: per-speaker CMLLR
    input transforms in xfin/, MLLRMEAN ones in xfm/, a word network,
    and the features shifted by a further global 3.0 (shift.scp) with a
    global MLLRMEAN parent that absorbs it in xfg/."""
    root = tmp_path_factory.mktemp("sat")
    old = os.getcwd()
    os.chdir(root)
    try:
        hs = make_proto(nstates=5, dim=DIM, parm_kind="USER")
        cl = clone_proto(hs, "proto", ["aa", "iy"])
        for nm, h in cl.hmms.items():
            for k, si in enumerate(h.states):
                mp = si.streams[0].mixes[0]
                mp.mean = np.full(DIM, CENTERS[nm] + 0.2 * k, np.float32)
                mp.var = np.full(DIM, 0.5, np.float32)
                mp.fix_gconst()
        save_mmf(cl, "hmmdefs")
        rng = np.random.default_rng(0)
        kind = pk.str2parmkind("USER")
        scp, sscp, mlf = [], [], ["#!MLF!#"]
        for d in ("xfin", "xfm", "xfg"):
            os.makedirs(d)
        for spk, bias in BIAS.items():
            save_tmf(f"xfin/{spk}.tmf", spk, Transform(
                kind="CMLLR", A=np.eye(DIM), b=np.full(DIM, -bias)))
            save_tmf(f"xfm/{spk}.tmf", spk, Transform(
                kind="MLLRMEAN", A=np.eye(DIM), b=np.full(DIM, bias)))
            for i in range(4):
                mu = 0.2 * np.arange(3).repeat(4).reshape(3, 4)
                x = np.concatenate([np.repeat(CENTERS[ph] + mu, 4, axis=0)
                                    for ph in ("aa", "iy")])
                x = (x + bias + 0.1 * rng.normal(size=(24, DIM))).astype(
                    np.float32)
                fn = f"{spk}_{i}.usr"
                write_htk_file(fn, x, 100000, kind)
                write_htk_file(f"g{fn}", x + 3.0, 100000, kind)
                scp.append(fn)
                sscp.append(f"g{fn}")
                mlf += [f'"*/{spk}_{i}.lab"', "aa", "iy", "."]
        save_tmf("xfg/global.tmf", "global", Transform(
            kind="MLLRMEAN", A=np.eye(DIM), b=np.full(DIM, 3.0)))
        _write("train.scp", "\n".join(scp))
        _write("shift.scp", "\n".join(sscp))
        _write("phones.mlf", "\n".join(mlf) + "\n")
        _write("phonelist", "aa\niy\n")
        _write("dict", "A  aa\nI  iy\n")
        _write("wlist", "A\nI\n")
        _write("words.mlf", "#!MLF!#\n" + "".join(
            f'"*/{p}{fn[:-4]}.lab"\nA\nI\n.\n' for fn in scp
            for p in ("", "g")))
        assert p_hbuild.run(["wlist", "wdnet.slf"]) == 0
    finally:
        os.chdir(old)
    return root


@pytest.fixture
def sat(sat_root, monkeypatch):
    monkeypatch.chdir(sat_root)
    return sat_root


def assert_tmf_close(got_path, ref_path):
    """Two TMFs (single or multi-class) within TMF_ATOL/TMF_RTOL."""
    g, r = load_tmf_classes(got_path), load_tmf_classes(ref_path)
    if r is None:
        assert g is None
        (gn, gx), (rn, rx) = load_tmf(got_path), load_tmf(ref_path)
        g, r = (gn, [gx], None, None), (rn, [rx], None, None)
    assert g[0] == r[0] and len(g[1]) == len(r[1])
    for a, b in ((g[2], r[2]), (g[3], r[3])):
        if b is not None:
            np.testing.assert_array_equal(a, b)
    for xa, xb in zip(g[1], r[1]):
        assert xa.kind == xb.kind
        for k in ("A", "b", "var_scale"):
            va, vb = getattr(xa, k), getattr(xb, k)
            if vb is None:
                assert va is None
                continue
            np.testing.assert_allclose(
                va, vb, rtol=TMF_RTOL,
                atol=TMF_ATOL * max(float(np.abs(vb).max()), 1.0),
                err_msg=k)


def _both(tool_p, tool_j, argv, out):
    """Run both packages' tool with `argv`, "OUT" standing for `out`/p
    and `out`/j; returns the two output directories."""
    dirs = []
    for run, tag in ((tool_p.run, "p"), (tool_j.run, "j")):
        d = os.path.join(out, tag)
        os.makedirs(d, exist_ok=True)
        assert run([a.replace("OUT", d) for a in argv]) == 0
        dirs.append(d)
    return dirs


# -- HERest -K ----------------------------------------------------------------

K_CASES = {
    # name: (config, extra args)
    "cmllr": ("HADAPT: TRANSKIND = CMLLR\n", ["-h", "%%%%*"]),
    "cmllr-blocks": ("HADAPT: TRANSKIND = CMLLR\nHADAPT: BLOCKS = 2\n",
                     ["-h", "%%%%*"]),
    "mllrmean-global": ("", []),
    "mllrmean-var": ("HADAPT: MLLRVAR = T\n", ["-h", "%%%%*"]),
    "mllrmean-classes": ("HADAPT: NUMREGCLASSES = 2\n", ["-h", "%%%%*"]),
    "mllrcov": ("HADAPT: TRANSKIND = MLLRCOV\n",
                ["-a", "-J", "xfin", "-h", "%%%%*"]),
    "cmllr-classes": ("HADAPT: TRANSKIND = CMLLR\n"
                      "HADAPT: NUMREGCLASSES = 2\nHADAPT: OCCTHRESH = 10.0\n",
                      ["-h", "%%%%*"]),
}


@pytest.mark.parametrize("case", list(K_CASES))
def test_herest_K_matches_reference(sat, tmp_path, case):
    cfg_text, extra = K_CASES[case]
    cfg = str(tmp_path / "k.cfg")
    _write(cfg, cfg_text or "HADAPT: TRANSKIND = MLLRMEAN\n")
    p, j = _both(p_herest, j_herest, ["-C", cfg, *extra, "-I", "phones.mlf",
                                      "-H", "hmmdefs", "-K", "OUT", "-S",
                                      "train.scp", "phonelist"],
                 str(tmp_path))
    names = sorted(os.listdir(j))
    assert sorted(os.listdir(p)) == names
    assert names == (["global.tmf"] if case == "mllrmean-global"
                     else ["spkA.tmf", "spkB.tmf"])
    for n in names:
        assert_tmf_close(os.path.join(p, n), os.path.join(j, n))


# -- HERest -a -J and MAP ---------------------------------------------------

A_CASES = {
    "cmllr": ("", ["-a", "-J", "xfin", "-h", "%%%%*"]),
    "mllr-groups": ("", ["-a", "-J", "xfm", "-h", "%%%%*"]),
    "map": ("HMAP: MAPTAU = 5.0\n", []),
}


@pytest.mark.parametrize("case", list(A_CASES))
def test_herest_a_J_and_map_match_reference(sat, tmp_path, case):
    cfg_text, extra = A_CASES[case]
    cfg = str(tmp_path / "a.cfg")
    _write(cfg, cfg_text or "HTKTPU: PRECISION = highest\n")
    p, j = _both(p_herest, j_herest, ["-C", cfg, "-u", "mvwt", *extra,
                                      "-I", "phones.mlf", "-H", "hmmdefs",
                                      "-M", "OUT", "-S", "train.scp",
                                      "phonelist"], str(tmp_path))
    assert_mmf_close(os.path.join(p, "hmmdefs"), os.path.join(j, "hmmdefs"))


# -- HVite -J/-h/-k and HHEd XF ----------------------------------------------


def _n_correct(mlf_text):
    """Utterances of an HVite MLF recognised as "A I"."""
    return len(re.findall(r"\n\d+ \d+ A\n\d+ \d+ I\n\.", mlf_text))


def _hvite_both(argv, tmp_path, name="rec.mlf"):
    outs = []
    for run, tag in ((p_hvite.run, "p"), (j_hvite.run, "j")):
        path = str(tmp_path / f"{tag}_{name}")
        assert run(["-w", "wdnet.slf", "-i", path, *argv]) == 0
        outs.append(open(path, "rb").read())
    assert outs[0] == outs[1]
    return outs[0].decode()


def _k_tmfs(tmp_path, cfg_text, args=("-h", "%%%%*")):
    """HERest -K with the port (its TMFs feed both packages' decoders)."""
    cfg = str(tmp_path / "kk.cfg")
    _write(cfg, cfg_text)
    out = str(tmp_path / "xf")
    os.makedirs(out, exist_ok=True)
    assert p_herest.run(["-C", cfg, *args, "-I", "phones.mlf", "-H",
                         "hmmdefs", "-K", out, "-S", "train.scp",
                         "phonelist"]) == 0
    return out


# the speaker of spkA_0.usr and of its shifted copy gspkA_0.usr
HVITE_MASK = "*%%%%_*"


@pytest.mark.parametrize("case", ["children", "parent+children", "mllrcov",
                                  "cmllr-classes", "batched-cmllr",
                                  "mllr-var"])
def test_hvite_J_matches_reference(sat, tmp_path, case):
    if case == "children":
        argv = ["-J", "xfin", "-h", HVITE_MASK, "-S", "shift.scp"]
    elif case == "parent+children":
        argv = ["-J", "xfg", "-J", "xfin", "-h", HVITE_MASK, "-S",
                "shift.scp"]
    elif case == "mllrcov":
        xf = _k_tmfs(tmp_path, "HADAPT: TRANSKIND = MLLRCOV\n",
                     ["-a", "-J", "xfin", "-h", "%%%%*"])
        argv = ["-J", "xfin", "-J", xf, "-h", "%%%%*", "-S", "train.scp"]
    elif case == "cmllr-classes":
        xf = _k_tmfs(tmp_path, "HADAPT: TRANSKIND = CMLLR\n"
                     "HADAPT: NUMREGCLASSES = 2\nHADAPT: OCCTHRESH = 10.0\n")
        argv = ["-J", xf, "-h", "%%%%*", "-S", "train.scp"]
    elif case == "batched-cmllr":
        cfg = str(tmp_path / "b.cfg")
        _write(cfg, "HREC: DECODEBATCH = 3\n")
        argv = ["-C", cfg, "-J", "xfin", "-h", "%%%%*", "-S", "train.scp"]
    else:
        xf = _k_tmfs(tmp_path, "HADAPT: MLLRVAR = T\n")
        argv = ["-J", xf, "-h", "%%%%*", "-S", "train.scp"]
    text = _hvite_both([*argv, "-H", "hmmdefs", "dict", "phonelist"],
                       tmp_path)
    if case != "children":
        # every utterance recognised as A I (test_sat.py's 100%)
        assert _n_correct(text) == text.count('"*/')


def test_hhed_xf_and_hvite_k_match_reference(sat, tmp_path):
    _write(str(tmp_path / "xf.hed"), "XF xfg/global.tmf\n")
    p, j = _both(p_hhed, j_hhed, ["-H", "hmmdefs", "-M", "OUT",
                                  str(tmp_path / "xf.hed"), "phonelist"],
                 str(tmp_path))
    mp = open(os.path.join(p, "hmmdefs"), "rb").read()
    assert mp == open(os.path.join(j, "hmmdefs"), "rb").read()
    assert b'~a "global"' in mp
    for extra in ([], ["-J", "xfin", "-h", HVITE_MASK]):
        text = _hvite_both(["-k", *extra, "-H", os.path.join(p, "hmmdefs"),
                            "-S", "shift.scp", "dict", "phonelist"],
                           tmp_path, f"k{len(extra)}.mlf")
        if extra:
            assert _n_correct(text) == 8


# -- HHEd RC, HERest -K through BASECLASS, HDecode -J ------------------------


@pytest.fixture(scope="module")
def e2e_root(tmp_path_factory):
    """tests/test_e2e.py's corpus, its monophones trained twice by the
    port, the training channel shifted by 0.8 of its std (s*.mfc), a
    bigram LM and tests/test_e2e_adapt.py's LV decode config."""
    root = tmp_path_factory.mktemp("e2e_adapt")
    old = os.getcwd()
    os.chdir(root)
    mp = pytest.MonkeyPatch()
    mp.setenv("HTK_TPU_TORCH_DEVICE", "cpu")
    try:
        rng = np.random.default_rng(5)
        words = {"A": ["aa"], "I": ["iy"]}
        mlf, wmlf, sents = ["#!MLF!#"], ["#!MLF!#"], []
        for i in range(6):
            ws = [["A", "I"][int(x)] for x in rng.integers(0, 2, size=2)]
            phs = ["sil"]
            for w in ws:
                phs += words[w] + ["sil"]
            write_wav(f"u{i}.wav", synth_utterance(phs, rng))
            mlf += [f'"*/u{i}.lab"', *phs, "."]
            wmlf += [f'"*/u{i}.lab"', *ws, "."]
            sents.append(" ".join(ws))
        _write("phones.mlf", "\n".join(mlf) + "\n")
        _write("words.mlf", "\n".join(wmlf) + "\n")
        _write("copy.scp", "\n".join(f"u{i}.wav u{i}.mfc" for i in range(6)))
        _write("train.scp", "\n".join(f"u{i}.mfc" for i in range(6)))
        _write("monophones", "aa\niy\nsil\n")
        _write("dict", "A  aa\nI  iy\nSIL [] sil\n")
        _write("wlist", "A\nI\nSIL\n")
        _write("cfg_wav", "SOURCEFORMAT = WAV\nTARGETKIND = MFCC_E_D_A\n")
        _write("cfg", "TARGETKIND = MFCC_E_D_A\n")
        _write("cfglv", "TARGETKIND = MFCC_E_D_A\nHTKTPU: LVDECODE = T\n")
        _write("words.txt", "\n".join(sents) + "\n")
        save_mmf(make_proto(nstates=5, dim=39, parm_kind="MFCC_E_D_A"),
                 "proto")
        assert p_hcopy.run(["-C", "cfg_wav", "-S", "copy.scp"]) == 0
        assert p_hcompv.run(["-C", "cfg", "-f", "0.01", "-m", "-M", "hmm0",
                             "-S", "train.scp", "proto"]) == 0
        cl = clone_proto(load_mmf("hmm0/proto"), "proto",
                         ["aa", "iy", "sil"])
        cl.macros["v"]["varFloor1"] = load_mmf(
            "hmm0/vFloors").macros["v"]["varFloor1"]
        save_mmf(cl, "hmm0/hmmdefs")
        for it in (1, 2):
            assert p_herest.run(["-C", "cfg", "-I", "phones.mlf", "-H",
                                 f"hmm{it - 1}/hmmdefs", "-M", f"hmm{it}",
                                 "-S", "train.scp", "monophones"]) == 0
        feats = [read_htk_file(f"u{i}.mfc") for i in range(6)]
        shift = (0.8 * np.concatenate([f.data for f in feats]).std(axis=0)
                 ).astype(np.float32)
        for i, f in enumerate(feats):
            write_htk_file(f"s{i}.mfc", f.data + shift, f.samp_period,
                           f.parm_kind)
        _write("shift.scp", "\n".join(f"s{i}.mfc" for i in range(6)))
        _write("phones_s.mlf", open("phones.mlf").read().replace("/u", "/s"))
        assert p_hbuild.run(["wlist", "wdnet.slf"]) == 0
        assert p_lbuild.run(["-n", "2", "wlist", "lm.arpa",
                             "words.txt"]) == 0
    finally:
        mp.undo()
        os.chdir(old)
    return root


@pytest.fixture
def e2e(e2e_root, monkeypatch):
    monkeypatch.chdir(e2e_root)
    return e2e_root


def test_hhed_rc_baseclass_mllr_chain_matches_reference(e2e, tmp_path):
    """HHEd MU + RC byte-identical; HERest -K MLLRMEAN through the base
    classes' tree (OCCTHRESH 1, MLLRVAR) within the TMF tolerances;
    HVite -J with the port's TMF byte-identical."""
    _write(str(tmp_path / "rc.hed"), "MU 2 {*.state[2-4].mix}\nRC 2 rtree\n")
    p, j = _both(p_hhed, j_hhed, ["-H", "hmm2/hmmdefs", "-M", "OUT",
                                  str(tmp_path / "rc.hed"), "monophones"],
                 str(tmp_path / "rc"))
    for f in ("hmmdefs", "rtree.cls"):
        assert (open(os.path.join(p, f), "rb").read()
                == open(os.path.join(j, f), "rb").read()), f
    cfg = str(tmp_path / "adapt.cfg")
    _write(cfg, f"TARGETKIND = MFCC_E_D_A\nHADAPT: BASECLASS = {p}/rtree.cls"
                "\nHADAPT: OCCTHRESH = 1.0\nHADAPT: MLLRVAR = T\n")
    kp, kj = _both(p_herest, j_herest, ["-C", cfg, "-I", "phones.mlf", "-H",
                                        f"{p}/hmmdefs", "-K", "OUT", "-S",
                                        "train.scp", "monophones"],
                   str(tmp_path / "k"))
    assert os.listdir(kp) == os.listdir(kj) == ["global.tmf"]
    assert_tmf_close(os.path.join(kp, "global.tmf"),
                     os.path.join(kj, "global.tmf"))
    assert "MLLRCLASSES" in open(os.path.join(kp, "global.tmf")).read()
    outs = []
    for run, tag in ((p_hvite.run, "p"), (j_hvite.run, "j")):
        mlf = str(tmp_path / f"{tag}.mlf")
        assert run(["-w", "wdnet.slf", "-p", "-8", "-J", kp, "-i", mlf,
                    "-H", f"{p}/hmmdefs", "-S", "train.scp", "dict",
                    "monophones"]) == 0
        outs.append(open(mlf, "rb").read())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("case", ["mllrmean-k", "cmllr-h", "mllr-h"])
def test_hdecode_J_matches_reference(e2e, tmp_path, case):
    """HDecode -J on tests/test_e2e_adapt.py's shifted channel and LV
    config: a global MLLRMEAN TMF with -k, and per-speaker CMLLR and
    MLLRMEAN TMFs (BLOCKS 3) with -h 's%*', which makes each file its
    own speaker (a bucket of pass 1 a speaker)."""
    kind = {"mllrmean-k": "MLLRMEAN", "cmllr-h": "CMLLR",
            "mllr-h": "MLLRMEAN"}[case]
    cfg = str(tmp_path / "k.cfg")
    _write(cfg, f"TARGETKIND = MFCC_E_D_A\nHADAPT: TRANSKIND = {kind}\n"
                "HADAPT: BLOCKS = 3\n")
    xf = str(tmp_path / "xf")
    mask = ["-h", "s%*"] if case.endswith("-h") else []
    assert p_herest.run(["-C", cfg, *mask, "-I", "phones_s.mlf", "-H",
                         "hmm2/hmmdefs", "-K", xf, "-S", "shift.scp",
                         "monophones"]) == 0
    assert len(os.listdir(xf)) == (6 if mask else 1)
    extra = ["-J", xf, *(mask or ["-k"])]
    outs = []
    for run, tag in ((p_hdecode.run, "p"), (j_hdecode.run, "j")):
        mlf = str(tmp_path / f"{tag}.mlf")
        assert run(["-C", "cfglv", "-w", "lm.arpa", "-p", "-8", *extra,
                    "-i", mlf, "-H", "hmm2/hmmdefs", "-S", "shift.scp",
                    "dict", "monophones"]) == 0
        outs.append(open(mlf, "rb").read())
    assert outs[0] == outs[1]


# -- the full recipe's corpus ------------------------------------------------


def test_full_corpus_writer_byte_identical(tmp_path):
    sizes = dict(N_TRAIN="1", N_ADAPT="1", N_TEST="1")
    ref = tmp_path / "ref"
    ref.mkdir()
    env = {k: v for k, v in os.environ.items()}
    env.update(sizes, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, os.path.join(
        REPO, "recipes", "full", "make_corpus.py")], cwd=ref, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = tmp_path / "got"
    got.mkdir()
    old = os.getcwd()
    os.chdir(got)
    try:
        p_full.make_corpus(n_train=1, n_adapt=1, n_test=1)
    finally:
        os.chdir(old)

    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _ds, fs in os.walk(d) for f in fs)

    assert files(got) == files(ref)
    for f in files(ref):
        assert (got / f).read_bytes() == (ref / f).read_bytes(), f
