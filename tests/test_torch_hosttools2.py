"""The port's last host tools against htk_tpu's, on the CPU.

LNewMap/LGPrep/LGCopy/LFoF/LGList (tools/lgram.py), LMerge/LNorm,
LPlex, LSubset/LAdapt, Cluster/LLink, HLStats, HLMCopy, HDMan, HParse,
HSGen, HList, HSmooth and HSLab, with the SVG canvas (utils/graf.py).
Each case copies one input directory twice, runs the port's tool in one
copy and htk_tpu's in the other with the same arguments, and compares
every file the two runs wrote, and their stdout, byte for byte. The
inputs are the reference tests' (tests/test_tools2.py, test_cluster.py,
test_lgram.py, test_hlmcopy.py, test_hslab.py). HSmooth reads the
accumulators of two HERest -p passes of the port over halves of a
write_system corpus; LMerge reads two bigrams written by io.lm.write_arpa.
"""

import os

import numpy as np
import pytest

import htk_tpu.utils.graf as j_graf
from htk_tpu_torch.io import parmkind as pk
from htk_tpu_torch.io.htkfeat import write_htk_file
from htk_tpu_torch.io.lm import write_arpa
from htk_tpu_torch.synth import write_system
from htk_tpu_torch.tools import herest
from htk_tpu_torch.tools.lbuild import build_lm
from htk_tpu_torch.utils import graf

from _synth import synth_utterance, write_wav
from _torch_compare import assert_same, one_torch_thread, run_both  # noqa: F401
from test_cluster import planted_corpus


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def lm_inputs(tmp_path_factory):
    """Texts, a word map seeded by LNewMap, gram files from LGPrep, a
    class map from Cluster, and two ARPA bigrams."""
    from htk_tpu.tools import cluster, lgram

    d = tmp_path_factory.mktemp("lm")
    (d / "t1.txt").write_text("a b a\nb b\n")
    (d / "t2.txt").write_text("a b\na a b\n")
    rng = np.random.default_rng(2)
    (d / "train.txt").write_text("".join(
        " ".join(s) + "\n" for s in planted_corpus(rng, n=120)))
    (d / "cwmap").write_text("x1\nx2\nx3\ny1\ny2\ny3\n")
    (d / "wl").write_text("a\nb\n")
    old = os.getcwd()
    os.chdir(d)
    try:
        assert lgram.run_lnewmap(["base", "wmap"]) == 0
        assert lgram.run_lgprep(["-n", "2", "-r", "g1", "wmap",
                                 "t1.txt"]) == 0
        assert lgram.run_lgprep(["-n", "2", "-r", "g2", "wmap",
                                 "t2.txt"]) == 0
        assert lgram.run_lnewmap(["small", "smallmap"]) == 0
        assert cluster.run(["-c", "2", "-i", "3", "-p", "class.arpa",
                            "cwmap", "cmap", "train.txt"]) == 0
        assert cluster.run(["-c", "2", "wmap", "cmap12", "t1.txt"]) == 0
    finally:
        os.chdir(old)
    sents_a = [["a", "b"], ["a", "b"], ["a", "c"], ["b", "a"]]
    sents_b = [["b", "c"], ["c", "a", "b"], ["a", "a"]]
    write_arpa(build_lm(sents_a, order=2), str(d / "a.arpa"))
    write_arpa(build_lm(sents_b, order=2), str(d / "b.arpa"))
    lm3 = build_lm([["a", "b", "c", "d"], ["a", "b", "c", "e"],
                    ["a", "b", "c", "d"]], order=3)
    write_arpa(lm3, str(d / "c3.arpa"))
    return d


def assert_same_stdout(tmp_path, monkeypatch, capsys, tool, argv, inputs,
                       entry="main"):
    """Tools that only print: the same stdout and no file written."""
    fp, fj, (op, oj), _err, (rp, rj) = run_both(
        tmp_path, monkeypatch, capsys, tool, argv, inputs, entry)
    assert rp == rj == 0 and fp == fj == {}
    assert op == oj
    return op


@pytest.mark.parametrize("entry,argv", [
    ("main_lnewmap", ["-T", "1", "fresh", "newmap"]),
    ("main_lgprep", ["-n", "3", "-r", "gx", "wmap", "t1.txt", "t2.txt"]),
    ("main_lgcopy", ["-o", "all.2gram", "wmap", "g1.2gram", "g2.2gram"]),
    ("main_lgcopy", ["-o", "r.1gram", "-m", "smallmap", "wmap",
                     "g1.1gram"]),
    ("main_lfof", ["-n", "4", "wmap", "fof", "g1.2gram"]),
])
def test_lgram(lm_inputs, tmp_path, monkeypatch, capsys, entry, argv):
    assert_same(tmp_path, monkeypatch, capsys, "lgram", argv, lm_inputs,
                entry=entry)


@pytest.mark.parametrize("argv", [
    ["wmap", "g1.2gram"], ["-f", "wmap", "g1.1gram"],
    ["-m", "3", "wmap", "g1.1gram"],
])
def test_lglist(lm_inputs, tmp_path, monkeypatch, capsys, argv):
    assert assert_same_stdout(tmp_path, monkeypatch, capsys, "lgram", argv,
                              lm_inputs, "main_lglist")


@pytest.mark.parametrize("tool,entry,argv", [
    ("lbuild", "main", ["-n", "2", "wmap", "lm_gram.arpa", "g1.1gram",
                        "g1.2gram"]),
    ("lmerge", "main", ["-T", "1", "-i", "0.3", "b.arpa", "a.arpa",
                        "merged.arpa"]),
    ("lmerge", "main_lnorm", ["a.arpa", "norm.arpa"]),
    ("lmerge", "main_lnorm", ["-p", "-2.0", "c3.arpa", "pruned.arpa"]),
    ("lsubset", "main", ["-T", "1", "a.arpa", "wl", "sub.arpa"]),
    ("lsubset", "main_ladapt", ["-i", "0.4", "a.arpa", "-n", "2",
                                "adapt.arpa", "t2.txt"]),
    ("cluster", "main", ["-T", "1", "-c", "2", "-i", "3", "-p", "c.arpa",
                         "cwmap", "cmap_out", "train.txt"]),
    ("cluster", "main_llink", ["-o", "link.arpa", "cmap12", "t2.txt"]),
    ("cluster", "main_llink", ["-o", "link2.arpa", "cmap12", "g2.1gram",
                               "g2.2gram"]),
])
def test_lm_tools(lm_inputs, tmp_path, monkeypatch, capsys, tool, entry,
                  argv):
    assert_same(tmp_path, monkeypatch, capsys, tool, argv, lm_inputs,
                entry=entry)


@pytest.mark.parametrize("argv", [
    ["-n", "2", "class.arpa", "train.txt"],
    ["-t", "-u", "a.arpa", "t1.txt", "t2.txt"],
    ["-n", "3", "c3.arpa", "t1.txt"],
])
def test_lplex(lm_inputs, tmp_path, monkeypatch, capsys, argv):
    assert "erplexity" in assert_same_stdout(
        tmp_path, monkeypatch, capsys, "lplex", argv, lm_inputs)


@pytest.fixture(scope="module")
def label_inputs(tmp_path_factory):
    """Word labels, dictionaries, an HDMan script and a grammar."""
    d = tmp_path_factory.mktemp("labels")
    (d / "wlist").write_text("a\nb\nc\n")
    with open(d / "train.mlf", "w") as f:
        f.write("#!MLF!#\n")
        for i, s in enumerate((["a", "b"], ["a", "c"], ["b", "a"],
                               ["c", "c", "a"])):
            f.write(f'"*/u{i}.lab"\n' + "\n".join(s) + "\n.\n")
    (d / "src.dic").write_text("a ah\nb b iy\nb [b] 0.5 b ih\n"
                               "HELLO hh ax l ow1\nWORLD w er1 l d\n"
                               "ABBA ax b ax b\nCat k ae t\n")
    (d / "extra.dic").write_text("b B OH\nc s iy\nzed z eh d\n")
    (d / "wl").write_text("b\nc\n")
    (d / "wl_miss").write_text("a\nzzz\n")
    (d / "keep").write_text("a\nb\nHELLO\nABBA\nCat\nc\n")
    (d / "script").write_text("RS cmu\nAS sp\nRP ax aa\nMP axl ax l\n"
                              "CR p ax b ax\nDD A ey\nTC sil sil\n")
    (d / "script2").write_text("LP\nDP sp\nLC\n")
    (d / "script3").write_text("UP\nRC\n")
    (d / "gram").write_text(
        "$digit = one | two | three;\n"
        "( sent-start < $digit > [ oh ] { $digit } sent-end )\n")
    (d / "dict").write_text("".join(
        f"{w} {w[0]}\n" for w in ("one", "two", "three", "oh",
                                  "sent-start", "sent-end")))
    (d / "cfg_seed").write_text("HTKTPU: SEED = 7\n")
    return d


@pytest.mark.parametrize("tool,argv,stdout", [
    ("hlstats", ["-b", "big.mat", "-I", "train.mlf", "wlist"], True),
    ("hlstats", ["-o", "-b", "big.arpa", "-t", "1", "-u", "0.5",
                 "-I", "train.mlf", "wlist"], True),
    ("hlmcopy", ["-T", "1", "-d", "extra.dic", "-w", "wl", "src.dic",
                 "out.dic"], True),
    ("hlmcopy", ["-n", "1", "src.dic", "out.dic"], True),
    ("hlmcopy", ["-o", "-w", "wl_miss", "src.dic", "out.dic"], False),
    ("hdman", ["-T", "1", "-g", "script", "-n", "phl", "new.dic",
               "src.dic", "extra.dic"], True),
    ("hdman", ["-g", "script2", "-w", "keep", "new.dic", "src.dic",
               "extra.dic"], True),
    ("hdman", ["-g", "script3", "new.dic", "extra.dic"], True),
    ("hparse", ["gram", "net.slf"], True),
])
def test_label_tools(label_inputs, tmp_path, monkeypatch, capsys, tool,
                     argv, stdout):
    assert_same(tmp_path, monkeypatch, capsys, tool, argv, label_inputs,
                stdout=stdout)


def test_hlstats_prints(label_inputs, tmp_path, monkeypatch, capsys):
    assert assert_same_stdout(tmp_path, monkeypatch, capsys, "hlstats",
                              ["-p", "-I", "train.mlf", "wlist"],
                              label_inputs)


@pytest.mark.parametrize("argv", [
    ["-C", "cfg_seed", "-n", "10", "-l", "net.slf", "dict"],
    ["-C", "cfg_seed", "-n", "25", "-q", "-s", "net.slf", "dict"],
])
def test_hsgen(label_inputs, tmp_path, monkeypatch, capsys, argv):
    from htk_tpu.tools import hparse

    monkeypatch.chdir(label_inputs)
    if not (label_inputs / "net.slf").exists():
        assert hparse.run(["gram", "net.slf"]) == 0
    assert assert_same_stdout(tmp_path, monkeypatch, capsys, "hsgen", argv,
                              label_inputs)


@pytest.fixture(scope="module")
def speech_inputs(tmp_path_factory):
    """A feature file, a waveform and its config, an HSLab command
    script."""
    d = tmp_path_factory.mktemp("speech")
    rng = np.random.default_rng(0)
    write_htk_file(str(d / "a.usr"),
                   np.arange(36, dtype=np.float32).reshape(3, 12) / 7.0,
                   100000, pk.str2parmkind("USER"))
    write_wav(str(d / "a.wav"), synth_utterance(["sil", "aa", "sil"], rng))
    (d / "cfg").write_text("SOURCEFORMAT = WAV\nTARGETKIND = USER\n")
    (d / "cfg_mfc").write_text("SOURCEFORMAT = WAV\nTARGETKIND = MFCC_E\n")
    x = (3000 * np.sin(np.arange(16000) / 20)).astype(np.int16)
    write_wav(str(d / "u.wav"), x)
    (d / "cmds").write_text(
        "label 0.0 0.3 sil\nlabel 0.3 0.72 speech\nlabel 0.72 1.0 silX\n"
        "rename 2 sil\nadjust 1 0.3 0.7\nlabel 0.7 1.0 tail\ndelete 3\n"
        "render view.svg\nzoom 0.2 0.8\nrender zoom.svg\nsave\n")
    (d / "cmds_mlf").write_text("label 0.0 0.5 aa\nsave\n")
    (d / "u_old.lab").write_text("0 3000000 sil\n3000000 7000000 aa\n")
    return d


@pytest.mark.parametrize("argv", [
    ["a.usr"], ["-h", "a.usr"], ["-i", "4", "-s", "1", "-e", "2", "a.usr"],
    ["-C", "cfg_mfc", "-z", "a.wav"], ["-C", "cfg_mfc", "-t", "-h",
                                       "a.wav"],
])
def test_hlist(speech_inputs, tmp_path, monkeypatch, capsys, argv):
    assert "Sample Kind" in assert_same_stdout(
        tmp_path, monkeypatch, capsys, "hlist", argv, speech_inputs)


@pytest.mark.parametrize("argv", [
    ["-e", "cmds", "u.wav"],
    ["-e", "cmds_mlf", "-i", "out.mlf", "u.wav"],
    ["-e", "cmds_mlf", "-l", "u_old.lab", "-o", "v.svg", "-y", "lbl",
     "u.wav"],
])
def test_hslab(speech_inputs, tmp_path, monkeypatch, capsys, argv):
    assert_same(tmp_path, monkeypatch, capsys, "hslab", argv, speech_inputs)


def test_graf_canvas():
    out = []
    for mod in (graf, j_graf):
        g = mod.HGraf(100, 50, title="t<est")
        g.set_colour("red")
        g.draw_line(0, 0, 99, 49)
        g.fill_rectangle(10, 10, 20, 20)
        g.set_colour(15)
        g.printf(5, 40, 'hi & "bye"')
        out.append(g.to_svg())
    assert out[0] == out[1] and "hi &amp; &quot;bye&quot;" in out[0]


@pytest.fixture(scope="module")
def smooth_inputs(tmp_path_factory):
    """A 2-mixture triphone system and the accumulators of two HERest
    -p passes of the port, one over each half of its training data."""
    d = tmp_path_factory.mktemp("smooth")
    s = write_system(str(d / "sys"), n_words=6, n_phones=6, n_tied=30,
                     n_mix=2, n_utts=4, min_frames=60, max_frames=90,
                     fanout=3)
    scp = open(s.train_scp).read().splitlines()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HTK_TPU_TORCH_DEVICE", "cpu")
        for k, part in enumerate((scp[:2], scp[2:]), start=1):
            (d / f"half{k}.scp").write_text("\n".join(part) + "\n")
            assert herest.run(["-p", str(k), "-H", s.hmmdefs, "-M", str(d),
                               "-S", str(d / f"half{k}.scp"), "-I",
                               s.train_mlf, s.hmmlist]) == 0
    for f in ("hmmdefs", "hmmlist"):
        os.replace(os.path.join(s.root, f), d / f)
    return d


@pytest.mark.parametrize("argv", [
    ["-T", "1", "-H", "hmmdefs", "-M", "out", "hmmlist", "HER1.acc",
     "HER2.acc"],
    ["-T", "1", "-b", "0.2", "-e", "3", "-H", "hmmdefs", "-M", "out",
     "hmmlist", "HER2.acc", "HER1.acc"],
])
def test_hsmooth(smooth_inputs, tmp_path, monkeypatch, capsys, argv):
    fp, fj, (op, oj), _err, (rp, rj) = run_both(
        tmp_path, monkeypatch, capsys, "hsmooth", argv, smooth_inputs)
    assert rp == rj == 0 and op == oj
    assert list(fp) == list(fj) == ["out/hmmdefs"]
    assert fp["out/hmmdefs"] == fj["out/hmmdefs"]
    assert int(op.split("smoothed ")[1].split()[0]) > 10, op
