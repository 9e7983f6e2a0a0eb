"""The port's HDecode, LBuild and HLRescore against htk_tpu's, on the CPU.

A small system written by `synth.write_system` (20 words, 400 tied
states, so that no two word ends tie in real arithmetic and the two
packages' OutP roundings pick the same paths) and its lm.arpa bigram, and
a trigram LM that LBuild builds from the utterances' transcriptions.
HDecode runs on four legs, each with both packages on the same files:

  - LV dense (`HTKTPU: LVDECODE = T`: the uniform-row loop, maxplus);
  - general (20 words, below the LV threshold: the general network,
    decode_scan);
  - LV factored (lvnet's factored threshold lowered in both packages, so
    the 20-row loop is factored: segmax);
  - trigram-guided (LBuild's lm3.arpa: TRIGUIDE and the default -u 512).

The -i MLF is byte-identical and the -z lattices are within
`assert_slf_close`. Also: the 8524 knee warning, the 8525 retry ladder
(the batched pass 1 made to lose every utterance, as
tests/test_beam_guardrail.py:72-89 does), -J/-k/-h with the MLF
byte-identical, LBuild's ARPA and HLRescore's MLF and lattices
byte-identical.
"""

import os

import numpy as np
import pytest

from htk_tpu.algo import lvnet as j_lvnet
from htk_tpu.tools import hdecode as j_hdecode
from htk_tpu.tools import hlrescore as j_hlrescore
from htk_tpu.tools import lbuild as j_lbuild
from htk_tpu_torch.algo import lvnet as p_lvnet
from htk_tpu_torch.synth import write_system
from htk_tpu_torch.tools import hdecode as p_hdecode
from htk_tpu_torch.tools import hlrescore as p_hlrescore
from htk_tpu_torch.tools import lbuild as p_lbuild

from _torch_compare import assert_slf_close, one_torch_thread  # noqa: F401

LM_SCALE, PEN = "8", "-10"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hdecode_sys"))
    s = write_system(root, n_words=20, n_phones=8, n_tied=400, n_mix=2,
                     n_utts=4, min_frames=60, max_frames=150, fanout=4,
                     seed=2, binary_mmf=False)
    text = os.path.join(root, "words.txt")
    with open(text, "w") as f:
        f.write("".join(" ".join(t) + "\n" for t in s.transcripts))
    lm3 = os.path.join(root, "lm3.arpa")
    assert p_lbuild.run(["-n", "3", "wmap", lm3, text]) == 0
    for name, cfg in (("lv", "HTKTPU: LVDECODE = T\n"), ("gen", ""),
                      ("knee", "HTKTPU: LVDECODE = T\n")):
        with open(os.path.join(root, f"{name}.cfg"), "w") as f:
            f.write(cfg)
    return s, text, lm3


def _read_dir(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def _hdecode(run, s, out, cfg, lm, extra=()):
    os.makedirs(out, exist_ok=True)
    assert run(["-C", os.path.join(s.root, cfg), "-w", lm, "-s", LM_SCALE,
                "-p", PEN, "-z", "lat", "-l", out, "-i",
                os.path.join(out, "rec.mlf"), *extra, "-H", s.hmmdefs,
                "-S", s.scp, s.dict, s.hmmlist]) == 0
    return _read_dir(out)


def _assert_same(got, ref, n_lats):
    assert sorted(got) == sorted(ref)
    assert got["rec.mlf"] == ref["rec.mlf"]
    lats = [f for f in got if f.endswith(".lat")]
    assert len(lats) == n_lats
    for f in lats:
        assert_slf_close(got[f].decode(), ref[f].decode())


@pytest.mark.parametrize("leg", ["lv_dense", "general", "lv_factored",
                                 "trigram"])
def test_hdecode_equals_reference(system, tmp_path, monkeypatch, leg):
    s, _text, lm3 = system
    cfg = "gen.cfg" if leg == "general" else "lv.cfg"
    lm = lm3 if leg == "trigram" else s.lm
    if leg == "lv_factored":
        monkeypatch.setattr(p_lvnet, "FACTORED_THRESHOLD", 0)
        monkeypatch.setattr(j_lvnet, "FACTORED_THRESHOLD", 0)
    got = _hdecode(p_hdecode.run, s, str(tmp_path / "t"), cfg, lm)
    ref = _hdecode(j_hdecode.run, s, str(tmp_path / "j"), cfg, lm)
    _assert_same(got, ref, len(s.feats))
    assert got["rec.mlf"].count(b"\n.\n") == len(s.feats)


def test_hdecode_warns_below_knee(system, tmp_path, capsys):
    s, _text, _lm3 = system
    _hdecode(p_hdecode.run, s, str(tmp_path / "k"), "knee.cfg", s.lm,
             ["-t", "300.0"])
    err = capsys.readouterr().err
    assert "WARNING [-8524]" in err and "knee" in err


def test_hdecode_retry_ladder_recovers(system, tmp_path, monkeypatch,
                                       capsys):
    """A pass 1 that returns no path under pruning recovers through the
    widened-beam ladder, as in htk_tpu, and writes the unpruned MLF."""
    s, _text, _lm3 = system
    plain = _hdecode(p_hdecode.run, s, str(tmp_path / "p"), "lv.cfg", s.lm)
    monkeypatch.setattr(p_hdecode, "generate_lattice_batch",
                        lambda net, comp, featl, *a, **k: [None] * len(featl))
    extra = ["-t", "450.0", "-u", "8"]
    got = _hdecode(p_hdecode.run, s, str(tmp_path / "t"), "knee.cfg", s.lm,
                   extra)
    err = capsys.readouterr().err
    assert "WARNING [-8525]" in err and "retrying" in err
    assert got["rec.mlf"].count(b"\n.\n") == len(s.feats)
    from htk_tpu.algo import decode as jdec

    monkeypatch.setattr(jdec, "generate_lattice_batch",
                        lambda net, comp, featl, *a, **k: [None] * len(featl))
    ref = _hdecode(j_hdecode.run, s, str(tmp_path / "j"), "knee.cfg", s.lm,
                   extra)
    _assert_same(got, ref, len(s.feats))
    assert plain["rec.mlf"] == got["rec.mlf"]


@pytest.mark.parametrize("opt", [["-J", "xforms"], ["-k"], ["-h", "*%%%"]])
def test_hdecode_refuses_adaptation(system, tmp_path, opt):
    """-J, -k and -h, refused with HError 3290 until the adaptation module
    was ported, now decode as the reference does: a global CMLLR TMF
    under -J, and -k and -h alone (no transforms to apply), rec.mlf
    byte-identical."""
    from htk_tpu_torch.algo.adapt import Transform, save_tmf

    s, _text, _lm3 = system
    xf_dir = tmp_path / "xforms"
    xf_dir.mkdir()
    rng = np.random.default_rng(6)
    save_tmf(str(xf_dir / "global.tmf"), "global", Transform(
        kind="CMLLR", A=np.eye(39) + 0.02 * rng.normal(size=(39, 39)),
        b=0.1 * rng.normal(size=39)))
    opt = [str(xf_dir) if o == "xforms" else o for o in opt]
    outs = []
    for run, tag in ((p_hdecode.run, "p"), (j_hdecode.run, "j")):
        mlf = str(tmp_path / f"{tag}.mlf")
        assert run([*opt, "-w", s.lm, "-s", LM_SCALE, "-p", PEN, "-i", mlf,
                    "-H", s.hmmdefs, s.dict, s.hmmlist, *s.feats[:3]]) == 0
        outs.append(open(mlf, "rb").read())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("args", [["-n", "3"], ["-n", "2", "-d", "GT"],
                                  ["-n", "4", "-a", "0.3"]])
def test_lbuild_arpa_byte_identical(system, tmp_path, args):
    _s, text, _lm3 = system
    outs = []
    for run, name in ((p_lbuild.run, "t"), (j_lbuild.run, "j")):
        out = str(tmp_path / f"{name}.arpa")
        assert run([*args, "wmap", out, text]) == 0
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] and b"\\2-grams:" in outs[0]


@pytest.mark.parametrize("args", [["-f"], ["-n", "LM3", "-t", "50.0",
                                           "-w"], ["-s", "4", "-p", "-2"]])
def test_hlrescore_byte_identical(system, tmp_path, args):
    s, _text, lm3 = system
    lats = _hdecode(p_hdecode.run, s, str(tmp_path / "d"), "lv.cfg", s.lm)
    files = [str(tmp_path / "d" / f) for f in lats if f.endswith(".lat")]
    args = [lm3 if a == "LM3" else a for a in args]
    outs = []
    for run, name in ((p_hlrescore.run, "t"), (j_hlrescore.run, "j")):
        out = str(tmp_path / name)
        os.makedirs(out)
        assert run([*args, "-i", os.path.join(out, "best.mlf"), "-l", out,
                    s.dict, *files]) == 0
        outs.append(_read_dir(out))
    assert outs[0] == outs[1]
    assert len(outs[0]) == (1 + len(files) if "-w" in args else 1)
