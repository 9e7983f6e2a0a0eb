"""The port's copied host tools against htk_tpu's, on the CPU.

Each case writes its inputs once, copies them into two directories, runs
htk_tpu_torch's tool in one and htk_tpu's in the other with the same
arguments, and compares every file the two runs wrote (and their
stdout): byte for byte for HCompV, HLEd, HHEd, HBuild and HResults, and
for HCopy wherever the source is a feature file; for a waveform source
HCopy's headers are byte-identical and its data within the frontend's
tolerance (tests/_torch_compare.py). HHEd's RC and XF, which need the
unported adaptation module, give the numbered error 2690.
"""

import importlib
import os
import shutil

import numpy as np
import pytest

from htk_tpu_torch.io.htkfeat import read_htk_file, write_htk_file
from htk_tpu_torch.io.mmf import load_mmf, save_mmf
from htk_tpu_torch.io.wavefile import Waveform, read_wave, write_wave
from htk_tpu_torch.models.proto import clone_proto, make_proto
from htk_tpu_torch.recipes.speech import synth_words

from _torch_compare import (assert_features_close, assert_scaled_close,  # noqa: F401
                            one_torch_thread)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def _snapshot(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def run_both(tmp_path, monkeypatch, capsys, tool, argv, inputs):
    """Run `tool` of both packages on copies of the `inputs` directory;
    returns ({file: bytes} written by the port, the same for htk_tpu,
    (port stdout, htk_tpu stdout), (port rc, htk_tpu rc))."""
    out = []
    for pkg in ("htk_tpu_torch", "htk_tpu"):
        d = tmp_path / pkg
        shutil.copytree(inputs, d)
        before = _snapshot(d)
        monkeypatch.chdir(d)
        capsys.readouterr()
        mod = importlib.import_module(f"{pkg}.tools.{tool}")
        rc = mod.main(list(argv))
        cap = capsys.readouterr()
        after = _snapshot(d)
        out.append(({r: b for r, b in after.items() if before.get(r) != b},
                    cap.out, cap.err, rc))
    (fp, op, ep, rp), (fj, oj, ej, rj) = out
    return fp, fj, (op, oj), (ep, ej), (rp, rj)


def assert_same(tmp_path, monkeypatch, capsys, tool, argv, inputs,
                stdout=True):
    fp, fj, (op, oj), _err, (rp, rj) = run_both(
        tmp_path, monkeypatch, capsys, tool, argv, inputs)
    assert rp == rj == 0
    assert sorted(fp) == sorted(fj) and fp, (sorted(fp), sorted(fj))
    for rel in fp:
        assert fp[rel] == fj[rel], rel
    if stdout:
        assert op == oj
    return fp


@pytest.fixture(scope="module")
def waves(tmp_path_factory):
    """Four utterances as WAV, HTK-format and headerless waveforms, a
    word MLF, and the features of each as an HTK file."""
    d = tmp_path_factory.mktemp("waves")
    rng = np.random.default_rng(11)
    words = {"A": ["aa"], "I": ["iy"], "U": ["uw", "iy"]}
    mlf = ["#!MLF!#"]
    for i in range(4):
        ws = [list(words)[int(k)] for k in rng.integers(0, 3, size=2)]
        phs = ["sil"]
        for w in ws:
            phs += words[w] + ["sil"]
        x = synth_words(phs, rng)
        write_wave(str(d / f"u{i}.wav"), Waveform(x, 625), fmt="WAV")
        write_wave(str(d / f"u{i}.htk"), Waveform(x, 625), fmt="HTK")
        (d / f"u{i}.raw").write_bytes(x.astype("<i2").tobytes())
        f = rng.normal(size=(90 + 10 * i, 39)).astype(np.float32)
        write_htk_file(str(d / f"u{i}.mfc"), f, 100000, 838)  # MFCC_E_D_A
        mlf += [f'"*/u{i}.lab"', "0 2000000 sil", "2000000 5000000 " + ws[0],
                "5000000 8000000 " + ws[1], "."]
    (d / "words.mlf").write_text("\n".join(mlf) + "\n")
    (d / "copy.scp").write_text(
        "".join(f"u{i}.wav c{i}.mfc\n" for i in range(4)))
    (d / "train.scp").write_text("".join(f"u{i}.mfc\n" for i in range(4)))
    (d / "cfg_wav").write_text("SOURCEFORMAT = WAV\nTARGETKIND = MFCC_E_D_A\n")
    return d


def _feat_files(fp, fj):
    for rel in sorted(fp):
        assert fp[rel][:12] == fj[rel][:12], rel
    return sorted(fp)


def _data(root, rel):
    return read_htk_file(str(root / rel)).data


@pytest.mark.parametrize("extra,argv", [
    ("HPARM: BATCHFRONTEND = F\n", ["-S", "copy.scp"]),
    ("HPARM: BATCHFRONTEND = T\n", ["-S", "copy.scp"]),
    ("TARGETKIND = PLP_E_D_A_Z\nSAVECOMPRESSED = T\nSAVEWITHCRC = T\n",
     ["u1.wav", "c1.mfc"]),
    ("TARGETKIND = FBANK_E\n", ["-s", "300000", "-e", "900000", "u2.wav",
                                "+", "u3.wav", "c2.mfc"]),
    ("", ["-x", "sil", "-I", "words.mlf", "u0.wav", "c0.mfc"]),
    ("SOURCEFORMAT = HTK\nSOURCEKIND = WAVEFORM\n", ["u3.htk", "c3.mfc"]),
    ("SOURCEFORMAT = NOHEAD\nSOURCERATE = 625\nSOURCEKIND = WAVEFORM\n",
     ["u0.raw", "c0.mfc"]),
    ("HPARMOFILTER = cat > $\n", ["u2.wav", "c2.mfc"]),
])
def test_hcopy_waveforms(waves, tmp_path, monkeypatch, capsys, extra, argv):
    (waves / "cfg_case").write_text(
        (waves / "cfg_wav").read_text() + extra)
    fp, fj, _out, _err, (rp, rj) = run_both(
        tmp_path, monkeypatch, capsys, "hcopy",
        ["-C", "cfg_case"] + argv, waves)
    assert rp == rj == 0
    rels = _feat_files(fp, fj)
    assert rels
    close = assert_scaled_close if "PLP" in extra else assert_features_close
    for rel in rels:
        close(_data(tmp_path / "htk_tpu_torch", rel),
              _data(tmp_path / "htk_tpu", rel))


@pytest.mark.parametrize("cfg,argv", [
    ("TARGETKIND = MFCC_E_D_A\n", ["u1.mfc", "o.mfc"]),
    ("SAVECOMPRESSED = T\nSAVEWITHCRC = T\n", ["-S", "pairs.scp"]),
    ("", ["-s", "200000", "-e", "500000", "u2.mfc", "+", "u3.mfc", "o.mfc"]),
    ("TARGETKIND = DISCRETE\nVQTABLE = cb.vq\n", ["u0.mfc", "o.mfc"]),
])
def test_hcopy_features_byte_identical(waves, tmp_path, monkeypatch, capsys,
                                       cfg, argv):
    from htk_tpu_torch.io.vq import VQTable, save_vq

    rng = np.random.default_rng(3)
    save_vq(VQTable(codebooks=[rng.normal(size=(16, 39)).astype(np.float32)]),
            str(waves / "cb.vq"))
    (waves / "pairs.scp").write_text("u0.mfc p0.mfc\nu3.mfc p3.mfc\n")
    (waves / "cfg_f").write_text(cfg)
    assert_same(tmp_path, monkeypatch, capsys, "hcopy",
                ["-C", "cfg_f"] + argv, waves)


def test_wavefile_reads_equal(waves):
    from htk_tpu.io import wavefile as jw

    for name, fmt, rate in (("u0.wav", "WAV", None), ("u0.htk", "HTK", None),
                            ("u0.raw", "NOHEAD", 625)):
        a = read_wave(str(waves / name), fmt=fmt, source_rate=rate)
        b = jw.read_wave(str(waves / name), fmt=fmt, source_rate=rate)
        np.testing.assert_array_equal(a.samples, b.samples)
        assert a.samp_period == b.samp_period


@pytest.mark.parametrize("argv", [
    ["-C", "cfg", "-f", "0.01", "-m", "-M", "hmm0", "-S", "train.scp",
     "proto"],
    ["-C", "cfg", "-m", "-l", "I", "-I", "words.mlf", "-o", "seg", "-M",
     "hmm0", "-S", "train.scp", "proto"],
])
def test_hcompv(waves, tmp_path, monkeypatch, capsys, argv):
    save_mmf(make_proto(nstates=5, dim=39, parm_kind="MFCC_E_D_A"),
             str(waves / "proto"))
    (waves / "cfg").write_text("TARGETKIND = MFCC_E_D_A\n")
    (waves / "hmm0").mkdir(exist_ok=True)
    assert_same(tmp_path, monkeypatch, capsys, "hcompv", argv, waves)


def test_hled(waves, tmp_path, monkeypatch, capsys):
    (waves / "dict").write_text("A  aa\nI  iy\nU  uw iy\nsil  sil\n")
    (waves / "edit.led").write_text(
        "EX\nIS sil sil\nME sp sil sil\nRE ah aa\nDE iy\nSO\nTC\n")
    assert_same(tmp_path, monkeypatch, capsys, "hled",
                ["-d", "dict", "-i", "out.mlf", "edit.led", "words.mlf"],
                waves)


@pytest.fixture(scope="module")
def triset(tmp_path_factory):
    """A triphone set of 2 vowels in 3 contexts with distinct random means,
    its list, a stats file and the monophone set it was cloned from."""
    d = tmp_path_factory.mktemp("triset")
    rng = np.random.default_rng(2)
    mono = ["aa", "iy", "sil"]
    proto = make_proto(nstates=5, dim=6, parm_kind="MFCC")
    save_mmf(clone_proto(proto, "proto", mono), str(d / "mono"))
    (d / "monophones").write_text("\n".join(mono) + "\n")
    tris = [f"{l}-{v}+{r}" for v in ("aa", "iy")
            for l in ("aa", "iy", "sil") for r in ("aa", "iy", "sil")]
    hs = clone_proto(proto, "proto", mono + tris)
    for nm, h in hs.hmms.items():
        for st in h.states:
            mp = st.streams[0].mixes[0]
            mp.mean = rng.normal(size=6).astype(np.float32) * 2.0
            mp.var = (0.5 + rng.random(6)).astype(np.float32)
            mp.fix_gconst()
    save_mmf(hs, str(d / "tri"))
    names = mono + tris
    (d / "trilist").write_text("\n".join(names) + "\n")
    (d / "stats").write_text("".join(
        f'{i + 1} "{nm}" 5 {" ".join(f"{30 + 20 * rng.random():.4f}" for _ in range(3))}\n'
        for i, nm in enumerate(names)))
    return d


def test_hhed_cl_ti_mu(triset, tmp_path, monkeypatch, capsys):
    (triset / "cl.hed").write_text(
        "CL trilist\n"
        "TI T_aa {(*-aa+*,aa+*,*-aa,aa).transP}\n"
        "TI T_iy {(*-iy+*,iy+*,*-iy,iy).transP}\n"
        "MU 3 {*-aa+*.state[2-4].mix}\n"
        "AT 2 4 0.2 {sil.transP}\nRT 1 3 {iy.transP}\nSH\n")
    (triset / "out").mkdir(exist_ok=True)
    assert_same(tmp_path, monkeypatch, capsys, "hhed",
                ["-T", "1", "-H", "mono", "-M", "out", "-w", "out/list",
                 "cl.hed", "monophones"], triset)


def test_hhed_tb_ro_qs_st(triset, tmp_path, monkeypatch, capsys):
    lines = ["RO 40.0 stats"]
    for side, pat in (("L", "{ %s-* }"), ("R", "{ *+%s }")):
        for v in ("aa", "iy", "sil"):
            lines.append(f'QS "{side}_{v}" {pat % v}')
    for v in ("aa", "iy"):
        for st in (2, 3, 4):
            lines.append(f'TB 1.0 "ST_{v}_{st}_" {{("*-{v}+*","{v}+*",'
                         f'"*-{v}","{v}").state[{st}]}}')
    lines += ["ST trees", "MU 2 {*.state[2-4].mix}"]
    (triset / "tie.hed").write_text("\n".join(lines) + "\n")
    (triset / "out").mkdir(exist_ok=True)
    files = assert_same(tmp_path, monkeypatch, capsys, "hhed",
                        ["-T", "1", "-H", "tri", "-M", "out", "tie.hed",
                         "trilist"], triset)
    assert "trees" in files and "out/tri" in files
    # the trees tied something: of the 60 clustered states (2 vowels x
    # 10 models x 3), fewer distinct ones, at least one a tree
    hs = load_mmf(str(tmp_path / "htk_tpu_torch" / "out" / "tri"))
    assert 6 <= len(hs.macros["s"]) < 60


@pytest.mark.parametrize("script", ["RC 4 rtree\n", "XF xf.tmf\n"])
def test_hhed_rc_xf_numbered_error(triset, tmp_path, monkeypatch, capsys,
                                   script):
    from htk_tpu_torch.tools import hhed

    monkeypatch.chdir(triset)
    (triset / "a.hed").write_text(script)
    (triset / "xf.tmf").write_text("~a \"global\"\n")
    rc = hhed.main(["-H", "mono", "-M", str(tmp_path), "a.hed",
                    "monophones"])
    assert rc != 0
    assert "[+2690]" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["wlist", "out.slf"],
    ["-n", "lm.arpa", "wlist", "out.slf"],
    ["-w", "wp", "-s", "SIL", "SIL", "wlist", "out.slf"],
])
def test_hbuild(tmp_path, monkeypatch, capsys, argv):
    d = tmp_path / "in"
    d.mkdir()
    (d / "wlist").write_text("A\nI\nU\nSIL\n")
    (d / "wp").write_text("SIL A I\nA I U SIL\nI A SIL\nU SIL\n")
    (d / "lm.arpa").write_text(
        "\\data\\\nngram 1=6\nngram 2=5\n\n\\1-grams:\n"
        "-1.0 <s> -0.3\n-0.7 </s>\n-0.6 A -0.2\n-0.5 I -0.25\n"
        "-0.9 U -0.1\n-0.8 SIL -0.2\n\n\\2-grams:\n"
        "-0.2 <s> A\n-0.4 A I\n-0.3 I U\n-0.5 U </s>\n-0.1 SIL A\n\n"
        "\\end\\\n")
    assert_same(tmp_path, monkeypatch, capsys, "hbuild", argv, d)


@pytest.mark.parametrize("flags", [[], ["-t", "-f"], ["-p", "-s"],
                                   ["-e", "X", "U", "-d", "2"],
                                   ["-k", "u%*", "-n"]])
def test_hresults(tmp_path, monkeypatch, capsys, flags):
    d = tmp_path / "in"
    d.mkdir()
    ref = ["#!MLF!#"]
    rec = ["#!MLF!#"]
    rng = np.random.default_rng(4)
    words = ["A", "I", "U"]
    for i in range(5):
        ws = [words[int(k)] for k in rng.integers(0, 3, size=4)]
        hyp = list(ws)
        if i % 2:
            hyp[1] = words[(words.index(hyp[1]) + 1) % 3]
        if i == 3:
            hyp.insert(2, "A")
        ref += [f'"*/u{i}.lab"', *ws, "."]
        rec += [f'"*/u{i}.rec"', *(f"{k * 100000} {(k + 1) * 100000} {w}"
                                   for k, w in enumerate(hyp)), "///",
                *ws[:3], "."]
    (d / "ref.mlf").write_text("\n".join(ref) + "\n")
    (d / "rec.mlf").write_text("\n".join(rec) + "\n")
    (d / "list").write_text("A\nI\nU\n")
    fp, fj, (op, oj), _e, (rp, rj) = run_both(
        tmp_path, monkeypatch, capsys, "hresults",
        flags + ["-I", "ref.mlf", "list", "rec.mlf"], d)
    assert rp == rj == 0 and fp == fj == {}
    assert op == oj and "Ref : ref.mlf" in op


def test_proto_make_and_clone_equal():
    from htk_tpu.models import proto as jproto
    from htk_tpu.io import mmf as jmmf

    for kw in (dict(), dict(nstates=4, dim=13, parm_kind="PLP_0", nmix=2)):
        a = make_proto(**kw)
        b = jproto.make_proto(**kw)
        ca = clone_proto(a, "proto", ["x", "y"])
        cb = jproto.clone_proto(b, "proto", ["x", "y"])
        assert _mmf_text(ca, save_mmf) == _mmf_text(cb, jmmf.save_mmf)


def _mmf_text(hs, save):
    import tempfile

    with tempfile.TemporaryDirectory() as t:
        p = os.path.join(t, "m")
        save(hs, p)
        with open(p, "rb") as f:
            return f.read()
