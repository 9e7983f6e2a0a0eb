"""Live mode of the port against htk_tpu's, on the CPU.

Each class of tests/test_streaming.py has a counterpart here, and both
packages run on the same numpy-seeded inputs:

- audio sources (io/audio.py): the same samples, chunk for chunk, and
  HError 6106 with no source;
- the streaming frontend (ops/stream.py): port against htk_tpu's on the
  same samples fed in the same random sizes, and against the port's own
  batch `compute_features`, at the frontend's tolerances
  (tests/_torch_compare.py: max |diff| 1e-3, mean 2e-5; PLP relative to
  its largest value, 5e-5 and 2e-6); the refusals by number;
- decode_scan with a carried state (plain version): a run cut into
  chunks at every tested point gives exactly the unsplit run's records
  and finals;
- the streaming decoder (algo/stream_decode.py): words and times equal
  to htk_tpu's at chunk 16 and the score within 1e-5 relative (the two
  packages' OutP matmuls round differently), and exactly the port's
  batch `decode` (the same plain recursion on the same OutP);
- HVite live (`live.mlf` byte-identical to htk_tpu's, the same words on
  the `live [` partial lines), HCopy live capture (byte-identical to the
  port's HCopy of the file, htk_tpu's within the frontend tolerance) and
  HList on a live source (headers identical, values within the frontend
  tolerance plus half of HList's last printed digit).
"""

import os
import shutil

import numpy as np
import pytest
import torch

import htk_tpu.algo.decode as j_decode
import htk_tpu.algo.net as j_net
import htk_tpu.algo.stream_decode as j_sd
import htk_tpu.io.audio as j_audio
import htk_tpu.io.dictionary as j_dict
import htk_tpu.io.mmf as j_mmf
import htk_tpu.io.slf as j_slf
import htk_tpu.models.hmmset as j_hmmset
import htk_tpu.ops.dsp as j_dsp
import htk_tpu.ops.stream as j_stream
from htk_tpu.utils.config import Config as JConfig
from htk_tpu.utils.errors import HTKError as JHTKError

from htk_tpu_torch.algo.decode import decode, scorer_for
from htk_tpu_torch.algo.lvnet import compile_lv_loop
from htk_tpu_torch.algo.net import compile_network, word_internal_phone_map
from htk_tpu_torch.algo.stream_decode import StreamingDecoder
from htk_tpu_torch.io import audio
from htk_tpu_torch.io import parmkind as pk
from htk_tpu_torch.io.dictionary import read_dict
from htk_tpu_torch.io.htkfeat import read_htk_file
from htk_tpu_torch.io.lm import read_arpa
from htk_tpu_torch.io.mmf import load_mmf
from htk_tpu_torch.io.slf import read_slf
from htk_tpu_torch.io.wavefile import Waveform, write_wave
from htk_tpu_torch.models.hmmset import compile_hmmset
from htk_tpu_torch.ops import decode_scan as ds
from htk_tpu_torch.ops.dsp import FrontendConfig, compute_features
from htk_tpu_torch.ops.stream import StreamingFrontend
from htk_tpu_torch.synth import random_decode_net, write_system
from htk_tpu_torch.tools import hcopy, hlist, hvite
from htk_tpu_torch.utils.config import Config
from htk_tpu_torch.utils.errors import HTKError

from _synth import synth_utterance, write_wav
from _torch_compare import (FE_MAX, assert_features_close,  # noqa: F401
                            assert_scaled_close, one_torch_thread, run_both)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The port's tools run on the card unless the CPU is asked for."""
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def _wave(seed=3):
    rng = np.random.default_rng(seed)
    return synth_utterance(["sil", "aa", "iy", "sil"], rng).astype(np.float32)


def _read_all(src, n):
    src.start()
    got = []
    while (c := src.read(n)) is not None:
        got.append(c)
    src.stop()
    return np.concatenate(got)


# ---------------------------------------------------------------------------
# audio sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 256, 1000, 5000])
def test_array_source_chunks(n):
    x = np.arange(3000, dtype=np.int16)
    got = _read_all(audio.ArrayAudio(x, samp_period=625), n)
    assert np.array_equal(got, x)
    assert np.array_equal(got, _read_all(j_audio.ArrayAudio(x, 625), n))


def _write_nist(path, x):
    hdr = (b"NIST_1A\n   1024\nsample_rate -i 16000\nsample_n_bytes -i 2\n"
           b"sample_byte_format -s2 01\nend_head\n")
    with open(path, "wb") as f:
        f.write(hdr.ljust(1024, b" ") + x.astype("<i2").tobytes())


@pytest.mark.parametrize("fmt", ["WAV", "NIST", "HTK"])
def test_file_replay(tmp_path, fmt):
    x = (1000 * np.sin(np.arange(4000) / 10)).astype(np.int16)
    p = str(tmp_path / "a.snd")
    if fmt == "NIST":
        _write_nist(p, x)
    else:
        write_wave(p, Waveform(x, 625), fmt=fmt)
    assert audio._sniff_format(p) == j_audio._sniff_format(p) == fmt
    src = audio.FileReplayAudio(p)
    assert src.samp_period == j_audio.FileReplayAudio(p).samp_period == 625
    got = _read_all(src, 1024)
    assert np.array_equal(got, x)
    assert np.array_equal(got, _read_all(j_audio.FileReplayAudio(p), 1024))


def test_open_audio_input_config(tmp_path):
    write_wav(str(tmp_path / "b.wav"), np.arange(100, dtype=np.int16))
    cfg, jcfg = Config(), JConfig()
    for c in (cfg, jcfg):
        c.set("AUDIOSOURCE", str(tmp_path / "b.wav"), module="HAUDIO")
    src = audio.open_audio_input(cfg)
    assert isinstance(src, audio.FileReplayAudio)
    assert np.array_equal(_read_all(src, 7),
                          _read_all(j_audio.open_audio_input(jcfg), 7))
    with pytest.raises(HTKError) as e:
        audio.open_audio_input(Config())
    with pytest.raises(JHTKError) as je:
        j_audio.open_audio_input(JConfig())
    assert e.value.code == je.value.code == 6106


# ---------------------------------------------------------------------------
# streaming frontend
# ---------------------------------------------------------------------------

def _stream(sf, wave, seed=0):
    """`wave` through a streaming frontend in random feed sizes."""
    rng = np.random.default_rng(seed)
    pos, out = 0, []
    while pos < len(wave):
        n = int(rng.integers(40, 2000))
        got = sf.feed(wave[pos: pos + n])
        if got.size:
            out.append(got)
        pos += n
    tail = sf.flush()
    if tail.size:
        out.append(tail)
    return np.concatenate(out, axis=0)


@pytest.mark.parametrize("kind", ["MFCC_E_D_A", "MFCC_0_D", "FBANK_D_A",
                                  "MFCC_E_D_A_T", "PLP_E_D_A"])
def test_frontend_matches_reference(kind):
    wave = _wave()
    code = pk.str2parmkind(kind)
    cfg = FrontendConfig(target_kind=code, enormalise=False)
    jcfg = j_dsp.FrontendConfig(target_kind=code, enormalise=False)
    got = _stream(StreamingFrontend(cfg, device="cpu"), wave)
    ref = _stream(j_stream.StreamingFrontend(jcfg), wave)
    batch = compute_features(wave, cfg, device="cpu")
    assert got.shape == ref.shape == batch.shape
    close = assert_scaled_close if kind.startswith("PLP") \
        else assert_features_close
    close(got, ref)
    close(got, batch)


def test_frontend_z_with_cepmean():
    wave = _wave(seed=5)
    code = pk.str2parmkind("MFCC_E_D_Z")
    cfg_nz = FrontendConfig(target_kind=pk.str2parmkind("MFCC_E"),
                            enormalise=False)
    statics = compute_features(wave, cfg_nz, device="cpu")
    mean = statics[:, :-1].mean(axis=0)
    sf = StreamingFrontend(FrontendConfig(target_kind=code,
                                          enormalise=False),
                           cepmean=mean, device="cpu")
    got = np.concatenate([sf.feed(wave), sf.flush()], axis=0)
    jsf = j_stream.StreamingFrontend(
        j_dsp.FrontendConfig(target_kind=code, enormalise=False),
        cepmean=mean)
    ref = np.concatenate([jsf.feed(wave), jsf.flush()], axis=0)
    assert_features_close(got, ref)
    want = statics.copy()
    want[:, :-1] -= mean
    assert_features_close(got[:, :want.shape[1]], want)


def _refusal(mod, cfg_cls, case):
    kind, enorm = {"enormalise": ("MFCC_E", True), "z": ("MFCC_Z", False),
                   "c": ("MFCC_C", False), "k": ("MFCC_K", False),
                   "v": ("MFCC_V", False), "feed_after_flush":
                   ("MFCC_E", False), "n": ("MFCC_D_N", False)}[case]
    sf = mod.StreamingFrontend(
        cfg_cls(target_kind=pk.str2parmkind(kind), enormalise=enorm),
        **({"device": "cpu"} if mod is not j_stream else {}))
    if case == "feed_after_flush":
        sf.flush()
    sf.feed(_wave()[:4000])
    sf.flush()


@pytest.mark.parametrize("case,code", [
    ("enormalise", 6324), ("z", 6324), ("c", 6324), ("k", 6324),
    ("v", 6324), ("feed_after_flush", 6325), ("n", 6321)])
def test_frontend_refusals(case, code):
    import htk_tpu_torch.ops.stream as p_stream

    with pytest.raises(HTKError) as e:
        _refusal(p_stream, FrontendConfig, case)
    with pytest.raises(JHTKError) as je:
        _refusal(j_stream, j_dsp.FrontendConfig, case)
    assert e.value.code == je.value.code == code


# ---------------------------------------------------------------------------
# decode_scan with a carried state
# ---------------------------------------------------------------------------

def _operands(net, wpen=-1.0):
    nos, outp, band, a0, aE, bonus, trans, start = [
        torch.as_tensor(a) for a in net]
    Nn = trans.shape[0]
    return [outp, band, a0, aE, nos, bonus, trans, start,
            torch.full((Nn,), wpen), Nn]


def _chunked(args, cuts):
    """decode_scan over frames cut at `cuts`, the state carried across."""
    outp = args[0]
    carry, recs = None, []
    edges = [0] + list(cuts) + [outp.shape[1]]
    for a, b in zip(edges[:-1], edges[1:]):
        carry, r = ds.decode_scan(outp[:, a:b].contiguous(), *args[1:],
                                  init=carry, t0=a)
        recs.append(r)
    return carry, tuple(torch.cat(p, dim=1) for p in zip(*recs))


def _assert_equal(got, ref):
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, False),
                                       (3, True), (4, True)])
def test_carry_cut_equals_unsplit(seed, ties):
    T = 24
    args = _operands(random_decode_net(seed, Ns=40, Nn=6, K=3, B=2, T=T,
                                       ties=ties))
    ref = ds.decode_scan(*args)
    assert (ref[1][1] >= 0).sum() > 10  # records really flow
    for cuts in ([1], [T - 1], [T // 3], [5, 6, 16], list(range(1, T))):
        _assert_equal(_chunked(args, cuts), ref)


def test_carry_none_at_zero_is_unchanged():
    args = _operands(random_decode_net(0, B=2, T=16))
    _assert_equal(ds.decode_scan_plain(*args, init=None, t0=0),
                  ds.decode_scan_plain(*args))


def test_carry_checks_raise():
    args = _operands(random_decode_net(0, B=2, T=8))
    (v, wn, wt), _ = ds.decode_scan(*args)
    for bad in ((v[:1], wn, wt), (v, wn.float(), wt), (v, wn),
                (v.t().contiguous().t(), wn, wt)):
        with pytest.raises(ValueError):
            ds.decode_scan(*args, init=bad, t0=8)
    with pytest.raises(ValueError):
        ds.decode_scan(*args, init=(v, wn, wt), t0=-1)


# ---------------------------------------------------------------------------
# streaming decoder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def system(tmp_path_factory):
    """A small write_system system loaded by both packages."""
    root = str(tmp_path_factory.mktemp("sys"))
    s = write_system(root, n_words=8, n_phones=8, n_tied=24, n_mix=2,
                     n_utts=3, min_frames=70, max_frames=130, fanout=3)
    vocab = read_dict(s.dict)
    comp = compile_hmmset(load_mmf([s.hmmdefs]))
    net = compile_network(read_slf(s.wdnet), vocab, comp,
                          phone_map=word_internal_phone_map(comp.names))
    jvocab = j_dict.read_dict(s.dict)
    jcomp = j_hmmset.compile_hmmset(j_mmf.load_mmf([s.hmmdefs]))
    jnet = j_net.compile_network(
        j_slf.read_slf(s.wdnet), jvocab, jcomp,
        phone_map=j_net.word_internal_phone_map(jcomp.names))
    feats = [read_htk_file(os.path.join(root, f"utt{i:03d}.mfc")).data
             for i in range(3)]
    return dict(s=s, vocab=vocab, comp=comp, net=net, jcomp=jcomp,
                jnet=jnet, feats=feats)


def _feed_random(sd, x, seed):
    rng = np.random.default_rng(seed)
    pos = 0
    while pos < len(x):
        n = int(rng.integers(1, 25))
        sd.feed(x[pos: pos + n])
        pos += n
    return sd.flush()


@pytest.mark.parametrize("utt", [0, 1, 2])
def test_decoder_matches_reference_and_batch(system, utt):
    f = system["feats"][utt]
    got = _feed_random(StreamingDecoder(system["net"], system["comp"], 1.0,
                                        -2.0, chunk=16, device="cpu"),
                       f, utt)
    ref = _feed_random(j_sd.StreamingDecoder(system["jnet"], system["jcomp"],
                                             1.0, -2.0, chunk=16), f, utt)
    batch = decode(system["net"], system["comp"], f, 1.0, -2.0,
                   device="cpu")
    assert got is not None and ref is not None and got.words
    assert got.words == ref.words and got.times == ref.times
    assert got.score == pytest.approx(ref.score, rel=1e-5, abs=0)
    assert (got.words, got.times, got.score, got.word_nodes) == (
        batch.words, batch.times, batch.score, batch.word_nodes)
    # the reference's own stream equals its batch decode as well
    jb = j_decode.decode(system["jnet"], system["jcomp"], f, 1.0, -2.0)
    assert (ref.words, ref.times) == (jb.words, jb.times)


def test_decoder_partial_results(system):
    f = system["feats"][1]
    sd = StreamingDecoder(system["net"], system["comp"], word_pen=-2.0,
                          chunk=12, device="cpu")
    jsd = j_sd.StreamingDecoder(system["jnet"], system["jcomp"],
                                word_pen=-2.0, chunk=12)
    assert sd.partial_result() is None
    for i in range(0, len(f), 12):
        sd.feed(f[i: i + 12])
        jsd.feed(f[i: i + 12])
        r, jr = sd.partial_result(), jsd.partial_result()
        assert (r is None) == (jr is None)
        if r is not None:
            assert (r.words, r.times) == (jr.words, jr.times)
        assert sd.frames_processed == jsd.frames_processed
    last = sd.partial_result()
    final = sd.flush()
    assert final is not None and tuple(last.words) == tuple(final.words)


def test_decoder_state_mode_matches_batch(system):
    f = system["feats"][0]
    scores = scorer_for(system["comp"], "cpu")(torch.as_tensor(f)).numpy()
    ref = decode(system["net"], system["comp"], f, word_pen=-2.0,
                 state_scores=scores, device="cpu")
    sd = StreamingDecoder(system["net"], None, word_pen=-2.0, chunk=16,
                          state_mode=True, device="cpu")
    for i in range(0, len(scores), 13):
        sd.feed(scores[i: i + 13])
    got = sd.flush()
    assert ref is not None and got is not None
    assert (got.words, got.times, got.score) == (ref.words, ref.times,
                                                 ref.score)


def test_decoder_refusals(system):
    s = system["s"]
    lv = compile_lv_loop(list(system["vocab"].words), system["vocab"],
                         system["comp"], lm=read_arpa(s.lm),
                         phone_map=word_internal_phone_map(
                             system["comp"].names))
    with pytest.raises(HTKError) as e:
        StreamingDecoder(lv, system["comp"], device="cpu")
    assert e.value.code == 8521
    sd = StreamingDecoder(system["net"], system["comp"], device="cpu")
    assert sd.flush() is None  # no frames: no result
    with pytest.raises(HTKError) as e:
        sd.feed(system["feats"][0][:5])
    assert e.value.code == 8522
    with pytest.raises(HTKError) as e:
        sd.flush()
    assert e.value.code == 8522


# ---------------------------------------------------------------------------
# HVite live, HCopy and HList live capture
# ---------------------------------------------------------------------------

LIVE_CFG = ("SOURCEFORMAT = WAV\nTARGETKIND = MFCC_E_D_A\nENORMALISE = F\n"
            "SOURCEKIND = HAUDIO\n")


@pytest.fixture(scope="module")
def live_dir(system, tmp_path_factory):
    """The system's files, a 2.5 s utterance and live configs."""
    d = tmp_path_factory.mktemp("live")
    s = system["s"]
    for p in (s.dict, s.hmmdefs, s.hmmlist, s.wdnet):
        shutil.copy(p, d)
    rng = np.random.default_rng(21)
    write_wav(str(d / "u.wav"), synth_utterance(
        ["sil", "aa", "iy", "sil", "uw", "aa", "sil", "iy", "uw", "sil",
         "aa", "sil"], rng))
    (d / "cfg_live").write_text(LIVE_CFG + "HAUDIO: AUDIOSOURCE = u.wav\n")
    (d / "cfg_nosrc").write_text(LIVE_CFG)
    (d / "cfg_file").write_text("SOURCEFORMAT = WAV\nTARGETKIND = "
                                "MFCC_E_D_A\nENORMALISE = F\n")
    return d


def _partials(out):
    return [ln.split(":", 1)[1].split() for ln in out.splitlines()
            if ln.startswith("live [")]


def test_hvite_live_matches_reference(live_dir, tmp_path, monkeypatch,
                                      capsys):
    fp, fj, (op, oj), _err, (rp, rj) = run_both(
        tmp_path, monkeypatch, capsys, "hvite",
        ["-C", "cfg_live", "-T", "2", "-w", "wdnet.slf", "-p", "-10", "-i",
         "live.mlf", "-H", "hmmdefs", "dict", "hmmlist"], live_dir)
    assert rp == rj == 0
    assert sorted(fp) == sorted(fj) == ["live.mlf"]
    assert fp["live.mlf"] == fj["live.mlf"]
    assert fp["live.mlf"].decode().count("\n") > 3  # words with times
    parts = _partials(op)
    assert len(parts) >= 5 and parts == _partials(oj)
    assert "live:" in op


def test_hvite_live_refusals(live_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(live_dir)
    base = ["-w", "wdnet.slf", "-H", "hmmdefs", "dict", "hmmlist"]
    for argv, code in ((base, 1030), (["-C", "cfg_file"] + base, 1030),
                       (["-C", "cfg_nosrc"] + base, 6106)):
        with pytest.raises(HTKError) as e:
            hvite.run(argv)
        assert e.value.code == code


def test_hcopy_live_capture(live_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(live_dir)
    assert hcopy.run(["-C", "cfg_file", "u.wav", str(tmp_path / "a.mfc")]) == 0
    assert hcopy.run(["-C", "cfg_nosrc", "u.wav",
                      str(tmp_path / "b.mfc")]) == 0
    with open(tmp_path / "a.mfc", "rb") as fa, \
            open(tmp_path / "b.mfc", "rb") as fb:
        assert fa.read() == fb.read()
    fp, fj, _out, _err, (rp, rj) = run_both(
        tmp_path / "both", monkeypatch, capsys, "hcopy",
        ["-C", "cfg_nosrc", "u.wav", "c.mfc"], live_dir)
    assert rp == rj == 0 and sorted(fp) == sorted(fj) == ["c.mfc"]
    assert fp["c.mfc"][:12] == fj["c.mfc"][:12]
    assert_features_close(
        read_htk_file(str(tmp_path / "both" / "htk_tpu_torch" /
                          "c.mfc")).data,
        read_htk_file(str(tmp_path / "both" / "htk_tpu" / "c.mfc")).data)


def test_hlist_live_matches_reference(live_dir, tmp_path, monkeypatch,
                                      capsys):
    _fp, _fj, (op, oj), _err, (rp, rj) = run_both(
        tmp_path, monkeypatch, capsys, "hlist",
        ["-C", "cfg_live", "-t", "-s", "0", "-e", "40", "u.wav"], live_dir)
    assert rp == rj == 0
    gp, gj = op.splitlines(), oj.splitlines()
    assert len(gp) == len(gj) > 40
    n_rows = 0
    for a, b in zip(gp, gj):
        # a frame's values: "    t: v v ..." and its continuation lines
        ha, va = a.split(":", 1) if ":" in a else ("", a)
        hb, vb = b.split(":", 1) if ":" in b else ("", b)
        if ha.strip().isdigit() or (not ha and a.startswith(" " * 8)):
            n_rows += bool(ha)
            assert ha == hb
            np.testing.assert_allclose(np.array(va.split(), float),
                                       np.array(vb.split(), float),
                                       atol=FE_MAX + 5e-4, rtol=0)
        else:
            assert a == b
    assert n_rows == 41
    # the same listing as the port's HList of the file itself
    capsys.readouterr()
    monkeypatch.chdir(live_dir)
    assert hlist.run(["-C", "cfg_file", "-t", "-s", "0", "-e", "40",
                      "u.wav"]) == 0
    assert capsys.readouterr().out == op
