"""The port's file readers against htk_tpu's on corrupt input.

The twin of tests/test_fuzz_readers.py, on its `_mutations` corpus (each
format's small valid file truncated at spread-out byte offsets, single
bytes flipped at seeded offsets, an empty file, zeros and text in no
format). For every mutation both packages must either parse to equal
results or raise an HTKError with the same number; any other exception
from either is a failure too. The readers that go through the port's
native codecs (HTK feature files, MLFs, ARPA LMs) are the ones whose
error paths the codecs change; the rest are copied host code.
"""

import dataclasses
from collections import Counter

import numpy as np
import pytest

from htk_tpu.utils.errors import HTKError as JHTKError
from htk_tpu_torch.utils.errors import HTKError

from _torch_compare import one_torch_thread  # noqa: F401
from test_fuzz_readers import _mutations


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def same(a, b, where="result"):
    """Structural equality across the two packages' classes: the same
    class name, equal fields, arrays equal in dtype, shape and value (NaN
    equal to NaN), dicts equal key for key."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), where
        return
    assert type(a).__name__ == type(b).__name__, (where, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, float):
        assert a == b or (a != a and b != b), where
    elif dataclasses.is_dataclass(a):
        same({f.name: getattr(a, f.name) for f in dataclasses.fields(a)},
             {f.name: getattr(b, f.name) for f in dataclasses.fields(b)},
             where)
    elif hasattr(a, "__dict__"):
        same(vars(a), vars(b), where)
    else:
        assert a == b, where


def lm_view(lm):
    """An LM by what its reader built: its class, order and tables (a
    packed LM's arrays as read; its dicts are made from them on first
    use, and a damaged binary LM's word ids, which neither package's
    reader checks, would fail there in both)."""
    if hasattr(lm, "_packs"):
        return type(lm).__name__, lm.order, lm._packs
    return (type(lm).__name__, lm.order, lm.unigrams, lm.bigrams,
            lm.trigrams, lm.tri_bo, lm.fourgrams)


def mlf_view(m):
    return [(pat, [[(lab.name, lab.start, lab.end, lab.score, lab.aux)
                    for lab in alt] for alt in tr.alternatives])
            for pat, tr in m.entries]


def outcome(reader, path, error):
    try:
        return "ok", reader(path)
    except error as e:
        return "error", e.code


def assert_same_outcomes(port, ref, blob, tmp_path, name, view=None):
    """Every mutation of `blob` through the port's reader and htk_tpu's."""
    p = str(tmp_path / name)
    for i, mut in enumerate(_mutations(blob)):
        with open(p, "wb") as f:
            f.write(mut)
        got = outcome(port, p, HTKError)
        ref_ = outcome(ref, p, JHTKError)
        assert got[0] == ref_[0], (name, i, got, ref_)
        if got[0] == "error":
            assert got[1] == ref_[1], (name, i, got[1], ref_[1])
        elif view is not None:
            same(view(got[1]), view(ref_[1]), f"{name} mutation {i}")
        else:
            same(got[1], ref_[1], f"{name} mutation {i}")


def feature_blob(tmp_path, kind, seed, shape, scale):
    from htk_tpu_torch.io.htkfeat import write_htk_file
    from htk_tpu_torch.io.parmkind import str2parmkind

    x = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    p = str(tmp_path / "a.mfc")
    write_htk_file(p, x, 100000, str2parmkind(kind))
    return open(p, "rb").read()


FEATURE_CASES = [("USER_E", 0, (20, 6), 1.0), ("USER_C_K", 1, (30, 4), 4.0),
                 ("MFCC_E_C", 2, (25, 5), 8.0)]


@pytest.mark.parametrize("kind, seed, shape, scale", FEATURE_CASES)
def test_fuzz_htk_feature_file(tmp_path, kind, seed, shape, scale):
    from htk_tpu.io import htkfeat as jf
    from htk_tpu_torch.io import htkfeat as pf

    blob = feature_blob(tmp_path, kind, seed, shape, scale)
    assert_same_outcomes(pf.read_htk_file, jf.read_htk_file, blob,
                         tmp_path, "feat.mfc")


def assert_within_a_rounding(got, ref, what):
    """Equal, or a `_C` file's float32 decompression against the numpy
    reader's float64 one: one float32 rounding apart."""
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    assert (np.abs(got - ref) <= np.spacing(np.abs(ref))).all(), what


@pytest.mark.parametrize("kind, seed, shape, scale", FEATURE_CASES)
def test_fuzz_native_feature_loaders(tmp_path, kind, seed, shape, scale):
    """The native single-file and batch loaders on every mutation: each
    file they take gives the numpy reader's data, and a header that
    promises more than the file holds is declined before the codec
    (which trusts it) runs. htk_tpu's loaders pass such headers to the
    codec, which reads past its buffers, so they are not run here."""
    from htk_tpu_torch.io.htkfeat import read_htk_file, read_htk_file_fast
    from htk_tpu_torch.tools._common import open_speech_file, preload_corpus
    from htk_tpu_torch.utils.config import Config

    blob = feature_blob(tmp_path, kind, seed, shape, scale)
    paths = []
    for i, mut in enumerate(_mutations(blob)):
        p = str(tmp_path / f"m{i}.mfc")
        with open(p, "wb") as f:
            f.write(mut)
        paths.append(p)
        fast = read_htk_file_fast(p)
        if fast is not None:
            ref = read_htk_file(p)
            assert_within_a_rounding(fast.data, ref.data, f"fast {i}")
            assert (fast.samp_period, fast.parm_kind) == (
                ref.samp_period, ref.parm_kind)
    pre = preload_corpus(paths, Config())
    if "_C" in kind:
        assert len(pre) > len(paths) // 2
    for p, (data, period, pkind, _e) in pre.items():
        ref = open_speech_file(p, Config())
        assert_within_a_rounding(data, ref[0], f"preload {p}")
        assert (period, pkind) == ref[1:3]


def test_fuzz_mlf(tmp_path):
    from htk_tpu.io.mlf import MLF as JMLF
    from htk_tpu_torch.io.mlf import MLF

    blob = (b'#!MLF!#\n"*/u0.lab"\n0 1000000 aa -1.5\nsil\n.\n'
            b'"*/u1.lab"\nbb\ncc\n.\n')
    assert_same_outcomes(MLF.load, JMLF.load, blob, tmp_path, "l.mlf",
                         view=mlf_view)


ARPA = (b"\\data\\\nngram 1=3\nngram 2=2\n\n\\1-grams:\n"
        b"-1 a -0.3\n-1 b -0.2\n-2 c\n\n\\2-grams:\n"
        b"-0.5 a b\n-0.4 b c\n\n\\end\\\n")


def test_fuzz_arpa(tmp_path, monkeypatch):
    from htk_tpu.io import lm as jl
    from htk_tpu_torch.io import lm as pl

    assert_same_outcomes(pl.read_lm, jl.read_lm, ARPA, tmp_path, "lm.arpa",
                         view=lm_view)

    # the Python readers alone (htk_tpu's with its codec switched off)
    def j_plain(p):
        with monkeypatch.context() as m:
            m.setenv("HTKTPU_NO_NATIVE", "1")
            return jl.read_arpa(p)

    assert_same_outcomes(pl.read_arpa_plain, j_plain, ARPA, tmp_path,
                         "lm2.arpa", view=lm_view)


def test_fuzz_arpa_codec_equals_plain_version(tmp_path):
    """On every mutation the codec and its plain version in Python give
    the same packs, or both reject the file."""
    from htk_tpu_torch import native

    p = str(tmp_path / "c.arpa")
    for i, mut in enumerate(_mutations(ARPA)):
        with open(p, "wb") as f:
            f.write(mut)
        same(native.parse_arpa_plain(p), native.parse_arpa(p),
             f"mutation {i}")


def test_fuzz_binary_lm(tmp_path):
    from htk_tpu.io import lm as jl
    from htk_tpu_torch.io import lm as pl

    src = str(tmp_path / "src.arpa")
    open(src, "wb").write(ARPA)
    binp = str(tmp_path / "lm.bin")
    pl.write_binary_lm(pl.read_lm(src), binp)
    assert_same_outcomes(pl.read_lm, jl.read_lm, open(binp, "rb").read(),
                         tmp_path, "b.bin", view=lm_view)


def test_fuzz_matrix_bigram(tmp_path):
    from htk_tpu.io import lm as jl
    from htk_tpu_torch.io import lm as pl

    lm = pl.NGramLM(order=2)
    lm.unigrams = {"a": (-1.0, 0.0), "b": (-1.0, 0.0)}
    lm.bigrams = {("a", "b"): (-0.5, 0.0)}
    p = str(tmp_path / "m.bg")
    pl.write_matrix_bigram(lm, ["a", "b"], p)
    assert_same_outcomes(pl.read_lm, jl.read_lm, open(p, "rb").read(),
                         tmp_path, "m2.bg", view=lm_view)


TEXT_FORMATS = {
    "dictionary": ("htk_tpu_torch.io.dictionary:read_dict",
                   b"a  [A] 0.9 aa ax\nb  b iy\nc  [C] c aa c\n"),
    "slf": ("htk_tpu_torch.io.slf:read_slf",
            b"VERSION=1.0\nN=3 L=2\n"
            b"I=0 t=0.0\nI=1 t=0.5 W=hello\nI=2 t=1.0 W=world\n"
            b"J=0 S=0 E=1 a=-5.0 l=-1.0\nJ=1 S=1 E=2 a=-6.0 l=-2.0\n"),
    "hmm list": ("htk_tpu_torch.io.mmf:load_hmm_list", b"aa\nbb phys\ncc\n"),
    "baseclass": ("htk_tpu_torch.algo.adapt:load_baseclass",
                  b"~b \"global\"\n<MMFIDMASK> *\n<PARAMETERS> MIXBASE\n"
                  b"<NUMCLASSES> 1\n<CLASS> 1 {*.state[2-4].mix[1-8]}\n"),
}


def both(spec):
    """The port's function named by `module:function` and htk_tpu's."""
    import importlib

    mod, fn = spec.split(":")
    return (getattr(importlib.import_module(mod), fn),
            getattr(importlib.import_module(
                mod.replace("htk_tpu_torch", "htk_tpu", 1)), fn))


@pytest.mark.parametrize("fmt", list(TEXT_FORMATS))
def test_fuzz_text_formats(tmp_path, fmt):
    spec, blob = TEXT_FORMATS[fmt]
    port, ref = both(spec)
    assert_same_outcomes(port, ref, blob, tmp_path, "f.txt")


@pytest.mark.parametrize("binary", [False, True], ids=["text", "binary"])
def test_fuzz_mmf(tmp_path, binary):
    from htk_tpu_torch.io.mmf import save_mmf
    from htk_tpu_torch.models.proto import clone_proto, make_proto

    port, ref = both("htk_tpu_torch.io.mmf:load_mmf")
    hs = make_proto(nstates=4, dim=3, parm_kind="USER")
    cl = clone_proto(hs, "proto", ["aa", "bb"])
    p = str(tmp_path / "mmf")
    save_mmf(cl, p, binary=binary)
    assert_same_outcomes(lambda q: port([q]), lambda q: ref([q]),
                         open(p, "rb").read(), tmp_path, "m.mmf")


@pytest.mark.parametrize("fmt", ["WAV", "HTK"])
def test_fuzz_wave(tmp_path, fmt):
    from htk_tpu_torch.io.wavefile import Waveform, write_wave

    port, ref = both("htk_tpu_torch.io.wavefile:read_wave")
    x = (np.random.default_rng(2).normal(size=400) * 3000).astype(np.int16)
    p = str(tmp_path / "a.wav")
    write_wave(p, Waveform(samples=x, samp_period=625), fmt=fmt)
    assert_same_outcomes(lambda q: port(q, fmt=fmt),
                         lambda q: ref(q, fmt=fmt), open(p, "rb").read(),
                         tmp_path, "w.wav")


def test_fuzz_vq_table(tmp_path):
    from htk_tpu_torch.io.vq import VQTable, save_vq

    port, ref = both("htk_tpu_torch.io.vq:load_vq")
    rng = np.random.default_rng(7)
    p = str(tmp_path / "t.vq")
    save_vq(VQTable(codebooks=[rng.normal(size=(8, 4)).astype(
        np.float32)]), p)
    assert_same_outcomes(port, ref, open(p, "rb").read(), tmp_path, "f.vq")


def test_fuzz_gram_file(tmp_path):
    from htk_tpu_torch.tools.lgram import write_gram

    port, ref = both("htk_tpu_torch.tools.lgram:read_gram")
    p = str(tmp_path / "g.gram")
    write_gram(p, 2, Counter({("a", "b"): 3, ("b", "c"): 1, ("a", "c"): 2}))
    assert_same_outcomes(port, ref, open(p, "rb").read(), tmp_path,
                         "f.gram")


def test_fuzz_tmf(tmp_path):
    from htk_tpu_torch.algo.adapt import Transform, save_tmf

    port, ref = both("htk_tpu_torch.algo.adapt:load_tmf")
    p = str(tmp_path / "t.tmf")
    save_tmf(p, "spk01", Transform(kind="MLLRMEAN", A=np.eye(3),
                                   b=np.zeros(3)))
    assert_same_outcomes(port, ref, open(p, "rb").read(), tmp_path, "f.tmf")
