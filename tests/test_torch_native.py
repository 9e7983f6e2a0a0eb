"""The port's host runtime in C++ (htk_tpu_torch/native) against htk_tpu's.

The twin of tests/test_native.py: each of its cases runs through both
packages on the same seeded files. The two libraries are built from the
same sources, so their outputs are held equal exactly: the CRC, the batch
loader's arena, the MLF scanner's entries, the ARPA codec's packs and the
LMs read through it. The port has no toolchain-less leg: its readers
always take the codec, and its Python ARPA reader (`read_arpa_plain`) is
the plain version the codec is held against, as htk_tpu's reader with
HTKTPU_NO_NATIVE set is for htk_tpu's codec.

Also here: the fault the codec closes (a duplicated n-gram line, which
htk_tpu's codec keeps and maxes over in the LV loop's tables, where a
dict reader keeps the last line), the ARPA codec against its plain
version in Python, HError 1094 when no compiler is on PATH, and builders
racing for one library.
"""

import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import htk_tpu.native as j_native
from htk_tpu.algo import lvnet as j_lvnet
from htk_tpu.io import lm as j_lm
from htk_tpu.io.htkfeat import read_htk_file_fast as j_read_fast
from htk_tpu.io.mlf import MLF as JMLF
from htk_tpu.tools import _common as j_common
from htk_tpu.utils.config import Config as JConfig
from htk_tpu.utils.errors import HTKError as JHTKError
from htk_tpu_torch import convert
from htk_tpu_torch import native
from htk_tpu_torch.algo import lvnet as p_lvnet
from htk_tpu_torch.io import lm as p_lm
from htk_tpu_torch.io import parmkind as pk
from htk_tpu_torch.io.htkfeat import _crc16, read_htk_file, write_htk_file
from htk_tpu_torch.io.htkfeat import read_htk_file_fast
from htk_tpu_torch.io.mlf import MLF
from htk_tpu_torch.tools import _common
from htk_tpu_torch.utils import build
from htk_tpu_torch.utils.config import Config
from htk_tpu_torch.utils.errors import HTKError

from _torch_compare import one_torch_thread  # noqa: F401
from test_decode import separable_set
from test_native import ARPA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def _write(tmp_path, text, name="t.arpa"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def j_read_py(path, monkeypatch):
    """htk_tpu's Python ARPA reader (its codec switched off by its own
    environment variable)."""
    with monkeypatch.context() as m:
        m.setenv("HTKTPU_NO_NATIVE", "1")
        out = j_lm.read_arpa(path)
    assert type(out) is j_lm.NGramLM
    return out


def four_readers(path, monkeypatch):
    """(port codec, port Python, htk_tpu codec, htk_tpu Python)."""
    pn, pp = p_lm.read_arpa(path), p_lm.read_arpa_plain(path)
    jn, jp = j_lm.read_arpa(path), j_read_py(path, monkeypatch)
    assert type(pn) is p_lm.PackedNGramLM and type(pp) is p_lm.NGramLM
    assert type(jn) is j_lm.PackedNGramLM
    return pn, pp, jn, jp


def assert_lm_equal(a, b):
    assert a.order == b.order
    assert a.vocab == b.vocab
    for k in ("unigrams", "bigrams", "trigrams", "tri_bo", "fourgrams"):
        assert getattr(a, k) == getattr(b, k), k


def assert_packs_equal(a, b):
    assert a["order"] == b["order"] and a["vocab"] == b["vocab"]
    for n in range(1, a["order"] + 1):
        for x, y in zip(a[n], b[n]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


# -- libhtkio: CRC16 and the batch loader ------------------------------------

def test_crc_matches_python_and_reference():
    lib, jlib = native.get_htkio(), j_native.get_htkio()
    for blob in (b"", b"x", b"hello world", bytes(range(256))):
        assert lib.htkio_crc16(blob, len(blob)) == _crc16(blob)
        assert lib.htkio_crc16(blob, len(blob)) == jlib.htkio_crc16(
            blob, len(blob))


@pytest.mark.parametrize("kind", ["USER_E", "MFCC_E_C", "USER_C_K"])
def test_batch_load_equals_reference(tmp_path, kind):
    """Uncompressed files load exactly; `_C` files decompress in float32
    in both codecs, bit for bit alike and within one float32 rounding of
    the numpy reader (tests/test_native.py's 1e-5)."""
    rng = np.random.default_rng(0)
    paths, refs = [], []
    for i in range(4):
        x = (rng.normal(size=(30 + i, 7)) * 8).astype(np.float32)
        p = str(tmp_path / f"u{i}.mfc")
        write_htk_file(p, x, 100000, pk.str2parmkind(kind))
        paths.append(p)
        refs.append(read_htk_file(p).data)
    got = native.load_corpus_batch(paths, 40, 7)
    ref = j_native.load_corpus_batch(paths, 40, 7)
    arena, frames, periods, kinds = got
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(frames, ref[1])
    np.testing.assert_array_equal(periods, ref[2])
    np.testing.assert_array_equal(kinds, ref[3])
    for i in range(4):
        assert frames[i] == 30 + i and periods[i] == 100000
        assert kinds[i] == pk.str2parmkind(kind)
        np.testing.assert_array_equal(arena[i, :30 + i],
                                      ref[0][i, :30 + i])
        if "_C" in kind:
            np.testing.assert_allclose(arena[i, :30 + i], refs[i],
                                       atol=1e-5)
            step = np.spacing(np.abs(refs[i]))
            assert (np.abs(arena[i, :30 + i] - refs[i]) <= step).all()
        else:
            np.testing.assert_array_equal(arena[i, :30 + i], refs[i])


def test_missing_file_reports_error(tmp_path):
    missing = [str(tmp_path / "nothere.mfc")]
    _a, frames, _p, _k = native.load_corpus_batch(missing, 10, 4)
    _ja, jframes, _jp, _jk = j_native.load_corpus_batch(missing, 10, 4)
    assert frames[0] < 0 and frames[0] == jframes[0]


@pytest.mark.parametrize("kind", ["USER_E", "MFCC_E_C", "USER_C_K",
                                  "WAVEFORM"])
def test_read_htk_file_fast_equals_reference(tmp_path, kind):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(25, 6)) * 100).astype(np.float32)
    if kind == "WAVEFORM":
        x = x.astype(np.int16)
    p = str(tmp_path / "f.mfc")
    write_htk_file(p, x, 100000, pk.str2parmkind(kind))
    got, ref = read_htk_file_fast(p), j_read_fast(p)
    assert (got is None) == (ref is None)
    if kind in ("USER_C_K", "WAVEFORM"):  # CRC-checked / int kinds
        assert got is None
        return
    np.testing.assert_array_equal(got.data, ref.data)
    assert (got.samp_period, got.parm_kind) == (ref.samp_period,
                                                ref.parm_kind)


# -- the MLF structure scanner ---------------------------------------------

def mlf_entries(m):
    return [(pat, [[(lab.name, lab.start, lab.end, lab.score, lab.aux)
                    for lab in alt] for alt in tr.alternatives])
            for pat, tr in m.entries]


def test_native_mlf_equals_pure_and_reference(tmp_path):
    p = tmp_path / "big.mlf"
    with open(p, "w") as f:
        f.write("#!MLF!#\n")
        for i in range(200):
            f.write(f'"*/u{i}.lab"\n')
            f.write("0 1000000 aa -12.5\n///\nsil\n.\n")
    data = p.read_bytes()
    scanned = MLF()
    assert scanned._read_native(data)
    pure = MLF()
    pure._read_pure(data, str(p))
    got = mlf_entries(MLF.load(str(p)))
    assert len(got) == 200
    assert got == mlf_entries(scanned) == mlf_entries(pure)
    assert got == mlf_entries(JMLF.load(str(p)))
    assert len(MLF.load(str(p)).entries[0][1].alternatives) == 2


# -- the ARPA codec ----------------------------------------------------------

def test_arpa_native_matches_python(tmp_path, monkeypatch):
    path = _write(tmp_path, ARPA)
    pn, pp, jn, jp = four_readers(path, monkeypatch)
    for other in (pp, jn, jp):
        assert_lm_equal(pn, other)
    assert pn.unigrams["a"] == (-1.0 * math.log(10),
                                -0.3010 * math.log(10))
    assert ("a", "b", "c") in pn.tri_bo
    assert ("b", "c", "a") not in pn.tri_bo


def test_arpa_native_fourgram_and_edge_lines(tmp_path, monkeypatch):
    text = ("\\data\\\n\\1-grams:\n-1 a\n-1 b\n\\2-grams:\n-0.5 a b\n"
            "\\3-grams:\n-0.4 a b a\n\\4-grams:\n-0.3 a b a b\n"
            "-0.2 b a b a -0.9\nshort\n\\end\\\n")
    path = _write(tmp_path, text)
    pn, pp, jn, jp = four_readers(path, monkeypatch)
    for other in (pp, jn, jp):
        assert_lm_equal(pn, other)
    assert pn.order == 4
    assert pn.fourgrams[("b", "a", "b", "a")] == -0.2 * math.log(10)


def test_arpa_native_empty_sections_and_order(tmp_path, monkeypatch):
    path = _write(tmp_path, "\\data\\\n\\1-grams:\n-1 x\n\\2-grams:\n"
                            "\\end\\\n")
    pn, pp, jn, jp = four_readers(path, monkeypatch)
    for other in (pp, jn, jp):
        assert_lm_equal(pn, other)
    assert pn.order == 2 and not pn.bigrams


@pytest.mark.parametrize("text, codes", [
    ("\\data\\\n\\1-grams:\n\\end\\\n", {8150}),
    ("\\data\\\n\\1-grams:\n-1 a\n-1 b\n\\5-grams:\n-0.1 a b a b a\n"
     "\\end\\\n", {8153}),
    ("\\data\\\n\\1-grams:\nxx a\n\\end\\\n", {8150, 8154}),
    ("\\data\\\n\\1-grams:\n-1 a notanumber\n\\end\\\n", {8150, 8154}),
], ids=["no unigrams", "5-grams", "bad prob", "bad back-off"])
def test_arpa_numbered_errors_equal_reference(tmp_path, monkeypatch, text,
                                              codes):
    """Each reader of both packages raises the same numbered error; a
    file the codec rejects gets it from the Python reader."""
    path = _write(tmp_path, text)
    got = []
    for read in (p_lm.read_arpa, p_lm.read_arpa_plain):
        with pytest.raises(HTKError) as e:
            read(path)
        got.append(e.value.code)
    with pytest.raises(JHTKError) as e:
        j_lm.read_arpa(path)
    got.append(e.value.code)
    with pytest.raises(JHTKError) as e:
        j_read_py(path, monkeypatch)
    got.append(e.value.code)
    assert len(set(got)) == 1 and got[0] in codes, got


def test_bigram_arrays_packed_matches_dict(tmp_path, monkeypatch):
    path = _write(tmp_path, ARPA)
    pn, pp, jn, _jp = four_readers(path, monkeypatch)
    words = ["b", "a", "c", "zz"]
    for extra in ((), ("e",)):
        for f in ("bigram_arrays", "bigram_bow_arrays", "trigram_arrays"):
            ref = getattr(jn, f)(words, extra)
            for lm in (pn, pp):
                for a, b in zip(getattr(lm, f)(words, extra), ref):
                    np.testing.assert_array_equal(a, b)


def test_bigram_arrays_respects_dict_edits(tmp_path):
    path = _write(tmp_path, ARPA)
    pn, jn = p_lm.read_arpa(path), j_lm.read_arpa(path)
    for lm in (pn, jn):
        lm.bigrams[("a", "c")] = (-0.111, 0.0)
    got, ref = pn.bigram_arrays(["a", "c"]), jn.bigram_arrays(["a", "c"])
    assert len(got[0]) == 2 and -0.111 in got[2].tolist()
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_packed_lazy_dicts_cached_and_writable(tmp_path):
    nat = p_lm.read_arpa(_write(tmp_path, ARPA))
    d1 = nat.bigrams
    assert nat.bigrams is d1
    nat.unigrams = {"q": (0.0, 0.0)}
    assert nat.vocab == ["q"]


def test_binary_roundtrip_packed(tmp_path, monkeypatch):
    path = _write(tmp_path, ARPA)
    b1, b2, bj = (str(tmp_path / n) for n in ("lm.bin", "lm2.bin", "j.bin"))
    p_lm.write_binary_lm(p_lm.read_arpa_plain(path), b1)
    j_lm.write_binary_lm(j_read_py(path, monkeypatch), bj)
    back = p_lm.read_binary_lm(b1)
    assert isinstance(back, p_lm.PackedNGramLM)
    p_lm.write_binary_lm(back, b2)
    assert open(b1, "rb").read() == open(b2, "rb").read()
    assert open(b1, "rb").read() == open(bj, "rb").read()
    assert_lm_equal(back, j_lm.read_binary_lm(bj))
    # the binary container from the codec's LM is the same file
    p_lm.write_binary_lm(p_lm.read_arpa(path), b2)
    assert open(b1, "rb").read() == open(b2, "rb").read()


def test_read_lm_filtered_matrix_bigram(tmp_path):
    import gzip

    words = ["a", "b"]
    lm = p_lm.NGramLM(order=2)
    lm.unigrams = {"a": (-1.0, 0.0), "b": (-1.0, 0.0)}
    lm.bigrams = {("a", "b"): (-0.5, 0.0), ("b", "a"): (-0.7, 0.0)}
    p = str(tmp_path / "mat.bg")
    p_lm.write_matrix_bigram(lm, words, p)
    gz = p + ".gz"
    gzip.open(gz, "wb").write(open(p, "rb").read())
    cfg, jcfg = Config(), JConfig()
    cfg.set("HLANGMODFILTER", "gunzip -c $")
    jcfg.set("HLANGMODFILTER", "gunzip -c $")
    back = p_lm.read_lm(gz, cfg=cfg, words=words)
    assert back.bigrams == p_lm.read_lm(p, words=words).bigrams
    assert back.bigrams == j_lm.read_lm(gz, cfg=jcfg, words=words).bigrams


def test_arpa_filtered_through_the_codec(tmp_path):
    import gzip

    gz = str(tmp_path / "lm.arpa.gz")
    gzip.open(gz, "wb").write(ARPA.encode())
    cfg = Config()
    cfg.set("HLANGMODFILTER", "gunzip -c $")
    got = p_lm.read_arpa(gz, cfg=cfg)
    assert type(got) is p_lm.PackedNGramLM
    assert_lm_equal(got, p_lm.read_arpa_plain(_write(tmp_path, ARPA)))


# -- the codec against its plain version -------------------------------------

DUPLICATES = """\\data\\
ngram 1=3
ngram 2=4
ngram 3=3

\\1-grams:
-1.0 a -0.3
-1.2 b -0.2
-1.5 c -0.25

\\2-grams:
-0.2 a b -0.1
-0.7 b c
-0.8 a b -0.4
-0.3 c a

\\3-grams:
-0.25 a b c
-0.5 b c a -0.05
-0.9 a b c 0.1

\\end\\
"""

PLAIN_CASES = {
    "reference": ARPA,
    "duplicates": DUPLICATES,
    "4-grams": ("\\data\\\n\\1-grams:\n-1 a\n+1e-1 b\n\\2-grams:\n"
                "-.5 a b\n\\4-grams:\n-0.3 a b a b\n-2. b a b a -inf\n"
                "x\n\\end\\\nafter end\n"),
    "no sections": "just text\n\\bogus\\\n",
    "crlf": "\\data\\\r\n\\1-grams:\r\n-1 a\t-0.5\r\n-2 b\r\n\\end\\",
    "5-grams": "\\data\\\n\\1-grams:\n-1 a\n\\5-grams:\n-1 a a a a a\n",
    "bad number": "\\data\\\n\\1-grams:\n-1 a 1_0\n",
}


@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_codec_equals_plain_version(tmp_path, case):
    path = _write(tmp_path, PLAIN_CASES[case])
    got, ref = native.parse_arpa(path), native.parse_arpa_plain(path)
    assert (got is None) == (ref is None)
    if got is not None:
        assert_packs_equal(got, ref)
        assert_packs_equal(got, j_native.parse_arpa(path))
    else:
        assert j_native.parse_arpa(path) is None


def test_codec_rejects_what_it_cannot_open(tmp_path):
    missing = str(tmp_path / "none.arpa")
    assert native.parse_arpa(missing) is None
    assert native.parse_arpa_plain(missing) is None
    with pytest.raises(HTKError, match="8110"):
        p_lm.read_arpa(missing)


# -- the duplicate n-gram fault --------------------------------------------

def lv_nets(lm_j, lm_p, words, factored):
    jc = separable_set()
    pc = convert.compiled_hmmset_from(jc)
    from htk_tpu.io.dictionary import Vocab as JVocab
    from htk_tpu_torch.io.dictionary import Vocab as PVocab
    jv, pv = JVocab(), PVocab()
    phones = ("aa", "iy", "sil")
    for k, w in enumerate(words):
        jv.add_pron(w, [phones[k % 3]])
        pv.add_pron(w, [phones[k % 3]])
    return (j_lvnet.compile_lv_loop(words, jv, jc, lm=lm_j,
                                    factored=factored),
            p_lvnet.compile_lv_loop(words, pv, pc, lm=lm_p,
                                    factored=factored))


NET_ARRAYS = ("comp_state", "band", "a0", "aE", "chain_of", "node_of_chain",
              "chain_pron_prob", "trans", "start_entry", "end_exit")


@pytest.mark.parametrize("factored", [False, True])
def test_duplicate_ngram_lines_equal_reference(tmp_path, factored):
    """A bigram on two lines (-0.2 and -0.8 for `a b`): htk_tpu's codec
    keeps both and the LV loop's tables take the larger; so does the
    port's, exactly."""
    path = _write(tmp_path, DUPLICATES)
    lm_j, lm_p = j_lm.read_arpa(path), p_lm.read_arpa(path)
    words = ["a", "b", "c"]
    trans_j = j_lvnet.lm_loop_matrices(words, lm_j)
    trans_p = p_lvnet.lm_loop_matrices(words, lm_p)
    for a, b in zip(trans_p, trans_j):
        np.testing.assert_array_equal(a, b)
    assert trans_p[0][0, 1] == -0.2 * math.log(10)
    jn, pn = lv_nets(lm_j, lm_p, words, factored)
    for k in NET_ARRAYS:
        np.testing.assert_array_equal(getattr(pn, k), getattr(jn, k), k)
    if factored:
        xp, xj = pn.xw_backoff, jn.xw_backoff
        for k in ("bow", "uni", "inv", "succ_j", "succ_p", "marg"):
            np.testing.assert_array_equal(xp[k], xj[k], k)
        for (p1, s1), (p2, s2) in zip(xp["buckets"], xj["buckets"]):
            np.testing.assert_array_equal(p1, p2)
            np.testing.assert_array_equal(s1, s2)
    # the dict views resolve the duplicate as the Python reader does
    assert p_lm.read_arpa_plain(path).bigrams == lm_p.bigrams
    assert lm_p.bigrams[("a", "b")][0] == -0.8 * math.log(10)


# -- the build ---------------------------------------------------------------

def _run(code, env=None):
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          timeout=120, cwd=REPO)


def test_missing_compiler_raises_1094(tmp_path):
    """With no g++ on PATH and nothing built, the first use raises HError
    1094; no reader falls back to its Python leg."""
    arpa = _write(tmp_path, ARPA)
    code = f"""
        from htk_tpu_torch.utils import build
        build.BUILD_DIR = {str(tmp_path / "build")!r}
        from htk_tpu_torch.io.lm import read_arpa
        from htk_tpu_torch.utils.errors import HTKError
        try:
            read_arpa({arpa!r})
        except HTKError as e:
            print("code", e.code, e.message)
        else:
            print("no error")
    """
    bare = tmp_path / "bin"
    bare.mkdir()
    env = dict(os.environ, PATH=str(bare))
    out = _run(code, env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("code 1094"), out.stdout
    assert "g++" in out.stdout
    assert not os.listdir(tmp_path / "build")


def test_failed_build_raises_1094_with_stderr(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    with pytest.raises(HTKError) as e:
        native._load("broken", lambda lib: None)
    assert e.value.code == 1094 and "error" in e.value.message
    assert "broken" not in native._libs


def test_builders_racing_load_one_whole_library(tmp_path):
    """More processes than cores build the same library into an empty
    directory at once: each loads a whole library, and one file is
    left."""
    d = str(tmp_path / "build")
    code = f"""
        from htk_tpu_torch.utils import build
        build.BUILD_DIR = {d!r}
        from htk_tpu_torch import native
        lib = native.get_htkio()
        print(lib.htkio_crc16(b"hello world", 11))
    """
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO)
             for _ in range((os.cpu_count() or 4) + 2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    assert {o[0].strip() for o in outs} == {str(_crc16(b"hello world"))}
    assert [f for f in os.listdir(d) if f.endswith(".so")] == [
        os.path.basename(native.library_path("htkio"))]
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


# -- preload_corpus ----------------------------------------------------------

def test_preload_corpus_matches_open_speech_file(tmp_path):
    """The port's preload returns what htk_tpu's does, bit for bit, and
    within one float32 rounding of open_speech_file; it declines the
    files it must not cover (uncompressed, segment-sliced)."""
    rng = np.random.default_rng(4)
    entries = []
    for i, (n, kind) in enumerate([(30, "USER_C"), (45, "USER_C_K"),
                                   (20, "USER")]):
        x = (rng.normal(size=(n, 7)) * 4).astype(np.float32)
        p = str(tmp_path / f"c{i}.usr")
        write_htk_file(p, x, 100000, pk.str2parmkind(kind))
        entries.append(p)
    entries.append(entries[0] + "[3,10]")
    pre = _common.preload_corpus(entries, Config())
    jpre = j_common.preload_corpus(entries, JConfig())
    assert set(pre) == set(jpre) == set(entries[:2])
    for ent in entries[:2]:
        data, period, kind, e = pre[ent]
        jd, jp, jk, je = jpre[ent]
        np.testing.assert_array_equal(data, jd)
        assert (period, kind, e.logical) == (jp, jk, je.logical)
        d2, p2, k2, e2 = _common.open_speech_file(ent, Config())
        np.testing.assert_allclose(data, d2, atol=1e-5)
        assert (np.abs(data - d2) <= np.spacing(np.abs(d2))).all()
        assert period == p2 and kind == k2 and e.logical == e2.logical
        assert data.dtype == d2.dtype and data.flags.c_contiguous


@pytest.mark.parametrize("key, value", [("HPARMFILTER", "cat $"),
                                        ("SOURCEKIND", "WAVEFORM"),
                                        ("SOURCEFORMAT", "WAV")])
def test_preload_corpus_declines_configs(tmp_path, key, value):
    p = str(tmp_path / "c.usr")
    write_htk_file(p, np.ones((10, 3), np.float32), 100000,
                   pk.str2parmkind("USER_C"))
    cfg, jcfg = Config(), JConfig()
    cfg.set(key, value)
    jcfg.set(key, value)
    assert _common.preload_corpus([p], cfg) == {}
    assert j_common.preload_corpus([p], jcfg) == {}
    assert _common.preload_corpus([p], None) == {}
