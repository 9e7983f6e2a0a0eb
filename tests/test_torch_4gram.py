"""The port's exact 4-gram lattice rescoring against htk_tpu's.

The twin of tests/test_4gram_rescore.py: `algo/latops.best_path_4gram`
(which HDecode takes for an ARPA of order 4 or more) and
`best_path_trigram` of both packages on its diamond lattice, with a dict
LM built the same way in each, and with a `PackedNGramLM` that each
package's read_arpa makes from the same 4-gram ARPA through its native
codec. Both packages run the same float64 host DP, so scores are held
equal exactly and paths word for word.
"""

import numpy as np
import pytest

from htk_tpu.algo import latops as j_latops
from htk_tpu.io import lm as j_lm
from htk_tpu_torch.algo import latops as p_latops
from htk_tpu_torch.io import lm as p_lm
from htk_tpu_torch.io import slf as p_slf

from _torch_compare import one_torch_thread  # noqa: F401
from test_4gram_rescore import diamond_lattice

WORDS = ("A", "X", "Y", "W", "Z")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def port_lattice():
    """tests/test_4gram_rescore.py's diamond in the port's classes."""
    ref = diamond_lattice()
    lat = p_slf.Lattice(lmscale=ref.lmscale, wdpenalty=ref.wdpenalty)
    lat.nodes = [p_slf.LNode(id=n.id, time=n.time, word=n.word)
                 for n in ref.nodes]
    lat.arcs = [p_slf.LArc(id=a.id, start=a.start, end=a.end,
                           aclike=a.aclike, lmlike=a.lmlike)
                for a in ref.arcs]
    return lat


def make_lm(mod, case):
    """tests/test_4gram_rescore.py's LM for each of its cases, in `mod`'s
    NGramLM."""
    lm = mod.NGramLM(order=3 if case == "trigram" else 4)
    for w in WORDS:
        lm.unigrams[w] = (np.log(0.2), np.log(0.1))
    lm.unigrams["!ENTER"] = (-99.0, np.log(0.2))
    for w1 in WORDS + ("!ENTER",):
        for w2 in WORDS:
            lm.bigrams[(w1, w2)] = (np.log(0.2), np.log(0.5))
    lm.trigrams[("X", "Y", "Z")] = np.log(0.30)
    lm.trigrams[("X", "W", "Z")] = np.log(0.25)
    if case == "fourgram":
        lm.fourgrams[("A", "X", "W", "Z")] = np.log(0.95)
    if case == "tri_bo":
        lm.tri_bo[("X", "Y", "Z")] = 0.0
        lm.tri_bo[("A", "X", "Y")] = np.log(0.5)
        lm.tri_bo[("A", "X", "W")] = np.log(0.5)
    return lm


# (case, LM scale, word penalty): the reference test's three cases
CASES = [("trigram", 2.0, -0.5), ("fourgram", 4.0, 0.0), ("tri_bo", 1.0, 0.0)]


def assert_same_best(got, ref):
    (s, path), (rs, rpath) = got, ref
    assert s == rs
    assert [w for w, _ in path] == [w for w, _ in rpath]
    assert [t for _, t in path] == [t for _, t in rpath]


@pytest.mark.parametrize("case, scale, pen", CASES)
def test_best_path_4gram_dict_lm(case, scale, pen):
    lm_p, lm_j = make_lm(p_lm, case), make_lm(j_lm, case)
    lat_p, lat_j = port_lattice(), diamond_lattice()
    got = p_latops.best_path_4gram(lat_p, lm_p, scale, pen)
    assert_same_best(got, j_latops.best_path_4gram(lat_j, lm_j, scale, pen))
    assert_same_best(p_latops.best_path_trigram(lat_p, lm_p, scale, pen),
                     j_latops.best_path_trigram(lat_j, lm_j, scale, pen))
    if case == "fourgram":  # only the 4-gram rescorer sees (A, X, W)
        assert [w for w, _ in got[1]] == ["A", "X", "W", "Z"]


@pytest.mark.parametrize("case, scale, pen", CASES)
def test_best_path_4gram_packed_lm(tmp_path, case, scale, pen):
    """The same LMs written as ARPA files and read back through each
    package's codec."""
    path = str(tmp_path / "lm.arpa")
    p_lm.write_arpa(make_lm(p_lm, case), path)
    lm_p, lm_j = p_lm.read_arpa(path), j_lm.read_arpa(path)
    assert type(lm_p) is p_lm.PackedNGramLM
    assert type(lm_j) is j_lm.PackedNGramLM
    got = p_latops.best_path_4gram(port_lattice(), lm_p, scale, pen)
    assert_same_best(got, j_latops.best_path_4gram(diamond_lattice(), lm_j,
                                                   scale, pen))
    # the codec's packed LM rescores as the Python reader's dicts do
    assert_same_best(got, p_latops.best_path_4gram(
        port_lattice(), p_lm.read_arpa_plain(path), scale, pen))
