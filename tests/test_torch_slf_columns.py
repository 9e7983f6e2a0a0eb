"""`write_slf` on both forms of a `Lattice` (`htk_tpu_torch/io/slf.py`),
on the CPU: a lattice held as columns (`Lattice.from_columns`, what the
decoders' lattice walk returns) and one held as `LNode`/`LArc` lists
(`read_slf`, HBuild, HParse, the lists of a columnar lattice once read).

A columnar lattice writes the bytes its lists write; a lattice read from
SLF writes the bytes it always has; the columns round-trip through
`read_slf`; the lists are built once, in the span `htk.lattice.views`
with their lengths as counts, and from then on they are the lattice.
On an LV batch from `generate_lattice_batch` that span appears only when
a lattice's lists are read.
"""

import os
import tempfile

import numpy as np
import pytest

from htk_tpu_torch.algo import decode as pdec
from htk_tpu_torch.algo.lvnet import compile_lv_loop
from htk_tpu_torch.io.slf import (NULL_WORD, LArc, Lattice, LatticeColumns,
                                  LNode, read_slf, write_slf)
from htk_tpu_torch.synth import lv_system
from htk_tpu_torch.utils import metrics

# every field the writer formats: words on nodes and on arcs, variants,
# times and scores that round at the second and fourth decimal, -0.0
SLF = """VERSION=1.0
UTTERANCE=u1
lmscale=12.00 wdpenalty=-2.50
N=5 L=6
I=0 t=0.00 W=!NULL
I=1 t=0.13 W=A v=2
I=2 t=0.27
I=3 t=0.50 W=B
I=4 t=0.61 W=!NULL
J=0 S=0 E=1 a=-12.35 l=-1.2346
J=1 S=0 E=2 W=C a=-0.00 l=0.0000
J=2 S=1 E=3 a=-101.99 l=-3.0001
J=3 S=2 E=3 W=D a=7.25 l=-0.5000
J=4 S=3 E=4 a=0.00 l=-2.3026
J=5 S=1 E=4 a=-1.00 l=-0.1000
"""


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def _bytes(lat):
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "x.lat")
        write_slf(lat, p)
        with open(p, "rb") as f:
            return f.read()


def _read(text):
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "x.lat")
        with open(p, "w") as f:
            f.write(text)
        return read_slf(p)


def _columnar(seed=0, n=40, m=70):
    """A columnar lattice as the walk lays one out: node 0 the start,
    node 1 the end (!NULL), words from a table; scores with many digits."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(25)]
    time = np.concatenate([[0.0, 0.01 * (n + 3)],
                           np.sort(rng.integers(1, n + 3, n)) * 0.01])
    return Lattice.from_columns(LatticeColumns(
        time=time, word=np.concatenate([[-1, -1], rng.integers(0, 25, n)]),
        words=words, start=rng.integers(0, n + 2, m),
        end=rng.integers(0, n + 2, m), aclike=rng.normal(0, 300, m),
        lmlike=rng.normal(-3, 2, m)), utterance="utt", lmscale=12.0,
        wdpenalty=-1.0)


def _views(f):
    """What `f()` returns and the `htk.lattice.views` spans it opened."""
    with metrics.recording():
        out = f()
        spans = [r for r in metrics.RECORDER.records
                 if r.name == "htk.lattice.views"]
    return out, spans


def test_a_columnar_lattice_writes_the_bytes_of_its_lists():
    lat = _columnar()
    cols = _bytes(lat)
    assert lat._columns is not None  # writing built no list
    lat.nodes  # noqa: B018 (the first read builds them)
    assert lat._columns is None
    assert _bytes(lat) == cols
    rebuilt = Lattice(nodes=list(lat.nodes), arcs=list(lat.arcs),
                      utterance="utt", lmscale=12.0, wdpenalty=-1.0)
    assert _bytes(rebuilt) == cols


def test_a_read_lattice_writes_the_bytes_it_always_has():
    lat = _read(SLF)
    assert lat._columns is None
    assert _bytes(lat).decode() == SLF
    assert lat.nodes[1] == LNode(id=1, time=0.13, word="A", var=2)
    assert lat.arcs[1] == LArc(id=1, start=0, end=2, word="C", aclike=-0.0)


def test_columns_round_trip_through_read_slf():
    lat = _columnar(seed=1)
    c = lat._columns
    back = _read(_bytes(lat).decode())
    assert [(n.id, n.time, n.word, n.var) for n in back.nodes] == [
        (k, float(f"{t:.2f}"), NULL_WORD if w < 0 else c.words[w], 0)
        for k, (t, w) in enumerate(zip(c.time.tolist(), c.word.tolist()))]
    assert [(a.id, a.start, a.end, a.word, a.aclike, a.lmlike)
            for a in back.arcs] == [
        (k, s, e, None, float(f"{ac:.2f}"), float(f"{lm:.4f}"))
        for k, (s, e, ac, lm) in enumerate(zip(
            c.start.tolist(), c.end.tolist(), c.aclike.tolist(),
            c.lmlike.tolist()))]
    assert (back.utterance, back.lmscale, back.wdpenalty) == (
        "utt", 12.0, -1.0)


def test_an_edit_through_the_lists_is_what_gets_written():
    lat = _columnar(seed=2)
    before = _bytes(lat)
    lat.arcs[3].aclike = -4321.0
    del lat.arcs[5]
    lat.nodes[7].word = "edited"
    after = _bytes(lat).decode()
    assert after != before.decode()
    assert "J=3 S=%d E=%d a=-4321.00 " % (lat.arcs[3].start,
                                          lat.arcs[3].end) in after
    assert f"N={len(lat.nodes)} L=69\n" in after
    assert "I=7 t=%.2f W=edited\n" % lat.nodes[7].time in after
    # a list set before any read replaces that list; the other is built
    lat = _columnar(seed=2)
    lat.arcs = []
    assert lat._columns is not None and "nodes" not in vars(lat)
    text = _bytes(lat).decode()
    assert lat.arcs == [] and len(lat.nodes) == 42
    assert "L=0\n" in text and "\nJ=" not in text


def test_the_views_build_once_in_their_span():
    lat = _columnar(seed=3)
    nodes, spans = _views(lambda: lat.nodes)
    (nodes2, arcs), again = _views(lambda: (lat.nodes, lat.arcs))
    assert again == [] and nodes2 is nodes and lat.arcs is arcs
    assert len(spans) == 1 and spans[0].counts == {"nodes": 42, "arcs": 70}
    _, none = _views(lambda: _bytes(_columnar(seed=4)))
    assert none == []  # writing the columns builds nothing


def test_a_batch_builds_its_lists_only_when_they_are_read():
    """The factored 300-word system of tests/test_torch_lvlattice.py
    (`lv_system(300, seed=3)`, 3 utterances of 60-120 frames) through
    the batched LV lattice path, LATPREDS 8."""
    s = lv_system(300, n_tied=2000, n_mix=2, n_utts=3, min_frames=60,
                  max_frames=120, seed=3)
    net = compile_lv_loop(s.words, s.vocab, s.comp, lm=s.lm, factored=True)
    lats, spans = _views(lambda: pdec.generate_lattice_batch(
        net, s.comp, s.feats, 12.0, 0.0, lattice_beam=150.0, pad_to=16,
        max_preds=8, device="cpu"))
    assert spans == [] and all(lt._columns is not None for lt in lats)
    texts = [_bytes(lt) for lt in lats]
    for lt, text in zip(lats, texts):
        (nodes, arcs), spans = _views(lambda: (lt.nodes, lt.arcs))
        assert len(spans) == 1 and spans[0].counts == {
            "nodes": len(nodes), "arcs": len(arcs)}
        assert len(nodes) > 2 and arcs
        assert _bytes(lt) == text
