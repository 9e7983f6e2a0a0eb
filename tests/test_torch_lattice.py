"""The port's word lattices (HVite -z) and N-best (-n) against htk_tpu's.

A tiny system (tests/test_torch_hvite.py's: 6 words, 8 phones, 20 tied
2-mixture states, 6 utterances) from the port's generator. The lattice
walk is host numpy copied from htk_tpu, fed by the port's decode
recursion, so the structure of every lattice (nodes, times, words, arcs,
l=) is exact and the acoustic scores a= agree within 0.05: write_slf
prints them with 2 decimals and the two packages' OutP matmuls round
differently in the last bits. The 1-best from the same recursion, and
HVite's rec.mlf, are byte-identical. In the port, the batched generator
equals the sequential one byte for byte.
"""

import os
import tempfile

import numpy as np
import pytest

from htk_tpu.algo import decode as jdec
from htk_tpu.algo import latops as jlatops
from htk_tpu.algo.net import compile_network as j_net
from htk_tpu.algo.net import word_internal_phone_map as j_pmap
from htk_tpu.io import slf as jslf
from htk_tpu.io.dictionary import read_dict as j_dict
from htk_tpu.io.mmf import load_mmf as j_mmf
from htk_tpu.io.slf import read_slf as j_slf
from htk_tpu.models.hmmset import compile_hmmset as j_comp
from htk_tpu.tools import hvite as jax_hvite
from htk_tpu_torch.algo import decode as tdec
from htk_tpu_torch.algo import latops as tlatops
from htk_tpu_torch.algo.net import compile_network, word_internal_phone_map
from htk_tpu_torch.io.dictionary import read_dict
from htk_tpu_torch.io.htkfeat import read_htk_file
from htk_tpu_torch.io.mmf import load_mmf
from htk_tpu_torch.io.slf import read_slf, write_slf
from htk_tpu_torch.models.hmmset import compile_hmmset
from htk_tpu_torch.synth import write_system
from htk_tpu_torch.tools import hvite as torch_hvite
from htk_tpu_torch.utils.errors import HTKError

from _torch_compare import assert_slf_close, one_torch_thread  # noqa: F401

LM, PEN = 2.0, -3.0


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lat_sys"))
    s = write_system(root, n_words=6, n_phones=8, n_tied=20, n_mix=2,
                     dim=39, n_utts=6, min_frames=60, max_frames=150,
                     fanout=3, seed=1, binary_mmf=False)
    comp = compile_hmmset(load_mmf([s.hmmdefs]))
    vocab = read_dict(s.dict)
    net = compile_network(read_slf(s.wdnet), vocab, comp,
                          phone_map=word_internal_phone_map(comp.names))
    with open(s.scp) as f:
        feats = [read_htk_file(p).data for p in f.read().split()]
    jcomp = j_comp(j_mmf([s.hmmdefs]))
    jnet = j_net(j_slf(s.wdnet), j_dict(s.dict), jcomp,
                 phone_map=j_pmap(jcomp.names))
    return s, comp, net, jcomp, jnet, feats


def _slf(lat):
    with tempfile.TemporaryDirectory() as t:
        p = os.path.join(t, "x.lat")
        (jslf.write_slf if isinstance(lat, jslf.Lattice) else write_slf)(
            lat, p)
        with open(p) as f:
            return f.read()


def _same_result(a, b):
    assert a.words == b.words and a.times == b.times
    assert a.score == pytest.approx(b.score, rel=1e-5)


@pytest.mark.parametrize("beam", [200.0, 40.0])
def test_generate_lattice_matches_reference(system, beam):
    _s, comp, net, jcomp, jnet, feats = system
    for f in feats[:3]:
        lt, r = tdec.generate_lattice(
            net, comp, f, LM, PEN, lattice_beam=beam, want_result=True,
            device="cpu")
        jl, jr = jdec.generate_lattice(
            jnet, jcomp, f, LM, PEN, lattice_beam=beam, want_result=True)
        assert len(lt.nodes) > 10
        assert_slf_close(_slf(lt), _slf(jl))
        _same_result(r, jr)
        assert _slf(tdec.generate_lattice(
            net, comp, f, LM, PEN, lattice_beam=beam,
            device="cpu")) == _slf(lt)


def test_batch_equals_sequential_and_reference(system):
    _s, comp, net, jcomp, jnet, feats = system
    got = tdec.generate_lattice_batch(net, comp, feats, LM, PEN,
                                      want_results=True, device="cpu")
    ref = jdec.generate_lattice_batch(jnet, jcomp, feats, LM, PEN,
                                      want_results=True)
    for f, (lt, r), (jl, jr) in zip(feats, got, ref):
        sl, sr = tdec.generate_lattice(net, comp, f, LM, PEN,
                                       want_result=True, device="cpu")
        assert _slf(lt) == _slf(sl)
        _same_result(r, sr)
        assert_slf_close(_slf(lt), _slf(jl))
        _same_result(r, jr)
    plain = tdec.generate_lattice_batch(net, comp, feats, LM, PEN,
                                        device="cpu")
    assert [_slf(x) for x in plain] == [_slf(x) for x, _ in got]


@pytest.mark.parametrize("batched", [True, False])
def test_lattice_batch_on_uniform_net_raises_8527(batched):
    """Lattices on uniform-row (LV) nets wait for the LV lattice
    pipeline: both generators refuse them before any decode."""
    from htk_tpu_torch.algo.net import DecodeNetwork

    z = np.zeros(1, np.float32)
    i = np.zeros(1, np.int32)
    net = DecodeNetwork(comp_state=i, band=z[None], a0=z, aE=z, chain_of=i,
                        node_of_chain=i, chain_pron_prob=z, node_words=["a"],
                        node_out=[None], trans=np.zeros((1, 1), np.float32),
                        start_entry=z, end_exit=z, uniform_width=1)
    with pytest.raises(HTKError) as e:
        if batched:
            tdec.generate_lattice_batch(net, None, [np.zeros((3, 39))],
                                        device="cpu")
        else:
            tdec.generate_lattice(net, None, np.zeros((3, 39)),
                                  device="cpu")
    assert e.value.code == 8527


@pytest.mark.parametrize("n", [1, 3, 8])
def test_nbest_paths_match_reference(system, n, tmp_path):
    """The N-best walk is host code: on the same SLF file, the port's and
    htk_tpu's give the same sentences, times and scores."""
    _s, comp, net, _jc, _jn, feats = system
    for k, f in enumerate(feats[:3]):
        lt = tdec.generate_lattice(net, comp, f, LM, PEN, device="cpu")
        p = str(tmp_path / f"{k}.lat")
        write_slf(lt, p)
        got = tlatops.nbest_paths(read_slf(p), n, lmscale=1.0, wdpenalty=0.0)
        ref = jlatops.nbest_paths(jslf.read_slf(p), n, lmscale=1.0,
                                  wdpenalty=0.0)
        assert got == ref and 1 <= len(got) <= n


def _run_hvite(run, s, out, extra, files):
    os.makedirs(out, exist_ok=True)
    argv = ["-w", s.wdnet, "-H", s.hmmdefs, "-i", f"{out}/rec.mlf", "-s",
            str(LM), "-p", str(PEN), "-l", out, *extra]
    argv += (["-S", s.scp, s.dict, s.hmmlist] if files is None
             else [s.dict, s.hmmlist, *files])
    assert run(argv) == 0
    return {f: open(os.path.join(out, f), "rb").read()
            for f in sorted(os.listdir(out))}


@pytest.mark.parametrize("extra,single", [
    (["-z", "lat"], False),
    (["-z", "lat"], True),
    (["-z", "lat", "-t", "40.0"], False),
    (["-n", "2", "4"], False),
    (["-z", "lat", "-n", "2", "3"], False),
])
def test_hvite_z_n_through_the_tool(system, tmp_path, extra, single):
    s = system[0]
    files = None
    if single:
        with open(s.scp) as f:
            files = f.read().split()[:1]
    got = _run_hvite(torch_hvite.run, s, str(tmp_path / "t"), extra, files)
    ref = _run_hvite(jax_hvite.run, s, str(tmp_path / "j"), extra, files)
    assert sorted(got) == sorted(ref)
    assert got["rec.mlf"] == ref["rec.mlf"]
    lats = [f for f in got if f.endswith(".lat")]
    assert len(lats) == (0 if "-z" not in extra else
                         1 if single else 6)
    for f in lats:
        assert_slf_close(got[f].decode(), ref[f].decode())


def test_hvite_z_single_equals_batched(system, tmp_path):
    s = system[0]
    with open(s.scp) as f:
        names = f.read().split()
    batched = _run_hvite(torch_hvite.run, s, str(tmp_path / "b"),
                         ["-z", "lat"], None)
    for k, fn in enumerate(names[:2]):
        one = _run_hvite(torch_hvite.run, s, str(tmp_path / f"s{k}"),
                         ["-z", "lat"], [fn])
        lat = [f for f in one if f.endswith(".lat")][0]
        assert one[lat] == batched[lat]
