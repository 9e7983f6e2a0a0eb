"""Port HVite -w recognition (htk_tpu_torch) against htk_tpu's, on the CPU.

A tiny system (6 words, 8 phones, 20 tied 2-mixture states, 39 dims, 6
utterances) is written with the port's generator (htk_tpu_torch/synth.py),
and both packages' HVite run on the same files: the two rec.mlf must be
byte-identical, through the batched buckets (HREC: DECODEBATCH = 8) and
through the per-utterance path (a single file).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from htk_tpu.tools import hvite as jax_hvite
from htk_tpu_torch.synth import word_accuracy, write_system
from htk_tpu_torch.tools import hvite as torch_hvite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The port's tools run on the card unless the CPU is asked for."""
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hvite_sys"))
    s = write_system(root, n_words=6, n_phones=8, n_tied=20, n_mix=2,
                     dim=39, n_utts=6, min_frames=60, max_frames=150,
                     fanout=3, seed=1, binary_mmf=False)
    cfg = os.path.join(root, "batch.cfg")
    with open(cfg, "w") as f:
        f.write("HREC: DECODEBATCH = 8\n")
    return s, cfg


def _argv(s, mlf, files, cfg=None):
    """HVite arguments: `files` is "scp" (-S test.scp) or a list."""
    argv = ["-w", s.wdnet, "-H", s.hmmdefs, "-i", mlf, "-s", "2.0",
            "-p", "-3.0"]
    if cfg:
        argv += ["-C", cfg]
    if files == "scp":
        return argv + ["-S", s.scp, s.dict, s.hmmlist]
    return argv + [s.dict, s.hmmlist] + list(files)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_batched_mlf_byte_identical(system, tmp_path):
    s, cfg = system
    ref, got = str(tmp_path / "jax.mlf"), str(tmp_path / "torch.mlf")
    assert jax_hvite.run(_argv(s, ref, "scp", cfg)) == 0
    assert torch_hvite.run(_argv(s, got, "scp", cfg)) == 0
    assert _read(got) == _read(ref)
    from htk_tpu_torch.io.mlf import MLF

    m = MLF.load(got)
    hyps = [m.lookup(f"*/{os.path.basename(p)[:-4]}.rec").names()
            for p in s.feats]
    assert all(hyps)
    assert word_accuracy(s.transcripts, hyps) > 50.0


def test_single_file_mlf_byte_identical(system, tmp_path):
    s, _cfg = system
    ref, got = str(tmp_path / "jax1.mlf"), str(tmp_path / "torch1.mlf")
    one = [s.feats[2]]
    assert jax_hvite.run(_argv(s, ref, one)) == 0
    assert torch_hvite.run(_argv(s, got, one)) == 0
    assert _read(got) == _read(ref)
    assert b".rec" in _read(got)


def test_decode_batch_equals_per_utterance(system):
    """Padded buckets finalise every utterance at its own length."""
    from htk_tpu_torch.algo.decode import decode, decode_batch
    from htk_tpu_torch.algo.net import compile_network, word_internal_phone_map
    from htk_tpu_torch.io.dictionary import read_dict
    from htk_tpu_torch.io.htkfeat import read_htk_file
    from htk_tpu_torch.io.mmf import load_mmf
    from htk_tpu_torch.io.slf import read_slf
    from htk_tpu_torch.models.hmmset import compile_hmmset

    s, _cfg = system
    comp = compile_hmmset(load_mmf([s.hmmdefs]))
    net = compile_network(read_slf(s.wdnet), read_dict(s.dict), comp,
                          phone_map=word_internal_phone_map(comp.names))
    feats = [read_htk_file(p).data for p in s.feats[:4]]
    rs = decode_batch(net, comp, feats, 2.0, -3.0, pad_to=64, device="cpu")
    for f, r in zip(feats, rs):
        one = decode(net, comp, f, 2.0, -3.0, device="cpu")
        assert (r.words, r.times) == (one.words, one.times)
        assert abs(r.score - one.score) < 1e-3


def test_convert_carries_jax_objects(system):
    """convert.py rebuilds the JAX package's compiled set and network as
    the port's, equal to the port's own compilation of the same files."""
    from htk_tpu.algo.net import compile_network as j_net
    from htk_tpu.algo.net import word_internal_phone_map as j_pmap
    from htk_tpu.io.dictionary import read_dict as j_dict
    from htk_tpu.io.mmf import load_mmf as j_mmf
    from htk_tpu.io.slf import read_slf as j_slf
    from htk_tpu.models.hmmset import compile_hmmset as j_comp
    from htk_tpu_torch import convert
    from htk_tpu_torch.algo.net import compile_network, word_internal_phone_map
    from htk_tpu_torch.io.dictionary import read_dict
    from htk_tpu_torch.io.mmf import load_mmf
    from htk_tpu_torch.io.slf import read_slf
    from htk_tpu_torch.models.hmmset import compile_hmmset

    s, _cfg = system
    jc = j_comp(j_mmf([s.hmmdefs]))
    jn = j_net(j_slf(s.wdnet), j_dict(s.dict), jc,
               phone_map=j_pmap(jc.names))
    pc = compile_hmmset(load_mmf([s.hmmdefs]))
    pn = compile_network(read_slf(s.wdnet), read_dict(s.dict), pc,
                         phone_map=word_internal_phone_map(pc.names))
    cc, cn = convert.compiled_hmmset_from(jc), convert.decode_network_from(jn)
    for k in ("means", "variances", "gconsts", "state_mix", "state_logw",
              "log_transp", "model_states"):
        np.testing.assert_array_equal(getattr(cc, k), getattr(pc, k))
    assert cc.names == pc.names and cc.slot_blocks == pc.slot_blocks
    for k in ("comp_state", "band", "a0", "aE", "chain_of", "node_of_chain",
              "chain_pron_prob", "trans", "start_entry", "end_exit"):
        np.testing.assert_array_equal(getattr(cn, k), getattr(pn, k))
    assert cn.node_words == pn.node_words and cn.n_nodes == pn.n_nodes
    scorer, d = convert.to_device(cc, cn, "cpu")
    assert torch.equal(d["trans"], torch.as_tensor(pn.trans))
    assert scorer.Wt.shape == (2 * pc.dim, pc.n_mix)


@pytest.mark.parametrize("opt", [["-a"], ["-J", "xf"], ["-N", "ann"]])
def test_unported_options_raise_numbered_error(system, tmp_path, opt,
                                               capsys):
    s, _cfg = system
    rc = torch_hvite.main(opt + _argv(s, str(tmp_path / "x.mlf"), "scp"))
    assert rc != 0
    assert "[+3290]" in capsys.readouterr().err


def test_uniform_network_raises_numbered_error():
    """Uniform-row nets decode, dense and factored; adaptive-exact top-A
    on a factored net whose tables lack the successor lists raises HError
    8526, as the reference's own check does (htk_tpu/algo/decode.py:
    411-417)."""
    from htk_tpu_torch.algo.decode import decode
    from htk_tpu_torch.algo.net import DecodeNetwork
    from htk_tpu_torch.utils.errors import HTKError

    z = np.zeros(1, np.float32)
    i = np.zeros(1, np.int32)
    net = DecodeNetwork(comp_state=i, band=z[None], a0=z, aE=z, chain_of=i,
                        node_of_chain=i, chain_pron_prob=z, node_words=["a"],
                        node_out=[None], trans=np.zeros((0, 0), np.float32),
                        start_entry=z, end_exit=z, uniform_width=1,
                        xw_backoff={"bow": z, "uni": z, "buckets": [],
                                    "inv": np.zeros(1, np.int32),
                                    "succ_j": None})
    with pytest.raises(HTKError) as e:
        decode(net, None, np.zeros((3, 39), np.float32), max_active=-4,
               device="cpu")
    assert e.value.code == 8526


def test_port_imports_no_jax_and_no_htk_tpu():
    """Every module of the port, and chip_smoke.py, imported in a fresh
    interpreter (the pytest process has jax loaded, by conftest), pulls in
    neither jax nor htk_tpu."""
    code = ("import importlib, pkgutil, sys, htk_tpu_torch, chip_smoke\n"
            "mods = [m.name for m in pkgutil.walk_packages("
            "htk_tpu_torch.__path__, 'htk_tpu_torch.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "need = {'htk_tpu_torch.tools.herest', "
            "'htk_tpu_torch.ops.fb_scans', 'htk_tpu_torch.algo.trainer', "
            "'htk_tpu_torch.parallel.acc_files', "
            "'htk_tpu_torch.algo.lvnet', 'htk_tpu_torch.io.lm', "
            "'htk_tpu_torch.ops.maxplus', 'htk_tpu_torch.ops.tropical', "
            "'htk_tpu_torch.ops.xw_gather', 'htk_tpu_torch.ops.xw_route', "
            "'htk_tpu_torch.ops.xw_window', 'htk_tpu_torch.ops.dsp', "
            "'htk_tpu_torch.io.wavefile', 'htk_tpu_torch.io.vq', "
            "'htk_tpu_torch.models.proto', 'htk_tpu_torch.models.itemlist', "
            "'htk_tpu_torch.algo.tree', 'htk_tpu_torch.algo.kmeans', "
            "'htk_tpu_torch.algo.latops', 'htk_tpu_torch.tools.hcopy', "
            "'htk_tpu_torch.tools.hcompv', 'htk_tpu_torch.tools.hled', "
            "'htk_tpu_torch.tools.hhed', 'htk_tpu_torch.tools.hbuild', "
            "'htk_tpu_torch.tools.hresults', "
            "'htk_tpu_torch.recipes.demo', 'htk_tpu_torch.recipes.speech'}\n"
            "assert need <= set(mods), need - set(mods)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'htk_tpu' or "
            "m.startswith('htk_tpu.')]\n"
            "print(len(mods), bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
