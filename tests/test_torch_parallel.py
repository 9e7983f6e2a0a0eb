"""Port multi-rank training (htk_tpu_torch parallel/mesh.py, HERest across
ranks, parallel/dryrun.py) against htk_tpu's, on the CPU.

Ranks are fresh processes joined as one gloo group over a `file://`
rendezvous under the test's temporary directory (no port to collide
between test workers), started by `parallel.dryrun.spawn_ranks` with
OMP_NUM_THREADS=1 and a timeout for the whole group, well inside the
suite's; each rank's collectives wait at most tests/_torch_ranks.py's
RANK_TIMEOUT. Held here:

  - `pad_batch(pad_to=)` equals the reference's arrays, and its padding
    rows add nothing to the accumulators;
  - ShardedTrainer on 2 and 4 ranks (batch_size 1, the reference's
    10-utterance corpus of tests/test_parallel.py, uneven across the
    ranks) equals the port's serial Trainer and the reference's
    ShardedTrainer on the 8-device mesh, within rtol/atol 5e-5 (the
    reference test's bound);
  - HERest as 2 ranks (`HTKTPU: COORDINATOR`, DEVICECOMPOSITE = F, with
    and without the -t retry ladder) writes one MMF and -s file, from
    rank 0, within tests/test_torch_herest.py's tolerances of the
    single-process port's and of htk_tpu's HERest; rank 1 writes and
    prints nothing;
  - default_device's card for a rank (cuda:LOCAL_RANK, HError 1091) under
    a stand-in torch.cuda; init_distributed's answers: False with nothing
    configured, HError 1092 on a bad rendezvous, a missing rank or a rank
    that never meets the others;
  - the multi-rank dry run on 2 and 4 ranks.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from htk_tpu.algo.trainer import Trainer as JTrainer
from htk_tpu.algo.trainer import pad_batch as j_pad_batch
from htk_tpu.parallel.mesh import ShardedTrainer as JShardedTrainer
from htk_tpu.parallel.mesh import make_mesh as j_make_mesh
from htk_tpu.tools import herest as jax_herest
from htk_tpu_torch import convert
from htk_tpu_torch.algo.fb import Accumulators
from htk_tpu_torch.algo.trainer import Trainer, pad_batch, prepare_utterance
from htk_tpu_torch.parallel import mesh
from htk_tpu_torch.parallel.dryrun import (dryrun_multichip, run_ranks,
                                           spawn_ranks)
from htk_tpu_torch.synth import write_system
from htk_tpu_torch.tools import _common
from htk_tpu_torch.tools import herest as torch_herest
from htk_tpu_torch.utils.errors import HTKError

from _torch_compare import one_torch_thread  # noqa: F401
from _torch_ranks import SPAWN_TIMEOUT
from test_fb import small_set
from test_parallel import corpus
from test_torch_herest import assert_mmf_close, read_stats

TESTS = os.path.dirname(os.path.abspath(__file__))
RANKS = "_torch_ranks:"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cpu")


def spawn(n, fn, **kwargs):
    return spawn_ranks(n, RANKS + fn, kwargs, timeout=SPAWN_TIMEOUT,
                       path=[TESTS])


def _port_utts(jcomp, n=10):
    """The reference corpus (tests/test_parallel.py) and the port's
    utterances on the same features and transcriptions."""
    comp = convert.compiled_hmmset_from(jcomp)
    jutts = corpus(jcomp, n=n)
    return comp, jutts, [prepare_utterance(comp, u.name, u.feats, seq)
                         for u, seq in zip(jutts, _seqs(n))]


def _seqs(n):
    return [[["a", "b"], ["b", "a"], ["a", "b", "a"]][i % 3]
            for i in range(n)]


def assert_accs_close(got, ref, tol=5e-5):
    for f in Accumulators._fields:
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(ref, f)), rtol=tol,
                                   atol=tol, err_msg=f)


@pytest.mark.parametrize("pad_to", [None, 4, 7])
def test_pad_batch_matches_jax(pad_to):
    jcomp = small_set(nmix=2, seed=1)
    comp, jutts, utts = _port_utts(jcomp, n=3)
    got = pad_batch(utts, comp.n_states, pad_to=pad_to)
    ref = j_pad_batch(jutts, jcomp.n_states, pad_to=pad_to)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    assert got["feats"].shape[0] == (pad_to or 3)
    assert not got["t_real"][3:].any()


def test_padding_rows_add_nothing():
    comp, _j, utts = _port_utts(small_set(nmix=2, seed=1), n=3)
    tr = Trainer(comp, device="cpu")
    params = tr.params()

    def accs(pad_to):
        arrs = {k: torch.as_tensor(v)
                for k, v in pad_batch(utts, comp.n_states, pad_to).items()}
        return tr._fb(params, arrs, None)

    (lp, ref), (lp8, got) = accs(None), accs(8)
    torch.testing.assert_close(lp8[:3], lp, rtol=1e-6, atol=0)
    assert (lp8[3:] <= -1e9).all()
    assert_accs_close(got, ref, tol=1e-6)
    assert float(got.n_utts) == 3


@pytest.fixture(scope="module")
def sharded_case(tmp_path_factory):
    """The corpus pickled for the ranks, and the port's serial and the
    reference's 8-device sharded accumulators."""
    jcomp = small_set(nmix=2, seed=1)
    comp, jutts, utts = _port_utts(jcomp)
    data = tmp_path_factory.mktemp("sharded") / "corpus.pkl"
    with open(data, "wb") as f:
        pickle.dump((comp, utts), f)
    serial = Trainer(comp, device="cpu").accumulate(utts, batch_size=4)
    ref = convert.accumulators_from(
        JShardedTrainer(jcomp, j_make_mesh(8)).accumulate(jutts,
                                                          batch_size=1))
    assert float(JTrainer(jcomp).accumulate(jutts).n_utts) == 10
    return data, serial, ref


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_equals_serial_and_jax(sharded_case, tmp_path, world):
    data, serial, ref = sharded_case
    out = tmp_path / "accs.npz"
    spawn(world, "sharded_accs", data=str(data), out=str(out), batch_size=1)
    z = np.load(out)
    got = Accumulators(**{f: torch.as_tensor(z[f])
                          for f in Accumulators._fields})
    assert float(got.n_utts) == 10
    assert_accs_close(got, serial)
    assert_accs_close(got, ref)


HOST = "HTKTPU: DEVICECOMPOSITE = F\n"
HEREST_MODES = {"host": ["-s", "stats"],
                "ladder": ["-t", "0.2", "0.3", "3", "-v", "0.2"]}


@pytest.fixture(scope="module")
def herest_system(tmp_path_factory):
    root = tmp_path_factory.mktemp("herest_ranks")
    return root, write_system(str(root), n_words=6, n_phones=8, n_tied=20,
                              n_mix=2, dim=39, n_utts=6, min_frames=60,
                              max_frames=150, fanout=3, seed=1,
                              binary_mmf=False)


def _herest_argv(s, cfg, out, args):
    args = [os.path.join(out, a) if a == "stats" else a for a in args]
    return ["-T", "1", "-C", cfg, "-H", s.hmmdefs, "-M", out, "-S",
            s.train_scp, "-I", s.train_mlf, *args, s.hmmlist]


@pytest.mark.parametrize("mode", list(HEREST_MODES))
def test_herest_across_ranks(herest_system, tmp_path, mode):
    _root, s = herest_system
    args = HEREST_MODES[mode]
    cfg = tmp_path / "ranks.cfg"
    cfg.write_text(HOST + f"HTKTPU: COORDINATOR = file://{tmp_path}/rv\n")
    one_cfg = tmp_path / "one.cfg"
    one_cfg.write_text(HOST)
    # each rank gets its own -M: rank 1's must stay empty
    outs = [str(tmp_path / f"rank{r}") for r in (0, 1)]
    for o in outs:
        os.makedirs(o)
    stdout = run_ranks(
        [[sys.executable, "-m", "htk_tpu_torch.tools.herest",
          *_herest_argv(s, str(cfg), o, args)] for o in outs],
        timeout=SPAWN_TIMEOUT)
    one, jax = str(tmp_path / "one"), str(tmp_path / "jax")
    os.makedirs(one)
    os.makedirs(jax)
    assert torch_herest.run(_herest_argv(s, str(one_cfg), one, args)) == 0
    assert jax_herest.run(_herest_argv(s, str(one_cfg), jax, args)) == 0
    assert os.listdir(outs[1]) == []
    assert stdout[1] == ""
    assert "HERest: saved" in stdout[0]
    assert sorted(os.listdir(outs[0])) == sorted(
        ["hmmdefs"] + (["stats"] if "-s" in args else []))
    for ref in (one, jax):
        assert_mmf_close(os.path.join(outs[0], "hmmdefs"),
                         os.path.join(ref, "hmmdefs"))
    if mode == "host":
        (names, occ), (rnames, rocc) = [
            read_stats(os.path.join(d, "stats")) for d in (outs[0], jax)]
        assert names == rnames
        np.testing.assert_allclose(occ, rocc, rtol=1e-3, atol=0.011)
    else:
        assert "retrying 6 utterance(s) at beam 0.5" in stdout[0]


class _Cuda:
    """A stand-in torch.cuda with `n` cards."""

    def __init__(self, n):
        self.n = n

    def is_available(self):
        return self.n > 0

    def device_count(self):
        return self.n


@pytest.mark.parametrize("world,local,want", [
    (None, None, "cuda"), ("1", "0", "cuda"), ("2", "1", "cuda:1"),
    ("4", "0", "cuda:0"), ("2", "2", 1091), ("3", "5", 1091)])
def test_default_device_per_rank(monkeypatch, world, local, want):
    monkeypatch.setenv("HTK_TPU_TORCH_DEVICE", "cuda")
    monkeypatch.setattr(_common.torch, "cuda", _Cuda(2))
    for k, v in (("WORLD_SIZE", world), ("LOCAL_RANK", local)):
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    if isinstance(want, int):
        with pytest.raises(HTKError) as e:
            _common.default_device()
        assert e.value.code == want
    else:
        assert _common.default_device() == torch.device(want)


def test_init_distributed_unconfigured(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.init_distributed() is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(HTKError) as e:
        mesh.make_mesh()
    assert e.value.code == 1093


@pytest.mark.parametrize("coordinator,world,rank", [
    ("localhost:1234", "2", "0"), ("file:///nowhere", None, "0"),
    ("file:///nowhere", "2", "2")])
def test_init_distributed_refuses(monkeypatch, coordinator, world, rank):
    for k, v in (("WORLD_SIZE", world), ("RANK", rank)):
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    with pytest.raises(HTKError) as e:
        mesh.init_distributed(coordinator=coordinator)
    assert e.value.code == 1092
    assert not torch.distributed.is_initialized()


def test_missing_rank_raises_1092():
    # one process of a world of 2: the other rank never comes
    with pytest.raises(RuntimeError, match=r"ERROR \[\+1092\]"):
        spawn_ranks(1, RANKS + "lonely_rank", {"timeout_s": 3},
                    env={"WORLD_SIZE": "2"}, timeout=SPAWN_TIMEOUT,
                    path=[TESTS])


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    dryrun_multichip(n, timeout=SPAWN_TIMEOUT)
