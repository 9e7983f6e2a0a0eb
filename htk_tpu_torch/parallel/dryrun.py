"""A multi-rank dry run of the port's parallel paths, and the launcher that
starts a group of ranks as local processes.

The twin of `__graft_entry__.py : dryrun_multichip`: on n ranks, one
sharded training step (`ShardedTrainer.accumulate`, batch_size 1), a
data-parallel decode of each rank's share on a 3-word loop and on a
trigram-guided LV net (`max_active=2`), gathered to n rows, the
time-sharded forward-backward of one utterance of 8n frames, and, for an
even n of at least 4, the (2, n/2) dp x t form. Each rank prints
DRYRUN_MULTICHIP_OK.

`run_ranks` starts one command a rank as local processes, each with
WORLD_SIZE and RANK, OMP_NUM_THREADS=1 and the device choice
(HTK_TPU_TORCH_DEVICE; LOCAL_RANK for a card a rank); it waits for all of
them under one timeout and raises if a rank fails or the time runs out,
killing the rest: a group whose ranks never meet cannot hang its caller.
`spawn_ranks` runs a function ("module:function") that way, the ranks
sharing a `file://` rendezvous given as the function's first argument;
run as a module with --child, this file is that rank.

Usage: python -m htk_tpu_torch.parallel.dryrun N   (a dry run of N ranks)
"""

from __future__ import annotations

import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..tools._common import DEVICE_ENV, default_device
from .mesh import ShardedTrainer, init_distributed, make_mesh

OK = "DRYRUN_MULTICHIP_OK"
TIMEOUT_S = 300.0  # the whole group's wall, start-up included
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_ranks(argvs: Sequence[Sequence[str]], *, device: str = "cpu",
              timeout: float = TIMEOUT_S, env: Optional[dict] = None,
              path: Sequence[str] = ()) -> List[str]:
    """Run command `argvs[r]` as rank r of len(argvs), each in its own
    process with WORLD_SIZE, RANK, LOCAL_RANK and OMP_NUM_THREADS=1;
    returns each rank's stdout. `device` "cpu" asks every rank for the
    CPU, "cuda" gives rank r the card cuda:r. `env` adds variables to
    every rank's environment, `path` directories to its module path.
    Raises RuntimeError when a rank exits non-zero or the group outlives
    `timeout` seconds (every rank is then killed)."""
    n = len(argvs)
    pypath = os.pathsep.join([*path, _ROOT, os.environ.get("PYTHONPATH",
                                                           "")])
    with tempfile.TemporaryDirectory(prefix="htk_ranks_") as tmp:
        procs, logs = [], []
        try:
            for r, argv in enumerate(argvs):
                e = dict(os.environ, WORLD_SIZE=str(n), RANK=str(r),
                         LOCAL_RANK=str(r), OMP_NUM_THREADS="1",
                         PYTHONPATH=pypath)
                e[DEVICE_ENV] = device
                e.update(env or {})
                logs.append([open(os.path.join(tmp, f"rank{r}.{k}"), "w+")
                             for k in ("out", "err")])
                procs.append(subprocess.Popen(list(argv), env=e,
                                              stdout=logs[-1][0],
                                              stderr=logs[-1][1]))
            deadline = time.monotonic() + timeout
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs, failed = [], []
        for r, (p, files) in enumerate(zip(procs, logs)):
            o, e = [f.seek(0) or f.read() for f in files]
            for f in files:
                f.close()
            outs.append(o)
            if p.returncode != 0:
                failed.append(f"rank {r} (rc {p.returncode}):\n{o[-2000:]}\n"
                              f"{e[-4000:]}")
        if failed:
            raise RuntimeError(f"{argvs[0]} as {n} ranks failed (timeout "
                               f"{timeout:.0f} s):\n" + "\n".join(failed))
        return outs


def spawn_ranks(n: int, target: str, kwargs: Optional[dict] = None,
                **how) -> List[str]:
    """Run `target(init_method, **kwargs)` ("module:function") as ranks
    0..n-1 of a fresh group over a `file://` rendezvous, through
    `run_ranks` (`how`: its device, timeout, env and path)."""
    with tempfile.TemporaryDirectory(prefix="htk_rv_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        argv = [sys.executable, "-m", "htk_tpu_torch.parallel.dryrun",
                "--child", init, target, json.dumps(kwargs or {})]
        return run_ranks([argv] * n, **how)


def _child(init: str, target: str, kwargs: str) -> None:
    mod, fn = target.split(":")
    getattr(importlib.import_module(mod), fn)(init, **json.loads(kwargs))


def _tiny_setup(n_phones=5, dim=8, nmix=2, n_utts=4, T=32):
    """The reference's dry-run system: 5 random 5-state phones of 2
    Gaussians in 8 dims, n_utts utterances of 6 phones and T frames."""
    from ..algo.trainer import prepare_utterance
    from ..models.hmmset import compile_hmmset
    from ..models.proto import clone_proto, make_proto

    rng = np.random.default_rng(0)
    hs = make_proto(nstates=5, dim=dim, parm_kind="USER", nmix=nmix)
    names = [f"ph{i}" for i in range(n_phones)]
    cl = clone_proto(hs, "proto", names)
    for h in cl.hmms.values():
        for si in h.states:
            for mp in si.streams[0].mixes:
                mp.mean = rng.normal(size=dim).astype(np.float32)
                mp.var = (0.5 + rng.random(dim)).astype(np.float32)
                mp.fix_gconst()
    comp = compile_hmmset(cl)
    utts = []
    for i in range(n_utts):
        seq = [names[j] for j in rng.integers(0, n_phones, 6)]
        feats = rng.normal(size=(T, dim)).astype(np.float32)
        utts.append(prepare_utterance(comp, f"u{i}", feats, seq))
    return comp, utts


def _dryrun_rank(n_devices: int) -> None:
    """The dry run's steps on this rank of an n-rank group."""
    from ..algo.composite import build_composite
    from ..algo.decode import run_decode_batch
    from ..algo.lvnet import compile_lv_loop
    from ..algo.net import compile_network
    from ..io.dictionary import Vocab
    from ..io.lm import NGramLM
    from ..ops.outp import all_state_outp
    from ..tools.hbuild import word_loop_lattice
    from .timeshard import _all_gather, fb_time_sharded, fb_time_sharded_batch

    dev = default_device()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    comp, utts = _tiny_setup(n_utts=n_devices)
    mesh = make_mesh(n_devices)
    accs = ShardedTrainer(comp, mesh, device=dev).accumulate(utts,
                                                             batch_size=1)
    if float(accs.n_utts) != n_devices:
        raise AssertionError(f"{float(accs.n_utts)} utterances landed, "
                             f"not {n_devices}: all shards must land")

    # decode: each rank scores its share (one utterance) of the batch;
    # the network and the model parameters are replicated
    rank = dist.get_rank()
    v = Vocab()
    for k in range(3):
        v.add_pron(f"W{k}", [f"ph{k}"])
    wl = [f"W{k}" for k in range(3)]
    net = compile_network(word_loop_lattice(wl), v, comp)
    x = torch.as_tensor(utts[rank].feats[None], device=dev)
    logb = all_state_outp(x, *[torch.as_tensor(a, device=dev) for a in (
        comp.means, comp.variances, comp.gconsts, comp.state_mix,
        comp.state_logw)])[0]
    (vf, _wn, _wt), _recs = run_decode_batch(
        logb[:, :, torch.as_tensor(net.comp_state, device=dev).long()], net,
        1.0, 0.0)
    if _all_gather(vf, None).flatten(0, 1).shape[0] != n_devices:
        raise AssertionError("the 3-word loop's decode lost rows")

    # LV decode with single-pass trigram guidance
    lm = NGramLM(order=3)
    for w in wl:
        lm.unigrams[w] = (math.log(0.3), math.log(0.2))
    for w1 in wl:
        for w2 in wl:
            lm.bigrams[(w1, w2)] = (math.log(0.3), math.log(0.5))
    lm.trigrams[(wl[0], wl[1], wl[2])] = math.log(0.9)
    netlv = compile_lv_loop(wl, v, comp, lm=lm, trigram=True)
    if netlv.xw_trigram is None:
        raise AssertionError("the LV net has no trigram guidance")
    (vlv, _w3, _t3), _r3 = run_decode_batch(
        logb[:, :, torch.as_tensor(netlv.comp_state, device=dev).long()],
        netlv, 8.0, 0.0, max_active=2)
    if _all_gather(vlv, None).flatten(0, 1).shape[0] != n_devices:
        raise AssertionError("the trigram-guided decode lost rows")

    # sequence parallelism on the same mesh, reused as a time axis: one
    # utterance of 8n frames, its frames sharded across the ranks
    hmm = build_composite(comp, [comp.model_id("ph0"),
                                 comp.model_id("ph1")])
    rng = np.random.default_rng(1)
    ops = [np.asarray(a, np.float32) for a in (hmm.logA, hmm.a0, hmm.aE)]
    outp = (-4.0 - 2.0 * rng.random((8 * n_devices, hmm.n_states))).astype(
        np.float32)
    al, be, lp, _xi = fb_time_sharded(torch.as_tensor(outp, device=dev),
                                      *ops, mesh, axis="data")
    gamma = torch.exp(al + be - lp).sum(dim=1)
    if not torch.allclose(gamma, torch.ones_like(gamma), atol=1e-3):
        raise AssertionError("time-sharded FB: posteriors do not sum to 1")

    # a (2, n/2) mesh: utterances data-parallel over one axis, each one's
    # time axis sharded over the other
    if n_devices >= 4 and n_devices % 2 == 0:
        from torch.distributed.device_mesh import init_device_mesh

        mesh2 = init_device_mesh(dev.type, (2, n_devices // 2),
                                 mesh_dim_names=("d", "t"))
        outp_b = (-4.0 - 2.0 * rng.random(
            (2, 8 * (n_devices // 2), hmm.n_states))).astype(np.float32)
        al2, be2, lp2, _xi2 = fb_time_sharded_batch(
            torch.as_tensor(outp_b, device=dev), *ops, mesh2)
        i = dist.get_rank(mesh2.get_group("d"))
        g2 = torch.exp(al2 + be2 - lp2[i:i + 1, None, None]).sum(dim=2)
        if not torch.allclose(g2, torch.ones_like(g2), atol=1e-3):
            raise AssertionError("2-D FB: posteriors do not sum to 1")


def _dryrun_child(init: str, n_devices: int) -> None:
    init_distributed(coordinator=init)
    try:
        _dryrun_rank(n_devices)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(OK, flush=True)


def dryrun_multichip(n_devices: int, timeout: float = TIMEOUT_S) -> None:
    """The dry run on n ranks: in this process when it is already a rank
    of an n-rank group, else as n fresh processes, gloo on the CPU or
    NCCL with a card a rank when the tools' device is a card and n of
    them are visible. Raises when a step or a rank fails."""
    if dist.is_initialized() and dist.get_world_size() == n_devices:
        _dryrun_rank(n_devices)
        return
    cards = (os.environ.get(DEVICE_ENV, "cuda").strip().lower() != "cpu"
             and torch.cuda.is_available()
             and n_devices <= torch.cuda.device_count())
    outs = spawn_ranks(n_devices, "htk_tpu_torch.parallel.dryrun:"
                       "_dryrun_child", {"n_devices": n_devices},
                       device="cuda" if cards else "cpu", timeout=timeout)
    missing = [r for r, o in enumerate(outs) if OK not in o]
    if missing:
        raise RuntimeError(f"dryrun_multichip: ranks {missing} did not "
                           f"print {OK}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        _child(*sys.argv[2:5])
    else:
        dryrun_multichip(int(sys.argv[1]))
        print(OK)
