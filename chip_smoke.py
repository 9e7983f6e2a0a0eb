"""Smoke run of the PyTorch port on one NVIDIA GPU: HVite -w recognition.

Drives htk_tpu_torch's main path, `htk_tpu_torch.tools.hvite.run`, on a
synthetic system at htk_tpu's BASELINE config #4 widths (1,000-word
back-off bigram word network, 40 phones, word-internal triphones over
2,000 tied 8-mixture states, 39-dim MFCC_E_D_A; random weights from a
numpy seed; 16 utterances of about 500 frames). Phases, each raising on
failure:

  1. device: a CUDA card is required; its name and power limit are
     printed; the decode kernel (htk_tpu_torch/csrc/decode_scan.cu) is
     built from source with nvcc
  2. kernel against its plain torch version on random nets (several
     seeds, B > 1, a tie-heavy integer-score case)
  3. the config-#4 system written with the port's own writers
  4. HVite on the card: exit 0, one kernel launch per decode bucket,
     a transcript for every utterance; for one bucket the kernel and the
     plain version on the same real outp, and the tool's words and times
     against the plain path's; word accuracy (informational)
  5. decode-step time and xRT, kernel and plain, at B=8, T=512
  6. one JSON line of kernels, then the device line last

Tolerances: live scores within 1e-5 (the reference's own, and the sums
are in the same order, so they are in fact equal); every word-link record
exactly equal.

Usage: python3 chip_smoke.py        (exit 0 only if every phase passed)
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from htk_tpu_torch.algo.decode import (_final_records, _finalize,
                                       _net_outp, decode_operands)
from htk_tpu_torch.algo.net import compile_network, word_internal_phone_map
from htk_tpu_torch.io.dictionary import read_dict
from htk_tpu_torch.io.htkfeat import read_htk_file
from htk_tpu_torch.io.mlf import MLF
from htk_tpu_torch.io.mmf import load_mmf
from htk_tpu_torch.io.slf import read_slf
from htk_tpu_torch.models.hmmset import compile_hmmset
from htk_tpu_torch.ops import decode_scan as ds
from htk_tpu_torch.synth import (random_decode_net, word_accuracy,
                                 write_system)
from htk_tpu_torch.tools import hvite
from htk_tpu_torch.utils.logmath import LZERO

ATOL = 1e-5
DECODEBATCH = 8
N_UTTS = 16
# BASELINE config #4 widths (htk_tpu's bench.py build_tied_triphone_system)
SYSTEM = dict(n_words=1000, n_phones=40, n_tied=2000, n_mix=8, dim=39)
RANDOM_NET = dict(Ns=3000, Nn=200, K=3, B=4, T=48)
TIMING_B, TIMING_T = 8, 512
LM_SCALE, WORD_PEN = 8.0, -10.0
FRAME_S = 0.01


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def compare(kernel_out, plain_out, what: str) -> float:
    """Live scores within ATOL, records equal; returns max |diff|."""
    (vk, wnk, wtk), (WEk, pwnk, pwtk) = kernel_out
    (vp, wnp, wtp), (WEp, pwnp, pwtp) = plain_out
    err = 0.0
    for got, ref, name in ((vk, vp, "v"), (WEk, WEp, "WE")):
        live = ref > LZERO / 2
        if not torch.equal(live, got > LZERO / 2):
            raise AssertionError(f"{what}: live {name} sets differ")
        d = (got[live] - ref[live]).abs()
        e = float(d.max()) if d.numel() else 0.0
        if e > ATOL:
            raise AssertionError(f"{what}: {name} max |diff| {e} > {ATOL}")
        err = max(err, e)
    for got, ref, name in ((wnk, wnp, "wn"), (wtk, wtp, "wt"),
                           (pwnk, pwnp, "pwn"), (pwtk, pwtp, "pwt")):
        if not torch.equal(got, ref):
            n = int((got != ref).sum())
            raise AssertionError(f"{what}: {name} differs at {n} places")
    return err


def random_net(seed, dev, ties, **sizes):
    """synth.random_decode_net's operands as decode_scan arguments."""
    nos, outp, band, a0, aE, bonus, trans, start = [
        torch.as_tensor(a, device=dev)
        for a in random_decode_net(seed, ties=ties, **sizes)]
    Nn = trans.shape[0]
    return (outp, band, a0, aE, nos, bonus, trans, start,
            torch.full((Nn,), -1.0, device=dev), Nn)


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false")
    here = os.path.dirname(os.path.abspath(__file__))
    if not ds.KERNEL.library_path().startswith(here + os.sep):
        raise RuntimeError(f"chip_smoke: htk_tpu_torch is not the checkout's "
                           f"own ({ds.__file__}, not under {here})")
    log(f"device: {torch.cuda.get_device_name(0)}  "
        f"count={torch.cuda.device_count()}  torch={torch.__version__}  "
        f"cuda={torch.version.cuda}")
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    ds.KERNEL.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {ds.KERNEL.build_seconds:.2f} s)")
    return card


def phase_random_nets(dev) -> float:
    err = 0.0
    cases = [(seed, False) for seed in range(3)] + [(10, True), (11, True)]
    for seed, ties in cases:
        args = random_net(seed, dev, ties, **RANDOM_NET)
        k = ds.decode_scan_cuda(*args)
        p = ds.decode_scan_plain(*args)
        torch.cuda.synchronize(dev)
        e = compare(k, p, f"random net seed={seed} ties={ties}")
        live = int((p[1][1] >= 0).sum())
        log(f"random net seed={seed} ties={ties}: equal "
            f"(max |dv| {e:.3g}, {live} live word-end records)")
        err = max(err, e)
    return err


def phase_main_path(sysm, root, dev):
    cfg = os.path.join(root, "hvite.cfg")
    with open(cfg, "w") as f:
        f.write(f"HREC: DECODEBATCH = {DECODEBATCH}\n")
    mlf = os.path.join(root, "rec.mlf")
    argv = ["-T", "1", "-C", cfg, "-w", sysm.wdnet, "-H", sysm.hmmdefs,
            "-i", mlf, "-s", str(LM_SCALE), "-p", str(WORD_PEN),
            "-S", sysm.scp, sysm.dict, sysm.hmmlist]
    ds.KERNEL.launches = 0
    t0 = time.perf_counter()
    rc = hvite.run(argv)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = ds.KERNEL.launches
    if rc != 0:
        raise RuntimeError(f"HVite returned {rc}")
    n_buckets = -(-N_UTTS // DECODEBATCH)
    log(f"HVite: rc 0 in {wall:.2f} s, decode kernel launches {launches} "
        f"(buckets {n_buckets})")
    if launches != n_buckets:
        raise AssertionError(f"kernel launched {launches} times, expected "
                             f"{n_buckets}")
    m = MLF.load(mlf)
    hyps = {}
    for p in sysm.feats:
        stem = os.path.splitext(os.path.basename(p))[0]
        tr = m.lookup(f"*/{stem}.rec")
        if tr is None or not tr.names():
            raise AssertionError(f"no transcript for {stem}")
        hyps[p] = tr
    acc = word_accuracy(sysm.transcripts, [hyps[p].names() for p in sysm.feats])
    log(f"word accuracy vs synthesised transcripts: {acc:.2f}% "
        "(informational)")
    return launches, hyps


def phase_real_bucket(sysm, hyps, dev):
    """The first bucket again: kernel and plain on the same real outp;
    the plain path's words and times against the tool's MLF."""
    comp = compile_hmmset(load_mmf([sysm.hmmdefs]))
    net = compile_network(read_slf(sysm.wdnet), read_dict(sysm.dict), comp,
                          phone_map=word_internal_phone_map(comp.names))
    log(f"network: {net.n_nodes} nodes, {net.n_states} states, band "
        f"K={net.band.shape[0]}; {comp.n_mix} Gaussians, {comp.n_states} "
        f"tied states")
    feats = [read_htk_file(p).data for p in sysm.feats]
    order = sorted(range(len(feats)), key=lambda i: feats[i].shape[0])
    idx = order[:DECODEBATCH]
    lens = [feats[i].shape[0] for i in idx]
    T = -(-max(lens) // 128) * 128
    fb = np.zeros((len(idx), T, feats[0].shape[1]), np.float32)
    for b, i in enumerate(idx):
        fb[b, :lens[b]] = feats[i]
    args = decode_args(net, comp, fb, dev)
    k = ds.decode_scan_cuda(*args)
    p = ds.decode_scan_plain(*args)
    torch.cuda.synchronize(dev)
    err = compare(k, p, "config-4 bucket")
    log(f"config-4 bucket (B={len(idx)}, T={T}): kernel == plain "
        f"(max |dv| {err:.3g})")
    (v, wn, wt), (WE, pwn, pwt) = [[x.cpu().numpy() for x in g] for g in p]
    period = 100000
    for b, i in enumerate(idx):
        tr = lens[b]
        if tr == T:
            fin = _final_records(net, v[b], wn[b], wt[b])
        else:
            fin = (WE[b, tr].astype(np.float64), pwn[b, tr].astype(np.int64),
                   pwt[b, tr].astype(np.int64))
        res = _finalize(net, WE[b], pwn[b], pwt[b], *fin, tr, LM_SCALE)
        plain = [(w, t0 * period, (t1 + 1) * period)
                 for w, (t0, t1) in zip(res.words, res.times)]
        tool = [(lab.name, lab.start, lab.end) for lab in hyps[
            sysm.feats[i]].labels]
        if plain != tool:
            raise AssertionError(f"{sysm.feats[i]}: tool MLF {tool} != "
                                 f"plain path {plain}")
    log(f"tool MLF words and times == plain path for {len(idx)} utterances")
    return err, net, comp, feats


def decode_args(net, comp, fb, dev):
    """decode_scan's operands for padded frames `fb`, as the tool builds
    them."""
    return decode_operands(_net_outp(net, comp, fb, "highest", dev), net,
                           LM_SCALE, WORD_PEN)


def time_call(fn, dev, reps=3):
    """Wall times (ms) of `reps` calls of fn(), each ending in a
    synchronise, after one warm-up call."""
    fn()
    torch.cuda.synchronize(dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def phase_timing(net, comp, feats, card, dev):
    B, T = TIMING_B, TIMING_T
    fb = np.zeros((B, T, feats[0].shape[1]), np.float32)
    for b in range(B):
        n = min(T, feats[b].shape[0])
        fb[b, :n] = feats[b][:n]
    args = decode_args(net, comp, fb, dev)
    audio_s = B * T * FRAME_S
    # in turns: plain, kernel, kernel, plain (3 timed calls each)
    p = time_call(lambda: ds.decode_scan_plain(*args), dev)
    k = time_call(lambda: ds.decode_scan_cuda(*args), dev)
    k += time_call(lambda: ds.decode_scan_cuda(*args), dev)
    p += time_call(lambda: ds.decode_scan_plain(*args), dev)
    kms, pms = statistics.median(k), statistics.median(p)
    oms = statistics.median(time_call(
        lambda: _net_outp(net, comp, fb, "highest", dev), dev))
    log(f"timing on {card} (B={B}, T={T}, Nn={net.n_nodes}, "
        f"Ns={net.n_states}; median of 6 synchronised calls, taken in "
        f"turns plain/kernel/kernel/plain):")
    for name, ms, ts in (("kernel", kms, k), ("plain ", pms, p)):
        log(f"  decode_scan {name} {ms:.3f} ms per decode step "
            f"({ms / T * 1e3:.2f} us per frame), decode xRT "
            f"{ms / 1e3 / audio_s:.4e}; samples "
            + " ".join(f"{x:.3f}" for x in ts))
    log(f"  OutP (GaussianScorer, {comp.n_mix} Gaussians) {oms:.3f} ms")
    return kms, pms


def main() -> int:
    card = phase_device()
    dev = torch.device("cuda")
    err = phase_random_nets(dev)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        sysm = write_system(root, n_utts=N_UTTS, seed=0, **SYSTEM)
        log(f"config-4 system written in {time.perf_counter() - t0:.2f} s: "
            f"{N_UTTS} utterances, frames {sysm.n_frames}")
        launches, hyps = phase_main_path(sysm, root, dev)
        e2, net, comp, feats = phase_real_bucket(sysm, hyps, dev)
        kms, pms = phase_timing(net, comp, feats, card, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"kernels": [{
        "name": "decode_scan",
        "route": "cuda",
        "source": "htk_tpu_torch/csrc/decode_scan.cu",
        "replaces": "htk_tpu/ops/decode_pallas.py:137",
        "launches": launches,
        "max_abs_err": max(err, e2),
        "ms": kms,
        "plain_ms": pms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
