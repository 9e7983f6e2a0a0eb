"""Smoke run of the PyTorch port on one NVIDIA GPU: HVite -w recognition,
HERest Baum-Welch training and the uniform-row LV decoder.

Drives htk_tpu_torch's main paths, `htk_tpu_torch.tools.hvite.run`,
`htk_tpu_torch.tools.herest.run` and `algo.decode.decode_batch` on a
`compile_lv_loop` network, on a synthetic system at htk_tpu's BASELINE
config #4 widths (1,000-word back-off bigram, as a word network and as
ARPA tables; 40 phones, word-internal triphones over 2,000 tied 8-mixture
states, 39-dim MFCC_E_D_A; random weights from a numpy seed; 16
utterances of about 500 frames, with their phone-level transcriptions).
Phases, each raising on failure:

  1. device: a CUDA card is required; its name and power limit are
     printed; the three kernels (htk_tpu_torch/csrc/decode_scan.cu,
     fb_scans.cu and maxplus.cu) are built from source with nvcc, in
     parallel
  2. the decode kernel against its plain torch version on random nets
     (several seeds, B > 1, a tie-heavy integer-score case)
  3. the FB scans kernel against its plain version on random composites
     (two seeds, B = 4, Q = 50 and Q = 250, whose logA does not fit shared
     memory; rows with t_real < T and t_real = 0; no beam, a loose beam,
     one that kills some rows and one that kills all)
  4. the config-#4 system written with the port's own writers
  5. HVite on the card: exit 0, one decode launch per bucket, a transcript
     for every utterance; for one bucket the kernel and the plain version
     on the same real outp, and the tool's words and times against the
     plain path's; word accuracy (informational)
  6. HERest on the card, two iterations (-B, -S train.scp -I train.mlf):
     exit 0 each, one fb_scans launch per FB batch, the average log prob
     per frame rising; for the first batch the kernel and the plain
     version on the same real operands, and the tool path's accumulators
     against the plain path's; then HVite decodes with the re-estimated
     MMF (exit 0, word accuracy informational)
  7. times, kernel and plain taken in turns: the decode step at B=8,
     T=512, the FB scans on the real bucket (B=8, T=512, Q=192), HERest
     iterations in utterances and audio seconds per second; under
     torch.profiler, the device time of the FB kernel's two parts and the
     device's busy share of a HERest iteration
  8. the maxplus kernel (both floor contracts) and the tropical wrappers
     against the plain version on random operands (two seeds, B in
     {1, 8, 17}, C in {1, 200, 1000, 2050}; normal, tie-heavy integer
     scores and all-dead rows): values and arguments exactly equal
  9. the LV decoder: `compile_lv_loop` over the system's dict and
     lm.arpa (1,000 rows, S=16); `decode_batch` of the 16 utterances in
     2 batches of 8 at the HVite settings: one maxplus launch per padded
     frame per batch, a transcript for every utterance, equal to HVite
     -w's; for one batch the kernel leg and the plain leg on the same
     real outp (planes as for decode, and the same 1-best); the dense
     top-A leg (max_active=128) once, for information; then the tropical
     path: that batch's cross-word products replayed through the
     tropical wrappers (operand padded once, one call per frame), each
     equal to the plain version
 10. times, in turns plain/kernel/kernel/plain: maxplus and tropical per
     launch (CUDA events over 100 launches) at B=8, C=1,000 on a real
     frame, one LV batch (B=8, T=512) with each leg, and `decode_batch`
     of the 16 utterances as xRT; under torch.profiler, one LV batch's
     device busy share, the maxplus kernel's share and the top device
     operations
 11. one JSON line of kernels, then the device line last

Each main path runs with every launch count set to 0 just before it and
read just after. Tolerances, kernel against plain: maxplus and tropical
exactly equal; decode and the LV planes: live scores
within 1e-5 and every word-link record exactly equal; FB logP within 1e-5
relative, alphas and betas at t < t_real with the same live sets (above
LZERO/2) and within 1e-5 |ref| + 1e-4, xi of live utterances within rtol
1e-4, atol 1e-6; the accumulators of a batch within 1e-2 of each field's
largest magnitude (alphas of magnitude ~3e4 differ by float32 ulps of the
sums' order, which moves occupancies by ~1e-3).

`bound_ms` is the larger of the bytes each kernel must move (inputs read
once, outputs written once) over 3.35 TB/s and its operations over the
67 TFLOP/s of FP32 outside the tensor cores (H100 SXM data sheet; exp
and log counted as one operation each); for the FB scans only the live
(above LZERO/2) cells of logA count, since the others add exactly
nothing; for maxplus and tropical, trans and WE in, values and arguments
out, an add and a compare per (b, i, j). No single PyTorch call computes
any of these kernels' functions (max-plus with argmax has none), so
`library_ms` is null.

Usage: python3 chip_smoke.py        (exit 0 only if every phase passed)
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from htk_tpu_torch.algo import decode as dec
from htk_tpu_torch.algo.decode import (_final_records, _finalize,
                                       _net_outp, decode_operands)
from htk_tpu_torch.algo.fb import _fb_outp
from htk_tpu_torch.algo.lvnet import compile_lv_loop
from htk_tpu_torch.algo.net import compile_network, word_internal_phone_map
from htk_tpu_torch.algo.trainer import (DeviceCompositeTrainer, _bucket,
                                        prepare_utterance_ids)
from htk_tpu_torch.io.dictionary import read_dict
from htk_tpu_torch.io.htkfeat import read_htk_file
from htk_tpu_torch.io.lm import read_arpa
from htk_tpu_torch.io.mlf import MLF
from htk_tpu_torch.io.mmf import load_mmf
from htk_tpu_torch.io.slf import read_slf
from htk_tpu_torch.models.hmmset import compile_hmmset
from htk_tpu_torch.ops import decode_scan as ds
from htk_tpu_torch.ops import fb_scans as fbs
from htk_tpu_torch.ops import maxplus as mp
from htk_tpu_torch.ops import tropical as trop
from htk_tpu_torch.synth import (random_decode_net, random_fb_operands,
                                 random_maxplus_operands, word_accuracy,
                                 write_system)
from htk_tpu_torch.tools import herest, hvite
from htk_tpu_torch.tools._common import DEVICE_ENV
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
KERNELS = (ds.KERNEL, fbs.KERNEL, mp.KERNEL)
COUNTS = KERNELS + (trop.LAUNCHES,)  # tropical launches the maxplus kernel
MAXPLUS_BS, MAXPLUS_CS = (1, 8, 17), (1, 200, 1000, 2050)
MAXPLUS_MODES = {"normal": {}, "ties": {"ties": True},
                 "dead row": {"dead_rows": 1}}
TOPA = 128  # the dense top-A leg's max_active (htk_tpu's bench.py 5k row)
LAUNCH_LOOP = 100  # back-to-back launches per timed sample of one kernel
PAD_T = 128  # decode_batch pads T to a multiple of this
HEREST_BATCH = 8
RANDOM_FB = dict(B=4, T=40, t_real=[40, 33, 20, 0])
FB_QS = (50, 250)  # Q = 250: logA in global memory
FB_BEAMS = (None, 10.0, 5.0, 2.0)  # 5 kills some rows, 2 all of them
ACC_TOL = 1e-2
HBM_BPS, FP32_OPS = 3.35e12, 67e12  # H100 SXM data sheet


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


def reset_counts() -> None:
    for k in COUNTS:
        k.launches = 0


def compare_scans(got, ref, t_real, what: str) -> float:
    """FB scans kernel against plain at the tolerances of the module
    docstring; returns the max |diff| over logP, the live alphas and betas
    at t < t_real and the xi of live utterances."""
    al, be, lp, xi = got
    al_r, be_r, lp_r, xi_r = ref
    if not torch.allclose(lp, lp_r, rtol=1e-5, atol=0):
        raise AssertionError(f"{what}: logP {lp.tolist()} != {lp_r.tolist()}")
    err = float((lp - lp_r).abs().max())
    for b, tr in enumerate(t_real.tolist()):
        for g, r, name in ((al[b, :tr], al_r[b, :tr], "alpha"),
                           (be[b, :tr], be_r[b, :tr], "beta")):
            live = r > LZERO / 2
            if not torch.equal(live, g > LZERO / 2):
                raise AssertionError(f"{what}: row {b}: live {name} sets "
                                     "differ")
            d = (g[live] - r[live]).abs()
            if d.numel() and not bool(
                    (d <= 1e-5 * r[live].abs() + 1e-4).all()):
                raise AssertionError(f"{what}: row {b}: {name} max |diff| "
                                     f"{float(d.max())}")
            err = max(err, float(d.max()) if d.numel() else 0.0)
        if float(lp_r[b]) > LZERO / 2:  # a failed utterance's xi is unused
            if not torch.allclose(xi[b], xi_r[b], rtol=1e-4, atol=1e-6):
                raise AssertionError(f"{what}: row {b}: xi differs by "
                                     f"{float((xi[b] - xi_r[b]).abs().max())}")
            err = max(err, float((xi[b] - xi_r[b]).abs().max()))
    return err


def bound(name: str, nbytes: float, ops: float):
    """(ms, what bounds it): the larger of bytes over HBM bandwidth and
    operations over the FP32 peak; both are printed."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / FP32_OPS * 1e3
    log(f"{name} bound: bytes {nbytes / 1e6:.3f} MB = {tb:.6f} ms, "
        f"operations {ops:.4g} = {to:.6f} ms")
    return (tb, "bytes") if tb >= to else (to, "operations")


def decode_bound(B, T, Ns, Nn, K):
    """decode_scan: outp, band, the per-state and per-node vectors and
    trans in; the (B, T, Nn) records and (B, Ns) finals out. Per frame and
    utterance an add and a max for each band candidate and word end, four
    more for each state's combine, and an add and a max for each (i, j)
    of the cross-word step (none at t = 0)."""
    nbytes = 4 * (B * T * Ns + K * Ns + 4 * Ns + Nn * Nn + 2 * Nn
                  + 3 * B * T * Nn + 3 * B * Ns)
    ops = B * (T * (2 * K + 6) * Ns + (T - 1) * (2 * Nn * Nn + Nn))
    return bound("decode_scan", nbytes, ops)


def fb_bound(outp, logA, t_real):
    """fb_scans: outp, logA, a0, aE, t_real in; alphas, betas, logP, xi
    out. Each live cell of logA costs about five operations (add, max,
    subtract, exp, add) per step of each scan (T steps) and of xi
    (t_real - 1 steps); each output of a reduction a log and an add."""
    B, T, Q = outp.shape
    nnz = (logA > LZERO / 2).sum(dim=(1, 2)).double()
    steps = 2 * T + (t_real.double() - 1).clamp(min=0)
    ops = float(5 * (steps * nnz).sum()) + 4 * B * T * Q
    nbytes = 4 * (3 * B * T * Q + 2 * B * Q * Q + 2 * B * Q + 2 * B)
    return bound("fb_scans", nbytes, ops)


def maxplus_bound(name, B, C):
    """maxplus / tropical: WE and trans in, values and arguments out; an
    add and a compare per (b, i, j)."""
    return bound(name, 4 * (C * C + 3 * B * C), 2 * B * C * C)


@contextlib.contextmanager
def plain_scans():
    """algo/fb runs its scans through the plain version inside."""
    saved = fbs.fb_scans
    fbs.fb_scans = fbs.fb_scans_plain
    try:
        yield
    finally:
        fbs.fb_scans = saved


@contextlib.contextmanager
def plain_maxplus():
    """The LV decoder's dense leg runs the plain version inside."""
    saved = mp.maxplus
    mp.maxplus = mp.maxplus_plain
    try:
        yield
    finally:
        mp.maxplus = saved


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false")
    here = os.path.dirname(os.path.abspath(__file__))
    if not all(k.library_path().startswith(here + os.sep) for k in KERNELS):
        raise RuntimeError(f"chip_smoke: htk_tpu_torch is not the checkout's "
                           f"own ({ds.__file__}, not under {here})")
    log(f"device: {torch.cuda.get_device_name(0)}  "
        f"count={torch.cuda.device_count()}  torch={torch.__version__}  "
        f"cuda={torch.version.cuda}")
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(lambda k: k.build(), KERNELS))
    log(f"kernel builds: {time.perf_counter() - t0:.2f} s in parallel ("
        + ", ".join(f"{k.name} nvcc {k.build_seconds:.2f} s"
                    for k in KERNELS) + ")")
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


def phase_main_path(sysm, root, dev, mmf=None, what="HVite"):
    cfg = os.path.join(root, "hvite.cfg")
    with open(cfg, "w") as f:
        f.write(f"HREC: DECODEBATCH = {DECODEBATCH}\n")
    mlf = os.path.join(root, "rec.mlf" if mmf is None else "rec_trained.mlf")
    argv = ["-T", "1", "-C", cfg, "-w", sysm.wdnet, "-H", mmf or sysm.hmmdefs,
            "-i", mlf, "-s", str(LM_SCALE), "-p", str(WORD_PEN),
            "-S", sysm.scp, sysm.dict, sysm.hmmlist]
    reset_counts()
    t0 = time.perf_counter()
    rc = hvite.run(argv)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = ds.KERNEL.launches
    if rc != 0:
        raise RuntimeError(f"{what} returned {rc}")
    n_buckets = -(-N_UTTS // DECODEBATCH)
    log(f"{what}: rc 0 in {wall:.2f} s, decode kernel launches {launches} "
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


def phase_random_fb(dev) -> float:
    err = 0.0
    for Q in FB_QS:
        where = ("shared" if fbs.smem_bytes(Q) <= fbs.SMEM_MAX
                 else "global")
        for seed in range(2):
            args = [torch.as_tensor(a, device=dev) for a in
                    random_fb_operands(seed, Q=Q, **RANDOM_FB)]
            for beam in FB_BEAMS:
                what = f"random FB Q={Q} seed={seed} beam={beam}"
                k = fbs.fb_scans_cuda(*args, beam=beam)
                p = fbs.fb_scans_plain(*args, beam=beam)
                torch.cuda.synchronize(dev)
                e = compare_scans(k, p, args[4], what)
                dead = int((p[2] <= LZERO / 2).sum())
                log(f"{what} (logA in {where} memory): agree (max |d| "
                    f"{e:.3g}; {dead} of {len(p[2])} rows without a path)")
                err = max(err, e)
    return err


def herest_batches(sysm) -> int:
    """FB batches of one HERest pass: buckets of (T, K) pads, as
    DeviceCompositeTrainer forms them, in batches of HEREST_BATCH."""
    mlf = MLF.load(sysm.train_mlf)
    counts = {}
    for path, n in zip(sysm.feats, sysm.n_frames):
        stem = os.path.splitext(os.path.basename(path))[0]
        key = (_bucket(n), _bucket(len(mlf.lookup(f"*/{stem}.lab").names()),
                                   8))
        counts[key] = counts.get(key, 0) + 1
    return sum(-(-c // HEREST_BATCH) for c in counts.values())


def phase_herest(sysm, root, card, dev):
    """Two HERest iterations on the card; returns (fb_scans launches, the
    last MMF, logP per frame and wall seconds of each iteration)."""
    n_batches = herest_batches(sysm)
    audio_s = sum(sysm.n_frames) * FRAME_S
    mmf, lps, walls, launches = sysm.hmmdefs, [], [], 0
    for it in (1, 2):
        out = os.path.join(root, f"hmm{it}")
        os.makedirs(out)
        cfg, metrics = (os.path.join(out, "herest.cfg"),
                        os.path.join(out, "metrics.jsonl"))
        with open(cfg, "w") as f:
            f.write(f"HTKTPU: METRICS = {metrics}\n")
        argv = ["-T", "1", "-B", "-b", str(HEREST_BATCH), "-C", cfg, "-H",
                mmf, "-M", out, "-S", sysm.train_scp, "-I", sysm.train_mlf,
                sysm.hmmlist]
        reset_counts()
        t0 = time.perf_counter()
        rc = herest.run(argv)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        n = fbs.KERNEL.launches
        if rc != 0:
            raise RuntimeError(f"HERest iteration {it} returned {rc}")
        if n != n_batches:
            raise AssertionError(f"HERest iteration {it}: fb_scans launched "
                                 f"{n} times, expected {n_batches}")
        with open(metrics) as f:
            lps.append(json.loads(f.read().splitlines()[-1])
                       ["logp_per_frame"])
        walls.append(wall)
        launches += n
        mmf = os.path.join(out, os.path.basename(sysm.hmmdefs))
        log(f"HERest iteration {it} on {card}: rc 0 in {wall:.3f} s "
            f"({N_UTTS / wall:.2f} utt/s, {audio_s / wall:.1f} s of audio "
            f"per s), fb_scans launches {n} (FB batches {n_batches}), "
            f"average log prob per frame {lps[-1]:.5f}")
    if not lps[1] > lps[0]:
        raise AssertionError(f"average log prob per frame did not rise: "
                             f"{lps}")
    return launches, mmf, lps, walls


def phase_real_fb_batch(sysm, dev):
    """The first FB batch of the initial model: kernel and plain on the
    same real operands; the tool path's accumulators against the plain
    path's."""
    comp = compile_hmmset(load_mmf([sysm.hmmdefs]))
    mlf = MLF.load(sysm.train_mlf)
    utts = []
    for path in sysm.feats:
        stem = os.path.splitext(os.path.basename(path))[0]
        utts.append(prepare_utterance_ids(
            comp, stem, read_htk_file(path).data,
            mlf.lookup(f"*/{stem}.lab").names()))
    trainer = DeviceCompositeTrainer(comp, device=dev)
    params = trainer.params()
    _batch, arrs = next(trainer.batches(utts, HEREST_BATCH))
    outp = _fb_outp(arrs["feats"], arrs["comp_state"], arrs["q_mask"],
                    **params, slot_blocks=tuple(comp.slot_blocks) or None)[0]
    ops = (outp, arrs["logA"], arrs["a0"], arrs["aE"], arrs["t_real"])
    k = fbs.fb_scans_cuda(*ops)
    p = fbs.fb_scans_plain(*ops)
    torch.cuda.synchronize(dev)
    B, T, Q = outp.shape
    err = compare_scans(k, p, ops[4], "config-4 FB batch")
    log(f"config-4 FB batch (B={B}, T={T}, Q={Q}, {comp.n_mix} Gaussians): "
        f"kernel and plain agree (max |d| {err:.3g}, logP "
        f"{[round(x, 2) for x in p[2].tolist()]})")
    _lk, acc_k = trainer._fb(params, arrs, None)
    with plain_scans():
        _lp, acc_p = trainer._fb(params, arrs, None)
    torch.cuda.synchronize(dev)
    tl, tl_r = float(acc_k.total_logp), float(acc_p.total_logp)
    if abs(tl - tl_r) > 1e-5 * abs(tl_r):
        raise AssertionError(f"accumulators: total logP {tl} != {tl_r}")
    worst = {}
    for f in ("occ", "sum_x", "sum_xx", "wt_occ", "tr"):
        g, r = getattr(acc_k, f), getattr(acc_p, f)
        worst[f] = float((g - r).abs().max() / r.abs().max())
        if worst[f] > ACC_TOL:
            raise AssertionError(f"accumulators: {f} differs by "
                                 f"{worst[f]:.3g} of its scale")
    log("tool-path accumulators == plain path's (max |diff| / scale: "
        + ", ".join(f"{f} {v:.2e}" for f, v in worst.items()) + ")")
    return err, ops, trainer, utts


def phase_fb_timing(ops, trainer, utts, card, dev):
    B, T, Q = ops[0].shape
    # in turns: plain, kernel, kernel, plain (3 timed calls each)
    p = time_call(lambda: fbs.fb_scans_plain(*ops), dev)
    k = time_call(lambda: fbs.fb_scans_cuda(*ops), dev)
    k += time_call(lambda: fbs.fb_scans_cuda(*ops), dev)
    p += time_call(lambda: fbs.fb_scans_plain(*ops), dev)
    kms, pms = statistics.median(k), statistics.median(p)
    acc = time_call(lambda: trainer.accumulate(utts, HEREST_BATCH), dev)
    audio_s = sum(u.feats.shape[0] for u in utts) * FRAME_S
    log(f"timing on {card} (B={B}, T={T}, Q={Q}; median of 6 synchronised "
        f"calls, taken in turns plain/kernel/kernel/plain):")
    for name, ms, ts in (("kernel", kms, k), ("plain ", pms, p)):
        log(f"  fb_scans {name} {ms:.3f} ms per FB batch; samples "
            + " ".join(f"{x:.3f}" for x in ts))
    am = statistics.median(acc)
    log(f"  FB pass (DeviceCompositeTrainer.accumulate, {len(utts)} "
        f"utterances) {am:.3f} ms: {len(utts) / am * 1e3:.2f} utt/s, "
        f"{audio_s / am * 1e3:.1f} s of audio per s; samples "
        + " ".join(f"{x:.3f}" for x in acc))
    return kms, pms


def device_profile(fn, dev):
    """Wall ms of one synchronised fn() under torch.profiler, the device
    ms of each kernel it ran, largest first (empty when the profiler saw
    no device time), and the number of device operations it ran."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    times, n = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            times[e.key] = e.self_device_time_total / 1e3
            n += e.count
    return wall, sorted(times.items(), key=lambda kv: -kv[1]), n


def phase_profile(sysm, ops, root, card, dev):
    """Where the time goes: the two kernels of one fb_scans call, and the
    device's share of one HERest iteration's wall time."""
    fbs.fb_scans_cuda(*ops)
    wall, ks, _n = device_profile(lambda: fbs.fb_scans_cuda(*ops), dev)
    log(f"profile on {card} of one fb_scans call ({wall:.3f} ms wall): "
        + (", ".join(f"{k[:40]} {ms:.3f} ms" for k, ms in ks)
           or "no device time seen"))
    out = os.path.join(root, "hmm_profiled")
    argv = ["-H", sysm.hmmdefs, "-M", out, "-S", sysm.train_scp, "-I",
            sysm.train_mlf, sysm.hmmlist]
    wall, ks, _n = device_profile(lambda: herest.run(argv), dev)
    busy = sum(ms for _k, ms in ks)
    log(f"profile on {card} of one HERest iteration: wall {wall:.1f} ms, "
        f"device busy "
        f"{busy:.1f} ms ({100 * busy / wall:.1f}%); top kernels: "
        + ", ".join(f"{k[:40]} {ms:.2f} ms" for k, ms in ks[:6]))


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


def check_equal(got, ref, what: str) -> float:
    """maxplus outputs (values, arguments) exactly equal; returns the max
    |diff| of the values (0.0)."""
    for g, r, name in ((got[0], ref[0], "values"), (got[1], ref[1], "args")):
        if not torch.equal(g, r):
            n = int((g != r).sum())
            raise AssertionError(f"{what}: {name} differ at {n} places")
    return float((got[0] - ref[0]).abs().max()) if got[0].numel() else 0.0


def padded(WE, Cp):
    """WE (B, C) in a (B rounded up to 8, Cp) LZERO block, as the
    tropical wrappers' padded operands are laid out."""
    B, C = WE.shape
    out = torch.full((-(-B // 8) * 8, Cp), LZERO, device=WE.device)
    out[:B, :C] = WE
    return out


def phase_random_maxplus(dev) -> float:
    err, n = 0.0, 0
    for mode, kw in MAXPLUS_MODES.items():
        for seed in range(2):
            for B in MAXPLUS_BS:
                for C in MAXPLUS_CS:
                    WE, tr = [torch.as_tensor(a, device=dev) for a in
                              random_maxplus_operands(seed, B=B, C=C, **kw)]
                    what = f"maxplus {mode} seed={seed} B={B} C={C}"
                    for floor in (False, True):
                        err = max(err, check_equal(
                            mp.maxplus_cuda(WE, tr, floor),
                            mp.maxplus_plain(WE, tr, floor),
                            f"{what} floor={floor}"))
                    tT = trop.pad_tropical_operand(tr)
                    out = trop.tropical_matvec_argmax_padded(
                        padded(WE, tT.shape[0]), tT)
                    err = max(err, check_equal(
                        [x[:B, :C] for x in out],
                        mp.maxplus_plain(WE, tr, True), f"tropical {what}"))
                    err = max(err, check_equal(
                        trop.tropical_matvec_argmax(WE, tr, use_pallas=False),
                        mp.maxplus_plain(WE, tr, False),
                        f"tropical {what} unfloored"))
                    n += 1
    torch.cuda.synchronize(dev)
    log(f"maxplus (floor off and on) and tropical (padded, and unfloored) "
        f"== plain exactly on {n} random operand sets")
    return err


def lv_network(sysm, comp):
    vocab = read_dict(sysm.dict)
    t0 = time.perf_counter()
    net = compile_lv_loop(list(vocab.words), vocab, comp,
                          lm=read_arpa(sysm.lm),
                          phone_map=word_internal_phone_map(comp.names))
    log(f"LV network (compile_lv_loop over dict and lm.arpa, "
        f"{time.perf_counter() - t0:.2f} s): C={net.n_nodes} rows, "
        f"S={net.uniform_width}, Ns={net.n_states}, K={net.band.shape[0]}, "
        f"dense trans {tuple(net.trans.shape)}")
    return net


def lv_batches(n):
    return [list(range(i, min(i + DECODEBATCH, n)))
            for i in range(0, n, DECODEBATCH)]


def pad_T(lens) -> int:
    return -(-max(lens) // PAD_T) * PAD_T


def lv_decode_all(net, comp, feats, dev, max_active=None):
    out = []
    for idx in lv_batches(len(feats)):
        out += dec.decode_batch(net, comp, [feats[i] for i in idx], LM_SCALE,
                                WORD_PEN, max_active=max_active, device=dev)
    return out


def phase_lv_main(sysm, hyps, net, comp, feats, dev):
    """The LV decoder's main path: decode_batch of every utterance."""
    want = sum(pad_T([feats[i].shape[0] for i in idx])
               for idx in lv_batches(len(feats)))
    reset_counts()
    t0 = time.perf_counter()
    res = lv_decode_all(net, comp, feats, dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = mp.KERNEL.launches
    log(f"LV decode_batch: {len(feats)} utterances in {wall:.3f} s, maxplus "
        f"launches {launches} (padded frames over the batches: {want})")
    if launches != want:
        raise AssertionError(f"maxplus launched {launches} times, expected "
                             f"{want}")
    for path, r in zip(sysm.feats, res):
        if r is None or not r.words:
            raise AssertionError(f"LV: no transcript for {path}")
        if r.words != hyps[path].names():
            raise AssertionError(f"LV {path}: {r.words} != HVite -w "
                                 f"{hyps[path].names()}")
    acc = word_accuracy(sysm.transcripts, [r.words for r in res])
    log(f"LV transcripts == HVite -w's for all {len(res)} utterances; word "
        f"accuracy {acc:.2f}% (informational)")
    return launches


def lv_batch_args(net, comp, feats, dev):
    """The first batch's frames and its decode_scan_uniform_batch
    operands on real outp, as the decoder builds them."""
    idx = lv_batches(len(feats))[0]
    lens = [feats[i].shape[0] for i in idx]
    fb = np.zeros((len(idx), pad_T(lens), feats[0].shape[1]), np.float32)
    for b, i in enumerate(idx):
        fb[b, :lens[b]] = feats[i]
    d = dec._net_dev(net, dev)
    outp = _net_outp(net, comp, fb, "highest", dev)
    args = (outp, d["band"], d["a0"], d["aE"], net.uniform_width,
            d["bonus"], d["trans"] * LM_SCALE, d["start"] * LM_SCALE,
            WORD_PEN)
    return [feats[i] for i in idx], lens, args


def phase_lv_real_batch(net, comp, batch, lens, args, dev):
    """Kernel leg and plain leg on the same real outp: planes and 1-best;
    then the dense top-A leg once."""
    k = dec.decode_scan_uniform_batch(*args)
    with plain_maxplus():
        p = dec.decode_scan_uniform_batch(*args)
    torch.cuda.synchronize(dev)
    B, T, Ns = args[0].shape
    err = compare(k, p, "LV batch")
    d = dec._net_dev(net, dev)
    best = [dec._traceback_device(*out[0], *out[1], d["aE"],
                                  d["end_exit"] * LM_SCALE, lens,
                                  net.uniform_width) for out in (k, p)]
    if not (torch.equal(best[0][0], best[1][0])
            and torch.equal(best[0][1], best[1][1])):
        raise AssertionError("LV batch: kernel and plain 1-best differ")
    log(f"LV batch (B={B}, T={T}, Ns={Ns}): kernel leg == plain leg (max "
        f"|dv| {err:.3g}; records and 1-best equal)")
    t0 = time.perf_counter()
    ra = dec.decode_batch(net, comp, batch, LM_SCALE, WORD_PEN,
                          max_active=TOPA, device=dev)
    torch.cuda.synchronize(dev)
    log(f"LV dense top-A leg (max_active={TOPA}), first batch: "
        f"{time.perf_counter() - t0:.3f} s; words "
        f"{sum(len(r.words) for r in ra if r)} (informational)")
    return err, p[1][0]


def phase_tropical_path(net, WEs, dev):
    """The tropical wrappers' path: the batch's cross-word products (word
    ends WEs (B, T, C) from the plain leg) replayed frame by frame through
    pad_tropical_operand (once) and tropical_matvec_argmax_padded."""
    trans = dec._net_dev(net, dev)["trans"] * LM_SCALE
    B, T, C = WEs.shape
    reset_counts()
    tT = trop.pad_tropical_operand(trans)
    WEp = [padded(WEs[:, t], tT.shape[0]) for t in range(T)]
    outs = [trop.tropical_matvec_argmax_padded(w, tT) for w in WEp]
    torch.cuda.synchronize(dev)
    launches = trop.LAUNCHES.launches
    if launches != T:
        raise AssertionError(f"tropical launched {launches} times, expected "
                             f"{T}")
    err = 0.0
    for t, (v, a) in enumerate(outs):
        err = max(err, check_equal(
            (v[:B, :C], a[:B, :C]),
            mp.maxplus_plain(WEs[:, t].contiguous(), trans, True),
            f"tropical path frame {t}"))
    log(f"tropical path: {launches} launches (one per frame), each == plain")
    return launches, err, (WEp[T // 2], tT)


def time_launches(fn, dev, n=LAUNCH_LOOP, reps=3):
    """Device ms per call of fn(): CUDA events around n back-to-back
    calls, after one warm-up call; `reps` samples."""
    fn()
    torch.cuda.synchronize(dev)
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1) / n)
    return ts


def in_turns(timer, plain, kernel, dev):
    """Medians of 6 (plain, kernel, kernel, plain; 3 samples each)."""
    p = timer(plain, dev)
    k = timer(kernel, dev)
    k += timer(kernel, dev)
    p += timer(plain, dev)
    return statistics.median(k), statistics.median(p), k, p


def phase_lv_timing(net, comp, feats, batch, args, WEs, trop_ops, card,
                    dev):
    B, T = args[0].shape[:2]
    WE = WEs[:, T // 2].contiguous()
    trans = args[6]
    C = WE.shape[1]
    mk, mpl, ks, ps = in_turns(
        time_launches, lambda: mp.maxplus_plain(WE, trans, False),
        lambda: mp.maxplus_cuda(WE, trans, False), dev)
    WEp, tT = trop_ops
    tp = tT.t().contiguous()
    tk, tpl, tks, tps = in_turns(
        time_launches, lambda: mp.maxplus_plain(WEp, tp, True),
        lambda: trop.tropical_matvec_argmax_padded(WEp, tT), dev)
    log(f"timing on {card} (per launch, CUDA events over {LAUNCH_LOOP} "
        f"launches; median of 6, in turns plain/kernel/kernel/plain):")
    log(f"  maxplus B={B} C={C} (a real frame): kernel {mk:.6f} ms, plain "
        f"{mpl:.6f} ms; samples " + " ".join(f"{x:.6f}" for x in ks)
        + " | " + " ".join(f"{x:.6f}" for x in ps))
    log(f"  tropical padded {tuple(WEp.shape)} x {tuple(tT.shape)}: kernel "
        f"{tk:.6f} ms, plain {tpl:.6f} ms; samples "
        + " ".join(f"{x:.6f}" for x in tks) + " | "
        + " ".join(f"{x:.6f}" for x in tps))

    def one_batch():
        dec.decode_batch(net, comp, batch, LM_SCALE, WORD_PEN, device=dev)

    def one_batch_plain():
        with plain_maxplus():
            one_batch()

    bk, bp, bks, bps = in_turns(time_call, one_batch_plain, one_batch, dev)
    log(f"  LV batch (decode_batch, B={B}, T={T}): kernel leg {bk:.3f} ms "
        f"({bk / T * 1e3:.1f} us per frame), plain leg {bp:.3f} ms; samples "
        + " ".join(f"{x:.3f}" for x in bks) + " | "
        + " ".join(f"{x:.3f}" for x in bps))
    walls = time_call(lambda: lv_decode_all(net, comp, feats, dev), dev,
                      reps=6)
    w = statistics.median(walls)
    audio = sum(f.shape[0] for f in feats) * FRAME_S
    log(f"  LV decode_batch of {len(feats)} utterances ({audio:.2f} s of "
        f"audio): {w:.3f} ms, xRT {w / 1e3 / audio:.6f} (OutP + scan + "
        f"traceback; median of 6: " + " ".join(f"{x:.3f}" for x in walls)
        + ")")
    wall, ops, n_ops = device_profile(one_batch, dev)
    busy = sum(ms for _k, ms in ops)
    mx = sum(ms for k, ms in ops if "maxplus" in k)
    log(f"profile on {card} of one LV batch: wall {wall:.1f} ms (the "
        f"profiler slows the host; unprofiled {bk:.1f} ms), device busy "
        f"{busy:.1f} ms ({100 * busy / wall:.1f}% of the profiled wall, "
        f"{100 * busy / bk:.1f}% of the unprofiled), {n_ops} device "
        f"operations ({n_ops / T:.1f} per frame), maxplus kernel "
        f"{mx:.2f} ms ({100 * mx / max(busy, 1e-9):.1f}% of busy); top: "
        + ", ".join(f"{k[:48]} {ms:.2f} ms" for k, ms in ops[:8]))
    return mk, mpl, tk, tpl


def main() -> int:
    os.environ[DEVICE_ENV] = "cuda"
    card = phase_device()
    dev = torch.device("cuda")
    err = phase_random_nets(dev)
    fb_err = phase_random_fb(dev)
    mp_err = phase_random_maxplus(dev)
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        sysm = write_system(root, n_utts=N_UTTS, seed=0, **SYSTEM)
        log(f"config-4 system written in {time.perf_counter() - t0:.2f} s: "
            f"{N_UTTS} utterances, frames {sysm.n_frames}")
        launches, hyps = phase_main_path(sysm, root, dev)
        e2, net, comp, feats = phase_real_bucket(sysm, hyps, dev)
        fb_launches, mmf, _lps, _walls = phase_herest(sysm, root, card, dev)
        fb_err2, fb_ops, trainer, utts = phase_real_fb_batch(sysm, dev)
        phase_main_path(sysm, root, dev, mmf=mmf,
                        what="HVite with the re-estimated MMF")
        kms, pms = phase_timing(net, comp, feats, card, dev)
        fkms, fpms = phase_fb_timing(fb_ops, trainer, utts, card, dev)
        phase_profile(sysm, fb_ops, root, card, dev)
        lvnet = lv_network(sysm, comp)
        mp_launches = phase_lv_main(sysm, hyps, lvnet, comp, feats, dev)
        batch, lens, lv_args = lv_batch_args(lvnet, comp, feats, dev)
        mp_err2, WEs = phase_lv_real_batch(lvnet, comp, batch, lens, lv_args,
                                           dev)
        tr_launches, tr_err, tr_ops = phase_tropical_path(lvnet, WEs, dev)
        mkms, mpms, tkms, tpms = phase_lv_timing(
            lvnet, comp, feats, batch, lv_args, WEs, tr_ops, card, dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    dbound = decode_bound(TIMING_B, TIMING_T, net.n_states, net.n_nodes,
                          net.band.shape[0])
    fbound = fb_bound(fb_ops[0], fb_ops[1], fb_ops[4])
    mbound = maxplus_bound("maxplus", *WEs[:, 0].shape)
    tbound = maxplus_bound("tropical", *tr_ops[0].shape)
    log(card)
    print(json.dumps({"kernels": [{
        "name": "decode_scan",
        "route": "cuda",
        "source": "htk_tpu_torch/csrc/decode_scan.cu",
        "replaces": "htk_tpu/ops/decode_pallas.py:137",
        "launches": launches,
        "max_abs_err": max(err, e2),
        "ms": kms,
        "plain_ms": pms,
        "bound_ms": dbound[0],
        "bound_by": dbound[1],
        "library_ms": None,
    }, {
        "name": "fb_scans",
        "route": "cuda",
        "source": "htk_tpu_torch/csrc/fb_scans.cu",
        "replaces": "htk_tpu/ops/fb_pallas.py:127",
        "launches": fb_launches,
        "max_abs_err": max(fb_err, fb_err2),
        "ms": fkms,
        "plain_ms": fpms,
        "bound_ms": fbound[0],
        "bound_by": fbound[1],
        "library_ms": None,
    }, {
        "name": "maxplus",
        "route": "cuda",
        "source": "htk_tpu_torch/csrc/maxplus.cu",
        "replaces": "htk_tpu/ops/maxplus_pallas.py:67",
        "launches": mp_launches,
        "max_abs_err": max(mp_err, mp_err2),
        "ms": mkms,
        "plain_ms": mpms,
        "bound_ms": mbound[0],
        "bound_by": mbound[1],
        "library_ms": None,
    }, {
        "name": "tropical",
        "route": "cuda",
        "source": "htk_tpu_torch/csrc/maxplus.cu",
        "replaces": "htk_tpu/ops/tropical_pallas.py:46",
        "launches": tr_launches,
        "max_abs_err": max(mp_err, tr_err),
        "ms": tkms,
        "plain_ms": tpms,
        "bound_ms": tbound[0],
        "bound_by": tbound[1],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
