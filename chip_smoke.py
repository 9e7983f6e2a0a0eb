"""Smoke run of the PyTorch port on one NVIDIA GPU: HCopy's frontend,
HVite -w recognition and -z lattices, HERest Baum-Welch training, the
demo chain through HResults, and the uniform-row LV decoder, dense and
factored.

Drives htk_tpu_torch's main paths, `htk_tpu_torch.tools.hcopy.run`,
`htk_tpu_torch.tools.hvite.run`, `htk_tpu_torch.tools.herest.run`,
`recipes.demo.run_chain` and `algo.decode.decode_batch` on
`compile_lv_loop` networks, on a synthetic system at htk_tpu's BASELINE
config #4 widths (1,000-word back-off bigram, as a word network and as
ARPA tables; 40 phones, word-internal triphones over 2,000 tied 8-mixture
states, 39-dim MFCC_E_D_A; random weights from a numpy seed; 16
utterances of about 500 frames, with their phone-level transcriptions),
and on the same shape of system at 20,000 words (htk_tpu's bench.py
big-vocabulary row, factored cross-word legs) and at 5,000 words with a
trigram LM (its `triguide_5k` row). Phases, each raising on failure:

  1. device: a CUDA card is required; its name and power limit are
     printed; the four kernels (htk_tpu_torch/csrc/decode_scan.cu,
     fb_scans.cu, maxplus.cu and xw_gather.cu) are built from source with
     nvcc, in parallel
  2. the decode kernel against its plain torch version on random nets
     (several seeds, B > 1, a tie-heavy integer-score case), each at the
     full grid and at forced grids of 1, 2, 3 and 7 blocks
  3. the FB scans kernel against its plain version on random composites
     (two seeds, B = 4; banded at Q = 50, 250 and 1,100 and dense at
     Q = 250 and 1,100, whose live-cell lists do not fit shared memory;
     rows with t_real < T and t_real = 0; no beam (the two scans in
     separate blocks), a loose beam, one that kills some rows and one
     that kills all); xi exactly 0 on every dead cell
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
     T=512 (with the grid size, the decode kernel's device time under
     torch.profiler, and a one-node net at the full grid: the kernel's
     floor a frame); one HVite run under torch.profiler (device busy
     share, decode kernel time); the FB scans on the real bucket (B=8,
     T=512, Q=192), HERest iterations in utterances and audio seconds per
     second; under torch.profiler, the device time of each of the FB
     launch's parts (lists, scans, xi), the live cells per utterance, a
     one-state composite's scan time a step (the kernel's floor) and the
     device's busy share of a HERest iteration
  8. the maxplus kernel (both floor contracts, the source range forced
     into 1, 2, 3 and 7 chunks and the grid's own) and the tropical
     wrappers against the plain version on random operands (two seeds, B
     in {1, 8, 17}, C in {1, 200, 1000, 2050}; normal, tie-heavy integer
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
     of the 16 utterances as xRT; under torch.profiler, maxplus's device
     time a launch, one LV batch's device busy share, the maxplus
     kernel's share and the top device operations
 11. the segmax and gather-add kernels (csrc/xw_gather.cu) against their
     plain versions on random operands (three seeds, B in {1, 8, 17},
     segments of 0, 1, 4-64 and 500-700 slots, tie-heavy integer scores,
     dead rows, -inf cells), segmax at every forced lane count (1-32 and
     the schedule's own) with WE copied into shared memory, read from L2
     and as the launch chooses: exactly equal
 12. the 20k factored LV decoder: `lv_system(20000)` and
     `compile_lv_loop` (over 8,000 rows, so factored: no dense matrix);
     `decode_batch` of 16 utterances in 2 batches of 8 at LM scale 12,
     word penalty 0 (bench.py's settings) on three legs: exact (one
     segmax launch per padded frame per batch), adaptive-exact top-A
     (-128: the same launches, each gated on the device by the frame's
     certificate, and scores, words and times == exact's)
     and top-A 128 (no segmax launch); for one batch the kernel leg and
     the plain leg on the same real outp (planes as for decode, and the
     same 1-best); word accuracy (informational) and peak device memory
 13. on that batch's real word ends: `xw_route.routed_explicit_leg` over
     the net's slot stream (kernel == plain, and == the bucket leg on
     every target with a predecessor), `xw_window.window_gather` over the
     same slots in the window layout; `bucket_max` at gather_probe.py's
     shape (C = 22,000, 640,000 slots of 16) and `lane_gather` at
     dyngather_probe.py's (W = 2,048, 4,096 x 128), each kernel == plain
     exactly, lane_gather also == `torch.index_select`
 14. trigram guidance at 5k: `lv_system(5000, lm_order=3)`,
     `compile_lv_loop(trigram=True)`, one `decode_batch` of 8 at
     max_active=128; this leg launches no kernel (its scatters are torch
     ops), which the counts show
 15. times, in turns plain/kernel/kernel/plain: segmax, the routed leg,
     window_gather, bucket_max and lane_gather per launch and their
     device times under torch.profiler; on the real frame, segmax's
     device time at each forced lane count and staging choice (each ==
     plain), a launch skipped by its device flag, and the values-only
     yardstick `torch.segment_reduce` over the gathered candidates (or a
     line saying that it does not run on the card); lane_gather and
     index_select per call in 40 alternating rounds (with lane_gather's
     plain version; these go to the kernels line) and index_select's
     device time; one 20k
     LV batch with the exact kernel and plain legs, with the adaptive and
     top-A legs, and `decode_batch` of the 16 utterances as xRT for each
     leg; under torch.profiler, one 20k batch of each leg: its device
     busy share, segmax's device time, device operations per frame and
     top operations, with the adaptive batch's frames whose certificate
     fails (counted offline from the exact leg's word-end planes)
 17. (run after phase 11) HCopy at the batched frontend's full chunk:
     64 synthetic utterances of 3-8 s at 16 kHz (recipes/speech.py,
     seed 5) as MFCC_E_D_A, PLP_E_D_A and FBANK, with BATCHFRONTEND T and
     F in turns (T, F, F, T): exit 0, every file against the port's
     frontend on the CPU (max |diff| 1e-3, mean 2e-5; of the scale for
     PLP), audio seconds per second; under torch.profiler, one batched
     run's device busy share; the golden fixture (tests/golden) on the
     card at tests/test_golden_frontend.py's tolerances
 18. (run after phase 6) HVite -z on the config-4 system: one decode
     launch per bucket, a lattice for every utterance, rec.mlf
     byte-identical to phase 5's; every bucket's lattices walked again
     from the kernel's planes on the same outp equal the tool's files
     byte for byte, and for the first bucket equal those from the plain
     version's planes; the wall split into decode and lattice build
 19. (run after phase 15) the demo twin (recipes/demo.py, run_demo.sh's
     chain through HResults) in a temporary directory: 100% word
     accuracy, each tool's wall, the decode_scan and fb_scans launches
 20. one JSON line of kernels, then the device line last

Each main path runs with every launch count set to 0 just before it and
read just after. Tolerances, kernel against plain: maxplus, tropical,
segmax and gather-add exactly equal; decode (at every grid) and the LV
planes: live scores within 1e-5 and every word-link record exactly
equal; FB logP within 1e-5 relative, alphas and betas at t < t_real with
the same live sets (above LZERO/2) and within 1e-5 |ref| + 1e-4, xi of
live utterances within rtol 1e-4, atol 1e-6; the accumulators of a batch within 1e-2 of each field's
largest magnitude (alphas of magnitude ~3e4 differ by float32 ulps of the
sums' order, which moves occupancies by ~1e-3).

`bound_ms` is the larger of the bytes each kernel must move (inputs read
once, outputs written once) over 3.35 TB/s and its operations over the
67 TFLOP/s of FP32 outside the tensor cores (H100 SXM data sheet; exp
and log counted as one operation each); for the FB scans only the live
(above LZERO/2) cells of logA count, since the others add exactly
nothing and the kernel leaves them out; for maxplus and tropical, trans
and WE in, values and arguments out, an add and a compare per (b, i, j)
(on the decoder's path trans stays in L2 from frame to frame, so L2's
rate, not the HBM rate the bound uses, is the floor there); for segmax
(and the routed leg and bucket_max on it) the slot stream (pred and
score), WE and the segment tables in, values and arguments out, an add
and a compare per (b, slot); for gather-add (window_gather,
lane_gather) the slot tables and WE in (only the first table row for
lane_gather), the candidates out, an add per (b, slot). No single
PyTorch call computes max-plus with argmax or a segmented max with its
argmax, or a gather and an add, so `library_ms` is null for all but
lane_gather, whose function is one `torch.index_select` of the first
table row. `torch.segment_reduce` computes segmax's values but not its
first-slot argument, so phase 15 times it beside segmax as a yardstick
only.

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
from typing import Optional

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
from htk_tpu_torch.io import parmkind as pk
from htk_tpu_torch.io.htkfeat import read_htk_file
from htk_tpu_torch.io.lm import read_arpa
from htk_tpu_torch.io.mlf import MLF
from htk_tpu_torch.io.mmf import load_mmf
from htk_tpu_torch.io.slf import read_slf, write_slf
from htk_tpu_torch.models.hmmset import compile_hmmset
from htk_tpu_torch.ops import decode_scan as ds
from htk_tpu_torch.ops import fb_scans as fbs
from htk_tpu_torch.ops import maxplus as mp
from htk_tpu_torch.ops import tropical as trop
from htk_tpu_torch.ops import xw_gather as xg
from htk_tpu_torch.ops import xw_route, xw_window
from htk_tpu_torch.ops.dsp import (FrontendConfig, compute_features,
                                   compute_features_batch)
from htk_tpu_torch.recipes import demo
from htk_tpu_torch.recipes.speech import utterance_set, write_wav
from htk_tpu_torch.synth import (lv_system, random_decode_net,
                                 random_fb_operands, random_maxplus_operands,
                                 random_xw_operands, word_accuracy,
                                 write_system)
from htk_tpu_torch.tools import hcopy, herest, hvite
from htk_tpu_torch.tools._common import DEVICE_ENV
from htk_tpu_torch.utils.logmath import LZERO

ATOL = 1e-5
DECODEBATCH = 8
N_UTTS = 16
# BASELINE config #4 widths (htk_tpu's bench.py build_tied_triphone_system)
SYSTEM = dict(n_words=1000, n_phones=40, n_tied=2000, n_mix=8, dim=39)
RANDOM_NET = dict(Ns=3000, Nn=200, K=3, B=4, T=48)
FORCED_GRIDS = (1, 2, 3, 7, None)  # decode_scan blocks; None: the full grid
TIMING_B, TIMING_T = 8, 512
LM_SCALE, WORD_PEN = 8.0, -10.0
FRAME_S = 0.01
KERNELS = (ds.KERNEL, fbs.KERNEL, mp.KERNEL, xg.KERNEL)
# tropical launches the maxplus kernel; xw_gather counts its two entries
COUNTS = KERNELS + (trop.LAUNCHES, xg.SEGMAX, xg.GATHER_ADD)
MAXPLUS_BS, MAXPLUS_CS = (1, 8, 17), (1, 200, 1000, 2050)
MAXPLUS_CHUNKS = (1, 2, 3, 7, None)  # forced source chunks; None: the grid's
MAXPLUS_MODES = {"normal": {}, "ties": {"ties": True},
                 "dead row": {"dead_rows": 1}}
TOPA = 128  # the dense top-A leg's max_active (htk_tpu's bench.py 5k row)
LAUNCH_LOOP = 100  # back-to-back launches per timed sample of one kernel
PROFILE_TRIES = 6  # torch.profiler sessions before a profile fails
PLAIN_LOOP = 10  # calls per timed sample of a slow plain version
LIBRARY_ROUNDS = 40  # alternating samples of lane_gather and index_select
PAD_T = 128  # decode_batch pads T to a multiple of this
HEREST_BATCH = 8
RANDOM_FB = dict(B=4, T=40, t_real=[40, 33, 20, 0])
# (Q, layout): banded composites and dense ones (every cell among the live
# states live); the dense and Q = 1,100 cases' lists do not fit shared
# memory, so the kernel reads them from global memory
FB_CASES = ((50, "banded"), (250, "banded"), (1100, "banded"),
            (250, "dense"), (1100, "dense"))
FB_BEAMS = (None, 10.0, 5.0, 2.0)  # 5 kills some rows, 2 all of them
ACC_TOL = 1e-2
HBM_BPS, FP32_OPS = 3.35e12, 67e12  # H100 SXM data sheet
# the factored LV systems (htk_tpu's bench.py bench_bigvocab and
# triguide_5k rows: their seeds, LM scales and word penalties)
BIG = dict(n_words=20000, seed=11)
BIG_LM_SCALE, BIG_WORD_PEN = 12.0, 0.0
TRI = dict(n_words=5000, lm_order=3, seed=7)
ADAPTIVE = -TOPA  # adaptive-exact top-A
XW_CASE = dict(C=2000, n_slots=80000)  # random segmax / gather-add operands
XW_INF_EVERY = 37  # -inf in every 37th column of the random WE
SEGMAX_LANES = (1, 2, 4, 8, 16, 32, None)  # forced lanes; None: by width
SEGMAX_STAGED = (True, False, None)  # WE copied, read from L2, or chosen
PROBE = dict(C=22000, NNZ=640000, FB=16)  # benchmarks/gather_probe.py
LANE = dict(W=2048, n=4096, L=128)  # benchmarks/dyngather_probe.py
# HCopy at the batched frontend's full chunk (ops/dsp.BATCH_WIDTH files)
HCOPY_SET = dict(n=64, min_s=3.0, max_s=8.0, seed=5)
HCOPY_KINDS = ("MFCC_E_D_A", "PLP_E_D_A", "FBANK")
FE_MAX, FE_MEAN = 1e-3, 2e-5  # card vs CPU frontend, max and mean |diff|
FE_REL_MAX, FE_REL_MEAN = 5e-5, 2e-6  # the same over PLP's largest value
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "mfcc_golden.npz")
# (kind, channels, max, mean): tests/test_golden_frontend.py's tolerances
GOLDEN_TOL = (("MFCC_E_D_A_Z", 20, 2.0e-3, 3.0e-4),
              ("MFCC_0", 20, 2.0e-3, 5.0e-4), ("FBANK", 24, 3.0e-4, 1.0e-4),
              ("PLP", 20, 2.0e-3, 2.0e-4))
LATTICE_BEAM = 200.0  # HREC: LATTICEBEAM's default


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


def full_grid() -> int:
    """The decode kernel's full grid on the current card."""
    return ds.full_grid(torch.cuda.current_device())


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


@contextlib.contextmanager
def plain_xw():
    """segmax, gather_add and lane_gather (and so the factored exact leg
    and every xw wrapper) run their plain versions inside."""
    saved = xg.segmax, xg.gather_add, xg.lane_gather
    xg.segmax, xg.gather_add, xg.lane_gather = (
        xg.segmax_plain, xg.gather_add_plain, xg.lane_gather_plain)
    try:
        yield
    finally:
        xg.segmax, xg.gather_add, xg.lane_gather = saved


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
    """Each random net at the full grid and at forced small grids, whose
    range edges and halos fall inside the band."""
    err = 0.0
    cases = [(seed, False) for seed in range(3)] + [(10, True), (11, True)]
    for seed, ties in cases:
        args = random_net(seed, dev, ties, **RANDOM_NET)
        p = ds.decode_scan_plain(*args)
        for G in FORCED_GRIDS:
            k = ds.decode_scan_cuda(*args, grid=G)
            torch.cuda.synchronize(dev)
            err = max(err, compare(k, p, f"random net seed={seed} "
                                         f"ties={ties} grid={G}"))
        live = int((p[1][1] >= 0).sum())
        log(f"random net seed={seed} ties={ties}: equal at grids "
            f"{[G or full_grid() for G in FORCED_GRIDS]} "
            f"(max |dv| {err:.3g}, {live} live word-end records)")
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


def phase_hvite_profile(sysm, root, card, dev):
    """One HVite run under torch.profiler: the device's busy share and the
    decode kernel's part of it."""
    argv = ["-C", os.path.join(root, "hvite.cfg"), "-w", sysm.wdnet, "-H",
            sysm.hmmdefs, "-i", os.path.join(root, "rec_profiled.mlf"),
            "-s", str(LM_SCALE), "-p", str(WORD_PEN), "-S", sysm.scp,
            sysm.dict, sysm.hmmlist]
    p = device_profile(lambda: hvite.run(argv), dev, "decode_scan_kernel",
                       -(-len(sysm.feats) // DECODEBATCH))
    busy = p.ms()
    log(f"profile on {card} of one HVite run: wall {p.wall:.1f} ms, device "
        f"busy {busy:.1f} ms ({100 * busy / p.wall:.1f}%), decode kernel "
        f"{p.ms('decode_scan_kernel'):.2f} ms in "
        f"{p.count('decode_scan_kernel')} launches; top: {p.top(5)}")


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


def fb_operands(seed, Q, layout, dev):
    """random_fb_operands on the card; `dense` makes every cell among the
    live states live (an ergodic composite)."""
    ops = random_fb_operands(seed, Q=Q, **RANDOM_FB)
    if layout == "dense":
        live = Q - 4  # random_fb_operands' padded states
        rng = np.random.default_rng(seed + 100)
        ops[1][:, :live, :live] = np.log(rng.uniform(
            0.05, 1.0, (ops[1].shape[0], live, live))).astype(np.float32)
    return [torch.as_tensor(a, device=dev) for a in ops]


def phase_random_fb(dev) -> float:
    err = 0.0
    for Q, layout in FB_CASES:
        for seed in range(2):
            args = fb_operands(seed, Q, layout, dev)
            for beam in FB_BEAMS:
                what = f"random FB Q={Q} {layout} seed={seed} beam={beam}"
                k = fbs.fb_scans_cuda(*args, beam=beam)
                p = fbs.fb_scans_plain(*args, beam=beam)
                torch.cuda.synchronize(dev)
                e = compare_scans(k, p, args[4], what)
                if not bool((k[3][args[1] <= LZERO / 2] == 0).all()):
                    raise AssertionError(f"{what}: xi not 0 on a dead cell")
                dead = int((p[2] <= LZERO / 2).sum())
                nnz = int((args[1] > LZERO / 2).sum(dim=(1, 2)).max())
                in_smem = fbs.lists_in_smem(args[1], beam is not None)
                log(f"{what} ({nnz} live cells, lists in "
                    f"{'shared' if in_smem else 'global'} memory): "
                    f"agree (max |d| {e:.3g}; {dead} of {len(p[2])} rows "
                    f"without a path)")
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


def _holds(key: str, name) -> bool:
    return any(n in key for n in ((name,) if isinstance(name, str)
                                  else name))


class Profile:
    """One torch.profiler session: `wall` ms of the synchronised call and
    `ops`, each device operation's (name, device ms, count), largest
    first."""

    def __init__(self, wall, ops):
        self.wall, self.ops = wall, ops

    @property
    def n(self) -> int:
        """Device operations recorded."""
        return sum(c for _k, _ms, c in self.ops)

    def ms(self, name="") -> float:
        """Device ms of the operations whose name holds `name` (or one of
        a tuple of names)."""
        return sum(ms for k, ms, _c in self.ops if _holds(k, name))

    def count(self, name="") -> int:
        return sum(c for k, _ms, c in self.ops if _holds(k, name))

    def per_launch(self, name) -> float:
        """Device ms a recorded launch of the operations named `name`."""
        return self.ms(name) / self.count(name)

    def top(self, n: int, width: int = 40, fmt: str = ".2f") -> str:
        return ", ".join(f"{k[:width]} {ms:{fmt}} ms"
                         for k, ms, _c in self.ops[:n])


def device_profile(fn, dev, expect, launches: Optional[int] = None
                   ) -> Profile:
    """One synchronised fn() under torch.profiler, where fn launches a
    device operation whose name holds `expect` (`""`: any; or one of a
    tuple of names), `launches` times where that is known.

    The card's torch.profiler at times returns a session that lacks some
    or all of its device records, for our kernels and torch's alike:
    PR 8's decode_scan session came back empty after the HCopy profile,
    one fb_scans session lacked its table kernel, and a loop of 100
    maxplus launches held 99 records in six sessions running. So a
    session without a record of `expect` is run again, up to
    PROFILE_TRIES sessions, and the profile fails if none holds one; a
    shortfall against `launches` is logged, and per-launch times divide
    by the launches recorded."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for k in range(PROFILE_TRIES):
        torch.cuda.synchronize(dev)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            wall = (time.perf_counter() - t0) * 1e3
        p = Profile(wall, sorted(
            ((e.key, e.self_device_time_total / 1e3, e.count)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda op: -op[1]))
        if p.count(expect) and p.ms(expect) > 0:
            if k or (launches is not None and p.count(expect) < launches):
                name = (expect if isinstance(expect, str)
                        else "/".join(expect)) or "any operation"
                log(f"  (torch.profiler recorded {p.count(expect)}"
                    + ("" if launches is None else f" of {launches}")
                    + f" launches of {name}"
                    + (f" after {k} empty sessions" if k else "") + ")")
            return p
    raise AssertionError(f"torch.profiler: no session of {PROFILE_TRIES} "
                         f"held a device record of '{expect}'")


def phase_profile(sysm, ops, root, card, dev):
    """Where the time goes: the two kernels of one fb_scans call, and the
    device's share of one HERest iteration's wall time."""
    fbs.fb_scans_cuda(*ops)
    p = device_profile(lambda: fbs.fb_scans_cuda(*ops), dev,
                       "fb_scan_kernel")
    live = (ops[1] > LZERO / 2).sum(dim=(1, 2)).tolist()
    log(f"profile on {card} of one fb_scans call ({p.wall:.3f} ms wall; "
        f"live cells per utterance {live} of {ops[1].shape[1] ** 2}): "
        + p.top(len(p.ops), fmt=".3f"))
    # a one-state composite (a self-loop) at the same B and T: the two
    # scans' steps with no work, the kernel's floor a step
    B, T, _Q = ops[0].shape
    one = [torch.zeros((B, T, 1), device=dev),
           torch.full((B, 1, 1), -0.5, device=dev),
           torch.zeros((B, 1), device=dev), torch.zeros((B, 1), device=dev),
           torch.full((B,), T, dtype=torch.int32, device=dev)]
    fms = statistics.median(time_call(lambda: fbs.fb_scans_cuda(*one), dev))
    scan1 = device_profile(lambda: fbs.fb_scans_cuda(*one), dev,
                           "fb_scan_kernel").per_launch("fb_scan_kernel")
    log(f"  a one-state composite (B={B}, T={T}): {fms:.3f} ms a call, "
        f"scan kernel {scan1:.3f} ms of device time "
        f"({scan1 / T * 1e3:.3f} us a step of each scan, both at once)")
    out = os.path.join(root, "hmm_profiled")
    argv = ["-H", sysm.hmmdefs, "-M", out, "-S", sysm.train_scp, "-I",
            sysm.train_mlf, sysm.hmmlist]
    p = device_profile(lambda: herest.run(argv), dev, "fb_scan_kernel")
    busy = p.ms()
    log(f"profile on {card} of one HERest iteration: wall {p.wall:.1f} ms, "
        f"device busy "
        f"{busy:.1f} ms ({100 * busy / p.wall:.1f}%), fb_scans' scan kernel "
        f"{p.ms('fb_scan_kernel'):.2f} ms in {p.count('fb_scan_kernel')} "
        f"launches; top kernels: {p.top(6)}")


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
    part = ds._plan(args[4], net.n_nodes, args[1].shape[0],
                    full_grid())["part"]
    log(f"timing on {card} (B={B}, T={T}, Nn={net.n_nodes}, "
        f"Ns={net.n_states}; median of 6 synchronised calls, taken in "
        f"turns plain/kernel/kernel/plain; grid {full_grid()} "
        f"blocks of {ds.THREADS} threads, at most {part.cols_max} columns "
        f"a block, columns in "
        f"{'shared' if part.trans_in_smem else 'global'} memory):")
    for name, ms, ts in (("kernel", kms, k), ("plain ", pms, p)):
        log(f"  decode_scan {name} {ms:.3f} ms per decode step "
            f"({ms / T * 1e3:.2f} us per frame), decode xRT "
            f"{ms / 1e3 / audio_s:.4e}; samples "
            + " ".join(f"{x:.3f}" for x in ts))
    dms = device_profile(lambda: ds.decode_scan_cuda(*args), dev,
                         "decode_scan_kernel").per_launch("decode_scan_kernel")
    # a one-node net at the full grid: the frames' barriers and phases
    # with (almost) no work, the kernel's floor a frame
    one = random_net(0, dev, False, Ns=1, Nn=1, K=2, B=B, T=T)
    fms = statistics.median(time_call(lambda: ds.decode_scan_cuda(*one),
                                      dev))
    log(f"  decode_scan device time (torch.profiler) {dms:.3f} ms a step; "
        f"a one-node net at the full grid {fms:.3f} ms "
        f"({fms / T * 1e3:.2f} us a frame)")
    log(f"  OutP (GaussianScorer, {comp.n_mix} Gaussians) {oms:.3f} ms")
    return kms, pms


def check_equal(got, ref, what: str) -> float:
    """Kernel outputs exactly equal: (values, arguments) of maxplus and
    segmax, or one tensor (gather-add); returns the max |diff| of the
    finite values (0.0)."""
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    for k, (g, r) in enumerate(zip(got, ref)):
        if not torch.equal(g, r):
            n = int((g != r).sum())
            raise AssertionError(f"{what}: {('values', 'args')[k]} differ "
                                 f"at {n} places")
    fin = torch.isfinite(ref[0])
    return float((got[0][fin] - ref[0][fin]).abs().max()) if bool(
        fin.any()) else 0.0


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
                        ref = mp.maxplus_plain(WE, tr, floor)
                        for ch in MAXPLUS_CHUNKS:
                            err = max(err, check_equal(
                                mp.maxplus_cuda(WE, tr, floor, chunks=ch),
                                ref, f"{what} floor={floor} chunks={ch}"))
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
    log(f"maxplus (floor off and on; source chunks forced to "
        f"{MAXPLUS_CHUNKS[:-1]} and the grid's, {mp.grid_chunks(8, 1000)} "
        f"at B=8, C=1000) and tropical (padded, and unfloored) == plain "
        f"exactly on {n} random operand sets")
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


def lv_decode_all(net, comp, feats, dev, max_active=None,
                  lm=(LM_SCALE, WORD_PEN)):
    out = []
    for idx in lv_batches(len(feats)):
        out += dec.decode_batch(net, comp, [feats[i] for i in idx], *lm,
                                max_active=max_active, device=dev)
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


def lv_batch_args(net, comp, feats, dev, lm=(LM_SCALE, WORD_PEN)):
    """The first batch's frames and its decode_scan_uniform_batch
    operands on real outp, as the decoder builds them (exact leg)."""
    idx = lv_batches(len(feats))[0]
    lens = [feats[i].shape[0] for i in idx]
    fb = np.zeros((len(idx), pad_T(lens), feats[0].shape[1]), np.float32)
    for b, i in enumerate(idx):
        fb[b, :lens[b]] = feats[i]
    d = dec._net_dev(net, dev)
    outp = _net_outp(net, comp, fb, "highest", dev)
    args = (outp, d["band"], d["a0"], d["aE"], net.uniform_width,
            d["bonus"], d["trans"] * lm[0], d["start"] * lm[0], lm[1],
            dec._BEAM_OFF, None, dec._scale_xw(d.get("xw"), lm[0]))
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


def in_turns(timer, plain, kernel, dev, plain_timer=None):
    """Medians of 6 (plain, kernel, kernel, plain; 3 samples each);
    `plain_timer` times the plain version where given."""
    pt = plain_timer or timer
    p = pt(plain, dev)
    k = timer(kernel, dev)
    k += timer(kernel, dev)
    p += pt(plain, dev)
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
    mdev = device_profile(
        lambda: [mp.maxplus_cuda(WE, trans, False)
                 for _ in range(LAUNCH_LOOP)], dev, "maxplus_kernel",
        LAUNCH_LOOP).per_launch("maxplus_kernel")
    log(f"  maxplus device time a launch (torch.profiler, {LAUNCH_LOOP} "
        f"calls, {mp.grid_chunks(B, C)} source chunks): "
        f"{mdev:.6f} ms, against {mk:.6f} ms a call")
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
    p = device_profile(one_batch, dev, "maxplus_kernel")
    busy, mx = p.ms(), p.ms("maxplus_kernel")
    log(f"profile on {card} of one LV batch: wall {p.wall:.1f} ms (the "
        f"profiler slows the host; unprofiled {bk:.1f} ms), device busy "
        f"{busy:.1f} ms ({100 * busy / p.wall:.1f}% of the profiled wall, "
        f"{100 * busy / bk:.1f}% of the unprofiled), {p.n} device "
        f"operations ({p.n / T:.1f} per frame), maxplus kernel "
        f"{mx:.2f} ms in {p.count('maxplus_kernel')} launches "
        f"({100 * mx / max(busy, 1e-9):.1f}% of busy); top: "
        f"{p.top(8, 48)}")
    return mk, mpl, tk, tpl


def phase_random_xw(dev) -> float:
    """segmax at every forced lane count and staging choice, and
    gather-add with and without lp, against their plain versions."""
    err, n, variants = 0.0, 0, 0
    for seed in range(3):
        for B in MAXPLUS_BS:
            for ties in (False, True):
                ops = [torch.as_tensor(a, device=dev) for a in
                       random_xw_operands(seed, B=B, ties=ties,
                                          dead_rows=min(B - 1, 2),
                                          **XW_CASE)]
                ops[0][:, ::XW_INF_EVERY] = -float("inf")
                what = f"xw seed={seed} B={B} ties={ties}"
                C = XW_CASE["C"]
                ref = xg.segmax_plain(*ops, C)
                for lanes in SEGMAX_LANES:
                    for staged in SEGMAX_STAGED:
                        err = max(err, check_equal(
                            xg.segmax_cuda(*ops, C, lanes=lanes,
                                           staged=staged), ref,
                            f"segmax {what} lanes={lanes} staged={staged}"))
                        variants += 1
                for lp in (ops[2], None):
                    err = max(err, check_equal(
                        xg.gather_add_cuda(ops[0], ops[1], lp),
                        xg.gather_add_plain(ops[0], ops[1], lp),
                        f"gather_add {what}"))
                n += 1
    torch.cuda.synchronize(dev)
    width = np.diff(random_xw_operands(0, **XW_CASE)[3])
    log(f"segmax ({variants} launches: lanes {SEGMAX_LANES}, staged "
        f"{SEGMAX_STAGED}) and gather_add (with and without lp) == plain "
        f"exactly on {n} random operand sets (C={XW_CASE['C']}, -inf in "
        f"every {XW_INF_EVERY}th column of WE, "
        f"{int(width.sum())} slots in the first: widths 0 x "
        f"{int((width == 0).sum())}, 1 x {int((width == 1).sum())}, "
        f">= 500 x {int((width >= 500).sum())})")
    return err


def big_system(dev):
    """The 20k system and its factored net, with their set-up times."""
    t0 = time.perf_counter()
    sysm = lv_system(**BIG)
    t1 = time.perf_counter()
    net = compile_lv_loop(sysm.words, sysm.vocab, sysm.comp, lm=sysm.lm)
    t2 = time.perf_counter()
    x = net.xw_backoff
    if x is None or net.trans.size:
        raise AssertionError("20k net: compile_lv_loop did not choose the "
                             "factored form")
    padded = sum(p.size for p, _ in x["buckets"])
    log(f"20k system (lv_system {t1 - t0:.2f} s, compile_lv_loop "
        f"{t2 - t1:.2f} s): {len(sysm.comp.names)} models, C={net.n_nodes} "
        f"rows, S={net.uniform_width}, Ns={net.n_states}, "
        f"K={net.band.shape[0]}, slots {len(x['slots'][0])} real / {padded} "
        f"padded in {len(x['buckets'])} buckets, o_max "
        f"{x['succ_j'].shape[1] if x['succ_j'] is not None else None}, "
        f"dense trans {tuple(net.trans.shape)}")
    return sysm, net


def phase_big_main(sysm, net, dev):
    """The factored main path: decode_batch of every utterance on the
    exact, adaptive and top-A legs, with the counts read per leg."""
    feats = sysm.feats
    want = sum(pad_T([feats[i].shape[0] for i in idx])
               for idx in lv_batches(len(feats)))
    lm = (BIG_LM_SCALE, BIG_WORD_PEN)
    out, launches = {}, {}
    torch.cuda.reset_peak_memory_stats(dev)
    for leg, ma in (("exact", None), ("adaptive", ADAPTIVE), ("topA", TOPA)):
        reset_counts()
        t0 = time.perf_counter()
        res = lv_decode_all(net, sysm.comp, feats, dev, max_active=ma, lm=lm)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        n = launches[leg] = xg.SEGMAX.launches
        acc = word_accuracy(sysm.truths, [r.words if r else [] for r in res])
        log(f"20k LV decode_batch, {leg} leg (max_active={ma}): "
            f"{len(feats)} utterances in {wall:.3f} s, segmax launches {n}, "
            f"word accuracy {acc:.2f}% (informational)")
        if any(r is None or not r.words for r in res):
            raise AssertionError(f"20k {leg}: an utterance has no "
                                 "transcript")
        if n != (0 if leg == "topA" else want):
            raise AssertionError(f"20k {leg}: segmax launched {n} times, "
                                 f"expected {0 if leg == 'topA' else want}")
        out[leg] = res
    for a, e in zip(out["adaptive"], out["exact"]):
        if (a.words, a.times, a.score) != (e.words, e.times, e.score):
            raise AssertionError(f"20k adaptive != exact: {a.score} "
                                 f"{e.score}")
    log(f"20k adaptive-exact scores, words and times == exact for all "
        f"{len(feats)} utterances; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return launches["exact"]


def phase_big_real_batch(net, comp, feats, dev):
    """Kernel leg and plain leg of the exact factored step on the same
    real outp: planes and 1-best."""
    lm = (BIG_LM_SCALE, BIG_WORD_PEN)
    batch, lens, args = lv_batch_args(net, comp, feats, dev, lm)
    k = dec.decode_scan_uniform_batch(*args)
    with plain_xw():
        p = dec.decode_scan_uniform_batch(*args)
    torch.cuda.synchronize(dev)
    B, T, Ns = args[0].shape
    err = compare(k, p, "20k LV batch")
    d = dec._net_dev(net, dev)
    best = [dec._traceback_device(*out[0], *out[1], d["aE"],
                                  d["end_exit"] * lm[0], lens,
                                  net.uniform_width) for out in (k, p)]
    if not (torch.equal(best[0][0], best[1][0])
            and torch.equal(best[0][1], best[1][1])):
        raise AssertionError("20k LV batch: kernel and plain 1-best differ")
    log(f"20k LV batch (B={B}, T={T}, Ns={Ns}): kernel leg == plain leg "
        f"(max |dv| {err:.3g}; records and 1-best equal); peak device "
        f"memory with its full (B, T, Ns) outp and both legs' planes "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    fails = certificate_failures(net, k[1][0], dev)
    del args, p
    return err, batch, k[1][0][:, T // 2].contiguous(), fails


def certificate_failures(net, WEs, dev) -> int:
    """Frames of one batch whose adaptive-exact certificate fails, so that
    segmax runs in full: algo/decode.py's `safe` (no word end outside the
    top A can beat the back-off floor), counted offline from the exact
    leg's word-end planes WEs (B, T, C), which are the adaptive leg's too
    (its results equal exact's); the step itself gains no operation."""
    x = dec._scale_xw(dec._net_dev(net, dev)["xw"], BIG_LM_SCALE)
    fails = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(WEs.shape[1]):
        WE = WEs[:, t]
        bo_best = torch.max(WE + x["bow"][None], dim=1).values
        _v, idxs = dec._top_a(WE, -ADAPTIVE)
        ex_m = (WE + x["marg"][None]).scatter(1, idxs, 2 * LZERO)
        fails += ~(ex_m.amax(dim=1) <= bo_best).all()
    return int(fails)


def phase_xw_paths(net, WE, dev):
    """routed_explicit_leg, window_gather, bucket_max and lane_gather:
    kernel (counted) against plain, on real word ends WE (B, C) where the
    function takes them. Returns per function its launches and operands
    for timing."""
    C = WE.shape[1]
    src, tgt, p = net.xw_backoff["slots"]
    s32 = np.float32(BIG_LM_SCALE)
    out = {}
    tabs = xw_route.device_tables(xw_route.build_route(src, tgt, p, C), dev)
    tabs["scores"] = tabs["scores"] * BIG_LM_SCALE
    wtabs = [torch.as_tensor(a, device=dev) for a in
             xw_window.window_tables(src, p.astype(np.float32) * s32)[:3]]
    rng = np.random.default_rng(0)  # gather_probe.py's operands
    CB = PROBE["NNZ"] // PROBE["FB"]
    bops = [torch.as_tensor(a, device=dev) for a in (
        rng.standard_normal(PROBE["C"]).astype(np.float32),
        rng.integers(0, PROBE["C"], (CB, PROBE["FB"]), dtype=np.int32),
        rng.standard_normal((CB, PROBE["FB"])).astype(np.float32))]
    lops = [torch.as_tensor(a, device=dev) for a in (  # dyngather_probe.py's
        rng.standard_normal((8, LANE["W"])).astype(np.float32),
        rng.integers(0, LANE["W"], (LANE["n"], LANE["L"]), dtype=np.int32))]
    calls = {
        "routed_explicit_leg": (xg.SEGMAX, lambda: xw_route.routed_explicit_leg(
            WE, tabs)),
        "window_gather": (xg.GATHER_ADD, lambda: xw_window.window_gather(
            WE, *wtabs)),
        "bucket_max": (xg.SEGMAX, lambda: xg.bucket_max(*bops)),
        "lane_gather": (xg.GATHER_ADD, lambda: xg.lane_gather(*lops)),
    }
    for name, (count, fn) in calls.items():
        reset_counts()
        got = fn()
        n = count.launches
        with plain_xw():
            ref = fn()
        torch.cuda.synchronize(dev)
        check_equal(got, ref, name)
        if n != 1:
            raise AssertionError(f"{name}: {n} launches, expected 1")
        out[name] = (n, fn, got)
    idx_sel = torch.index_select(lops[0][0], 0, lops[1].reshape(-1))
    check_equal(out["lane_gather"][2],
                idx_sel.reshape(LANE["n"], LANE["L"]),
                "lane_gather against index_select")
    # the routed leg equals the decoder's bucket leg where a target has a
    # predecessor (the buckets' pad slots only decide the others)
    bv, ba = dec._segmax_leg(WE, dec._scale_xw(dec._net_dev(net, dev)["xw"],
                                               BIG_LM_SCALE), C)
    rv, ra = out["routed_explicit_leg"][2]
    has = torch.as_tensor(np.bincount(tgt, minlength=C) > 0, device=dev)
    if not (torch.equal(rv[:, has], bv[:, has])
            and torch.equal(ra[:, has], ba[:, has])):
        raise AssertionError("routed leg != bucket leg on targets with a "
                             "predecessor")
    log(f"routed_explicit_leg ({len(src)} slots, {int(has.sum())} of {C} "
        f"targets with a predecessor), window_gather "
        f"({wtabs[0].numel()} tiles), bucket_max ({CB} x {PROBE['FB']}, "
        f"C={PROBE['C']}) and lane_gather (W={LANE['W']}, "
        f"{LANE['n']} x {LANE['L']}): one launch each, kernel == plain "
        f"exactly; routed == bucket leg on targets with a predecessor; "
        f"lane_gather == index_select")
    return out, tabs, wtabs, bops, lops


def phase_trigram(dev):
    """Trigram guidance at 5k (bench.py's triguide_5k row): one batch."""
    t0 = time.perf_counter()
    sysm = lv_system(n_utts=DECODEBATCH, **TRI)
    t1 = time.perf_counter()
    net = compile_lv_loop(sysm.words, sysm.vocab, sysm.comp, lm=sysm.lm,
                          trigram=True)
    t2 = time.perf_counter()
    x3 = net.xw_trigram
    if x3 is None:
        raise AssertionError("5k trigram net has no guidance tables")
    reset_counts()
    t3 = time.perf_counter()
    res = dec.decode_batch(net, sysm.comp, sysm.feats, LM_SCALE, WORD_PEN,
                           max_active=TOPA, device=dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t3
    n = sum(k.launches for k in COUNTS)
    if n or any(r is None or not r.words for r in res):
        raise AssertionError(f"5k trigram: {n} kernel launches, or an "
                             "utterance without a transcript")
    acc = word_accuracy(sysm.truths, [r.words for r in res])
    log(f"5k trigram system (lv_system {t1 - t0:.2f} s, compile_lv_loop "
        f"{t2 - t1:.2f} s): C={net.n_nodes}, {len(x3['pair_u'])} contexts, "
        f"{len(x3['tri_j'])} trigram slots, o3max {x3['o3max']}; "
        f"decode_batch of {len(res)} at max_active={TOPA}: {wall:.3f} s, "
        f"no kernel launched (the guided leg is torch ops), word accuracy "
        f"{acc:.2f}% (informational); first words {res[0].words[:8]}")
    return wall


def xw_bounds(net, WE, tabs, wtabs, bops, lops):
    """Bounds of the four xw functions at this run's shapes."""
    B, C = WE.shape
    x = dec._net_dev(net, WE.device)["xw"]
    N, R = x["preds"].numel(), x["out_row"].numel()

    def seg(name, B, C, N, R):
        return bound(name, 4 * (2 * N + B * C + 2 * B * R + 2 * R + 1),
                     2 * B * N)

    Nw = wtabs[1].numel()
    CB, FB = bops[1].shape
    n_lane = lops[1].numel()
    return {
        "segmax": seg("segmax", B, C, N, R),
        "routed_explicit_leg": seg("routed_explicit_leg", B, C,
                                   tabs["preds"].numel(), C),
        "window_gather": bound("window_gather", 4 * (wtabs[0].numel()
                                                     + 2 * Nw + B * C
                                                     + B * Nw), B * Nw),
        "bucket_max": bound("bucket_max", 4 * (2 * CB * FB + bops[0].numel()
                                               + CB), 2 * CB * FB),
        "lane_gather": bound("lane_gather", 4 * (lops[0].shape[1]
                                                 + 2 * n_lane), 0),
    }


def phase_big_timing(sysm, net, batch, WE, paths, lops, fails, card, dev):
    """Per launch times of segmax and the four xw functions, segmax at
    each forced lane count and staging choice, a launch skipped by its
    flag and the values-only segment_reduce yardstick; LV batch times per
    leg, xRT per leg, and a profile of one batch of each leg, with the
    adaptive leg's frames whose certificate fails (`fails`)."""
    x = dec._scale_xw(dec._net_dev(net, dev)["xw"], BIG_LM_SCALE)
    C = WE.shape[1]
    times = {}
    fns = {"segmax": lambda: dec._segmax_leg(WE, x, C)}
    fns.update({k: v[1] for k, v in paths.items()})

    def plain(fn):
        def run():
            with plain_xw():
                fn()
        return run

    log(f"timing on {card} (per launch, CUDA events over {LAUNCH_LOOP} "
        f"launches, {PLAIN_LOOP} calls of a plain version; median of 6, in "
        f"turns plain/kernel/kernel/plain):")
    for name, fn in fns.items():
        # the plain versions take 0.04-11 ms a call: PLAIN_LOOP of them
        k, p, ks, ps = in_turns(time_launches, plain(fn), fn, dev,
                                lambda f, d: time_launches(f, d, PLAIN_LOOP))
        times[name] = [k, p, None]
        log(f"  {name}: kernel {k:.6f} ms, plain {p:.6f} ms; samples "
            + " ".join(f"{v:.6f}" for v in ks) + " | "
            + " ".join(f"{v:.6f}" for v in ps))
    for name, fn in fns.items():
        # the same calls under torch.profiler: the kernel's own device
        # time, apart from the wrapper's host work between launches
        ours = ("segmax_kernel", "gather_add_kernel")
        p = device_profile(lambda: [fn() for _ in range(LAUNCH_LOOP)], dev,
                           ours, LAUNCH_LOOP)
        log(f"  {name}: device time a call (torch.profiler, "
            f"{LAUNCH_LOOP} calls): kernel {p.per_launch(ours):.6f} ms, all "
            f"device operations {p.ms() / p.count(ours):.6f} ms")
    segmax_variants(WE, x, C, card, dev)
    row, flat = lops[0][0], lops[1].reshape(-1)

    def index_select():
        torch.index_select(row, 0, flat)

    lane = paths["lane_gather"][1]
    # index_select, lane_gather and lane_gather's plain version
    # alternating, one sample each a round in a rotating order, so that
    # drift in the host's speed touches all alike; these are lane_gather's
    # times in the kernels line
    runs = {"index_select": lambda: time_launches(index_select, dev, reps=1),
            "lane_gather": lambda: time_launches(lane, dev, reps=1),
            "plain": lambda: time_launches(plain(lane), dev, reps=1)}
    got = {k: [] for k in runs}
    for r in range(LIBRARY_ROUNDS):
        for k in list(runs)[r % 3:] + list(runs)[:r % 3]:
            got[k] += runs[k]()
    lis, lks = got["index_select"], got["lane_gather"]
    li, lk = statistics.median(lis), statistics.median(lks)
    times["lane_gather"] = [lk, statistics.median(got["plain"]), li]
    p = device_profile(lambda: [index_select() for _ in range(LAUNCH_LOOP)],
                       dev, "", LAUNCH_LOOP)
    log(f"  torch.index_select (lane_gather's function): {li:.6f} ms a "
        f"call, device time {p.ms() / LAUNCH_LOOP:.6f} "
        f"ms; lane_gather alternating with it {lk:.6f} ms, no slower in "
        f"{sum(k <= i for k, i in zip(lks, lis))} of {LIBRARY_ROUNDS} "
        f"rounds; samples " + " ".join(f"{v:.6f}" for v in lis)
        + " | " + " ".join(f"{v:.6f}" for v in lks))

    lm = (BIG_LM_SCALE, BIG_WORD_PEN)
    B, T = len(batch), pad_T([f.shape[0] for f in batch])

    def one_batch(ma=None):
        return lambda: dec.decode_batch(net, sysm.comp, batch, *lm,
                                        max_active=ma, device=dev)

    bk, bp, bks, bps = in_turns(time_call, plain(one_batch()), one_batch(),
                                dev)
    log(f"  20k LV batch (decode_batch, B={B}, T={T}): exact kernel leg "
        f"{bk:.3f} ms ({bk / T * 1e3:.1f} us per frame), exact plain leg "
        f"{bp:.3f} ms; samples " + " ".join(f"{v:.3f}" for v in bks)
        + " | " + " ".join(f"{v:.3f}" for v in bps))
    batch_ms = {"exact": bk}
    for leg, ma in (("adaptive", ADAPTIVE), ("topA", TOPA)):
        ts = time_call(one_batch(ma), dev)
        batch_ms[leg] = statistics.median(ts)
        log(f"  20k LV batch, {leg} leg (max_active={ma}): "
            f"{batch_ms[leg]:.3f} ms; samples "
            + " ".join(f"{v:.3f}" for v in ts))
    audio = sum(f.shape[0] for f in sysm.feats) * FRAME_S
    for leg, ma in (("exact", None), ("adaptive", ADAPTIVE), ("topA", TOPA)):
        walls = time_call(lambda: lv_decode_all(net, sysm.comp, sysm.feats,
                                                dev, ma, lm), dev)
        w = statistics.median(walls)
        log(f"  20k decode_batch of {len(sysm.feats)} utterances "
            f"({audio:.2f} s of audio), {leg} leg: {w:.3f} ms, xRT "
            f"{w / 1e3 / audio:.6f}; samples "
            + " ".join(f"{v:.3f}" for v in walls))
    log(f"  adaptive leg: {fails} of {T} frames of this batch fail the "
        f"certificate (counted offline from the exact leg's word-end "
        f"planes), so {T - fails} of its {T} segmax launches are skipped")
    # each leg's device busy share and segmax's device time (the adaptive
    # leg launches segmax every frame, gated on the device)
    for leg, ma in (("exact", None), ("adaptive", ADAPTIVE),
                    ("topA", TOPA)):
        # the top-A leg does not run segmax: any device record will do
        p = device_profile(one_batch(ma), dev,
                           "" if leg == "topA" else "segmax_kernel")
        busy, sm = p.ms(), p.ms("segmax_kernel")
        bms = batch_ms[leg]
        log(f"profile on {card} of one {leg} 20k LV batch: wall "
            f"{p.wall:.1f} ms (unprofiled {bms:.1f} ms), device busy "
            f"{busy:.1f} ms ({100 * busy / p.wall:.1f}% of the profiled "
            f"wall, {100 * busy / bms:.1f}% of the unprofiled), {p.n} "
            f"device operations ({p.n / T:.1f} per frame), segmax kernel "
            f"{sm:.2f} ms in {p.count('segmax_kernel')} launches "
            f"({100 * sm / max(busy, 1e-9):.1f}% of busy); top: "
            f"{p.top(8, 48)}")
    return times


def segmax_variants(WE, x, C, card, dev):
    """On the real frame WE: segmax at each forced lane count and staging
    choice (each == plain) and its device time; a launch skipped by its
    device flag; and `torch.segment_reduce` (max over the same gathered
    candidates, values only) as a yardstick, or a line saying that it does
    not run on the card. segment_reduce gives no argmax, so it is not
    segmax's function and segmax's `library_ms` stays null."""
    args = (WE, x["preds"], x["scores"], x["seg_off"], x["out_row"], C)
    ref = xg.segmax_plain(*args)

    def per_launch(fn):
        """Device ms a launch of segmax's kernel."""
        return device_profile(
            lambda: [fn() for _ in range(LAUNCH_LOOP)], dev,
            "segmax_kernel", LAUNCH_LOOP).per_launch("segmax_kernel")

    log(f"  segmax on {card} at each lane count and staging choice, the "
        f"real frame (device time a launch, torch.profiler, {LAUNCH_LOOP} "
        f"launches; each == plain):")
    for staged in (True, False):
        ms = {}
        for lanes in SEGMAX_LANES:
            def fn(lanes=lanes, staged=staged):
                return xg.segmax_cuda(*args, lanes=lanes, staged=staged)
            check_equal(fn(), ref, f"segmax lanes={lanes} staged={staged}")
            ms[lanes] = per_launch(fn)
        log(f"    {'WE in shared memory' if staged else 'WE from L2'}: "
            + ", ".join(f"{'by width' if g is None else f'{g} lanes'} "
                        f"{v:.6f} ms" for g, v in ms.items()))
    skip = torch.tensor(True, device=dev)

    def skipped():
        return dec._segmax_leg(WE, x, C, skip=skip)

    sk = statistics.median(time_launches(skipped, dev))
    log(f"  segmax skipped by its device flag: {sk:.6f} ms a call, device "
        f"time {per_launch(skipped):.6f} ms a launch")
    cand = (WE[:, x["preds"].long()] + x["scores"][None]).t().contiguous()
    width = torch.diff(x["seg_off"]).long()
    try:
        got = torch.segment_reduce(cand, "max", lengths=width, axis=0)
    except RuntimeError as e:
        log(f"  torch.segment_reduce (values only) does not run on the "
            f"card: {str(e).splitlines()[0]}")
        return
    has = width > 0
    want = ref[0][:, x["out_row"].long()].t()
    if not torch.equal(got[has], want[has]):
        raise AssertionError("segment_reduce values != segmax's")

    def seg_reduce():
        return torch.segment_reduce(cand, "max", lengths=width, axis=0)

    sr = statistics.median(time_launches(seg_reduce, dev))
    seg_ms = device_profile(
        lambda: [seg_reduce() for _ in range(LAUNCH_LOOP)], dev,
        "").ms() / LAUNCH_LOOP
    log(f"  torch.segment_reduce, max over the gathered candidates "
        f"{tuple(cand.shape)} (values only, == segmax's): {sr:.6f} ms a "
        f"call, device time {seg_ms:.6f} ms (all its device operations)")


def _feature_err(got, ref, scaled):
    """max and mean |diff| of two feature matrices, over the largest
    |ref| where the kind has a scale of its own (PLP's cepstra)."""
    if got.shape != ref.shape:
        raise AssertionError(f"feature shapes {got.shape} != {ref.shape}")
    s = float(np.abs(ref).max()) if scaled else 1.0
    d = np.abs(got.astype(np.float64) - ref) / s
    return float(d.max()), float(d.mean())


def phase_hcopy(root, card, dev):
    """HCopy at the batched frontend's full chunk: HCOPY_SET's 64
    utterances through the tool as each of HCOPY_KINDS, batched and per
    file, held against the port's frontend on the CPU; then the golden
    fixture on the card. Returns the summary line's numbers."""
    t0 = time.perf_counter()
    waves = utterance_set(**HCOPY_SET)
    d = os.path.join(root, "hcopy")
    os.makedirs(d)
    for k, x in enumerate(waves):
        write_wav(os.path.join(d, f"w{k}.wav"), x)
    audio_s = sum(len(x) for x in waves) / 16000.0
    log(f"HCopy set: {len(waves)} utterances, {audio_s:.1f} s of audio "
        f"({min(len(x) for x in waves) / 16000.0:.2f}-"
        f"{max(len(x) for x in waves) / 16000.0:.2f} s each), synthesised "
        f"in {time.perf_counter() - t0:.1f} s")
    worst = (0.0, 0.0)
    for kind in HCOPY_KINDS:
        fcfg = FrontendConfig(target_kind=pk.str2parmkind(kind))
        t0 = time.perf_counter()
        ref = compute_features_batch([(x, fcfg) for x in waves],
                                     device="cpu")
        cpu_s = time.perf_counter() - t0
        outs, walls, k_err = {}, {"T": [], "F": []}, (0.0, 0.0)
        for batched in ("T", "F", "F", "T"):  # in turns: the first warms up
            out = os.path.join(d, f"{kind}_{batched}")
            os.makedirs(out, exist_ok=True)
            cfg = os.path.join(out, "cfg")
            with open(cfg, "w") as f:
                f.write(f"SOURCEFORMAT = WAV\nTARGETKIND = {kind}\n"
                        f"HPARM: BATCHFRONTEND = {batched}\n")
            scp = os.path.join(out, "copy.scp")
            with open(scp, "w") as f:
                f.writelines(f"{d}/w{k}.wav {out}/w{k}.mfc\n"
                             for k in range(len(waves)))
            t0 = time.perf_counter()
            rc = hcopy.run(["-C", cfg, "-S", scp])
            torch.cuda.synchronize(dev)
            walls[batched].append(time.perf_counter() - t0)
            if rc != 0:
                raise RuntimeError(f"HCopy {kind} BATCHFRONTEND={batched} "
                                   f"returned {rc}")
            feats = [read_htk_file(f"{out}/w{k}.mfc").data
                     for k in range(len(waves))]
            scaled = kind.startswith("PLP")
            errs = [_feature_err(g, r, scaled) for g, r in zip(feats, ref)]
            e_max = max(e[0] for e in errs)
            e_mean = max(e[1] for e in errs)
            lim = (FE_REL_MAX, FE_REL_MEAN) if scaled else (FE_MAX, FE_MEAN)
            if e_max > lim[0] or e_mean > lim[1]:
                raise AssertionError(
                    f"HCopy {kind} BATCHFRONTEND={batched}: card vs CPU max "
                    f"{e_max:.3g} mean {e_mean:.3g} (limits {lim})")
            k_err = (max(k_err[0], e_max), max(k_err[1], e_mean))
            outs[batched] = feats
        worst = (max(worst[0], k_err[0]), max(worst[1], k_err[1]))
        for batched, ws in walls.items():
            log(f"HCopy {kind} BATCHFRONTEND={batched} on {card}: rc 0 in "
                + " and ".join(f"{w:.3f} s ({audio_s / w:.1f} s of audio "
                               f"per s)" for w in ws)
                + f", card vs CPU max |diff| {k_err[0]:.3g}, mean "
                f"{k_err[1]:.3g}{' of scale' if kind.startswith('PLP') else ''}"
                f" (CPU frontend {cpu_s:.2f} s)")
        bp = max(float(np.abs(a - b).max())
                 for a, b in zip(outs["T"], outs["F"]))
        log(f"HCopy {kind}: batched vs per-file on the card max |diff| "
            f"{bp:.3g}")
    cfg = os.path.join(d, f"{HCOPY_KINDS[0]}_T", "cfg")
    scp = os.path.join(d, f"{HCOPY_KINDS[0]}_T", "copy.scp")
    # torch.fft.rfft runs as cuFFT's own kernels: any device record will do
    p = device_profile(lambda: hcopy.run(["-C", cfg, "-S", scp]), dev, "")
    busy = p.ms()
    log(f"profile on {card} of one batched HCopy {HCOPY_KINDS[0]} run: wall "
        f"{p.wall:.1f} ms ({audio_s / p.wall * 1e3:.1f} s of audio per s), "
        f"device busy {busy:.1f} ms ({100 * busy / p.wall:.1f}%), {p.n} "
        f"device operations; top: {p.top(4)}")
    gold = np.load(GOLDEN)
    for kind, nch, tmax, tmean in GOLDEN_TOL:
        got = compute_features(
            gold["waveform"].astype(np.float32),
            FrontendConfig(target_kind=pk.str2parmkind(kind),
                           num_chans=nch), device=dev)
        dd = np.abs(got - gold["feat_" + kind])
        if not (dd.max() < tmax and dd.mean() < tmean):
            raise AssertionError(f"golden {kind} on the card: max "
                                 f"{dd.max():.3g} mean {dd.mean():.3g}")
        log(f"golden fixture {kind} on the card: max |diff| "
            f"{dd.max():.3g} (< {tmax}), mean {dd.mean():.3g} (< {tmean})")
    return worst


def _slf_text(lat, stem):
    lat.utterance = stem
    with tempfile.NamedTemporaryFile("r", suffix=".lat") as f:
        write_slf(lat, f.name)
        return f.read()


def phase_lattices(sysm, root, net, comp, feats, dev):
    """HVite -z on the config-4 system: one decode launch per bucket, a
    lattice for every utterance, rec.mlf byte-identical to the run
    without -z; for the first bucket, the lattices from the kernel's
    planes byte-identical to those from the plain version's on the same
    outp, and to the tool's files. Returns the decode launches."""
    latdir = os.path.join(root, "lats")
    mlf = os.path.join(root, "rec_z.mlf")
    argv = ["-C", os.path.join(root, "hvite.cfg"), "-w", sysm.wdnet, "-H",
            sysm.hmmdefs, "-i", mlf, "-s", str(LM_SCALE), "-p", str(WORD_PEN),
            "-z", "lat", "-l", latdir, "-S", sysm.scp, sysm.dict,
            sysm.hmmlist]
    os.makedirs(latdir)
    reset_counts()
    t0 = time.perf_counter()
    rc = hvite.run(argv)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = ds.KERNEL.launches
    if rc != 0:
        raise RuntimeError(f"HVite -z returned {rc}")
    n_buckets = -(-N_UTTS // DECODEBATCH)
    if launches != n_buckets:
        raise AssertionError(f"HVite -z: decode kernel launched {launches} "
                             f"times, expected {n_buckets}")
    lats = sorted(os.listdir(latdir))
    if len(lats) != N_UTTS:
        raise AssertionError(f"HVite -z wrote {len(lats)} lattices, "
                             f"expected {N_UTTS}")
    with open(mlf, "rb") as f, open(os.path.join(root, "rec.mlf"),
                                    "rb") as g:
        if f.read() != g.read():
            raise AssertionError("HVite -z: rec.mlf differs from the run "
                                 "without -z")
    order = sorted(range(len(feats)), key=lambda i: feats[i].shape[0])
    dec_s = lat_s = 0.0
    n_nodes = n_arcs = 0
    for i0 in range(0, len(order), DECODEBATCH):
        idx = order[i0:i0 + DECODEBATCH]
        lens = [feats[i].shape[0] for i in idx]
        T = -(-max(lens) // PAD_T) * PAD_T
        fb = np.zeros((len(idx), T, feats[0].shape[1]), np.float32)
        for b, i in enumerate(idx):
            fb[b, :lens[b]] = feats[i]
        t0 = time.perf_counter()
        args = decode_args(net, comp, fb, dev)
        k = ds.decode_scan_cuda(*args)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        lk = dec.lattices_from_planes(net, k[0], k[1], lens, LATTICE_BEAM,
                                      FRAME_S, LM_SCALE, WORD_PEN)
        t2 = time.perf_counter()
        dec_s += t1 - t0
        lat_s += t2 - t1
        stems = [os.path.splitext(os.path.basename(sysm.feats[i]))[0]
                 for i in idx]
        texts = [_slf_text(lt, st) for lt, st in zip(lk, stems)]
        n_nodes += sum(len(lt.nodes) for lt in lk)
        n_arcs += sum(len(lt.arcs) for lt in lk)
        for st, txt in zip(stems, texts):
            with open(os.path.join(latdir, f"{st}.lat")) as f:
                if f.read() != txt:
                    raise AssertionError(f"{st}: the tool's lattice differs "
                                         f"from the kernel planes' walk")
        if i0 == 0:
            p = ds.decode_scan_plain(*args)
            lp = dec.lattices_from_planes(net, p[0], p[1], lens,
                                          LATTICE_BEAM, FRAME_S, LM_SCALE,
                                          WORD_PEN)
            plain = [_slf_text(lt, st) for lt, st in zip(lp, stems)]
            if plain != texts:
                n = sum(a != b for a, b in zip(plain, texts))
                raise AssertionError(f"{n} lattices differ between the "
                                     f"kernel's planes and the plain "
                                     f"version's")
            log(f"HVite -z bucket (B={len(idx)}, T={T}): lattices from the "
                f"kernel's planes == the plain version's, byte for byte")
    log(f"HVite -z: rc 0 in {wall:.2f} s, decode kernel launches "
        f"{launches} (buckets {n_buckets}), {len(lats)} lattices "
        f"({n_nodes} nodes, {n_arcs} arcs), rec.mlf == without -z; the "
        f"same work outside the tool: decode (OutP + kernel) "
        f"{dec_s:.3f} s, lattice build (host) {lat_s:.3f} s")
    return launches


def phase_demo(card, dev):
    """The demo twin through HResults in a temporary directory: 100% word
    accuracy (run_chain raises otherwise), each tool's wall, and the
    decode_scan and fb_scans launches of the whole chain."""
    work = tempfile.mkdtemp(prefix="chip_demo_")
    try:
        reset_counts()
        t0 = time.perf_counter()
        walls = demo.run_chain(work, quiet=True)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    d_n, f_n = ds.KERNEL.launches, fbs.KERNEL.launches
    if d_n != 2 or f_n < 7:
        raise AssertionError(f"demo: decode_scan launched {d_n} times "
                             f"(expected 2 buckets), fb_scans {f_n} "
                             f"(expected at least one a HERest pass)")
    log(f"demo twin on {card}: {demo.PASS_LINE} in {wall:.2f} s; "
        f"decode_scan launches {d_n}, fb_scans launches {f_n}; "
        + ", ".join(f"{lab} {s:.3f} s" for lab, s in walls))
    return d_n, f_n


def kernel_entry(name, source, replaces, launches, err, times, bnd,
                 library_ms=None):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": times[0], "plain_ms": times[1], "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": library_ms}


def main() -> int:
    os.environ[DEVICE_ENV] = "cuda"
    t_all = time.perf_counter()
    marks = [t_all]

    def done(what):
        marks.append(time.perf_counter())
        log(f"[phase] {what}: {marks[-1] - marks[-2]:.1f} s")

    card = phase_device()
    dev = torch.device("cuda")
    err = phase_random_nets(dev)
    fb_err = phase_random_fb(dev)
    mp_err = phase_random_maxplus(dev)
    xw_err = phase_random_xw(dev)
    done("device, builds and random operands")
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        fe_err = phase_hcopy(root, card, dev)
        done("HCopy")
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
        z_launches = phase_lattices(sysm, root, net, comp, feats, dev)
        kms, pms = phase_timing(net, comp, feats, card, dev)
        phase_hvite_profile(sysm, root, card, dev)
        fkms, fpms = phase_fb_timing(fb_ops, trainer, utts, card, dev)
        phase_profile(sysm, fb_ops, root, card, dev)
        done("HVite and HERest")
        lvnet = lv_network(sysm, comp)
        mp_launches = phase_lv_main(sysm, hyps, lvnet, comp, feats, dev)
        batch, lens, lv_args = lv_batch_args(lvnet, comp, feats, dev)
        mp_err2, WEs = phase_lv_real_batch(lvnet, comp, batch, lens, lv_args,
                                           dev)
        tr_launches, tr_err, tr_ops = phase_tropical_path(lvnet, WEs, dev)
        mkms, mpms, tkms, tpms = phase_lv_timing(
            lvnet, comp, feats, batch, lv_args, WEs, tr_ops, card, dev)
        del lv_args
        done("1k LV decoder")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    big, bnet = big_system(dev)
    done("20k system set-up")
    sm_launches = phase_big_main(big, bnet, dev)
    sm_err, bbatch, bWE, fails = phase_big_real_batch(bnet, big.comp,
                                                      big.feats, dev)
    paths, rtabs, wtabs, bops, lops = phase_xw_paths(bnet, bWE, dev)
    done("20k factored LV decoder and xw paths")
    phase_trigram(dev)
    done("5k trigram guidance")
    xt = phase_big_timing(big, bnet, bbatch, bWE, paths, lops, fails, card,
                          dev)
    done("20k timing")
    demo_launches = phase_demo(card, dev)
    done("demo twin")
    dbound = decode_bound(TIMING_B, TIMING_T, net.n_states, net.n_nodes,
                          net.band.shape[0])
    fbound = fb_bound(fb_ops[0], fb_ops[1], fb_ops[4])
    mbound = maxplus_bound("maxplus", *WEs[:, 0].shape)
    tbound = maxplus_bound("tropical", *tr_ops[0].shape)
    xb = xw_bounds(bnet, bWE, rtabs, wtabs, bops, lops)
    log(f"new paths: HCopy card vs CPU max |diff| {fe_err[0]:.3g}, mean "
        f"{fe_err[1]:.3g}; HVite -z decode_scan launches {z_launches}; "
        f"demo decode_scan/fb_scans launches {demo_launches}")
    log(f"chip_smoke: {time.perf_counter() - t_all:.1f} s in all")
    log(card)
    xs = "htk_tpu_torch/csrc/xw_gather.cu"
    print(json.dumps({"kernels": [
        kernel_entry("decode_scan", "htk_tpu_torch/csrc/decode_scan.cu",
                     "htk_tpu/ops/decode_pallas.py:137", launches,
                     max(err, e2), (kms, pms), dbound),
        kernel_entry("fb_scans", "htk_tpu_torch/csrc/fb_scans.cu",
                     "htk_tpu/ops/fb_pallas.py:127", fb_launches,
                     max(fb_err, fb_err2), (fkms, fpms), fbound),
        kernel_entry("maxplus", "htk_tpu_torch/csrc/maxplus.cu",
                     "htk_tpu/ops/maxplus_pallas.py:67", mp_launches,
                     max(mp_err, mp_err2), (mkms, mpms), mbound),
        kernel_entry("tropical", "htk_tpu_torch/csrc/maxplus.cu",
                     "htk_tpu/ops/tropical_pallas.py:46", tr_launches,
                     max(mp_err, tr_err), (tkms, tpms), tbound),
        kernel_entry("segmax", xs, "htk_tpu/ops/xw_route.py:220",
                     sm_launches, max(xw_err, sm_err), xt["segmax"],
                     xb["segmax"]),
        kernel_entry("window_gather", xs, "htk_tpu/ops/xw_pallas.py:66",
                     paths["window_gather"][0], xw_err, xt["window_gather"],
                     xb["window_gather"]),
        kernel_entry("bucket_max", xs, "benchmarks/gather_probe.py:58",
                     paths["bucket_max"][0], xw_err, xt["bucket_max"],
                     xb["bucket_max"]),
        kernel_entry("lane_gather", xs, "benchmarks/dyngather_probe.py:22",
                     paths["lane_gather"][0], xw_err, xt["lane_gather"],
                     xb["lane_gather"], xt["lane_gather"][2]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
