"""Smoke run of the PyTorch port on one NVIDIA GPU: HCopy's frontend,
HVite -w recognition and -z lattices, HVite -a forced alignment, HERest,
HInit and HRest training, HMMIRest (MMI), the DNN hybrid (HNTrainSGD,
HNForward, HVite -N), HDecode with LV lattices, speaker adaptation
(HERest -K, HHEd RC, HVite and HDecode -J), the demo chain of
run_demo.sh and the full recipe of run_full.sh, every stage, and the
uniform-row LV decoder, dense and factored, with its lattices.

Drives htk_tpu_torch's main paths, `htk_tpu_torch.tools.hcopy.run`,
`htk_tpu_torch.tools.hvite.run` (-w, -z, -a), `tools.herest.run`,
`tools.hinit.run`, `tools.hrest.run`, `tools.hdecode.run`,
`tools.hmmirest.run`, `tools.hntrainsgd.run`, `tools.hnforward.run`,
`hvite.run` -N, `hhed.run` RC, `herest.run` -K, `hvite.run` and
`hdecode.run` -J, `recipes.demo.run_chain`, `recipes.full.run_chain`
and `algo.decode.decode_batch` and
`generate_lattice_batch` on `compile_lv_loop` networks, on a synthetic
system at htk_tpu's BASELINE config #4 widths (1,000-word back-off
bigram, as a word network and as ARPA tables; 40 phones, word-internal
triphones over 2,000 tied 8-mixture states, 39-dim MFCC_E_D_A; random
weights from a numpy seed; 16 utterances of about 500 frames, with their
phone-level transcriptions),
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
 19. (run after phase 15) the demo twin (recipes/demo.py, every stage of
     run_demo.sh) in a temporary directory: 100% word accuracy at HVite
     -z, after MMI (HMMIRest, then HVite) and at HDecode, the DNN
     hybrid's WORD line (HNTrainSGD -e 15, HVite -N), each tool's wall,
     the decode_scan and fb_scans launches (read around each HVite,
     HMMIRest and HDecode call too: HVite -N one an utterance); on the
     chain's files, fb_scans kernel == plain on HMMIRest's widest arc
     launch and decode_scan kernel == plain on HVite -N's ANN scores
 21. (run after phase 19, as 22-24 are: after every earlier profile)
     HVite -a -m on the config-4 system, a word MLF
     of its 16 synthesised transcriptions: on the card and, the same
     call, on the port's CPU path; labels, word tags and times identical
     (where a model boundary moved, the two runs' Viterbi paths must
     hold the same physical states and score: adjacent models sharing a
     tied state tie exactly), scores within 1e-4 relative; the wall and
     an -a -z run writing 16 numerator lattices; the alignment core of
     the 16 utterances under torch.profiler (device busy share,
     operations a frame)
 22. HInit, then HRest, on the triphone with the most segments in phase
     21's alignment (-l), from a flat proto: on the card and on the CPU
     path, the MMFs within tests/test_torch_herest.py's tolerances;
     HRest's fb_scans launches and the walls
 23. HDecode on the config-4 files (1,000 words:
     the LV loop; lm.arpa is a bigram: the dense exact leg) with -z, the
     16 utterances in one auto-sized batch: one maxplus launch a padded
     frame, rec.mlf identical to the port's CPU run, word accuracy
     (informational), lattices' nodes and arcs, records in beam, kept,
     8523 overflows and resurrection gathers, pass 1's device pipeline
     beside its host walk, peak device memory
 24. generate_lattice_batch(want_results=True) on
     the 20k factored net, the first batch of 8, exact and adaptive
     legs: one segmax launch a padded frame each, the 1-best equal to
     phase 12's exact decode_batch (words and times; scores within 1e-5
     relative), records in beam and overflow, device pipeline beside
     host walk, peak device memory
 25. (after 24) HMMIRest on the config-4 system at full width, the first
     8 utterances in one ACCBLOCK, denominator lattices from HVite -z at
     HREC: LATTICEBEAM = 150 (htk_tpu's bench_mmi), numerators the phone
     MLF: on the card and on the port's CPU path, the MMFs within the
     herest tolerances and the MMI criteria within 1e-4 relative; lattice
     arcs, arc mini-utterances, score and accumulate launches, the
     criterion, EBW seconds, pass walls, peak device memory; HVite -w
     with each MMI model (rec.mlf equal, word accuracy); on the same
     arcs fb_scans kernel == plain on the widest launch and on a
     4,096-wide launch of one real arc (4,095 rows at t_real = 0, the
     arc's logP == its narrow launch's), times in turns at the arc shape
     beside the bound, and each pass's device busy share
 26. the DNN hybrid on the config-4 system: HNTrainSGD (HIDDENSIZE = 1024
     1024 1024, CONTEXT = 4: input 351, output 1,992; -e 3) on the card
     and on the CPU path, ANN files within 1e-5 (tests/test_torch_nnet.py's
     TRAIN_ATOL, TF32 off), CE and frame accuracy per epoch, each
     epoch's wall, one more epoch's device busy share; HNForward of the
     16 files, .pos within 1e-4 of the CPU path's; HVite -N over the 16
     utterances, one decode_scan launch each, rec.mlf equal to the CPU
     run's on the same ANN file, -T 1 scores within 1e-4 relative;
     decode_scan kernel == plain on one utterance's ANN scores; the
     sequence criterion (CRITERION = MMI) on one utterance: the phone
     loop's Q (every emitting state of the set), fb_scans kernel ==
     plain at that Q, fb_scans launches and the objective before and
     after one iteration (two iterations run: the second's E step
     scores the first's update)
 27. speaker adaptation on the config-4 system at full width, the 16
     utterances as two speakers (-h 'utt0%*': 10 and 6): HERest -K CMLLR
     (HADAPT: BLOCKS = 3) on the card and on the CPU path, the TMFs'
     A and b within 1e-2 of scale (the posteriors come from alphas of
     magnitude ~3e4 in float32, as phase 6's accumulators), one
     accumulation pass and one fb_scans launch in each of the 16
     mix_posteriors_utterance calls, the host seconds of the float64
     CMLLR statistics and estimates beside the wall, peak device memory;
     HHEd RC 8, then HERest -K MLLRMEAN through its base classes on the
     card (the pass and one more a speaker); HVite -J -h with each TMF
     kind on the card and the CPU path, rec.mlf equal, decode_scan
     launches one a bucket (CMLLR) and one an utterance (MLLR), walls;
     HDecode -J -h with the CMLLR TMFs on the card and the CPU path,
     rec.mlf equal, one maxplus launch a padded frame of each speaker's
     batch; on utt000, CMLLR-transformed, fb_scans kernel == plain and
     decode_scan kernel == plain under its speaker's MLLR classes
     (`model_params`)
 28. the full recipe twin (recipes/full.py, every stage of
     recipes/full/run_full.sh) at the default corpus size: each stage's
     wall, %Corr and %Acc, the launches of the whole chain; the phase
     fails when check_results.py's rule fails (a stage more than 3.0
     below results_expected.md)
 20. one JSON line of kernels, then the device line last

Phase 19 also runs the demo's trigram HDecode stage (LBuild, HDecode
below the LV threshold: one decode_scan launch an utterance, HResults at
Acc=100.00), its decode_scan launches read around that stage.

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

import collections
import contextlib
import copy
import io
import json
import os
import re
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
from htk_tpu_torch.algo import adapt, nnet, viterbi
from htk_tpu_torch.algo.composite import build_composite
from htk_tpu_torch.algo.fb import _fb_outp
from htk_tpu_torch.algo.lvnet import compile_lv_loop
from htk_tpu_torch.algo.net import compile_network, word_internal_phone_map
from htk_tpu_torch.algo.trainer import (DeviceCompositeTrainer, Trainer,
                                        _bucket, make_batches, pad_batch,
                                        prepare_utterance,
                                        prepare_utterance_ids)
from htk_tpu_torch.io.dictionary import read_dict
from htk_tpu_torch.io import parmkind as pk
from htk_tpu_torch.io.htkfeat import read_htk_file
from htk_tpu_torch.io.lm import read_arpa
from htk_tpu_torch.io.mlf import MLF
from htk_tpu_torch.io.mmf import load_mmf, save_mmf
from htk_tpu_torch.io.slf import read_slf, write_slf
from htk_tpu_torch.models.ann import load_ann
from htk_tpu_torch.models.hmmset import compile_hmmset
from htk_tpu_torch.models.proto import make_proto
from htk_tpu_torch.ops import decode_scan as ds
from htk_tpu_torch.ops import fb_scans as fbs
from htk_tpu_torch.ops import maxplus as mp
from htk_tpu_torch.ops import tropical as trop
from htk_tpu_torch.ops import xw_gather as xg
from htk_tpu_torch.ops import xw_route, xw_window
from htk_tpu_torch.ops.dsp import (FrontendConfig, compute_features,
                                   compute_features_batch)
from htk_tpu_torch.recipes import demo, full
from htk_tpu_torch.recipes.speech import utterance_set, write_wav
from htk_tpu_torch.synth import (PARM_KIND, lv_system, random_decode_net,
                                 random_fb_operands, random_maxplus_operands,
                                 random_xw_operands, word_accuracy,
                                 write_system, write_word_mlf)
from htk_tpu_torch.tools import (hcopy, hdecode, herest, hhed, hinit,
                                 hmmirest, hnforward, hntrainsgd, hrest, hvite)
from htk_tpu_torch.tools._common import DEVICE_ENV
from htk_tpu_torch.tools._xfcli import (chain_model_params,
                                        load_input_transforms)
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
# each profiled kernel's launch count, for a profile timed with CUDA events
PROFILE_COUNTS = {"decode_scan_kernel": ds.KERNEL, "fb_scan_kernel": fbs.KERNEL,
                  "maxplus_kernel": mp.KERNEL, "segmax_kernel": xg.SEGMAX,
                  "gather_add_kernel": xg.GATHER_ADD}
MAXPLUS_BS, MAXPLUS_CS = (1, 8, 17), (1, 200, 1000, 2050)
MAXPLUS_CHUNKS = (1, 2, 3, 7, None)  # forced source chunks; None: the grid's
MAXPLUS_MODES = {"normal": {}, "ties": {"ties": True},
                 "dead row": {"dead_rows": 1}}
TOPA = 128  # the dense top-A leg's max_active (htk_tpu's bench.py 5k row)
LAUNCH_LOOP = 100  # back-to-back launches per timed sample of one kernel
PROFILE_TRIES = 3  # torch.profiler sessions before CUDA events time a call
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
ALIGN_RTOL = 1e-4  # HVite -a -m scores, card against the port's CPU run
DEMO_UTTS = 10  # the demo corpus (make_corpus.py): HDecode's decodes
MMI_UTTS = 8  # phase 25: HMMIRest's utterances, one ACCBLOCK
MMI_LATTICE_BEAM = 150.0  # htk_tpu's bench_mmi (bench.py)
DNN_HIDDEN = "1024 1024 1024"  # phase 26's HNTrainSGD hidden layers
DNN_EPOCHS = 3
TRAIN_ATOL = 1e-5  # tests/test_torch_nnet.py's bound on trained ANNs
POS_ATOL = 1e-4  # HNForward's .pos, card against the CPU path
HYBRID_RTOL = 1e-4  # HVite -N scores, card against the CPU path
SEQ_UTTS = 1  # the sequence criterion's utterance


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
    log(f"profile on {card} of one HVite run: wall {p.wall:.1f} ms, "
        f"{p.busy()}, decode kernel "
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
    first; `events`: the session lost its records and `ops` is one entry
    timed with CUDA events (`event_profile`)."""

    def __init__(self, wall, ops, events=False):
        self.wall, self.ops, self.events = wall, ops, events

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

    def busy(self, unprofiled: Optional[float] = None) -> str:
        """The text "device busy X ms (Y% of the wall[, Z% of the
        `unprofiled` ms])", or that the busy time was not measured where
        CUDA events timed the call."""
        if self.events:
            return (f"device busy not measured (CUDA events: "
                    f"{self.ms():.3f} ms on the stream)")
        b = self.ms()
        return (f"device busy {b:.1f} ms ({100 * b / self.wall:.1f}%"
                + ("" if unprofiled is None else
                   f" of the profiled wall, {100 * b / unprofiled:.1f}% of "
                   f"the unprofiled") + ")")

    def top(self, n: int, width: int = 40, fmt: str = ".2f") -> str:
        return ", ".join(f"{k[:width]} {ms:{fmt}} ms"
                         for k, ms, _c in self.ops[:n])


def _launch_counts(expect) -> int:
    """The launches the wrappers have counted of the kernels named
    `expect` (`""`: of every kernel)."""
    names = (expect,) if isinstance(expect, str) else expect
    return sum(c.launches for k, c in PROFILE_COUNTS.items()
               if any(n in k for n in names))


def event_profile(fn, dev, expect) -> Profile:
    """fn() between two CUDA events on the current stream: one entry
    named after `expect`, with the stream's elapsed ms (an upper bound of
    the device time: it holds the stream's idle gaps too) and the
    launches the wrappers counted (at least one where `expect` names a
    kernel of ours; else fn launched none and this raises)."""
    n0 = _launch_counts(expect)
    torch.cuda.synchronize(dev)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) * 1e3
    n = _launch_counts(expect) - n0
    key = ((expect if isinstance(expect, str) else "/".join(expect))
           or "all device work") + " (CUDA events)"
    if not n:
        if expect:
            raise AssertionError(f"{key}: the call launched no kernel "
                                 f"named {expect!r}")
        n = 1
    return Profile(wall, [(key, e0.elapsed_time(e1), n)], events=True)


def device_profile(fn, dev, expect, launches: Optional[int] = None
                   ) -> Profile:
    """One synchronised fn() under torch.profiler, where fn launches a
    device operation whose name holds `expect` (`""`: any; or one of a
    tuple of names), `launches` times where that is known.

    The card's torch.profiler at times returns a session that lacks some
    or all of its device records, for our kernels and torch's alike:
    a decode_scan session came back empty after the HCopy profile, one
    fb_scans session lacked its table kernel, a loop of 100 maxplus
    launches held 99 records in six sessions running, and in one run six
    decode_scan sessions running held no record at all. So a session
    without a record of `expect` is run again, up to PROFILE_TRIES
    sessions; when none holds one, the call is timed with CUDA events
    instead (`event_profile`), and that is logged. A shortfall against
    `launches` is logged, and per-launch times divide by the launches
    recorded."""
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
    p = event_profile(fn, dev, expect)
    key, ms, n = p.ops[0]
    log(f"  (torch.profiler: no session of {PROFILE_TRIES} held a device "
        f"record of {expect!r}; timed with CUDA events instead: {ms:.6f} ms "
        f"on the stream, {n} launches counted; device busy not measured "
        f"in this profile)")
    return p


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
    log(f"profile on {card} of one HERest iteration: wall {p.wall:.1f} ms, "
        f"{p.busy()}, fb_scans' scan kernel "
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
        f"profiler slows the host; unprofiled {bk:.1f} ms), {p.busy(bk)}, "
        f"{p.n} device "
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
    return launches["exact"], out["exact"]


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
            f"{p.wall:.1f} ms (unprofiled {bms:.1f} ms), {p.busy(bms)}, "
            f"{p.n} "
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
    log(f"profile on {card} of one batched HCopy {HCOPY_KINDS[0]} run: wall "
        f"{p.wall:.1f} ms ({audio_s / p.wall * 1e3:.1f} s of audio per s), "
        f"{p.busy()}, {p.n} "
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


def decode_hold(net, scores, lm, what) -> float:
    """decode_scan's kernel against its plain version on one utterance's
    hybrid scores (T, S) gathered on the net's states, at LM scale and
    word penalty `lm`: live scores within ATOL, records equal."""
    outp = scores[:, dec._net_dev(net, scores.device)["comp_state"]]
    args = decode_operands(outp[None].contiguous(), net, *lm)
    k = ds.decode_scan_cuda(*args)
    p = ds.decode_scan_plain(*args)
    torch.cuda.synchronize()
    err = compare(k, p, what)
    lo, hi = float(scores.min()), float(scores.max())
    log(f"{what}: decode kernel == plain on ANN scores in [{lo:.2f}, "
        f"{hi:.2f}] (T={scores.shape[0]}, Ns={net.n_states}; max |dv| "
        f"{err:.3g}, records equal)")
    return err


def arc_operands(arcfb, fbank, launch):
    """fb_scans' operands of one ArcFB launch (tb, qb, bw, arcs), as
    ArcFB.score builds them: frames gathered from the bank, OutP of the
    touched Gaussians, padding rows at t_real = 0 on composite 0."""
    tb, qb, bw, batch = launch
    feats, t_real, c = arcfb._operands(fbank, arcfb._bank(qb), batch, bw, tb)
    outp = _fb_outp(feats, c["comp_state"], c["q_mask"], **arcfb._params,
                    slot_blocks=tuple(arcfb.comp.slot_blocks) or None,
                    gather_outp=True)[0]
    return outp, c["logA"], c["a0"], c["aE"], t_real


def arc_holds(comp, vocab, feats, lats, dev, what, batch=256):
    """Every lattice's arcs as HMMIRest expands them, on one feature
    bank; fb_scans' kernel against its plain version on the launch with
    the most arcs. Returns (max |d|, that launch's operands, the ArcFB,
    its bank, the arc mini-utterances)."""
    arcfb = hmmirest.ArcFB(Trainer(comp, device=dev), comp, batch=batch)
    fbank = arcfb.load_block(feats)
    utts = []
    for i, (f, lat) in enumerate(zip(feats, lats)):
        utts.extend(hmmirest.lattice_arc_utts(
            lat, vocab, comp, f, int(FRAME_S * 1e7), f"u{i}", arcfb,
            utt=i)[0])
    launches = arcfb._buckets(utts)
    widest = max(launches, key=lambda la: len(la[3]))
    ops = arc_operands(arcfb, fbank, widest)
    B, T, Q = ops[0].shape
    err = compare_scans(fbs.fb_scans_cuda(*ops), fbs.fb_scans_plain(*ops),
                        ops[4], f"{what} arc launch")
    log(f"{what}: {len(utts)} arc mini-utterances in {len(launches)} "
        f"launches; fb_scans kernel == plain on the widest (B={B} with "
        f"{len(widest[3])} arcs, Tb={T}, Qb={Q}; max |d| {err:.3g})")
    return err, ops, arcfb, fbank, utts


def phase_demo(card, dev):
    """The demo twin, every stage of run_demo.sh, in a temporary
    directory: 100% word accuracy at HVite -z, after MMI and at HDecode
    (run_chain raises otherwise), the DNN hybrid's WORD line, each tool's
    wall; the decode_scan and fb_scans launches of the whole chain, and
    read around each HVite, HMMIRest and HDecode call: 2 buckets for
    HVite -z and for the MMI decode, one an utterance for HVite -N and
    HDecode. Then, on the chain's files, fb_scans' kernel against its
    plain version on HMMIRest's widest arc launch and decode_scan's on
    HVite -N's ANN scores."""
    work = tempfile.mkdtemp(prefix="chip_demo_")
    mods = {"hvite": hvite, "hmmirest": hmmirest, "hdecode": hdecode}
    reals = {n: m.main for n, m in mods.items()}
    calls = {n: [] for n in mods}

    def counted(name):
        def main(argv):
            n0 = ds.KERNEL.launches, fbs.KERNEL.launches
            rc = reals[name](argv)
            calls[name].append((ds.KERNEL.launches - n0[0],
                                fbs.KERNEL.launches - n0[1]))
            return rc
        return main

    for n, m in mods.items():
        m.main = counted(n)
    try:
        reset_counts()
        t0 = time.perf_counter()
        walls = demo.run_chain(work, quiet=True)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        d_n, f_n = ds.KERNEL.launches, fbs.KERNEL.launches
        for n, m in mods.items():
            m.main = reals[n]
        reports = {}
        for lab in ("HResults_MMI", "HResults_DNN"):
            with open(os.path.join(work, f"{lab}.txt")) as f:
                reports[lab] = demo.word_line(f.read())
        d_err, f_err = demo_holds(work, dev)
    finally:
        for n, m in mods.items():
            m.main = reals[n]
        shutil.rmtree(work, ignore_errors=True)
    hv = [d for d, _f in calls["hvite"]]
    hd = [d for d, _f in calls["hdecode"]]
    mmi_f = [f for _d, f in calls["hmmirest"]]
    if (hv != [2, 2, DEMO_UTTS] or hd != [DEMO_UTTS]
            or d_n != 4 + 2 * DEMO_UTTS or len(mmi_f) != 1 or mmi_f[0] < 2
            or f_n < 7 + mmi_f[0]):
        raise AssertionError(f"demo: decode_scan launched {d_n} times, "
                             f"{hv} in the HVite calls (expected 2, 2 and "
                             f"{DEMO_UTTS}), {hd} in HDecode (expected "
                             f"{DEMO_UTTS}); fb_scans {f_n}, {mmi_f} in "
                             f"HMMIRest (expected a score and an "
                             f"accumulate launch at least, and one a HERest "
                             f"pass besides)")
    log(f"demo twin on {card}: every stage of run_demo.sh in {wall:.2f} s; "
        f"{demo.PASS_LINE} at HVite -z and HDecode, the MMI decode "
        f"{reports['HResults_MMI']}; the DNN hybrid {reports['HResults_DNN']}"
        f"; decode_scan launches {d_n} (HVite -z {hv[0]}, MMI decode "
        f"{hv[1]}, HVite -N {hv[2]}, HDecode {hd[0]}), fb_scans launches "
        f"{f_n} ({mmi_f[0]} of them under HMMIRest); "
        + ", ".join(f"{lab} {s:.3f} s" for lab, s in walls))
    return d_n, f_n, hd[0], mmi_f[0], hv[2], d_err, f_err


def demo_holds(work, dev):
    """The demo chain's files: fb_scans on HMMIRest's widest arc launch
    (the tied2 set over the HVite -z lattices), decode_scan on HVite -N's
    scores of the first utterance (LM scale 1, penalty -10, as run)."""
    comp = compile_hmmset(load_mmf([os.path.join(work, "tied2/hmmdefs")]))
    vocab = read_dict(os.path.join(work, "dict"))
    feats = [read_htk_file(os.path.join(work, f"u{i}.mfc")).data
             for i in range(DEMO_UTTS)]
    lats = [read_slf(os.path.join(work, f"lats/u{i}.lat"))
            for i in range(DEMO_UTTS)]
    f_err = arc_holds(comp, vocab, feats, lats, dev, "demo HMMIRest")[0]
    net = compile_network(read_slf(os.path.join(work, "wdnet.slf")), vocab,
                          comp, phone_map=word_internal_phone_map(comp.names))
    ann = load_ann(os.path.join(work, "dnn/ann"))
    scores = nnet.hybrid_outp(ann, feats[0], device=dev)
    d_err = decode_hold(net, scores, (1.0, -10.0), "demo HVite -N u0")
    return d_err, f_err


@contextlib.contextmanager
def tool_device(name: str):
    """The port's tools run on `name` ("cuda" or "cpu") inside."""
    old = os.environ.get(DEVICE_ENV)
    os.environ[DEVICE_ENV] = name
    try:
        yield
    finally:
        os.environ[DEVICE_ENV] = old


@contextlib.contextmanager
def timed_calls(module, name: str, acc: list, grab=None):
    """module.name runs timed inside (host seconds of each call, ending in a
    synchronise, appended to `acc`); `grab(kwargs)` sees each call's
    keyword arguments after it."""
    real = getattr(module, name)

    def wrapper(*a, **k):
        t0 = time.perf_counter()
        out = real(*a, **k)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        acc.append(time.perf_counter() - t0)
        if grab is not None:
            grab(k)
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def _mlf_rows(path):
    """{stem: [(name, start, end, aux)], ...} and the scores alongside."""
    rows, scores = {}, {}
    for pat, tr in MLF.load(path).entries:
        stem = os.path.splitext(os.path.basename(pat))[0]
        rows[stem] = [(lab.name, lab.start, lab.end, tuple(lab.aux or ()))
                      for lab in tr.labels]
        scores[stem] = np.asarray([lab.score or 0.0 for lab in tr.labels])
    return rows, scores


def _composite(comp, vocab, words):
    """The composite HMM HVite -a aligns `words` against: each word's
    first pronunciation, word-internally context-expanded."""
    pmap = word_internal_phone_map(comp.names)
    names = [ph for w in words for ph in pmap(vocab.get(w).prons[0].phones)]
    return build_composite(comp, [comp.model_id(n) for n in names])


def _direct_align(comp, vocab, words, path, device):
    """viterbi.align of one utterance on `device`, as HVite -a runs it:
    (physical state per frame, score)."""
    hmm = _composite(comp, vocab, words)
    r = viterbi.align(comp, hmm, read_htk_file(path).data, device=device)
    return hmm.comp_state[r.states], r.score


def phase_align(sysm, root, comp, card, dev):
    """HVite -a -m on the config-4 system (a word MLF of the synthesised
    transcriptions): on the card and, the same call, on the port's CPU
    path; labels, word tags and times identical, scores within ALIGN_RTOL
    relative. Where a model boundary moved, the two runs' Viterbi paths
    must hold the same physical states (adjacent models sharing a tied
    state tie exactly, and the two devices' roundings break the tie) and
    the same score within ALIGN_RTOL. Then one -a -z run writing the
    numerator lattices. Returns the card's aligned MLF, the walls, and
    the alignment core of the same 16 utterances (OutP, the Viterbi scan
    and the traceback on the card) as a function for `align_profile`."""
    wmlf = write_word_mlf(sysm, os.path.join(root, "words.mlf"))

    def argv(mlf, *extra):
        return ["-a", "-m", "-y", "lab", "-I", wmlf, "-H", sysm.hmmdefs,
                "-i", mlf, *extra, "-S", sysm.scp, sysm.dict, sysm.hmmlist]

    walls = {}
    for where in ("cuda", "cpu"):
        mlf = os.path.join(root, f"aligned_{where}.mlf")
        with tool_device(where):
            t0 = time.perf_counter()
            rc = hvite.run(argv(mlf))
            torch.cuda.synchronize(dev)
            walls[where] = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"HVite -a -m on {where} returned {rc}")
    (rk, sk), (rc_, sc_) = (_mlf_rows(os.path.join(root, f"aligned_{w}.mlf"))
                            for w in ("cuda", "cpu"))
    if sorted(rk) != sorted(rc_) or len(rk) != N_UTTS:
        raise AssertionError(f"HVite -a: {len(rk)} card and {len(rc_)} CPU "
                             f"transcriptions, expected {N_UTTS}")
    vocab = read_dict(sysm.dict)
    paths = {os.path.splitext(os.path.basename(p))[0]: (p, t)
             for p, t in zip(sysm.feats, sysm.transcripts)}
    moved, worst = [], 0.0
    for stem in sorted(rk):
        a, b = rk[stem], rc_[stem]
        if [(r[0], r[3]) for r in a] != [(r[0], r[3]) for r in b]:
            raise AssertionError(f"HVite -a {stem}: labels differ")
        if a != b:
            path, words = paths[stem]
            (pk_, sk_), (pc_, sc2) = (
                _direct_align(comp, vocab, words, path, d)
                for d in (dev, "cpu"))
            if not np.array_equal(pk_, pc_) or abs(sk_ - sc2) > \
                    ALIGN_RTOL * abs(sc2):
                raise AssertionError(f"HVite -a {stem}: times differ and "
                                     "the physical state paths or scores "
                                     "do too")
            moved.append(stem)
            continue
        d = np.abs(sk[stem] - sc_[stem]) / np.abs(sc_[stem])
        worst = max(worst, float(d.max()))
        if worst > ALIGN_RTOL:
            raise AssertionError(f"HVite -a {stem}: scores differ by "
                                 f"{worst:.3g} relative")
    n_labs = sum(len(r) for r in rk.values())
    work = [(_composite(comp, vocab, words), read_htk_file(path).data)
            for path, words in zip(sysm.feats, sysm.transcripts)]

    def core():
        for hmm, f in work:
            viterbi.align(comp, hmm, f, device=dev)

    latdir = os.path.join(root, "numlats")
    os.makedirs(latdir)
    t0 = time.perf_counter()
    if hvite.run(argv(os.path.join(root, "aligned_z.mlf"), "-z", "lat",
                      "-l", latdir)) != 0:
        raise RuntimeError("HVite -a -m -z returned non-zero")
    torch.cuda.synchronize(dev)
    zwall = time.perf_counter() - t0
    n_lat = len(os.listdir(latdir))
    if n_lat != N_UTTS:
        raise AssertionError(f"HVite -a -z wrote {n_lat} lattices")
    frames = sum(sysm.n_frames)
    log(f"HVite -a -m on {card}: {N_UTTS} utterances ({frames} frames, "
        f"{n_labs} model labels) in {walls['cuda']:.3f} s (CPU path "
        f"{walls['cpu']:.3f} s); labels and word tags == the CPU run's, "
        f"times equal in {N_UTTS - len(moved)} utterances, in "
        f"{len(moved)} ({moved}) a boundary moved inside a tied state "
        f"(same physical path and score); scores within {worst:.3g} "
        f"relative (limit {ALIGN_RTOL}); -a -z {zwall:.3f} s, {n_lat} "
        f"numerator lattices")
    return os.path.join(root, "aligned_cuda.mlf"), walls, (core, frames)


def align_profile(core, frames, card, dev):
    """The alignment core of phase 21 under torch.profiler: its device
    busy share and operations a frame."""
    p = device_profile(core, dev, "")
    log(f"profile on {card} of HVite -a's alignment core ({N_UTTS} "
        f"utterances, {frames} frames, one at a time): wall {p.wall:.1f} "
        f"ms, {p.busy()}, "
        f"{p.n} device operations ({p.n / frames:.2f} a frame); top: "
        f"{p.top(4)}")


def _mmf_params(path):
    c = compile_hmmset(load_mmf([path]))
    w = np.where(c.state_mix >= 0, np.exp(c.state_logw), 0.0)
    return dict(means=c.means, variances=c.variances, weights=w,
                transp=np.exp(np.maximum(c.log_transp, -700.0)))


def mmf_close(got, ref, what,
              keys=("weights", "transp", "means", "variances")):
    """tests/test_torch_herest.py's tolerances: weights and transitions
    rtol 1e-4, atol 1e-7; means and variances rtol 1e-4, atol 1e-3 of
    the array's largest magnitude. Returns the largest |diff| / scale."""
    g, r = _mmf_params(got), _mmf_params(ref)
    worst = 0.0
    for k in keys:
        scale = float(np.abs(r[k]).max())
        atol = 1e-7 if k in ("weights", "transp") else 1e-3 * scale
        if not np.allclose(g[k], r[k], rtol=1e-4, atol=atol):
            raise AssertionError(f"{what}: {k} differs by "
                                 f"{float(np.abs(g[k] - r[k]).max())}")
        worst = max(worst, float(np.abs(g[k] - r[k]).max()) / scale)
    return worst


def phase_hinit_hrest(sysm, root, aligned, card, dev):
    """HInit, then HRest, on the triphone with the most segments in the
    card's -a -m alignment (-l), from a flat proto: on the card and on
    the port's CPU path; the MMFs within the herest tolerances; HRest's
    fb_scans launches (one a batch of each iteration) and the walls."""
    count = collections.Counter(
        lab.name for _p, tr in MLF.load(aligned).entries
        for lab in tr.labels)
    label, n_seg = count.most_common(1)[0]
    proto = os.path.join(root, "proto")
    save_mmf(make_proto(nstates=5, dim=SYSTEM["dim"], parm_kind=PARM_KIND),
             proto)
    walls, launches, out = {}, {}, {}
    for where in ("cuda", "cpu"):
        d = os.path.join(root, f"hinit_{where}")
        with tool_device(where):
            t0 = time.perf_counter()
            rc = hinit.run(["-T", "1", "-l", label, "-o", label, "-I",
                            aligned, "-M", f"{d}/init", "-S", sysm.scp,
                            proto])
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            reset_counts()
            rc2 = hrest.run(["-T", "1", "-l", label, "-I", aligned, "-M",
                             f"{d}/rest", "-S", sysm.scp,
                             f"{d}/init/{label}"])
            torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
        if rc or rc2:
            raise RuntimeError(f"HInit/HRest on {where}: {rc}, {rc2}")
        walls[where] = (t1 - t0, t2 - t1)
        launches[where] = fbs.KERNEL.launches
        out[where] = (f"{d}/init/{label}", f"{d}/rest/{label}")
    if launches["cuda"] < 1:
        raise AssertionError("HRest did not launch fb_scans on the card")
    errs = [mmf_close(k, c, f"{tool} card vs CPU")
            for tool, k, c in zip(("HInit", "HRest"), out["cuda"],
                                  out["cpu"])]
    log(f"HInit and HRest of {label} ({n_seg} segments) on {card}: HInit "
        f"{walls['cuda'][0]:.3f} s, HRest {walls['cuda'][1]:.3f} s with "
        f"{launches['cuda']} fb_scans launches (CPU path "
        f"{walls['cpu'][0]:.3f} s and {walls['cpu'][1]:.3f} s); MMFs == "
        f"the CPU run's within the herest tolerances (largest |diff| / "
        f"scale: HInit {errs[0]:.3g}, HRest {errs[1]:.3g})")
    return launches["cuda"]


def phase_hdecode(sysm, root, card, dev):
    """HDecode on config #4's written files (1,000 words, so the LV loop;
    lm.arpa is a bigram, so the dense exact leg: one maxplus launch a
    padded frame), its 16 utterances in one auto-sized batch: rec.mlf
    identical to the port's CPU run, word accuracy, lattices, records in
    beam and overflow, the batch's device pipeline beside its host walk,
    and peak device memory. Returns the maxplus launches."""
    lens = sysm.n_frames
    want = pad_T(lens)
    runs = {}
    for where in ("cuda", "cpu"):
        latdir = os.path.join(root, f"hd_lats_{where}")
        mlf = os.path.join(root, f"rechd_{where}.mlf")
        os.makedirs(latdir)
        argv = ["-T", "1", "-w", sysm.lm, "-s", str(LM_SCALE), "-p",
                str(WORD_PEN), "-z", "lat", "-l", latdir, "-i", mlf, "-H",
                sysm.hmmdefs, "-S", sysm.scp, sysm.dict, sysm.hmmlist]
        pipe, batch, stats = [], [], []
        out = io.StringIO()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        with tool_device(where), timed_calls(dec, "_lv_lattice_pipeline",
                                             pipe), \
                timed_calls(hdecode, "generate_lattice_batch", batch,
                            lambda k: stats.append(dict(k["stats"]))), \
                contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            rc = hdecode.run(argv)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"HDecode on {where} returned {rc}")
        runs[where] = dict(wall=wall, pipe=pipe, batch=batch, stats=stats,
                           launches=mp.KERNEL.launches, mlf=mlf,
                           latdir=latdir, trace=out.getvalue(),
                           peak=torch.cuda.max_memory_allocated(dev))
    k = runs["cuda"]
    if len(k["batch"]) != 1 or k["launches"] != want:
        raise AssertionError(f"HDecode: {len(k['batch'])} batches and "
                             f"{k['launches']} maxplus launches, expected 1 "
                             f"and {want}")
    with open(k["mlf"], "rb") as f, open(runs["cpu"]["mlf"], "rb") as g:
        if f.read() != g.read():
            raise AssertionError("HDecode: the card's rec.mlf differs from "
                                 "the CPU run's")
    m = MLF.load(k["mlf"])
    hyps = []
    for p in sysm.feats:
        tr = m.lookup(f"*/{os.path.splitext(os.path.basename(p))[0]}.rec")
        if tr is None or not tr.names():
            raise AssertionError(f"HDecode: no transcript for {p}")
        hyps.append(tr.names())
    lats = [read_slf(os.path.join(k["latdir"], f))
            for f in sorted(os.listdir(k["latdir"]))]
    if len(lats) != N_UTTS:
        raise AssertionError(f"HDecode wrote {len(lats)} lattices")
    st = k["stats"][0]
    acc = word_accuracy(sysm.transcripts, hyps)
    dev_s, walk_s = k["pipe"][0], k["batch"][0] - k["pipe"][0]
    log(f"HDecode on {card} (LV dense, {len(lens)} utterances in one batch, "
        f"T padded to {want}): rc 0 in {k['wall']:.3f} s (CPU path "
        f"{runs['cpu']['wall']:.3f} s), maxplus launches {k['launches']} "
        f"(one a padded frame), rec.mlf == the CPU run's, word accuracy "
        f"{acc:.2f}%; lattices {sum(len(x.nodes) for x in lats)} nodes, "
        f"{sum(len(x.arcs) for x in lats)} arcs; records in beam "
        f"{st['in_beam']}, kept {st['kept']}, {st['overflow']} utterances "
        f"over the budget (8523), {st['gathers']} resurrection gathers; "
        f"pass 1 {k['batch'][0]:.3f} s = device pipeline (scan, "
        f"compaction, copies) {dev_s:.3f} s + host walk {walk_s:.3f} s; "
        f"peak device memory {k['peak'] / 2**30:.2f} GiB")
    log("  HDecode -T 1: " + " | ".join(
        ln for ln in k["trace"].splitlines() if ln.startswith("HDecode")))
    return k["launches"]


def phase_big_lattice(big, net, exact, dev):
    """generate_lattice_batch(want_results=True) on the 20k factored net,
    its first batch of 8, exact and adaptive legs: one segmax launch a
    padded frame each, the 1-best equal to phase 12's exact decode_batch
    (words and times equal, scores within 1e-5 relative), records in beam
    and overflow, the device pipeline beside the host walk, and peak
    device memory. Returns the exact leg's segmax launches."""
    idx = lv_batches(len(big.feats))[0]
    fl = [big.feats[i] for i in idx]
    want = pad_T([f.shape[0] for f in fl])
    out = {}
    for leg, ma in (("exact", None), ("adaptive", ADAPTIVE)):
        stats, pipe = {}, []
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        with timed_calls(dec, "_lv_lattice_pipeline", pipe):
            t0 = time.perf_counter()
            prs = dec.generate_lattice_batch(
                net, big.comp, fl, BIG_LM_SCALE, BIG_WORD_PEN, LATTICE_BEAM,
                FRAME_S, max_active=ma, want_results=True, stats=stats,
                device=dev)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        n = xg.SEGMAX.launches
        if n != want:
            raise AssertionError(f"20k lattices, {leg}: segmax launched {n} "
                                 f"times, expected {want}")
        for i, (lt, r) in zip(idx, prs):
            e = exact[i]
            if lt is None or r is None or (r.words, r.times) != (e.words,
                                                                e.times) \
                    or abs(r.score - e.score) > 1e-5 * abs(e.score):
                raise AssertionError(f"20k lattices, {leg}: utterance {i}'s "
                                     "1-best differs from decode_batch's")
        out[leg] = n
        log(f"20k lattices, {leg} leg (B={len(fl)}, T={want}): "
            f"{wall:.3f} s = device pipeline {pipe[0]:.3f} s + host walk "
            f"{wall - pipe[0]:.3f} s; segmax launches {n}; 1-best == "
            f"decode_batch's (words, times; scores within 1e-5); lattices "
            f"{sum(len(lt.nodes) for lt, _ in prs)} nodes, "
            f"{sum(len(lt.arcs) for lt, _ in prs)} arcs; records in beam "
            f"{stats['in_beam']}, kept {stats['kept']}, {stats['overflow']} "
            f"utterances over the budget, {stats['gathers']} resurrection "
            f"gathers for {stats['resurrected']} records; peak device "
            f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return out["exact"]


def _feats_names(sysm, n):
    """The first n utterances' features and phone transcriptions."""
    mlf = MLF.load(sysm.train_mlf)
    feats, names = [], []
    for path in sysm.feats[:n]:
        stem = os.path.splitext(os.path.basename(path))[0]
        feats.append(read_htk_file(path).data)
        names.append(mlf.lookup(f"*/{stem}.lab").names())
    return feats, names


def _rec_rows(path):
    """rec.mlf's bytes, to compare two runs' whole files."""
    with open(path, "rb") as f:
        return f.read()


def _scores_of(trace):
    """{utterance: score} from HVite -T 1's per-utterance lines."""
    out = {}
    for ln in trace.splitlines():
        if ln.endswith("]") and "  [" in ln:
            head, sc = ln.rsplit("  [", 1)
            out[head.split(":")[0]] = float(sc[:-1])
    return out


def ebw_bounds(comp, accs_a, accs_b, e=2.0):
    """How far the EBW update (algo/ebw.py) can move between two runs
    whose (numerator, denominator) accumulators part by their gap. Per
    Gaussian, with n = the numerator's statistics minus the denominator's
    and D the update's smoothing constant (E d_occ, doubled until every
    variance is positive, replayed here on run b's values),

      mu'  = (n_x + D mu0) / (n_occ + D)
      var' = (n_xx + D (var0 + mu0^2)) / (n_occ + D) - mu'^2

    and per state, w'_m = N_m / S with N_m = wt_n - wt_d + C w_m, C = 2
    max_m(wt_d / w_m) + 1, S = sum_m N_m. Each quotient a / b moves by at
    most (|da| + |a / b| |db|) / (b - |db|), and mu'^2 by |dmu| (2 |mu|
    + |dmu|). Returns {means, variances, weights: bound arrays};
    Gaussians under the update's occupancy floor keep their values
    (bound 0)."""
    f64 = lambda x: np.asarray(x, np.float64)  # noqa: E731
    (na, da), (nb, db) = accs_a, accs_b

    def diff(acc_n, acc_d, f):
        return f64(getattr(acc_n, f)) - f64(getattr(acc_d, f))

    gap = {f: np.abs(diff(na, da, f) - diff(nb, db, f))
           for f in ("occ", "sum_x", "sum_xx")}
    mu0, var0 = f64(comp.means), f64(comp.variances)
    occ, x, xx = (diff(nb, db, f) for f in ("occ", "sum_x", "sum_xx"))
    d_occ = f64(db.occ)
    D = np.maximum(e * d_occ, 1.0)
    for _ in range(40):  # algo/ebw.py's search for D, vectorised
        den = occ + D
        var = ((xx + D[:, None] * (var0 + mu0 ** 2)) / np.where(
            den > 0, den, 1.0)[:, None]
               - ((x + D[:, None] * mu0) / np.where(den > 0, den, 1.0)
                  [:, None]) ** 2)
        bad = (den <= 0) | ~(var > 0).all(axis=1)
        if not bad.any():
            break
        D = np.where(bad, 2 * D, D)
    # D scales with d_occ where E d_occ set it
    dD = np.where(e * d_occ > 1.0, D / np.maximum(d_occ, 1e-30)
                  * np.abs(f64(da.occ) - d_occ), 0.0)[:, None]
    D = D[:, None]
    denom = occ[:, None] + D
    d_den = gap["occ"][:, None] + dD
    low = np.maximum(denom - d_den, 1e-30)
    mu = (x + D * mu0) / denom
    t1 = (xx + D * (var0 + mu0 ** 2)) / denom
    d_mu = (gap["sum_x"] + np.abs(mu0) * dD + np.abs(mu) * d_den) / low
    d_t1 = (gap["sum_xx"] + (var0 + mu0 ** 2) * dD
            + np.abs(t1) * d_den) / low
    d_var = d_t1 + d_mu * (2 * np.abs(mu) + d_mu)
    live = ((f64(nb.occ) + d_occ) >= 1e-3)[:, None]
    old_w = np.where(comp.state_mix >= 0, np.exp(comp.state_logw), 0.0)

    def parts(num, den):
        wn, wd = f64(num.wt_occ), f64(den.wt_occ)
        ratio = np.where(old_w > 0, wd / np.maximum(old_w, 1e-10), 0.0)
        C = ratio.max(axis=1, keepdims=True) * 2.0 + 1.0
        return np.maximum(wn - wd + C * old_w, 0.0)

    Na, Nb = parts(na, da), parts(nb, db)
    S = Nb.sum(axis=1, keepdims=True)
    dS = np.abs(Na.sum(axis=1, keepdims=True) - S)
    return {"means": np.where(live, d_mu, 0.0),
            "variances": np.where(live, d_var, 0.0),
            "weights": (np.abs(Na - Nb) + Nb / np.maximum(S, 1e-30) * dS)
            / np.maximum(S - dS, 1e-30)}


def phase_hmmirest(sysm, root, card, dev):
    """HMMIRest on the config-4 system at full width, the first MMI_UTTS
    utterances in one ACCBLOCK: denominator lattices from HVite -z at
    HREC: LATTICEBEAM = 150 (htk_tpu's bench_mmi), numerators the phone
    MLF. On the card and on the port's CPU path: the MMFs within the
    herest tolerances, the MMI criteria within 1e-4 relative; lattice
    arcs, arc mini-utterances, score and accumulate launches, EBW
    seconds, each pass's wall, peak device memory. HVite -w with each
    MMI model: rec.mlf equal, word accuracy. On the same arcs: fb_scans'
    kernel against its plain version on the widest real launch and on a
    4,096-wide launch of one real arc (padding rows at t_real = 0),
    times in turns at the arc shape beside the bound, and each pass's
    device busy share. Returns the card run's fb_scans launches."""
    n = MMI_UTTS
    scp = os.path.join(root, "mmi.scp")
    with open(scp, "w") as f:
        f.write("".join(f"{p}\n" for p in sysm.feats[:n]))
    cfg = os.path.join(root, "mmi.cfg")
    with open(cfg, "w") as f:
        f.write(f"HREC: LATTICEBEAM = {MMI_LATTICE_BEAM}\n"
                f"HREC: DECODEBATCH = {n}\nHMMIREST: ACCBLOCK = {n}\n")
    latdir = os.path.join(root, "mmi_lats")
    os.makedirs(latdir)
    lm = ["-s", str(LM_SCALE), "-p", str(WORD_PEN)]
    t0 = time.perf_counter()
    if hvite.run(["-C", cfg, "-w", sysm.wdnet, "-H", sysm.hmmdefs, "-i",
                  os.path.join(root, "mmi_den.mlf"), *lm, "-z", "lat", "-l",
                  latdir, "-S", scp, sysm.dict, sysm.hmmlist]) != 0:
        raise RuntimeError("HVite -z for the MMI lattices failed")
    lat_s = time.perf_counter() - t0
    runs = {}
    for where in ("cuda", "cpu"):
        out_dir = os.path.join(root, f"mmi_{where}")
        argv = ["-C", cfg, "-T", "1", "-I", sysm.train_mlf, "-r", latdir,
                "-d", sysm.dict, "-s", str(LM_SCALE), "-H", sysm.hmmdefs,
                "-M", out_dir, "-S", scp, sysm.hmmlist]
        ebw, score, accum, accs = [], [], [], []
        out = io.StringIO()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        real_ebw = hmmirest.ebw_update

        def grab_ebw(comp, num, den, *a, **kw):
            accs.append((num, den))
            return real_ebw(comp, num, den, *a, **kw)

        hmmirest.ebw_update = grab_ebw
        with tool_device(where), timed_calls(hmmirest, "ebw_update", ebw), \
                timed_calls(hmmirest.ArcFB, "score", score), \
                timed_calls(hmmirest.ArcFB, "accumulate", accum), \
                contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            rc = hmmirest.run(argv)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        hmmirest.ebw_update = real_ebw
        if rc != 0:
            raise RuntimeError(f"HMMIRest on {where} returned {rc}")
        text = out.getvalue()
        m = re.search(r"(\d+) lattice arcs, (\d+) arc mini-utterances, "
                      r"(\d+) score and (\d+) accumulate launches", text)
        c = re.search(r"MMI criterion (-?[0-9.]+)", text)
        if not (m and c):
            raise AssertionError(f"HMMIRest -T 1 on {where}: no arc or "
                                 f"criterion line in {text[-500:]!r}")
        runs[where] = dict(wall=wall, ebw=sum(ebw), score=sum(score),
                           accum=sum(accum), counts=[int(x) for x in
                                                     m.groups()],
                           crit=float(c.group(1)), argv=argv,
                           launches=fbs.KERNEL.launches, accs=accs[0],
                           peak=torch.cuda.max_memory_allocated(dev),
                           mmf=os.path.join(out_dir, "hmmdefs"))
    k, cp = runs["cuda"], runs["cpu"]
    arcs, utts_n, n_score, n_acc = k["counts"]
    if k["counts"] != cp["counts"]:
        raise AssertionError(f"HMMIRest: card {k['counts']} arcs, "
                             f"mini-utterances and launches, CPU "
                             f"{cp['counts']}")
    if k["launches"] < n_score + n_acc or not n_score or not n_acc:
        raise AssertionError(f"HMMIRest: {k['launches']} fb_scans launches "
                             f"for {n_score} score and {n_acc} accumulate "
                             f"launches")
    if abs(k["crit"] - cp["crit"]) > 1e-4 * abs(cp["crit"]):
        raise AssertionError(f"HMMIRest: MMI criterion {k['crit']} on the "
                             f"card, {cp['crit']} on the CPU")
    # the accumulators at phase 7's tolerance, transitions (EBW keeps
    # them) at the herest tolerances; means, variances and weights within
    # what the accumulators' own gap moves them by through EBW, which
    # takes the numerator's statistics minus the denominator's (not their
    # ratio, as HERest does), so independent float32 errors in the two
    # do not cancel
    agap = {}
    for side, (a, b) in zip(("num", "den"), zip(k["accs"], cp["accs"])):
        for f in ("occ", "sum_x", "sum_xx", "wt_occ"):
            ga, gb = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            agap[f"{side} {f}"] = float(np.abs(ga - gb).max()
                                        / max(np.abs(gb).max(), 1e-30))
    if max(agap.values()) > ACC_TOL:
        raise AssertionError(f"HMMIRest accumulators card vs CPU: {agap}")
    err = mmf_close(k["mmf"], cp["mmf"], "HMMIRest card vs CPU",
                    keys=("transp",))
    comp = compile_hmmset(load_mmf([sysm.hmmdefs]))
    bounds = ebw_bounds(comp, k["accs"], cp["accs"])
    got, ref = _mmf_params(k["mmf"]), _mmf_params(cp["mmf"])
    reach = {}
    for f, b in bounds.items():
        if f == "weights":
            g = got[f][comp.state_mix >= 0]
            r = ref[f][comp.state_mix >= 0]
            b = b[comp.state_mix >= 0]
        else:
            g, r = got[f], ref[f]
        # the MMF text keeps 7 significant digits of each value
        lim = b * (1 + 1e-3) + 2e-6 * float(np.abs(r).max())
        d = np.abs(g - r)
        if (d > lim).any():
            i = np.unravel_index(np.argmax(d - lim), d.shape)
            raise AssertionError(f"HMMIRest card vs CPU: {f}{list(i)} "
                                 f"differs by {d[i]:.3g}, beyond the "
                                 f"accumulators' reach {b[i]:.3g}")
        reach[f] = (float(d.max()), float(b.max()), float((d / lim).max()))
    log(f"HMMIRest card vs CPU: accumulators' largest |diff| / scale "
        + ", ".join(f"{f} {v:.2e}" for f, v in agap.items())
        + "; the MMFs part as far as that gap moves EBW's output: "
        + ", ".join(f"{f} largest |diff| {d:.3g} (largest bound {b:.3g}; "
                    f"at most {u:.2f} of its own bound)"
                    for f, (d, b, u) in reach.items())
        + f"; transitions within the herest tolerances")
    log(f"HMMIRest on {card} (config #4, {comp_width(sysm)}; {n} "
        f"utterances, one ACCBLOCK; HVite -z lattices at beam "
        f"{MMI_LATTICE_BEAM:g} in {lat_s:.2f} s): rc 0 in {k['wall']:.3f} s "
        f"(CPU path {cp['wall']:.3f} s); {arcs} lattice arcs, {utts_n} arc "
        f"mini-utterances, {n_score} score and {n_acc} accumulate launches, "
        f"fb_scans launches {k['launches']} (with the transcript "
        f"numerators); MMI criterion {k['crit']:.2f} (CPU {cp['crit']:.2f});"
        f" score pass {k['score']:.3f} s, accumulate pass {k['accum']:.3f} s,"
        f" EBW {k['ebw']:.3f} s (CPU path {cp['score']:.3f} / "
        f"{cp['accum']:.3f} / {cp['ebw']:.3f} s); peak device memory "
        f"{k['peak'] / 2**30:.2f} GiB")
    recs = {}
    for where in ("cuda", "cpu"):
        mlf = os.path.join(root, f"recmmi_{where}.mlf")
        with tool_device(where):
            t0 = time.perf_counter()
            rc = hvite.run(["-C", cfg, "-w", sysm.wdnet, "-H",
                            runs[where]["mmf"], "-i", mlf, *lm, "-S", scp,
                            sysm.dict, sysm.hmmlist])
            torch.cuda.synchronize(dev)
        if rc != 0:
            raise RuntimeError(f"HVite with the MMI model on {where}: {rc}")
        recs[where] = (mlf, time.perf_counter() - t0)
    if _rec_rows(recs["cuda"][0]) != _rec_rows(recs["cpu"][0]):
        raise AssertionError("HVite with the MMI model: the card's rec.mlf "
                             "differs from the CPU run's")
    m = MLF.load(recs["cuda"][0])
    hyps = [m.lookup(f"*/{os.path.splitext(os.path.basename(p))[0]}.rec")
            .names() for p in sysm.feats[:n]]
    log(f"HVite -w with the MMI model on {card}: {recs['cuda'][1]:.3f} s, "
        f"rec.mlf == the CPU run's, word accuracy "
        f"{word_accuracy(sysm.transcripts[:n], hyps):.2f}% (informational)")

    comp = compile_hmmset(load_mmf([sysm.hmmdefs]))
    vocab = read_dict(sysm.dict)
    feats, _names = _feats_names(sysm, n)
    lats = [read_slf(os.path.join(latdir, f"{os.path.splitext(os.path.basename(p))[0]}.lat"))
            for p in sysm.feats[:n]]
    e1, ops, arcfb, fbank, utts = arc_holds(comp, vocab, feats, lats, dev,
                                           "config-4 HMMIRest")
    # one real arc in a launch 4,096 wide: the rest are t_real = 0 rows
    wide = hmmirest.ArcFB(arcfb.trainer, comp, batch=4096)
    short = min(utts, key=lambda u: u.t1 - u.t0)
    wide.composite(short.ids)
    (launch,) = wide._buckets([short])
    wops = arc_operands(wide, fbank, launch)
    e2 = compare_scans(fbs.fb_scans_cuda(*wops), fbs.fb_scans_plain(*wops),
                       wops[4], "4,096-wide arc launch")
    if wops[0].shape[0] != 4096 or int((wops[4] > 0).sum()) != 1:
        raise AssertionError(f"the wide launch is {tuple(wops[0].shape)} "
                             f"with {int((wops[4] > 0).sum())} real rows")
    lp1 = wide.score(fbank, [short])[short.name]
    lp2 = arcfb.score(fbank, [short])[short.name]
    if lp1 != lp2:
        raise AssertionError(f"the arc scores {lp1} in the 4,096-wide "
                             f"launch and {lp2} in a narrow one")
    log(f"4,096-wide arc launch, one real row (Tb={wops[0].shape[1]}, "
        f"Qb={wops[0].shape[2]}): kernel == plain (max |d| {e2:.3g}), the "
        f"arc's logP {lp1:.3f} == its narrow launch's")
    B, T, Q = ops[0].shape
    p = time_call(lambda: fbs.fb_scans_plain(*ops), dev)
    kt = time_call(lambda: fbs.fb_scans_cuda(*ops), dev)
    kt += time_call(lambda: fbs.fb_scans_cuda(*ops), dev)
    p += time_call(lambda: fbs.fb_scans_plain(*ops), dev)
    kms, pms = statistics.median(kt), statistics.median(p)
    abound = fb_bound(*ops[:2], ops[4])
    log(f"fb_scans at the arc shape on {card} (B={B}, Tb={T}, Qb={Q}): "
        f"kernel {kms:.6f} ms, plain {pms:.6f} ms a launch (median of 6 "
        f"synchronised calls in turns), bound {abound[0]:.6f} ms "
        f"({abound[1]})")
    wts = {u.name: 1.0 for u in utts}
    zero = arcfb.trainer._zero
    ps = device_profile(lambda: arcfb.score(fbank, utts), dev,
                        "fb_scan_kernel")
    pa = device_profile(lambda: arcfb.accumulate(fbank, utts, wts, zero()),
                        dev, "fb_scan_kernel")
    log(f"  the {n} lattices' passes alone: score {ps.wall:.1f} ms wall, "
        f"{ps.busy()}; accumulate {pa.wall:.1f} ms wall, {pa.busy()}")
    return k["launches"], max(e1, e2), (kms, pms), abound


def comp_width(sysm) -> str:
    c = compile_hmmset(load_mmf([sysm.hmmdefs]))
    return (f"{c.n_mix:,} Gaussians of {c.dim} dims in {c.n_states:,} tied "
            f"states, {c.n_models:,} models")


def phase_dnn(sysm, root, card, dev):
    """The DNN hybrid on the config-4 system: HNTrainSGD (HIDDENSIZE =
    1024 1024 1024, CONTEXT = 4, -e 3) on the card and on the CPU path,
    the ANN files within TRAIN_ATOL, CE and frame accuracy per epoch,
    one epoch's wall and device busy share; HNForward of the 16 files
    with the card's ANN, .pos within POS_ATOL of the CPU's; HVite -N over
    the 16 utterances, one decode_scan launch each, rec.mlf equal to the
    CPU run's and scores within HYBRID_RTOL; decode_scan's kernel against
    its plain version on one utterance's ANN scores; then the sequence
    criterion on SEQ_UTTS utterances: the phone loop's Q, fb_scans'
    kernel against its plain version at that Q, fb_scans launches and
    the MMI objective before and after one iteration. Returns HVite -N's
    decode_scan launches and the largest kernel error."""
    cfg = os.path.join(root, "dnn.cfg")
    with open(cfg, "w") as f:
        f.write(f'HNTRAINSGD: HIDDENSIZE = "{DNN_HIDDEN}"\n'
                "HNTRAINSGD: CONTEXT = 4\n")
    runs, grab = {}, {}
    real_train = hntrainsgd.train_ann
    for where in ("cuda", "cpu"):
        out_dir = os.path.join(root, f"dnn_{where}")
        epochs = []

        def train(ann, x, y, scfg, **kw):
            grab["x"], grab["y"], grab["cfg"] = x, y, scfg
            t = [time.perf_counter()]

            def on_epoch(*a):
                torch.cuda.synchronize(dev)
                epochs.append(a + (time.perf_counter() - t[0],))
                t[0] = time.perf_counter()
            return real_train(ann, x, y, scfg, on_epoch=on_epoch, **kw)

        hntrainsgd.train_ann = train
        try:
            with tool_device(where), \
                    contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                rc = hntrainsgd.run(["-C", cfg, "-T", "1", "-e",
                                     str(DNN_EPOCHS), "-I", sysm.train_mlf,
                                     "-H", sysm.hmmdefs, "-M", out_dir, "-S",
                                     sysm.train_scp, sysm.hmmlist])
                torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
        finally:
            hntrainsgd.train_ann = real_train
        if rc != 0:
            raise RuntimeError(f"HNTrainSGD on {where} returned {rc}")
        runs[where] = dict(wall=wall, epochs=epochs,
                           ann=os.path.join(out_dir, "ann"))
    k, cp = runs["cuda"], runs["cpu"]
    ga, ra = load_ann(k["ann"]), load_ann(cp["ann"])
    worst = max(float(np.abs(a - b).max()) for lg, lr in zip(ga.layers,
                                                              ra.layers)
                for a, b in ((lg.weight, lr.weight), (lg.bias, lr.bias)))
    if worst > TRAIN_ATOL or not np.array_equal(ga.target_priors,
                                                ra.target_priors):
        raise AssertionError(f"HNTrainSGD: the card's ANN differs from the "
                             f"CPU run's by {worst:.3g}")
    dims = [ga.in_dim] + [l.weight.shape[0] for l in ga.layers]
    log(f"HNTrainSGD on {card} (layers {dims}, {grab['x'].shape[0]} frames, "
        f"-e {DNN_EPOCHS}): rc 0 in {k['wall']:.3f} s (CPU path "
        f"{cp['wall']:.3f} s); the ANN == the CPU run's within "
        f"{TRAIN_ATOL:g} (largest |diff| {worst:.3g}), priors equal")
    for (e, lr, tce, tacc, cce, cacc, s), cpu_e in zip(k["epochs"],
                                                       cp["epochs"]):
        log(f"  epoch {e + 1}: lr {lr:.5f}, train CE {tce:.4f} frame "
            f"accuracy {tacc:.3f}, cv CE {cce:.4f} accuracy {cacc:.3f}; "
            f"{s:.3f} s on the card, {cpu_e[-1]:.3f} s on the CPU path")
    one = copy.deepcopy(grab["cfg"])
    one.n_epochs = 1
    pe = device_profile(lambda: nnet.train_ann(
        load_ann(k["ann"]), grab["x"], grab["y"], one, device=dev), dev, "")
    log(f"  one more epoch under the profiler: {pe.wall:.1f} ms wall, "
        f"{pe.busy()}; top: {pe.top(4)}")

    pos = {}
    for where in ("cuda", "cpu"):
        with tool_device(where):
            t0 = time.perf_counter()
            rc = hnforward.run(["-N", k["ann"], "-M",
                                os.path.join(root, f"pos_{where}"), "-S",
                                sysm.scp, sysm.hmmlist])
            torch.cuda.synchronize(dev)
        if rc != 0:
            raise RuntimeError(f"HNForward on {where} returned {rc}")
        pos[where] = time.perf_counter() - t0
    pworst = 0.0
    for path in sysm.feats:
        stem = os.path.splitext(os.path.basename(path))[0]
        g, r = (read_htk_file(os.path.join(root, f"pos_{w}/{stem}.pos"))
                for w in ("cuda", "cpu"))
        pworst = max(pworst, float(np.abs(g.data - r.data).max()))
    if pworst > POS_ATOL:
        raise AssertionError(f"HNForward: the card's .pos differ from the "
                             f"CPU run's by {pworst:.3g}")
    log(f"HNForward of {len(sysm.feats)} files on {card}: {pos['cuda']:.3f}"
        f" s (CPU path {pos['cpu']:.3f} s), .pos == the CPU run's within "
        f"{POS_ATOL:g} (largest |diff| {pworst:.3g})")

    hv = {}
    for where in ("cuda", "cpu"):
        mlf = os.path.join(root, f"recdnn_{where}.mlf")
        out = io.StringIO()
        reset_counts()
        with tool_device(where), contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            rc = hvite.run(["-T", "1", "-w", sysm.wdnet, "-N", k["ann"],
                            "-H", sysm.hmmdefs, "-i", mlf, "-s",
                            str(LM_SCALE), "-p", str(WORD_PEN), "-S",
                            sysm.scp, sysm.dict, sysm.hmmlist])
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"HVite -N on {where} returned {rc}")
        hv[where] = dict(wall=wall, mlf=mlf, launches=ds.KERNEL.launches,
                         scores=_scores_of(out.getvalue()))
    hk, hc = hv["cuda"], hv["cpu"]
    if hk["launches"] != N_UTTS:
        raise AssertionError(f"HVite -N: {hk['launches']} decode_scan "
                             f"launches, expected one an utterance")
    if _rec_rows(hk["mlf"]) != _rec_rows(hc["mlf"]):
        raise AssertionError("HVite -N: the card's rec.mlf differs from the "
                             "CPU run's")
    if hk["scores"].keys() != hc["scores"].keys() or len(hk["scores"]) != \
            N_UTTS:
        raise AssertionError("HVite -N: -T 1 scores missing")
    srel = max(abs(hk["scores"][u] - hc["scores"][u]) /
               max(abs(hc["scores"][u]), 1.0) for u in hk["scores"])
    if srel > HYBRID_RTOL:
        raise AssertionError(f"HVite -N: scores differ by {srel:.3g} "
                             f"relative")
    m = MLF.load(hk["mlf"])
    hyps = [m.lookup(f"*/{os.path.splitext(os.path.basename(p))[0]}.rec")
            .names() for p in sysm.feats]
    log(f"HVite -N on {card}: {hk['wall']:.3f} s (CPU path "
        f"{hc['wall']:.3f} s), decode_scan launches {hk['launches']} (one "
        f"an utterance), rec.mlf == the CPU run's, scores within "
        f"{srel:.3g} relative, word accuracy "
        f"{word_accuracy(sysm.transcripts, hyps):.2f}% (informational)")

    comp = compile_hmmset(load_mmf([sysm.hmmdefs]))
    vocab = read_dict(sysm.dict)
    net = compile_network(read_slf(sysm.wdnet), vocab, comp,
                          phone_map=word_internal_phone_map(comp.names))
    ann = load_ann(k["ann"])
    feats, names = _feats_names(sysm, SEQ_UTTS)
    scores = nnet.hybrid_outp(ann, feats[0], device=dev)
    d_err = decode_hold(net, scores, (LM_SCALE, WORD_PEN),
                        "config-4 HVite -N utterance 0")

    t0 = time.perf_counter()
    loop = nnet.make_phone_loop(comp)
    loop_s = time.perf_counter() - t0
    Q = len(loop[0])
    cs = torch.as_tensor(loop[0], device=dev).long()
    lops = (scores[:, cs][None].contiguous(),
            *(torch.as_tensor(a, device=dev)[None].contiguous()
              for a in loop[1:]),
            torch.full((1,), scores.shape[0], dtype=torch.int32, device=dev))
    t0 = time.perf_counter()
    lk = fbs.fb_scans_cuda(*lops)
    torch.cuda.synchronize(dev)
    k_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lp = fbs.fb_scans_plain(*lops)
    torch.cuda.synchronize(dev)
    p_s = time.perf_counter() - t0
    f_err = compare_scans(lk, lp, lops[4], "phone-loop FB")
    del lk, lp
    nnz = int((lops[1] > LZERO / 2).sum())
    log(f"phone loop of {comp.n_models:,} models: Q = {Q:,} states, "
        f"{nnz:,} live cells, built in {loop_s:.2f} s on the host; logA "
        f"{4 * Q * Q / 2**20:.0f} MiB, the kernel's live-cell lists "
        f"{16 * Q * Q / 2**20:.0f} MiB and xi {4 * Q * Q / 2**20:.0f} MiB "
        f"a launch, scan shared memory {fbs.scan_smem(Q, False)} bytes "
        f"(state vectors and offsets {fbs.smem_bytes(Q, 1, 0)}; lists from "
        f"global memory); "
        f"fb_scans kernel == plain on utterance 0 (T={scores.shape[0]}; "
        f"max |d| {f_err:.3g}; kernel {k_s * 1e3:.1f} ms, plain "
        f"{p_s * 1e3:.1f} ms, one call each, synchronised)")
    reset_counts()
    t0 = time.perf_counter()
    _a, objs = nnet.train_ann_sequence(
        ann, comp, feats, names, nnet.SGDConfig(
            lr=grab["cfg"].lr * 0.1, momentum=grab["cfg"].momentum,
            batch_size=grab["cfg"].batch_size), n_iters=2, device=dev)
    torch.cuda.synchronize(dev)
    seq_s = time.perf_counter() - t0
    seq_n = fbs.KERNEL.launches
    if seq_n != 2 * 2 * SEQ_UTTS or not all(np.isfinite(objs)):
        raise AssertionError(f"sequence training: {seq_n} fb_scans "
                             f"launches, objectives {objs}")
    log(f"CRITERION = MMI on {SEQ_UTTS} utterance(s) ({card}): _gamma_phys Q "
        f"= {Q:,}, fb_scans launches {seq_n} (numerator and denominator "
        f"per utterance, two passes), MMI objective {objs[0]:.2f} before, "
        f"{objs[1]:.2f} after one iteration ({'risen' if objs[1] > objs[0] else 'not risen'}); "
        f"{seq_s:.2f} s")
    return hk["launches"], d_err, f_err, seq_n


ADAPT_MASK = "utt0%*"  # phase 27: speakers "0" (utt000-009), "1" (-015)
ADAPT_SPEAKERS = {"0": 10, "1": 6}
RC_CLASSES = 8  # phase 27: HHEd RC's regression classes
XF_ATOL = 1e-2  # phase 27's TMFs, card against CPU path, of each scale


def adapt_groups(sysm):
    """{speaker: [(feature path, phone names)]} under ADAPT_MASK."""
    mlf = MLF.load(sysm.train_mlf)
    groups = {}
    for path in sysm.feats:
        stem = os.path.splitext(os.path.basename(path))[0]
        groups.setdefault(adapt.speaker_from_mask(ADAPT_MASK, path), []
                          ).append((path, mlf.lookup(f"*/{stem}.lab").names()))
    sizes = {k: len(v) for k, v in groups.items()}
    if sizes != ADAPT_SPEAKERS:
        raise AssertionError(f"-h {ADAPT_MASK}: speakers {sizes}, expected "
                             f"{ADAPT_SPEAKERS}")
    return groups


def host_batches(comp, utts) -> int:
    """FB batches of one accumulation pass of the host-composite Trainer
    (HERest -K's) over [(feature path, phone names)]."""
    return len(make_batches([prepare_utterance(
        comp, p, read_htk_file(p).data, names) for p, names in utts],
        HEREST_BATCH))


def xf_close(got_dir, ref_dir, what) -> float:
    """Two directories of single-transform TMFs: the same files, A and b
    within XF_ATOL of each array's scale; returns the max |diff|."""
    names = sorted(os.listdir(ref_dir))
    if sorted(os.listdir(got_dir)) != names:
        raise AssertionError(f"{what}: TMFs {os.listdir(got_dir)} against "
                             f"{names}")
    err = 0.0
    for n in names:
        (_g, xg), (_r, xr) = (adapt.load_tmf(os.path.join(d, n))
                              for d in (got_dir, ref_dir))
        for a, b in ((xg.A, xr.A), (xg.b, xr.b)):
            e = float(np.abs(a - b).max())
            if e > XF_ATOL * max(float(np.abs(b).max()), 1.0):
                raise AssertionError(f"{what}: {n} differs by {e}")
            err = max(err, e)
    return err


def adapt_herest(sysm, out, cfg_text, mmf, where, dev):
    """HERest -K on `where` over the 16 utterances with -h ADAPT_MASK:
    (wall, fb_scans launches, fb_scans launches inside each
    mix_posteriors_utterance call, host seconds in the CMLLR statistics
    and estimates, peak device memory)."""
    cfg = out + ".cfg"
    with open(cfg, "w") as f:
        f.write(cfg_text)
    os.makedirs(out)
    real = herest.mix_posteriors_utterance
    per_call, host = [], []

    def counted(*a, **k):
        n0 = fbs.KERNEL.launches
        r = real(*a, **k)
        per_call.append(fbs.KERNEL.launches - n0)
        return r

    argv = ["-C", cfg, "-h", ADAPT_MASK, "-I", sysm.train_mlf, "-H", mmf,
            "-K", out, "-S", sysm.train_scp, sysm.hmmlist]
    herest.mix_posteriors_utterance = counted
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        with tool_device(where), \
                timed_calls(adapt, "cmllr_stats_from_gammas", host), \
                timed_calls(adapt, "estimate_cmllr", host):
            t0 = time.perf_counter()
            rc = herest.run(argv)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
    finally:
        herest.mix_posteriors_utterance = real
    if rc != 0:
        raise RuntimeError(f"HERest -K on {where} returned {rc}")
    return (wall, fbs.KERNEL.launches, per_call, sum(host),
            torch.cuda.max_memory_allocated(dev))


def adapt_hvite(sysm, root, xf_dir, tag, where, dev):
    """HVite -J xf_dir -h ADAPT_MASK on `where`: (wall, decode_scan
    launches, rec.mlf bytes)."""
    mlf = os.path.join(root, f"rec_{tag}_{where}.mlf")
    cfg = os.path.join(root, "hvite.cfg")
    argv = ["-C", cfg, "-w", sysm.wdnet, "-J", xf_dir, "-h", ADAPT_MASK,
            "-H", sysm.hmmdefs, "-i", mlf, "-s", str(LM_SCALE), "-p",
            str(WORD_PEN), "-S", sysm.scp, sysm.dict, sysm.hmmlist]
    reset_counts()
    with tool_device(where):
        t0 = time.perf_counter()
        rc = hvite.run(argv)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"HVite -J ({tag}) on {where} returned {rc}")
    return wall, ds.KERNEL.launches, _rec_rows(mlf)


def phase_adapt(sysm, root, net, comp, card, dev):
    """Speaker adaptation on the config-4 system at full width, the 16
    utterances as two speakers (-h ADAPT_MASK: 10 and 6):

      - HERest -K CMLLR (BLOCKS 3) on the card and on the CPU path: the
        TMFs' A and b within XF_ATOL of scale; on the card one accumulation
        pass (its host-composite FB batches) and one fb_scans launch in
        each of the 16 mix_posteriors_utterance calls; the host seconds
        of the float64 CMLLR statistics and estimates beside the wall;
        peak device memory;
      - HHEd RC 8, then HERest -K MLLRMEAN through the base classes
        (BASECLASS; a regression-class TMF a speaker): on the card, the
        accumulation pass and one more a speaker;
      - HVite -J -h with each kind, on the card and on the CPU path:
        rec.mlf equal; decode_scan launches one a bucket for CMLLR (the
        features transformed on the host), one an utterance for MLLR
        (the set adapted a speaker); the walls;
      - HDecode -J -h with the CMLLR TMFs on the card and on the CPU path
        (the LV loop, one pass-1 batch a speaker): rec.mlf equal, one
        maxplus launch a padded frame of each speaker's batch;
      - on utt000, CMLLR-transformed, the fb_scans kernel against its
        plain version (its composite's OutP), and the decode_scan kernel
        against its plain version on the network's OutP under the
        speaker's MLLR parameters (model_params).

    Returns (launches {kernel: n}, max |d| of fb_scans, of decode_scan)."""
    groups = adapt_groups(sysm)
    with open(os.path.join(root, "hvite.cfg"), "w") as f:
        f.write(f"HREC: DECODEBATCH = {DECODEBATCH}\n")
    cmllr_cfg = "HADAPT: TRANSKIND = CMLLR\nHADAPT: BLOCKS = 3\n"
    runs = {w: adapt_herest(sysm, os.path.join(root, f"xf_cmllr_{w}"),
                            cmllr_cfg, sysm.hmmdefs, w, dev)
            for w in ("cuda", "cpu")}
    wall, n_fb, per_call, host_s, peak = runs["cuda"]
    acc_batches = host_batches(comp, [u for g in groups.values()
                                      for u in g])
    if per_call != [1] * N_UTTS or n_fb != acc_batches + N_UTTS:
        raise AssertionError(f"HERest -K CMLLR: fb_scans launched {n_fb} "
                             f"times ({per_call} inside the posterior "
                             f"calls), expected {acc_batches} + one in each "
                             f"of {N_UTTS} calls")
    xf_card = os.path.join(root, "xf_cmllr_cuda")
    xf_err = xf_close(xf_card, os.path.join(root, "xf_cmllr_cpu"),
                      "HERest -K CMLLR card vs CPU")
    log(f"HERest -K CMLLR (BLOCKS 3, -h {ADAPT_MASK}: 2 speakers) on "
        f"{card}: rc 0 in {wall:.3f} s (CPU path {runs['cpu'][0]:.3f} s); "
        f"fb_scans launches {n_fb} ({acc_batches} accumulation batches + "
        f"one in each of {len(per_call)} mix_posteriors_utterance calls); "
        f"host float64 statistics and estimates {host_s:.3f} s "
        f"({100 * host_s / wall:.1f}% of the wall); TMFs card vs CPU max "
        f"|d| {xf_err:.3g}; peak device memory {peak / 2**30:.2f} GiB")

    rc_dir = os.path.join(root, "rc")
    hed = os.path.join(root, "rc.hed")
    with open(hed, "w") as f:
        f.write(f"RC {RC_CLASSES} rtree\n")
    t0 = time.perf_counter()
    if hhed.run(["-H", sysm.hmmdefs, "-M", rc_dir, hed, sysm.hmmlist]) != 0:
        raise RuntimeError("HHEd RC returned non-zero")
    rc_wall = time.perf_counter() - t0
    rc_mmf = os.path.join(rc_dir, os.path.basename(sysm.hmmdefs))
    mwall, m_fb, m_calls, _h, m_peak = adapt_herest(
        sysm, os.path.join(root, "xf_mllr"),
        "HADAPT: TRANSKIND = MLLRMEAN\nHADAPT: BASECLASS = "
        f"{os.path.join(rc_dir, 'rtree.cls')}\n", rc_mmf, "cuda", dev)
    want = acc_batches + sum(host_batches(comp, g) for g in groups.values())
    if m_fb != want or m_calls:
        raise AssertionError(f"HERest -K MLLRMEAN: fb_scans launched {m_fb} "
                             f"times, expected {want}")
    xf_mllr = os.path.join(root, "xf_mllr")
    multi = [adapt.load_tmf_classes(os.path.join(xf_mllr, f"{k}.tmf"))
             for k in sorted(groups)]
    log(f"HHEd RC {RC_CLASSES} in {rc_wall:.3f} s; HERest -K MLLRMEAN "
        f"through its base classes on {card}: rc 0 in {mwall:.3f} s, "
        f"fb_scans launches {m_fb} (the pass and one a speaker), "
        + ", ".join(f"speaker {k}: {len(x[1])} transforms"
                    for k, x in zip(sorted(groups), multi))
        + f"; peak device memory {m_peak / 2**30:.2f} GiB")

    launches = {"fb_scans": n_fb + m_fb}
    n_buckets = -(-N_UTTS // DECODEBATCH)
    for tag, xf_dir, want in (("cmllr", xf_card, n_buckets),
                              ("mllr", xf_mllr, N_UTTS)):
        k = adapt_hvite(sysm, root, xf_dir, tag, "cuda", dev)
        c = adapt_hvite(sysm, root, xf_dir, tag, "cpu", dev)
        if k[1] != want:
            raise AssertionError(f"HVite -J ({tag}): decode_scan launched "
                                 f"{k[1]} times, expected {want}")
        if k[2] != c[2]:
            raise AssertionError(f"HVite -J ({tag}): the card's rec.mlf "
                                 "differs from the CPU run's")
        launches[f"decode_scan {tag}"] = k[1]
        log(f"HVite -J -h ({tag.upper()}) on {card}: rc 0 in {k[0]:.3f} s "
            f"(CPU path {c[0]:.3f} s), decode_scan launches {k[1]}, rec.mlf "
            f"== the CPU run's")

    hd = {}
    for where in ("cuda", "cpu"):
        mlf = os.path.join(root, f"rechd_xf_{where}.mlf")
        reset_counts()
        with tool_device(where), contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            rc = hdecode.run(["-w", sysm.lm, "-s", str(LM_SCALE), "-p",
                              str(WORD_PEN), "-J", xf_card, "-h", ADAPT_MASK,
                              "-i", mlf, "-H", sysm.hmmdefs, "-S", sysm.scp,
                              sysm.dict, sysm.hmmlist])
            torch.cuda.synchronize(dev)
            hd[where] = (time.perf_counter() - t0, mp.KERNEL.launches,
                         _rec_rows(mlf))
        if rc != 0:
            raise RuntimeError(f"HDecode -J on {where} returned {rc}")
    lens = dict(zip(sysm.feats, sysm.n_frames))
    want = sum(pad_T([lens[p] for p, _n in g]) for g in groups.values())
    if hd["cuda"][1] != want or hd["cuda"][2] != hd["cpu"][2]:
        raise AssertionError(f"HDecode -J: maxplus launched "
                             f"{hd['cuda'][1]} times (expected {want}), "
                             f"rec.mlf equal: {hd['cuda'][2] == hd['cpu'][2]}")
    launches["maxplus"] = hd["cuda"][1]
    log(f"HDecode -J -h (CMLLR) on {card}: rc 0 in {hd['cuda'][0]:.3f} s "
        f"(CPU path {hd['cpu'][0]:.3f} s), maxplus launches {want} (one a "
        f"padded frame of each speaker's batch), rec.mlf == the CPU run's")

    # kernel == plain on one adapted utterance
    path, names = groups["0"][0]
    _n, xf = adapt.load_tmf(os.path.join(xf_card, "0.tmf"))
    x = xf.apply_to_features(read_htk_file(path).data).astype(np.float32)
    tr = Trainer(comp, device=dev)
    arrs = {k: torch.as_tensor(v, device=dev) for k, v in pad_batch(
        [prepare_utterance(comp, path, x, names)], comp.n_states).items()}
    outp = _fb_outp(arrs["feats"], arrs["comp_state"], arrs["q_mask"],
                    **tr.params(),
                    slot_blocks=tuple(comp.slot_blocks) or None)[0]
    ops = (outp, arrs["logA"], arrs["a0"], arrs["aE"],
           arrs["t_real"].to(torch.int32))
    f_err = compare_scans(fbs.fb_scans_cuda(*ops), fbs.fb_scans_plain(*ops),
                          ops[4], "fb_scans on CMLLR-adapted utt000")
    chain = load_input_transforms([xf_mllr])["0"]
    _x, params = chain_model_params(comp, chain, x, (comp.means,
                                                     comp.variances))
    scores = dec.scorer_with(comp, dev, model_params=params)(
        torch.as_tensor(x, device=dev))
    d_err = decode_hold(net, scores, (LM_SCALE, WORD_PEN),
                        "decode_scan on utt000 under CMLLR features and "
                        "its speaker's MLLR classes")
    log(f"adapted utt000 ({x.shape[0]} frames, Q={outp.shape[2]}): fb_scans "
        f"kernel == plain (max |d| {f_err:.3g}), decode_scan kernel == plain "
        f"(max |d| {d_err:.3g})")
    return launches, f_err, d_err


def phase_full(card, dev):
    """The twin of recipes/full/run_full.sh (recipes/full.py) at the
    default corpus size in a temporary directory: every stage's wall,
    %Corr and %Acc; check_results.py's rule (fails the phase when a
    stage falls more than TOL below results_expected.md); the
    decode_scan, fb_scans and maxplus launches of the whole chain.
    Returns those launches."""
    work = tempfile.mkdtemp(prefix="chip_full_")
    try:
        reset_counts()
        t0 = time.perf_counter()
        walls, rows = full.run_chain(work, quiet=True)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    n = {"decode_scan": ds.KERNEL.launches, "fb_scans": fbs.KERNEL.launches,
         "maxplus": mp.KERNEL.launches}
    log(f"full recipe twin on {card}: every stage of run_full.sh in "
        f"{wall:.2f} s; " + "; ".join(
            f"{k} %Corr {c:.2f} %Acc {a:.2f} (expected >= "
            f"{full.EXPECTED[k][1] - full.TOL:.2f})"
            for k, (c, a) in rows.items())
        + f"; launches {n}; " + ", ".join(f"{lab} {s:.3f} s"
                                          for lab, s in walls))
    bad = full.check(rows)
    if bad:
        raise AssertionError("full recipe: " + "; ".join(bad))
    if not (n["decode_scan"] and n["fb_scans"]):
        raise AssertionError(f"full recipe: launches {n}")
    return n


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
        big, bnet = big_system(dev)
        done("20k system set-up")
        sm_launches, big_exact = phase_big_main(big, bnet, dev)
        sm_err, bbatch, bWE, fails = phase_big_real_batch(bnet, big.comp,
                                                          big.feats, dev)
        paths, rtabs, wtabs, bops, lops = phase_xw_paths(bnet, bWE, dev)
        done("20k factored LV decoder and xw paths")
        phase_trigram(dev)
        done("5k trigram guidance")
        xt = phase_big_timing(big, bnet, bbatch, bWE, paths, lops, fails,
                              card, dev)
        done("20k timing")
        # the alignment, HInit/HRest, HDecode and LV lattice phases run
        # after every earlier profile: once the alignment's ~80,000
        # launches have run, the card's torch.profiler has lost the device
        # records of later sessions
        demo_launches = phase_demo(card, dev)
        done("demo twin")
        aligned, _aw, align_core = phase_align(sysm, root, comp, card, dev)
        align_profile(*align_core, card, dev)
        hr_launches = phase_hinit_hrest(sysm, root, aligned, card, dev)
        done("HVite -a, HInit and HRest")
        hd_launches = phase_hdecode(sysm, root, card, dev)
        done("HDecode")
        lat_launches = phase_big_lattice(big, bnet, big_exact, dev)
        done("20k lattices")
        mmi_launches, mmi_err, arc_times, arc_bound = phase_hmmirest(
            sysm, root, card, dev)
        done("HMMIRest")
        dnn_launches, dnn_derr, dnn_ferr, seq_launches = phase_dnn(
            sysm, root, card, dev)
        done("DNN hybrid")
        ad_launches, ad_ferr, ad_derr = phase_adapt(sysm, root, net, comp,
                                                    card, dev)
        done("adaptation")
        full_launches = phase_full(card, dev)
        done("full recipe twin")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    dbound = decode_bound(TIMING_B, TIMING_T, net.n_states, net.n_nodes,
                          net.band.shape[0])
    fbound = fb_bound(fb_ops[0], fb_ops[1], fb_ops[4])
    mbound = maxplus_bound("maxplus", *WEs[:, 0].shape)
    tbound = maxplus_bound("tropical", *tr_ops[0].shape)
    xb = xw_bounds(bnet, bWE, rtabs, wtabs, bops, lops)
    log(f"earlier paths: HCopy card vs CPU max |diff| {fe_err[0]:.3g}, mean "
        f"{fe_err[1]:.3g}; HVite -z decode_scan launches {z_launches}")
    log(f"earlier paths: fb_scans launches under HRest {hr_launches}; "
        f"maxplus launches under HDecode {hd_launches}; segmax launches "
        f"under the 20k lattice batch (exact) {lat_launches}; decode_scan "
        f"launches under the demo's HDecode stage {demo_launches[2]}")
    log(f"new paths on {card}: fb_scans launches under the config-4 "
        f"HMMIRest {mmi_launches}, under the demo's HMMIRest "
        f"{demo_launches[3]}, under the sequence criterion {seq_launches}; "
        f"decode_scan launches under the config-4 HVite -N {dnn_launches}, "
        f"under the demo's HVite -N {demo_launches[4]} (the whole demo: "
        f"decode_scan {demo_launches[0]}, fb_scans {demo_launches[1]}); "
        f"fb_scans at the arc shape {arc_times[0]:.6f} ms a launch (plain "
        f"{arc_times[1]:.6f}, bound {arc_bound[0]:.6f} by "
        f"{arc_bound[1]}); kernel against plain at the new shapes: max "
        f"|d| decode_scan {max(dnn_derr, demo_launches[5]):.3g}, fb_scans "
        f"{max(mmi_err, dnn_ferr, demo_launches[6]):.3g}")
    log(f"adaptation paths on {card}: launches under phase 27 "
        f"{ad_launches}, under the full recipe twin {full_launches}; "
        f"kernel against plain on adapted inputs: max |d| fb_scans "
        f"{ad_ferr:.3g}, decode_scan {ad_derr:.3g}")
    log(f"chip_smoke: {time.perf_counter() - t_all:.1f} s in all")
    log(card)
    xs = "htk_tpu_torch/csrc/xw_gather.cu"
    print(json.dumps({"kernels": [
        kernel_entry("decode_scan", "htk_tpu_torch/csrc/decode_scan.cu",
                     "htk_tpu/ops/decode_pallas.py:137", launches,
                     max(err, e2, dnn_derr, demo_launches[5], ad_derr),
                     (kms, pms),
                     dbound),
        kernel_entry("fb_scans", "htk_tpu_torch/csrc/fb_scans.cu",
                     "htk_tpu/ops/fb_pallas.py:127", fb_launches,
                     max(fb_err, fb_err2, mmi_err, dnn_ferr,
                         demo_launches[6], ad_ferr), (fkms, fpms), fbound),
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
