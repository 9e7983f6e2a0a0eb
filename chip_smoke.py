"""Smoke run of the PyTorch port on one NVIDIA GPU: HCopy's frontend,
HVite -w recognition and -z lattices, live mode (the streaming decoder,
HVite live, HCopy live capture), HVite -a forced alignment, HERest,
HInit and HRest training, HMMIRest (MMI), the DNN hybrid (HNTrainSGD,
HNForward, HVite -N), HDecode with LV lattices, speaker adaptation
(HERest -K, HHEd RC, HVite and HDecode -J), FULLC, DISCRETE and -r
training, discrete recognition and HQuant, the demo chain of
run_demo.sh and the full recipe of run_full.sh, every stage, the
uniform-row LV decoder, dense and factored, with its lattices, and the
host runtime in C++ (the ARPA codec, the `_C` corpus loader and the MLF
scanner).

Drives htk_tpu_torch's main paths, `htk_tpu_torch.tools.hcopy.run`,
`htk_tpu_torch.tools.hvite.run` (-w, -z, -a), `tools.herest.run`,
`tools.hinit.run`, `tools.hrest.run`, `tools.hdecode.run`,
`tools.hmmirest.run`, `tools.hntrainsgd.run`, `tools.hnforward.run`,
`hvite.run` -N, `hhed.run` RC, `herest.run` -K, `hvite.run` and
`hdecode.run` -J, `herest.run` on FULLC and DISCRETE sets and -r,
`hvite.run` on a DISCRETE set, `hquants.run`, `hhed.run` HK,
`recipes.demo.run_chain`, `recipes.full.run_chain`,
`algo.stream_decode.StreamingDecoder`, `hvite.run` live, `hcopy.run`
with a live source, and `algo.decode.decode_batch` and
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
     printed; the six kernels (htk_tpu_torch/csrc/decode_scan.cu,
     fb_scans.cu, maxplus.cu, xw_gather.cu, lv_step.cu and lstmp_cell.cu)
     are built from source with nvcc, and the two host libraries
     (htk_tpu_torch/native/htkio.cpp and htknative.cpp) with g++, in
     parallel
  2. the decode kernel against its plain torch version on random nets
     (several seeds, B > 1, a tie-heavy integer-score case), each at the
     full grid and at forced grids of 1, 2, 3 and 7 blocks
  3. the FB scans kernel against its plain version on random composites
     (two seeds, B = 4; banded at Q = 50, 250 and 1,100 and dense at
     Q = 250 and 1,100, whose live-cell lists do not fit shared memory;
     rows with t_real < T and t_real = 0; no beam (the two scans in
     separate blocks), a loose beam, one that kills some rows and one
     that kills all), each on both designs (path="narrow" and "wide");
     xi exactly 0 on every dead cell
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
     max_active=128; one lv_step launch a padded frame and no other
     kernel (the guided leg's scatters are torch ops), which the counts
     show
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
     phone loop (every emitting state of the set: B = 1, Q = 10,332, T
     of utterance 0) through fb_scans' wide design (fb_plan's choice)
     and, once, its narrow design forced by path=, each == plain (xi
     too); the wide launch's time without xi (CUDA events around 10
     launches, 3 samples), its tables, scan and xi device times (CUDA
     events between its parts), the narrow and plain times, beside
     fb_bound without xi (the timed launch's work) and with it; a random
     sparse composite at Q = 20,480 (B = 1, T = 64, past the narrow
     design's limit) through fb_scans, == plain; the sequence criterion
     (CRITERION = MMI) on 4 utterances: 16 fb_scans launches (numerator
     and denominator an utterance, two iterations: the second's E step
     scores the first's update) and the objective before and after one
     iteration
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
 29. HTK's other set kinds on the config-4 system at full width: the
     set converted to FULLC (each precision diag(1 / var)), HERest one
     iteration over the 16 (-v 1.0: a diagonal loading that keeps
     covariances from a few frames invertible; two fb_scans launches an
     utterance); on the first 4 (the CPU path takes over a minute a
     pass of the 16) -p 1 on the card and the CPU path, the
     accumulators and sidecars within 1e-2 of scale, -p 0 over each
     (its sidecar read), the MMFs within the herest tolerances and the
     precisions within 1e-3 of scale, HERest -K MLLRMEAN on each, the
     TMFs within 1e-2 of scale; HVite -J with the card's TMF (one
     decode_scan launch an utterance);
     HQuant -n 1 256 over the 16, HHEd HK DISCRETEHS, HCopy _V, HERest
     on the card and the CPU path (tables within one DPROB step, one
     fb_scans launch a batch) and HVite over the bigram net (rec.mlf
     equal, one decode_scan launch an utterance); HERest -r over a
     paired script whose second channel is a seeded affine map of the
     frames at 39 and 26 dims, card vs CPU at the herest tolerances but
     means and variances within 1e-2 of scale (they are ratios of the
     accumulators, which part by that much); fb_scans kernel == plain on a FULLC
     utterance, a discrete batch and a -r batch, decode_scan kernel ==
     plain on an utterance's discrete state scores; each tool's wall,
     launches, host share (fullcov_update) and peak device memory
 30. live mode: (a) decode_scan with a carried state (`init`, `t0`) over
     chunks of 32 frames on two random nets (B = 4, T = 96, one
     tie-heavy) and the longest config-#4 utterance (B = 1, T = 512):
     the kernel == its plain version over the same chunks == one
     unchunked launch == the chunked kernel at a forced grid of 2 blocks,
     bit for bit, and the plain chunked run == the plain unchunked one;
     the live chunk's time (B = 1, T = 32, from a carried state), kernel
     and plain in turns, beside its bound; (b) the 16 utterances through
     `StreamingDecoder` fed 1-79 frames at a time: words and times ==
     phase 5's batch HVite, one decode_scan launch a chunk (the sum of
     ceil(T / 32)), the stream's xRT and peak memory; an instrumented
     pass splits a chunk into OutP, the launch and the record copy
     (median and p95) and times partial_result() at the end of the
     longest utterance; (c) on phase 28's files, the set retrained at
     ENORMALISE = F (HCopy and two HERest passes: live mode refuses
     ENORMALISE), HVite live replays a test utterance on the card: one
     launch a chunk, live.mlf == the CPU path's (`python -m
     htk_tpu_torch.tools.hvite`, HTK_TPU_TORCH_DEVICE=cpu) == batch
     HVite's on the file, words against the transcription
     (informational), the wall a second of audio; (d) HCopy live capture
     (SOURCEKIND = HAUDIO) of 4 test utterances, card vs CPU within the
     frontend tolerances
 31. multi-device: (a) in one process, a one-rank NCCL group (a file://
     rendezvous) and its mesh; ShardedTrainer and Trainer over the 16
     utterances with host composites (HERest's DEVICECOMPOSITE = F
     path), in turns, under torch's deterministic algorithms: the
     accumulators equal bit for bit, one fb_scans launch a FB batch (2),
     the walls; (b) fb_scans on a padded shard (5 utterances and 3 rows
     at t_real = 0, as pad_batch(pad_to=) makes them on a rank): kernel
     == plain, the padding rows' logP LZERO and xi 0, the accumulators
     through the kernel against the plain scans'; (c) fb_time_sharded on
     a one-rank mesh against the port's serial scans, on the longest
     utterance cut to 504 frames and on the first four utterances joined
     (transcripts and features, about 1,900-2,000 frames), at
     tests/test_timeshard.py's tolerances: the walls of the call, of its
     block operator and its rescans, of the serial scans, and the peak
     device memory; (d) two gloo ranks on the one card, when gloo takes
     CUDA tensors (else a line with its error): ShardedTrainer at 4
     utterances a rank against (a)'s Trainer within rtol/atol 5e-5, and
     fb_time_sharded at D = 2 on (c)'s long utterance against the serial
     scans in float64: alphas, betas and logP each no further off than
     twice the float32 serial scans' own gap plus the test's tolerance
     (at |logP| ~1e5 a float32 step is 8e-3, so the float32 serial scans
     part from exact values by more than the test's 2e-3), and xi against
     xi_scan of its own gathered alphas, betas and logP at the test's
     tolerances (at this length xi carries each float32 result's drift
     of LSE(alpha_t + beta_t) from logP, the serial scans' too); then
     `dryrun_multichip(1)` in the one-rank group (fb_scans and
     decode_scan launches)
 32. the host runtime in C++ (htk_tpu_torch/native: htkio.cpp and
     htknative.cpp, built with g++ in phase 1 beside the kernels, their
     build seconds printed): (a) a 20,000-word trigram ARPA (about 43 MB:
     1,000,000 bigrams, 500,000 trigrams, from a seed, over the 20k
     system's words), 8 bigram and 8 trigram lines planted twice with
     other values, through the codec (`native.parse_arpa`, `read_arpa`)
     and through its plain version in Python (`native.parse_arpa_plain`):
     packs exactly equal, duplicates included; `compile_lv_loop` over the
     20k system from each, every table exactly equal; each planted bigram
     reaching the loop as its two lines; the codec LM's dicts equal to
     the Python reader's (`read_arpa_plain`); the walls of each; (b) 2,000
     MFCC_E_D_A_Z_C files (500 x 39, from a seed) through
     `preload_corpus` and through `open_speech_file` a file at a time:
     every file covered, bit for bit the codec's float32 (q + B) / A, and
     within one float32 rounding of the per-file reader (which divides in
     float64: the count of values that differ is printed), with both
     walls; (c) the MLF structure scanner against the pure parse on
     config #4's train.mlf and the corpus's MLF, with both walls; (d)
     HVite and HERest's first iteration, preload on, over config #4's
     files (float, which preload leaves alone): rec.mlf byte for byte
     phase 5's, the MMF within 1e-5 of scale of phase 6's (the card's
     atomic float32 sums land in another order from run to run; whether
     the bytes are equal is printed); then over a _C copy of them (all
     preloaded) against the same tools reading per file: words and times
     equal, scores within 1e-4 relative and the MMFs within 1e-2 of each
     array's scale (the features part by a float32 rounding). Every wall
     is labelled with the card's name and power limit
 33. (run after phase 12, on its system) the uniform step's kernel
     (csrc/lv_step.cu, ops/lv_step.py) against the plain step at the
     hdecode cells' shape: 13 utterances of the 20k system (C = 20,000
     rows of S = 16, its band), padded to 512 frames, the exact factored
     leg without a beam: v, the records and the three planes bit for bit;
     one segmax and one step launch a frame; then, in turns plain/kernel/
     kernel/plain, the step kernel's device time a launch (CUDA events
     over 100 launches of one frame) against its byte floor and against
     the plain step a frame with segmax's output given (the same
     function), and the whole frame loop's time a frame (a whole batch,
     segmax and the kernel against the plain step with segmax)
 34. (after 33) the LSTMP cell's kernel (csrc/lstmp_cell.cu,
     ops/lstmp.py) against its plain version at the hybrid LSTMP cell's
     shape (B = 13 rows, n_c = 832 cells; also B = 8, the last batch, and
     B = 1) on seeded operands, bit for bit; in turns plain/kernel/
     kernel/plain, its device time a launch (CUDA events over 100
     launches) against its byte floor and the plain cell's time; then one
     whole LSTMP layer (832 cells, 512 projection, from 512 inputs) over
     a batch of 13 at T = 1,280 + 5 steps (`algo/nnet._lstmp_layer`: a
     cell launch a step, the step GEMMs on cuBLAS), its time a step; then
     HDecode -N's OutP, `algo/nnet.hybrid_outp`, on an LSTMP net of the
     cell's widths (39 inputs, 3 x 832 cells, 512 projection, 9,304
     outputs, delay 5) over a padded batch of 13 at T = 1,280: its cell
     launches counted from zero (3 x 1,285, the kernels line's count) and
     its scores against the same call with the plain cell stepping
 20. one JSON line of kernels, then the device line last

Phase 19 also runs the demo's trigram HDecode stage (LBuild, HDecode
below the LV threshold: one decode_scan launch an utterance, HResults at
Acc=100.00), its decode_scan launches read around that stage.

Each main path runs with every launch count set to 0 just before it and
read just after; decode_scan's `launches` in the kernels line is the sum
over phase 5's HVite and phase 30's two paths (the stream and HVite
live), each logged apart. Tolerances, kernel against plain: maxplus, tropical,
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
import datetime
import io
import json
import math
import os
import pickle
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
import torch.distributed as dist

from htk_tpu_torch.algo import decode as dec
from htk_tpu_torch.algo.decode import (_final_records, _finalize,
                                       _net_outp, decode_operands)
from htk_tpu_torch.algo import adapt, fb_discrete, fullcov_train, nnet, viterbi
from htk_tpu_torch.algo.composite import build_composite
from htk_tpu_torch.algo.stream_decode import StreamingDecoder
from htk_tpu_torch.algo.fb import (_fb_outp, backward_scan, forward_scan,
                                   xi_scan)
from htk_tpu_torch.algo.lvnet import compile_lv_loop
from htk_tpu_torch.algo.net import compile_network, word_internal_phone_map
from htk_tpu_torch.algo.trainer import (DeviceCompositeTrainer, Trainer,
                                        UttData, _bucket, make_batches,
                                        pad_batch, prepare_utterance,
                                        prepare_utterance_ids)
from htk_tpu_torch import native
from htk_tpu_torch.io.dictionary import read_dict
from htk_tpu_torch.io import parmkind as pk
from htk_tpu_torch.io.htkfeat import read_htk_file, write_htk_file
from htk_tpu_torch.io.lm import PackedNGramLM, read_arpa, read_arpa_plain
from htk_tpu_torch.io.mlf import MLF
from htk_tpu_torch.io.mmf import load_mmf, save_mmf
from htk_tpu_torch.io.slf import read_slf, write_slf
from htk_tpu_torch.io.wavefile import read_wave
from htk_tpu_torch.models.ann import ANNModule, init_ann, load_ann
from htk_tpu_torch.models.hmmset import compile_hmmset
from htk_tpu_torch.models.proto import make_proto
from htk_tpu_torch.ops import decode_scan as ds
from htk_tpu_torch.ops import fb_scans as fbs
from htk_tpu_torch.ops import lstmp as lo
from htk_tpu_torch.ops import lv_step as lvs
from htk_tpu_torch.ops import maxplus as mp
from htk_tpu_torch.ops import tropical as trop
from htk_tpu_torch.ops import xw_gather as xg
from htk_tpu_torch.ops import xw_route, xw_window
from htk_tpu_torch.ops.dsp import (FrontendConfig, compute_features,
                                   compute_features_batch, num_frames)
from htk_tpu_torch.parallel import timeshard as tsh
from htk_tpu_torch.parallel.dryrun import dryrun_multichip, spawn_ranks
from htk_tpu_torch.parallel.mesh import (ShardedTrainer, init_distributed,
                                         make_mesh)
from htk_tpu_torch.recipes import demo, full
from htk_tpu_torch.recipes.speech import utterance_set, write_wav
from htk_tpu_torch.synth import (PARM_KIND, lv_system, random_decode_net,
                                 random_fb_operands, random_maxplus_operands,
                                 random_sparse_fb_operands,
                                 random_xw_operands, word_accuracy,
                                 write_system, write_word_mlf)
from htk_tpu_torch.tools import (hcopy, hdecode, herest, hhed, hinit,
                                 hmmirest, hnforward, hntrainsgd, hquants,
                                 hrest, hvite)
from htk_tpu_torch.tools._common import (DEVICE_ENV, open_speech_file,
                                        preload_corpus)
from htk_tpu_torch.tools._xfcli import (chain_model_params,
                                        load_input_transforms)
from htk_tpu_torch.utils.config import Config
from htk_tpu_torch.utils.logmath import LZERO, ladd_reduce

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
KERNELS = (ds.KERNEL, fbs.KERNEL, mp.KERNEL, xg.KERNEL, lvs.KERNEL,
           lo.KERNEL)
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
LV_STEP_B = 13  # phase 33: the hdecode cells' batch of utterances
LSTMP = dict(B=13, n_c=832, n_r=512, T=1280, delay=5, dim=39,
             K=9304)  # phase 34
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
SEQ_UTTS = 4  # the sequence criterion's utterances
PHONE_LOOP_LAUNCHES = 10  # phase 26: wide launches a timed phone-loop sample
WIDE_SPARSE_Q = 20480  # phase 26: a composite past the narrow design's limit
WIDE_SPARSE_SEED = 26
# phase 32: a trigram ARPA over the 20k system's words (about 43 MB) with
# bigram and trigram lines planted twice, other values the second time;
# a corpus of _C feature files (MFCC_E_D_A_Z_C, 500 x 39)
NATIVE_ARPA = dict(bigrams=1_000_000, trigrams=500_000, duplicates=8,
                   seed=32)
NATIVE_CORPUS = dict(n=2000, frames=500, dim=39, seed=33)
NATIVE_KIND = "MFCC_E_D_A_Z_C"
HVITE_SCORE_RTOL = 1e-4  # rec.mlf scores, preload against per-file on _C
HEREST_MODEL_TOL = ACC_TOL  # trained MMFs, of each array's scale
# HERest run again on the same files: its float32 sums by atomic adds on
# the card land in another order from run to run
HEREST_RERUN_TOL = 1e-5


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


def fb_bound(outp, logA, t_real, xi=True):
    """fb_scans: outp, logA, a0, aE, t_real in; alphas, betas, logP and
    (where xi) xi out. Each live cell of logA costs about five operations
    (add, max, subtract, exp, add) per step of each scan (T steps) and,
    where xi, of xi (t_real - 1 steps); each output of a reduction a log
    and an add."""
    B, T, Q = outp.shape
    nnz = (logA > LZERO / 2).sum(dim=(1, 2)).double()
    steps = 2 * T + (t_real.double() - 1).clamp(min=0) * xi
    ops = float(5 * (steps * nnz).sum()) + 4 * B * T * Q
    nbytes = 4 * (3 * B * T * Q + (1 + xi) * B * Q * Q + 2 * B * Q + 2 * B)
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
    and every xw wrapper) and the uniform step run their plain versions
    inside."""
    saved = xg.segmax, xg.gather_add, xg.lane_gather, dec._KernelScan
    xg.segmax, xg.gather_add, xg.lane_gather, dec._KernelScan = (
        xg.segmax_plain, xg.gather_add_plain, xg.lane_gather_plain,
        dec._PlainScan)
    try:
        yield
    finally:
        xg.segmax, xg.gather_add, xg.lane_gather, dec._KernelScan = saved


@contextlib.contextmanager
def fixed_segmax(out):
    """segmax gives `out` inside and launches nothing: the plain step's
    exact leg is then the back-off max and `out`, which is lv_step's
    function."""
    saved = xg.segmax
    xg.segmax = lambda *args, **kw: out
    try:
        yield
    finally:
        xg.segmax = saved


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
    if not all(native.library_path(n).startswith(here + os.sep)
               for n in ("htkio", "htknative")):
        raise RuntimeError(f"chip_smoke: htk_tpu_torch is not the checkout's "
                           f"own ({native.__file__}, not under {here})")
    t0 = time.perf_counter()
    builds = [k.build for k in KERNELS] + [native.get_htkio,
                                           native.get_arpa_lib]
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda build: build(), builds))
    log(f"kernel and host runtime builds: {time.perf_counter() - t0:.2f} s "
        "in parallel (" + ", ".join(
            [f"{k.name} nvcc {k.build_seconds:.2f} s" for k in KERNELS]
            + [f"{n} g++ {native.BUILD_SECONDS[n]:.2f} s"
               for n in ("htkio", "htknative")]) + ")")
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
                p = fbs.fb_scans_plain(*args, beam=beam)
                plan = fbs.fb_plan(*args[0].shape, beam)
                for path in ("narrow", "wide"):
                    what = (f"random FB Q={Q} {layout} seed={seed} "
                            f"beam={beam} {path}")
                    k = fbs.fb_scans_cuda(*args, beam=beam, path=path)
                    torch.cuda.synchronize(dev)
                    e = compare_scans(k, p, args[4], what)
                    if not bool((k[3][args[1] <= LZERO / 2] == 0).all()):
                        raise AssertionError(f"{what}: xi not 0 on a dead "
                                             "cell")
                    dead = int((p[2] <= LZERO / 2).sum())
                    nnz = int((args[1] > LZERO / 2).sum(dim=(1, 2)).max())
                    where = ("" if path == "wide" else ", lists in " + (
                        "shared" if fbs.lists_in_smem(args[1], beam is not
                                                      None) else "global")
                        + " memory")
                    log(f"{what}{' (fb_plan)' if path == plan else ''} "
                        f"({nnz} live cells{where}): agree (max |d| "
                        f"{e:.3g}; {dead} of {len(p[2])} rows without a "
                        f"path)")
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


def lv_step_bound(B, C, S, K):
    """lv_step: v, the 32-bit records and the frame's scores in and v and
    the records out, (B, Ns) each; the band, a0, aE (Ns,), bonus, uni, bow
    (C,) and the explicit leg's planes (B, C) in; the three planes' frame,
    the word-end copy and the back-off keys out. Per state an add and a
    compare for each band shift, the entry's two adds and compare, the
    score's add, the word end's add and compare."""
    Ns = C * S
    nbytes = (20 * B * Ns + 4 * (K + 2) * Ns + 12 * C + 8 * B * C
              + 16 * B * C + 8 * B)
    return bound("lv_step", nbytes, B * Ns * (2 * K + 6))


def phase_lv_step(big, net, card, dev):
    """The uniform step's kernel against the plain step at the hdecode
    cells' shape (phase 33): a batch of LV_STEP_B utterances of the 20k
    system, the exact factored leg, no beam. Returns the launches of the
    compared loop, max |d| (0: equal bits), (kernel ms a launch, the
    plain step's ms a frame with segmax's output given: the same
    function) and the bound."""
    lm = (BIG_LM_SCALE, BIG_WORD_PEN)
    feats = big.feats[:LV_STEP_B]
    lens = [f.shape[0] for f in feats]
    T = pad_T(lens)
    fb = np.zeros((len(feats), T, feats[0].shape[1]), np.float32)
    for b, f in enumerate(feats):
        fb[b, :lens[b]] = f
    outp = _net_outp(net, big.comp, fb, "highest", dev)
    d = dec._net_dev(net, dev)
    B, _, Ns = outp.shape
    S, K = net.uniform_width, net.band.shape[0]
    args = (B, T, Ns, d["band"], d["a0"], d["aE"], S, d["bonus"],
            d["trans"] * lm[0], d["start"] * lm[0], lm[1], dec._BEAM_OFF,
            None, dec._scale_xw(d["xw"], lm[0]), None, dev)

    def loop(cls):
        scan = cls(*args)
        scan.frames(outp, 0)
        return scan

    reset_counts()
    kscan = loop(dec._KernelScan)
    torch.cuda.synchronize(dev)
    launches = (lvs.KERNEL.launches, xg.SEGMAX.launches)
    if launches != (T, T):
        raise AssertionError(f"lv_step batch: (lv_step, segmax) launched "
                             f"{launches} times, expected ({T}, {T})")
    (v, rec), planes = kscan.result()
    (vp, recp), planes_p = loop(dec._PlainScan).result()
    torch.cuda.synchronize(dev)
    for name, a, b in zip(("v", "rec", "WEs", "pwns", "pwts"),
                          (v, rec, *planes), (vp, recp, *planes_p)):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"lv_step batch: {name} differs from the "
                                 f"plain step at {int((a != b).sum())} "
                                 "places")
    log(f"lv_step batch (B={B}, T={T}, C={net.n_nodes}, S={S}, K={K}, "
        f"Ns={Ns}): kernel loop == plain loop bit for bit (v, records, "
        f"WEs, pwns, pwts); one segmax and one lv_step launch a frame")
    run = kscan.run
    x = dec._scale_xw(d["xw"], lm[0])
    t = T // 2
    exp = dec._segmax_leg(run.we_buf, x, net.n_nodes)

    def step():
        run.step(t, t, exp=exp)

    def frames(f, dv, reps=1):
        return [x / T for x in time_launches(f, dv, 1, reps)]

    def plain_step(f, dv):
        with fixed_segmax(exp):
            return frames(f, dv)

    k, p, ks, ps = in_turns(time_launches, lambda: loop(dec._PlainScan),
                            step, dev, plain_step)
    kf = frames(lambda: loop(dec._KernelScan), dev, 3)
    pf = frames(lambda: loop(dec._PlainScan), dev, 3)
    kfm, pfm = statistics.median(kf), statistics.median(pf)
    bnd = lv_step_bound(B, net.n_nodes, S, K)
    log(f"lv_step on {card}: {k:.6f} ms a launch (device, CUDA events "
        f"over {LAUNCH_LOOP} launches; {100 * bnd[0] / k:.1f}% of its "
        f"{bnd[0]:.6f}-ms bound by {bnd[1]}), the plain step with "
        f"segmax's output given (the same function) {p:.6f} ms a frame; "
        f"the whole frame (segmax and the step): kernel {kfm:.6f} ms, "
        f"plain {pfm:.6f} ms; samples " + " ".join(f"{y:.6f}" for y in ks)
        + " | " + " ".join(f"{y:.6f}" for y in ps) + " | "
        + " ".join(f"{y:.6f}" for y in kf) + " | "
        + " ".join(f"{y:.6f}" for y in pf))
    return T, 0.0, (k, p), bnd


def lstmp_cell_bound(B, n_c):
    """lstmp_cell: the two gate rows (4 n_c a batch row each), c_{t-1},
    the peepholes (3 n_c) and the bias (4 n_c) in, c_t and m_t out; about
    29 operations a (batch row, cell) (hbench/metrics/_lstmp_bounds.py
    holds the benchmark's frozen copy)."""
    return bound("lstmp_cell", 4 * (8 * B * n_c + 3 * B * n_c + 7 * n_c),
                 29 * B * n_c)


def phase_lstmp(card, dev):
    """The LSTMP cell's kernel against its plain version, its time a
    launch, a whole layer's time a step, and the main path's launches and
    scores (phase 34). Returns the cell launches of one `hybrid_outp`
    call at the cell's shape, its scores' max |d| from the plain cell's
    (0: equal bits), (kernel ms a launch, plain ms a step) and the
    bound."""
    B, n_c, n_r = LSTMP["B"], LSTMP["n_c"], LSTMP["n_r"]
    g = torch.Generator(device=dev).manual_seed(34)

    def normal(*shape, sd=1.0):
        return torch.randn(shape, generator=g, device=dev) * sd

    reset_counts()
    cells = {}
    for b in (B, 8, 1):
        gx, gr, c = normal(2, b, 4 * n_c, sd=3.0), normal(b, 4 * n_c), \
            normal(b, n_c)
        peep, bias = normal(3, n_c, sd=0.5), normal(4 * n_c)
        cell = lo.CellSteps(gx, peep, bias)
        cell.gr.copy_(gr)
        cell.c[1].copy_(c)
        cell.step(1)  # c_{t-1} in c[1], c_t into c[0]
        ct, m = lo.lstmp_cell_plain(gx[1], gr, c, peep, bias)
        torch.cuda.synchronize(dev)
        for name, a, want in (("c_t", cell.c[0], ct), ("m_t", cell.m, m)):
            if not torch.equal(a.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(
                    f"lstmp_cell B={b}: {name} differs from the plain "
                    f"cell at {int((a != want).sum())} places")
        cells[b] = (cell, (gx[1], gr, c, peep, bias))
    launches = lo.KERNEL.launches
    if launches != 3:
        raise AssertionError(f"lstmp_cell: {launches} launches, expected 3")
    log(f"lstmp_cell (n_c={n_c}; B={B}, 8, 1): kernel == plain bit for bit "
        f"(c_t, m_t), one launch a step")
    cell, ops = cells[B]
    k, p, ks, ps = in_turns(time_launches, lambda: lo.lstmp_cell_plain(*ops),
                            lambda: cell.step(1), dev)
    bnd = lstmp_cell_bound(B, n_c)
    # one whole layer of the cell's shape (its layers 2-3: 512 inputs)
    S = LSTMP["T"] + LSTMP["delay"]
    h = normal(S, B, n_r)
    w = (normal(4 * n_c, n_r, sd=4 / n_r ** 0.5),
         normal(4 * n_c, n_r, sd=0.5 / n_r ** 0.5), normal(3, n_c, sd=0.1),
         normal(4 * n_c, sd=0.1), normal(n_r, n_c, sd=0.75 / n_c ** 0.5))
    before = lo.KERNEL.launches

    def layer():
        with torch.no_grad():
            nnet._lstmp_layer(h, *w)

    lay = [x / S for x in time_launches(layer, dev, 1, 3)]
    layer_ms = statistics.median(lay)
    if lo.KERNEL.launches - before != 4 * S:
        raise AssertionError(f"lstmp layer: {lo.KERNEL.launches - before} "
                             f"cell launches over 4 calls of {S} steps")
    n, err = lstmp_main_path(dev)
    log(f"lstmp_cell on {card}: {k:.6f} ms a launch (device, CUDA events "
        f"over {LAUNCH_LOOP} launches; {100 * bnd[0] / k:.2f}% of its "
        f"{bnd[0]:.6f}-ms bound by {bnd[1]}), the plain cell {p:.6f} ms a "
        f"step; one LSTMP layer (B={B}, {n_r} in, {n_c} cells, {n_r} "
        f"projection, {S} steps) {layer_ms:.6f} ms a step ({layer_ms * S:.1f} "
        f"ms a layer); samples " + " ".join(f"{y:.6f}" for y in ks) + " | "
        + " ".join(f"{y:.6f}" for y in ps) + " | "
        + " ".join(f"{y:.6f}" for y in lay))
    return n, err, (k, p), bnd


class _PlainCellSteps(lo.CellSteps):
    """CellSteps that steps with the plain cell on the card too."""

    def __init__(self, *args):
        super().__init__(*args)
        self.on_card = False


def lstmp_main_path(dev):
    """HDecode -N's OutP on an LSTMP net of the hybrid LSTMP cell's widths
    (39 inputs, 3 layers of 832 cells and a 512 projection, 9,304 outputs,
    delay 5): `hybrid_outp` on a padded batch of 13 at T = 1,280, its
    cell launches counted from zero, against the same call with the plain
    cell stepping on the card. Returns (launches, max |d|)."""
    B, n_c, n_r, d = LSTMP["B"], LSTMP["n_c"], LSTMP["n_r"], LSTMP["delay"]
    T = LSTMP["T"]
    ann = init_ann("lstmp", LSTMP["dim"], [n_c] * 3, LSTMP["K"], context=0,
                   activation="LSTMP", projection=n_r, out_delay=d, seed=34)
    model = ANNModule(ann, dev)
    lens = np.linspace(T // 3, T, B).astype(int).tolist()
    rng = np.random.default_rng(34)
    x = np.zeros((B, T, LSTMP["dim"]), np.float32)
    for b, n in enumerate(lens):
        x[b, :n] = rng.standard_normal((n, LSTMP["dim"]))

    def outp():
        return nnet.hybrid_outp(ann, x, device=dev, model=model,
                                lengths=lens)

    reset_counts()
    got = outp()
    torch.cuda.synchronize(dev)
    n = lo.KERNEL.launches
    if n != 3 * (T + d):
        raise AssertionError(f"lstmp hybrid_outp: {n} cell launches, "
                             f"expected {3 * (T + d)}")
    real = nnet.CellSteps
    nnet.CellSteps = _PlainCellSteps
    try:
        want = outp()
    finally:
        nnet.CellSteps = real
    torch.cuda.synchronize(dev)
    if lo.KERNEL.launches != n:
        raise AssertionError("lstmp hybrid_outp: the plain cell launched "
                             "the kernel")
    rows = torch.cat([got[b, :m] - want[b, :m] for b, m in enumerate(lens)])
    err = float(rows.abs().max())
    # the kernel equals the plain cell bit for bit, so the scores do too
    # where cuBLAS repeats its GEMMs exactly; a wrong cell moves them by
    # far more than float32's rounding of the largest score
    scale = float(want.abs().max())
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    if not err <= 2.0 ** -16 * scale:
        raise AssertionError(f"lstmp hybrid_outp: kernel and plain cell "
                             f"differ by {err:.3e} (scores to {scale:.1f})")
    log(f"lstmp hybrid_outp (B={B}, T={T}, delay {d}, 3 x {n_c}/{n_r}, "
        f"{LSTMP['K']} outputs): {n} cell launches; scores "
        f"{'equal bit for bit' if same else f'within {err:.3e}'} to the "
        f"plain cell's (max |score| {scale:.1f})")
    return n, err


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
    want = pad_T([f.shape[0] for f in sysm.feats])
    n = sum(k.launches for k in COUNTS) - lvs.KERNEL.launches
    if (n or lvs.KERNEL.launches != want
            or any(r is None or not r.words for r in res)):
        raise AssertionError(f"5k trigram: {lvs.KERNEL.launches} lv_step "
                             f"launches (expected {want}) and {n} of other "
                             "kernels, or an utterance without a "
                             "transcript")
    acc = word_accuracy(sysm.truths, [r.words for r in res])
    log(f"5k trigram system (lv_system {t1 - t0:.2f} s, compile_lv_loop "
        f"{t2 - t1:.2f} s): C={net.n_nodes}, {len(x3['pair_u'])} contexts, "
        f"{len(x3['tri_j'])} trigram slots, o3max {x3['o3max']}; "
        f"decode_batch of {len(res)} at max_active={TOPA}: {wall:.3f} s, "
        f"one lv_step launch a padded frame ({want}) and no other kernel "
        f"(the guided leg is torch ops), word accuracy {acc:.2f}% "
        f"(informational); first words {res[0].words[:8]}")
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
    state scores (T, S) gathered on the net's states, at LM scale and
    word penalty `lm`: live scores within ATOL, records equal."""
    outp = scores[:, dec._net_dev(net, scores.device)["comp_state"]]
    args = decode_operands(outp[None].contiguous(), net, *lm)
    k = ds.decode_scan_cuda(*args)
    p = ds.decode_scan_plain(*args)
    torch.cuda.synchronize()
    err = compare(k, p, what)
    lo, hi = float(scores.min()), float(scores.max())
    log(f"{what}: decode kernel == plain on state scores in [{lo:.2f}, "
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
              keys=("weights", "transp", "means", "variances"), rel=1e-3):
    """tests/test_torch_herest.py's tolerances: weights and transitions
    rtol 1e-4, atol 1e-7; means and variances rtol 1e-4, atol `rel` (1e-3)
    of the array's largest magnitude. Returns the largest |diff| / scale."""
    g, r = _mmf_params(got), _mmf_params(ref)
    worst = 0.0
    for k in keys:
        scale = float(np.abs(r[k]).max())
        atol = 1e-7 if k in ("weights", "transp") else rel * scale
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


def wide_phases(ops, dev, xi=True):
    """One wide launch with CUDA events between its parts: device ms of
    the tables (count, offsets, fill), the scan grid and xi
    (its clear and kernel)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    fbs.fb_scans_cuda(*ops, xi=xi, path="wide", events=ev)
    torch.cuda.synchronize(dev)
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def phase_phone_loop(lops, card, dev) -> float:
    """fb_scans on the phone loop (B = 1, Q = 10,332 at config #4) on
    both designs: the wide one (fb_plan's) and, once, the narrow one
    forced by path=, each held against the plain version (xi too); the
    wide launch's time without xi (as _gamma_phys launches it; CUDA
    events around PHONE_LOOP_LAUNCHES launches), its parts' device times
    from CUDA events, the narrow launch's time and the plain version's,
    beside fb_bound. Returns the largest kernel error."""
    B, T, Q = lops[0].shape
    nnz = int((lops[1] > LZERO / 2).sum())
    plan = fbs.fb_plan(B, T, Q, None)
    if plan != "wide":
        raise AssertionError(f"phone loop: fb_plan chose {plan}")
    t0 = time.perf_counter()
    p = fbs.fb_scans_plain(*lops)
    torch.cuda.synchronize(dev)
    p_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p3 = fbs.fb_scans_plain(*lops, xi=False)
    torch.cuda.synchronize(dev)
    p3_s = time.perf_counter() - t0
    k = fbs.fb_scans_cuda(*lops)
    torch.cuda.synchronize(dev)
    err = compare_scans(k, p, lops[4], "phone-loop FB, wide design")
    del k
    ks = time_launches(lambda: fbs.fb_scans_cuda(*lops, xi=False), dev,
                       n=PHONE_LOOP_LAUNCHES)
    kms = statistics.median(ks)
    parts = [wide_phases(lops, dev) for _ in range(3)]
    tab, scan, xim = (statistics.median(x) for x in zip(*parts))
    t0 = time.perf_counter()
    n = fbs.fb_scans_cuda(*lops, path="narrow")
    torch.cuda.synchronize(dev)
    n_s = time.perf_counter() - t0
    err = max(err, compare_scans(n, p, lops[4],
                                 "phone-loop FB, narrow design"))
    del n, p, p3
    bms, by = fb_bound(*lops[:2], lops[4], xi=False)
    xbms, xby = fb_bound(*lops[:2], lops[4])
    log(f"phone loop on {card}: B = {B}, T = {T}, Q = {Q:,}, {nnz:,} live "
        f"cells; logA {4 * Q * Q / 2**20:.0f} MiB, the lists "
        f"{16 * Q * Q / 2**20:.0f} MiB and xi {4 * Q * Q / 2**20:.0f} MiB a "
        f"launch; fb_plan: {plan}; kernel == plain on both designs (max |d| "
        f"{err:.3g})")
    log(f"  wide design, no xi (as _gamma_phys): {kms:.3f} ms a launch "
        f"(CUDA events around {PHONE_LOOP_LAUNCHES} launches, median of 3: "
        + " ".join(f"{x:.3f}" for x in ks) + f"); with xi, device ms "
        f"tables {tab:.3f}, scan {scan:.3f}, xi "
        f"{xim:.3f} (median of 3; samples "
        + "; ".join("/".join(f"{x:.3f}" for x in ps) for ps in parts) + ")")
    log(f"  narrow design forced (path='narrow', with xi, one synchronised "
        f"call): {n_s * 1e3:.1f} ms; plain {p_s * 1e3:.1f} ms with xi, "
        f"{p3_s * 1e3:.1f} ms without (one call each); bound without xi "
        f"{bms:.6f} ms by {by} (with xi {xbms:.6f} ms by {xby}); the wide "
        f"launch without xi {kms / bms:.1f}x its bound, "
        f"{p3_s * 1e3 / kms:.1f}x faster than the plain version without "
        f"xi, {n_s * 1e3 / kms:.1f}x than the narrow design")
    return err


def phase_wide_sparse(dev) -> float:
    """A random sparse composite past the narrow design's limit (B = 1,
    T = 64, Q = 20,480, hub lists of about Q / 2), where the parent
    raised: fb_scans launches the wide design, held against plain."""
    B, T, Q = 1, 64, WIDE_SPARSE_Q
    outp, (b, i, j, v), a0, aE, tr = random_sparse_fb_operands(
        WIDE_SPARSE_SEED, B=B, T=T, Q=Q)
    logA = torch.full((B, Q, Q), LZERO, device=dev)
    logA[tuple(torch.as_tensor(x, device=dev) for x in (b, i, j))] = \
        torch.as_tensor(v, device=dev)
    ops = [torch.as_tensor(outp, device=dev), logA,
           *(torch.as_tensor(x, device=dev) for x in (a0, aE, tr))]
    if fbs.smem_bytes(Q, 1, 0) <= fbs.SMEM_MAX:
        raise AssertionError(f"Q = {Q} fits the narrow design")
    n0 = fbs.KERNEL.launches
    t0 = time.perf_counter()
    k = fbs.fb_scans(*ops)
    torch.cuda.synchronize(dev)
    k_s = time.perf_counter() - t0
    if fbs.KERNEL.launches != n0 + 1:
        raise AssertionError("Q = 20,480: fb_scans did not launch the kernel")
    t0 = time.perf_counter()
    p = fbs.fb_scans_plain(*ops)
    torch.cuda.synchronize(dev)
    p_s = time.perf_counter() - t0
    err = compare_scans(k, p, ops[4], f"sparse composite Q={Q}")
    log(f"sparse composite B = {B}, T = {T}, Q = {Q:,} ({len(b):,} live "
        f"cells; the narrow design refuses Q past 19,359): fb_scans took "
        f"the {fbs.fb_plan(B, T, Q, None)} design, kernel == plain (max |d| "
        f"{err:.3g}; kernel {k_s * 1e3:.1f} ms, plain {p_s * 1e3:.1f} ms, "
        f"one synchronised call each, xi included)")
    return err


def phase_dnn(sysm, root, card, dev):
    """The DNN hybrid on the config-4 system: HNTrainSGD (HIDDENSIZE =
    1024 1024 1024, CONTEXT = 4, -e 3) on the card and on the CPU path,
    the ANN files within TRAIN_ATOL, CE and frame accuracy per epoch,
    one epoch's wall and device busy share; HNForward of the 16 files
    with the card's ANN, .pos within POS_ATOL of the CPU's; HVite -N over
    the 16 utterances, one decode_scan launch each, rec.mlf equal to the
    CPU run's and scores within HYBRID_RTOL; decode_scan's kernel against
    its plain version on one utterance's ANN scores; then the sequence
    criterion on SEQ_UTTS utterances: fb_scans on the phone loop
    (`phase_phone_loop`) and past the narrow design's limit
    (`phase_wide_sparse`), fb_scans launches and the MMI objective before
    and after one iteration. Returns HVite -N's decode_scan launches and
    the largest kernel errors."""
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
    cs = torch.as_tensor(loop[0], device=dev).long()
    lops = (scores[:, cs][None].contiguous(),
            *(torch.as_tensor(a, device=dev)[None].contiguous()
              for a in loop[1:]),
            torch.full((1,), scores.shape[0], dtype=torch.int32, device=dev))
    log(f"phone loop of {comp.n_models:,} models built in {loop_s:.2f} s on "
        f"the host")
    f_err = phase_phone_loop(lops, card, dev)
    f_err = max(f_err, phase_wide_sparse(dev))
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
        f"= {lops[0].shape[2]:,}, fb_scans launches {seq_n} (numerator and "
        f"denominator "
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


def phase_full(work, card, dev):
    """The twin of recipes/full/run_full.sh (recipes/full.py) at the
    default corpus size in `work` (phase 30 reads its files): every
    stage's wall, %Corr and %Acc; check_results.py's rule (fails the
    phase when a stage falls more than TOL below results_expected.md);
    the decode_scan, fb_scans and maxplus launches of the whole chain.
    Returns those launches."""
    reset_counts()
    t0 = time.perf_counter()
    walls, rows = full.run_chain(work, quiet=True)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
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


SETKIND_SEED = 29  # phase 29: -r's channel-2 affine maps
RETRAIN_D2 = (39, 26)  # phase 29: -r's channel-2 widths (kinds below)
RETRAIN_KIND = {39: "MFCC_E_D_A", 26: "MFCC_E_D"}
VQ_SIZE = 256  # phase 29: HQuant -n 1 256
FULLC_LOADING = 1.0  # phase 29: FULLC HERest -v, the diagonal loading
FULLC_SHARD = 4  # phase 29: utterances of FULLC's card-vs-CPU shard
# phase 29: HERest -r's means and variances, card vs CPU, of each array's
# scale: they are the accumulators' ratios with nothing old to fall back
# on, so they carry the accumulators' gap (ACC_TOL, phase 6)
RETRAIN_TOL = ACC_TOL
DPROB_STEP = 1.0 / 2371.8  # one step of a DPROB's int16 quantisation


def fullc_from(mmf, out):
    """The set of `mmf` as FULLC (each <INVCOVAR> the diagonal precision
    diag(1 / var), as tests/test_torch_herest.py converts it), written
    binary to `out`."""
    hs = load_mmf([mmf])
    seen = set()
    for h in hs.hmms.values():
        for st in h.states:
            for m in st.streams[0].mixes:
                if m is None or id(m) in seen:
                    continue
                seen.add(id(m))
                m.var = np.diag(1.0 / m.var).astype(np.float32)
                m.cov_kind = "FULLC"
                m.fix_gconst()
    hs.cov_kind = "FULLC"
    save_mmf(hs, out, binary=True)


def setkind_tool(module, argv, where, dev, timers=()):
    """`module.run(argv)` on `where` with every launch count reset first:
    (wall s, {kernel: launches}, host seconds of each (module, name) of
    `timers`, peak device memory bytes)."""
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    host = {name: [] for _m, name in timers}
    with contextlib.ExitStack() as stack:
        stack.enter_context(tool_device(where))
        stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
        for mod, name in timers:
            stack.enter_context(timed_calls(mod, name, host[name]))
        t0 = time.perf_counter()
        rc = module.run(argv)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{module.__name__} {' '.join(argv[:4])} ... on "
                           f"{where} returned {rc}")
    return (wall, {"fb_scans": fbs.KERNEL.launches,
                   "decode_scan": ds.KERNEL.launches},
            {k: sum(v) for k, v in host.items()},
            torch.cuda.max_memory_allocated(dev))


def fullc_close(got, ref, what) -> float:
    """Two FULLC MMFs: weights, transitions and means at the herest
    tolerances (`mmf_close`), the precision matrices within 1e-3 of their
    scale (tests/test_torch_fullcov.py's); returns the worst |d| / scale."""
    worst = mmf_close(got, ref, what, keys=("weights", "transp", "means"))
    g, r = (compile_hmmset(load_mmf([p])) for p in (got, ref))
    pg, pr = (np.einsum("mde,mfe->mdf", c.fc_proj.astype(np.float64),
                        c.fc_proj.astype(np.float64)) for c in (g, r))
    scale = float(np.abs(pr).max())
    if not np.allclose(pg, pr, rtol=1e-4, atol=1e-3 * scale):
        raise AssertionError(f"{what}: precisions differ by "
                             f"{float(np.abs(pg - pr).max())}")
    return max(worst, float(np.abs(pg - pr).max()) / scale)


def accs_close(got_acc, ref_acc, what) -> float:
    """Two .acc files (and their FULLC sidecars) within ACC_TOL of each
    field's scale, as phase 6 holds accumulators; returns the worst."""
    g, r = np.load(got_acc), np.load(ref_acc)
    pairs = [(g[k], r[k], k) for k in ("occ", "sum_x", "sum_xx", "tr")]
    pairs.append((np.load(got_acc + ".fcx.npy"),
                  np.load(ref_acc + ".fcx.npy"), "sum x x^T"))
    worst = 0.0
    for a, b, k in pairs:
        e = float(np.abs(a - b).max() / np.abs(b).max())
        if e > ACC_TOL:
            raise AssertionError(f"{what}: {k} differs by {e:.3g} of scale")
        worst = max(worst, e)
    return worst


def discrete_close(got, ref, what) -> float:
    """Two DISCRETE MMFs: every table entry within one DPROB step (the
    int16 quantisation's rounding may fall either way), transitions at
    the herest tolerances; returns the table's max |d|."""
    mmf_close(got, ref, what, keys=("transp",))
    g, r = (compile_hmmset(load_mmf([p])).dprob_table for p in (got, ref))
    e = float(np.abs(g - r).max())
    if e > 1.01 * DPROB_STEP:
        raise AssertionError(f"{what}: DPROB tables differ by {e}")
    return e


def _train_utts(comp, sysm, feats_of=None):
    """The 16 utterances prepared on `comp` with host composites."""
    mlf = MLF.load(sysm.train_mlf)
    out = []
    for path in sysm.feats:
        stem = os.path.splitext(os.path.basename(path))[0]
        x = read_htk_file(path if feats_of is None else feats_of(path)).data
        out.append(prepare_utterance(comp, stem, x,
                                     mlf.lookup(f"*/{stem}.lab").names()))
    return out


def phase_fullc(sysm, root, card, dev):
    """FULLC HERest at config-#4 width: the set converted (`fullc_from`);
    one iteration over the 16 on the card (two fb_scans launches an
    utterance). Card vs CPU on the first FULLC_SHARD utterances (the CPU
    path takes over a minute a pass of the 16): -p 1 on each, the
    accumulators and sidecars within ACC_TOL, -p 0 over each .acc (its
    sidecar read), the MMFs within `fullc_close`; HERest -K MLLRMEAN on
    each (TMFs within XF_ATOL); HVite -J on the card with the card's TMF
    (one decode_scan launch an utterance); fb_scans kernel == plain on
    the first utterance's full-covariance OutP. Returns (launches, max
    |d|)."""
    d = os.path.join(root, "fullc")
    os.makedirs(d)
    mmf = os.path.join(d, "hmmdefs")
    t0 = time.perf_counter()
    fullc_from(sysm.hmmdefs, mmf)
    comp = compile_hmmset(load_mmf([mmf]))
    log(f"FULLC set written and compiled in {time.perf_counter() - t0:.2f} s "
        f"({comp.n_mix} Gaussians of {comp.dim} x {comp.dim}, "
        f"{os.path.getsize(mmf) / 2**20:.1f} MiB binary)")
    with open(sysm.train_scp) as f:
        lines = f.read().split()
    scp = {"all": sysm.train_scp, "s1": os.path.join(d, "s1.scp")}
    with open(scp["s1"], "w") as f:
        f.write("\n".join(lines[:FULLC_SHARD]) + "\n")
    timers = ((herest, "fullcov_accumulate"), (herest, "fullcov_update"))

    def run(tag, where, part, *opts, extra=(), n_utts=None):
        out = os.path.join(d, tag)
        os.makedirs(out)
        argv = ["-B", "-v", str(FULLC_LOADING), *opts, "-H", mmf, "-M", out]
        if part:
            argv += ["-S", scp[part], "-I", sysm.train_mlf]
        r = setkind_tool(herest, argv + [sysm.hmmlist, *extra], where, dev,
                         timers)
        if where == "cuda" and n_utts and r[1]["fb_scans"] != 2 * n_utts:
            raise AssertionError(f"HERest FULLC {tag}: fb_scans launched "
                                 f"{r[1]['fb_scans']} times, expected "
                                 f"{2 * n_utts}")
        return r

    def acc(tag):
        return os.path.join(d, tag, f"HER{tag[-1]}.acc")

    wall, n, host, peak = run("it", "cuda", "all", n_utts=N_UTTS)
    p1 = run("p1", "cuda", "s1", "-p", "1", n_utts=FULLC_SHARD)
    cpu1 = run("cpu1", "cpu", "s1", "-p", "1")
    run("s_card", "cuda", None, "-p", "0", extra=(acc("p1"),))
    run("s_cpu", "cuda", None, "-p", "0", extra=(acc("cpu1"),))
    e_acc = accs_close(acc("p1"), acc("cpu1"),
                       "FULLC accumulators card vs CPU")
    e_cpu = fullc_close(os.path.join(d, "s_card", "hmmdefs"),
                        os.path.join(d, "s_cpu", "hmmdefs"),
                        "FULLC card vs CPU")
    acc_s, upd_s = host["fullcov_accumulate"], host["fullcov_update"]
    log(f"HERest FULLC (-v {FULLC_LOADING}) on {card}: rc 0 in {wall:.3f} s, "
        f"fb_scans launches {n['fb_scans']} (two an utterance); "
        f"fullcov_accumulate {acc_s:.3f} s, fullcov_update (host, "
        f"{comp.n_mix} inverses) {upd_s:.3f} s ({100 * upd_s / wall:.1f}% of "
        f"the wall); peak device memory {peak / 2**30:.2f} GiB; -p 1 over "
        f"the first {FULLC_SHARD} {p1[0]:.3f} s, fb_scans launches "
        f"{p1[1]['fb_scans']} (CPU path {cpu1[0]:.3f} s), accumulators and "
        f"sidecar card vs CPU within {e_acc:.2e} of scale, their -p 0 MMFs "
        f"card vs CPU {e_cpu:.2e} (|d| / scale)")

    xf, k_run = {}, {}
    for where in ("cuda", "cpu"):
        xf[where] = os.path.join(d, f"xf_{where}")
        os.makedirs(xf[where])
        k_run[where] = setkind_tool(
            herest, ["-H", mmf, "-K", xf[where], "-S", scp["s1"], "-I",
                     sysm.train_mlf, sysm.hmmlist], where, dev)
    k_wall, k_n, _h, k_peak = k_run["cuda"]
    if k_n["fb_scans"] != 2 * FULLC_SHARD:
        raise AssertionError(f"HERest -K FULLC: fb_scans launched "
                             f"{k_n['fb_scans']} times")
    xf_err = xf_close(xf["cuda"], xf["cpu"], "HERest -K FULLC card vs CPU")
    mlf = os.path.join(d, "rec_j.mlf")
    v_wall, v_n, _h, v_peak = setkind_tool(
        hvite, ["-w", sysm.wdnet, "-J", xf["cuda"], "-H", mmf, "-i", mlf,
                "-s", str(LM_SCALE), "-p", str(WORD_PEN), "-S", sysm.scp,
                sysm.dict, sysm.hmmlist], "cuda", dev)
    if v_n["decode_scan"] != N_UTTS:
        raise AssertionError(f"HVite -J FULLC: decode_scan launched "
                             f"{v_n['decode_scan']} times, expected {N_UTTS}")
    wacc = word_accuracy(sysm.transcripts, _rec_words(mlf, sysm))
    log(f"HERest -K MLLRMEAN on the FULLC set over the first "
        f"{FULLC_SHARD} on {card}: rc 0 in {k_wall:.3f} s (CPU path "
        f"{k_run['cpu'][0]:.3f} s), fb_scans launches {k_n['fb_scans']}, "
        f"TMF card vs CPU max |d| {xf_err:.3g}, peak {k_peak / 2**30:.2f} "
        f"GiB; HVite -J on the FULLC set: rc 0 in {v_wall:.3f} s, "
        f"decode_scan launches {v_n['decode_scan']}, word accuracy "
        f"{wacc:.2f}% (informational), peak {v_peak / 2**30:.2f} GiB")

    u = _train_utts(comp, sysm)[0]
    arrs = {k: torch.as_tensor(v, device=dev)
            for k, v in pad_batch([u], comp.n_states).items()}
    p = fullcov_train._params(comp, dev)
    outp = _fb_outp(arrs["feats"], arrs["comp_state"], arrs["q_mask"],
                    **p)[0]
    ops = (outp, arrs["logA"], arrs["a0"], arrs["aE"],
           arrs["t_real"].to(torch.int32))
    f_err = compare_scans(fbs.fb_scans_cuda(*ops), fbs.fb_scans_plain(*ops),
                          ops[4], "fb_scans on a FULLC utterance")
    log(f"FULLC utterance {u.name} (T={int(ops[4][0])}, Q={outp.shape[2]}): "
        f"fb_scans kernel == plain (max |d| {f_err:.3g})")
    launches = {"fb_scans FULLC": n["fb_scans"],
                "fb_scans FULLC -p 1": p1[1]["fb_scans"],
                "fb_scans FULLC -K": k_n["fb_scans"],
                "decode_scan FULLC -J": v_n["decode_scan"]}
    return launches, f_err


def _rec_words(mlf, sysm):
    m = MLF.load(mlf)
    return [m.lookup("*/" + os.path.splitext(os.path.basename(p))[0]
                     + ".rec").names() for p in sysm.feats]


def phase_discrete(sysm, root, card, dev):
    """The HK DISCRETEHS chain at config-#4 width: HQuant -n 1 VQ_SIZE over
    the 16 utterances, HHEd HK DISCRETEHS on the tied set, HCopy _V of
    the 16, one HERest iteration on the card and on the CPU path (the
    tables within a DPROB step, transitions at the herest tolerances;
    one fb_scans launch a batch), HVite with the card's MMF over the
    Nn = 1,000 bigram net on the card and on the CPU path (rec.mlf
    byte-identical, one decode_scan launch an utterance); fb_scans
    kernel == plain on the first batch's table-lookup OutP, decode_scan
    kernel == plain on the first utterance's discrete state scores.
    Returns (launches, max |d| of fb_scans, of decode_scan)."""
    d = os.path.join(root, "disc")
    os.makedirs(d)
    vq = os.path.join(d, "cb.vq")
    t0 = time.perf_counter()
    if hquants.run(["-n", "1", str(VQ_SIZE), vq, "-S",
                    sysm.train_scp]) != 0:
        raise RuntimeError("HQuant returned non-zero")
    q_wall = time.perf_counter() - t0
    files = {"hk.hed": "HK DISCRETEHS\n",
             "cfg_hk": f"HHED: VQTABLE = {vq}\n",
             "cfg_vq": f"TARGETKIND = DISCRETE\nHPARM: VQTABLE = {vq}\n"}
    dsc = {p: os.path.join(d, os.path.splitext(os.path.basename(p))[0]
                           + ".dsc") for p in sysm.feats}
    files["vq.scp"] = "\n".join(f"{p} {q}" for p, q in dsc.items())
    files["train.scp"] = "\n".join(dsc.values())
    files["test.scp"] = files["train.scp"]
    for name, text in files.items():
        with open(os.path.join(d, name), "w") as f:
            f.write(text)
    t0 = time.perf_counter()
    if hhed.run(["-C", os.path.join(d, "cfg_hk"), "-H", sysm.hmmdefs, "-M",
                 os.path.join(d, "disc0"), os.path.join(d, "hk.hed"),
                 sysm.hmmlist]) != 0:
        raise RuntimeError("HHEd HK DISCRETEHS returned non-zero")
    hk_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    if hcopy.run(["-C", os.path.join(d, "cfg_vq"), "-S",
                  os.path.join(d, "vq.scp")]) != 0:
        raise RuntimeError("HCopy _V returned non-zero")
    hc_wall = time.perf_counter() - t0
    mmf0 = os.path.join(d, "disc0", os.path.basename(sysm.hmmdefs))
    comp = compile_hmmset(load_mmf([mmf0]))
    if not comp.discrete:
        raise AssertionError("HHEd HK DISCRETEHS: the set is not discrete")
    log(f"HQuant -n 1 {VQ_SIZE} over {N_UTTS} utterances "
        f"({sum(sysm.n_frames)} frames) in {q_wall:.3f} s; HHEd HK "
        f"DISCRETEHS ({comp.n_states} states x {VQ_SIZE} codewords) in "
        f"{hk_wall:.3f} s; HCopy _V of {N_UTTS} files in {hc_wall:.3f} s "
        "(host tools)")

    utts = _train_utts(comp, sysm, feats_of=dsc.get)
    n_batches = len(make_batches(utts, HEREST_BATCH))
    runs = {}
    for where in ("cuda", "cpu"):
        out = os.path.join(d, f"disc1_{where}")
        os.makedirs(out)
        runs[where] = setkind_tool(herest, [
            "-I", sysm.train_mlf, "-H", mmf0, "-M", out, "-S",
            os.path.join(d, "train.scp"), sysm.hmmlist], where, dev)
    wall, n, _h, peak = runs["cuda"]
    if n["fb_scans"] != n_batches:
        raise AssertionError(f"HERest DISCRETE: fb_scans launched "
                             f"{n['fb_scans']} times, expected {n_batches}")
    mmf1 = os.path.join(d, "disc1_cuda", os.path.basename(sysm.hmmdefs))
    e_tab = discrete_close(mmf1, os.path.join(
        d, "disc1_cpu", os.path.basename(sysm.hmmdefs)),
        "HERest DISCRETE card vs CPU")
    log(f"HERest DISCRETE on {card}: rc 0 in {wall:.3f} s (CPU path "
        f"{runs['cpu'][0]:.3f} s), fb_scans launches {n['fb_scans']} (FB "
        f"batches {n_batches}), table card vs CPU max |d| {e_tab:.3g} "
        f"(a DPROB step {DPROB_STEP:.3g}), peak {peak / 2**30:.2f} GiB")

    hv = {}
    for where in ("cuda", "cpu"):
        mlf = os.path.join(d, f"rec_{where}.mlf")
        hv[where] = setkind_tool(hvite, [
            "-w", sysm.wdnet, "-H", mmf1, "-i", mlf, "-s", str(LM_SCALE),
            "-p", str(WORD_PEN), "-S", os.path.join(d, "test.scp"),
            sysm.dict, sysm.hmmlist], where, dev) + (_rec_rows(mlf),)
    if hv["cuda"][1]["decode_scan"] != N_UTTS:
        raise AssertionError(f"HVite DISCRETE: decode_scan launched "
                             f"{hv['cuda'][1]['decode_scan']} times, "
                             f"expected {N_UTTS}")
    if hv["cuda"][4] != hv["cpu"][4]:
        raise AssertionError("HVite DISCRETE: the card's rec.mlf differs "
                             "from the CPU run's")
    acc = word_accuracy(sysm.transcripts, _rec_words(
        os.path.join(d, "rec_cuda.mlf"), sysm))
    log(f"HVite DISCRETE on {card}: rc 0 in {hv['cuda'][0]:.3f} s (CPU path "
        f"{hv['cpu'][0]:.3f} s), decode_scan launches "
        f"{hv['cuda'][1]['decode_scan']} (one an utterance), rec.mlf == the "
        f"CPU run's, word accuracy {acc:.2f}% (informational)")

    comp1 = compile_hmmset(load_mmf([mmf1]))
    tr = fb_discrete.DiscreteTrainer(comp1, device=dev)
    batch = make_batches(_train_utts(comp1, sysm, feats_of=dsc.get),
                         HEREST_BATCH)[0]
    a = {k: torch.as_tensor(v, device=dev)
         for k, v in pad_batch(batch, comp1.n_states).items()}
    outp = fb_discrete.discrete_outp(a["feats"].long(), a["comp_state"],
                                     a["q_mask"], **tr.params(),
                                     dprob_blocks=comp1.dprob_blocks)
    ops = (outp, a["logA"], a["a0"], a["aE"], a["t_real"].to(torch.int32))
    f_err = compare_scans(fbs.fb_scans_cuda(*ops), fbs.fb_scans_plain(*ops),
                          ops[4], "fb_scans on a discrete batch")
    vocab = read_dict(sysm.dict)
    net = compile_network(read_slf(sysm.wdnet), vocab, comp1,
                          phone_map=word_internal_phone_map(comp1.names))
    scores = fb_discrete.discrete_state_scores(
        comp1, read_htk_file(dsc[sysm.feats[0]]).data, device=dev)
    d_err = decode_hold(net, scores, (LM_SCALE, WORD_PEN),
                        "decode_scan on utt000's discrete state scores")
    log(f"discrete batch (B={outp.shape[0]}, T={outp.shape[1]}, "
        f"Q={outp.shape[2]}): fb_scans kernel == plain (max |d| "
        f"{f_err:.3g}); decode_scan kernel == plain (max |d| {d_err:.3g})")
    launches = {"fb_scans DISCRETE": n["fb_scans"],
                "decode_scan DISCRETE": hv["cuda"][1]["decode_scan"]}
    return launches, f_err, d_err


def phase_retrain(sysm, root, card, dev):
    """HERest -r at config-#4 width: a paired script of the 16 utterances,
    channel 2 written from the same frames through a seeded affine map
    at D2 = 39 (MFCC_E_D_A) and D2 = 26 (MFCC_E_D); on the card and on
    the CPU path, the MMFs within the herest tolerances, the set's width
    the new channel's; one fb_scans launch a batch; fb_scans kernel ==
    plain on the first batch. Returns (launches, max |d|)."""
    rng = np.random.default_rng(SETKIND_SEED)
    comp = compile_hmmset(load_mmf([sysm.hmmdefs]))
    launches, f_err = {}, 0.0
    for D2 in RETRAIN_D2:
        d = os.path.join(root, f"retrain{D2}")
        os.makedirs(d)
        A = rng.normal(scale=0.3, size=(comp.dim, D2)).astype(np.float32)
        b = rng.normal(size=D2).astype(np.float32)
        pairs = []
        for p in sysm.feats:
            q = os.path.join(d, os.path.basename(p))
            f = read_htk_file(p)
            write_htk_file(q, f.data @ A + b, f.samp_period,
                           pk.str2parmkind(RETRAIN_KIND[D2]))
            pairs.append(f"{p} {q}")
        scp = os.path.join(d, "pair.scp")
        with open(scp, "w") as f:
            f.write("\n".join(pairs) + "\n")
        utts = _train_utts(comp, sysm)
        n_batches = len(make_batches(utts, HEREST_BATCH))
        runs = {}
        for where in ("cuda", "cpu"):
            out = os.path.join(d, where)
            os.makedirs(out)
            runs[where] = setkind_tool(herest, [
                "-r", "-B", "-I", sysm.train_mlf, "-H", sysm.hmmdefs, "-M",
                out, "-S", scp, sysm.hmmlist], where, dev)
        got, ref = (os.path.join(d, w, os.path.basename(sysm.hmmdefs))
                    for w in ("cuda", "cpu"))
        wall, n, _h, peak = runs["cuda"]
        if n["fb_scans"] != n_batches:
            raise AssertionError(f"HERest -r ({D2}): fb_scans launched "
                                 f"{n['fb_scans']} times, expected "
                                 f"{n_batches}")
        hs = load_mmf([got])
        if hs.vec_size != D2:
            raise AssertionError(f"HERest -r: vecSize {hs.vec_size} != {D2}")
        worst = mmf_close(got, ref, f"HERest -r ({D2}) card vs CPU",
                          rel=RETRAIN_TOL)
        launches[f"fb_scans -r {D2}"] = n["fb_scans"]
        log(f"HERest -r to {D2} dims ({RETRAIN_KIND[D2]}) on {card}: rc 0 "
            f"in {wall:.3f} s (CPU path {runs['cpu'][0]:.3f} s), fb_scans "
            f"launches {n['fb_scans']} (FB batches {n_batches}), MMF card "
            f"vs CPU {worst:.2e} of scale (held at {RETRAIN_TOL}), peak "
            f"{peak / 2**30:.2f} GiB")
    tr = Trainer(comp, device=dev, retrain_dim=RETRAIN_D2[-1])
    a = {k: torch.as_tensor(v, device=dev) for k, v in pad_batch(
        make_batches(utts, HEREST_BATCH)[0], comp.n_states).items()}
    outp = _fb_outp(a["feats"], a["comp_state"], a["q_mask"], **tr.params(),
                    slot_blocks=tuple(comp.slot_blocks) or None)[0]
    ops = (outp, a["logA"], a["a0"], a["aE"], a["t_real"].to(torch.int32))
    f_err = compare_scans(fbs.fb_scans_cuda(*ops), fbs.fb_scans_plain(*ops),
                          ops[4], "fb_scans on a -r batch")
    log(f"-r batch (B={outp.shape[0]}, T={outp.shape[1]}, Q={outp.shape[2]}"
        f"): fb_scans kernel == plain (max |d| {f_err:.3g})")
    return launches, f_err


def phase_setkinds(sysm, root, card, dev):
    """Phase 29: FULLC, DISCRETE and -r HERest and discrete HVite on the
    config-#4 system. Returns (launches, max |d| of fb_scans, of
    decode_scan)."""
    fl, f1 = phase_fullc(sysm, root, card, dev)
    dl, f2, d_err = phase_discrete(sysm, root, card, dev)
    rl, f3 = phase_retrain(sysm, root, card, dev)
    return {**fl, **dl, **rl}, max(f1, f2, f3), d_err

LIVE_CHUNK = 32  # phase 30: frames a StreamingDecoder chunk (its default)
LIVE_T = 512  # phase 30(a): the config-#4 utterance cut into chunks
LIVE_GRID = 2  # phase 30(a): the forced small grid
LIVE_SEED = 30  # phase 30: random nets and feed sizes
LIVE_FEED = (1, 80)  # phase 30(b): frames a feed() call, drawn uniformly
LIVE_TEST = "spkC/spkC_test{}.wav"  # phase 30(c, d): the full corpus's
LIVE_HCOPY = 4  # phase 30(d): test utterances captured live
LIVE_RETRAIN = 2  # phase 30(c): HERest passes at ENORMALISE = F
LIVE_CFG = "SOURCEFORMAT = WAV\nTARGETKIND = MFCC_E_D_A\nENORMALISE = F\n"


def carried_scan(launch, args, chunk):
    """`launch` (a decode_scan implementation) over args' frames in chunks
    of `chunk` frames, the state carried from one to the next: the finals
    and the records of the whole run."""
    outp = args[0]
    carry, recs = None, []
    for t0 in range(0, outp.shape[1], chunk):
        carry, r = launch(outp[:, t0:t0 + chunk].contiguous(), *args[1:],
                          init=carry, t0=t0)
        recs.append(r)
    return carry, tuple(torch.cat(p, dim=1) for p in zip(*recs))


def identical(got, ref, what: str) -> None:
    """Finals and records equal bit for bit."""
    for a, b, name in zip(got[0] + got[1], ref[0] + ref[1],
                          ("v", "wn", "wt", "WE", "pwn", "pwt")):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs at "
                                 f"{int((a != b).sum())} places")


def phase_live_kernel(net, comp, feats, card, dev):
    """Phase 30(a): decode_scan with a carried state. On random nets and
    on the longest config-#4 utterance at LIVE_T frames (B = 1), the
    kernel over chunks of LIVE_CHUNK frames, the state carried, equals
    its plain version over the same chunks, one unchunked launch and the
    chunked kernel at a forced grid of LIVE_GRID blocks, bit for bit; the
    plain chunked run equals the plain unchunked one. Then the chunk
    shape's time (B = 1, T = LIVE_CHUNK, from a carried state), kernel
    and plain in turns, and its bound. Returns (max |d|, (kernel ms,
    plain ms), bound)."""
    grid = lambda *a, **k: ds.decode_scan_cuda(*a, grid=LIVE_GRID, **k)  # noqa: E731
    cases = [(f"random net seed={s} ties={t}",
              random_net(s, dev, t, **dict(RANDOM_NET, T=3 * LIVE_CHUNK)))
             for s, t in ((LIVE_SEED, False), (LIVE_SEED + 1, True))]
    x = max(feats, key=len)[:LIVE_T]
    fb = np.zeros((1, LIVE_T, x.shape[1]), np.float32)
    fb[0, :len(x)] = x
    args = decode_args(net, comp, fb, dev)
    cases.append((f"config-4 utterance (B=1, T={LIVE_T})", args))
    for what, a in cases:
        p = ds.decode_scan_plain(*a)
        pc = carried_scan(ds.decode_scan_plain, a, LIVE_CHUNK)
        kc = carried_scan(ds.decode_scan_cuda, a, LIVE_CHUNK)
        kg = carried_scan(grid, a, LIVE_CHUNK)
        k = ds.decode_scan_cuda(*a)
        torch.cuda.synchronize(dev)
        identical(pc, p, f"{what}: plain chunked vs unchunked")
        identical(kc, pc, f"{what}: kernel vs plain, chunked")
        identical(kc, k, f"{what}: kernel chunked vs one launch")
        identical(kg, kc, f"{what}: kernel at {LIVE_GRID} blocks")
        n = -(-a[0].shape[1] // LIVE_CHUNK)
        log(f"{what}: kernel over {n} chunks of {LIVE_CHUNK} frames, the "
            f"state carried == plain over the same chunks == one launch "
            f"== {LIVE_GRID} blocks, bit for bit; "
            f"{int((p[1][1] >= 0).sum())} live word-end records")
    (carry, _r) = ds.decode_scan_plain(
        args[0][:, :LIVE_CHUNK].contiguous(), *args[1:])
    one = (args[0][:, LIVE_CHUNK:2 * LIVE_CHUNK].contiguous(),) + args[1:]
    kms, pms, k, p = in_turns(
        time_launches,
        lambda: ds.decode_scan_plain(*one, init=carry, t0=LIVE_CHUNK),
        lambda: ds.decode_scan_cuda(*one, init=carry, t0=LIVE_CHUNK), dev,
        plain_timer=time_call)
    bnd = decode_bound(1, LIVE_CHUNK, net.n_states, net.n_nodes,
                       net.band.shape[0])
    log(f"decode_scan at the live chunk on {card} (B=1, T={LIVE_CHUNK}, "
        f"Nn={net.n_nodes}, Ns={net.n_states}, from a carried state): "
        f"kernel {kms:.6f} ms a launch (CUDA events over {LAUNCH_LOOP} "
        f"launches; samples {' '.join(f'{v:.6f}' for v in k)}), plain "
        f"{pms:.3f} ms a call (samples {' '.join(f'{v:.3f}' for v in p)}), "
        f"bound {bnd[0]:.6f} ms by {bnd[1]}")
    return 0.0, (kms, pms), bnd  # every comparison above is bit for bit


def stream_pass(sd_of, feats, rng, timers=None, partial_at=None):
    """Every utterance through its own StreamingDecoder (`sd_of()`), fed
    in sizes drawn from LIVE_FEED; `timers` {method: list} wraps the
    decoder's _outp/_launch/_keep with synchronised host timers; at
    utterance `partial_at` a partial_result() before the flush is timed.
    Returns the results, the wall s and the partial_result ms."""
    results, part_ms = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for u, x in enumerate(feats):
        sd = sd_of()
        for name, acc in (timers or {}).items():
            setattr(sd, name, synced(getattr(sd, name), acc))
        pos = 0
        while pos < len(x):
            n = int(rng.integers(*LIVE_FEED))
            sd.feed(x[pos:pos + n])
            pos += n
        if u == partial_at:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sd.partial_result()
            torch.cuda.synchronize()
            part_ms = (time.perf_counter() - t1) * 1e3
        results.append(sd.flush())
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0, part_ms


def synced(fn, acc):
    """fn, its calls' host ms (each ending in a synchronise) into acc."""
    def wrapper(*a):
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        acc.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapper


def phase_live_stream(sysm, hyps, net, comp, feats, card, dev):
    """Phase 30(b): the config-#4 utterances through StreamingDecoder
    on the card in chunks of LIVE_CHUNK frames, fed in random sizes:
    words and times equal to phase 5's batch HVite, one decode_scan
    launch a chunk (the sum of ceil(T / LIVE_CHUNK)); the stream's xRT
    and peak memory; a second, instrumented pass splits a chunk's ms into
    OutP, the launch and the record copy (median and p95) and times
    partial_result() at the end of the longest utterance. Returns the
    launches of the first pass."""
    def sd_of():
        return StreamingDecoder(net, comp, LM_SCALE, WORD_PEN, LIVE_CHUNK,
                                device=dev)

    want = sum(-(-len(x) // LIVE_CHUNK) for x in feats)
    audio_s = sum(len(x) for x in feats) * FRAME_S
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res, wall, _ = stream_pass(sd_of, feats, np.random.default_rng(LIVE_SEED))
    launches = ds.KERNEL.launches
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != want:
        raise AssertionError(f"stream: {launches} decode_scan launches, "
                             f"expected {want}")
    period = 100000
    for p, r in zip(sysm.feats, res):
        got = [(w, t0 * period, (t1 + 1) * period)
               for w, (t0, t1) in zip(r.words, r.times)]
        tool = [(lab.name, lab.start, lab.end) for lab in hyps[p].labels]
        if got != tool:
            raise AssertionError(f"{p}: streamed {got} != HVite {tool}")
    timers = {"_outp": [], "_launch": [], "_keep": []}
    longest = max(range(len(feats)), key=lambda u: len(feats[u]))
    _r, wall2, part_ms = stream_pass(sd_of, feats,
                                     np.random.default_rng(LIVE_SEED),
                                     timers, longest)
    chunk = [sum(ms) for ms in zip(*timers.values())]

    def med95(v):
        return f"median {np.median(v):.3f}, p95 {np.percentile(v, 95):.3f}"

    log(f"StreamingDecoder on {card}: the {len(feats)} config-#4 "
        f"utterances ({audio_s:.2f} s of audio) in chunks of {LIVE_CHUNK} "
        f"frames, fed {LIVE_FEED[0]}-{LIVE_FEED[1] - 1} frames at a time: "
        f"words and times == batch HVite for all; {launches} decode_scan "
        f"launches "
        f"(sum of ceil(T / {LIVE_CHUNK}) = {want}); wall {wall:.3f} s, xRT "
        f"{wall / audio_s:.4e}; peak device memory {peak / 2**20:.1f} MiB")
    log(f"  a chunk, instrumented pass ({len(chunk)} chunks, wall "
        f"{wall2:.3f} s; synchronised after each part): all {med95(chunk)} "
        f"ms; OutP {med95(timers['_outp'])}; launch "
        f"{med95(timers['_launch'])}; record copy {med95(timers['_keep'])}; "
        f"partial_result() at the end of the longest utterance "
        f"({len(feats[longest])} frames) {part_ms:.3f} ms")
    return launches


def retrain_unnormalised(dev):
    """The full twin's mix3 set retrained on features without ENORMALISE
    (live mode refuses it, HError 6324): HCopy of the training audio at
    LIVE_CFG, then LIVE_RETRAIN HERest passes from mix3 on the card, in
    the current directory. Returns the new MMF and the wall s."""
    t0 = time.perf_counter()
    mfcs = open("train.scp").read().split()
    with open("copy_enf.scp", "w") as f:
        f.writelines(f"{m[:-4]}.wav enf/{m}\n" for m in mfcs)
    with open("train_enf.scp", "w") as f:
        f.writelines(f"enf/{m}\n" for m in mfcs)
    for d in {os.path.dirname(m) for m in mfcs}:
        os.makedirs(os.path.join("enf", d), exist_ok=True)
    mmf = "mix3"
    with contextlib.redirect_stdout(io.StringIO()):
        if hcopy.run(["-C", "cfg_file", "-S", "copy_enf.scp"]) != 0:
            raise RuntimeError("HCopy of the training audio at "
                               "ENORMALISE = F failed")
        for it in range(1, LIVE_RETRAIN + 1):
            os.makedirs(f"enf{it}", exist_ok=True)
            if herest.run(["-C", "cfg", "-I", "tri.mlf", "-H",
                           f"{mmf}/hmmdefs", "-M", f"enf{it}", "-S",
                           "train_enf.scp", "tiedlist"]) != 0:
                raise RuntimeError(f"HERest pass {it} at ENORMALISE = F "
                                   "failed")
            mmf = f"enf{it}"
    torch.cuda.synchronize(dev)
    return f"{mmf}/hmmdefs", time.perf_counter() - t0


def phase_live_tools(work, card, dev):
    """Phase 30(c, d), on the full twin's files (phase 28): its set
    retrained without ENORMALISE (`retrain_unnormalised`), HVite live
    (SOURCEKIND = HAUDIO, ENORMALISE = F) replays the first test
    utterance on the card, its live.mlf equal to the CPU path's (`python
    -m htk_tpu_torch.tools.hvite` with HTK_TPU_TORCH_DEVICE=cpu) and to
    the port's batch HVite of the same file with the same config, its
    words held against the corpus's transcription (informational); then
    HCopy captures LIVE_HCOPY test utterances live on the card and on
    the CPU path, features within the frontend tolerances. Returns the
    decode_scan launches of the live HVite."""
    wav = LIVE_TEST.format(0)
    with open(os.path.join(work, "cfg_live"), "w") as f:
        f.write(LIVE_CFG + f"SOURCEKIND = HAUDIO\nHAUDIO: AUDIOSOURCE = "
                f"{wav}\n")
    with open(os.path.join(work, "cfg_file"), "w") as f:
        f.write(LIVE_CFG)
    old = os.getcwd()
    os.chdir(work)
    try:
        mmf, rt_wall = retrain_unnormalised(dev)
        net = ["-w", "wdnet.slf", "-p", "-12", "-H", mmf]
        n = len(read_wave(wav, fmt="WAV").samples)
        audio_s = n / 16000.0
        want = -(-num_frames(n, FrontendConfig()) // LIVE_CHUNK)
        reset_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = hvite.run(["-C", "cfg_live", "-T", "2", *net, "-i",
                            "live.mlf", "dict", "tiedlist"])
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = ds.KERNEL.launches
        if rc != 0:
            raise RuntimeError(f"HVite live returned {rc}")
        parts = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith("live [")]
        final = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith("live:")]
        env = dict(os.environ, PYTHONPATH=old, **{DEVICE_ENV: "cpu"})
        t0 = time.perf_counter()
        cpu = subprocess.run(
            [sys.executable, "-m", "htk_tpu_torch.tools.hvite", "-C",
             "cfg_live", *net, "-i", "live_cpu.mlf", "dict", "tiedlist"],
            env=env, capture_output=True, text=True, timeout=300)
        cpu_wall = time.perf_counter() - t0
        if cpu.returncode != 0:
            raise RuntimeError(f"HVite live on the CPU path returned "
                               f"{cpu.returncode}: {cpu.stderr[-2000:]}")
        if hvite.run(["-C", "cfg_file", *net, "-i", "batch.mlf", "dict",
                      "tiedlist", wav]) != 0:
            raise RuntimeError("batch HVite of the live file failed")
        mlf = {n: open(n, "rb").read()
               for n in ("live.mlf", "live_cpu.mlf", "batch.mlf")}
        if not mlf["live.mlf"] == mlf["live_cpu.mlf"] == mlf["batch.mlf"]:
            raise AssertionError(f"live.mlf differs: {mlf}")
        stem = os.path.splitext(os.path.basename(wav))[0]
        hyp = MLF.load("live.mlf").lookup(f"*/{stem}.rec").names()
        ref = MLF.load("words_test.mlf").lookup(f"*/{stem}.lab").names()
        if not hyp:
            raise AssertionError("HVite live recognised no word")
        if launches != want:
            raise AssertionError(f"HVite live: {launches} decode_scan "
                                 f"launches, expected {want}")
        log(f"the full twin's set retrained at ENORMALISE = F "
            f"({LIVE_RETRAIN} HERest passes from mix3, HCopy included): "
            f"{rt_wall:.2f} s")
        log(f"HVite live on {card} ({wav}, {audio_s:.2f} s of audio, "
            f"ENORMALISE = F): rc 0 in {wall:.3f} s ({wall / audio_s:.4f} s "
            f"of wall a second of audio), words {hyp} against {ref} "
            f"(accuracy {word_accuracy([ref], [hyp]):.2f}%, informational), "
            f"{launches} decode_scan launches, "
            f"{len(parts)} partial lines (last: {parts[-1] if parts else ''})"
            f", {final[0] if final else 'no final line'}; live.mlf == the "
            f"CPU path's (python -m, {cpu_wall:.2f} s with start-up) == "
            f"batch HVite's on the file, byte for byte")
        with open("cfg_hcopy", "w") as f:
            f.write(LIVE_CFG + "SOURCEKIND = HAUDIO\n")
        errs = (0.0, 0.0)
        walls = {}
        for where in ("cuda", "cpu"):
            os.makedirs(f"live_{where}", exist_ok=True)
            with open(f"live_{where}.scp", "w") as f:
                f.writelines(f"{LIVE_TEST.format(i)} live_{where}/c{i}.mfc\n"
                             for i in range(LIVE_HCOPY))
            t0 = time.perf_counter()
            with tool_device(where):
                rc = hcopy.run(["-C", "cfg_hcopy", "-S", f"live_{where}.scp"])
            torch.cuda.synchronize(dev)
            walls[where] = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"HCopy live capture on {where} returned "
                                   f"{rc}")
        for i in range(LIVE_HCOPY):
            e = _feature_err(read_htk_file(f"live_cuda/c{i}.mfc").data,
                             read_htk_file(f"live_cpu/c{i}.mfc").data, False)
            errs = (max(errs[0], e[0]), max(errs[1], e[1]))
        if errs[0] > FE_MAX or errs[1] > FE_MEAN:
            raise AssertionError(f"HCopy live capture: card vs CPU max "
                                 f"{errs[0]:.3g} mean {errs[1]:.3g}")
        log(f"HCopy live capture (SOURCEKIND = HAUDIO) of {LIVE_HCOPY} test "
            f"utterances: card {walls['cuda']:.3f} s, CPU path "
            f"{walls['cpu']:.3f} s; card vs CPU max |diff| {errs[0]:.3g}, "
            f"mean {errs[1]:.3g}")
    finally:
        os.chdir(old)
    return launches


def phase_live(sysm, hyps, net, comp, feats, work, card, dev):
    """Phase 30: live mode. Returns (launches: the stream's decode_scan
    launches and live HVite's, max |d| of decode_scan with a carry, its
    chunk-shape times and bound)."""
    err, times, bnd = phase_live_kernel(net, comp, feats, card, dev)
    n_stream = phase_live_stream(sysm, hyps, net, comp, feats, card, dev)
    n_hvite = phase_live_tools(work, card, dev)
    return {"stream": n_stream, "HVite live": n_hvite}, err, times, bnd


MD_T = 504  # phase 31(c): frames of the config-#4 utterance
MD_LONG = 4  # phase 31(c): transcripts joined into the long utterance
MD_SHARD = (5, 8)  # phase 31(b): a padded shard's real rows, and its rows
MD_RANK_BATCH = 4  # phase 31(d): utterances a rank a batch
MD_TIMEOUT = 180.0  # phase 31(d): the two-rank group's wall, start-up included
MD_ACC_TOL = 5e-5  # phase 31(d): tests/test_parallel.py's rtol and atol


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms inside (index_add_ on the card
    then sums in a fixed order, so that two runs of one computation are
    equal bit for bit); matmuls keep their own, deterministic, kernels."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def md_world1(comp, utts, card, dev):
    """Phase 31(a): ShardedTrainer on a one-rank NCCL mesh and Trainer
    over the 16 utterances (host composites, HERest's DEVICECOMPOSITE = F
    path), in turns Trainer, ShardedTrainer, ShardedTrainer, Trainer:
    every pass's accumulators equal bit for bit, fb_scans launched once a
    FB batch. Returns (Trainer's accumulators, ShardedTrainer's fb_scans
    launches in its first pass)."""
    mesh = make_mesh(1)
    want = len(make_batches(utts, HEREST_BATCH))
    runs = []
    with deterministic():
        for name in ("Trainer", "ShardedTrainer", "ShardedTrainer",
                     "Trainer"):
            tr = (Trainer(comp, device=dev) if name == "Trainer"
                  else ShardedTrainer(comp, mesh, device=dev))
            reset_counts()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            accs = tr.accumulate(utts, batch_size=HEREST_BATCH)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            n = fbs.KERNEL.launches
            if n != want:
                raise AssertionError(f"31(a) {name}: fb_scans launched {n} "
                                     f"times, expected {want}")
            runs.append((name, accs, wall, n))
    ref = runs[0][1]
    for name, accs, _w, _n in runs[1:]:
        for f in ref._fields:
            a, b = getattr(accs, f), getattr(ref, f)
            if not torch.equal(a, b):
                raise AssertionError(
                    f"31(a) {name}: {f} differs from Trainer's at "
                    f"{int((a != b).sum())} places (max |d| "
                    f"{float((a - b).abs().max()):.3g})")
    log(f"31(a) world 1 on {dist.get_backend()}, {card}: "
        f"ShardedTrainer == Trainer bit for bit over {len(utts)} "
        f"utterances ({want} FB batches of {HEREST_BATCH}, "
        f"{comp.n_states} tied states, {comp.n_mix} Gaussians); walls "
        + ", ".join(f"{name} {w:.3f} s" for name, _a, w, _n in runs)
        + "; fb_scans launches " + ", ".join(str(n) for *_x, n in runs))
    return ref, runs[1][3]


def md_padded_shard(comp, utts, dev):
    """Phase 31(b): one fb_batch call on a shard with trailing padding
    rows (t_real = 0), as pad_batch(pad_to=) makes them on a rank: the
    kernel against the plain version on the same outp, the padding rows'
    logP LZERO and xi zero, and the accumulators of the call through the
    kernel against the plain scans'. Returns the scans' max |d|."""
    real, rows = MD_SHARD
    tr = Trainer(comp, device=dev)
    params = tr.params()
    batch = max(make_batches(utts, HEREST_BATCH), key=len)[:real]
    arrs = {k: torch.as_tensor(v, device=dev) for k, v in pad_batch(
        batch, comp.n_states, pad_to=rows).items()}
    outp = _fb_outp(arrs["feats"], arrs["comp_state"], arrs["q_mask"],
                    **params, slot_blocks=tuple(comp.slot_blocks) or None)[0]
    ops = (outp, arrs["logA"], arrs["a0"], arrs["aE"], arrs["t_real"])
    k = fbs.fb_scans_cuda(*ops)
    p = fbs.fb_scans_plain(*ops)
    torch.cuda.synchronize(dev)
    err = compare_scans(k, p, ops[4], "31(b) padded shard")
    if not bool((k[2][real:] <= LZERO / 2).all()) or bool(k[3][real:].any()):
        raise AssertionError("31(b): a padding row has a logP or an xi")
    _lk, acc_k = tr._fb(params, arrs, None)
    with plain_scans():
        _lp, acc_p = tr._fb(params, arrs, None)
    torch.cuda.synchronize(dev)
    if float(acc_k.n_utts) != real:
        raise AssertionError(f"31(b): {float(acc_k.n_utts)} utterances "
                             f"accumulated, not {real}")
    worst = {}
    for f in ("occ", "sum_x", "sum_xx", "wt_occ", "tr"):
        g, r = getattr(acc_k, f), getattr(acc_p, f)
        worst[f] = float((g - r).abs().max() / r.abs().max())
        if worst[f] > ACC_TOL:
            raise AssertionError(f"31(b) accumulators: {f} differs by "
                                 f"{worst[f]:.3g} of its scale")
    B, T, Q = outp.shape
    log(f"31(b) fb_scans on a padded shard (B={B}: {real} utterances and "
        f"{rows - real} rows at t_real = 0, T={T}, Q={Q}): kernel == plain "
        f"(max |d| {err:.3g}), padding rows' logP LZERO and xi 0; "
        "accumulators through the kernel == plain scans' (max |diff| / "
        "scale: " + ", ".join(f"{f} {v:.2e}" for f, v in worst.items())
        + ")")
    return err


def md_long_utterance(comp, sysm):
    """The first MD_LONG transcripts joined and their features
    concatenated, cut to a multiple of 8 frames."""
    mlf = MLF.load(sysm.train_mlf)
    feats, names = [], []
    for path in sysm.feats[:MD_LONG]:
        stem = os.path.splitext(os.path.basename(path))[0]
        feats.append(read_htk_file(path).data)
        names += mlf.lookup(f"*/{stem}.lab").names()
    x = np.concatenate(feats)
    return prepare_utterance(comp, "long", x[:len(x) - len(x) % 8], names)


def md_operands(comp, u, dev):
    """Utterance u's outp (T, Q) on the card at its real Q, and its logA,
    a0 and aE."""
    params = Trainer(comp, device=dev).params()
    arrs = {k: torch.as_tensor(v, device=dev)
            for k, v in pad_batch([u], comp.n_states).items()}
    outp = _fb_outp(arrs["feats"], arrs["comp_state"], arrs["q_mask"],
                    **params, slot_blocks=tuple(comp.slot_blocks) or None)[0]
    T, Q = u.feats.shape[0], u.hmm.n_states
    return [outp[0, :T, :Q].contiguous()] + [
        torch.as_tensor(np.asarray(a, np.float32), device=dev)
        for a in (u.hmm.logA, u.hmm.a0, u.hmm.aE)]


def serial_fb(outp, logA, a0, aE):
    """The port's serial scans of one utterance: alphas, betas, logP and
    xi."""
    T = outp.shape[0]
    o, A = outp[None], logA[None]
    t_real = torch.tensor([T], dtype=torch.int32, device=outp.device)
    al = forward_scan(o, A, a0[None], t_real)
    be = backward_scan(o, A, aE[None], t_real)
    lp = ladd_reduce(al[:, 0] + be[:, 0], dim=-1)
    xi = xi_scan(al, be, o, A, lp, t_real)
    return al[0], be[0], lp[0], xi[0]


def timeshard_close(got, ref, what, xi_rtol=5e-4):
    """tests/test_timeshard.py's tolerances: alphas and betas where the
    serial value is above -1e9 within 2e-3 + 1e-5 |ref|, xi within
    atol 5e-3, rtol `xi_rtol`; logP within 2e-3 + 1e-5 |ref| too (the
    test's logP, about -400, is held at 2e-3 absolute; a config-#4 logP
    is about -6e4, where one float32 step is 4e-3). Returns the max |d|
    of alphas and betas, of logP and of xi."""
    al, be, lp, xi = got
    al_r, be_r, lp_r, xi_r = ref
    d_ab = 0.0
    for g, r, name in ((al, al_r, "alpha"), (be, be_r, "beta")):
        live = r > -1e9
        d = (g[live] - r[live]).abs()
        if not bool((d <= 2e-3 + 1e-5 * r[live].abs()).all()):
            raise AssertionError(f"{what}: {name} max |d| {float(d.max())}")
        d_ab = max(d_ab, float(d.max()))
    d_lp = abs(float(lp) - float(lp_r))
    if d_lp > 2e-3 + 1e-5 * abs(float(lp_r)):
        raise AssertionError(f"{what}: logP {float(lp)} != {float(lp_r)}")
    if not torch.allclose(xi, xi_r, rtol=xi_rtol, atol=5e-3):
        raise AssertionError(f"{what}: xi differs by "
                             f"{float((xi - xi_r).abs().max())} (largest "
                             f"{float(xi_r.abs().max())})")
    return d_ab, d_lp, float((xi - xi_r).abs().max())


def fb_gaps(got, ref):
    """{alpha, beta, logP, xi, LSE spread}: max |got - ref| of each (alphas
    and betas on the same live cells, above -1e9), and the largest
    |LSE_i(alpha_t + beta_t) - logP| over t of `got`."""
    out = {}
    for g, r, name in zip(got[:2], ref[:2], ("alpha", "beta")):
        live = r > -1e9
        if not torch.equal(live, g > -1e9):
            raise AssertionError(f"31(d): live {name} cells differ")
        out[name] = float((g[live].double() - r[live]).abs().max())
    out["logP"] = abs(float(got[2]) - float(ref[2]))
    out["xi"] = float((got[3].double() - ref[3]).abs().max())
    out["LSE spread"] = float((ladd_reduce(got[0] + got[1], dim=-1)
                               - got[2]).abs().max())
    return out


def synced_ms(fn, dev):
    """fn()'s result and its wall in ms, ending in a synchronise."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, (time.perf_counter() - t0) * 1e3


def md_timeshard(comp, sysm, utts, card, dev):
    """Phase 31(c): fb_time_sharded on a one-rank mesh on the card against
    the port's serial scans, on the longest config-#4 utterance cut to
    MD_T frames and on the long utterance (`md_long_utterance`): the
    walls of the call, of its phase 1 (the block operator) and phase 3
    (the rescans) and of the serial scans, and the call's peak device
    memory. Returns the long utterance's operands and serial result."""
    mesh = make_mesh(1, axis="t")
    longest = max(utts, key=lambda u: u.feats.shape[0])
    cut = UttData("cut", longest.feats[:MD_T], longest.hmm)
    out = None
    for what, u in (("the longest utterance, cut", cut),
                    (f"{MD_LONG} utterances joined", md_long_utterance(
                        comp, sysm))):
        ops = md_operands(comp, u, dev)
        T, Q = ops[0].shape
        ref, serial_ms = synced_ms(lambda: serial_fb(*ops), dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        got, ts_ms = synced_ms(lambda: tsh.fb_time_sharded(*ops, mesh), dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        errs = timeshard_close(got, ref, f"31(c) {what}")
        K = tsh._band_of(ops[1].cpu().numpy())
        O, p1_ms = synced_ms(lambda: tsh._block_operator(
            ops[0][None], ops[1], ops[2], K, 0), dev)
        seeds = tsh._boundaries(O[None], 0, ops[3])
        _ab, p3_ms = synced_ms(lambda: tsh._rescan(
            ops[0][None], ops[1], ops[2], *seeds, 0), dev)
        log(f"31(c) fb_time_sharded at D = 1 on {card}, {what} (T={T}, "
            f"Q={Q}, band K={K}, logP {float(ref[2]):.2f}): == serial scans "
            f"(max |d| alpha/beta {errs[0]:.3g}, logP {errs[1]:.3g}, xi "
            f"{errs[2]:.3g}); wall {ts_ms:.1f} ms (phase 1, the block "
            f"operator, {p1_ms:.1f} ms; phase 3, the rescans, {p3_ms:.1f} "
            f"ms), serial scans {serial_ms:.1f} ms; peak device memory "
            f"{peak / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB held "
            f"(xi's (T, Q, Q) terms: {4 * T * Q * Q / 2**20:.1f} MiB)")
        out = (ops, ref)
    return out


def md_rank(init, data, out, device):
    """Phase 31(d)'s rank: one of two gloo ranks on the same `device`
    (the card, cuda:0). First
    whether gloo takes CUDA tensors (all_reduce, all_gather_into_tensor):
    if not, rank 0 saves the error and both stop. Then ShardedTrainer at
    MD_RANK_BATCH utterances a rank over the pickled corpus and
    fb_time_sharded of the pickled long utterance over the two ranks;
    rank 0 saves the accumulators, the gathered alphas and betas, logP,
    xi, and each rank prints its launches, walls and peak memory."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init,
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]),
                            timeout=datetime.timedelta(seconds=120))
    rank = dist.get_rank()
    try:
        try:
            x = torch.ones(4, device=dev)
            dist.all_reduce(x)
            g = x.new_empty(8)
            dist.all_gather_into_tensor(g, x)
        except RuntimeError as e:
            if rank == 0:
                np.savez(out, gloo_error=np.array(str(e)))
            return
        with open(data, "rb") as f:
            comp, utts, long_ops = pickle.load(f)
        mesh = make_mesh(2, device_type=dev.type)
        reset_counts()
        accs, tr_ms = synced_ms(lambda: ShardedTrainer(
            comp, mesh, device=dev).accumulate(utts,
                                               batch_size=MD_RANK_BATCH), dev)
        n_fb = fbs.KERNEL.launches
        mesh_t = make_mesh(2, axis="t", device_type=dev.type)
        ops = [torch.as_tensor(a, device=dev) for a in long_ops]
        torch.cuda.reset_peak_memory_stats(dev)
        res, ts_ms = synced_ms(lambda: tsh.fb_time_sharded(*ops, mesh_t),
                               dev)
        peak = torch.cuda.max_memory_allocated(dev)
        whole = [tsh.gather_blocks(res[0], mesh_t),
                 tsh.gather_blocks(res[1], mesh_t), res[2], res[3]]
        print(f"rank {rank}: ShardedTrainer {tr_ms:.1f} ms, fb_scans "
              f"launches {n_fb}; fb_time_sharded over T={ops[0].shape[0]} "
              f"(this rank's {res[0].shape[0]} frames) {ts_ms:.1f} ms, "
              f"peak device memory {peak / 2**20:.1f} MiB", flush=True)
        if rank == 0:
            np.savez(out, **{f: getattr(accs, f).cpu().numpy()
                             for f in accs._fields},
                     **{f"ts_{n}": t.cpu().numpy() for n, t in zip(
                         ("alphas", "betas", "logp", "xi"), whole)})
        dist.barrier()
    finally:
        dist.destroy_process_group()


def md_world2(comp, utts, ref, long_case, root, card, dev):
    """Phase 31(d): two gloo ranks on the one card (`md_rank`), when
    gloo takes CUDA tensors: ShardedTrainer at MD_RANK_BATCH a rank
    against 31(a)'s Trainer within MD_ACC_TOL, and fb_time_sharded at
    D = 2 on the long utterance against the serial scans (below)."""
    (ops, serial) = long_case
    data = os.path.join(root, "md31.pkl")
    out = os.path.join(root, "md31.npz")
    with open(data, "wb") as f:
        pickle.dump((comp, utts, [a.cpu().numpy() for a in ops]), f)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    where = "cuda:0" if dev.type == "cuda" else "cpu"
    outs = spawn_ranks(2, "chip_smoke:md_rank",
                       {"data": data, "out": out, "device": where},
                       device=dev.type, env={"LOCAL_RANK": "0"},
                       timeout=MD_TIMEOUT, path=[here])
    wall = time.perf_counter() - t0
    z = np.load(out)
    if "gloo_error" in z.files:
        log(f"31(d) left out: gloo on torch {torch.__version__} does not "
            f"take CUDA tensors: {z['gloo_error']}")
        return
    for f in ref._fields:
        g, r = z[f], getattr(ref, f).cpu().numpy()
        if not np.allclose(g, r, rtol=MD_ACC_TOL, atol=MD_ACC_TOL):
            raise AssertionError(f"31(d): {f} differs from Trainer's by "
                                 f"{float(np.abs(g - r).max()):.3g}")
    got = [torch.as_tensor(z[f"ts_{n}"], device=dev)
           for n in ("alphas", "betas", "logp", "xi")]
    # at |logP| ~1e5 one float32 step is 8e-3 and a scan rounds T times,
    # so the float32 serial scans part from exact values by far more than
    # tests/test_timeshard.py's 2e-3 (its logP is -400): alphas, betas
    # and logP are held against the serial scans in float64, no further
    # off than twice the float32 serial scans plus the test's tolerance.
    # xi at this length carries each result's drift of LSE(alpha_t +
    # beta_t) from logP (float32 serial: e^2.6 on the card), so it is held
    # to xi_scan of its own gathered alphas, betas and logP at the test's
    # tolerances: the block-boundary exchange and the sum across ranks
    exact = serial_fb(*[a.double() for a in ops])
    e32, ets = fb_gaps(serial, exact), fb_gaps(got, exact)
    t_real = torch.tensor([ops[0].shape[0]], dtype=torch.int32, device=dev)
    xi_own = xi_scan(got[0][None], got[1][None], ops[0][None], ops[1][None],
                     got[2].reshape(1), t_real)[0]
    xi_d = float((got[3] - xi_own).abs().max())
    log(f"31(d) world 2 on one card (gloo, CUDA tensors), {card}: "
        f"ShardedTrainer at {MD_RANK_BATCH} a rank == 31(a)'s Trainer "
        f"within {MD_ACC_TOL}; fb_time_sharded at D = 2 on the long "
        f"utterance, max |d| from the float64 serial scans (the float32 "
        f"serial scans' beside): "
        + ", ".join(f"{k} {ets[k]:.4g} ({e32[k]:.4g})" for k in ets)
        + f"; xi from xi_scan of its own alphas, betas and logP {xi_d:.4g} "
        f"(largest {float(xi_own.abs().max()):.4g}); group wall "
        f"{wall:.1f} s, start-up included")
    for k, floor in (("alpha", 2e-3), ("beta", 2e-3), ("logP", 2e-3)):
        if ets[k] > 2 * e32[k] + floor:
            raise AssertionError(f"31(d) D = 2: {k} {ets[k]:.4g} from the "
                                 f"float64 scans, the float32 serial scans "
                                 f"{e32[k]:.4g}")
    if not torch.allclose(got[3], xi_own, rtol=5e-4, atol=5e-3):
        raise AssertionError(f"31(d) D = 2: xi {xi_d:.4g} from xi_scan of "
                             f"its own alphas, betas and logP")
    for o in outs:
        for line in o.splitlines():
            log(f"  {line}")


def phase_multidevice(sysm, root, card, dev):
    """Phase 31: multi-device training (parallel/mesh.py) and time-sharded
    forward-backward (parallel/timeshard.py) on the card at config-#4
    width, (a)-(d) above, then the multi-rank dry run at one rank.
    Returns (fb_scans launches under 31(a)'s first ShardedTrainer pass,
    under the dry run; decode_scan launches under the dry run; 31(b)'s
    max |d|)."""
    comp = compile_hmmset(load_mmf([sysm.hmmdefs]))
    utts = _train_utts(comp, sysm)
    init_distributed(coordinator="file://" + os.path.join(root, "rv31"),
                     num_processes=1, process_id=0, device=dev)
    try:
        ref, n_a = md_world1(comp, utts, card, dev)
        err = md_padded_shard(comp, utts, dev)
        long_case = md_timeshard(comp, sysm, utts, card, dev)
        md_world2(comp, utts, ref, long_case, root, card, dev)
        reset_counts()
        _r, dry_ms = synced_ms(lambda: dryrun_multichip(1), dev)
        n_dry = (fbs.KERNEL.launches, ds.KERNEL.launches)
        if min(n_dry) < 1:
            raise AssertionError(f"dry run: launches fb_scans, decode_scan "
                                 f"{n_dry}")
        log(f"dryrun_multichip(1) on {card}: {dry_ms:.1f} ms, fb_scans "
            f"launches {n_dry[0]}, decode_scan launches {n_dry[1]}")
    finally:
        dist.destroy_process_group()
    return n_a, n_dry, err


def kernel_entry(name, source, replaces, launches, err, times, bnd,
                 library_ms=None):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": times[0], "plain_ms": times[1], "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": library_ms}


def write_big_arpa(path, words, bigrams, trigrams, duplicates, seed):
    """A trigram ARPA over `words`: every word a unigram with a back-off,
    `bigrams` distinct bigrams with back-offs, `trigrams` distinct
    trigrams extending them; then `duplicates` bigram and trigram lines
    written a second time with other values (the last lines of their
    sections). Returns the planted (bigram, trigram) keys."""
    rng = np.random.default_rng(seed)
    V = len(words)
    bkeys = np.unique(rng.integers(0, V * V, int(bigrams * 1.1)))
    bkeys = np.sort(rng.permutation(bkeys)[:bigrams])
    tkeys = np.unique(rng.choice(bkeys, int(trigrams * 1.1)) * V
                      + rng.integers(0, V, int(trigrams * 1.1)))
    tkeys = np.sort(rng.permutation(tkeys)[:trigrams])
    lines = ["\\data\\", f"ngram 1={V}", f"ngram 2={bigrams + duplicates}",
             f"ngram 3={trigrams + duplicates}", "", "\\1-grams:"]
    up, ub = rng.uniform(-6, -2, V), rng.uniform(-1.5, -0.1, V)
    lines += [f"{p:.4f}\t{w}\t{b:.4f}" for p, w, b in zip(up, words, ub)]
    lines += ["", "\\2-grams:"]
    bp, bb = rng.uniform(-4, -0.1, bigrams), rng.uniform(-1, -0.05, bigrams)
    w1, w2 = (bkeys // V).tolist(), (bkeys % V).tolist()
    lines += [f"{p:.4f}\t{words[i]}\t{words[j]}\t{b:.4f}"
              for p, i, j, b in zip(bp.tolist(), w1, w2, bb.tolist())]
    bd = rng.choice(bigrams, duplicates, replace=False)
    lines += [f"{bp[k] + rng.uniform(-1, 1):.4f}\t{words[w1[k]]}\t"
              f"{words[w2[k]]}\t{bb[k]:.4f}" for k in bd]
    lines += ["", "\\3-grams:"]
    tp = rng.uniform(-3, -0.1, trigrams)
    t1, t2, t3 = ((tkeys // (V * V)).tolist(), (tkeys // V % V).tolist(),
                  (tkeys % V).tolist())
    lines += [f"{p:.4f}\t{words[i]}\t{words[j]}\t{words[k]}"
              for p, i, j, k in zip(tp.tolist(), t1, t2, t3)]
    td = rng.choice(trigrams, duplicates, replace=False)
    lines += [f"{tp[k] + rng.uniform(-1, 1):.4f}\t{words[t1[k]]}\t"
              f"{words[t2[k]]}\t{words[t3[k]]}" for k in td]
    lines += ["", "\\end\\", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return ([(words[w1[k]], words[w2[k]]) for k in bd],
            [(words[t1[k]], words[t2[k]], words[t3[k]]) for k in td])


def timed(fn, *args):
    """fn(*args) and the host seconds it took."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def scaled_packs(packs):
    """A codec pack dict in natural logs, as io/lm.read_arpa scales it."""
    out = dict(packs)
    for n in range(1, packs["order"] + 1):
        ids, lp, bo, hb = packs[n]
        out[n] = (ids, lp * math.log(10.0), bo * math.log(10.0), hb)
    return out


def net_tables(net):
    """compile_lv_loop's arrays, the factored cross-word tables included."""
    out = {k: getattr(net, k) for k in (
        "comp_state", "band", "a0", "aE", "chain_of", "node_of_chain",
        "chain_pron_prob", "trans", "start_entry", "end_exit")}
    x = net.xw_backoff or {}
    for k in ("bow", "uni", "inv", "succ_j", "succ_p", "marg"):
        out[f"xw.{k}"] = x.get(k)
    for i, (p, sc) in enumerate(x.get("buckets", ())):
        out[f"xw.bucket{i}"] = (p, sc)
    for i, a in enumerate(x.get("slots", ())):
        out[f"xw.slots{i}"] = a
    return out


def same_arrays(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(same_arrays, a, b))
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a, b))


def phase_native_arpa(big, root, card):
    """32(b): the 43 MB ARPA through the codec and its plain version."""
    path = os.path.join(root, "native_20k.arpa")
    t0 = time.perf_counter()
    dup_bi, dup_tri = write_big_arpa(path, big.words, **NATIVE_ARPA)
    mb = os.path.getsize(path) / 1e6
    log(f"ARPA written in {time.perf_counter() - t0:.2f} s: {mb:.1f} MB, "
        f"{len(big.words)} unigrams, {NATIVE_ARPA['bigrams']} bigrams and "
        f"{NATIVE_ARPA['trigrams']} trigrams, {NATIVE_ARPA['duplicates']} "
        "of each written twice")
    walls = {}
    packs, walls["codec parse"] = timed(native.parse_arpa, path)
    plain, walls["plain parse"] = timed(native.parse_arpa_plain, path)
    lm, walls["read_arpa (codec)"] = timed(read_arpa, path)
    dict_lm, walls["read_arpa_plain (dicts)"] = timed(read_arpa_plain, path)
    if packs is None or plain is None:
        raise AssertionError("ARPA: a parser rejected the file")
    if packs["order"] != plain["order"] or packs["vocab"] != plain["vocab"]:
        raise AssertionError("ARPA: codec and plain version differ in order "
                             "or vocabulary")
    for n in range(1, packs["order"] + 1):
        if not same_arrays(packs[n], plain[n]):
            raise AssertionError(f"ARPA: {n}-gram packs differ")
    counts = [len(packs[n][1]) for n in range(1, packs["order"] + 1)]
    log(f"ARPA codec packs == plain version's, duplicates included "
        f"({counts} lines of order 1-{packs['order']})")
    if type(lm) is not PackedNGramLM:
        raise AssertionError(f"read_arpa returned {type(lm).__name__}")
    nets = {}
    for name, m in (("codec", lm),
                    ("plain", PackedNGramLM(scaled_packs(plain)))):
        net, walls[f"compile_lv_loop ({name})"] = timed(
            compile_lv_loop, big.words, big.vocab, big.comp, m)
        nets[name] = net_tables(net)
    differ = [k for k in nets["codec"]
              if not same_arrays(nets["codec"][k], nets["plain"][k])]
    if differ or nets["codec"].keys() != nets["plain"].keys():
        raise AssertionError(f"compile_lv_loop tables differ: {differ}")
    log(f"compile_lv_loop tables from the codec LM == from the plain "
        f"version's packs ({len(nets['codec'])} arrays, factored)")
    # a bigram on two lines: both reach the LV loop, which keeps the larger
    i, j, p = lm.bigram_arrays(big.words)
    idx = {w: n for n, w in enumerate(big.words)}
    vid = {w: n for n, w in enumerate(packs["vocab"])}
    ids, lp = packs[2][0], packs[2][1]
    for w1, w2 in dup_bi:
        rows = (ids[:, 0] == vid[w1]) & (ids[:, 1] == vid[w2])
        got = p[(i == idx[w1]) & (j == idx[w2])]
        if rows.sum() != 2 or not np.array_equal(
                np.sort(got), np.sort(lp[rows] * math.log(10.0))):
            raise AssertionError(f"bigram {w1} {w2}: {got} are not its two "
                                 f"lines {lp[rows]}")
    log(f"the {len(dup_bi)} duplicated bigrams reach compile_lv_loop as two "
        "entries each, as from htk_tpu's codec (the LV loop takes the "
        "larger; a dict reader keeps the last)")
    # last: reading a packed LM's dicts makes its array views follow them
    t0 = time.perf_counter()
    for k in ("unigrams", "bigrams", "trigrams", "tri_bo"):
        if getattr(lm, k) != getattr(dict_lm, k):
            raise AssertionError(f"ARPA: the codec LM's {k} != the Python "
                                 "reader's")
    log(f"ARPA codec LM's dicts == the Python reader's (a duplicate's last "
        f"line in both; compared in {time.perf_counter() - t0:.2f} s)")
    log(f"ARPA walls on {card}'s host (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items())
        + f"; codec / Python reader "
        f"{walls['read_arpa_plain (dicts)'] / walls['read_arpa (codec)']:.2f}x")
    return walls


def phase_native_corpus(root, card):
    """32(c): preload_corpus on 2,000 _C files against the per-file reader;
    32(d) the MLF scanner on their MLF."""
    c = NATIVE_CORPUS
    d = os.path.join(root, "native_corpus")
    os.makedirs(d)
    rng = np.random.default_rng(c["seed"])
    kind = pk.str2parmkind(NATIVE_KIND)
    paths = []
    t0 = time.perf_counter()
    for n in range(c["n"]):
        x = (rng.normal(size=(c["frames"], c["dim"])) * 6).astype(np.float32)
        paths.append(os.path.join(d, f"u{n:04d}.mfc"))
        write_htk_file(paths[-1], x, 100000, kind)
    log(f"corpus written in {time.perf_counter() - t0:.2f} s: {c['n']} "
        f"{NATIVE_KIND} files of {c['frames']} x {c['dim']}")
    cfg = Config()
    pre, t_pre = timed(preload_corpus, paths, cfg)
    per, t_per = timed(lambda: [open_speech_file(p, cfg) for p in paths])
    if set(pre) != set(paths):
        raise AssertionError(f"preload_corpus covered {len(pre)} of "
                             f"{len(paths)} files")
    off, worst = 0, 0.0
    for p, (data, period, pkind, e) in zip(paths, per):
        got = pre[p]
        if got[1:3] != (period, pkind) or got[3].logical != e.logical:
            raise AssertionError(f"{p}: preload's period/kind/entry differ")
        # the codec's arithmetic in numpy: (q + B) / A in float32
        raw = open(p, "rb").read()
        w = c["dim"]
        A = np.frombuffer(raw[12:12 + 4 * w], ">f4").astype(np.float32)
        B = np.frombuffer(raw[12 + 4 * w:12 + 8 * w], ">f4").astype(
            np.float32)
        q = np.frombuffer(raw[12 + 8 * w:], ">i2").reshape(-1, w).astype(
            np.float32)
        if not np.array_equal(got[0], (q + B) / A):
            raise AssertionError(f"{p}: preload != (q + B) / A in float32")
        step = np.spacing(np.abs(data))
        if not (np.abs(got[0] - data) <= step).all():
            raise AssertionError(f"{p}: preload more than a float32 "
                                 "rounding off open_speech_file")
        off += int((got[0] != data).sum())
        worst = max(worst, float(np.abs(got[0] - data).max()))
    total = c["n"] * c["frames"] * c["dim"]
    log(f"preload_corpus == (q + B) / A in float32 bit for bit on all "
        f"{c['n']} files; against open_speech_file (float64 division) "
        f"{off} of {total} values one float32 rounding apart (max |d| "
        f"{worst:.3g}), the rest equal")
    log(f"corpus walls on {card}'s host: preload_corpus {t_pre:.3f} s, "
        f"open_speech_file per file {t_per:.3f} s ({t_per / t_pre:.2f}x)")
    mlf = os.path.join(d, "corpus.mlf")
    with open(mlf, "w") as f:
        f.write("#!MLF!#\n")
        for n in range(c["n"]):
            f.write(f'"*/u{n:04d}.lab"\n')
            f.write("".join(f"{k * 100000} {(k + 1) * 100000} p{k % 40}\n"
                            for k in range(0, c["frames"], 10)))
            f.write(".\n")
    return t_pre, t_per, mlf


def phase_native_mlf(mlfs, card):
    """32(d): MLF.read's scanner leg against the pure parse."""
    walls = []
    for path in mlfs:
        data = open(path, "rb").read()
        scanned, pure = MLF(), MLF()
        took, t_scan = timed(scanned._read_native, data)
        if not took:
            raise AssertionError(f"{path}: the scanner declined the file")
        _, t_pure = timed(pure._read_pure, data, path)
        if mlf_view(scanned) != mlf_view(pure):
            raise AssertionError(f"{path}: scanner entries != pure parse's")
        log(f"MLF {os.path.basename(path)} ({len(scanned.entries)} entries, "
            f"{len(data) / 1e6:.2f} MB): scanner == pure parse; walls on "
            f"{card}'s host: scanner {t_scan:.4f} s, pure {t_pure:.4f} s "
            f"({t_pure / t_scan:.2f}x)")
        walls.append((t_scan, t_pure))
    return walls


@contextlib.contextmanager
def no_preload():
    """HVite and HERest read every file through open_speech_file inside."""
    saved = hvite.preload_corpus, herest.preload_corpus
    hvite.preload_corpus = herest.preload_corpus = lambda files, cfg: {}
    try:
        yield
    finally:
        hvite.preload_corpus, herest.preload_corpus = saved


def run_hvite_herest(sysm, root, tag, scp, train_scp):
    """HVite as phase 5 runs it and HERest's first iteration as phase 6
    runs it, over `scp`/`train_scp`; returns (rec.mlf, MMF) paths."""
    rec = os.path.join(root, f"rec_{tag}.mlf")
    argv = ["-T", "1", "-C", os.path.join(root, "hvite.cfg"), "-w",
            sysm.wdnet, "-H", sysm.hmmdefs, "-i", rec, "-s", str(LM_SCALE),
            "-p", str(WORD_PEN), "-S", scp, sysm.dict, sysm.hmmlist]
    if hvite.run(argv) != 0:
        raise RuntimeError(f"HVite ({tag}) returned non-zero")
    out = os.path.join(root, f"hmm_{tag}")
    os.makedirs(out)
    argv = ["-T", "1", "-B", "-b", str(HEREST_BATCH), "-H", sysm.hmmdefs,
            "-M", out, "-S", train_scp, "-I", sysm.train_mlf, sysm.hmmlist]
    if herest.run(argv) != 0:
        raise RuntimeError(f"HERest ({tag}) returned non-zero")
    return rec, os.path.join(out, os.path.basename(sysm.hmmdefs))


def mlf_view(m):
    """An MLF's entries: pattern, then each alternative's labels."""
    return [(p, [[(lab.name, lab.start, lab.end, lab.score, lab.aux)
                  for lab in alt] for alt in tr.alternatives])
            for p, tr in m.entries]


def model_gap(a, b) -> float:
    """The largest difference of two MMFs' Gaussians, weights and
    transitions, each over its array's largest magnitude."""
    ca, cb = (compile_hmmset(load_mmf([p])) for p in (a, b))
    gap = 0.0
    for k in ("means", "variances", "state_logw", "log_transp"):
        x, y = (np.asarray(getattr(c, k), np.float64) for c in (ca, cb))
        live = np.isfinite(x) & (x > LZERO / 2)
        if not np.array_equal(live, np.isfinite(y) & (y > LZERO / 2)):
            raise AssertionError(f"{k}: live entries differ")
        if live.any():
            gap = max(gap, float(np.abs(x[live] - y[live]).max()
                                 / np.abs(x[live]).max()))
    return gap


def phase_native_tools(sysm, root, card):
    """32(e): HVite and HERest with preload on. Over config #4's float
    files (which preload leaves to the per-file reader) their outputs are
    phase 5's rec.mlf and phase 6's first MMF byte for byte; over a _C
    copy of the corpus (every file preloaded), preload against the
    per-file path: the same words and times, scores and models within
    float32 rounding of the features."""
    t0 = time.perf_counter()
    rec, mmf = run_hvite_herest(sysm, root, "preload_float", sysm.scp,
                                sysm.train_scp)
    wall_float = time.perf_counter() - t0
    ref = os.path.join(root, "rec.mlf")
    if open(rec, "rb").read() != open(ref, "rb").read():
        raise AssertionError(f"{rec} != {ref} byte for byte")
    ref = os.path.join(root, "hmm1", os.path.basename(sysm.hmmdefs))
    rerun = model_gap(mmf, ref)
    if rerun > HEREST_RERUN_TOL:
        raise AssertionError(f"{mmf}: {rerun:.3g} of scale off phase 6's")
    same = open(mmf, "rb").read() == open(ref, "rb").read()
    log("HVite and HERest iteration 1 with preload over config #4's files "
        "(none covered): rec.mlf == phase 5's byte for byte; the MMF "
        f"{rerun:.3g} of scale off phase 6's (bytes "
        f"{'equal' if same else 'differ'}; {wall_float:.2f} s)")
    cdir = os.path.join(root, "c4_compressed")
    os.makedirs(cdir)
    moved = {}
    for p in sysm.feats:
        ff = read_htk_file(p)
        q = os.path.join(cdir, os.path.basename(p))
        write_htk_file(q, ff.data, ff.samp_period,
                       ff.parm_kind | pk.HASCOMPX)
        moved[p] = q
    scps = []
    for s in (sysm.scp, sysm.train_scp):
        out = os.path.join(cdir, os.path.basename(s))
        with open(s) as f, open(out, "w") as g:
            for line in f:
                g.write(moved.get(line.strip(), line.strip()) + "\n")
        scps.append(out)
    if len(preload_corpus(list(moved.values()), Config())) != len(moved):
        raise AssertionError("preload did not cover the _C copy")
    walls = {}
    t0 = time.perf_counter()
    rec_pre, mmf_pre = run_hvite_herest(sysm, root, "preload_c", *scps)
    walls["preload"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with no_preload():
        rec_per, mmf_per = run_hvite_herest(sysm, root, "perfile_c", *scps)
    walls["per file"] = time.perf_counter() - t0
    a, b = (mlf_view(MLF.load(r)) for r in (rec_pre, rec_per))

    def words_times(view):
        return [(p, [[lab[:3] for lab in alt] for alt in alts])
                for p, alts in view]

    if words_times(a) != words_times(b):
        raise AssertionError("HVite on _C files: words or times differ "
                             "between preload and per file")
    sgap = max((abs(x[3] - y[3]) / max(abs(y[3]), 1.0)
                for (_p, xa), (_q, ya) in zip(a, b)
                for xs, ys in zip(xa, ya) for x, y in zip(xs, ys)
                if x[3] is not None), default=0.0)
    if sgap > HVITE_SCORE_RTOL:
        raise AssertionError(f"HVite on _C files: scores {sgap:.3g} apart")
    same_bytes = open(rec_pre, "rb").read() == open(rec_per, "rb").read()
    mgap = model_gap(mmf_pre, mmf_per)
    if mgap > HEREST_MODEL_TOL:
        raise AssertionError(f"HERest on _C files: models {mgap:.3g} of "
                             "scale apart")
    mmf_same = open(mmf_pre, "rb").read() == open(mmf_per, "rb").read()
    log(f"HVite and HERest iteration 1 over the _C copy ({len(moved)} "
        f"files, all preloaded) on {card}: words and times == per file, "
        f"scores {sgap:.3g} apart (rec.mlf bytes "
        f"{'equal' if same_bytes else 'differ'}), MMFs {mgap:.3g} of scale "
        f"apart (bytes {'equal' if mmf_same else 'differ'}); walls: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()))


def phase_native(sysm, big, root, card):
    """Phase 32: the host runtime in C++ (htk_tpu_torch/native)."""
    log(f"host runtime builds (phase 1, g++): " + ", ".join(
        f"{n} {native.BUILD_SECONDS[n]:.2f} s -> {native.library_path(n)}"
        for n in ("htkio", "htknative")))
    walls = phase_native_arpa(big, root, card)
    t_pre, t_per, mlf = phase_native_corpus(root, card)
    phase_native_mlf([sysm.train_mlf, mlf], card)
    phase_native_tools(sysm, root, card)
    return walls, t_pre, t_per


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
        lv_step = phase_lv_step(big, bnet, card, dev)
        done("uniform step kernel")
        lstmp = phase_lstmp(card, dev)
        done("LSTMP cell kernel")
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
        work = os.path.join(root, "full")
        full_launches = phase_full(work, card, dev)
        done("full recipe twin")
        sk_launches, sk_ferr, sk_derr = phase_setkinds(sysm, root, card, dev)
        done("set kinds")
        lv_launches, lv_err, lv_times, lv_bound = phase_live(
            sysm, hyps, net, comp, feats, work, card, dev)
        done("live mode")
        md_launches, md_dry, md_err = phase_multidevice(sysm, root, card,
                                                        dev)
        done("multi-device")
        phase_native(sysm, big, root, card)
        done("native host runtime")
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
    log(f"set-kind paths on {card}: launches under phase 29 {sk_launches}; "
        f"kernel against plain on FULLC, discrete and -r inputs: max |d| "
        f"fb_scans {sk_ferr:.3g}, decode_scan {sk_derr:.3g}")
    log(f"live paths on {card}: decode_scan launches under phase 30 "
        f"{lv_launches} (phase 5's HVite: {launches}); at the live chunk "
        f"(B=1, T={LIVE_CHUNK}) {lv_times[0]:.6f} ms a launch (plain "
        f"{lv_times[1]:.3f}, bound {lv_bound[0]:.6f} by {lv_bound[1]}); "
        f"kernel against plain with a carry: max |d| {lv_err:.3g}")
    log(f"multi-device paths on {card}: fb_scans launches under phase "
        f"31(a)'s ShardedTrainer {md_launches}, under the dry run "
        f"{md_dry[0]}; decode_scan launches under the dry run {md_dry[1]}; "
        f"fb_scans kernel against plain on a padded shard: max |d| "
        f"{md_err:.3g}")
    log(f"chip_smoke: {time.perf_counter() - t_all:.1f} s in all")
    log(card)
    xs = "htk_tpu_torch/csrc/xw_gather.cu"
    print(json.dumps({"kernels": [
        kernel_entry("decode_scan", "htk_tpu_torch/csrc/decode_scan.cu",
                     "htk_tpu/ops/decode_pallas.py:137",
                     launches + sum(lv_launches.values()),
                     max(err, e2, dnn_derr, demo_launches[5], ad_derr,
                         sk_derr, lv_err),
                     (kms, pms),
                     dbound),
        kernel_entry("fb_scans", "htk_tpu_torch/csrc/fb_scans.cu",
                     "htk_tpu/ops/fb_pallas.py:127", fb_launches,
                     max(fb_err, fb_err2, mmi_err, dnn_ferr,
                         demo_launches[6], ad_ferr, sk_ferr, md_err),
                     (fkms, fpms),
                     fbound),
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
        kernel_entry("lv_step", "htk_tpu_torch/csrc/lv_step.cu",
                     "htk_tpu/algo/decode.py : _make_uniform_step (XLA, "
                     "no Pallas kernel)", *lv_step),
        kernel_entry("lstmp_cell", "htk_tpu_torch/csrc/lstmp_cell.cu",
                     "none (htk_tpu has no recurrent layer)", *lstmp),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
