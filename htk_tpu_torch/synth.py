"""Synthetic recognition systems written to disk, for smoke runs and tests.

Builds, from a numpy seed, everything HVite `-w` and HERest need, in the
port's own file writers:

  hmmdefs    a tied-state word-internal triphone set: a pool of `n_tied`
             shared `n_mix`-mixture diagonal-Gaussian states (~s macros,
             the decision-tree tying outcome), each triphone a 5-state
             left-to-right model drawing its 3 emitting states from the
             pool (the shape of htk_tpu's bench.py config #4)
  dict       a random 3-5 phone monophone lexicon (HVite expands it to
             word-internal triphones)
  hmmlist    the triphone names
  wdnet.slf  a back-off bigram word network in the shape of HBuild's
             (htk_tpu/tools/hbuild.py : bigram_lattice): sentence start
             and end !NULL nodes, one !NULL back-off node, and about
             `fanout` favoured explicit successors per word
  lm.arpa    the same back-off bigram LM as ARPA tables, for the
             uniform-row LV decoder (algo/lvnet.compile_lv_loop); it
             draws no random numbers of its own
  *.mfc      utterances synthesised from the state means plus Gaussian
             noise, 3 frames per state, as MFCC_E_D_A feature files
  test.scp   the feature files
  train.mlf  each utterance's word-internal triphones, as HERest's
             phone-level transcriptions (-I)
  train.scp  the feature files again, as HERest's training script (-S)

At the defaults (1,000 words, 40 phones, 2,000 tied 8-mixture states,
39 dims) this is htk_tpu's BASELINE config #4 system.

`lv_system` builds the same shape of system in memory at any vocabulary
(htk_tpu's bench.py `build_tied_triphone_system`, the big-vocabulary and
trigram-guidance rows), for the LV decoder's factored legs.

`random_decode_net` makes the operands of one decode recursion directly
(a random general net and its observation scores), for holding the
decode kernel against its plain version; `random_fb_operands` does the
same for the forward-backward scans, `random_maxplus_operands` for the
max-plus cross-word product, `random_xw_operands` for the segmented
max-plus and gather-add of the factored cross-word leg.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from .io.dictionary import Vocab
from .io.htkfeat import write_htk_file
from .io.lm import NGramLM, write_arpa
from .io.mmf import HMMDef, HMMSet, MixPDF, StateInfo, StreamElem, save_mmf
from .io.parmkind import str2parmkind
from .io.slf import LArc, LNode, Lattice, NULL_WORD, write_slf
from .models.hmmset import CompiledHMMSet, compile_hmmset
from .utils.logmath import LZERO

PARM_KIND = "MFCC_E_D_A"
FRAME_PERIOD = 100000  # 10 ms in 100 ns units
NOISE = 1.0  # std of the Gaussian noise added to state means per frame


@dataclass
class System:
    """Paths of a written system and what its utterances say."""

    root: str
    hmmdefs: str
    dict: str
    hmmlist: str
    wdnet: str
    scp: str
    train_mlf: str
    train_scp: str
    lm: str
    feats: List[str] = field(default_factory=list)
    transcripts: List[List[str]] = field(default_factory=list)
    n_frames: List[int] = field(default_factory=list)


def internal_triphones(phones: Sequence[str]) -> List[str]:
    """Word-internal context names: l-p+r inside, biphones at the edges."""
    out = []
    n = len(phones)
    for k, p in enumerate(phones):
        l = phones[k - 1] if k > 0 else None
        r = phones[k + 1] if k < n - 1 else None
        if l and r:
            out.append(f"{l}-{p}+{r}")
        elif r:
            out.append(f"{p}+{r}")
        elif l:
            out.append(f"{l}-{p}")
        else:
            out.append(p)
    return out


def left_to_right_transp(nstates: int, self_prob: float = 0.6) -> np.ndarray:
    """N-state left-to-right transition matrix (entry 1, exit N)."""
    tp = np.zeros((nstates, nstates), np.float32)
    tp[0, 1] = 1.0
    for i in range(1, nstates - 1):
        tp[i, i] = self_prob
        tp[i, i + 1] = 1.0 - self_prob
    return tp


def build_hmmset(rng, n_words: int, n_phones: int, n_tied: int, n_mix: int,
                 dim: int) -> Tuple[HMMSet, Dict[str, List[str]]]:
    """The tied-state triphone set and the monophone lexicon."""
    phones = [f"p{i}" for i in range(n_phones)]
    lex: Dict[str, List[str]] = {}
    for i in range(n_words):
        n_ph = int(rng.integers(3, 6))
        lex[f"w{i}"] = [phones[j] for j in rng.integers(0, n_phones, n_ph)]
    tri_names = sorted({t for ph in lex.values()
                        for t in internal_triphones(ph)})

    hset = HMMSet(vec_size=dim, parm_kind=str2parmkind(PARM_KIND))
    for k in range(n_tied):
        se = StreamElem(
            weights=[1.0 / n_mix] * n_mix,
            mixes=[MixPDF(mean=(rng.normal(size=dim) * 2).astype(np.float32),
                          var=(0.5 + rng.random(dim)).astype(np.float32))
                   for _ in range(n_mix)])
        for mp in se.mixes:
            mp.fix_gconst()
        hset.macros["s"][f"st{k}"] = StateInfo(streams=[se])
    pool = list(hset.macros["s"].values())
    tp = left_to_right_transp(5)
    hset.macros["t"]["trP"] = tp
    for name in tri_names:
        picks = rng.integers(0, n_tied, 3)
        hset.hmms[name] = HMMDef(name=name, nstates=5,
                                 states=[pool[k] for k in picks], transp=tp)
    return hset, lex


def bigram_successors(rng, V: int, fanout: int) -> List[List[int]]:
    """Each word's explicit bigram successors: `fanout` draws, deduplicated
    and sorted."""
    return [sorted(set(int(x) for x in rng.integers(0, V, fanout)))
            for _ in range(V)]


def bigram_network(words: List[str], succ: List[List[int]],
                   fanout: int) -> Lattice:
    """Back-off bigram word network (HBuild's layout).

    Node ids: 0 sentence start, 1 back-off, 2 sentence end, words from 3.
    Unigrams are log(0.5 / V), every back-off weight log(0.5), the
    explicit bigrams (word k to each of succ[k]) log(0.4 / fanout);
    sentence entry and exit go through the back-off (log 0.5 + unigram),
    as for a start word with no explicit bigrams."""
    V = len(words)
    uni = math.log(0.5 / V)
    bow = math.log(0.5)
    lat = Lattice()
    for i in range(3):
        lat.nodes.append(LNode(id=i, word=NULL_WORD))
    for k, w in enumerate(words):
        lat.nodes.append(LNode(id=3 + k, word=w))

    def arc(s, e, p):
        lat.arcs.append(LArc(id=len(lat.arcs), start=s, end=e, lmlike=p))

    for k in range(V):
        arc(0, 3 + k, bow + uni)
    for k in range(V):
        for j in succ[k]:
            arc(3 + k, 3 + j, math.log(0.4 / fanout))
    for k in range(V):
        arc(3 + k, 1, bow)
        arc(1, 3 + k, uni)
    for k in range(V):
        arc(3 + k, 2, bow + uni)
    return lat


def bigram_lm(words: List[str], succ: List[List[int]],
              fanout: int) -> NGramLM:
    """The back-off bigram LM that `bigram_network` encodes, as ARPA
    tables (the shape of htk_tpu's bench.py build_tied_triphone_system):
    unigrams log(0.5 / V) with back-off log 0.5, the explicit bigrams
    log(0.4 / fanout), !ENTER (-99, log 0.5) and !EXIT (log(0.5 / V), 0)."""
    V = len(words)
    uni = math.log(0.5 / V)
    lm = NGramLM(order=2)
    for w in words:
        lm.unigrams[w] = (uni, math.log(0.5))
    lm.unigrams["!ENTER"] = (-99.0, math.log(0.5))
    lm.unigrams["!EXIT"] = (uni, 0.0)
    for k, w in enumerate(words):
        for j in succ[k]:
            lm.bigrams[(w, words[j])] = (math.log(0.4 / fanout), 0.0)
    return lm


def synth_utterance(rng, hset: HMMSet, lex: Dict[str, List[str]],
                    words: List[str], min_frames: int,
                    max_frames: int) -> Tuple[np.ndarray, List[str]]:
    """Frames walked from state means (first mixture) plus noise, 3 per
    state, word by word until at least `min_frames`; the result is cut
    to at most `max_frames` only at a word boundary (words are added
    while they fit)."""
    target = int(rng.integers(min_frames, max_frames + 1))
    frames: List[np.ndarray] = []
    seq: List[str] = []
    while True:
        w = words[int(rng.integers(0, len(words)))]
        wf = []
        for tri in internal_triphones(lex[w]):
            for si in hset.hmms[tri].states:
                mu = np.asarray(si.streams[0].mixes[0].mean, np.float64)
                for _ in range(3):
                    wf.append(mu + NOISE * rng.normal(size=mu.shape))
        if seq and len(frames) + len(wf) > max_frames:
            break
        seq.append(w)
        frames.extend(wf)
        if len(frames) >= target:
            break
    return np.stack(frames).astype(np.float32), seq


def write_system(root: str, n_words: int = 1000, n_phones: int = 40,
                 n_tied: int = 2000, n_mix: int = 8, dim: int = 39,
                 n_utts: int = 16, min_frames: int = 440,
                 max_frames: int = 512, fanout: int = 20, seed: int = 0,
                 binary_mmf: bool = True) -> System:
    """Write a complete HVite -w and HERest system under `root` (made if
    missing)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    hset, lex = build_hmmset(rng, n_words, n_phones, n_tied, n_mix, dim)
    words = list(lex)
    sysm = System(root=root,
                  hmmdefs=os.path.join(root, "hmmdefs"),
                  dict=os.path.join(root, "dict"),
                  hmmlist=os.path.join(root, "hmmlist"),
                  wdnet=os.path.join(root, "wdnet.slf"),
                  scp=os.path.join(root, "test.scp"),
                  train_mlf=os.path.join(root, "train.mlf"),
                  train_scp=os.path.join(root, "train.scp"),
                  lm=os.path.join(root, "lm.arpa"))
    save_mmf(hset, sysm.hmmdefs, binary=binary_mmf)
    with open(sysm.dict, "w") as f:
        for w in words:
            f.write(f"{w} {' '.join(lex[w])}\n")
    with open(sysm.hmmlist, "w") as f:
        f.write("".join(f"{n}\n" for n in hset.hmms))
    succ = bigram_successors(rng, len(words), fanout)
    write_slf(bigram_network(words, succ, fanout), sysm.wdnet)
    write_arpa(bigram_lm(words, succ, fanout), sysm.lm)

    kind = str2parmkind(PARM_KIND)
    for u in range(n_utts):
        x, seq = synth_utterance(rng, hset, lex, words, min_frames,
                                 max_frames)
        path = os.path.join(root, f"utt{u:03d}.mfc")
        write_htk_file(path, x, FRAME_PERIOD, kind)
        sysm.feats.append(path)
        sysm.transcripts.append(seq)
        sysm.n_frames.append(int(x.shape[0]))
    for path in (sysm.scp, sysm.train_scp):
        with open(path, "w") as f:
            f.write("".join(f"{p}\n" for p in sysm.feats))
    with open(sysm.train_mlf, "w") as f:
        f.write("#!MLF!#\n")
        for path, seq in zip(sysm.feats, sysm.transcripts):
            stem = os.path.splitext(os.path.basename(path))[0]
            tris = [t for w in seq for t in internal_triphones(lex[w])]
            f.write(f'"*/{stem}.lab"\n' + "".join(f"{t}\n" for t in tris)
                    + ".\n")
    return sysm


def write_word_mlf(sysm: System, path: str) -> str:
    """The utterances' word transcriptions as a word-level MLF (HVite -a's
    input); returns `path`."""
    with open(path, "w") as f:
        f.write("#!MLF!#\n")
        for p, seq in zip(sysm.feats, sysm.transcripts):
            stem = os.path.splitext(os.path.basename(p))[0]
            f.write(f'"*/{stem}.lab"\n' + "".join(f"{w}\n" for w in seq)
                    + ".\n")
    return path


class LVSystem(NamedTuple):
    """An in-memory LV system and what its utterances say."""

    comp: CompiledHMMSet
    vocab: Vocab  # words -> word-internal triphone pronunciations
    words: List[str]
    lm: NGramLM
    feats: List[np.ndarray]  # (T, dim) float32 each
    truths: List[List[str]]


def lv_system(n_words: int, n_tied: int = 2000, n_mix: int = 8,
              dim: int = 39, n_phones: int = 40, lm_order: int = 2,
              fanout: int = 20, n_utts: int = 16, min_frames: int = 440,
              max_frames: int = 512, seed: int = 0) -> LVSystem:
    """The shape of htk_tpu's bench.py `build_tied_triphone_system`, built
    in memory: the tied-state triphone set and 3-5 phone lexicon of
    `write_system` (pronunciations written as their word-internal
    triphones, so compile_lv_loop needs no phone map), the back-off bigram
    of `bigram_lm` (about `fanout` explicit successors a word), and
    utterances synthesised as `write_system`'s. With `lm_order=3` every
    bigram gets back-off weight log 0.3 and about 8 explicit trigram
    successors of log(0.5 / 8) (bench.py's trigram-guidance testbed)."""
    rng = np.random.default_rng(seed)
    hset, lex = build_hmmset(rng, n_words, n_phones, n_tied, n_mix, dim)
    words = list(lex)
    vocab = Vocab()
    for w in words:
        vocab.add_pron(w, internal_triphones(lex[w]))
    lm = bigram_lm(words, bigram_successors(rng, n_words, fanout), fanout)
    if lm_order >= 3:
        lm.order = 3
        bow, tri_fan = math.log(0.3), 8
        for key in list(lm.bigrams):
            lm.bigrams[key] = (lm.bigrams[key][0], bow)
        for u, v in list(lm.bigrams):
            for j in sorted(set(int(x) for x in
                                rng.integers(0, n_words, tri_fan))):
                lm.trigrams[(u, v, words[j])] = math.log(0.5 / tri_fan)
    feats, truths = [], []
    for _ in range(n_utts):
        x, seq = synth_utterance(rng, hset, lex, words, min_frames,
                                 max_frames)
        feats.append(x)
        truths.append(seq)
    return LVSystem(compile_hmmset(hset), vocab, words, lm, feats, truths)


def word_accuracy(refs: List[List[str]], hyps: List[List[str]]) -> float:
    """HResults word accuracy (N - S - D - I) / N, in percent, from a
    minimum-edit alignment of each reference with its hypothesis."""
    n = errs = 0
    for r, h in zip(refs, hyps):
        d = np.arange(len(h) + 1)
        for i in range(1, len(r) + 1):
            prev, d = d, np.empty_like(d)
            d[0] = i
            for j in range(1, len(h) + 1):
                d[j] = min(prev[j] + 1, d[j - 1] + 1,
                           prev[j - 1] + (r[i - 1] != h[j - 1]))
        n += len(r)
        errs += int(d[-1])
    return 100.0 * (n - errs) / max(n, 1)


def random_decode_net(seed: int = 0, Ns: int = 30, Nn: int = 5, K: int = 3,
                      B: int = 2, T: int = 20, ties: bool = False):
    """Random decode-recursion operands (numpy, float32 / int32):
    (node_of_state, outp, band, a0, aE, bonus, trans, start).

    States sort into nodes; band and trans are sparse (LZERO elsewhere);
    each node is entered at its first state and left at its last; node 0
    can start. `ties=True` draws every score from {0, -1, -2}, so equal
    candidates are everywhere and the tie rules of the recursion (first
    state, first source node, first band offset) decide the records."""
    rng = np.random.default_rng(seed)
    node_of_state = np.sort(rng.integers(0, Nn, Ns)).astype(np.int32)

    def score(shape):
        if ties:
            return -rng.integers(0, 3, shape).astype(np.float64)
        return -rng.random(shape)

    if ties:
        outp = score((B, T, Ns))
    else:
        outp = rng.normal(size=(B, T, Ns)) * 2
    band = np.where(rng.random((K, Ns)) < 0.7, score((K, Ns)), LZERO)
    band[0] = -1.0 if ties else -0.5
    trans = np.where(rng.random((Nn, Nn)) < 0.5, score((Nn, Nn)), LZERO)
    exit_lp = 0.0 if ties else -0.1
    a0 = np.where(rng.random(Ns) < 0.3, 0.0, LZERO)
    aE = np.where(rng.random(Ns) < 0.3, 2 * exit_lp, LZERO)
    start = np.where(rng.random(Nn) < 0.5, 0.0, LZERO)
    start[0] = 0.0
    for n in range(Nn):
        sel = np.where(node_of_state == n)[0]
        if len(sel):
            a0[sel[0]] = 0.0
            aE[sel[-1]] = exit_lp
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (node_of_state, f(outp), f(band), f(a0), f(aE), f(np.zeros(Ns)),
            f(trans), f(start))


def random_fb_operands(seed: int = 0, B: int = 3, T: int = 40, Q: int = 50,
                       t_real: Sequence[int] = (), dead: int = 4):
    """Random forward-backward operands (numpy): outp (B, T, Q), logA
    (B, Q, Q), a0, aE (B, Q) f32 and t_real (B,) int32.

    Each composite is banded like an utterance HMM (self-loops and forward
    links up to 6 states on, with a few random long links; LZERO
    elsewhere), entered in its first 6 states and left from its last 6
    live ones; its last `dead` states are padding (LZERO outp, rows and
    columns), as in a padded batch. `t_real` defaults to T for every
    row."""
    rng = np.random.default_rng(seed)
    live = Q - dead
    i = np.arange(Q)[:, None]
    j = np.arange(Q)[None, :]
    band = (j - i >= 0) & (j - i <= 6)
    logA = np.full((B, Q, Q), LZERO)
    a0 = np.full((B, Q), LZERO)
    aE = np.full((B, Q), LZERO)
    for b in range(B):
        on = (band & (rng.random((Q, Q)) < 0.7)) | (rng.random((Q, Q)) < 0.02)
        on[live:] = False
        on[:, live:] = False
        logA[b] = np.where(on, np.log(rng.uniform(0.05, 1.0, (Q, Q))), LZERO)
        a0[b, :min(6, live)] = np.log(rng.uniform(0.05, 1.0, min(6, live)))
        aE[b, max(0, live - 6):live] = np.log(
            rng.uniform(0.05, 1.0, live - max(0, live - 6)))
    outp = rng.normal(size=(B, T, Q)) * 2 - 4
    outp[:, :, live:] = LZERO
    tr = np.asarray(list(t_real) or [T] * B, np.int32)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f(outp), f(logA), f(a0), f(aE), tr


def random_sparse_fb_operands(seed: int = 0, B: int = 1, T: int = 64,
                              Q: int = 20480, t_real: Sequence[int] = (),
                              links: int = 8, hubs: int = 4):
    """Random forward-backward operands for a large composite (numpy):
    outp (B, T, Q), logA as its live cells (b, i, j, value) with (b, i, j)
    ascending, a0, aE (B, Q) f32 and t_real (B,) int32; every other cell
    of logA is LZERO (a wide composite is built on its device from these,
    never as a dense numpy array).

    Each composite has self-loops and links to the next two states,
    `links` x Q random links, and `hubs` states whose row and column are
    each live at half their cells (lists of about Q / 2 entries in both
    directions); it is entered in its first 6 states and left from its
    last 6. `t_real` defaults to T for every row."""
    rng = np.random.default_rng(seed)
    q = np.arange(Q)
    cells = []
    for b in range(B):
        rows = [q, q[:-1], q[:-2], rng.integers(0, Q, links * Q)]
        cols = [q, q[1:], q[2:], rng.integers(0, Q, links * Q)]
        for h in rng.choice(Q, min(hubs, Q), replace=False):
            k = np.flatnonzero(rng.random(Q) < 0.5)
            rows += [np.full(len(k), h), k]
            cols += [k, np.full(len(k), h)]
        lin = np.unique(np.concatenate(rows) * Q + np.concatenate(cols))
        cells.append((np.full(len(lin), b), lin // Q, lin % Q))
    bb, ii, jj = (np.concatenate(x).astype(np.int64) for x in zip(*cells))
    vals = np.log(rng.uniform(0.05, 1.0, len(bb))).astype(np.float32)
    a0 = np.full((B, Q), LZERO, np.float32)
    aE = np.full((B, Q), LZERO, np.float32)
    n = min(6, Q)
    a0[:, :n] = np.log(rng.uniform(0.05, 1.0, (B, n)))
    aE[:, Q - n:] = np.log(rng.uniform(0.05, 1.0, (B, n)))
    outp = (rng.normal(size=(B, T, Q)) * 2 - 4).astype(np.float32)
    tr = np.asarray(list(t_real) or [T] * B, np.int32)
    return outp, (bb, ii, jj, vals), a0, aE, tr


def random_maxplus_operands(seed: int = 0, B: int = 4, C: int = 50,
                            ties: bool = False, dead_rows: int = 0):
    """Random max-plus operands (numpy float32): WE (B, C) and trans
    (C, C), as the LV decoder's cross-word step sees them.

    trans holds LZERO at about a tenth of its cells (forbidden word
    pairs); WE holds 2*LZERO (a dead word end) at about a fifth. The last
    `dead_rows` rows of WE are dead throughout, so every candidate of
    their targets is at or below LZERO, where the floored and unfloored
    contracts differ. `ties=True` draws every live score from {0, -1,
    -2}, so equal candidates are everywhere and the first-max rule
    decides the argmax."""
    rng = np.random.default_rng(seed)

    def score(shape):
        if ties:
            return -rng.integers(0, 3, shape).astype(np.float64)
        return rng.normal(size=shape) * 4 - 10

    WE = np.where(rng.random((B, C)) < 0.2, 2 * LZERO, score((B, C)))
    if dead_rows:
        WE[B - dead_rows:] = 2 * LZERO
    trans = np.where(rng.random((C, C)) < 0.1, LZERO, score((C, C)))
    return WE.astype(np.float32), trans.astype(np.float32)


def random_xw_operands(seed: int = 0, B: int = 4, C: int = 50,
                       n_slots: int = 0, ties: bool = False,
                       dead_rows: int = 0):
    """Random segmented max-plus operands (numpy): WE (B, C) float32, preds
    (N,) int32, scores (N,) float32, seg_off (C+1,) int32 and out_row (C,)
    int32 (a permutation), as the factored cross-word leg sees them.

    Segment widths are 0 or 1 for a tenth of the C segments each and 4-64
    for the rest; then segments of 500-700 slots replace random ones, one
    for every 600 slots by which `n_slots` exceeds that total (so the
    total comes to about `n_slots`). Slots name random source rows; a
    tenth of the scores are LZERO (pads). WE holds 2*LZERO at about a fifth
    of its cells and in its last `dead_rows` rows. `ties=True` draws every
    live score from {0, -1, -2}, so the first-slot rule decides the
    argmax."""
    rng = np.random.default_rng(seed)

    def score(shape):
        if ties:
            return -rng.integers(0, 3, shape).astype(np.float64)
        return rng.normal(size=shape) * 4 - 10

    kind = rng.random(C)
    width = np.where(kind < 0.1, 0, np.where(kind < 0.2, 1,
                                             rng.integers(4, 65, C)))
    n_long = max(0, min(C, (n_slots - int(width.sum())) // 600))
    if n_long:
        width[rng.choice(C, n_long, replace=False)] = rng.integers(
            500, 701, n_long)
    N = int(width.sum())
    preds = rng.integers(0, C, N)
    scores = np.where(rng.random(N) < 0.1, LZERO, score(N))
    seg_off = np.concatenate([[0], np.cumsum(width)])
    WE = np.where(rng.random((B, C)) < 0.2, 2 * LZERO, score((B, C)))
    if dead_rows:
        WE[B - dead_rows:] = 2 * LZERO
    return (WE.astype(np.float32), preds.astype(np.int32),
            scores.astype(np.float32), seg_off.astype(np.int32),
            rng.permutation(C).astype(np.int32))
