"""Recognition systems and utterances made from a seed: the one generator
every cell's traffic goes through.

A frozen copy of the generators of the port's `synth.py` (`build_hmmset`,
`bigram_successors`, `bigram_lm`'s weights, `synth_utterance`), rebuilt for
the benchmark so that a later change to the program cannot move it:

  structure   the lexicon (3-5 monophones a word), its word-internal
              triphones, each triphone's 3 emitting states drawn from a
              pool of tied states, and each word's successors (the
              explicit bigrams of a back-off bigram, or the allowed pairs
              of a word-pair grammar); from the configuration's fixed
              `structure_seed` (the deployment's dictionary, tying and
              grammar are part of it)
  gaussians   the pool's `n_mix` diagonal Gaussians a state (means of
              scale `mean_scale`, variances in [var_lo, var_hi)); from the
              run's seed, on the device, in two calls
  utterances  word sequences from the run's seed (under a word-pair
              grammar each word one of its predecessor's successors); each
              word's states held for `frames_per_state` frames, shortened
              towards 1 so that an utterance is exactly its target length;
              a frame is its state's first mean plus Gaussian noise of
              `noise`, drawn on the device in one call for the whole pool

Target lengths are a fixed set for a workload (`pool_lengths`), whatever
the seed: every seed decodes the same sizes in another order.

Plain numpy and torch; imports nothing of the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def internal_triphones(phones: Sequence[str]) -> List[str]:
    """Word-internal context names: l-p+r inside, biphones at the edges
    (the port's `synth.internal_triphones`)."""
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


@dataclass
class Structure:
    """A configuration's words, tying and bigram successors."""

    words: List[str]
    lex: List[List[str]]  # monophones a word
    tri_names: List[str]  # sorted
    tri_states: np.ndarray  # (n_tri, 3) pool ids of each triphone's states
    succ: List[List[int]]  # each word's explicit successors, sorted
    word_states: List[np.ndarray]  # pool ids of a word's chain

    @property
    def n_states(self) -> int:
        return int(sum(len(s) for s in self.word_states))


def build_structure(cfg: dict) -> Structure:
    """The lexicon, the tying and the bigram successors, from the
    configuration's `structure_seed`."""
    rng = np.random.default_rng(int(cfg["structure_seed"]))
    V, P = int(cfg["n_words"]), int(cfg["n_phones"])
    phones = [f"p{i}" for i in range(P)]
    lo, hi = cfg["phones_per_word"]
    n_ph = rng.integers(lo, hi + 1, V)
    lex = [[phones[j] for j in rng.integers(0, P, int(k))] for k in n_ph]
    tri_names = sorted({t for ph in lex for t in internal_triphones(ph)})
    row = {t: k for k, t in enumerate(tri_names)}
    tri_states = rng.integers(0, int(cfg["n_tied"]),
                              (len(tri_names), int(cfg["states_per_phone"])))
    fan = int(cfg["fanout"])
    if cfg["grammar"] == "word_pair":  # exactly `fan` successors a word
        succ = [sorted(int(x) for x in rng.choice(V, fan, replace=False))
                for _ in range(V)]
    else:  # `fan` draws a word, repeats merged
        succ_draw = rng.integers(0, V, (V, fan))
        succ = [sorted(set(int(x) for x in r)) for r in succ_draw]
    word_tris = [[row[t] for t in internal_triphones(ph)] for ph in lex]
    word_states = [tri_states[r].reshape(-1) for r in word_tris]
    return Structure([f"w{i}" for i in range(V)], lex, tri_names,
                     tri_states, succ, word_states)


def lm_weights(cfg: dict) -> Dict[str, float]:
    """The grammar's natural-log weights.

    "backoff_bigram" (the port's `synth.bigram_lm`): unigrams log(0.5 /
    V), back-off weights log 0.5 (keys `uni`, `bow`), explicit bigrams
    log(0.4 / fanout); sentence start enters a word through the back-off
    (log 0.5 + unigram) and a word leaves for the sentence end the same way.
    "word_pair": each word's successors equally likely, log(1 / fanout),
    no other word may follow it; any word starts a sentence, log(1 / V),
    and may end it, log(1 / fanout)."""
    V, fan = int(cfg["n_words"]), int(cfg["fanout"])
    if cfg["grammar"] == "word_pair":
        return {"explicit": -math.log(fan), "start": -math.log(V),
                "end": -math.log(fan)}
    uni, bow = math.log(0.5 / V), math.log(0.5)
    return {"uni": uni, "bow": bow, "explicit": math.log(0.4 / fan),
            "start": bow + uni, "end": bow + uni}


def transitions(cfg: dict) -> Tuple[float, float]:
    """(log self-loop, log forward) of every emitting state: the
    left-to-right 5-state topology of the port's synth, entry prob 1."""
    a = float(cfg["self_loop"])
    return math.log(a), math.log(1.0 - a)


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def make_gaussians(cfg: dict, seed: int, device):
    """(means, variances), each (n_tied, n_mix, dim) float32 on `device`,
    from `seed`. Mixture weights are uniform."""
    g = _generator(seed, device)
    shape = (int(cfg["n_tied"]), int(cfg["n_mix"]), int(cfg["dim"]))
    means = torch.randn(shape, generator=g, device=device) * float(
        cfg["mean_scale"])
    lo, hi = cfg["var_range"]
    var = lo + (hi - lo) * torch.rand(shape, generator=g, device=device)
    return means, var


def pool_lengths(n: int, lo: int, hi: int) -> np.ndarray:
    """`n` target lengths in frames, evenly spread over [lo, hi] (the
    quantiles of a uniform draw): the same set for every seed."""
    q = (np.arange(n) + 0.5) / n
    return np.round(lo + (hi - lo) * q).astype(np.int64)


@dataclass
class Pool:
    """A pool of utterances: frames on the host and their lengths."""

    feats: List[np.ndarray]  # (T, dim) float32 each
    lengths: np.ndarray  # (n,) frames


def _durations(n_states: int, target: int, per_state: int) -> np.ndarray:
    """Frames a state: `per_state` each, shortened towards 1 from the
    last state back until the total is `target`."""
    d = np.full(n_states, per_state, np.int64)
    excess = int(d.sum()) - target
    k = n_states - 1
    while excess > 0:
        cut = min(excess, int(d[k]) - 1)
        d[k] -= cut
        excess -= cut
        k -= 1
    return d


def make_pool(cfg: dict, st: Structure, means: torch.Tensor, n: int,
              lo: int, hi: int, seed: int) -> Pool:
    """`n` utterances of the fixed target lengths `pool_lengths(n, lo,
    hi)`, in an order and with words drawn from `seed`, frames drawn on
    `means`' device."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    targets = pool_lengths(n, lo, hi)[rng.permutation(n)]
    per = int(cfg["frames_per_state"])
    V = len(st.words)
    pairs = cfg["grammar"] == "word_pair"
    state_runs = []
    for target in targets.tolist():
        # words are added while `per` frames a state fall short of the
        # target; a state then needs at least one frame, which fits as
        # long as the target is over 3 x the longest word's states
        states, total, w = [], 0, -1
        while total < target:
            # a word-pair grammar's sentences follow its pairs
            w = (int(rng.integers(0, V)) if w < 0 or not pairs else
                 st.succ[w][int(rng.integers(0, len(st.succ[w])))])
            states.append(st.word_states[w])
            total += per * len(st.word_states[w])
        s = np.concatenate(states)
        state_runs.append(np.repeat(s, _durations(len(s), target, per)))
    idx = torch.as_tensor(np.concatenate(state_runs), device=means.device)
    g = _generator(int(seed) + 1, means.device)
    noise = torch.randn((idx.numel(), means.shape[2]), generator=g,
                        device=means.device)
    x = (means[idx, 0] + float(cfg["noise"]) * noise).cpu().numpy()
    cuts = np.cumsum(targets)[:-1]
    return Pool(feats=np.split(x, cuts), lengths=targets)
