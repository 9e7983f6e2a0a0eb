"""Decode-network compilation (the HNet role, TPU-shaped).

Mirrors `HTKLib/HNet.c : ExpandWordNet()`: a word lattice (SLF) + dict +
HMMSet compile into the recognition network. Instead of linked HMM
instances for token passing, the output is dense arrays for the decode
scan (algo/decode.py):

  - every (word-node, pronunciation) expands to a *chain*: its phone
    models abutted with algo.composite (so tee models and skips inside
    words are exact);
  - all chains stack into one state vector; within-chain transitions
    become a banded matrix B[k, s] = logA[s-k, s] (band width = max skip
    distance), so the per-frame inner update is K shifted adds on the VPU
    instead of a sparse gather;
  - !NULL lattice nodes are epsilon-closed on host into a dense
    word-node -> word-node log-prob matrix (max-plus closure), so the
    cross-word step is one dense max-plus matvec per frame.

Cross-word context expansion (triphone decode, `cross_word=True`)
splits each word node into context-variant units (l, r): the first
(last) context phone of each pronunciation takes its left (right)
context from the neighbouring word across the lattice arc, HNet.c's
cross-word case. Context-free phones (default `sp`) are transparent —
they stay monophone and context flows through them, so `A [aa sp]`
presents `aa` as left context to the next word. The dense node-level
`trans` matrix is rebuilt over the variant units with arcs gated on
context agreement, and the decoder (algo/decode.py) runs unchanged.
Interiors are duplicated per (l, r) variant rather than shared — the
price of the dense banded layout; fine up to medium vocabularies,
large-vocab sharing is a later round. [LC]

Copied from `htk_tpu/algo/net.py` into the PyTorch port: host code, numpy
only, behaviour unchanged. The port cannot use htk_tpu, whose
utils package pulls in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.dictionary import Vocab
from ..io.slf import Lattice, NULL_WORD
from ..models.hmmset import CompiledHMMSet
from ..utils.errors import HError
from .composite import build_composite

LZERO = -1.0e10
LSMALL = -0.5e10


@dataclass
class DecodeNetwork:
    """Dense decode structure consumed by algo/decode.py."""

    # states
    comp_state: np.ndarray  # (Ns,) physical state id per network state
    band: np.ndarray  # (K, Ns) banded within-chain log transitions
    a0: np.ndarray  # (Ns,) chain-entry log prob per state
    aE: np.ndarray  # (Ns,) chain-exit log prob per state
    chain_of: np.ndarray  # (Ns,) chain index
    # chains
    node_of_chain: np.ndarray  # (C,) word-node index
    chain_pron_prob: np.ndarray  # (C,) log pron prob
    # word nodes (non-NULL)
    node_words: List[str]  # (Nn,) word per node
    node_out: List[Optional[str]]  # output symbol (None = word; '' = silent)
    trans: np.ndarray  # (Nn, Nn) closed log LM transition matrix
    start_entry: np.ndarray  # (Nn,) log prob of entering node from start
    end_exit: np.ndarray  # (Nn,) log prob node -> lattice end
    n_states: int = 0
    n_chains: int = 0
    n_nodes: int = 0
    # set by algo/lvnet.py: every chain padded to this many states and
    # node == chain (rows). Enables the gather-free uniform decode scan.
    uniform_width: Optional[int] = None
    # set by algo/lvnet.py when built from an n-gram LM: the cross-word
    # step factored through the ARPA back-off structure (bow/uni vectors
    # + bucketed explicit-bigram gather lists) instead of the dense
    # (C, C) matrix — O(#bigrams) per frame instead of O(C^2), exact.
    xw_backoff: Optional[dict] = None
    # interior sharing (cross_word + share_interiors): True for nodes
    # that are the head/body part of a split word — their records merge
    # times into the following node and emit no symbol (see _finalize)
    node_cont: Optional[np.ndarray] = None
    # 1.0 where entering the node collects the word-insertion penalty
    # (full/head units), 0.0 for intra-word body/tail entries
    node_wdpen: Optional[np.ndarray] = None
    # set by algo/lvnet.py for trigram LMs: single-pass trigram guidance
    # tables (context-sorted trigram successor lists + bigram back-off
    # weights, keyed by the predecessor word carried on each token's
    # entry record) — see lvnet._trigram_tables / decode `xw3` leg
    xw_trigram: Optional[dict] = None


def _maxplus_closure(null_arcs: np.ndarray) -> np.ndarray:
    """All-pairs max-plus closure over NULL nodes (tiny, host-side)."""
    n = null_arcs.shape[0]
    C = null_arcs.copy()
    for k in range(n):
        C = np.maximum(C, C[:, k : k + 1] + C[k : k + 1, :])
    return C


def make_context_lookup(model_names):
    """(left, p, right) -> most specific model name in the set.

    HNet's FindModel search order: full triphone, right biphone, left
    biphone, monophone. `left`/`right` may be None (utterance edge)."""
    names = set(model_names)

    def best(left, p, right):
        cands = []
        if left and right:
            cands.append(f"{left}-{p}+{right}")
        if right:
            cands.append(f"{p}+{right}")
        if left:
            cands.append(f"{left}-{p}")
        cands.append(p)
        for c in cands:
            if c in names:
                return c
        return p

    return best


def word_internal_phone_map(model_names):
    """Pronunciation phones -> word-internal context-dependent names.

    The word-internal slice of HNet.c's context expansion: inside a word,
    p_i maps to p_{i-1}-p_i+p_{i+1} (biphones at word edges), falling back
    to less specific names (biphone, then monophone) when the model set
    lacks the full context — HNet's FindModel search order.
    """
    best = make_context_lookup(model_names)

    def fn(phones):
        out = []
        n = len(phones)
        for i, p in enumerate(phones):
            left = phones[i - 1] if i > 0 else None
            right = phones[i + 1] if i < n - 1 else None
            out.append(best(left, p, right))
        return out

    return fn


def _edge_phones(phones: Sequence[str], cf: frozenset) -> Tuple[str, str]:
    """The context phones a pronunciation presents to its neighbours:
    first/last phone skipping transparent (context-free) ones. A pron
    made only of cf phones presents them anyway (full transparency at
    the word level is a later round). [LC]"""
    ctx = [p for p in phones if p not in cf]
    if not ctx:
        return phones[0], phones[-1]
    return ctx[0], ctx[-1]


def _xword_phones(phones: Sequence[str], l: Optional[str], r: Optional[str],
                  cf: frozenset, best) -> List[str]:
    """Map a pronunciation to cross-word context-dependent model names.

    Interior context phones get word-internal triphones; the first (last)
    context phone takes `l` (`r`) from across the word boundary; cf
    phones stay monophone."""
    ctx = [k for k, p in enumerate(phones) if p not in cf]
    out = list(phones)
    for pos, k in enumerate(ctx):
        left = phones[ctx[pos - 1]] if pos > 0 else l
        right = phones[ctx[pos + 1]] if pos < len(ctx) - 1 else r
        out[k] = best(left, phones[k], right)
    return out


def compile_network(
    lat: Lattice,
    vocab: Vocab,
    comp: CompiledHMMSet,
    phone_map=None,
    cross_word: bool = False,
    cf_phones: Sequence[str] = ("sp",),
    share_interiors: bool = False,
) -> DecodeNetwork:
    """Expand a word lattice into the dense decode network.

    `phone_map(phones: List[str]) -> List[str]` optionally rewrites a
    pronunciation's phone names (e.g. to word-internal triphones).

    `cross_word=True` instead performs full cross-word context expansion
    (see module docstring): word nodes split into (left, right) context
    variant units and `phone_map` is ignored — names are resolved with
    the FindModel fallback chain against the model set.

    `share_interiors=True` (HNet.c ExpandWordNet's structural interior
    sharing, the TPU form): pronunciations with >= 3 context phones
    split into per-left-context HEAD units (first context phone), ONE
    shared BODY unit (the interior, context-independent), and
    per-right-context TAIL units — |L| + 1 + |R| units instead of
    |L| x |R| full variants, with identical decodes (the decoder's
    word-transition max over head variants is exactly the within-word
    Viterbi max the fused chain would take). Head/body nodes are marked
    `node_cont`; the traceback merges their times into the word emitted
    at the tail. Lattice generation over such networks would emit
    sub-word pseudo-nodes, so callers that need lattices keep it off.
    """
    id_of = {n.id: k for k, n in enumerate(lat.nodes)}
    words = []
    for n in lat.nodes:
        w = n.word
        words.append(None if (w is None or w == NULL_WORD) else w)
    n_all = len(lat.nodes)
    start = id_of[lat.start_node()]
    end = id_of[lat.end_node()]

    is_word = [w is not None for w in words]
    word_nodes = [k for k in range(n_all) if is_word[k]]
    widx = {k: i for i, k in enumerate(word_nodes)}
    Nn = len(word_nodes)
    if Nn == 0:
        HError(8620, "compile_network: lattice has no word nodes")

    # arc matrix over ALL nodes, then epsilon-close through non-word nodes
    A = np.full((n_all, n_all), LZERO)
    for a in lat.arcs:
        s, e = id_of[a.start], id_of[a.end]
        A[s, e] = max(A[s, e], a.lmlike)
    # closure: paths through non-word nodes only
    # C[i,j] = best score i->j using only null intermediates
    C = A.copy()
    for k in range(n_all):
        if is_word[k]:
            continue
        C = np.maximum(C, C[:, k : k + 1] + C[k : k + 1, :])

    trans = np.full((Nn, Nn), LZERO)
    for i in word_nodes:
        for j in word_nodes:
            if C[i, j] > LSMALL:
                trans[widx[i], widx[j]] = C[i, j]
    start_entry = np.full(Nn, LZERO)
    end_exit = np.full(Nn, LZERO)
    for j in word_nodes:
        if j == start:
            start_entry[widx[j]] = 0.0
        elif C[start, j] > LSMALL:
            start_entry[widx[j]] = C[start, j]
        if j == end:
            end_exit[widx[j]] = 0.0
        elif C[j, end] > LSMALL:
            end_exit[widx[j]] = C[j, end]

    # -- units: one per word node, or (node, pron-group, l, r) variants --
    unit_words: List[str] = []
    unit_out: List[Optional[str]] = []
    unit_prons: List[List[Tuple[List[str], float]]] = []

    defs = []
    for i in word_nodes:
        w = words[i]
        wd = vocab.get(w)
        if wd is None:
            HError(8621, "compile_network: word %s not in dictionary", w)
        defs.append(wd)

    node_cont_l: List[bool] = []
    node_pen_l: List[bool] = []
    if not cross_word:
        for i, wd in zip(word_nodes, defs):
            unit_words.append(words[i])
            unit_out.append(wd.prons[0].out_sym)
            unit_prons.append([
                (phone_map(p.phones) if phone_map else list(p.phones), p.prob)
                for p in wd.prons
            ])
    else:
        best = make_context_lookup(comp.names)
        cf = frozenset(cf_phones)
        # pron groups per node by the contexts they present to neighbours
        node_groups: List[List[Tuple[str, str, list]]] = []
        for wd in defs:
            gs: Dict[Tuple[str, str], list] = {}
            for p in wd.prons:
                gs.setdefault(_edge_phones(p.phones, cf), []).append(p)
            node_groups.append([(lc, rc, ps) for (lc, rc), ps in gs.items()])
        preds: List[List[int]] = [[] for _ in range(Nn)]
        succs: List[List[int]] = [[] for _ in range(Nn)]
        for na in range(Nn):
            for nb in range(Nn):
                if trans[na, nb] > LSMALL:
                    preds[nb].append(na)
                    succs[na].append(nb)
        key = lambda x: (x is None, x or "")  # noqa: E731
        in_ctx, out_ctx = [], []
        for n in range(Nn):
            ic = {rc for j in preds[n] for (_lc, rc, _) in node_groups[j]}
            oc = {lc for j in succs[n] for (lc, _rc, _) in node_groups[j]}
            if start_entry[n] > LSMALL:
                ic.add(None)
            if end_exit[n] > LSMALL:
                oc.add(None)
            in_ctx.append(sorted(ic, key=key) or [None])
            out_ctx.append(sorted(oc, key=key) or [None])
        # context variants whose FindModel-resolved model sequences
        # coincide are EXACTLY mergeable: the acoustic chains are the
        # same objects, the LM score depends only on the word pair, and
        # a merged unit's connectivity is the union of its members'
        # (context matching is per-side independent). With a
        # word-internal-trained set (HDecode's lattice-constrained
        # pass 2) most cross-word variants back off to the same models,
        # collapsing the classic |L|x|R| interior blow-up.
        # With share_interiors, prons with >= 3 context phones instead
        # split into |L| heads + 1 shared body + |R| tails — the
        # structural sharing for fully cross-word-trained sets whose
        # variants never coincide.
        groups: Dict[tuple, int] = {}
        g_members: List[dict] = []

        def get_unit(gk, **kw):
            gi = groups.get(gk)
            if gi is None:
                gi = len(g_members)
                groups[gk] = gi
                g_members.append({"L": set(), "R": set(), "to": set(),
                                  "kind": "full", **kw})
            return gi

        for n in range(Nn):
            wd = defs[n]
            split_pron_ids = set()
            if share_interiors:
                for pi, p in enumerate(wd.prons):
                    ctx = [k for k, ph in enumerate(p.phones)
                           if ph not in cf]
                    if len(ctx) < 3:
                        continue
                    split_pron_ids.add(pi)
                    olc, orc = _edge_phones(p.phones, cf)
                    c1, cl = ctx[1], ctx[-1]
                    head_ph = list(p.phones[:c1])
                    body_ph = list(p.phones[c1:cl])
                    tail_ph = list(p.phones[cl:])
                    body_res = tuple(_xword_phones(
                        body_ph, p.phones[ctx[0]], p.phones[cl], cf, best))
                    bi = get_unit(("b", n, pi), n=n, kind="body",
                                  olc=olc, orc=orc,
                                  exp=((body_res, 1.0),))
                    for l in in_ctx[n]:
                        hres = tuple(_xword_phones(
                            head_ph, l, p.phones[c1], cf, best))
                        hi = get_unit(("h", n, pi, hres), n=n,
                                      kind="head", olc=olc, orc=orc,
                                      exp=((hres, p.prob),))
                        g_members[hi]["L"].add(l)
                        g_members[hi]["to"].add(bi)
                    for r in out_ctx[n]:
                        tres = tuple(_xword_phones(
                            tail_ph, p.phones[ctx[-2]], r, cf, best))
                        ti = get_unit(("t", n, pi, tres), n=n,
                                      kind="tail", olc=olc, orc=orc,
                                      exp=((tres, 1.0),))
                        g_members[ti]["R"].add(r)
                        g_members[bi]["to"].add(ti)
            for (olc, orc, ps) in node_groups[n]:
                ps = [p for p in ps
                      if wd.prons.index(p) not in split_pron_ids]
                if not ps:
                    continue
                for l in in_ctx[n]:
                    for r in out_ctx[n]:
                        exp = tuple(
                            (tuple(_xword_phones(p.phones, l, r, cf, best)),
                             p.prob)
                            for p in ps)
                        gi = get_unit((n, olc, orc, exp), n=n,
                                      olc=olc, orc=orc, exp=exp)
                        g = g_members[gi]
                        g["L"].add(l)
                        g["R"].add(r)
        Nu = len(g_members)
        u_trans = np.full((Nu, Nu), LZERO)
        u_start = np.full(Nu, LZERO)
        u_end = np.full(Nu, LZERO)
        for ua, ga in enumerate(g_members):
            exit_xw = ga["kind"] in ("full", "tail")
            entry_xw = ga["kind"] in ("full", "head")
            if entry_xw and None in ga["L"]:
                u_start[ua] = start_entry[ga["n"]]
            if exit_xw and None in ga["R"]:
                u_end[ua] = end_exit[ga["n"]]
            for ub in ga["to"]:  # intra-word head->body / body->tail
                u_trans[ua, ub] = 0.0
            if not exit_xw:
                continue
            for ub, gb in enumerate(g_members):
                if (gb["kind"] in ("full", "head")
                        and trans[ga["n"], gb["n"]] > LSMALL
                        and gb["olc"] in ga["R"] and ga["orc"] in gb["L"]):
                    u_trans[ua, ub] = trans[ga["n"], gb["n"]]
        for ga in g_members:
            wd = defs[ga["n"]]
            unit_words.append(words[word_nodes[ga["n"]]])
            cont = ga["kind"] in ("head", "body")
            node_cont_l.append(cont)
            node_pen_l.append(ga["kind"] in ("full", "head"))
            unit_out.append("" if cont else wd.prons[0].out_sym)
            unit_prons.append([(list(ph), prob) for ph, prob in ga["exp"]])
        trans, start_entry, end_exit = u_trans, u_start, u_end
        Nn = Nu

    # -- expand chains per unit --
    comp_state: List[np.ndarray] = []
    a0: List[np.ndarray] = []
    aE: List[np.ndarray] = []
    chain_of: List[np.ndarray] = []
    node_of_chain: List[int] = []
    chain_pron_prob: List[float] = []
    chain_logA: List[np.ndarray] = []
    node_words: List[str] = []
    node_out: List[Optional[str]] = []

    c_idx = 0
    for u, (w, out_sym, prons) in enumerate(
            zip(unit_words, unit_out, unit_prons)):
        node_words.append(w)
        node_out.append(out_sym)
        for phones, prob in prons:
            try:
                ids = [comp.model_id(ph) for ph in phones]
            except Exception:
                HError(8622, "compile_network: missing model for %s (%s)",
                       w, " ".join(phones))
            ch = build_composite(comp, ids)
            comp_state.append(ch.comp_state)
            a0.append(ch.a0)
            aE.append(ch.aE)
            chain_logA.append(ch.logA)
            chain_of.append(np.full(ch.n_states, c_idx, np.int32))
            node_of_chain.append(u)
            chain_pron_prob.append(float(np.log(max(prob, 1e-30))))
            c_idx += 1

    Ns = int(sum(len(s) for s in comp_state))
    C_n = c_idx
    # band width
    K = 1
    for la in chain_logA:
        q = la.shape[0]
        for ii in range(q):
            for jj in range(q):
                if la[ii, jj] > LSMALL and jj >= ii:
                    K = max(K, jj - ii + 1)
                elif la[ii, jj] > LSMALL and jj < ii:
                    K = max(K, 1)  # backward transitions handled below

    # check for backward transitions (rare: ergodic models) — unsupported
    for la in chain_logA:
        q = la.shape[0]
        for ii in range(q):
            for jj in range(q):
                if jj < ii and la[ii, jj] > LSMALL:
                    HError(8623, "compile_network: backward within-word "
                                 "transitions not supported in decode")

    band = np.full((K, Ns), LZERO, np.float32)
    off = 0
    for la in chain_logA:
        q = la.shape[0]
        for jj in range(q):
            for k in range(K):
                ii = jj - k
                if 0 <= ii < q and la[ii, jj] > LSMALL:
                    band[k, off + jj] = la[ii, jj]
        off += q

    return DecodeNetwork(
        comp_state=np.concatenate(comp_state).astype(np.int32),
        band=band,
        a0=np.concatenate(a0).astype(np.float32),
        aE=np.concatenate(aE).astype(np.float32),
        chain_of=np.concatenate(chain_of).astype(np.int32),
        node_of_chain=np.asarray(node_of_chain, np.int32),
        chain_pron_prob=np.asarray(chain_pron_prob, np.float32),
        node_words=node_words,
        node_out=node_out,
        trans=trans.astype(np.float32),
        start_entry=start_entry.astype(np.float32),
        end_exit=end_exit.astype(np.float32),
        n_states=Ns,
        n_chains=C_n,
        n_nodes=Nn,
        node_cont=(np.asarray(node_cont_l, bool)
                   if any(node_cont_l) else None),
        node_wdpen=(np.asarray(node_pen_l, np.float32)
                    if node_cont_l and not all(node_pen_l) else None),
    )
